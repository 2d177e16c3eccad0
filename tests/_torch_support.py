"""Shared fixtures of the tests that hold reef_tpu_torch against reef_tpu.

Import both into a test module to make them apply to each of its tests.
"""

import jax
import pytest
import torch


@pytest.fixture(autouse=True)
def no_compile_cache_writes():
    """Keep the reference's compiles in these tests out of the committed
    persistent compile cache (tests/.jax_cache): a compile may still read
    an entry, but writes none, however long it takes."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch's CPU ops on one thread: the suite runs several worker
    processes at once, and torch's thread pool in each of them, competing
    for the same cores, slowed these tests twenty-fold."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
