"""The port's MXU-formulated Poseidon (ops/poseidon_mxu.py) against the
JAX package.

At t = 5 it must equal the reference's `poseidon_mxu.permute_jit` limb
for limb; at t = 9, the host permutation and the port's plain K5
permutation (the reference's own test covers t = 5 only).  Exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu.ops import limb as ref_limb
from reef_tpu.ops import poseidon_mxu as ref_mxu
from reef_tpu.ops.poseidon_constants import host_permutation
from reef_tpu_torch import convert
from reef_tpu_torch.ops import limb, poseidon_device, poseidon_mxu

FIELDS = {"fp": (limb.FP, ref_limb.FP), "fq": (limb.FQ, ref_limb.FQ)}


def _states(lf, t: int, B: int, seed: int) -> list:
    rng = random.Random(seed)
    return [[rng.randrange(lf.p_int) for _ in range(t)] for _ in range(B)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_poseidon_mxu_matches_reference_t5(name):
    lf, rf = FIELDS[name]
    t, B = 5, 8
    states = _states(lf, t, B, 23)
    ref_in = rf.encode([x for s in states for x in s]).reshape(B, t, 16)
    got = poseidon_mxu.permute(lf, convert.states_from_reference(ref_in))
    want = ref_mxu.permute_jit(rf, jnp.asarray(ref_in), t)
    np.testing.assert_array_equal(convert.states_to_reference(got),
                                  np.asarray(want))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_poseidon_mxu_t9_matches_host_and_k5_plain(name):
    """t = 9, where a row's value reaches 9p^2 and the REDC leaves up to
    ~3.3p: the port takes a third subtract and stays canonical."""
    lf, _ = FIELDS[name]
    t, B = 9, 8
    states = _states(lf, t, B, 29)
    X = lf.encode32([x for s in states for x in s]).reshape(
        limb.N32, B, t).permute(2, 0, 1).contiguous()
    got = poseidon_mxu.permute(lf, X)
    assert torch.equal(got, poseidon_device.permute_plain(lf, X))
    for b, s in enumerate(states):
        assert [lf.decode32(got[l, :, b:b + 1])[0]
                for l in range(t)] == host_permutation(lf.p_int, s)


def test_poseidon_mxu_checks_its_input():
    with pytest.raises(ValueError):
        poseidon_mxu.permute(limb.FQ, torch.zeros((1, 8, 2),
                                                  dtype=torch.int32))
    with pytest.raises(TypeError):
        poseidon_mxu.permute(limb.FQ, torch.zeros((5, 8, 2),
                                                  dtype=torch.int64))
    with pytest.raises(ValueError):
        poseidon_mxu.permute(limb.FQ, torch.zeros((5, 16, 2),
                                                  dtype=torch.int32))
