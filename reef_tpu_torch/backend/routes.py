"""Which engine runs each operation that has a device route, and the
device bases those routes read.

An engine is the host (HOST), the engine device alone (CARD: the device
utils/device.py selects) or the process mesh when it holds more than one
device (MESH: parallel/mesh.py).  `route(op, n)` is the one decision, for
the operations

  msm       a Pedersen commit MSM of n values (PedersenGens.commit);
  rows      the Hyrax row commits of n columns each
            (PedersenGens.commit_rows), which have no mesh route: on a
            mesh they stay on the host;
  ipa       the IPA prover's rounds over n values (backend/ipa.py);
  sumcheck  the nlookup sumcheck over a table of n entries
            (backend/witness.py; how the table splits over a mesh is
            parallel/mesh.py `table_cache`'s).

The process-wide `Policy` holds each operation's floor, the least n that
takes a device route, and whether a CPU engine takes the device routes
too, where the kernels' plain versions run (tests and dry runs).
`use(policy)` sets it for a block.  It is a module global and not a
context variable: the prover's helper threads (the fold worker, the
second Spartan proof, the consistency thread) start with an empty
context, and must see it.  `host_only()` keeps the calling thread on the
host for a block.

The device bases: one store a process, keyed by (curve, label, n) and the
device or mesh that holds the basis, so that every PedersenGens of one
generator set reads one upload.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

from ..ec.msm import kernels_for
from ..ec.msm_v3 import DeviceBasisV3
from ..parallel import mesh as PM
from ..utils import cudabuild
from ..utils.device import engine_type, resolve
from ..utils.metrics import count, span

HOST, CARD, MESH = "host", "card", "mesh"


@dataclass(frozen=True)
class Policy:
    """Each operation's floor (None: the operation stays on the host) and
    whether a CPU engine takes the device routes."""
    msm: Optional[int] = 256           # below it the host MSM always wins
    rows: Optional[int] = 4096         # the tree kernel's chunk floor
    # below it the native host rounds win or tie (PERF.md section 5,
    # tools/ipa_sweep.py on an H100)
    ipa: Optional[int] = 1 << 10
    # the JAX package's floor, chosen on the TPU (the H100's crossover
    # against the native host rounds is not measured yet)
    sumcheck: Optional[int] = 1 << 14
    cpu: bool = False


DEFAULT = Policy()
ALL_HOST = Policy(msm=None, rows=None, ipa=None, sumcheck=None)

_policy = DEFAULT
_thread = threading.local()


def policy() -> Policy:
    return _policy


@contextlib.contextmanager
def use(p: Policy):
    """The process's policy is `p` inside the block, in every thread."""
    global _policy
    prev, _policy = _policy, p
    try:
        yield p
    finally:
        _policy = prev


@contextlib.contextmanager
def host_only():
    """Every operation the calling thread starts inside the block runs on
    the host; other threads are untouched."""
    prev = getattr(_thread, "host_only", False)
    _thread.host_only = True
    try:
        yield
    finally:
        _thread.host_only = prev


def route(op: str, n: int) -> str:
    """HOST, CARD or MESH for operation `op` (module docstring) of size
    `n`."""
    floor = getattr(_policy, op)
    if getattr(_thread, "host_only", False) or floor is None or n < floor:
        return HOST
    if engine_type() == "cpu" and not _policy.cpu:
        return HOST
    if PM.process_mesh().size > 1:
        return HOST if op == "rows" else MESH
    return CARD


_BASES: dict = {}
_BASES_LOCK = threading.Lock()


def basis(gens, mesh: Optional[PM.Mesh] = None):
    """The device basis of `gens` (backend/commitment.py PedersenGens): a
    DeviceBasisV3 on the engine device, or with `mesh` a ShardedBasis
    over it.  Uploaded once a process, in the span and under the counter
    `MSM basis_upload`."""
    where = mesh if mesh is not None else resolve()
    key = (gens.cv.name, gens.label, gens.n, where)
    with _BASES_LOCK:
        b = _BASES.get(key)
        if b is None:
            count("MSM", "basis_upload")
            with span("MSM", "basis_upload"):
                ck = kernels_for(gens.cv)
                b = (PM.ShardedBasis(ck, gens.G, mesh) if mesh is not None
                     else DeviceBasisV3(ck, gens.G, device=where))
            _BASES[key] = b
    return b


def prewarm(gens_list) -> None:
    """On the calling thread: upload the basis of each gens whose commits
    take a device route and, on a CUDA engine, build the kernels, so that
    the fold worker's first commit waits on neither (and a build error
    surfaces on this thread)."""
    on_device = False
    for gens in gens_list:
        r = route("msm", gens.n)
        if r != HOST:
            basis(gens, PM.process_mesh() if r == MESH else None)
            on_device = True
    if on_device and engine_type() == "cuda":
        for name in cudabuild.LIBS:
            cudabuild.library(name)
