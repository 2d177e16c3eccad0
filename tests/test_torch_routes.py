"""backend/routes.py: the one decision of host, card or mesh for each
operation with a device route, the policy that sets it, `host_only`, and
the process's store of device bases.

The route table is held case by case: each operation, on a CPU engine
(which keeps to the host), a CPU engine whose policy takes the device
routes, and a stand-in card (the engine device set to CUDA, nothing
launched), with a process mesh of one device and of four, at n just
below the operation's floor, at the floor, and at the floor with the
floor unset.
"""

import threading

import pytest
import torch

from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu_torch.backend import commitment as CM
from reef_tpu_torch.backend import routes
from reef_tpu_torch.ec.pasta import PALLAS
from reef_tpu_torch.parallel import mesh as PM
from reef_tpu_torch.utils import device, metrics

FLOORS = {"msm": 256, "rows": 4096, "ipa": 1 << 10, "sumcheck": 1 << 14}
ENGINES = ("cpu", "cpu_device_routes", "stand_in_card")


def _engine(monkeypatch, engine: str, k: int) -> None:
    """The engine device and a process mesh of k copies of it."""
    dev = torch.device("cuda", 0) if engine == "stand_in_card" \
        else torch.device("cpu")
    monkeypatch.setattr(device, "_SELECTED", dev)
    monkeypatch.setattr(PM, "_PROCESS_MESH", PM.Mesh((dev,) * k))


@pytest.mark.parametrize("size", ["below", "floor", "unset"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("op", list(FLOORS))
def test_route_table(op, engine, k, size, monkeypatch):
    floor = FLOORS[op]
    assert getattr(routes.DEFAULT, op) == floor
    _engine(monkeypatch, engine, k)
    p = routes.Policy(cpu=engine == "cpu_device_routes",
                      **({op: None} if size == "unset" else {}))
    if size != "floor" or engine == "cpu":
        want = routes.HOST
    elif k == 1:
        want = routes.CARD
    else:                               # the rows have no mesh route
        want = routes.HOST if op == "rows" else routes.MESH
    with routes.use(p):
        assert routes.route(op, floor - (size == "below")) == want
    assert routes.policy() is routes.DEFAULT


def _in_thread(fn):
    out = []
    th = threading.Thread(target=lambda: out.append(fn()))
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and len(out) == 1
    return out[0]


def test_host_only_holds_for_its_block_and_its_thread(monkeypatch):
    """`host_only` keeps the calling thread on the host until its block
    ends, nested or not, and no other thread; `use` holds in every
    thread."""
    _engine(monkeypatch, "stand_in_card", 1)

    def msm():
        return routes.route("msm", 1 << 16)

    with routes.host_only():
        assert msm() == routes.HOST
        assert _in_thread(msm) == routes.CARD
        with routes.host_only():
            assert msm() == routes.HOST
        assert msm() == routes.HOST
    assert msm() == routes.CARD
    with routes.use(routes.ALL_HOST):
        assert _in_thread(msm) == routes.HOST
    assert _in_thread(msm) == routes.CARD


def _uploads(fn):
    mt = metrics.Metrics()
    with metrics.recording(mt):
        out = fn()
    return out, mt.events.get(("MSM", "basis_upload"), 0)


def test_device_bases_upload_once_a_process(monkeypatch):
    """Two PedersenGens of one (curve, label, n) read one device basis,
    uploaded once; a new mesh gets a sharded basis of its own; threads
    asking at once upload once."""
    monkeypatch.setattr(device, "_SELECTED", torch.device("cpu"))
    monkeypatch.setattr(PM, "_PROCESS_MESH", None)
    monkeypatch.setattr(routes, "_BASES", {})
    a, b = (CM.PedersenGens(PALLAS, b"test_torch_routes", 8)
            for _ in range(2))
    basis, n = _uploads(a.device_G)
    assert n == 1 and basis.device == torch.device("cpu")
    assert _uploads(b.device_G) == (basis, 0)
    m4, m2 = PM.make_mesh(4), PM.make_mesh(2)
    sharded, n = _uploads(lambda: a.sharded_G(m4))
    assert n == 1 and sharded.mesh == m4 and len(sharded.shards) == 4
    assert _uploads(lambda: b.sharded_G(m4)) == (sharded, 0)
    other, n = _uploads(lambda: b.sharded_G(m2))
    assert n == 1 and other is not sharded and other.mesh == m2
    assert b.device_G() is basis

    made = []
    orig = routes.DeviceBasisV3

    def slow(*args, **kw):
        made.append(1)
        threading.Event().wait(0.05)     # a window for a second upload
        return orig(*args, **kw)

    monkeypatch.setattr(routes, "DeviceBasisV3", slow)
    gens = [CM.PedersenGens(PALLAS, b"test_torch_routes/race", 8)
            for _ in range(8)]
    start = threading.Barrier(len(gens))
    got = [None] * len(gens)

    def ask(i):
        start.wait(timeout=60)
        got[i] = gens[i].device_G()

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(gens))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert len(made) == 1 and all(g is got[0] for g in got)
