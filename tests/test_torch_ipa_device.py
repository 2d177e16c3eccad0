"""The IPA prover's device round engine (ec/ipa_device.py `IpaDevice`) on
the CPU, where its kernels' plain versions run and the MSM takes
ec/msm_v3.py's plain pipeline over the gens' `device_G()`.

For a fixed list of challenges its rounds (cL, cR, L, R) and final scalar
must equal both native host engines' (the port's and the JAX package's
`IpaNative`); with the blinds fixed, a whole `ipa_prove` forced onto it
(the device routes taken on the `cpu` device, the ipa floor lowered) must
give the host engine's proof bit for bit, which `ipa_verify` accepts, and
so must one on the mesh engine (`IpaMesh`) over k CPUs; and `ipa_prove`
must take each only where backend/routes.py routes it.
"""

import contextlib
import random
import secrets

import numpy as np
import pytest
import torch

from reef_tpu.ec import native_msm as ref_native
from reef_tpu.ec import pasta as ref_pasta
from reef_tpu_torch.backend import commitment as CM
from reef_tpu_torch.backend import ipa, routes
from reef_tpu_torch.ec import ipa_device, msm_v3, native_msm
from reef_tpu_torch.ec.pasta import PALLAS, VESTA
from reef_tpu_torch.ops import limb
from reef_tpu_torch.parallel import mesh as PM
from reef_tpu_torch.utils import device, metrics

CURVES = {"pallas": (PALLAS, ref_pasta.PALLAS),
          "vesta": (VESTA, ref_pasta.VESTA)}


@pytest.fixture
def cpu_engine(monkeypatch):
    monkeypatch.setattr(device, "_SELECTED", None)
    device.select("cpu")


def _rounds(eng, xs):
    seq = []
    for x in xs:
        seq.append(eng.cross())
        eng.fold(x)
    seq.append(eng.final())
    eng.close()
    return seq


def _proof(gens, cv, n, seed):
    """An honest ipa_prove of a random vector, blinds drawn from `seed`."""
    rng = random.Random(seed)
    p = cv.order
    G_s = CM.shared_scalar_gens(cv).G[0]
    w = [rng.randrange(p) for _ in range(n)]
    R = [rng.randrange(p) for _ in range(n)]
    rho, r_v = rng.randrange(p), rng.randrange(p)
    v = sum(a * b for a, b in zip(w, R)) % p
    C_w = cv.add(cv.mul(rho, gens.H),
                 native_msm.msm_packed(cv, w, gens.packed_G(),
                                       handle=gens.native_basis()))
    C_v = cv.add(cv.mul(v, G_s), cv.mul(r_v, gens.H))
    blinds = random.Random(seed + 1)
    orig = secrets.randbelow
    secrets.randbelow = lambda m: blinds.randrange(m)
    try:
        mt = metrics.Metrics()
        with metrics.recording(mt):
            proof = ipa.ipa_prove(gens, G_s, w, rho, R, v, r_v, C_w, C_v,
                                  CM.Transcript(b"t"))
    finally:
        secrets.randbelow = orig
    ok = ipa.ipa_verify(gens, G_s, R, C_w, C_v, proof, CM.Transcript(b"t"))
    took = {k[1]: c for k, c in mt.events.items() if k[0] == "IPA"}
    return proof, ok, took


def _row_msms(ck, basis, scb):
    """Each row's MSM of the scalar bytes `scb` (n2, 32 rows) over a
    DeviceBasisV3's points, by the native host MSM, as (3, 8, rows)."""
    pts = ck.to_affine(basis.arr.permute(0, 3, 1, 2).reshape(-1, 3, 8))
    raw = scb.numpy().tobytes()
    width = scb.shape[1]
    sums = []
    for r in range(width // 32):
        sc = [int.from_bytes(raw[width * j + 32 * r:width * j + 32 * r + 32],
                             "little") for j in range(len(pts))]
        sums.append(native_msm.msm_native(ck.curve, sc, pts))
    return torch.from_numpy(ck.to_proj(sums)).permute(1, 2, 0)


def _combined(sf, proj, partial):
    """The combine's output form: the rows' points, then the dots'
    partials summed."""
    words = partial.permute(0, 2, 1).reshape(-1, 8).numpy()
    ints = limb._words_to_ints(words, 32)
    nb = partial.shape[2]
    d = [sum(ints[k * nb:(k + 1) * nb]) % sf.p_int for k in (0, 1)]
    dw = torch.from_numpy(limb._ints_to_words(d, np.uint32)
                          .view(np.int32).copy())
    return torch.cat([proj.reshape(-1), dw.reshape(-1)])


def _host_msm(monkeypatch):
    """The round's MSM and window combine by the native host MSM over the
    engine's basis points, in the combine's output form:
    the plain MSM costs ~1 s a round on the CPU whatever n, and is held to
    the reference by tests/test_torch_msm.py, the combine to its kernel by
    tests/test_torch_card_ipa.py, both in full here at n = 2^4."""
    def windows(ck, basis, scb):
        return basis, scb.clone()

    def combine(ck, sf, carried, rows, partial):
        return _combined(sf, _row_msms(ck, *carried), partial)

    monkeypatch.setattr(ipa_device, "msm_windows", windows)
    monkeypatch.setattr(ipa_device, "combine", combine)


def _host_shards(monkeypatch):
    """On a mesh, each shard's window sums by the native host MSM (window
    0 of a row holds the row's MSM over the shard's points, its other 31
    the identity) and the combine of the lead's window sums by the host
    curve (msm_v3.combine_windows), so that the shards' slices of the
    scalars and their sum on the lead (`_point_sum`, K1's plain reduce)
    are what runs: the plain MSM and combine cost ~1 s each a round."""
    def windows(ck, basis, scb):
        rows = scb.shape[1] // 32
        out = ck.ident_t(scb.device)[:, :, None].expand(
            3, 8, 32 * rows).clone()
        out[:, :, ::32] = _row_msms(ck, basis, scb)
        return out

    def combine(ck, sf, accs, rows, partial):
        pts = [msm_v3.combine_windows(ck, accs[:, :, 32 * r:32 * r + 32])
               for r in range(rows)]
        proj = torch.from_numpy(ck.to_proj(pts)).permute(1, 2, 0)
        return _combined(sf, proj, partial)

    monkeypatch.setattr(PM, "msm_windows", windows)
    monkeypatch.setattr(ipa_device, "combine", combine)


# (what, curve, log2 n, MSM): the plain MSM and combine in full at 2^4,
# the host MSM above and in the whole proofs
CASES = [("rounds", name, log_n, "plain" if log_n == 4 else "host")
         for name in CURVES for log_n in (4, 6, 8)] + [
    ("proof", name, 3, "host") for name in CURVES]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_device_engine_equals_host(case, cpu_engine, monkeypatch):
    """One engine of each kind on the same inputs."""
    what, name, log_n, msm_by = case
    if msm_by == "host":
        _host_msm(monkeypatch)
    cv, ref_cv = CURVES[name]
    n = 1 << log_n
    gens = CM.PedersenGens(cv, b"test_torch_ipa_device", n)
    if native_msm._load() is None or ref_native._load() is None:
        pytest.skip("native msm unavailable")
    if what == "rounds":
        rng = random.Random(log_n)
        p = cv.order
        w = [rng.randrange(p) for _ in range(n)]
        R = [rng.randrange(p) for _ in range(n)]
        xs = [rng.randrange(1, p) for _ in range(log_n)]
        packed = bytes(gens.packed_G())
        got = _rounds(ipa_device.IpaDevice(gens, w, R), xs)
        assert got == _rounds(native_msm.IpaNative(cv, w, R, packed), xs)
        assert got == _rounds(ref_native.IpaNative(ref_cv, w, R, packed), xs)
        assert len(got) == log_n + 1
        return
    host, host_ok, host_took = _proof(gens, cv, n, 7)
    with routes.use(routes.Policy(cpu=True, ipa=n)):
        dev, dev_ok, dev_took = _proof(gens, cv, n, 7)
    assert (host_took, dev_took) == ({"host": 1}, {"device": 1})
    assert host_ok and dev_ok
    assert dev == host


# (curve, mesh of k CPUs, log2 n, log2 of the basis): n = 2^10 =
# the ipa floor; a vector half its basis, so two of the four shards
# hold none of its points and are skipped; shards of 64 points, which
# their cards pad to 128
MESH_CASES = [(name, k, 10, 10) for name in CURVES for k in (2, 4)] + [
    ("pallas", 4, 10, 11), ("vesta", 4, 8, 8)]


@pytest.mark.parametrize("case", MESH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_mesh_engine_equals_host(case, cpu_engine, monkeypatch):
    """A whole ipa_prove on the mesh engine (`IpaMesh` over the gens'
    sharded basis, the device routes taken on a mesh of k CPUs) against
    the host engine's, blinds fixed: the same proof, bit for bit, which
    `ipa_verify` accepts; no whole basis is uploaded."""
    name, k, log_n, log_b = case
    if native_msm._load() is None:
        pytest.skip("native msm unavailable")
    _host_shards(monkeypatch)
    cv = CURVES[name][0]
    n = 1 << log_n
    gens = CM.PedersenGens(cv, b"test_torch_ipa_device", 1 << log_b)
    monkeypatch.setattr(PM, "_PROCESS_MESH",
                        PM.make_mesh(devices=["cpu"] * k))
    monkeypatch.setattr(routes, "_BASES", {})
    host, host_ok, host_took = _proof(gens, cv, n, 7)
    with routes.use(routes.Policy(cpu=True, ipa=min(n, routes.DEFAULT.ipa))):
        mesh, mesh_ok, mesh_took = _proof(gens, cv, n, 7)
    assert (host_took, mesh_took) == ({"host": 1}, {"mesh": 1})
    assert host_ok and mesh_ok
    assert mesh == host
    basis, = routes._BASES.values()          # no whole basis beside it
    assert basis is gens.sharded_G() and len(basis.shards) == k


# where ipa_prove's round engine is on the card: the device routes taken
# at n at the ipa floor or above, outside `routes.host_only`, `IpaDevice`
# on a one-device mesh and `IpaMesh` on a larger one; every other case the
# host's
GATES = ["device", "below_floor", "device_msm_off", "pinned_thread",
         "mesh", "mesh_below_floor", "mesh_pinned_thread"]


@pytest.mark.parametrize("gate", GATES)
def test_round_engine_gate(gate, cpu_engine, monkeypatch):
    import threading
    if native_msm._load() is None:
        pytest.skip("native msm unavailable")
    n = 16
    gens = CM.PedersenGens(PALLAS, b"test_torch_ipa_device", n)
    w, R = list(range(1, n + 1)), list(range(n, 0, -1))
    monkeypatch.setattr(PM, "_PROCESS_MESH", PM.make_mesh(
        devices=["cpu"] * (2 if gate.startswith("mesh") else 1)))
    monkeypatch.setattr(routes, "_BASES", {})
    got = {}

    def choose():
        mt = metrics.Metrics()
        pinned = gate.endswith("pinned_thread")
        with metrics.recording(mt), \
                routes.host_only() if pinned else contextlib.nullcontext():
            got["engine"] = ipa._round_engine(gens, w, R)
        got["took"] = {k[1]: c for k, c in mt.events.items()
                       if k[0] == "IPA"}

    with routes.use(routes.Policy(
            cpu=gate != "device_msm_off",
            ipa=2 * n if gate.endswith("below_floor") else n)):
        th = threading.Thread(target=choose)
        th.start()
        th.join(timeout=60)
    assert not th.is_alive()
    took = gate if gate in ("device", "mesh") else "host"
    want = {"device": ipa_device.IpaDevice, "mesh": ipa_device.IpaMesh,
            "host": native_msm.IpaNative}[took]
    assert type(got["engine"]) is want
    assert got["took"] == {took: 1}
    if took == "mesh":        # over the sharded basis, with no whole one
        basis, = routes._BASES.values()
        assert got["engine"].basis is basis is gens.sharded_G()
    got["engine"].close()


def test_launch_counts_from_threads_add_up():
    """The two Spartan proofs count their rounds' launches from two
    threads at once: no count may be lost (a short switch interval makes
    a lost read-modify-write likely)."""
    import sys
    import threading

    from reef_tpu_torch.utils import cudabuild
    before = cudabuild.launch_counts()["ipa_combine"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [cudabuild.count("ipa_combine")
                            for _ in range(20000)]) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert cudabuild.launch_counts()["ipa_combine"] == before + 8 * 20000
