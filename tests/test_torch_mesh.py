"""reef_tpu_torch's multi-device prover (parallel/mesh.py) against the JAX
package, on the CPU.

Every mesh here is k copies of the CPU, as the JAX package's tests run its
mesh on virtual CPU devices; the shards' kernels run their plain versions.
Inputs come from numpy seeds, and every comparison is exact (field
arithmetic has no tolerance):

  - the sharded nlookup sumcheck's transcript equals the JAX package's
    host `nlookup_prove` on a real SAFA's table at k = 1, 2, 3 (not a power
    of two: the table stays on the lead) and 8, and on tables just at 2k
    entries and of a length that is not a power of two;
  - `sharded_msm` equals the reference curve's MSM on both curves, for
    n = 1, n < k and n not a multiple of k;
  - `sharded_prover_step` equals the JAX package's `device_step` under
    jax on the CPU at k = 1, 2 and 8, and its point sum the python
    curve's;
  - the routes: the commit MSM takes `sharded_msm` on a mesh and
    `msm_device_v3` on one device, `commit_rows` takes the device rows
    only on one device, and the sumcheck cache splits at 2k entries and
    more;
  - every kernel wrapper calls its launcher with its tensor's card
    current, and K5's constants are set once per (card, field, t)
    (stand-in libraries record the calls; nothing launches).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_support import (DEVICE_SUMCHECK_ONLY,
                            no_compile_cache_writes,  # noqa: F401
                            one_torch_thread, stand_in_card)
from reef_tpu.backend import sumcheck as ref_sc
from reef_tpu.backend.table import TransitionTable, doc_transform
from reef_tpu.ec import pasta as ref_pasta
from reef_tpu.frontend import parser, regex as R
from reef_tpu.frontend.safa import SAFA
from reef_tpu.models import prover_step as ref_step
from reef_tpu.ops import field as ref_field
from reef_tpu_torch import convert
from reef_tpu_torch.backend import commitment as CM
from reef_tpu_torch.backend import routes
from reef_tpu_torch.backend import sumcheck as port_sc
from reef_tpu_torch.backend import witness
from reef_tpu_torch.ec import msm, msm_v3
from reef_tpu_torch.ec.pasta import PALLAS
from reef_tpu_torch.ec import padd as PD
from reef_tpu_torch.ops import field_kernel, limb, poseidon_kernel
from reef_tpu_torch.ops import sumcheck_device as SD
from reef_tpu_torch.ops import sumcheck_kernel as K
from reef_tpu_torch.parallel import mesh as PM
from reef_tpu_torch.utils import cudabuild, device

CPU = torch.device("cpu")
CURVES = {"pallas": (msm.pallas_kernels, ref_pasta.PALLAS),
          "vesta": (msm.vesta_kernels, ref_pasta.VESTA)}


@pytest.fixture(autouse=True)
def cpu_engine(monkeypatch):
    """The CPU as the engine device, and the default process mesh."""
    monkeypatch.setattr(device, "_SELECTED", None)
    device.select("cpu")
    monkeypatch.setattr(PM, "_PROCESS_MESH", None)


def _mesh(k: int) -> PM.Mesh:
    return PM.make_mesh(devices=["cpu"] * k)


# ---- the sharded sumcheck ---------------------------------------------------

def _real_table():
    """The dryrun's table: `.*b` over `aaaaaaaab`, batch 2 (8 entries)."""
    safa = SAFA("ab", R.simpl(parser.parse(".*b")))
    codes = [ord(c) for c in "aaaaaaaab"]
    udoc = doc_transform(safa.ab, codes)
    return TransitionTable(safa, udoc, len(udoc), len(codes),
                           batch_size=2).table


def _claims(table, seed: int):
    f = ref_field.FQ
    rng = np.random.default_rng(seed)
    qs = [int(q) for q in rng.integers(0, len(table), 5)]
    qs[3] = qs[1]                                   # a duplicate lookup row
    vs = [table[q] for q in qs]
    ell = max(1, (len(table) - 1).bit_length())
    prev_q = [int.from_bytes(rng.bytes(32), "little") % f.p
              for _ in range(ell)]
    return qs, vs, prev_q, ref_sc.verifier_mle_eval(f, table, prev_q)


def _check_transcript(table, cache, seed: int, tag="nl", doc_hash=None):
    f = ref_field.FQ
    args = (f, table, *_claims(table, seed), tag, doc_hash)
    want = ref_sc.nlookup_prove(*args)
    got = port_sc.nlookup_prove(*args, device_cache=cache)
    assert got.sc_rs == want.sc_rs
    assert got.g_coeffs == want.g_coeffs
    assert got.next_running_v == want.next_running_v
    assert got.last_claim == want.last_claim


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_sharded_sumcheck_on_real_table_matches_reference(k):
    """As the dryrun's step 1: split wherever the mesh can take the
    8-entry table (k a power of two, at most 8; at k = 8 one entry a
    shard, so every round runs on the lead after the gather), else on the
    lead by the route's rule."""
    table = _real_table()
    assert len(table) == 8
    mesh = _mesh(k)
    splits = not k & (k - 1)
    cache = (PM.sharded_table_cache(limb.FQ, table, mesh) if splits
             else PM.table_cache(limb.FQ, table, mesh))
    assert len(cache.t_shards) == (k if splits else 1)
    _check_transcript(table, cache, seed=k)


@pytest.mark.parametrize("k,n", [(2, 4), (8, 16), (8, 37)])
def test_table_cache_splits_by_low_bits(k, n):
    """A table just at 2k entries (one round on the shards) and one of 37
    (padded to 64: three rounds on the shards, three on the lead): shard
    d holds entries d, d + k, ...; the transcript is the reference's."""
    rng = np.random.default_rng(n)
    table = [int(v) for v in rng.integers(0, 1 << 40, n)]
    cache = PM.table_cache(limb.FQ, table, _mesh(k))
    assert len(cache.t_shards) == k
    padded = table + [0] * ((1 << cache.ell) - n)
    for d, shard in enumerate(cache.t_shards):
        assert limb.FQ.decode32(shard) == padded[d::k]
    _check_transcript(table, cache, seed=n, tag="nldoc", doc_hash=12345)


def test_sharded_table_needs_a_power_of_two_within_the_table():
    with pytest.raises(ValueError):
        PM.sharded_table_cache(limb.FQ, list(range(8)), _mesh(3))
    with pytest.raises(ValueError):
        PM.sharded_table_cache(limb.FQ, list(range(4)), _mesh(8))


def test_sum_coeffs_is_one_coefficient_launch(monkeypatch):
    """The lead's sum of the shards' coefficient triples, mod p, with the
    sponge state absorbed, is one K6 coefficient pass."""
    lf, p = limb.FQ, limb.FQ.p_int
    rng = np.random.default_rng(3)
    vals = [[int.from_bytes(rng.bytes(32), "little") % p for _ in range(3)]
            for _ in range(5)]
    parts = [lf.encode32(v).T.reshape(3, 8, 1) for v in vals]
    state = lf.encode32(list(range(9))).T.reshape(9, 8, 1).contiguous()
    calls = []
    orig = K.coeffs

    def counted(*a):
        calls.append(a[1].shape)
        return orig(*a)

    monkeypatch.setattr(K, "coeffs", counted)
    g, st = SD.sum_coeffs(lf, parts, CPU, state)
    sums = [sum(v[c] for v in vals) % p for c in range(3)]
    assert [lf.decode32(g[c])[0] for c in range(3)] == sums
    assert [lf.decode32(st[i])[0] for i in range(9)] == \
        [0, 1 + sums[2], 2 + sums[1], 3 + sums[0], 4, 5, 6, 7, 8]
    assert calls == [(8, 16)]


# ---- the sharded MSM --------------------------------------------------------

@pytest.mark.parametrize("name,k,n", [("pallas", 2, 1), ("vesta", 3, 2),
                                      ("pallas", 2, 3), ("vesta", 1, 3)])
def test_sharded_msm_matches_reference(name, k, n):
    """n = 1; n < k (the last shard holds padding only); n not a multiple
    of k; a one-device mesh.  The basis has two points more than the
    scalars, as a commit's generators may."""
    ck, ref_cv = CURVES[name][0](), CURVES[name][1]
    rng = np.random.default_rng(n * 10 + k)
    pts = [ref_cv.mul(int(s), ref_cv.gen)
           for s in rng.integers(1, 1 << 48, n + 2)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % ref_cv.order
               for _ in range(n)]
    mesh = _mesh(k)
    basis = PM.ShardedBasis(ck, pts, mesh)
    nl = basis.n_local
    assert nl == 1 << max(0, -(-(n + 2) // k) - 1).bit_length()
    assert [b.n for b in basis.shards] == \
        [len(pts[d * nl:(d + 1) * nl]) for d in range(k)]
    assert PM.sharded_msm(mesh, ck, scalars, basis) == \
        ref_cv.msm(scalars, pts[:n])


# ---- the sharded flagship step ----------------------------------------------

def test_sharded_prover_step_matches_reference():
    """The same inputs through the JAX package's device_step (jitted on
    the CPU) and the port's sharded step at k = 1, 2 and 8; the point sum
    against the python curve."""
    gen = torch.Generator().manual_seed(11)
    args = PM.sharded_example_args(_mesh(8), gen, batch_per_dev=2,
                                   half_per_dev=2, pts_per_dev=1)
    states, t_tab, eq_tab, r, pts = args
    ref_in = (convert.states_to_reference(states),
              convert.rows_to_reference(t_tab),
              convert.rows_to_reference(eq_tab),
              convert.rows_to_reference(r)[0])
    # XLA:CPU's expensive LLVM passes only speed the compiled code up
    step = jax.jit(ref_step.device_step).lower(*ref_in).compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True})
    ref_out = [np.asarray(x) for x in step(*ref_in)]
    want = [convert.states_from_reference(ref_out[0]),
            convert.rows_from_reference(ref_out[1]),
            convert.rows_from_reference(ref_out[2])]
    want += [convert.rows_from_reference(x.reshape(1, limb.N))
             for x in ref_out[3:]]
    ck = msm.vesta_kernels()
    pt_sum = None
    for i in range(pts.shape[2]):
        pt_sum = ref_pasta.VESTA.add(pt_sum,
                                     ref_pasta.VESTA.mul(i + 2,
                                                         ref_pasta.VESTA.gen))
    for k in (1, 2, 8):
        out = PM.sharded_prover_step(_mesh(k))(*args)
        for got, w in zip(out[:6], want):
            assert torch.equal(got, w), k
        assert ck.to_affine(out[6].permute(2, 0, 1).numpy()) == [pt_sum]


# ---- the routes -------------------------------------------------------------

def test_make_mesh_and_the_process_mesh(monkeypatch):
    assert PM.make_mesh() == PM.Mesh((CPU,))
    assert PM.make_mesh(3) == _mesh(3) and _mesh(3).lead == CPU
    assert PM.process_mesh() == PM.make_mesh()
    assert PM.select(["cpu"] * 8).size == 8
    assert PM.process_mesh() == _mesh(8)
    assert PM.select(None) == PM.make_mesh()
    assert PM.process_mesh().size == 1
    with pytest.raises(ValueError):
        PM.make_mesh(devices=[])
    with pytest.raises(ValueError):
        PM.make_mesh(devices=["meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_mesh(devices=["cuda:0"] * 2)


def test_msm_device_route_takes_the_mesh(monkeypatch):
    """More than one device: `sharded_msm` over the gens' cached
    ShardedBasis (one a mesh); one device: `msm_device_v3`."""
    gens = CM.PedersenGens(PALLAS, b"test_torch_mesh/route", 256)
    values = list(range(1, 257))
    calls = []
    monkeypatch.setattr(
        PM, "sharded_msm", lambda mesh, ck, v, basis:
        calls.append(("sharded", mesh.size, basis.n, len(v))) or "S")
    monkeypatch.setattr(
        msm_v3, "msm_device_v3", lambda ck, v, basis:
        calls.append(("single", basis.n, len(v))) or "D")
    PM.select(["cpu"] * 4)
    assert gens._msm_device_route(values, routes.MESH) == "S"
    basis = gens.sharded_G()
    assert gens.sharded_G() is basis and basis.mesh == _mesh(4)
    assert [b.n for b in basis.shards] == [64] * 4
    PM.select(["cpu"] * 2)
    assert gens.sharded_G() is not basis
    PM.select(None)
    assert gens._msm_device_route(values, routes.CARD) == "D"
    assert calls == [("sharded", 4, 256, 256), ("single", 256, 256)]


def test_commit_rows_take_the_device_rows_only_on_one_device(monkeypatch):
    n = 256
    gens = CM.PedersenGens(PALLAS, b"test_torch_mesh/rows", n)
    rng = np.random.default_rng(5)
    flat = [int(v) for v in rng.integers(0, 1 << 60, 2 * n)]
    blinds = [3, 4]
    host = gens.commit_rows(flat, blinds)    # the CPU engine: the host
    calls = []
    monkeypatch.setattr(msm_v3, "msm_device_v3_rows",
                        lambda ck, rows, basis: calls.append(len(rows))
                        or [None] * len(rows))
    with routes.use(routes.Policy(cpu=True, rows=n)):
        PM.select(["cpu"] * 2)
        assert gens.commit_rows(flat, blinds) == host
        assert calls == []
        PM.select(None)
        gens.commit_rows(flat, blinds)
    assert calls == [2]


@pytest.mark.parametrize("k,n,sharded", [(1, 64, False), (4, 8, True),
                                         (4, 7, False), (3, 64, False),
                                         (8, 16, True)])
def test_device_cache_takes_the_mesh(monkeypatch, k, n, sharded):
    """Every table on its device route: split at and above 2k entries on
    a mesh of a power of two devices, else whole on the lead."""
    PM.select(["cpu"] * k)
    gen = witness.WitnessGenerator.__new__(witness.WitnessGenerator)
    table = list(range(n))
    with routes.use(DEVICE_SUMCHECK_ONLY):
        cache = gen._maybe_device_cache("nl", table)
    assert gen._maybe_device_cache("nl", table) is cache
    assert isinstance(cache, SD.DeviceTableCache) and cache.device == CPU
    assert len(cache.t_shards) == (k if sharded else 1)


# ---- the launches on a node with several cards -----------------------------

def _launch(which: str):
    ck, lf = msm.pallas_kernels(), limb.FQ
    z = torch.zeros
    T = z((8, 4), dtype=torch.int32)
    if which == "padd":
        P = z((3, 8, 2), dtype=torch.int32)
        PD.launch(ck, P, P, PD.THREAD)
    elif which == "padd_reduce":
        PD.padd_reduce(ck, z((3, 8, 1, 2, 1), dtype=torch.int32))
    elif which == "tree":
        msm_v3.tree_launch(ck, z((2, 8, 1, 4), dtype=torch.int32),
                           z((3, 8, 1, 4), dtype=torch.int32), [1, 2])
    elif which == "poseidon":
        poseidon_kernel.launch(lf, z((5, 8, 2), dtype=torch.int32))
    elif which == "coeffs":
        K.coeffs(lf, T[:, :2], T[:, 2:], T[:, :2], T[:, 2:])
    elif which == "fold":
        K.fold(lf, T[:, :2], T[:, 2:], T[:, :2], T[:, 2:], T[:, :1])
    elif which == "eq_step":
        K.eq_step(lf, T, T[:, :1])
    elif which == "encode":
        K.encode(lf, z(3, dtype=torch.int64), 4)
    elif which == "mont_mul":
        a = z((16, 4), dtype=torch.int64)
        field_kernel.mont_mul(lf, a, a)
    else:
        field_kernel.mont_redc_cols(lf, z((32, 4), dtype=torch.int64))


@pytest.mark.parametrize("which", ["padd", "padd_reduce", "tree", "poseidon",
                                   "coeffs", "fold", "eq_step", "encode",
                                   "mont_mul", "mont_redc"])
def test_launchers_run_with_their_tensors_card_current(which, monkeypatch,
                                                       stand_in_card):
    """`<<<>>>` launches on the current device, so every wrapper calls its
    launcher (and K5 its constants' copy) with the tensor's card current."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            return lambda *a: calls.append((fn, stand_in_card.current)) or 0

    monkeypatch.setattr(cudabuild, "library", lambda name: Lib())
    monkeypatch.setattr(cudabuild, "on_card", lambda name, t: True)
    monkeypatch.setattr(poseidon_kernel, "_CONSTS_SET", set())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("Props", (), {
                            "multi_processor_count": 132}))
    _launch(which)
    assert calls and all(dev == CPU for _, dev in calls), calls
    assert stand_in_card.current is None


def test_poseidon_constants_set_once_per_card(monkeypatch, stand_in_card):
    sets = []

    class Lib:
        def reef_poseidon_set_consts(self, field, t, rc, mds, sparse):
            sets.append((stand_in_card.current, field, t))
            return 0

    monkeypatch.setattr(cudabuild, "library", lambda name: Lib())
    monkeypatch.setattr(poseidon_kernel, "_CONSTS_SET", set())
    cards = [torch.device("cuda", i) for i in (0, 1)]
    for _ in range(2):
        for dev in cards:
            for lf in (limb.FQ, limb.FP):
                for t in (5, 9):
                    poseidon_kernel._set_consts(lf, t, dev)
    assert sets == [(dev, lf.field_id, t) for dev in cards
                    for lf in (limb.FQ, limb.FP) for t in (5, 9)]
