"""reef_tpu_torch's device nlookup sumcheck against the JAX package (CPU).

The port's device route (ops/sumcheck_device.py: the eq build, the round
loop, the Poseidon sponge on the device, through the K5 and K6 wrappers,
which run their plain versions on CPU tensors) must give exactly the JAX
package's host transcript: the challenges, the round coefficients, the
next running claim and the sponge state afterwards.  The flagship step's
round is held to big-int python; the witness routing to the device
cache follows REEF_DEVICE_SUMCHECK; and a proof made with the document
sumcheck forced onto the device route verifies under the JAX package's
verifier.  The coefficient kernel's three-product form must equal the
reference's four-product sums, and its launch plan must make one launch
a round.  The K6 kernels are held against their plain versions on the
card by tests/test_torch_card_sumcheck.py, which imports no JAX.
"""

import contextlib
import io
import random

import pytest
import torch

from _torch_card_support import rows as _rows
from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread, stand_in_card)
from reef_tpu import cli as ref_cli
from reef_tpu.backend import sumcheck as ref_sc
from reef_tpu.backend.table import TransitionTable, doc_transform
from reef_tpu.frontend import parser, regex as R
from reef_tpu.frontend.safa import SAFA
from reef_tpu.ops import field as ref_field
from reef_tpu_torch import cli
from reef_tpu_torch.backend import sumcheck as port_sc
from reef_tpu_torch.backend import witness
from reef_tpu_torch.models import prover_step
from reef_tpu_torch.ops import limb
from reef_tpu_torch.ops import sumcheck_device as SD
from reef_tpu_torch.ops import sumcheck_kernel as K
from reef_tpu_torch.utils import cudabuild, device

# real lookup tables: (alphabet, regex, document) -> the transition table,
# or ("doc", n) -> an n-character document projected as the nldoc table
TABLES = {
    "nl64": ("abcd", "^(ab|cd){2,5}$", "abcdab"),
    "nl256": ("abcdefghij", ".*(abc|def|ghi)+.*j", "abcdefghij"),
    "doc300": ("doc", 300),
}


def _table(case):
    if case[0] == "doc":
        rng = random.Random(case[1])
        return [rng.randrange(4) for _ in range(case[1])]
    ab, rx, doc = case
    safa = SAFA(ab, R.simpl(parser.parse(rx)))
    codes = [ord(c) for c in doc]
    udoc = doc_transform(safa.ab, codes)
    return TransitionTable(safa, udoc, len(udoc), len(codes),
                           batch_size=2).table


def _capture_sponges(monkeypatch, module):
    """Record every HostSponge that `module` makes."""
    made = []
    base = module.HostSponge

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(module, "HostSponge", Recorded)
    return made


@pytest.mark.parametrize("name", sorted(TABLES))
def test_device_route_matches_reference(monkeypatch, name):
    f = ref_field.FQ
    table = _table(TABLES[name])
    rng = random.Random(len(table))
    qs = [rng.randrange(len(table)) for _ in range(5)]
    qs[3] = qs[1]                                  # a duplicate lookup row
    vs = [table[q] for q in qs]
    ell = max(1, (len(table) - 1).bit_length())
    prev_q = [rng.randrange(f.p) for _ in range(ell)]
    prev_v = ref_sc.verifier_mle_eval(f, table, prev_q)
    ref_sponges = _capture_sponges(monkeypatch, ref_sc)
    port_sponges = _capture_sponges(monkeypatch, port_sc)
    want = ref_sc.nlookup_prove(f, table, qs, vs, prev_q, prev_v, "nldoc",
                                doc_hash=12345)
    cache = SD.DeviceTableCache(limb.FQ, table, device="cpu")
    assert [t.shape for t in cache.t_shards] == [(8, 1 << ell)]
    got = port_sc.nlookup_prove(f, table, qs, vs, prev_q, prev_v, "nldoc",
                                doc_hash=12345, device_cache=cache)
    assert got.sc_rs == want.sc_rs
    assert got.g_coeffs == want.g_coeffs
    assert got.next_running_v == want.next_running_v
    assert (got.claim_r, got.last_claim, got.next_running_q,
            got.combined_qs) == (want.claim_r, want.last_claim,
                                 want.next_running_q, want.combined_qs)
    (rs,), (ps,) = ref_sponges, port_sponges
    assert (ps.state, ps.pos, ps.squeezing) == (rs.state, rs.pos,
                                                rs.squeezing)


def test_sumcheck_round_matches_bigint():
    lf = limb.FQ
    p = lf.p_int
    _, t_tab, eq_tab, r = prover_step.example_args(batch=1, half=8, seed=5,
                                                   device="cpu")
    T = [lf.decode32(t_tab[k]) for k in range(2)]
    E = [lf.decode32(eq_tab[k]) for k in range(2)]
    rr = lf.decode32(r)[0]
    ts = [(b - a) % p for a, b in zip(*T)]
    es = [(b - a) % p for a, b in zip(*E)]
    t_fold, e_fold, xsq, x, con = prover_step.sumcheck_round(lf, t_tab,
                                                             eq_tab, r)
    assert lf.decode32(xsq) == [sum(a * b for a, b in zip(ts, es)) % p]
    assert lf.decode32(x) == [sum(e * a + d * b for e, a, d, b in
                                  zip(es, T[0], ts, E[0])) % p]
    assert lf.decode32(con) == [sum(a * b for a, b in zip(T[0], E[0])) % p]
    assert lf.decode32(t_fold) == [(a + rr * d) % p for a, d in zip(T[0], ts)]
    assert lf.decode32(e_fold) == [(a + rr * d) % p for a, d in zip(E[0], es)]


def test_build_eq_matches_reference_eq_table():
    f = ref_field.FQ
    lf = limb.FQ
    rng = random.Random(9)
    ell, qs = 5, [3, 17, 3, 30]
    rs = [rng.randrange(f.p) for _ in range(len(qs) + 1)]
    prev_q = [rng.randrange(f.p) for _ in range(ell)]
    combined = {}
    for q, r in zip(qs, rs):
        combined[q] = (combined.get(q, 0) + r) % f.p
    rows = sorted(combined)
    eq = SD.build_eq(lf, ell, torch.tensor(rows),
                     lf.encode32([combined[q] for q in rows]),
                     lf.encode32([rs[-1]]), lf.encode32(prev_q))
    assert lf.decode32(eq) == ref_sc.gen_eq_table(f, rs, qs, prev_q)


@pytest.mark.parametrize("mode,profile,n,engaged", [
    ("0", "local-accel", 1 << 14, False),
    ("auto", "cpu", 1 << 14, False),
    ("auto", "local-accel", (1 << 14) - 1, False),
    ("auto", "local-accel", 1 << 14, True),
    ("1", "cpu", 64, True),
])
def test_device_cache_routing(monkeypatch, mode, profile, n, engaged):
    """REEF_DEVICE_SUMCHECK: 0 = host, 1 = device route for any table,
    auto = device route for tables >= 2^14 on a CUDA engine device (here
    the profile is forced and the cache lands on the selected CPU)."""
    monkeypatch.setenv("REEF_DEVICE_SUMCHECK", mode)
    monkeypatch.setenv("REEF_DEVICE_PROFILE", profile)
    monkeypatch.setattr(device, "_SELECTED", torch.device("cpu"))
    gen = witness.WitnessGenerator.__new__(witness.WitnessGenerator)
    table = list(range(n))
    cache = gen._maybe_device_cache("nldoc", table)
    assert (cache is not None) == engaged
    assert gen._maybe_device_cache("nldoc", table) is cache
    if engaged:
        assert cache.device.type == "cpu"
        assert limb.FQ.decode32(cache.t_shards[0][:, :3]) == [0, 1, 2]


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_forced_device_sumcheck_e2e_verifies_with_reference(monkeypatch,
                                                            tmp_path):
    """Commit and prove with both nlookup batches on the device route (plain
    versions on the CPU; MSMs on the host), then verify with the JAX
    package's verifier."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REEF_DEVICE_SUMCHECK", "1")
    monkeypatch.setenv("REEF_DEVICE_MSM", "0")
    monkeypatch.setattr(device, "_SELECTED", None)
    calls = []
    orig = SD.device_sumcheck_rounds

    def counted(lf, cache, *a):
        calls.append((cache.device.type, cache.ell))
        return orig(lf, cache, *a)

    monkeypatch.setattr(SD, "device_sumcheck_rounds", counted)
    (tmp_path / "doc.txt").write_text("aaaaaaaab")
    argv = ["ascii", "-d", "doc.txt", "-r", ".*b"]
    _run(cli.main, argv[:1] + ["--commit"] + argv[1:] + ["--device", "cpu"])
    _run(cli.main, argv[:1] + ["--prove"] + argv[1:] + ["--device", "cpu"])
    assert sorted(set(calls)) == [("cpu", 3), ("cpu", 4)]
    assert "Verification PASSED" in _run(ref_cli.main,
                                         argv[:1] + ["--verify"] + argv[1:])


def _three_products(lf, t0, t1, e0, e1):
    """The coefficient kernel's arithmetic in plain limb ops: xsq = sum ts
    es, con = sum t0 e0, x = sum t1 e1 - xsq - con."""
    a0, a1, b0, b1 = (limb.split32(x) for x in (t0, t1, e0, e1))
    xsq = K._tree_sum(lf, limb.mul(lf, limb.sub(lf, a1, a0),
                                   limb.sub(lf, b1, b0)))
    con = K._tree_sum(lf, limb.mul(lf, a0, b0))
    x = limb.sub(lf, limb.sub(lf, K._tree_sum(lf, limb.mul(lf, a1, b1)),
                              xsq), con)
    return torch.stack([limb.join16(v) for v in (xsq, x, con)])


@pytest.mark.parametrize("lf", [limb.FQ, limb.FP], ids=["fq", "fp"])
@pytest.mark.parametrize("half", [1, 2, 256])
@pytest.mark.parametrize("table", ["random", "p-1"])
def test_three_products_match_four(lf, half, table):
    """x = sum t1 e1 - xsq - con equals the reference's sum (es t0 + ts
    e0) in python ints, and the kernel's three-product arithmetic gives
    coeffs_plain's four-product limbs, on random tables and on tables of
    p - 1 (every sum and difference wraps)."""
    p = lf.p_int
    if table == "random":
        rows = [_rows(2 * half, 31), _rows(2 * half, 32)]
    else:
        rows = [lf.encode32([p - 1] * (2 * half), "cpu")] * 2
    T, E = rows
    halves = (T[:, :half], T[:, half:], E[:, :half], E[:, half:])
    t0, t1, e0, e1 = (lf.decode32(h) for h in halves)
    ts = [(b - a) % p for a, b in zip(t0, t1)]
    es = [(b - a) % p for a, b in zip(e0, e1)]
    xsq = sum(a * b for a, b in zip(ts, es)) % p
    con = sum(a * b for a, b in zip(t0, e0)) % p
    four = sum(e * a + d * b for e, a, d, b in zip(es, t0, ts, e0)) % p
    assert (sum(a * b for a, b in zip(t1, e1)) - xsq - con) % p == four
    g, _ = K.coeffs_plain(lf, *halves)
    assert [lf.decode32(g[c])[0] for c in range(3)] == [xsq, four, con]
    assert torch.equal(_three_products(lf, *halves), g)


@pytest.mark.parametrize("log_half", range(20))
def test_coeff_plan_is_one_launch_a_round(log_half, monkeypatch,
                                          stand_in_card):
    """At every half of a 2^20-entry sumcheck the coefficient pass is one
    launch, of whole warps, within the kernel's block and the plan's
    grid, with a partials buffer and the ticket exactly when it has more
    than one block (a stand-in library records the call)."""
    half = 1 << log_half
    grid, threads = K.coeff_plan(half)
    assert 32 <= threads <= K.THREADS and threads % 32 == 0
    assert 1 <= grid <= K.MAX_BLOCKS
    assert grid == 1 or threads == K.THREADS
    assert grid * threads >= min(half, K.MAX_BLOCKS * K.THREADS)
    if grid == 1:
        assert threads >= half or threads == K.THREADS
    calls = []

    class Lib:
        def reef_sc_coeffs(self, t0, t1, e0, e1, st, se, n, grid_, threads_,
                           partial, ticket, g, si, so, t, field, stream):
            assert stand_in_card.current == T.device
            calls.append((n, grid_, threads_, partial != 0, ticket != 0,
                          so != 0, t))
            return 0

    monkeypatch.setattr(K.cudabuild, "library", lambda name: Lib())
    monkeypatch.setattr(K.cudabuild, "on_card", lambda name, t: True)
    lf = limb.FQ
    T = torch.zeros((8, 2 * half), dtype=torch.int32)
    st = torch.zeros((9, 8, 1), dtype=torch.int32)
    before = cudabuild.launch_counts()["sumcheck_coeffs"]
    K.coeffs(lf, T[:, :half], T[:, half:], T[:, :half], T[:, half:], st)
    assert cudabuild.launch_counts()["sumcheck_coeffs"] == before + 1
    assert calls == [(half, grid, threads, grid > 1, grid > 1, True, 9)]
