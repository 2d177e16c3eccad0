"""reef_tpu_torch Poseidon and the device Merkle build against the JAX package.

The port's plain permutation (ops/poseidon_device.py) must give, for every
state, exactly the JAX package's host permutation
(`poseidon_constants.host_permutation`, the oracle its own
tests/test_poseidon.py holds `permute` to), for both widths and both
fields; `hash_elems` must equal the JAX package's HostSponge; the port's
own round constants and MDS must equal the reference's; and the batched
Merkle build must give the root of the reference's MerkleCommitment.
Field arithmetic is exact, so every comparison is of integers, with no
tolerance.  K5 has two launches, picked by batch size; the plain twins
of both launches' arithmetic must give the host permutation too: the
block-per-state launch's dense rounds, and the thread-per-state launch's
sparse partial rounds (`sparse_params`) with one REDC a matrix row, whose
conditional subtracts are held at the row sum's worst case.  The
reference's own permutation on the CPU is its `lax.scan` path
(`reef_tpu.ops.poseidon.permute_jit`, as its tests/test_poseidon.py runs
it): its Pallas kernel in interpret mode, one block of 1024 states at
the least, is far too slow on the CPU for a test.  Both launches
(csrc/poseidon.cu) are held against the plain version and the port's
python permutation, edge states included, on the card by
tests/test_torch_card_poseidon.py, which imports no JAX; the port's
python permutation must equal the reference's here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_card_support import edge_states as _edge_states
from _torch_card_support import from_port as _from_port
from _torch_card_support import states as _states
from _torch_card_support import to_port as _to_port
from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu.backend.merkle import MerkleCommitment
from reef_tpu.ops import field as ref_field
from reef_tpu.ops import limb as ref_limb
from reef_tpu.ops import poseidon as ref_poseidon
from reef_tpu.ops.poseidon import HostSponge, IOPattern
from reef_tpu.ops.poseidon_constants import host_permutation, poseidon_params
from reef_tpu_torch import convert
from reef_tpu_torch.backend.merkle import build_tree_device
from reef_tpu_torch.ops import limb, poseidon, poseidon_device, poseidon_kernel
from reef_tpu_torch.ops import poseidon_constants as port_constants
from reef_tpu_torch.ops.poseidon_constants import (FULL_ROUNDS,
                                                   sparse_params)
from reef_tpu_torch.utils import cudabuild

FIELDS = {"fq": (limb.FQ, ref_limb.FQ), "fp": (limb.FP, ref_limb.FP)}


def _words32(words, device="cpu") -> torch.Tensor:
    """python ints taken as raw 32-bit limb words -> (8, n) int32."""
    w = limb._ints_to_words(words, np.uint32).view(np.int32).T.copy()
    return torch.from_numpy(w).to(device)


def _sparse_permutation(p: int, state):
    """The permutation in python ints on `sparse_params`' tables."""
    t = len(state)
    full_rc, part_rc, pre, mds, rows, cols = sparse_params(p, t)
    half = FULL_ROUNDS // 2
    s = list(state)
    for r in range(FULL_ROUNDS):
        if r == half:
            for c, row, col in zip(part_rc, rows, cols):
                s[0] = pow((s[0] + c) % p, 5, p)
                s = [sum(a * b for a, b in zip(row, s)) % p] + [
                    (s[i] + col[i - 1] * s[0]) % p for i in range(1, t)]
        s = [pow((x + c) % p, 5, p) for x, c in zip(s, full_rc[r])]
        m = pre if r == half - 1 else mds
        s = [sum(a * b for a, b in zip(row, s)) % p for row in m]
    return s


@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("t", [5, 9])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_plain_permute_matches_reference(name, t, B):
    lf = FIELDS[name][0]
    states = _states(lf, t, B, seed=t * 100 + B)
    got = _from_port(lf, poseidon.permute(lf, _to_port(lf, states)))
    assert got == [host_permutation(lf.p_int, s) for s in states]


@pytest.mark.parametrize("t", [5, 9])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_constants_match_reference(name, t):
    """The port derives its own round constants and MDS."""
    lf = FIELDS[name][0]
    rc_w, mds_w = poseidon_device._device_consts(lf, t)
    rc_ref, mds_ref = poseidon_params(lf.p_int, t)
    dec = limb._words_to_ints
    assert [lf.unmont(x) for x in dec(rc_w.reshape(-1, 8), 32)] == \
        list(rc_ref)
    assert [lf.unmont(x) for x in dec(mds_w.reshape(-1, 8), 32)] == \
        [m for row in mds_ref for m in row]


@pytest.mark.parametrize("t", [5, 9])
def test_hash_elems_matches_host_sponge(t):
    lf = limb.FQ
    rows = _states(lf, t - 1, 3, seed=t)
    elems = _to_port(lf, rows)
    got = lf.decode32(poseidon.hash_elems(lf, elems, t))
    io = IOPattern([("absorb", t - 1), ("squeeze", 1)])
    want = []
    for row in rows:
        sp = HostSponge(ref_field.FQ, io, rate=t - 1)
        sp.absorb(row)
        want.append(sp.squeeze(1)[0])
    assert got == want


def test_states_carry_across_from_reference():
    """JAX-package limb arrays -> the port's layout -> permuted -> back:
    the reference's Montgomery limbs of the host permutation."""
    lf, ref_lf = FIELDS["fq"]
    states = _states(lf, 5, 3, seed=11)
    ref_arr = np.stack([ref_lf.encode_host(s) for s in states])  # (3, 5, 16)
    port = convert.states_from_reference(ref_arr)
    assert port.shape == (5, 8, 3)
    out = convert.states_to_reference(poseidon.permute(lf, port))
    want = np.stack([ref_lf.encode_host(host_permutation(lf.p_int, s))
                     for s in states])
    assert np.array_equal(out, want)
    plain = convert.plain_from_reference(ref_arr)
    assert np.array_equal(convert.plain_to_reference(plain), ref_arr)


@pytest.mark.parametrize("n", [300, 7])
def test_build_tree_device_matches_reference(n):
    rng = np.random.default_rng(n)
    udoc = [int(v) for v in rng.integers(0, 4, size=n)]
    assert build_tree_device(udoc, device="cpu") == \
        MerkleCommitment(udoc).commitment


def test_permute_on_cpu_runs_the_plain_version():
    """A CPU tensor never reaches the kernel; a width without parameters
    or a wrong dtype raises."""
    lf = limb.FQ
    before = cudabuild.launch_counts()
    x = _to_port(lf, _states(lf, 5, 2, seed=3))
    assert torch.equal(poseidon.permute(lf, x),
                       poseidon_device.permute_plain(lf, x))
    assert cudabuild.launch_counts() == before
    with pytest.raises(ValueError):
        poseidon_kernel.launch(lf, x)        # the kernel takes CUDA only
    with pytest.raises(ValueError):
        poseidon.permute(lf, x[:1])          # no parameters for t = 1
    with pytest.raises(TypeError):
        poseidon.permute(lf, x.long())


@pytest.mark.parametrize("t", [5, 9])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_spread_arithmetic_matches_reference(name, t):
    """The block-per-state launch's arithmetic, (M_ij x_j) x_j^4 summed
    row by row, in plain torch: the host permutation, exactly."""
    lf = FIELDS[name][0]
    states = _states(lf, t, 2, seed=t * 10 + 1)
    got = poseidon_device.permute_plain(lf, _to_port(lf, states), spread=True)
    assert _from_port(lf, got) == [host_permutation(lf.p_int, s)
                                   for s in states]


@pytest.mark.parametrize("t", [5, 9])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_sparse_params_reproduce_the_permutation(name, t):
    """Sparse partial rounds on `sparse_params`' tables, in python ints:
    the reference's host permutation, exactly, on random and edge
    states."""
    lf = FIELDS[name][0]
    states = _states(lf, t, 4, seed=t * 7 + 3) + _edge_states(lf, t)
    assert [_sparse_permutation(lf.p_int, s) for s in states] == \
        [host_permutation(lf.p_int, s) for s in states]


@pytest.mark.parametrize("t", [5, 9])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_sparse_arithmetic_matches_reference(name, t):
    """The thread-per-state launch's arithmetic in plain torch: sparse
    partial rounds, each matrix row's products summed as schoolbook
    columns before one REDC; the host permutation, exactly."""
    lf = FIELDS[name][0]
    states = _states(lf, t, 2, seed=t * 10 + 2) + _edge_states(lf, t)
    got = poseidon_device.permute_plain(lf, _to_port(lf, states),
                                        sparse=True)
    assert _from_port(lf, got) == [host_permutation(lf.p_int, s)
                                   for s in states]


@pytest.mark.parametrize("t,B", [(5, 8), (9, 2)])
def test_sparse_arithmetic_matches_reference_permute_jit(t, B):
    """Against the JAX package's own device permutation (its `lax.scan`
    path on the CPU), from its Montgomery limb arrays."""
    lf, ref_lf = FIELDS["fq"]
    states = _states(lf, t, B, seed=t + 40)
    ref = np.asarray(ref_lf.encode([x for s in states for x in s]))
    out = np.asarray(ref_poseidon.permute_jit(
        ref_lf, jnp.asarray(ref).reshape(B, t, ref_limb.N), t))
    want = [ref_lf.decode(out[b]) for b in range(B)]
    got = poseidon_device.permute_plain(lf, _to_port(lf, states),
                                        sparse=True)
    assert _from_port(lf, got) == want


@pytest.mark.parametrize("terms,high", [(5, False), (9, False), (1, True)])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_lazy_row_subtracts_at_the_worst_case(name, terms, high,
                                              monkeypatch):
    """A lazy row at its bound: matrix words p - 1 against state words
    p - 1 - k (and, for a partial round's lane update s_i + c_i x0, s_i
    words p - 1 - k in the upper half).  `row_subtracts` subtracts give
    the exact row; some of these rows leave the REDC above row_subtracts
    - 1 times p, so with one subtract fewer they come out wrong."""
    lf = FIELDS[name][0]
    p, R = lf.p_int, 1 << 256
    ks = range(64)
    xs = [[p - 1 - k] * terms for k in ks]
    his = [p - 1 - k for k in ks] if high else [0] * len(ks)
    T = [sum((p - 1) * x for x in row) + h * R for row, h in zip(xs, his)]
    want = [v * pow(R, -1, p) % p for v in T]
    # what the REDC leaves before its subtracts, (T + M p) / R
    pre = [(v + (-v * pow(p, -1, R) % R) * p) // R for v in T]
    n_sub = poseidon_device.row_subtracts(terms, high)
    assert max(pre) >= n_sub * p > max(pre) - p      # the bound is reached
    s = limb.split32(torch.stack([_words32([row[j] for row in xs])
                                  for j in range(terms)], dim=1))
    m = limb.split32(_words32([p - 1] * terms))[:, None, :, None]
    hi = limb.split32(_words32(his))[:, None] if high else None

    def row():
        out = limb.join16(poseidon_device._lazy_rows(lf, s, m, hi))
        return limb._words_to_ints(out[:, 0].T.numpy(), 32)
    assert row() == want
    full = poseidon_device.row_subtracts
    monkeypatch.setattr(poseidon_device, "row_subtracts",
                        lambda n, h=False: full(n, h) - 1)
    assert row() != want


def test_route_picks_one_launch_by_batch_size():
    """Below the crossover the block-per-state launch, from it on the
    thread-per-state one; every B gets exactly one of the two."""
    cross = poseidon_kernel.THREAD_MIN_B
    paths = (poseidon_kernel.THREAD, poseidon_kernel.SPREAD)
    assert len(set(paths)) == 2
    for B in (1, 2, 37, cross - 1, cross, cross + 1, 1 << 19):
        want = poseidon_kernel.SPREAD if B < cross else poseidon_kernel.THREAD
        assert poseidon_kernel.route(B) == want, B
    assert poseidon_kernel.route(1) == poseidon_kernel.SPREAD
    assert poseidon_kernel.route(1 << 19) == poseidon_kernel.THREAD


@pytest.mark.parametrize("t", [5, 9])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_port_host_permutation_matches_reference(name, t):
    """The port's python permutation, the card test's oracle, equals the
    reference's on the edge states and random ones."""
    lf = FIELDS[name][0]
    for s in _edge_states(lf, t) + _states(lf, t, 3, seed=t + 77):
        assert port_constants.host_permutation(lf.p_int, s) == \
            host_permutation(lf.p_int, s)
