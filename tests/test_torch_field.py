"""reef_tpu_torch field layer against the JAX package and python ints.

The port's plain field ops (ops/limb.py, sixteen 16-bit limbs in int64)
must give the same canonical Montgomery integers as the JAX package's
limb ops (reef_tpu.ops.limb) on the same inputs: both use R = 2^256, so
any difference is a bug.  The CUDA header's constants and carry chains
(csrc/field.cuh) are checked here too, by reading the header and running
its PTX chains through a small python emulation, since no CUDA compiler
runs on the CPU.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_card_support import mxu_range_cols
from _torch_support import (no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu.ops import limb as ref_limb
from reef_tpu_torch import convert
from reef_tpu_torch.ops import limb

FIELDS = {"fp": (limb.FP, ref_limb.FP), "fq": (limb.FQ, ref_limb.FQ)}

_ref_add = jax.jit(ref_limb.add, static_argnums=0)
_ref_sub = jax.jit(ref_limb.sub, static_argnums=0)
_ref_redc = jax.jit(ref_limb.redc_cols, static_argnums=0)


def _values(p: int, seed: int, n: int = 61):
    """0, 1, 2, p-1, p-2, 2^255 mod p, 2^254 and random values below p."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, 2, p - 1, p - 2, (1 << 255) % p, 1 << 254]
    while len(vals) < n:
        words = rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
        vals.append(sum(int(w) << (32 * i) for i, w in enumerate(words)) % p)
    return vals


def _to_ref(lf, t: torch.Tensor) -> np.ndarray:
    """Port (16, n) int64 -> reference (n, 16) uint32 (same integers)."""
    return np.ascontiguousarray(t.numpy().T.astype(np.uint32))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_encode_decode_both_layouts(name):
    lf, rf = FIELDS[name]
    vals = _values(lf.p_int, 1)
    t16 = lf.encode(vals)
    t32 = lf.encode32(vals)
    assert t16.shape == (16, len(vals)) and t16.dtype == torch.int64
    assert t32.shape == (8, len(vals)) and t32.dtype == torch.int32
    assert lf.decode(t16) == vals
    assert lf.decode32(t32) == vals
    assert torch.equal(limb.split32(t32), t16)
    assert torch.equal(limb.join16(t16), t32)
    # the same Montgomery integers as the reference's host encode
    np.testing.assert_array_equal(_to_ref(lf, t16), rf.encode_host(vals))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_ops_match_reference_and_ints(name):
    lf, rf = FIELDS[name]
    p = lf.p_int
    xs = _values(p, 2)
    ys = list(reversed(_values(p, 3)))
    a, b = lf.encode(xs), lf.encode(ys)
    ra, rb = jnp.asarray(rf.encode_host(xs)), jnp.asarray(rf.encode_host(ys))

    got_mul = limb.mul(lf, a, b)
    got_add = limb.add(lf, a, b)
    got_sub = limb.sub(lf, a, b)
    np.testing.assert_array_equal(_to_ref(lf, got_mul),
                                  np.asarray(ref_limb.mul_jit(rf, ra, rb)))
    np.testing.assert_array_equal(_to_ref(lf, got_add),
                                  np.asarray(_ref_add(rf, ra, rb)))
    np.testing.assert_array_equal(_to_ref(lf, got_sub),
                                  np.asarray(_ref_sub(rf, ra, rb)))

    assert lf.decode(got_mul) == [x * y % p for x, y in zip(xs, ys)]
    assert lf.decode(got_add) == [(x + y) % p for x, y in zip(xs, ys)]
    assert lf.decode(got_sub) == [(x - y) % p for x, y in zip(xs, ys)]
    assert lf.decode(limb.neg(lf, a)) == [(-x) % p for x in xs]
    assert lf.decode(limb.sqr(lf, a)) == [x * x % p for x in xs]
    assert lf.decode(limb.pow5(lf, a)) == [pow(x, 5, p) for x in xs]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_redc_cols_matches_reference(name):
    """REDC of column sums: a product's 32 schoolbook columns (port only:
    they exceed 32 bits), then columns below 2^30 whose value is below
    p*R, the reference kernel's input range."""
    lf, rf = FIELDS[name]
    p = lf.p_int
    xs, ys = _values(p, 4), _values(p, 5)
    a, b = lf.encode(xs), lf.encode(ys)
    cols = torch.zeros((32, len(xs)), dtype=torch.int64)
    for i in range(16):
        cols[i:i + 16] += a[i] * b
    assert torch.equal(limb.redc_cols(lf, cols), limb.mul(lf, a, b))

    rng = np.random.default_rng(9)
    cols = rng.integers(0, 1 << 30, size=(32, 40), dtype=np.int64)
    cols[30:] = 0
    got = limb.redc_cols(lf, torch.from_numpy(cols))
    want = _ref_redc(rf, jnp.asarray(cols.T.astype(np.uint32)))
    np.testing.assert_array_equal(_to_ref(lf, got), np.asarray(want))
    rinv = pow(1 << 256, -1, p)
    values = [sum(int(cols[k, j]) << (16 * k) for k in range(32))
              for j in range(cols.shape[1])]
    assert [lf.mont(x) for x in lf.decode(got)] == [v * rinv % p
                                                   for v in values]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_redc_cols_mxu_range_matches_reference(name):
    """Values in [pR, 5p^2) as 32 columns below 2^31: the REDC leaves up
    to ~2.3p, so it takes two conditional subtracts to be canonical, as
    the reference's `redc_cols` does."""
    lf, rf = FIELDS[name]
    p = lf.p_int
    cols = mxu_range_cols(p, 64, {"fp": 21, "fq": 22}[name])
    got = limb.redc_cols(lf, torch.from_numpy(cols))
    want = _ref_redc(rf, jnp.asarray(cols.T.astype(np.uint32)))
    np.testing.assert_array_equal(_to_ref(lf, got), np.asarray(want))
    rinv = pow(1 << 256, -1, p)
    values = [sum(int(cols[k, j]) << (16 * k) for k in range(32))
              for j in range(cols.shape[1])]
    raw = limb._words_to_ints(got.numpy().T, 16)
    assert raw == [v * rinv % p for v in values]


def test_limb_conversion_roundtrip():
    rng = np.random.default_rng(6)
    a16 = rng.integers(0, 1 << 16, size=(5, 16, 7), dtype=np.uint32)
    a32 = convert.limbs16_to_32(a16, axis=1)
    assert a32.shape == (5, 8, 7) and a32.dtype == np.int32
    np.testing.assert_array_equal(convert.limbs32_to_16(a32, axis=1), a16)
    # the same packing as the port's own split/join
    t = torch.from_numpy(a32[0])
    np.testing.assert_array_equal(limb.split32(t).numpy(), a16[0])


# ---------------------------------------------------------------------------
# csrc/field.cuh, read on the CPU
# ---------------------------------------------------------------------------

_CUH = os.path.join(os.path.dirname(__file__), os.pardir, "reef_tpu_torch",
                    "csrc", "field.cuh")
M32 = 0xFFFFFFFF


def _header() -> str:
    with open(_CUH) as fh:
        return fh.read()


def _const_table(src: str, name: str):
    body = re.search(name + r"\[2\](?:\[8\])?\s*=\s*\{(.*?)\};", src,
                     re.S).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-fA-F]+)u", body)]
    if len(words) == 2:
        return words
    return [sum(w << (32 * i) for i, w in enumerate(words[8 * f:8 * f + 8]))
            for f in range(2)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_cuda_header_constants(name):
    lf, _ = FIELDS[name]
    src = _header()
    fid = lf.field_id
    p = lf.p_int
    assert _const_table(src, "FIELD_P")[fid] == p
    assert _const_table(src, "FIELD_N0")[fid] == lf.n0inv32
    assert (p * lf.n0inv32 + 1) % (1 << 32) == 0
    assert _const_table(src, "FIELD_B3")[fid] == lf.mont(15)
    assert _const_table(src, "FIELD_ONE")[fid] == lf.r_int
    assert _const_table(src, "FIELD_R2")[fid] == lf.r_int * lf.r_int % p


def _asm_chain(src: str, fn: str):
    """The instructions of the first asm statement after `fn`."""
    i = src.index(fn)
    j = src.index("asm(", i)
    body = src[j + 4:src.index(":", j)]
    text = "".join(re.findall(r'"([^"]*)"', body))
    text = text.replace("\\n", "").replace("\\t", "")
    return [ins.strip() for ins in text.split(";") if ins.strip()]


def _run_chain(chain, ops):
    """Emulate mad/madc/add/addc/sub/subc with .lo/.hi/.cc on u32."""
    cf = 0
    for ins in chain:
        op, args = ins.split(None, 1)
        a = [s.strip() for s in args.split(",")]
        src = [ops[int(x[1:])] if x.startswith("%") else int(x, 0)
               for x in a[1:]]
        parts = op.split(".")
        kind, with_cf = parts[0].rstrip("c"), parts[0].endswith("c")
        cin = cf if with_cf else 0
        if kind == "mad":
            prod = src[0] * src[1]
            r = (prod & M32 if parts[1] == "lo" else prod >> 32) + src[2] + cin
        elif kind == "add":
            r = src[0] + src[1] + cin
        elif kind == "sub":
            r = src[0] - src[1] - cin
        else:
            raise ValueError(op)
        if "cc" in parts:
            cf = int(r < 0) if kind == "sub" else r >> 32
        ops[int(a[0][1:])] = r & M32


class _HeaderField:
    """fe_add / fe_sub / fe_mul of csrc/field.cuh, on 8-word lists."""

    def __init__(self, src: str, p: int):
        self.mac = _asm_chain(src, "void mac_row")
        self.sub = _asm_chain(src, "u32 sub8")
        self.add = _asm_chain(src, "void add8")
        self.p = [(p >> (32 * i)) & M32 for i in range(8)]
        self.n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)

    def mac_row(self, t, x, y):
        ops = dict(enumerate(t))
        ops.update({10 + i: x[i] for i in range(8)})
        ops[18] = y
        _run_chain(self.mac, ops)
        return [ops[i] for i in range(10)]

    def sub8(self, r, q):
        ops = {9 + i: r[i] for i in range(8)}
        ops.update({17 + i: q[i] for i in range(8)})
        ops[25] = 0
        _run_chain(self.sub, ops)
        return [ops[i] for i in range(8)], ops[8]

    def add8(self, a, b):
        ops = {8 + i: a[i] for i in range(8)}
        ops.update({16 + i: b[i] for i in range(8)})
        _run_chain(self.add, ops)
        return [ops[i] for i in range(8)]

    def reduce_once(self, r):
        s, bw = self.sub8(r, self.p)
        return [(r[i] & bw) | (s[i] & ~bw & M32) for i in range(8)]

    def fe_add(self, a, b):
        return self.reduce_once(self.add8(a, b))

    def fe_sub(self, a, b):
        d, bw = self.sub8(a, b)
        return self.add8(d, [w & bw for w in self.p])

    def fe_mul(self, a, b):
        t = [0] * 10
        for i in range(8):
            t = self.mac_row(t, a, b[i])
            t = self.mac_row(t, self.p, (t[0] * self.n0) & M32)
            assert t[0] == 0
            t = t[1:] + [0]
        assert t[8] == 0
        return self.reduce_once(t[:8])


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_cuda_header_carry_chains(name):
    """The header's PTX carry chains, emulated word by word, compute the
    canonical Montgomery product, sum and difference."""
    lf, _ = FIELDS[name]
    p = lf.p_int
    hf = _HeaderField(_header(), p)
    words = lambda x: [(x >> (32 * i)) & M32 for i in range(8)]
    num = lambda w: sum(v << (32 * i) for i, v in enumerate(w))
    xs, ys = _values(p, 7, 40), _values(p, 8, 40)[::-1]
    rinv = pow(1 << 256, -1, p)
    for x, y in zip(xs, ys):
        assert num(hf.fe_mul(words(x), words(y))) == x * y * rinv % p
        assert num(hf.fe_add(words(x), words(y))) == (x + y) % p
        assert num(hf.fe_sub(words(x), words(y))) == (x - y) % p
    # the table encode (csrc/sc_encode.cu): fe_mul(v, R^2) of a 64-bit v
    # is its Montgomery form
    r2 = words(_const_table(_header(), "FIELD_R2")[lf.field_id])
    for v in (0, 1, 255, (1 << 63) - 1, (1 << 64) - 1):
        assert num(hf.fe_mul(words(v), r2)) == lf.mont(v)
