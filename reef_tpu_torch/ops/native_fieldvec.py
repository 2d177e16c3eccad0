"""ctypes bridge to native/fieldvec.cpp: the prover's host hot loops.

Covers the exact loops the reference runs under rug/GMP + rayon
(r1cs_helper.rs:441-506 and nova's folding): sparse matvec, Nova cross
terms, vector folds, Spartan sumcheck round evaluations, eq-table builds.
Every entry point has a pure-python fallback at the call sites, so the
toolchain is optional.

Conventions: field elements cross the boundary as 32-byte little-endian;
`field` is 0 for P (pallas base / vesta scalar) and 1 for Q.  Montgomery-
domain buffers ("_m") stay opaque to python and are cached across calls
(per-shape constants, sumcheck tables across rounds).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

from . import field as F

FIELD_ID = {F.P: 0, F.Q: 1}

_LIB = None
_BUILD_FAILED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    try:
        from ..utils.nativebuild import build_native_lib, native_src
        so = build_native_lib(native_src("fieldvec.cpp"), "libfieldvec")
        lib = ctypes.CDLL(so)
        B = ctypes.c_char_p          # accepts bytes / string buffers
        Buf = ctypes.c_void_p        # mutable buffers
        I64 = ctypes.c_int64
        IP = ctypes.POINTER(ctypes.c_int64)
        C = ctypes.c_int
        lib.fv_to_mont.argtypes = [Buf, B, I64, C]
        lib.fv_from_mont.argtypes = [Buf, Buf, I64, C]
        lib.fv_fold.argtypes = [Buf, B, B, B, I64, C]
        lib.fv_matvec.argtypes = [Buf, IP, IP, B, I64, B, I64, I64, C]
        lib.fv_cross.argtypes = [Buf, B, B, B, B, B, B, B, I64, C]
        lib.fv_sc1_evals.argtypes = [Buf, Buf, Buf, Buf, Buf, Buf, B,
                                     I64, C]
        lib.fv_sc2_evals.argtypes = [Buf, Buf, Buf, I64, C]
        lib.fv_nl_round.argtypes = [Buf, Buf, Buf, I64, C]
        lib.fv_fold_mont.argtypes = [Buf, B, I64, C]
        lib.fv_scale_mont.argtypes = [Buf, B, I64, C]
        lib.fv_add_at.argtypes = [Buf, I64, B, C]
        lib.fv_eq_evals.argtypes = [Buf, B, I64, C]
        lib.fv_mtab.argtypes = [Buf, IP, IP, B, I64, Buf, B, C]
        lib.fv_bilinear.argtypes = [Buf, IP, IP, B, I64, Buf, Buf, C]
        lib.fv_dot.argtypes = [Buf, B, B, I64, C]
        lib.fv_witness.argtypes = [Buf, IP, IP, B, IP, I64, C]
        lib.fv_gather.argtypes = [Buf, B, IP, I64]
        lib.fv_poseidon.argtypes = [Buf, I64, B, B, I64, I64, C]
        for fn in ("fv_to_mont", "fv_from_mont", "fv_fold", "fv_matvec",
                   "fv_cross", "fv_sc1_evals", "fv_sc2_evals", "fv_nl_round",
                   "fv_fold_mont", "fv_scale_mont", "fv_add_at",
                   "fv_eq_evals", "fv_mtab", "fv_bilinear", "fv_dot",
                   "fv_witness", "fv_gather", "fv_poseidon"):
            getattr(lib, fn).restype = None
        _LIB = lib
    except Exception:
        _BUILD_FAILED = True
    return _LIB


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack(vals: Sequence[int], p: int) -> bytes:
    if isinstance(vals, PackedVec) and vals.p == p:
        return vals.raw
    return b"".join((v % p).to_bytes(32, "little") for v in vals)


def unpack(buf, n: int) -> List[int]:
    mv = bytes(buf)
    return [int.from_bytes(mv[32 * i:32 * i + 32], "little")
            for i in range(n)]


class PackedVec:
    """Canonical-form packed field vector (32 B little-endian / element).

    The native vector ops return these so CHAINED calls (matvec ->
    cross_term -> fold_vec, fold after fold) skip the int<->bytes
    round-trip that dominated the host profile (~3 s / 1 KB prove in
    int.to_bytes alone).  Quacks like a read-only list of ints:
    iteration / indexing / len materialize (and cache) the int list
    lazily, so exit points (commit MSMs, spartan padding, transcripts)
    need no changes."""

    __slots__ = ("raw", "n", "p", "_ints")

    def __init__(self, raw: bytes, n: int, p: int):
        self.raw = raw
        self.n = n
        self.p = p
        self._ints = None

    def ints(self) -> List[int]:
        if self._ints is None:
            self._ints = unpack(self.raw, self.n)
        return self._ints

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return iter(self.ints())

    def __getitem__(self, i):
        return self.ints()[i]

    def __add__(self, other):                 # list-style concatenation
        return self.ints() + list(other)

    def __radd__(self, other):
        return list(other) + self.ints()

    def __eq__(self, other):
        if isinstance(other, PackedVec):
            return self.p == other.p and self.raw == other.raw
        if isinstance(other, (list, tuple)):
            return self.ints() == list(other)
        return NotImplemented

    __hash__ = None

    def pad_to(self, m: int) -> "PackedVec":
        """Zero-extend to m elements (bytes append, no materialization)."""
        if m <= self.n:
            return self
        return PackedVec(self.raw + b"\0" * (32 * (m - self.n)), m, self.p)

    def at(self, i: int) -> int:
        """Single-element read without materializing the whole vector."""
        if self._ints is not None:
            return self._ints[i]
        if i < 0:                     # list semantics (raw[-32:0] would
            i += self.n               # silently read as 0 otherwise)
        if not 0 <= i < self.n:
            raise IndexError(i)
        return int.from_bytes(self.raw[32 * i:32 * i + 32], "little")


def _c_i64(arr: Sequence[int]):
    return (ctypes.c_int64 * len(arr))(*arr)


def poseidon_perm_native(p: int, state: Sequence[int], rc_mont: bytes,
                         mds_mont: bytes, r_f: int, r_p: int) -> List[int]:
    """One host Poseidon permutation in C (fv_poseidon); constants are
    pre-packed Montgomery buffers cached by the caller."""
    lib = _load()
    t = len(state)
    buf = ctypes.create_string_buffer(pack(state, p), 32 * t)
    lib.fv_poseidon(buf, ctypes.c_int64(t), rc_mont, mds_mont,
                    ctypes.c_int64(r_f), ctypes.c_int64(r_p), FIELD_ID[p])
    return unpack(buf.raw, t)


def gather_packed(pv: PackedVec, idx_c, n_out: int) -> PackedVec:
    """out[k] = pv[idx[k]] as a PackedVec (C memcpy gather; `idx_c` is a
    ctypes int64 array, cacheable at the caller)."""
    lib = _load()
    out = ctypes.create_string_buffer(32 * n_out)
    lib.fv_gather(out, pv.raw, idx_c, n_out)
    return PackedVec(out.raw, n_out, pv.p)


def to_mont(vals: Sequence[int], p: int) -> bytes:
    lib = _load()
    fid = FIELD_ID[p]
    buf = pack(vals, p)
    out = ctypes.create_string_buffer(len(buf))
    lib.fv_to_mont(out, buf, len(vals), fid)
    return out.raw


# ---------------------------------------------------------------------------
# vector ops (int lists in / out)
# ---------------------------------------------------------------------------

def fold_vec(a: Sequence[int], b: Sequence[int], r: int, p: int
             ) -> List[int]:
    """a + r*b elementwise."""
    lib = _load()
    n = len(a)
    fid = FIELD_ID[p]
    ab = pack(a, p)
    bb = pack(b, p)
    rb = pack([r], p)
    out = ctypes.create_string_buffer(32 * n)
    lib.fv_fold(out, ab, bb, rb, n, fid)
    return PackedVec(out.raw, n, p)


def cross_term(az1, bz1, cz1, az2, bz2, cz2, u1: int, p: int) -> List[int]:
    lib = _load()
    n = len(az1)
    fid = FIELD_ID[p]
    bufs = [pack(v, p) for v in (az1, bz1, cz1, az2, bz2, cz2)]
    ub = pack([u1], p)
    out = ctypes.create_string_buffer(32 * n)
    lib.fv_cross(out, *bufs, ub, n, fid)
    return PackedVec(out.raw, n, p)


class SparseMat:
    """COO matrix with cached Montgomery-domain values + index arrays."""

    def __init__(self, coo: Sequence[Tuple[int, int, int]], p: int):
        self.p = p
        self.fid = FIELD_ID[p]
        self.nnz = len(coo)
        self.rows = _c_i64([t[0] for t in coo])
        self.cols = _c_i64([t[1] for t in coo])
        self.vals_m = to_mont([t[2] for t in coo], p)
        self.max_col = max((t[1] for t in coo), default=0)

    @classmethod
    def from_packed(cls, rows, cols, vals: bytes, p: int) -> "SparseMat":
        """Zero-conversion construction from R1CSShape's packed COO form
        (int64 arrays + canonical 32B-LE values)."""
        self = cls.__new__(cls)
        self.p = p
        self.fid = FIELD_ID[p]
        n = len(rows)
        self.nnz = n
        self.rows = (ctypes.c_int64 * n).from_buffer_copy(rows.tobytes()) \
            if n else (ctypes.c_int64 * 0)()
        self.cols = (ctypes.c_int64 * n).from_buffer_copy(cols.tobytes()) \
            if n else (ctypes.c_int64 * 0)()
        lib = _load()
        out = ctypes.create_string_buffer(len(vals))
        lib.fv_to_mont(out, vals, n, self.fid)
        self.vals_m = out.raw
        self.max_col = max(cols) if n else 0
        return self

    def matvec(self, z: Sequence[int], n_out: int) -> "PackedVec":
        lib = _load()
        zb = pack(z, self.p)
        out = ctypes.create_string_buffer(32 * n_out)
        lib.fv_matvec(out, self.rows, self.cols, self.vals_m, self.nnz,
                      zb, len(z), n_out, self.fid)
        return PackedVec(out.raw, n_out, self.p)

    def mtab_accum(self, mtab_m: ctypes.Array, eq_rx_m: bytes, coeff: int):
        """mtab[col] += coeff * val * eq_rx[row]  (Montgomery in-place)."""
        lib = _load()
        cb = pack([coeff], self.p)
        lib.fv_mtab(mtab_m, self.rows, self.cols, self.vals_m, self.nnz,
                    eq_rx_m, cb, self.fid)


def shape_mats(shape) -> Optional[Tuple[SparseMat, SparseMat, SparseMat]]:
    """Per-R1CSShape cached native matrices (None if no toolchain)."""
    if not available():
        return None
    cached = getattr(shape, "_fv_mats", None)
    if cached is None:
        p = shape.f.p
        packed = getattr(shape, "_packed_mats", None)
        if packed is not None:
            cached = tuple(SparseMat.from_packed(r, c, v, p)
                           for (r, c, v) in packed)
        else:
            cached = (SparseMat(shape.A, p), SparseMat(shape.B, p),
                      SparseMat(shape.C, p))
        shape._fv_mats = cached
    return cached


# ---------------------------------------------------------------------------
# sumcheck tables (opaque Montgomery buffers across rounds)
# ---------------------------------------------------------------------------

class MontTable:
    def __init__(self, vals: Sequence[int], p: int, _raw: bytes = None):
        self.p = p
        self.fid = FIELD_ID[p]
        if _raw is not None:
            self.buf = ctypes.create_string_buffer(_raw, len(_raw))
            self.n = len(_raw) // 32
        else:
            raw = to_mont(vals, p)
            self.buf = ctypes.create_string_buffer(raw, len(raw))
            self.n = len(vals)

    def fold(self, r: int):
        lib = _load()
        half = self.n // 2
        rb = pack([r], self.p)
        lib.fv_fold_mont(self.buf, rb, half, self.fid)
        self.n = half

    def first(self) -> int:
        lib = _load()
        out = ctypes.create_string_buffer(32)
        lib.fv_from_mont(out, self.buf, 1, self.fid)
        return int.from_bytes(out.raw, "little")

    def copy(self) -> "MontTable":
        """O(n) memcpy clone — lets a cached table survive in-place folds."""
        t = MontTable.__new__(MontTable)
        t.p = self.p
        t.fid = self.fid
        t.n = self.n
        t.buf = ctypes.create_string_buffer(self.buf.raw[:32 * self.n],
                                            32 * self.n)
        return t

    def scale(self, r: int):
        """tab[i] *= r, in place."""
        lib = _load()
        lib.fv_scale_mont(self.buf, pack([r], self.p), self.n, self.fid)

    def add_at(self, idx: int, v: int):
        """tab[idx] += v, in place."""
        lib = _load()
        lib.fv_add_at(self.buf, ctypes.c_int64(idx), pack([v], self.p),
                      self.fid)


def sc1_evals(eq: MontTable, az: MontTable, bz: MontTable, cz: MontTable,
              e: MontTable, u: int, p: int) -> List[int]:
    lib = _load()
    half = eq.n // 2
    um = to_mont([u], p)
    out = ctypes.create_string_buffer(32 * 4)
    lib.fv_sc1_evals(out, eq.buf, az.buf, bz.buf, cz.buf, e.buf, um,
                     half, FIELD_ID[p])
    return unpack(out.raw, 4)


def nl_round(t: MontTable, eq: MontTable, p: int) -> List[int]:
    """(xsq, x, con) coefficients of one nlookup sumcheck round."""
    lib = _load()
    half = t.n // 2
    out = ctypes.create_string_buffer(32 * 3)
    lib.fv_nl_round(out, t.buf, eq.buf, half, FIELD_ID[p])
    return unpack(out.raw, 3)


def sc2_evals(m: MontTable, zt: MontTable, p: int) -> List[int]:
    lib = _load()
    half = m.n // 2
    out = ctypes.create_string_buffer(32 * 3)
    lib.fv_sc2_evals(out, m.buf, zt.buf, half, FIELD_ID[p])
    return unpack(out.raw, 3)


def eq_evals_mont(point: Sequence[int], p: int) -> MontTable:
    """eq table at `point` (MSB-first), returned as a Montgomery table."""
    lib = _load()
    l = len(point)
    pb = pack(point, p)
    out = ctypes.create_string_buffer(32 * (1 << l))
    lib.fv_eq_evals(out, pb, l, FIELD_ID[p])
    t = MontTable.__new__(MontTable)
    t.p = p
    t.fid = FIELD_ID[p]
    t.buf = out
    t.n = 1 << l
    return t


def eq_evals_native(point: Sequence[int], p: int) -> "PackedVec":
    """All 2^l eq-table values as a PackedVec: downstream consumers
    (_scalar_buf, pack, FV.dot) reuse the raw bytes — the int unpacking
    plus re-packing of the 2^15-slot tables was a visible slice of the
    warm 1 KB prove profile."""
    lib = _load()
    t = eq_evals_mont(point, p)
    out = ctypes.create_string_buffer(32 * t.n)
    lib.fv_from_mont(out, t.buf, t.n, FIELD_ID[p])
    return PackedVec(out.raw, t.n, p)


def bilinear(mat: SparseMat, eq_rx_m: "MontTable", eq_ry_m: "MontTable"
             ) -> int:
    """sum over the matrix of val * eq_rx[row] * eq_ry[col]."""
    lib = _load()
    out = ctypes.create_string_buffer(32)
    lib.fv_bilinear(out, mat.rows, mat.cols, mat.vals_m, mat.nnz,
                    eq_rx_m.buf, eq_ry_m.buf, mat.fid)
    return int.from_bytes(out.raw, "little")


def dot(a: Sequence[int], b: Sequence[int], p: int) -> int:
    lib = _load()
    ab = pack(a, p)
    bb = pack(b, p)
    out = ctypes.create_string_buffer(32)
    lib.fv_dot(out, ab, bb, len(a), FIELD_ID[p])
    return int.from_bytes(out.raw, "little")


# ---------------------------------------------------------------------------
# witness-program interpreter (backend/r1cs.py CompiledCircuit.witness)
# ---------------------------------------------------------------------------

_OP_KIND = {"lc": 0, "mul": 1, "bit": 2, "inv0": 3, "eq0": 4}


def _tpl_block(tpl, p: int):
    """Precompiled witness-op block for a Poseidon stamping template
    (backend/r1cs._PoseidonTemplate), cached on the template object:
    (ops (n,4) int64 over TEMPLATE wires / 0-based local lc ids,
     lc ends (cumulative, local), lc cols (template wires),
     Montgomery coeff bytes, n_cols).  Splicing = wire renumbering via the
    stamp's m_np + lc id/offset shifts — no per-entry python work."""
    import numpy as _np
    blk = getattr(tpl, "_fv_block", None)
    if blk is not None and blk[5] == p:
        return blk[:5]
    ops: List[int] = []
    ends: List[int] = []
    cols: List[int] = []
    coeffs: List[int] = []
    for idx, op in tpl.computers:
        kind = _OP_KIND[op[0]]
        for k, v in op[1].items():
            cols.append(k)
            coeffs.append(v % p)
        ends.append(len(cols))
        a = len(ends) - 1
        if kind == 1:
            for k, v in op[2].items():
                cols.append(k)
                coeffs.append(v % p)
            ends.append(len(cols))
            b = len(ends) - 1
        else:
            b = 0
        ops.extend((kind, idx, a, b))
    blk = (_np.asarray(ops, dtype=_np.int64).reshape(-1, 4),
           _np.asarray(ends, dtype=_np.int64),
           _np.asarray(cols, dtype=_np.int64),
           to_mont(coeffs, p), len(cols), p)
    tpl._fv_block = blk
    return blk[:5]


class WitnessProgram:
    """Compiled form of a ConstraintSystem's ordered witness computers.

    Tagged ops (mul / bit / lc / inv0 / eq0 — 99.8% of a step circuit)
    execute in C over a 32B/elem standard-form z buffer; untagged python
    closures run in segments between native spans, with the python int
    list synced lazily by index watermark.  ~10x on the per-step witness
    evaluation (the reference's StagedWitCompEvaluator role,
    framework.rs:561-572)."""

    def __init__(self, cs):
        import numpy as _np
        p = cs.f.p
        self.p = p
        self.fid = FIELD_ID[p]
        self.n_vars = cs.n_vars
        # lc tables accumulate in CHUNKS: plain ops append python lists,
        # stamped template segments splice precompiled numpy/Montgomery
        # blocks (wire-renumbered in one vectorized shot) — per-entry
        # python compilation of the ~60k template ops per augmented
        # circuit dominated program-build time
        lc_off = [0]                  # absolute cumulative entry ends
        col_chunks: List[object] = []
        coeff_chunks: List[bytes] = []
        cols: List[int] = []          # current plain chunk
        coeffs: List[int] = []
        col_base = 0

        def flush_lc():
            nonlocal col_base
            if cols:
                col_chunks.append(_np.asarray(cols, dtype=_np.int64))
                coeff_chunks.append(to_mont(coeffs, p))
                col_base += len(cols)
                cols.clear()
                coeffs.clear()

        def add_lc(lc) -> int:
            for k, v in lc.items():
                cols.append(k)
                coeffs.append(v % p)
            lc_off.append(col_base + len(cols))
            return len(lc_off) - 2

        # segments: ("n", ops_c_array, count) | ("p", [(idx, fn), ...])
        segs = []
        cur_native: List[int] = []
        cur_py: List[tuple] = []

        def flush_native():
            if cur_native:
                segs.append(("n", _c_i64(cur_native),
                             len(cur_native) // 4))
                cur_native.clear()

        def flush_py():
            if cur_py:
                segs.append(("p", list(cur_py)))
                cur_py.clear()

        items = cs.computers.items() if hasattr(cs.computers, "items") \
            else [("c", idx, fn, op) for idx, fn, op in cs.computers]
        for it in items:
            if it[0] == "s":
                _, tpl, _m, m_np, _cs = it
                flush_py()
                flush_native()
                flush_lc()
                ops, ends, tcols, tcoef, ncols = _tpl_block(tpl, p)
                ops2 = ops.copy()
                ops2[:, 1] = m_np[ops[:, 1]]            # output wires
                shift = len(lc_off) - 1                 # lc id offset
                ops2[:, 2] += shift
                mulm = ops[:, 0] == 1                   # mul's b is an lc id
                ops2[mulm, 3] += shift
                flat = ops2.ravel()
                arr = (ctypes.c_int64 * flat.size).from_buffer_copy(
                    flat.tobytes())
                segs.append(("n", arr, len(ops)))
                lc_off.extend((ends + col_base).tolist())
                col_chunks.append(m_np[tcols])
                coeff_chunks.append(tcoef)
                col_base += ncols
                continue
            _, idx, fn, op = it
            if op is None:
                flush_native()
                cur_py.append((idx, fn))
                continue
            flush_py()
            kind = _OP_KIND[op[0]]
            if kind == 1:            # mul: two LCs
                a = add_lc(op[1])
                b = add_lc(op[2])
            elif kind == 2:          # bit: LC + shift
                a = add_lc(op[1])
                b = op[2]
            else:                    # lc / inv0 / eq0
                a = add_lc(op[1])
                b = 0
            cur_native.extend((kind, idx, a, b))
        flush_native()
        flush_py()
        flush_lc()
        self.segs = segs
        self.lc_off = _c_i64(lc_off)
        if col_chunks:
            allc = col_chunks[0] if len(col_chunks) == 1 \
                else _np.concatenate(col_chunks)
            self.lc_cols = (ctypes.c_int64 * allc.size).from_buffer_copy(
                allc.tobytes())
        else:
            self.lc_cols = _c_i64([])
        self.lc_coeff_m = b"".join(coeff_chunks)

    def run(self, z: List[int], inputs) -> List[int]:
        buf = self._run_buf(z)
        n = self.n_vars
        raw = memoryview(buf).cast("B")
        for i in range(n):
            z[i] = int.from_bytes(raw[32 * i:32 * i + 32], "little")
        return z

    def run_packed(self, z: List[int], inputs) -> PackedVec:
        """Like run() but returns the packed wire buffer directly — the
        consumers (split_wires gather, commit MSMs, z_vector) are all
        packed-native, so the full int round-trip is skipped."""
        return PackedVec(bytes(self._run_buf(z).raw), self.n_vars, self.p)

    def _run_buf(self, z: List[int]) -> ctypes.Array:
        lib = _load()
        p = self.p
        n = self.n_vars
        buf = ctypes.create_string_buffer(32 * n)
        mv = memoryview(buf).cast("B")
        for i, v in enumerate(z):
            if v:
                mv[32 * i:32 * i + 32] = v.to_bytes(32, "little")
        synced = 0                    # z[i] for i < synced reflects buf

        def sync_to(k):
            nonlocal synced
            raw = mv
            for i in range(synced, k):
                z[i] = int.from_bytes(raw[32 * i:32 * i + 32], "little")
            synced = k

        for seg in self.segs:
            if seg[0] == "n":
                _, ops, cnt = seg
                lib.fv_witness(buf, self.lc_off, self.lc_cols,
                               self.lc_coeff_m, ops, cnt, self.fid)
            else:
                for idx, fn in seg[1]:
                    sync_to(idx)      # closure may read any earlier wire
                    v = fn(z) % p
                    z[idx] = v
                    mv[32 * idx:32 * idx + 32] = v.to_bytes(32, "little")
                    synced = idx + 1
        return buf


def witness_program(cs) -> Optional[WitnessProgram]:
    prog = getattr(cs, "_native_wit_prog", None)
    if prog is False:
        return None
    if prog is not None:
        return prog
    try:
        prog = WitnessProgram(cs)
    except Exception:
        cs._native_wit_prog = False
        return None
    cs._native_wit_prog = prog
    return prog
