"""ctypes bridge to the native C++ Pippenger MSM (native/msm.cpp).

Hooks into Curve.msm for host-side commitment work; silent fallback to the
Python Pippenger when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

_LIB = None
_BUILD_FAILED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    try:
        from ..utils.nativebuild import build_native_lib, native_src
        so = build_native_lib(native_src("msm.cpp"), "libpastamsm")
        lib = ctypes.CDLL(so)
        lib.pasta_msm.restype = None
        lib.pasta_msm_idx.restype = None
        lib.pasta_msm_idx.argtypes = [ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_char_p]
        lib.pasta_fold_points.restype = None
        lib.pasta_msm_rows.restype = None
        lib.pasta_msm_rows.argtypes = [ctypes.c_int, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_char_p]
        lib.msm_basis_init.restype = ctypes.c_void_p
        lib.msm_basis_init.argtypes = [ctypes.c_int, ctypes.c_int64,
                                       ctypes.c_char_p]
        lib.msm_basis_free.restype = None
        lib.msm_basis_free.argtypes = [ctypes.c_void_p]
        lib.pasta_msm_basis.restype = None
        lib.pasta_msm_basis.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int64),
                                        ctypes.c_char_p]
        lib.ipa_init.restype = ctypes.c_void_p
        lib.ipa_init.argtypes = [ctypes.c_int, ctypes.c_int64,
                                 ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_char_p]
        lib.ipa_cross.restype = None
        lib.ipa_cross.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_char_p]
        lib.ipa_fold.restype = None
        lib.ipa_fold.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ipa_final.restype = None
        lib.ipa_final.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ipa_free.restype = None
        lib.ipa_free.argtypes = [ctypes.c_void_p]
        lib.pasta_derive_gens.restype = None
        lib.pasta_derive_gens.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_char_p]
        _LIB = lib
    except Exception:
        _BUILD_FAILED = True
    return _LIB


def _unpack_proj(curve, raw: bytes):
    X = int.from_bytes(raw[0:32], "little")
    Y = int.from_bytes(raw[32:64], "little")
    Z = int.from_bytes(raw[64:96], "little")
    if Z == 0:
        return None
    p = curve.p
    zi = pow(Z, p - 2, p)
    return (X * zi % p, Y * zi % p)


class IpaNative:
    """Native IPA round engine: holds w/R/coeff (scalar field) and the
    Montgomery-affine basis in C; per round returns (cL, cR, mL, mR) and
    folds on the host-supplied challenge.  Transcript/blinds stay in
    Python (backend/ipa.py)."""

    def __init__(self, curve, w: List[int], R: List[int], packed: bytes):
        lib = _load()
        if lib is None:
            raise RuntimeError("native msm unavailable")
        from .pasta import PALLAS
        self.curve = curve
        self.lib = lib
        n = len(w)
        assert len(packed) >= 65 * n
        wb, _ = _scalar_buf(curve, w)
        rb, _ = _scalar_buf(curve, R)
        self.h = lib.ipa_init(ctypes.c_int(0 if curve is PALLAS else 1),
                              ctypes.c_int64(n), wb, rb, packed)

    def cross(self):
        cl = ctypes.create_string_buffer(32)
        cr = ctypes.create_string_buffer(32)
        lp = ctypes.create_string_buffer(96)
        rp = ctypes.create_string_buffer(96)
        self.lib.ipa_cross(self.h, cl, cr, lp, rp)
        return (int.from_bytes(cl.raw, "little"),
                int.from_bytes(cr.raw, "little"),
                _unpack_proj(self.curve, lp.raw),
                _unpack_proj(self.curve, rp.raw))

    def fold(self, x: int):
        self.lib.ipa_fold(
            self.h, (x % self.curve.order).to_bytes(32, "little"))

    def final(self) -> int:
        out = ctypes.create_string_buffer(32)
        self.lib.ipa_final(self.h, out)
        return int.from_bytes(out.raw, "little")

    def close(self):
        if self.h:
            self.lib.ipa_free(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _pack_points(points) -> bytearray:
    buf = bytearray(65 * len(points))
    for i, pt in enumerate(points):
        if pt is None:
            buf[65 * i + 64] = 1
        else:
            buf[65 * i:65 * i + 32] = pt[0].to_bytes(32, "little")
            buf[65 * i + 32:65 * i + 64] = pt[1].to_bytes(32, "little")
    return buf


def _unpack_points(buf, n):
    out = []
    for i in range(n):
        if buf[65 * i + 64]:
            out.append(None)
        else:
            x = int.from_bytes(bytes(buf[65 * i:65 * i + 32]), "little")
            y = int.from_bytes(bytes(buf[65 * i + 32:65 * i + 64]), "little")
            out.append((x, y))
    return out


def derive_gens_packed(curve, label: bytes, start: int,
                       count: int) -> Optional[bytes]:
    """Native bulk hash-to-curve generator derivation (bit-identical to
    Curve.hash_to_curve / Curve.gens, pasta.py:159-177): returns `count`
    points for indices [start, start+count) in the packed 65 B/point LE
    layout, or None when the native library is unavailable.  Threaded in
    C; ~1000x the python Tonelli-Shanks loop (a 2^15-point cache miss was
    ~40 s/process)."""
    lib = _load()
    if lib is None or count <= 0:
        return None
    from .pasta import PALLAS
    prefix = curve.name.encode() + b"/" + label + b"/"
    out = ctypes.create_string_buffer(65 * count)
    lib.pasta_derive_gens(ctypes.c_int(0 if curve is PALLAS else 1),
                          prefix, ctypes.c_int64(len(prefix)),
                          ctypes.c_int64(start), ctypes.c_int64(count),
                          out)
    return out.raw


def sqrt_batch(curve, values) -> Optional[list]:
    """Batch modular square roots in the curve's BASE field (bit-identical
    to Curve.sqrt, pasta.py:35 — canonical min(y, p-y) is picked by the
    CALLER; this returns the raw Tonelli root).  Returns a list of
    Optional[int] (None for non-residues), or None when the native library
    is unavailable.  The verifier decompresses ~100 L/R points per proof;
    the python Tonelli loop was ~0.1s of every verify."""
    lib = _load()
    if lib is None or not values:
        return None
    from .pasta import PALLAS
    n = len(values)
    buf = b"".join((v % curve.p).to_bytes(32, "little") for v in values)
    out = ctypes.create_string_buffer(32 * n)
    ok = ctypes.create_string_buffer(n)
    try:
        fn = lib.pasta_sqrt_batch
    except AttributeError:
        return None
    fn(ctypes.c_int(0 if curve is PALLAS else 1), ctypes.c_int64(n),
       buf, out, ok)
    res = []
    raw = out.raw
    okr = ok.raw
    for i in range(n):
        if okr[i]:
            res.append(int.from_bytes(raw[32 * i:32 * i + 32], "little"))
        else:
            res.append(None)
    return res


def fold_points_native(curve, xi: int, x: int, lo, hi):
    """[xi*lo[i] + x*hi[i]] batched (the IPA basis fold)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native msm unavailable")
    from .pasta import PALLAS
    curve_id = 0 if curve is PALLAS else 1
    n = len(lo)
    assert len(hi) == n
    lo_b = _pack_points(lo)
    hi_b = _pack_points(hi)
    out = ctypes.create_string_buffer(65 * n)
    xi_b = (xi % curve.order).to_bytes(32, "little")
    x_b = (x % curve.order).to_bytes(32, "little")
    lib.pasta_fold_points(
        ctypes.c_int(curve_id), ctypes.c_int64(n), xi_b, x_b,
        (ctypes.c_char * len(lo_b)).from_buffer(lo_b),
        (ctypes.c_char * len(hi_b)).from_buffer(hi_b), out)
    return _unpack_points(bytearray(out.raw), n)


def pack_points(points) -> bytes:
    """Pack points once for repeated indexed MSMs (cache at the caller)."""
    return bytes(_pack_points(points))


def _scalar_buf(curve, scalars):
    """(bytes-like, n) of 32B-LE scalars; PackedVec raw is reused as-is
    when its modulus is the curve order (the fold/cross vectors feeding
    commit MSMs are already canonical 32B LE — repacking them was ~15% of
    a multi-fold prove)."""
    from ..ops.native_fieldvec import PackedVec
    if isinstance(scalars, PackedVec) and scalars.p == curve.order:
        return scalars.raw, scalars.n
    n = len(scalars)
    sbuf = bytearray(32 * n)
    for i, s in enumerate(scalars):
        sbuf[32 * i:32 * (i + 1)] = (s % curve.order).to_bytes(32, "little")
    return bytes(sbuf), n


_BASIS_CACHE: dict = {}
_BASIS_LOCK = None


def basis_handle(curve, key, packed) -> Optional[tuple]:
    """Load a fixed basis into the native layer ONCE (Montgomery affine +
    the 5x52 IFMA mirror) and reuse the handle for every subsequent MSM.
    `key` must uniquely identify the basis content (PedersenGens keys by
    (curve, label, n) — the packed buffer itself is a fresh slice per
    instance).  Returns (handle, n) or None if the library is missing."""
    global _BASIS_LOCK
    lib = _load()
    if lib is None:
        return None
    if _BASIS_LOCK is None:
        import threading
        _BASIS_LOCK = threading.Lock()
    with _BASIS_LOCK:
        ent = _BASIS_CACHE.get(key)
        if ent is None:
            from .pasta import PALLAS
            n = len(packed) // 65
            h = lib.msm_basis_init(
                ctypes.c_int(0 if curve is PALLAS else 1),
                ctypes.c_int64(n), bytes(packed))
            ent = (h, n)
            _BASIS_CACHE[key] = ent
        return ent


def msm_packed(curve, scalars: List[int], packed: bytes,
               indices: Optional[List[int]] = None,
               handle: Optional[tuple] = None) -> Optional[tuple]:
    """MSM over a pre-packed point buffer, optionally gathering via an
    index array — avoids repacking a fixed basis on every call (the IPA
    prover calls 2*log(n) MSMs against subsets of the same gens).  With
    `handle` (from basis_handle) the basis load + IFMA conversion are
    skipped too; `packed` is then ignored."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native msm unavailable")
    from .pasta import PALLAS
    curve_id = 0 if curve is PALLAS else 1
    sbuf, n = _scalar_buf(curve, scalars)
    if n == 0:
        return None
    if indices is not None:
        assert len(indices) == n
    idx = (ctypes.c_int64 * n)(*indices) if indices is not None else None
    out_buf = ctypes.create_string_buffer(96)
    if handle is not None:
        if indices is None:
            assert n <= handle[1]
        else:
            assert max(indices) < handle[1]
        lib.pasta_msm_basis(ctypes.c_void_p(handle[0]), ctypes.c_int64(n),
                            sbuf, idx, out_buf)
    else:
        lib.pasta_msm_idx(ctypes.c_int(curve_id), ctypes.c_int64(n),
                          sbuf, packed, idx, out_buf)
    X = int.from_bytes(out_buf.raw[0:32], "little")
    Y = int.from_bytes(out_buf.raw[32:64], "little")
    Z = int.from_bytes(out_buf.raw[64:96], "little")
    if Z == 0:
        return None
    p = curve.p
    zi = pow(Z, p - 2, p)
    return (X * zi % p, Y * zi % p)


def msm_rows(curve, n_rows: int, n_cols: int, flat_scalars,
             blinds: List[int], packed_basis: bytes,
             H) -> Optional[List[Optional[tuple]]]:
    """Row-batched Pedersen commits: [<flat[r*n_cols:(r+1)*n_cols], G> +
    blinds[r]*H for r in rows] in one native call (shared basis load, rows
    threaded, blind via a fixed-base table).  None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    from .pasta import PALLAS
    curve_id = 0 if curve is PALLAS else 1
    sbuf, n = _scalar_buf(curve, flat_scalars)
    assert n == n_rows * n_cols
    bbuf, nb = _scalar_buf(curve, blinds)
    assert nb == n_rows
    hbuf = bytes(_pack_points([H]))
    out = ctypes.create_string_buffer(65 * n_rows)
    lib.pasta_msm_rows(ctypes.c_int(curve_id), ctypes.c_int64(n_rows),
                       ctypes.c_int64(n_cols), sbuf, packed_basis, bbuf,
                       hbuf, out)
    return _unpack_points(bytearray(out.raw), n_rows)


def msm_native(curve, scalars: List[int], points) -> Optional[tuple]:
    """MSM via the native library; returns an affine point or None (identity).

    Raises RuntimeError if the library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native msm unavailable")
    from .pasta import PALLAS
    curve_id = 0 if curve is PALLAS else 1
    n = len(scalars)
    if n == 0:
        return None
    sbuf = bytearray(32 * n)
    pbuf = bytearray(65 * n)
    for i, (s, pt) in enumerate(zip(scalars, points)):
        sbuf[32 * i:32 * (i + 1)] = (s % curve.order).to_bytes(32, "little")
        if pt is None:
            pbuf[65 * i + 64] = 1
        else:
            pbuf[65 * i:65 * i + 32] = pt[0].to_bytes(32, "little")
            pbuf[65 * i + 32:65 * i + 64] = pt[1].to_bytes(32, "little")
    out = bytes(96)
    out_buf = ctypes.create_string_buffer(out, 96)
    lib.pasta_msm(ctypes.c_int(curve_id), ctypes.c_int64(n),
                  (ctypes.c_char * len(sbuf)).from_buffer(sbuf),
                  (ctypes.c_char * len(pbuf)).from_buffer(pbuf),
                  out_buf)
    X = int.from_bytes(out_buf.raw[0:32], "little")
    Y = int.from_bytes(out_buf.raw[32:64], "little")
    Z = int.from_bytes(out_buf.raw[64:96], "little")
    if Z == 0:
        return None
    p = curve.p
    zi = pow(Z, p - 2, p)
    return (X * zi % p, Y * zi % p)
