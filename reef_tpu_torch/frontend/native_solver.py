"""ctypes bridge to the native C++ SAFA solver (native/solver.cpp).

Builds the shared library on demand with g++ (no external deps) and flattens
a SAFA into CSR arrays.  Falls back silently to the Python solver if the
toolchain is unavailable.  The native solver mirrors the Python solver's
semantics; `SAFA.solve(native=True)` routes here.
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
        so = build_native_lib(native_src("solver.cpp"), "libsafasolver",
                              extra=["-pthread"])
        lib = ctypes.CDLL(so)
        lib.safa_solve.restype = ctypes.c_int64
        _LIB = lib
    except Exception:
        _BUILD_FAILED = True
    return _LIB


def solve_native(safa, doc: List[int]):
    """Returns a Trace (list of TraceElem) or None; raises RuntimeError if
    the native library is unavailable."""
    from .trace import TraceElem

    lib = _load()
    if lib is None:
        raise RuntimeError("native solver unavailable")

    n = safa.num_states()
    is_and = np.zeros(n, np.uint8)
    accepting = np.zeros(n, np.uint8)
    for i in range(n):
        if safa.nodes[i].is_and:
            is_and[i] = 1
    for a in safa.accepting:
        accepting[a] = 1

    edge_start = np.zeros(n + 1, np.int32)
    edges = []          # (dst, kind, chr, range_lo, range_hi, self_nil)
    labels = []         # python edge labels, indexed by edge id
    r_start: List[int] = []
    r_end: List[int] = []
    for src in range(n):
        edge_start[src] = len(edges)
        for dst, lbl in safa.out_edges[src]:
            if lbl[0] == "c":
                edges.append((dst, 0, lbl[1], 0, 0, 0))
            else:
                lo = len(r_start)
                for s, e in lbl[1].ranges:
                    r_start.append(s)
                    r_end.append(-1 if e is None else e)
                self_nil = 1 if (dst == src and lbl[1].is_nil()) else 0
                edges.append((dst, 1, 0, lo, len(r_start), self_nil))
            labels.append(lbl)
    edge_start[n] = len(edges)

    edge_data = np.array(edges, np.int32).reshape(-1)
    r_start_a = np.array(r_start or [0], np.int64)
    r_end_a = np.array(r_end or [0], np.int64)
    doc_a = np.array(doc, np.int32)

    cap = max(4096, 4 * len(doc) + 16 * n)
    while True:
        out_from = np.zeros(cap, np.int32)
        out_edge = np.zeros(cap, np.int32)
        out_to = np.zeros(cap, np.int32)
        out_fc = np.zeros(cap, np.int64)
        out_tc = np.zeros(cap, np.int64)
        got = lib.safa_solve(
            ctypes.c_int32(n),
            is_and.ctypes.data_as(ctypes.c_void_p),
            accepting.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int32(-1 if safa.sink is None else safa.sink),
            edge_start.ctypes.data_as(ctypes.c_void_p),
            edge_data.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int32(len(edges)),
            r_start_a.ctypes.data_as(ctypes.c_void_p),
            r_end_a.ctypes.data_as(ctypes.c_void_p),
            doc_a.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(len(doc)),
            out_from.ctypes.data_as(ctypes.c_void_p),
            out_edge.ctypes.data_as(ctypes.c_void_p),
            out_to.ctypes.data_as(ctypes.c_void_p),
            out_fc.ctypes.data_as(ctypes.c_void_p),
            out_tc.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(cap),
        )
        if got == -2:
            cap *= 4
            continue
        if got == -1:
            return None
        trace = []
        for k in range(got):
            trace.append(TraceElem(int(out_from[k]), labels[int(out_edge[k])],
                                   int(out_to[k]), int(out_fc[k]),
                                   int(out_tc[k])))
        return trace
