"""Carry state from the JAX package's layouts into this package's.

The JAX package holds a field element as sixteen 16-bit limbs in uint32
(numpy or jax arrays, limb axis anywhere); this package's kernels hold
eight 32-bit limbs as int32 bit patterns (ops.limb).  Both use Montgomery
form with R = 2^256, so converting is a repacking of the same number.
Takes and returns numpy arrays (and torch tensors for the basis), so it
needs neither package's device code.
"""

from __future__ import annotations

import numpy as np

from .ec.msm import CurveKernels
from .ec.msm_v3 import DeviceBasisV3
from .ops import limb


def limbs16_to_32(arr, axis: int) -> np.ndarray:
    """16-bit limbs (16 along `axis`) -> int32 32-bit limbs (8 along it)."""
    a = np.moveaxis(np.asarray(arr).astype(np.uint32), axis, -1)
    if a.shape[-1] != limb.N:
        raise ValueError(f"axis {axis} has {a.shape[-1]} limbs, not 16")
    pairs = a.reshape(a.shape[:-1] + (limb.N32, 2))
    w = (pairs[..., 0] | (pairs[..., 1] << 16)).astype(np.uint32)
    return np.ascontiguousarray(np.moveaxis(w.view(np.int32), -1, axis))


def limbs32_to_16(arr, axis: int) -> np.ndarray:
    """int32 32-bit limbs (8 along `axis`) -> uint32 16-bit limbs (16)."""
    a = np.moveaxis(np.asarray(arr).astype(np.int32).view(np.uint32),
                    axis, -1)
    if a.shape[-1] != limb.N32:
        raise ValueError(f"axis {axis} has {a.shape[-1]} limbs, not 8")
    out = np.stack([a & 0xFFFF, a >> 16], axis=-1).astype(np.uint32)
    out = out.reshape(a.shape[:-1] + (limb.N,))
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


def basis_from_reference(ck: CurveKernels, arr, device=None) -> DeviceBasisV3:
    """The JAX package's DeviceBasisV3.arr, (n_chunks, 3, 16, cap) uint32
    (padding included), as this package's basis on `device`."""
    a = limbs16_to_32(np.asarray(arr), axis=2)        # (n_chunks, 3, 8, cap)
    n_chunks, _, _, cap = a.shape
    points = np.transpose(a, (1, 2, 0, 3)).reshape(3, limb.N32,
                                                   n_chunks * cap)
    points = np.ascontiguousarray(np.transpose(points, (2, 0, 1)))
    return DeviceBasisV3(ck, points, cap=cap, device=device)
