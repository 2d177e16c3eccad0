"""Carry state from the JAX package's layouts into this package's.

The JAX package holds a field element as sixteen 16-bit limbs in uint32
(numpy or jax arrays, limb axis anywhere); this package's kernels hold
eight 32-bit limbs as int32 bit patterns (ops.limb).  Both use Montgomery
form with R = 2^256, so converting is a repacking of the same number.
Takes numpy arrays (the JAX package's arrays as `np.asarray` gives them)
and returns torch tensors on the CPU, or the reverse, so it needs neither
package's device code.  The Poseidon constants are not carried across:
the port derives its own (ops.poseidon_device).
"""

from __future__ import annotations

import numpy as np
import torch

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


def plain_from_reference(arr) -> torch.Tensor:
    """(..., 16) uint32 Montgomery limbs -> the plain layout, (16, ...)
    int64."""
    a = np.asarray(arr).astype(np.int64)
    if a.shape[-1] != limb.N:
        raise ValueError(f"last axis has {a.shape[-1]} limbs, not 16")
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)))


def plain_to_reference(t: torch.Tensor) -> np.ndarray:
    """Inverse of `plain_from_reference`."""
    a = np.moveaxis(t.detach().cpu().numpy(), 0, -1)
    return np.ascontiguousarray(a.astype(np.uint32))


def points_from_reference(arr) -> torch.Tensor:
    """(n, 3, 16) uint32 projective Montgomery points -> the plain layout
    the port's point adds take, (3, 16, n) int64."""
    a = np.asarray(arr)
    if a.ndim != 3 or a.shape[1:] != (3, limb.N):
        raise ValueError(f"shape {a.shape}: expected (n, 3, {limb.N})")
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a.astype(np.int64), (1, 2, 0))))


def points_to_reference(t: torch.Tensor) -> np.ndarray:
    """Inverse of `points_from_reference`."""
    a = np.transpose(t.detach().cpu().numpy(), (2, 0, 1))
    return np.ascontiguousarray(a.astype(np.uint32))


def rows_from_reference(arr) -> torch.Tensor:
    """(..., n, 16) uint32 Montgomery limbs -> the kernel layout,
    (..., 8, n) int32: a table (n, 16) becomes (8, n), a split-halved
    table (2, half, 16) becomes (2, 8, half)."""
    a = np.asarray(arr)
    if a.ndim < 2:
        raise ValueError(f"shape {a.shape}: expected (..., n, 16)")
    w = limbs16_to_32(a, axis=a.ndim - 1)
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, -1, -2)))


def rows_to_reference(t: torch.Tensor) -> np.ndarray:
    """Inverse of `rows_from_reference`."""
    w = np.swapaxes(t.detach().cpu().numpy(), -1, -2)
    return limbs32_to_16(w, axis=w.ndim - 1)


def states_from_reference(arr) -> torch.Tensor:
    """Poseidon states (B, t, 16) uint32 -> (t, 8, B) int32."""
    return rows_from_reference(np.swapaxes(np.asarray(arr), 0, 1))


def states_to_reference(t: torch.Tensor) -> np.ndarray:
    """Inverse of `states_from_reference`."""
    return np.ascontiguousarray(np.swapaxes(rows_to_reference(t), 0, 1))


def basis_from_reference(ck: CurveKernels, arr, device=None) -> DeviceBasisV3:
    """The JAX package's DeviceBasisV3.arr, (n_chunks, 3, 16, cap) uint32
    (padding included), as this package's basis on `device`."""
    a = limbs16_to_32(np.asarray(arr), axis=2)        # (n_chunks, 3, 8, cap)
    n_chunks, _, _, cap = a.shape
    points = np.transpose(a, (1, 2, 0, 3)).reshape(3, limb.N32,
                                                   n_chunks * cap)
    points = np.ascontiguousarray(np.transpose(points, (2, 0, 1)))
    return DeviceBasisV3(ck, points, cap=cap, device=device)
