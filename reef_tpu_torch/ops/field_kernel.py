"""K3 and K4, the standalone field kernels, and the hook that routes the
plain field ops through them.

Port of the JAX package's ops/pallas_field.py (`mont_mul`,
`mont_redc_cols`, `enable`, `disable`).  Both kernels live in
csrc/mont.cu and work on the plain layout of ops.limb, sixteen 16-bit
limbs in int64 rows, which is what the hook's callers hold:

  - `mont_mul(f, a, b)`: K3, the Montgomery product of (16, B) x (16, B)
    -> (16, B); its plain version is `limb.mul`;
  - `mont_redc_cols(f, cols)`: K4, the REDC of (32, B) column sums
    -> (16, B) canonical elements; its plain version is
    `limb.redc_cols`.

On a CUDA tensor each launches its kernel (a build or launch failure
raises); on a CPU tensor it runs the plain version.

`enable()` rebinds `limb.mul` (and, with redc=True, `limb.redc_cols`) to
dispatchers that send every CUDA batch to the kernel and every CPU batch
to the plain version; `enabled()` does the same for a `with` block and
then puts back what the caller had bound.  Code that looks `limb.mul` up
at call time (the plain point add of ec/msm.py, `limb.pow5`, the MXU
Poseidon) follows the hook.  The reference routes only batches of at
least 2048 elements, a multiple of 128, to its kernel (the TPU tiles
8 x 128 lanes); on the card the plain product is some 400 launches
against the kernel's one, and the kernel guards its own tail, so no
batch size is better served by the plain version there.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..utils import cudabuild
from . import limb
from .limb import N, LimbField

_BASE_MUL = limb.mul
_BASE_REDC = limb.redc_cols


def _check_rows(name: str, t: torch.Tensor, rows: int) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int64")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"({rows}, B)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def mont_mul(f: LimbField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(16, B) x (16, B) -> (16, B) int64 Montgomery product, lane by lane:
    K3 on a CUDA tensor, `limb.mul` on a CPU tensor."""
    _check_rows("a", a, N)
    _check_rows("b", b, N)
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b differ in shape or device")
    if not cudabuild.on_card("mont_mul", a):
        return _BASE_MUL(f, a, b)
    out = torch.empty_like(a)
    if a.shape[1]:
        cudabuild.launch("mont", "reef_mont_mul", a.device, a.data_ptr(),
                         b.data_ptr(), out.data_ptr(), a.shape[1],
                         f.field_id)
        cudabuild.count("mont_mul")
    return out


def mont_redc_cols(f: LimbField, cols: torch.Tensor) -> torch.Tensor:
    """(32, B) non-negative int64 column sums -> (16, B) canonical
    elements (the input contract of `limb.redc_cols`): K4 on a CUDA
    tensor, `limb.redc_cols` on a CPU tensor."""
    _check_rows("cols", cols, 2 * N)
    if not cudabuild.on_card("mont_redc_cols", cols):
        return _BASE_REDC(f, cols)
    out = torch.empty((N, cols.shape[1]), dtype=torch.int64,
                      device=cols.device)
    if cols.shape[1]:
        cudabuild.launch("mont", "reef_mont_redc", cols.device,
                         cols.data_ptr(), out.data_ptr(), cols.shape[1],
                         f.field_id)
        cudabuild.count("mont_redc")
    return out


# ---------------------------------------------------------------------------
# the dispatch hook
# ---------------------------------------------------------------------------

def _dispatching_mul(f: LimbField, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return _BASE_MUL(f, a, b)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    n = math.prod(batch)
    shape = (N,) + tuple(batch)
    a = a.expand(shape).reshape(N, n).contiguous()
    b = b.expand(shape).reshape(N, n).contiguous()
    return mont_mul(f, a, b).reshape(shape)


def _dispatching_redc_cols(f: LimbField, cols: torch.Tensor) -> torch.Tensor:
    if cols.device.type == "cpu":
        return _BASE_REDC(f, cols)
    batch = cols.shape[1:]
    out = mont_redc_cols(f, cols.reshape(2 * N, math.prod(batch)).contiguous())
    return out.reshape((N,) + tuple(batch))


def enable(redc: bool = False) -> None:
    """Route `limb.mul` through K3 for CUDA tensors; with redc=True route
    `limb.redc_cols` through K4 the same way."""
    limb.mul = _dispatching_mul
    if redc:
        limb.redc_cols = _dispatching_redc_cols


def disable() -> None:
    """Put the plain `limb.mul` and `limb.redc_cols` back."""
    limb.mul = _BASE_MUL
    limb.redc_cols = _BASE_REDC


@contextlib.contextmanager
def enabled(redc: bool = False):
    """`enable(redc)` for a `with` block; afterwards, also when the block
    raises, `limb.mul` and `limb.redc_cols` are what they were before it
    (a caller's own hook included)."""
    prev = limb.mul, limb.redc_cols
    enable(redc)
    try:
        yield
    finally:
        limb.mul, limb.redc_cols = prev
