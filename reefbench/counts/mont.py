"""K3 and K4 (`csrc/mont.cu`): Montgomery products and reductions of
field elements held as 16 limbs of 64 bits (128 bytes; a double-width
input 256)."""

from harness.peaks import IMADS_PER_PRODUCT, IMADS_PER_REDC

KERNELS = ("mont_mul_kernel", "mont_redc_kernel")
LIMBS16 = 16 * 8


def work(fn: str, args: tuple):
    if fn == "reef_mont_mul":               # A, B, O, n, field
        n = args[3]
        return n * IMADS_PER_PRODUCT, 3 * n * LIMBS16
    if fn == "reef_mont_redc":              # C, O, n, field
        n = args[2]
        return n * IMADS_PER_REDC, 3 * n * LIMBS16
    raise KeyError(fn)
