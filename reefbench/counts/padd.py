"""K1 (`csrc/padd.cu`): point additions on Pallas or Vesta, each counted
at `peaks.PRODUCTS_PER_ADD` whatever the launch does; the bytes are the
inputs read once and the output written once, projective points."""

from harness.peaks import BYTES_PER_POINT as POINT
from harness.peaks import IMADS_PER_PRODUCT, PRODUCTS_PER_ADD

KERNELS = ("padd_kernel", "padd_spread_kernel", "padd_reduce_kernel")


def work(fn: str, args: tuple):
    """(IMADs, bytes) of one call of the launcher `fn` with `args` (as
    `reef_tpu_torch.utils.cudabuild.LIBS` declares them)."""
    if fn == "reef_padd":                   # P, Q, O, B, field, path
        B = args[3]
        return B * PRODUCTS_PER_ADD * IMADS_PER_PRODUCT, 3 * B * POINT
    if fn == "reef_padd_reduce":            # X, row, n_out, inner, ... L,
        n_out, L, acc = args[2], args[7], args[8]   # acc, out, ...
        adds = n_out * (L - 1 + (1 if acc else 0))
        nbytes = n_out * (L + (2 if acc else 1)) * POINT
        return adds * PRODUCTS_PER_ADD * IMADS_PER_PRODUCT, nbytes
    raise KeyError(fn)
