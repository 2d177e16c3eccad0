"""K2 (`csrc/msm_tree.cu`): the level-synchronous bucket trees, W
windows of `cap` leaves; level l adds W * cap / 2^l pairs.  Level 1
reads affine leaves, every level writes projective nodes, and each level
reads the one below it once."""

from harness.peaks import BYTES_PER_AFFINE, BYTES_PER_POINT
from harness.peaks import IMADS_PER_PRODUCT, PRODUCTS_PER_ADD

KERNELS = ("tree_level",)


def work(fn: str, args: tuple):
    if fn != "reef_tree_levels":            # src, out, W, cap, lo, hi, ...
        raise KeyError(fn)
    W, cap, lo, hi = args[2:6]
    adds = nbytes = 0
    for lvl in range(lo, hi + 1):
        nodes = W * cap >> lvl
        adds += nodes
        below = BYTES_PER_AFFINE if lvl == 1 else BYTES_PER_POINT
        nbytes += 2 * nodes * below + nodes * BYTES_PER_POINT
    return adds * PRODUCTS_PER_ADD * IMADS_PER_PRODUCT, nbytes
