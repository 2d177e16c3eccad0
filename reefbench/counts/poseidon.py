"""K5 (`csrc/poseidon.cu`): B Poseidon permutations of width t (5 or 9),
8 full rounds and 56 (t = 5) or 57 (t = 9) partial ones, counted at the
products of the sparse partial rounds whichever launch runs them: in a
full round the S-box (3 products) on every lane and the t^2 products of
the mix; in a partial round the lane-0 S-box, the lane-0 row (t) and one
product on each other lane (t - 1).  992 products at t = 5, 2,004 at
t = 9.  Bytes: the states read once and written once."""

from harness.peaks import BYTES_PER_ELEMENT, IMADS_PER_PRODUCT

KERNELS = ("perm_kernel", "perm_spread_kernel")
R_F, R_P = 8, {5: 56, 9: 57}


def products(t: int) -> int:
    return R_F * (3 * t + t * t) + R_P[t] * (3 + 2 * t - 1)


def work(fn: str, args: tuple):
    if fn != "reef_poseidon":               # state, out, B, t, field, path
        raise KeyError(fn)
    B, t = args[2], args[3]
    return (B * products(t) * IMADS_PER_PRODUCT,
            2 * B * t * BYTES_PER_ELEMENT)
