"""K6 (`csrc/sumcheck.cu`): the nlookup sumcheck's rounds over tables of
`half` pairs.  A round's coefficients take 3 products a pair (t1 - t0
by e1 - e0, t1 e1, t0 e0) and read four half-tables; a fold takes 2 a
pair and reads four half-tables and writes two; an eq doubling step of m
entries takes 1 product an entry (x q, and x (1 - q) as x - x q), reads
the m entries and the 2m it adds to (where given) and writes 2m."""

from harness.peaks import BYTES_PER_ELEMENT as E
from harness.peaks import IMADS_PER_PRODUCT

KERNELS = ("coeff_kernel", "fold_kernel", "eq_kernel")


def work(fn: str, args: tuple):
    if fn == "reef_sc_coeffs":              # t0, t1, e0, e1, st, se, half
        half = args[6]
        return 3 * half * IMADS_PER_PRODUCT, 4 * half * E
    if fn == "reef_sc_fold":                # ..., r, sr, t_out, e_out, half
        half = args[10]
        return 2 * half * IMADS_PER_PRODUCT, 6 * half * E
    if fn == "reef_sc_eq_step":             # term, m, q, sq, eq, out
        m, eq = args[1], args[4]
        return m * IMADS_PER_PRODUCT, (m + (4 if eq else 2) * m) * E
    raise KeyError(fn)
