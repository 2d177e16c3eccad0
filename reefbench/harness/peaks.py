"""The card's peaks, and the price of the kernels' work in them.

NVIDIA H100 SXM (the data sheet): HBM3 at 3.35 TB/s.  32-bit integer
multiply-adds (IMAD): 64 a clock on each SM on compute capability 9.0,
half the FP32 rate (the CUDA C Programming Guide's throughput table),
times the card's SMs and its highest SM clock (`nvidia-smi
clocks.max.sm`), read at run time.

A field product is priced at the fewest IMADs the repository's
arithmetic takes for one: a wide 8 x 8-limb product, lo and hi halves
(128), plus a REDC shaped for the Pasta primes, 8 rounds of 3 limb
products, lo and hi halves (48): 176.  A REDC alone is 48.

A point addition is counted at 10 products, the fewest that any addition
in the repository takes (two affine inputs, K2's first level), whatever
adds it; a Poseidon permutation at the products of its sparse partial
rounds.  So the count is the work, not one implementation's cost of it,
and no kernel in view reads above its roofline.
"""

HBM_BYTES_PER_S = 3.35e12
IMADS_PER_CLOCK_PER_SM = 64
IMADS_PER_PRODUCT = 128 + 48
IMADS_PER_REDC = 48
PRODUCTS_PER_ADD = 10
BYTES_PER_ELEMENT = 32          # a field element as eight 32-bit limbs
BYTES_PER_POINT = 3 * BYTES_PER_ELEMENT     # projective
BYTES_PER_AFFINE = 2 * BYTES_PER_ELEMENT


def imads_per_s(sm_count: int, sm_clock_mhz: float) -> float:
    return IMADS_PER_CLOCK_PER_SM * sm_count * sm_clock_mhz * 1e6
