"""Inputs of the tests that hold reef_tpu_torch's CUDA kernels against
their plain versions, shared with the CPU tests that hold those plain
versions against reef_tpu.

This module imports neither jax nor reef_tpu: the card lane runs where
neither is installed,

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card_*.py

and its oracles are python ints and the port's plain twins.  The CPU
tests (`tests/test_torch_{ec,field,field_kernel,pippenger,poseidon,
sumcheck}.py`) build their inputs here too, so that the twins they hold
to the JAX package are the ones the card lane trusts.

Loaded as a plugin (`-p _torch_card_support`, with tests/ on the path)
and with REEF_CARD_COUNTS naming a file, it writes the test run's kernel
launch counts there as JSON at the end of the run (`chip_smoke.py`
phase `card_tests`).
"""

import json
import os

import numpy as np
import torch

from reef_tpu_torch.models import prover_step


def pytest_sessionfinish(session, exitstatus):
    path = os.environ.get("REEF_CARD_COUNTS")
    if path:
        from reef_tpu_torch.utils import cudabuild
        with open(path, "w") as fh:
            json.dump(cudabuild.launch_counts(), fh)


# ---- curve points (K1, K2) ---------------------------------------------

def pairs(cv, seed: int):
    """Random pairs plus the identity, doubling and P + (-P) cases."""
    rng = np.random.default_rng(seed)
    mults = [int(v) for v in rng.integers(1, 1 << 40, size=8)]
    pts = [cv.mul(k, cv.gen) for k in mults]
    g5 = cv.mul(5, cv.gen)
    out = list(zip(pts[:4], pts[4:]))
    out += [(None, cv.gen), (g5, g5), (g5, cv.neg(g5)), (None, None),
            (cv.gen, None)]
    return out


def soa(ck, pts) -> torch.Tensor:
    """Affine host points -> (3, 8, n) int32 Montgomery projective."""
    return torch.from_numpy(ck.to_proj(pts)).permute(1, 2, 0).contiguous()


# ---- field elements (K3, K4) ---------------------------------------------

def elements(p: int, n: int, seed: int) -> list:
    """0, 1, p - 1, then random values below p."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1]
    while len(vals) < n:
        vals.append(int.from_bytes(rng.bytes(32), "little") % p)
    return vals


def encode(lf, xs) -> torch.Tensor:
    """Python ints -> contiguous (16, n) int64 Montgomery rows."""
    return lf.encode(xs).contiguous()


def mxu_range_cols(p: int, n: int, seed: int) -> np.ndarray:
    """(32, n) int64 columns, each below 2^31, of n values in [pR, 5p^2):
    the range of the MXU Poseidon's byte-matmul accumulations, where a
    REDC leaves up to ~2.3p.  Each value's 16-bit limbs, with random
    amounts moved one column down (column k-1 gains 2^16 x what column k
    loses), so the columns exceed 16 bits as the matmul's do."""
    rng = np.random.default_rng(seed)
    lo, hi = p << 256, 5 * p * p
    out = np.zeros((32, n), np.int64)
    for j in range(n):
        v = lo + int.from_bytes(rng.bytes(64), "little") % (hi - lo)
        c = [(v >> (16 * k)) & 0xFFFF for k in range(32)]
        for k in range(31, 0, -1):
            r = int(rng.integers(0, min(c[k], 1 << 14) + 1))
            c[k] -= r
            c[k - 1] += r << 16
        assert sum(x << (16 * k) for k, x in enumerate(c)) == v
        out[:, j] = c
    assert out.max() < 1 << 31
    return out


# ---- Poseidon states (K5) -----------------------------------------------

def states(lf, t: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(32), "little") % lf.p_int
             for _ in range(t)] for _ in range(B)]


def to_port(lf, sts, device="cpu") -> torch.Tensor:
    """python-int states -> (t, 8, B) int32."""
    t = len(sts[0])
    return torch.stack([lf.encode32([s[l] for s in sts], device)
                        for l in range(t)])


def from_port(lf, x: torch.Tensor):
    cols = [lf.decode32(x[l]) for l in range(x.shape[0])]
    return [list(s) for s in zip(*cols)]


def edge_states(lf, t: int):
    """Every lane 0, 1 or p - 1, as values and as raw Montgomery words
    (word p - 1 is the largest element a lazy row sums), as python-int
    values."""
    p = lf.p_int
    return ([[v] * t for v in (0, 1, p - 1)]
            + [[lf.unmont(w)] * t for w in (1, p - 1)]
            + [[(0, 1, p - 1)[(l + k) % 3] for l in range(t)]
               for k in range(3)])


# ---- sumcheck tables (K6) ------------------------------------------------

def rows(n, seed):
    """(8, n) int32 random field elements (Montgomery words)."""
    g = torch.Generator().manual_seed(seed)
    return prover_step.random_elems((n,), g, "cpu")
