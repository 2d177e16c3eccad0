"""The flagship device step: batched Poseidon plus one sumcheck fold round.

The port of the JAX package's models/prover_step.py: the prover's
per-round device workload (SURVEY.md section 5's long-document scaling
path), a batch of Poseidon permutations (Fiat-Shamir / Merkle hashing,
K5) beside one MLE-product sumcheck round over the T and eq tables (K6):
the degree-2 coefficients (modular sums of products) and the fold of both
tables by the challenge.

Tables are split-halved, (2, 8, half) int32: plane 0 is the lower half of
the table and plane 1 the upper, so the round's top-bit split is the
leading axis (the JAX package's (2, half, 16) layout with the limb axis
moved next to the rows, as ops.limb keeps it).
"""

from __future__ import annotations

import torch

from ..ops import limb, poseidon_device
from ..ops import sumcheck_kernel as K
from ..ops.limb import FQ


def sumcheck_round(lf, t_tab: torch.Tensor, eq_tab: torch.Tensor,
                   r: torch.Tensor):
    """One linear_mle_product round (r1cs_helper.rs:441-506), no sponge.

    t_tab, eq_tab: (2, 8, half) Montgomery; r: (8, 1) Montgomery challenge.
    Returns the folded (8, half) tables and the (8, 1) coefficients
    xsq, x, con."""
    g, _ = K.coeffs(lf, t_tab[0], t_tab[1], eq_tab[0], eq_tab[1])
    t_fold, e_fold = K.fold(lf, t_tab[0], t_tab[1], eq_tab[0], eq_tab[1], r)
    return t_fold, e_fold, g[0], g[1], g[2]


def device_step(states: torch.Tensor, t_tab: torch.Tensor,
                eq_tab: torch.Tensor, r: torch.Tensor):
    """The single-device flagship step on F_Q.

    states: (5, 8, B) Poseidon states; t_tab, eq_tab: (2, 8, half);
    r: (8, 1)."""
    lf = FQ
    states = poseidon_device.permute(lf, states)
    t_fold, e_fold, xsq, x, con = sumcheck_round(lf, t_tab, eq_tab, r)
    return states, t_fold, e_fold, xsq, x, con


def random_elems(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform (8, ...) int32 words with the top limb below 2^30: values
    below 2^254 < p, so each is a canonical Montgomery element."""
    w = torch.randint(0, 1 << 32, (limb.N32,) + tuple(shape),
                      generator=generator, dtype=torch.int64,
                      device=generator.device)
    w[limb.N32 - 1] &= (1 << 30) - 1
    w = torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)
    return w.to(device)


def example_args(batch: int = 256, half: int = 128, seed: int = 0,
                 device=None):
    """Random step inputs from an explicit torch.Generator seeded with
    `seed` (on the CPU, so a seed gives the same inputs on every device),
    placed on `device` (default: the engine device)."""
    from ..utils.device import resolve
    dev = resolve(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    states = random_elems((5, batch), g, dev).permute(1, 0, 2)
    t_tab = random_elems((2, half), g, dev).permute(1, 0, 2).contiguous()
    eq_tab = random_elems((2, half), g, dev).permute(1, 0, 2).contiguous()
    r = random_elems((1,), g, dev)
    return states.contiguous(), t_tab, eq_tab, r
