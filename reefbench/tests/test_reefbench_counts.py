"""The kernels' work counts against the plain twins: the arguments the
port's launch wrappers hand the kernel libraries for a shape (caught on
the CPU, the launch stubbed) give the work that the plain twin does for
the same shape, counted as it runs."""

from __future__ import annotations

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import manifest, peaks  # noqa: E402

COUNTS = manifest.work_counts()
PROD = peaks.IMADS_PER_PRODUCT


@pytest.fixture
def launches(monkeypatch):
    """Every cudabuild.launch as (library, function, args), none run."""
    from reef_tpu_torch.ops import poseidon_kernel, sumcheck_kernel
    from reef_tpu_torch.utils import cudabuild
    got = []
    monkeypatch.setattr(cudabuild, "on_card", lambda name, t: True)
    monkeypatch.setattr(cudabuild, "launch",
                        lambda lib, fn, dev, *a: got.append((lib, fn, a)))
    monkeypatch.setattr(poseidon_kernel, "_set_consts", lambda *a: None)
    monkeypatch.setattr(sumcheck_kernel, "_ticket",
                        lambda dev: torch.zeros(1, dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132})())
    return got


def work(got):
    return sum(COUNTS[lib].work(fn, a)[0] for lib, fn, a in got)


def rand_points(ck, n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**31 - 1, (3, 8, n), generator=g,
                         dtype=torch.int32)


def counting_add(counter):
    from reef_tpu_torch.ec import padd

    def add(ck, P, Q):
        counter[0] += P.shape[2]
        return padd.padd_soa_plain(ck, P, Q)
    return add


def test_k1_add_and_reduce(launches):
    from reef_tpu_torch.ec import padd
    from reef_tpu_torch.ec.msm import kernels_for
    from reef_tpu_torch.ec.pasta import PALLAS
    ck = kernels_for(PALLAS)
    P = rand_points(ck, 37)
    padd.padd_soa(ck, P, rand_points(ck, 37, 2))
    assert work(launches) == 37 * peaks.PRODUCTS_PER_ADD * PROD
    for acc in (False, True):
        launches.clear()
        X = rand_points(ck, 2 * 8 * 3).reshape(3, 8, 2, 8, 3)
        A = rand_points(ck, 6, 3).reshape(3, 8, 2, 3) if acc else None
        padd.padd_reduce(ck, X, A)
        adds = [0]
        padd.padd_reduce_plain(ck, X, A, add=counting_add(adds))
        assert work(launches) == adds[0] * peaks.PRODUCTS_PER_ADD * PROD


def test_k2_tree(launches, monkeypatch):
    from reef_tpu_torch.ec import msm_v3
    from reef_tpu_torch.ec.msm import kernels_for
    from reef_tpu_torch.ec.pasta import PALLAS
    ck = kernels_for(PALLAS)
    W, cap = 3, 64
    placed = rand_points(ck, W * cap)[:2].reshape(2, 8, W, cap)
    msm_v3.tree_levels(ck, placed)
    adds = [0]
    for name in ("_padd_affine16", "_padd16"):
        orig = getattr(msm_v3, name)

        def counted(ck, a, b, orig=orig):
            adds[0] += a[0, 0].numel()
            return orig(ck, a, b)
        monkeypatch.setattr(msm_v3, name, counted)
    msm_v3.tree_levels_plain(ck, placed)
    assert adds[0] == W * (cap - 1)
    assert work(launches) == adds[0] * peaks.PRODUCTS_PER_ADD * PROD


@pytest.mark.parametrize("t, products", [(5, 992), (9, 2004)])
def test_k5_permutations(launches, t, products):
    from reef_tpu_torch.ops import limb, poseidon_kernel
    lf = limb.FQ
    state = torch.zeros((t, 8, 7), dtype=torch.int32)
    poseidon_kernel.launch(lf, state)
    assert COUNTS["poseidon"].products(t) == products
    assert work(launches) == 7 * products * PROD


@pytest.mark.parametrize("which, ratio", [
    # (count, twin) products: the coefficients at the kernel's three a
    # pair (x from t1 e1 - xsq - con), where the twin takes the
    # reference's four; the eq step at one an entry (x (1 - q) as
    # x - x q), where the twin takes two
    ("coeffs", (3, 4)), ("fold", (1, 1)), ("eq", (1, 2))])
def test_k6_rounds(launches, monkeypatch, which, ratio):
    from reef_tpu_torch.ops import limb, sumcheck_kernel as K
    lf = limb.FQ
    half = 16
    g = torch.Generator().manual_seed(4)

    def rows(n):
        return torch.randint(0, 2**30, (8, n), generator=g,
                             dtype=torch.int32)
    hv = (rows(half), rows(half), rows(half), rows(half))
    kernel, plain, args = {
        "coeffs": (K.coeffs, K.coeffs_plain, hv),
        "fold": (K.fold, K.fold_plain, hv + (rows(1),)),
        "eq": (K.eq_step, K.eq_step_plain, (rows(half), rows(1)))}[which]
    kernel(lf, *args)
    products = [0]
    orig = limb.mul

    def mul(lf_, a, b):
        out = orig(lf_, a, b)
        products[0] += out[0].numel()
        return out
    monkeypatch.setattr(limb, "mul", mul)
    plain(lf, *args)
    assert ratio[1] * work(launches) == ratio[0] * products[0] * PROD
