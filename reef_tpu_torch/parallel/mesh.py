"""The multi-device prover on a mesh of torch devices.

The port of the JAX package's parallel/mesh.py: the commit MSM, the
nlookup sumcheck and the flagship step, each split over the devices of a
mesh, with the shards' partial results combined on one device.

The reference is single-controller: one Python prover calls
`sharded_msm(mesh, ...)` in the middle of a commit, and `shard_map`
spreads the work.  The port keeps that shape.  A Mesh is an ordered list
of torch devices driven by one process, not a group of
`torch.distributed` ranks: a multi-process prover would put every rank
through the whole host protocol in lockstep, and NCCL refuses two ranks
on one card.  A device may appear more than once, so one card can hold
several shards (the tests' ["cpu"] * 8; ["cuda:0"] * 8 on a machine with
one card).  devices[0] is the lead: it gathers the shards' partial
results, runs the Fiat-Shamir sponge and combines.

  - MSM: shard d holds basis points [d n_local, (d+1) n_local) as a
    DeviceBasisV3 on its device; each shard computes its 32 window sums
    with ec.msm_v3's `msm_windows` (K2's tree, K1's halving reduces);
    the window sums are linear in the points, so the lead adds the
    shards' sums (one K1 reduce launch) and combines the windows on the
    host.
  - sumcheck: the table splits by its low bits
    (ops.sumcheck_device.DeviceTableCache over the mesh's devices,
    `sharded_rounds`).
  - the flagship step: states, table halves and points split on their
    batch axes; each shard permutes (K5), computes its round's
    coefficients and folds (K6) and sums its points (K1); the lead sums
    the coefficients mod p (one K6 launch) and the points (one K1
    launch).
  - the IPA rounds of the compressed SNARK (ec/ipa_device.py `IpaMesh`):
    the round state on the lead; each round, each shard's slice of the
    scalar bytes copied to its card and its window sums computed there
    over the sharded basis (`sharded_windows`), summed on the lead.

A shard's work is issued without a host sync, so shards on different
cards overlap: the host syncs (the scalar uploads, the final copy back)
come before the first shard's launches or after the last.  Shards that
share a card run on its current stream, one after another; K6's
coefficient launch needs that, since its block ticket is one word a card
(ops/sumcheck_kernel.py `_ticket`).

Every sharded call records, in a request run with `--metrics`
(utils/metrics.py), the spans `Mesh scalars` (the per-shard input
copies: the MSM's scalar bytes, the sumcheck's eq table, the step's
blocks), `Mesh issue` (the host issuing every shard's launches, one
Python thread for all the cards) and `Mesh gather` (the shards' results
copied to the lead and summed there; for the MSM windows it ends with
the lead's stream synchronised, so it holds the wait for the slowest
card), and the counters `Mesh shards` (shards issued) and `Mesh
gather_bytes` (bytes of partial results gathered).

The process mesh (`select`, `process_mesh`) is the one the device routes
(backend/routes.py) read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ec.msm import CurveKernels, vesta_kernels
from ..ec.msm_v3 import (DeviceBasisV3, combine_windows, msm_windows,
                         upload_scalars)
from ..ec.padd import padd_reduce
from ..ec.pasta import VESTA, Point
from ..ops import limb, poseidon_device
from ..ops import sumcheck_kernel as K
from ..ops.limb import FQ, LimbField
from ..ops.sumcheck_device import DeviceTableCache, sum_coeffs
from ..utils.device import _check, resolve
from ..utils.metrics import count, span


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of torch devices, repeats allowed; devices[0] is
    the lead."""
    devices: Tuple[torch.device, ...]

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh over `devices`, or by default over every CUDA device torch
    sees when the engine device (utils.device) is CUDA, and one CPU
    device when it is the CPU.  `n_devices` takes the first n of the
    CUDA devices, or n copies of the CPU."""
    if devices is None:
        eng = resolve()
        if eng.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if n_devices is not None:
                if n_devices > len(devices):
                    raise ValueError(f"{n_devices} devices asked for, torch "
                                     f"sees {len(devices)} CUDA devices")
                devices = devices[:n_devices]
        else:
            devices = [eng] * (n_devices or 1)
    devices = tuple(_check(torch.device(d)) for d in devices)
    if not devices:
        raise ValueError("a mesh needs a device")
    return Mesh(devices)


_PROCESS_MESH: Optional[Mesh] = None


def select(devices=None) -> Mesh:
    """Set the process mesh from a Mesh or a list of devices (None: back
    to the default, `make_mesh()`, built when read)."""
    global _PROCESS_MESH
    if devices is None or isinstance(devices, Mesh):
        _PROCESS_MESH = devices
    else:
        _PROCESS_MESH = make_mesh(devices=devices)
    return process_mesh()


def process_mesh() -> Mesh:
    """The selected mesh, else `make_mesh()`."""
    return _PROCESS_MESH if _PROCESS_MESH is not None else make_mesh()


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _point_sum(ck: CurveKernels, P: torch.Tensor) -> torch.Tensor:
    """(3, 8, n, C) points -> the C sums over n, (3, 8, C), on P's device:
    padded with identities to a power of two (at most padd.REDUCE_MAX_L)
    and added by halving (point j plus point j + L/2, as the reference's
    all-gather loop pairs the shards) in one K1 reduce launch."""
    n, C = P.shape[2], P.shape[3]
    L = _pow2_at_least(n)
    if L == 1:
        return P[:, :, 0]
    if L != n:
        pad = ck.ident_t(P.device)[:, :, None, None].expand(
            3, limb.N32, L - n, C)
        P = torch.cat([P, pad], dim=2)
    return padd_reduce(ck, P[:, :, None])[:, :, 0]


# ---------------------------------------------------------------------------
# the sharded commit MSM
# ---------------------------------------------------------------------------

def _n_local(n: int, ndev: int) -> int:
    """Points a shard: the power of two at or above ceil(n / ndev)."""
    return _pow2_at_least(max(1, -(-n // ndev)))


class ShardedBasis:
    """A fixed MSM basis resident on the mesh: shard d holds points
    [d n_local, (d+1) n_local) as a DeviceBasisV3 on devices[d] (padded
    there with zero-scalar generators; a shard past the last point holds
    padding only).  Uploaded once per generator set; each `sharded_msm`
    call then moves only the scalars."""

    def __init__(self, ck: CurveKernels, points, mesh: Mesh):
        self.ck = ck
        self.mesh = mesh
        pts = (ck.to_proj(points) if isinstance(points, list)
               else np.asarray(points, dtype=np.int32))     # (n, 3, 8)
        self.n = pts.shape[0]
        self.n_local = nl = _n_local(self.n, mesh.size)
        self.shards = [DeviceBasisV3(ck, pts[d * nl:(d + 1) * nl],
                                     device=dev)
                       for d, dev in enumerate(mesh.devices)]


def upload_sharded_scalars(basis: ShardedBasis,
                           scalars: List[int]) -> List[torch.Tensor]:
    """Each shard's slice of the scalars as (n2, 32) uint8 bytes on its
    device (`upload_scalars`; a blocking copy, so all of them come before
    the shards' launches), in the span `Mesh scalars`."""
    if len(scalars) > basis.n:
        raise ValueError(f"{len(scalars)} scalars for a basis of {basis.n}")
    nl = basis.n_local
    with span("Mesh", "scalars"):
        return [upload_scalars(b, [scalars[d * nl:(d + 1) * nl]])[0]
                for d, b in enumerate(basis.shards)]


def gather(lead: torch.device,
           parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The shards' partial results copied to the lead, counted under
    `Mesh gather_bytes` (call inside the span `Mesh gather`)."""
    count("Mesh", "gather_bytes",
          sum(t.numel() * t.element_size() for t in parts))
    return [t.to(lead) for t in parts]


def sharded_windows(ck: CurveKernels, basis: ShardedBasis,
                    scbs: List[torch.Tensor]) -> torch.Tensor:
    """The window sums (3, 8, W) on the lead of the MSM whose scalar bytes
    on the first len(scbs) shards are `scbs` (the shards past them hold
    only zero scalars and are skipped): each shard's (`msm_windows`),
    issued in the span `Mesh issue`, then added across the shards on the
    lead in `Mesh gather`, which ends when the lead has the sum."""
    count("Mesh", "shards", len(scbs))
    with span("Mesh", "issue"):
        wins = [msm_windows(ck, b, s) for b, s in zip(basis.shards, scbs)]
    lead = basis.mesh.lead
    with span("Mesh", "gather"):
        acc = _point_sum(ck, torch.stack(gather(lead, wins), dim=2))
        if lead.type == "cuda":
            torch.cuda.current_stream(lead).synchronize()
    return acc


def sharded_msm(mesh: Mesh, ck: CurveKernels, scalars: List[int],
                points) -> Point:
    """MSM with the points split over the mesh (`points` a ShardedBasis,
    or host points uploaded and split for this call): the window sums of
    `sharded_windows`, combined on the host."""
    if not scalars:
        raise ValueError("empty MSM")
    if not isinstance(points, ShardedBasis):
        points = ShardedBasis(ck, points, mesh)
    if points.mesh != mesh:
        raise ValueError("the basis lies on another mesh")
    scbs = upload_sharded_scalars(points, scalars)
    return combine_windows(ck, sharded_windows(ck, points, scbs))


# ---------------------------------------------------------------------------
# the sharded sumcheck table
# ---------------------------------------------------------------------------

def sharded_table_cache(lf: LimbField, table: List[int],
                        mesh: Mesh) -> DeviceTableCache:
    """The table split over the mesh by its low bits (a mesh of a power of
    two devices, at most the padded table's size)."""
    return DeviceTableCache(lf, table, devices=mesh.devices)


def table_cache(lf: LimbField, table: List[int],
                mesh: Mesh) -> DeviceTableCache:
    """The device cache the sumcheck route takes on `mesh`: split over it
    where the mesh has a power of two of devices (the low-bit split needs
    one) and the table at least 2 entries a device (the reference's
    len(table) >= 2 ndev); else whole on the lead."""
    m = mesh.size
    if not m & (m - 1) and len(table) >= 2 * m:
        return sharded_table_cache(lf, table, mesh)
    return DeviceTableCache(lf, table, device=mesh.lead)


# ---------------------------------------------------------------------------
# the sharded flagship step
# ---------------------------------------------------------------------------

def _split(x: torch.Tensor, m: int, devices) -> List[torch.Tensor]:
    """x split into m equal contiguous blocks of its last axis, block d on
    devices[d]."""
    w = x.shape[-1]
    if w % m:
        raise ValueError(f"an axis of {w} does not split over {m} devices")
    b = w // m
    return [x[..., d * b:(d + 1) * b].contiguous().to(dev)
            for d, dev in enumerate(devices)]


def sharded_prover_step(mesh: Mesh):
    """One multi-device prover step on F_Q: `step(states, t_tab, eq_tab,
    r, pts)` with states (5, 8, B), the split-halved tables (2, 8, half),
    r (8, 1) and Vesta points (3, 8, n), each batch axis a multiple of the
    mesh's size.  The states, the tables' half axis (the pairs stay on
    their shard) and the points split over the mesh; returns, gathered on
    the lead, the permuted states, both folded tables, the coefficients
    xsq, x, con (each (8, 1)) and the points' sum (3, 8, 1)."""
    lf, ck, devs = FQ, vesta_kernels(), mesh.devices

    def step(states, t_tab, eq_tab, r, pts):
        lead = mesh.lead
        m = mesh.size
        with span("Mesh", "scalars"):
            shards = list(zip(_split(states, m, devs),
                              _split(t_tab, m, devs),
                              _split(eq_tab, m, devs), _split(pts, m, devs)))
        count("Mesh", "shards", m)
        outs = []
        with span("Mesh", "issue"):
            for (s, t, e, p), dev in zip(shards, devs):
                rd = r.to(dev)
                g, _ = K.coeffs(lf, t[0], t[1], e[0], e[1])
                outs.append((poseidon_device.permute(lf, s), g,
                             *K.fold(lf, t[0], t[1], e[0], e[1], rd),
                             _point_sum(ck, p[:, :, :, None])))
        g, _ = sum_coeffs(lf, [o[1] for o in outs], lead)
        with span("Mesh", "gather"):
            acc = _point_sum(ck, torch.stack(
                gather(lead, [o[4] for o in outs]), dim=2))
            cat = [torch.cat(gather(lead, [o[i] for o in outs]), dim=-1)
                   for i in (0, 2, 3)]
        return cat[0], cat[1], cat[2], g[0], g[1], g[2], acc

    return step


def sharded_example_args(mesh: Mesh, generator: torch.Generator,
                         batch_per_dev: int = 8, half_per_dev: int = 8,
                         pts_per_dev: int = 2):
    """Random step inputs on the lead, drawn from `generator` (on the CPU):
    states (5, 8, B), tables (2, 8, half), r (8, 1), and the Vesta points
    (i + 2) G, i < n, as (3, 8, n)."""
    from ..models.prover_step import random_elems
    m, lead = mesh.size, mesh.lead
    B, H, n = batch_per_dev * m, half_per_dev * m, pts_per_dev * m
    states = random_elems((5, B), generator, lead).permute(1, 0, 2)
    t_tab = random_elems((2, H), generator, lead).permute(1, 0, 2)
    eq_tab = random_elems((2, H), generator, lead).permute(1, 0, 2)
    r = random_elems((1,), generator, lead)
    pts = vesta_kernels().to_proj(
        [VESTA.mul(i + 2, VESTA.gen) for i in range(n)])
    pts = torch.from_numpy(pts).permute(1, 2, 0).contiguous().to(lead)
    return (states.contiguous(), t_tab.contiguous(), eq_tab.contiguous(),
            r, pts)
