"""Which torch device the prover's device routes run on.

The entry points take a device and default to CUDA.  A process selects its
engine device once (the CLI's --device); the Pedersen commit routing and
the device bases read it.  Asking for CUDA where torch sees no CUDA device
raises: nothing carries on on the CPU unless the CPU was asked for, in
which case the kernels' plain versions run there.

Classification for the "auto" routing gate (commitment._device_msm_on):
  "cpu"          — the engine device is the CPU, or none was selected and
                   torch sees no CUDA device: auto stays on the host MSM;
  "local-accel"  — the engine device is a CUDA card: auto engages it.
(REEF_DEVICE_PROFILE overrides the classification.)
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_SELECTED: Optional[torch.device] = None


def _check(dev: torch.device) -> torch.device:
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch sees no CUDA device; pass "
            "device 'cpu' (CLI: --device cpu) to run the kernels' plain "
            "versions on the CPU")
    return dev


def select(device="cuda") -> torch.device:
    """Set the process's engine device (validated; raises without CUDA
    unless 'cpu' is asked for)."""
    global _SELECTED
    _SELECTED = _check(torch.device(device))
    return _SELECTED


def resolve(device=None) -> torch.device:
    """`device` if given, else the selected engine device, else CUDA."""
    if device is not None:
        return _check(torch.device(device))
    if _SELECTED is not None:
        return _SELECTED
    return _check(torch.device("cuda"))


def device_profile() -> str:
    """"cpu" or "local-accel" (see the module docstring)."""
    forced = os.environ.get("REEF_DEVICE_PROFILE")
    if forced in ("cpu", "local-accel"):
        return forced
    if _SELECTED is not None:
        return "local-accel" if _SELECTED.type == "cuda" else "cpu"
    return "local-accel" if torch.cuda.is_available() else "cpu"

