"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each `.cu` source becomes one shared library with a plain `extern "C"`
interface, compiled by `nvcc` straight from the checkout and loaded with
ctypes: no PyTorch headers, no ninja, so a build takes seconds, not the
minutes a `torch/extension.h` build takes.  The libraries go into the
package's build directory under a name keyed on a hash of every csrc
file and the flags, so an edited source or flag set is never served a
stale library.  `build()` starts one nvcc per source, all at once.

Every wrapper of a kernel calls its launcher through `launch`, which
makes the tensor's card current for the call, and calls `count(kernel)`
once per launch of that kernel (a library may hold several, one per
launcher); a run shows that it went through the kernels by reading
`launch_counts()`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

from .nativebuild import build_dir

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")

FLAGS = ["-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
B = ctypes.c_char_p        # host bytes

# kernel library -> (source, {exported function: argtypes}); every
# function returns a cudaError_t as an int
LIBS = {
    "padd": ("padd.cu", {
        "reef_padd": [P, P, P, I, I, I, P],
        "reef_padd_reduce": [P, L, L, L, L, L, L, I, P, P, I, I, U, I, P]}),
    "msm_tree": ("msm_tree.cu", {"reef_tree_levels": [P, P, I, I, I, I, I,
                                                      P]}),
    "poseidon": ("poseidon.cu", {
        "reef_poseidon_set_consts": [I, I, P, P, P],
        "reef_poseidon": [P, P, I, I, I, I, P]}),
    "sumcheck": ("sumcheck.cu", {
        "reef_sc_coeffs": [P, P, P, P, L, L, L, I, I, P, P, P, P, P, I, I,
                           P],
        "reef_sc_fold": [P, P, P, P, L, L, P, L, P, P, L, I, P],
        "reef_sc_eq_step": [P, L, P, L, P, P, I, P]}),
    "sc_encode": ("sc_encode.cu", {"reef_sc_encode": [P, L, L, P, I, P]}),
    "mont": ("mont.cu", {"reef_mont_mul": [P, P, P, L, I, P],
                         "reef_mont_redc": [P, P, L, I, P]}),
    "ipa": ("ipa.cu", {
        "reef_ipa_scalars": [P, P, P, L, L, I, P],
        "reef_ipa_dots": [P, P, P, L, L, I, I, P],
        "reef_ipa_combine": [P, I, P, I, P, I, P],
        "reef_ipa_fold": [P, P, P, L, L, B, I, P]}),
}

# the kernels whose launches are counted (the K6 libraries have four:
# three round kernels and the table encode, the K3/K4 library two); "padd"
# counts every K1 launch, "padd_spread" those of its group-per-add kernel
# and "padd_reduce" its halving reduces; "poseidon" counts every K5
# launch, "poseidon_spread" those of its block-per-state kernel; the IPA
# library's kernels count one each
KERNELS = ("padd", "padd_spread", "padd_reduce", "msm_tree", "poseidon",
           "poseidon_spread", "sumcheck_coeffs", "sumcheck_fold",
           "sumcheck_eq", "sumcheck_encode", "mont_mul", "mont_redc",
           "ipa_scalars", "ipa_dots", "ipa_combine", "ipa_fold")

_LOADED: Dict[str, ctypes.CDLL] = {}
_COUNTS: Dict[str, int] = {name: 0 for name in KERNELS}
# the compressed SNARK's two Spartan proofs launch from two threads at once
_COUNTS_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()


def count(kernel: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[kernel] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def lib_path(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update("\0".join(FLAGS).encode())
    return os.path.join(build_dir("cuda"),
                        f"libreef_{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named libraries (default: all) that are not built yet,
    one nvcc process per source, all started together.  Returns, per
    library, its path, the build seconds (0 when it was already built)
    and nvcc's register/spill report.  Raises if any build fails."""
    names = list(names or LIBS)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            so = lib_path(name)
            if os.path.exists(so):
                out[name] = {"path": so, "seconds": 0.0, "log": ""}
                continue
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [nvcc(), *FLAGS, "-o", tmp,
                   os.path.join(CSRC, LIBS[name][0])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), so, tmp)
        for name, (proc, so, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {LIBS[name][0]}:\n{log}")
            os.replace(tmp, so)
            out[name] = {"path": so, "log": log,
                         "seconds": time.perf_counter() - t0}
    finally:
        for proc, _, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if need be (once, whichever
    thread asks first)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        path = build([name])[name]["path"]
        lib = ctypes.CDLL(path)
        for fn, argtypes in LIBS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.reef_cuda_error_string.argtypes = [ctypes.c_int]
        lib.reef_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
        return lib


def on_card(name: str, t) -> bool:
    """Whether the wrapper `name` launches its kernel for the tensor t:
    True on a CUDA tensor, False on a CPU tensor (its plain version
    runs), and any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def launch(name: str, fn: str, device, *args) -> None:
    """Call the launcher `fn` of library `name` with `args` and the current
    stream of `device`, with `device` current: `<<<>>>` and
    `cudaMemcpyToSymbol` act on the current device whatever stream they
    are handed, so without the switch a kernel for a second card would
    run on the first.  Raises if the launcher reports a CUDA error."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(name), fn)(*args, stream)
    check(err, fn)


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err:
        msg = next(iter(_LOADED.values())).reef_cuda_error_string(err)
        raise RuntimeError(f"{what}: CUDA error {err}: {msg.decode()}")
