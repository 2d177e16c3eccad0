"""Shared g++ build for the host libraries (msm / fieldvec / solver).

The C++ sources live in the repository's `native/` directory, which both
packages read; this package builds its own copies into `build_dir()`
(listed in .gitignore) and never loads a library it did not build there.

One place decides the flag set, so the three libraries can never drift to
different codegen.  The BMI2/ADX and AVX-512 IFMA fast-path flags are only
added when /proc/cpuinfo advertises the features.  The library's file name
carries a hash of the source, the flags and the CPU's feature set, so a
library built on (or copied from) a host with other features is never
loaded: it simply has another name, and this host builds its own.  A build
failure retries once with the conservative flag set before giving up.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List, Optional

_BASE = ["-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17"]

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    """The checkout root (holds `native/` and the package)."""
    return os.path.dirname(_PKG_ROOT)


def build_dir(*parts: str) -> str:
    """The package's build and cache directory (created on demand)."""
    path = os.path.join(_PKG_ROOT, "_build", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def native_src(name: str) -> str:
    return os.path.join(repo_root(), "native", name)


def _cpu_fast_flags() -> List[str]:
    try:
        with open("/proc/cpuinfo") as fh:
            info = fh.read()
        flags_lines = [ln for ln in info.splitlines()
                       if ln.startswith("flags")]
        feats = set(flags_lines[0].split(":", 1)[1].split()) \
            if flags_lines else set()
        out = []
        if "bmi2" in feats:
            out.append("-mbmi2")
        if "adx" in feats:
            out.append("-madx")
        if {"avx512ifma", "avx512f", "avx512dq",
                "avx512vl"} <= feats:
            # enables the 8-wide 5x52 Montgomery bucket phase in msm.cpp
            out += ["-mavx512f", "-mavx512dq", "-mavx512vl",
                    "-mavx512ifma"]
        return out
    except OSError:
        return []


def lib_path(src: str, stem: str, flags: List[str]) -> str:
    """Where the library built from `src` with `flags` lives."""
    h = hashlib.sha256()
    with open(src, "rb") as fh:
        h.update(fh.read())
    h.update("\0".join(flags).encode())
    return os.path.join(build_dir(), f"{stem}-{h.hexdigest()[:16]}.so")


def _compile(src: str, so: str, flags: List[str]) -> None:
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *flags, src, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_native_lib(src: str, stem: str,
                     extra: Optional[List[str]] = None) -> str:
    """Build `src` into the build directory unless a library with the same
    source and flags is already there; returns its path, raises on
    failure.  The write is atomic (temp file + rename), so concurrent
    builders of one library never see a partial file."""
    extra = list(extra or [])
    candidates = [_BASE + _cpu_fast_flags() + extra, _BASE + extra]
    for flags in candidates:
        so = lib_path(src, stem, flags)
        if os.path.exists(so):
            return so
    for flags in candidates[:-1]:
        so = lib_path(src, stem, flags)
        try:
            _compile(src, so, flags)
            return so
        except subprocess.CalledProcessError:
            continue
    # final attempt, letting the exception propagate with stderr attached
    so = lib_path(src, stem, candidates[-1])
    _compile(src, so, candidates[-1])
    return so
