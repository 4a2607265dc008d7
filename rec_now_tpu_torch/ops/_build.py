"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``_build/<name>-<hash>.so`` (the directory is git-ignored) for
``sm_90a``.  The build runs at first use, so nothing is compiled when a
module is imported, and again whenever the source's content hash
changes.  A failed build raises with nvcc's stderr.  ptxas's report
(registers, shared memory, spills) is kept beside the library as
``<name>-<hash>.log``.

Usage::

    lib = load("cin")                 # builds if needed, then dlopens
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` at its current content goes."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if stale and return the loaded library."""
    lib = _loaded.get(name)
    if lib is None:
        out = library_path(name)
        if not out.exists():
            _compile(name, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib


def _compile(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, out)
