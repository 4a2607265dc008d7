"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` (:data:`SOURCES`) exposes a plain C interface and
compiles on its own into ``_build/<name>-<hash>.so`` (the directory is
git-ignored) for ``sm_90a``.  The build runs at first use, so nothing is
compiled when a module is imported, and again whenever the source's
content hash changes.  A failed build raises with nvcc's stderr.
ptxas's report (registers, shared memory, spills) is kept beside the
library as ``<name>-<hash>.log``.

Also here: the checks every kernel wrapper makes before it hands
pointers to a library (:func:`is_cpu`, :func:`check_input`,
:func:`check_rc`).

Usage::

    lib = load("cin")                 # builds if needed, then dlopens
    secs = build_all()                # every source at once, one nvcc each
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("cin", "pairwise", "table_update", "multi_dense", "listwise")
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
            _finish(name, *_start(name, out))
        lib = ctypes.CDLL(str(out))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def build_all() -> Dict[str, float]:
    """Compile every stale source at once, one nvcc process each.

    Returns the wall seconds of each build (0.0 where the library was
    current).  Raises on the first failed build, after all have ended.
    """
    secs = {name: 0.0 for name in SOURCES}
    running = {}
    for name in SOURCES:
        out = library_path(name)
        if not out.exists():
            running[name] = _start(name, out) + (time.perf_counter(),)
    while running:
        for name in [n for n, r in running.items() if r[0].poll() is not None]:
            proc, out, log, t0 = running.pop(name)
            secs[name] = time.perf_counter() - t0
            _finish(name, proc, out, log)
        time.sleep(0.05)
    return secs


def _start(name: str, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(f".{os.getpid()}.log.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    with open(log, "w") as sink:       # a file, not a pipe: no pipe to fill
        proc = subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT)
    return proc, out, log


def _finish(name: str, proc: subprocess.Popen, out: Path, log: Path) -> None:
    rc = proc.wait()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    text = log.read_text()
    log.unlink()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
                           f"{text}")
    out.with_suffix(".log").write_text(text)
    os.replace(tmp, out)


def is_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for CUDA;
    any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU, not {x.device}")
    return False


def check_input(name: str, t: torch.Tensor, ndim: int,
                device: torch.device,
                dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D ``dtype`` tensor on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.error_string(rc).decode()} ({rc})")


def stream_of(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as the C entry points
    take it."""
    return torch.cuda.current_stream(x.device).cuda_stream
