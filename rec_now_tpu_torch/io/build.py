"""Build the native Criteo parser with g++ and load it with ctypes.

``io/native/criteo_parser.cpp`` (a plain C interface) compiles at first
use into the git-ignored ``_build/recio-<hash>.so`` with ``g++ -O3
-std=c++17 -shared -fPIC -march=native -pthread``.  The hash covers the
source, the flags and what ``-march=native`` means on this host (g++'s
``-Q --help=target`` report), so a tree copied to another machine never
loads a library built for another CPU, and an edited source rebuilds.
The compiler writes a file of its own process and ``os.replace`` puts it
in place, so processes that build at the same moment never load a
half-written library.  A failed build raises with g++'s output: there is
no fallback to the Python parser, which runs only when a caller asks for
it (``parse_chunk(..., force_python=True)``).

Usage::

    lib = load()          # builds if needed, then dlopens
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "native" / "criteo_parser.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX = "g++"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
         "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _run(cmd, what: str) -> subprocess.CompletedProcess:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"{what}: cannot run {cmd[0]!r}: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"{what} (exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    return out


def library_path() -> Path:
    """Where the build of the parser at its current content goes for
    this host's ``-march=native``."""
    target = _run([CXX, "-march=native", "-Q", "--help=target"],
                  "g++ could not report its native target").stdout
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([CXX] + FLAGS).encode() + b"\0" + target.encode())
    return BUILD_DIR / f"recio-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The parser's library, built first if this host has no current
    build; raises RuntimeError when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                try:
                    _run([CXX, *FLAGS, "-o", str(tmp), str(SRC)],
                         f"g++ failed on {SRC.name}")
                    os.replace(tmp, out)
                finally:
                    tmp.unlink(missing_ok=True)
            _lib = _bind(ctypes.CDLL(str(out)))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.rn_parse_criteo.restype = i64
    lib.rn_parse_criteo.argtypes = [
        ctypes.c_char_p, i64,          # buf, len
        i32, i32,                      # num_dense, num_sparse
        i64,                           # rows_per_field
        i32, i64,                      # group_field, num_groups
        i32, i64,                      # num_threads, max_rows
        ptr, ptr, ptr, ptr,            # dense, ids, labels, group_ids
    ]
    lib.rn_fnv1a_mod.restype = i64
    lib.rn_fnv1a_mod.argtypes = [ctypes.c_char_p, i64, i64]
    return lib
