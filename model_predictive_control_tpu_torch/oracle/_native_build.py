"""Build and load the native C++ oracle libraries, and the array helpers
every oracle shares (port of ``oracle/_native_build.py``).

The sources are ``csrc/oracle/*.cpp``, copies of the JAX package's
``native/`` files, built with the JAX package's g++ command (``-O3 -shared
-fPIC -std=c++17``), so the two libraries compute the same bits. A library
is built into ``build/native/`` under a name that carries a hash of its
sources and flags: an edited source builds anew, an unchanged one is reused.
The build writes a temporary file and renames it into place, so processes
that build the same library at once (test workers) never load a partial
one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np
import torch

from ..ops.cuda._build import BUILD_DIR, PKG

NATIVE_DIR = PKG / "csrc" / "oracle"  # the native sources
NATIVE_BUILD_DIR = BUILD_DIR / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# g++'s seconds for each library this process built (not for one reused)
BUILD_SECONDS: dict[str, float] = {}


def build_native_lib(lib_name: str, sources: tuple[str, ...]) -> str:
    """Compile ``sources`` (names under ``csrc/oracle/``) into
    ``build/native/<stem>_<hash>.so`` unless that file exists; returns its
    path."""
    srcs = [NATIVE_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in srcs:
        digest.update(src.read_bytes())
    stem = lib_name.removesuffix(".so")
    out = NATIVE_BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    NATIVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), *map(str, srcs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {lib_name} ({proc.returncode}):\n{proc.stderr}")
    BUILD_SECONDS[lib_name] = time.perf_counter() - t0
    os.replace(tmp, out)
    return str(out)


def load_native_lib(lib_name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    return ctypes.CDLL(build_native_lib(lib_name, sources))


def ptr(a: np.ndarray):
    """Raw double* for a contiguous float64 array."""
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def c64(a) -> np.ndarray:
    """Contiguous float64 numpy copy or view of an array-like or of a
    tensor on any device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))
