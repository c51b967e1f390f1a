"""Build and load the hand-written CUDA kernels.

Each kernel is a shared library with a plain C interface, compiled with nvcc
for ``sm_90a`` from named ``csrc/`` sources and loaded with ctypes. The
library's file name carries a hash of its sources and flags, so an edited
source builds anew and an unchanged one is reused from ``build/``. Builds of
different libraries may run at the same time (one lock per library).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time
from typing import Callable

from ...obs.profiling import span

PKG = pathlib.Path(__file__).resolve().parents[2]
BUILD_DIR = PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's seconds for each library this process built (not for one reused)
BUILD_SECONDS: dict[str, float] = {}
_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()


def ptxas_report(name: str) -> pathlib.Path:
    """Where the last build of ``name`` left ptxas's register and spill
    report."""
    return BUILD_DIR / f"{name}.ptxas.txt"


def _compile(name: str, sources: list[pathlib.Path], flags: list[str],
             depends: tuple = ()) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in (*sources, *depends):
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *flags, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    ptxas_report(name).write_text(proc.stderr)
    tmp.replace(out)
    return out


def load_library(
    name: str,
    sources: list[pathlib.Path],
    configure: Callable[[ctypes.CDLL], None],
    extra_flags: tuple[str, ...] = (),
    depends: tuple = (),
) -> ctypes.CDLL:
    """The library ``name`` built from ``sources`` with :data:`NVCC_FLAGS`
    and ``extra_flags``, loaded once per process; ``configure`` sets its
    functions' ctypes signatures on first load. ``depends`` lists files the
    sources include: they key the build too. The first load (nvcc's build,
    where the cache has no library, and the load) is the span ``build``."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            with span("build"):
                lib = ctypes.CDLL(str(_compile(name, sources, [*NVCC_FLAGS, *extra_flags],
                                               depends)))
                configure(lib)
            _loaded[name] = lib
        return lib
