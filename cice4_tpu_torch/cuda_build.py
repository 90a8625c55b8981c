"""Build and load the port's CUDA kernels.

Each kernel library is one CUDA C++ source under ``csrc/`` with a plain
C interface (headers ``csrc/*.cuh`` are shared between sources).  At
first use in a process, :func:`load` compiles it with ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
checkout's ``build/`` directory and loads it with ``ctypes``.  The
library's file name carries a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-kernel flags: these kernels follow their plain PyTorch versions
# operation by operation, so nvcc must not contract a*b+c into an FMA that
# eager PyTorch does not do (it could flip the remap geometry's case tests)
EXTRA_FLAGS = {"evp_subcycle": ("-fmad=false",),
               "evp_rounds": ("-fmad=false",),
               "remap_gsh": ("-fmad=false",),
               "remap_k12": ("-fmad=false",),
               "remap_k1k2": ("-fmad=false",),
               "ridge_column": ("-fmad=false",),
               "gfdl_column": ("-fmad=false",)}
NVCC_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    built: bool           # False when an existing build was reused
    seconds: float        # nvcc wall time (0.0 when reused)
    log: str              # nvcc/ptxas output (registers, spills)


_loaded: dict[str, Library] = {}
_locks: dict[str, threading.Lock] = {}
_guard = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "cice4_tpu_torch need the CUDA toolkit")
    return path


def load(name: str) -> Library:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process).
    Concurrent calls for different names build in parallel."""
    with _guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC / f"{name}.cu"
        deps = [src] + sorted(CSRC.glob("*.cuh"))
        flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
        digest = hashlib.sha256(" ".join(flags).encode())
        for dep in deps:
            digest.update(dep.read_bytes())
        so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        log_path = so.with_suffix(".log")
        built, seconds, log = False, 0.0, ""
        if so.exists():
            log = log_path.read_text() if log_path.exists() else ""
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=NVCC_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name} (rc={res.returncode}):\n"
                    f"{' '.join(cmd)}\n{log}")
            log_path.write_text(log)
            os.replace(tmp, so)
            built = True
        out = Library(lib=ctypes.CDLL(str(so)), path=so, built=built,
                      seconds=seconds, log=log)
        _loaded[name] = out
        return out


def load_all(names) -> dict[str, Library]:
    """Build and load several kernels at once, one nvcc each, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load, names)))
