"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use, each by its own ``nvcc`` and
all of them started together, into a shared library with a plain C
interface under ``build/kernels/`` (listed in ``.gitignore``), and loaded
with ``ctypes``. A library's file name carries a hash of its source, so an
edited kernel is rebuilt and a stale one is never loaded. Nothing is
compiled when the package is imported.

Each launching wrapper adds one to ``launch_counts[<kernel>]`` right where it
launches, and nowhere else, so a run can show that its path went through
the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

launch_counts: "collections.Counter[str]" = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None


def reset_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing, in parallel, and load
    them all. Returns the seconds spent building (0 when all were built)."""
    global build_seconds
    with _lock:
        if _libs:
            return build_seconds or 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(BUILD_DIR / f"{src.stem}.log", "w")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, log,
                          subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for src, out, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file
            else:
                failed.append(f"{src.name} (rc {rc}):\n"
                              + (BUILD_DIR / f"{src.stem}.log").read_text()[-4000:])
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        build_seconds = time.perf_counter() - t0
        for src in sorted(CSRC.glob("*.cu")):
            lib = ctypes.CDLL(str(_target(src)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[src.stem] = lib
        return build_seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds on first use)."""
    if not _libs:
        build_all()
    return _libs[name]


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``csrc/<name>.cu`` in this directory."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``: a refused
    launch never runs, and a later synchronize would not report it."""
    if err:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
