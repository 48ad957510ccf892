"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it into a shared library in seconds.  The library goes to
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags: a changed source rebuilds, an unchanged one loads
the library already there.  Nothing is built at import; the first call
that launches a kernel builds it.  ``load_all`` builds several sources at
once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# sm_90a (with the "a"): Hopper's wgmma/setmaxnreg exist only for that
# target; -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()               # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"path", "seconds", "cached", "log"} of the build that loaded it
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of tpinn_torch are built from csrc/ at first use")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = BUILD_DIR / f"{name}-{digest}.so"
        t0 = time.perf_counter()
        log = ""
        cached = so.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        BUILD_INFO[name] = {"path": str(so), "cached": cached, "log": log,
                            "seconds": time.perf_counter() - t0}
        _LIBS[name] = lib
        return lib


def load_all(names: Sequence[str]) -> None:
    """Build and load several sources concurrently (one nvcc each)."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for fut in [pool.submit(load, n) for n in names]:
            fut.result()
