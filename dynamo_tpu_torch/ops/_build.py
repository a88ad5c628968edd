"""Build the package's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each source under ``csrc/`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
``sm_90a`` into ``build/torch_kernels/`` at the root of the checkout. The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built when
the module is imported: the CPU never needs a library.
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
from typing import Dict, Iterable, Tuple

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("paged_attention",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of the last build of each source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from csrc/ at first use"
    )


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _compile(name: str) -> Tuple[Path, float]:
    """nvcc one source into its shared library (skipped when the hashed
    library exists). Returns (library path, seconds spent compiling)."""
    out = _lib_path(name)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    build_logs[name] = (proc.stdout + proc.stderr).strip()
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, took


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source, one ``nvcc`` each, all started together.
    Returns the compile seconds of each (0.0 when already built)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        results = dict(zip(names, pool.map(_compile, names)))
    return {name: took for name, (_, took) in results.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = _compile(name)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
