"""Build the package's C sources at first use and load them with ``ctypes``.

Each source under ``csrc/`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) in
``build/torch_kernels/`` at the root of the checkout: a ``.cu`` source (the
CUDA kernels) is compiled by ``nvcc`` for ``sm_90a``, a ``.cpp`` source (the
host hot loops, ``dynamo_native.cpp``) by the host compiler, ``$CXX`` or
else ``g++`` (the one ``nvcc`` itself drives). The library's file name
carries a hash of its source and flags, so an edited source is rebuilt and a
stale library is never loaded; it is written under a name of its own and
moved into place with one ``os.replace``, so processes that build at once
never load half a file. A failed build raises with the compiler's output.
Nothing is built when the module is imported, and the module imports no
``torch``: the frontend loads the host library through it.
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
CUDA_SOURCES = ("paged_attention",)
HOST_SOURCES = ("dynamo_native",)
SOURCES = CUDA_SOURCES + HOST_SOURCES
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# the compiler's report of the last build of each source (ptxas registers
# and shared memory for the CUDA ones)
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


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found:
        return found
    raise RuntimeError(
        f"host C++ compiler {cxx!r} not found (set CXX or put g++ on "
        "PATH): csrc/*.cpp are built at first use"
    )


def _source(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """The source file of ``name`` and its compiler flags."""
    if name in HOST_SOURCES:
        return SRC_DIR / f"{name}.cpp", CXX_FLAGS
    return SRC_DIR / f"{name}.cu", NVCC_FLAGS


def _lib_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _compile(name: str) -> Tuple[Path, float]:
    """Compile one source into its shared library (skipped when the hashed
    library exists). Returns (library path, seconds spent compiling)."""
    out = _lib_path(name)
    if out.exists():
        return out, 0.0
    src, flags = _source(name)
    compiler = _cxx() if name in HOST_SOURCES else _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(compiler).name} failed for csrc/{src.name} "
            f"({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    build_logs[name] = (proc.stdout + proc.stderr).strip()
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, took


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source, one compiler process each, all started
    together.
    Returns the compile seconds of each (0.0 when already built)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        results = dict(zip(names, pool.map(_compile, names)))
    return {name: took for name, (_, took) in results.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built on first
    use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = _compile(name)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
