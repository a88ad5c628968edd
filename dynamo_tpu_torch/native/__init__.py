"""ctypes loader for the host hot loops in ``csrc/dynamo_native.cpp``.

The port's copy of ``dynamo_tpu.native`` (the role of the reference's native
crates for token hashing and the router's radix index; ref:
lib/tokens/src/lib.rs, kv_router/indexer.rs:224): XXH3-64, the chained block
hashes behind every admission's prefix-cache keys and KV events, and the
KV router's per-decision prefix matcher. The library is built by
``ops/_build.py`` with the host compiler at first use, into the same
``build/`` tree as the CUDA kernels.

Unlike the JAX loader, there is no quiet fallback: a library that does not
build or load raises, with the compiler's output. The pure-Python versions
(``utils/xxh3.py``, the chain in ``tokens.py``, ``KvIndexer(use_native=
False)``) stay beside it as the plain versions the tests hold it against.
This module imports numpy and the standard library only, so the frontend
that runs the router never loads torch.
"""

from __future__ import annotations

import array
import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

# buffers pass as plain addresses (``c_void_p``): a ``ctypes`` pointer
# conversion per argument would cost more than the hash of a block
_P = ctypes.c_void_p


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises when it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from ..ops import _build

            lib = _build.load("dynamo_native")
            lib.dyn_xxh3_64.restype = ctypes.c_uint64
            lib.dyn_xxh3_64.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_uint64]
            lib.dyn_block_hashes.restype = ctypes.c_int64
            lib.dyn_block_hashes.argtypes = [
                _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _P, _P]
            lib.dyn_index_new.restype = ctypes.c_void_p
            lib.dyn_index_new.argtypes = []
            lib.dyn_index_free.restype = None
            lib.dyn_index_free.argtypes = [ctypes.c_void_p]
            for name in ("dyn_index_stored", "dyn_index_removed"):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, _P,
                               ctypes.c_int64]
            lib.dyn_index_clear_worker.restype = None
            lib.dyn_index_clear_worker.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_uint64]
            lib.dyn_index_num_blocks.restype = ctypes.c_int64
            lib.dyn_index_num_blocks.argtypes = [ctypes.c_void_p]
            lib.dyn_index_find_matches.restype = ctypes.c_int64
            lib.dyn_index_find_matches.argtypes = [
                ctypes.c_void_p, _P, ctypes.c_int64, _P, _P, ctypes.c_int64]
            _lib = lib
    return _lib


def _u64s(values) -> array.array:
    """``values`` (ints below 2**64) as a contiguous u64 buffer."""
    if isinstance(values, np.ndarray):
        return array.array("Q", values.astype(np.uint64, copy=False)
                           .tobytes())
    return array.array("Q", values)


# ------------------------------ hashing -----------------------------------


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """``XXH3_64bits_withSeed`` of ``data``; the seed is masked to its low
    64 bits, as ``xxhash`` and ``utils/xxh3.py`` mask it."""
    data = bytes(data)
    return get_lib().dyn_xxh3_64(data, len(data), seed & (2 ** 64 - 1))


def block_hashes(tokens, block_size: int,
                 seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(block hashes, sequence hashes) of every complete block of
    ``tokens`` (u32 ids), as uint64 arrays."""
    bh, sh = _chain(tokens, block_size, seed)
    return np.frombuffer(bh, np.uint64), np.frombuffer(sh, np.uint64)


def sequence_hashes(tokens, block_size: int, seed: int) -> list:
    """The sequence hashes of :func:`block_hashes`, as a list of ints."""
    return _chain(tokens, block_size, seed)[1].tolist()


def _chain(tokens, block_size: int, seed: int):
    lib = get_lib()
    if isinstance(tokens, np.ndarray):
        toks = array.array("I", tokens.astype(np.uint32, copy=False)
                           .tobytes())
    else:
        toks = array.array("I", tokens)
    n_blocks = len(toks) // block_size if block_size > 0 else 0
    bh = array.array("Q", bytes(8 * n_blocks))
    sh = array.array("Q", bytes(8 * n_blocks))
    got = lib.dyn_block_hashes(toks.buffer_info()[0], len(toks), block_size,
                               seed, bh.buffer_info()[0],
                               sh.buffer_info()[0])
    if got != n_blocks:
        raise RuntimeError(f"dyn_block_hashes wrote {got} of {n_blocks} "
                           "blocks")
    return bh, sh


# ---------------------------- prefix index ---------------------------------


class NativePrefixIndex:
    """C++ longest-prefix matcher (chained sequence hashes -> workers)."""

    def __init__(self):
        self._h = None
        self._lib = get_lib()
        self._h = self._lib.dyn_index_new()
        self._out_cap = 0

    def close(self) -> None:
        if self._h is not None:
            self._lib.dyn_index_free(self._h)
            self._h = None

    __del__ = close

    def stored(self, worker: int, seq_hashes) -> None:
        a = _u64s(seq_hashes)
        self._lib.dyn_index_stored(self._h, worker, a.buffer_info()[0],
                                   len(a))

    def removed(self, worker: int, seq_hashes) -> None:
        a = _u64s(seq_hashes)
        self._lib.dyn_index_removed(self._h, worker, a.buffer_info()[0],
                                    len(a))

    def clear_worker(self, worker: int) -> None:
        self._lib.dyn_index_clear_worker(self._h, worker)

    @property
    def num_blocks(self) -> int:
        return self._lib.dyn_index_num_blocks(self._h)

    def find_matches(self, seq_hashes, max_workers: int = 4096
                     ) -> Dict[int, int]:
        a = _u64s(seq_hashes)
        if self._out_cap != max_workers:
            # the output buffers are made once and reused
            self._workers = array.array("Q", bytes(8 * max_workers))
            self._depths = array.array("q", bytes(8 * max_workers))
            self._out_cap = max_workers
        n = self._lib.dyn_index_find_matches(
            self._h, a.buffer_info()[0], len(a),
            self._workers.buffer_info()[0], self._depths.buffer_info()[0],
            max_workers)
        return dict(zip(self._workers[:n].tolist(),
                        self._depths[:n].tolist()))
