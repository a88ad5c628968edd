"""G2 host-memory + G3 disk block pools, sequence-hash keyed
(ref: lib/llm/src/block_manager/pool/managed.rs — active/inactive pools
with hash reuse; storage/disk.rs for the disk tier).

A block's payload is its per-block KV: ``{"k","v"}: [L, KV, bs, hd]``
CPU tensors — plus ``"ks"``/``"vs"`` float32 scales when the engine
serves a quantized KV cache. G2 is an LRU dict bounded by
``capacity_blocks`` AND (when ``capacity_bytes`` > 0) by total payload
bytes — the byte bound is what lets an int8 cache hold ~2x the blocks of
a bf16 cache in the same host budget. Overflow spills to G3 (one file per
block under ``disk_dir``) when configured, else drops. Lookups check G2
then G3 (disk hits are re-promoted to G2).

A copy of ``dynamo_tpu.kvbm.host_pool`` on torch CPU tensors (the host form
of a KV payload in this package, ``disagg/protocol.py``). A G3 file keeps
the JAX package's format — an ``.npz`` with ``__keys__``, each key's array
and its ``{key}_dtype`` name, bf16 and fp8 stored as uint16/uint8 views —
so each package reads the other's spill files.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..disagg.protocol import dtype_name, torch_dtype
from ..utils.logging import get_logger

log = get_logger("kvbm.host_pool")

# numpy stores what it has no dtype for (bf16, fp8) as unsigned views
_UINT = {1: np.uint8, 2: np.uint16}


def _from_saved(a: np.ndarray, name: str) -> torch.Tensor:
    """A spill file's array back as a tensor of its saved dtype name."""
    if name == a.dtype.name:
        return torch.from_numpy(np.ascontiguousarray(a))
    dt = torch_dtype(name)
    if a.dtype.itemsize != dt.itemsize:
        raise ValueError(f"saved view {a.dtype} cannot hold {name}")
    raw = torch.from_numpy(np.ascontiguousarray(a).view(
        np.int16 if a.dtype.itemsize == 2 else np.uint8))
    return raw.view(dt)


def _to_saved(t: torch.Tensor) -> np.ndarray:
    """A payload tensor as the array a spill file stores."""
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        raw = t.view(torch.int16 if t.element_size() == 2 else torch.uint8)
        return raw.numpy().view(_UINT[t.element_size()])
    return t.numpy()


@dataclass
class HostPoolStats:
    g2_blocks: int = 0
    g2_bytes: int = 0
    g3_blocks: int = 0
    g2_hits: int = 0
    g3_hits: int = 0
    misses: int = 0
    spills: int = 0
    drops: int = 0


class HostBlockPool:
    def __init__(
        self,
        capacity_blocks: int,
        disk_dir: Optional[str] = None,
        disk_capacity_blocks: int = 0,
        capacity_bytes: int = 0,
    ):
        self.capacity = capacity_blocks
        # 0 = unbounded; rides the incremental _mem_bytes accounting, so
        # the bound is O(1) per put regardless of pool size
        self.capacity_bytes = capacity_bytes
        self.disk_dir = Path(disk_dir) if disk_dir else None
        self.disk_capacity = disk_capacity_blocks if disk_dir else 0
        if self.disk_dir is not None:
            self.disk_dir.mkdir(parents=True, exist_ok=True)
        self._mem: "OrderedDict[int, Dict[str, torch.Tensor]]" = OrderedDict()
        self._mem_bytes = 0  # incremental: a per-put sum over G2 is O(n)
        self._disk: "OrderedDict[int, Path]" = OrderedDict()
        self.stats = HostPoolStats()
        # called with a seq_hash that left the pool entirely (distributed
        # KVBM retracts its presence advertisement)
        self.on_drop = None

    # -- query --

    def __contains__(self, seq_hash: int) -> bool:
        return seq_hash in self._mem or seq_hash in self._disk

    def get(self, seq_hash: int) -> Optional[Dict[str, torch.Tensor]]:
        data = self._mem.get(seq_hash)
        if data is not None:
            self._mem.move_to_end(seq_hash)
            self.stats.g2_hits += 1
            return data
        path = self._disk.get(seq_hash)
        if path is not None:
            try:
                with np.load(path) as z:
                    if "__keys__" in z:
                        # per-key payload + dtype (quantized caches mix
                        # 1-byte pages with float32 scales)
                        data = {
                            key: _from_saved(z[key], str(z[f"{key}_dtype"]))
                            for key in [str(x) for x in z["__keys__"]]
                        }
                    else:  # legacy {"k","v"} single-dtype layout
                        # bfloat16 round-trips as uint16 views (np.savez
                        # can't serialise it natively)
                        dtype = str(z["dtype"]) if "dtype" in z else None
                        data = {n: _from_saved(z[n], dtype or z[n].dtype.name)
                                for n in ("k", "v")}
            except Exception:
                log.exception("G3 read failed for %x", seq_hash)
                self._disk.pop(seq_hash, None)
                return None
            self.stats.g3_hits += 1
            self.put(seq_hash, data)  # promote back to G2
            return data
        self.stats.misses += 1
        return None

    # -- insert --

    def put(self, seq_hash: int, data: Dict[str, torch.Tensor]) -> None:
        if seq_hash in self._mem:
            self._mem.move_to_end(seq_hash)
            return
        self._mem[seq_hash] = data
        self._mem_bytes += sum(a.nbytes for a in data.values())
        while self._mem and (
            len(self._mem) > self.capacity
            or (self.capacity_bytes > 0
                and self._mem_bytes > self.capacity_bytes)
        ):
            old_hash, old_data = self._mem.popitem(last=False)
            self._mem_bytes -= sum(a.nbytes for a in old_data.values())
            self._spill(old_hash, old_data)
        self._refresh()

    def _spill(self, seq_hash: int, data: Dict[str, torch.Tensor]) -> None:
        if self.disk_dir is None or self.disk_capacity <= 0:
            self.stats.drops += 1
            if self.on_drop is not None:
                self.on_drop(seq_hash)
            return
        if seq_hash in self._disk:
            return
        path = self.disk_dir / f"{seq_hash:016x}.npz"
        try:
            save: Dict[str, np.ndarray] = {
                "__keys__": np.asarray(sorted(data.keys()))
            }
            for key, a in data.items():
                save[f"{key}_dtype"] = np.asarray(dtype_name(a.dtype))
                save[key] = _to_saved(a)
            np.savez(path, **save)
        except Exception:
            log.exception("G3 spill failed for %x", seq_hash)
            if self.on_drop is not None:  # the block is gone — retract
                self.on_drop(seq_hash)
            return
        self._disk[seq_hash] = path
        self.stats.spills += 1
        while len(self._disk) > self.disk_capacity:
            old_hash, old_path = self._disk.popitem(last=False)
            try:
                os.unlink(old_path)
            except OSError:
                pass
            # fire only when the block left the pool ENTIRELY — a G3 copy
            # of a block promoted back to G2 stays servable from _mem
            if self.on_drop is not None and old_hash not in self._mem:
                self.on_drop(old_hash)
        self._refresh()

    def _refresh(self) -> None:
        self.stats.g2_blocks = len(self._mem)
        self.stats.g2_bytes = self._mem_bytes
        self.stats.g3_blocks = len(self._disk)
