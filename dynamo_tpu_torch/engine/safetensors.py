"""The safetensors format, read and written without the ``safetensors``
package (the card's machine has neither it nor ``ml_dtypes``).

A file is an 8-byte little-endian header length ``N``, ``N`` bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with an
optional ``"__metadata__": {str: str}``, then one buffer holding every
tensor's raw little-endian bytes; ``data_offsets`` count from the start of
that buffer. The writer pads the JSON with spaces to a multiple of 8 bytes
and lays the tensors out largest element first, then by name, as the
library does.

:class:`SafeFile` maps the file copy-on-write and hands out one tensor at a
time as a CPU tensor that views the mapping (no copy); :meth:`release`
drops a tensor's pages once it has been copied elsewhere, so reading a
checkpoint never holds more than one tensor's pages resident.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, List, Optional, Tuple

import torch

# the format's dtype names this package reads and writes
DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "F8_E4M3": torch.float8_e4m3fn,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# bytes per element of every dtype the format defines: a header entry is
# checked against these when the file is opened, so a corrupt header fails
# there while an unread tensor of a dtype outside DTYPES passes
ITEMSIZE = {
    "BOOL": 1, "U8": 1, "I8": 1, "F8_E4M3": 1, "F8_E5M2": 1,
    "I16": 2, "U16": 2, "F16": 2, "BF16": 2,
    "I32": 4, "U32": 4, "F32": 4,
    "I64": 8, "U64": 8, "F64": 8,
}
_MAX_HEADER = 100 << 20      # the library refuses larger headers too
_ALIGN = 8


class SafeFile:
    """One ``*.safetensors`` file, mapped. Use as a context manager; the
    tensors :meth:`get_tensor` returns view the mapping and stay valid
    while a reference to them lives (``clone()`` one to own it)."""

    def __init__(self, path):
        self.path = str(path)
        self._f = open(self.path, "rb")
        self._mm: Optional[mmap.mmap] = None
        try:
            size = os.fstat(self._f.fileno()).st_size
            head = self._f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: shorter than 8 bytes")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER or 8 + n > size:
                raise ValueError(f"{self.path}: bad header length {n}")
            header = json.loads(self._f.read(n))
            self._meta = header.pop("__metadata__", None)
            self._base = 8 + n
            self._info: Dict[str, Tuple[str, List[int],
                                        Tuple[int, int]]] = {}
            for name, e in header.items():
                self._info[name] = self._check(name, e, size - self._base)
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_COPY)
        except Exception:
            self._f.close()
            raise

    def _check(self, name, e, data_len):
        dtype = e["dtype"]
        if dtype not in ITEMSIZE:
            raise ValueError(f"{self.path}: {name}: dtype {dtype} not one "
                             f"of the format's {sorted(ITEMSIZE)}")
        shape = [int(d) for d in e["shape"]]
        begin, end = (int(o) for o in e["data_offsets"])
        numel = 1
        for d in shape:
            numel *= d
        if not 0 <= begin <= end <= data_len \
                or end - begin != numel * ITEMSIZE[dtype]:
            raise ValueError(f"{self.path}: {name}: data_offsets "
                             f"{[begin, end]} do not fit {dtype} {shape}")
        return dtype, shape, (begin, end)

    def _torch_dtype(self, name: str) -> torch.dtype:
        """The torch dtype of ``name``; raises, by name, for a dtype this
        package does not read (checked only when the tensor is read)."""
        dtype = self._info[name][0]
        if dtype not in DTYPES:
            raise ValueError(f"{self.path}: {name}: dtype {dtype} not one "
                             f"of {sorted(DTYPES)}")
        return DTYPES[dtype]

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # a tensor still views it: it unmaps with the last one
            self._mm = None
        self._f.close()

    def keys(self) -> List[str]:
        """Tensor names, sorted (as ``safe_open().keys()`` gives them)."""
        return sorted(self._info)

    def metadata(self) -> Optional[Dict[str, str]]:
        return self._meta

    def nbytes(self, name: str) -> int:
        self._torch_dtype(name)
        begin, end = self._info[name][2]
        return end - begin

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a CPU tensor viewing the mapping."""
        dt = self._torch_dtype(name)
        _, shape, (begin, end) = self._info[name]
        if end == begin:
            return torch.empty(shape, dtype=dt)
        raw = torch.frombuffer(self._mm, dtype=torch.uint8,
                               count=end - begin, offset=self._base + begin)
        return raw.view(dt).reshape(shape)

    def release(self, name: str) -> None:
        """Drop the resident pages of ``name`` (after it was copied out);
        a later :meth:`get_tensor` reads them from the file again."""
        advice = getattr(mmap, "MADV_DONTNEED", None)
        begin, end = self._info[name][2]
        if advice is None or end == begin:
            return
        page = mmap.PAGESIZE
        lo = (self._base + begin) // page * page
        hi = -(-(self._base + end) // page) * page
        self._mm.madvise(advice, lo, min(hi, len(self._mm)) - lo)


def save_file(tensors: Dict[str, torch.Tensor], path,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; contiguous copies are taken) to
    ``path``, with ``metadata`` as ``__metadata__``."""
    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} not writable")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % _ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name]
            if t.numel():
                raw = t.detach().to("cpu").contiguous().reshape(-1)
                f.write(memoryview(raw.view(torch.uint8).numpy()))
