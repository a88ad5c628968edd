"""Wire encoding for KV block payloads and transfer params
(ref: the ``kv_transfer_params`` dict threaded through handlers.py:147-188
and the block-ID-only descriptor design of disagg_serving.md §Efficient KV
Transfer — metadata rides the control message; bulk bytes ride the
transport's binary frames).

Every frame carries an integrity envelope: the byte length implied by
``shape``/``dtype`` plus a CRC32 over each tensor's raw bytes. The decode
side verifies the envelope *before* scattering into reserved blocks, so a
truncated, bit-flipped, or dtype-mangled relay payload is rejected (the
handoff falls back / retries) instead of poisoning the KV cache.

Quantized KV (``EngineConfig.kv_dtype`` int8/fp8) payloads carry two extra
tensors — the float32 per-(slot, head) scale caches ``ks``/``vs`` — with
their own shape/dtype/CRC entries in the same envelope, so dtype and
scales survive the handoff bit-exactly. Frames without them decode to a
plain {"k", "v"} pair.

A copy of ``dynamo_tpu.disagg.protocol``. The host-side form of a payload
in this package is a dict of torch CPU tensors (bf16 and fp8 are torch
dtypes, where numpy needs ``ml_dtypes``): the engine's extract returns it,
and the host pool, the relay and the spill files keep it. A frame names
dtypes as the JAX package does (``"bfloat16"``, ``"float8_e4m3fn"``,
``"int8"``, ``"float32"``), so the bytes of a frame are the same whichever
package wrote it, and each package decodes the other's frames.
"""

from __future__ import annotations

import zlib
from typing import Dict

import torch

# the dtypes a KV payload may carry (cache pages of either model dtype or
# quantized kv_dtype, f32 scales), under the names numpy/ml_dtypes give
# them (torch's names are the same)
_DTYPES = {name: getattr(torch, name) for name in (
    "bfloat16", "float8_e4m3fn", "float32", "int8")}
# the integer view each dtype's bytes take on their way through numpy
_UINT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


class KvIntegrityError(ValueError):
    """Wire payload failed its size/dtype/checksum verification."""


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy/ml_dtypes name of a payload dtype (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return str(dtype).split(".", 1)[1]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a payload dtype name; raises
    :class:`KvIntegrityError` for a name no KV payload carries."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise KvIntegrityError(f"unknown KV dtype {name!r}") from None


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a CPU tensor in C order."""
    t = t.contiguous()
    return t.view(_UINT_VIEW[t.element_size()]).numpy().tobytes()


def tensor_from_bytes(buf: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    """A CPU tensor of ``dtype``/``shape`` over a copy of ``buf``."""
    raw = torch.frombuffer(bytearray(buf), dtype=torch.uint8) if buf \
        else torch.empty((0,), dtype=torch.uint8)
    return raw.view(dtype).reshape(tuple(shape))


def kv_to_wire(data: Dict[str, torch.Tensor]) -> dict:
    """{"k","v"[,"ks","vs"]} CPU tensors -> msgpack-safe dict (raw bytes +
    shape + dtype + per-tensor CRC32)."""
    k, v = data["k"], data["v"]
    kb, vb = tensor_bytes(k), tensor_bytes(v)
    wire = {
        "shape": list(k.shape),
        "dtype": dtype_name(k.dtype),
        "k": kb,
        "v": vb,
        "k_crc": zlib.crc32(kb),
        "v_crc": zlib.crc32(vb),
    }
    if "ks" in data:
        ks, vs = data["ks"], data["vs"]
        ksb, vsb = tensor_bytes(ks), tensor_bytes(vs)
        wire.update({
            "scale_shape": list(ks.shape),
            "scale_dtype": dtype_name(ks.dtype),
            "ks": ksb,
            "vs": vsb,
            "ks_crc": zlib.crc32(ksb),
            "vs_crc": zlib.crc32(vsb),
        })
    return wire


def _verify(name: str, buf: bytes, nbytes: int, crc) -> None:
    if len(buf) != nbytes:
        raise KvIntegrityError(
            f"{name} payload is {len(buf)} bytes, expected {nbytes}"
        )
    if crc is not None and zlib.crc32(buf) != int(crc):
        raise KvIntegrityError(f"{name} payload failed its checksum")


def _nbytes(shape, dt: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * dt.itemsize


def kv_from_wire(wire: dict) -> Dict[str, torch.Tensor]:
    """Decode and *verify* a wire frame. Raises :class:`KvIntegrityError`
    on truncation, checksum mismatch, or a dtype/shape that doesn't match
    the byte payload — never returns a partially-valid tensor set.

    Frames without ``k_crc``/``v_crc`` still get the size check; the
    checksum is skipped. Frames with ``ks``/``vs`` (quantized KV) verify
    and return the scale tensors under the same contract.
    """
    shape = tuple(int(d) for d in wire["shape"])
    dt = torch_dtype(wire["dtype"])
    nbytes = _nbytes(shape, dt)
    kb, vb = wire["k"], wire["v"]
    _verify("k", kb, nbytes, wire.get("k_crc"))
    _verify("v", vb, nbytes, wire.get("v_crc"))
    out = {
        "k": tensor_from_bytes(kb, dt, shape),
        "v": tensor_from_bytes(vb, dt, shape),
    }
    if "ks" in wire:
        s_shape = tuple(int(d) for d in wire["scale_shape"])
        s_dt = torch_dtype(wire["scale_dtype"])
        s_nbytes = _nbytes(s_shape, s_dt)
        ksb, vsb = wire["ks"], wire["vs"]
        _verify("ks", ksb, s_nbytes, wire.get("ks_crc"))
        _verify("vs", vsb, s_nbytes, wire.get("vs_crc"))
        out["ks"] = tensor_from_bytes(ksb, s_dt, s_shape)
        out["vs"] = tensor_from_bytes(vsb, s_dt, s_shape)
    return out
