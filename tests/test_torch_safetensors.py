"""The port's own safetensors reader and writer
(``dynamo_tpu_torch/engine/safetensors.py``) held against the
``safetensors`` package, both ways, tensor for tensor: every dtype the port
reads (F32, F16, BF16, I8, U8, F8_E4M3), 0-d and empty tensors,
``__metadata__``, several files, a checkpoint directory; plus the header
layout and the errors on a malformed file."""

import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open as lib_open
from safetensors.numpy import save_file as lib_save
from safetensors.torch import save_file as lib_save_torch

from dynamo_tpu_torch.engine import safetensors as st

DTYPES = {  # format name: (torch dtype, numpy dtype the library writes)
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, ml_dtypes.bfloat16),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "F8_E4M3": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
}
SHAPES = [(3, 5), (), (0, 4), (7,), (2, 3, 4)]


def _numpy(name, shape, seed):
    rng = np.random.default_rng(seed)
    _, np_dt = DTYPES[name]
    if name in ("I8", "U8"):
        info = np.iinfo(np_dt)
        return np.asarray(rng.integers(info.min, info.max + 1, size=shape),
                          dtype=np_dt)
    return np.asarray(np.asarray(rng.standard_normal(shape) * 3.0,
                                 dtype=np.float32), dtype=np_dt)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def load_file(path):
    """Every tensor of a file through the port's reader, as owned copies."""
    with st.SafeFile(path) as f:
        return {name: f.get_tensor(name).clone() for name in f.keys()}


def _tensors(seed=0):
    out = {}
    for i, name in enumerate(DTYPES):
        for j, shape in enumerate(SHAPES):
            out[f"{name.lower()}.{j}"] = _numpy(name, shape, seed + 10 * i + j)
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_library_files_read_by_the_port(tmp_path, dtype):
    arrays = {f"t{j}": _numpy(dtype, shape, j)
              for j, shape in enumerate(SHAPES)}
    path = tmp_path / "lib.safetensors"
    lib_save(arrays, str(path), metadata={"format": "np", "k": "v"})
    with st.SafeFile(path) as f:
        assert f.keys() == sorted(arrays)
        assert f.metadata() == {"format": "np", "k": "v"}
        for name, a in arrays.items():
            t = f.get_tensor(name)
            assert t.dtype == DTYPES[dtype][0]
            assert tuple(t.shape) == a.shape
            assert _bytes(t) == _bytes(a)
            f.release(name)
            assert _bytes(f.get_tensor(name)) == _bytes(a)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_files_read_by_the_library(tmp_path, dtype):
    tensors = {f"t{j}": torch.from_numpy(
        np.ascontiguousarray(_numpy(dtype, shape, j)).view(
            np.uint8 if DTYPES[dtype][0].itemsize == 1 else
            np.uint16 if DTYPES[dtype][0].itemsize == 2 else np.float32)
    ).view(DTYPES[dtype][0]).reshape(shape)
        for j, shape in enumerate(SHAPES)}
    path = tmp_path / "port.safetensors"
    st.save_file(tensors, path, metadata={"format": "pt"})
    with lib_open(str(path), framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
        assert f.metadata() == {"format": "pt"}
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and got.shape == t.shape
            assert _bytes(got) == _bytes(t)


def test_mixed_file_both_ways(tmp_path):
    arrays = _tensors()
    lib_path = tmp_path / "a.safetensors"
    port_path = tmp_path / "b.safetensors"
    lib_save(arrays, str(lib_path))
    loaded = load_file(lib_path)
    assert sorted(loaded) == sorted(arrays)
    for name, a in arrays.items():
        assert _bytes(loaded[name]) == _bytes(a), name
    st.save_file(loaded, port_path)
    with lib_open(str(port_path), framework="pt") as f:
        assert f.metadata() is None
        for name, t in loaded.items():
            assert _bytes(f.get_tensor(name)) == _bytes(t), name
    # the port's file reads back through the port too
    again = load_file(port_path)
    assert all(_bytes(again[n]) == _bytes(t) for n, t in loaded.items())


def test_header_layout_matches_the_library(tmp_path):
    """8-byte little-endian length, JSON padded with spaces to a multiple of
    8, tensors largest element first; the library's own torch writer lays
    out the same tensors at the same offsets."""
    t = {"b": torch.arange(3, dtype=torch.int8),
         "a": torch.ones(2, 2, dtype=torch.bfloat16),
         "c": torch.zeros(5, dtype=torch.float32)}
    port, lib = tmp_path / "p.safetensors", tmp_path / "l.safetensors"
    st.save_file(t, port, metadata={"format": "pt"})
    lib_save_torch(t, str(lib), metadata={"format": "pt"})
    for path in (port, lib):
        raw = path.read_bytes()
        (n,) = struct.unpack("<Q", raw[:8])
        assert n % 8 == 0
        header = json.loads(raw[8:8 + n])
        assert raw[8:8 + n].rstrip(b" ").endswith(b"}")
        offsets = {k: v["data_offsets"] for k, v in header.items()
                   if k != "__metadata__"}
        assert offsets == {"c": [0, 20], "a": [20, 28], "b": [28, 31]}


def test_several_files_make_one_checkpoint(tmp_path):
    """A tensor set split over several files, written by each side, reads
    back whole through the other."""
    arrays = _tensors(seed=5)
    names = sorted(arrays)
    for k in range(3):
        part = {n: arrays[n] for n in names[k::3]}
        lib_save(part, str(tmp_path / f"model-{k:05d}.safetensors"))
    got = {}
    for path in sorted(tmp_path.glob("*.safetensors")):
        got.update(load_file(path))
        st.save_file(load_file(path), tmp_path / f"{path.stem}.port")
    assert sorted(got) == names
    assert all(_bytes(got[n]) == _bytes(arrays[n]) for n in names)
    back = {}
    for path in sorted(tmp_path.glob("*.port")):
        with lib_open(str(path), framework="pt") as f:
            back.update({n: f.get_tensor(n) for n in f.keys()})
    assert all(_bytes(back[n]) == _bytes(arrays[n]) for n in names)


def test_malformed_files_raise(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\x01\x02")
    with pytest.raises(ValueError, match="shorter than 8 bytes"):
        st.SafeFile(bad)
    bad.write_bytes(struct.pack("<Q", 1 << 40) + b"{}")
    with pytest.raises(ValueError, match="header length"):
        st.SafeFile(bad)
    head = json.dumps({"x": {"dtype": "F32", "shape": [4],
                             "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(struct.pack("<Q", len(head)) + head + bytes(8))
    with pytest.raises(ValueError, match="do not fit"):
        st.SafeFile(bad)
    head = json.dumps({"x": {"dtype": "C64", "shape": [1],
                             "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(struct.pack("<Q", len(head)) + head + bytes(8))
    with pytest.raises(ValueError, match="not one of"):
        st.SafeFile(bad)
