"""Ragged paged attention: the CUDA kernels' wrappers and their plain
version.

One contract serves every attention shape the engine runs against the paged
KV cache (the *Ragged Paged Attention* design, PAPERS.md): decode rows
(``q_len == 1``) and prefill chunks (``q_len`` up to the chunk budget), mixed
in one launch. On a card the ragged face runs a tensor-core flash-attention
kernel and the decode face a split-KV kernel whose last split combines
(``csrc/paged_attention.cu`` says why). Queries are packed along a single
flat axis; row ``r`` owns the
slots ``[q_start[r], q_start[r+1])`` and fills the first ``q_len[r]`` of them.
Query ``i`` of row ``r`` sits at absolute position ``ctx_len - q_len + i`` and
sees exactly the keys at positions ``<= that``.

Port of ``dynamo_tpu/ops/paged_attention.py`` (the Pallas kernel
``paged_attention_ragged`` and its decode face ``paged_attention_decode``).
On a CUDA tensor each wrapper launches the hand-written kernel in
``csrc/paged_attention.cu`` (built at first use by :mod:`._build`) or raises;
on a CPU tensor it runs :func:`paged_attention_ragged_plain`, a PyTorch
version of the same contract.

Trash-block contract (physical block 0): the scheduler never allocates block
0 and scatters every padding write into it, so its contents are arbitrary.
Rows with ``q_len == 0`` and key slots at positions ``>= ctx_len`` (partial
last blocks, stale table tails) contribute *exactly zero* and can never
NaN-poison the softmax; a zero softmax denominator divides as 1; every slot of
a row's allotment that holds no valid query comes back as exact zeros.

Launch parameters: ``paged_attention_ragged`` takes ``q_tile`` (query slots
per block, at most ``64 // G``) and ``kv_chunk`` (keys per staged chunk, 64 or
128), ``paged_attention_decode`` takes ``n_split`` (splits of the context, at
most the table's span count); 0 launches the kernel's default, which is what
a call without them launches. ``engine/autotune.py`` sweeps them per shape
class. A value the kernel cannot take raises ``ValueError`` by name before
anything launches (on the CPU too, where the plain version, whose result does
not depend on them, runs).

Quantized KV (``EngineConfig.kv_dtype`` int8/fp8): the pages are int8 or
float8_e4m3fn and ``k_scale``/``v_scale`` ``[num_blocks, KV, bs]`` f32 hold
one scale per (slot, head). Each key is dequantized (page times scale)
BEFORE the trash zeroing, so NaN scales in the trash block are wiped like
NaN pages; the kernel never reads a page byte or a scale past the causal
frontier. Without scales the unquantized kernel runs, as before.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

# launches of the CUDA kernel, per wrapper and, for quantized pages, per kv
# dtype (the plain CPU path never counts). A call made while the stream is
# being captured into a CUDA graph launches nothing: it is recorded in
# _RECORDED instead, and each replay of the graph adds the launches the
# graph holds (count_replay).
LAUNCHES = {"paged_attention_decode": 0, "paged_attention_ragged": 0,
            "paged_attention_decode_int8": 0, "paged_attention_decode_fp8": 0,
            "paged_attention_ragged_int8": 0, "paged_attention_ragged_fp8": 0}
_RECORDED = dict.fromkeys(LAUNCHES, 0)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# quantized page dtypes: (kernel code, LAUNCHES suffix)
_KV_CODES = {torch.int8: (1, "int8"), torch.float8_e4m3fn: (2, "fp8")}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 16  # query heads per KV head the CUDA kernels take
_CHUNK = 64      # keys per staged chunk of the CUDA kernels
_MAX_ROWS = 64   # flat query rows (q slots x G heads) per ragged block
KV_CHUNKS = (64, 128)  # keys per staged chunk the ragged face is built for
# dynamic shared memory one block may opt into on an H100 (sm_90); a card
# reports its own (shared_memory_per_block_optin)
SMEM_OPTIN_SM90 = 232448
# (C entry point, pointer arguments, int arguments) per (face, quantized)
_ENTRY = {
    ("ragged", False): ("dtt_ragged_paged_attention", 8, 10),
    ("ragged", True): ("dtt_ragged_paged_attention_quant", 10, 11),
    ("decode", False): ("dtt_paged_attention_decode", 9, 9),
    ("decode", True): ("dtt_paged_attention_decode_quant", 11, 10),
}
_fns = {}
_sm_counts = {}
_smem_limits = {}
_occupancy = {}
# per device: the decode kernel's arrival counters, one per (row, KV head),
# zero between calls (the last split of each resets its own)
_arrived = {}
# counter buffers that a larger one replaced: a CUDA graph captured over
# one keeps its address, so it must never be freed and reused
_retired = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def take_recorded() -> dict:
    """The launches recorded under capture since the last call (counter
    name -> launches): what one replay of the graph just captured
    launches. Clears the record."""
    held = {name: n for name, n in _RECORDED.items() if n}
    for name in _RECORDED:
        _RECORDED[name] = 0
    return held


def count_replay(held: dict) -> None:
    """One replay of a CUDA graph that holds ``held`` launches (from
    :func:`take_recorded` at its capture) launched them all."""
    for name, n in held.items():
        LAUNCHES[name] += n


def _kernel(face: str, quantized: bool):
    """The C entry point of ``face`` ("ragged" | "decode"); the quantized
    twin takes two scale pointers and a kv-dtype code more."""
    fn = _fns.get((face, quantized))
    if fn is None:
        from . import _build

        name, n_ptr, n_int = _ENTRY[face, quantized]
        fn = getattr(_build.load("paged_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[face, quantized] = fn
    return fn


def _sm_count(device: torch.device) -> int:
    n = _sm_counts.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = n
    return n


def _blocks_per_sm(device, H: int, KV: int, hd: int, dtype_code: int,
                   kv_code: int) -> int:
    """Blocks of the decode kernel one SM holds at once (from the CUDA
    occupancy calculator; a static property of the build and the shape)."""
    key = (device, H // KV, hd, dtype_code, kv_code)
    n = _occupancy.get(key)
    if n is None:
        from . import _build

        lib = _build.load("paged_attention")
        fn = lib.dtt_paged_attention_decode_occupancy
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(H, KV, hd, dtype_code, kv_code, ctypes.addressof(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"decode kernel occupancy query failed: "
                               f"cudaError {err}, {out.value} blocks")
        n = _occupancy[key] = out.value
    return n


def _arrival_counters(device, n: int) -> torch.Tensor:
    buf = _arrived.get(device)
    if buf is None or buf.numel() < n:
        # allocated inside a capture, the buffer would live in the graph's
        # memory pool, where another graph could reuse it (and the kernel
        # needs it zero between calls): warm the largest shape up first
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode kernel arrival counters reallocated during a CUDA "
                f"graph capture ({n} needed): run the largest decode shape "
                "once before capturing")
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _arrived[device] = buf
    return buf


def decode_spans(W: int, bs: int) -> Tuple[int, int]:
    """``(span, n_spans)``: the decode face cuts a table's ``W * bs``
    positions into spans of ``span`` keys, the least common multiple of
    the kernel's 64-key chunk and ``bs`` (whole pages, whole chunks)."""
    span = _CHUNK * bs // math.gcd(_CHUNK, bs)
    return span, -(-(W * bs) // span)


def check_n_split(n_split: int, W: int, bs: int) -> None:
    """Raise by name for a decode split count the kernel cannot take:
    negative, or more splits than the table has spans."""
    _, n_spans = decode_spans(W, bs)
    if n_split < 0 or n_split > n_spans:
        raise ValueError(
            f"n_split {n_split}: the decode face takes 0 (its default) or "
            f"1..{n_spans}, the spans of a {W}-block table of {bs}")


def _decode_grid(B: int, KV: int, W: int, bs: int, n_sm: int,
                 blocks_per_sm: int, n_split: int = 0):
    """``(n_split, span)`` of the decode face's split-KV launch, from
    host-known shapes only (never from ``seq_lens``, so the launch needs no
    host sync and a CUDA graph can capture it).

    Split ``s`` owns the spans ``s, s + n_split, s + 2 n_split, ...`` of
    :func:`decode_spans`, so the ``n_split`` splits cover every position
    once and a short context still spreads over several splits. A
    ``n_split`` given (the autotune's) is taken as it is; the default fills
    the card once: as many splits per (row, KV head) as the ``n_sm *
    blocks_per_sm`` blocks the SMs hold at once allow (at least one, never
    more than the spans), so no block waits for a second wave."""
    check_n_split(n_split, W, bs)
    span, n_spans = decode_spans(W, bs)
    if n_split:
        return n_split, span
    return max(1, min(n_spans, n_sm * blocks_per_sm // max(1, B * KV))), span


def ragged_smem_bytes(hd: int, kv_chunk: int, quantized: bool) -> int:
    """Dynamic shared memory of one block of the ragged face's tensor-core
    kernel (``mma_smem_bytes`` in ``csrc/paged_attention.cu``)."""
    stages = 3 if kv_chunk == 64 else 2
    q_tile = _MAX_ROWS * (hd + 8) * 2
    tile = kv_chunk * (hd + 8) * 2
    raw_stage = 2 * kv_chunk * (hd + 16) + 2 * kv_chunk * 4
    return q_tile + (2 * tile + stages * raw_stage if quantized
                     else 2 * stages * tile)


def ragged_tile(q_tile: int, kv_chunk: int, *, G: int, max_q_len: int,
                hd: int, q_dtype: torch.dtype, quantized: bool,
                smem_optin: int = SMEM_OPTIN_SM90) -> Tuple[int, int]:
    """The ``(q_tile, kv_chunk)`` one ragged launch runs, 0 standing for
    the default (``min(max_q_len, 64 // G)`` query slots; 64 keys for bf16
    pages, 128 for 1-byte pages; the f32 build's fixed 32-key chunks report
    0). Raises ``ValueError`` naming a value the kernel cannot take."""
    max_tile = max(1, _MAX_ROWS // G)
    if q_tile < 0 or q_tile > max_tile:
        raise ValueError(
            f"q_tile {q_tile}: a ragged block holds {_MAX_ROWS} flat rows, "
            f"so at most {max_tile} query slots of {G} heads (0 = default)")
    qt = q_tile or max(1, min(max_q_len, max_tile))
    if q_dtype == torch.float32:
        if kv_chunk:
            raise ValueError(f"kv_chunk {kv_chunk}: the f32 build stages "
                             "32-key chunks and takes only 0")
        return qt, 0
    ch = kv_chunk or (128 if quantized else 64)
    if ch not in KV_CHUNKS:
        raise ValueError(f"kv_chunk {kv_chunk}: the ragged face is built "
                         f"for {KV_CHUNKS} keys per chunk (0 = default)")
    smem = ragged_smem_bytes(hd, ch, quantized)
    if smem > smem_optin:
        raise ValueError(
            f"kv_chunk {ch}: {smem} bytes of shared memory per block, over "
            f"the card's opt-in limit of {smem_optin}")
    return qt, ch


def _check_scales(q, k_cache, k_scale, v_scale) -> None:
    """Scales come as a pair, exactly when the pages are 1-byte."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is None:
        if k_cache.dtype in _KV_CODES:
            raise TypeError(f"{k_cache.dtype} pages need k_scale/v_scale")
        return
    if k_cache.dtype not in _KV_CODES:
        raise TypeError(f"scales given with {k_cache.dtype} pages (only "
                        "int8|float8_e4m3fn pages are quantized)")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
        if t.shape != k_cache.shape[:-1]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(k_cache.shape[:-1])}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_common(q, k_cache, v_cache, block_tables, meta: dict,
                  block_size: int, k_scale, v_scale) -> None:
    """What both faces' kernels require of q, the pages, the table and the
    int32 row metadata ``meta`` (name -> tensor)."""
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, **meta}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} (kernel takes float32|bfloat16)")
    _check_scales(q, k_cache, k_scale, v_scale)
    page_dtype = k_cache.dtype if k_scale is not None else q.dtype
    for name in ("k_cache", "v_cache"):
        if tensors[name].dtype != page_dtype:
            raise TypeError(
                f"{name} dtype {tensors[name].dtype} != {page_dtype}")
    for name in ("block_tables", *meta):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("q [Tq, H, hd] and caches [NB, KV, bs, hd] expected")
    Tq, H, hd = q.shape
    NB, KV, bs, hd_c = k_cache.shape
    if hd_c != hd or bs != block_size or H % KV:
        raise ValueError(
            f"shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)} "
            f"block_size {block_size}"
        )
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (kernel built for {_HEAD_DIMS})")
    if H // KV > _MAX_GROUP:
        raise ValueError(f"{H // KV} query heads per KV head (kernel takes "
                         f"<= {_MAX_GROUP})")
    if block_tables.dim() != 2:
        raise ValueError("block_tables must be [R, W]")
    for name in ("q", "k_cache", "v_cache"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check(q, k_cache, v_cache, block_tables, q_start, q_len, ctx_len,
           block_size: int, max_q_len: int, k_scale=None,
           v_scale=None) -> None:
    """The ragged kernel's requirements."""
    _check_common(q, k_cache, v_cache, block_tables,
                  {"q_start": q_start, "q_len": q_len, "ctx_len": ctx_len},
                  block_size, k_scale, v_scale)
    R = block_tables.shape[0]
    if (q_start.shape != (R + 1,) or q_len.shape != (R,)
            or ctx_len.shape != (R,)):
        raise ValueError("q_start [R+1], q_len [R], ctx_len [R] expected")
    if max_q_len < 1:
        raise ValueError("max_q_len must be >= 1")


def _check_decode(q, k_cache, v_cache, block_tables, seq_lens,
                  block_size: int, k_scale=None, v_scale=None) -> None:
    """The decode kernel's requirements: one query row per table row and
    ``seq_lens`` [B] int32."""
    _check_common(q, k_cache, v_cache, block_tables, {"seq_lens": seq_lens},
                  block_size, k_scale, v_scale)
    B = block_tables.shape[0]
    if q.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError(f"q [{B}, H, hd] and seq_lens [{B}] expected for "
                         f"block_tables of {B} rows, got q "
                         f"{tuple(q.shape)}, seq_lens {tuple(seq_lens.shape)}")


def _call(face: str, counter: str, q, k_cache, ptrs, dims, k_scale,
          v_scale) -> None:
    """Launch ``face``'s C entry point on q's current stream (scales and
    the kv-dtype code appended for 1-byte pages); count it or raise."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if k_scale is None:
            err = _kernel(face, False)(*ptrs, *dims, stream)
        else:
            kv_code, suffix = _KV_CODES[k_cache.dtype]
            counter = f"{counter}_{suffix}"
            err = _kernel(face, True)(*ptrs, k_scale.data_ptr(),
                                      v_scale.data_ptr(), *dims, kv_code,
                                      stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel ({face}) launch failed: "
                           f"cudaError {err}")
    if torch.cuda.is_current_stream_capturing():
        _RECORDED[counter] += 1
    else:
        LAUNCHES[counter] += 1


def _smem_optin(device) -> int:
    n = _smem_limits.get(device)
    if n is None:
        n = _smem_limits[device] = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
    return n


def _launch(q, k_cache, v_cache, block_tables, q_start, q_len, ctx_len,
            block_size: int, max_q_len: int, k_scale=None, v_scale=None,
            q_tile: int = 0, kv_chunk: int = 0) -> torch.Tensor:
    _check(q, k_cache, v_cache, block_tables, q_start, q_len, ctx_len,
           block_size, max_q_len, k_scale, v_scale)
    _, H, hd = q.shape
    KV = k_cache.shape[1]
    q_tile, kv_chunk = ragged_tile(
        q_tile, kv_chunk, G=H // KV, max_q_len=max_q_len, hd=hd,
        q_dtype=q.dtype, quantized=k_scale is not None,
        smem_optin=_smem_optin(q.device))
    out = torch.empty_like(q)
    R, W = block_tables.shape
    if R == 0 or q.shape[0] == 0:
        return out
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
            ctx_len.data_ptr(), out.data_ptr())
    dims = (R, H, KV, hd, block_size, W, max_q_len, q_tile, kv_chunk,
            _DTYPE_CODES[q.dtype])
    _call("ragged", "paged_attention_ragged", q, k_cache, ptrs, dims,
          k_scale, v_scale)
    return out


def _launch_decode(q, k_cache, v_cache, block_tables, seq_lens,
                   block_size: int, k_scale=None, v_scale=None,
                   n_split: int = 0) -> torch.Tensor:
    _check_decode(q, k_cache, v_cache, block_tables, seq_lens, block_size,
                  k_scale, v_scale)
    out = torch.empty_like(q)
    B, W = block_tables.shape
    if B == 0:
        return out
    _, H, hd = q.shape
    KV = k_cache.shape[1]
    G = H // KV
    dtype_code = _DTYPE_CODES[q.dtype]
    kv_code = 0 if k_scale is None else _KV_CODES[k_cache.dtype][0]
    n_split, span = _decode_grid(
        B, KV, W, block_size, _sm_count(q.device),
        _blocks_per_sm(q.device, H, KV, hd, dtype_code, kv_code), n_split)
    # the splits' partials: acc [B, KV, n_split, G, hd], then (m, l)
    n_part = B * KV * n_split * G
    part = torch.empty(n_part * (hd + 2), dtype=torch.float32,
                       device=q.device)
    arrived = _arrival_counters(q.device, B * KV)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part.data_ptr(), part[n_part * hd:].data_ptr(),
            arrived.data_ptr())
    dims = (B, H, KV, hd, block_size, W, n_split, span, dtype_code)
    _call("decode", "paged_attention_decode", q, k_cache, ptrs, dims,
          k_scale, v_scale)
    return out


def paged_attention_ragged(
    q: torch.Tensor,             # [Tq, H, hd] flat packed queries
    k_cache: torch.Tensor,       # [num_blocks, KV, bs, hd] paged cache
    v_cache: torch.Tensor,       # [num_blocks, KV, bs, hd]
    block_tables: torch.Tensor,  # [R, W] int32 (0 = trash block)
    q_start: torch.Tensor,       # [R+1] int32, q_start[R] == Tq
    q_len: torch.Tensor,         # [R] int32 (0 = dead/padding row)
    ctx_len: torch.Tensor,       # [R] int32 context incl. the row's own tokens
    *,
    block_size: int,
    max_q_len: int,
    k_scale: torch.Tensor | None = None,  # [num_blocks, KV, bs] f32
    v_scale: torch.Tensor | None = None,  # [num_blocks, KV, bs] f32
    q_tile: int = 0,
    kv_chunk: int = 0,
) -> torch.Tensor:
    """Ragged paged attention over heterogeneous-length query rows.

    The K/V of every query must already be scattered into the cache (how
    ``engine.model.forward`` orders things). ``max_q_len`` bounds
    ``q_start[r+1] - q_start[r]``. Returns ``[Tq, H, hd]`` in q's dtype.
    ``q_tile``/``kv_chunk`` are the CUDA kernel's launch parameters (the
    counterpart of the Pallas kernel's ``q_tile``/``kv_tile``; see
    :func:`ragged_tile`). ``k_scale``/``v_scale`` go with int8/float8_e4m3fn
    pages (quantized KV) and only with them.
    """
    if q.device.type == "cpu":
        H, KV = q.shape[1], k_cache.shape[1]
        ragged_tile(q_tile, kv_chunk, G=H // KV, max_q_len=max_q_len,
                    hd=q.shape[2], q_dtype=q.dtype,
                    quantized=k_scale is not None)
        return paged_attention_ragged_plain(
            q, k_cache, v_cache, block_tables, q_start, q_len, ctx_len,
            block_size=block_size, max_q_len=max_q_len, k_scale=k_scale,
            v_scale=v_scale,
        )
    return _launch(q, k_cache, v_cache, block_tables, q_start, q_len,
                   ctx_len, block_size, max_q_len, k_scale, v_scale,
                   q_tile, kv_chunk)


def paged_attention_decode(
    q: torch.Tensor,             # [B, H, hd]
    k_cache: torch.Tensor,       # [num_blocks, KV, bs, hd]
    v_cache: torch.Tensor,       # [num_blocks, KV, bs, hd]
    block_tables: torch.Tensor,  # [B, W] int32 (0 = trash block)
    seq_lens: torch.Tensor,      # [B] int32 (0 = padding row)
    *,
    block_size: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    n_split: int = 0,
) -> torch.Tensor:
    """Single-token-per-sequence paged attention. Returns ``[B, H, hd]``.

    The decode face: every row is one query slot. ``seq_lens[b]`` (int32)
    counts the valid context slots for row ``b`` *including* the token
    being decoded; ``seq_lens[b] == 0`` rows emit exact zeros.
    ``k_scale``/``v_scale`` carry quantized-KV scales as in
    :func:`paged_attention_ragged`.

    Split-KV contract on a card: the kernel takes ``seq_lens`` as it is
    (no per-call metadata tensors are built) and launches once: one block
    per (split, KV head, row) over the grid of :func:`_decode_grid`, which
    depends on host-known shapes only (``n_split`` > 0 sets the split count
    instead, up to the table's span count). A split whose first span starts at
    or past ``seq_lens[b]`` exits at once; every other writes its partial
    softmax state (m, l, acc) for the G query heads of its KV head to an
    f32 scratch allocated here. The last live split of each (row, KV head)
    to finish, counted in a persistent per-device buffer that it resets,
    rescales and sums the partials into the output. No key at a position
    ``>= seq_lens[b]`` and no scale past it is read.
    """
    if q.device.type == "cpu":
        check_n_split(n_split, block_tables.shape[1], block_size)
        B = q.shape[0]
        return paged_attention_ragged_plain(
            q, k_cache, v_cache, block_tables,
            torch.arange(B + 1, dtype=torch.int32), (seq_lens > 0).to(
                torch.int32), seq_lens, block_size=block_size, max_q_len=1,
            k_scale=k_scale, v_scale=v_scale,
        )
    return _launch_decode(q, k_cache, v_cache, block_tables, seq_lens,
                          block_size, k_scale, v_scale, n_split)


def paged_attention_ragged_plain(
    q, k_cache, v_cache, block_tables, q_start, q_len, ctx_len, *,
    block_size: int, max_q_len: int, k_scale=None, v_scale=None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract: gather each row's
    context through its table (quantized pages times their scales), zero
    every key at a position >= ctx_len before the dot, mask causally,
    softmax in f32 with a zero denominator dividing as 1. Slots outside
    every allotment come back as zeros.

    Holds a host sync (the longest context bounds the gather), so it serves
    the CPU and the kernel's comparisons, never the main path on a card."""
    _check_scales(q, k_cache, k_scale, v_scale)
    Tq, H, hd = q.shape
    KV, bs = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    R, W = block_tables.shape
    S = max_q_len
    dev = q.device
    out = torch.zeros_like(q)
    if R == 0 or Tq == 0:
        return out
    ctx = ctx_len.long()
    ql = q_len.long()
    # only the blocks the longest context reaches (same result, less memory)
    W = max(1, min(W, -(-int(ctx.max()) // bs)))
    tables = block_tables[:, :W].long()
    K = W * bs

    def gather(cache, scale):  # [R, K, KV, hd] f32; position = w*bs + off
        # 1-byte pages are gathered as their bits: uint8 indexing exists on
        # every backend, float8 indexing not everywhere
        g = (cache.view(torch.uint8)[tables].view(cache.dtype)
             if cache.element_size() == 1 else cache[tables])
        g = g.permute(0, 1, 3, 2, 4).reshape(R, K, KV, hd)
        if scale is None:
            return g.float()
        sc = scale[tables].permute(0, 1, 3, 2).reshape(R, K, KV)
        return g.float() * sc[..., None]

    kpos = torch.arange(K, device=dev)
    kvalid = kpos[None, :] < ctx[:, None]                   # [R, K]
    # zero every key past ctx_len BEFORE the dot (and after the dequant, so
    # NaN trash scales are wiped too): masking scores alone would still let
    # NaN·0 from the trash block leak through p @ v
    k = torch.where(kvalid[:, :, None, None], gather(k_cache, k_scale), 0.0)
    v = torch.where(kvalid[:, :, None, None], gather(v_cache, v_scale), 0.0)

    i = torch.arange(S, device=dev)
    slot = q_start[:R, None].long() + i[None, :]            # [R, S]
    owned = slot < q_start[1:, None].long()
    qr = q[slot.clamp(0, Tq - 1)].float().reshape(R, S, KV, G, hd)
    s = torch.einsum("rskgd,rtkd->rskgt", qr, k) * (1.0 / math.sqrt(hd))
    last = (ctx - ql)[:, None] + i[None, :]                 # [R, S]
    valid = ((i[None, :] < ql[:, None])[:, :, None]
             & (kpos[None, None, :] <= last[:, :, None])
             & kvalid[:, None, :])                          # [R, S, K]
    s = s.masked_fill(~valid[:, :, None, None, :], -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("rskgt,rtkd->rskgd", p, v)
    o = o / torch.where(denom == 0.0, 1.0, denom)
    o = o.reshape(R, S, H, hd).to(q.dtype)
    out[slot[owned]] = o[owned]
    return out
