"""Llama-class transformer in PyTorch with a paged KV cache.

Port of ``dynamo_tpu.engine.model`` (the single-device path, dense and
MoE: a Mixtral-class config routes each layer's FFN through
``parallel/moe.py``). The functions keep their JAX names, layouts and
contracts, so the tests hold each against its JAX counterpart on the same
numpy inputs; inside they are plain PyTorch, with an explicit ``device``,
explicit generators, and in-place updates where the JAX code donates
buffers:

- **One unified step** serves prefill chunks and decode batches:
  ``tokens [B, T]`` with per-sequence block tables. Prefill runs ``B=1``
  with a bucketed ``T``; decode runs ``T=1`` with a bucketed ``B``.
- **Paged KV**: the cache is per-layer ``[num_blocks, KV, block_size, hd]``
  tensors (block-major, head-contiguous); the step scatters the chunk's K/V
  into (block, offset) slots from the block table IN PLACE (the JAX step
  donates the cache), then attends through the ragged paged-attention
  kernel (ops/paged_attention.py) — its decode face for ``T == 1``, its
  ragged face for prefill chunks. Physical block 0 is a trash block:
  padding positions scatter there and the allocator never hands it out.
- **Sampling is fused** into the step (greedy / temperature / top-k / top-p,
  per-request seeds), so only B sampled token ids cross to the host.
- **Decode runs on device-resident control state**: the autopilot window
  reads every seat's position, limits, sampling knobs, table and input token
  from persistent ``ctl`` tensors, which the host updates with packed deltas
  only when membership or tables change.
- **Decode windows replay CUDA graphs** on a card (:class:`AutopilotWindow`,
  from :func:`make_autopilot_fns`): one graph per (decode bucket,
  stochastic), captured once over the eager window and replayed — the
  counterpart of the JAX package's one jitted executable per bucket.
  **Packed prefill chunks** replay theirs too (:class:`PrefillGraphs`):
  one graph per (prefill bucket, stochastic) at the widest table, in the
  same pool (:class:`GraphPool`), for the chunks :func:`prefill_graphed`
  sends there.
- **Speculative decoding** (``spec_mode="ngram"``): the spec window drafts
  from a per-seat token history in ``ctl["hist"]`` (``spec/ngram.py``) and
  verifies ``[B, k+1]`` query rows in one forward through the kernel's
  ragged face; on a card it is captured and replayed like the decode
  window, in the same pool.
- **Tuned launches**: ``forward`` hands the kernel the launch parameters of
  its shape class (``attention_tile_*``, :func:`class_tile`), so a captured
  graph replays the tuned launch (``engine/autotune.py``).
- **Quantized serving** (``engine/quant.py``): matmul weights may be
  ``{"q", "s"}`` leaves (int8/fp8 with per-output-channel f32 scales), and
  with a quantized ``kv_dtype`` the pages are 1-byte with per-(slot, head)
  f32 scales in ``cache["ks"]``/``cache["vs"]``, scattered beside them and
  handed to both kernel faces.
- **Multimodal prefill and embeddings**: ``forward`` splices precomputed
  image embeddings over placeholder rows (``mm_embeds``/``mm_mask``; the
  packed prefill's ``mm`` variant uploads them), and ``encode_forward`` is
  the encode-only step of ``/v1/embeddings`` (dense causal attention over
  the chunk through the plain ``_attention``, mean-pooled, L2-normalised).
- **Tensor and expert parallelism** (``eng.mesh_shape == (1, tp)``, one
  rank per process, ``parallel/``): each rank holds its slice of the tree
  (:func:`shard_params`, the ``SpecLayout`` table) and its KV heads of the
  cache, and ``forward`` is the Megatron form of that layout —
  ``wq``/``wk``/``wv``/``w_gate``/``w_up`` column-sharded and local, ``wo``
  and dense ``w_down`` row-sharded with one ``all_reduce`` (of the f32
  partial products) after each, experts over ``ep`` with one
  ``all_reduce`` after the MoE FFN, and a vocab-sharded embedding lookup
  and head, each ending in one ``all_reduce`` (rows and logit columns a
  rank does not hold are zeros there, so those two sums are exact). Every
  rank then holds the same hidden states and full logits and samples the
  same tokens. Both kernel faces run unchanged at ``H/tp`` query heads and
  ``KV/tp`` KV heads. ``encode_forward`` runs the same split
  (:func:`encode_layer`), the multimodal splice runs unchanged on every
  rank (the leader broadcasts the embeddings), and the KV block ops gather
  the rank's heads and write its slice of a full payload
  (:func:`make_kv_ops`). Every ``all_reduce`` runs over the rank's **tp
  row**: on a ``(dp, tp)`` mesh the ``dp`` replicas hold the same
  parameters and cache and run the same dense step redundantly, as GSPMD
  runs the JAX package's replicated activations. The groups come from the
  engine's mesh (``make_mesh(eng.mesh_shape)``, its ``tp_group``,
  ``dp_group``, ``fsdp_group`` and ``seq_group``), bound when a step
  function is built and handed to ``forward`` and ``logits_fn``: no
  collective reads a group from process state, so two engines on two
  meshes in one process keep their own.
- **Parameter storage over fsdp** (``eng.mesh_shape == (dp, fsdp, tp)``):
  each rank *stores* the JAX table's fsdp slices — ``D / fsdp`` of every
  column leaf's contraction dim, of every row leaf's output dim, of the
  embedding's and of an untied head's model dim — and gathers them whole
  over its **fsdp group** just before use, as ZeRO-3 does: one layer's
  weights before the layer runs (:func:`gather_fsdp`, freed when it
  returns, never cached), the looked-up embedding rows before the tp sum,
  the head before the logits. The gathered weights are the ``(1, tp)``
  mesh's slices, copied exactly, so the Megatron body above runs
  unchanged and an fsdp mesh computes the ``(1, tp)`` mesh's arithmetic
  bit for bit. (The activation form — partial products over D slices
  summed over fsdp — would split every D contraction into f32 partials
  and lose that.) The cost is the gathered bytes, about ``1 - 1/fsdp`` of
  the parameters per step through the fsdp group. MoE expert stacks and
  the router have no fsdp entry. The cache and the hidden states stay
  replicated over dp and fsdp.
- **Sequence-parallel prefill** (``forward(..., sp=True)``, the engine's
  ``sp_prefill_threshold``): a fresh prompt's one chunk of ``T`` tokens is
  split along T over the rank's **seq column** (the ``dp * fsdp`` ranks of
  its tp index, in rank order), Megatron's context parallel times tensor
  parallel. The rank at seq index ``s = d * fsdp + f`` takes the
  contiguous slice ``[s*T/n, (s+1)*T/n)``, ``n = dp * fsdp`` — the union
  of the JAX mesh-major chunks ``s*tp .. s*tp+tp-1`` of
  ``SpecLayout.seq_axes`` — and inside its tp row the tp ranks run the
  column/row split above on that slice (their ``all_reduce`` stays on the
  tp row). Attention is ``parallel/ring_attention.py`` over the seq column
  on the rank's ``H/tp`` heads, from the unquantized K/V as in JAX; the
  cache then takes the whole prompt's K/V of the rank's ``KV/tp`` heads
  by one exact ``all_gather`` over the seq column per K and V (quantized
  there for 1-byte pages) — the port's form of the JAX gather-then-slice
  re-landing. An MoE layer gathers its input rows over the seq column
  too: capacity routing is a function of every row of the chunk in
  order. The function is the JAX package's; the placement differs in one
  respect: activations per rank are O(T/(dp*fsdp)), where the JAX
  composite axis gives O(T/(dp*fsdp*tp)) (ROADMAP.md, item 6.3). With a
  seq column of one rank the sp chunk is the tp forward over the whole
  prompt, with ring attention's f32 einsum in place of the kernel.

Nothing here synchronises with the host except where a docstring says so.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..observability import compilewatch
from ..ops import paged_attention as pa
from ..ops.paged_attention import (
    paged_attention_decode, paged_attention_ragged,
)
from ..parallel import comm
from ..parallel.layout import (
    AXIS_FSDP, Mesh, SpecLayout, make_mesh, map_specs, shard_tensor,
)
from ..parallel.moe import moe_ffn
from ..parallel.ring_attention import ring_attention
from . import quant
from .config import EngineConfig, ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, List[torch.Tensor]]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def tp_size(eng: EngineConfig) -> int:
    """The tensor-parallel degree of the engine's mesh (its last axis)."""
    return int(eng.mesh_shape[-1])


def mesh_ranks(eng: EngineConfig) -> int:
    """The ranks of the engine's world: every rank of its ``(dp, tp)`` or
    ``(dp, fsdp, tp)`` mesh times its pipeline stages (the two are
    exclusive, so one of the factors is 1)."""
    return math.prod(int(n) for n in eng.mesh_shape) * int(eng.pp_stages)


# ------------------------------ init ------------------------------------


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random-init parameters on the generator's device (stacked per-layer
    ``[L, …]`` leaves, as in the JAX tree; MoE expert leaves ``[L, E, …]``
    plus ``w_router [L, D, E]``). The draws differ from ``jax.random``'s
    for the same seed. Expert stacks are drawn one (layer, expert) matrix
    at a time into a leaf made in the model dtype, so no f32 copy of a
    whole stack exists (at Mixtral width one would be ~30 GB)."""
    dt = torch_dtype(cfg)
    dev = generator.device
    hd = cfg.head_dim_
    D, H, KV, F_, L, V = (
        cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
        cfg.intermediate_size, cfg.num_layers, cfg.vocab_size,
    )

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(dt)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def experts(shape, fan_in):
        leaf = torch.empty((L, cfg.num_experts) + shape, device=dev,
                           dtype=dt)
        for li in range(L):
            for e in range(cfg.num_experts):
                leaf[li, e] = norm(shape, fan_in)
        return leaf

    layers: Dict[str, Any] = {
        "attn_norm": ones((L, D)),
        "wq": norm((L, D, H * hd), D),
        "wk": norm((L, D, KV * hd), D),
        "wv": norm((L, D, KV * hd), D),
        "wo": norm((L, H * hd, D), H * hd),
        "mlp_norm": ones((L, D)),
    }
    if cfg.is_moe:
        layers["w_router"] = norm((L, D, cfg.num_experts), D)
        layers["w_gate"] = experts((D, F_), D)
        layers["w_up"] = experts((D, F_), D)
        layers["w_down"] = experts((F_, D), F_)
    else:
        layers["w_gate"] = norm((L, D, F_), D)
        layers["w_up"] = norm((L, D, F_), D)
        layers["w_down"] = norm((L, F_, D), F_)
    params: Params = {
        "embed": norm((V, D), D),
        "layers": layers,
        "final_norm": ones((D,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm((D, V), D)
    return params


def init_cache(cfg: ModelConfig, eng: EngineConfig,
               device: torch.device, num_layers: Optional[int] = None
               ) -> Cache:
    """Paged KV cache, block-major and head-contiguous: per-layer tensors of
    ``[num_blocks, KV, block_size, hd]`` (lists under ``"k"``/``"v"``).
    One (block, head) tile is a contiguous ``bs*hd`` run. Per-layer tensors,
    as in the JAX cache, so each layer's scatter updates its own buffer in
    place. A quantized ``kv_dtype`` stores 1-byte pages plus per-(slot,
    head) f32 scale caches ``[num_blocks, KV, block_size]`` under
    ``"ks"``/``"vs"``; the trash block's zero scales dequantize to zeros."""
    quantized = quant.is_quantized(eng.kv_dtype)
    dt = quant.storage_dtype(eng.kv_dtype) if quantized else torch_dtype(cfg)
    # under tensor parallelism each rank holds its KV heads (cache_block)
    shape = (eng.num_blocks, cfg.num_kv_heads // tp_size(eng),
             eng.block_size, cfg.head_dim_)
    planes = {"k": (shape, dt), "v": (shape, dt)}
    if quantized:
        planes.update(ks=(shape[:-1], torch.float32),
                      vs=(shape[:-1], torch.float32))
    return {
        key: [torch.zeros(shp, dtype=t, device=device)
              for _ in range(cfg.num_layers if num_layers is None
                             else num_layers)]
        for key, (shp, t) in planes.items()
    }


# ---------------------------- shardings ----------------------------------


def shard_model_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The attention shapes one rank of a ``tp``-way mesh runs: its query
    and KV head counts (what autotune times the kernel at)."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def param_specs(cfg: ModelConfig, eng: EngineConfig) -> Dict[str, Any]:
    """The canonical per-leaf spec table of the engine's mesh
    (``parallel/layout.py`` ``SpecLayout``), quantized leaves mirrored."""
    return SpecLayout.for_mesh(eng.mesh_shape).param_specs(
        cfg, eng.weight_dtype)


def shard_params(params: Params, cfg: ModelConfig,
                 eng: EngineConfig) -> Params:
    """This rank's slice of every leaf of a full tree (the counterpart of
    the JAX ``shard_params``' ``device_put``); the full leaves can be freed
    as soon as the caller drops the tree. On an fsdp mesh the slices are
    what the rank *stores*: ``D / fsdp`` of every column and row leaf's
    model dim and of the embedding's (:func:`gather_fsdp` rebuilds a
    layer's ``(1, tp)`` slices just before it runs). A tree already
    sharded (its embedding smaller than ``[V, D]``, as
    ``weights.load_hf_params_sharded`` gives it) is kept, and so is any
    tree of a mesh that shards no parameter (``tp`` and ``fsdp`` 1). On
    a mesh of more than one rank it makes the mesh first (``make_mesh``,
    which creates its groups on every rank alike)."""
    mesh = make_mesh(eng.mesh_shape)
    if (mesh.shape["tp"] * mesh.shape.get("fsdp", 1) == 1
            or tuple(params["embed"].shape)
            != (cfg.vocab_size, cfg.hidden_size)):
        return params
    return map_specs(lambda t, sp: shard_tensor(t, sp, mesh), params,
                     param_specs(cfg, eng))


# ----------------------------- modules -----------------------------------


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def _rope_tables(positions: torch.Tensor, theta: float,
                 hd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[B, T, 1, hd/2]`` in f32 for :func:`_apply_rope`. The
    JAX code recomputes them inside every rope call and XLA folds the
    repeats; eager PyTorch would launch them twice per layer, so
    ``forward`` builds them once per step."""
    half = hd // 2
    freqs = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    ))
    pos = torch.clamp(positions, min=0).float()             # [B, T]
    angles = pos[..., None] * freqs                         # [B, T, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """HF-convention rotary embedding (rotate-half). x: [B, T, Hx, hd]."""
    return _apply_rope(x, *_rope_tables(positions, theta, x.shape[-1]))


def _mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Matmul against a possibly-quantized weight leaf. A quantized
    ``{"q", "s"}`` leaf multiplies by the 1-byte weight cast to x's dtype
    (exact for int8 and e4m3) and scales the product per output channel in
    f32, as the JAX ``_mm`` does. Eager PyTorch writes the cast copy of the
    weight to device memory on every call, where XLA fuses the cast into
    the matmul feed; a GEMM that reads the 1-byte weight is later work."""
    if isinstance(w, dict):
        y = x @ w["q"].to(x.dtype)
        return (y.float() * w["s"][0]).to(x.dtype)
    return x @ w


def _row_mm(x: torch.Tensor, w: Any, tpg: comm.Group) -> torch.Tensor:
    """A row-parallel matmul (``wo``, dense ``w_down``) under tensor
    parallelism: this rank's partial product over its rows of ``w``, in
    f32, summed over the tp row ``tpg`` by one ``all_reduce``, then cast to x's
    dtype once (as the one-rank ``_mm`` casts its f32-accumulated
    product)."""
    if isinstance(w, dict):
        y = (x @ w["q"].to(x.dtype)).float() * w["s"][0]
    else:
        y = _head_mm(x, w)
    return comm.all_reduce(y, tpg).to(x.dtype)


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                  vocab_size: int, tpg: comm.Group,
                  fsg: comm.Group = comm.SOLO) -> torch.Tensor:
    """Token embeddings from a (possibly vocab-sharded) table: a rank
    holding rows ``[lo, lo + rows)`` of the vocabulary looks up the tokens
    in its range, writes zeros for the rest, and one ``all_reduce`` over
    the tp row ``tpg`` sums the ranks' rows — exact, as each element has
    one nonzero term. A table stored over fsdp (``D / fsdp`` columns)
    looks up its columns of the rows, and one exact ``all_gather`` over
    the fsdp group ``fsg`` joins them before the tp sum."""
    rows = embed.shape[0]
    if rows == vocab_size:
        return _gather(embed[tokens.long()], fsg, -1)
    local = tokens.long() - tpg.index * rows
    inside = (local >= 0) & (local < rows)
    h = _gather(embed[torch.where(inside, local, 0)], fsg, -1)
    return comm.all_reduce(torch.where(inside[..., None], h, 0.0), tpg)


def _gather(t: torch.Tensor, fsg: comm.Group, dim: int) -> torch.Tensor:
    """The fsdp group's slices of ``t`` joined along ``dim`` (an exact
    copy, counted as ``fsdp_gather``; 1-byte weights travel as bytes:
    gloo has no float8)."""
    if fsg.size == 1:
        return t
    if t.element_size() == 1:
        return comm.all_gather(t.view(torch.uint8), fsg, dim,
                               op="fsdp_gather").view(t.dtype)
    return comm.all_gather(t, fsg, dim, op="fsdp_gather")


def gather_fsdp(tree: Any, specs: Any, fsg: comm.Group) -> Any:
    """``tree`` (parameters as the rank stores them: a layer's slice, the
    embedding, the head) with every leaf whose spec carries ``fsdp`` joined
    over the fsdp group ``fsg`` on that dim, the ZeRO-3 gather. ``specs``
    is the matching part of :func:`param_specs` (a stacked layer spec fits
    the layer's slice too: the dim is counted from the end), so the one
    table that shards the parameters also says what to gather: column
    leaves on -2, row leaves and their scales on -1, the embedding on -1,
    an untied head on -2; norms, MoE expert stacks, the router and a column
    leaf's scale have no fsdp entry and pass unchanged, as does everything
    on a group of one. The result is the ``(1, tp)`` mesh's slices, exact
    copies, so the Megatron body runs the ``(1, tp)`` mesh's arithmetic
    bit for bit; it lives only while its caller runs (never cached: that
    would undo fsdp)."""
    if fsg.size == 1:
        return tree

    def one(t: torch.Tensor, sp) -> torch.Tensor:
        if AXIS_FSDP not in sp:
            return t
        return _gather(t, fsg, sp.index(AXIS_FSDP) - len(sp))

    return map_specs(one, tree, specs)


def _layer_slice(stacked: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Per-layer view of the stacked param tree (a view, not a copy);
    quantized ``{"q", "s"}`` leaves slice both members."""
    return {
        name: ({k: v[li] for k, v in w.items()} if isinstance(w, dict)
               else w[li])
        for name, w in stacked.items()
    }


def _dequant_leaf(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """A whole weight leaf in ``dtype``, for consumers that need a plain
    tensor (the MoE expert stacks). A quantized leaf makes a transient
    full-precision copy of the stack each call, as the JAX code does."""
    if isinstance(w, dict):
        return (w["q"].float() * w["s"]).to(dtype)
    return w


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte page cache as its uint8 bits, for indexing and scatter
    (uint8 indexing exists on every backend, float8 indexing not
    everywhere)."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


_Q_BLOCK = 512  # query-block size for long prefill chunks: caps the f32
                # score tensor at [B, _Q_BLOCK, H, S]


def _attention(
    q: torch.Tensor,        # [B, T, H, hd]
    k_all: torch.Tensor,    # [B, S, KV, hd]  gathered sequence KV
    v_all: torch.Tensor,    # [B, S, KV, hd]
    positions: torch.Tensor,  # [B, T] absolute positions (-1 = pad)
) -> torch.Tensor:
    """The plain gathered-context attention (the ``einsum`` impl)."""
    T = q.shape[1]
    if T > _Q_BLOCK:
        outs = [
            _attention(q[:, t0:t0 + _Q_BLOCK], k_all, v_all,
                       positions[:, t0:t0 + _Q_BLOCK])
            for t0 in range(0, T, _Q_BLOCK)
        ]
        return torch.cat(outs, dim=1)
    B, T, H, hd = q.shape
    S, KV = k_all.shape[1], k_all.shape[2]
    G = H // KV
    scores = torch.einsum(
        "btkgh,bskh->btkgs", q.reshape(B, T, KV, G, hd).float(),
        k_all.float(),
    ) / math.sqrt(hd)
    # causal paged mask: key slot s corresponds to absolute position s
    kpos = torch.arange(S, device=q.device)[None, None, :]   # [1, 1, S]
    valid = kpos <= positions[:, :, None]                    # [B, T, S]
    scores = torch.where(valid[:, :, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "btkgs,bskh->btkgh", probs.to(q.dtype).float(), v_all.float(),
    )
    return out.reshape(B, T, H, hd).to(q.dtype)


def attention_class(eng: EngineConfig, T: int) -> str:
    """Shape class of a ``[B, T]`` chunk: decode / spec / prefill. T is a
    static shape of the step, so the class (and the impl picked from it) is
    fixed per captured graph."""
    if T == 1:
        return "decode"
    if eng.spec_mode != "off" and T <= eng.spec_k + 1:
        return "spec"
    return "prefill"


def resolve_attention_impl(eng: EngineConfig, attn_class: str) -> str:
    """The attention impl ("kernel" | "einsum") of a shape class: its
    per-class override when set (``engine/autotune.py`` sets all three for
    ``attention_impl="auto"``), else ``attention_impl`` — "kernel" by
    default for every class (on a card the CUDA kernel, on the CPU its
    plain version). An "auto" no probe has resolved is einsum, as the JAX
    package's is."""
    override = getattr(eng, f"attention_impl_{attn_class}", "")
    if override:
        return override
    return "einsum" if eng.attention_impl == "auto" else eng.attention_impl


def class_tile(eng: EngineConfig, attn_class: str, T: int,
               W: int) -> Tuple[int, int]:
    """The kernel launch parameters a shape class's tile gives a ``[B, T]``
    step over a ``W``-block table: ``(q_tile, kv_chunk)`` for the ragged
    classes, ``(0, n_split)`` for decode (``engine/config.py``).

    Tuned tiles are advisory, as the JAX package's ``_class_tile`` makes
    them: a q_tile that does not divide this step's T (a winner picked at
    the largest prefill bucket against a shorter chunk), or an n_split over
    this table's span count, falls back to the kernel's default (0). What
    the kernel cannot take at any shape still raises in the wrapper."""
    q_tile, second = getattr(eng, f"attention_tile_{attn_class}", (0, 0))
    if attn_class == "decode":
        return 0, (second if second <= pa.decode_spans(
            W, eng.block_size)[1] else 0)
    if q_tile > 0 and T % q_tile:
        q_tile = 0
    return q_tile, second


@dataclasses.dataclass
class ChunkPlan:
    """What every layer of one step over a ``[B, T]`` chunk shares: the
    shapes (``H``/``KV`` are this rank's heads, ``Tl`` its rows of an sp
    chunk, ``mine`` their slice), the cache scatter indices (pad
    positions go to the trash block 0), the rope tables of the rank's
    rows, the attention route and the kernel's ragged metadata, and the
    rank's tp row, its seq column (the ranks that split an sp chunk: dp
    times fsdp of them; one rank off the sp path) and its fsdp group with
    the layer specs that say what it gathers.
    Built once per step by
    :func:`chunk_plan`; :func:`layer_forward` reads it."""

    B: int
    T: int
    Tl: int
    W: int
    H: int
    KV: int
    tp: int
    mine: slice
    positions: torch.Tensor       # [B, T] int64, -1 = pad
    block_tables: torch.Tensor    # [B, W] int32
    scatter_idx: Tuple[torch.Tensor, ...]
    cos: torch.Tensor
    sin: torch.Tensor
    sp: bool
    use_kernel: bool
    tpg: Any
    seqg: Any
    fsg: Any
    specs: Any = None             # the layer specs, on an fsdp mesh
    q_tile: int = 0
    kv_arg: int = 0
    seq_lens: Optional[torch.Tensor] = None
    q_len: Optional[torch.Tensor] = None
    ctx_len: Optional[torch.Tensor] = None
    q_start: Optional[torch.Tensor] = None


def chunk_plan(cfg: ModelConfig, eng: EngineConfig, positions: torch.Tensor,
               block_tables: torch.Tensor, sp: bool, mesh: Mesh) -> ChunkPlan:
    """The :class:`ChunkPlan` of a chunk (``positions`` int64, the tables
    int32 and contiguous, as ``forward`` hands them)."""
    B, T = positions.shape
    W = block_tables.shape[1]
    bs = eng.block_size
    tp = tp_size(eng)
    KV = cfg.num_kv_heads // tp                  # this rank's KV heads
    dev = positions.device
    tpg = mesh.tp_group
    seqg = mesh.seq_group if sp else comm.SOLO
    if T % seqg.size:
        raise ValueError(f"an sp chunk of T={T} does not split over "
                         f"dp*fsdp={seqg.size}")
    Tl = T // seqg.size                     # this rank's rows of the chunk
    mine = slice(seqg.index * Tl, (seqg.index + 1) * Tl)

    # physical (block, offset) per (b, t); pads go to the trash block 0
    pos_safe = torch.clamp(positions, min=0)
    logical_block = pos_safe // bs                         # [B, T]
    phys_block = torch.gather(
        block_tables.long(), 1, torch.clamp(logical_block, max=W - 1)
    )                                                      # [B, T]
    live = positions >= 0
    scatter_block = torch.where(live, phys_block, 0).reshape(-1)
    scatter_off = torch.where(live, pos_safe % bs, 0).reshape(-1)
    scatter_idx = (scatter_block[:, None],
                   torch.arange(KV, device=dev)[None, :],
                   scatter_off[:, None])                   # -> [B*T, KV]

    cos, sin = _rope_tables(positions[:, mine], cfg.rope_theta,
                            cfg.head_dim_)
    attn_class = attention_class(eng, T)
    use_kernel = not sp and resolve_attention_impl(eng, attn_class) == "kernel"
    c = ChunkPlan(B=B, T=T, Tl=Tl, W=W, H=cfg.num_heads // tp, KV=KV, tp=tp,
                  mine=mine, positions=positions, block_tables=block_tables,
                  scatter_idx=scatter_idx, cos=cos, sin=sin, sp=sp,
                  use_kernel=use_kernel, tpg=tpg, seqg=seqg,
                  fsg=mesh.fsdp_group)
    if c.fsg.size > 1:
        c.specs = param_specs(cfg, eng)["layers"]
    if use_kernel:
        c.q_tile, c.kv_arg = class_tile(eng, attn_class, T, W)
        if T == 1:
            c.seq_lens = torch.clamp(positions[:, 0] + 1, min=0).to(
                torch.int32)
        else:
            c.q_len = live.sum(dim=1).to(torch.int32)
            c.ctx_len = torch.clamp(positions.max(dim=1).values + 1,
                                    min=0).to(torch.int32)
            c.q_start = torch.arange(B + 1, dtype=torch.int32,
                                     device=dev) * T
    return c


def _ffn(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
         tpg: comm.Group) -> torch.Tensor:
    """A layer's dense or MoE FFN over the normed ``x [B, T, D]``, in
    ``x``'s dtype. Under tp (``tpg`` of more than one member) the dense
    ``w_down`` is row-parallel (one ``all_reduce``), and each rank runs
    its experts (ep rides tp) and one ``all_reduce`` sums their f32
    partial outputs. :func:`layer_forward` and :func:`encode_layer` both
    run it."""
    tp = tpg.size
    if cfg.is_moe:
        B, T, D = x.shape
        out = moe_ffn(
            x.reshape(B * T, D),
            p["w_router"],
            _dequant_leaf(p["w_gate"], x.dtype),
            _dequant_leaf(p["w_up"], x.dtype),
            _dequant_leaf(p["w_down"], x.dtype),
            top_k=cfg.num_experts_per_token,
            capacity_factor=cfg.moe_capacity_factor,
            expert_offset=None if tp == 1 else tpg.index * (
                cfg.num_experts // tp),
        )
        if tp > 1:
            out = comm.all_reduce(out, tpg).to(x.dtype)
        return out.reshape(B, T, D)
    gate = F.silu(_mm(x, p["w_gate"]).float())
    up = _mm(x, p["w_up"]).float()
    act = (gate * up).to(x.dtype)
    return (_mm(act, p["w_down"]) if tp == 1
            else _row_mm(act, p["w_down"], tpg))


def layer_forward(cfg: ModelConfig, eng: EngineConfig, p: Dict[str, Any],
                  cache: Cache, li: int, h: torch.Tensor,
                  c: ChunkPlan) -> torch.Tensor:
    """One transformer layer over the chunk's hidden states ``h [B, Tl,
    D]``: its K/V scattered into ``cache`` layer ``li`` in place, attention
    by the route of ``c`` (the kernel's decode or ragged face, the ring
    for an sp chunk, or the gathered-context einsum), then the dense or
    MoE FFN. ``p`` is the layer's slice of the stacked tree as the rank
    stores it; on an fsdp mesh its slices are gathered first
    (:func:`gather_fsdp`) and freed when the layer returns. ``forward``
    runs every layer through here, and so does a pipeline stage its own
    (``parallel/pp_serving.py``)."""
    B, T, Tl, W, H, KV, tp = c.B, c.T, c.Tl, c.W, c.H, c.KV, c.tp
    bs = eng.block_size
    hd = cfg.head_dim_
    tpg, seqg = c.tpg, c.seqg
    p = gather_fsdp(p, c.specs, c.fsg)
    kv_quant = quant.is_quantized(eng.kv_dtype)
    scatter_idx = c.scatter_idx
    block_tables, positions = c.block_tables, c.positions
    lk, lv = cache["k"][li], cache["v"][li]               # [NB, KV, bs, hd]
    # [NB, KV, bs] f32 per-(slot, head) scales of quantized pages
    lks = cache["ks"][li] if kv_quant else None
    lvs = cache["vs"][li] if kv_quant else None

    x = _rms_norm(h, p["attn_norm"], cfg.rms_norm_eps)
    q = _mm(x, p["wq"]).reshape(B, Tl, H, hd)
    k = _mm(x, p["wk"]).reshape(B, Tl, KV, hd)
    v = _mm(x, p["wv"]).reshape(B, Tl, KV, hd)
    q = _apply_rope(q, c.cos, c.sin)
    k = _apply_rope(k, c.cos, c.sin)

    # scatter this chunk's K/V into the paged cache, in place (the JAX
    # step donates the cache and scatter-updates it); an sp rank first
    # gathers its seq column's slices of its heads (exact copies)
    k_upd = comm.all_gather(k, seqg, dim=1).reshape(B * T, KV, hd)
    v_upd = comm.all_gather(v, seqg, dim=1).reshape(B * T, KV, hd)
    if kv_quant:
        # per-(token, head) scales: a token's bytes depend only on its
        # own K/V, never on the block it lands in
        k_upd, k_sc = quant.kv_quantize(k_upd, eng.kv_dtype)
        v_upd, v_sc = quant.kv_quantize(v_upd, eng.kv_dtype)
        lks.index_put_(scatter_idx, k_sc)
        lvs.index_put_(scatter_idx, v_sc)
    _bits(lk).index_put_(scatter_idx, _bits(k_upd))
    _bits(lv).index_put_(scatter_idx, _bits(v_upd))

    if c.sp:
        attn = ring_attention(q, k, v, seqg)
    elif c.use_kernel and T == 1:
        attn = paged_attention_decode(
            q[:, 0].contiguous(), lk, lv, block_tables, c.seq_lens,
            block_size=bs, k_scale=lks, v_scale=lvs, n_split=c.kv_arg,
        )[:, None]
    elif c.use_kernel:
        attn = paged_attention_ragged(
            q.reshape(B * T, H, hd).contiguous(), lk, lv, block_tables,
            c.q_start, c.q_len, c.ctx_len, block_size=bs, max_q_len=T,
            k_scale=lks, v_scale=lvs, q_tile=c.q_tile, kv_chunk=c.kv_arg,
        ).reshape(B, T, H, hd)
    else:
        # gather the full context: [B, W*bs, KV, hd] with gathered
        # position = w*bs + offset = absolute position
        tbl = block_tables.long().reshape(-1)
        k_all = _bits(lk)[tbl].view(lk.dtype).reshape(
            B, W, KV, bs, hd).permute(0, 1, 3, 2, 4).reshape(
            B, W * bs, KV, hd)
        v_all = _bits(lv)[tbl].view(lv.dtype).reshape(
            B, W, KV, bs, hd).permute(0, 1, 3, 2, 4).reshape(
            B, W * bs, KV, hd)
        if kv_quant:
            ks_all = lks[tbl].reshape(B, W, KV, bs).permute(
                0, 1, 3, 2).reshape(B, W * bs, KV)
            vs_all = lvs[tbl].reshape(B, W, KV, bs).permute(
                0, 1, 3, 2).reshape(B, W * bs, KV)
            k_all = quant.kv_dequantize(k_all, ks_all, q.dtype)
            v_all = quant.kv_dequantize(v_all, vs_all, q.dtype)
        attn = _attention(q, k_all, v_all, positions)
    attn = attn.reshape(B, Tl, H * hd)
    h = h + (_mm(attn, p["wo"]) if tp == 1
             else _row_mm(attn, p["wo"], tpg))

    x = _rms_norm(h, p["mlp_norm"], cfg.rms_norm_eps)
    if cfg.is_moe:
        # every row of the chunk is routed, padding included, in the
        # reference's order: capacity slots go to rows in [B*T] order. An
        # sp rank routes the whole chunk (gathered over its seq column),
        # then keeps its rows: capacity slots depend on every row before
        # its own
        h = h + _ffn(cfg, p, comm.all_gather(x, seqg, dim=1),
                     tpg)[:, c.mine]
    else:
        h = h + _ffn(cfg, p, x, tpg)
    return h


def forward(
    cfg: ModelConfig,
    eng: EngineConfig,
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,        # [B, T] int (0 = pad)
    positions: torch.Tensor,     # [B, T] int absolute, -1 = pad
    block_tables: torch.Tensor,  # [B, W] int physical block ids (0 = trash)
    mm_embeds: Optional[torch.Tensor] = None,  # [B, T, D] vision embeddings
    mm_mask: Optional[torch.Tensor] = None,    # [B, T] True = use mm_embeds
    sp: bool = False,
    mesh: Optional[Mesh] = None,
) -> Tuple[Cache, torch.Tensor]:
    """Run the transformer over a token chunk, updating the paged cache IN
    PLACE (the returned cache is the same dict and tensors). ``mesh``
    carries the rank's groups (default ``make_mesh(eng.mesh_shape)``; the
    step builders bind it once).

    With ``sp`` the chunk MUST be a full fresh prompt (start 0) whose T the
    seq column (``dp * fsdp`` ranks) divides: this rank runs its slice of
    T (module docstring), attention is the exact ring over the seq column,
    and every rank's cache takes the whole prompt's K/V of its heads. The
    returned hidden states are then this rank's slice ``[B, T/(dp*fsdp),
    D]``. Pad tails are safe: the ring masks by absolute chunk index, so
    pad keys (index above every real query) never reach a real row, and
    pad rows scatter to the trash block.

    Valid tokens of each row are a prefix of it (the prefill/decode feed
    contract), so the kernel's ragged metadata is a count and a max.
    ``mm_embeds``/``mm_mask`` (multimodal prefill chunks only; the decode
    and spec graphs are captured without them) put the encode worker's
    embeddings, cast to the model dtype, in place of the placeholder rows'
    token embeddings before the first layer.
    Returns (cache, hidden states [B, T, D]).
    """
    positions = positions.long()
    block_tables = block_tables.to(torch.int32).contiguous()
    mesh = make_mesh(eng.mesh_shape) if mesh is None else mesh
    c = chunk_plan(cfg, eng, positions, block_tables, sp, mesh)
    # an fsdp group joins its members' columns of the SAME rows, and on an
    # sp chunk its members may hold different rows (the seq column spans
    # fsdp): there every rank looks up the whole chunk, then keeps its own
    whole = c.fsg.size > 1 and c.seqg.size > 1
    h = _embed_lookup(params["embed"], tokens if whole else tokens[:, c.mine],
                      cfg.vocab_size, c.tpg, c.fsg)
    if whole:
        h = h[:, c.mine]                                   # [B, Tl, D]
    if mm_embeds is not None:
        # multimodal EPD: placeholder positions take the encode worker's
        # precomputed embeddings instead of token embeddings (ref: the
        # TRT-LLM EPD flow, request_handlers/handler_base.py:64-234)
        h = torch.where(mm_mask.bool()[..., None], mm_embeds.to(h.dtype), h)
    stacked = params["layers"]
    for li in range(cfg.num_layers):
        h = layer_forward(cfg, eng, _layer_slice(stacked, li), cache, li, h,
                          c)
    h = _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return cache, h


def logits_fn(cfg: ModelConfig, params: Params, h: torch.Tensor,
              mesh: Optional[Mesh] = None,
              specs: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Float32 logits ``[..., V]``. A bf16 head on the card multiplies in
    bf16 with an f32 result (casting the [D, V] head to f32 would write
    ~1 GB per step for a 1B model). A quantized untied head multiplies by
    its 1-byte weight cast to h's dtype, then by its per-column f32
    scale.

    A vocab-sharded head (tensor parallelism: fewer columns than the
    vocabulary) writes this rank's columns into zeroed full logits and one
    ``all_reduce`` over ``mesh``'s tp row fills in the others' — exact, so
    every rank samples the same tokens from the same logits. A head
    stored over fsdp (``D / fsdp`` of its model dim) is gathered over
    ``mesh``'s fsdp group first, as ``specs`` (:func:`param_specs`) says,
    and freed after the product. Both need ``mesh``."""
    fsg = comm.SOLO if mesh is None else mesh.fsdp_group
    name = "embed" if cfg.tie_word_embeddings else "lm_head"
    head = gather_fsdp(params[name], None if specs is None else specs[name],
                       fsg)
    if cfg.tie_word_embeddings:
        head = head.T
    if isinstance(head, dict):
        y = _head_mm(h, head["q"].to(h.dtype)) * head["s"][0]
    else:
        y = _head_mm(h, head)
    cols = y.shape[-1]
    if cols == cfg.vocab_size:
        return y
    if mesh is None:
        raise ValueError(f"a vocab-sharded head ({cols} of "
                         f"{cfg.vocab_size} columns) needs the mesh")
    full = torch.zeros(y.shape[:-1] + (cfg.vocab_size,), dtype=y.dtype,
                       device=y.device)
    lo = mesh.tp_group.index * cols
    full[..., lo:lo + cols] = y
    return comm.all_reduce(full, mesh.tp_group)


def _head_mm(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``h @ head`` with an f32 result."""
    if h.dtype == torch.float32 and head.dtype == torch.float32:
        return h @ head
    if h.is_cuda:
        flat = h.reshape(-1, h.shape[-1])
        y = torch.mm(flat, head.to(h.dtype), out_dtype=torch.float32)
        return y.reshape(*h.shape[:-1], y.shape[-1])
    return h.float() @ head.float()


# --------------------------- encode (embeddings) --------------------------


def encode_layer(cfg: ModelConfig, p: Dict[str, Any], h: torch.Tensor,
                 positions: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, tpg: comm.Group) -> torch.Tensor:
    """One layer of the encode-only forward over ``h [B, T, D]``: dense
    causal attention over the chunk through the plain :func:`_attention`
    (no paged cache), then the dense or MoE FFN. On a tp rank (``tpg`` of
    more than one member) it runs the rank's ``H/tp`` and ``KV/tp`` heads,
    ``wo`` row-parallel (one ``all_reduce``) and the group-aware
    :func:`_ffn`, as :func:`layer_forward` does, so every rank holds the
    same ``h``. ``p`` is the layer's ``(1, tp)`` slice (on an fsdp mesh
    :func:`encode_forward` gathers it first).
    :func:`encode_forward` runs every layer through here, and so does a
    pipeline stage its own (``parallel/pp_serving.py``)."""
    B, T, _ = h.shape
    hd = cfg.head_dim_
    tp = tpg.size
    H, KV = cfg.num_heads // tp, cfg.num_kv_heads // tp
    x = _rms_norm(h, p["attn_norm"], cfg.rms_norm_eps)
    q = _apply_rope(_mm(x, p["wq"]).reshape(B, T, H, hd), cos, sin)
    k = _apply_rope(_mm(x, p["wk"]).reshape(B, T, KV, hd), cos, sin)
    v = _mm(x, p["wv"]).reshape(B, T, KV, hd)
    attn = _attention(q, k, v, positions).reshape(B, T, H * hd)
    h = h + (_mm(attn, p["wo"]) if tp == 1
             else _row_mm(attn, p["wo"], tpg))
    x = _rms_norm(h, p["mlp_norm"], cfg.rms_norm_eps)
    return h + _ffn(cfg, p, x, tpg)


def encode_pool(cfg: ModelConfig, params: Params, h: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """The encode step's head: the final norm, then L2-normalised mean-
    pooled hidden states ``[B, D]`` in f32 (the mean over positions >= 0,
    divided by ``max(count, 1)``; the norm floored at 1e-12)."""
    h = _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    valid = (positions >= 0).float()[:, :, None]          # [B, T, 1]
    pooled = (h.float() * valid).sum(dim=1) / torch.clamp(
        valid.sum(dim=1), min=1.0)                         # [B, D]
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)


def encode_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,      # [B, T] int (0 = pad)
    positions: torch.Tensor,   # [B, T] int, -1 = pad
    mesh: Optional[Mesh] = None,
    specs: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Encode-only forward: dense causal attention over the chunk through
    the plain :func:`_attention`, no paged cache — the engine step for
    ``/v1/embeddings`` (ref: the embeddings route in
    lib/llm/src/http/service/openai.rs:714; the decoder itself encodes).

    Returns L2-normalised mean-pooled final hidden states ``[B, D]`` in f32
    (:func:`encode_pool`). Pad rows attend to nothing valid: their softmax
    is uniform over masked scores, finite, and pooled out.

    On a tp or fsdp rank (``mesh`` with a tp row or fsdp group of more
    than one rank, params this rank's shard) the lookup is the sharded
    one and each layer the group-aware :func:`encode_layer`, its slices
    gathered over fsdp first as ``specs`` (:func:`param_specs`) says; the
    pooled result is the same on every rank, as the JAX
    ``make_encode_fn``'s on a mesh is replicated.
    """
    tpg = comm.SOLO if mesh is None else mesh.tp_group
    fsg = comm.SOLO if mesh is None else mesh.fsdp_group
    positions = positions.long()
    h = _embed_lookup(params["embed"], tokens, cfg.vocab_size,
                      tpg, fsg)                            # [B, T, D]
    cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim_)
    stacked = params["layers"]
    lspecs = None if specs is None else specs["layers"]
    for li in range(cfg.num_layers):
        p = gather_fsdp(_layer_slice(stacked, li), lspecs, fsg)
        h = encode_layer(cfg, p, h, positions, cos, sin, tpg)
        del p
    return encode_pool(cfg, params, h, positions)


def make_encode_fn(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                   specs: Optional[Dict[str, Any]] = None):
    """The encode step: ``(params, tokens[B,T], positions[B,T]) -> [B, D]``,
    run eagerly without autograd (the JAX package jits one program per
    (B, T) bucket; eager PyTorch makes no program to count). ``mesh``
    binds a tp rank's groups, as ``forward`` binds them, and ``specs``
    (:func:`param_specs`) what an fsdp rank gathers."""

    def encode(params, tokens, positions):
        with torch.inference_mode():
            return encode_forward(cfg, params, tokens, positions, mesh,
                                  specs)

    return encode


# ----------------------------- sampling ----------------------------------


MAX_TOP_K = 64  # top-k above this is clamped; the top-p nucleus is found
                # among these candidates (a >64-token nucleus clamps to 64)

_U32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A counter-based 32-bit mix (lowbias32) over int64 tensors holding
    uint32 values; products wrap and are masked back to 32 bits."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def _row_keys(step_key: torch.Tensor, seeds: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Per-row keys. Seeded rows (seed >= 0) key on (seed, position) —
    deterministic across runs, engine restarts and batch composition.
    Unseeded rows (-1) key on the engine's step key and their row index."""
    B = seeds.shape[0]
    seeds = seeds.long()
    seeded = _hash32(
        _hash32(torch.clamp(seeds, min=0))
        ^ _hash32(torch.clamp(positions.long(), min=0) + 0x9E3779B9)
    )
    rows = torch.arange(B, device=seeds.device)
    anon = _hash32(step_key.long() ^ _hash32(rows + 0x632BE5AB))
    return torch.where(seeds >= 0, seeded, anon)


def _uniform(keys: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] uniforms in (0, 1) from per-row keys (24-bit mantissas)."""
    vocab = _hash32(torch.arange(V, device=keys.device) * 0x9E3779B9 + 1)
    bits = _hash32(keys[:, None] ^ vocab[None, :])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _candidates(logits: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor):
    """(scaled logits, keep mask) of the top-k / top-p filter: thresholds
    come from the MAX_TOP_K largest candidates, never a full V-sort."""
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits / temp                                    # [B, V]
    K = min(MAX_TOP_K, logits.shape[-1])
    k_vals = torch.topk(scaled, K, dim=-1).values             # [B, K] desc
    # top-k threshold: the kth largest value (k clamped to K)
    safe_k = torch.clamp(top_k.long(), 1, K)
    kth = torch.gather(k_vals, 1, (safe_k - 1)[:, None])
    thresh = torch.where(top_k[:, None] > 0, kth, -math.inf)  # [B, 1]
    # top-p threshold: smallest candidate still inside the nucleus
    # (probabilities under the full softmax; the first is always kept)
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs_k = torch.exp(k_vals - lse)                         # [B, K]
    cum = torch.cumsum(probs_k, dim=-1)
    top_p = top_p.float()
    p_on = (top_p > 0.0) & (top_p < 1.0)                      # [B]
    keep = (cum - probs_k) < torch.where(p_on, top_p, 2.0)[:, None]
    pth = torch.where(keep, k_vals, math.inf).amin(dim=-1, keepdim=True)
    thresh = torch.maximum(
        thresh, torch.where(p_on[:, None], pth, -math.inf))
    return scaled, scaled >= thresh


def sample(
    logits: torch.Tensor,        # [B, V] float32
    step_key: torch.Tensor,      # [] int64 engine step key (on device)
    temperature: torch.Tensor,   # [B] 0.0 = greedy
    top_k: torch.Tensor,         # [B] 0 = disabled
    top_p: torch.Tensor,         # [B] <=0 or >=1 = disabled
    seeds: torch.Tensor,         # [B] per-request seed, -1 = engine key
    positions: torch.Tensor,     # [B] absolute position being sampled
    stochastic: bool,
) -> torch.Tensor:
    """Greedy / temperature / top-k / top-p sampling over the batch, as in
    the JAX ``sample``; returns int32 ``[B]``.

    ``stochastic`` is the host's knowledge that some row samples (the JAX
    version branches on device with ``lax.cond``; asking the device here
    would cost a host sync per step), so an all-greedy batch pays only the
    argmax. Sampling is gumbel-max with per-row uniforms from a counter-based
    hash keyed on (seed, position) for seeded rows: reproducible across runs
    and batch compositions like the JAX package's, but the draws differ from
    JAX's threefry streams by design. Greedy rows and the surviving top-k /
    top-p candidate sets are identical to the JAX function's.
    """
    greedy = torch.argmax(logits, dim=-1)
    if not stochastic:
        return greedy.to(torch.int32)
    scaled, keep = _candidates(logits, temperature, top_k, top_p)
    masked = torch.where(keep, scaled, -math.inf)
    u = _uniform(_row_keys(step_key, seeds, positions), logits.shape[-1])
    sampled = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)


def step_key(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Derive a step key from a base key and a counter, on device."""
    return _hash32(key ^ _hash32(counter + 0x5BD1E995))


# --------------------------- the step function ----------------------------


def _sp_last_rows(h: torch.Tensor, last_idx: torch.Tensor,
                  g: comm.Group) -> torch.Tensor:
    """``[B, D]``: row ``last_idx[b]`` of the chunk's hidden states, which
    an sp rank holds only if its slice owns that position. Every member
    of the seq column ``g`` offers the row it would own, one exact
    ``all_gather`` over ``g`` collects them, and the owner's is selected
    on the device — a broadcast from the owner, without reading
    ``last_idx`` on the host."""
    B, C, _ = h.shape
    rows = torch.arange(B, device=h.device)
    local = torch.clamp(last_idx - g.index * C, 0, C - 1)
    offered = comm.all_gather(h[rows, local][None], g, dim=0)   # [n, B, D]
    owner = torch.clamp(last_idx // C, max=g.size - 1)
    return offered[owner, rows]


def raw_step_fn(cfg: ModelConfig, eng: EngineConfig, sp: bool = False):
    """The unified prefill/decode step (with ``sp``, the sequence-parallel
    prefill of a fresh prompt's one chunk: every rank returns the same
    sample).

    Signature:
      step(params, cache, tokens[B,T], positions[B,T], block_tables[B,W],
           last_idx[B], key, temperature[B], top_k[B], top_p[B], seeds[B],
           stochastic) -> (cache, sampled[B])

    ``last_idx[b]`` selects which chunk position's logits to sample (the last
    valid token of the chunk). The engine's mesh is bound here, once.
    """
    mesh = make_mesh(eng.mesh_shape)
    specs = param_specs(cfg, eng)

    def step(params, cache, tokens, positions, block_tables, last_idx, key,
             temperature, top_k, top_p, seeds, stochastic, mm_embeds=None,
             mm_mask=None):
        cache, h = forward(cfg, eng, params, cache, tokens, positions,
                           block_tables, mm_embeds=mm_embeds,
                           mm_mask=mm_mask, sp=sp, mesh=mesh)
        B = tokens.shape[0]
        rows = torch.arange(B, device=tokens.device)
        last_idx = last_idx.long()
        h_last = (_sp_last_rows(h, last_idx, mesh.seq_group) if sp
                  else h[rows, last_idx])
        logits = logits_fn(cfg, params, h_last, mesh, specs)  # [B, V]
        pos_last = positions[rows, last_idx]
        sampled = sample(logits, key, temperature, top_k, top_p, seeds,
                         pos_last, stochastic)
        return cache, sampled

    return step


def raw_ring_prefill_fn(cfg: ModelConfig, eng: EngineConfig,
                        sp: bool = False):
    """The unified prefill step that also posts its sampled token to the
    token ring ``last_tok``: rows with ``write_mask > 0`` (completing their
    prompt) write ``sampled`` into ``last_tok[slot]`` in place, so the
    first decode window chains on device; the others write the trash slot.
    ``sp`` makes it the sequence-parallel prefill.

    Signature:
      prefill(params, cache, last_tok, tokens[B,T], positions[B,T],
              block_tables[B,W], last_idx[B], slot_ids[B], write_mask[B],
              key, temperature[B], top_k[B], top_p[B], seeds[B],
              stochastic[, mm_embeds, mm_mask])
        -> (cache, last_tok, sampled[B])
    """
    base = raw_step_fn(cfg, eng, sp=sp)

    def prefill(params, cache, last_tok, tokens, positions, block_tables,
                last_idx, slot_ids, write_mask, key, temperature, top_k,
                top_p, seeds, stochastic, mm_embeds=None, mm_mask=None):
        cache, sampled = base(params, cache, tokens, positions, block_tables,
                              last_idx, key, temperature, top_k, top_p,
                              seeds, stochastic, mm_embeds=mm_embeds,
                              mm_mask=mm_mask)
        S = last_tok.shape[0] - 1
        slot_eff = torch.where(write_mask > 0, slot_ids, S).long()
        last_tok.index_put_((slot_eff,), sampled)
        return cache, last_tok, sampled

    return prefill


def make_sp_prefill_fn(cfg: ModelConfig, eng: EngineConfig):
    """The sequence-parallel unified step (``raw_step_fn`` with ``sp``):
    every rank of the mesh calls it on the same full-prompt chunk and
    returns the same sample."""
    return raw_step_fn(cfg, eng, sp=True)


def make_sp_ring_prefill_fn(cfg: ModelConfig, eng: EngineConfig):
    """The engine's sequence-parallel prefill: ``fn(T, W)`` is the packed
    prefill of a ``(T, W)`` sp chunk (:func:`raw_packed_prefill_fn` with
    ``sp``, the ``last_tok`` write included), built once per shape."""
    fns: Dict[Tuple[int, int], Any] = {}

    def for_shape(T: int, W: int):
        fn = fns.get((T, W))
        if fn is None:
            fn = fns[(T, W)] = raw_packed_prefill_fn(cfg, eng, T, W, sp=True)
        return fn

    return for_shape


PP_SCALARS = 8   # n, start, slot, write, top_k, seed, temp_q, top_p_q
PP_QUANT = 1e4   # temperature / top_p fixed-point scale in the int pack


def raw_packed_prefill_fn(cfg: ModelConfig, eng: EngineConfig, T: int,
                          W: int, mm: bool = False, sp: bool = False):
    """Prefill step with ALL inputs packed into ONE host-to-device copy.

    ``pint [1, T + W + PP_SCALARS]`` int32 = tokens(T), tables(W), then n,
    start, slot, write, top_k, seed, temp*1e4, top_p*1e4 (fixed-point).
    Positions are derived on device (start + iota, -1 pads). Rows that
    complete their prompt (write > 0) post the sampled token into
    ``last_tok[slot]`` in place so the first decode window chains on device;
    others post to the trash slot.

    With ``mm`` (the multimodal prefill, the counterpart of the JAX
    ``make_mm_prefill_fn`` / ``make_mm_ring_prefill_fn``) ``pint`` carries
    T more ints after the scalars, the placeholder mask, and the step takes
    ``mm_embeds [T, D]`` f32, a second upload, spliced over the masked rows.

    With ``sp`` it is the sequence-parallel prefill of a fresh prompt's
    one chunk (``forward(..., sp=True)``; T divisible by the seq column).

    Signature: prefill(params, cache, last_tok[S+1], pint, key, stochastic
    [, mm_embeds]) -> (cache, last_tok, sampled[1])
    """
    ring = raw_ring_prefill_fn(cfg, eng, sp=sp)
    M = T + W + PP_SCALARS

    def prefill(params, cache, last_tok, pint, key, stochastic,
                mm_embeds=None):
        tokens = pint[:, :T]
        tables = pint[:, T:T + W]
        n = pint[0, T + W + 0]
        start = pint[0, T + W + 1]
        slot = pint[0, T + W + 2]
        write = pint[0, T + W + 3]
        top_k = pint[0:1, T + W + 4]
        seed = pint[0:1, T + W + 5]
        temp = pint[0:1, T + W + 6].float() / PP_QUANT
        tp = pint[0:1, T + W + 7].float() / PP_QUANT
        idx = torch.arange(T, dtype=torch.int32, device=pint.device)
        positions = torch.where(idx < n, start + idx, -1)[None, :]
        last_idx = torch.clamp(n - 1, min=0)[None]
        mm_mask = pint[:, M:M + T] > 0 if mm else None
        if mm:
            mm_embeds = mm_embeds[None]
        return ring(params, cache, last_tok, tokens, positions, tables,
                    last_idx, slot[None], write[None], key, temp, top_k, tp,
                    seed, stochastic, mm_embeds=mm_embeds, mm_mask=mm_mask)

    return prefill


# ------------------- decode autopilot (device-resident control) -----------
#
# All per-sequence decode state lives on the device, indexed by slot:
#
#   ctl = {pos, vu (valid_until), temp, tk, tp, seed, last_tok [S+1],
#          tables [S+1, Wcap], key, ctr[, hist [S+1, hist_cap+1]]}
#
# A steady-state decode window runs with NO fresh host tensors: it reads its
# seats from a device-resident ``slot_rows`` map. The host pushes packed
# deltas (one int32 [n, 6+Wcap] + one f32 [n, 2] copy) only when membership
# joins/leaves, blocks grow, or a resumed sequence injects a host-known
# token. Slot S is the trash slot: delta pad rows target it, and dead seats
# (valid_until 0) advance nothing and scatter to the trash block.

CTL_I32_FIELDS = 6  # slot, pos, valid_until, top_k, seed, last_tok


def init_ctl(eng: EngineConfig, S: int, Wcap: int, device: torch.device,
             seed: int = 0, hist_cap: int = 0) -> Dict[str, torch.Tensor]:
    """Fresh control state as persistent tensors on ``device``; the delta
    and window functions update them in place.

    ``hist_cap > 0`` (spec decode) adds a per-seat token history ``hist``
    [S+1, hist_cap+1] for the n-gram drafter: ``hist[s, p]`` is sequence
    s's token at position p, -1 = unknown; column hist_cap is a trash
    column for padded scatters. The decode window and the delta pass the
    extra key through untouched."""
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    ctl = {
        "pos": torch.zeros((S + 1,), **i32),
        "vu": torch.zeros((S + 1,), **i32),
        "temp": torch.zeros((S + 1,), **f32),
        "tk": torch.zeros((S + 1,), **i32),
        "tp": torch.ones((S + 1,), **f32),
        "seed": torch.full((S + 1,), -1, **i32),
        "last_tok": torch.zeros((S + 1,), **i32),
        "tables": torch.zeros((S + 1, Wcap), **i32),
        "key": torch.tensor(seed & 0xFFFFFFFF, dtype=torch.int64,
                            device=device),
        "ctr": torch.zeros((), dtype=torch.int64, device=device),
    }
    if hist_cap > 0:
        ctl["hist"] = torch.full((S + 1, hist_cap + 1), -1, **i32)
    return ctl


def raw_ctl_delta_fn(Wcap: int):
    """Apply a packed delta to the control state, in place.

    delta_i32 [n, 6 + Wcap]: slot, pos, valid_until, top_k, seed, last_tok
    (-1 = keep the ring value — joins after an on-device prefill must not
    clobber the sampled token), then the full table row.
    delta_f32 [n, 2]: temperature, top_p. Pad rows use slot = S (trash).
    """

    def apply(ctl, delta_i32, delta_f32):
        slots = (delta_i32[:, 0].long(),)
        ctl["pos"].index_put_(slots, delta_i32[:, 1])
        ctl["vu"].index_put_(slots, delta_i32[:, 2])
        ctl["tk"].index_put_(slots, delta_i32[:, 3])
        ctl["seed"].index_put_(slots, delta_i32[:, 4])
        lt = delta_i32[:, 5]
        ctl["last_tok"].index_put_(
            slots, torch.where(lt >= 0, lt, ctl["last_tok"][slots]))
        ctl["tables"].index_put_(slots, delta_i32[:, 6:])
        ctl["temp"].index_put_(slots, delta_f32[:, 0])
        ctl["tp"].index_put_(slots, delta_f32[:, 1])
        return ctl

    return apply


def raw_autopilot_window_fn(cfg: ModelConfig, eng: EngineConfig, K: int):
    """K decode steps reading EVERYTHING from device state.

    Signature: window(params, cache, ctl, slot_rows[B], stochastic) ->
    (cache, ctl, samples[K, B]); cache and ctl are updated in place.

    Dead seats (valid_until <= pos) compute garbage into the trash block and
    advance nothing; their sample columns are discarded by the host. Step
    keys derive from the carried key + counter, so a window carries zero
    fresh host tensors.
    """
    mesh = make_mesh(eng.mesh_shape)
    specs = param_specs(cfg, eng)

    def window(params, cache, ctl, slot_rows, stochastic):
        rows = slot_rows.long()
        tok = ctl["last_tok"][rows][:, None]
        pos0 = ctl["pos"][rows]
        vu = ctl["vu"][rows]
        temp = ctl["temp"][rows]
        tk = ctl["tk"][rows]
        tp = ctl["tp"][rows]
        sd = ctl["seed"][rows]
        tables = ctl["tables"][rows]
        pos = pos0[:, None]
        outs = []
        for k in range(K):
            key_k = step_key(ctl["key"], ctl["ctr"] * K + k)
            pos_eff = torch.where(pos < vu[:, None], pos, -1)
            cache, h = forward(cfg, eng, params, cache, tok, pos_eff, tables,
                               mesh=mesh)
            logits = logits_fn(cfg, params, h[:, 0], mesh, specs)
            s = sample(logits, key_k, temp, tk, tp, sd, pos[:, 0],
                       stochastic)
            outs.append(s)
            tok, pos = s[:, None], pos + 1
        samples = torch.stack(outs)                        # [K, B]
        # write each row's last in-capacity sample back to its ring slot; a
        # row already at/over capacity (acc == 0 — e.g. a padding row whose
        # valid_until <= pos) produced ONLY garbage samples, so route its
        # write to the trash slot S instead of corrupting a live ring entry
        acc = torch.clamp(vu - pos0, 0, K)                 # [B]
        final = torch.gather(
            samples, 0, torch.clamp(acc - 1, min=0).long()[None, :])[0]
        S = ctl["last_tok"].shape[0] - 1
        write_rows = torch.where(acc > 0, rows, S)
        ctl["last_tok"].index_put_((write_rows,), final)
        # duplicate trash rows accumulate zero (acc there is 0)
        ctl["pos"].index_add_(0, rows, acc.to(torch.int32))
        ctl["ctr"] += 1
        return cache, ctl, samples

    return window


# ------------------- speculative decode window (draft + verify) -----------
#
# One autopilot window lands at most K tokens per host sync. The spec
# window raises the per-sync yield without a draft model: an on-device
# prompt-lookup drafter (spec/ngram.py) proposes up to k continuation
# tokens from the seat's own token history, and ONE [B, k+1] ragged
# forward verifies the chain against the paged cache — accepted prefix +
# one bonus/corrective token land per sync, up to k+1 total. Greedy rows
# are exactly parity-safe: every emitted token is the target model's own
# argmax given a correct prefix. Draft tokens that get rejected DO write
# KV at positions past the accepted point, but those positions are (a)
# never attendable by any accepted query (the causal mask is
# ``kpos <= q``), and (b) always re-scattered by the next window before
# any later query reads them — so rejected tokens never poison the cache.


def raw_spec_window_fn(cfg: ModelConfig, eng: EngineConfig, k: int,
                       ngram_min: int, ngram_max: int):
    """Draft + batched-verify decode window.

    Signature: window(params, cache, ctl, slot_rows[B], stochastic) ->
    (cache, ctl, packed[k+3, B]); cache and ctl (``hist`` included) are
    updated in place. Packed rows 0..k are the emitted token candidates,
    row k+1 is n_emitted per seat (how many of them are real), and row k+2
    is n_drafted (accounting).

    Drafting is restricted to greedy seats (temp <= 0); sampled seats run
    the window as a plain single-token decode step, keyed by position for
    seeded rows exactly like the non-spec path. Dead seats (vu <= pos)
    feed trash and emit 0 tokens. Every scatter that may repeat an index
    sends the repeats to the trash slot S or the history's trash cell, and
    writes a constant there (-1, or 0 into ``last_tok``), so the order in
    which CUDA applies repeated indices cannot change any bit of ctl: a
    replay stays bitwise equal to the eager window. The trash values are
    never read; the JAX window writes its garbage there instead. No scatter
    needs ``accumulate`` except the position advance, which adds as the
    JAX window does.
    """
    from ..spec.ngram import propose_drafts

    mesh = make_mesh(eng.mesh_shape)
    specs = param_specs(cfg, eng)

    def window(params, cache, ctl, slot_rows, stochastic):
        rows = slot_rows.long()                            # [B]
        tok0 = ctl["last_tok"][rows]
        pos0 = ctl["pos"][rows]
        vu = ctl["vu"][rows]
        temp = ctl["temp"][rows]
        tk = ctl["tk"][rows]
        tp = ctl["tp"][rows]
        sd = ctl["seed"][rows]
        tables = ctl["tables"][rows]
        hist = ctl["hist"]                                 # [S+1, Hcap+1]
        S = ctl["last_tok"].shape[0] - 1
        Hcap = hist.shape[1] - 1
        live = vu > pos0
        # keep the history coherent with the ring: the window's input token
        # IS all_tokens[pos0] (defensive — joins already host-fill it)
        hist.index_put_((
            torch.where(live, rows, S),
            torch.where(live, torch.clamp(pos0, 0, Hcap - 1), Hcap).long(),
        ), torch.where(live, tok0, -1))
        drafts = propose_drafts(hist[rows], pos0, k, ngram_min, ngram_max)
        drafts = torch.where((temp <= 0.0)[:, None], drafts, -1)  # [B, k]
        dvalid = torch.cumprod((drafts >= 0).to(torch.int32),
                               dim=1).bool()
        steps = torch.arange(k + 1, dtype=torch.int32, device=rows.device)
        toks = torch.cat(
            [tok0[:, None], torch.where(dvalid, drafts, 0)], dim=1
        )                                                  # [B, k+1]
        pos = pos0[:, None] + steps[None, :]
        feed = torch.cat(
            [torch.ones_like(dvalid[:, :1]), dvalid], dim=1
        ) & (pos < vu[:, None])
        pos_eff = torch.where(feed, pos, -1)
        cache, h = forward(cfg, eng, params, cache, toks, pos_eff, tables,
                           mesh=mesh)
        logits = logits_fn(cfg, params, h, mesh, specs)    # [B, k+1, V]
        g = torch.argmax(logits, dim=-1).to(torch.int32)   # [B, k+1]
        key_w = step_key(ctl["key"], ctl["ctr"])
        s0 = sample(logits[:, 0], key_w, temp, tk, tp, sd, pos0, stochastic)
        emitted = torch.cat([s0[:, None], g[:, 1:]], dim=1)
        # accept the longest draft prefix the target model reproduces; the
        # query at index i (position pos0+i) verifies draft i
        match = dvalid & (drafts == g[:, :k])              # [B, k]
        a = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        cap = torch.clamp(vu - pos0, 0, k + 1)
        n = torch.minimum(a + 1, cap).to(torch.int32)      # [B] emitted
        final = torch.gather(
            emitted, 1, torch.clamp(n - 1, min=0).long()[:, None])[:, 0]
        write_rows = torch.where(n > 0, rows, S)
        ctl["last_tok"].index_put_((write_rows,), torch.where(n > 0, final, 0))
        # duplicate trash rows accumulate zero (n there is 0)
        ctl["pos"].index_add_(0, rows, n)
        # append the landed tokens to the history (emitted j is
        # all_tokens[pos0+1+j]); rejects route to the trash cell
        hv = steps[None, :] < n[:, None]
        hist.index_put_((
            torch.where(hv, rows[:, None], S),
            torch.where(hv, torch.clamp(pos0[:, None] + 1 + steps[None, :],
                                        0, Hcap - 1), Hcap).long(),
        ), torch.where(hv, emitted, -1))
        ctl["ctr"] += 1
        ndraft = dvalid.to(torch.int32).sum(dim=1)
        packed = torch.cat(
            [emitted.T, n[None, :], ndraft[None, :]], dim=0
        ).to(torch.int32)                                  # [k+3, B]
        return cache, ctl, packed

    return window


def raw_spec_hist_fill_fn():
    """Host-side history injection for joining/resumed seats.

    fill(ctl, slots[n], rows[n, Hcap+1]) scatters full token-history rows
    (-1-padded) into ``ctl["hist"]`` in place — the key is never rebound,
    since the spec graphs read it at its captured address. Pad entries use
    slot = S (trash). Dispatched only on seat joins/resets — steady-state
    spec windows maintain the history on device with zero host uploads.
    """

    def fill(ctl, slots, rows):
        ctl["hist"].index_put_((slots.long(),), rows)
        return ctl

    return fill


@contextmanager
def gc_paused():
    """Around a CUDA graph capture: a cyclic garbage collection inside it
    (on any thread) could destroy a dead graph, which invalidates the
    capture; so the collector waits until the capture is done."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _window_key(kind: str, B: int, stochastic: bool) -> str:
    return f"{kind}_window:B={B}:stochastic={int(stochastic)}"


def graphs_apply(eng: EngineConfig, device: torch.device) -> bool:
    """Whether the engine's decode windows and packed prefill chunks replay
    CUDA graphs: on a card, on a mesh of one rank. On a mesh of more they
    run eager: a gloo collective cannot be captured, capture with NCCL
    inside waits for a machine with two cards to be tested on, and a (dp,
    1) window (no collective) is kept eager too until a card shows its
    replay on every rank."""
    return device.type == "cuda" and mesh_ranks(eng) == 1


class GraphPool:
    """The memory pool and capture stream that a set of CUDA graphs share:
    the engine's decode and spec windows and its prefill chunks. Their
    replays run one at a time on one stream, so a graph captured later may
    reuse what an earlier one freed during its capture; each graph's output
    stays referenced by its owner, so no capture takes it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = None
        self.stream: Optional[torch.cuda.Stream] = None

    def capture(self, warm_up, body):
        """Run ``warm_up()`` once eagerly on the capture stream, so what a
        first call allocates (the decode kernel's arrival counters and
        occupancy query, cuBLAS's workspace) lives outside the pool; then
        capture ``body()`` into the pool in the ``"thread_local"`` error
        mode, which lets other threads make CUDA calls during it, with the
        garbage collector paused (:func:`gc_paused`). Returns ``(graph,
        what body returned, held)``, ``held`` being the paged-attention
        launches the graph holds (``ops.paged_attention.take_recorded``)."""
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        s = self.stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            warm_up()
        pa.take_recorded()
        graph = torch.cuda.CUDAGraph()
        with gc_paused(), torch.cuda.graph(
                graph, pool=self.handle, stream=s,
                capture_error_mode="thread_local"):
            out = body()
        torch.cuda.current_stream(self.device).wait_stream(s)
        return graph, out, pa.take_recorded()

    def bytes(self) -> int:
        """Device bytes of the segments in the pool."""
        if self.handle is None:
            return 0
        pool = tuple(self.handle)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class AutopilotWindow:
    """The engine's decode window, and with ``spec_k`` > 0 its spec window
    too. On a CUDA device: one ``torch.cuda.CUDAGraph`` per ``(kind, decode
    bucket B, stochastic)``, kind "decode" captured over
    :func:`raw_autopilot_window_fn` and kind "spec" over
    :func:`raw_spec_window_fn`, and replayed — the counterpart of the JAX
    package's one jitted executable per bucket
    (``dynamo_tpu/engine/model.py`` ``make_autopilot_fns`` and
    ``make_spec_fns``). On the CPU it calls the eager functions: the CPU was
    asked for, so that is not a fallback. Signature as the eager windows':
    ``window(params, cache, ctl, slot_rows[B], stochastic, spec=False) ->
    (cache, ctl, out)``, ``out`` being ``samples[K, B]`` or the spec
    window's ``packed[k+3, B]``.

    What a graph needs, and what this class does about it:

    - *Persistent inputs.* A graph reads params, cache and ctl at the
      addresses it was captured over. The engine only updates them in place
      (the delta, history-fill and prefill functions hand back the same
      objects), and every call checks that it is handed the objects it
      captured, ctl's tensors key by key (``hist`` among them).
    - *Static rows.* Each bucket has one ``slot_rows`` buffer, shared by all
      its graphs, decode and spec. :meth:`load_rows` writes a new seat map
      into it with a copy on the stream, in place of a new tensor.
    - *Static output.* ``samples`` (or ``packed``) lives in the graphs'
      pool, and the next replay of the same graph overwrites it: the caller
      copies it out on the same stream before it dispatches another window.
    - *Warm-up.* Before its capture each graph's window runs once eagerly
      on the capture stream (:meth:`GraphPool.capture`), over the trash
      slot only (it writes the trash slot, the trash block and the
      history's trash cell; the step counter it advances is put back).
      :meth:`capture_all` takes the largest bucket first, so the decode
      kernel's arrival counters never grow after a capture
      (``ops/paged_attention.py`` raises if they would grow during one).
    - *One pool.* All graphs share one :class:`GraphPool` (``pool``), which
      the engine's :class:`PrefillGraphs` share too.
    - *Threads.* The engine captures every graph at construction, before
      its loop starts. A window built later (the stall watchdog's einsum
      rebuild) captures at its first call, on the device-step thread, while
      the fetch thread may be waiting on a CUDA event: hence the capture's
      ``"thread_local"`` error mode and paused garbage collector.
    - *Launch counts.* A replay never calls the kernel wrappers. A capture
      records the paged-attention launches it holds
      (``ops.paged_attention.take_recorded``) and each replay adds them to
      ``LAUNCHES``.
    - *No fallback.* A failed capture or replay raises; on a card the window
      never runs eagerly outside the warm-up.
    - *New rungs.* A bucket the engine never captured at construction (a
      rung the adaptive ladder adds, ``engine/ladder.py``) is captured at
      its first call, on the device-step thread, like the einsum rebuild's.
      Every capture is counted by ``observability/compilewatch.py`` under
      its key; on the CPU, the first call of a key is.
    """

    def __init__(self, cfg: ModelConfig, eng: EngineConfig, K: int,
                 device: torch.device, spec_k: int = 0):
        self.raw = raw_autopilot_window_fn(cfg, eng, K)
        self.raw_spec = (
            raw_spec_window_fn(cfg, eng, spec_k, eng.spec_ngram_min,
                               eng.spec_ngram_max) if spec_k > 0 else None)
        self.device = device
        self.graphed = graphs_apply(eng, device)
        self.trash = eng.max_num_seqs       # ctl's trash slot S
        self._graphs: Dict[Tuple[str, int, bool],
                           Tuple[Any, torch.Tensor, Dict[str, int]]] = {}
        self._rows: Dict[int, torch.Tensor] = {}
        self._bound: Optional[Tuple[Any, Any, Any, Dict[str, Any]]] = None
        self.pool = GraphPool(device)
        self.replays = 0
        self.spec_replays = 0
        self.capture_s: Dict[Tuple[str, int, bool], float] = {}
        self.last_key = ""                   # the last graph captured
        self._seen: set = set()              # keys called eagerly (CPU)

    def load_rows(self, cols: List[int]) -> torch.Tensor:
        """The device seat map ``slot_rows`` for ``cols``: on a card the
        bucket's static buffer, refilled from pinned memory on the stream
        (after every window already dispatched)."""
        host = torch.tensor(cols, dtype=torch.int32)
        if not self.graphed:
            return host.to(self.device)
        buf = self._rows_buffer(len(cols))
        buf.copy_(host.pin_memory(), non_blocking=True)
        return buf

    def _rows_buffer(self, B: int) -> torch.Tensor:
        buf = self._rows.get(B)
        if buf is None:
            buf = torch.full((B,), self.trash, dtype=torch.int32,
                             device=self.device)
            self._rows[B] = buf
        return buf

    def _check_bound(self, params, cache, ctl) -> None:
        if self._bound is None:
            self._bound = (params, cache, ctl, dict(ctl))
        bp, bc, bl, leaves = self._bound
        if (params is not bp or cache is not bc or ctl is not bl
                or len(ctl) != len(leaves)
                or any(ctl.get(k) is not v for k, v in leaves.items())):
            raise RuntimeError(
                "decode graphs are bound to the params, cache and ctl "
                "tensors they were captured over; update those in place")

    def _fn(self, spec: bool):
        if spec and self.raw_spec is None:
            raise RuntimeError("this window was built without spec_k")
        return self.raw_spec if spec else self.raw

    def capture_all(self, params, cache, ctl, buckets) -> None:
        """Capture every ``(kind, B, stochastic)`` graph of ``buckets``,
        largest bucket first (see the class docstring)."""
        kinds = (False, True) if self.raw_spec is not None else (False,)
        for B in sorted(set(buckets), reverse=True):
            for spec in kinds:
                for stochastic in (False, True):
                    self._capture(params, cache, ctl, B, stochastic, spec)

    def _capture(self, params, cache, ctl, B: int, stochastic: bool,
                 spec: bool):
        self._check_bound(params, cache, ctl)
        fn = self._fn(spec)
        t0 = time.perf_counter()
        rows = self._rows_buffer(B)

        def warm_up():
            trash_rows = torch.full_like(rows, self.trash)
            ctr = ctl["ctr"].clone()
            fn(params, cache, ctl, trash_rows, stochastic)
            ctl["ctr"].copy_(ctr)

        graph, (_, _, out), held = self.pool.capture(
            warm_up, lambda: fn(params, cache, ctl, rows, stochastic))
        entry = (graph, out, held)
        key = ("spec" if spec else "decode", B, stochastic)
        self._graphs[key] = entry
        self.capture_s[key] = time.perf_counter() - t0
        self.last_key = _window_key(*key)
        compilewatch.note(self.last_key, self.capture_s[key])
        return entry

    def pool_bytes(self) -> int:
        """Device bytes of the segments in the graphs' shared pool."""
        return self.pool.bytes()

    def __call__(self, params, cache, ctl, slot_rows: torch.Tensor,
                 stochastic: bool, spec: bool = False):
        if not self.graphed:
            key = ("spec" if spec else "decode", slot_rows.shape[0],
                   stochastic)
            if key not in self._seen:
                self._seen.add(key)
                self.last_key = _window_key(*key)
                compilewatch.note(self.last_key)
            return self._fn(spec)(params, cache, ctl, slot_rows, stochastic)
        B = slot_rows.shape[0]
        entry = self._graphs.get(("spec" if spec else "decode", B,
                                  stochastic))
        if entry is None:
            entry = self._capture(params, cache, ctl, B, stochastic, spec)
        self._check_bound(params, cache, ctl)
        rows = self._rows[B]
        if slot_rows is not rows:
            rows.copy_(slot_rows)
        graph, out, held = entry
        graph.replay()
        pa.count_replay(held)
        self.replays += 1
        self.spec_replays += int(spec)
        return cache, ctl, out


def make_autopilot_fns(cfg: ModelConfig, eng: EngineConfig, K: int,
                       Wcap: int, device: torch.device, spec_k: int = 0):
    """(window_fn, delta_fn) of the engine's decode path: the window is an
    :class:`AutopilotWindow` (CUDA graphs on a card), which also serves the
    spec window when ``spec_k`` > 0; the delta stays eager (its row count
    varies, and joins and block growth are rare)."""
    return (AutopilotWindow(cfg, eng, K, device, spec_k=spec_k),
            raw_ctl_delta_fn(Wcap))


# ------------------------ packed prefill graphs ----------------------------


def prefill_graphed(eng: EngineConfig, device: torch.device, T: int,
                    mm: bool = False, sp: bool = False) -> bool:
    """Whether a packed prefill chunk of ``T`` tokens replays a graph of
    :class:`PrefillGraphs` (else it runs its eager function): on a card
    and a one-rank mesh (:func:`graphs_apply`), a text chunk off the sp
    path whose attention class resolves to the kernel. The kernel reads a
    row's table only below its context (``ctx_len``), so its work does not
    grow with the table's width and one graph per T at the widest table
    does a narrow chunk's work; the einsum route gathers the whole table,
    so it keeps its eager function per ``(T, W)``. A multimodal chunk
    carries a second upload and stays eager, as does an sp chunk (its
    mesh has more than one rank)."""
    return (graphs_apply(eng, device) and not mm and not sp
            and resolve_attention_impl(eng, attention_class(eng, T))
            == "kernel")


class PrefillGraphs:
    """The packed prefill (:func:`raw_packed_prefill_fn`) of the chunks
    :func:`prefill_graphed` takes: one ``torch.cuda.CUDAGraph`` per ``(T,
    stochastic)`` at the widest table, ``W = max_blocks_per_seq``, replayed
    in place of the eager chunk. Signature as the eager function's:
    ``prefill(params, cache, last_tok, pint, key, stochastic) -> (cache,
    last_tok, sampled[1])``, ``pint`` ``[1, T + W + PP_SCALARS]`` from
    :meth:`load`. It keeps :class:`AutopilotWindow`'s rules and shares its
    :class:`GraphPool`:

    - *Static inputs.* Each T has one ``pint`` buffer, which :meth:`load`
      fills with one copy from pinned memory on the stream; one key buffer
      takes a copy of each chunk's step key. params, cache and ``last_tok``
      are bound by identity and checked on every call.
    - *Output.* ``sampled`` lives in the pool and the graph's next replay
      overwrites it, and one batch may carry two chunks of one T: each
      replay's sample is copied out on the stream right after it.
    - *Warm-up.* Before its capture each graph's chunk runs once eagerly
      with ``n = 0``: every position is -1, so its K/V go to the trash
      block and its sample to the trash slot. :meth:`capture_all` takes the
      largest T first.
    - *Threads.* The engine captures the greedy graph of every prefill
      bucket at construction, after the decode graphs; a stochastic graph,
      or a rung the adaptive ladder adds, is captured at its first call on
      the device-step thread, which holds the profiler's launch gate. Each
      capture is counted by ``observability/compilewatch.py`` under
      ``prefill:<T>:greedy|stochastic``.
    - *Launch counts* and *no fallback* as the decode window's.
    """

    def __init__(self, cfg: ModelConfig, eng: EngineConfig, pool: GraphPool):
        self.cfg, self.eng = cfg, eng
        self.pool = pool
        self.device = pool.device
        self.W = eng.max_blocks_per_seq
        self._fns: Dict[int, Any] = {}
        self._graphs: Dict[Tuple[int, bool],
                           Tuple[Any, torch.Tensor, Dict[str, int]]] = {}
        self._pint: Dict[int, torch.Tensor] = {}
        self._key: Optional[torch.Tensor] = None
        self._bound: Optional[Tuple[Any, Any, Any]] = None
        self.replays = 0
        self.capture_s: Dict[Tuple[int, bool], float] = {}

    def load(self, host: torch.Tensor) -> torch.Tensor:
        """The device ``pint`` of a chunk packed on the host: its T's
        static buffer, refilled from pinned memory on the stream (after
        every call already dispatched)."""
        buf = self._pint_buffer(host.shape[1] - self.W - PP_SCALARS)
        if self.device.type == "cuda":
            host = host.pin_memory()
        buf.copy_(host, non_blocking=True)
        return buf

    def _pint_buffer(self, T: int) -> torch.Tensor:
        buf = self._pint.get(T)
        if buf is None:
            buf = torch.zeros((1, T + self.W + PP_SCALARS),
                              dtype=torch.int32, device=self.device)
            self._pint[T] = buf
        return buf

    def _check_bound(self, params, cache, last_tok) -> None:
        if self._bound is None:
            self._bound = (params, cache, last_tok)
        bp, bc, bl = self._bound
        if params is not bp or cache is not bc or last_tok is not bl:
            raise RuntimeError(
                "prefill graphs are bound to the params, cache and last_tok "
                "tensors they were captured over; update those in place")

    def _fn(self, T: int):
        fn = self._fns.get(T)
        if fn is None:
            fn = self._fns[T] = raw_packed_prefill_fn(self.cfg, self.eng, T,
                                                      self.W)
        return fn

    def capture_all(self, params, cache, last_tok, buckets) -> None:
        """Capture the greedy graph of every T in ``buckets``, largest
        first."""
        for T in sorted(set(buckets), reverse=True):
            self._capture(params, cache, last_tok, T, False)

    def _capture(self, params, cache, last_tok, T: int, stochastic: bool):
        self._check_bound(params, cache, last_tok)
        fn = self._fn(T)
        t0 = time.perf_counter()
        pint = self._pint_buffer(T)
        if self._key is None:
            self._key = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        key = self._key
        graph, (_, _, sampled), held = self.pool.capture(
            # n = 0: the trash block and the trash slot
            lambda: fn(params, cache, last_tok, torch.zeros_like(pint), key,
                       stochastic),
            lambda: fn(params, cache, last_tok, pint, key, stochastic))
        entry = (graph, sampled, held)
        self._graphs[(T, stochastic)] = entry
        self.capture_s[(T, stochastic)] = time.perf_counter() - t0
        compilewatch.note(
            f"prefill:{T}:{'stochastic' if stochastic else 'greedy'}",
            self.capture_s[(T, stochastic)])
        return entry

    def __call__(self, params, cache, last_tok, pint: torch.Tensor,
                 key: torch.Tensor, stochastic: bool):
        T = pint.shape[1] - self.W - PP_SCALARS
        entry = self._graphs.get((T, stochastic))
        if entry is None:
            entry = self._capture(params, cache, last_tok, T, stochastic)
        self._check_bound(params, cache, last_tok)
        buf = self._pint[T]
        if pint is not buf:
            buf.copy_(pint)
        self._key.copy_(key)
        graph, sampled, held = entry
        graph.replay()
        pa.count_replay(held)
        self.replays += 1
        return cache, last_tok, sampled.clone()


# ------------------------ KV block transfer ops ---------------------------
#
# The data plane of KV movement (disaggregated prefill/decode, the KVBM
# tiers, the prefix cache's device-plane onboarding, preemption
# evacuation): gather a set of physical blocks out of the paged cache and
# scatter received blocks into pre-allocated ones. The JAX package jits an
# XLA gather and a donated scatter (``make_kv_ops``); here they are torch
# index ops. The scatter writes the cache's per-layer tensors IN PLACE: the
# decode graphs read those tensors at the addresses they were captured over.


def cache_payload_keys(eng: EngineConfig) -> Tuple[str, ...]:
    """The cache dict keys a block transfer must carry: quantized caches
    add the per-(slot, head) scale planes to the K/V pages."""
    if quant.is_quantized(eng.kv_dtype):
        return ("k", "v", "ks", "vs")
    return ("k", "v")




def make_kv_ops(eng: EngineConfig, mesh: Optional[Mesh] = None):
    """(extract, inject) block gather/scatter over the paged cache.

    extract(cache, block_ids[N]) -> {"k","v"}: [L, N, KV, bs, hd]
    (plus {"ks","vs"}: [L, N, KV, bs] when the cache is quantized), new
    tensors on the cache's device;
    inject(cache, block_ids[N], data) -> cache, the same object, each layer
    written in place with ``index_copy_`` (``data`` on the cache's device).
    Pad ids name the trash block 0: pads gather it and scatter into it.

    On a tp rank (``mesh``, the engine's, with a tp axis above 1) the
    cache holds the rank's ``KV/tp`` heads: extract gathers those (``[L,
    N, KV/tp, ...]``; the engine joins the ranks' slices), and inject
    always takes the full payload of the JAX layout — every KV head, in
    head order (``SpecLayout.kv_payload_specs``) — and writes the rank's
    head slice of it."""
    keys = cache_payload_keys(eng)
    mesh = make_mesh(eng.mesh_shape) if mesh is None else mesh
    specs = SpecLayout.for_mesh(eng.mesh_shape).kv_payload_specs(keys)

    def extract(cache: Cache, block_ids: torch.Tensor) -> Dict[str, Any]:
        ids = block_ids.long()
        return {key: torch.stack([layer.index_select(0, ids)
                                  for layer in cache[key]])
                for key in keys}

    def inject(cache: Cache, block_ids: torch.Tensor,
               data: Dict[str, Any]) -> Cache:
        ids = block_ids.long()
        for key in keys:
            src = data[key]
            if mesh.shape["tp"] > 1:
                src = shard_tensor(src, specs[key], mesh)
            for li, layer in enumerate(cache[key]):
                if layer.dtype == torch.float8_e4m3fn:
                    # no index_copy_ for fp8: copy the same bytes as uint8
                    # through a view of the same storage
                    layer.view(torch.uint8).index_copy_(
                        0, ids, src[li].view(torch.uint8))
                else:
                    layer.index_copy_(0, ids, src[li])
        return cache

    return extract, inject
