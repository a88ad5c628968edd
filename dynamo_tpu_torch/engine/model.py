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
- **Speculative decoding** (``spec_mode="ngram"``): the spec window drafts
  from a per-seat token history in ``ctl["hist"]`` (``spec/ngram.py``) and
  verifies ``[B, k+1]`` query rows in one forward through the kernel's
  ragged face; on a card it is captured and replayed like the decode
  window, in the same pool.
- **Quantized serving** (``engine/quant.py``): matmul weights may be
  ``{"q", "s"}`` leaves (int8/fp8 with per-output-channel f32 scales), and
  with a quantized ``kv_dtype`` the pages are 1-byte with per-(slot, head)
  f32 scales in ``cache["ks"]``/``cache["vs"]``, scattered beside them and
  handed to both kernel faces.

Nothing here synchronises with the host except where a docstring says so.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import paged_attention as pa
from ..ops.paged_attention import (
    paged_attention_decode, paged_attention_ragged,
)
from ..parallel.moe import moe_ffn
from . import quant
from .config import EngineConfig, ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, List[torch.Tensor]]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


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
               device: torch.device) -> Cache:
    """Paged KV cache, block-major and head-contiguous: per-layer tensors of
    ``[num_blocks, KV, block_size, hd]`` (lists under ``"k"``/``"v"``).
    One (block, head) tile is a contiguous ``bs*hd`` run. Per-layer tensors,
    as in the JAX cache, so each layer's scatter updates its own buffer in
    place. A quantized ``kv_dtype`` stores 1-byte pages plus per-(slot,
    head) f32 scale caches ``[num_blocks, KV, block_size]`` under
    ``"ks"``/``"vs"``; the trash block's zero scales dequantize to zeros."""
    quantized = quant.is_quantized(eng.kv_dtype)
    dt = quant.storage_dtype(eng.kv_dtype) if quantized else torch_dtype(cfg)
    shape = (eng.num_blocks, cfg.num_kv_heads, eng.block_size, cfg.head_dim_)
    planes = {"k": (shape, dt), "v": (shape, dt)}
    if quantized:
        planes.update(ks=(shape[:-1], torch.float32),
                      vs=(shape[:-1], torch.float32))
    return {
        key: [torch.zeros(shp, dtype=t, device=device)
              for _ in range(cfg.num_layers)]
        for key, (shp, t) in planes.items()
    }


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
    per-class override when set, else ``attention_impl`` — "kernel" by
    default for every class (on a card the CUDA kernel, on the CPU its
    plain version)."""
    return getattr(eng, f"attention_impl_{attn_class}", "") \
        or eng.attention_impl


def forward(
    cfg: ModelConfig,
    eng: EngineConfig,
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,        # [B, T] int (0 = pad)
    positions: torch.Tensor,     # [B, T] int absolute, -1 = pad
    block_tables: torch.Tensor,  # [B, W] int physical block ids (0 = trash)
) -> Tuple[Cache, torch.Tensor]:
    """Run the transformer over a token chunk, updating the paged cache IN
    PLACE (the returned cache is the same dict and tensors).

    Valid tokens of each row are a prefix of it (the prefill/decode feed
    contract), so the kernel's ragged metadata is a count and a max.
    Returns (cache, hidden states [B, T, D]).
    """
    B, T = tokens.shape
    W = block_tables.shape[1]
    bs = eng.block_size
    hd = cfg.head_dim_
    H, KV = cfg.num_heads, cfg.num_kv_heads
    dev = tokens.device
    positions = positions.long()
    block_tables = block_tables.to(torch.int32).contiguous()

    h = params["embed"][tokens.long()]                    # [B, T, D]

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

    cos, sin = _rope_tables(positions, cfg.rope_theta, hd)
    kv_quant = quant.is_quantized(eng.kv_dtype)

    use_kernel = resolve_attention_impl(eng, attention_class(eng, T)) \
        == "kernel"
    if use_kernel:
        if T == 1:
            seq_lens = torch.clamp(positions[:, 0] + 1, min=0).to(
                torch.int32)
        else:
            q_len = live.sum(dim=1).to(torch.int32)
            ctx_len = torch.clamp(positions.max(dim=1).values + 1,
                                  min=0).to(torch.int32)
            q_start = torch.arange(B + 1, dtype=torch.int32,
                                   device=dev) * T

    stacked = params["layers"]
    for li in range(cfg.num_layers):
        p = _layer_slice(stacked, li)
        lk, lv = cache["k"][li], cache["v"][li]           # [NB, KV, bs, hd]
        # [NB, KV, bs] f32 per-(slot, head) scales of quantized pages
        lks = cache["ks"][li] if kv_quant else None
        lvs = cache["vs"][li] if kv_quant else None

        x = _rms_norm(h, p["attn_norm"], cfg.rms_norm_eps)
        q = _mm(x, p["wq"]).reshape(B, T, H, hd)
        k = _mm(x, p["wk"]).reshape(B, T, KV, hd)
        v = _mm(x, p["wv"]).reshape(B, T, KV, hd)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)

        # scatter this chunk's K/V into the paged cache, in place (the JAX
        # step donates the cache and scatter-updates it)
        k_upd = k.reshape(B * T, KV, hd)
        v_upd = v.reshape(B * T, KV, hd)
        if kv_quant:
            # per-(token, head) scales: a token's bytes depend only on its
            # own K/V, never on the block it lands in
            k_upd, k_sc = quant.kv_quantize(k_upd, eng.kv_dtype)
            v_upd, v_sc = quant.kv_quantize(v_upd, eng.kv_dtype)
            lks.index_put_(scatter_idx, k_sc)
            lvs.index_put_(scatter_idx, v_sc)
        _bits(lk).index_put_(scatter_idx, _bits(k_upd))
        _bits(lv).index_put_(scatter_idx, _bits(v_upd))

        if use_kernel and T == 1:
            attn = paged_attention_decode(
                q[:, 0].contiguous(), lk, lv, block_tables, seq_lens,
                block_size=bs, k_scale=lks, v_scale=lvs,
            )[:, None]
        elif use_kernel:
            attn = paged_attention_ragged(
                q.reshape(B * T, H, hd).contiguous(), lk, lv, block_tables,
                q_start, q_len, ctx_len, block_size=bs, max_q_len=T,
                k_scale=lks, v_scale=lvs,
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
        h = h + _mm(attn.reshape(B, T, H * hd), p["wo"])

        x = _rms_norm(h, p["mlp_norm"], cfg.rms_norm_eps)
        if cfg.is_moe:
            # every row of the chunk is routed, padding included, in the
            # reference's order: capacity slots go to rows in [B*T] order
            D = x.shape[-1]
            out = moe_ffn(
                x.reshape(B * T, D),
                p["w_router"],
                _dequant_leaf(p["w_gate"], x.dtype),
                _dequant_leaf(p["w_up"], x.dtype),
                _dequant_leaf(p["w_down"], x.dtype),
                top_k=cfg.num_experts_per_token,
                capacity_factor=cfg.moe_capacity_factor,
            )
            h = h + out.reshape(B, T, D)
        else:
            gate = F.silu(_mm(x, p["w_gate"]).float())
            up = _mm(x, p["w_up"]).float()
            h = h + _mm((gate * up).to(h.dtype), p["w_down"])

    h = _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return cache, h


def logits_fn(cfg: ModelConfig, params: Params,
              h: torch.Tensor) -> torch.Tensor:
    """Float32 logits ``[..., V]``. A bf16 head on the card multiplies in
    bf16 with an f32 result (casting the [D, V] head to f32 would write
    ~1 GB per step for a 1B model). A quantized untied head multiplies by
    its 1-byte weight cast to h's dtype, then by its per-column f32
    scale."""
    head = (params["embed"].T if cfg.tie_word_embeddings
            else params["lm_head"])
    if isinstance(head, dict):
        return _head_mm(h, head["q"].to(h.dtype)) * head["s"][0]
    return _head_mm(h, head)


def _head_mm(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``h @ head`` with an f32 result."""
    if h.dtype == torch.float32 and head.dtype == torch.float32:
        return h @ head
    if h.is_cuda:
        flat = h.reshape(-1, h.shape[-1])
        y = torch.mm(flat, head.to(h.dtype), out_dtype=torch.float32)
        return y.reshape(*h.shape[:-1], y.shape[-1])
    return h.float() @ head.float()


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


def raw_step_fn(cfg: ModelConfig, eng: EngineConfig):
    """The unified prefill/decode step.

    Signature:
      step(params, cache, tokens[B,T], positions[B,T], block_tables[B,W],
           last_idx[B], key, temperature[B], top_k[B], top_p[B], seeds[B],
           stochastic) -> (cache, sampled[B])

    ``last_idx[b]`` selects which chunk position's logits to sample (the last
    valid token of the chunk).
    """

    def step(params, cache, tokens, positions, block_tables, last_idx, key,
             temperature, top_k, top_p, seeds, stochastic):
        cache, h = forward(cfg, eng, params, cache, tokens, positions,
                           block_tables)
        B = tokens.shape[0]
        rows = torch.arange(B, device=tokens.device)
        last_idx = last_idx.long()
        logits = logits_fn(cfg, params, h[rows, last_idx])    # [B, V]
        pos_last = positions[rows, last_idx]
        sampled = sample(logits, key, temperature, top_k, top_p, seeds,
                         pos_last, stochastic)
        return cache, sampled

    return step


PP_SCALARS = 8   # n, start, slot, write, top_k, seed, temp_q, top_p_q
PP_QUANT = 1e4   # temperature / top_p fixed-point scale in the int pack


def raw_packed_prefill_fn(cfg: ModelConfig, eng: EngineConfig, T: int,
                          W: int):
    """Prefill step with ALL inputs packed into ONE host-to-device copy.

    ``pint [1, T + W + PP_SCALARS]`` int32 = tokens(T), tables(W), then n,
    start, slot, write, top_k, seed, temp*1e4, top_p*1e4 (fixed-point).
    Positions are derived on device (start + iota, -1 pads). Rows that
    complete their prompt (write > 0) post the sampled token into
    ``last_tok[slot]`` in place so the first decode window chains on device;
    others post to the trash slot.

    Signature: prefill(params, cache, last_tok[S+1], pint, key, stochastic)
    -> (cache, last_tok, sampled[1])
    """
    base = raw_step_fn(cfg, eng)

    def prefill(params, cache, last_tok, pint, key, stochastic):
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
        cache, sampled = base(params, cache, tokens, positions, tables,
                              last_idx, key, temp, top_k, tp, seed,
                              stochastic)
        S = last_tok.shape[0] - 1
        slot_eff = torch.where(write > 0, slot, S).long()[None]
        last_tok.index_put_((slot_eff,), sampled)
        return cache, last_tok, sampled

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
            cache, h = forward(cfg, eng, params, cache, tok, pos_eff, tables)
            logits = logits_fn(cfg, params, h[:, 0])
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
        cache, h = forward(cfg, eng, params, cache, toks, pos_eff, tables)
        logits = logits_fn(cfg, params, h)                 # [B, k+1, V]
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
      on the capture stream, over the trash slot only (it writes the trash
      slot, the trash block and the history's trash cell; the step counter
      it advances is put back), so what a first call allocates — the decode
      kernel's arrival counters and occupancy query, cuBLAS's workspace —
      lives outside the pool. :meth:`capture_all` takes the largest bucket
      first, so the counters never grow after a capture
      (``ops/paged_attention.py`` raises if they would grow during one).
    - *One pool.* All graphs share one memory pool: replays run one at a
      time on one stream, and every graph's output stays referenced here.
    - *Threads.* The engine captures every graph at construction, before
      its loop starts. A window built later (the stall watchdog's einsum
      rebuild) captures at its first call, on the device-step thread, while
      the fetch thread may be waiting on a CUDA event: so every capture
      runs in the ``"thread_local"`` error mode, which lets other threads
      make CUDA calls during it.
    - *Launch counts.* A replay never calls the kernel wrappers. A capture
      records the paged-attention launches it holds
      (``ops.paged_attention.take_recorded``) and each replay adds them to
      ``LAUNCHES``.
    - *No fallback.* A failed capture or replay raises; on a card the window
      never runs eagerly outside the warm-up.
    """

    def __init__(self, cfg: ModelConfig, eng: EngineConfig, K: int,
                 device: torch.device, spec_k: int = 0):
        self.raw = raw_autopilot_window_fn(cfg, eng, K)
        self.raw_spec = (
            raw_spec_window_fn(cfg, eng, spec_k, eng.spec_ngram_min,
                               eng.spec_ngram_max) if spec_k > 0 else None)
        self.device = device
        self.graphed = device.type == "cuda"
        self.trash = eng.max_num_seqs       # ctl's trash slot S
        self._graphs: Dict[Tuple[str, int, bool],
                           Tuple[Any, torch.Tensor, Dict[str, int]]] = {}
        self._rows: Dict[int, torch.Tensor] = {}
        self._bound: Optional[Tuple[Any, Any, Any, Dict[str, Any]]] = None
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.replays = 0
        self.spec_replays = 0
        self.capture_s: Dict[Tuple[str, int, bool], float] = {}
        self.last_key = ""                   # the last graph captured

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
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        s = self._stream
        rows = self._rows_buffer(B)
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            trash_rows = torch.full_like(rows, self.trash)
            ctr = ctl["ctr"].clone()
            fn(params, cache, ctl, trash_rows, stochastic)
            ctl["ctr"].copy_(ctr)
        pa.take_recorded()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=s,
                              capture_error_mode="thread_local"):
            _, _, out = fn(params, cache, ctl, rows, stochastic)
        torch.cuda.current_stream(self.device).wait_stream(s)
        entry = (graph, out, pa.take_recorded())
        kind = "spec" if spec else "decode"
        key = (kind, B, stochastic)
        self._graphs[key] = entry
        self.capture_s[key] = time.perf_counter() - t0
        self.last_key = f"{kind}_window:B={B}:stochastic={int(stochastic)}"
        return entry

    def pool_bytes(self) -> int:
        """Device bytes of the segments in the graphs' shared pool."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def __call__(self, params, cache, ctl, slot_rows: torch.Tensor,
                 stochastic: bool, spec: bool = False):
        if not self.graphed:
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




def make_kv_ops(eng: EngineConfig):
    """(extract, inject) block gather/scatter over the paged cache.

    extract(cache, block_ids[N]) -> {"k","v"}: [L, N, KV, bs, hd]
    (plus {"ks","vs"}: [L, N, KV, bs] when the cache is quantized), new
    tensors on the cache's device;
    inject(cache, block_ids[N], data) -> cache, the same object, each layer
    written in place with ``index_copy_`` (``data`` on the cache's device).
    Pad ids name the trash block 0: pads gather it and scatter into it.
    """
    keys = cache_payload_keys(eng)

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
