"""A plain PyTorch Mistral / Mixtral block, written from the published
equations (the Mistral 7B and Mixtral of Experts papers, arXiv:2310.06825
and arXiv:2401.04088, and the models' ``config.json``): pre-norm decoder
layers with RMSNorm, rotary position embeddings (rotate-half, base
``rope_theta``), grouped-query causal attention, and a SwiGLU FFN, dense
or a top-k mixture of experts routed as published: softmax over the
router's logits, the k largest kept and renormalised, no capacity limit.

Float32 on float32 weights, one whole sequence at a time, no cache. It
imports nothing of the program. The weights are the tree the benchmark
made from the seed (``arch/mistral.py`` ``leaf_shapes``), read as
``x @ w``. ``reference/model.py`` drives it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd]; HF rotate-half convention."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv[None]                 # [T, hd/2]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def _attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal softmax attention; q [T, H, hd], k/v [T, KV, hd]."""
    T, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)    # [H, T, hd]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    scale = hd ** -0.5
    for s in range(0, T, block):
        e = min(T, s + block)
        sc = torch.einsum("qhd,hkd->hqk", q[s:e], k[:, :e]) * scale
        mask = torch.arange(e, device=q.device)[None, :] \
            > torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[s:e] = torch.einsum("hqk,hkd->qhd", sc.softmax(-1), v[:, :e])
    return out


def _moe(x: torch.Tensor, w: Dict[str, torch.Tensor],
         top_k: int) -> torch.Tensor:
    """Top-k routed SwiGLU experts over x [T, D], dropless."""
    probs = (x @ w["w_router"]).softmax(-1)                # [T, E]
    vals, idx = probs.topk(top_k, dim=-1)
    vals = vals / vals.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(w["w_gate"].shape[0]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        ye = (F.silu(xe @ w["w_gate"][e]) * (xe @ w["w_up"][e])) \
            @ w["w_down"][e]
        out.index_add_(0, rows, ye * vals[rows, slot][:, None])
    return out


def _heads(cfg):
    heads = cfg["num_attention_heads"]
    return (heads, cfg.get("num_key_value_heads", heads),
            cfg.get("head_dim") or cfg["hidden_size"] // heads)


# the matmul weights of a layer; its norms and the router are not
MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def num_layers(cfg: Dict) -> int:
    return cfg["num_hidden_layers"]


def embedding(params: Dict, cfg: Dict, ids: torch.Tensor) -> torch.Tensor:
    """Float32 rows ``[T, D]`` of the token ids ``ids``."""
    return params["embed"][ids].float()


def layer_weights(params: Dict, cfg: Dict,
                  li: int) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s weights, widened to float32."""
    return {name: leaf[li].float()
            for name, leaf in params["layers"].items()}


def layer(h: torch.Tensor, w: Dict[str, torch.Tensor],
          cfg: Dict) -> torch.Tensor:
    """One decoder layer over one whole sequence ``h`` [T, D]."""
    heads, kv_heads, hd = _heads(cfg)
    T = h.shape[0]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    pos = torch.arange(T, device=h.device)
    x = _rms_norm(h, w["attn_norm"], eps)
    q = _rope((x @ w["wq"]).view(T, heads, hd), pos, theta)
    k = _rope((x @ w["wk"]).view(T, kv_heads, hd), pos, theta)
    v = (x @ w["wv"]).view(T, kv_heads, hd)
    h = h + _attention(q, k, v).reshape(T, heads * hd) @ w["wo"]
    x = _rms_norm(h, w["mlp_norm"], eps)
    if cfg.get("num_local_experts", 0):
        return h + _moe(x, w, cfg["num_experts_per_tok"])
    return h + (F.silu(x @ w["w_gate"]) * (x @ w["w_up"])) @ w["w_down"]


def output_norm(h: torch.Tensor, params: Dict, cfg: Dict) -> torch.Tensor:
    return _rms_norm(h, params["final_norm"].float(), cfg["rms_norm_eps"])


def head(params: Dict, cfg: Dict) -> torch.Tensor:
    """The LM head ``[D, V]`` in float32 (the embedding's transpose where
    the two are tied)."""
    return (params["embed"].T if cfg.get("tie_word_embeddings")
            else params["lm_head"]).float()
