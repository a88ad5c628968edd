"""A plain PyTorch Mistral / Mixtral forward, written from the published
equations (the Mistral 7B and Mixtral of Experts papers, arXiv:2310.06825
and arXiv:2401.04088, and the models' ``config.json``): pre-norm decoder
layers with RMSNorm, rotary position embeddings (rotate-half, base
``rope_theta``), grouped-query causal attention, and a SwiGLU FFN, dense
or a top-k mixture of experts routed as published: softmax over the
router's logits, the k largest kept and renormalised, no capacity limit.

Float32 throughout, TF32 off, no cache and no batching: each sequence runs
whole, one layer at a time for all sequences, so one layer's weights are
widened to float32 once. It imports nothing of the program. The weights are
the tree the benchmark made from the seed (``portbench/weights.py``), read
as ``x @ w``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

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


def _layer(h: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict,
           heads: int, kv_heads: int, hd: int) -> torch.Tensor:
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


# the matmul weights; norms, the embedding and the router are not
MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """A float32 weight ``[..., in, out]`` rounded through float8 e4m3
    with one scale per output channel (amax over ``in`` mapped to 448)."""
    s = w.abs().amax(dim=-2, keepdim=True) / 448.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return (w / s).to(torch.float8_e4m3fn).float() * s


def served_logit_gaps(params: Dict, cfg: Dict, seqs: Sequence[tuple],
                      lowp=None):
    """For each (prompt ids, served ids): at every served position, how far
    the served token's logit lies below the best logit, in float32 ``[n]``.
    The sequence run is the prompt followed by the served tokens but the
    last; position ``P - 1 + i`` predicts served token ``i``.

    With ``lowp`` (a function of a float32 matmul weight, such as
    :func:`fp8_weights`) it returns a second list too: at the same
    positions, the gap of the token that the reference computed with
    ``lowp`` weights puts first (the control of the comparison)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _gaps(params, cfg, seqs, lowp)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _heads(cfg):
    heads = cfg["num_attention_heads"]
    return (heads, cfg.get("num_key_value_heads", heads),
            cfg.get("head_dim") or cfg["hidden_size"] // heads)


def _head(params, cfg) -> torch.Tensor:
    return (params["embed"].T if cfg.get("tie_word_embeddings")
            else params["lm_head"]).float()


@torch.no_grad()
def logits(params: Dict, cfg: Dict, ids: torch.Tensor) -> torch.Tensor:
    """Float32 logits ``[T, V]`` of one whole sequence."""
    heads, kv_heads, hd = _heads(cfg)
    h = params["embed"][ids].float()
    for li in range(cfg["num_hidden_layers"]):
        w = {n: leaf[li].float() for n, leaf in params["layers"].items()}
        h = _layer(h, w, cfg, heads, kv_heads, hd)
    h = _rms_norm(h, params["final_norm"].float(), cfg["rms_norm_eps"])
    return h @ _head(params, cfg)


@torch.no_grad()
def _gaps(params, cfg, seqs, lowp):
    heads, kv_heads, hd = _heads(cfg)
    embed = params["embed"]
    dev = embed.device
    ids = [torch.tensor(list(p) + list(s[:-1]), device=dev) for p, s in seqs]
    chains = [[embed[t].float() for t in ids]]
    if lowp is not None:
        chains.append([h.clone() for h in chains[0]])
    layers = params["layers"]
    for li in range(cfg["num_hidden_layers"]):
        w = {name: leaf[li].float() for name, leaf in layers.items()}
        chains[0] = [_layer(h, w, cfg, heads, kv_heads, hd)
                     for h in chains[0]]
        if lowp is not None:
            w = {k: lowp(v) if k in MATMULS else v for k, v in w.items()}
            chains[1] = [_layer(h, w, cfg, heads, kv_heads, hd)
                         for h in chains[1]]
        del w
    head = _head(params, cfg)
    heads_ = [head] + ([lowp(head)] if lowp is not None else [])
    norm = params["final_norm"].float()
    eps = cfg["rms_norm_eps"]
    gaps, control = [], []
    for i, (p, s) in enumerate(seqs):
        rows = _rms_norm(chains[0][i][len(p) - 1:], norm, eps)
        low = (_rms_norm(chains[1][i][len(p) - 1:], norm, eps)
               if lowp is not None else None)
        served = torch.tensor(list(s), device=dev)
        out, out_c = [], []
        for b in range(0, rows.shape[0], 1024):
            lg = rows[b:b + 1024] @ head
            best = lg.max(-1).values
            tok = served[b:b + 1024]
            out.append(best - lg.gather(1, tok[:, None])[:, 0])
            if low is not None:
                first = (low[b:b + 1024] @ heads_[1]).argmax(-1)
                out_c.append(best - lg.gather(1, first[:, None])[:, 0])
        gaps.append(torch.cat(out))
        if low is not None:
            control.append(torch.cat(out_c))
    return (gaps, control) if lowp is not None else gaps
