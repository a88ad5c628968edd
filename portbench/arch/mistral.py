"""The Mistral block (``model_type`` ``mistral``; Mixtral re-exports it):
its sizes, the ``ModelConfig`` the port serves it with, its weight leaves,
and its frozen arithmetic.

The FLOP model is the one the port's flight recorder uses (2 FLOPs per
multiply-accumulate of every active weight, plus QK^T and PV over the
attended context), copied here so that no later change to the program
moves the yardstick. The attention bytes follow the kernel table's bound:
each input byte read once, each output byte written once, only what the
real tokens need (padding and trash blocks are not counted).

Everything here takes a :class:`Shapes` built from a configuration file,
never from the program's config objects. The counts assume a pre-norm
decoder whose every layer attends its whole context, a dense SwiGLU FFN or
``top_k`` routed experts of one width (no shared expert, a router as wide
as the experts held), and the whole vocabulary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple


@dataclass(frozen=True)
class Shapes:
    vocab: int
    hidden: int
    ffn: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    experts: int = 0        # 0 = dense
    top_k: int = 0
    tied: bool = False
    elem_bytes: int = 2     # bytes of one KV / activation element (bf16)


def shapes(c: dict) -> Shapes:
    heads = c["num_attention_heads"]
    return Shapes(
        vocab=c["vocab_size"], hidden=c["hidden_size"],
        ffn=c["intermediate_size"], layers=c["num_hidden_layers"],
        heads=heads, kv_heads=c.get("num_key_value_heads", heads),
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        experts=c.get("num_local_experts", 0),
        top_k=c.get("num_experts_per_tok", 0),
        tied=bool(c.get("tie_word_embeddings", False)),
        elem_bytes=4 if c.get("torch_dtype") == "float32" else 2,
    )


def model_config(c: dict, ModelConfig):
    heads = c["num_attention_heads"]
    extra = ({"moe_capacity_factor": float(c["moe_capacity_factor"])}
             if "moe_capacity_factor" in c else {})
    return ModelConfig(**extra,
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"], num_heads=heads,
        num_kv_heads=c.get("num_key_value_heads", heads),
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        rope_theta=float(c["rope_theta"]), rms_norm_eps=c["rms_norm_eps"],
        max_position=c["engine"]["max_model_len"],
        tie_word_embeddings=bool(c.get("tie_word_embeddings", False)),
        dtype=c.get("torch_dtype", "bfloat16"),
        num_experts=c.get("num_local_experts", 0),
        num_experts_per_token=c.get("num_experts_per_tok", 0),
    )


def leaf_shapes(s: Shapes) -> Iterator[Tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every leaf, in draw order; fan_in 0 marks a
    norm weight. Names under ``layers/`` are the stacked per-layer leaves."""
    D, F, L, E = s.hidden, s.ffn, s.layers, s.experts
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    yield "embed", (s.vocab, D), D
    yield "layers/attn_norm", (L, D), 0
    yield "layers/wq", (L, D, q), D
    yield "layers/wk", (L, D, kv), D
    yield "layers/wv", (L, D, kv), D
    yield "layers/wo", (L, q, D), q
    yield "layers/mlp_norm", (L, D), 0
    if E:
        yield "layers/w_router", (L, D, E), D
        yield "layers/w_gate", (L, E, D, F), D
        yield "layers/w_up", (L, E, D, F), D
        yield "layers/w_down", (L, E, F, D), F
    else:
        yield "layers/w_gate", (L, D, F), D
        yield "layers/w_up", (L, D, F), D
        yield "layers/w_down", (L, F, D), F
    yield "final_norm", (D,), 0
    if not s.tied:
        yield "lm_head", (D, s.vocab), D


def layer_active_params(s: Shapes) -> int:
    """Weights one token multiplies by in one layer: q, k, v, o, and the
    dense FFN or the router plus its ``top_k`` experts. Norms are not
    matmuls and are left out."""
    attn = s.hidden * s.heads * s.head_dim * 2 \
        + s.hidden * s.kv_heads * s.head_dim * 2
    if s.experts:
        ffn = s.hidden * s.experts + s.top_k * 3 * s.hidden * s.ffn
    else:
        ffn = 3 * s.hidden * s.ffn
    return attn + ffn


def active_params(s: Shapes) -> int:
    """Weights one token multiplies by in the whole model: every layer and
    the LM head (the embedding is a lookup, not a matmul)."""
    return s.layers * layer_active_params(s) + s.hidden * s.vocab


def token_flops(s: Shapes) -> float:
    """Matmul FLOPs of one token, attention over its context aside."""
    return 2.0 * active_params(s)


def attn_flops(s: Shapes, context_sum: float) -> float:
    """QK^T and PV over the attended context, all layers: 4 FLOPs per
    (query head, head element, key) per layer."""
    return 4.0 * s.layers * s.heads * s.head_dim * context_sum


def step_flops(s: Shapes, rec) -> float:
    """Useful FLOPs of one landed step (a ``StepRecord``): its
    ``real_tokens`` real tokens, whose attended contexts sum to
    ``context_sum``."""
    return token_flops(s) * rec.real_tokens + attn_flops(s, rec.context_sum)


def attn_launch_bytes(s: Shapes, queries: int, keys: int) -> float:
    """Bytes one layer's attention launch needs for ``queries`` real query
    rows over ``keys`` distinct cached keys (summed over the rows of a
    batch): K and V of every key, the queries in and the outputs out."""
    e = s.elem_bytes
    kv = 2.0 * keys * s.kv_heads * s.head_dim * e
    qo = 2.0 * queries * s.heads * s.head_dim * e
    return kv + qo


def launch_bound_s(s: Shapes, peaks: dict, queries: int, keys: int,
                   context_sum: float) -> float:
    """The least time ONE layer's launch could take on the card: the larger
    of its bytes over the HBM rate and its FLOPs over the bf16 peak."""
    flops = 4.0 * s.heads * s.head_dim * context_sum
    return max(attn_launch_bytes(s, queries, keys) / peaks["hbm_bytes_s"],
               flops / peaks["bf16_flops"])


def attn_bound_s(s: Shapes, peaks: dict, rec) -> float:
    """The least time one layer's attention launch of this step could
    take: decode rows read their contexts, a prefill chunk its own."""
    if rec.kind == "prefill":
        n = rec.real_tokens
        start = (rec.context_sum - n * (n + 1) // 2) // n
        return launch_bound_s(s, peaks, n, start + n, rec.context_sum)
    return launch_bound_s(s, peaks, rec.live_rows, rec.context_sum,
                          rec.context_sum)
