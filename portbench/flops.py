"""The benchmark's frozen arithmetic: model FLOPs per token, the operations
and bytes an attention launch needs, and the card's published peaks.

The FLOP model is the one the port's flight recorder uses (2 FLOPs per
multiply-accumulate of every active weight, plus QK^T and PV over the
attended context), copied here so that no later change to the program
moves the yardstick. The attention bytes follow the kernel table's bound:
each input byte read once, each output byte written once, only what the
real tokens need (padding and trash blocks are not counted).

Everything here takes a :class:`Shapes` built from a configuration file,
never from the program's config objects.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# Published peaks of one card (NVIDIA data sheet, dense, no sparsity), by a
# lower-case substring of ``torch.cuda.get_device_name()``. Only the SXM
# part is listed: an unknown card gets no peak, and the metrics that need
# one are left out of the result.
PEAKS = {
    "h100 80gb hbm3": {"bf16_flops": 989.4e12, "hbm_bytes_s": 3.35e12},
}


def card_peaks(device_name: str) -> Optional[dict]:
    kind = (device_name or "").lower()
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None


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

    @staticmethod
    def from_config(c: dict) -> "Shapes":
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


def step_flops(s: Shapes, tokens: float, context_sum: float) -> float:
    """Useful FLOPs of ``tokens`` real tokens whose attended contexts sum
    to ``context_sum``."""
    return token_flops(s) * tokens + attn_flops(s, context_sum)


def prefill_context_sum(start: int, length: int) -> int:
    """Sum over a causal chunk's positions of the context each attends."""
    return length * start + length * (length + 1) // 2


def attn_launch_bytes(s: Shapes, queries: int, keys: int) -> float:
    """Bytes one layer's attention launch needs for ``queries`` real query
    rows over ``keys`` distinct cached keys (summed over the rows of a
    batch): K and V of every key, the queries in and the outputs out."""
    e = s.elem_bytes
    kv = 2.0 * keys * s.kv_heads * s.head_dim * e
    qo = 2.0 * queries * s.heads * s.head_dim * e
    return kv + qo


def attn_bound_s(s: Shapes, peaks: dict, queries: int, keys: int,
                 context_sum: float) -> float:
    """The least time ONE layer's launch could take on the card: the larger
    of its bytes over the HBM rate and its FLOPs over the bf16 peak."""
    flops = 4.0 * s.heads * s.head_dim * context_sum
    return max(attn_launch_bytes(s, queries, keys) / peaks["hbm_bytes_s"],
               flops / peaks["bf16_flops"])
