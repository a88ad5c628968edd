"""The analytic FLOPs/parameter model of the flight recorder
(``observability/stepstats.py``), and the card's peak rates.

A copy of ``dynamo_tpu.observability.flops`` for the port's dense models
(the MoE terms come with the MoE slice). Two terms per processed token:

* **matmul**: ``2 * n_active_params`` — every weight participates in one
  multiply-accumulate per token (2 FLOPs/MAC). The embedding *lookup* is
  excluded (it is a gather, not a matmul); the lm_head projection is
  included.
* **attention**: ``4 * num_layers * num_heads * head_dim * context`` —
  the QK^T scores plus the PV mix, both ``num_heads * head_dim * context``
  MACs per query token.

Peak rates per card come from NVIDIA's public H100 data sheet (dense,
without sparsity); the JAX package's TPU rows are not copied.
"""

from __future__ import annotations

# Peak dense bf16 FLOP/s per card by device name (public data sheet).
PEAK_FLOPS = {
    "h100": 989.4e12,        # H100 SXM ("NVIDIA H100 80GB HBM3")
    "h100 pcie": 756e12,
}
# Peak dense 8-bit OP/s: int8 and fp8 run at the same tensor-core rate.
PEAK_FLOPS_INT8 = {
    "h100": 1978.9e12,
    "h100 pcie": 1513e12,
}
PEAK_FLOPS_FP8 = PEAK_FLOPS_INT8
# float32 outside the tensor cores (the port leaves TF32 off)
PEAK_FLOPS_F32 = {
    "h100": 66.9e12,
    "h100 pcie": 51.2e12,
}
DEFAULT_PEAK = PEAK_FLOPS["h100"]
DEFAULT_PEAK_INT8 = PEAK_FLOPS_INT8["h100"]
DEFAULT_PEAK_F32 = PEAK_FLOPS_F32["h100"]
CPU_PEAK = 1e12        # nominal, so CPU MFU fields stay defined


def peak_flops(device_name: str, platform: str,
               dtype: str = "bfloat16") -> float:
    """Per-card peak FLOP/s for a device name string (e.g.
    ``torch.cuda.get_device_name()``, ``"NVIDIA H100 80GB HBM3"``).

    Longest-key match over the table; unknown CUDA names fall back to the
    H100 SXM numbers, other platforms to the nominal CPU peak.
    ``"int8"``/``"fp8"`` select the 8-bit table (quantized weights run
    their matmuls against that roofline), ``"float32"`` the CUDA-core
    table."""
    if platform != "cuda":
        return CPU_PEAK
    kind = (device_name or "").lower()
    if dtype in ("int8", "fp8", "float8_e4m3fn"):
        table, peak = PEAK_FLOPS_INT8, DEFAULT_PEAK_INT8
    elif dtype in ("float32", "f32"):
        table, peak = PEAK_FLOPS_F32, DEFAULT_PEAK_F32
    else:
        table, peak = PEAK_FLOPS, DEFAULT_PEAK
    for key in sorted(table, key=len, reverse=True):
        if key in kind:
            peak = table[key]
            break
    return peak


def param_count(cfg) -> int:
    """Exact parameter count of ``engine.model.init_params`` for a
    ModelConfig."""
    hd = cfg.head_dim_
    D, H, KV, F, L, V = (
        cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
        cfg.intermediate_size, cfg.num_layers, cfg.vocab_size,
    )
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D   # wq, wk, wv, wo
    mlp = 3 * D * F
    per_layer = attn + mlp + 2 * D                      # + the two norms
    total = V * D + L * per_layer + D                   # embed + final_norm
    if not cfg.tie_word_embeddings:
        total += D * V
    return total


def active_param_count(cfg) -> int:
    """Parameters doing matmul work per token: the full count minus the
    embedding table (gather, not matmul)."""
    D, V = cfg.hidden_size, cfg.vocab_size
    active = param_count(cfg) - V * D
    if cfg.tie_word_embeddings:
        # the tied table still runs as the lm_head matmul
        active += D * V
    return active


class FlopsModel:
    """Per-step forward-FLOPs estimator for one ModelConfig.

    ``step_flops(tokens, context_sum)`` = matmul term + attention term,
    where ``context_sum`` is the sum over the step's tokens of the context
    length each token attends (position + 1)."""

    def __init__(self, model_cfg):
        self.model_cfg = model_cfg
        self.n_params = param_count(model_cfg)
        self.n_active_params = active_param_count(model_cfg)
        self.matmul_per_token = 2.0 * self.n_active_params
        # QK^T + PV: 2 matmuls of (num_heads*head_dim x context) per token
        self.attn_coef = (4.0 * model_cfg.num_layers * model_cfg.num_heads
                          * model_cfg.head_dim_)

    def step_flops(self, tokens: float, context_sum: float) -> float:
        return self.matmul_per_token * tokens + self.attn_coef * context_sum

    def sequence_context_sum(self, length: int, start: int = 0) -> int:
        """Sum of (position + 1) over positions [start, start+length) —
        the ``context_sum`` of prefilling those tokens causally."""
        if length <= 0:
            return 0
        return length * start + length * (length + 1) // 2

    def sequence_flops(self, isl: int, osl: int) -> float:
        """Total forward FLOPs to serve one (isl, osl) request: prefill
        the prompt plus decode osl tokens, attention term included."""
        total = isl + osl
        return self.step_flops(total, self.sequence_context_sum(total))
