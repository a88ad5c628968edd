"""Model + engine configuration.

A copy of ``dynamo_tpu.engine.config``. ``ModelConfig`` describes a
Llama-class decoder-only transformer (the shapes cover Llama 2/3 and
TinyLlama-style test models). ``EngineConfig`` carries the serving-side knobs
that the reference exposes through engine flags and the ModelRuntimeConfig
(ref: lib/llm/src/local_model/runtime_config.rs:9 — ``total_kv_blocks``,
``max_num_seqs``, ``max_num_batched_tokens``).

The engine config keeps the knobs this package serves, plus the ones that
select a path it does not serve yet (a mesh of more than one device,
pipeline and sequence parallelism): those stay so that
:func:`check_supported` refuses them loudly at engine construction instead
of ignoring them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Dense Llama-class decoder-only transformer shapes (the JAX
    package's MoE fields wait for the MoE slice)."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position: int = 8192
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    # -- canned configs ---------------------------------------------------

    @staticmethod
    def llama3_8b() -> "ModelConfig":
        return ModelConfig()

    @staticmethod
    def llama3_1b() -> "ModelConfig":
        """Llama-3.2-1B shapes — fits one card comfortably."""
        return ModelConfig(
            hidden_size=2048, intermediate_size=8192, num_layers=16,
            num_heads=32, num_kv_heads=8, head_dim=64,
            tie_word_embeddings=True,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "ModelConfig":
        """CPU-testable toy config."""
        return ModelConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
            max_position=512, rope_theta=10000.0, dtype="float32",
        )


ATTENTION_IMPLS = ("kernel", "einsum")


@dataclass(frozen=True)
class EngineConfig:
    """Serving-side engine knobs (vLLM-equivalent semantics)."""

    block_size: int = 16                # tokens per KV block
    num_blocks: int = 2048              # total KV blocks in device memory
    max_num_seqs: int = 64              # max concurrently running sequences
    max_num_batched_tokens: int = 512   # per-step token budget (chunked prefill)
    watermark: float = 0.01             # min free-block fraction before admit
    max_model_len: int = 8192           # max tokens per sequence
    enable_prefix_caching: bool = True
    # decode batch sizes are padded up to the nearest bucket so the step
    # functions see a handful of shapes, not one per batch size
    decode_buckets: Tuple[int, ...] = (8, 16, 32, 64)
    # prefill chunk lengths likewise bucketed (powers of two)
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    # (dp, tp) or (dp, fsdp, tp) mesh axis sizes; only one device is served
    mesh_shape: Tuple[int, ...] = (1, 1)
    # attention implementation: "kernel" runs the paged-attention kernel
    # (ops/paged_attention.py: CUDA on a card, its plain version on the
    # CPU); "einsum" materialises the gathered context
    attention_impl: str = "kernel"
    # per-shape-class overrides ("" = inherit attention_impl)
    attention_impl_decode: str = ""
    attention_impl_spec: str = ""
    attention_impl_prefill: str = ""
    # chunked prefill: cap each prefill chunk at this many tokens so long
    # prompts are admitted in slices interleaved with running decodes.
    # 0 = off (chunks capped only by the largest prefill bucket).
    prefill_chunk_tokens: int = 0
    # tokens generated per decode window (>1 chains steps on device; tokens
    # past a sequence's EOS/capacity inside a window are discarded)
    decode_steps: int = 1
    # speculative decoding: "ngram" replaces each decode window with a
    # draft+verify window — a device-resident prompt-lookup drafter proposes
    # up to spec_k continuation tokens from the seq's own on-device token
    # history and ONE ragged [B, k+1] forward verifies them, so a single
    # host round-trip can land up to k+1 tokens. Greedy rows get exact
    # parity with spec_mode="off"; sampled rows emit 1 token per window.
    spec_mode: str = "off"              # "off" | "ngram"
    spec_k: int = 4                     # max draft tokens per window
    spec_ngram_min: int = 1             # smallest suffix n-gram to match
    spec_ngram_max: int = 3             # largest suffix n-gram to match
    # adaptive kill switch: once spec_auto_disable_window draft tokens have
    # been verified, an acceptance rate below the threshold permanently
    # falls back to plain autopilot windows (0.0 = never disable)
    spec_auto_disable_threshold: float = 0.0
    spec_auto_disable_window: int = 256
    # device token-history capacity per seat (0 = max_model_len); drafting
    # only sees the first spec_hist_cap positions of each sequence
    spec_hist_cap: int = 0
    # run-ahead: how many scheduled windows may be in flight before the
    # engine loop waits for a landing. >1 dispatches window N+1 (decode
    # input tokens read from the device ring) while window N's sampled
    # tokens are still being copied to the host, so the fetch never sits
    # on the dispatch path. 1 = the synchronous loop.
    pipeline_depth: int = 2
    # decode block lookahead: best-effort extra blocks reserved past each
    # window so control-state table deltas amortise over
    # lookahead*block_size tokens instead of per-block
    block_lookahead: int = 0
    # engine stall watchdog: a dispatched window whose results don't land
    # within stall_timeout_s + stall_timeout_per_token_s * real tokens is
    # declared wedged — the window is cancelled, its shape class
    # quarantined, and its seats recovered by recompute. 0 = watchdog off.
    stall_timeout_s: float = 0.0
    stall_timeout_per_token_s: float = 0.0
    # per-seat recompute retries after a stall before the seat errors out
    stall_seq_retries: int = 2
    # consecutive stalled windows before the worker declares itself dead
    # (aborts every seat so drain + Migration take over)
    stall_dead_threshold: int = 3
    # HBM-pressure ladder: graduated response to KV pool occupancy,
    # engaged per rung when usage crosses its threshold (0.0 = rung off).
    # rung 1: spill the coldest pending-free seat (recompute preemption);
    # rung 2: pause speculative windows; rung 3: shed new admissions until
    # pressure releases.
    pressure_spill_threshold: float = 0.0
    pressure_spec_threshold: float = 0.0
    pressure_shed_threshold: float = 0.0
    # hysteresis: a rung releases once usage < threshold - pressure_release
    pressure_release: float = 0.05
    # quantized serving (engine/quant.py): "bf16" keeps the model dtype end
    # to end; "int8"/"fp8" store matmul weights / KV pages in 1 byte with
    # f32 scales
    weight_dtype: str = "bf16"          # "bf16" | "int8" | "fp8"
    kv_dtype: str = "bf16"              # "bf16" | "int8" | "fp8"
    # -- paths not served by this package yet (check_supported refuses) --
    pp_stages: int = 1
    sp_prefill_threshold: int = 0

    def __post_init__(self):
        if len(self.mesh_shape) not in (2, 3):
            raise ValueError("mesh_shape must be (dp, tp) or (dp, fsdp, tp)")
        if self.max_num_seqs > max(self.decode_buckets):
            raise ValueError("max_num_seqs exceeds largest decode bucket")
        if self.spec_mode not in ("off", "ngram"):
            raise ValueError(f"unknown spec_mode {self.spec_mode!r}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}"
            )
        for cls in ("decode", "spec", "prefill"):
            v = getattr(self, f"attention_impl_{cls}")
            if v not in ("",) + ATTENTION_IMPLS:
                raise ValueError(
                    f"unknown attention_impl_{cls} {v!r}"
                )
        if self.prefill_chunk_tokens < 0:
            raise ValueError("prefill_chunk_tokens must be >= 0")
        if self.spec_mode != "off":
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if not (1 <= self.spec_ngram_min <= self.spec_ngram_max):
                raise ValueError("need 1 <= spec_ngram_min <= spec_ngram_max")
            if self.pp_stages > 1:
                raise ValueError("spec_mode requires pp_stages == 1")
        if self.stall_timeout_s < 0 or self.stall_timeout_per_token_s < 0:
            raise ValueError("stall timeouts must be >= 0")
        if self.stall_seq_retries < 0:
            raise ValueError("stall_seq_retries must be >= 0")
        if self.stall_dead_threshold < 1:
            raise ValueError("stall_dead_threshold must be >= 1")
        for rung in ("spill", "spec", "shed"):
            v = getattr(self, f"pressure_{rung}_threshold")
            if not (0.0 <= v <= 1.0):
                raise ValueError(
                    f"pressure_{rung}_threshold must be in [0, 1]"
                )
        if self.pressure_release < 0:
            raise ValueError("pressure_release must be >= 0")
        for knob in ("weight_dtype", "kv_dtype"):
            v = getattr(self, knob)
            if v not in ("bf16", "int8", "fp8"):
                raise ValueError(
                    f"unknown {knob} {v!r} (expected bf16|int8|fp8)"
                )
        if (self.weight_dtype != "bf16" or self.kv_dtype != "bf16") \
                and self.pp_stages > 1:
            raise ValueError("quantized serving requires pp_stages == 1")
        # max_num_batched_tokens MAY exceed the largest prefill bucket:
        # the scheduler caps each chunk at the bucket, so extra budget
        # just lets decode seats coexist with a full-bucket prefill

    @property
    def max_blocks_per_seq(self) -> int:
        return (self.max_model_len + self.block_size - 1) // self.block_size


def check_supported(eng: EngineConfig) -> None:
    """Refuse, at engine construction, every path this package does not
    serve yet (each is still served by the JAX package)."""
    mesh_devices = 1
    for n in eng.mesh_shape:
        mesh_devices *= n
    unsupported = [
        (mesh_devices > 1, f"mesh_shape={eng.mesh_shape!r}"),
        (eng.pp_stages > 1, f"pp_stages={eng.pp_stages}"),
        (eng.sp_prefill_threshold > 0,
         f"sp_prefill_threshold={eng.sp_prefill_threshold}"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not served by dynamo_tpu_torch yet"
            )
