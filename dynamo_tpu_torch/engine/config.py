"""Model + engine configuration.

A copy of ``dynamo_tpu.engine.config``. ``ModelConfig`` describes a
Llama-class decoder-only transformer (the shapes cover Llama 2/3 and
TinyLlama-style test models). ``EngineConfig`` carries the serving-side knobs
that the reference exposes through engine flags and the ModelRuntimeConfig
(ref: lib/llm/src/local_model/runtime_config.rs:9 — ``total_kv_blocks``,
``max_num_seqs``, ``max_num_batched_tokens``).

Attention tiles (``attention_tile_{decode,spec,prefill}``, filled by
``engine/autotune.py``'s sweep or set by hand; ``(0, 0)`` = the kernel's
defaults) name the CUDA kernel's launch parameters, not the Pallas
kernel's ``(q_tile, kv_tile)``:

- ragged classes (spec, prefill): ``(q_tile, kv_chunk)`` — query slots per
  block of the ragged face (its default ``64 // G``, capped at the chunk
  length) and keys per staged chunk (64 or 128; the default is 64 for bf16
  pages, 128 for 1-byte pages);
- decode class: ``(0, n_split)`` — the decode face's split count (its
  default fills the card once, ``ops/paged_attention.py`` ``_decode_grid``).

The engine config keeps the knobs this package serves, plus the ones that
select a path it does not serve yet (an sp prefill over a seq column that
is not a power of two): those stay so that :func:`check_supported`
refuses them loudly at engine construction instead of ignoring them. A
``(dp, tp)`` or ``(dp, fsdp, tp)`` mesh and ``pp_stages`` pipeline stages
are served: one engine per rank of a ``torch.distributed`` world
(``parallel/multihost.py``; a pp engine's stages are its ranks,
``parallel/pp_serving.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Llama-class decoder-only transformer shapes, dense or MoE."""

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
    # MoE (0 experts = dense). Mixtral-class models set these.
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_capacity_factor: float = 2.0

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    # -- canned configs ---------------------------------------------------

    @staticmethod
    def llama3_8b() -> "ModelConfig":
        return ModelConfig()

    @staticmethod
    def llama3_70b() -> "ModelConfig":
        return ModelConfig(
            hidden_size=8192, intermediate_size=28672, num_layers=80,
            num_heads=64, num_kv_heads=8,
        )

    @staticmethod
    def llama3_1b() -> "ModelConfig":
        """Llama-3.2-1B shapes — fits one card comfortably."""
        return ModelConfig(
            hidden_size=2048, intermediate_size=8192, num_layers=16,
            num_heads=32, num_kv_heads=8, head_dim=64,
            tie_word_embeddings=True,
        )

    @staticmethod
    def mixtral_8x7b() -> "ModelConfig":
        """Mixtral-class MoE shapes (8 experts, top-2 routing)."""
        return ModelConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8,
            rope_theta=1e6, num_experts=8, num_experts_per_token=2,
        )

    @staticmethod
    def tiny_moe(vocab_size: int = 512) -> "ModelConfig":
        """CPU-testable MoE toy (8 experts, top-2)."""
        return ModelConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
            max_position=512, rope_theta=10000.0, dtype="float32",
            num_experts=8, num_experts_per_token=2,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "ModelConfig":
        """CPU-testable toy config."""
        return ModelConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
            max_position=512, rope_theta=10000.0, dtype="float32",
        )


ATTENTION_IMPLS = ("kernel", "einsum", "auto")
# what a shape class resolves to ("auto" is resolved per class at startup)
CLASS_IMPLS = ("kernel", "einsum")
# keys per staged chunk the ragged face is built for (0 = its default)
KV_CHUNKS = (0, 64, 128)


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
    # (dp, tp) or (dp, fsdp, tp) mesh axis sizes; (1, tp) is served, one
    # rank per process (parallel/multihost.py)
    mesh_shape: Tuple[int, ...] = (1, 1)
    # attention implementation: "kernel" runs the paged-attention kernel
    # (ops/paged_attention.py: CUDA on a card, its plain version on the
    # CPU); "einsum" materialises the gathered context; "auto" times both
    # per shape class at engine startup (engine/autotune.py)
    attention_impl: str = "kernel"
    # per-shape-class overrides ("" = inherit attention_impl)
    attention_impl_decode: str = ""
    attention_impl_spec: str = ""
    attention_impl_prefill: str = ""
    # per-shape-class launch parameters of the CUDA kernel (module
    # docstring): (q_tile, kv_chunk) for spec/prefill, (0, n_split) for
    # decode; (0, 0) = the kernel's defaults. engine/autotune.py's sweep
    # fills them with the fastest candidate that passed its numeric gate
    # (persisted across runs via DYNTPU_AUTOTUNE_CACHE)
    attention_tile_decode: Tuple[int, int] = (0, 0)
    attention_tile_spec: Tuple[int, int] = (0, 0)
    attention_tile_prefill: Tuple[int, int] = (0, 0)
    # adaptive bucket ladders (engine/ladder.py): split hot decode/prefill
    # buckets and retire cold ones from the flight recorder's per-bucket
    # occupancy, under ladder_compile_budget extra rungs per ladder. Off by
    # default: static buckets stay fully deterministic
    adaptive_buckets: bool = False
    # max rungs each ladder may ADD over its lifetime; bounds the decode
    # graphs captured after warm-up (one per new rung and sampling mode)
    ladder_compile_budget: int = 4
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
    # sequence-parallel prefill: on a mesh of more than one rank, a fresh
    # prompt at least this long is prefilled as ONE chunk with its T axis
    # split over the dp rows (ring attention over the dp column,
    # engine/model.py), so a long prompt need not fit one rank's prefill
    # budget. 0 = disabled (chunked prefill)
    sp_prefill_threshold: int = 0
    # pipeline parallelism: >1 runs the unified step GPipe-style over that
    # many stages, one rank each (layers split over the stages, decode
    # batches microbatched; parallel/pp_serving.py). Exclusive with a
    # mesh larger than one device, spec decode and quantized serving;
    # decode_steps > 1 runs single-step decode
    pp_stages: int = 1
    pp_microbatches: int = 4

    def __post_init__(self):
        if len(self.mesh_shape) not in (2, 3):
            raise ValueError("mesh_shape must be (dp, tp) or (dp, fsdp, tp)")
        mesh_devices = 1
        for n in self.mesh_shape:
            mesh_devices *= n
        if self.pp_stages > 1 and mesh_devices > 1:
            raise ValueError("pp_stages and a (dp, tp) mesh are exclusive")
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
            if v not in ("",) + CLASS_IMPLS:
                raise ValueError(
                    f"unknown attention_impl_{cls} {v!r}"
                )
        # what the kernel's launch takes regardless of the model (the
        # wrappers check the rest: q_tile against 64 // G, n_split against
        # the table's span count, kv_chunk against shared memory)
        for cls in ("decode", "spec", "prefill"):
            tile = tuple(getattr(self, f"attention_tile_{cls}"))
            if len(tile) != 2 or tile[0] < 0 or tile[1] < 0:
                raise ValueError(
                    f"attention_tile_{cls} must be a pair of ints >= 0")
        for cls in ("spec", "prefill"):
            kv_chunk = getattr(self, f"attention_tile_{cls}")[1]
            if kv_chunk not in KV_CHUNKS:
                raise ValueError(
                    f"attention_tile_{cls} kv_chunk {kv_chunk} not one of "
                    f"{KV_CHUNKS} (the ragged face's staged chunks)")
        if self.attention_tile_decode[0] != 0:
            raise ValueError("attention_tile_decode is (0, n_split): the "
                             "decode face has one query per row")
        if self.ladder_compile_budget < 0:
            raise ValueError("ladder_compile_budget must be >= 0")
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
    serve yet (each is still served by the JAX package): an sp prefill
    whose seq column (``dp * fsdp`` ranks) is not a power of two (ROADMAP.md
    queue A, item 6.8). Every ``(dp, tp)`` and ``(dp, fsdp, tp)`` mesh is
    served."""
    from ..parallel.layout import check_mesh_shape

    dp, fsdp, _ = check_mesh_shape(eng.mesh_shape)
    seq = dp * fsdp
    unsupported = [
        # an sp chunk is bucketed to a power of two, which the seq column
        # must divide
        (eng.sp_prefill_threshold > 0 and seq & (seq - 1),
         f"sp_prefill_threshold on dp*fsdp={seq} (not a power of two)"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not served by dynamo_tpu_torch yet: it needs "
                "ROADMAP.md queue A, item 6.8 (uneven shards)"
            )
