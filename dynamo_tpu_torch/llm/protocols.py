"""Common LLM wire types crossing the pipeline and the transport.

Role-equivalent to the reference's ``protocols/common`` types —
``PreprocessedRequest`` and ``LLMEngineOutput`` with sampling/stop options
(ref: lib/llm/src/protocols/common/*, preprocessor.rs:62-65). All types
round-trip through plain dicts so they msgpack cleanly over the transport.

A copy of ``dynamo_tpu.llm.protocols``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class SamplingOptions:
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def to_wire(self) -> dict:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}

    @staticmethod
    def from_wire(d: dict) -> "SamplingOptions":
        return SamplingOptions(
            temperature=float(d.get("temperature", 0.0)),
            top_k=int(d.get("top_k", 0)),
            top_p=float(d.get("top_p", 1.0)),
            seed=d.get("seed"),
        )


@dataclass
class StopConditions:
    max_tokens: int = 64
    stop: List[str] = field(default_factory=list)
    stop_token_ids: List[int] = field(default_factory=list)
    eos_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False

    def to_wire(self) -> dict:
        return {"max_tokens": self.max_tokens, "stop": self.stop,
                "stop_token_ids": self.stop_token_ids,
                "eos_token_ids": self.eos_token_ids,
                "ignore_eos": self.ignore_eos}

    @staticmethod
    def from_wire(d: dict) -> "StopConditions":
        return StopConditions(
            max_tokens=int(d.get("max_tokens", 64)),
            stop=list(d.get("stop", [])),
            stop_token_ids=list(d.get("stop_token_ids", [])),
            eos_token_ids=list(d.get("eos_token_ids", [])),
            ignore_eos=bool(d.get("ignore_eos", False)),
        )


@dataclass
class PreprocessedRequest:
    """Tokenized request flowing preprocessor → router → engine."""

    token_ids: List[int]
    model: str = ""
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    annotations: Dict[str, Any] = field(default_factory=dict)
    # router hints (ref: RouterConfigOverride kv_router.rs:87-93)
    router_hints: Dict[str, Any] = field(default_factory=dict)
    # multimodal payload: {positions, embeddings (binary wire array),
    # hash_token_ids} — see dynamo_tpu.multimodal
    mm: Optional[Dict[str, Any]] = None

    def to_wire(self) -> dict:
        out = {
            "token_ids": self.token_ids,
            "model": self.model,
            "sampling": self.sampling.to_wire(),
            "stop": self.stop.to_wire(),
            "annotations": self.annotations,
            "router_hints": self.router_hints,
        }
        if self.mm is not None:
            out["mm"] = self.mm
        return out

    @staticmethod
    def from_wire(d: dict) -> "PreprocessedRequest":
        return PreprocessedRequest(
            token_ids=list(d["token_ids"]),
            model=d.get("model", ""),
            sampling=SamplingOptions.from_wire(d.get("sampling", {})),
            stop=StopConditions.from_wire(d.get("stop", {})),
            annotations=dict(d.get("annotations", {})),
            router_hints=dict(d.get("router_hints", {})),
            mm=d.get("mm"),
        )


@dataclass
class BackendOutput:
    """One post-processed generation step flowing backward to the frontend."""

    token_ids: List[int]
    text: str = ""                       # completed UTF-8 delta
    finish_reason: Optional[str] = None  # stop | length | error | cancelled
    cum_tokens: int = 0                  # output tokens so far
    num_prompt_tokens: int = 0

    def to_wire(self) -> dict:
        return {"token_ids": self.token_ids, "text": self.text,
                "finish_reason": self.finish_reason,
                "cum_tokens": self.cum_tokens,
                "num_prompt_tokens": self.num_prompt_tokens}

    @staticmethod
    def from_wire(d: dict) -> "BackendOutput":
        return BackendOutput(
            token_ids=list(d.get("token_ids", [])),
            text=d.get("text", ""),
            finish_reason=d.get("finish_reason"),
            cum_tokens=int(d.get("cum_tokens", 0)),
            num_prompt_tokens=int(d.get("num_prompt_tokens", 0)),
        )
