"""The model engine on PyTorch: a Llama-class model over a paged KV cache,
the continuous-batching scheduler, and the asyncio engine loop that streams
tokens per request."""

from .config import EngineConfig, ModelConfig
from .engine import InferenceEngine, Request, StepOutput

__all__ = [
    "EngineConfig",
    "ModelConfig",
    "InferenceEngine",
    "Request",
    "StepOutput",
]
