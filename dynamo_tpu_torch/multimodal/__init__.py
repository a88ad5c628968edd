"""Multimodal encode-prefill-decode (EPD) support
(ref: components/backends/trtllm — multimodal_processor.py + the EPD
request handlers): a vision ENCODE worker turns media into prompt
embeddings; prefill splices them over placeholder tokens; decode is
unchanged. Embeddings ride the wire as binary arrays, and KV block hashes
are content-addressed over the media so the prefix cache can never serve
one image's KV for another.

A copy of ``dynamo_tpu.multimodal``. The package re-exports only the
frontend's pieces (processor and wire arrays), which load no torch; the
encoder lives in ``.encoder``.
"""

from .processor import MM_MARKER, MultimodalProcessor
from .wire import array_from_wire, array_to_wire

__all__ = [
    "MultimodalProcessor",
    "MM_MARKER",
    "array_to_wire",
    "array_from_wire",
]
