"""Multimodal request processing: image extraction, prompt splicing, and
the encode-first orchestration
(ref: components/backends/trtllm/src/dynamo/trtllm/multimodal_processor.py
— the reference extracts media from OpenAI message content parts, runs the
encode step, and splices prompt embeddings; same contract here).

A copy of ``dynamo_tpu.multimodal.processor``: the content hash is the
port's own XXH3-64 in the C++ library (``native.xxh3_64``, built from
``csrc/dynamo_native.cpp``) in place of ``xxhash``, and the module imports
numpy and the standard library only, so the frontend that runs it never
loads torch. The local encoder is any object with the
:class:`~.encoder.VisionEncoder` ``encode`` method.

Flow (EPD):

  chat request with image content parts
    → extract images (data: URLs carrying raw .npy bytes, or inline
      nested-list arrays)
    → messages rendered with each image part replaced by MM_MARKER
    → the rendered prompt is split on MM_MARKER and the text segments
      tokenized independently; each image contributes a run of
      ``tokens_per_image`` placeholder ids between segments
    → the ENCODE worker (or a local encoder) turns images into embedding
      arrays
    → the wire request carries {positions, embeddings}; the engine's
      multimodal prefill splices them over the placeholder rows.

Cache correctness: block hashes are computed over token ids, and every
image uses the same placeholder id — so two prompts differing only in the
image would collide. ``content_token`` folds each image's CONTENT hash
into the ids used for hashing (not the model inputs), making the prefix
cache content-addressed: same image → legitimate reuse, different image →
different blocks.
"""

from __future__ import annotations

import base64
import io
from typing import Any, List, Tuple

import numpy as np

from .. import native
from ..runtime.engine import Operator
from ..utils.logging import get_logger
from .wire import array_from_wire, array_to_wire

log = get_logger("mm.processor")

# the string an image part contributes to the rendered chat prompt; the
# processor splits on it, so it must survive the chat template verbatim
MM_MARKER = "<|image|>"

# placeholder token id used for model-input rows that will be overwritten
# by vision embeddings (id 0 is the universal pad across our tokenizers)
PLACEHOLDER_ID = 0


def decode_image_part(part: dict) -> np.ndarray:
    """One OpenAI image content part → float array.

    Accepted: ``image_url.url = data:application/x-npy;base64,...`` (raw
    .npy bytes — the zero-dependency path this image supports) or an
    inline ``{"array": [[...]]}`` nested list."""
    if "array" in part:
        return np.asarray(part["array"], np.float32)
    url = (part.get("image_url") or {}).get("url", "")
    if not url.startswith("data:"):
        raise ValueError(
            "image_url must be a data: URL carrying .npy bytes "
            "(zero-egress deployment — no fetching)"
        )
    try:
        payload = base64.b64decode(url.split(",", 1)[1])
        return np.load(io.BytesIO(payload), allow_pickle=False)
    except Exception as exc:
        raise ValueError(f"undecodable image payload: {exc}") from None


def content_token(image: np.ndarray, index: int) -> int:
    """Content-addressed stand-in id for HASHING (never a model input):
    folds the image bytes into the KV block hash chain."""
    h = native.xxh3_64(np.ascontiguousarray(image, np.float32).tobytes(),
                       seed=index)
    # token ids hash as u32; the top bit keeps content ids clear of any
    # real vocab (vocabs are < 2^31), with 31 bits of content entropy
    return int(h & 0x7FFFFFFF) | 0x80000000


class MultimodalProcessor:
    """Splices images into a tokenized prompt and fetches embeddings.

    ``encode_client`` is a component Client for the encode worker's
    endpoint (EPD: encode runs on its own worker); ``local_encoder`` is
    the in-process fallback (aggregated deployments / tests)."""

    def __init__(self, tokenizer, tokens_per_image: int,
                 encode_client=None,
                 local_encoder=None):
        if encode_client is None and local_encoder is None:
            raise ValueError("need an encode client or a local encoder")
        self.tokenizer = tokenizer
        self.tokens_per_image = tokens_per_image
        self.encode_client = encode_client
        self.local_encoder = local_encoder

    # ------------------------ message handling -------------------------

    @staticmethod
    def has_media(messages: List[dict]) -> bool:
        for m in messages:
            content = m.get("content")
            if isinstance(content, list) and any(
                isinstance(p, dict)
                and p.get("type") in ("image_url", "image")
                for p in content
            ):
                return True
        return False

    @staticmethod
    def extract(messages: List[dict]) -> Tuple[List[dict], List[np.ndarray]]:
        """Replace image parts with MM_MARKER text; collect the arrays in
        prompt order."""
        images: List[np.ndarray] = []
        out: List[dict] = []
        for m in messages:
            content = m.get("content")
            if not isinstance(content, list):
                out.append(m)
                continue
            text_parts: List[str] = []
            for part in content:
                if not isinstance(part, dict):
                    continue
                if part.get("type") in ("image_url", "image"):
                    images.append(decode_image_part(part))
                    text_parts.append(MM_MARKER)
                elif part.get("type") in ("text", "input_text"):
                    text_parts.append(part.get("text", ""))
            out.append({**m, "content": "".join(text_parts)})
        return out, images

    # -------------------------- tokenisation ---------------------------

    def splice(self, rendered: str,
               images: List[np.ndarray]) -> Tuple[List[int], List[int],
                                                  List[int]]:
        """Rendered prompt (with MM_MARKERs) → (token_ids, mm_positions,
        hash_token_ids). Text segments are tokenized independently around
        the markers (the standard split-on-marker assembly)."""
        segments = rendered.split(MM_MARKER)
        if len(segments) - 1 != len(images):
            raise ValueError(
                f"{len(segments) - 1} image markers vs "
                f"{len(images)} images"
            )
        ids: List[int] = []
        hash_ids: List[int] = []
        positions: List[int] = []
        for i, seg in enumerate(segments):
            seg_ids = self.tokenizer.encode(seg) if seg else []
            ids.extend(seg_ids)
            hash_ids.extend(seg_ids)
            if i < len(images):
                start = len(ids)
                run = self.tokens_per_image
                positions.extend(range(start, start + run))
                ids.extend([PLACEHOLDER_ID] * run)
                ct = content_token(images[i], i)
                # content-addressed hash ids: fold position so repeated
                # identical images still chain distinctly; ids must stay
                # u32 (block hashing packs '<I') with the vocab-clear top
                # bit pinned
                hash_ids.extend(
                    0x80000000 | ((ct + j) & 0x7FFFFFFF)
                    for j in range(run)
                )
        return ids, positions, hash_ids

    # --------------------------- encoding ------------------------------

    async def encode(self, images: List[np.ndarray]) -> List[np.ndarray]:
        if self.encode_client is not None:
            from ..runtime.context import Context

            async for out in self.encode_client.round_robin(
                {"images": [array_to_wire(i) for i in images]}, Context()
            ):
                if out.get("tokens_per_image") != self.tokens_per_image:
                    raise ValueError(
                        "encode worker tokens_per_image "
                        f"{out.get('tokens_per_image')} != processor "
                        f"{self.tokens_per_image}"
                    )
                return [array_from_wire(e) for e in out["embeddings"]]
            raise RuntimeError("encode worker returned no response")
        return [self.local_encoder.encode(i) for i in images]

    async def process(self, rendered: str,
                      images: List[np.ndarray]) -> Tuple[List[int], dict]:
        """→ (token_ids, mm wire dict for the engine)."""
        ids, positions, hash_ids = self.splice(rendered, images)
        embeds = await self.encode(images)
        flat = np.concatenate(embeds, axis=0) if embeds else np.zeros(
            (0, 1), np.float32)
        if flat.shape[0] != len(positions):
            raise ValueError(
                f"{flat.shape[0]} embedding rows vs "
                f"{len(positions)} placeholder positions"
            )
        return ids, {
            "positions": positions,
            "embeddings": array_to_wire(flat.astype(np.float32)),
            "hash_token_ids": hash_ids,
        }


class MultimodalPreprocessor(Operator):
    """Preprocessor operator variant handling image content parts: extract
    → encode (EPD) → splice, falling back to the plain text path when no
    media is present. Drop-in for llm.preprocessor.Preprocessor in
    build_routed_pipeline."""

    def __init__(self, inner, processor: MultimodalProcessor):
        self.inner = inner          # llm.preprocessor.Preprocessor
        self.mm = processor

    async def forward(self, request: Any, context) -> Any:
        req = request
        if (not isinstance(req, dict) or "messages" not in req
                or not MultimodalProcessor.has_media(req["messages"])):
            return await self.inner.forward(request, context)

        text_messages, images = MultimodalProcessor.extract(req["messages"])
        rendered = self.inner.template.render(
            messages=text_messages, add_generation_prompt=True
        )
        token_ids, mm = await self.mm.process(rendered, images)
        bos = self.inner.tokenizer.bos_token_id
        if bos is not None and (not token_ids or token_ids[0] != bos):
            token_ids = [bos] + token_ids
            mm["positions"] = [p + 1 for p in mm["positions"]]
            mm["hash_token_ids"] = [bos] + mm["hash_token_ids"]
        # sampling/stop/annotation assembly shared with the text path so
        # the two can never drift
        out = self.inner.build_request(req, token_ids, formatted=rendered)
        out.mm = mm
        return out

    def backward(self, stream, request: Any, context):
        return self.inner.backward(stream, request, context)
