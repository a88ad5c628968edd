"""Preprocessor operator: OpenAI-shaped request → tokenized request.

Role-equivalent to the reference's ``OpenAIPreprocessor`` forward edge
(ref: lib/llm/src/preprocessor.rs:158): apply model defaults, render the
chat template (jinja2), tokenize, and build sampling/stop configuration.
OpenAI SSE delta folding happens in the frontend (``llm/openai.py``), so the
backward edge here is identity over :class:`BackendOutput`.

A copy of ``dynamo_tpu.llm.preprocessor``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import jinja2

from ..runtime.context import Context
from ..runtime.engine import Operator
from ..tracing import trace_span
from .protocols import PreprocessedRequest, SamplingOptions, StopConditions
from .tokenizer import Tokenizer

# Generic fallback template (models ship their own via tokenizer_config.json)
DEFAULT_CHAT_TEMPLATE = (
    "{% for m in messages %}"
    "<|{{ m['role'] }}|>\n{{ m['content'] }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


class PromptTemplate:
    """Jinja2 chat-template renderer (ref: preprocessor/prompt/*)."""

    def __init__(self, template: Optional[str] = None):
        self._env = jinja2.Environment(
            loader=jinja2.BaseLoader(), keep_trailing_newline=True,
            trim_blocks=True, lstrip_blocks=True,
        )
        self._env.globals["raise_exception"] = self._raise
        self._template = self._env.from_string(
            template or DEFAULT_CHAT_TEMPLATE
        )

    @staticmethod
    def _raise(msg: str):
        raise ValueError(f"chat template error: {msg}")

    def render(
        self,
        messages: List[Dict[str, Any]],
        *,
        add_generation_prompt: bool = True,
        bos_token: str = "",
        eos_token: str = "",
        **extra,
    ) -> str:
        return self._template.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=bos_token, eos_token=eos_token, **extra,
        )


class Preprocessor(Operator):
    """Forward edge: OpenAI request dict → :class:`PreprocessedRequest`.

    Accepts either chat requests (``messages``) or completion requests
    (``prompt`` as text, or pre-tokenized as a list of ids).
    """

    def __init__(
        self,
        tokenizer: Tokenizer,
        *,
        model_name: str = "",
        default_max_tokens: int = 512,
        max_context_len: Optional[int] = None,
    ):
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.default_max_tokens = default_max_tokens
        self.max_context_len = max_context_len
        self.template = PromptTemplate(tokenizer.chat_template)

    # -- forward --

    async def forward(self, request: Any, context: Context) -> Any:
        if isinstance(request, PreprocessedRequest):
            return request
        req: dict = request
        with trace_span("frontend.tokenize", context) as span:
            token_ids, formatted = self._tokenize(req)
            span.set_attr("num_tokens", len(token_ids))
        return self.build_request(req, token_ids, formatted=formatted)

    def build_request(
        self, req: dict, token_ids: List[int],
        formatted: Optional[str] = None,
    ) -> PreprocessedRequest:
        """Assemble the PreprocessedRequest for already-produced token ids
        (shared by the text path and the multimodal preprocessor so
        sampling/stop/annotation semantics can never drift)."""
        if self.max_context_len and len(token_ids) >= self.max_context_len:
            raise ValueError(
                f"prompt length {len(token_ids)} exceeds context window "
                f"{self.max_context_len}"
            )
        max_tokens = int(
            req.get("max_completion_tokens") or req.get("max_tokens")
            or self.default_max_tokens
        )
        stop = req.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        out = PreprocessedRequest(
            token_ids=token_ids,
            model=req.get("model", self.model_name),
            sampling=SamplingOptions(
                temperature=float(req.get("temperature") or 0.0),
                top_k=int(req.get("top_k") or 0),
                top_p=float(req.get("top_p") or 1.0),
                seed=req.get("seed"),
            ),
            stop=StopConditions(
                max_tokens=max_tokens,
                stop=list(stop),
                stop_token_ids=list(req.get("stop_token_ids", [])),
                eos_token_ids=list(self.tokenizer.eos_token_ids),
                ignore_eos=bool(req.get("ignore_eos", False)),
            ),
        )
        if req.get("_return_formatted_prompt"):
            # annotation parity: formatted_prompt/token_ids on request
            # (ref: preprocessor.rs:62-65 annotations)
            out.annotations["formatted_prompt"] = formatted
            out.annotations["token_ids"] = token_ids
        return out

    def _tokenize(self, req: dict):
        if "messages" in req:
            formatted = self.template.render(
                messages=req["messages"], add_generation_prompt=True
            )
            ids = self.tokenizer.encode(formatted)
            if (self.tokenizer.bos_token_id is not None
                    and (not ids or ids[0] != self.tokenizer.bos_token_id)):
                ids = [self.tokenizer.bos_token_id] + ids
            return ids, formatted
        prompt = req.get("prompt", "")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return list(prompt), None
        if not isinstance(prompt, str):
            raise ValueError("prompt must be a string or list of token ids")
        return self.tokenizer.encode(prompt), prompt
