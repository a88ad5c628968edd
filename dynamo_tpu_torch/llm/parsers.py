"""Streaming reasoning + tool-call parsers
(ref: lib/parsers/src/{reasoning,tool_calling} — hermes/llama/pythonic
formats, detect-start jailing heuristics at preprocessor.rs:27).

Parsers consume decoded text deltas and re-split them into
``content`` / ``reasoning_content`` / ``tool_calls``. Streaming rule: plain
content flows through immediately; the moment a start marker *might* be
forming, the tail is held back ("jailed") until it resolves — so clients
never see half a ``<tool_call>`` tag, and reasoning is never leaked as
content.

A copy of ``dynamo_tpu.llm.parsers``.
"""

from __future__ import annotations

import ast
import json
import re
import uuid
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ParseDelta:
    content: str = ""
    reasoning: str = ""
    tool_calls: List[dict] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not (self.content or self.reasoning or self.tool_calls)


def _tool_call_dict(name: str, arguments: str, index: int) -> dict:
    return {
        "index": index,
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def _partial_suffix(buf: str, token: str) -> int:
    """Length of the longest suffix of ``buf`` that is a proper prefix of
    ``token`` (what must be held back in case the token continues)."""
    for n in range(min(len(token) - 1, len(buf)), 0, -1):
        if token.startswith(buf[-n:]):
            return n
    return 0


class ReasoningParser:
    """Splits ``<think>…</think>`` spans into ``reasoning_content``
    (ref: reasoning/base parser; deepseek-r1/gpt-oss style)."""

    def __init__(self, start: str = "<think>", end: str = "</think>"):
        self.start = start
        self.end = end
        self._buf = ""
        self._in_think = False

    def push(self, text: str) -> ParseDelta:
        self._buf += text
        out = ParseDelta()
        while True:
            if self._in_think:
                idx = self._buf.find(self.end)
                if idx >= 0:
                    out.reasoning += self._buf[:idx]
                    self._buf = self._buf[idx + len(self.end):]
                    self._in_think = False
                    continue
                hold = _partial_suffix(self._buf, self.end)
                emit = self._buf[: len(self._buf) - hold]
                out.reasoning += emit
                self._buf = self._buf[len(emit):]
                return out
            idx = self._buf.find(self.start)
            if idx >= 0:
                out.content += self._buf[:idx]
                self._buf = self._buf[idx + len(self.start):]
                self._in_think = True
                continue
            hold = _partial_suffix(self._buf, self.start)
            emit = self._buf[: len(self._buf) - hold]
            out.content += emit
            self._buf = self._buf[len(emit):]
            return out

    def flush(self) -> ParseDelta:
        out = ParseDelta()
        if self._in_think:
            out.reasoning = self._buf   # unterminated think: keep as reasoning
        else:
            out.content = self._buf
        self._buf = ""
        self._in_think = False
        return out


class HermesToolParser:
    """``<tool_call>{json}</tool_call>`` (hermes/qwen format)."""

    START, END = "<tool_call>", "</tool_call>"

    def __init__(self):
        self._buf = ""
        self._jailed = False
        self._count = 0

    def push(self, text: str) -> ParseDelta:
        self._buf += text
        out = ParseDelta()
        while True:
            if self._jailed:
                idx = self._buf.find(self.END)
                if idx < 0:
                    return out  # still jailed
                raw = self._buf[:idx].strip()
                self._buf = self._buf[idx + len(self.END):]
                self._jailed = False
                out.tool_calls.extend(self._parse(raw))
                continue
            idx = self._buf.find(self.START)
            if idx >= 0:
                out.content += self._buf[:idx]
                self._buf = self._buf[idx + len(self.START):]
                self._jailed = True
                continue
            hold = _partial_suffix(self._buf, self.START)
            emit = self._buf[: len(self._buf) - hold]
            out.content += emit
            self._buf = self._buf[len(emit):]
            return out

    def _parse(self, raw: str) -> List[dict]:
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError:
            return []
        args = obj.get("arguments", obj.get("parameters", {}))
        call = _tool_call_dict(
            obj.get("name", ""), json.dumps(args), self._count
        )
        self._count += 1
        return [call]

    def flush(self) -> ParseDelta:
        out = ParseDelta()
        if not self._jailed:
            out.content = self._buf
        # jailed-but-unterminated: drop the partial call (never emit garbage)
        self._buf = ""
        self._jailed = False
        return out


class JsonToolParser:
    """Bare-JSON tool calls: output that *is* ``{"name": …, "parameters"|
    "arguments": …}`` (llama3-style). Jails from the first ``{`` that looks
    like a call start (detect-start heuristic, ref preprocessor.rs:27)."""

    _START = re.compile(r'\{\s*"(?:name|type)"\s*:')

    def __init__(self):
        self._buf = ""
        self._jailed = False
        self._count = 0

    def push(self, text: str) -> ParseDelta:
        self._buf += text
        out = ParseDelta()
        if not self._jailed:
            m = self._START.search(self._buf)
            if m is None:
                # hold back a potential forming start (anything from the
                # last unmatched '{' on)
                idx = self._buf.rfind("{")
                emit_to = idx if idx >= 0 else len(self._buf)
                out.content += self._buf[:emit_to]
                self._buf = self._buf[emit_to:]
                return out
            out.content += self._buf[: m.start()]
            self._buf = self._buf[m.start():]
            self._jailed = True
        # jailed: try to complete the JSON object
        obj, consumed = self._try_complete(self._buf)
        if obj is not None:
            self._buf = self._buf[consumed:]
            self._jailed = False
            out.tool_calls.extend(self._emit(obj))
        return out

    @staticmethod
    def _try_complete(buf: str):
        depth = 0
        in_str = False
        esc = False
        for i, ch in enumerate(buf):
            if esc:
                esc = False
                continue
            if ch == "\\":
                esc = True
            elif ch == '"':
                in_str = not in_str
            elif not in_str:
                if ch == "{":
                    depth += 1
                elif ch == "}":
                    depth -= 1
                    if depth == 0:
                        try:
                            return json.loads(buf[: i + 1]), i + 1
                        except json.JSONDecodeError:
                            return None, 0
        return None, 0

    def _emit(self, obj: dict) -> List[dict]:
        if "function" in obj:   # {"type":"function","function":{...}}
            obj = obj["function"]
        name = obj.get("name", "")
        args = obj.get("parameters", obj.get("arguments", {}))
        call = _tool_call_dict(name, json.dumps(args), self._count)
        self._count += 1
        return [call]

    def flush(self) -> ParseDelta:
        out = ParseDelta()
        out.content = "" if self._jailed else self._buf
        self._buf = ""
        self._jailed = False
        return out


class PythonicToolParser:
    """``[get_weather(city="SF"), search(q=1)]`` (llama4/pythonic format)."""

    _START = re.compile(r"\[\s*[A-Za-z_][\w.]*\s*\(")

    def __init__(self):
        self._buf = ""
        self._jailed = False
        self._count = 0

    def push(self, text: str) -> ParseDelta:
        self._buf += text
        out = ParseDelta()
        if not self._jailed:
            m = self._START.search(self._buf)
            if m is None:
                idx = self._buf.rfind("[")
                emit_to = idx if idx >= 0 else len(self._buf)
                out.content += self._buf[:emit_to]
                self._buf = self._buf[emit_to:]
                return out
            out.content += self._buf[: m.start()]
            self._buf = self._buf[m.start():]
            self._jailed = True
        end = self._find_close(self._buf)
        if end >= 0:
            raw = self._buf[: end + 1]
            self._buf = self._buf[end + 1:]
            self._jailed = False
            out.tool_calls.extend(self._parse(raw))
        return out

    @staticmethod
    def _find_close(buf: str) -> int:
        depth = 0
        in_str: Optional[str] = None
        for i, ch in enumerate(buf):
            if in_str:
                if ch == in_str:
                    in_str = None
                continue
            if ch in "\"'":
                in_str = ch
            elif ch == "[" or ch == "(":
                depth += 1
            elif ch == "]" or ch == ")":
                depth -= 1
                if depth == 0:
                    return i
        return -1

    def _parse(self, raw: str) -> List[dict]:
        try:
            tree = ast.parse(raw.strip(), mode="eval")
        except SyntaxError:
            return []
        if not isinstance(tree.body, ast.List):
            return []
        calls = []
        for node in tree.body.elts:
            if not isinstance(node, ast.Call):
                continue
            name = ast.unparse(node.func)
            args = {}
            for kw in node.keywords:
                try:
                    args[kw.arg] = ast.literal_eval(kw.value)
                except (ValueError, SyntaxError):
                    args[kw.arg] = ast.unparse(kw.value)
            calls.append(_tool_call_dict(
                name, json.dumps(args), self._count
            ))
            self._count += 1
        return calls

    def flush(self) -> ParseDelta:
        out = ParseDelta()
        out.content = "" if self._jailed else self._buf
        self._buf = ""
        self._jailed = False
        return out


TOOL_PARSERS = {
    "hermes": HermesToolParser,
    "json": JsonToolParser,
    "pythonic": PythonicToolParser,
}


class StreamParserPipeline:
    """Reasoning parser feeding a tool-call parser (either optional)."""

    def __init__(self, reasoning: Optional[str] = None,
                 tool_calls: Optional[str] = None):
        self.reasoning = ReasoningParser() if reasoning else None
        self.tools = (TOOL_PARSERS[tool_calls]()
                      if tool_calls else None)

    def push(self, text: str) -> ParseDelta:
        if self.reasoning is not None:
            d = self.reasoning.push(text)
            if self.tools is not None and d.content:
                td = self.tools.push(d.content)
                d.content = td.content
                d.tool_calls.extend(td.tool_calls)
            return d
        if self.tools is not None:
            return self.tools.push(text)
        return ParseDelta(content=text)

    def flush(self) -> ParseDelta:
        out = ParseDelta()
        if self.reasoning is not None:
            d = self.reasoning.flush()
            out.reasoning += d.reasoning
            if self.tools is not None and d.content:
                td = self.tools.push(d.content)
                out.content += td.content
                out.tool_calls.extend(td.tool_calls)
            else:
                out.content += d.content
        if self.tools is not None:
            d = self.tools.flush()
            out.content += d.content
            out.tool_calls.extend(d.tool_calls)
        return out
