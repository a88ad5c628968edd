"""A reader of HuggingFace ``tokenizer.json`` files for byte-level BPE.

The port's stand-in for ``tokenizers.Tokenizer`` (which the card's machine
does not install), with the small surface :class:`~.tokenizer.Tokenizer`
calls: ``encode(text, add_special_tokens).ids``, ``decode(ids,
skip_special_tokens)``, ``token_to_id``, ``get_vocab_size`` and ``to_str``.
It follows the library's algorithm step for step, so that ids and text are
the library's own:

1. added tokens are split out of the text first (leftmost-longest, the
   tokens with ``normalized: false`` before the others), so a chat
   template's ``<|start_header_id|>`` encodes to its one id;
2. the rest is pre-tokenized: ``Split`` by a regex (``Isolated`` or
   ``Removed``) and ``ByteLevel`` (optional prefix space, optional GPT-2
   regex, bytes mapped to the printable byte alphabet), alone or in a
   ``Sequence``;
3. each word is merged by BPE: the lowest-ranked adjacent pair first, the
   leftmost among equals, with ``ignore_merges`` (a word already in the
   vocabulary is one token) and a per-word cache;
4. ``TemplateProcessing`` adds its special tokens when asked;
5. decoding maps ids back (unknown ids give nothing, special ones are
   skipped on request) and the ``ByteLevel`` decoder turns the byte
   alphabet back into bytes, decoded as UTF-8 with U+FFFD for what is not.

Python's ``re`` has no ``\\p{L}``/``\\p{N}``, and its ``\\s``, ``\\d`` and
``\\w`` are other sets than the library's regex engine (Oniguruma) uses, so
:func:`translate_regex` rewrites each of them, inside a bracket or outside,
negated or not, into an explicit class of code-point ranges built from
``unicodedata``. Any other component (a normalizer, WordPiece, Unigram,
byte fallback, ...) raises ``NotImplementedError`` naming it: nothing is
approximated.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# the ByteLevel pre-tokenizer's own regex (GPT-2's)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
_CACHE_CAPACITY = 10_000

Ranges = List[Tuple[int, int]]


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The byte alphabet: printable Latin-1 bytes stand for themselves, the
    other 68 bytes for the code points 256 up, in byte order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# ------------------------------ regex ------------------------------------


@functools.lru_cache(maxsize=1)
def _category_ranges() -> Dict[str, Ranges]:
    """Every general category as sorted code-point ranges (one pass)."""
    out: Dict[str, Ranges] = {}
    cat = unicodedata.category
    start, prev = 0, cat(chr(0))
    for cp in range(1, sys.maxunicode + 1):
        c = cat(chr(cp))
        if c != prev:
            out.setdefault(prev, []).append((start, cp - 1))
            start, prev = cp, c
    out.setdefault(prev, []).append((start, sys.maxunicode))
    return out


# Oniguruma's \s in Unicode mode: the White_Space property
_WHITE_SPACE: Ranges = [(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85),
                        (0xA0, 0xA0), (0x1680, 0x1680), (0x2000, 0x200A),
                        (0x2028, 0x2029), (0x202F, 0x202F),
                        (0x205F, 0x205F), (0x3000, 0x3000)]


def _union(*parts: Ranges) -> Ranges:
    merged: Ranges = []
    for lo, hi in sorted(r for p in parts for r in p):
        if merged and lo <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _complement(ranges: Ranges) -> Ranges:
    out: Ranges = []
    nxt = 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= sys.maxunicode:
        out.append((nxt, sys.maxunicode))
    return out


@functools.lru_cache(maxsize=None)
def _property(name: str) -> Tuple[Tuple[int, int], ...]:
    """Code-point ranges of a general category (``L``, ``Lu``, ``N``, ...)
    or of the class behind ``\\s`` (``White_Space``), ``\\d`` (``Nd``) or
    ``\\w`` (``Word``: letters, marks, decimal digits, connectors)."""
    cats = _category_ranges()
    if name == "White_Space":
        return tuple(_WHITE_SPACE)
    if name == "Word":
        names = [c for c in cats if c[0] in "LM"] + ["Nd", "Pc"]
    elif len(name) == 1 and name in "LMNPSZC":
        names = [c for c in cats if c[0] == name]
    elif len(name) == 2 and name in cats or name == "Cn":
        names = [name]
    else:
        raise NotImplementedError(f"regex property \\p{{{name}}}")
    return tuple(_union(*(cats.get(c, []) for c in names)))


def _class_body(ranges: Sequence[Tuple[int, int]]) -> str:
    return "".join(f"\\U{lo:08x}" if lo == hi else
                   f"\\U{lo:08x}-\\U{hi:08x}" for lo, hi in ranges)


_CLASS_ESCAPES = {"s": "White_Space", "d": "Nd", "w": "Word"}


def translate_regex(pattern: str) -> str:
    """Rewrite an Oniguruma pattern for Python's ``re``: ``\\p{X}``,
    ``\\P{X}``, ``\\p{^X}``, ``\\s``, ``\\d``, ``\\w`` and their negations
    become explicit code-point classes (spliced into an enclosing bracket,
    or bracketed on their own); everything else passes through."""
    out: List[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            esc = pattern[i + 1]
            if esc in "pP":
                if not pattern.startswith("{", i + 2):
                    raise NotImplementedError(
                        f"regex escape {pattern[i:i + 3]!r} (Oniguruma "
                        f"needs braces: \\p{{...}})")
                close = pattern.index("}", i + 3)
                name, i = pattern[i + 3:close], close + 1
                negate = esc == "P"
                if name.startswith("^"):
                    negate, name = not negate, name[1:]
                ranges = list(_property(name))
            elif esc.lower() in _CLASS_ESCAPES:
                ranges = list(_property(_CLASS_ESCAPES[esc.lower()]))
                negate, i = esc.isupper(), i + 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            body = _class_body(_complement(ranges) if negate else ranges)
            out.append(body if in_class else f"[{body}]")
            continue
        out.append(ch)
        i += 1
        if in_class:
            if ch == "]":
                in_class = False
        elif ch == "[":
            in_class = True
            # a ']' right after '[' or '[^' is a literal
            if pattern.startswith("^", i):
                out.append("^")
                i += 1
            if pattern.startswith("]", i):
                out.append("\\]")
                i += 1
    return "".join(out)


def compile_regex(pattern: str) -> "re.Pattern[str]":
    try:
        return re.compile(translate_regex(pattern))
    except re.error as e:
        raise NotImplementedError(f"regex {pattern!r}: {e}") from None


# --------------------------- pre-tokenizers ------------------------------


def _regex_pieces(rx: "re.Pattern[str]", text: str,
                  keep_matches: bool) -> List[str]:
    """Split ``text`` at every match: the gaps and (``Isolated``) the
    matches, each its own piece; empty pieces dropped."""
    out: List[str] = []
    prev = 0
    for m in rx.finditer(text):
        if m.start() > prev:
            out.append(text[prev:m.start()])
        if keep_matches and m.end() > m.start():
            out.append(m.group())
        prev = m.end()
    if prev < len(text):
        out.append(text[prev:])
    return out


def _build_pretokenizer(spec: Optional[dict]) -> List[Callable[[str],
                                                             List[str]]]:
    """The pre-tokenizer as a list of steps, each one piece → pieces."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for sub in spec["pretokenizers"]
                for step in _build_pretokenizer(sub)]
    if kind == "Split":
        behavior = spec.get("behavior")
        if behavior not in ("Isolated", "Removed") or spec.get("invert"):
            raise NotImplementedError(
                f"Split pre-tokenizer behavior {behavior!r}"
                f"{' inverted' if spec.get('invert') else ''}")
        pat = spec["pattern"]
        if "Regex" in pat:
            rx = compile_regex(pat["Regex"])
        else:
            rx = re.compile(re.escape(pat["String"]))
        keep = behavior == "Isolated"
        return [lambda s: _regex_pieces(rx, s, keep)]
    if kind == "ByteLevel":
        table = bytes_to_unicode()
        rx = compile_regex(GPT2_PATTERN) if spec.get("use_regex", True) \
            else None
        prefix = bool(spec.get("add_prefix_space", False))

        def byte_level(s: str) -> List[str]:
            if prefix and not s.startswith(" "):
                s = " " + s
            parts = [s] if rx is None else _regex_pieces(rx, s, True)
            return ["".join(table[b] for b in p.encode()) for p in parts]
        return [byte_level]
    raise NotImplementedError(f"pre-tokenizer {kind!r}")


# ------------------------------- model -----------------------------------


class BPE:
    """The BPE model: vocabulary, ranked merges, ``ignore_merges``, unknown
    characters (``unk_token``/``fuse_unk``, else dropped), a word cache."""

    def __init__(self, spec: dict):
        kind = spec.get("type", "BPE" if "merges" in spec else None)
        if kind != "BPE":
            raise NotImplementedError(f"model {kind!r}")
        if spec.get("dropout") not in (None, 0.0):
            raise NotImplementedError("BPE dropout")
        for knob in ("byte_fallback", "continuing_subword_prefix",
                     "end_of_word_suffix"):
            if spec.get(knob):
                raise NotImplementedError(f"BPE {knob}")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.id_to_token: Dict[int, str] = {i: t for t, i in
                                            self.vocab.items()}
        self.unk_token: Optional[str] = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"bad merge {rank + 1}: {m!r}")
                a, b = parts
            else:
                a, b = m
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (
                    rank, self.vocab[a + b])
            except KeyError as e:
                raise ValueError(f"merge {rank + 1} ({a!r}, {b!r}): "
                                 f"{e.args[0]!r} is not in the vocabulary") \
                    from None
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges:
            tid = self.vocab.get(word)
            if tid is not None:
                return [tid]
        hit = self._cache.get(word)
        if hit is not None:
            return list(hit)
        ids = self._merge(self._symbols(word))
        if len(self._cache) < _CACHE_CAPACITY:
            self._cache[word] = ids
        return list(ids)

    def _symbols(self, word: str) -> List[int]:
        vocab = self.vocab
        out: List[int] = []
        pending_unk = False
        for ch in word:
            tid = vocab.get(ch)
            if tid is not None:
                out.append(tid)
                pending_unk = False
            elif self.unk_token is not None:
                if not (self.fuse_unk and pending_unk):
                    out.append(vocab[self.unk_token])
                pending_unk = True
        return out

    def _merge(self, c: List[int]) -> List[int]:
        """Apply merges lowest rank first, leftmost among equal ranks; a
        queued pair whose symbols changed since it was queued is skipped."""
        n = len(c)
        if n < 2:
            return c
        merges = self.merges
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos]:
                continue
            right = nxt[pos]
            if right == -1:
                continue
            m = merges.get((c[pos], c[right]))
            if m is None or m[1] != new_id:
                continue
            c[pos] = new_id
            alive[right] = False
            after = nxt[right]
            nxt[pos] = after
            if after != -1:
                prv[after] = pos
            before = prv[pos]
            if before != -1:
                m = merges.get((c[before], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], before, m[1]))
            if after != -1:
                m = merges.get((new_id, c[after]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


# ------------------------- post-processor, decoder ------------------------


def _build_post(spec: Optional[dict]) -> Callable[[List[int]], List[int]]:
    """What ``add_special_tokens=True`` adds around one sequence."""
    if spec is None:
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_build_post(s) for s in spec["processors"]]

        def seq(ids: List[int]) -> List[int]:
            for step in steps:
                ids = step(ids)
            return ids
        return seq
    if kind == "ByteLevel":     # offsets only: the ids stay as they are
        return lambda ids: ids
    if kind == "TemplateProcessing":
        special = spec.get("special_tokens", {})
        before: List[int] = []
        after: List[int] = []
        seen_seq = False
        for item in spec["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A" or seen_seq:
                    raise NotImplementedError(
                        f"TemplateProcessing item {item!r}")
                seen_seq = True
            else:
                ids = special[item["SpecialToken"]["id"]]["ids"]
                (after if seen_seq else before).extend(ids)
        return lambda ids: before + ids + after
    raise NotImplementedError(f"post-processor {kind!r}")


def _build_decoder(spec: Optional[dict]) -> Callable[[List[str]], str]:
    if spec is None:
        return " ".join
    kind = spec.get("type")
    if kind == "ByteLevel":
        rev = {ch: b for b, ch in bytes_to_unicode().items()}

        def byte_level(tokens: List[str]) -> str:
            buf = bytearray()
            for t in tokens:
                bs = [rev.get(ch) for ch in t]
                # a token outside the byte alphabet: its own UTF-8
                buf.extend(t.encode() if None in bs else bs)
            return buf.decode("utf-8", errors="replace")
        return byte_level
    raise NotImplementedError(f"decoder {kind!r}")


# ------------------------------ tokenizer --------------------------------


class Encoding:
    """What ``encode`` returns: the ids (the one field the pipeline reads)."""

    __slots__ = ("ids",)

    def __init__(self, ids: List[int]):
        self.ids = ids


class JsonTokenizer:
    """A ``tokenizer.json`` as the library would run it; see the module
    docstring for what it reads."""

    def __init__(self, data: str):
        self._json = data
        spec = json.loads(data)
        if spec.get("normalizer") is not None:
            raise NotImplementedError(
                f"normalizer {spec['normalizer'].get('type')!r}")
        for knob in ("truncation", "padding"):
            if spec.get(knob) is not None:
                raise NotImplementedError(knob)
        self.model = BPE(spec["model"])
        self._pre = _build_pretokenizer(spec.get("pre_tokenizer"))
        self._post = _build_post(spec.get("post_processor"))
        self._decoder = _build_decoder(spec.get("decoder"))
        self._added: Dict[str, int] = {}
        self._added_by_id: Dict[int, str] = {}
        self._special: set = set()
        passes: List[List[str]] = [[], []]   # normalized: false, then true
        for tok in spec.get("added_tokens", []):
            for knob in ("single_word", "lstrip", "rstrip"):
                if tok.get(knob):
                    raise NotImplementedError(f"added token {knob}")
            content = tok["content"]
            self._added[content] = tok["id"]
            self._added_by_id[tok["id"]] = content
            if tok.get("special"):
                self._special.add(content)
            passes[1 if tok.get("normalized", True) else 0].append(content)
        # leftmost-longest: at one position the longest alternative first
        self._splitters = [
            re.compile("|".join(re.escape(t) for t in
                                sorted(p, key=len, reverse=True)))
            for p in passes if p]

    @staticmethod
    def from_file(path: str) -> "JsonTokenizer":
        with open(path, encoding="utf-8") as f:
            return JsonTokenizer(f.read())

    @staticmethod
    def from_str(data: str) -> "JsonTokenizer":
        return JsonTokenizer(data)

    def to_str(self) -> str:
        return self._json

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._added.get(token)
        return tid if tid is not None else self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> Optional[str]:
        tok = self._added_by_id.get(tid)
        return tok if tok is not None else self.model.id_to_token.get(tid)

    def get_vocab_size(self) -> int:
        """Distinct tokens, added ones included (the library's default)."""
        return len(self.model.vocab.keys() | self._added.keys())

    def _split_added(self, text: str) -> List[Tuple[str, Optional[int]]]:
        pieces: List[Tuple[str, Optional[int]]] = [(text, None)]
        for rx in self._splitters:
            out: List[Tuple[str, Optional[int]]] = []
            for piece, tid in pieces:
                if tid is not None:
                    out.append((piece, tid))
                    continue
                prev = 0
                for m in rx.finditer(piece):
                    if m.start() > prev:
                        out.append((piece[prev:m.start()], None))
                    out.append((m.group(), self._added[m.group()]))
                    prev = m.end()
                if prev < len(piece):
                    out.append((piece[prev:], None))
            pieces = out
        return pieces

    def encode(self, text: str, add_special_tokens: bool = True) -> Encoding:
        ids: List[int] = []
        for piece, tid in self._split_added(text):
            if tid is not None:
                ids.append(tid)
                continue
            if not piece:
                continue
            words = [piece]
            for step in self._pre:
                words = [w for word in words for w in step(word)]
            for word in words:
                ids.extend(self.model.tokenize(word))
        return Encoding(self._post(ids) if add_special_tokens else ids)

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        tokens = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            tokens.append(tok)
        return self._decoder(tokens)
