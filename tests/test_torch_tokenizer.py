"""The port's ``tokenizer.json`` reader against HuggingFace ``tokenizers``
(which backs the JAX package's ``Tokenizer``): the same files give the same
ids and the same text, exactly.

Tokenizers, all built here with no download: the byte tokenizer of
``tests/test_llm_pipeline.py``; byte-level BPEs trained by ``BpeTrainer`` on
a seeded corpus (GPT-2's regex, with and without a prefix space); the same
trainer behind Llama-3's ``Split`` regex with ``ignore_merges``, special and
non-special added tokens and a ``TemplateProcessing``; and
``chip_smoke.py``'s synthetic Llama-3-layout generator at 4,000 merges.
Strings are seeded: letters of several scripts, digits of other scripts,
whitespace runs (including characters Python calls space and Oniguruma
does not), contractions in both cases, emoji, and special tokens inside the
text. ``DetokenizerStream`` deltas are held against the JAX package's.
"""

import json
import random

import pytest
from tokenizers import Regex
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import (
    decoders, models, normalizers, pre_tokenizers, processors, trainers,
)

import chip_smoke
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu_torch import run as trun
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.llm.tokenizer_json import (
    JsonTokenizer, bytes_to_unicode, compile_regex,
)
from test_llm_pipeline import byte_tokenizer

SPECIAL = ["<|begin_of_text|>", "<|eot_id|>", "<|start_header_id|>",
           "<|end_header_id|>"]
ALPHABET = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "éüßçñÅØǅ αβγδεΩ абвгдЖ 中文字符漢 かなカナ 한글 ابت עברית देवनागरी"
    "0123456789 ٠١٢٣٤ ०१२३ ０１２ ²³½Ⅻ"
    ",.;:!?'\"()[]{}-_/\\@#$%^&*+=<>|~`"
    "   \t\n\r 　 \u001c\u001f\u0085​"
    "😀🚀👍🏽"
)
PIECES = ["'s", "'T", "'Re", "'ll", "'D", " don't", "I'M", "\r\n", "\n\n",
          "    ", " 12345 ", "x²", "hello world", "wörld"]


def random_strings(n, seed, specials=()):
    rng = random.Random(seed)
    parts = PIECES + list(specials)
    out = []
    for _ in range(n):
        s = []
        for _ in range(rng.randint(0, 12)):
            if rng.random() < 0.3:
                s.append(rng.choice(parts))
            else:
                s.append("".join(rng.choice(ALPHABET)
                                 for _ in range(rng.randint(1, 8))))
        out.append("".join(s))
    return out


def corpus(seed=0):
    return random_strings(3000, seed) + [
        "I'm here, you're there, it's 2024! Don't stop.",
        "hello world hello wörld",
    ] * 20


def trained(kind, vocab_size=600):
    """A byte-level BPE trained here: ``gpt2`` (ByteLevel with its regex),
    ``prefix`` (the same with a prefix space), ``llama3`` (Llama-3's Split
    regex, ignore_merges, special and non-special added tokens,
    TemplateProcessing)."""
    tok = HFTokenizer(models.BPE(ignore_merges=kind == "llama3"))
    if kind == "llama3":
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(chip_smoke.LLAMA3_SPLIT),
                                 behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)])
    else:
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(
            add_prefix_space=kind == "prefix")
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        special_tokens=SPECIAL if kind == "llama3" else [],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    if kind == "llama3":
        tok.add_tokens(["hello world", "wörld", "<|x|>"])
        bos = SPECIAL[0]
        tok.post_processor = processors.TemplateProcessing(
            single=f"{bos} $A", pair=f"{bos} $A {bos} $B",
            special_tokens=[(bos, tok.token_to_id(bos))])
    return tok


def synthetic():
    return HFTokenizer.from_str(
        chip_smoke.synthetic_tokenizer_json(n_merges=4000))


BUILDERS = {
    "bytes": lambda: byte_tokenizer()._tk,
    "bpe": lambda: trained("gpt2"),
    "bpe_prefix_space": lambda: trained("prefix"),
    "llama3_style": lambda: trained("llama3"),
    "synthetic_4000": synthetic,
}
_built = {}


def hf_and_port(name):
    """(HF tokenizer, the port's reader of its tokenizer.json)."""
    if name not in _built:
        hf = BUILDERS[name]()
        _built[name] = hf, JsonTokenizer(hf.to_str())
    return _built[name]


def specials_of(hf):
    return [t.content for t in hf.get_added_tokens_decoder().values()]


@pytest.mark.parametrize("name", list(BUILDERS))
def test_encode_matches_hf(name):
    """Exact ids on 400 seeded strings, with and without special tokens."""
    hf, port = hf_and_port(name)
    for text in random_strings(400, seed=1, specials=specials_of(hf)):
        for add in (False, True):
            assert port.encode(text, add_special_tokens=add).ids == \
                hf.encode(text, add_special_tokens=add).ids, (text, add)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_decode_matches_hf(name):
    """Exact text for encoded strings with random ids mixed in, unknown
    ids (past the vocabulary) among them, skipping special tokens or not."""
    hf, port = hf_and_port(name)
    rng = random.Random(2)
    n = hf.get_vocab_size()
    for text in random_strings(200, seed=3, specials=specials_of(hf)):
        ids = hf.encode(text).ids
        for _ in range(rng.randint(0, 4)):
            ids.insert(rng.randint(0, len(ids)), rng.randrange(n + 50))
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == \
                hf.decode(ids, skip_special_tokens=skip), (ids, skip)
    assert port.get_vocab_size() == hf.get_vocab_size()
    assert port.decode([n + 7, n + 1000]) == hf.decode([n + 7, n + 1000])


def test_property_classes_split_like_oniguruma():
    """``\\p{L}``/``\\p{N}``, inside and outside brackets and negated, and
    ``\\s``/``\\S`` (Unicode White_Space, not Python's set) split strings
    the way the library's ``Split`` does."""
    patterns = [chip_smoke.LLAMA3_SPLIT,
                r"\p{L}+|\P{L}+", r"[^\p{N}]+|\p{N}", r"\p{^N}+|[\P{L}\p{N}]",
                r"\p{Lu}\p{Ll}*|\p{Nd}+|[^\p{Lu}\p{Ll}\p{Nd}]",
                r"\s+|\S+", r"[\s\p{N}]+|[^\s\p{N}]+"]
    for pat in patterns:
        split = pre_tokenizers.Split(Regex(pat), behavior="isolated")
        rx = compile_regex(pat)
        for text in random_strings(300, seed=4):
            want = [p for p, _ in split.pre_tokenize_str(text)]
            got = [p for p in _isolated(rx, text)]
            assert got == want, (pat, text)


def _isolated(rx, text):
    out, prev = [], 0
    for m in rx.finditer(text):
        if m.start() > prev:
            out.append(text[prev:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        prev = m.end()
    if prev < len(text):
        out.append(text[prev:])
    return out


def _toy_bpe(ignore_merges):
    """Vocabulary holding "abc" whole, merges that would make "ab"+"c"."""
    alpha = sorted(pre_tokenizers.ByteLevel.alphabet())
    vocab = {c: i for i, c in enumerate(alpha)}
    for t in ("ab", "abc", "bc"):
        vocab[t] = len(vocab)
    tok = HFTokenizer(models.BPE(vocab=vocab, merges=[("a", "b"),
                                                      ("b", "c")],
                                 ignore_merges=ignore_merges))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    return tok


@pytest.mark.parametrize("ignore_merges", [False, True])
def test_ignore_merges(ignore_merges):
    """A word already in the vocabulary is one token only with
    ``ignore_merges``; otherwise the merges decide ("ab" + "c")."""
    hf = _toy_bpe(ignore_merges)
    port = JsonTokenizer(hf.to_str())
    for text in ["abc", "abcabc abc", "xabc", "bcab", "abcd"]:
        assert port.encode(text).ids == hf.encode(text).ids
    vocab = hf.get_vocab()
    want = [vocab["abc"]] if ignore_merges else [vocab["ab"], vocab["c"]]
    assert port.encode("abc").ids == want


def test_added_tokens_split_out_of_text():
    """Special tokens inside words, back to back, overlapping added tokens
    (the longest wins), and non-special added tokens all encode to the
    library's ids; a chat header is one id each."""
    hf, port = hf_and_port("llama3_style")
    texts = ["<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>",
             "a<|eot_id|><|eot_id|>b", "<|eot_id", "x<|x|>y<|x|",
             "hello worldhello world", "say hello world!", "wörldwörld"]
    for text in texts:
        assert port.encode(text).ids == hf.encode(text).ids, text
    ids = port.encode("<|start_header_id|>assistant<|end_header_id|>",
                      add_special_tokens=False).ids
    assert ids[0] == hf.token_to_id("<|start_header_id|>")
    assert ids[-1] == hf.token_to_id("<|end_header_id|>")


def test_byte_level_alphabet_and_single_bytes():
    """The byte-to-unicode table is the library's: every single byte
    encodes to the library's id and decodes back."""
    table = bytes_to_unicode()
    assert sorted(table) == list(range(256))
    assert set(table.values()) == set(pre_tokenizers.ByteLevel.alphabet())
    hf, port = hf_and_port("bytes")
    for b in range(256):
        text = bytes([b]).decode("latin-1")
        assert port.encode(text).ids == hf.encode(text).ids
        ids = port.encode(bytes([b]).decode("utf-8", "replace")).ids
        assert port.decode(ids) == hf.decode(ids)


def test_lossy_utf8_decode_matches_hf():
    """Invalid UTF-8 decodes to U+FFFD exactly as the library does: lone
    continuation bytes, truncated leads, overlong forms, surrogates, code
    points past U+10FFFF."""
    hf, port = hf_and_port("bytes")
    byte_id = {b: hf.token_to_id(ch) for b, ch in bytes_to_unicode().items()}
    cases = [b"\x80", b"a\xbfb", b"\xe4\xb8", b"\xe4\xb8a", b"\xc0\xaf",
             b"\xed\xa0\x80", b"\xf4\x90\x80\x80", b"\xf0\x9f\x98",
             b"\xff\xfe", b"ok\xe2\x82\xacok", b"\xf8\x88\x80\x80\x80"]
    for raw in cases:
        ids = [byte_id[b] for b in raw]
        assert port.decode(ids) == hf.decode(ids), raw


@pytest.mark.parametrize("name", ["bytes", "bpe", "llama3_style",
                                  "synthetic_4000"])
def test_detokenizer_stream_matches_jax(name):
    """``DetokenizerStream`` deltas (pushed one to three ids at a time,
    multibyte characters split across pushes) and flushes equal the JAX
    package's over the same id streams and prompt seeds."""
    hf, port = hf_and_port(name)
    jax_tk = JaxTokenizer(hf)
    port_tk = Tokenizer(port)
    rng = random.Random(5)
    n = hf.get_vocab_size()
    streams = [hf.encode(t).ids for t in random_strings(60, seed=6)]
    streams += [[rng.randrange(n) for _ in range(40)] for _ in range(20)]
    for ids in streams:
        prompt = [rng.randrange(n) for _ in range(rng.randint(0, 10))]
        js, ps = jax_tk.stream(prompt), port_tk.stream(prompt)
        i = 0
        while i < len(ids):
            k = rng.randint(1, 3)
            assert ps.push(ids[i:i + k]) == js.push(ids[i:i + k])
            i += k
        assert ps.flush() == js.flush()
        assert ps.text == js.text


def test_from_pretrained_dir_reads_tokenizer_config(tmp_path):
    hf, _ = hf_and_port("llama3_style")
    (tmp_path / "tokenizer.json").write_text(hf.to_str())
    template = ("{% for m in messages %}<|start_header_id|>{{ m['role'] }}"
                "<|end_header_id|>\n\n{{ m['content'] }}<|eot_id|>"
                "{% endfor %}")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "chat_template": template,
        "eos_token": {"content": "<|eot_id|>"},
        "bos_token": "<|begin_of_text|>",
    }))
    want = JaxTokenizer.from_pretrained_dir(str(tmp_path))
    got = trun.load_tokenizer(str(tmp_path))
    assert got.eos_token_ids == want.eos_token_ids == (
        hf.token_to_id("<|eot_id|>"),)
    assert got.bos_token_id == want.bos_token_id
    assert got.chat_template == want.chat_template == template
    assert got.vocab_size == want.vocab_size
    file_tk = trun.load_tokenizer(str(tmp_path / "tokenizer.json"))
    assert file_tk.eos_token_ids == () and file_tk.chat_template is None
    text = "<|start_header_id|>user<|end_header_id|>\n\nhi there<|eot_id|>"
    assert got.encode(text) == want.encode(text)
    assert got.to_json_str() == want.to_json_str()


def _wordpiece():
    return HFTokenizer(models.WordPiece({"[UNK]": 0, "a": 1},
                                        unk_token="[UNK]"))


def _unigram():
    return HFTokenizer(models.Unigram([("<unk>", 0.0), ("a", -1.0)], 0))


def _normalized():
    tok = trained("gpt2", vocab_size=300)
    tok.normalizer = normalizers.NFC()
    return tok


def _metaspace():
    tok = trained("gpt2", vocab_size=300)
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    return tok


@pytest.mark.parametrize("build, component", [
    (_wordpiece, "WordPiece"), (_unigram, "Unigram"),
    (_normalized, "normalizer 'NFC'"), (_metaspace, "Metaspace"),
], ids=["wordpiece", "unigram", "normalizer", "metaspace"])
def test_unsupported_components_are_refused(build, component):
    with pytest.raises(NotImplementedError, match=component):
        JsonTokenizer(build().to_str())
