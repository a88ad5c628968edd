"""The port's LLM pipeline modules against the JAX package's, on the same
inputs: ``Preprocessor`` (template render, tokenization, request
assembly), ``Backend.backward`` (detokenization, stop-string holdback,
``stop_generating`` on a hit), the OpenAI chunk builders and aggregators,
the stream parsers, and the tracing collector. Both sides read the same
``tokenizer.json`` (HuggingFace ``tokenizers`` behind the JAX package, the
port's own reader behind the port). Equality is exact; generated ids
(``chatcmpl-…``, tool-call ids) and timestamps are set aside."""

import asyncio

import pytest

from dynamo_tpu.llm import backend as jbackend
from dynamo_tpu.llm import openai as joai
from dynamo_tpu.llm import parsers as jparsers
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm import protocols as jproto
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.llm import backend as tbackend
from dynamo_tpu_torch.llm import openai as toai
from dynamo_tpu_torch.llm import parsers as tparsers
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm import protocols as tproto
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.llm.tokenizer_json import JsonTokenizer
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tracing.export import InMemorySpanExporter
from test_torch_tokenizer import hf_and_port

LLAMA3_TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}<|start_header_id|>"
    "{{ m['role'] }}<|end_header_id|>\n\n{{ m['content'] }}<|eot_id|>"
    "{% endfor %}{% if add_generation_prompt %}<|start_header_id|>"
    "assistant<|end_header_id|>\n\n{% endif %}")


def tokenizers(name="llama3_style", template=None):
    """(JAX Tokenizer over HF, the port's Tokenizer over its reader) of one
    tokenizer.json, with its special ids and chat template."""
    hf, _ = hf_and_port(name)
    kw = {}
    if name == "llama3_style":
        kw = dict(eos_token_ids=[hf.token_to_id("<|eot_id|>")],
                  bos_token_id=hf.token_to_id("<|begin_of_text|>"),
                  chat_template=template)
    return (JaxTokenizer(hf, **kw),
            Tokenizer(JsonTokenizer(hf.to_str()), **kw))


CHAT = [{"role": "system", "content": "Be brief."},
        {"role": "user", "content": "héllo wörld, what's 2+2?"}]
REQUESTS = {
    "chat": {"model": "m", "messages": CHAT, "max_tokens": 7,
             "temperature": 0.5, "top_p": 0.9, "top_k": 5, "seed": 3,
             "stop": "</s>"},
    "chat_max_completion_tokens": {"model": "m", "messages": CHAT,
                                   "max_completion_tokens": 11,
                                   "max_tokens": 4},
    "prompt_text_stop_list": {"model": "m", "prompt": "It's 12 o'clock",
                              "stop": ["\n", "END"], "ignore_eos": True},
    "prompt_ids": {"model": "m", "prompt": [5, 6, 7, 300],
                   "stop_token_ids": [9], "_return_formatted_prompt": True},
    "prompt_text_annotated": {"prompt": "a b c",
                              "_return_formatted_prompt": True},
}


@pytest.mark.parametrize("template", [None, LLAMA3_TEMPLATE],
                         ids=["default_template", "llama3_template"])
@pytest.mark.parametrize("name", list(REQUESTS))
def test_preprocessor_matches_jax(name, template):
    jtk, ttk = tokenizers(template=template)
    jp = jpre.Preprocessor(jtk, model_name="m", max_context_len=512)
    tp = tpre.Preprocessor(ttk, model_name="m", max_context_len=512)
    req = REQUESTS[name]
    assert tp._tokenize(req) == jp._tokenize(req)
    want = asyncio.run(jp.forward(dict(req), JaxContext()))
    got = asyncio.run(tp.forward(dict(req), Context()))
    assert got.to_wire() == want.to_wire()
    ids, formatted = tp._tokenize(req)
    assert tp.build_request(req, ids, formatted).to_wire() == \
        jp.build_request(req, ids, formatted).to_wire()


@pytest.mark.parametrize("req", [
    {"model": "m", "prompt": "word " * 400},
    {"model": "m", "prompt": {"not": "a prompt"}},
    {"model": "m", "messages": [{"role": "user", "content": "x" * 3000}]},
], ids=["prompt_over_context", "bad_prompt_type", "chat_over_context"])
def test_preprocessor_refuses_like_jax(req):
    jtk, ttk = tokenizers()
    jp = jpre.Preprocessor(jtk, max_context_len=64)
    tp = tpre.Preprocessor(ttk, max_context_len=64)
    with pytest.raises(ValueError) as want:
        asyncio.run(jp.forward(req, JaxContext()))
    with pytest.raises(ValueError) as got:
        asyncio.run(tp.forward(req, Context()))
    assert str(got.value) == str(want.value)


def _script(ids, split, *, finish=None, finished=True, prompt_len=4):
    """Engine wire items: ``ids`` cut at ``split`` (list of item sizes)."""
    items, i = [], 0
    for k in split:
        items.append({"token_ids": ids[i:i + k], "num_prompt_tokens":
                      prompt_len, "finished": False})
        i += k
    if i < len(ids):
        items.append({"token_ids": ids[i:], "num_prompt_tokens": prompt_len,
                      "finished": False})
    if finished:
        items[-1] = dict(items[-1], finished=True, finish_reason=finish)
    return items


async def _backward(backend_cls, proto, ctx_cls, tk, items, stops):
    req = proto.PreprocessedRequest(
        token_ids=tk.encode("the prompt"),
        stop=proto.StopConditions(stop=stops, max_tokens=64))
    ctx = ctx_cls()

    async def stream():
        for item in items:
            yield item

    back = backend_cls(tk)
    wire = await back.forward(req, ctx)
    outs = [o.to_wire() async for o in back.backward(stream(), req, ctx)]
    return wire, outs, ctx.is_stopped()


@pytest.mark.parametrize("case", [
    "stop_split_across_tokens", "length", "no_finish_marker",
    "multibyte_bytes",
])
def test_backend_backward_matches_jax(case):
    name = "bytes" if case == "multibyte_bytes" else "llama3_style"
    jtk, ttk = tokenizers(name)
    text = "Hello wórld 中文 STOP after the stop"
    ids = jtk.encode(text)
    assert ttk.encode(text) == ids
    split = [1] * len(ids)
    stops = ["STOP"] if case == "stop_split_across_tokens" else ["zz", "q"]
    items = _script(ids, split, finish="length",
                    finished=case != "no_finish_marker")
    want = asyncio.run(_backward(jbackend.Backend, jproto, JaxContext, jtk,
                                 items, stops))
    got = asyncio.run(_backward(tbackend.Backend, tproto, Context, ttk,
                                items, stops))
    assert got == want
    if case == "stop_split_across_tokens":
        assert got[2] and got[1][-1]["finish_reason"] == "stop"
        assert "".join(o["text"] for o in got[1]) == "Hello wórld 中文 "


def _outputs(proto, parts, reason="stop"):
    async def gen():
        cum = 0
        for i, part in enumerate(parts):
            cum += 1
            yield proto.BackendOutput(
                token_ids=[i], text=part, cum_tokens=cum,
                num_prompt_tokens=3,
                finish_reason=reason if i == len(parts) - 1 else None)
    return gen()


def _strip(chunk):
    """A chunk or response without its generated id and timestamps."""
    out = {k: v for k, v in chunk.items()
           if k not in ("id", "created", "created_at")}
    for key in ("response",):
        if isinstance(out.get(key), dict):
            out[key] = _strip(out[key])
    for key in ("choices", "output"):
        if key in out:
            out[key] = [_strip_calls(c) for c in out[key]]
    return out


def _strip_calls(choice):
    choice = dict(choice)
    choice.pop("id", None)
    for key in ("delta", "message"):
        if key in choice and "tool_calls" in choice[key]:
            choice[key] = dict(choice[key], tool_calls=[
                {k: v for k, v in c.items() if k != "id"}
                for c in choice[key]["tool_calls"]])
    return choice


async def _collect(agen):
    return [x async for x in agen]


PARTS = {
    "plain": ["Hel", "lo", "", " world"],
    "tool_call": ["ok <tool", "_call>{\"name\": \"f\", \"arguments\": "
                  "{\"x\": 1}}</tool_call>", " done"],
    "reasoning": ["<think>hmm", "</think>", "answer"],
}


@pytest.mark.parametrize("reason", ["stop", "length", "cancelled"])
@pytest.mark.parametrize("parts", list(PARTS))
def test_openai_streams_and_aggregates_match_jax(parts, reason):
    pieces = PARTS[parts]
    parser = {"tool_call": dict(tool_calls="hermes"),
              "reasoning": dict(reasoning="think")}.get(parts)
    sides = []
    for oai, proto, pmod in ((joai, jproto, jparsers),
                             (toai, tproto, tparsers)):
        def make(kind):
            outs = _outputs(proto, pieces, reason)
            if kind == "chat":
                p = pmod.StreamParserPipeline(**parser) if parser else None
                return oai.chat_stream(outs, "rid", "m", parser=p)
            return oai.completion_stream(outs, "rid", "m")
        chat = asyncio.run(_collect(make("chat")))
        cmpl = asyncio.run(_collect(make("completion")))
        agg_chat = asyncio.run(oai.aggregate_chat(make("chat")))
        agg_cmpl = asyncio.run(oai.aggregate_completion(make("completion")))
        events = asyncio.run(_collect(oai.responses_stream(
            make("chat"), "resp", "m")))
        sides.append(dict(
            chat=[_strip(c) for c in chat], cmpl=[_strip(c) for c in cmpl],
            agg_chat=_strip(agg_chat), agg_cmpl=_strip(agg_cmpl),
            response=_strip(oai.chat_to_response(agg_chat, "resp", "m")),
            events=[(e, _strip(p)) for e, p in events],
            frames=[oai.sse_frame(_strip(c)) for c in chat],
        ))
    assert sides[1] == sides[0]


def test_request_validation_and_helpers_match_jax():
    bad = [{}, {"model": "m"}, {"model": "m", "messages": []},
           {"model": "m", "messages": [{"role": "user"}]},
           {"model": "m", "messages": CHAT, "temperature": 3},
           {"model": "m", "messages": CHAT, "top_p": 0},
           {"model": "m", "messages": CHAT, "max_tokens": 0},
           {"model": "m", "messages": CHAT, "n": 2}]
    for req in bad:
        for check in ("validate_chat_request",
                      "validate_completion_request"):
            errs = []
            for oai in (joai, toai):
                try:
                    getattr(oai, check)(req)
                    errs.append(None)
                except oai.RequestError as e:
                    errs.append(str(e))
            assert errs[1] == errs[0], (check, req)
    for body in [{"model": "m", "input": "hi", "instructions": "be nice",
                  "max_output_tokens": 5, "temperature": 0.1},
                 {"model": "m", "input": [{"role": "user", "content": [
                     {"type": "input_text", "text": "a"},
                     {"type": "image", "url": "x"}]}]}]:
        assert toai.responses_to_chat(body) == joai.responses_to_chat(body)
    models = [{"name": "a", "created": 1}, {"name": "b"}]
    assert toai.models_response(models) == joai.models_response(models)
    assert toai.sse_event("e", {"a": 1}) == joai.sse_event("e", {"a": 1})
    assert toai.SSE_DONE == joai.SSE_DONE


PARSER_CASES = [
    ("reasoning", ["<think>step 1</think>the answer"]),
    ("reasoning", ["<th", "ink>rea", "soning</th", "ink>out"]),
    ("reasoning", ["<think>never closed"]),
    ("reasoning", ["hello world"]),
    ("hermes", ['check: <tool_call>{"name": "get_weather", '
                '"arguments": {"city": "SF"}}</tool_call> done']),
    ("hermes", ["x <tool_", 'call>{"name": "f", "arguments": {}}</tool_',
                "call>"]),
    ("json", ['{"name": "search", "parameters": {"q": "tpu"}}']),
    ("json", ["just a normal answer"]),
    ("json", ['{"name": "f", "argu', 'ments": {"code": "if x { y }", '
              '"s": "a\\"b"}}']),
    ("pythonic", ['[get_weather(city="SF"), add(a=1, b=2)]']),
    ("pythonic", ["items: [1, 2, 3] ok"]),
    ("pipeline", ["<think>I should call the tool</think>",
                  'sure. <tool_call>{"name": "f", "arguments": {"x": 1}}'
                  "</tool_call>"]),
]


def _make_parser(mod, kind):
    return {
        "reasoning": mod.ReasoningParser,
        "hermes": mod.HermesToolParser,
        "json": mod.JsonToolParser,
        "pythonic": mod.PythonicToolParser,
        "pipeline": lambda: mod.StreamParserPipeline(
            reasoning="think", tool_calls="hermes"),
    }[kind]()


def _deltas(parser, pieces):
    out = [parser.push(p) for p in pieces] + [parser.flush()]
    return [(d.content, d.reasoning,
             [{k: v for k, v in c.items() if k != "id"}
              for c in d.tool_calls]) for d in out]


@pytest.mark.parametrize("kind, pieces", PARSER_CASES,
                         ids=[f"{k}{i}" for i, (k, _) in
                              enumerate(PARSER_CASES)])
def test_parsers_match_jax(kind, pieces):
    assert _deltas(_make_parser(tparsers, kind), pieces) == \
        _deltas(_make_parser(jparsers, kind), pieces)


def test_tracing_collector():
    """Head sampling is a pure function of (trace id, salt) — the same in
    two collectors and in the JAX package's, near the asked ratio — and
    every span's duration reaches the stage histogram whether sampled or
    not."""
    from dynamo_tpu.tracing.collector import SpanCollector as JaxCollector
    from dynamo_tpu_torch.utils.metrics import MetricsRegistry

    a = tracing.SpanCollector(sample_ratio=0.3, sample_salt=7)
    b = tracing.SpanCollector(sample_ratio=0.3, sample_salt=7)
    ids = [f"{i:032x}" for i in range(4000)]
    decisions = [a.sampled(t) for t in ids]
    assert decisions == [b.sampled(t) for t in ids]
    ref = JaxCollector(sample_ratio=0.3, sample_salt=7)
    assert decisions == [ref.sampled(t) for t in ids]
    assert 0.25 < sum(decisions) / len(ids) < 0.35
    assert not tracing.SpanCollector(sample_ratio=0.0).sampled(ids[0])
    assert tracing.SpanCollector(sample_ratio=1.0).sampled(ids[0])

    tracer = tracing.SpanCollector(sample_ratio=0.0)
    sink = InMemorySpanExporter()
    tracer.add_exporter(sink)
    reg = MetricsRegistry(prefix="t")
    tracer.attach_metrics(reg)
    with pytest.raises(KeyError):
        with tracer.trace_span("frontend.tokenize", Context()):
            raise KeyError("x")
    assert sink.spans == []          # not sampled: not exported
    text = reg.render().decode()
    assert ('t_stage_latency_seconds_count{stage="frontend.tokenize"} 1.0'
            in text)
    tracer.configure(sample_ratio=1.0)
    with tracer.trace_span("frontend.request", Context()) as span:
        span.set_attr("n", 1)
    assert [s.name for s in sink.spans] == ["frontend.request"]
    assert sink.spans[0].to_dict()["attrs"] == {"n": 1}
