"""The port's OpenAI HTTP service (its own asyncio HTTP/1.1 server) against
the JAX package's (aiohttp), each over the same fake engines as
``tests/test_frontend_http.py``: the same client gets the same status
codes, headers that matter (content type, cache control, transfer
encoding, ``Retry-After``, ``Allow``) and bodies — generated ids and
timestamps aside — on every route and error case, the same SSE frames and
``[DONE]``, and the same ``/metrics`` series. Both services kill the
request when the client leaves mid-stream, survive garbage bytes and stop
with a stream open. The port's metrics registry writes what
``prometheus_client`` writes.

End to end: ``build_local_pipeline`` over the JAX tiny engine and over the
port's (``params_from_numpy`` of the JAX parameters), served by both HTTP
services, give identical text for the same concurrent greedy requests;
``python -m dynamo_tpu_torch.run in=http`` answers a completion over TCP.
"""

import asyncio
import json
import logging
import re
import socket
import subprocess
import sys
import time

import aiohttp
import jax
import numpy as np
import pytest
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import decoders, models, pre_tokenizers, trainers

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.frontend import service as jsvc
from dynamo_tpu.llm import protocols as jproto
from dynamo_tpu.llm.entrypoint import build_local_pipeline as jax_pipeline
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu.runtime import engine as jengine
from dynamo_tpu.runtime import transport as jtransport
from dynamo_tpu.utils import metrics as jmetrics
from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine, ModelConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend import service as tsvc
from dynamo_tpu_torch.llm import protocols as tproto
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime import engine as tengine
from dynamo_tpu_torch.runtime import transport as ttransport
from dynamo_tpu_torch.utils import metrics as tmetrics
from test_torch_tokenizer import corpus

SIDES = {
    "jax": (jsvc, jproto, jengine, jtransport, jmetrics),
    "port": (tsvc, tproto, tengine, ttransport, tmetrics),
}
TIMEOUT = aiohttp.ClientTimeout(total=30)


def fake_engine(side, parts=("Hello", " world"), reason="stop", delay=0.0,
                error=None, seen=None):
    """The fake engine of ``tests/test_frontend_http.py``, with a delay
    between outputs, an error to raise, and a list that records each
    request's context."""
    _, proto, eng, transport, _ = SIDES[side]

    async def gen(request, context):
        if seen is not None:
            seen.append(context)
        if error is not None:
            kind, arg = error
            if kind == "engine":
                raise transport.EngineError("engine trouble", arg)
            raise arg("bad request for the engine")
        cum = 0
        for i, part in enumerate(parts):
            if delay:
                await asyncio.sleep(delay)
            cum += 1
            last = i == len(parts) - 1
            yield proto.BackendOutput(
                token_ids=[i], text=part,
                finish_reason=reason if last else None,
                cum_tokens=cum, num_prompt_tokens=3,
            )
    return eng.FnEngine(gen)


TOOL_TEXT = ['ok <tool_call>{"name": "f", "arguments": {"x": 1}}',
             "</tool_call>"]


def make_service(side, seen=None, **kw):
    svc_mod, _, _, _, metrics = SIDES[side]
    manager = svc_mod.ModelManager()
    entries = [
        ("m1", fake_engine(side), {}),
        ("slow", fake_engine(side, parts=["tok "] * 100, delay=0.02,
                             seen=seen), {}),
        ("nochat", fake_engine(side), dict(chat=False)),
        ("nocmpl", fake_engine(side), dict(completions=False)),
        ("unavailable", fake_engine(side, error=("engine", "unavailable")),
         {}),
        ("timeout", fake_engine(side,
                                error=("engine", "deadline_exceeded")), {}),
        ("badreq", fake_engine(side, error=("raise", ValueError)), {}),
        ("crash", fake_engine(side, error=("raise", RuntimeError)), {}),
        ("tools", fake_engine(side, parts=TOOL_TEXT),
         dict(tool_call_parser="hermes")),
        ("length", fake_engine(side, parts=["a", "b", "c"],
                               reason="length"), {}),
    ]
    for name, engine, flags in entries:
        manager.register(svc_mod.ModelEntry(name=name, engine=engine,
                                            created=1, **flags))
    return svc_mod.HttpService(
        manager, host="127.0.0.1", port=0,
        metrics=metrics.MetricsRegistry(prefix="test_frontend"), **kw)


def _norm(obj):
    """JSON without generated ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()
                if k not in ("id", "created", "created_at", "item_id")}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


HEADERS = ("Content-Type", "Cache-Control", "Transfer-Encoding",
           "Retry-After", "Allow")


async def fetch(session, port, method, path, body=None, data=None,
                headers=None):
    """(status, headers that matter, body): JSON parsed, SSE as a list of
    (event, parsed data) frames, anything else as text."""
    kw = {}
    if body is not None:
        kw["json"] = body
    if data is not None:
        kw["data"] = data
    async with session.request(method, f"http://127.0.0.1:{port}{path}",
                               headers=headers, **kw) as r:
        raw = (await r.read()).decode()
        hdrs = {h: r.headers.get(h) for h in HEADERS if h in r.headers}
        ctype = r.headers.get("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            frames = []
            for block in raw.split("\n\n"):
                if not block:
                    continue
                event = None
                for ln in block.split("\n"):
                    if ln.startswith("event: "):
                        event = ln[7:]
                    elif ln.startswith("data: "):
                        d = ln[6:]
                        frames.append((event, d if d == "[DONE]"
                                       else _norm(json.loads(d))))
            return r.status, hdrs, frames
        if "json" in ctype:
            return r.status, hdrs, _norm(json.loads(raw))
        return r.status, hdrs, raw


CHAT = {"messages": [{"role": "user", "content": "hi"}]}
CASES = [
    ("POST", "/v1/chat/completions", dict(CHAT, model="m1")),
    ("POST", "/v1/chat/completions", dict(CHAT, model="m1", stream=True)),
    ("POST", "/v1/completions", {"model": "m1", "prompt": "hi"}),
    ("POST", "/v1/completions", {"model": "m1", "prompt": [1, 2],
                                 "stream": True}),
    ("POST", "/v1/completions", {"model": "length", "prompt": "hi",
                                 "stream": True}),
    ("POST", "/v1/chat/completions", dict(CHAT, model="tools",
                                          stream=True)),
    ("POST", "/v1/chat/completions", dict(CHAT, model="tools")),
    ("POST", "/v1/responses", {"model": "m1", "input": "hi"}),
    ("POST", "/v1/responses", {"model": "m1", "input": "hi",
                               "stream": True}),
    ("POST", "/v1/responses", {"model": "m1"}),
    ("POST", "/v1/responses", {"model": "nope", "input": "hi"}),
    ("POST", "/v1/responses", {"model": "nochat", "input": "hi"}),
    ("POST", "/v1/embeddings", {"model": "m1", "input": "hi"}),
    ("POST", "/v1/embeddings", {"model": "m1"}),
    ("POST", "/v1/embeddings", {"model": "nope", "input": "hi"}),
    ("GET", "/v1/models", None),
    ("GET", "/health", None),
    ("GET", "/live", None),
    ("POST", "/v1/chat/completions", {"model": "nope", **CHAT}),
    ("POST", "/v1/completions", {"model": "nope", "prompt": "x"}),
    ("POST", "/v1/chat/completions", {"model": "m1", "messages": []}),
    ("POST", "/v1/chat/completions", dict(CHAT, model="m1",
                                          temperature=5)),
    ("POST", "/v1/chat/completions", dict(CHAT, model="m1", n=2)),
    ("POST", "/v1/completions", {"model": "m1"}),
    ("POST", "/v1/completions", {"prompt": "x"}),
    ("POST", "/v1/chat/completions", dict(CHAT, model="nochat")),
    ("POST", "/v1/completions", {"model": "nocmpl", "prompt": "x"}),
    ("POST", "/v1/chat/completions", dict(CHAT, model="unavailable")),
    ("POST", "/v1/chat/completions", dict(CHAT, model="unavailable",
                                          stream=True)),
    ("POST", "/v1/completions", {"model": "timeout", "prompt": "x"}),
    ("POST", "/v1/completions", {"model": "timeout", "prompt": "x",
                                 "stream": True}),
    ("POST", "/v1/completions", {"model": "badreq", "prompt": "x"}),
    ("POST", "/v1/chat/completions", dict(CHAT, model="crash")),
    ("GET", "/nope", None),
    ("GET", "/v1/chat/completions", None),
    ("POST", "/health", None),
]
RAW_CASES = [
    ("/v1/chat/completions", b"{not json"),
    ("/v1/completions", b""),
    ("/v1/embeddings", b"[1, 2"),
    ("/v1/responses", b"\xff\xfe"),
]


async def _run_cases(side):
    svc = make_service(side)
    await svc.start()
    out = []
    try:
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            for method, path, body in CASES:
                out.append(await fetch(s, svc.port, method, path, body))
            for path, data in RAW_CASES:
                out.append(await fetch(
                    s, svc.port, "POST", path, data=data,
                    headers={"Content-Type": "application/json",
                             "X-Request-Timeout-Ms": "garbage",
                             "traceparent": "00-" + "ab" * 16 + "-"
                                            + "cd" * 8 + "-01"}))
            metrics = await s.get(f"http://127.0.0.1:{svc.port}/metrics")
            exposition = await metrics.read()
            mtype = metrics.headers["Content-Type"]
    finally:
        await svc.stop()
    return out, exposition, mtype


def _series(exposition):
    return {(s.name, tuple(sorted(s.labels.items())))
            for s in jmetrics.validate_exposition(exposition)}


def test_routes_match_jax_service():
    want, jax_metrics, jax_type = asyncio.run(_run_cases("jax"))
    got, port_metrics, port_type = asyncio.run(_run_cases("port"))
    cases = [c[:2] for c in CASES] + [("POST", p) for p, _ in RAW_CASES]
    for case, w, g in zip(cases, want, got):
        assert g == w, case
    sse = [g for g in got if g[1].get("Content-Type", "").startswith(
        "text/event-stream")]
    assert len(sse) >= 6 and all(g[1]["Transfer-Encoding"] == "chunked"
                                 for g in sse)
    assert port_type == jax_type
    assert _series(port_metrics) == _series(jax_metrics)


async def _admission(side):
    """Shed at the door with a full slot (429), under degradation (429),
    and after a queued wait past the request deadline (503)."""
    out = []
    for queue, hdrs in ((0, {}), (1, {"X-Request-Timeout-Ms": "50"})):
        svc = make_service(side, max_concurrent_requests=1,
                           max_queued_requests=queue)
        await svc.start()
        url = f"http://127.0.0.1:{svc.port}/v1/completions"
        try:
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                held = await s.post(url, json={"model": "slow", "prompt": "x",
                                               "stream": True})
                frames = 0
                while frames < 2:                    # the slot is taken
                    frames += (await held.content.readline()).startswith(
                        b"data: ")
                out.append(await fetch(s, svc.port, "POST",
                                       "/v1/completions",
                                       {"model": "m1", "prompt": "x"},
                                       headers=hdrs))
                held.close()
                if queue == 0:
                    await asyncio.sleep(0.2)
                    svc.apply_degradation({"min_tier": 2, "level": 1})
                    for tier in ("1", "3", "junk"):
                        out.append(await fetch(
                            s, svc.port, "POST", "/v1/completions",
                            {"model": "m1", "prompt": "x"},
                            headers={"X-Request-Tier": tier}))
                    out.append(await fetch(
                        s, svc.port, "POST", "/v1/completions",
                        {"model": "m1", "prompt": "x", "tier": 5}))
                metrics = await (await s.get(
                    f"http://127.0.0.1:{svc.port}/metrics")).read()
        finally:
            await svc.stop()
        out.append(sorted(_series(metrics)))
    return out


def test_admission_matches_jax_service():
    want = asyncio.run(_admission("jax"))
    got = asyncio.run(_admission("port"))
    assert got == want
    assert got[0][0] == 429 and got[0][1]["Retry-After"] == "1"
    assert got[1][0] == 429 and "tier 1 shed" in got[1][2]["error"][
        "message"]
    assert got[-2][0] == 503


async def _disconnect(side):
    """The client leaves after the first frames; the request's context is
    killed and the service still answers."""
    seen = []
    svc = make_service(side, seen=seen)
    await svc.start()
    try:
        for path, body in (("/v1/chat/completions",
                            dict(CHAT, model="slow", stream=True)),
                           ("/v1/completions",
                            {"model": "slow", "prompt": "x",
                             "stream": True})):
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                r = await s.post(f"http://127.0.0.1:{svc.port}{path}",
                                 json=body)
                for _ in range(3):
                    await r.content.readline()
                r.close()
            t0 = time.monotonic()
            while not seen[-1].is_killed():
                assert time.monotonic() - t0 < 5, "context not killed"
                await asyncio.sleep(0.01)
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            status = (await fetch(s, svc.port, "GET", "/health"))[0]
    finally:
        await svc.stop()
    return len(seen), status


@pytest.mark.parametrize("side", ["jax", "port"])
def test_client_disconnect_kills_the_request(side):
    assert asyncio.run(_disconnect(side)) == (2, 200)


async def _garbage(side):
    svc = make_service(side)
    await svc.start()
    try:
        for junk in (b"\x16\x03\x01\x02\x00\x01\x00\x01\xfc\r\n\r\n",
                     b"GET\r\n\r\n", b"NOT A REQUEST LINE AT ALL\r\n\r\n",
                     b"GET / HTTP/1.1\r\nno colon here\r\n\r\n",
                     b"\x00\xff" * 100):
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           svc.port)
            writer.write(junk)
            await writer.drain()
            writer.write_eof()
            await asyncio.wait_for(reader.read(), 5)   # closed by the server
            writer.close()
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            return (await fetch(s, svc.port, "POST", "/v1/completions",
                                {"model": "m1", "prompt": "x"}))[0]
    finally:
        await svc.stop()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_garbage_bytes_leave_the_server_up(side):
    logger = logging.getLogger("dynamo_tpu_torch.frontend.http")
    seen = _Records()
    logger.addHandler(seen)
    try:
        assert asyncio.run(_garbage(side)) == 200
    finally:
        logger.removeHandler(seen)
    if side == "port":
        warnings = [r for r in seen.records if r.levelno == logging.WARNING]
        assert len(warnings) == 5       # one line per dropped connection
        assert all(r.exc_info is None for r in warnings)


async def _stop_with_live_stream(side):
    seen = []
    svc = make_service(side, seen=seen)
    await svc.start()
    async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
        r = await s.post(f"http://127.0.0.1:{svc.port}/v1/completions",
                         json={"model": "slow", "prompt": "x",
                               "stream": True})
        await r.content.readline()
        t0 = time.monotonic()
        await asyncio.wait_for(svc.stop(), 10)
        took = time.monotonic() - t0
        with pytest.raises((aiohttp.ClientError, asyncio.TimeoutError)):
            while await asyncio.wait_for(r.content.readline(), 5):
                pass
            raise aiohttp.ClientError("stream ended")
    return took


@pytest.mark.parametrize("side", ["jax", "port"])
def test_stop_returns_with_a_live_stream(side):
    """aiohttp lets the 2 s stream finish; the port closes it at once."""
    took = asyncio.run(_stop_with_live_stream(side))
    assert took < (1.0 if side == "port" else 10)


async def _raw_exchange(port, payload: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(payload)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(65536), 10)
    writer.close()
    return data


def test_port_server_limits_and_keep_alive():
    """Bodies past 1 MiB get 413, headers past 64 KiB 431; two requests
    ride one kept-alive connection, pipelined or not."""
    async def run():
        svc = make_service("port")
        await svc.start()
        try:
            big = b"x" * (1024 ** 2 + 1)
            r413 = await _raw_exchange(svc.port, (
                b"POST /v1/completions HTTP/1.1\r\nContent-Length: %d\r\n"
                b"\r\n" % len(big)) + big)
            r431 = await _raw_exchange(svc.port, (
                b"GET /health HTTP/1.1\r\nX-Big: " + b"y" * 70000
                + b"\r\n\r\n"))
            one = (b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           svc.port)
            writer.write(one + one)          # pipelined
            await writer.drain()
            got = b""
            while got.count(b"HTTP/1.1 200") < 2:
                got += await asyncio.wait_for(reader.read(65536), 10)
            writer.write(one)                # and once more, same socket
            await writer.drain()
            got = await asyncio.wait_for(reader.read(65536), 10)
            writer.close()
            return r413, r431, got
        finally:
            await svc.stop()

    r413, r431, again = asyncio.run(run())
    assert r413.startswith(b"HTTP/1.1 413 ")
    assert r431.startswith(b"HTTP/1.1 431 ")
    assert again.startswith(b"HTTP/1.1 200 ") and b"healthy" in again


def test_metrics_registry_writes_what_prometheus_client_writes():
    """Counters (``_total``, ``_created``), gauges, histograms (cumulative
    buckets, ``+Inf``, ``_count``, ``_sum``), constant labels of child
    scopes, removed series, escaped label values and help text: the same
    text, creation timestamps aside."""
    texts = []
    for metrics in (jmetrics, tmetrics):
        m = metrics.MetricsRegistry(prefix="x", const_labels={"ns": "a"})
        c = m.counter("req_total", "requests\nwith \\ slash",
                      ["model", "status"])
        c.labels(model='q"u\nx\\', status="200").inc()
        c.labels(model="m", status="200").inc(2.5)
        m.gauge("g", "a gauge").set(1234567.0)
        g2 = m.child(comp="c").gauge("g2", "g2", ["w"])
        g2.labels(w="1").set(3)
        g2.labels(w="2").set(4)
        g2.remove(w="1")
        g2.remove(w="never")
        h = m.histogram("lat", "latency", ["model"])
        h.labels(model="m").observe(0.003)
        h.labels(model="m").observe(400)
        m.counter("plain", "no labels").inc()
        m.histogram("h0", "custom buckets", buckets=(1, 2))
        r = metrics.MetricsRegistry(prefix="y")
        r.counter("c", "c").inc()
        r.histogram("h", "h").observe(2)
        texts.append(m.render().decode() + r.render().decode())
    want, got = (re.sub(r"^(\S*_created\S*) \S+$", r"\1 T", t, flags=re.M)
                 for t in texts)
    assert got == want
    assert len(jmetrics.validate_exposition(texts[1].encode())) == 58
    with pytest.raises(ValueError):
        tmetrics.MetricsRegistry().counter("neg", "n").inc(-1)


# ------------------------------ end to end ---------------------------------

ENG_KW = dict(block_size=4, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(4, 8), prefill_buckets=(16, 64))


def tiny_tokenizer():
    """A byte-level BPE trained to the tiny model's 512 ids: every id the
    model can sample decodes."""
    tok = HFTokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=512, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    assert tok.get_vocab_size() == 512
    return tok


E2E_REQUESTS = [
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": "Answer in one word."}],
        "max_tokens": 9, "stream": True}),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": "héllo wörld"}], "max_tokens": 7}),
    ("/v1/completions", {"prompt": "It's 12 o'clock, the", "max_tokens": 8,
                         "stream": True}),
    ("/v1/completions", {"prompt": [7, 300, 42, 11, 500], "max_tokens": 10,
                         "stop": "zz"}),
]


async def _serve_e2e(svc_mod, pipeline, engine):
    manager = svc_mod.ModelManager()
    manager.register(svc_mod.ModelEntry(name="tiny", engine=pipeline))
    svc = svc_mod.HttpService(manager, host="127.0.0.1", port=0)
    await engine.start()
    await svc.start()
    try:
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            results = await asyncio.gather(*(
                fetch(s, svc.port, "POST", path, dict(body, model="tiny",
                                                      temperature=0))
                for path, body in E2E_REQUESTS))
    finally:
        await svc.stop()
        await engine.stop()
    texts = []
    for status, _, body in results:
        assert status == 200
        if isinstance(body, list):                        # SSE frames
            assert body[-1] == (None, "[DONE]")
            choices = [f["choices"][0] for _, f in body[:-1]]
            texts.append("".join(c.get("text") or c.get("delta", {}).get(
                "content") or "" for c in choices))
            usage = body[-2][1]["usage"]
        else:
            c = body["choices"][0]
            texts.append(c["text"] if "text" in c else c["message"]
                         ["content"])
            usage = body["usage"]
        texts.append(usage)
    return texts


def test_http_end_to_end_matches_jax_pipeline():
    """Four concurrent greedy requests (chat and completions, streamed and
    not) through both HTTP services over the two tiny engines give
    identical text and usage."""
    hf = tiny_tokenizer()
    jeng = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**ENG_KW),
                     seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    want = asyncio.run(_serve_e2e(jsvc, jax_pipeline(
        jeng, JaxTokenizer(hf), "tiny", ENG_KW["max_model_len"]), jeng))
    teng = InferenceEngine(ModelConfig.tiny(), EngineConfig(**ENG_KW),
                           params=params_from_numpy(tree, ModelConfig.tiny(),
                                                    "cpu"),
                           device="cpu")
    got = asyncio.run(_serve_e2e(tsvc, build_local_pipeline(
        teng, Tokenizer.from_json_str(hf.to_str()), "tiny",
        ENG_KW["max_model_len"]), teng))
    assert got == want
    assert [u["completion_tokens"] for u in got[1::2]][:3] == [9, 7, 8]
    assert all(t for t in got[0::2])


def test_run_in_http_serves_a_completion(tmp_path):
    tok = tmp_path / "tok.json"
    tok.write_text(tiny_tokenizer().to_str())
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http",
         "out=engine", "--model", "tiny", "--device", "cpu", "--tokenizer",
         str(tok), "--host", "127.0.0.1", "--port", "0", "--num-blocks",
         "64", "--max-model-len", "256"],
        stderr=subprocess.PIPE, text=True)
    try:
        port = None
        t0 = time.monotonic()
        while port is None:
            assert time.monotonic() - t0 < 120, "server did not start"
            line = proc.stderr.readline()
            assert line, "server exited before serving"
            m = re.search(r"serving tiny on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
        body = json.dumps({"model": "tiny", "prompt": "hello world",
                           "max_tokens": 4}).encode()
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\nConnection: close"
                      b"\r\nContent-Length: %d\r\n\r\n%s" % (len(body),
                                                             body))
            raw = b""
            while chunk := s.recv(65536):
                raw += chunk
        head, _, payload = raw.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200 ")
        out = json.loads(payload)
        assert out["usage"]["completion_tokens"] == 4
        assert isinstance(out["choices"][0]["text"], str)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
