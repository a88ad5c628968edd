"""The port's distributed serving path end to end on the CPU.

- A port cluster (store, ``serve_engine`` over the port's tiny engine,
  ``ModelWatcher``, ``build_routed_pipeline``, ``HttpService``) and a JAX
  cluster of the same shape (as ``tests/test_e2e_serving.py``), the port
  engine holding the JAX engine's parameters (``params_from_numpy``), give
  identical greedy texts and usage for chat and completions, streamed and
  not.
- A JAX frontend discovers and serves a port worker's model the same way,
  and the port worker's ``clear_kv_blocks`` endpoint answers a JAX client.
- The KV events a port worker publishes have the JAX worker's structure
  (kinds, block fields, counts) and name the same blocks: equal sequence
  hashes, block hashes and parents (xxh3 in both packages).
- ``python -m dynamo_tpu_torch.runtime.store``, ``... .worker --device
  cpu`` and ``... .frontend`` as processes serve a streamed chat
  completion, and drain and exit 0 on SIGTERM.
- Two worker processes behind the frontend process: one is SIGKILLed
  mid-stream, and every stream still completes with its full token count
  and the text it gets with no kill (Migration re-issues the rest, with
  the tokens carried over, on the survivor).
"""

import asyncio
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import jax
import msgpack
import numpy as np
import pytest

from dynamo_tpu import serving as jserving
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.frontend import service as jsvc
from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm import entrypoint as jentry
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu.runtime import component as jcomp
from dynamo_tpu.runtime import context as jctx
from dynamo_tpu.runtime import store as jstore
from dynamo_tpu.utils import config as jconfig
from dynamo_tpu_torch import serving as tserving
from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine, ModelConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend import service as tsvc
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm import entrypoint as tentry
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime import codec as tcodec
from dynamo_tpu_torch.runtime import component as tcomp
from dynamo_tpu_torch.runtime import context as tctx
from dynamo_tpu_torch.runtime import store as tstore
from dynamo_tpu_torch.utils import config as tconfig
from test_torch_frontend_http import (
    E2E_REQUESTS, ENG_KW, TIMEOUT, fetch, tiny_tokenizer,
)
from torch_ready import wait_for_model

ROOT = Path(__file__).resolve().parent.parent
SIDES = {
    "jax": dict(store=jstore, comp=jcomp, config=jconfig, disc=jdisc,
                entry=jentry, svc=jsvc, serving=jserving, context=jctx,
                codec=lambda b: msgpack.unpackb(b, raw=False)),
    "port": dict(store=tstore, comp=tcomp, config=tconfig, disc=tdisc,
                 entry=tentry, svc=tsvc, serving=tserving, context=tctx,
                 codec=tcodec.unpackb),
}


def engines():
    hf = tiny_tokenizer()
    jeng = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**ENG_KW),
                     seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)
    teng = InferenceEngine(ModelConfig.tiny(), EngineConfig(**ENG_KW),
                           params=params_from_numpy(tree, ModelConfig.tiny(),
                                                    "cpu"),
                           device="cpu")
    return {
        "jax": (jeng, JaxEngineConfig(**ENG_KW), JaxTokenizer(hf)),
        "port": (teng, EngineConfig(**ENG_KW),
                 Tokenizer.from_json_str(hf.to_str())),
    }


async def cluster_texts(worker_side, front_side, engine, eng_cfg, tok):
    """Serve the E2E requests through store + worker + frontend; returns
    the texts and usages, what ``clear_kv_blocks`` answered, the structure
    of the KV events the worker published, and the blocks they name
    (kind, sequence hash, block hash, parent; sorted, since concurrent
    requests seal blocks in either order)."""
    w, f = SIDES[worker_side], SIDES[front_side]
    store = w["store"].StoreServer(host="127.0.0.1", port=0)
    await store.start()
    addr = f"127.0.0.1:{store.port}"
    w_rt = await w["comp"].DistributedRuntime.from_settings(
        w["config"].RuntimeConfig(store_addr=addr, namespace="e2e"))
    f_rt = await f["comp"].DistributedRuntime.from_settings(
        f["config"].RuntimeConfig(store_addr=addr, namespace="e2e"))
    manager = f["svc"].ModelManager()
    service = f["svc"].HttpService(manager, host="127.0.0.1", port=0)
    clients = []

    async def on_add(card, entry):
        client = await (f_rt.namespace(entry["namespace"])
                        .component(entry["component"])
                        .endpoint(entry["endpoint"]).client())
        clients.append(client)
        manager.register(f["svc"].ModelEntry(
            name=card.name, engine=f["entry"].build_routed_pipeline(
                card, client)))

    async def on_remove(name):
        manager.remove(name)

    watcher = f["disc"].ModelWatcher(f_rt, on_add, on_remove)
    kv_events = []
    sub = await f_rt.store.subscribe(f_rt.namespace("e2e").component(
        "backend").event_subject("kv_events"))

    async def collect():
        async for ev in sub:
            kv_events.append(f["codec"](ev["value"]))
    collector = asyncio.create_task(collect())
    try:
        served, kv_pub, metrics_pub = await w["serving"].serve_engine(
            w_rt, engine, eng_cfg, w["serving"].ServeOptions(name="tiny"),
            tok)
        await watcher.start()
        await service.start()
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            results = await asyncio.gather(*(
                fetch(s, service.port, "POST", path,
                      dict(body, model="tiny", temperature=0))
                for path, body in E2E_REQUESTS))
        clear = await (f_rt.namespace("e2e").component("backend")
                       .endpoint("clear_kv_blocks").client())
        clients.append(clear)
        await clear.wait_for_instances(1, 10)
        cleared = [item async for item in
                   clear.round_robin({}, f["context"].Context())]
        await asyncio.sleep(0.3)     # the publisher's last batch
        await kv_pub.stop()
        await metrics_pub.stop()
        await served.stop()
    finally:
        collector.cancel()
        await sub.cancel()
        for c in clients:
            await c.stop()
        await watcher.stop()
        await service.stop()
        await engine.stop()
        await f_rt.shutdown()
        await w_rt.shutdown()
        await store.stop()
    texts = []
    for status, _, body in results:
        assert status == 200, body
        if isinstance(body, list):                        # SSE frames
            assert body[-1] == (None, "[DONE]")
            choices = [fr["choices"][0] for _, fr in body[:-1]]
            texts.append("".join(c.get("text") or c.get("delta", {}).get(
                "content") or "" for c in choices))
            texts.append(body[-2][1]["usage"])
        else:
            c = body["choices"][0]
            texts.append(c["text"] if "text" in c else c["message"]
                         ["content"])
            texts.append(body["usage"])
    blocks, named = {}, []
    for msg in kv_events:
        assert msg["worker_id"] == served.instance.instance_id
        kind = msg["event"]["kind"]
        for b in msg["event"]["blocks"]:
            shape = tuple(sorted(b)) if isinstance(b, dict) else type(b)
            key = (kind, shape)
            blocks[key] = blocks.get(key, 0) + 1
            named.append((kind, b["seq_hash"], b["block_hash"], b["parent"])
                         if isinstance(b, dict) else (kind, b, None, None))
    return texts, cleared, blocks, sorted(named, key=repr)


@pytest.fixture(scope="module")
def jax_cluster_texts():
    jeng, jcfg, jtok = engines()["jax"]
    return asyncio.run(cluster_texts("jax", "jax", jeng, jcfg, jtok))


@pytest.mark.parametrize("front", ["port", "jax"])
def test_port_worker_serves_like_the_jax_cluster(jax_cluster_texts, front):
    """Port worker behind a port frontend and behind a JAX frontend: the
    JAX cluster's texts and usage, its KV events block for block, and
    ``clear_kv_blocks`` answers."""
    teng, tcfg, ttok = engines()["port"]
    got = asyncio.run(cluster_texts("port", front, teng, tcfg, ttok))
    want_texts, want_cleared, want_blocks, want_named = jax_cluster_texts
    assert got[0] == want_texts
    assert [u["completion_tokens"] for u in want_texts[1::2]][:3] == [9, 7, 8]
    assert got[1] == want_cleared == [{"cleared": True}]
    assert got[2] == want_blocks
    assert want_blocks[("stored", ("block_hash", "block_id", "digest",
                                   "parent", "seq_hash"))] > 0
    assert got[3] == want_named


# ------------------------- the entry points as processes -----------------


class Proc:
    def __init__(self, tmp_path, name, module, *args, env=None):
        self.log = tmp_path / f"{name}.log"
        self._f = open(self.log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args], cwd=ROOT,
            stdout=self._f, stderr=subprocess.STDOUT, env=env)

    def wait_for(self, pattern, timeout=120):
        t0 = time.monotonic()
        while True:
            m = re.search(pattern, self.log.read_text())
            if m:
                return m
            assert self.proc.poll() is None, self.log.read_text()[-3000:]
            assert time.monotonic() - t0 < timeout, \
                f"no {pattern!r}:\n{self.log.read_text()[-3000:]}"
            time.sleep(0.05)

    def stop(self, sig=signal.SIGTERM, timeout=60):
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            self._f.close()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def tok_file(tmp_path):
    path = tmp_path / "tok.json"
    path.write_text(tiny_tokenizer().to_str())
    return path


def start_cluster(tmp_path, tok_file, n_workers, *worker_flags,
                  frontend_flags=(), frontend_env=None):
    env = dict(os.environ, DYNTPU_LEASE_TTL_S="1.0",
               PYTHONPATH=str(ROOT))
    addr = f"127.0.0.1:{free_port()}"
    procs = {"store": Proc(tmp_path, "store",
                           "dynamo_tpu_torch.runtime.store", "--host",
                           "127.0.0.1", "--port", addr.split(":")[1],
                           env=env)}
    procs["store"].wait_for(r"store listening")
    for i in range(n_workers):
        procs[f"worker{i}"] = Proc(
            tmp_path, f"worker{i}", "dynamo_tpu_torch.worker", "--model",
            "tiny", "--device", "cpu", "--tokenizer", str(tok_file),
            "--store-addr", addr, "--num-blocks", "128", *worker_flags,
            env=env)
    procs["frontend"] = Proc(tmp_path, "frontend",
                             "dynamo_tpu_torch.frontend", "--host",
                             "127.0.0.1", "--port", "0", "--store-addr",
                             addr, *frontend_flags,
                             env=dict(env, **(frontend_env or {})))
    port = int(procs["frontend"].wait_for(
        r"frontend ready on 127\.0\.0\.1:(\d+)").group(1))
    for i in range(n_workers):
        procs[f"worker{i}"].wait_for(r"registered model tiny")
    return procs, port


async def wait_model(port):
    await wait_for_model(port, "tiny")


def test_three_entry_points_serve_a_streamed_chat(tmp_path, tok_file):
    procs, port = start_cluster(tmp_path, tok_file, 1)
    try:
        async def chat():
            await wait_model(port)
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                return await fetch(s, port, "POST", "/v1/chat/completions", {
                    "model": "tiny", "max_tokens": 6, "stream": True,
                    "messages": [{"role": "user", "content": "hello"}]})
        status, _, frames = asyncio.run(chat())
        assert status == 200
        assert frames[-1] == (None, "[DONE]")
        assert frames[-2][1]["usage"]["completion_tokens"] == 6
        assert procs["worker0"].stop() == 0
        assert "drain requested" in procs["worker0"].log.read_text()
        assert procs["frontend"].stop() == 0
    finally:
        for p in procs.values():
            p.stop(signal.SIGKILL)


def test_worker_killed_mid_stream_every_stream_completes(tmp_path,
                                                         tok_file):
    """Every stream completes with its full token count, and a migrated
    stream's text is the text the same prompt gets with no kill (f32 on
    the CPU is deterministic enough that a lost, repeated or skipped token
    at the join shows)."""
    procs, port = start_cluster(tmp_path, tok_file, 2,
                                "--migration-limit", "8",
                                "--max-model-len", "512")
    n_tokens = 150
    try:
        async def serve(kill):
            await wait_model(port)
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                jobs = [asyncio.ensure_future(fetch(
                    s, port, "POST", "/v1/completions", {
                        "model": "tiny", "prompt": [5 + i, 6, 7, 8],
                        "max_tokens": n_tokens, "ignore_eos": True,
                        "temperature": 0, "stream": True}))
                    for i in range(6)]
                if kill:
                    await asyncio.sleep(0.3)
                    procs["worker0"].stop(signal.SIGKILL)
                return await asyncio.gather(*jobs)

        def texts(results):
            out = []
            for status, _, frames in results:
                assert status == 200
                assert frames[-1] == (None, "[DONE]")
                assert frames[-2][1]["usage"]["completion_tokens"] \
                    == n_tokens
                out.append("".join(f["choices"][0]["text"]
                                   for _, f in frames[:-1]))
            return out
        killed = texts(asyncio.run(serve(kill=True)))
        carried = [int(n) for n in re.findall(
            r"migrating with (\d+) carried tokens",
            procs["frontend"].log.read_text())]
        assert carried and max(carried) > 0
        assert killed == texts(asyncio.run(serve(kill=False)))
    finally:
        for p in procs.values():
            p.stop(signal.SIGKILL)
