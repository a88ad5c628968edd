"""Tensor-parallel serving across processes in the port, mirroring
``tests/test_multihost.py``'s four cases on ``--device cpu``: a store, a
leader (``--mesh 1,2 --num-hosts 2 --host-index 0``) and a follower
(``--host-index 1``) join one gloo world; the leader registers and answers,
the follower replays its step plans.

- the sharded forward serves a streamed chat through the frontend process;
- the follower replays every plan: its per-kind counts, logged at exit,
  equal the leader's emitted counts, and both made the same all_reduces;
- a leader that goes silent (SIGSTOP) releases the follower (heartbeat
  deadline, or the collective timeout);
- a killed leader releases the follower (stream EOF);
- ``--mesh 1,2`` alone starts its second rank itself, and serves greedy
  streams equal to a one-rank worker's on the same store.

Every process wait carries its own timeout."""

import asyncio
import os
import re
import signal
import sys
from pathlib import Path

import aiohttp
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_distributed import Proc, free_port, wait_model  # noqa: E402
from test_torch_frontend_http import (  # noqa: E402
    TIMEOUT, fetch, tiny_tokenizer,
)

ROOT = Path(__file__).resolve().parent.parent
READY_S = 120
EXIT_S = 60
COMMON = ["--model", "tiny", "--device", "cpu", "--block-size", "4",
          "--num-blocks", "128", "--max-model-len", "256",
          "--max-batched-tokens", "64", "--mesh", "1,2"]
PLANS = re.compile(r"worker exiting: tp rank=(\d) world=2 backend=gloo "
                   r"all_reduce_calls=(\d+) .* plans=(\S+)")


def _env():
    # one torch thread per rank process (as tests/torch_tp_world.py caps
    # its ranks); the ranks a worker starts itself inherit it
    return dict(os.environ, DYNTPU_LEASE_TTL_S="1.0", PYTHONPATH=str(ROOT),
                OMP_NUM_THREADS="1")


def _store(tmp_path):
    addr = f"127.0.0.1:{free_port()}"
    store = Proc(tmp_path, "store", "dynamo_tpu_torch.runtime.store",
                 "--host", "127.0.0.1", "--port", addr.split(":")[1],
                 env=_env())
    store.wait_for(r"store listening", timeout=READY_S)
    return addr, store


def _start_world(tmp_path, tok):
    addr, store = _store(tmp_path)
    coord = f"127.0.0.1:{free_port()}"
    common = [*COMMON, "--tokenizer", str(tok), "--store-addr", addr,
              "--coordinator", coord, "--num-hosts", "2"]
    procs = {"store": store}
    procs["leader"] = Proc(tmp_path, "leader", "dynamo_tpu_torch.worker",
                           *common, "--host-index", "0", env=_env())
    procs["follower"] = Proc(tmp_path, "follower",
                             "dynamo_tpu_torch.worker", *common,
                             "--host-index", "1", env=_env())
    procs["follower"].wait_for(r"follower 1 ready \(barrier passed\)",
                               timeout=READY_S)
    procs["leader"].wait_for(r"registered model tiny", timeout=READY_S)
    return addr, procs


def _stop_all(procs):
    for p in reversed(list(procs.values())):
        if p.proc.poll() is None:
            p.proc.send_signal(signal.SIGCONT)
        p.stop(signal.SIGKILL, timeout=EXIT_S)


@pytest.fixture
def tok(tmp_path):
    path = tmp_path / "tok.json"
    path.write_text(tiny_tokenizer().to_str())
    return path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One world behind a frontend for the two serving cases; the second
    stops it."""
    tmp_path = tmp_path_factory.mktemp("tp_world")
    tok = tmp_path / "tok.json"
    tok.write_text(tiny_tokenizer().to_str())
    addr, procs = _start_world(tmp_path, tok)
    procs["frontend"] = Proc(tmp_path, "frontend",
                             "dynamo_tpu_torch.frontend", "--host",
                             "127.0.0.1", "--port", "0", "--store-addr",
                             addr, env=_env())
    port = int(procs["frontend"].wait_for(
        r"frontend ready on 127\.0\.0\.1:(\d+)", timeout=READY_S).group(1))
    try:
        yield procs, port
    finally:
        _stop_all(procs)


def _chat(port, content, n):
    async def go():
        await wait_model(port)
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            return await fetch(s, port, "POST", "/v1/chat/completions", {
                "model": "tiny", "max_tokens": n, "stream": True,
                "messages": [{"role": "user", "content": content}]})
    return asyncio.run(go())


def test_sharded_forward_serves_through_the_frontend(served):
    procs, port = served
    status, _, frames = _chat(port, "hello", 6)
    assert status == 200
    assert frames[-1] == (None, "[DONE]")
    assert frames[-2][1]["usage"]["completion_tokens"] == 6
    procs["follower"].wait_for(r"follower 1: 1 plans replayed",
                               timeout=READY_S)


def test_follower_replays_every_plan(served):
    procs, port = served

    async def several():
        async def one(i):
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                return await fetch(s, port, "POST", "/v1/completions", {
                    "model": "tiny", "max_tokens": 5, "stream": False,
                    "prompt": "abcdefghijklmnopqrstuvwxyz"[i:i + 20]})
        await wait_model(port)
        return await asyncio.gather(*(one(i) for i in range(3)))

    for status, _, body in asyncio.run(several()):
        assert status == 200, body
        assert body["usage"]["completion_tokens"] == 5
    # a graceful leader exit closes the step stream: the follower logs its
    # counts and exits by itself
    assert procs["leader"].stop(timeout=EXIT_S) == 0
    procs["follower"].proc.wait(EXIT_S)
    lead = PLANS.search(procs["leader"].log.read_text())
    follow = PLANS.search(procs["follower"].log.read_text())
    assert lead and follow, procs["follower"].log.read_text()[-2000:]
    assert (lead.group(1), follow.group(1)) == ("0", "1")
    assert follow.group(3) == lead.group(3)       # plans per kind
    assert follow.group(2) == lead.group(2) != "0"  # all_reduce calls
    assert "Traceback" not in procs["follower"].log.read_text()


def test_leader_silent_death_releases_follower(tmp_path, tok):
    """SIGSTOP: no FIN ever arrives; the follower's heartbeat deadline (or
    the collective timeout) ends it."""
    _, procs = _start_world(tmp_path, tok)
    try:
        procs["leader"].proc.send_signal(signal.SIGSTOP)
        procs["follower"].proc.wait(EXIT_S)
        assert "leader presumed dead" in procs["follower"].log.read_text()
    finally:
        _stop_all(procs)


def test_leader_kill_releases_follower(tmp_path, tok):
    _, procs = _start_world(tmp_path, tok)
    try:
        procs["leader"].proc.kill()
        procs["follower"].proc.wait(EXIT_S)
        assert "worker exiting: tp rank=1" in \
            procs["follower"].log.read_text()
    finally:
        _stop_all(procs)


def test_mesh_alone_starts_its_ranks_and_matches_one_rank(tmp_path, tok):
    """``--mesh 1,2`` with no coordinator: the worker starts rank 1 as its
    own child on localhost; its greedy streams equal a one-rank worker's
    (same seed, same weights) on the same store."""
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    addr, store = _store(tmp_path)
    procs = {"store": store}
    common = [*COMMON[:-2], "--tokenizer", str(tok), "--store-addr", addr]
    procs["one"] = Proc(tmp_path, "one", "dynamo_tpu_torch.worker", *common,
                        "--component", "one", "--model-name", "tiny-1",
                        env=_env())
    procs["tp"] = Proc(tmp_path, "tp", "dynamo_tpu_torch.worker", *common,
                       "--mesh", "1,2", "--component", "tp",
                       "--model-name", "tiny-tp", env=_env())
    try:
        procs["one"].wait_for(r"registered model tiny-1", timeout=READY_S)
        procs["tp"].wait_for(r"registered model tiny-tp", timeout=READY_S)
        assert "started local ranks [1]" in procs["tp"].log.read_text()

        async def streams(component):
            rt = await DistributedRuntime.from_settings(
                RuntimeConfig(store_addr=addr))
            try:
                client = await (rt.namespace().component(component)
                                .endpoint("generate").client())
                await client.wait_for_instances(1, timeout_s=READY_S)
                out = []
                for i in range(2):
                    toks = []
                    async for o in client.round_robin(
                            {"token_ids": list(range(3 + i, 40 + 7 * i)),
                             "max_tokens": 8, "ignore_eos": True},
                            Context()):
                        toks.extend(o["token_ids"])
                    out.append(toks)
                return out
            finally:
                await rt.shutdown()

        want = asyncio.run(asyncio.wait_for(streams("one"), READY_S))
        got = asyncio.run(asyncio.wait_for(streams("tp"), READY_S))
        assert [len(s) for s in got] == [8, 8]
        assert got == want
        # SIGTERM drains the leader, whose child rank exits after it
        assert procs["tp"].stop(timeout=EXIT_S) == 0
        log = procs["tp"].log.read_text()
        assert "worker exiting: tp rank=0" in log
        assert "worker exiting: tp rank=1" in log
    finally:
        _stop_all(procs)


def test_data_parallel_worker_serves_through_the_frontend(tmp_path, tok):
    """``--mesh 2,1`` alone: the worker starts rank 1 itself and serves
    replicated dp rows (no sp threshold, as the JAX worker); greedy
    completions through the frontend equal a one-rank worker's on the
    same store, and both ranks log their exit lines with a world of 2."""
    addr, store = _store(tmp_path)
    procs = {"store": store}
    common = [*COMMON[:-2], "--tokenizer", str(tok), "--store-addr", addr]
    procs["one"] = Proc(tmp_path, "one", "dynamo_tpu_torch.worker", *common,
                        "--component", "one", "--model-name", "tiny-1",
                        env=_env())
    procs["dp"] = Proc(tmp_path, "dp", "dynamo_tpu_torch.worker", *common,
                       "--mesh", "2,1", "--component", "dp",
                       "--model-name", "tiny-dp", env=_env())
    procs["frontend"] = Proc(tmp_path, "frontend",
                             "dynamo_tpu_torch.frontend", "--host",
                             "127.0.0.1", "--port", "0", "--store-addr",
                             addr, env=_env())
    try:
        port = int(procs["frontend"].wait_for(
            r"frontend ready on 127\.0\.0\.1:(\d+)", timeout=READY_S
        ).group(1))
        procs["one"].wait_for(r"registered model tiny-1", timeout=READY_S)
        procs["dp"].wait_for(r"registered model tiny-dp", timeout=READY_S)
        assert "started local ranks [1]" in procs["dp"].log.read_text()

        async def texts(model):
            out = []
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                for _ in range(400):
                    async with s.get(f"http://127.0.0.1:{port}/v1/models"
                                     ) as r:
                        listed = [m["id"] for m in (await r.json())["data"]]
                    if model in listed:
                        break
                    await asyncio.sleep(0.05)
                for prompt in ("hello world", "abcdefghijklmnop"):
                    status, _, body = await fetch(
                        s, port, "POST", "/v1/completions", {
                            "model": model, "prompt": prompt,
                            "max_tokens": 8, "temperature": 0,
                            "ignore_eos": True, "stream": False})
                    assert status == 200, body
                    assert body["usage"]["completion_tokens"] == 8
                    out.append(body["choices"][0]["text"])
            return out

        want = asyncio.run(asyncio.wait_for(texts("tiny-1"), READY_S))
        got = asyncio.run(asyncio.wait_for(texts("tiny-dp"), READY_S))
        assert got == want
        assert procs["dp"].stop(timeout=EXIT_S) == 0
        log = procs["dp"].log.read_text()
        for r in (0, 1):
            assert f"worker exiting: tp rank={r} world=2" in log
        assert "sp_prefills=0" in log
    finally:
        _stop_all(procs)


@pytest.mark.parametrize("flags", [
    ["--disagg-mode", "prefill"], ["--kvbm-host-blocks", "64"],
    ["--mm-encoder"], ["--mm-encode-component", "encoder"],
], ids=lambda f: f[0].lstrip("-"))
def test_data_parallel_worker_refuses_single_rank_paths(flags):
    """A ``--mesh 2,1`` worker has tp 1 but two ranks: on one host the
    disaggregated, KVBM and multimodal paths pass ``check_supported``
    (its follower joins them by plans); over two hosts disaggregation and
    the KVBM tiers are refused in the JAX worker's words, before any rank
    starts, and multimodal EPD is served."""
    from dynamo_tpu_torch import worker

    worker.check_supported(
        worker.parse_args(["--device", "cpu", "--mesh", "2,1", *flags]))
    args = worker.parse_args(["--device", "cpu", "--mesh", "2,1",
                              "--num-hosts", "2", *flags])
    if flags[0].startswith("--mm"):
        worker.check_supported(args)
        return
    with pytest.raises(SystemExit) as e:
        asyncio.run(worker.run_worker(args))
    assert str(e.value) == ("multi-host workers serve the aggregated path "
                            "only (disagg/KVBM are single-host features)")
