"""The planner's scaling loop over real port processes, the twin of
``tests/test_planner_e2e.py``: HTTP load → the port frontend's window stats
→ the port planner → its VirtualConnector target → the port's scale watcher
(``python -m dynamo_tpu_torch.deploy.scale_watcher``) starts and stops port
mocker workers. The fleet scales 1 → N under a burst and back to 1 under a
trickle, in the target and in the registered instances. Every process is
the port's, and the client is the port's ``utils/httpclient.py`` (no
``aiohttp``)."""

import asyncio
import json
import re
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_llm_pipeline import byte_tokenizer  # noqa: E402
from utils import ManagedProcess, free_port  # noqa: E402

from dynamo_tpu_torch.runtime.store import StoreClient  # noqa: E402
from dynamo_tpu_torch.utils.httpclient import HttpClient  # noqa: E402

pytestmark = pytest.mark.anyio

# the JAX test's synthetic curves: the burst needs >1 decode replica, the
# trickle exactly 1
PROFILE = {
    "prefill_isl": [8, 64, 256],
    "prefill_ttft_s": [0.01, 0.02, 0.05],
    "prefill_thpt_per_chip": [2000.0, 2000.0, 2000.0],
    "decode_kv_usage": [0.1, 0.5, 0.9],
    "decode_context_length": [16, 64, 256],
    "decode_itl_s": [0.005, 0.005, 0.005],
    "decode_thpt_per_chip": [30.0, 30.0, 30.0],
}
BODY = json.dumps({"model": "mock", "max_tokens": 16, "messages": [
    {"role": "user", "content": "load probe"}]}).encode()


async def fire(url: str, n: int):
    """``n`` concurrent chat requests, each on a connection of its own;
    their HTTP statuses (0 for a failed exchange)."""
    async def one():
        client = HttpClient(url, timeout_s=60.0)
        try:
            resp = await client.request(
                "POST", "/v1/chat/completions", body=BODY,
                headers={"Content-Type": "application/json"})
            return resp.status
        except (OSError, asyncio.TimeoutError):
            return 0
        finally:
            await client.close()

    return await asyncio.gather(*(one() for _ in range(n)))


async def test_planner_scales_port_fleet_up_and_down(tmp_path):
    tok = tmp_path / "tokenizer.json"
    tok.write_text(byte_tokenizer().to_json_str())
    profile = tmp_path / "profile.json"
    profile.write_text(json.dumps(PROFILE))
    store_port = free_port()
    http_port = free_port()
    addr = f"127.0.0.1:{store_port}"
    procs = []
    client = None
    try:
        store = ManagedProcess(
            ["-m", "dynamo_tpu_torch.runtime.store", "--host", "127.0.0.1",
             "--port", str(store_port)],
            name="store", ready_pattern=r"listening")
        procs.append(store)
        store.wait_ready(20)
        env = {"DYNTPU_STORE_ADDR": addr}

        # seed the scaling target so the watcher brings up the first worker
        client = await StoreClient.connect(addr)
        await client.put(
            "planner/dynamo/target/backend",
            json.dumps({"replicas": 1, "ts": time.time(),
                        "decision": 0}).encode())

        watcher = ManagedProcess(
            ["-m", "dynamo_tpu_torch.deploy.scale_watcher",
             "--store", addr, "--component", "backend", "--poll", "0.5",
             "--", sys.executable, "-m", "dynamo_tpu_torch.mocker",
             "--model-name", "mock", "--tokenizer", str(tok),
             "--block-size", "4", "--num-blocks", "512",
             "--max-model-len", "512", "--speedup-ratio", "50"],
            name="watcher", env=env, ready_pattern=r"scale up -> 1/1")
        procs.append(watcher)
        watcher.wait_ready(30)

        frontend = ManagedProcess(
            ["-m", "dynamo_tpu_torch.frontend", "--host", "127.0.0.1",
             "--port", str(http_port), "--stats-publish-interval", "1"],
            name="frontend", env=env, ready_pattern=r"frontend ready")
        procs.append(frontend)
        frontend.wait_ready(30)

        planner = ManagedProcess(
            ["-m", "dynamo_tpu_torch.planner", "--profile", str(profile),
             "--adjustment-interval", "2", "--max-chip-budget", "4",
             "--ttft", "0.5", "--itl", "0.05"],
            name="planner", env=env, ready_pattern=r"planner running")
        procs.append(planner)
        planner.wait_ready(30)

        url = f"http://127.0.0.1:{http_port}"

        async def instances() -> int:
            kvs = await client.get_prefix("v1/instances/")
            return sum(1 for k, _ in kvs if "/generate/" in k)

        async def target() -> int:
            raw = await client.get("planner/dynamo/target/backend")
            return int(json.loads(raw)["replicas"]) if raw else 0

        # wait until the first mocker is discovered by the frontend
        for _ in range(100):
            if await fire(url, 1) == [200]:
                break
            await asyncio.sleep(0.2)
        else:
            pytest.fail("fleet never served the warmup request")

        # ---- burst phase: load that needs >1 decode replica ----------
        # paced so the AR predictor sees a plateau, not an unbounded ramp
        max_target = max_instances = 1
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            await fire(url, 16)
            await asyncio.sleep(0.4)
            max_target = max(max_target, await target())
            max_instances = max(max_instances, await instances())
            if max_target > 1 and max_instances > 1:
                break
        assert max_target > 1, "planner never scaled the target above 1"
        assert max_instances > 1, "the watcher never realised the scale-up"

        # ---- trickle phase: load a single replica satisfies ----------
        deadline = time.monotonic() + 90
        down_target = down_instances = None
        while time.monotonic() < deadline:
            await fire(url, 1)
            await asyncio.sleep(1.0)
            t, i = await target(), await instances()
            if t == 1 and i == 1:
                down_target, down_instances = t, i
                break
        assert down_target == 1, "planner never scaled back down to 1"
        assert down_instances == 1, (
            "the watcher never terminated the extra workers")
        # the watcher said so, in the JAX watcher's words
        lines = watcher.log()
        ups = re.findall(r"^scale up -> (\d+)/(\d+)$", lines, re.M)
        downs = re.findall(r"^scale down -> (\d+)/(\d+)$", lines, re.M)
        assert len(ups) >= 2 and downs and downs[-1][1] == "1"
    finally:
        if client is not None:
            await client.close()
        for p in reversed(procs):
            try:
                p.terminate()
            except Exception:
                pass
