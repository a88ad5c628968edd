"""The port's scale watcher (``python -m dynamo_tpu_torch.deploy.scale_watcher``)
held against the JAX package's ``deploy/scripts/scale_watcher.py``: each on
its own package's store, both driven through the same replica targets with
a child that only sleeps. Their ``scale up``/``scale down`` lines and their
live child counts after each target are equal, a scale-down ends the newest
children first in both, the port's children each lead a process group of
their own and each exit is reported, and neither leaves a child behind
after SIGTERM."""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dynamo_tpu.runtime.store import StoreClient as JaxStoreClient
from dynamo_tpu.runtime.store import StoreServer as JaxStoreServer
from dynamo_tpu_torch.runtime.store import StoreClient, StoreServer

pytestmark = pytest.mark.anyio

ROOT = Path(__file__).resolve().parent.parent
KEY = "planner/dynamo/target/backend"
TARGETS = (1, 3, 2, 0, 1)
SLEEPER = ["sleep", "300"]
POLL_S = "0.2"


def children(pid: int) -> dict:
    """Live children of ``pid``: child pid -> start time in clock ticks
    (zombies, already exited, are left out)."""
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out[int(entry)] = int(fields[19])
    return out


class Watcher:
    """One watcher process with its output in a file."""

    def __init__(self, cmd, log_path: Path):
        self.log_path = log_path
        self._log = open(log_path, "w")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.proc = subprocess.Popen(cmd, stdout=self._log,
                                     stderr=subprocess.STDOUT, env=env,
                                     cwd=ROOT)

    def lines(self):
        return self.log_path.read_text().splitlines()

    def scale_lines(self):
        return [ln for ln in self.lines() if ln.startswith("scale ")]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(30)
        finally:
            self._log.close()


async def _settle(watcher: Watcher, n_lines: int, want: int,
                  timeout_s: float = 20.0) -> dict:
    """Wait until the watcher has printed ``n_lines`` scale lines and holds
    ``want`` live children; return them."""
    deadline = time.monotonic() + timeout_s
    while True:
        kids = children(watcher.proc.pid)
        if len(watcher.scale_lines()) >= n_lines and len(kids) == want:
            return kids
        if watcher.proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(
                f"watcher: {len(kids)} children, want {want}; output:\n"
                + "\n".join(watcher.lines()))
        await asyncio.sleep(0.05)


async def test_watchers_realise_the_same_targets(tmp_path):
    jax_server = JaxStoreServer(host="127.0.0.1", port=0)
    port_server = StoreServer(host="127.0.0.1", port=0)
    await jax_server.start()
    await port_server.start()
    jax_client = await JaxStoreClient.connect(f"127.0.0.1:{jax_server.port}")
    port_client = await StoreClient.connect(f"127.0.0.1:{port_server.port}")
    watchers = {}
    seen = {"jax": set(), "port": set()}
    try:
        for side, client in (("jax", jax_client), ("port", port_client)):
            await client.put(KEY, json.dumps(
                {"replicas": TARGETS[0], "ts": 0.0, "decision": 0}).encode())
        watchers["jax"] = Watcher(
            [sys.executable, "deploy/scripts/scale_watcher.py",
             "--store", f"127.0.0.1:{jax_server.port}", "--poll", POLL_S,
             "--", *SLEEPER], tmp_path / "jax.log")
        watchers["port"] = Watcher(
            [sys.executable, "-m", "dynamo_tpu_torch.deploy.scale_watcher",
             "--store", f"127.0.0.1:{port_server.port}", "--poll", POLL_S,
             "--", *SLEEPER], tmp_path / "port.log")
        counts = {"jax": [], "port": []}
        prev = {"jax": {}, "port": {}}
        n_lines = 0
        for i, target in enumerate(TARGETS):
            if i:
                for client in (jax_client, port_client):
                    await client.put(KEY, json.dumps(
                        {"replicas": target, "ts": float(i),
                         "decision": i}).encode())
            n_lines += abs(target - (TARGETS[i - 1] if i else 0))
            for side, w in watchers.items():
                kids = await _settle(w, n_lines, target)
                counts[side].append(len(kids))
                seen[side] |= set(kids)
                if target < len(prev[side]):
                    # a scale-down ends the newest children first
                    oldest = sorted(prev[side], key=prev[side].get)[:target]
                    assert set(kids) == set(oldest), (side, kids, prev[side])
                prev[side] = kids
        assert counts["jax"] == counts["port"] == list(TARGETS)
        assert watchers["jax"].scale_lines() == watchers["port"].scale_lines()
        assert watchers["port"].scale_lines()[:4] == [
            "scale up -> 1/1", "scale up -> 2/3", "scale up -> 3/3",
            "scale down -> 2/2"]
        # the port announces each child and gives it a process group of its
        # own
        spawned = [int(ln.split()[2]) for ln in watchers["port"].lines()
                   if ln.startswith("spawned pid ")]
        assert set(spawned) == seen["port"]
        assert len(spawned) == TARGETS[0] + 2 + 1
        for pid in prev["port"]:
            assert os.getpgid(pid) == pid
        # the stores live on this loop: wait for the exits off it
        for side, w in watchers.items():
            assert await asyncio.to_thread(w.stop) == 0, "\n".join(w.lines())
        # the port reports every child's exit: SIGTERM ends a sleeper
        exits = {int(ln.split()[1]): int(ln.rsplit(" ", 1)[1])
                 for ln in watchers["port"].lines()
                 if ln.startswith("pid ") and " exited with code " in ln}
        assert exits == {pid: -signal.SIGTERM for pid in spawned}
    finally:
        for w in watchers.values():
            if w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait(10)
        await jax_client.close()
        await port_client.close()
        await jax_server.stop()
        await port_server.stop()
    # no child outlives its watcher
    for side, pids in seen.items():
        for pid in pids:
            assert not os.path.exists(f"/proc/{pid}"), (side, pid)


def test_watcher_refuses_an_empty_command():
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.deploy.scale_watcher",
         "--store", "127.0.0.1:1", "--"], cwd=ROOT, capture_output=True,
        text=True, timeout=60)
    assert out.returncode == 2
    assert "worker command required after --" in out.stderr


async def test_watcher_reaps_a_childs_process_group(tmp_path):
    """A child that started a process of its own: the watcher's exit kills
    what is left of the child's group (the JAX watcher leaves it)."""
    server = StoreServer(host="127.0.0.1", port=0)
    await server.start()
    client = await StoreClient.connect(f"127.0.0.1:{server.port}")
    grandchild = tmp_path / "grandchild.pid"
    w = None
    try:
        await client.put(KEY, json.dumps({"replicas": 1}).encode())
        # the child starts a sleeper that ignores SIGTERM, then waits
        script = (f"trap '' TERM; sleep 300 & echo $! > {grandchild}; "
                  f"trap - TERM; wait")
        w = Watcher([sys.executable, "-m",
                     "dynamo_tpu_torch.deploy.scale_watcher",
                     "--store", f"127.0.0.1:{server.port}", "--poll",
                     POLL_S, "--", "sh", "-c", script], tmp_path / "w.log")
        deadline = time.monotonic() + 20
        while not grandchild.exists() or not grandchild.read_text().strip():
            assert time.monotonic() < deadline, "\n".join(w.lines())
            await asyncio.sleep(0.05)
        pid = int(grandchild.read_text())
        assert os.path.exists(f"/proc/{pid}")
        assert await asyncio.to_thread(w.stop) == 0
        deadline = time.monotonic() + 10
        while os.path.exists(f"/proc/{pid}"):
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break
            assert time.monotonic() < deadline, "grandchild outlived"
            await asyncio.sleep(0.05)
    finally:
        if w is not None and w.proc.poll() is None:
            w.proc.kill()
            w.proc.wait(10)
        await client.close()
        await server.stop()
