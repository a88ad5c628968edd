"""Realise the planner's VirtualConnector targets as local worker processes
(the non-K8s orchestrator; role of the reference's operator reconciler for
``DynamoGraphDeployment`` replica counts).

    python -m dynamo_tpu_torch.deploy.scale_watcher --store 127.0.0.1:4222 \
        --component backend -- python -m dynamo_tpu_torch.worker --weights DIR

Watches ``planner/{ns}/target/{component}`` and spawns/terminates copies of
the worker command to match the target replica count: ``scale up -> i/n``
per spawn, ``scale down -> i/n`` per SIGTERM (the newest child first; the
worker drains its in-flight streams and exits). Each child runs in a process
group of its own, announced by a ``spawned pid P (process group P)`` line,
so a supervisor can reap a child's whole tree, and each exit is reported
as ``pid P exited with code C``. On exit the watcher terminates every child
that is still running, draining ones included, and kills what is left of
their groups.

A copy of the JAX package's ``deploy/scripts/scale_watcher.py`` on the
port's store client.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys

from ..runtime.store import StoreClient


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="realise planner targets as local worker processes")
    p.add_argument("--store", default="127.0.0.1:4222")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--poll", type=float, default=5.0)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="worker command after --")
    args = p.parse_args(argv)
    args.cmd = [c for c in args.cmd if c != "--"]
    if not args.cmd:
        p.error("worker command required after --")
    return args


def _exited(pr: subprocess.Popen) -> None:
    print(f"pid {pr.pid} exited with code {pr.returncode}", flush=True)


def _reap(procs) -> None:
    """SIGTERM every child, wait up to 10 s each (SIGKILL past that), then
    kill whatever is left in each child's process group."""
    for pr in procs:
        pr.terminate()
    for pr in procs:
        try:
            pr.wait(10)
        except subprocess.TimeoutExpired:
            pr.kill()
            pr.wait()
        _exited(pr)
    for pr in procs:
        try:
            os.killpg(pr.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


async def run(args: argparse.Namespace) -> None:
    client = await StoreClient.connect(args.store)
    key = f"planner/{args.namespace}/target/{args.component}"
    procs: list = []
    # children sent SIGTERM by a scale-down and not yet exited
    draining: list = []
    # Python's default SIGTERM disposition would kill us without running
    # the finally, orphaning every worker we spawned
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        while not stop.is_set():
            raw = await client.get(key)
            target = int(json.loads(raw)["replicas"]) if raw else len(procs)
            for pr in procs + draining:
                if pr.poll() is not None:
                    _exited(pr)
            procs = [pr for pr in procs if pr.returncode is None]
            draining = [pr for pr in draining if pr.returncode is None]
            while len(procs) < target:
                print(f"scale up -> {len(procs) + 1}/{target}", flush=True)
                pr = subprocess.Popen(args.cmd, process_group=0)
                print(f"spawned pid {pr.pid} (process group {pr.pid})",
                      flush=True)
                procs.append(pr)
            while len(procs) > target:
                pr = procs.pop()
                print(f"scale down -> {len(procs)}/{target}", flush=True)
                pr.send_signal(signal.SIGTERM)   # graceful drain
                draining.append(pr)
            try:
                await asyncio.wait_for(stop.wait(), timeout=args.poll)
            except asyncio.TimeoutError:
                pass
    finally:
        # a child still draining gets its SIGTERM again (a repeat signal
        # ends a draining worker at once)
        _reap(procs + draining)
        await client.close()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
