"""The port's graph controller (``python -m dynamo_tpu_torch.deploy.controller``)
held against the JAX package's ``deploy/operator/controller.py`` on
``tests/test_operator.py``'s fake apiserver: the four cases of that file run
through each controller (and, in the last, each package's connector) on a
cluster of its own, from the same states. Both reach the JAX tests'
assertions, and their request logs (method, path, JSON body) are equal
apart from the worker module and the image the pods run."""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
from aiohttp import web

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent / "deploy" / "operator"))

import controller as jctl  # noqa: E402
from dynamo_tpu.planner import kubernetes_connector as jk  # noqa: E402
from dynamo_tpu_torch.deploy import controller as tctl  # noqa: E402
from dynamo_tpu_torch.planner import kubernetes_connector as tk  # noqa: E402
from test_operator import FakeCluster  # noqa: E402

pytestmark = pytest.mark.anyio

ROOT = Path(__file__).resolve().parent.parent
SIDES = {
    "jax": dict(ctl=jctl, k8s=jk, image="dynamo-tpu:test",
                worker="dynamo_tpu.worker"),
    "port": dict(ctl=tctl, k8s=tk, image="dynamo-tpu-torch:test",
                 worker="dynamo_tpu_torch.worker"),
}


class LoggingCluster(FakeCluster):
    """The JAX tests' fake cluster, logging every request as (method, path,
    JSON body or None)."""

    def __init__(self, namespace="prod"):
        super().__init__(namespace)
        self.log = []

        @web.middleware
        async def record(request, handler):
            text = await request.text()
            self.log.append((request.method, request.path_qs,
                             json.loads(text) if text else None))
            return await handler(request)

        self.app.middlewares.append(record)


def api_for(side: str, cluster):
    k8s = SIDES[side]["k8s"]
    api = k8s.KubernetesAPI(k8s.KubeConfig(
        base_url=f"http://127.0.0.1:{cluster.port}",
        namespace=cluster.namespace, token="test-token"))
    cluster.clients.append(api)
    return api


def controller_for(side: str, cluster):
    return SIDES[side]["ctl"].GraphController(
        api_for(side, cluster), image=SIDES[side]["image"],
        store_addr="store:4222")


def as_jax(log, side: str):
    """A request log with the side's worker module and image named as the
    JAX side's."""
    text = json.dumps(log)
    for key in ("worker", "image"):
        text = text.replace(json.dumps(SIDES[side][key]),
                            json.dumps(SIDES["jax"][key]))
    return json.loads(text)


async def run_both(scenario, setup=None):
    """Run ``scenario(side, cluster)`` on a fresh cluster per side (after
    ``setup(cluster)``, before the cluster starts); the request logs must be
    equal once the names are mapped."""
    logs = {}
    for side in SIDES:
        cluster = LoggingCluster()
        if setup is not None:
            setup(cluster)
        await cluster.start()
        try:
            await scenario(side, cluster)
            logs[side] = cluster.log
        finally:
            for client in cluster.clients:
                await client.close()
            await cluster.stop()
    assert logs["jax"], "the scenario made no request"
    assert as_jax(logs["port"], "port") == json.loads(json.dumps(logs["jax"]))
    return logs


async def test_creates_deployments_from_cr():
    async def scenario(side, cluster):
        cluster.objects["graph"] = {
            "metadata": {"name": "graph"},
            "spec": {"services": {
                "backend": {"replicas": 2, "component": "backend",
                            "args": ["--disagg-mode", "decode"]},
                "prefill": {"replicas": 1},
            }},
        }
        ctrl = controller_for(side, cluster)
        actions = await ctrl.reconcile_once()
        assert actions == 2
        dep = cluster.deployments["graph-backend"]
        assert dep["spec"]["replicas"] == 2
        container = dep["spec"]["template"]["spec"]["containers"][0]
        assert container["image"] == SIDES[side]["image"]
        assert container["args"][:4] == ["-m", SIDES[side]["worker"],
                                         "--component", "backend"]
        assert "--disagg-mode" in container["args"]
        assert {"name": "DYNTPU_STORE_ADDR", "value": "store:4222"} in (
            container["env"])
        assert cluster.deployments["graph-prefill"]["spec"]["replicas"] == 1
        # status mirrored: nothing ready yet
        assert (cluster.objects["graph"]["status"]["conditions"][0]
                ["status"] == "False")

    logs = await run_both(scenario)
    # the port's pods run the port's worker
    posts = [body for method, _, body in logs["port"] if method == "POST"]
    assert len(posts) == 2
    for body in posts:
        args = body["spec"]["template"]["spec"]["containers"][0]["args"]
        assert args[1] == "dynamo_tpu_torch.worker"


async def test_scales_and_mirrors_status():
    async def scenario(side, cluster):
        cluster.objects["graph"] = {
            "metadata": {"name": "graph"},
            "spec": {"services": {"backend": {"replicas": 1}}},
        }
        ctrl = controller_for(side, cluster)
        await ctrl.reconcile_once()
        cluster.set_ready("graph-backend", 1)
        await ctrl.reconcile_once()
        st = cluster.objects["graph"]["status"]
        assert st["services"]["backend"]["replicas"] == 1
        assert st["conditions"][0]["status"] == "True"

        # planner scales the CR up; the controller moves the Deployment
        cluster.objects["graph"]["spec"]["services"]["backend"]["replicas"] \
            = 3
        actions = await ctrl.reconcile_once()
        assert actions == 1
        assert cluster.deployments["graph-backend"]["spec"]["replicas"] == 3
        assert ctrl.num_scales == 1
        # mid-rollout: ready (1) != want (3)
        assert (cluster.objects["graph"]["status"]["conditions"][0]
                ["status"] == "False")
        cluster.set_ready("graph-backend", 3)
        await ctrl.reconcile_once()
        assert (cluster.objects["graph"]["status"]["conditions"][0]
                ["status"] == "True")
        assert ctrl.num_reconciles == 4

    await run_both(scenario)


async def test_reconcile_is_idempotent():
    async def scenario(side, cluster):
        cluster.objects["graph"] = {
            "metadata": {"name": "graph"},
            "spec": {"services": {"backend": {"replicas": 2}}},
        }
        ctrl = controller_for(side, cluster)
        await ctrl.reconcile_once()
        cluster.set_ready("graph-backend", 2)
        assert await ctrl.reconcile_once() == 0
        assert await ctrl.reconcile_once() == 0
        assert ctrl.num_scales == 0

    await run_both(scenario)


async def test_planner_connector_roundtrip_through_operator():
    """The full control loop: each package's planner connector patches the
    CR, its controller realises it, the mirrored status re-arms the
    connector's mid-rollout guard."""
    async def scenario(side, cluster):
        cluster.objects["graph"] = {
            "metadata": {"name": "graph"},
            "spec": {"services": {"backend": {"replicas": 1}}},
        }
        ctrl = controller_for(side, cluster)
        await ctrl.reconcile_once()
        cluster.set_ready("graph-backend", 1)
        await ctrl.reconcile_once()  # status: Ready=True

        conn = SIDES[side]["k8s"].KubernetesConnector(
            api_for(side, cluster))
        await conn.scale("backend", 4)     # planner writes intent
        await ctrl.reconcile_once()        # operator moves pods
        assert cluster.deployments["graph-backend"]["spec"]["replicas"] == 4
        # guard: while rolling out, further scales are skipped
        await conn.scale("backend", 9)
        assert (cluster.objects["graph"]["spec"]["services"]["backend"]
                ["replicas"] == 4)

    await run_both(scenario)


async def test_a_failing_cr_skips_only_itself():
    """A CR whose reconcile raises (its Deployment's GET answers 500) is
    logged and skipped; the next CR is still reconciled, in both."""
    @web.middleware
    async def fail_bad(request, handler):
        if request.path.endswith("/deployments/bad-backend"):
            return web.json_response({"reason": "boom"}, status=500)
        return await handler(request)

    async def scenario(side, cluster):
        for name in ("bad", "good"):
            cluster.objects[name] = {
                "metadata": {"name": name},
                "spec": {"services": {"backend": {"replicas": 1}}},
            }
        ctrl = controller_for(side, cluster)
        assert await ctrl.reconcile_once() == 1
        assert set(cluster.deployments) == {"good-backend"}

    await run_both(scenario,
                   setup=lambda c: c.app.middlewares.append(fail_bad))


def test_controller_flags_keep_the_jax_defaults():
    args = tctl.parse_args([])
    assert (args.store_addr, args.interval, args.namespace,
            args.base_url) == ("store:4222", 5.0, None, None)
    assert args.image == "dynamo-tpu-torch:latest"
    assert tctl.GraphController.__init__.__defaults__ == (
        "store:4222", "dynamo_tpu_torch.worker")


async def test_controller_process_reconciles_the_fake_cluster():
    """``python -m dynamo_tpu_torch.deploy.controller --base-url ...``
    creates the CR's Deployments, whose pods run the port's worker."""
    cluster = LoggingCluster()
    await cluster.start()
    cluster.objects["graph"] = {
        "metadata": {"name": "graph"},
        "spec": {"services": {"backend": {"replicas": 2}}},
    }
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.deploy.controller",
         "--base-url", f"http://127.0.0.1:{cluster.port}",
         "--namespace", "prod", "--interval", "0.2",
         "--image", "img:1"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 30
        while "graph-backend" not in cluster.deployments:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "no Deployment created"
            await asyncio.sleep(0.05)
        container = (cluster.deployments["graph-backend"]["spec"]["template"]
                     ["spec"]["containers"][0])
        assert container["image"] == "img:1"
        assert container["args"][:2] == ["-m", "dynamo_tpu_torch.worker"]
        assert cluster.deployments["graph-backend"]["spec"]["replicas"] == 2
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
        proc.stdout.close()
        await cluster.stop()
