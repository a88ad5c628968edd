"""TpuGraphDeployment reconciler — the operator-equivalent controller
(role of the reference's Go operator, deploy/cloud/operator: watch the
graph CR, realise per-service replica counts as Kubernetes Deployments,
mirror observed state into the CR status; ~17k LoC of operator machinery
reduced to the reconcile loop that actually moves pods).

    python -m dynamo_tpu_torch.deploy.controller --interval 5

Reconcile semantics per TpuGraphDeployment:

- every ``spec.services.<name>`` maps to one k8s Deployment named
  ``{cr}-{service}`` (created from a pod template rendered off the CR's
  service ``component``/``args``, running ``python -m
  dynamo_tpu_torch.worker``; image/env come from the controller's flags so
  one controller serves many graphs);
- ``spec.services.<name>.replicas`` is authoritative — the Deployment's
  ``spec.replicas`` is patched to match (the SLA planner writes the CR,
  this loop moves the pods: the same split as reference planner →
  operator);
- observed ready replicas are mirrored into ``status.services.<name>``
  and a ``Ready`` condition, which the planner's mid-rollout guard reads.

Level-triggered: each pass reconciles the full desired state, so missed
events cannot wedge it. Degenerate apiserver responses only skip a pass.

A copy of the JAX package's ``deploy/operator/controller.py`` on the port's
Kubernetes client (``planner/kubernetes_connector.py``, the same
``GROUP``/``VERSION``), whose requests go through ``utils/httpclient.py``.
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Optional

from ..planner.kubernetes_connector import (
    GROUP, VERSION, K8sApiError, KubeConfig, KubernetesAPI,
)
from ..utils.logging import get_logger

log = get_logger("operator")


class GraphController:
    """One reconcile loop over every TpuGraphDeployment in a namespace."""

    def __init__(self, api: KubernetesAPI, image: str,
                 store_addr: str = "store:4222",
                 worker_module: str = "dynamo_tpu_torch.worker"):
        self.api = api
        self.image = image
        self.store_addr = store_addr
        self.worker_module = worker_module
        self.num_reconciles = 0
        self.num_scales = 0

    # -------------------- k8s Deployment plumbing ----------------------

    def _deploy_path(self, name: str = "") -> str:
        ns = self.api.config.namespace
        base = f"/apis/apps/v1/namespaces/{ns}/deployments"
        return f"{base}/{name}" if name else base

    def _render_deployment(self, cr_name: str, service: str,
                           svc_spec: dict) -> dict:
        name = f"{cr_name}-{service}"
        labels = {
            "app.kubernetes.io/managed-by": "dynamo-tpu-operator",
            "dynamo-tpu/graph": cr_name,
            "dynamo-tpu/service": service,
        }
        args = ["-m", self.worker_module,
                "--component", svc_spec.get("component", service)]
        args += [str(a) for a in svc_spec.get("args", [])]
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "labels": labels},
            "spec": {
                "replicas": int(svc_spec.get("replicas", 1)),
                "selector": {"matchLabels": labels},
                "template": {
                    "metadata": {"labels": labels},
                    "spec": {"containers": [{
                        "name": "worker",
                        "image": self.image,
                        "command": ["python"],
                        "args": args,
                        "env": [{"name": "DYNTPU_STORE_ADDR",
                                 "value": self.store_addr}],
                    }]},
                },
            },
        }

    async def _get_deployment(self, name: str) -> Optional[dict]:
        try:
            return await self.api._request("GET", self._deploy_path(name))
        except K8sApiError as exc:
            if exc.status == 404:
                return None
            raise

    # --------------------------- reconcile -----------------------------

    async def reconcile_once(self) -> int:
        """One level-triggered pass; returns the number of scale actions."""
        self.num_reconciles += 1
        actions = 0
        try:
            crs = await self.api.list_graph_deployments()
        except Exception:
            log.exception("listing graph deployments failed — skipping pass")
            return 0
        for cr in crs:
            try:
                actions += await self._reconcile_cr(cr)
            except Exception:
                log.exception("reconcile of %s failed",
                              cr.get("metadata", {}).get("name"))
        return actions

    async def _reconcile_cr(self, cr: dict) -> int:
        cr_name = cr["metadata"]["name"]
        services = cr.get("spec", {}).get("services", {})
        actions = 0
        status_services = {}
        all_ready = True
        for service, svc_spec in services.items():
            want = int(svc_spec.get("replicas", 1))
            name = f"{cr_name}-{service}"
            dep = await self._get_deployment(name)
            if dep is None:
                await self.api._request(
                    "POST", self._deploy_path(),
                    body=self._render_deployment(cr_name, service,
                                                 svc_spec),
                )
                log.info("created deployment %s (replicas=%d)", name, want)
                actions += 1
                all_ready = all_ready and want == 0
                status_services[service] = {"replicas": 0}
                continue
            have = int(dep.get("spec", {}).get("replicas", 0))
            if have != want:
                await self.api._request(
                    "PATCH", self._deploy_path(name),
                    body={"spec": {"replicas": want}},
                    content_type="application/merge-patch+json",
                )
                log.info("scaled %s: %d -> %d", name, have, want)
                self.num_scales += 1
                actions += 1
            ready = int(dep.get("status", {}).get("readyReplicas", 0))
            status_services[service] = {"replicas": ready}
            if ready != want:
                all_ready = False
        # mirror observed state into the CR status (what the planner's
        # mid-rollout guard reads)
        await self.api._request(
            "PATCH",
            self.api._cr_path(cr_name) + "/status",
            body={"status": {
                "services": status_services,
                "conditions": [{
                    "type": "Ready",
                    "status": "True" if all_ready else "False",
                }],
            }},
            content_type="application/merge-patch+json",
        )
        return actions

    async def run(self, interval_s: float) -> None:
        log.info("operator reconciling %s/%s in %s every %.0fs",
                 GROUP, VERSION, self.api.config.namespace, interval_s)
        try:
            while True:
                await self.reconcile_once()
                await asyncio.sleep(interval_s)
        finally:
            await self.api.close()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu graph operator")
    p.add_argument("--image", default="dynamo-tpu-torch:latest")
    p.add_argument("--store-addr", default="store:4222")
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--namespace", default=None)
    p.add_argument("--base-url", default=None,
                   help="apiserver override (tests); default in-cluster")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    api = KubernetesAPI(KubeConfig(
        base_url=args.base_url, namespace=args.namespace,
    ) if (args.base_url or args.namespace) else None)
    controller = GraphController(api, image=args.image,
                                 store_addr=args.store_addr)
    asyncio.run(controller.run(args.interval))


if __name__ == "__main__":
    main()
