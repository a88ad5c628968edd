"""Kubernetes scaling connector: the planner's targets realised by
merge-patching a graph-deployment custom resource
(ref: components/planner/src/dynamo/planner/kubernetes_connector.py,
kube.py — same contract, re-built on a minimal in-cluster REST client
instead of the kubernetes client package, which this image doesn't ship).

The custom resource (deploy/k8s/crd.yaml) holds one graph of serving
components:

    apiVersion: serving.dynamo-tpu.io/v1alpha1
    kind: TpuGraphDeployment
    spec:
      services:
        backend:  {replicas: 2}
        prefill:  {replicas: 1}

An operator-equivalent reconciler (in-cluster controller or
deploy/scripts/scale_watcher.py pointed at the CR) realises the replica
counts; the planner only writes intent, mirroring the reference's
decoupling. Scaling while the deployment is mid-rollout is skipped — the
same guard the reference applies before patching.

A copy of ``dynamo_tpu.planner.kubernetes_connector`` whose requests go
through the port's own HTTP/1.1 client (``utils/httpclient.py``) in place
of ``aiohttp``: one kept-alive connection, a 30 s timeout per request.
"""

from __future__ import annotations

import asyncio
import json
import os
import ssl
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..utils.httpclient import HttpClient
from ..utils.logging import get_logger

log = get_logger("planner.k8s")

GROUP = "serving.dynamo-tpu.io"
VERSION = "v1alpha1"
PLURAL = "tpugraphdeployments"

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclass
class KubeConfig:
    """In-cluster API access (the only mode the planner pod needs)."""

    host: str = field(default_factory=lambda: os.environ.get(
        "KUBERNETES_SERVICE_HOST", ""))
    port: str = field(default_factory=lambda: os.environ.get(
        "KUBERNETES_SERVICE_PORT", "443"))
    token: Optional[str] = None
    ca_path: Optional[str] = None
    namespace: Optional[str] = None
    # test/dev override: plain http endpoint, no auth
    base_url: Optional[str] = None

    def resolve(self) -> "KubeConfig":
        if self.base_url is None:
            self.base_url = f"https://{self.host}:{self.port}"
        if self.token is None and os.path.exists(f"{SA_DIR}/token"):
            with open(f"{SA_DIR}/token") as f:
                self.token = f.read().strip()
        if self.ca_path is None and os.path.exists(f"{SA_DIR}/ca.crt"):
            self.ca_path = f"{SA_DIR}/ca.crt"
        if self.namespace is None:
            ns_file = f"{SA_DIR}/namespace"
            if os.path.exists(ns_file):
                with open(ns_file) as f:
                    self.namespace = f.read().strip()
            else:
                self.namespace = "default"
        return self


class K8sApiError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class KubernetesAPI:
    """Minimal async client for the graph-deployment CR (role of the
    reference's kube.py, without the kubernetes package)."""

    def __init__(self, config: Optional[KubeConfig] = None):
        self.config = (config or KubeConfig()).resolve()
        self._client: Optional[HttpClient] = None  # lazy, kept alive
        self._ssl: Optional[ssl.SSLContext] = None
        if (self.config.base_url.startswith("https")
                and self.config.ca_path):
            self._ssl = ssl.create_default_context(
                cafile=self.config.ca_path
            )

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()
            self._client = None

    def _headers(self, content_type: str = "application/json") -> dict:
        headers = {"Accept": "application/json",
                   "Content-Type": content_type}
        if self.config.token:
            headers["Authorization"] = f"Bearer {self.config.token}"
        return headers

    def _cr_path(self, name: str = "") -> str:
        path = (f"/apis/{GROUP}/{VERSION}/namespaces/"
                f"{self.config.namespace}/{PLURAL}")
        return f"{path}/{name}" if name else path

    async def _request(self, method: str, path: str,
                       body: Optional[dict] = None,
                       content_type: str = "application/json") -> dict:
        if self._client is None:
            # one shared connection: a fresh one per request would pay a
            # TCP+TLS handshake on every poll of wait_ready
            self._client = HttpClient(self.config.base_url,
                                      ssl_context=self._ssl, timeout_s=30.0)
        resp = await self._client.request(
            method, path, headers=self._headers(content_type),
            body=None if body is None else json.dumps(body).encode(),
        )
        text = resp.text()
        if resp.status >= 400:
            raise K8sApiError(
                resp.status,
                f"k8s API {method} {path} -> {resp.status}: {text[:500]}",
            )
        return json.loads(text) if text else {}

    async def list_graph_deployments(self) -> list:
        out = await self._request("GET", self._cr_path())
        return out.get("items", [])

    async def get_graph_deployment(
        self, name: Optional[str] = None,
    ) -> Optional[dict]:
        """The named CR, or the single CR in the namespace (the common
        one-graph-per-namespace deployment shape)."""
        if name:
            try:
                return await self._request("GET", self._cr_path(name))
            except K8sApiError as exc:
                if exc.status == 404:
                    return None
                raise  # 403 etc. is a real error, not "missing CR"
        items = await self.list_graph_deployments()
        if not items:
            return None
        if len(items) > 1:
            log.warning("multiple graph deployments in %s — using %s",
                        self.config.namespace,
                        items[0]["metadata"]["name"])
        return items[0]

    async def patch_service_replicas(
        self, name: str, component: str, replicas: int,
    ) -> None:
        await self._request(
            "PATCH", self._cr_path(name),
            body={"spec": {"services": {component: {
                "replicas": int(replicas)}}}},
            content_type="application/merge-patch+json",
        )

    async def is_ready(self, deployment: dict) -> bool:
        """Rollout settled: every service's observed replicas match spec
        (the reference gates on the operator's ready condition; our
        reconciler mirrors counts into status.services)."""
        status = deployment.get("status", {})
        conditions = status.get("conditions", [])
        for cond in conditions:
            if cond.get("type") == "Ready":
                return cond.get("status") == "True"
        observed = status.get("services", {})
        spec = deployment.get("spec", {}).get("services", {})
        if not observed:
            return True  # no status reported yet — don't wedge scaling
        return all(
            observed.get(svc, {}).get("replicas")
            == spec.get(svc, {}).get("replicas")
            for svc in spec
        )

    async def wait_ready(self, name: str, timeout_s: float = 300.0,
                         poll_s: float = 2.0) -> bool:
        deadline = asyncio.get_running_loop().time() + timeout_s
        while asyncio.get_running_loop().time() < deadline:
            dep = await self.get_graph_deployment(name)
            if dep is not None and await self.is_ready(dep):
                return True
            await asyncio.sleep(poll_s)
        return False


class KubernetesConnector:
    """VirtualConnector-shaped scaling intent writer backed by the CR
    (the planner calls ``scale``; the cluster reconciler does the rest)."""

    def __init__(self, api: Optional[KubernetesAPI] = None,
                 deployment_name: Optional[str] = None,
                 blocking: bool = False):
        self.api = api or KubernetesAPI()
        self.deployment_name = deployment_name
        self.blocking = blocking
        self.decision_count = 0

    async def _deployment(self) -> dict:
        dep = await self.api.get_graph_deployment(self.deployment_name)
        if dep is None:
            raise RuntimeError(
                f"graph deployment "
                f"{self.deployment_name or '(any)'} not found in "
                f"{self.api.config.namespace}"
            )
        return dep

    async def scale(self, component: str, replicas: int) -> None:
        dep = await self._deployment()
        name = dep["metadata"]["name"]
        services = dep.get("spec", {}).get("services", {})
        if component not in services:
            raise ValueError(
                f"component {component!r} not in deployment {name} "
                f"(services: {sorted(services)})"
            )
        if not await self.api.is_ready(dep):
            # mid-rollout: piling a new target onto an unsettled rollout
            # thrashes pods (the reference applies the same guard)
            log.warning("deployment %s mid-rollout — skipping scale of "
                        "%s to %d", name, component, replicas)
            return
        current = services[component].get("replicas", 1)
        if current == int(replicas):
            return
        self.decision_count += 1
        await self.api.patch_service_replicas(name, component, replicas)
        log.info("scaled %s/%s: %d -> %d", name, component, current,
                 replicas)
        if self.blocking:
            await self.api.wait_ready(name)

    async def read_target(self, component: str) -> Optional[int]:
        dep = await self.api.get_graph_deployment(self.deployment_name)
        if dep is None:
            return None
        svc = dep.get("spec", {}).get("services", {}).get(component)
        return None if svc is None else int(svc.get("replicas", 1))
