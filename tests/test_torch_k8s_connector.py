"""The port's Kubernetes scaling connector on its own HTTP/1.1 client
(``dynamo_tpu_torch/utils/httpclient.py`` in place of ``aiohttp``) against
the fake apiserver of ``tests/test_k8s_connector.py``: list, get,
merge-patch, the bearer token, the mid-rollout skip and the error cases
hold as they do for the JAX connector, over one kept-alive connection.
The client's framings (chunked, close-delimited, a line stream) are held
against ``aiohttp.web`` responses too."""

import pytest
from aiohttp import web

from dynamo_tpu.planner import kubernetes_connector as jk
from dynamo_tpu_torch.planner import kubernetes_connector as tk
from dynamo_tpu_torch.utils.httpclient import HttpClient
from test_k8s_connector import FakeKubeApi, deployment

pytestmark = pytest.mark.anyio


class CountingKubeApi(FakeKubeApi):
    """The JAX tests' fake apiserver, counting client connections (peer
    ports) and answering 403 for one forbidden name."""

    def __init__(self, namespace="prod"):
        super().__init__(namespace)
        self.peers = set()

        @web.middleware
        async def seen(request, handler):
            self.peers.add(request.transport.get_extra_info("peername"))
            if request.match_info.get("name") == "forbidden":
                return web.json_response({"reason": "Forbidden"},
                                         status=403)
            return await handler(request)

        self.app.middlewares.append(seen)

    def port_config(self) -> tk.KubeConfig:
        return tk.KubeConfig(base_url=f"http://127.0.0.1:{self.port}",
                             namespace=self.namespace, token="test-token")


@pytest.fixture
async def fake_api():
    api = CountingKubeApi()
    await api.start()
    yield api
    for client in api.clients:
        await client.close()
    await api.stop()


def test_constants_equal_jax():
    assert (tk.GROUP, tk.VERSION, tk.PLURAL, tk.SA_DIR) == (
        jk.GROUP, jk.VERSION, jk.PLURAL, jk.SA_DIR)


async def test_scale_patches_service_replicas(fake_api):
    fake_api.objects["graph"] = deployment()
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    conn = tk.KubernetesConnector(api)
    await conn.scale("backend", 3)
    assert fake_api.patches == [
        ("graph", {"spec": {"services": {"backend": {"replicas": 3}}}})
    ]
    assert await conn.read_target("backend") == 3
    assert conn.decision_count == 1
    assert fake_api.auth_headers
    assert all(h == "Bearer test-token" for h in fake_api.auth_headers)
    # list, list, patch, list: one kept-alive connection
    assert len(fake_api.peers) == 1


async def test_both_connectors_make_the_same_calls(fake_api):
    """The same scale sequence through the JAX and the port connector
    leaves the same patches, auth headers and decision counts."""
    results = []
    for side, cfg in (("jax", fake_api.config()),
                      ("port", fake_api.port_config())):
        fake_api.objects = {"graph": deployment(
            replicas={"backend": 1, "prefill": 1})}
        fake_api.patches, fake_api.auth_headers = [], []
        mod = jk if side == "jax" else tk
        api = mod.KubernetesAPI(cfg)
        fake_api.clients.append(api)
        conn = mod.KubernetesConnector(api, deployment_name="graph")
        for comp, n in (("backend", 3), ("backend", 3), ("prefill", 2),
                        ("backend", 1)):
            await conn.scale(comp, n)
        results.append((fake_api.patches, fake_api.auth_headers,
                        conn.decision_count,
                        await conn.read_target("prefill"),
                        fake_api.objects["graph"]))
    assert results[1] == results[0]


async def test_scale_noop_when_already_at_target(fake_api):
    fake_api.objects["graph"] = deployment()
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    conn = tk.KubernetesConnector(api)
    await conn.scale("backend", 1)
    assert fake_api.patches == []
    assert conn.decision_count == 0


async def test_scale_skipped_mid_rollout(fake_api):
    fake_api.objects["graph"] = deployment(ready=False)
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    conn = tk.KubernetesConnector(api)
    await conn.scale("backend", 5)
    assert fake_api.patches == []


async def test_unknown_component_rejected(fake_api):
    fake_api.objects["graph"] = deployment()
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    conn = tk.KubernetesConnector(api)
    with pytest.raises(ValueError, match="not in deployment"):
        await conn.scale("nonexistent", 2)


async def test_missing_deployment_raises(fake_api):
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    conn = tk.KubernetesConnector(api)
    with pytest.raises(RuntimeError, match="not found"):
        await conn.scale("backend", 2)
    assert await conn.read_target("backend") is None
    # a named CR that is missing is None (404), not an error
    assert await api.get_graph_deployment("nope") is None


async def test_forbidden_is_an_api_error(fake_api):
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    with pytest.raises(tk.K8sApiError) as exc:
        await api.get_graph_deployment("forbidden")
    assert exc.value.status == 403
    assert "Forbidden" in str(exc.value)


async def test_named_deployment_selected_among_many(fake_api):
    fake_api.objects["a"] = deployment("a", replicas={"backend": 1})
    fake_api.objects["b"] = deployment("b", replicas={"backend": 2})
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    conn = tk.KubernetesConnector(api, deployment_name="b")
    assert await conn.read_target("backend") == 2
    await conn.scale("backend", 4)
    assert fake_api.patches[0][0] == "b"


async def test_readiness_falls_back_to_status_services(fake_api):
    dep = deployment()
    dep["status"] = {"services": {"backend": {"replicas": 1},
                                  "prefill": {"replicas": 1}}}
    fake_api.objects["graph"] = dep
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    assert await api.is_ready(dep)
    dep["status"]["services"]["backend"]["replicas"] = 0
    assert not await api.is_ready(dep)


async def test_blocking_scale_waits_for_ready(fake_api):
    fake_api.objects["graph"] = deployment()
    api = tk.KubernetesAPI(fake_api.port_config())
    fake_api.clients.append(api)
    conn = tk.KubernetesConnector(api, blocking=True)
    await conn.scale("prefill", 2)
    assert await api.wait_ready("graph", timeout_s=1.0, poll_s=0.05)


async def test_client_framings_and_reconnect():
    """Chunked and close-delimited bodies, a line stream, a query string,
    and a server that closes the kept-alive connection between calls."""
    async def chunked(request):
        resp = web.StreamResponse()
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        for part in (b'{"a": ', b"1, ", b'"q": "' +
                     request.query.get("wave", "").encode() + b'"}'):
            await resp.write(part)
        await resp.write_eof()
        return resp

    async def sse(request):
        body = await request.json()
        resp = web.StreamResponse(headers={"Content-Type":
                                           "text/event-stream"})
        await resp.prepare(request)
        for i in range(body["n"]):
            await resp.write(f"data: {i}\n\n".encode())
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def closing(request):
        return web.Response(body=b"bye", headers={"Connection": "close"})

    app = web.Application()
    app.add_routes([web.get("/c", chunked), web.post("/s", sse),
                    web.get("/x", closing), web.delete("/c", chunked)])
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    client = HttpClient(f"http://127.0.0.1:{port}")
    try:
        r = await client.request("GET", "/c", params={"wave": "w 1"})
        assert r.status == 200 and r.json() == {"a": 1, "q": "w 1"}
        r = await client.request("GET", "/x")
        assert (r.status, r.body) == (200, b"bye") and client.closed
        r = await client.request("DELETE", "/c")
        assert r.json() == {"a": 1, "q": ""}
        status = []
        lines = [ln async for ln in client.stream_lines(
            "POST", "/s", body=b'{"n": 3}',
            headers={"Content-Type": "application/json"},
            status_out=status)]
        assert status == [200]
        assert [ln for ln in lines if ln.strip()] == [
            b"data: 0\n", b"data: 1\n", b"data: 2\n", b"data: [DONE]\n"]
        status = []
        assert [ln async for ln in client.stream_lines(
            "GET", "/missing", status_out=status)] == []
        assert status == [404]
        assert (await client.request("GET", "/missing")).status == 404
    finally:
        await client.close()
        await runner.cleanup()
