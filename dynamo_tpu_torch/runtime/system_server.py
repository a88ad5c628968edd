"""System status server: /health, /live, /metrics for any runtime process.

Role-equivalent to the reference's axum system server (ref: lib/runtime/src/
system_status_server.rs, enabled by DYN_SYSTEM_ENABLED/PORT — here
``DYNTPU_SYSTEM_ENABLED`` / ``DYNTPU_SYSTEM_PORT`` via RuntimeConfig). Health
aggregates registered probe callbacks (engines, endpoints) so orchestrators
can gate traffic on worker readiness.

A copy of ``dynamo_tpu.runtime.system_server`` on the port's own HTTP server
(``frontend/http.py``) and Prometheus exposition (``utils/metrics.py``) in
place of aiohttp and prometheus_client: the same routes, status codes and
JSON bodies. ``POST /preempt`` fires the registered maintenance-notice
triggers (the preemption coordinator, ``runtime/preemption.py``);
``GET /debug/profile?ms=N`` captures a ``torch.profiler`` trace
(``observability/profiling.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..frontend import http as web
from ..utils.logging import get_logger
from ..utils.metrics import CONTENT_TYPE_LATEST, MetricsRegistry

log = get_logger("system_server")

HealthProbe = Callable[[], dict]   # () -> {"healthy": bool, ...detail}


class SystemServer:
    def __init__(
        self,
        metrics: Optional[MetricsRegistry] = None,
        host: str = "0.0.0.0",
        port: int = 0,
        store=None,
    ):
        self.metrics = metrics
        self.host = host
        self.port = port
        # this process's StoreClient (when the owning runtime has one):
        # fault-plan installs kick clock-gated rules through it so chaos
        # replays fire deterministically (see _faults_install)
        self.store = store
        self._probes: Dict[str, HealthProbe] = {}
        # admin drain triggers: name -> zero-arg callable kicking off a
        # graceful drain (same path as SIGINT/SIGTERM)
        self._drain_handlers: Dict[str, Callable[[], None]] = {}
        # maintenance-notice triggers: name -> zero-arg callable kicking
        # off an evacuating drain (runtime.preemption)
        self._preempt_handlers: Dict[str, Callable[[], None]] = {}
        self._live = True
        self._app: Optional[web.Application] = None

    def register_probe(self, name: str, probe: HealthProbe) -> None:
        self._probes[name] = probe

    def unregister_probe(self, name: str) -> None:
        self._probes.pop(name, None)

    def register_drain(self, name: str, handler: Callable[[], None]) -> None:
        self._drain_handlers[name] = handler

    def register_preempt(self, name: str,
                         handler: Callable[[], None]) -> None:
        self._preempt_handlers[name] = handler

    def set_live(self, live: bool) -> None:
        self._live = live

    async def start(self) -> None:
        app = web.Application()
        app.add_routes([
            web.get("/health", self._health),
            web.get("/live", self._livez),
            web.post("/drain", self._drain),
            web.post("/preempt", self._preempt),
            web.get("/metrics", self._metrics),
            web.get("/debug/profile", self._profile),
            web.get("/debug/traces", self._traces),
            web.get("/debug/traces/{trace_id}", self._trace),
            web.get("/debug/faults", self._faults_get),
            web.post("/debug/faults", self._faults_install),
            web.delete("/debug/faults", self._faults_clear),
        ])
        self.port = await app.start(self.host, self.port)
        self._app = app
        log.info("system server on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._app is not None:
            await self._app.stop()
            self._app = None

    async def _health(self, request: web.Request) -> web.Response:
        detail = {}
        healthy = True
        for name, probe in self._probes.items():
            try:
                r = probe()
            except Exception as e:  # a broken probe is an unhealthy probe
                r = {"healthy": False, "error": str(e)}
            detail[name] = r
            healthy = healthy and bool(r.get("healthy", False))
        status = 200 if healthy or not self._probes else 503
        return web.json_response(
            {"status": "healthy" if status == 200 else "unhealthy",
             "probes": detail},
            status=status,
        )

    async def _drain(self, request: web.Request) -> web.Response:
        """Admin drain trigger: stop routing here, finish or migrate
        in-flight work, then exit clean. 202 — the drain runs async."""
        if not self._drain_handlers:
            return web.json_response(
                {"error": "nothing drainable registered"}, status=404
            )
        fired = []
        for name, handler in list(self._drain_handlers.items()):
            try:
                handler()
                fired.append(name)
            except Exception:
                log.exception("drain handler %s failed", name)
        return web.json_response({"draining": fired}, status=202)

    async def _preempt(self, request: web.Request) -> web.Response:
        """Maintenance-notice trigger (the HTTP twin of the node agent's
        SIGUSR1): evacuate in-flight KV to a peer / the host tier, then
        drain. 202 — the evacuation runs async against its deadline."""
        if not self._preempt_handlers:
            return web.json_response(
                {"error": "nothing preemptible registered"}, status=404
            )
        fired = []
        for name, handler in list(self._preempt_handlers.items()):
            try:
                handler()
                fired.append(name)
            except Exception:
                log.exception("preempt handler %s failed", name)
        return web.json_response({"evacuating": fired}, status=202)

    async def _livez(self, request: web.Request) -> web.Response:
        return web.json_response({"live": self._live},
                                 status=200 if self._live else 503)

    async def _metrics(self, request: web.Request) -> web.Response:
        body = self.metrics.render() if self.metrics else b""
        # exposition-format content type so conformant scrapers negotiate
        # the right parser
        return web.Response(body=body,
                            headers={"Content-Type": CONTENT_TYPE_LATEST})

    async def _profile(self, request: web.Request) -> web.Response:
        """On-demand device profile: ``GET /debug/profile?ms=N`` captures a
        ``torch.profiler`` trace for N ms (clamped) into a fresh directory
        and returns its path. One capture at a time per process;
        concurrent requests get 409."""
        from ..observability import profiling

        try:
            ms = int(request.query.get("ms", profiling.DEFAULT_MS))
        except ValueError:
            return web.json_response(
                {"error": "ms must be an integer"}, status=400
            )
        try:
            result = await profiling.capture(
                ms, base_dir=request.query.get("dir", "")
            )
        except profiling.ProfileBusyError as exc:
            return web.json_response({"error": str(exc)}, status=409)
        except Exception as exc:  # profiler unavailable in this process
            log.exception("profile capture failed")
            return web.json_response({"error": str(exc)}, status=500)
        return web.json_response(result)

    async def _traces(self, request: web.Request) -> web.Response:
        """Recent trace ids still resident in this process's span buffer."""
        from .. import tracing

        ids = tracing.get_tracer().trace_ids()
        return web.json_response({"trace_ids": ids, "count": len(ids)})

    async def _trace(self, request: web.Request) -> web.Response:
        """Assembled view of one trace (this process's spans only)."""
        from .. import tracing
        from ..tracing.assemble import assemble_trace

        trace_id = request.match_info["trace_id"]
        spans = tracing.get_tracer().get_trace(trace_id)
        if not spans:
            return web.json_response(
                {"error": f"unknown trace id {trace_id!r}"}, status=404
            )
        return web.json_response(assemble_trace([s.to_dict() for s in spans]))

    async def _faults_get(self, request: web.Request) -> web.Response:
        """The installed fault plan (rules + firing log), for replay
        attribution harvest and operator inspection."""
        from . import faults

        plan = faults.current()
        if plan is None:
            return web.json_response({"installed": False})
        return web.json_response(
            {"installed": True, "plan": plan.to_dict(include_log=True),
             "fired_counts": plan.fired_counts()})

    async def _faults_install(self, request: web.Request) -> web.Response:
        """Install (or extend) the process-global fault plan from its wire
        form. A body whose seed matches the installed plan *merges* its
        rules in — how the replay driver lands successive correlated fault
        waves on one process; any other seed (or no installed plan)
        replaces the plan wholesale."""
        from . import faults

        try:
            body = await request.json()
        except Exception:
            return web.json_response({"error": "body must be JSON"},
                                     status=400)
        try:
            incoming = faults.FaultPlan.from_dict(body)
        except (ValueError, KeyError, TypeError) as exc:
            return web.json_response({"error": str(exc)}, status=400)
        plan = faults.current()
        merged = False
        if plan is not None and plan.seed == incoming.seed:
            for rule in incoming.rules:
                plan.add(rule)
            merged = True
        else:
            plan = incoming
            faults.install(plan)
        log.info("fault plan %s: seed=%d rules=%d",
                 "merged" if merged else "installed", plan.seed,
                 len(plan.rules))
        # lease keepalives are wall-clock-periodic with a phase set at
        # client spawn, so a finite-times rule gating them would fire a
        # load-dependent 0..times within any replay window. Drive the op
        # directly, once per budgeted firing, so the count is exactly
        # ``times`` in every run.
        kicked = 0
        if self.store is not None:
            for rule in incoming.rules:
                if (rule.site == "store.call"
                        and rule.match == "lease_keepalive"):
                    for _ in range(max(1, int(rule.times or 1))):
                        await self.store.kick_keepalive()
                        kicked += 1
        return web.json_response(
            {"installed": True, "merged": merged, "seed": plan.seed,
             "rules": len(plan.rules), "kicked": kicked})

    async def _faults_clear(self, request: web.Request) -> web.Response:
        """Clear the fault plan — or just one wave's rules with ``?wave=``
        (the firing log survives for attribution)."""
        from . import faults

        wave = request.query.get("wave")
        plan = faults.current()
        if plan is None:
            return web.json_response({"installed": False, "removed": 0})
        if wave:
            removed = plan.clear_wave(wave)
            return web.json_response(
                {"installed": True, "wave": wave, "removed": removed})
        removed = len(plan.rules)
        faults.clear()
        return web.json_response({"installed": False, "removed": removed})
