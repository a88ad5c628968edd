"""The port's SLA planner (``dynamo_tpu_torch/planner/``) held against the
JAX package's on the CPU. Tolerance: none — every comparison is equality.

* predictors, interpolators and ``Planner`` targets (and its degradation
  orders and broadcast events) over the same window sequences;
* ``VirtualConnector`` store keys and payloads, and the planner-events
  bytes (the port's codec against ``msgpack.packb``), on one store;
* the orchestrator's moves against the same targets and pool;
* the profiler at ``--model tiny --device cpu`` writes the reference's
  keys and both packages' interpolators load its file; it refuses what one
  card does not serve, and the card when none is present.
"""

import asyncio
import json
import math

import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu import planner as jp
from dynamo_tpu.planner import orchestrator as jorch
from dynamo_tpu.runtime.store import StoreServer
from dynamo_tpu_torch import planner as tp
from dynamo_tpu_torch.planner import __main__ as tmain
from dynamo_tpu_torch.planner import orchestrator as torch_orch
from dynamo_tpu_torch.planner import profiler as tprof
from dynamo_tpu_torch.runtime.store import StoreClient

SIDES = {"jax": jp, "port": tp}
NAN = float("nan")
# the observation streams a startup gap or a store outage produces, with
# a trend and a period for the AR fit to follow
OBSERVATIONS = {
    "trend": [float(3 * i + 1) for i in range(20)],
    "gaps": [5.0, None, 7.0, NAN, 9.0, float("inf"), 11.0, 12.5, None,
             14.0, 13.0, 15.5, 17.0, 16.0, 18.5],
    "periodic": [10 + 5 * math.sin(i / 2) for i in range(40)],
    "noisy": list(np.random.default_rng(0).gamma(2.0, 3.0, 30)),
}


@pytest.mark.parametrize("series", sorted(OBSERVATIONS))
@pytest.mark.parametrize("name", ["ConstantPredictor",
                                  "MovingAveragePredictor", "ARPredictor"])
def test_predictors_equal_jax(name, series):
    preds = {side: getattr(m, name)() for side, m in SIDES.items()}
    for v in OBSERVATIONS[series]:
        got = {}
        for side, p in preds.items():
            p.observe(v)
            got[side] = p.predict()
        assert got["port"] == got["jax"]


def _profile(seed):
    rng = np.random.default_rng(seed)
    isl = sorted(rng.choice(np.arange(64, 8192), 5, replace=False).tolist())
    return {
        "prefill_isl": isl,
        "prefill_ttft_s": sorted(rng.uniform(0.01, 2.0, 5).tolist()),
        "prefill_thpt_per_chip": rng.uniform(5e3, 2e4, 5).tolist(),
        "decode_kv_usage": rng.uniform(0.0, 1.0, 8).round(4).tolist(),
        "decode_context_length": rng.choice([256, 1024, 4096], 8).tolist(),
        "decode_itl_s": rng.uniform(0.005, 0.2, 8).tolist(),
        "decode_thpt_per_chip": rng.uniform(100, 5000, 8).tolist(),
    }


def _interps(m, profile):
    return (m.PrefillInterpolator.from_profile(profile),
            m.DecodeInterpolator.from_profile(profile))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolators_equal_jax(seed):
    profile = _profile(seed)
    (jpre, jdec), (tpre, tdec) = (_interps(m, profile)
                                  for m in (jp, tp))
    rng = np.random.default_rng(seed + 10)
    for isl in [0.0, 32.0, 9000.0] + rng.uniform(0, 9000, 16).tolist():
        assert tpre.interpolate_ttft(isl) == jpre.interpolate_ttft(isl)
        assert (tpre.interpolate_thpt_per_chip(isl)
                == jpre.interpolate_thpt_per_chip(isl))
    for kv, ctx in [(-0.5, 100.0), (1.5, 5000.0)] + list(zip(
            rng.uniform(0, 1, 16).tolist(),
            rng.uniform(128, 4096, 16).tolist())):
        assert tdec.interpolate_itl(kv, ctx) == jdec.interpolate_itl(kv, ctx)
        assert (tdec.interpolate_thpt_per_chip(kv, ctx)
                == jdec.interpolate_thpt_per_chip(kv, ctx))
    for itl in (0.001, 0.02, 0.1, 1.0):
        for ctx in (256.0, 1500.0, 4096.0):
            assert (tdec.find_best_throughput_per_chip(itl, ctx)
                    == jdec.find_best_throughput_per_chip(itl, ctx))


def _windows(seed, n=24):
    """A seeded window sequence: ramp, burst, breaker and preemption
    signals, a few invalid (startup/outage) windows, percentiles present
    or absent."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        burst = 4.0 if 8 <= i < 14 else 1.0
        kw = dict(
            num_requests=float(rng.poisson(40 * burst)) if i != 3 else 0.0,
            isl_avg=float(rng.uniform(200, 1200)),
            osl_avg=float(rng.uniform(32, 256)),
            ttft_avg_s=float(rng.uniform(0.05, 0.4) * burst),
            itl_avg_s=float(rng.uniform(0.01, 0.04) * burst),
            queue_depth=float(rng.integers(0, 30)) if burst > 1 else 0.0,
            breaker_open=int(rng.integers(0, 3)) if i % 5 == 0 else 0,
            spec_acceptance=float(rng.uniform(0.3, 0.8)),
            preempt_notices=1 if i == 10 else 0,
        )
        if i % 3:
            kw.update(ttft_p50_s=kw["ttft_avg_s"] * 0.8,
                      ttft_p99_s=kw["ttft_avg_s"] * 2.5,
                      itl_p50_s=kw["itl_avg_s"] * 0.9,
                      itl_p99_s=kw["itl_avg_s"] * 2.0)
        out.append(kw)
    return out


async def _drive(m, profile, windows, **cfg):
    conn = m.CallbackConnector()
    pre, dec = _interps(m, profile)
    planner = m.Planner(m.PlannerConfig(**cfg), pre, dec, conn)
    targets = []
    for kw in windows:
        planner.observe(m.WindowMetrics(**kw))
        targets.append(await planner.make_adjustments())
    return {"targets": targets, "calls": conn.calls,
            "degradations": conn.degradations, "events": conn.events,
            "corrections": (planner.p_correction, planner.d_correction),
            "ladder": list(planner.ladder.transitions)
            if planner.ladder else None}


@pytest.mark.parametrize("cfg", [
    {},
    {"sla_quantile": "avg", "max_chip_budget": 8, "min_endpoint": 2},
    {"sla_quantile": "p50", "degradation": None,
     "compensate_breakers": False, "compensate_preemptions": False},
    {"ttft_sla_s": 0.2, "itl_sla_s": 0.02, "adjustment_interval_s": 5.0,
     "prefill_engine_num_chips": 2, "decode_engine_num_chips": 4,
     "predictor_order": 2},
], ids=["default", "avg-budget", "p50-no-ladder", "tight-multichip"])
@pytest.mark.parametrize("seed", [0, 1])
def test_planner_targets_equal_jax(seed, cfg):
    profile = _profile(seed)
    windows = _windows(seed)
    want = asyncio.run(_drive(jp, profile, windows, **cfg))
    got = asyncio.run(_drive(tp, profile, windows, **cfg))
    assert got == want
    assert any(t is not None for t in want["targets"])


@pytest.fixture
def store_addr():
    """A JAX store server (the wire both packages speak)."""
    holder = {}

    async def start():
        holder["server"] = StoreServer(host="127.0.0.1", port=0)
        await holder["server"].start()

    loop = asyncio.new_event_loop()
    loop.run_until_complete(start())
    yield loop, f"127.0.0.1:{holder['server'].port}"
    loop.run_until_complete(holder["server"].stop())
    loop.close()


def _strip_ts(raw):
    d = json.loads(raw)
    d.pop("ts", None)
    return d


def test_virtual_connector_store_keys_and_payloads_equal_jax(store_addr):
    """Both connectors over one store: the same keys, the same JSON (the
    wall-clock ``ts`` aside), the same decision counters across a planner
    restart, and planner events whose bytes equal ``msgpack.packb``."""
    loop, addr = store_addr
    from dynamo_tpu.runtime.store import StoreClient as JaxStoreClient

    events = [{"kind": "scale", "prefill": 3, "decode": 7},
              {"kind": "degradation", "direction": "engage",
               "step": "shed_low_tier", "level": 1, "pressure": 2.5},
              {"kind": "preemption", "notices": 2}]

    async def scenario(m, client, ns):
        conn = m.VirtualConnector(client, namespace=ns)
        sub = await client.subscribe(
            (jp.connector if m is jp else tp.connector)
            .planner_events_subject(ns))
        await conn.scale("backend", 5)
        await conn.scale("prefill", 2)
        await conn.scale("backend", 5)         # redundant: skipped
        await conn.set_degradation({"level": 1, "steps": ["shed_low_tier"],
                                    "min_tier": 1, "spec_k_max": None,
                                    "prefill_chunk_tokens_max": None})
        await conn.set_degradation({"level": 1, "steps": ["shed_low_tier"],
                                    "min_tier": 1, "spec_k_max": None,
                                    "prefill_chunk_tokens_max": None})
        again = m.VirtualConnector(client, namespace=ns)
        await again.scale("prefill", 2)        # restored: still redundant
        await again.scale("prefill", 4)
        for ev in events:
            await again.publish_event(ev)
        frames = []
        for _ in events:
            while True:
                ev = await asyncio.wait_for(sub.next(), 5.0)
                if ev["event"] == "msg":
                    frames.append(bytes(ev["value"]))
                    break
        await sub.cancel()
        keys = await client.get_prefix(f"planner/{ns}/")
        return ({k.split("/", 2)[2]: _strip_ts(v) for k, v in keys},
                (conn.decision_count, again.decision_count),
                await again.read_target("prefill"),
                await again.read_degradation() is not None, frames)

    async def both():
        jc = await JaxStoreClient.connect(addr)
        tc = await StoreClient.connect(addr)
        try:
            return (await scenario(jp, jc, "nsj"),
                    await scenario(tp, tc, "nst"))
        finally:
            await jc.close()
            await tc.close()

    want, got = loop.run_until_complete(both())
    assert got == want
    assert got[-1] == [msgpack.packb(e, use_bin_type=True) for e in events]
    assert tp.connector.planner_events_subject("x") \
        == jp.connector.planner_events_subject("x")
    from dynamo_tpu_torch import serving
    assert serving.planner_events_subject is tp.connector \
        .planner_events_subject


class _FakeStore:
    def __init__(self):
        self.data = {}

    async def get(self, key):
        return self.data.get(key)

    async def put(self, key, value):
        self.data[key] = value


class _FakePool:
    def __init__(self, prefill, decode):
        self._w = {"prefill": list(prefill), "backend": list(decode)}
        self._next = 100
        self.log = []

    def workers(self, component):
        return sorted(self._w[component])

    async def spawn(self, component):
        self._next += 1
        self._w[component].append(self._next)
        self.log.append(("spawn", component, self._next))
        return self._next

    async def stop(self, wid):
        for ws in self._w.values():
            if wid in ws:
                ws.remove(wid)
        self.log.append(("stop", wid))

    async def flip(self, wid, component):
        for ws in self._w.values():
            if wid in ws:
                ws.remove(wid)
        self._w[component].append(wid)
        self.log.append(("flip", wid, component))


@pytest.mark.parametrize("steps", [
    [(1, 4), (1, 4), (3, 3), (0, 1)],
    [(20, 20), (2, 2)],
    [(5, 1), (1, 5), (2, 2), (6, 6)],
    [("bad", 2), (2, None)],
], ids=["flips", "budget", "swing", "malformed"])
@pytest.mark.parametrize("flip_enabled", [True, False])
def test_orchestrator_moves_equal_jax(steps, flip_enabled):
    async def run(mod):
        store = _FakeStore()
        pool = _FakePool(prefill=[1, 2, 3], decode=[4, 5])
        orch = mod.Orchestrator(store, pool, namespace="ns",
                                max_chip_budget=10,
                                flip_enabled=flip_enabled)
        moves = []
        for p, d in steps:
            for comp, n in (("prefill", p), ("backend", d)):
                store.data[f"planner/ns/target/{comp}"] = (
                    json.dumps({"replicas": n}).encode() if n != "bad"
                    else b"{not json")
            moves.append(await orch.reconcile())
        return moves, pool.log, vars(orch.stats)

    assert asyncio.run(run(torch_orch)) == asyncio.run(run(jorch))


def test_profiler_tiny_cpu_writes_the_reference_keys(tmp_path):
    out = tmp_path / "profile.json"
    tprof.main(["--model", "tiny", "--device", "cpu", "--num-blocks", "256",
                "--isls", "16,48", "--batches", "1,3", "--contexts",
                "16,40", "--out", str(out)])
    prof = json.loads(out.read_text())
    assert set(prof) == {
        "prefill_isl", "prefill_ttft_s", "prefill_thpt_per_chip",
        "decode_kv_usage", "decode_context_length", "decode_itl_s",
        "decode_thpt_per_chip", "meta"}
    assert prof["prefill_isl"] == [16, 48]
    assert prof["decode_context_length"] == [16 + 16, 40 + 16] * 2
    assert prof["meta"] == {"model": "tiny", "mesh": [1, 1],
                            "num_blocks": 256}
    assert all(v > 0 for v in prof["prefill_ttft_s"]
               + prof["prefill_thpt_per_chip"] + prof["decode_itl_s"]
               + prof["decode_thpt_per_chip"])
    assert all(0 < u <= 1 for u in prof["decode_kv_usage"])
    for m in (jp, tp):
        pre, dec = _interps(m, prof)
        assert pre.interpolate_ttft(32) > 0
        assert dec.find_best_throughput_per_chip(1.0, 40)[0] > 0


@pytest.mark.parametrize("flags,match", [
    (["--model", "70b"], "--model 70b"),
    (["--mesh", "2,1,1"], "too many values to unpack"),
])
def test_profiler_refuses_what_one_card_does_not_serve(flags, match):
    """``--model 70b`` does not fit one card; a 3-number ``--mesh`` raises
    the JAX profiler's ``ValueError`` (``--mesh D,N`` is served:
    tests/test_torch_mesh_launch.py)."""
    args = tprof.parse_args(flags + ["--device", "cpu"])
    err = NotImplementedError if "70b" in flags else ValueError
    with pytest.raises(err, match=match):
        tprof.build_engine(args)


def test_profiler_without_device_raises_on_a_cpu_machine(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.build_engine(tprof.parse_args(["--model", "tiny"]))


def test_planner_cli_parses_as_jax():
    from dynamo_tpu.planner import __main__ as jmain
    argv = ["--profile", "p.json", "--ttft", "0.2", "--itl", "0.01",
            "--connector", "kubernetes", "--k8s-deployment", "g",
            "--engage-ratio", "1.2", "--no-degradation"]
    assert vars(tmain.parse_args(argv)) == vars(jmain.parse_args(argv))
