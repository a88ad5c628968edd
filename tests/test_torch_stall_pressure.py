"""The port's stall watchdog and HBM-pressure ladder, mirroring
``tests/test_stall_pressure.py``: each script runs on a port engine and on
a JAX engine with the same parameters (carried across by
``params_from_numpy``) and the results stand side by side.

Stall side: the deadline scales with scheduled tokens; a quarantined
bucket routes to the next rung (the same bucket choices as JAX); recovery
after an ``engine.stall`` delay is byte-identical to an un-stalled run and
to the JAX engine's stream; exhausted retries abort the seat; a stall
streak declares the worker dead. Pressure side: the rungs engage and
release with hysteresis at the same pool usages as JAX's; shedding refuses
admission and counts it; a drained pool reopens admission from
``submit``. CPU, ``ModelConfig.tiny(vocab_size=256)``, float32.
"""

import asyncio
import types

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.engine import Request as JaxRequest
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine, Request
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime import faults

PKGS = ("jax", "port")
CFG = dict(num_blocks=64, block_size=4, max_model_len=128,
           max_num_batched_tokens=128, prefill_buckets=(128,),
           decode_buckets=(4, 8), max_num_seqs=4)
PROMPT = [7, 3, 11, 42, 9, 100, 55, 2, 91, 13, 77, 5, 31, 8, 60, 24,
          17, 45, 88, 6, 29, 73, 50, 12]


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def tree():
    """One set of tiny(vocab 256) parameters, as numpy, for both
    packages."""
    engine = JaxEngine(JaxModelConfig.tiny(vocab_size=256),
                       JaxEngineConfig(**CFG), seed=0)
    return jax.tree.map(np.asarray, engine.params)


def make_engine(pkg, tree, **kw):
    if pkg == "jax":
        return JaxEngine(JaxModelConfig.tiny(vocab_size=256),
                         JaxEngineConfig(**CFG, **kw), seed=0)
    mc = ModelConfig.tiny(vocab_size=256)
    return InferenceEngine(mc, EngineConfig(**CFG, **kw),
                           params=params_from_numpy(tree, mc, "cpu"),
                           device="cpu")


def mk_req(pkg, rid, prompt, max_tokens=8, **kw):
    cls = JaxRequest if pkg == "jax" else Request
    return cls(request_id=rid, token_ids=list(prompt),
               max_tokens=max_tokens, ignore_eos=True, **kw)


def install(pkg, plan_fn):
    """A seeded plan with one rule, on ``pkg``'s fault registry."""
    mod = jfaults if pkg == "jax" else faults
    plan = mod.FaultPlan(seed=0)
    plan_fn(plan)
    mod.install(plan)
    return plan


async def collect(aiter):
    toks, reason = {}, None
    async for out in aiter:
        if out.token_id >= 0:
            toks[out.index] = out.token_id
        if out.finished:
            reason = out.finish_reason
    return [toks[i] for i in sorted(toks)], reason


def serve(engine, req, timeout=60.0):
    async def run():
        try:
            return await asyncio.wait_for(collect(engine.submit(req)),
                                          timeout=timeout)
        finally:
            await engine.stop()
    return asyncio.run(run())


# --------------------------- stall watchdog -----------------------------


def test_stall_deadline_scales_with_scheduled_work(tree):
    batch = types.SimpleNamespace(
        prefills=[types.SimpleNamespace(length=100)],
        decode_rows=[types.SimpleNamespace(accepted=2)] * 2,
    )
    got = {}
    for pkg in PKGS:
        eng = make_engine(pkg, tree, stall_timeout_s=1.0,
                          stall_timeout_per_token_s=0.01)
        off = make_engine(pkg, tree)
        got[pkg] = (eng._stall_deadline(batch), off._stall_deadline(batch))
    assert got["port"] == got["jax"]
    assert got["port"][0] == pytest.approx(1.0 + 0.01 * 104)
    assert got["port"][1] is None  # stall_timeout_s == 0: watchdog off


def test_quarantined_bucket_routes_to_next_rung(tree):
    """The same bucket choices as JAX before and after a quarantine; the
    wedged rung's work pads into the next one up."""
    def script(eng):
        seen = [eng._bucket_for("decode", n) for n in (1, 3, 4, 5, 8)]
        eng._quarantine_shape(("decode", 4))
        seen += [eng._bucket_for("decode", n) for n in (1, 3, 4, 5, 8)]
        seen += [eng._bucket_for("prefill", n) for n in (1, 30, 128)]
        return seen, sorted(eng._shape_quarantine)

    got = {pkg: script(make_engine(pkg, tree)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"][0][:10] == [4, 4, 4, 8, 8, 8, 8, 8, 8, 8]
    assert got["port"][1] == [("decode", 4)]


def test_largest_decode_bucket_rebuilds_on_einsum(tree):
    """A wedge of the largest rung has no rung to route to: the window is
    rebuilt once on the einsum attention impl (a new graph on a card),
    as the JAX engine rebuilds its executable; the stream it then serves
    stays the un-stalled one."""
    eng = make_engine("port", tree)
    want = serve(make_engine("port", tree),
                 mk_req("port", "e0", PROMPT, max_tokens=6))
    eng._quarantine_shape(("decode", 8))
    assert eng.num_einsum_rebuilds == 1 and not eng._shape_quarantine
    jeng = make_engine("jax", tree)
    jeng._quarantine_shape(("decode", 8))
    assert jeng._stall_einsum_fallback and not jeng._shape_quarantine
    got = serve(eng, mk_req("port", "e0", PROMPT, max_tokens=6))
    assert got == want


def test_stall_recovery_is_byte_identical(tree):
    """An engine.stall wedge on the port's run-ahead loop is detected,
    quarantined and replayed: the stream equals the un-stalled port run
    and the JAX engine's."""
    jwant = serve(make_engine("jax", tree),
                  mk_req("jax", "stall0", PROMPT, max_tokens=8))
    want = serve(make_engine("port", tree),
                 mk_req("port", "stall0", PROMPT, max_tokens=8))
    plan = install("port", lambda p: p.delay("engine.stall", 2.0, after=3,
                                             times=1))
    eng = make_engine("port", tree, stall_timeout_s=0.3,
                      stall_seq_retries=4, stall_dead_threshold=10)
    assert eng.pipeline_depth == 2
    got = serve(eng, mk_req("port", "stall0", PROMPT, max_tokens=8))
    assert plan.fired("engine.stall") >= 1
    assert eng.num_stalls >= 1 and not eng.stall_dead
    assert eng._shape_quarantine, "stall must quarantine a shape class"
    assert got == want == jwant, (got, want, jwant)


@pytest.mark.parametrize("pkg", PKGS)
def test_stall_retries_exhausted_aborts_seat(tree, pkg):
    install(pkg, lambda p: p.delay("engine.stall", 2.0, after=2, times=1))
    eng = make_engine(pkg, tree, stall_timeout_s=0.3, stall_seq_retries=0,
                      stall_dead_threshold=10)
    _, reason = serve(eng, mk_req(pkg, "stall1", PROMPT, max_tokens=8))
    assert eng.num_stalls >= 1
    assert reason == "error"
    # no leaked state: the seat is gone and its blocks returned
    assert not eng.scheduler.running and not eng.scheduler.waiting


@pytest.mark.parametrize("pkg", PKGS)
def test_stall_streak_declares_worker_dead(tree, pkg):
    install(pkg, lambda p: p.delay("engine.stall", 2.0, after=2, times=1))
    eng = make_engine(pkg, tree, stall_timeout_s=0.3, stall_seq_retries=5,
                      stall_dead_threshold=1)

    async def run():
        try:
            _, reason = await asyncio.wait_for(
                collect(eng.submit(mk_req(pkg, "stall2", PROMPT))), 60.0)
            with pytest.raises(RuntimeError, match="declared dead"):
                async for _ in eng.submit(mk_req(pkg, "stall3", PROMPT)):
                    pass
            return reason
        finally:
            await eng.stop()

    assert asyncio.run(run()) == "error"
    assert eng.stall_dead


# --------------------------- pressure ladder ----------------------------


class _DialPool:
    """Wraps the real pool but reports a dialled usage fraction."""

    def __init__(self, pool):
        self._pool = pool
        self.value = 0.0

    @property
    def usage(self):
        return self.value

    def __getattr__(self, name):
        return getattr(self._pool, name)


def _dialled_engine(pkg, tree, **kw):
    eng = make_engine(pkg, tree, pressure_spill_threshold=0.5,
                      pressure_spec_threshold=0.65,
                      pressure_shed_threshold=0.8, pressure_release=0.1,
                      **kw)
    dial = _DialPool(eng.scheduler.pool)
    eng.scheduler.pool = dial
    return eng, dial


def test_pressure_rungs_engage_and_release_with_hysteresis(tree):
    usages = (0.9, 0.75, 0.69, 0.52, 0.2, 0.66, 0.81, 0.0)
    got = {}
    for pkg in PKGS:
        eng, dial = _dialled_engine(pkg, tree)
        trace = []
        for u in usages:
            dial.value = u
            eng._pressure_tick()
            trace.append((eng.pressure_level, eng.pressure_shedding,
                          eng._pressure_spec_paused))
        got[pkg] = (trace, eng.pressure_peak)
    assert got["port"] == got["jax"]
    assert [t[0] for t in got["port"][0]] == [3, 3, 2, 1, 0, 2, 3, 0]
    assert got["port"][1] == 3


def test_pressure_ladder_disabled_by_default(tree):
    for pkg in PKGS:
        eng = make_engine(pkg, tree)
        eng._pressure_tick()
        assert eng.pressure_level == 0 and not eng.pressure_shedding


@pytest.mark.parametrize("pkg", PKGS)
def test_shed_rejects_admission_and_counts(tree, pkg):
    eng, dial = _dialled_engine(pkg, tree)
    dial.value = 0.9
    eng._pressure_tick()

    async def run():
        try:
            with pytest.raises(RuntimeError, match="admission shed"):
                async for _ in eng.submit(mk_req(pkg, "shed0", PROMPT)):
                    pass
        finally:
            await eng.stop()

    asyncio.run(run())
    assert eng.num_pressure_shed == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_drained_pool_reopens_admission_from_submit(tree, pkg):
    """If every seat drains while the shed flag is up and the loop idles,
    submit() itself re-evaluates the ladder instead of shedding forever on
    a stale flag."""
    eng, dial = _dialled_engine(pkg, tree)
    dial.value = 0.9
    eng._pressure_tick()
    assert eng.pressure_shedding
    dial.value = 0.1  # the wave drained; the idle loop never ticked
    got, reason = serve(eng, mk_req(pkg, "reopen0", PROMPT, max_tokens=4))
    assert not eng.pressure_shedding
    assert reason is not None and len(got) == 4


def test_spill_rung_preempts_a_seat_and_it_recovers(tree):
    """Rung 1 on a live engine: the spilled seat re-prefills and its
    stream stays the un-pressured one."""
    want = serve(make_engine("port", tree),
                 mk_req("port", "spill0", PROMPT, max_tokens=8))
    eng = make_engine("port", tree, pressure_spill_threshold=0.01)
    got = serve(eng, mk_req("port", "spill0", PROMPT, max_tokens=8))
    assert eng.num_pressure_spills >= 1 and eng.pressure_peak == 1
    assert got == want
