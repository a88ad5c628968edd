"""The port's adaptive bucket ladders against the JAX package's.

Every scenario of ``tests/test_ladder.py`` runs through both
``BucketLadder`` classes: the decisions (events), the grid and the snapshot
must be equal, and each scenario's own expectation holds. Then the engines:
the port's tiny engine with ``adaptive_buckets`` splits its decode rung,
converges and captures no new window key after warm-up (the twin of
``test_engine_ladder_splits_converges_then_no_recompiles``), and on the
same trace it makes the JAX engine's rungs and greedy streams.
"""

import asyncio
import random

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu.engine.ladder import BucketLadder as JaxLadder
from dynamo_tpu.observability import compilewatch as jcompilewatch
from dynamo_tpu.observability.flops import FlopsModel as JaxFlopsModel
from dynamo_tpu.observability.stepstats import StepRecord as JaxStepRecord
from dynamo_tpu.observability.stepstats import StepStats as JaxStepStats
from dynamo_tpu_torch.engine import (
    EngineConfig, InferenceEngine, ModelConfig, Request,
)
from dynamo_tpu_torch.engine.ladder import BucketLadder
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.observability import compilewatch
from dynamo_tpu_torch.observability.flops import FlopsModel
from dynamo_tpu_torch.observability.stepstats import (
    DECODE, SPEC_VERIFY, StepRecord, StepStats,
)

SIDES = {
    "jax": dict(ladder=JaxLadder, stats=JaxStepStats, rec=JaxStepRecord,
                flops=JaxFlopsModel(JaxModelConfig.tiny())),
    "port": dict(ladder=BucketLadder, stats=StepStats, rec=StepRecord,
                 flops=FlopsModel(ModelConfig.tiny())),
}


def _acc(lad):
    return {b: list(v) for b, v in lad._acc.items()}


def _ladder(side, **over):
    kw = dict(kinds=(DECODE, SPEC_VERIFY), compile_budget=2,
              split_waste=0.25, retire_share=0.02, min_dispatches=8,
              hysteresis=2, step=8)
    kw.update(over)
    base = kw.pop("base", (64,))
    return SIDES[side]["ladder"]("decode", base, **kw)


# each scenario drives one ladder (and, for the recorder scenario, one
# StepStats pair) and returns what it decided; the test runs it on both
# packages and compares


def split_on_hot_waste(side):
    lad = _ladder(side)
    for _ in range(10):
        lad.observe(64, real=24, padded=64)
    events = lad.maybe_adapt()
    assert [e["op"] for e in events] == ["split"] and events[0]["new"] == 24
    return events, lad, [lad.bucket_for(10), lad.bucket_for(30),
                         lad.rung_at_most(63), lad.rung_at_most(5)]


def compile_budget(side):
    lad = _ladder(side, compile_budget=1, hysteresis=1)
    for _ in range(10):
        lad.observe(64, real=24, padded=64)
    events = lad.maybe_adapt()
    for _ in range(10):
        lad.observe(24, real=4, padded=24)
    for _ in range(5):
        events += lad.maybe_adapt()
        for _ in range(10):
            lad.observe(24, real=4, padded=24)
    assert lad.snapshot()["splits_total"] == 1
    return events, lad, None


def room_between(side):
    lad = _ladder(side, base=(8,))
    for _ in range(10):
        lad.observe(8, real=1, padded=8)
    events = lad.maybe_adapt()
    assert events == [] and lad.buckets() == (8,)
    return events, lad, None


def below_min_dispatches(side):
    lad = _ladder(side, min_dispatches=20)
    for _ in range(10):
        lad.observe(64, real=8, padded=64)
    events = lad.maybe_adapt()
    assert events == []
    for _ in range(10):
        lad.observe(64, real=8, padded=64)
    events += lad.maybe_adapt()
    assert [e["op"] for e in events] == ["split"]
    return events, lad, None


def retire_and_capacity_rung(side):
    lad = _ladder(side, base=(8, 64), min_dispatches=4, hysteresis=2)
    events = []
    for _ in range(2):
        for _ in range(5):
            lad.observe(64, real=60, padded=64)
        events += lad.maybe_adapt()
    assert [e["op"] for e in events] == ["retire"]
    lad2 = _ladder(side, base=(8, 64), min_dispatches=4, hysteresis=1)
    for _ in range(6):
        for _ in range(5):
            lad2.observe(8, real=7, padded=8)
        events += lad2.maybe_adapt()
    assert 64 in lad2.buckets()
    return events, lad, lad2.snapshot()


def no_flapping(side):
    lad = _ladder(side, base=(8, 64), min_dispatches=4, hysteresis=2)
    events = []
    for _ in range(4):
        for _ in range(5):
            lad.observe(64, real=4, padded=64)
        events.append(lad.maybe_adapt())
    assert [[e["op"] for e in ev] for ev in events] == [
        [], ["retire"], [], ["split"]]
    return events, lad, None


def converged(side):
    lad = _ladder(side, min_dispatches=4, hysteresis=2)
    for _ in range(6):
        lad.observe(64, real=24, padded=64)
    events = lad.maybe_adapt()
    flags = [lad.converged]
    for _ in range(4):
        for _ in range(6):
            lad.observe(24, real=22, padded=24)
        events += lad.maybe_adapt()
        flags.append(lad.converged)
    assert flags[0] is False and flags[-1] is True
    return events, lad, flags


def seeded_trace(side):
    rng = random.Random(1234)
    trace = [rng.randint(1, 64) for _ in range(400)]
    lad = _ladder(side, min_dispatches=16, hysteresis=2)
    events = []
    for i, real in enumerate(trace):
        lad.observe(lad.bucket_for(real), real, lad.bucket_for(real))
        if i % 20 == 19:
            events.extend(lad.maybe_adapt())
    return events, lad, None


def ingest_deltas(side):
    lad = _ladder(side, min_dispatches=8)
    lad.ingest({"decode:64": (10, 240, 640), "prefill:16": (5, 50, 80)})
    acc = [_acc(lad)]
    lad.ingest({"decode:64": (12, 260, 768)})
    acc.append(_acc(lad))
    events = lad.maybe_adapt()
    assert acc == [{64: [10, 240, 640]}, {64: [12, 260, 768]}]
    return events, lad, acc


def ingest_rebaseline(side):
    lad = _ladder(side, min_dispatches=8)
    lad.ingest({"decode:64": (10, 240, 640)})
    events = lad.maybe_adapt()
    lad.ingest({"decode:64": (1, 60, 64)})
    acc = [_acc(lad)]
    lad.ingest({"decode:64": (2, 120, 128)})
    acc.append(_acc(lad))
    lad.ingest({"spec_verify:64": (3, 30, 192)})
    acc.append(_acc(lad))
    assert acc[-1][64] == [4, 90, 256]
    return events, lad, acc


def padding_waste_drops(side):
    S = SIDES[side]
    clock = lambda: 100.0  # noqa: E731

    def drive(stats, bucket):
        for _ in range(10):
            stats.commit(S["rec"](
                kind=DECODE, t_dispatch=100.0, t_land=100.0,
                bucket=bucket, rows=bucket, live_rows=24,
                padded_tokens=bucket, real_tokens=24, goodput_tokens=24,
                context_sum=24 * 32))
        return stats.snapshot(max_age_s=0.0)["padding_waste_ratio"]

    before = S["stats"](S["flops"], clock=clock)
    waste_before = drive(before, bucket=64)
    lad = _ladder(side, min_dispatches=8)
    lad.ingest(before.bucket_occupancy())
    events = lad.maybe_adapt()
    waste_after = drive(S["stats"](S["flops"], clock=clock),
                        bucket=lad.bucket_for(24))
    assert waste_before > 0.3 and waste_after == 0.0
    return events, lad, [waste_before, waste_after]


SCENARIOS = [split_on_hot_waste, compile_budget, room_between,
             below_min_dispatches, retire_and_capacity_rung, no_flapping,
             converged, seeded_trace, ingest_deltas, ingest_rebaseline,
             padding_waste_drops]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_ladder_decisions_equal_jax(scenario):
    want_events, want_lad, want_extra = scenario("jax")
    got_events, got_lad, got_extra = scenario("port")
    assert got_events == want_events
    assert got_lad.buckets() == want_lad.buckets()
    assert got_lad.snapshot() == want_lad.snapshot()
    assert got_extra == want_extra


def test_ladder_knobs_read_the_jax_env_names(monkeypatch):
    for name, value in (("COMPILE_BUDGET", "3"), ("SPLIT_WASTE", "0.5"),
                        ("RETIRE_SHARE", "0.1"), ("MIN_DISPATCHES", "6"),
                        ("HYSTERESIS", "1")):
        monkeypatch.setenv(f"DYNTPU_LADDER_{name}", value)
    want, got = _ladder("jax"), _ladder("port")
    for knob in ("compile_budget", "split_waste", "retire_share",
                 "min_dispatches", "hysteresis"):
        assert getattr(got, knob) == getattr(want, knob)
    assert got.compile_budget == 3 and got.hysteresis == 1


# ---------------------------------------------------------------------------
# engines

ENG_KW = dict(block_size=4, num_blocks=64, max_num_seqs=4,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(16,), prefill_buckets=(16, 32),
              adaptive_buckets=True, ladder_compile_budget=2)


@pytest.fixture
def ladder_env(monkeypatch):
    # knobs must be set before engine construction (read in __init__)
    monkeypatch.setenv("DYNTPU_LADDER_MIN_DISPATCHES", "6")
    monkeypatch.setenv("DYNTPU_LADDER_HYSTERESIS", "1")
    watch = compilewatch.get_watch()
    watch.reset()
    yield watch
    watch.reset()


async def _run(engine, request_cls, prompt, n=4):
    req = request_cls(request_id=f"lad-{prompt[0]}-{len(prompt)}-{n}",
                      token_ids=prompt, max_tokens=n, temperature=0.0,
                      ignore_eos=True)
    return [out.token_id async for out in engine.submit(req)]


async def _drive(engine, request_cls, rounds=30):
    """The JAX test's trace: a 3-token warm-up, then 1-row requests until
    the decode ladder has split and converged; returns the streams."""
    streams = [await _run(engine, request_cls, [5, 6, 7])]
    engine.mark_obs_warmup_done()
    dec = engine._ladders["decode"]
    for i in range(rounds):
        streams.append(await _run(engine, request_cls,
                                  [i + 1, i + 2, i + 3]))
        if dec.snapshot()["splits_total"] and dec.converged:
            break
    return streams


def test_engine_ladder_splits_converges_then_captures_nothing(ladder_env):
    """Under 1-row decode traffic the decode ladder splits its 16-rung to 8
    (one new window key, counted in steady state), converges, and further
    traffic makes no new window key."""
    engine = InferenceEngine(ModelConfig.tiny(), EngineConfig(**ENG_KW),
                             device="cpu")
    assert engine._ladders["decode"].buckets() == (16,)

    async def script():
        try:
            await _drive(engine, Request)
            snap = engine.obs_snapshot()
            occ = engine.obs.bucket_occupancy()
            steady = ladder_env.steady_by_label()
            with compilewatch.assert_no_recompiles():
                tail = [await _run(engine, Request, [90 + i, 91, 92])
                        for i in range(3)]
            return snap, occ, steady, tail
        finally:
            await engine.stop()

    snap, occ, steady, tail = asyncio.run(script())
    assert snap["ladder_decode_splits_total"] == 1
    assert snap["ladder_decode_rungs"] == (8, 16)
    assert snap["ladder_decode_budget_remaining"] == 1
    assert snap["ladder_decode_converged"] == 1
    assert "decode:16" in occ and "decode:8" in occ
    assert steady == {"decode_window:B=8:stochastic=0": 1}
    assert snap["recompiles_by_fn"] == steady
    assert all(len(t) == 4 for t in tail)


def test_engine_ladder_rungs_and_streams_equal_jax(ladder_env):
    """The JAX engine and the port's (carrying the JAX weights) on the same
    trace: the same rungs, splits and budget, and the same greedy
    streams."""
    jwatch = jcompilewatch.get_watch()
    jcompilewatch.install()
    jwatch.reset()
    jengine = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**ENG_KW),
                        seed=0)
    tree = jax.tree.map(np.asarray, jengine.params)
    tengine = InferenceEngine(
        ModelConfig.tiny(), EngineConfig(**ENG_KW),
        params=params_from_numpy(tree, ModelConfig.tiny(), "cpu"),
        device="cpu")

    async def script(engine, request_cls):
        try:
            streams = await _drive(engine, request_cls)
            return streams, engine.obs_snapshot()
        finally:
            await engine.stop()

    try:
        want, jsnap = asyncio.run(script(jengine, JaxRequest))
    finally:
        jwatch.reset()
    got, tsnap = asyncio.run(script(tengine, Request))
    assert got == want
    for key in ("rungs", "splits_total", "retires_total",
                "budget_remaining", "converged"):
        assert tsnap[f"ladder_decode_{key}"] == jsnap[f"ladder_decode_{key}"]
        assert tsnap[f"ladder_prefill_{key}"] == \
            jsnap[f"ladder_prefill_{key}"]
    assert tsnap["ladder_decode_rungs"] == (8, 16)
    # the one steady-state program each: JAX's traced window, the port's
    # new window key
    assert jsnap["recompiles_steady_state"] >= 1
    assert tsnap["recompiles_by_fn"] == {"decode_window:B=8:stochastic=0": 1}


@pytest.mark.parametrize("observed", [[], [(64, 40, 64)] * 8],
                         ids=["base-grid", "after-split"])
def test_scheduler_snaps_chunks_to_the_prefill_ladder_as_jax(observed):
    """Chunked prefill with a prefill ladder: both schedulers snap the
    chunk cap onto the same live rung (the base grid's, or a rung the
    ladder split in), so the chunks are the same."""
    from dynamo_tpu.engine.config import EngineConfig as JaxConfig
    from dynamo_tpu.engine.scheduler import SchedSeq as JaxSeq
    from dynamo_tpu.engine.scheduler import Scheduler as JaxScheduler
    from dynamo_tpu_torch.engine.scheduler import SchedSeq, Scheduler

    kw = dict(block_size=4, num_blocks=128, max_num_seqs=4,
              max_num_batched_tokens=64, max_model_len=256,
              decode_buckets=(4,), prefill_buckets=(16, 32, 64),
              prefill_chunk_tokens=48)
    chunks = {}
    for side, sched_cls, seq_cls, cfg_cls in (
            ("jax", JaxScheduler, JaxSeq, JaxConfig),
            ("port", Scheduler, SchedSeq, EngineConfig)):
        sched = sched_cls(cfg_cls(**kw))
        lad = SIDES[side]["ladder"]("prefill", kw["prefill_buckets"],
                                    kinds=("prefill",), min_dispatches=8,
                                    step=16)
        for bucket, real, padded in observed:
            lad.observe(bucket, real, padded)
        lad.maybe_adapt()
        sched.prefill_ladder = lad
        for i, n in enumerate((100, 37, 64)):
            sched.add(seq_cls(seq_id=f"s{i}", prompt_ids=list(range(1, n + 1)),
                              max_tokens=2, eos_token_ids=frozenset()))
        got = []
        for _ in range(20):
            batch = sched.schedule()
            for c in batch.prefills:
                got.append((c.seq.seq_id, c.start, c.length))
                sched.on_prefill_executed(c, 1 if c.final else None)
            for row in batch.decode_rows:
                sched.on_decode_executed(row.seq, 1)
        chunks[side] = (got, lad.buckets())
    assert chunks["port"] == chunks["jax"]
    rungs = chunks["port"][1]
    assert rungs == ((16, 32, 48, 64) if observed else (16, 32, 64))
    assert max(n for *_, n in chunks["port"][0]) == (48 if observed else 32)


def test_grid_reads_stay_whole_while_the_ladder_adapts():
    """The engine adapts the ladder on its fetch thread while the
    device-step thread and the scheduler read the grid: a reader must
    always see a whole, sorted grid holding the capacity rung."""
    import sys
    import threading

    lad = _ladder("port", base=(8, 64), min_dispatches=1, hysteresis=1,
                  compile_budget=10 ** 6)
    stop = threading.Event()
    seen, errors = [], []

    def adapt():
        while not stop.is_set():
            for real, bucket in ((20, 64), (44, 64), (60, 64), (7, 8)):
                lad.observe(bucket, real, bucket)
                lad.maybe_adapt()

    def read():
        try:
            while not stop.is_set():
                grid = lad.buckets()
                b = lad.bucket_for(30)
                seen.append(grid)
                assert list(grid) == sorted(grid) and grid[-1] == 64
                assert b >= 30 and (lad.rung_at_most(63) or 0) <= 63
        except Exception as e:  # a thread's failure fails the test
            errors.append(e)
            stop.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=adapt)] + [
        threading.Thread(target=read) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        threading.Event().wait(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(seen) > 100
    assert lad.snapshot()["splits_total"] > 0
