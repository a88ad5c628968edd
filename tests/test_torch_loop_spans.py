"""The port engine loop's spans (``engine.step`` and its phases): one set
per scheduled batch, minted only while the span collector has a sink, kept
out of the ring the slow-request dump reads, and on the profiler's clock,
both through the collector's monotonic→Unix offset and inside a
``/debug/profile`` trace. A tiny engine on the CPU, where a batch has no
CUDA events and so no ``engine.device_gap``; the gap's arithmetic is held
on stand-in events. CPU."""

import asyncio
import concurrent.futures
import json
import time

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine, _LoopStamps
from dynamo_tpu_torch.observability import profiling
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tracing import InMemorySpanExporter
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

ENG = dict(block_size=4, num_blocks=96, max_num_seqs=4,
           max_num_batched_tokens=16, max_model_len=128,
           decode_buckets=(8,), prefill_buckets=(8, 16),
           enable_prefix_caching=False)
LOOP = ("engine.step", "engine.schedule", "engine.enqueue_prefill",
        "engine.enqueue_decode", "engine.land", "engine.postprocess",
        "engine.device_gap")
# a 40-token prompt makes three chunks under a 16-token budget
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6] * 5, [2, 7, 1, 8, 2, 8])


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _engine(depth=2):
    return InferenceEngine(ModelConfig.tiny(),
                           EngineConfig(**ENG, pipeline_depth=depth),
                           device="cpu")


async def _generate(engine, prompts=PROMPTS, max_tokens=6):
    async def one(p):
        return [o async for o in engine.generate(
            {"token_ids": p, "max_tokens": max_tokens}, Context())]
    return await asyncio.gather(*(one(p) for p in prompts))


def _serve(engine, **kw):
    async def go():
        try:
            return await _generate(engine, **kw)
        finally:
            await engine.stop()
    return asyncio.run(go())


def _exporting():
    tracer = tracing.get_tracer().configure(sample_ratio=1.0)
    sink = InMemorySpanExporter()
    tracer.add_exporter(sink)
    return sink


def _loop_spans(sink):
    return [s for s in sink.spans if s.name in LOOP]


@pytest.mark.parametrize("depth", [1, 2], ids=["sync", "pipelined"])
def test_one_step_span_per_batch_with_its_phases_in_order(depth):
    sink = _exporting()
    engine = _engine(depth)
    outs = _serve(engine)
    assert [len(o) for o in outs] == [6, 6]
    steps = [s for s in sink.spans if s.name == "engine.step"]
    assert len(steps) == engine.num_steps > 0
    kids = {}
    for s in _loop_spans(sink):
        if s.name != "engine.step":
            kids.setdefault(s.parent_span_id, []).append(s)
    for step in steps:
        assert step.parent_span_id is None and not step.buffered
        mine = {s.name: s for s in kids.pop(step.span_id)}
        assert all(s.trace_id == step.trace_id for s in mine.values())
        sched, land, post = (mine["engine.schedule"], mine["engine.land"],
                             mine["engine.postprocess"])
        # the loop thread's phases, in order, from the step's start to
        # its end
        assert step.start_mono == sched.start_mono
        assert sched.end_mono <= land.start_mono <= land.end_mono \
            == post.start_mono <= post.end_mono == step.end_mono
        # the step thread's enqueues lie between the schedule and the
        # landing
        for name in ("engine.enqueue_prefill", "engine.enqueue_decode"):
            if name in mine:
                assert sched.end_mono <= mine[name].start_mono \
                    <= mine[name].end_mono <= land.start_mono
        assert set(mine) <= set(LOOP) - {"engine.device_gap"}
        assert ("engine.enqueue_decode" in mine) == \
            (step.attrs["live_rows"] > 0)
        assert ("engine.enqueue_prefill" in mine) == \
            (step.attrs["prefill_tokens"] > 0)
    assert kids == {}                 # no child without its step


def test_one_enqueue_prefill_span_per_chunk():
    sink = _exporting()
    engine = _engine()
    _serve(engine)
    chunks = [s for s in sink.spans if s.name == "engine.enqueue_prefill"]
    assert len(chunks) == engine.num_prefill_dispatches >= 4
    assert sum(s.attrs["tokens"] for s in chunks) == \
        sum(len(p) for p in PROMPTS)
    assert all(s.attrs["bucket"] in ENG["prefill_buckets"]
               and s.attrs["tokens"] <= s.attrs["bucket"] for s in chunks)
    steps = [s for s in sink.spans if s.name == "engine.step"]
    assert sum(s.attrs["prefill_tokens"] for s in steps) == \
        sum(s.attrs["tokens"] for s in chunks)
    assert len([s for s in sink.spans if s.name == "engine.enqueue_decode"]) \
        == engine.num_windows


def test_no_loop_span_is_minted_without_a_sink(monkeypatch):
    tracer = tracing.get_tracer()
    assert not tracer.active
    minted = []
    start_span = tracer.start_span

    def spy(name, *a, **kw):
        minted.append(name)
        return start_span(name, *a, **kw)
    monkeypatch.setattr(tracer, "start_span", spy)
    engine = _engine()
    _serve(engine)
    assert engine.num_steps > 0
    assert not set(minted) & set(LOOP)
    # the request's own stage spans are still recorded, into the ring
    assert {"worker.queue", "engine.prefill", "engine.decode"} <= set(minted)


def test_a_sink_added_after_the_engine_is_built_takes_effect():
    engine = _engine()

    async def go():
        try:
            await _generate(engine)
            before = engine.num_steps
            reg = MetricsRegistry(prefix="t")
            tracing.get_tracer().attach_metrics(reg)
            await _generate(engine)
            text = reg.render().decode()
            count = f't_stage_latency_seconds_count{{stage="engine.step"}}'
            line, = [x for x in text.splitlines() if x.startswith(count)]
            assert float(line.split()[-1]) == engine.num_steps - before > 0
            # a reset collector has no sink: the loop reads the new one
            tracing.reset()
            sink = InMemorySpanExporter()
            await _generate(engine)
            tracing.get_tracer().configure(sample_ratio=1.0)
            tracing.get_tracer().add_exporter(sink)
            n = engine.num_steps
            await _generate(engine)
            steps = [s for s in sink.spans if s.name == "engine.step"]
            assert len(steps) == engine.num_steps - n
        finally:
            await engine.stop()
    asyncio.run(go())


def test_loop_spans_keep_out_of_the_ring():
    tracer = tracing.get_tracer().configure(buffer_size=16)
    sink = _exporting()
    engine = _engine()
    ctx = Context()

    async def go():
        try:
            out = [o async for o in engine.generate(
                {"token_ids": PROMPTS[0], "max_tokens": 24}, ctx)]
            await _generate(engine, max_tokens=12)
            return out
        finally:
            await engine.stop()
    assert len(asyncio.run(go())) == 24
    assert len(_loop_spans(sink)) > 16 * 4
    mine = {s.name for s in tracer.get_trace(ctx.trace.trace_id)}
    assert mine == {"worker.queue", "engine.prefill", "engine.decode"}
    assert not {s.name for s in tracer._ring} & set(LOOP)


class _Event:
    """A stand-in CUDA event: ``elapsed_time`` to another in ms."""

    def __init__(self, t_ms, done=True):
        self.t_ms = t_ms
        self.done = done

    def elapsed_time(self, other):
        if not (self.done and other.done):
            raise RuntimeError("event not ready")
        return other.t_ms - self.t_ms


@pytest.mark.parametrize("prev,start,queued,idle,want", [
    (_Event(10.0), _Event(13.5), False, False, 3.5),
    (_Event(10.0), _Event(10.002), True, False, 0.0),
    (_Event(10.0), _Event(13.5), False, True, None),
    (None, _Event(13.5), False, False, None),
    (_Event(10.0, done=False), _Event(13.5), False, False, None),
    (_Event(10.0), None, False, False, None),
], ids=["gap", "queued", "after-idle", "first", "dropped", "off-card"])
def test_device_gap_ms(prev, start, queued, idle, want):
    st = _LoopStamps(0.0, 0.0, idle, gap_prev=prev, gap_start=start,
                     queued=queued)
    assert st.device_gap_ms() == want


def _probe_range(name):
    """Host monotonic stamps taken just inside a ``record_function``."""
    with record_function(name):
        t0 = time.monotonic()
        time.sleep(0.003)
        t1 = time.monotonic()
    return t0, t1


def test_span_and_profiler_range_share_the_clock():
    tracer = tracing.get_tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _probe_range("warm")
        tracer.calibrate_clock()
        t0, t1 = _probe_range("probe")
    span = tracer.record("engine.step", start_mono=t0, end_mono=t1,
                         buffered=False)
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "probe"]
    assert abs(span.start_unix * 1e9 - ev.start_ns()) < 0.5e6
    end_unix = span.start_unix + span.duration_s
    assert abs(end_unix * 1e9 - ev.end_ns()) < 0.5e6


class _Inline(concurrent.futures.Executor):
    """Runs each task on the calling thread: the profiler records the CPU
    ops of the thread that started it, here the test's."""

    def __init__(self, *a, **kw):
        pass

    def submit(self, fn, /, *args, **kwargs):
        fut = concurrent.futures.Future()
        fut.set_result(fn(*args, **kwargs))
        return fut


def test_debug_profile_trace_holds_the_loop_spans_on_its_clock(
        tmp_path, monkeypatch):
    monkeypatch.setattr(profiling.concurrent.futures, "ThreadPoolExecutor",
                        _Inline)
    engine = _engine()
    tracer = tracing.get_tracer()
    assert not tracer.active          # the capture's tap is the only sink

    async def go():
        try:
            await _generate(engine, max_tokens=2)       # warm
            capture = asyncio.ensure_future(
                profiling.capture(400, base_dir=str(tmp_path)))
            await asyncio.sleep(0.1)
            _probe_range("warm")
            t0, t1 = _probe_range("probe")
            tracer.record("engine.probe", start_mono=t0, end_mono=t1,
                          buffered=False)
            await _generate(engine, max_tokens=8)
            return await capture
        finally:
            await engine.stop()
    meta = asyncio.run(go())
    with open(meta["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    probe, = [e for e in events
              if e.get("name") == "probe" and e.get("ph") == "X"]
    begin, = [e for e in events
              if e.get("name") == "engine.probe" and e["ph"] == "b"]
    end, = [e for e in events
            if e.get("name") == "engine.probe" and e["ph"] == "e"]
    assert abs(begin["ts"] - probe["ts"]) < 500        # microseconds
    assert abs(end["ts"] - (probe["ts"] + probe["dur"])) < 500
    steps = [e for e in events if e.get("name") == "engine.step"]
    assert steps and {e["ph"] for e in steps} == {"b", "e"}
    assert all(e["pid"] == profiling.SPANS_PID for e in steps)
    assert not tracer.active          # the tap closed with the capture
