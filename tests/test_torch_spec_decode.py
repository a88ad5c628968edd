"""The port's speculative decoding held against the JAX package, mirroring
``tests/test_spec_decode.py``: the n-gram drafter equals JAX's
``propose_drafts`` and the numpy oracle; one spec window equals JAX's
``raw_spec_window_fn`` on the same parameters and control state (packed
output, ctl, history and greedy rows exactly, the paged cache within 1e-5;
JAX runs its spec class through einsum, the port through the ragged face's
plain version); greedy token streams of the port's spec engine equal its
own non-spec engine's and the JAX spec engine's across prompt shapes, seat
churn and a migration that carries draft state; seeded stochastic rows
land one token per window; acceptance accounting and auto-disable equal
JAX's; the pressure ladder's rung 2 pauses and resumes spec windows as in
JAX; decode spans carry the spec attributes. CPU, ``ModelConfig.tiny()``,
float32."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.engine import Request as JaxRequest
from dynamo_tpu.spec import SpecDecodeStats as JaxSpecDecodeStats
from dynamo_tpu.spec import propose_drafts as jax_propose_drafts
from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine.engine import InferenceEngine, Request
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.transport import ERR_UNAVAILABLE, EngineError
from dynamo_tpu_torch.spec import (
    SpecDecodeStats, propose_drafts, propose_drafts_reference,
)
from dynamo_tpu_torch.tracing import InMemorySpanExporter

pytestmark = pytest.mark.spec

ATOL = 1e-5
ENG = dict(block_size=16, num_blocks=128, max_num_batched_tokens=256,
           max_model_len=256, prefill_buckets=(64, 256),
           decode_buckets=(4, 8))


@pytest.fixture(scope="module")
def tree():
    """tiny(512) parameters from the JAX initialiser, as numpy."""
    return jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jcfg.ModelConfig.tiny(512)))


def cfg_kw(spec: bool, max_num_seqs=4, spec_k=4, **kw):
    return dict(ENG, max_num_seqs=max_num_seqs,
                spec_mode="ngram" if spec else "off", spec_k=spec_k, **kw)


def jax_engine(tree, spec, **kw):
    return JaxEngine(jcfg.ModelConfig.tiny(512),
                     jcfg.EngineConfig(attention_impl="einsum",
                                       pipeline_depth=1,
                                       **cfg_kw(spec, **kw)),
                     params=jax.tree.map(jnp.asarray, tree), seed=0)


def port_engine(tree, spec, **kw):
    mc = tcfg.ModelConfig.tiny(512)
    return InferenceEngine(mc, tcfg.EngineConfig(**cfg_kw(spec, **kw)),
                           params=params_from_numpy(tree, mc, "cpu"),
                           seed=0, device="cpu")


def mk_req(pkg, i, prompt, max_tokens=24, temperature=0.0, seed=None,
           top_k=0):
    cls = JaxRequest if pkg == "jax" else Request
    return cls(request_id=f"r{i}", token_ids=list(prompt),
               max_tokens=max_tokens, temperature=temperature, top_k=top_k,
               seed=seed)


def run(engine, reqs):
    """All requests concurrently; (token streams, engine facts)."""
    async def go():
        await engine.start()

        async def one(r):
            return [out.token_id async for out in engine.submit(r)]
        try:
            streams = await asyncio.gather(*[one(r) for r in reqs])
        finally:
            await engine.stop()
        return streams
    streams = asyncio.run(go())
    return [list(s) for s in streams], {
        "stats": engine.spec_stats, "syncs": engine.num_fetch_syncs,
        "tokens": sum(len(s) for s in streams)}


def stats_tuple(st):
    return (st.drafted, st.accepted, st.emitted, st.windows)


# ------------------------------ drafter ----------------------------------


@pytest.mark.parametrize("ngram", [(1, 3), (2, 3), (1, 1), (3, 3)],
                         ids=lambda n: f"n{n[0]}-{n[1]}")
def test_drafter_equals_jax_and_the_oracle(ngram):
    """Random histories over a small alphabet with -1 gaps and unknown
    tails, pos0 anywhere (pos0 < n among them): the port's batched drafter
    equals JAX's ``propose_drafts`` and the numpy oracle row by row."""
    nmin, nmax = ngram
    rng = np.random.default_rng(7)
    H, k, trials = 48, 4, 64
    hist = rng.integers(2, 9, size=(trials, H)).astype(np.int32)
    pos0 = rng.integers(0, H, size=trials).astype(np.int32)
    pos0[:4] = [0, 1, 2, 1]             # shorter than the n-gram
    for t in range(trials):
        for _ in range(rng.integers(0, 4)):
            hist[t, rng.integers(0, H)] = -1
        hist[t, pos0[t] + 1:] = -1
    got = propose_drafts(torch.from_numpy(hist), torch.from_numpy(pos0), k,
                         nmin, nmax).numpy()
    want = np.asarray(jax_propose_drafts(hist, pos0, k, nmin, nmax))
    oracle = np.stack([propose_drafts_reference(h, int(p), k, nmin, nmax)
                       for h, p in zip(hist, pos0)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert got.dtype == np.int32
    assert (got >= 0).any()              # some rows did draft


def test_drafter_prefers_full_continuation():
    """Periodic content: the drafter picks a match with k known followers,
    not the nearest one, as JAX's does."""
    hist = np.array([[11, 13] * 8 + [-1] * 8], np.int32)
    pos0 = np.array([15], np.int32)
    got = propose_drafts(torch.from_numpy(hist), torch.from_numpy(pos0),
                         4, 1, 3).numpy()
    np.testing.assert_array_equal(got[0], [11, 13, 11, 13])
    np.testing.assert_array_equal(
        got, np.asarray(jax_propose_drafts(hist, pos0, 4, 1, 3)))


def test_spec_stats_wire_fields_equal_jax():
    for d in ({}, None, {"drafted": 8, "accepted": 6},
              {"drafted": 10, "accepted": 4, "emitted": 14, "windows": 10}):
        mine, theirs = SpecDecodeStats.from_dict(d), \
            JaxSpecDecodeStats.from_dict(d)
        assert mine.to_dict() == theirs.to_dict()
    assert SpecDecodeStats().acceptance_rate == 0.0


@pytest.mark.parametrize("knob", [dict(spec_k=0), dict(spec_ngram_min=0),
                                  dict(spec_ngram_min=3, spec_ngram_max=2)],
                         ids=lambda k: "-".join(f"{a}{b}"
                                                for a, b in k.items()))
def test_spec_config_checks_equal_jax(knob):
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError):
            mod.EngineConfig(spec_mode="ngram", **knob)
        mod.EngineConfig(spec_mode="off", **knob)   # only checked when on


# ----------------------------- one window --------------------------------


def test_spec_window_equals_jax(tree):
    """Three seats prefilled by the packed prefill (two greedy, one whose
    capacity ends mid-window), their histories filled, then four spec
    windows of k=4 over a padded bucket: the packed output's counts and
    emitted tokens, ctl (history included) and greedy rows equal JAX's
    ``raw_spec_window_fn``; the paged cache agrees within 1e-5."""
    k, T, W = 4, 64, 8
    kw = cfg_kw(True, max_num_seqs=8)
    je = jcfg.EngineConfig(attention_impl="einsum", **kw)
    te = tcfg.EngineConfig(**kw)
    jc, tc = jcfg.ModelConfig.tiny(512), tcfg.ModelConfig.tiny(512)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, tc, "cpu")
    S, Wcap, Hcap = je.max_num_seqs, je.max_blocks_per_seq, je.max_model_len
    prompts = [[5, 9, 11, 4] * 8, [7, 7, 8] * 10 + [7], list(range(2, 40))]
    tables = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11]]
    vus = [64, 48, 41]        # seat 2 runs out 2 tokens into its windows

    jcache = jm.init_cache(jc, je)
    jctl = jax.tree.map(jnp.asarray, jm.init_ctl(je, S, Wcap, hist_cap=Hcap))
    jpre = jm.make_packed_prefill_fn(jc, je, T, W)
    _, jdelta = jm.make_autopilot_fns(jc, je, 1, Wcap)
    jwin = jax.jit(jm.raw_spec_window_fn(jc, je, k, 1, 3))
    jfill = jm.raw_spec_hist_fill_fn()
    tcache = tm.init_cache(tc, te, torch.device("cpu"))
    tctl = tm.init_ctl(te, S, Wcap, torch.device("cpu"), hist_cap=Hcap)
    hist_obj = tctl["hist"]
    tpre = tm.raw_packed_prefill_fn(tc, te, T, W)
    twin = tm.raw_spec_window_fn(tc, te, k, 1, 3)
    tfill = tm.raw_spec_hist_fill_fn()
    tdelta = tm.raw_ctl_delta_fn(Wcap)

    for slot, (prompt, table) in enumerate(zip(prompts, tables)):
        pint = np.zeros((1, T + W + tm.PP_SCALARS), np.int32)
        pint[0, :len(prompt)] = prompt
        pint[0, T:T + len(table)] = table
        pint[0, T + W:] = (len(prompt), 0, slot, 1, 0, -1, 0,
                           int(tm.PP_QUANT))
        jcache, jlt, _ = jpre(jparams, jcache, jctl["last_tok"],
                              jnp.asarray(pint), jax.random.PRNGKey(slot))
        jctl = {**jctl, "last_tok": jlt}
        tpre(tparams, tcache, tctl["last_tok"], torch.from_numpy(pint),
             torch.tensor(slot), False)
    np.testing.assert_array_equal(tctl["last_tok"].numpy(),
                                  np.asarray(jctl["last_tok"]))
    di = np.zeros((4, tm.CTL_I32_FIELDS + Wcap), np.int32)
    di[:, 0], di[:, 5] = S, -1
    df = np.zeros((4, 2), np.float32)
    slots = np.full((4,), S, np.int32)
    hrows = np.full((4, Hcap + 1), -1, np.int32)
    for slot in range(3):
        di[slot, :6] = (slot, len(prompts[slot]), vus[slot], 0, -1, -1)
        di[slot, 6:6 + len(tables[slot])] = tables[slot]
        df[slot] = (0.0, 1.0)
        slots[slot] = slot
        hrows[slot, :len(prompts[slot])] = prompts[slot]
    jctl = jdelta(jctl, jnp.asarray(di), jnp.asarray(df))
    tdelta(tctl, torch.from_numpy(di), torch.from_numpy(df))
    jctl = jfill(jctl, jnp.asarray(slots), jnp.asarray(hrows))
    tfill(tctl, torch.from_numpy(slots), torch.from_numpy(hrows))
    rows = np.array([0, 1, 2, S], np.int32)   # bucket 4, trash padding
    accepted = 0
    for _ in range(4):
        jcache, jctl, jp = jwin(jparams, jcache, jctl, jnp.asarray(rows))
        tcache, tctl, tp = twin(tparams, tcache, tctl,
                                torch.from_numpy(rows), False)
        tp, jp = tp.numpy(), np.asarray(jp)
        # counts exactly; the candidates a seat emitted exactly (those past
        # n come from unfed query slots: zeros in the ragged face, garbage
        # in the einsum path, read by nobody)
        np.testing.assert_array_equal(tp[k + 1:], jp[k + 1:])
        real = np.arange(k + 1)[:, None] < tp[k + 1][None, :]
        np.testing.assert_array_equal(tp[:k + 1][real], jp[:k + 1][real])
        accepted += int(np.maximum(tp[k + 1] - 1, 0).sum())
        np.testing.assert_array_equal(tctl["ctr"].numpy(),
                                      np.asarray(jctl["ctr"]))
        # the trash slot S takes the dead columns' writes, and the
        # history's trash row every rejected one: their values are unread
        for key in ("pos", "last_tok", "hist"):
            np.testing.assert_array_equal(tctl[key].numpy()[:S],
                                          np.asarray(jctl[key])[:S])
    assert tctl["hist"] is hist_obj            # updated in place
    assert accepted > 0                        # drafts were verified
    assert int(tctl["pos"][2]) == vus[2]       # seat 2 stopped at capacity
    for key in ("k", "v"):
        for li in range(tc.num_layers):
            np.testing.assert_allclose(
                tcache[key][li].numpy()[1:], np.asarray(jcache[key][li])[1:],
                rtol=0, atol=ATOL)


# --------------------------- engine streams ------------------------------

SHAPES = [[3, 5, 7, 11] * 12, list(range(2, 30)), [9],
          [100, 101] * 20 + [7, 8, 9]]


@pytest.fixture(scope="module")
def prompt_shapes(tree):
    """The JAX spec engine's greedy streams for four prompt shapes, and its
    accounting."""
    streams, facts = run(jax_engine(tree, True, max_num_seqs=8),
                         [mk_req("jax", i, p) for i, p in enumerate(SHAPES)])
    return streams, stats_tuple(facts["stats"])


def test_greedy_parity_prompt_shapes(tree, prompt_shapes):
    """Port spec = port non-spec = JAX spec, greedy, across prompt shapes
    (repetitive, ramp, single-token, mixed tail); the accounting equals
    JAX's too."""
    want, jax_stats = prompt_shapes
    reqs = [mk_req("port", i, p) for i, p in enumerate(SHAPES)]
    on, facts = run(port_engine(tree, True, max_num_seqs=8), reqs)
    off, _ = run(port_engine(tree, False, max_num_seqs=8), reqs)
    assert on == want
    assert off == want
    st = facts["stats"]
    assert st.windows > 0 and st.drafted > 0 and st.accepted > 0
    assert stats_tuple(st) == jax_stats


def test_seat_churn_parity(tree):
    """More requests than seats: joins re-fill draft history mid-flight;
    streams equal the port's non-spec engine's and JAX's spec engine's."""
    prompts = [[(7 * i) % 90 + 2, 5, 5] * (4 + i % 3) for i in range(8)]
    want, _ = run(jax_engine(tree, True, max_num_seqs=4),
                  [mk_req("jax", i, p, max_tokens=20)
                   for i, p in enumerate(prompts)])
    reqs = [mk_req("port", i, p, max_tokens=20)
            for i, p in enumerate(prompts)]
    on, facts = run(port_engine(tree, True, max_num_seqs=4), reqs)
    off, _ = run(port_engine(tree, False, max_num_seqs=4), reqs)
    assert on == want == off
    assert facts["stats"].drafted > 0


class FailoverEngine(AsyncEngine):
    """Streams from engine A, dies retryably after ``fail_after`` tokens,
    then serves the Migration retry (carried prompt) from engine B."""

    def __init__(self, engines, fail_after: int):
        self.engines = list(engines)
        self.fail_after = fail_after
        self.calls = 0

    async def generate(self, request, context):
        eng = self.engines[min(self.calls, len(self.engines) - 1)]
        first = self.calls == 0
        self.calls += 1
        req = Request(request_id=f"mig-{self.calls}",
                      token_ids=list(request["token_ids"]),
                      max_tokens=int(request["max_tokens"]), temperature=0.0)
        i = 0
        async for out in eng.submit(req):
            if first and i >= self.fail_after:
                raise EngineError("worker died", ERR_UNAVAILABLE)
            yield {"token_ids": [out.token_id], "finished": out.finished,
                   "finish_reason": out.finish_reason,
                   "num_prompt_tokens": out.num_prompt_tokens}
            i += 1


def test_migration_parity_carries_draft_state(tree):
    """A mid-stream failover re-issues the request with carried tokens;
    the second port spec engine rebuilds draft history from the longer
    prompt, and the joined stream equals an uninterrupted JAX spec run."""
    prompt, max_tokens = [5, 9, 11] * 8, 24
    (want,), _ = run(jax_engine(tree, True),
                     [mk_req("jax", 0, prompt, max_tokens=max_tokens)])
    eng_a, eng_b = port_engine(tree, True), port_engine(tree, True)

    async def go():
        await eng_a.start()
        await eng_b.start()
        try:
            failover = FailoverEngine([eng_a, eng_b], fail_after=7)
            mig = Migration(failover, migration_limit=2,
                            backoff_base_s=0.001)
            out = []
            async for item in mig.generate(
                    {"token_ids": prompt, "max_tokens": max_tokens},
                    Context()):
                out.extend(item["token_ids"])
            return out, failover.calls
        finally:
            await eng_a.stop()
            await eng_b.stop()
    out, calls = asyncio.run(go())
    assert calls == 2
    assert out == want
    # engine B decoded from a carried prompt: its drafter had history
    assert eng_b.spec_stats.drafted > 0


def test_seeded_stochastic_rows_land_one_token_per_window(tree):
    """Seeded sampled rows draft nothing and land one token per spec
    window; their streams equal the port's non-spec engine's (draws keyed
    by seed and position)."""
    reqs = [mk_req("port", i, [3 + i, 9, 40 + i] * 6, max_tokens=16,
                   temperature=0.8, seed=42 + i, top_k=8) for i in range(3)]
    on, facts = run(port_engine(tree, True), reqs)
    off, _ = run(port_engine(tree, False), reqs)
    assert on == off
    st = facts["stats"]
    assert st.drafted == 0 and st.accepted == 0
    # every decode token came from its own window
    assert st.emitted == facts["tokens"] - len(reqs)
    assert st.windows >= max(len(s) for s in on) - 1


def test_acceptance_accounting_equals_jax(tree):
    prompt = [4, 6, 8] * 10
    _, jfacts = run(jax_engine(tree, True),
                    [mk_req("jax", 0, prompt, max_tokens=32)])
    streams, facts = run(port_engine(tree, True),
                         [mk_req("port", 0, prompt, max_tokens=32)])
    st = facts["stats"]
    assert stats_tuple(st) == stats_tuple(jfacts["stats"])
    assert 0 < st.accepted <= st.drafted
    assert st.emitted == facts["tokens"] - 1
    assert st.emitted <= st.windows + st.accepted
    assert st.to_dict() == jfacts["stats"].to_dict()


def test_auto_disable_equals_jax(tree):
    """An impossible threshold falls back to plain windows after the
    observation window — at the same draft count as JAX, one-way, and
    stream-correct."""
    prompt = list(range(2, 26))
    kw = dict(spec_auto_disable_threshold=1.1, spec_auto_disable_window=8)
    jeng = jax_engine(tree, True, **kw)
    (jon,), jfacts = run(jeng, [mk_req("jax", 0, prompt, max_tokens=48)])
    peng = port_engine(tree, True, **kw)
    (on,), facts = run(peng, [mk_req("port", 0, prompt, max_tokens=48)])
    (off,), _ = run(port_engine(tree, False),
                    [mk_req("port", 0, prompt, max_tokens=48)])
    assert peng._spec_auto_disabled and jeng._spec_auto_disabled
    assert peng.scheduler.spec_plan_window is None
    assert stats_tuple(facts["stats"]) == stats_tuple(jfacts["stats"])
    assert on == off == jon
    # decode windows ran after the switch
    assert peng.num_windows > facts["stats"].windows


class _DialPool:
    """The scheduler's pool with a scripted ``usage``: high (rung 2
    engaged) from the ``lo``-th to the ``hi``-th loop pass."""

    def __init__(self, pool, lo, hi):
        self._pool, self.lo, self.hi, self.reads = pool, lo, hi, 0

    @property
    def usage(self):
        self.reads += 1
        return 0.9 if self.lo <= self.reads < self.hi else 0.0

    def __getattr__(self, name):
        return getattr(self._pool, name)


def test_rung2_pauses_and_resumes_spec(tree):
    """The pressure ladder's rung 2 pauses spec windows mid-stream (decode
    windows pass the history through untouched) and resumes them; the
    stream equals the non-spec one, and the pause lands where JAX's does
    (same accounting)."""
    prompt = [3, 5, 7, 11] * 6
    got = {}
    for pkg, make in (("jax", jax_engine), ("port", port_engine)):
        eng = make(tree, True, pressure_spec_threshold=0.5,
                   pressure_release=0.1)
        dial = _DialPool(eng.scheduler.pool, 4, 9)
        eng.scheduler.pool = dial
        paused = []
        orig = eng._pause_spec

        def pause(orig=orig, eng=eng):
            paused.append(eng.scheduler.spec_plan_window)
            orig()
        eng._pause_spec = pause
        (stream,), facts = run(eng, [mk_req(pkg, 0, prompt, max_tokens=40)])
        got[pkg] = (stream, stats_tuple(facts["stats"]), eng.num_windows,
                    paused, eng.scheduler.spec_plan_window,
                    eng._pressure_spec_paused)
    (off,), _ = run(port_engine(tree, False),
                    [mk_req("port", 0, prompt, max_tokens=40)])
    assert got["port"] == got["jax"]
    stream, stats, windows, paused, plan, still = got["port"]
    assert stream == off
    assert paused == [5]               # paused once, from k + 1
    assert plan == 5 and not still     # and resumed
    assert windows > stats[3] > 0      # decode windows ran while paused


def test_decode_span_carries_spec_attrs(tree):
    tracing.reset()
    try:
        tracer = tracing.get_tracer()
        tracer.configure(sample_ratio=1.0)
        exp = InMemorySpanExporter()
        tracer.add_exporter(exp)
        eng = port_engine(tree, True)

        async def go():
            await eng.start()
            try:
                async for _ in eng.generate(
                        {"token_ids": [3, 5, 7] * 10, "max_tokens": 16},
                        Context()):
                    pass
            finally:
                await eng.stop()
        asyncio.run(go())
        spans = [s for s in exp.spans if s.name == "engine.decode"]
        assert spans
        attrs = spans[-1].attrs
        assert attrs["spec_drafted"] > 0
        assert 0 <= attrs["spec_accepted"] <= attrs["spec_drafted"]
    finally:
        tracing.reset()


def test_tokens_per_host_sync_improves(tree):
    """A repetitive prompt lands >= 1.5x as many tokens per host sync
    with spec windows as without (the JAX test's bar)."""
    reqs = [mk_req("port", 0, [11, 13] * 16, max_tokens=64)]
    off, f_off = run(port_engine(tree, False, pipeline_depth=1), reqs)
    on, f_on = run(port_engine(tree, True), reqs)
    assert off == on
    assert (f_on["tokens"] / f_on["syncs"]
            >= 1.5 * f_off["tokens"] / f_off["syncs"])
