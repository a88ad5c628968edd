"""The packed prefill's CUDA graphs (``engine/model.py`` ``PrefillGraphs``):
what they rest on, held on the CPU.

- A graph runs its chunk at the widest block table (``max_blocks_per_seq``)
  in place of the chunk's own power-of-two width: at every default prefill
  bucket, for a first and a mid-prompt chunk, dense and MoE, the wide
  chunk's sample, ring token and KV bytes equal the narrow chunk's bit for
  bit.
- The routing rule (``prefill_graphed``) sends a card's one-rank,
  kernel-route chunks to graphs and multimodal, sp, einsum-route, mesh and
  CPU chunks to their eager functions.
- An engine whose ``PrefillGraphs`` replays stand-in graphs (a replay
  reruns the captured chunk into the output it returned at capture, as a
  CUDA graph rewrites its pool) serves the eager engine's tokens when one
  batch carries two chunks of one bucket, counts every chunk as a replay
  and marks its ``engine.enqueue_prefill`` spans ``graphed``.
- On the CPU the engine replays nothing and its spans say so. CPU."""

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.observability import compilewatch
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tracing import InMemorySpanExporter

CPU = torch.device("cpu")
CUDA = torch.device("cuda")      # a device object only: nothing runs there
BUCKETS = EngineConfig().prefill_buckets
# a table of 64 blocks, wider than any chunk's own (at most 32 blocks: the
# tiny models' 512 positions)
MODEL_KW = dict(block_size=16, num_blocks=80, max_num_seqs=4,
                max_model_len=1024)
# (start, length) of a first and of a mid-prompt chunk in each bucket: the
# first fills its bucket but for three pads, the mid-prompt one follows a
# context that ends mid-block
CHUNKS = {T: ((0, T - 3), (37, min(T, 512 - 37 - 11) - 5)) for T in BUCKETS}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _pint(T, W, tokens, table, start, slot, temp):
    pint = np.zeros((1, T + W + tm.PP_SCALARS), np.int32)
    pint[0, :len(tokens)] = tokens
    nb = -(-(start + len(tokens)) // MODEL_KW["block_size"])
    pint[0, T:T + nb] = table[:nb]
    pint[0, T + W:] = (len(tokens), start, slot, 1, 0, 7,
                       int(round(temp * tm.PP_QUANT)), int(tm.PP_QUANT))
    return torch.from_numpy(pint)


@pytest.fixture(scope="module", params=["dense", "moe"])
def model(request):
    cfg = (ModelConfig.tiny() if request.param == "dense"
           else ModelConfig.tiny_moe())
    eng = EngineConfig(**MODEL_KW)
    params = tm.init_params(torch.Generator().manual_seed(3), cfg)
    return cfg, eng, params


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "stochastic"])
@pytest.mark.parametrize("which", [0, 1], ids=["first", "mid"])
@pytest.mark.parametrize("T", BUCKETS)
def test_widest_table_matches_the_bucketed_width(model, T, which,
                                                 stochastic):
    cfg, eng, params = model
    start, n = CHUNKS[T][which]
    bs = MODEL_KW["block_size"]
    rng = np.random.RandomState(T + which)
    table = rng.permutation(np.arange(1, MODEL_KW["num_blocks"]))[
        :eng.max_blocks_per_seq].astype(np.int32)
    prompt = rng.randint(1, cfg.vocab_size, start + n).astype(np.int32)
    cache = tm.init_cache(cfg, eng, CPU)
    last_tok = torch.zeros((eng.max_num_seqs + 1,), dtype=torch.int32)
    if start:
        # the context before the chunk, prefilled once for both arms
        Tc = 64
        Wc = -(-start // bs)
        tm.raw_packed_prefill_fn(cfg, eng, Tc, Wc)(
            params, cache, last_tok,
            _pint(Tc, Wc, prompt[:start], table, 0, 1, 0.0),
            torch.tensor(5), False)
    narrow = min(eng.max_blocks_per_seq, 1 << (
        -(-(start + n) // bs) - 1).bit_length())
    wide = eng.max_blocks_per_seq
    assert narrow < wide
    temp = 0.8 if stochastic else 0.0
    got = {}
    for W in (narrow, wide):
        c = {k: [t.clone() for t in v] for k, v in cache.items()}
        lt = last_tok.clone()
        _, _, sampled = tm.raw_packed_prefill_fn(cfg, eng, T, W)(
            params, c, lt, _pint(T, W, prompt[start:], table, start, 2, temp),
            torch.tensor(11), stochastic)
        got[W] = (sampled, lt, c)
    (s_n, lt_n, c_n), (s_w, lt_w, c_w) = got[narrow], got[wide]
    assert torch.equal(s_n, s_w)
    assert torch.equal(lt_n, lt_w) and int(lt_w[2]) == int(s_w[0])
    for key in c_n:
        for a, b in zip(c_n[key], c_w[key]):
            assert torch.equal(_bits(a), _bits(b))
    # the chunk's K/V landed (the comparison is not of two empty caches)
    assert any(not torch.equal(_bits(a), _bits(b))
               for a, b in zip(c_w["k"], cache["k"]))


@pytest.mark.parametrize("case,eng_kw,device,T,mm,sp,want", [
    ("card, one rank, kernel", {}, CUDA, 512, False, False, True),
    ("every default bucket", {}, CUDA, 16, False, False, True),
    ("the CPU", {}, CPU, 512, False, False, False),
    ("a multimodal chunk", {}, CUDA, 512, True, False, False),
    ("an sp chunk", {}, CUDA, 512, False, True, False),
    ("einsum for every class", {"attention_impl": "einsum"}, CUDA, 512,
     False, False, False),
    ("einsum for the prefill class",
     {"attention_impl_prefill": "einsum"}, CUDA, 512, False, False, False),
    ("einsum for decode only", {"attention_impl_decode": "einsum"}, CUDA,
     512, False, False, True),
    ("auto, unresolved", {"attention_impl": "auto"}, CUDA, 512, False,
     False, False),
    ("a tp mesh", {"mesh_shape": (1, 2)}, CUDA, 512, False, False, False),
    ("a dp mesh", {"mesh_shape": (2, 1)}, CUDA, 512, False, False, False),
    ("pipeline stages", {"pp_stages": 2}, CUDA, 512, False, False, False),
    ("a spec-class bucket on einsum",
     {"spec_mode": "ngram", "spec_k": 4, "attention_impl_spec": "einsum"},
     CUDA, 4, False, False, False),
    ("a prefill-class bucket beside it",
     {"spec_mode": "ngram", "spec_k": 4, "attention_impl_spec": "einsum"},
     CUDA, 16, False, False, True),
], ids=lambda v: v if isinstance(v, str) else None)
def test_routing_rule(case, eng_kw, device, T, mm, sp, want):
    eng = EngineConfig(**eng_kw)
    assert tm.prefill_graphed(eng, device, T, mm=mm, sp=sp) is want
    # the decode windows' rule is the same one, without the chunk's kind
    assert tm.graphs_apply(eng, device) is (
        device.type == "cuda" and "mesh_shape" not in eng_kw
        and "pp_stages" not in eng_kw)


# ----------------------- the engine with stand-in graphs -------------------

ENG = dict(block_size=4, num_blocks=96, max_num_seqs=4,
           max_num_batched_tokens=32, max_model_len=128,
           decode_buckets=(4,), prefill_buckets=(8, 16, 32),
           enable_prefix_caching=False)
# two prompts of one bucket (16), scheduled in one batch, then a long one
# chunked over two batches
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], [2, 7, 1, 8, 2, 8, 1, 8, 2,
                                                   8, 4, 5, 9],
           list(range(40, 100)))
MAX_TOKENS = 5


class _StandInGraph:
    """Replays by running the captured chunk again into the tensors its
    capture returned, as a CUDA graph rewrites its pool."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        for old, new in zip(self.out, self.body()):
            if isinstance(old, torch.Tensor) and new is not old:
                old.copy_(new)


class _StandInPool(tm.GraphPool):
    def capture(self, warm_up, body):
        warm_up()
        out = body()
        return _StandInGraph(body, out), out, {}


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()
    compilewatch.get_watch().reset()


def _engine():
    return InferenceEngine(ModelConfig.tiny(), EngineConfig(**ENG),
                           device="cpu", seed=4)


def _serve(engine, prompts=PROMPTS):
    async def one(p):
        return [o["token_ids"][0] async for o in engine.generate(
            {"token_ids": p, "max_tokens": MAX_TOKENS}, Context())]

    async def go():
        try:
            return await asyncio.gather(*(one(p) for p in prompts))
        finally:
            await engine.stop()
    return asyncio.run(go())


def _exporting():
    tracer = tracing.get_tracer().configure(sample_ratio=1.0)
    sink = InMemorySpanExporter()
    tracer.add_exporter(sink)
    return sink


def _chunk_spans(sink):
    return [s for s in sink.spans if s.name == "engine.enqueue_prefill"]


def _stand_in(engine, monkeypatch):
    """Route the engine's text chunks to a PrefillGraphs of stand-in
    graphs, as a card's engine routes them to CUDA graphs."""
    monkeypatch.setattr(tm, "graphs_apply", lambda eng, device: True)
    engine._prefill_graphs = tm.PrefillGraphs(
        engine.model_config, engine.config, _StandInPool(engine.device))
    return engine._prefill_graphs


def test_cpu_engine_replays_nothing_and_says_so():
    sink = _exporting()
    engine = _engine()
    outs = _serve(engine)
    assert [len(o) for o in outs] == [MAX_TOKENS] * len(PROMPTS)
    assert engine._prefill_graphs is None
    assert engine.num_prefill_graph_replays == 0
    chunks = _chunk_spans(sink)
    assert len(chunks) == engine.num_prefill_dispatches >= 4
    assert all(s.attrs["graphed"] is False for s in chunks)


def test_two_chunks_of_one_bucket_in_one_batch_keep_their_samples(
        monkeypatch):
    want = _serve(_engine())
    # the two short prompts' first tokens differ, so a shared output would
    # show
    assert want[0][0] != want[1][0]
    compilewatch.get_watch().reset()
    sink = _exporting()
    engine = _engine()
    graphs = _stand_in(engine, monkeypatch)
    got = _serve(engine)
    assert got == want
    assert engine.num_prefill_graph_replays == \
        engine.num_prefill_dispatches == graphs.replays >= 4
    chunks = _chunk_spans(sink)
    assert len(chunks) == engine.num_prefill_dispatches
    assert all(s.attrs["graphed"] is True for s in chunks)
    # one batch carried both short prompts' chunks, in the 16 bucket
    by_step = {}
    for s in chunks:
        by_step.setdefault(s.parent_span_id, []).append(s.attrs["bucket"])
    assert [16, 16] in by_step.values()
    # one greedy graph per bucket met, captured at its first call, each
    # counted under its key; the wide tables of every chunk
    assert sorted(graphs.capture_s) == [(16, False), (32, False)]
    assert {k: n for k, n in compilewatch.snapshot()["compiles_by_fn"].items()
            if k.startswith("prefill:")} == {
        "prefill:16:greedy": 1, "prefill:32:greedy": 1}
    assert set(graphs._pint) == {16, 32} and all(
        b.shape == (1, T + engine.config.max_blocks_per_seq + tm.PP_SCALARS)
        for T, b in graphs._pint.items())


def test_a_stochastic_chunk_captures_its_own_graph(monkeypatch):
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]]

    def sampled(engine):
        async def go():
            try:
                return [o["token_ids"][0] async for o in engine.generate(
                    {"token_ids": prompts[0], "max_tokens": MAX_TOKENS,
                     "temperature": 0.9, "seed": 17}, Context())]
            finally:
                await engine.stop()
        return asyncio.run(go())

    want = sampled(_engine())
    engine = _engine()
    graphs = _stand_in(engine, monkeypatch)
    assert sampled(engine) == want
    assert sorted(graphs.capture_s) == [(16, True)]
    assert engine.num_prefill_graph_replays == 1


def test_graphs_are_bound_to_what_they_captured_over(monkeypatch):
    engine = _engine()
    graphs = _stand_in(engine, monkeypatch)
    _serve(engine, PROMPTS[:1])
    pint = graphs.load(torch.zeros((1, 16 + graphs.W + tm.PP_SCALARS),
                                   dtype=torch.int32))
    other = {k: [t.clone() for t in v] for k, v in engine.cache.items()}
    with pytest.raises(RuntimeError, match="bound to the params, cache"):
        graphs(engine.params, other, engine._ctl["last_tok"], pint,
               torch.tensor(1), False)
    with pytest.raises(RuntimeError, match="bound to the params, cache"):
        graphs(engine.params, engine.cache, engine._ctl["last_tok"].clone(),
               pint, torch.tensor(1), False)


def test_buckets_captured_at_construction(monkeypatch):
    engine = _engine()
    monkeypatch.setattr(tm, "graphs_apply", lambda eng, device: True)
    # every bucket a chunk under the 32-token budget can take
    assert engine._prefill_graph_buckets() == [8, 16, 32]
    monkeypatch.setattr(engine, "config", EngineConfig(
        **{**ENG, "max_num_batched_tokens": 12}))
    assert engine._prefill_graph_buckets() == [8, 16]
    monkeypatch.setattr(engine, "config", EngineConfig(
        **{**ENG, "attention_impl_prefill": "einsum"}))
    assert engine._prefill_graph_buckets() == []
