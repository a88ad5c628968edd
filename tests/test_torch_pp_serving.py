"""Pipeline-parallel serving in the port, held against the JAX package,
at the level of the step and the engine: the port's stages are ranks of
a gloo world on the CPU (``torch_tp_world.py``), the JAX package's a
``pp`` mesh of virtual CPU devices; the same numpy parameters (the JAX
tree) feed both. The engines' streams are in ``test_torch_pp_streams.py``,
the ``--pp 2`` worker's in ``test_torch_pp_worker.py``.

- ``raw_pp_step_fn`` at S = 2 on ``tiny`` (and ``tiny_moe``) at 4 layers,
  f32: a prefill chunk of two rows, then a decode batch of B = 8 over M = 4
  microbatches with pad rows — the live rows' samples equal JAX's, each
  stage's cache planes match its layers of the JAX stacked cache within
  1e-5 (the trash block aside: a JAX bubble tick scatters garbage there,
  a port bubble tick runs nothing), and only stage 0 sends activations;
- a pp engine holds its stage's layers and cache planes only, runs the
  synchronous loop with no decode graphs, control state or ladders,
  counts its stages as chips, warns about ``decode_steps > 1`` with JAX's
  words, refuses KV transfer, KVBM and multimodal prefill with JAX's
  messages, evacuates as the JAX engine does (the seats are journaled and
  end as fallbacks, since the transfer refuses), and embeds equal to the
  JAX pp engine (the stages encode together);
- ``pp_stages`` with a ``(dp, tp)`` mesh raises JAX's ``ValueError``;
- ``load_hf_params(..., layers=)`` reads a stage's layers only, bitwise
  the slice of the full load.
"""

import asyncio
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu.engine import model as jm
from dynamo_tpu.parallel import pp_serving as jpp
from dynamo_tpu_torch.engine import EngineConfig
from dynamo_tpu_torch.engine import weights as tweights

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_preemption as tpre_test  # noqa: E402
import torch_tp_world as tw  # noqa: E402

ATOL = 1e-5
S = 2
# the JAX pp test's engine shape (tests/test_pp_serving.py)
ENG_KW = dict(block_size=4, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(8,), prefill_buckets=(64,))
PP_KW = dict(pp_stages=S, pp_microbatches=4, **ENG_KW)


@pytest.fixture(scope="module")
def world2():
    with tw.World(S) as w:
        yield w


def _jcfg(name):
    base, _, layers = name.partition(":")
    return dataclasses.replace(getattr(JaxModelConfig, base)(),
                               num_layers=int(layers))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------ the pp step --------------------------------


def _steps():
    """A prefill chunk of two rows (13 and 5 tokens), then a decode batch
    of 8 rows: the two sequences go on, four more decode at short
    positions, two rows are padding (position -1)."""
    rng = np.random.RandomState(3)
    toks = np.zeros((2, 16), np.int32)
    pos = np.full((2, 16), -1, np.int32)
    toks[0, :13] = rng.randint(1, 512, 13)
    pos[0, :13] = np.arange(13)
    toks[1, :5] = rng.randint(1, 512, 5)
    pos[1, :5] = np.arange(5)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :2] = [5, 6]
    prefill = (toks, pos, tables, np.array([12, 4], np.int32))
    dtoks = np.zeros((8, 1), np.int32)
    dpos = np.full((8, 1), -1, np.int32)
    dtab = np.zeros((8, 8), np.int32)
    dtoks[:6, 0] = rng.randint(1, 512, 6)
    dpos[:6, 0] = [13, 5, 0, 1, 2, 3]
    dtab[0, :4] = [1, 2, 3, 4]
    dtab[1, :2] = [5, 6]
    for r in range(2, 6):
        dtab[r, 0] = 5 + r
    decode = (dtoks, dpos, dtab, np.zeros((8,), np.int32))
    return [prefill, decode]


def _jax_pp_steps(cfg, params, steps):
    eng = JaxEngineConfig(pp_stages=S, **ENG_KW)
    mesh = jpp.make_pp_mesh(S, jax.devices("cpu"))
    params = jax.device_put(params, jpp.pp_param_shardings(mesh, cfg))
    cache = jax.device_put(jpp.init_pp_cache(cfg, eng),
                           jpp.pp_cache_shardings(mesh, cfg))
    step = jpp.make_pp_step_fn(cfg, eng, mesh, 4)
    sampled = []
    for toks, pos, tables, last in steps:
        B = toks.shape[0]
        cache, s = step(params, cache, toks, pos, tables, last,
                        jax.random.PRNGKey(7), np.zeros(B, np.float32),
                        np.zeros(B, np.int32), np.ones(B, np.float32),
                        np.full(B, -1, np.int32))
        sampled.append(np.asarray(s).tolist())
    return sampled, np.asarray(cache["k"]), np.asarray(cache["v"])


@pytest.mark.parametrize("cfg_name", ["tiny:4", "tiny_moe:4"])
def test_raw_pp_step_fn_matches_jax(world2, cfg_name, cpu_devices):
    cfg = _jcfg(cfg_name)
    params = jm.init_params(jax.random.PRNGKey(1), cfg)
    steps = _steps()
    want, jk, jv = _jax_pp_steps(cfg, params, steps)
    got = world2.run(tw.pp_step_case, cfg_name, numpy_tree(params),
                     dict(pp_stages=S, **ENG_KW), steps)
    Lp = cfg.num_layers // S
    live = [(pos[:, 0] >= 0).sum() for _, pos, _, _ in steps]
    for stage, g in enumerate(got):
        # a pad row's sample is garbage in both (the engine drops it)
        assert [s[:n] for s, n in zip(g["sampled"], live)] == \
            [s[:n] for s, n in zip(want, live)]
        assert g["layers"] == (stage * Lp, (stage + 1) * Lp)
        assert g["k"].shape == (Lp,) + jk.shape[1:]
        layers = slice(stage * Lp, (stage + 1) * Lp)
        np.testing.assert_allclose(g["k"][:, 1:], jk[layers, 1:], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(g["v"][:, 1:], jv[layers, 1:], rtol=0,
                                   atol=ATOL)
        # at S = 2 a stage posts one hop per microbatch (M clamps to 2
        # for the two-row prefill, 4 for the decode batch): stage 0 sends
        # every row's activations once, stage 1 sends nothing back
        assert g["ppermute_calls"] == 2 + 4
        assert g["ppermute_bytes"] == (
            sum(t.size for t, _, _, _ in steps) * cfg.hidden_size * 4
            if stage == 0 else 0)
        assert g["broadcast_calls"] == 2


# ------------------------------ the pp engine ------------------------------


@pytest.fixture(scope="module")
def jax_pp_embed():
    """The JAX pp engine's tree and its ``embed`` of PROBE_EMBED."""
    engine = JaxEngine(_jcfg("tiny:4"), JaxEngineConfig(**PP_KW), seed=0,
                       devices=jax.devices("cpu")[:S])
    vecs = np.asarray(asyncio.run(engine.embed(tw.PROBE_EMBED)), np.float32)
    asyncio.run(engine.stop())
    return numpy_tree(engine.params), vecs


@pytest.fixture(scope="module")
def probe(world2, jax_pp_embed):
    """Every rank's report from a pp engine over the JAX pp engine's tree
    (decode_steps 4 and adaptive buckets asked for, to see both
    declined)."""
    return world2.run(tw.pp_engine_probe, "tiny:4",
                      dict(PP_KW, decode_steps=4, adaptive_buckets=True),
                      jax_pp_embed[0])


@pytest.fixture(scope="module")
def jax_refusals():
    """The JAX pp engine's messages for the paths it refuses."""
    engine = JaxEngine(_jcfg("tiny:4"), JaxEngineConfig(**PP_KW), seed=0,
                       devices=jax.devices("cpu")[:S])
    async def mm():
        # the submit starts the engine's loop: stop it on the same loop
        try:
            await engine.submit(JaxRequest(
                request_id="m", token_ids=[1, 2], mm_positions=[0],
            )).__anext__()
        finally:
            await engine.stop()

    calls = {
        "extract": lambda: asyncio.run(engine.extract_kv_blocks([1])),
        "inject": lambda: asyncio.run(engine.inject_kv_blocks([1], {})),
        "kvbm": lambda: engine.attach_kvbm(),
        "mm": lambda: asyncio.run(mm()),
    }
    out = {}
    for what, call in calls.items():
        with pytest.raises(Exception) as e:
            call()
        out[what] = (type(e.value).__name__, str(e.value))
    return out


@pytest.mark.parametrize("what", ["extract", "inject", "kvbm", "mm"])
def test_pp_guards_keep_jax_messages(probe, jax_refusals, what):
    for rank in probe:
        assert rank["refused"][what] == jax_refusals[what]


@pytest.mark.parametrize("what", ["embed", "evacuation"])
def test_pp_refuses_embed_and_evacuation_by_item(world2, probe, jax_refusals,
                                                 jax_pp_embed, what):
    """``embed`` is served: every stage returns the JAX pp engine's
    vectors (within 1e-5). Evacuation behaves as the JAX engine's: the
    engine lists its decoding seats, a maintenance notice journals them,
    the KV transfer it then tries (to a peer) refuses with the JAX
    engine's message, and the seat ends as a fallback that a one-rank
    engine resumes from its journal record to the one-rank stream."""
    for rank in probe:
        if what == "embed":
            assert rank["refused"]["embed"] is None
            np.testing.assert_allclose(rank["embedded"], jax_pp_embed[1],
                                       rtol=0, atol=ATOL)
        else:
            assert rank["refused"]["evacuation"] is None
            assert rank["refused"]["extract"] == jax_refusals["extract"] == (
                "RuntimeError", "KV block transfer unsupported on a "
                "pipeline-parallel engine")
    if what == "evacuation":
        jengine = JaxEngine(JaxModelConfig.tiny(**tpre_test.MC_KW),
                            JaxEngineConfig(**tpre_test.ENG_KW), seed=0)
        tree = numpy_tree(jengine.params)
        asyncio.run(jengine.stop())
        got = world2.run(tw.mesh_script, tpre_test.MC_KW, tree,
                         dict(pp_stages=S, **tpre_test.ENG_KW), "evac",
                         "peer", tpre_test.PROMPT, 8)
        r = got[0]["result"]
        assert r["journaled"] and r["results"] == 1
        assert r["mode"] == "fallback" and not r["moved"]
        assert r["reason"] == "evacuated"
        assert r["stream"] == r["want"]
        assert r["src_running"] == 0
        assert got[1]["replayed"] == got[0]["emitted"]


def test_pp_engine_holds_its_stage_on_the_synchronous_loop(probe):
    cfg = tw._cfg("tiny:4")
    for stage, rank in enumerate(probe):
        assert rank["stage_layers"] == (2 * stage, 2 * stage + 2)
        assert rank["cache_layers"] == 2
        assert rank["wq"] == (2, cfg.hidden_size,
                              cfg.num_heads * cfg.head_dim_)
        assert rank["embed"] == (cfg.vocab_size, cfg.hidden_size)
        assert rank["pipeline_depth"] == 1
        assert not rank["graphs"] and not rank["ctl"]
        assert rank["ladders"] == []
        assert rank["obs_chips"] == rank["world"] == S


def test_decode_steps_warning_is_jax_s(probe):
    """The warning the JAX engine logs (``engine.py:1326``), word for
    word."""
    want = ("decode_steps > 1 is unsupported with pp_stages — running "
            "single-step decode")
    src = Path(jpp.__file__).parent.parent / "engine" / "engine.py"
    assert "decode_steps > 1 is unsupported with" in src.read_text()
    for rank in probe:
        assert rank["warnings"] == [want]


def test_pp_mesh_exclusive_with_tp():
    from dynamo_tpu_torch import worker

    for cfg in (JaxEngineConfig, EngineConfig):
        with pytest.raises(ValueError, match="exclusive") as e:
            cfg(pp_stages=2, mesh_shape=(1, 2))
        assert str(e.value) == "pp_stages and a (dp, tp) mesh are exclusive"
    args = worker.parse_args(["--device", "cpu", "--pp", "2", "--mesh",
                              "1,2"])
    with pytest.raises(ValueError, match="exclusive"):
        worker.check_supported(args)


@pytest.mark.parametrize("knob", [dict(spec_mode="ngram"),
                                  dict(weight_dtype="int8"),
                                  dict(kv_dtype="fp8")],
                         ids=["spec", "int8", "fp8_kv"])
def test_pp_exclusions_are_jax_s(knob):
    for cfg in (JaxEngineConfig, EngineConfig):
        with pytest.raises(ValueError, match="pp_stages == 1"):
            cfg(pp_stages=2, **knob)


# ------------------------------ the stage loader ---------------------------


@pytest.mark.parametrize("cfg_name", ["tiny:4", "tiny_moe:4"])
def test_stage_load_reads_its_layers_only(tmp_path, cfg_name):
    cfg = tw._cfg(cfg_name)
    import dynamo_tpu_torch.engine.model as tm

    params = tm.init_params(torch.Generator().manual_seed(2), cfg)
    tweights.save_hf_params(tmp_path, params, cfg, n_shards=2)
    full = tweights.load_hf_params(tmp_path, cfg, device="cpu")
    n_full = tweights.last_load_stats["n_tensors"]
    part = tweights.load_hf_params(tmp_path, cfg, device="cpu",
                                   layers=(2, 4))
    stats = dict(tweights.last_load_stats)
    assert stats["layers"] == (2, 4)
    n_top = len(full) - 1                       # embed, final_norm[, head]
    per_layer = (n_full - n_top) // cfg.num_layers
    assert stats["n_tensors"] == n_full - 2 * per_layer
    for name, leaf in full["layers"].items():
        assert torch.equal(part["layers"][name], leaf[2:4]), name
    for name in full:
        if name != "layers":
            assert torch.equal(part[name], full[name])
