"""The port's Mixture-of-Experts path held against the JAX package on the
CPU, on the same numpy inputs:

* ``moe_capacity`` and ``moe_ffn`` equal ``dynamo_tpu.parallel.moe``'s in
  f32 to 1e-5, with a capacity overflow, a top-k tie (ties go to the lower
  expert, as ``jax.lax.top_k`` orders them) and padded rows;
* ``moe_ffn`` with room for every pick equals a token-by-token f32
  reference;
* ``ModelConfig.tiny_moe`` ``forward`` (prefill and decode steps, both
  attention impls) equals JAX's hidden states to 1e-5, and the port engine
  streams the JAX engine's greedy tokens, with and without the spec
  window;
* int8/fp8 expert stacks quantize to JAX's bytes, the quantized forward
  matches JAX's, and the logprob divergence stays within the budgets of
  ``tests/test_quantized.py``;
* ``param_count``/``active_param_count`` equal JAX's for Mixtral-8x7B and
  ``tiny_moe``, and count ``init_params``'s tree exactly.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.engine import quant as jq
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.engine import Request as JaxRequest
from dynamo_tpu.observability import flops as jflops
from dynamo_tpu.parallel import moe as jmoe
from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine, Request
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine import quant as tq
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.observability import flops as tflops
from dynamo_tpu_torch.parallel import moe as tmoe

ATOL = 1e-5
ENG_KW = dict(block_size=4, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(4, 8), prefill_buckets=(16, 64))
# tests/test_quantized.py: int8 peaks ~0.08 nats on the tiny model, fp8
# ~0.35; the budgets leave ~3x headroom
LOGPROB_BUDGET = {"int8": 0.25, "fp8": 0.80}


def numpy_tree(tree):
    """JAX params as numpy leaves: bf16 as uint16 bits, fp8 as uint8."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16)
        if a.dtype.name == "float8_e4m3fn":
            return a.view(np.uint8)
        return a
    return jax.tree.map(leaf, tree)


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.ModelConfig.tiny_moe()
    tc = tcfg.ModelConfig.tiny_moe()
    jparams = jm.init_params(jax.random.PRNGKey(0), jc)
    tparams = params_from_numpy(numpy_tree(jparams), tc, "cpu")
    return jc, tc, jparams, tparams


def _weights(rng, N, D, F, E, dup_router=False):
    x = rng.standard_normal((N, D)).astype(np.float32)
    wr = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    if dup_router:
        wr[:, 5] = wr[:, 2]   # experts 2 and 5 tie for every token
        wr[:, 6] = wr[:, 1]
    wg = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    return x, wr, wg, wu, wd


# ------------------------------ moe_ffn ----------------------------------


@pytest.mark.parametrize("args", [(32, 8, 2, 2.0), (32, 4, 2, 0.0625),
                                  (1, 8, 2, 2.0), (512, 8, 2, 2.0),
                                  (7, 3, 1, 1.3)])
def test_moe_capacity_equals_jax(args):
    assert tmoe.moe_capacity(*args) == jmoe.moe_capacity(*args)


@pytest.mark.parametrize("case", [
    dict(N=32, E=8, k=2, cf=2.0),              # the serving default
    dict(N=32, E=4, k=2, cf=0.0625),           # C=1: most picks overflow
    dict(N=24, E=8, k=2, cf=1.0, pad=8),       # 8 identical pad rows first
    dict(N=16, E=8, k=2, cf=2.0, dup=True),    # every token's top-2 ties
    dict(N=16, E=8, k=1, cf=8.0),              # top-1, room for all
], ids=["default", "overflow", "pad-rows", "ties", "top1"])
def test_moe_ffn_equals_jax(case):
    rng = np.random.default_rng(7)
    x, wr, wg, wu, wd = _weights(rng, case["N"], 16, 24, case["E"],
                                 dup_router=case.get("dup", False))
    if case.get("pad"):
        x[:case["pad"]] = x[0]
    want = np.asarray(jmoe.moe_ffn(
        *(jnp.asarray(a) for a in (x, wr, wg, wu, wd)), top_k=case["k"],
        capacity_factor=case["cf"]))
    got = tmoe.moe_ffn(*(torch.from_numpy(a) for a in (x, wr, wg, wu, wd)),
                       top_k=case["k"], capacity_factor=case["cf"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_topk_ties_go_to_the_lower_index_as_in_jax():
    probs = np.array([[0.1, 0.3, 0.1, 0.3, 0.2],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.0, 0.5, 0.25, 0.25, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tmoe.topk_lower_first(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist()[1] == [0, 1, 2]


def _per_token_reference(x, wr, wg, wu, wd, k):
    """Each token's top-k experts, one at a time, in f32, no capacity."""
    out = np.zeros_like(x)
    for n in range(x.shape[0]):
        logits = x[n] @ wr
        p = np.exp(logits - logits.max())
        p /= p.sum()
        top = np.argsort(-p, kind="stable")[:k]
        g = p[top] / p[top].sum()
        for e, w in zip(top, g):
            a = x[n] @ wg[e]
            h = a / (1.0 + np.exp(-a)) * (x[n] @ wu[e])
            out[n] += w * (h @ wd[e])
    return out


def test_moe_ffn_with_room_equals_the_per_token_reference():
    rng = np.random.default_rng(11)
    x, wr, wg, wu, wd = _weights(rng, 20, 16, 24, 8)
    got = tmoe.moe_ffn(*(torch.from_numpy(a) for a in (x, wr, wg, wu, wd)),
                       top_k=2, capacity_factor=8.0)
    np.testing.assert_allclose(
        got.numpy(), _per_token_reference(x, wr, wg, wu, wd, 2),
        rtol=0, atol=ATOL)


# --------------------------- params and flops ------------------------------


def test_init_params_moe_tree_matches_jax_shapes(setup):
    jc, tc, jparams, _ = setup
    tp = tm.init_params(torch.Generator().manual_seed(0), tc)
    jl, tl = jparams["layers"], tp["layers"]
    assert set(jl) == set(tl)
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k
        assert tl[k].dtype == torch.float32
    n = sum(t.numel() for t in tl.values()) + sum(
        tp[k].numel() for k in ("embed", "final_norm", "lm_head") if k in tp)
    assert n == tflops.param_count(tc)


@pytest.mark.parametrize("name", ["mixtral_8x7b", "tiny_moe"])
def test_param_counts_equal_jax(name):
    jc, tc = getattr(jcfg.ModelConfig, name)(), getattr(tcfg.ModelConfig,
                                                          name)()
    assert tc == tcfg.ModelConfig(**{f: getattr(jc, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "rms_norm_eps", "max_position", "tie_word_embeddings", "dtype",
        "num_experts", "num_experts_per_token", "moe_capacity_factor")})
    assert tflops.param_count(tc) == jflops.param_count(jc)
    assert tflops.active_param_count(tc) == jflops.active_param_count(jc)
    fm = tflops.FlopsModel(tc)
    assert fm.step_flops(16, 9000) == jflops.FlopsModel(jc).step_flops(
        16, 9000)
    assert tflops.active_param_count(tc) < tflops.param_count(tc)


# ------------------------------ forward -----------------------------------


def _feed():
    """A ragged prefill batch (rows of 13 and 5 valid tokens, pads -1),
    then two decode steps with a padding row."""
    rng = np.random.RandomState(0)
    steps = []
    toks = np.zeros((2, 16), np.int32)
    pos = np.full((2, 16), -1, np.int32)
    toks[0, :13] = rng.randint(1, 512, 13)
    pos[0, :13] = np.arange(13)
    toks[1, :5] = rng.randint(1, 512, 5)
    pos[1, :5] = np.arange(5)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :2] = [5, 6]
    steps.append((toks, pos, tables))
    for t in range(2):
        dt = np.array([[rng.randint(1, 512)], [rng.randint(1, 512)], [0]],
                      np.int32)
        dp = np.array([[13 + t], [5 + t], [-1]], np.int32)
        dtab = np.zeros((3, 8), np.int32)
        dtab[0, :4] = [1, 2, 3, 4]
        dtab[1, :2] = [5, 6]
        steps.append((dt, dp, dtab))
    return steps


ENG_FWD = dict(block_size=4, num_blocks=64, max_num_seqs=8,
               max_num_batched_tokens=64, max_model_len=128,
               decode_buckets=(8,), prefill_buckets=(16, 64))


def _run_forward(jc, tc, jparams, tparams, jax_impl, torch_impl,
                 weight_dtype="bf16", kv_dtype="bf16"):
    q = dict(weight_dtype=weight_dtype, kv_dtype=kv_dtype)
    je = jcfg.EngineConfig(attention_impl=jax_impl,
                           attention_impl_prefill=jax_impl, **q, **ENG_FWD)
    te = tcfg.EngineConfig(attention_impl=torch_impl, **q, **ENG_FWD)
    jcache = jm.init_cache(jc, je)
    tcache = tm.init_cache(tc, te, torch.device("cpu"))
    outs = []
    for toks, pos, tables in _feed():
        jcache, jh = jm.forward(jc, je, jparams, jcache, jnp.asarray(toks),
                                jnp.asarray(pos), jnp.asarray(tables))
        tcache, th = tm.forward(tc, te, tparams, tcache,
                                torch.from_numpy(toks),
                                torch.from_numpy(pos),
                                torch.from_numpy(tables))
        outs.append((pos >= 0, th.numpy(), np.asarray(jh)))
    return outs


@pytest.mark.parametrize("jax_impl,torch_impl", [
    ("einsum", "einsum"), ("einsum", "kernel"), ("pallas", "kernel")])
def test_forward_matches_jax(setup, jax_impl, torch_impl):
    """Hidden states of the valid rows to 1e-5. Pad rows route too (they
    take capacity slots in row order), so valid rows only agree if the pad
    rows computed what JAX's did."""
    jc, tc, jparams, tparams = setup
    for valid, th, jh in _run_forward(jc, tc, jparams, tparams, jax_impl,
                                      torch_impl):
        np.testing.assert_allclose(th[valid], jh[valid], rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_expert_stacks_equal_jax(setup, dtype):
    """Expert stacks [L, E, in, out] quantize to JAX's bytes with scales
    [L, E, 1, out]; dequantized they match; the router stays unquantized."""
    jc, tc, jparams, tparams = setup
    want = jq.quantize_params(jparams, dtype)
    got = tq.quantize_params(tparams, dtype)
    assert not isinstance(got["layers"]["w_router"], dict)
    for k in ("w_gate", "w_up", "w_down"):
        g, w = got["layers"][k], want["layers"][k]
        assert tuple(g["s"].shape) == w["s"].shape
        assert g["s"].shape[:2] == (tc.num_layers, tc.num_experts)
        assert g["s"].shape[2] == 1
        np.testing.assert_array_equal(bits(g["q"]), bits(w["q"]))
        np.testing.assert_array_equal(g["s"].numpy(), np.asarray(w["s"]))
        np.testing.assert_array_equal(
            tm._dequant_leaf(g, torch.float32).numpy(),
            np.asarray(jm._dequant_leaf(w, jnp.float32)))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_forward_matches_jax(setup, dtype):
    jc, tc, jparams, _ = setup
    jq_params = jq.quantize_params(jparams, dtype)
    tq_params = params_from_numpy(numpy_tree(jq_params), tc, "cpu",
                                  weight_dtype=dtype)
    for valid, th, jh in _run_forward(jc, tc, jq_params, tq_params,
                                      "einsum", "kernel", dtype, dtype):
        np.testing.assert_allclose(th[valid], jh[valid], rtol=0, atol=ATOL)


def _logprobs(pkg, weight_dtype, kv_dtype, params):
    """Valid-position logprobs of a mixed ragged prefill batch (three rows
    of different lengths, as ``tests/test_quantized.py`` feeds the dense
    model) through the einsum path of ``pkg`` ("jax" | "port")."""
    rng = np.random.default_rng(3)
    B, T, W = 3, 32, 8
    tokens = rng.integers(1, 512, size=(B, T)).astype(np.int32)
    lens = np.array([32, 17, 5], np.int32)
    positions = np.broadcast_to(np.arange(T), (B, T)).copy().astype(np.int32)
    for r, ln in enumerate(lens):
        positions[r, ln:] = -1
        tokens[r, ln:] = 0
    tables = 1 + np.arange(B * W).reshape(B, W).astype(np.int32)
    kw = dict(weight_dtype=weight_dtype, kv_dtype=kv_dtype,
              attention_impl="einsum", **ENG_FWD)
    if pkg == "jax":
        mc, eng = jcfg.ModelConfig.tiny_moe(), jcfg.EngineConfig(**kw)
        params = jq.quantize_params(params, weight_dtype)
        _, h = jm.forward(mc, eng, params, jm.init_cache(mc, eng),
                          jnp.asarray(tokens), jnp.asarray(positions),
                          jnp.asarray(tables))
        lp = np.asarray(jax.nn.log_softmax(jm.logits_fn(mc, params, h),
                                           axis=-1))
    else:
        mc, eng = tcfg.ModelConfig.tiny_moe(), tcfg.EngineConfig(**kw)
        params = tq.quantize_params(params, weight_dtype)
        _, h = tm.forward(mc, eng, params,
                          tm.init_cache(mc, eng, torch.device("cpu")),
                          torch.from_numpy(tokens),
                          torch.from_numpy(positions),
                          torch.from_numpy(tables))
        lp = torch.log_softmax(tm.logits_fn(mc, params, h), dim=-1).numpy()
    return [lp[r, :ln] for r, ln in enumerate(lens)]


@pytest.mark.parametrize("weight_dtype,kv_dtype", [
    ("int8", "int8"), ("fp8", "fp8"), ("int8", "bf16"), ("bf16", "int8")])
def test_quantized_logprob_divergence_equals_jax(setup, weight_dtype,
                                                 kv_dtype):
    """The quantized model's divergence from the bf16 one equals the JAX
    package's to 1e-4. Quantized KV alone stays within the dense budget of
    ``tests/test_quantized.py``; quantized experts do not, in either
    package: a quantized stack moves near-tied router logits, a flipped
    pick swaps a whole expert's output (~0.5-1.3 nats here). ROADMAP.md
    logs this as a finding about the reference."""
    _, _, jparams, tparams = setup
    worst = {}
    for pkg, params in (("jax", jparams), ("port", tparams)):
        ref = _logprobs(pkg, "bf16", "bf16", params)
        got = _logprobs(pkg, weight_dtype, kv_dtype, params)
        worst[pkg] = max(float(np.max(np.abs(g - r)))
                         for g, r in zip(got, ref))
    assert 0.0 < worst["port"]
    assert abs(worst["port"] - worst["jax"]) <= 1e-4, worst
    if weight_dtype == "bf16":
        assert worst["port"] <= LOGPROB_BUDGET[kv_dtype]


# ------------------------------ engines -----------------------------------

PROMPTS = [
    [5, 6, 7],
    list(range(20, 41)),
    [9, 10, 11, 12, 13, 14, 15],
    list(range(100, 170)),        # longer than one prefill bucket (64)
]
MAX_TOKENS = [6, 9, 4, 7]


async def _serve(engine, request_cls, prompts=PROMPTS, max_tokens=MAX_TOKENS):
    async def one(i):
        req = request_cls(request_id=f"r{i}", token_ids=prompts[i],
                          max_tokens=max_tokens[i])
        return [o.token_id async for o in engine.submit(req)]
    try:
        return await asyncio.gather(*(one(i) for i in range(len(prompts))))
    finally:
        await engine.stop()


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("decode_steps", [1, 4])
def test_greedy_streams_match_jax_engine(setup, impl, decode_steps):
    """On the synchronous loop both engines batch alike, so every window
    routes the same rows, padding included, in the same order: the greedy
    streams are identical. (Under run-ahead a window's seat map depends on
    when earlier results landed — a finished seat keeps its column until
    the host learns of it — and capacity-based routing lets a pad row's
    pick move a live row's, in either package.) The JAX engine runs its
    default classes (Pallas decode, einsum prefill) against the port's
    kernel decode, or einsum on both."""
    jc, tc, jparams, _ = setup
    jax_impl = "pallas" if impl == "kernel" else "einsum"
    jengine = JaxEngine(jc, jcfg.EngineConfig(
        attention_impl=jax_impl, decode_steps=decode_steps,
        pipeline_depth=1, **ENG_KW), params=jparams, seed=0)
    want = asyncio.run(_serve(jengine, JaxRequest))
    tengine = InferenceEngine(
        tc, EngineConfig(attention_impl=impl, attention_impl_prefill="einsum",
                         decode_steps=decode_steps, pipeline_depth=1,
                         **ENG_KW),
        params=params_from_numpy(numpy_tree(jparams), tc, "cpu"),
        device="cpu")
    got = asyncio.run(_serve(tengine, Request))
    assert [len(g) for g in got] == MAX_TOKENS
    assert got == want


def test_spec_window_streams_match_jax_engine(setup):
    """A spec (n-gram, k=4) engine on tiny_moe: its [B, k+1] verify rows
    route through the experts as one chunk; streams equal the JAX spec
    engine's, and the port's non-spec ones."""
    jc, tc, jparams, _ = setup
    prompts = [[7, 8, 9, 10] * 6, list(range(30, 50)) * 2, [3, 4] * 9]
    mt = [16, 12, 10]
    kw = dict(ENG_KW, spec_mode="ngram", spec_k=4, attention_impl="einsum",
              pipeline_depth=1)
    jengine = JaxEngine(jc, jcfg.EngineConfig(**kw), params=jparams, seed=0)
    want = asyncio.run(_serve(jengine, JaxRequest, prompts, mt))
    tengine = InferenceEngine(
        tc, EngineConfig(**kw),
        params=params_from_numpy(numpy_tree(jparams), tc, "cpu"),
        device="cpu")
    got = asyncio.run(_serve(tengine, Request, prompts, mt))
    assert got == want
    assert tengine.spec_stats.windows > 0 and tengine.spec_stats.drafted > 0
