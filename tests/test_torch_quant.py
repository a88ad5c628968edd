"""Quantized serving of the PyTorch port held against the JAX package
(``dynamo_tpu.engine.quant`` and ``tests/test_quantized.py``), on the CPU,
on the same numpy inputs:

* ``quantize`` / ``kv_quantize`` give bitwise the bytes and scales of
  ``quantize_jnp`` / ``kv_quantize`` for int8 and fp8, all-zero channels
  and tokens included; a token's bytes depend only on that token;
* ``"bf16"`` passes the tree through as the same object and keeps the cache
  scale-free; the quantized cache halves its pages and fits 2x the blocks
  in <= 1.13x the bytes;
* ``params_from_numpy`` on a JAX-quantized tree equals the port's own
  ``quantize_params`` bitwise;
* ``forward`` on ``ModelConfig.tiny()`` (untied head) for four
  weight/KV combinations on both attention impls, fed the JAX package's
  quantized params: hidden states within 1e-5 of JAX ``forward``, quantized
  pages bitwise equal, scales within 1e-5 relative (a scale is amax/QMAX of
  a K/V row the two packages project in a different f32 summation order);
* the logprob-divergence budget of the JAX tests holds for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.engine import quant as jq
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine import quant as tq
from dynamo_tpu_torch.engine.weights import params_from_numpy

ATOL = 1e-5
ENG_KW = dict(block_size=4, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(8,), prefill_buckets=(16, 64))
COMBOS = [("int8", "int8"), ("fp8", "fp8"), ("bf16", "int8"),
          ("int8", "bf16")]
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
    """Raw bytes of a torch tensor or a JAX/numpy array, for bitwise
    comparison (fp8 has no numpy dtype outside ml_dtypes)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.uint8)


# ----------------------------- primitives ---------------------------------


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_bitwise_matches_jax(dtype, src):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 48, 40))
         * rng.uniform(0.01, 10.0, (1, 1, 40))).astype(np.float32)
    w[:, :, 5] = 0.0  # an all-zero output channel: scale 1.0, q 0
    jw = jnp.asarray(w).astype(src)
    tw = torch.from_numpy(w).to(getattr(torch, src))
    want = jq.quantize_jnp(jw, dtype)
    got = tq.quantize(tw, dtype)
    assert got["q"].dtype == tq.storage_dtype(dtype)
    assert got["s"].dtype == torch.float32 and got["s"].shape == (3, 1, 40)
    np.testing.assert_array_equal(bits(got["q"]), bits(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert torch.all(got["s"][:, :, 5] == 1.0)
    back = tq.dequantize(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.dequantize_np(
            {"q": np.asarray(want["q"]), "s": np.asarray(want["s"])})))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_kv_quantize_bitwise_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((24, 4, 32)) * 3.0).astype(np.float32)
    x[3] = 0.0        # an all-zero token
    x[7, 2] = 0.0     # an all-zero (token, head)
    wq, ws = jq.kv_quantize(jnp.asarray(x), dtype)
    gq, gs = tq.kv_quantize(torch.from_numpy(x), dtype)
    assert gq.dtype == tq.storage_dtype(dtype) and gs.shape == (24, 4)
    np.testing.assert_array_equal(bits(gq), bits(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert torch.all(gs[3] == 1.0) and gs[7, 2] == 1.0
    np.testing.assert_array_equal(
        tq.kv_dequantize(gq, gs).numpy(),
        np.asarray(jq.kv_dequantize(wq, ws)))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_kv_quantize_per_token(dtype):
    """A token's bytes depend only on its own K/V."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 4, 16)).astype(np.float32))
    q_all, s_all = tq.kv_quantize(x, dtype)
    q_sub, s_sub = tq.kv_quantize(x[2:5], dtype)
    np.testing.assert_array_equal(bits(q_all[2:5]), bits(q_sub))
    np.testing.assert_array_equal(s_all[2:5].numpy(), s_sub.numpy())


def test_fp8_cast_saturates_where_jax_overflows():
    """torch saturates past 448 where jnp gives NaN; quantize never goes
    there (|q| <= 448), which the bitwise tests above pin."""
    big = np.array([470.0, 500.0], np.float32)
    assert torch.all(torch.from_numpy(big).to(torch.float8_e4m3fn).float()
                     == 448.0)
    assert np.isnan(np.asarray(jnp.asarray(big).astype(jnp.float8_e4m3fn)
                               .astype(jnp.float32))).all()
    w = torch.tensor([[448.0], [-1e-3]])
    assert tq.quantize(w, "fp8")["q"].float()[0, 0] == 448.0


def test_bf16_passthrough_identity():
    tc = tcfg.ModelConfig.tiny()
    params = tm.init_params(torch.Generator().manual_seed(0), tc)
    assert tq.quantize_params(params, "bf16") is params
    cache = tm.init_cache(tc, tcfg.EngineConfig(**ENG_KW),
                          torch.device("cpu"))
    assert set(cache) == {"k", "v"}


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_init_cache_structure(kv_dtype):
    tc = tcfg.ModelConfig.tiny()
    eng = tcfg.EngineConfig(kv_dtype=kv_dtype, **ENG_KW)
    cache = tm.init_cache(tc, eng, torch.device("cpu"))
    jcache = jm.init_cache(jcfg.ModelConfig.tiny(),
                           jcfg.EngineConfig(kv_dtype=kv_dtype, **ENG_KW))
    assert set(cache) == set(jcache) == {"k", "v", "ks", "vs"}
    for key in cache:
        assert len(cache[key]) == tc.num_layers
        for got, want in zip(cache[key], jcache[key]):
            assert tuple(got.shape) == want.shape
            assert got.element_size() == want.dtype.itemsize
            assert torch.all(got.float() == 0)
    assert cache["k"][0].dtype == tq.storage_dtype(kv_dtype)
    assert cache["ks"][0].dtype == torch.float32


def test_quantized_cache_capacity():
    """Pages halve exactly; 2x the blocks, scales included, cost at most
    1.13x the bf16 bytes (tests/test_quantized.py's capacity check)."""
    cfg = tcfg.ModelConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=4, head_dim=64,
        max_position=512, rope_theta=10000.0, dtype="bfloat16",
    )
    kw = dict(block_size=16, num_blocks=128, max_num_seqs=4,
              max_num_batched_tokens=256, max_model_len=256,
              prefill_buckets=(64, 256), decode_buckets=(4, 8))

    def nbytes(eng, keys=None):
        c = tm.init_cache(cfg, eng, torch.device("cpu"))
        return sum(t.numel() * t.element_size()
                   for key, lst in c.items() if keys is None or key in keys
                   for t in lst)

    eng16 = tcfg.EngineConfig(**kw)
    eng8 = tcfg.EngineConfig(kv_dtype="int8", **kw)
    assert nbytes(eng8, ("k", "v")) * 2 == nbytes(eng16, ("k", "v"))
    eng8_2x = tcfg.EngineConfig(kv_dtype="int8",
                                **{**kw, "num_blocks": 256})
    assert nbytes(eng8_2x) <= nbytes(eng16) * 1.13
    assert tq.kv_bytes_per_elem("int8") == 1.0
    assert tq.kv_bytes_per_elem("bf16") == 2.0


@pytest.mark.parametrize("weight_dtype", ["int8", "fp8"])
def test_params_from_numpy_quantized_tree_bitwise(weight_dtype):
    """A tree the JAX package quantized, carried across, equals the port's
    own ``quantize_params`` of the same float weights, bit for bit; a
    quantized tree passes ``quantize_params`` unchanged."""
    jc, tc = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    jparams = jm.init_params(jax.random.PRNGKey(0), jc)
    carried = params_from_numpy(
        numpy_tree(jq.quantize_params(jparams, weight_dtype)), tc, "cpu",
        weight_dtype=weight_dtype)
    own = tq.quantize_params(
        params_from_numpy(numpy_tree(jparams), tc, "cpu"), weight_dtype)
    assert tq.quantize_params(carried, weight_dtype)["layers"]["wq"] is \
        carried["layers"]["wq"]
    for name in tq.QUANTIZED_LEAVES:
        a = carried["layers"].get(name, carried.get(name))
        b = own["layers"].get(name, own.get(name))
        assert isinstance(a, dict) and a["q"].dtype == b["q"].dtype
        np.testing.assert_array_equal(bits(a["q"]), bits(b["q"]))
        np.testing.assert_array_equal(a["s"].numpy(), b["s"].numpy())
    for name in ("attn_norm", "mlp_norm"):
        torch.testing.assert_close(carried["layers"][name],
                                   own["layers"][name], rtol=0, atol=0)
    with pytest.raises(TypeError):
        params_from_numpy(numpy_tree(jq.quantize_params(jparams, "int8")),
                          tc, "cpu")


def test_config_accepts_quantized_knobs_and_keeps_pp_rule():
    for wd, kd in COMBOS:
        tcfg.check_supported(tcfg.EngineConfig(weight_dtype=wd, kv_dtype=kd))
    with pytest.raises(ValueError, match="pp_stages"):
        tcfg.EngineConfig(weight_dtype="int8", pp_stages=2)
    with pytest.raises(ValueError, match="kv_dtype"):
        tcfg.EngineConfig(kv_dtype="e5m2")


# ------------------------------- forward ----------------------------------


def _feed():
    """A ragged prefill batch (rows of 13 and 5 valid tokens, pads -1),
    then two decode steps with a padding row."""
    rng = np.random.RandomState(0)
    toks = np.zeros((2, 16), np.int32)
    pos = np.full((2, 16), -1, np.int32)
    toks[0, :13] = rng.randint(1, 512, 13)
    pos[0, :13] = np.arange(13)
    toks[1, :5] = rng.randint(1, 512, 5)
    pos[1, :5] = np.arange(5)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :2] = [5, 6]
    steps = [(toks, pos, tables)]
    for t in range(2):
        dt = np.array([[rng.randint(1, 512)], [rng.randint(1, 512)], [0]],
                      np.int32)
        dp = np.array([[13 + t], [5 + t], [-1]], np.int32)
        dtab = np.zeros((3, 8), np.int32)
        dtab[0, :4] = [1, 2, 3, 4]
        dtab[1, :2] = [5, 6]
        steps.append((dt, dp, dtab))
    return steps


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(jax.random.PRNGKey(0), jcfg.ModelConfig.tiny())


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
@pytest.mark.parametrize("weight_dtype,kv_dtype", COMBOS)
def test_forward_and_cache_match_jax(jax_params, weight_dtype, kv_dtype,
                                     impl):
    jc, tc = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    assert not tc.tie_word_embeddings  # the untied head is quantized too
    jparams = jq.quantize_params(jax_params, weight_dtype)
    tparams = params_from_numpy(numpy_tree(jparams), tc, "cpu",
                                weight_dtype=weight_dtype)
    jax_impl = "pallas" if impl == "kernel" else "einsum"
    je = jcfg.EngineConfig(attention_impl=jax_impl,
                           attention_impl_prefill=jax_impl,
                           weight_dtype=weight_dtype, kv_dtype=kv_dtype,
                           **ENG_KW)
    te = tcfg.EngineConfig(attention_impl=impl, weight_dtype=weight_dtype,
                           kv_dtype=kv_dtype, **ENG_KW)
    jcache = jm.init_cache(jc, je)
    tcache = tm.init_cache(tc, te, torch.device("cpu"))
    for toks, pos, tables in _feed():
        jcache, jh = jm.forward(jc, je, jparams, jcache, jnp.asarray(toks),
                                jnp.asarray(pos), jnp.asarray(tables))
        tcache, th = tm.forward(tc, te, tparams, tcache,
                                torch.from_numpy(toks),
                                torch.from_numpy(pos),
                                torch.from_numpy(tables))
        valid = pos >= 0
        np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                                   rtol=0, atol=ATOL)
    logits = tm.logits_fn(tc, tparams, th)
    np.testing.assert_allclose(
        logits.numpy()[valid],
        np.asarray(jm.logits_fn(jc, jparams, jh))[valid], rtol=0, atol=1e-4)
    assert set(tcache) == set(jcache)
    for key in tcache:
        for li in range(tc.num_layers):
            # block 0 is the trash block: pad rows race to write it
            got, want = tcache[key][li][1:], np.asarray(jcache[key][li])[1:]
            if key in ("k", "v") and kv_dtype != "bf16":
                np.testing.assert_array_equal(bits(got), bits(want))
            elif key in ("ks", "vs"):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=0)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=ATOL)


def _logprobs(params, weight_dtype, kv_dtype):
    """Valid-position logprobs of a mixed ragged prefill batch (three rows
    of different lengths) through the port's einsum path, as in
    tests/test_quantized.py."""
    tc = tcfg.ModelConfig.tiny()
    eng = tcfg.EngineConfig(
        block_size=16, num_blocks=128, max_num_seqs=4,
        max_num_batched_tokens=256, max_model_len=256,
        prefill_buckets=(64, 256), decode_buckets=(4, 8),
        attention_impl="einsum", weight_dtype=weight_dtype,
        kv_dtype=kv_dtype)
    params = tq.quantize_params(params, weight_dtype)
    cache = tm.init_cache(tc, eng, torch.device("cpu"))
    rng = np.random.default_rng(3)
    B, T, W = 3, 32, 4
    tokens = rng.integers(1, tc.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.array([32, 17, 5], np.int32)
    positions = np.broadcast_to(np.arange(T), (B, T)).copy().astype(np.int32)
    for r, ln in enumerate(lens):
        positions[r, ln:] = -1
        tokens[r, ln:] = 0
    tables = 1 + np.arange(B * W).reshape(B, W).astype(np.int32)
    _, h = tm.forward(tc, eng, params, cache, torch.from_numpy(tokens),
                      torch.from_numpy(positions), torch.from_numpy(tables))
    lp = torch.log_softmax(tm.logits_fn(tc, params, h), dim=-1).numpy()
    return [lp[r, :ln] for r, ln in enumerate(lens)]


@pytest.mark.parametrize("weight_dtype,kv_dtype", COMBOS)
def test_logprob_divergence_budget(jax_params, weight_dtype, kv_dtype):
    params = params_from_numpy(numpy_tree(jax_params),
                               tcfg.ModelConfig.tiny(), "cpu")
    ref = _logprobs(params, "bf16", "bf16")
    got = _logprobs(params, weight_dtype, kv_dtype)
    budget = max(LOGPROB_BUDGET.get(weight_dtype, 0.0),
                 LOGPROB_BUDGET.get(kv_dtype, 0.0))
    worst = max(float(np.max(np.abs(g - r))) for g, r in zip(got, ref))
    assert np.isfinite(worst)
    assert 0.0 < worst <= budget, (
        f"{weight_dtype}/{kv_dtype} logprob divergence {worst:.4f} "
        f"(budget {budget})")
