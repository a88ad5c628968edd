"""The PyTorch port's model core held against the JAX package on
``ModelConfig.tiny()`` in float32, with the JAX parameters carried across by
``params_from_numpy``: ``forward`` (hidden states and the updated paged
cache), the dense-reference checks of tests/test_engine_model.py, ``sample``,
and the packed prefill plus autopilot decode windows.

Tolerances: forward and cache agree to 1e-5 (both compute in f32, in a
different summation order); logits against the dense reference keep that
test's 2e-4; token streams are compared exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine.weights import params_from_numpy

ATOL = 1e-5
ENG_KW = dict(block_size=4, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(8,), prefill_buckets=(16, 64))


def numpy_tree(tree):
    """JAX params as numpy leaves; bf16 leaves as uint16 bit views."""
    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.ModelConfig.tiny()
    tc = tcfg.ModelConfig.tiny()
    jparams = jm.init_params(jax.random.PRNGKey(0), jc)
    tparams = params_from_numpy(numpy_tree(jparams), tc, "cpu")
    return jc, tc, jparams, tparams


def jax_eng(impl):
    if impl == "pallas":
        return jcfg.EngineConfig(attention_impl="pallas",
                                 attention_impl_prefill="pallas", **ENG_KW)
    return jcfg.EngineConfig(attention_impl="einsum", **ENG_KW)


def _feed():
    """A ragged prefill batch (rows of 13 and 5 valid tokens, pads -1) and
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


@pytest.mark.parametrize("torch_impl", ["kernel", "einsum"])
@pytest.mark.parametrize("jax_impl", ["einsum", "pallas"])
def test_forward_and_cache_match_jax(setup, jax_impl, torch_impl):
    jc, tc, jparams, tparams = setup
    je = jax_eng(jax_impl)
    te = tcfg.EngineConfig(attention_impl=torch_impl, **ENG_KW)
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
    for key in ("k", "v"):
        for li in range(tc.num_layers):
            # block 0 is the trash block: pad rows race to write it
            np.testing.assert_allclose(
                tcache[key][li].numpy()[1:], np.asarray(jcache[key][li])[1:],
                rtol=0, atol=ATOL)


def dense_reference(cfg, params, tokens):
    """Independent dense causal forward in torch (no paging, no cache)."""
    T = len(tokens)
    hd, H, KV = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    h = params["embed"][torch.tensor(tokens)][None]
    positions = torch.arange(T)[None]

    def norm(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + cfg.rms_norm_eps) * w

    for li in range(cfg.num_layers):
        p = {k: v[li] for k, v in params["layers"].items()}
        x = norm(h, p["attn_norm"])
        q = tm._rope((x @ p["wq"]).reshape(1, T, H, hd), positions,
                     cfg.rope_theta)
        k = tm._rope((x @ p["wk"]).reshape(1, T, KV, hd), positions,
                     cfg.rope_theta)
        v = (x @ p["wv"]).reshape(1, T, KV, hd)
        G = H // KV
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool))
        s = s.masked_fill(~causal, -1e30)
        attn = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
        h = h + attn.reshape(1, T, H * hd) @ p["wo"]
        x = norm(h, p["mlp_norm"])
        h = h + (torch.nn.functional.silu(x @ p["w_gate"])
                 * (x @ p["w_up"])) @ p["w_down"]
    h = norm(h, params["final_norm"])
    return tm.logits_fn(cfg, params, h)[0]


def run_paged(cfg, eng, params, tokens, chunks):
    cache = tm.init_cache(cfg, eng, torch.device("cpu"))
    bs = eng.block_size
    table = torch.arange(1, (len(tokens) + bs - 1) // bs + 1,
                         dtype=torch.int32)[None]
    outs, start = [], 0
    for chunk in chunks:
        toks = torch.tensor(tokens[start:start + chunk], dtype=torch.int32)
        pos = torch.arange(start, start + chunk, dtype=torch.int32)
        cache, h = tm.forward(cfg, eng, params, cache, toks[None],
                              pos[None], table)
        outs.append(tm.logits_fn(cfg, params, h)[0])
        start += chunk
    return torch.cat(outs)


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
@pytest.mark.parametrize("chunks", [[13], [5, 4, 5], [1] * 9],
                         ids=["paged_prefill", "chunked", "tokenwise"])
def test_paged_matches_dense(setup, impl, chunks):
    _, tc, _, tparams = setup
    eng = tcfg.EngineConfig(attention_impl=impl, **ENG_KW)
    tokens = list(np.random.RandomState(len(chunks)).randint(
        1, tc.vocab_size, sum(chunks)))
    ref = dense_reference(tc, tparams, tokens)
    got = run_paged(tc, eng, tparams, tokens, chunks)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


def test_params_from_numpy_bf16_bits():
    jc = jcfg.ModelConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=8, tie_word_embeddings=True,
    )
    tc = tcfg.ModelConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=8, tie_word_embeddings=True,
    )
    tree = numpy_tree(jm.init_params(jax.random.PRNGKey(1), jc))
    params = params_from_numpy(tree, tc, "cpu")
    assert "lm_head" not in params
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["layers"]["wq"].view(torch.int16).numpy().view(np.uint16),
        tree["layers"]["wq"])


# ------------------------------ sampling ----------------------------------


def _jax_sample(logits, temp, top_k, top_p, seeds, positions):
    return np.asarray(jm.sample(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(seeds),
        jnp.asarray(positions),
    ))


def _torch_sample(logits, temp, top_k, top_p, seeds, positions,
                  stochastic):
    return tm.sample(
        torch.from_numpy(logits), torch.tensor(7), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(seeds), torch.from_numpy(positions), stochastic,
    ).numpy()


def test_greedy_identical():
    rng = np.random.default_rng(0)
    B, V = 16, 512
    logits = rng.standard_normal((B, V)).astype(np.float32)
    temp = np.zeros(B, np.float32)
    temp[::3] = 0.9                   # sampled rows beside greedy ones
    args = (np.zeros(B, np.int32), np.ones(B, np.float32),
            np.full(B, -1, np.int32), np.arange(B, dtype=np.int32))
    greedy = temp == 0
    want = _jax_sample(logits, temp, *args)
    got = _torch_sample(logits, temp, *args, stochastic=True)
    np.testing.assert_array_equal(got[greedy], want[greedy])
    zero = np.zeros(B, np.float32)
    np.testing.assert_array_equal(
        _torch_sample(logits, zero, *args, stochastic=False),
        _jax_sample(logits, zero, *args))


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 5, 1.0), (1.0, 0, 0.5), (1.3, 6, 0.8), (0.7, 3, 0.0),
])
def test_candidate_sets_identical(temp, top_k, top_p):
    """The surviving top-k / top-p candidates are the same set: every token
    the JAX sampler draws over 512 seeded rows lies in the port's mask, and
    every token of the mask is drawn (each candidate holds >= 5% of the
    mass, so all of them appear)."""
    rng = np.random.default_rng(1)
    V, B = 512, 512
    row = rng.standard_normal(V).astype(np.float32) * 0.3 - 6.0
    head = rng.permutation(V)[:8]
    row[head] = np.linspace(3.0, 2.3, 8, dtype=np.float32)
    logits = np.tile(row, (B, 1))
    t = np.full(B, temp, np.float32)
    k = np.full(B, top_k, np.int32)
    p = np.full(B, top_p, np.float32)
    seeds = np.arange(B, dtype=np.int32)
    pos = np.zeros(B, np.int32)
    drawn = set(_jax_sample(logits, t, k, p, seeds, pos).tolist())
    _, keep = tm._candidates(torch.from_numpy(logits), torch.from_numpy(t),
                             torch.from_numpy(k), torch.from_numpy(p))
    mask = set(np.nonzero(keep[0].numpy())[0].tolist())
    assert drawn == mask
    ours = _torch_sample(logits, t, k, p, seeds, pos, stochastic=True)
    assert set(ours.tolist()) <= mask


def test_seeded_rows_are_batch_invariant_and_position_keyed():
    rng = np.random.default_rng(2)
    V = 512
    logits = rng.standard_normal((4, V)).astype(np.float32)
    temp = np.ones(4, np.float32)
    kw = (np.zeros(4, np.int32), np.ones(4, np.float32))
    seeds = np.array([11, 11, -1, 11], np.int32)
    pos = np.array([5, 5, 5, 6], np.int32)
    a = _torch_sample(logits[[0, 0, 0, 0]], temp, *kw, seeds, pos, True)
    b = tm.sample(torch.from_numpy(logits[[0]]), torch.tensor(99),
                  torch.ones(1), torch.zeros(1, dtype=torch.int32),
                  torch.ones(1), torch.tensor([11], dtype=torch.int32),
                  torch.tensor([5], dtype=torch.int32), True).numpy()
    assert a[0] == a[1] == b[0]
    draws = {int(_torch_sample(logits[[0]], temp[:1], kw[0][:1], kw[1][:1],
                               np.array([11], np.int32),
                               np.array([p], np.int32), True)[0])
             for p in range(32)}
    assert len(draws) > 1   # the stream moves with the position


# ------------------- packed prefill + autopilot windows --------------------


def test_packed_prefill_and_autopilot_windows_match_jax(setup):
    """Two seats prefilled by the packed prefill, then autopilot decode
    windows of K=4 over device-resident control state. Seat 1's capacity
    ends mid-window (valid_until), so its later windows hit the acc == 0
    trash-slot write-back. Accepted tokens, ring tokens and positions match
    the JAX step functions exactly (greedy)."""
    jc, tc, jparams, tparams = setup
    je = jcfg.EngineConfig(**ENG_KW)   # JAX defaults: pallas decode
    te = tcfg.EngineConfig(**ENG_KW)
    K, T, W = 4, 16, 8
    S, Wcap = je.max_num_seqs, je.max_blocks_per_seq
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 512, 12), rng.randint(1, 512, 7)]
    tables = [[1, 2, 3, 4, 5, 6], [7, 8, 9]]
    vus = [24, 10]          # seat 1 runs out 3 tokens into its decode

    jcache = jm.init_cache(jc, je)
    jctl = jax.tree.map(jnp.asarray, jm.init_ctl(je, S, Wcap))
    jpre = jm.make_packed_prefill_fn(jc, je, T, W)
    jwin, jdelta = jm.make_autopilot_fns(jc, je, K, Wcap)
    tcache = tm.init_cache(tc, te, torch.device("cpu"))
    tctl = tm.init_ctl(te, S, Wcap, torch.device("cpu"))
    tpre = tm.raw_packed_prefill_fn(tc, te, T, W)
    twin = tm.raw_autopilot_window_fn(tc, te, K)
    tdelta = tm.raw_ctl_delta_fn(Wcap)

    first = []
    for slot, (prompt, table) in enumerate(zip(prompts, tables)):
        pint = np.zeros((1, T + W + tm.PP_SCALARS), np.int32)
        pint[0, :len(prompt)] = prompt
        pint[0, T:T + len(table)] = table
        pint[0, T + W:] = (len(prompt), 0, slot, 1, 0, -1, 0,
                           int(tm.PP_QUANT))
        jcache, jlt, js = jpre(jparams, jcache, jctl["last_tok"],
                               jnp.asarray(pint), jax.random.PRNGKey(slot))
        jctl = {**jctl, "last_tok": jlt}
        tcache, _, ts = tpre(tparams, tcache, tctl["last_tok"],
                             torch.from_numpy(pint), torch.tensor(slot),
                             False)
        assert int(ts[0]) == int(np.asarray(js)[0])
        first.append(int(ts[0]))
    np.testing.assert_array_equal(tctl["last_tok"].numpy(),
                                  np.asarray(jctl["last_tok"]))

    di = np.zeros((2, tm.CTL_I32_FIELDS + Wcap), np.int32)
    df = np.zeros((2, 2), np.float32)
    for slot in range(2):
        di[slot, :6] = (slot, len(prompts[slot]), vus[slot], 0, -1, -1)
        di[slot, 6:6 + len(tables[slot])] = tables[slot]
        df[slot] = (0.0, 1.0)
    jctl = jdelta(jctl, jnp.asarray(di), jnp.asarray(df))
    tdelta(tctl, torch.from_numpy(di), torch.from_numpy(df))
    rows = np.array([0, 1, S, S], np.int32)   # bucket 4, trash padding
    streams = {0: [first[0]], 1: [first[1]]}
    for _ in range(3):
        acc = np.clip(np.asarray(jctl["vu"])[:2]
                      - np.asarray(jctl["pos"])[:2], 0, K)
        jcache, jctl, jsamp = jwin(jparams, jcache, jctl, jnp.asarray(rows))
        tcache, tctl, tsamp = twin(tparams, tcache, tctl,
                                   torch.from_numpy(rows), False)
        jsamp, tsamp = np.asarray(jsamp), tsamp.numpy()
        for slot in range(2):
            np.testing.assert_array_equal(tsamp[:acc[slot], slot],
                                          jsamp[:acc[slot], slot])
            streams[slot].extend(tsamp[:acc[slot], slot].tolist())
        for key in ("pos", "last_tok"):
            np.testing.assert_array_equal(tctl[key].numpy()[:S],
                                          np.asarray(jctl[key])[:S])
    # seat 0 decoded 3 full windows; seat 1 stopped at its capacity
    assert len(streams[0]) == 1 + 3 * K
    assert len(streams[1]) == 1 + (vus[1] - len(prompts[1]))
