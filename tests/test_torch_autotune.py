"""The port's attention autotune against the JAX package's.

On the CPU both packages resolve ``attention_impl`` and the per-class tiles
alike (einsum for "auto" without probing, the defaults without a sweep,
cache hits adopted, explicit tiles first); ``class_shapes`` and the sweep
case's draws are the JAX package's. The cache round-trips, ignores
corruption and version drift, and its key moves with the card, the KV
dtype, the torch version and the kernel source. The candidates stay inside
the kernel's limits. The winner selection runs through the plain version
with a stand-in timer: a mis-masking candidate fails the gate on the
NaN-poisoned case, and a launch that raises makes ``autotune_attention``
raise instead of choosing einsum or the defaults.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import autotune as jtune
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.engine import autotune as tune
from dynamo_tpu_torch.engine import model as model_lib
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.ops import paged_attention as pa

# the JAX test module's engine shape (tests/test_autotune_sweep.py)
ENG_KW = dict(block_size=16, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=256, max_model_len=256,
              decode_buckets=(8,), prefill_buckets=(16, 32),
              spec_mode="ngram", spec_k=3)
# the JAX package's attention names
JAX_NAMES = {"kernel": "pallas", "einsum": "einsum", "auto": "auto",
             "": ""}
# a bf16 model at small widths whose heads the CUDA kernel takes (hd 64,
# 4 query heads per KV head, as Llama-3.2-1B)
SMALL_BF16 = ModelConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_layers=2, num_heads=4,
                         num_kv_heads=1, head_dim=64, max_position=512,
                         dtype="bfloat16")


def _cfgs(**over):
    kw = dict(ENG_KW, **over)
    jkw = dict(kw)
    if "attention_impl" in jkw:
        jkw["attention_impl"] = JAX_NAMES[jkw["attention_impl"]]
    return ((ModelConfig.tiny(), EngineConfig(**kw)),
            (JaxModelConfig.tiny(), JaxEngineConfig(**jkw)))


@pytest.fixture(autouse=True)
def one_thread():
    """The plain version at these sizes is a few small ops per call: one
    intra-op thread runs them fastest, and keeps the sweep tests from
    starving the suite's other workers of CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_cache(monkeypatch):
    monkeypatch.delenv(tune.CACHE_ENV, raising=False)


@pytest.mark.parametrize("spec", ["ngram", "off"])
@pytest.mark.parametrize("impl", ["auto", "kernel", "einsum"])
def test_autotune_resolves_like_jax_on_the_cpu(impl, spec, no_cache):
    (mc, ec), (jmc, jec) = _cfgs(attention_impl=impl, spec_mode=spec)
    cfg, choice = tune.autotune_attention(mc, ec, "cpu")
    jcfg, jchoice = jtune.autotune_attention(jmc, jec)
    for cls in tune.CLASSES:
        assert JAX_NAMES[getattr(cfg, f"attention_impl_{cls}")] == \
            getattr(jcfg, f"attention_impl_{cls}")
        assert getattr(cfg, f"attention_tile_{cls}") == \
            getattr(jcfg, f"attention_tile_{cls}")
    assert JAX_NAMES[cfg.attention_impl] == jcfg.attention_impl
    assert choice["tiles"] == jchoice["tiles"]
    for key in ("probed", "autotune_cache_hit", "cache_path"):
        assert choice.get(key) == jchoice.get(key)
    assert choice["sweep_launches"] == choice["probe_launches"] == 0
    if impl == "auto":
        # unresolved "auto" is einsum in both, and resolved "auto" too
        assert {model_lib.resolve_attention_impl(cfg, c)
                for c in tune.CLASSES} == {"einsum"}
        assert model_lib.resolve_attention_impl(ec, "decode") == "einsum"


@pytest.mark.parametrize("over", [
    {}, {"spec_mode": "off", "spec_k": 0}, {"decode_buckets": (8, 32, 64),
                                            "max_num_seqs": 32},
    {"prefill_buckets": (16, 64, 512), "spec_k": 5},
], ids=["spec", "no-spec", "decode-64", "prefill-512"])
def test_class_shapes_equal_jax(over):
    (mc, ec), (jmc, jec) = _cfgs(**over)
    assert tune.class_shapes(mc, ec) == jtune.class_shapes(jmc, jec)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("cls", ["decode", "spec", "prefill"])
def test_sweep_case_draws_as_jax(cls, kv):
    """Same rows, tables, queries and pages as the JAX package's case (the
    decode case's table padded with trash to the decode table width), the
    same NaN-poisoned slots; int8 pages and scales bitwise."""
    (mc, ec), (jmc, jec) = _cfgs(kv_dtype=kv)
    B, T = tune.class_shapes(mc, ec)[cls]
    case = tune.make_sweep_case(mc, ec, cls, B, T)
    jcase = jtune.make_sweep_case(jmc, jec, cls, B, T)
    q, kc, vc, tables, q_start, q_len, ctx_len = jcase["args"]
    W = tables.shape[1]
    assert case["tables"].shape[1] == (ec.max_blocks_per_seq
                                       if cls == "decode" else W)
    assert np.array_equal(case["tables"][:, :W].numpy(), tables)
    assert not case["tables"][:, W:].any()
    for name, want in (("q_start", q_start), ("q_len", q_len),
                       ("ctx_len", ctx_len)):
        assert np.array_equal(case[name].numpy(), want)
    assert np.array_equal(case["q"].numpy(), q)
    for mine, want, scale, jscale in (
            (case["k_cache"], kc, case["k_scale"], jcase["k_scale"]),
            (case["v_cache"], vc, case["v_scale"], jcase["v_scale"])):
        assert np.array_equal(mine.numpy(), np.asarray(want),
                              equal_nan=kv == "bf16")
        if kv == "int8":
            assert np.array_equal(scale.numpy(), jscale, equal_nan=True)


def test_cache_roundtrip_and_corruption(tmp_path):
    path = str(tmp_path / "tune.json")
    entry = {"device_kind": "NVIDIA H100 80GB HBM3",
             "tiles": {"decode": [0, 4], "prefill": [8, 128]}}
    assert tune.store_cache_entry(path, "k1", entry)
    assert tune.load_cache_entry(path, "k1")["tiles"]["decode"] == [0, 4]
    assert tune.load_cache_entry(path, "other-key") is None
    assert tune.store_cache_entry(path, "k2", {"tiles": {}})
    assert tune.load_cache_entry(path, "k1") is not None
    # the JAX package reads the port's file, and the port the JAX one's
    assert jtune.load_cache_entry(path, "k1") == \
        tune.load_cache_entry(path, "k1")
    doc = json.load(open(path))
    doc["version"] = tune.CACHE_VERSION + 1
    json.dump(doc, open(path, "w"))
    assert tune.load_cache_entry(path, "k1") is None
    for bad in ("{not json", "[1, 2]", '{"version": 1, "entries": []}'):
        open(path, "w").write(bad)
        assert tune.load_cache_entry(path, "k1") is None
    assert tune.load_cache_entry(str(tmp_path / "absent.json"), "k1") is None
    # a corrupt file is replaced by a good one on the next store
    assert tune.store_cache_entry(path, "k3", {"tiles": {}})
    assert tune.load_cache_entry(path, "k3") == {"tiles": {}}


def test_config_hash_moves_with_what_the_sweep_measured():
    (mc, ec), _ = _cfgs()
    card = "NVIDIA H100 80GB HBM3"
    base = tune.config_hash(mc, ec, card)
    assert base == tune.config_hash(mc, ec, card)  # deterministic
    drifted = [
        tune.config_hash(mc, ec, "NVIDIA H200"),
        tune.config_hash(mc, dataclasses.replace(ec, kv_dtype="int8"), card),
        tune.config_hash(mc, dataclasses.replace(ec, kv_dtype="fp8"), card),
        tune.config_hash(mc, ec, card, torch_version="0.0.0"),
        tune.config_hash(mc, ec, card, kernel="0" * 16),
        tune.config_hash(mc, dataclasses.replace(ec, block_size=32), card),
        tune.config_hash(mc, dataclasses.replace(ec, decode_buckets=(8, 16)),
                         card),
        tune.config_hash(mc, dataclasses.replace(ec, spec_k=5), card),
        tune.config_hash(dataclasses.replace(mc, num_layers=3), ec, card),
    ]
    assert len({base, *drifted}) == len(drifted) + 1
    # the kernel's digest is its source's
    assert tune.config_hash(mc, ec, card) == tune.config_hash(
        mc, ec, card, torch_version=torch.__version__,
        kernel=tune.kernel_digest())


def test_autotune_cache_precedence(tmp_path, monkeypatch):
    """Explicit tiles > cache hit > defaults, in both packages, from one
    cache file per package."""
    (mc, ec), (jmc, jec) = _cfgs(attention_impl="einsum")
    # each package's tiles in its own terms: the port's second element is a
    # kv_chunk of 64, the JAX package's a kv_tile dividing block_size
    for side, fn, m, e, kv in (
            ("port", tune.autotune_attention, mc, ec, 64),
            ("jax", jtune.autotune_attention, jmc, jec, 8)):
        path = str(tmp_path / f"{side}.json")
        monkeypatch.setenv("DYNTPU_AUTOTUNE_CACHE", path)
        args = (m, e, "cpu") if side == "port" else (m, e)
        cfg, choice = fn(*args)
        assert choice["autotune_cache_hit"] is False
        assert cfg.attention_tile_decode == (0, 0)
        tune.store_cache_entry(path, choice["config_hash"], {
            "device_kind": "cpu",
            "tiles": {"decode": [0, 8], "spec": [1, kv], "prefill": [8, kv]},
        })
        cfg2, choice2 = fn(*args)
        assert choice2["autotune_cache_hit"] is True
        assert (cfg2.attention_tile_decode, cfg2.attention_tile_spec,
                cfg2.attention_tile_prefill) == ((0, 8), (1, kv), (8, kv))
        e3 = dataclasses.replace(e, attention_tile_prefill=(16, 0))
        cfg3, choice3 = fn(*((m, e3, "cpu") if side == "port" else (m, e3)))
        assert choice3["autotune_cache_hit"] is True
        assert cfg3.attention_tile_prefill == (16, 0)
        assert cfg3.attention_tile_decode == (0, 8)


def test_config_checks_what_the_kernel_takes():
    EngineConfig(attention_tile_prefill=(8, 128), attention_tile_spec=(1, 64),
                 attention_tile_decode=(0, 16), attention_impl="auto")
    for bad in (dict(attention_tile_prefill=(8, 96)),
                dict(attention_tile_spec=(-1, 0)),
                dict(attention_tile_decode=(1, 4)),
                dict(attention_tile_decode=(0, 4, 1)),
                dict(attention_impl_decode="auto"),
                dict(ladder_compile_budget=-1)):
        with pytest.raises(ValueError):
            EngineConfig(**bad)


@pytest.mark.parametrize("model,kv", [
    ("1b", "bf16"), ("1b", "int8"), ("1b", "fp8"), ("small", "bf16"),
    ("tiny", "bf16")])
def test_candidates_stay_inside_the_kernel_limits(model, kv):
    mc = {"1b": ModelConfig.llama3_1b(), "small": SMALL_BF16,
          "tiny": ModelConfig.tiny()}[model]
    ec = EngineConfig(spec_mode="ngram", kv_dtype=kv)
    G = mc.num_heads // mc.num_kv_heads
    quantized = kv != "bf16"
    for cls, (B, T) in tune.class_shapes(mc, ec).items():
        cands = tune.tile_candidates(mc, ec, cls, T)
        assert cands[0] == (0, 0) and len(set(cands)) == len(cands)
        for q_tile, second in cands:
            if cls == "decode":
                assert q_tile == 0
                pa.check_n_split(second, ec.max_blocks_per_seq,
                                 ec.block_size)
                continue
            assert q_tile == 0 or T % q_tile == 0
            pa.ragged_tile(q_tile, second, G=G, max_q_len=T,
                           hd=mc.head_dim_, q_dtype=model_lib.torch_dtype(mc),
                           quantized=quantized)
    if model == "1b":
        dec = tune.tile_candidates(mc, ec, "decode", 1)
        # 8,192 positions in spans of 64: n_split 1, 2, 4, ..., 128
        assert [s for _, s in dec] == [0, 1, 2, 4, 8, 16, 32, 64, 128]
        pre = tune.tile_candidates(mc, ec, "prefill", 256)
        other = 64 if quantized else 128
        assert pre == [(q, c) for q in (0, 1, 2, 4, 8) for c in (0, other)]
        spec = tune.tile_candidates(mc, ec, "spec", 5)
        assert spec == [(q, c) for q in (0, 1) for c in (0, other)]


@pytest.mark.parametrize("bad", [
    dict(q_tile=17), dict(kv_chunk=96), dict(q_tile=-1)])
def test_ragged_wrapper_refuses_a_launch_it_cannot_take(bad):
    case = tune.make_sweep_case(SMALL_BF16, EngineConfig(), "prefill", 4, 16)
    with pytest.raises(ValueError, match=next(iter(bad))):
        pa.paged_attention_ragged(
            case["q"], case["k_cache"], case["v_cache"], case["tables"],
            case["q_start"], case["q_len"], case["ctx_len"], block_size=16,
            max_q_len=16, **bad)


def test_decode_wrapper_refuses_more_splits_than_spans():
    ec = EngineConfig(max_model_len=256)
    case = tune.make_sweep_case(SMALL_BF16, ec, "decode", 8, 1)
    args = (case["q"], case["k_cache"], case["v_cache"], case["tables"],
            case["ctx_len"])
    _, n_spans = pa.decode_spans(case["tables"].shape[1], 16)
    out = pa.paged_attention_decode(*args, block_size=16, n_split=n_spans)
    # the plain version does not split (CPU bf16 matmuls may sum in another
    # order from call to call, so not bitwise)
    torch.testing.assert_close(
        out, pa.paged_attention_decode(*args, block_size=16))
    with pytest.raises(ValueError, match="n_split"):
        pa.paged_attention_decode(*args, block_size=16, n_split=n_spans + 1)
    assert pa.ragged_smem_bytes(128, 128, False) <= pa.SMEM_OPTIN_SM90
    with pytest.raises(ValueError, match="shared memory"):
        pa.ragged_tile(0, 128, G=4, max_q_len=16, hd=128,
                       q_dtype=torch.bfloat16, quantized=False,
                       smem_optin=100_000)


def test_class_tile_is_advisory_as_jax_makes_it():
    ec = EngineConfig(max_model_len=256, attention_tile_prefill=(8, 128),
                      attention_tile_decode=(0, 4))
    assert model_lib.class_tile(ec, "prefill", 64, 4) == (8, 128)
    assert model_lib.class_tile(ec, "prefill", 12, 4) == (0, 128)
    # 4 splits need a table of >= 4 spans of 64 keys (16 blocks of 16)
    assert model_lib.class_tile(ec, "decode", 1, 16) == (0, 4)
    assert model_lib.class_tile(ec, "decode", 1, 8) == (0, 0)


class StandInTimer:
    """Device ms by candidate: the mis-masking candidate is the fastest,
    the default the slowest, and otherwise the smaller parameters the
    better."""

    def __init__(self, fastest):
        self.fastest = fastest
        self.calls = []

    def __call__(self, fn, tile=None, W=None):
        fn()
        self.calls.append((tuple(tile) if isinstance(tile, (list, tuple))
                           else tile, W))
        if tile == "kernel":
            return 1.0
        if tile == "einsum":
            return 2.0
        if tuple(tile) == self.fastest:
            return 0.001
        if tuple(tile) == (0, 0):
            return 2.0
        return 1.0 + tile[0] * 0.01 + tile[1] * 1e-4


def _mismask(fastest):
    """A runner whose ``fastest`` candidate reads one key past each row's
    context: the NaN-poisoned tails reach its output."""
    real = tune.run_candidate

    def run(case, tile, plain=False):
        if tuple(tile) != fastest or plain:
            return real(case, tile, plain)
        wide = dict(case, ctx_len=case["ctx_len"] + (case["ctx_len"] > 0))
        return real(wide, (0, 0), plain=True)
    return run


# small grids: the CPU runs every candidate through the plain version
SMALL_ENG = dict(max_model_len=256, max_num_seqs=8, decode_buckets=(8,),
                 prefill_buckets=(16, 32), spec_mode="ngram")


def test_sweep_gate_and_winner_through_the_plain_version(monkeypatch):
    ec = EngineConfig(**SMALL_ENG)
    fastest = (2, 0)
    timer = StandInTimer(fastest)
    monkeypatch.setattr(tune, "_time_device", timer)
    monkeypatch.setattr(tune, "run_candidate", _mismask(fastest))
    res = tune.sweep_class(SMALL_BF16, ec, "prefill", 4, 16,
                           torch.device("cpu"))
    by_tile = {tuple(c["tile"]): c for c in res["candidates"]}
    assert list(by_tile) == tune.tile_candidates(SMALL_BF16, ec,
                                                 "prefill", 16)
    bad = by_tile[fastest]
    assert not bad["eligible"] and "not finite" in bad["reason"]
    assert all(c["eligible"] for t, c in by_tile.items() if t != fastest)
    # the fastest eligible: q_tile 1 at the default chunk
    assert res["winner"] == [1, 0]
    assert res["widths"] == [8, 16]
    # every eligible candidate timed at both widths
    assert len(timer.calls) == 2 * (len(by_tile) - 1)
    assert max(e for c in by_tile.values() if c["eligible"]
               for e in c["max_err"].values()) <= res["tol"]


@pytest.fixture
def on_card(monkeypatch, tmp_path):
    """Run the card's path on CPU tensors: the sweep and the probe see a
    card, the wrappers run their plain versions, a stand-in timer."""
    monkeypatch.setattr(tune, "_on_card", lambda device: True)
    timer = StandInTimer(None)
    monkeypatch.setattr(tune, "_time_device", timer)
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "tune.json"))
    return timer


def test_sweep_winners_are_cached_and_the_second_build_sweeps_nothing(
        on_card):
    ec = EngineConfig(attention_impl="auto", **SMALL_ENG)
    cfg, choice = tune.autotune_attention(SMALL_BF16, ec, "cpu")
    assert choice["probed"] and not choice["autotune_cache_hit"]
    assert {model_lib.resolve_attention_impl(cfg, c)
            for c in tune.CLASSES} == {"kernel"}
    assert set(choice["sweep"]) == {"decode", "spec", "prefill"}
    assert choice["tiles"]["prefill"] == [1, 0]
    assert choice["tiles"]["decode"] == [0, 1]   # the stand-in's cheapest
    n_timed = len(on_card.calls)
    cfg2, choice2 = tune.autotune_attention(SMALL_BF16, ec, "cpu")
    assert choice2["autotune_cache_hit"] and choice2["tiles"] == \
        choice["tiles"]
    # the probe runs again, the sweep does not
    assert len(on_card.calls) - n_timed == 2 * len(tune.class_shapes(
        SMALL_BF16, ec))
    assert cfg2.attention_tile_prefill == cfg.attention_tile_prefill
    # an engine that names its impl is not swept
    ec_k = dataclasses.replace(ec, attention_impl="kernel", spec_k=5)
    _, choice3 = tune.autotune_attention(SMALL_BF16, ec_k, "cpu")
    assert "sweep" not in choice3 and choice3["tiles"]["prefill"] == [0, 0]


@pytest.mark.parametrize("where", ["probe", "sweep"])
def test_a_launch_that_raises_makes_autotune_raise(on_card, monkeypatch,
                                                   where):
    ec = EngineConfig(attention_impl="auto", **SMALL_ENG)
    if where == "probe":
        def broken(*args, **kwargs):
            raise RuntimeError("paged attention kernel (decode) launch "
                               "failed: cudaError 1")
        monkeypatch.setattr(pa, "paged_attention_decode", broken)
    else:
        real = tune.run_candidate

        def run(case, tile, plain=False):
            if tuple(tile) == (4, 128):
                raise RuntimeError("paged attention kernel (ragged) launch "
                                   "failed: cudaError 1")
            return real(case, tile, plain)
        monkeypatch.setattr(tune, "run_candidate", run)
    with pytest.raises(RuntimeError, match="launch failed"):
        tune.autotune_attention(SMALL_BF16, ec, "cpu")
