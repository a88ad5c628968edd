"""The port's sharding layout (``dynamo_tpu_torch.parallel.layout``) held
against the JAX package's ``SpecLayout``: the same spec per leaf for every
model the repo names (tiny, tiny_moe, Llama-3.2-1B, Mixtral-8x7B,
Llama-3-70B) with bf16 and int8 weights, and each rank's slice the very
index range of the JAX addressable shard on ``make_mesh((1, tp))`` over the
suite's 8 CPU devices, tp 2, 4 and 8. The full-size trees are built on
torch's ``meta`` device and the JAX side only asks its shardings for index
maps, so nothing of the big models is allocated."""

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.parallel.layout import SpecLayout as JaxSpecLayout
from dynamo_tpu.parallel.layout import make_mesh as jax_make_mesh
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine.weights import _scale_shape, _stacked_shapes
from dynamo_tpu_torch.parallel import layout
from dynamo_tpu_torch.parallel.layout import Mesh, SpecLayout

MODELS = ["tiny", "tiny_moe", "llama3_1b", "mixtral_8x7b", "llama3_70b"]
TPS = [2, 4, 8]


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list spec or param tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", [1] + TPS)
@pytest.mark.parametrize("model", MODELS)
def test_spec_table_equals_jax(cpu_devices, model, tp, weight_dtype):
    jmesh = jax_make_mesh((1, tp), cpu_devices)
    jlay = JaxSpecLayout.for_mesh(jmesh)
    lay = SpecLayout.for_mesh((1, tp))
    assert (lay.dp, lay.fsdp, lay.tp, lay.ep) == (
        jlay.dp, jlay.fsdp, jlay.tp, jlay.ep)
    jc = getattr(jcfg.ModelConfig, model)()
    tc = getattr(tcfg.ModelConfig, model)()
    want = _flat(jax.tree.map(tuple, jlay.param_specs(jc, weight_dtype),
                              is_leaf=_is_spec))
    got = _flat(lay.param_specs(tc, weight_dtype))
    assert got == want
    want_cache = _flat(jax.tree.map(tuple, jlay.cache_specs(jc, "int8"),
                                    is_leaf=_is_spec))
    assert _flat(lay.cache_specs(tc, "int8")) == want_cache
    assert lay.logits() == tuple(jlay.logits())
    assert lay.hidden() == tuple(jlay.hidden())


def _meta_tree(cfg, weight_dtype):
    """The full stacked tree of ``cfg`` on the meta device (quantized
    leaves as ``{"q", "s"}``)."""
    from dynamo_tpu_torch.engine import quant

    def leaf(name, shape):
        if quant.is_quantized(weight_dtype) and quant.is_weight_leaf(name):
            return {"q": torch.empty(shape, device="meta", dtype=torch.int8),
                    "s": torch.empty(_scale_shape(shape), device="meta")}
        return torch.empty(shape, device="meta", dtype=torch.bfloat16)

    V, D = cfg.vocab_size, cfg.hidden_size
    tree = {"embed": leaf("embed", (V, D)),
            "layers": {k: leaf(k, s)
                       for k, s in _stacked_shapes(cfg).items()},
            "final_norm": leaf("final_norm", (D,))}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = leaf("lm_head", (D, V))
    return tree


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("model", MODELS)
def test_rank_slices_are_the_jax_shards(cpu_devices, model, tp,
                                        weight_dtype):
    """Every rank's index range of every leaf (and of a cache layer) is the
    JAX addressable shard's on device ``rank`` of mesh (1, tp)."""
    jmesh = jax_make_mesh((1, tp), cpu_devices)
    tc = getattr(tcfg.ModelConfig, model)()
    jc = getattr(jcfg.ModelConfig, model)()
    full = _meta_tree(tc, weight_dtype)
    specs = _flat(SpecLayout.for_mesh((1, tp)).param_specs(tc, weight_dtype))
    jshard = _flat(JaxSpecLayout.for_mesh(jmesh).param_shardings(
        jmesh, jc, weight_dtype))
    leaves = _flat(full)
    eng = tcfg.EngineConfig(mesh_shape=(1, tp), weight_dtype=weight_dtype)
    for rank in range(tp):
        mesh = Mesh({"dp": 1, "tp": tp}, {"dp": 0, "tp": rank})
        dev = cpu_devices[rank]
        for path, t in leaves.items():
            idx = jshard[path].addressable_devices_indices_map(
                tuple(t.shape))[dev]
            want = [(s.start or 0, n if s.stop is None else s.stop)
                    for s, n in zip(idx, t.shape)]
            got = [layout.shard_range(n, ax, mesh)
                   for n, ax in zip(t.shape, specs[path])]
            assert got == want, (path, rank)
            assert tuple(layout.shard_tensor(t, specs[path], mesh).shape) \
                == tuple(b - a for a, b in want)
        cshape = (16, tc.num_kv_heads, 16, tc.head_dim_)
        cidx = jax.sharding.NamedSharding(
            jmesh, JaxSpecLayout.for_mesh(jmesh).cache_block()
        ).addressable_devices_indices_map(cshape)[dev]
        assert layout.shard_range(cshape[1], "tp", mesh) == (
            cidx[1].start, cidx[1].stop)
    # the engine's shard_params keeps exactly these slices
    kv_local = tm.init_cache(tc, tcfg.EngineConfig(
        num_blocks=2, mesh_shape=(1, tp)), torch.device("meta"))["k"][0]
    assert kv_local.shape[1] == tc.num_kv_heads // tp
    assert tm.tp_size(eng) == tp


def _rank_bytes(cfg, tp, weight_dtype="bf16"):
    specs = _flat(SpecLayout.for_mesh((1, tp)).param_specs(cfg, weight_dtype))
    mesh = Mesh({"dp": 1, "tp": tp}, {"dp": 0, "tp": 0})
    total = 0
    for path, t in _flat(_meta_tree(cfg, weight_dtype)).items():
        n = int(np.prod(layout.shard_shape(t.shape, specs[path], mesh)))
        total += n * t.element_size()
    return total


def test_llama3_70b_bytes_per_rank_at_tp8():
    """Llama-3-70B in bf16 at tp 8: 17,640,734,720 bytes (16.43 GiB) of
    weights per rank — replicated norms plus 1/8 of everything else — of
    141,107,412,992 in all; with int8 weights 8,961,030,784 bytes (the
    embedding stays bf16, the scales f32)."""
    cfg = tcfg.ModelConfig.llama3_70b()
    assert _rank_bytes(cfg, 1) == 141_107_412_992
    assert _rank_bytes(cfg, 8) == 17_640_734_720
    assert _rank_bytes(cfg, 8, "int8") == 8_961_030_784


@pytest.mark.parametrize("shape,match", [
    ((2, 1, 4, 1), "dp, fsdp, tp"), ((4,), "dp, fsdp, tp"),
])
def test_unserved_meshes_are_refused_by_name(shape, match):
    """A mesh of other than 2 or 3 axes is refused with the JAX
    ``make_mesh``'s message (the 3-D ``(dp, fsdp, tp)`` mesh is served:
    ``test_sequence_axes_equal_jax`` and ``tests/test_torch_fsdp.py``);
    a dim an axis does not split evenly is refused by name."""
    with pytest.raises(ValueError, match=match):
        SpecLayout.for_mesh(shape)
    with pytest.raises(ValueError, match=match):
        layout.check_mesh_shape(shape)
    mesh = Mesh({"dp": 1, "fsdp": 3, "tp": 1}, {"dp": 0, "fsdp": 1, "tp": 0})
    with pytest.raises(NotImplementedError, match="item 6.8"):
        layout.shard_range(64, "fsdp", mesh)


DP_TP = [(1, 1), (2, 1), (1, 2), (2, 2), (2, 4), (8, 1), (4, 2),
         (1, 2, 1), (1, 2, 2), (2, 2, 1), (2, 2, 2), (1, 4, 2)]


@pytest.mark.parametrize("shape", DP_TP, ids=lambda s: "x".join(map(str, s)))
def test_sequence_axes_equal_jax(cpu_devices, shape):
    """``seq_axes``, ``hidden_seq`` and ``heads_seq`` (the composite
    sequence axis of an sp prefill, mesh-major) and the dp/fsdp/tp/ep
    fields are the JAX layout's on every served (dp, tp) and (dp, fsdp,
    tp) mesh; the parameter specs ignore dp (replicated), as JAX's do."""
    jlay = JaxSpecLayout.for_mesh(jax_make_mesh(shape, cpu_devices))
    lay = SpecLayout.for_mesh(shape)
    assert (lay.dp, lay.fsdp, lay.tp, lay.ep) == (
        jlay.dp, jlay.fsdp, jlay.tp, jlay.ep)
    assert lay.seq_axes() == jlay.seq_axes()
    assert lay.hidden_seq() == tuple(jlay.hidden_seq())
    assert lay.heads_seq() == tuple(jlay.heads_seq())
    tc, jc = tcfg.ModelConfig.tiny(), jcfg.ModelConfig.tiny()
    assert _flat(lay.param_specs(tc)) == _flat(jax.tree.map(
        tuple, jlay.param_specs(jc), is_leaf=_is_spec))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 2, 2), (2, 2, 1)],
                         ids=["2x2", "4x1", "1x2x2", "2x2x1"])
def test_make_mesh_coordinates_and_groups(shape):
    """``make_mesh`` in a world of 4: rank r sits at (d, f, t) with r = (d
    * fsdp + f) * tp + t, the device JAX's ``make_mesh`` puts at that
    coordinate; its tp row, dp column, fsdp group, seq column (equal tp
    index, in rank order) and world are the groups the collectives
    take."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_tp_world as tw

    dp, fs, tp = layout.check_mesh_shape(shape)
    jmesh = jax_make_mesh(shape, jax.devices("cpu"))
    with tw.World(4) as world:
        got = world.run(tw.collectives, dp, tp,
                        fs if len(shape) == 3 else None)
    for r, g in enumerate(got):
        d, f, t = (g["coords"].get(a, 0) for a in ("dp", "fsdp", "tp"))
        at = (d, f, t) if len(shape) == 3 else (d, t)
        assert jmesh.devices[at].id == jax.devices("cpu")[r].id
        assert g["tp_ranks"] == [(d * fs + f) * tp + j for j in range(tp)]
        assert g["dp_ranks"] == [(e * fs + f) * tp + t for e in range(dp)]
        assert g["fsdp_ranks"] == [(d * fs + e) * tp + t for e in range(fs)]
        assert g["seq_ranks"] == [q for q in range(4) if q % tp == t]
        for group in ("tp", "dp", "fsdp", "seq"):
            assert g[f"sum_{group}"] == sum(g[f"{group}_ranks"])


def test_indivisible_counts_are_refused_by_name():
    cfg = tcfg.ModelConfig.tiny()
    layout.check_divisible(cfg, 8)
    with pytest.raises(NotImplementedError, match="num_kv_heads=8"):
        layout.check_divisible(tcfg.ModelConfig.llama3_1b(), 16)
    with pytest.raises(NotImplementedError, match="num_experts=8"):
        layout.check_divisible(
            tcfg.ModelConfig(num_experts=8, num_experts_per_token=2,
                             num_heads=32, num_kv_heads=16,
                             vocab_size=32000), 16)
    # the fsdp axis splits the model dim (item 6.8 names the refusal)
    layout.check_divisible(cfg, 8, 4)
    with pytest.raises(NotImplementedError,
                       match="hidden_size=64 is not divisible by fsdp=3"):
        layout.check_divisible(cfg, 1, 3)
