"""The port's checkpoint loader (``dynamo_tpu_torch/engine/weights.py`` on
its own safetensors reader) held against the JAX package's on the CPU:

* ``load_hf_params`` equals ``dynamo_tpu.engine.weights.load_hf_params``
  leaf for leaf and bit for bit on ``tiny``, a bf16 ``tiny`` and
  ``tiny_moe``, at bf16, int8 and fp8, from checkpoints written by the
  ``safetensors`` package (f32 and bf16 files) and by the port's writer in
  two shards;
* a tied ``lm_head`` in the file is skipped, a directory with no
  ``*.safetensors`` raises ``FileNotFoundError`` in both packages;
* ``model_config_from_hf`` equals JAX's on a dense and a Mixtral-style
  ``config.json``;
* ``python -m dynamo_tpu_torch.run ... --weights DIR`` and the worker pick
  up ``config.json`` and the tokenizer from the directory, serve the loaded
  weights, and import neither ``safetensors`` nor ``ml_dtypes``.
"""

import asyncio
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as lib_save

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.engine import weights as jw
from dynamo_tpu_torch import worker as tworker
from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine, Request
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine import weights as tw
from dynamo_tpu_torch.engine.weights import params_from_numpy
from test_torch_frontend_http import tiny_tokenizer

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = {  # name: (JAX config, port config)
    "tiny": (jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()),
    "tiny-bf16": (dataclasses.replace(jcfg.ModelConfig.tiny(),
                                      dtype="bfloat16"),
                  dataclasses.replace(tcfg.ModelConfig.tiny(),
                                      dtype="bfloat16")),
    "tiny_moe": (jcfg.ModelConfig.tiny_moe(), tcfg.ModelConfig.tiny_moe()),
}


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def assert_trees_equal_bitwise(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal_bitwise(got[k], want[k], f"{path}/{k}")
        return
    assert tuple(got.shape) == tuple(want.shape), path
    size = (want.element_size() if isinstance(want, torch.Tensor)
            else np.asarray(want).dtype.itemsize)
    assert got.element_size() == size, path
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=path)


def write_with_library(path, cfg, params, tied_head=None, n_shards=1,
                       extra=None):
    """The JAX tree written in HF layout by the ``safetensors`` package
    (the JAX tests' oracle layout), in ``n_shards`` files; ``extra``
    tensors go into the last one."""
    def c(x):
        return np.ascontiguousarray(np.asarray(x))
    lay = params["layers"]
    tensors = {"model.embed_tokens.weight": c(params["embed"]),
               "model.norm.weight": c(params["final_norm"]),
               # ignored by both loaders
               "model.layers.0.self_attn.rotary_emb.inv_freq":
                   np.ones(4, np.float32)}
    if not cfg.tie_word_embeddings:
        tensors["lm_head.weight"] = c(np.asarray(params["lm_head"]).T)
    elif tied_head is not None:
        tensors["lm_head.weight"] = tied_head
    names = {"attn_norm": "input_layernorm", "wq": "self_attn.q_proj",
             "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj",
             "mlp_norm": "post_attention_layernorm",
             "w_router": "block_sparse_moe.gate"}
    names.update({} if cfg.is_moe else {
        "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
        "w_down": "mlp.down_proj"})
    experts = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}
    for i in range(cfg.num_layers):
        for leaf, w in lay.items():
            w = np.asarray(w[i])
            if cfg.is_moe and leaf in experts:
                for e in range(cfg.num_experts):
                    tensors[f"model.layers.{i}.block_sparse_moe.experts.{e}."
                            f"{experts[leaf]}.weight"] = c(w[e].T)
            else:
                tensors[f"model.layers.{i}.{names[leaf]}.weight"] = c(
                    w if w.ndim == 1 else w.T)
    if n_shards == 1 and not extra:
        lib_save(tensors, str(Path(path) / "model.safetensors"))
        return
    names = sorted(tensors)
    for k in range(n_shards):
        shard = {n: tensors[n] for n in names[k::n_shards]}
        if k == n_shards - 1:
            shard.update(extra or {})
        lib_save(shard, str(Path(path) / f"model-{k + 1:05d}-of-"
                                         f"{n_shards:05d}.safetensors"))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def checkpoint(request, tmp_path_factory):
    name = request.param
    jc, tc = CONFIGS[name]
    path = tmp_path_factory.mktemp(name)
    write_with_library(path, jc, jm.init_params(jax.random.PRNGKey(0), jc))
    return name, jc, tc, path


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8", "fp8"])
def test_load_hf_params_equals_jax_bitwise(checkpoint, weight_dtype):
    _, jc, tc, path = checkpoint
    want = jw.load_hf_params(str(path), jc, weight_dtype)
    got = tw.load_hf_params(path, tc, weight_dtype, device="cpu")
    assert_trees_equal_bitwise(got, want)
    st = tw.last_load_stats
    assert st["n_files"] == 1 and st["bytes"] > 0 and st["gb_s"] > 0
    L, E = jc.num_layers, jc.num_experts
    per_layer = 7 + 3 * E if jc.is_moe else 9
    assert st["n_tensors"] == 2 + L * per_layer + (
        0 if jc.tie_word_embeddings else 1)


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
def test_port_writer_two_shards_load_in_both(tmp_path, checkpoint,
                                             weight_dtype):
    """The port's ``save_hf_params`` (two shards + config.json) read by
    both loaders: the same bits, and the bf16 load equals the source."""
    _, jc, tc, _ = checkpoint
    src = tw.load_hf_params(checkpoint[3], tc, device="cpu")
    tw.save_hf_params(tmp_path, src, tc, n_shards=2)
    assert len(sorted(tmp_path.glob("*.safetensors"))) == 2
    got = tw.load_hf_params(tmp_path, tc, weight_dtype, device="cpu")
    assert_trees_equal_bitwise(
        got, jw.load_hf_params(str(tmp_path), jc, weight_dtype))
    if weight_dtype == "bf16":
        assert_trees_equal_bitwise(got, src)


def test_tied_lm_head_is_skipped(tmp_path):
    jc, tc = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    jc = dataclasses.replace(jc, tie_word_embeddings=True)
    tc = dataclasses.replace(tc, tie_word_embeddings=True)
    params = jm.init_params(jax.random.PRNGKey(1), jc)
    write_with_library(tmp_path, jc, params,
                       tied_head=np.full((jc.vocab_size, jc.hidden_size),
                                         7.0, np.float32))
    got = tw.load_hf_params(tmp_path, tc, device="cpu")
    assert "lm_head" not in got
    assert_trees_equal_bitwise(got, jw.load_hf_params(str(tmp_path), jc))


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.bool_,
                                   np.int32], ids=["I64", "F64", "BOOL",
                                                   "I32"])
def test_unread_tensor_of_another_dtype_loads_in_both(tmp_path, dtype):
    """A buffer the loaders skip may have any dtype the format defines:
    shard 2 of 2 carries one the port does not read, and both loaders
    load the same 21 tensors, bitwise."""
    jc, tc = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    params = jm.init_params(jax.random.PRNGKey(3), jc)
    name = "model.layers.0.self_attn.rotary_emb.extra_buffer"
    write_with_library(tmp_path, jc, params, n_shards=2,
                       extra={name: (np.arange(6) % 2).astype(dtype)})
    assert len(sorted(tmp_path.glob("*.safetensors"))) == 2
    got = tw.load_hf_params(tmp_path, tc, device="cpu")
    assert tw.last_load_stats["n_tensors"] == 21
    assert tw.last_load_stats["n_files"] == 2
    assert_trees_equal_bitwise(got, jw.load_hf_params(str(tmp_path), jc))
    # read, it still raises by name
    from dynamo_tpu_torch.engine.safetensors import SafeFile
    with SafeFile(sorted(tmp_path.glob("*.safetensors"))[-1]) as sf:
        assert name in sf.keys()
        with pytest.raises(ValueError, match="extra_buffer: dtype"):
            sf.get_tensor(name)
        with pytest.raises(ValueError, match="extra_buffer: dtype"):
            sf.nbytes(name)


def test_missing_checkpoint_raises_in_both(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        tw.load_hf_params(tmp_path, tcfg.ModelConfig.tiny(), device="cpu")
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        jw.load_hf_params(str(tmp_path), jcfg.ModelConfig.tiny())


HF_CONFIGS = {
    "llama": {"vocab_size": 512, "hidden_size": 64,
              "intermediate_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 8, "num_key_value_heads": 4,
              "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
              "max_position_embeddings": 512, "tie_word_embeddings": True,
              "rope_scaling": {"rope_type": "llama3", "factor": 32.0},
              "torch_dtype": "bfloat16"},
    "mixtral": {"vocab_size": 32000, "hidden_size": 4096,
                "intermediate_size": 14336, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "head_dim": 128, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
                "max_position_embeddings": 32768,
                "num_local_experts": 8, "num_experts_per_tok": 2},
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_model_config_from_hf_equals_jax(tmp_path, name):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS[name]))
    got = tw.model_config_from_hf(tmp_path)
    want = jw.model_config_from_hf(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_moe == want.is_moe == (name == "mixtral")
    # the port's own config.json reads back as the config that wrote it
    (tmp_path / "config.json").write_text(json.dumps(tw.hf_config(got)))
    assert tw.model_config_from_hf(tmp_path) == got


# ------------------------------ entry points --------------------------------


@pytest.fixture(scope="module")
def served_dir(tmp_path_factory):
    """A tiny checkpoint dir (port writer, config.json with 3 layers so it
    differs from --model tiny) with the 512-id tokenizer beside it."""
    path = tmp_path_factory.mktemp("served")
    tc = dataclasses.replace(tcfg.ModelConfig.tiny(), num_layers=3,
                             dtype="bfloat16")
    tw.save_hf_params(path, tm.init_params(
        torch.Generator().manual_seed(5), tc), tc, n_shards=2)
    (path / "tokenizer.json").write_text(tiny_tokenizer().to_str())
    return path, tc


async def _serve(engine, prompts, max_tokens):
    async def one(i, p):
        req = Request(request_id=f"r{i}", token_ids=p, max_tokens=max_tokens)
        return [o.token_id async for o in engine.submit(req)]
    try:
        return await asyncio.gather(*(one(i, p) for i, p in
                                      enumerate(prompts)))
    finally:
        await engine.stop()


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
def test_run_weights_serves_the_checkpoint(served_dir, tmp_path,
                                           weight_dtype):
    path, tc = served_dir
    prompts = [[5, 6, 7, 8], list(range(20, 61))]
    batch = tmp_path / "b.jsonl"
    batch.write_text("".join(json.dumps({"token_ids": p, "max_tokens": 6})
                             + "\n" for p in prompts))
    code = (
        "import sys, runpy\n"
        "sys.argv = ['run'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('dynamo_tpu_torch.run', run_name='__main__')\n"
        "finally:\n"
        "    bad = [m for m in ('safetensors', 'ml_dtypes', 'jax')\n"
        "           if m in sys.modules]\n"
        "    print('FORBIDDEN', bad, file=sys.stderr)\n")
    out = subprocess.run(
        [sys.executable, "-c", code, f"in=batch:{batch}", "out=engine",
         "--weights", str(path), "--device", "cpu", "--model", "tiny",
         "--weight-dtype", weight_dtype, "--num-blocks", "64",
         "--max-model-len", "256"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stderr
    # 3 layers x 9 tensors, then embed, final norm and the untied head
    assert "loaded 30 tensors" in out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.strip()]
    assert all("text" in r for r in rows)          # the dir's tokenizer
    params = tw.load_hf_params(path, tc, weight_dtype, device="cpu")
    engine = InferenceEngine(
        tc, EngineConfig(num_blocks=64, max_model_len=256,
                         weight_dtype=weight_dtype),
        params=params, device="cpu")
    assert [r["token_ids"] for r in rows] == asyncio.run(
        _serve(engine, prompts, 6))


def test_worker_weights_reads_config_and_tokenizer_from_the_dir(
        served_dir, monkeypatch):
    path, tc = served_dir
    seen = {}

    class Stop(Exception):
        pass

    def engine(model_cfg, eng_cfg, params=None, device=None):
        seen.update(cfg=model_cfg, eng=eng_cfg, params=params)
        raise Stop

    monkeypatch.setattr(tworker, "InferenceEngine", engine)
    monkeypatch.setattr(tworker, "load_tokenizer",
                        lambda p: seen.setdefault("tokenizer", p))
    args = tworker.parse_args(["--device", "cpu", "--weights", str(path),
                               "--weight-dtype", "int8"])
    with pytest.raises(Stop):
        asyncio.run(tworker.run_worker(args))
    assert seen["cfg"] == tc and seen["cfg"].num_layers == 3
    assert seen["tokenizer"] == str(path)
    assert seen["eng"].weight_dtype == "int8"
    assert isinstance(seen["params"]["layers"]["wq"], dict)
    assert seen["params"]["layers"]["wq"]["q"].dtype == torch.int8


def test_params_from_numpy_carries_moe_leaves():
    jc, tc = jcfg.ModelConfig.tiny_moe(), tcfg.ModelConfig.tiny_moe()
    jp = jm.init_params(jax.random.PRNGKey(2), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    assert set(tp["layers"]) == set(jp["layers"])
    assert_trees_equal_bitwise(tp, jax.tree.map(np.asarray, jp))
