"""The PyTorch port's engine against the JAX engine: the same parameters
(carried across by ``params_from_numpy``), the same four greedy requests of
different lengths served concurrently, identical token streams, with bf16
passthrough and with quantized weights and KV (the JAX engine's quantized
tree carried across). Also runs
``python -m dynamo_tpu_torch.run in=batch:FILE out=engine`` once on the
CPU."""

import asyncio
import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu_torch.engine import (
    EngineConfig, InferenceEngine, ModelConfig, Request,
)
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.context import Context

ENG_KW = dict(block_size=4, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(4, 8), prefill_buckets=(16, 64))
PROMPTS = [
    [5, 6, 7],
    list(range(20, 41)),          # crosses several blocks
    [9, 10, 11, 12, 13, 14, 15],
    list(range(100, 170)),        # longer than one prefill bucket (64)
]
MAX_TOKENS = [6, 9, 4, 7]


async def _serve(engine, request_cls):
    async def one(i):
        req = request_cls(request_id=f"r{i}", token_ids=PROMPTS[i],
                          max_tokens=MAX_TOKENS[i])
        return [o.token_id async for o in engine.submit(req)]
    try:
        return await asyncio.gather(*(one(i) for i in range(len(PROMPTS))))
    finally:
        await engine.stop()


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_greedy_streams_match_jax_engine(decode_steps):
    jengine = JaxEngine(JaxModelConfig.tiny(),
                        JaxEngineConfig(decode_steps=decode_steps, **ENG_KW),
                        seed=0)
    tree = jax.tree.map(np.asarray, jengine.params)
    want = asyncio.run(_serve(jengine, JaxRequest))
    tengine = InferenceEngine(
        ModelConfig.tiny(), EngineConfig(decode_steps=decode_steps, **ENG_KW),
        params=params_from_numpy(tree, ModelConfig.tiny(), "cpu"),
        device="cpu",
    )
    got = asyncio.run(_serve(tengine, Request))
    assert [len(g) for g in got] == MAX_TOKENS
    assert got == want
    assert tengine.num_windows > 0 and tengine.num_prefill_dispatches >= 4


def _numpy_tree(tree):
    """JAX params as numpy leaves; fp8 leaves as uint8 bit views."""
    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_greedy_streams_match_jax_engine(dtype):
    quant = dict(weight_dtype=dtype, kv_dtype=dtype)
    jengine = JaxEngine(JaxModelConfig.tiny(),
                        JaxEngineConfig(**quant, **ENG_KW), seed=0)
    tree = _numpy_tree(jengine.params)
    assert isinstance(tree["layers"]["wq"], dict)
    want = asyncio.run(_serve(jengine, JaxRequest))
    tengine = InferenceEngine(
        ModelConfig.tiny(), EngineConfig(**quant, **ENG_KW),
        params=params_from_numpy(tree, ModelConfig.tiny(), "cpu",
                                 weight_dtype=dtype),
        device="cpu",
    )
    got = asyncio.run(_serve(tengine, Request))
    assert [len(g) for g in got] == MAX_TOKENS
    assert got == want


def test_quantized_chunked_prefill_streams_equal_whole():
    """Chunk boundaries change no token's quantized bytes: chunked and
    whole-bucket prefill stream the same tokens."""
    streams = []
    for chunk in (0, 8):
        engine = InferenceEngine(
            ModelConfig.tiny(),
            EngineConfig(weight_dtype="int8", kv_dtype="int8",
                         prefill_chunk_tokens=chunk, **ENG_KW),
            seed=3, device="cpu")
        streams.append(asyncio.run(_serve(engine, Request)))
    assert streams[0] == streams[1]
    assert [len(g) for g in streams[0]] == MAX_TOKENS


def test_wire_generate_and_abort():
    engine = InferenceEngine(ModelConfig.tiny(), EngineConfig(**ENG_KW),
                             device="cpu")

    async def run():
        ctx = Context()
        outs = []
        try:
            async for out in engine.generate(
                    {"token_ids": [3, 4, 5], "max_tokens": 50}, ctx):
                outs.append(out)
                if len(outs) == 3:
                    ctx.stop_generating()
        finally:
            await engine.stop()
        return outs

    outs = asyncio.run(run())
    assert outs[-1]["finished"]
    assert outs[-1]["finish_reason"] == "cancelled"
    assert len(outs) < 50
    assert engine.scheduler.pool.num_free == ENG_KW["num_blocks"] - 1


def test_run_batch_mode_on_cpu(tmp_path):
    batch = tmp_path / "batch.jsonl"
    batch.write_text(
        json.dumps({"token_ids": [5, 6, 7], "max_tokens": 3}) + "\n"
        + json.dumps({"token_ids": list(range(1, 30)), "max_tokens": 5})
        + "\n"
    )
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", f"in=batch:{batch}",
         "out=engine", "--model", "tiny", "--device", "cpu",
         "--num-blocks", "64", "--max-model-len", "256"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.strip()]
    assert [r["completion_tokens"] for r in rows] == [3, 5]
    assert all(0 <= t < 512 for r in rows for t in r["token_ids"])
