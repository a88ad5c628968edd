"""The port's embeddings path against the JAX package: ``encode_forward``
(the encode-only step), ``InferenceEngine.embed`` and its validation, the
``EmbeddingsPipeline``'s input handling, and ``POST /v1/embeddings`` through
the store, worker and frontend as processes on the CPU.

Tolerances: f32 (``ModelConfig.tiny()`` and ``tiny_moe``) agrees to 1e-5
(both compute in f32, in another summation order). At bf16 the pooled unit
vectors agree to 2e-2 per element, the bf16 budget the kernel checks use
(2^-7 relative rounding of hidden states ~1, in another order), and their
cosine to 1e-3."""

import asyncio
import dataclasses
import os
import signal

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm import entrypoint as jentry
from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm import entrypoint as tentry
from test_torch_distributed import Proc, free_port
from test_torch_frontend_http import TIMEOUT, fetch, tiny_tokenizer

ENG_KW = dict(block_size=4, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(4, 8), prefill_buckets=(16, 64))
BF16_ATOL = 2e-2
BF16_COS = 1e-3


def numpy_tree(tree):
    """JAX params as numpy leaves; bf16 leaves as uint16 bit views."""
    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree.map(leaf, tree)


def configs(name):
    if name == "tiny_bf16":
        return (dataclasses.replace(jcfg.ModelConfig.tiny(),
                                    dtype="bfloat16"),
                dataclasses.replace(tcfg.ModelConfig.tiny(),
                                    dtype="bfloat16"))
    return getattr(jcfg.ModelConfig, name)(), getattr(tcfg.ModelConfig,
                                                      name)()


def feed(T, vocab, seed=0):
    """Rows of T, T // 2 + 1 and 1 valid tokens and a row of pads only
    (pooled to the zero vector by the 1e-12 norm floor)."""
    rng = np.random.RandomState(seed)
    lens = [T, T // 2 + 1, 1, 0]
    tokens = np.zeros((len(lens), T), np.int32)
    positions = np.full((len(lens), T), -1, np.int32)
    for r, n in enumerate(lens):
        tokens[r, :n] = rng.randint(1, vocab, n)
        positions[r, :n] = np.arange(n)
    return tokens, positions


@pytest.mark.parametrize("name,T", [
    ("tiny", 16), ("tiny", 600), ("tiny_moe", 16), ("tiny_bf16", 16),
], ids=["tiny-f32", "tiny-f32-T600", "tiny_moe-f32", "tiny-bf16"])
def test_encode_forward_matches_jax(name, T):
    """T=600 runs the attention in two query blocks of at most 512."""
    jc, tc = configs(name)
    jparams = jm.init_params(jax.random.PRNGKey(0), jc)
    tparams = params_from_numpy(numpy_tree(jparams), tc, "cpu")
    tokens, positions = feed(T, jc.vocab_size)
    want = np.asarray(jm.encode_forward(jc, jparams, jnp.asarray(tokens),
                                        jnp.asarray(positions)))
    got = tm.make_encode_fn(tc)(tparams, torch.from_numpy(tokens),
                                torch.from_numpy(positions)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, tc.hidden_size)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got[:3], axis=-1), 1.0,
                               atol=1e-5)
    assert not got[3].any() and not want[3].any()
    if name == "tiny_bf16":
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        cos = (got[:3] * want[:3]).sum(-1)
        assert (1.0 - cos).max() < BF16_COS, cos
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_encode_forward_ignores_what_follows_a_row():
    """A row's embedding depends on its own valid tokens only: padding,
    other rows and the pad tokens' ids leave it unchanged."""
    tc = tcfg.ModelConfig.tiny()
    params = tm.init_params(torch.Generator().manual_seed(0), tc)
    tokens, positions = feed(16, tc.vocab_size)
    tok = torch.from_numpy(tokens)
    pos = torch.from_numpy(positions)
    batch = tm.encode_forward(tc, params, tok, pos)
    junk = tok.clone()
    junk[pos < 0] = 7
    alone = tm.encode_forward(tc, params, junk[1:2, :9], pos[1:2, :9])
    torch.testing.assert_close(alone[0], batch[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(
        tm.encode_forward(tc, params, junk, pos), batch, rtol=0, atol=1e-6)


# ------------------------------ the engine -------------------------------

EMBED_INPUTS = [[5, 6, 7, 8], [5, 6, 7, 8], [9, 10, 11],
                list(range(20, 61)), list(range(100, 117)), [3]]


def engines():
    jengine = JaxEngine(jcfg.ModelConfig.tiny(), JaxEngineConfig(**ENG_KW),
                        seed=0)
    tree = jax.tree.map(np.asarray, jengine.params)
    tengine = InferenceEngine(
        tcfg.ModelConfig.tiny(), EngineConfig(**ENG_KW),
        params=params_from_numpy(tree, tcfg.ModelConfig.tiny(), "cpu"),
        device="cpu")
    return jengine, tengine


def test_engine_embed_matches_jax():
    jengine, tengine = engines()

    async def run(engine):
        try:
            out = await engine.embed(EMBED_INPUTS)
            again = await engine.embed(EMBED_INPUTS)
            alone = [(await engine.embed([ids]))[0] for ids in EMBED_INPUTS]
            return out, again, alone
        finally:
            await engine.stop()

    want, _, _ = asyncio.run(run(jengine))
    got, again, alone = asyncio.run(run(tengine))
    assert got == again                        # bitwise, call to call
    assert got[0] == got[1] and got[0] != got[2]
    assert [len(v) for v in got] == [64] * len(EMBED_INPUTS)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(alone), np.asarray(got), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_embed_runs_on_the_device_step_thread():
    """``embed`` shares the one device-step thread with the windows."""
    _, tengine = engines()
    seen = []
    fn = tm.make_encode_fn(tengine.model_config)

    def spy(*args):
        import threading

        seen.append(threading.current_thread().name)
        return fn(*args)

    tengine._encode_fn = spy

    async def run():
        try:
            return await tengine.embed([[1, 2, 3], list(range(1, 40))])
        finally:
            await tengine.stop()

    asyncio.run(run())
    assert len(seen) == 2
    assert all(name.startswith("device-step") for name in seen)


@pytest.mark.parametrize("batch", [[[]], [[1, 2], []], [[1] * 128],
                                   [[1] * 500]],
                         ids=["empty", "one-empty", "max_model_len",
                              "longer"])
def test_embed_validation_messages_equal_jax(batch):
    jengine, tengine = engines()

    def message(engine):
        async def run():
            try:
                await engine.embed(batch)
            finally:
                await engine.stop()
        with pytest.raises(ValueError) as e:
            asyncio.run(run())
        return str(e.value)

    assert message(tengine) == message(jengine)


def test_embed_endpoint_answers_the_wire_request():
    _, tengine = engines()

    async def run():
        try:
            return [out async for out in tengine.embed_endpoint(
                {"token_ids_batch": [[1, 2, 3], [4, 5]]}, None)]
        finally:
            await tengine.stop()

    (out,) = asyncio.run(run())
    assert list(out) == ["embeddings"] and len(out["embeddings"]) == 2


# ---------------------------- the pipeline -------------------------------


class FakeClient:
    """Stands in for the worker's ``embed`` endpoint client: records the
    wire request, answers one vector per input."""

    def __init__(self):
        self.requests = []

    async def round_robin(self, request, context):
        self.requests.append(request)
        yield {"embeddings": [[float(len(ids))]
                              for ids in request["token_ids_batch"]]}


PIPELINE_INPUTS = {
    "string": "hello world",
    "strings": ["hello", "world again", "x"],
    "token-array": [1, 2, 3],
    "token-arrays": [[1, 2], [3, 4, 5]],
    "mixed": ["hi there", [5, 6]],
    "nothing": [],
    "dict": {"a": 1},
    "number": 3,
    "float-ids": [1.5, 2],
    "bool-ids": [True, 2],
    "bad-nested": [[1, "a"]],
    "empty-string": "",
    "empty-array": [[]],
    "too-long": [1] * 256,
}


@pytest.mark.parametrize("inputs", list(PIPELINE_INPUTS.values()),
                         ids=list(PIPELINE_INPUTS))
def test_embeddings_pipeline_inputs_equal_jax(inputs):
    """The same input through both pipelines: the same wire batch, vectors
    and prompt-token count, or the same ValueError."""
    tok = tiny_tokenizer().to_str()

    def run(disc, entry):
        card = disc.ModelDeploymentCard(name="tiny", tokenizer_json=tok,
                                        context_length=256)
        client = FakeClient()
        pipe = entry.EmbeddingsPipeline(card, client)
        try:
            out = asyncio.run(pipe.embed(inputs))
        except ValueError as e:
            return ("error", str(e)), client.requests
        return out, client.requests

    assert run(tdisc, tentry) == run(jdisc, jentry)


# ----------------------------- as processes ------------------------------


def test_v1_embeddings_through_store_worker_and_frontend(tmp_path):
    """``POST /v1/embeddings`` through the three entry points as processes
    (``--device cpu``): 200 for a string and for a list of token arrays,
    ``usage.prompt_tokens`` right, the vectors equal to an in-process
    engine's with the worker's seed within 1e-5; a bad input is a 400."""
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    tok_json = tiny_tokenizer().to_str()
    tok_file = tmp_path / "tok.json"
    tok_file.write_text(tok_json)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    addr = f"127.0.0.1:{free_port()}"
    procs = {"store": Proc(tmp_path, "store",
                           "dynamo_tpu_torch.runtime.store", "--host",
                           "127.0.0.1", "--port", addr.split(":")[1],
                           env=env)}
    try:
        procs["store"].wait_for(r"store listening")
        procs["worker"] = Proc(
            tmp_path, "worker", "dynamo_tpu_torch.worker", "--model",
            "tiny", "--device", "cpu", "--tokenizer", str(tok_file),
            "--store-addr", addr, "--num-blocks", "64", "--max-model-len",
            "256", env=env)
        procs["frontend"] = Proc(
            tmp_path, "frontend", "dynamo_tpu_torch.frontend", "--host",
            "127.0.0.1", "--port", "0", "--store-addr", addr, env=env)
        port = int(procs["frontend"].wait_for(
            r"frontend ready on 127\.0\.0\.1:(\d+)").group(1))
        procs["worker"].wait_for(r"registered model tiny")
        text = "embed this sentence, please"
        arrays = [[5, 6, 7, 8], list(range(20, 61))]

        async def ask():
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                for _ in range(200):
                    _, _, body = await fetch(s, port, "GET", "/v1/models")
                    if body["data"]:
                        break
                    await asyncio.sleep(0.05)
                out = []
                for inputs in (text, arrays, [[1, "x"]]):
                    out.append(await fetch(s, port, "POST",
                                           "/v1/embeddings",
                                           {"model": "tiny",
                                            "input": inputs}))
                return out

        (s1, _, b1), (s2, _, b2), (s3, _, b3) = asyncio.run(ask())
        assert (s1, s2, s3) == (200, 200, 400), (b1, b2, b3)
        ids = Tokenizer.from_json_str(tok_json).encode(text)
        assert b1["usage"]["prompt_tokens"] == len(ids)
        assert b2["usage"]["prompt_tokens"] == sum(map(len, arrays))
        assert [d["index"] for d in b2["data"]] == [0, 1]
        engine = InferenceEngine(tcfg.ModelConfig.tiny(),
                                 EngineConfig(num_blocks=64,
                                              max_model_len=256),
                                 seed=0, device="cpu")

        async def local():
            try:
                return await engine.embed([ids] + arrays)
            finally:
                await engine.stop()
        want = asyncio.run(local())
        got = [b1["data"][0]["embedding"]] + [d["embedding"]
                                              for d in b2["data"]]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert procs["worker"].stop() == 0
        assert procs["frontend"].stop() == 0
    finally:
        for p in procs.values():
            p.stop(signal.SIGKILL)
