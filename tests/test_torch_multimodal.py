"""The port's multimodal encode-prefill-decode path against the JAX package.

- The vision encoder: ``encode_image`` on the JAX encoder's parameters
  (carried across by ``vision_params_from_numpy``) at the tiny config and at
  224 px / 14 px patches, and ``VisionEncoder.encode``'s input handling
  (uint8 scaling, resizing, grey and RGBA inputs); 1e-5 (both f32, in another
  summation order).
- The processor: ``decode_image_part``, ``content_token`` (the port's XXH3
  against ``xxhash``), ``splice``, ``extract``, ``process`` and the
  multimodal preprocessor over a chat request: equal to JAX's.
- The engine: the JAX test ``test_engine_mm_injection_and_cache_correctness``
  ported, the validation messages, greedy mm streams identical to the JAX
  engine's at tiny f32 (an image split over two prefill chunks among them),
  and the KV-event hashes of an mm prompt equal to JAX's and to what the KV
  router hashes for the request.
- EPD in one process (encode endpoint, routed pipeline, engine) and over
  processes: store, ``python -m dynamo_tpu_torch.multimodal``, a worker with
  ``--mm-encode-component`` and the frontend, on the CPU.
"""

import asyncio
import base64
import io
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
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu.multimodal import encoder as jenc
from dynamo_tpu.multimodal import processor as jproc
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.tokens import compute_block_hashes_for_seq as jax_hashes
from dynamo_tpu_torch.engine import (
    EngineConfig, InferenceEngine, ModelConfig, Request,
)
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.multimodal import encoder as tenc
from dynamo_tpu_torch.multimodal import processor as tproc
from dynamo_tpu_torch.router.indexer import KvIndexer, RouterEvent
from dynamo_tpu_torch.router.kv_router import KvPushRouter
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tokens import compute_block_hashes_for_seq
from test_torch_distributed import Proc, free_port
from test_torch_frontend_http import TIMEOUT, fetch, tiny_tokenizer

ATOL = 1e-5


def image(seed: int, size: int = 32) -> np.ndarray:
    return np.random.RandomState(seed).rand(size, size, 3).astype(np.float32)


def data_url(img: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, img)
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f"data:application/x-npy;base64,{b64}"


VCFGS = {
    "tiny": dict(model_dim=64),
    "224-14": dict(image_size=224, patch_size=14, model_dim=2048),
}


def encoders(name, seed=0):
    """(JAX encoder, port encoder on its parameters, config pair)."""
    jcfg = jenc.VisionEncoderConfig(**VCFGS[name])
    tcfg = tenc.VisionEncoderConfig(**VCFGS[name])
    jax_enc = jenc.VisionEncoder(jcfg, seed=seed)
    tree = jax.tree.map(np.asarray, jax_enc.params)
    port = tenc.VisionEncoder(tcfg, device="cpu",
                              params=tenc.vision_params_from_numpy(tree,
                                                                   "cpu"))
    return jax_enc, port


# ------------------------------ the encoder -------------------------------


@pytest.mark.parametrize("name", list(VCFGS))
def test_encode_image_matches_jax(name):
    jax_enc, port = encoders(name)
    cfg = port.config
    img = image(1, cfg.image_size)
    want = np.asarray(jenc.encode_image(jax_enc.config, jax_enc.params,
                                        jnp.asarray(img)))
    got = tenc.encode_image(cfg, port.params, torch.from_numpy(img)).numpy()
    assert got.shape == (cfg.tokens_per_image, cfg.model_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


INPUTS = {
    "float": lambda: image(0),
    "uint8-resized": lambda: (image(0, size=48) * 255).astype(np.uint8),
    "grey": lambda: image(2)[:, :, 0],
    "rgba": lambda: np.random.RandomState(3).rand(20, 40, 4).astype(
        np.float32),
    "one-channel": lambda: image(4)[:, :, :1],
}


@pytest.mark.parametrize("kind", list(INPUTS))
def test_vision_encoder_encode_matches_jax(kind):
    jax_enc, port = encoders("tiny")
    img = INPUTS[kind]()
    want = jax_enc.encode(img)
    got = port.encode(img)
    assert got.dtype == np.float32
    assert got.shape == want.shape == (port.config.tokens_per_image, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert port.num_encoded == 1


def test_vision_encoder_is_seeded_and_content_dependent():
    cfg = tenc.VisionEncoderConfig.tiny()
    a = tenc.VisionEncoder(cfg, seed=0, device="cpu")
    b = tenc.VisionEncoder(cfg, seed=0, device="cpu")
    np.testing.assert_array_equal(a.encode(image(0)), b.encode(image(0)))
    assert not np.allclose(a.encode(image(0)), a.encode(image(1)))
    c = tenc.VisionEncoder(cfg, seed=1, device="cpu")
    assert not np.allclose(a.encode(image(0)), c.encode(image(0)))


def test_vision_encoder_without_device_raises_on_a_cpu_machine(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.VisionEncoder(tenc.VisionEncoderConfig.tiny())


@pytest.mark.parametrize("bad", [dict(image_size=30), dict(num_heads=3)],
                         ids=["patch", "heads"])
def test_vision_config_refusals_equal_jax(bad):
    msgs = []
    for mod in (jenc, tenc):
        with pytest.raises(ValueError) as e:
            mod.VisionEncoderConfig(**bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_wire_arrays_round_trip_as_in_jax():
    a = np.random.RandomState(0).randn(7, 5).astype(np.float32)
    wire = tenc.array_to_wire(a)
    assert wire == jenc.array_to_wire(a)
    np.testing.assert_array_equal(tenc.array_from_wire(wire), a)
    np.testing.assert_array_equal(jenc.array_from_wire(wire), a)


# ------------------------------ the processor -----------------------------


PARTS = {
    "data-url": lambda: {"type": "image_url",
                         "image_url": {"url": data_url(image(3))}},
    "array": lambda: {"type": "image", "array": image(3).tolist()},
    "http-url": lambda: {"type": "image_url",
                         "image_url": {"url": "http://x/y.png"}},
    "garbage": lambda: {"type": "image_url",
                        "image_url": {"url": "data:x;base64,AAAA"}},
    "no-url": lambda: {"type": "image_url"},
}


@pytest.mark.parametrize("kind", list(PARTS))
def test_decode_image_part_equals_jax(kind):
    def run(mod):
        try:
            return mod.decode_image_part(PARTS[kind]())
        except ValueError as e:
            return str(e)
    want, got = run(jproc), run(tproc)
    if isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,size,index", [
    (0, 32, 0), (1, 32, 0), (0, 32, 1), (5, 7, 3), (6, 224, 0),
    (7, 224, 2)])
def test_content_token_equals_jax(seed, size, index):
    img = image(seed, size)
    assert tproc.content_token(img, index) == jproc.content_token(img, index)
    assert tproc.content_token(img, index) >= (1 << 31)


class IdTokenizer:
    """ord()-based toy tokenizer for splice tests."""

    bos_token_id = None
    eos_token_ids = ()

    def encode(self, text):
        return [ord(c) % 500 for c in text]


MARK = tproc.MM_MARKER
SPLICES = {
    "two": (f"ab{MARK}cd{MARK}", 2),
    "only": (MARK, 1),
    "adjacent": (f"{MARK}{MARK}x", 2),
    "text-only": ("no markers", 0),
    "too-few-images": (f"a{MARK}b{MARK}", 1),
}


@pytest.mark.parametrize("kind", list(SPLICES))
def test_splice_equals_jax(kind):
    rendered, n = SPLICES[kind]
    imgs = [image(i) for i in range(n)]
    if kind == "too-few-images":
        imgs = [image(0)]

    def run(mod, local):
        proc = mod.MultimodalProcessor(IdTokenizer(), tokens_per_image=16,
                                       local_encoder=local)
        try:
            return proc.splice(rendered, imgs)
        except ValueError as e:
            return str(e)
    jax_enc, port = encoders("tiny")
    assert run(tproc, port) == run(jproc, jax_enc)


def test_extract_and_has_media_equal_jax():
    msgs = [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": [
            {"type": "text", "text": "look "},
            {"type": "image_url", "image_url": {"url": data_url(image(0))}},
            {"type": "input_text", "text": " and "},
            {"type": "image", "array": image(1).tolist()},
            "not a part",
        ]},
    ]
    for mod in (jproc, tproc):
        assert mod.MultimodalProcessor.has_media(msgs)
        assert not mod.MultimodalProcessor.has_media(msgs[:1])
    (jm_, jimgs), (tm_, timgs) = (jproc.MultimodalProcessor.extract(msgs),
                                  tproc.MultimodalProcessor.extract(msgs))
    assert tm_ == jm_
    assert len(timgs) == len(jimgs) == 2
    for a, b in zip(timgs, jimgs):
        np.testing.assert_array_equal(a, b)


def test_process_and_preprocessor_equal_jax():
    """A chat request with two images through both packages' multimodal
    preprocessors (local encoders on the same weights): the same token ids,
    placeholder positions and hash ids, embeddings within 1e-5."""
    hf = tiny_tokenizer()
    jax_enc, port = encoders("tiny")
    n = port.config.tokens_per_image
    request = {"model": "m", "max_tokens": 3, "messages": [
        {"role": "user", "content": [
            {"type": "text", "text": "describe "},
            {"type": "image_url", "image_url": {"url": data_url(image(0))}},
            {"type": "text", "text": " then "},
            {"type": "image_url", "image_url": {"url": data_url(image(1))}},
        ]}]}
    jtok, ttok = JaxTokenizer(hf), Tokenizer.from_json_str(hf.to_str())
    jpp = jproc.MultimodalPreprocessor(
        jpre.Preprocessor(jtok, model_name="m"),
        jproc.MultimodalProcessor(jtok, n, local_encoder=jax_enc))
    tpp = tproc.MultimodalPreprocessor(
        tpre.Preprocessor(ttok, model_name="m"),
        tproc.MultimodalProcessor(ttok, n, local_encoder=port))
    want = asyncio.run(jpp.forward(request, JaxContext()))
    got = asyncio.run(tpp.forward(request, Context()))
    assert got.token_ids == want.token_ids
    assert got.mm["positions"] == want.mm["positions"]
    assert len(got.mm["positions"]) == 2 * n
    assert got.mm["hash_token_ids"] == want.mm["hash_token_ids"]
    np.testing.assert_allclose(
        tenc.array_from_wire(got.mm["embeddings"]),
        jenc.array_from_wire(want.mm["embeddings"]), rtol=0, atol=ATOL)
    assert got.stop.max_tokens == want.stop.max_tokens == 3
    # text-only requests take the plain path in both
    plain = {"model": "m", "messages": [{"role": "user", "content": "hi"}]}
    assert (asyncio.run(tpp.forward(plain, Context())).token_ids
            == asyncio.run(jpp.forward(plain, JaxContext())).token_ids)


# ------------------------------- the engine --------------------------------


def tiny_engine(vocab_size=256):
    return InferenceEngine(
        ModelConfig.tiny(vocab_size=vocab_size),
        EngineConfig(num_blocks=128, block_size=4, max_model_len=256,
                     max_num_batched_tokens=256, prefill_buckets=(256,),
                     decode_buckets=(4,), max_num_seqs=4),
        device="cpu",
    )


async def _mm_run(eng, prompt, positions, embeds, hash_ids, rid,
                  request_cls=Request, max_tokens=4):
    req = request_cls(
        request_id=rid, token_ids=prompt, max_tokens=max_tokens,
        temperature=0.0, ignore_eos=True, mm_positions=positions,
        mm_embeddings=embeds, mm_hash_token_ids=hash_ids,
    )
    return [out.token_id async for out in eng.submit(req)]


def test_engine_mm_injection_and_cache_correctness():
    """Different images behind identical placeholder prompts must produce
    different outputs AND different KV blocks (content-addressed hashing);
    the same image must reuse its blocks and reproduce its output."""
    async def run():
        eng = tiny_engine()
        D = 64
        n = 4
        prompt = [5, 6] + [0] * n + [7, 8]
        positions = list(range(2, 2 + n))
        rng = np.random.RandomState(0)
        emb_a = rng.randn(n, D).astype(np.float32)
        emb_b = rng.randn(n, D).astype(np.float32)
        hash_a = [5, 6] + [(1 << 31) + 100 + j for j in range(n)] + [7, 8]
        hash_b = [5, 6] + [(1 << 31) + 900 + j for j in range(n)] + [7, 8]

        out_a1 = await _mm_run(eng, prompt, positions, emb_a, hash_a, "a1")
        assert eng.num_mm_prefills >= 1
        out_b = await _mm_run(eng, prompt, positions, emb_b, hash_b, "b")
        assert out_a1 != out_b, "different images produced identical streams"
        out_a2 = await _mm_run(eng, prompt, positions, emb_a, hash_a, "a2")
        assert out_a2 == out_a1, "same image failed to reproduce"
        # text-only request with the same placeholder ids must not hit
        # either image's cached blocks
        plain = [out.token_id async for out in eng.submit(Request(
            request_id="plain", token_ids=list(prompt), max_tokens=4,
            temperature=0.0, ignore_eos=True,
        ))]
        assert plain != out_a1 or plain != out_b
        await eng.stop()
    asyncio.run(run())


BAD_MM = {
    "no-hash-ids": ([1, 2, 0, 0], [2, 3], (2, 64), None),
    "short-hash-ids": ([1, 2, 0, 0], [2, 3], (2, 64), [1, 2, 3]),
    "rows": ([1, 2, 0, 0], [2, 3], (3, 64), [1, 2, 3, 4]),
    "width": ([1, 2, 0, 0], [2, 3], (2, 32), [1, 2, 3, 4]),
    "no-embeddings": ([1, 2, 0, 0], [2, 3], None, [1, 2, 3, 4]),
}


@pytest.mark.parametrize("kind", list(BAD_MM))
def test_engine_mm_validation_messages_equal_jax(kind):
    prompt, positions, shape, hash_ids = BAD_MM[kind]
    embeds = None if shape is None else np.zeros(shape, np.float32)

    def message(engine, request_cls):
        async def run():
            try:
                await _mm_run(engine, prompt, positions, embeds, hash_ids,
                              "bad", request_cls)
            finally:
                await engine.stop()
        with pytest.raises(ValueError) as e:
            asyncio.run(run())
        return str(e.value)

    jeng = JaxEngine(JaxModelConfig.tiny(vocab_size=256), JaxEngineConfig(
        num_blocks=32, block_size=4, max_model_len=64,
        max_num_batched_tokens=64, prefill_buckets=(64,),
        decode_buckets=(4,), max_num_seqs=4))
    want = message(jeng, JaxRequest)
    assert message(tiny_engine(), Request) == want
    assert kind != "width" or "--model-dim" in want


# an image of 32 placeholder rows after 50 text tokens: with a 64-token
# budget its rows 50..63 land in the first prefill chunk, 64..81 in the
# second
STREAM_KW = dict(block_size=4, num_blocks=128, max_num_seqs=4,
                 max_model_len=128, decode_buckets=(4,))
N_IMG = 32


def mm_requests():
    """(prompt, positions, embeddings, hash ids, max_tokens) per request:
    an image straddling the chunk boundary, the same image at the start of
    a short prompt, and two images."""
    rng = np.random.RandomState(7)
    out = []
    for layout in ((50,), (0,), (3, 40)):
        prompt, positions, hash_ids, embeds = [], [], [], []
        cursor = 0
        for k, at in enumerate(layout):
            text = rng.randint(1, 512, at - cursor).tolist()
            prompt += text
            hash_ids += text
            positions += list(range(len(prompt), len(prompt) + N_IMG))
            ct = tproc.content_token(image(k), k)
            hash_ids += [0x80000000 | ((ct + j) & 0x7FFFFFFF)
                         for j in range(N_IMG)]
            prompt += [0] * N_IMG
            embeds.append(rng.randn(N_IMG, 64).astype(np.float32))
            cursor = len(prompt)
        tail = rng.randint(1, 512, 20).tolist()
        prompt += tail
        hash_ids += tail
        out.append((prompt, positions, np.concatenate(embeds), hash_ids, 6))
    return out


@pytest.mark.parametrize("budget", [64, 128],
                         ids=["image-across-two-chunks", "one-chunk"])
def test_greedy_mm_streams_equal_jax(budget):
    eng_kw = dict(STREAM_KW, max_num_batched_tokens=budget,
                  prefill_buckets=(16, 64, 128))
    jengine = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**eng_kw),
                        seed=0)
    tree = jax.tree.map(np.asarray, jengine.params)
    tengine = InferenceEngine(
        ModelConfig.tiny(), EngineConfig(**eng_kw),
        params=params_from_numpy(tree, ModelConfig.tiny(), "cpu"),
        device="cpu")
    requests = mm_requests()

    async def serve(engine, request_cls):
        try:
            out = []
            for i, (p, pos, emb, h, n) in enumerate(requests):
                out.append(await _mm_run(engine, p, pos, emb, h, f"r{i}",
                                         request_cls, n))
            return out
        finally:
            await engine.stop()

    want = asyncio.run(serve(jengine, JaxRequest))
    got = asyncio.run(serve(tengine, Request))
    assert got == want
    assert tengine.num_mm_prefills == jengine.num_mm_prefills
    # the straddling image takes two mm chunks under a 64-token budget
    assert tengine.num_mm_prefills == (5 if budget == 64 else 3)


def test_mm_kv_event_hashes_equal_jax_and_the_router():
    """One mm prompt through both engines: the stored blocks' hashes are
    equal, chain over the content-addressed hash ids (not the placeholder
    ids), and are what the KV router computes for the request — a router
    fed the engine's events matches every full prompt block."""
    prompt, positions, embeds, hash_ids, n = mm_requests()[0]
    eng_kw = dict(STREAM_KW, max_num_batched_tokens=64,
                  prefill_buckets=(16, 64))

    async def serve(engine, request_cls):
        events = []
        engine.kv_event_sink = events.append
        try:
            await _mm_run(engine, prompt, positions, embeds, hash_ids, "r",
                          request_cls, n)
        finally:
            await engine.stop()
        return events

    jengine = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**eng_kw),
                        seed=0)
    tree = jax.tree.map(np.asarray, jengine.params)
    want = asyncio.run(serve(jengine, JaxRequest))
    tengine = InferenceEngine(
        ModelConfig.tiny(), EngineConfig(**eng_kw),
        params=params_from_numpy(tree, ModelConfig.tiny(), "cpu"),
        device="cpu")
    got = asyncio.run(serve(tengine, Request))
    assert got == want
    stored = [b["seq_hash"] for e in got if e["kind"] == "stored"
              for b in e["blocks"]]
    full = len(prompt) // 4
    routed = compute_block_hashes_for_seq(hash_ids, 4)
    assert routed == jax_hashes(hash_ids, 4)
    assert stored[:full] == routed
    assert stored[:full] != compute_block_hashes_for_seq(prompt, 4)

    # what KvPushRouter hands find_best_match: the hash ids of the mm field
    seen = []

    class StubRouter:
        class client:
            @staticmethod
            async def direct(worker, request, context):
                yield {"token_ids": [1]}

        class breakers:
            record_success = staticmethod(lambda w: None)

        def find_best_match(self, rid, token_ids, **kw):
            seen.append(list(token_ids))

            class Sel:
                worker_id, overlap_blocks = 1, 0
            return Sel()

        prefill_done = free = staticmethod(lambda rid: None)

    async def route():
        request = {"token_ids": prompt, "mm": {"hash_token_ids": hash_ids}}
        return [x async for x in KvPushRouter(StubRouter()).generate(
            request, Context())]
    asyncio.run(route())
    assert seen == [hash_ids]
    index = KvIndexer(block_size=4)
    for e in got:
        index.apply_event(RouterEvent(worker_id=1, kind=e["kind"],
                                      blocks=tuple(e["blocks"])))
    assert index.find_matches(routed).scores == {1: full}
    assert index.find_matches_for_tokens(prompt).scores.get(1, 0) \
        == 50 // 4


# ------------------------------ EPD flows ----------------------------------


def test_generate_reads_the_wire_mm_field():
    """The engine's wire adapter carries ``mm`` into the request: the same
    stream as ``submit`` with the fields set."""
    prompt, positions, embeds, hash_ids, n = mm_requests()[1]

    async def run():
        eng = tiny_engine(vocab_size=512)
        try:
            direct = await _mm_run(eng, prompt, positions, embeds, hash_ids,
                                   "d", Request, n)
            eng.clear_kv_blocks()
            wire = {"token_ids": prompt, "max_tokens": n, "ignore_eos": True,
                    "mm": {"positions": positions,
                           "embeddings": tenc.array_to_wire(embeds),
                           "hash_token_ids": hash_ids}}
            got = []
            async for out in eng.generate(wire, Context()):
                got.extend(out["token_ids"])
            return direct, got, eng.num_mm_prefills
        finally:
            await eng.stop()
    direct, got, n_mm = asyncio.run(run())
    assert got == direct and n_mm == 2


def test_epd_pipeline_in_one_process():
    """Chat request with an image data URL through the routed pipeline:
    multimodal preprocessor → encode endpoint → engine splicing → streamed
    completion; image identity changes the completion."""
    from dynamo_tpu_torch.llm.discovery import ModelDeploymentCard
    from dynamo_tpu_torch.llm.entrypoint import build_routed_pipeline
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.store import StoreServer
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    async def run():
        store = StoreServer(host="127.0.0.1", port=0)
        await store.start()
        cfg = RuntimeConfig(store_addr=f"127.0.0.1:{store.port}")
        worker_rt = await DistributedRuntime.from_settings(cfg)
        engine = InferenceEngine(
            ModelConfig.tiny(), EngineConfig(
                num_blocks=128, block_size=4, max_model_len=256,
                max_num_batched_tokens=256, prefill_buckets=(256,),
                decode_buckets=(4,), max_num_seqs=4), device="cpu")
        await engine.start()
        ns = worker_rt.namespace("mm")
        await ns.component("backend").endpoint("generate").serve_endpoint(
            engine)
        vcfg = tenc.VisionEncoderConfig.tiny(model_dim=64)
        handler = tenc.EncodeHandler(tenc.VisionEncoder(vcfg, device="cpu"))
        await ns.component("backend").endpoint("encode").serve_endpoint(
            handler)
        front_rt = await DistributedRuntime.from_settings(cfg)
        hf = tiny_tokenizer()
        card = ModelDeploymentCard(name="tiny-mm", tokenizer_json=hf.to_str(),
                                   context_length=256, migration_limit=1)
        gen_client = await (front_rt.namespace("mm").component("backend")
                            .endpoint("generate").client())
        enc_client = await (front_rt.namespace("mm").component("backend")
                            .endpoint("encode").client())
        await gen_client.wait_for_instances(1)
        await enc_client.wait_for_instances(1)
        pipeline = build_routed_pipeline(
            card, gen_client,
            mm_processor=tproc.MultimodalProcessor(
                card.load_tokenizer(),
                tokens_per_image=vcfg.tokens_per_image,
                encode_client=enc_client,
            ),
        )

        async def ask(img):
            body = {
                "model": "tiny-mm", "max_tokens": 4, "ignore_eos": True,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "describe "},
                    {"type": "image_url",
                     "image_url": {"url": data_url(img)}},
                ]}],
            }
            ids = []
            async for out in pipeline.generate(body, Context()):
                ids.extend(out.token_ids)
            return ids

        try:
            a1 = await ask(image(0))
            b = await ask(image(1))
            a2 = await ask(image(0))
            assert engine.num_mm_prefills >= 2
            assert len(a1) == 4 and a1 == a2
            assert a1 != b
            assert handler.encoder.num_encoded == 3
        finally:
            await gen_client.stop()
            await enc_client.stop()
            await engine.stop()
            handler.close()
            await front_rt.shutdown()
            await worker_rt.shutdown()
            await store.stop()
    asyncio.run(run())


def test_epd_over_processes(tmp_path):
    """The store, the encode worker (``python -m
    dynamo_tpu_torch.multimodal --device cpu``), a worker with
    ``--mm-encode-component encoder`` and the frontend, each a process:
    chat requests carrying ``.npy`` data URLs stream completions, image
    identity changes them, a text-only chat still works, and every process
    exits 0 on SIGTERM, the worker having spliced each image into one
    prefill chunk."""
    tok_file = tmp_path / "tok.json"
    tok_file.write_text(tiny_tokenizer().to_str())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    addr = f"127.0.0.1:{free_port()}"
    procs = {"store": Proc(tmp_path, "store",
                           "dynamo_tpu_torch.runtime.store", "--host",
                           "127.0.0.1", "--port", addr.split(":")[1],
                           env=env)}
    try:
        procs["store"].wait_for(r"store listening")
        procs["encoder"] = Proc(
            tmp_path, "encoder", "dynamo_tpu_torch.multimodal",
            "--store-addr", addr, "--model-dim", "64", "--device", "cpu",
            env=env)
        procs["worker"] = Proc(
            tmp_path, "worker", "dynamo_tpu_torch.worker", "--model",
            "tiny", "--device", "cpu", "--tokenizer", str(tok_file),
            "--store-addr", addr, "--model-name", "tiny-mm",
            "--block-size", "4", "--num-blocks", "128", "--max-model-len",
            "256", "--max-batched-tokens", "256",
            "--mm-encode-component", "encoder", env=env)
        procs["frontend"] = Proc(
            tmp_path, "frontend", "dynamo_tpu_torch.frontend", "--host",
            "127.0.0.1", "--port", "0", "--store-addr", addr, env=env)
        procs["encoder"].wait_for(r"encode worker ready: 32x32 px -> 16 "
                                  r"tokens x 64 dim on cpu")
        port = int(procs["frontend"].wait_for(
            r"frontend ready on 127\.0\.0\.1:(\d+)").group(1))
        procs["worker"].wait_for(r"registered model tiny-mm")

        async def ask():
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                for _ in range(200):
                    _, _, body = await fetch(s, port, "GET", "/v1/models")
                    if body["data"]:
                        break
                    await asyncio.sleep(0.05)
                out = []
                for img in (image(0), image(1), None):
                    content = "plain" if img is None else [
                        {"type": "text", "text": "describe "},
                        {"type": "image_url",
                         "image_url": {"url": data_url(img)}}]
                    out.append(await fetch(s, port, "POST",
                                           "/v1/chat/completions", {
                                               "model": "tiny-mm",
                                               "max_tokens": 4,
                                               "ignore_eos": True,
                                               "stream": True,
                                               "messages": [{
                                                   "role": "user",
                                                   "content": content}]}))
                return out

        results = asyncio.run(ask())
        texts = []
        for status, _, frames in results:
            assert status == 200, frames
            assert frames[-1] == (None, "[DONE]")
            assert frames[-2][1]["usage"]["completion_tokens"] == 4
            texts.append("".join(
                f[1]["choices"][0]["delta"].get("content") or ""
                for f in frames[:-1] if f[1].get("choices")))
        assert texts[0] != texts[1], "image identity did not matter"
        for name in ("frontend", "worker", "encoder"):
            assert procs[name].stop() == 0, name
        assert "encode worker exiting: 2 images encoded" in \
            procs["encoder"].log.read_text()
        assert "worker exiting: engine counts mm_prefills=2 " in \
            procs["worker"].log.read_text()
    finally:
        for p in procs.values():
            p.stop(signal.SIGKILL)
