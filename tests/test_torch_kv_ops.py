"""The port's KV block gather/scatter (``engine/model.py`` ``make_kv_ops``)
and the engine seams on top of it, held against the JAX package: extract
and inject equal the JAX ops bit for bit on the same cache for f32, bf16,
int8 and fp8 (pages and scales); the inject writes the engine's cache
tensors in place (the decode graphs read them at their captured
addresses); an injected cache gives the logits a prefilled one gives; a
resumed seat's first decode window takes the remotely sampled token from
the host. CPU, tiny shapes, numpy seeds."""

import asyncio

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.disagg.protocol import tensor_bytes
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine, Request

L, NB, KV, BS, HD = 3, 12, 2, 4, 8
NP_DTYPES = {
    "float32": np.dtype(np.float32),
    "bfloat16": np.dtype(ml_dtypes.bfloat16),
    "int8": np.dtype(np.int8),
    "fp8": np.dtype(ml_dtypes.float8_e4m3fn),
}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _np_bytes(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _to_torch(a: np.ndarray, dt: torch.dtype) -> torch.Tensor:
    """A numpy array (ml_dtypes included) as a torch tensor, same bytes."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind in "fiu":
        return torch.from_numpy(a.copy())
    view = np.uint8 if a.dtype.itemsize == 1 else np.int16
    return torch.from_numpy(a.view(view).copy()).view(dt)


def _cache_pair(kind: str, seed: int):
    """The same random cache as a JAX dict of jnp layers and a port dict of
    torch layers, plus the matching engine configs."""
    rng = np.random.default_rng(seed)
    quantized = kind in ("int8", "fp8")
    kv_dtype = kind if quantized else "bf16"
    ndt = NP_DTYPES[kind]
    shape = (NB, KV, BS, HD)
    planes = {"k": (shape, ndt), "v": (shape, ndt)}
    if quantized:
        planes.update(ks=(shape[:-1], np.dtype(np.float32)),
                      vs=(shape[:-1], np.dtype(np.float32)))
    arrs = {}
    for key, (shp, dt) in planes.items():
        layers = []
        for _ in range(L):
            if dt == np.int8:
                a = rng.integers(-127, 128, size=shp).astype(np.int8)
            else:
                a = (rng.standard_normal(shp) * 3).astype(np.float32)
                a = a.astype(dt)
            layers.append(a)
        arrs[key] = layers
    jcache = {key: [jnp.asarray(a) for a in layers]
              for key, layers in arrs.items()}
    tdt = {k: (TORCH_DTYPES[kind] if k in ("k", "v") else torch.float32)
           for k in arrs}
    tcache = {key: [_to_torch(a, tdt[key]) for a in layers]
              for key, layers in arrs.items()}
    jeng = JEngineConfig(num_blocks=NB, block_size=BS, kv_dtype=kv_dtype)
    teng = EngineConfig(num_blocks=NB, block_size=BS, kv_dtype=kv_dtype)
    return jcache, tcache, jeng, teng


KINDS = ["float32", "bfloat16", "int8", "fp8"]


@pytest.mark.parametrize("kind", KINDS)
def test_payload_keys_equal_jax(kind):
    _, _, jeng, teng = _cache_pair(kind, 0)
    assert tmodel.cache_payload_keys(teng) == jmodel.cache_payload_keys(jeng)


@pytest.mark.parametrize("kind", KINDS)
def test_extract_equals_jax_bitwise(kind):
    jcache, tcache, jeng, teng = _cache_pair(kind, 1)
    ids = np.array([3, 0, 7, 11, 5, 0, 0, 0], np.int32)   # pads: trash 0
    jex, _ = jmodel.make_kv_ops(jeng)
    tex, _ = tmodel.make_kv_ops(teng)
    want = jex(jcache, jnp.asarray(ids))
    got = tex(tcache, torch.from_numpy(ids))
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert tensor_bytes(got[key]) == _np_bytes(want[key]), key


@pytest.mark.parametrize("kind", KINDS)
def test_inject_equals_jax_bitwise_and_in_place(kind):
    jcache, tcache, jeng, teng = _cache_pair(kind, 2)
    src_j, src_t, _, _ = _cache_pair(kind, 3)
    src_ids = np.array([1, 2, 9, 4], np.int32)
    dst_ids = np.array([6, 10, 8, 0], np.int32)      # one pad row
    jex, jin = jmodel.make_kv_ops(jeng)
    tex, tin = tmodel.make_kv_ops(teng)
    data_j = jex(src_j, jnp.asarray(src_ids))
    data_t = tex(src_t, torch.from_numpy(src_ids))
    # zero the pad row as the engines do before a scatter
    data_j = {k: a.at[:, 3].set(0) for k, a in data_j.items()}
    for a in data_t.values():
        a[:, 3] = 0
    before = {key: [t.data_ptr() for t in layers]
              for key, layers in tcache.items()}
    layers_before = {key: list(layers) for key, layers in tcache.items()}
    want = jin(jcache, jnp.asarray(dst_ids), data_j)
    got = tin(tcache, torch.from_numpy(dst_ids), data_t)
    assert got is tcache
    for key in want:
        for li in range(L):
            assert got[key][li] is layers_before[key][li]
            assert got[key][li].data_ptr() == before[key][li]
            assert tensor_bytes(got[key][li]) == _np_bytes(want[key][li]), \
                (key, li)


# ----------------------------- engine seams -------------------------------


MC = ModelConfig.tiny(vocab_size=256)
PROMPT = [7, 3, 11, 42, 9, 100, 55, 2, 91, 13, 77, 5, 31, 8, 60, 24,
          17, 45, 88, 6, 29, 73, 50]


def _cfg(**kw):
    base = dict(num_blocks=64, block_size=4, max_model_len=128,
                max_num_batched_tokens=128, prefill_buckets=(128,),
                decode_buckets=(4,), max_num_seqs=4)
    base.update(kw)
    return EngineConfig(**base)


def _engine(seed=0, **kw):
    return InferenceEngine(MC, _cfg(**kw), seed=seed, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_engine_round_trip_keeps_cache_identity(kv_dtype):
    """extract → reserve → inject on a second engine: the reserved blocks
    then hold the source's bytes (pages and scales), the pad scattered only
    into the trash block, and every cache tensor of the destination is the
    object (and the storage) it was before."""
    async def run():
        src, dst = _engine(kv_dtype=kv_dtype), _engine(seed=1,
                                                       kv_dtype=kv_dtype)
        try:
            seq, _ = await src.prefill_held(Request("p", PROMPT, 1))
            data = await src.extract_kv(seq)
            assert data["k"].shape[1] == len(seq.block_table) == 6
            dseq = dst.reserve_sequence(Request("d", PROMPT, 4))
            ids = {key: [(t, t.data_ptr()) for t in layers]
                   for key, layers in dst.cache.items()}
            cache = dst.cache
            await dst.inject_kv(dseq, data, epoch=dseq.kv_epoch)
            assert dst.cache is cache
            for key, layers in ids.items():
                for li, (t, ptr) in enumerate(layers):
                    assert dst.cache[key][li] is t
                    assert t.data_ptr() == ptr
            got = await dst.extract_kv(dseq)
            for key in data:
                assert tensor_bytes(got[key]) == tensor_bytes(data[key])
            src.release_held(seq)
            dst.cancel_reservation(dseq)
        finally:
            await src.stop()
            await dst.stop()

    asyncio.run(run())


def test_injected_cache_gives_prefilled_logits():
    """A cache built by inject and one built by prefill give the same
    logits (bitwise, f32) for the next token through an eager forward."""
    async def run():
        a, b = _engine(), _engine()
        try:
            seq_a, tok_a = await a.prefill_held(Request("p", PROMPT, 1))
            data = await a.extract_kv(seq_a)
            seq_b = b.reserve_sequence(Request("d", PROMPT, 4))
            await b.inject_kv(seq_b, data, epoch=seq_b.kv_epoch)
            out = []
            for eng, seq in ((a, seq_a), (b, seq_b)):
                pos = len(PROMPT)
                tables = torch.tensor([seq.block_table], dtype=torch.int32)
                _, h = tmodel.forward(
                    MC, eng.config, eng.params, eng.cache,
                    torch.tensor([[tok_a]]), torch.tensor([[pos]]), tables)
                out.append(tmodel.logits_fn(MC, eng.params, h))
            a.release_held(seq_a)
            b.cancel_reservation(seq_b)
            return out
        finally:
            await a.stop()
            await b.stop()

    want, got = asyncio.run(run())
    assert torch.equal(want, got)


def test_resumed_seat_pushes_its_first_token_from_the_host():
    """``admit_prefilled`` leaves no token in flight on the device, so the
    resumed seat's first decode row has ``tok_src`` 0, and the window's
    delta carries the remotely sampled token as ``lt``; the stream then
    equals the aggregated one."""
    async def run():
        agg, pre, dec = _engine(), _engine(), _engine()
        try:
            want = [o.token_id async for o in agg.submit(
                Request("a", PROMPT, 6, ignore_eos=True))]
            seq, first = await pre.prefill_held(Request("p", PROMPT, 1))
            data = await pre.extract_kv(seq)
            pre.release_held(seq)
            dseq = dec.reserve_sequence(Request("d", PROMPT, 6,
                                                ignore_eos=True))
            await dec.inject_kv(dseq, data, epoch=dseq.kv_epoch)
            rows, deltas = [], []
            orig_sched = dec.scheduler.schedule
            orig_apply = dec._ap_apply_deltas

            def schedule():
                batch = orig_sched()
                rows.extend((r.tok_src, r.tok_host)
                            for r in batch.decode_rows)
                return batch

            def apply(d):
                deltas.append({s: v["lt"] for s, v in d.items()})
                return orig_apply(d)

            dec.scheduler.schedule = schedule
            dec._ap_apply_deltas = apply
            got = [o.token_id async for o in
                   dec.resume_prefilled(dseq, first)]
            return want, got, first, rows, deltas
        finally:
            for e in (agg, pre, dec):
                await e.stop()

    want, got, first, rows, deltas = asyncio.run(run())
    assert got == want
    assert rows[0] == (0, first)
    assert list(deltas[0].values()) == [first]
