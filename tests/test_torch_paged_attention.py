"""Ragged paged attention of the PyTorch port: its plain version (what the
wrapper runs on a CPU tensor) against the JAX Pallas kernel in interpret
mode, on the same numpy inputs. Float32 throughout; the two compute the same
f32 softmax in a different order, so they agree to 1e-5.

The cases are those of tests/test_ragged_attention.py and
tests/test_paged_attention.py: mixed ragged batches, GQA group sizes, partial
last blocks, all-trash rows, stale table tails over a NaN-poisoned block 0,
and the decode wrapper equal to the ragged one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.ops.paged_attention import (
    paged_attention_decode as jax_decode,
    paged_attention_ragged as jax_ragged,
)
from dynamo_tpu_torch.ops import paged_attention as pa

ATOL = 1e-5


def _make_case(rows, *, G=2, KV=2, hd=64, bs=16, W=8, q_tile=4, seed=0,
               poison_trash=True, poison_tails=True):
    """``rows`` is a list of (q_len, ctx_len, alloc_tiles). Tables are
    allocated contiguously from block 1; the trash block 0 and the dead tail
    of each partial last block are NaN."""
    rng = np.random.default_rng(seed)
    H = KV * G
    q_start = [0]
    for ql, cl, al in rows:
        q_start.append(q_start[-1] + al * q_tile)
    Tq = q_start[-1]
    nb = 1 + sum((cl + bs - 1) // bs for _, cl, _ in rows) + 2
    q = rng.standard_normal((Tq, H, hd)).astype(np.float32)
    k = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    v = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    if poison_trash:
        k[0] = np.nan
        v[0] = np.nan
    tables = np.zeros((len(rows), W), np.int32)
    nxt = 1
    for r, (ql, cl, al) in enumerate(rows):
        for w in range((cl + bs - 1) // bs):
            tables[r, w] = nxt
            nxt += 1
        if poison_tails and cl % bs and cl > 0:
            blk = tables[r, cl // bs]
            k[blk, :, cl % bs:] = np.nan
            v[blk, :, cl % bs:] = np.nan
    return dict(q=q, k=k, v=v, tables=tables,
                q_start=np.asarray(q_start, np.int32),
                q_len=np.asarray([r[0] for r in rows], np.int32),
                ctx_len=np.asarray([r[1] for r in rows], np.int32),
                bs=bs, q_tile=q_tile)


def _jax(c):
    max_q_len = int(np.max(np.diff(c["q_start"])))
    out = jax_ragged(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["q_start"]),
        jnp.asarray(c["q_len"]), jnp.asarray(c["ctx_len"]),
        block_size=c["bs"], max_q_len=max_q_len, q_tile=c["q_tile"],
        interpret=True,
    )
    return np.asarray(out)


def _torch(c):
    max_q_len = int(np.max(np.diff(c["q_start"])))
    t = {n: torch.from_numpy(np.ascontiguousarray(c[n]))
         for n in ("q", "k", "v", "tables", "q_start", "q_len", "ctx_len")}
    out = pa.paged_attention_ragged(
        t["q"], t["k"], t["v"], t["tables"], t["q_start"], t["q_len"],
        t["ctx_len"], block_size=c["bs"], max_q_len=max_q_len,
    )
    return out.numpy()


def _check(c):
    want, got = _jax(c), _torch(c)
    assert np.isfinite(got).all(), "plain version leaked NaN/inf"
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    return got


@pytest.fixture(autouse=True)
def _counter_stays_zero():
    pa.reset_launches()
    yield
    # a CPU tensor never reaches the CUDA kernel
    assert pa.LAUNCHES == {"paged_attention_decode": 0,
                           "paged_attention_ragged": 0}


def test_mixed_ragged_batch():
    rows = [
        (1, 37, 1),    # decode, partial last block
        (4, 20, 1),    # spec window [k+1] with history
        (8, 8, 2),     # fresh prefill chunk
        (0, 0, 1),     # dead / freshly-reset seat
        (6, 50, 2),    # continuation chunk, partial tile tail
    ]
    c = _make_case(rows)
    out = _check(c)
    q_start = c["q_start"]
    assert np.all(out[q_start[3]:q_start[4]] == 0.0)
    # slots past q_len inside an allotment are exact zeros too
    assert np.all(out[q_start[4] + 6:q_start[5]] == 0.0)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_gqa_group_sizes(G):
    rows = [(1, 17, 1), (4, 4, 1), (5, 33, 2)]
    _check(_make_case(rows, G=G, KV=2, seed=G))


def test_partial_last_blocks():
    rows = [(1, 1, 1), (1, 15, 1), (3, 19, 1), (7, 31, 2)]
    _check(_make_case(rows, bs=16, seed=3))


def test_all_trash_rows():
    c = _make_case([(0, 0, 1)] * 4, seed=4)
    got = _torch(c)
    assert np.all(got == 0.0)
    np.testing.assert_array_equal(got, _jax(c))


def test_stale_table_tails_beyond_ctx():
    c = _make_case([(1, 20, 1), (4, 10, 1)], seed=5)
    nb = c["k"].shape[0]
    for r in range(c["tables"].shape[0]):
        used = (int(c["ctx_len"][r]) + c["bs"] - 1) // c["bs"]
        c["tables"][r, used:] = nb - 1
    c["k"][nb - 1] = np.nan
    c["v"][nb - 1] = np.nan
    _check(c)


@pytest.mark.parametrize("seq_lens", [[7, 33, 0, 16], [1, 1, 1, 1]])
def test_decode_matches_jax_decode(seq_lens):
    bs, W, B = 8, 8, 4
    KV, G, hd = 2, 4, 16
    H = KV * G
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    k = rng.standard_normal((1 + B * W, KV, bs, hd), dtype=np.float32)
    v = rng.standard_normal((1 + B * W, KV, bs, hd), dtype=np.float32)
    k[0] = np.nan
    v[0] = np.nan
    tables = np.stack([1 + b * W + np.arange(W) for b in range(B)]
                      ).astype(np.int32)
    lens = np.asarray(seq_lens, np.int32)
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), block_size=bs, interpret=True,
    ))
    got = pa.paged_attention_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lens), block_size=bs,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(got[lens == 0] == 0.0)


def test_decode_wrapper_matches_ragged():
    rng = np.random.default_rng(7)
    B, KV, G, hd, bs, W = 4, 2, 2, 32, 16, 4
    H = KV * G
    nb = 1 + B * W
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    k = torch.from_numpy(
        rng.standard_normal((nb, KV, bs, hd)).astype(np.float32))
    v = torch.from_numpy(
        rng.standard_normal((nb, KV, bs, hd)).astype(np.float32))
    tables = torch.from_numpy(
        1 + np.arange(B * W, dtype=np.int32).reshape(B, W))
    lens = torch.tensor([1, 17, 0, 64], dtype=torch.int32)
    dec = pa.paged_attention_decode(q, k, v, tables, lens, block_size=bs)
    rag = pa.paged_attention_ragged(
        q, k, v, tables, torch.arange(B + 1, dtype=torch.int32),
        (lens > 0).to(torch.int32), lens, block_size=bs, max_q_len=1,
    )
    torch.testing.assert_close(dec, rag, rtol=0, atol=0)
    assert torch.all(dec[2] == 0.0)


def test_bf16_plain_matches_f32_within_bf16_rounding():
    # the working type on a card: the plain version keeps f32 math inside
    c = _make_case([(1, 37, 1), (8, 40, 2)], seed=9)
    ref = _torch(c)
    t = {n: torch.from_numpy(np.ascontiguousarray(c[n]))
         for n in ("q", "k", "v", "tables", "q_start", "q_len", "ctx_len")}
    got = pa.paged_attention_ragged(
        t["q"].bfloat16(), t["k"].bfloat16(), t["v"].bfloat16(),
        t["tables"], t["q_start"], t["q_len"], t["ctx_len"],
        block_size=c["bs"], max_q_len=8,
    ).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2)
