"""Ragged paged attention of the PyTorch port: its plain version (what the
wrapper runs on a CPU tensor) against the JAX Pallas kernel in interpret
mode, on the same numpy inputs. Float32 throughout; the two compute the same
f32 softmax in a different order, so they agree to 1e-5.

The cases are those of tests/test_ragged_attention.py and
tests/test_paged_attention.py: mixed ragged batches, GQA group sizes, partial
last blocks, all-trash rows, stale table tails over a NaN-poisoned block 0,
and the decode wrapper equal to the ragged one. The quantized-KV branch
(int8 / fp8 pages with per-(slot, head) f32 scales) is held against the
Pallas kernel with ``k_scale``/``v_scale`` on both faces, with NaN scales
(and NaN fp8 pages) in the trash block and stale table tails, and against
the plain version run on the dequantized cache, bitwise."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.engine import quant as jq
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
    assert set(pa.LAUNCHES) >= {"paged_attention_decode",
                                "paged_attention_ragged"}
    assert all(n == 0 for n in pa.LAUNCHES.values())


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


# ------------------------- quantized-KV branch ----------------------------


def _quant_case(seed, kv_dtype, *, B=3, T=4, W=4, bs=16, KV=2, G=2, hd=32,
                partial=True):
    """A ragged case over per-token-quantized caches (quantized by the JAX
    package's numpy twin), poisoned the way a served cache is garbage: the
    trash block 0 and the stale tail block hold NaN scales and, for fp8, NaN
    pages too (int8 has no NaN). Row 0's table ends in the trash block and
    row 2's in the stale block, both past ctx_len."""
    rng = np.random.default_rng(seed)
    H = KV * G
    nb = 2 + B * W
    stale = nb - 1
    kc = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    vc = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    kq, ks = jq.kv_quantize_cache_np(kc, kv_dtype)
    vq, vs = jq.kv_quantize_cache_np(vc, kv_dtype)
    for blk in (0, stale):
        ks[blk] = np.nan
        vs[blk] = np.nan
        if kv_dtype == "fp8":
            kq[blk] = np.nan
            vq[blk] = np.nan
    tables = (1 + np.arange(B * W).reshape(B, W)).astype(np.int32)
    tables[0, W - 1] = 0
    tables[2, 2:] = stale
    q = rng.standard_normal((B * T, H, hd)).astype(np.float32)
    q_start = (np.arange(B + 1) * T).astype(np.int32)
    if partial:  # row 0 ends mid-block, row 1 dead, row 2 short
        ctx = np.array([bs * (W - 2) + 3, bs * W, bs + 5], np.int32)[:B]
        q_len = np.array([3, 0, T], np.int32)[:B]
    else:
        ctx = np.array([bs * (W - 1), bs * W, 2 * bs], np.int32)[:B]
        q_len = np.full((B,), T, np.int32)
    ctx = np.maximum(ctx, q_len)
    return dict(q=q, kq=kq, vq=vq, ks=ks, vs=vs, tables=tables,
                q_start=q_start, q_len=q_len, ctx=ctx, bs=bs, T=T,
                kv_dtype=kv_dtype)


def _t_pages(a, kv_dtype):
    """numpy quantized pages (ml_dtypes fp8 or int8) as a torch tensor."""
    if kv_dtype == "fp8":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _torch_quant_args(c):
    return (torch.from_numpy(c["q"]), _t_pages(c["kq"], c["kv_dtype"]),
            _t_pages(c["vq"], c["kv_dtype"]), torch.from_numpy(c["tables"]),
            torch.from_numpy(c["q_start"]), torch.from_numpy(c["q_len"]),
            torch.from_numpy(c["ctx"]))


@pytest.mark.parametrize("partial", [True, False])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_ragged_matches_pallas(kv_dtype, partial):
    c = _quant_case(7, kv_dtype, partial=partial)
    want = np.asarray(jax_ragged(
        jnp.asarray(c["q"]), jnp.asarray(c["kq"]), jnp.asarray(c["vq"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["q_start"]),
        jnp.asarray(c["q_len"]), jnp.asarray(c["ctx"]),
        block_size=c["bs"], max_q_len=c["T"], interpret=True,
        k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"]),
    ))
    got = pa.paged_attention_ragged(
        *_torch_quant_args(c), block_size=c["bs"], max_q_len=c["T"],
        k_scale=torch.from_numpy(c["ks"]), v_scale=torch.from_numpy(c["vs"]),
    ).numpy()
    assert np.isfinite(got).all(), "trash-block NaN leaked"
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if partial:
        T = c["T"]
        assert np.all(got[T:2 * T] == 0.0)          # dead row
        assert np.all(got[3:T] == 0.0)              # slots past q_len


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_decode_matches_pallas(kv_dtype):
    c = _quant_case(11, kv_dtype, B=3, T=1, W=3, partial=False)
    q = c["q"]
    lens = np.array([32, 0, 21], np.int32)  # row 0 stops before its trash
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(c["kq"]), jnp.asarray(c["vq"]),
        jnp.asarray(c["tables"]), jnp.asarray(lens), block_size=c["bs"],
        interpret=True, k_scale=jnp.asarray(c["ks"]),
        v_scale=jnp.asarray(c["vs"]),
    ))
    args = _torch_quant_args(c)
    got = pa.paged_attention_decode(
        args[0], args[1], args[2], args[3], torch.from_numpy(lens),
        block_size=c["bs"], k_scale=torch.from_numpy(c["ks"]),
        v_scale=torch.from_numpy(c["vs"]),
    ).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_plain_equals_dequantize_then_run(kv_dtype):
    """In-version dequant == the plain version on the dequantized cache
    (NaN mirrored into the same trash slots), bit for bit."""
    c = _quant_case(13, kv_dtype)
    q, kq, vq, tables, q_start, q_len, ctx = _torch_quant_args(c)
    ks, vs = torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"])
    kw = dict(block_size=c["bs"], max_q_len=c["T"])
    got = pa.paged_attention_ragged_plain(
        q, kq, vq, tables, q_start, q_len, ctx, k_scale=ks, v_scale=vs, **kw)
    k_ref = kq.float() * ks[..., None]
    v_ref = vq.float() * vs[..., None]
    want = pa.paged_attention_ragged_plain(
        q, k_ref, v_ref, tables, q_start, q_len, ctx, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_quantized_wrappers_refuse_bad_scales():
    c = _quant_case(17, "int8", hd=64)
    q, kq, vq, tables, q_start, q_len, ctx = _torch_quant_args(c)
    ks, vs = torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"])
    kw = dict(block_size=c["bs"], max_q_len=c["T"])
    with pytest.raises(ValueError, match="together"):
        pa.paged_attention_ragged(q, kq, vq, tables, q_start, q_len, ctx,
                                  k_scale=ks, **kw)
    with pytest.raises(ValueError, match="together"):
        pa.paged_attention_decode(q[:3], kq, vq, tables, ctx,
                                  block_size=c["bs"], v_scale=vs)
    kf, vf = kq.float().bfloat16(), vq.float().bfloat16()
    with pytest.raises(TypeError, match="scales given"):
        pa.paged_attention_ragged(q.bfloat16(), kf, vf, tables, q_start,
                                  q_len, ctx, k_scale=ks, v_scale=vs, **kw)
    with pytest.raises(TypeError, match="need k_scale"):
        pa.paged_attention_ragged(q, kq, vq, tables, q_start, q_len, ctx,
                                  **kw)
    with pytest.raises(ValueError, match="shape"):
        pa._check(q, kq, vq, tables, q_start, q_len, ctx, c["bs"], c["T"],
                  ks[:, :, :1].contiguous(), vs)
    with pytest.raises(TypeError, match="float32"):
        pa._check(q, kq, vq, tables, q_start, q_len, ctx, c["bs"], c["T"],
                  ks.double(), vs)
    # the kernel-side check takes the quantized case as it is
    pa._check(q, kq, vq, tables, q_start, q_len, ctx, c["bs"], c["T"],
              ks, vs)


# ------------------- the CUDA kernels' host-side contract ------------------


@pytest.mark.parametrize("B,KV,W,bs,n_sm,bps", [
    (16, 8, 512, 16, 132, 4),    # the main path's decode bucket
    (64, 8, 66, 16, 132, 4),
    (1, 8, 512, 16, 132, 5),
    (4, 2, 3, 16, 132, 4),       # fewer spans than the card could split
    (8, 8, 40, 24, 132, 3),      # bs that does not divide the chunk
    (8, 4, 2, 128, 132, 2),      # pages larger than the chunk
    (512, 8, 512, 16, 132, 4),   # more (row, head) pairs than blocks
])
def test_decode_grid_covers_the_table_from_host_shapes(B, KV, W, bs, n_sm,
                                                       bps):
    n_split, span = pa._decode_grid(B, KV, W, bs, n_sm, bps)
    assert span % bs == 0 and span % pa._CHUNK == 0
    n_spans = -(-(W * bs) // span)
    assert 1 <= n_split <= n_spans
    # one wave: never more blocks than the SMs hold, unless one split per
    # (row, KV head) is already too many
    assert n_split == 1 or n_split * B * KV <= n_sm * bps
    # split s owns the spans s, s + n_split, ...: every position of the
    # table belongs to exactly one split
    owners = (np.arange(W * bs) // span) % n_split
    assert set(owners.tolist()) == set(range(n_split))


def test_decode_grid_main_path_fills_two_waves_of_sms():
    n_split, span = pa._decode_grid(16, 8, 512, 16, 132, 4)
    assert (n_split, span) == (4, 64)
    # every split is live at ctx ~560 and the grid is >= 2 x 132 blocks
    assert all(s * span < 513 for s in range(n_split))
    assert n_split * 16 * 8 >= 2 * 132


def _kernel_split_positions(s, n_split, span, n_keys):
    """The key positions split ``s`` visits, as the decode kernel walks them
    (64-key chunks of the spans s, s + n_split, ...; stops at n_keys)."""
    cps, out, n = span // pa._CHUNK, [], 0
    while True:
        c0 = (s + (n // cps) * n_split) * span + (n % cps) * pa._CHUNK
        if c0 >= n_keys:
            return out
        out += [p for p in range(c0, c0 + pa._CHUNK) if p < n_keys]
        n += 1


@pytest.mark.parametrize("n_keys", [1, 63, 64, 65, 560, 4000, 8192])
def test_decode_splits_visit_every_live_key_once(n_keys):
    n_split, span = pa._decode_grid(16, 8, 512, 16, 132, 4)
    seen = [p for s in range(n_split)
            for p in _kernel_split_positions(s, n_split, span, n_keys)]
    assert sorted(seen) == list(range(n_keys))
    # the splits the combine counts as live are those that visit a key
    live = min(n_split, -(-n_keys // span))
    assert all(bool(_kernel_split_positions(s, n_split, span, n_keys))
               == (s < live) for s in range(n_split))


def test_decode_refuses_bad_seq_lens():
    B, KV, G, hd, bs, W = 4, 2, 2, 64, 16, 4
    q = torch.zeros(B, KV * G, hd)
    k = torch.zeros(1 + B * W, KV, bs, hd)
    tables = torch.arange(B * W, dtype=torch.int32).reshape(B, W) + 1
    lens = torch.tensor([1, 17, 0, 64], dtype=torch.int32)
    pa._check_decode(q, k, k, tables, lens, bs)  # the right ones pass
    with pytest.raises(TypeError, match="seq_lens must be int32"):
        pa._check_decode(q, k, k, tables, lens.long(), bs)
    with pytest.raises(ValueError, match="seq_lens"):
        pa._check_decode(q, k, k, tables, lens[:3].contiguous(), bs)
    with pytest.raises(ValueError, match="seq_lens"):
        pa._check_decode(q, k, k, tables, lens[:, None].contiguous(), bs)
    with pytest.raises(ValueError, match="contiguous"):
        pa._check_decode(q, k, k, tables,
                         torch.stack([lens, lens], 1)[:, 0], bs)
    with pytest.raises(ValueError, match="query heads per KV head"):
        pa._check_decode(torch.zeros(B, 17 * KV, hd), k, k, tables, lens,
                         bs)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _kernel_numerics(q, kc, vc, tables, q_start, q_len, ctx, bs, ks=None,
                     vs=None, chunk=64):
    """The bf16 kernels' arithmetic in f32 on the CPU: pages converted
    exactly, S = q . k in f32 times the K scale per key and 1/sqrt(hd),
    online softmax over 64-key chunks, the row sum of unrounded p, P times
    the V scale per key rounded to bf16 before PV, the output rounded to
    bf16 once. Keys past ctx_len are never touched."""
    Tq, H, hd = q.shape
    KV = kc.shape[1]
    G = H // KV
    out = torch.zeros(Tq, H, hd)
    for r in range(tables.shape[0]):
        ql, cl, s0 = int(q_len[r]), int(ctx[r]), int(q_start[r])
        if ql == 0:
            continue
        pos = torch.arange(cl)
        blk = tables[r].long()[pos // bs]
        for h in range(H):
            kvh = h // G
            k = kc[blk, kvh, pos % bs].float()
            v = vc[blk, kvh, pos % bs].float()
            ksc = ks[blk, kvh, pos % bs] if ks is not None else torch.ones(cl)
            vsc = vs[blk, kvh, pos % bs] if vs is not None else torch.ones(cl)
            for i in range(ql):
                last = cl - ql + i
                qi = q[s0 + i, h].float()
                m, l, o = -math.inf, 0.0, torch.zeros(hd)
                for c0 in range(0, last + 1, chunk):
                    c1 = min(c0 + chunk, last + 1)
                    s = (k[c0:c1] @ qi) * ksc[c0:c1] / math.sqrt(hd)
                    m_new = max(m, float(s.max()))
                    alpha = math.exp(m - m_new)
                    p = torch.exp(s - m_new)
                    l = l * alpha + float(p.sum())
                    o = o * alpha + _bf16(p * vsc[c0:c1]) @ v[c0:c1]
                    m = m_new
                out[s0 + i, h] = o / l
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_kernel_numerics_within_bf16_tolerance(kv_dtype):
    """P rounded to bf16 before PV, the V scale folded into P and the K
    scale applied to S columns keep the kernels within
    ``chip_smoke.TOL["bfloat16"]`` of the plain version, on a mixed ragged
    batch over NaN trash (block 0, stale tails, NaN trash scales)."""
    import chip_smoke

    atol, rtol = chip_smoke.TOL["bfloat16"]
    if kv_dtype is None:
        c = _make_case([(1, 37, 1), (5, 130, 2), (0, 0, 1), (8, 8, 2),
                        (3, 200, 1)], G=4, KV=2, W=16, seed=21)
        t = {n: torch.from_numpy(np.ascontiguousarray(c[n]))
             for n in ("q", "k", "v", "tables", "q_start", "q_len",
                       "ctx_len")}
        q, kc, vc = t["q"].bfloat16(), t["k"].bfloat16(), t["v"].bfloat16()
        args = (t["tables"], t["q_start"], t["q_len"], t["ctx_len"])
        bs, max_q_len, ks, vs = c["bs"], 8, None, None
    else:
        c = _quant_case(23, kv_dtype, B=3, T=8, W=8, hd=64)
        q, kc, vc, tables, q_start, q_len, ctx = _torch_quant_args(c)
        q = q.bfloat16()
        args = (tables, q_start, q_len, ctx)
        bs, max_q_len = c["bs"], c["T"]
        ks, vs = torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"])
    want = pa.paged_attention_ragged_plain(
        q, kc, vc, *args, block_size=bs, max_q_len=max_q_len, k_scale=ks,
        v_scale=vs).float()
    got = _kernel_numerics(q, kc, vc, *args, bs, ks, vs).float()
    assert torch.isfinite(got).all()
    excess = ((got - want).abs() - rtol * want.abs()).max().item()
    assert excess <= atol
    # the rounding of P is visible, yet inside the tolerance
    assert (got - want).abs().max().item() > 0
    live = torch.zeros(q.shape[0], dtype=torch.bool)
    for r in range(args[0].shape[0]):
        s0 = int(args[1][r])
        live[s0:s0 + int(args[2][r])] = True
    assert torch.all(got[~live] == 0)
