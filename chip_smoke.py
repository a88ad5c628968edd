#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, ``dynamo_tpu_torch``.

    python3 chip_smoke.py        # from the root of a checkout, on one H100

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``dynamo_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the card's name and power limit;
2. hold the paged-attention kernel against its plain PyTorch version on the
   card, in bf16 at Llama-3.2-1B attention shapes with block 0 poisoned with
   NaN, on both faces, and its quantized-KV branch (int8 and fp8 pages with
   per-(slot, head) f32 scales, NaN trash scales and NaN fp8 trash pages) at
   the main path's shapes and on a mixed ragged batch, and the ragged face
   at the spec engine's verify shape (16 rows x 5 queries over ~560 keys)
   in bf16, int8 and fp8; time the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention``
   over pre-gathered (dequantized) K/V (the ``library_ms`` yardstick; only
   this script calls it);
3. serve 16 concurrent greedy requests (ISL 512, OSL 64) through the port's
   engine at full Llama-3.2-1B width with random weights from a fixed seed,
   through the same API ``python -m dynamo_tpu_torch.run in=batch`` uses,
   three times: bf16, int8 weights + int8 KV, fp8 weights + fp8 KV. Each
   engine captures its decode windows as CUDA graphs at construction and
   serves the traffic at run-ahead depths 2 (the default), 1 and 2 again
   (TTFT, ITL, throughput, steady decode step, fetch syncs and the flight
   recorder's MFU and goodput for each); every decode window must be a
   graph replay and the stall watchdog's einsum rebuild must not fire. Each
   run shows that decode and prefill went through its kernel build and
   checks a probe step's logits against the einsum attention path; the
   quantized runs print their probe's divergence from the bf16 logits.
   ``[graph]`` lines hold each decode graph phase 3 replays (buckets 8 and
   16, greedy and stochastic) against the eager window on identical clones
   of cache and ctl: samples and ctl must be bitwise equal. Then a bf16
   ``spec_mode="ngram"`` engine (k=4, n-gram 1..3, the same weights) serves
   16 greedy requests whose prompts repeat a seeded 64-token segment 8
   times (ISL 512, OSL 64), and the bf16 engine serves them at depths 1 and
   2: a spec stream may part from a non-spec one only where the non-spec
   model's top-2 logit margin is under 1e-3 x |top logit| (each parting's
   margin is printed), every spec window must be a graph replay whose
   verify forward ran the ragged face, and ``[spec]`` lines give
   acceptance, tokens per seat per window, windows per request, TTFT, ITL,
   tok/s and the steady window against the non-spec runs; ``[graph]``
   lines hold each spec graph against the eager spec window (packed output
   and ctl with the history bitwise equal);
4. profile one decode window, eager and as the engine's graph replay, and
   one prefill chunk at the main path's shapes (wall time, device busy time
   and idle share, host kernel and graph launches, kernels on the device,
   attention share), for the bf16 and the int8 engine, and measure what
   quantized serving adds to a decode step: the bf16 copies of the 1-byte
   weights and the ``kv_quantize`` launches;
5. serve the bf16 engine of phase 3 over HTTP through ``run.run_http``
   (what ``python -m dynamo_tpu_torch.run in=http`` runs) with a seeded
   synthetic byte-level BPE tokenizer at Llama-3's layout (128,000 regular
   and 256 special tokens, written under ``build/``): completions served one
   at a time must give the text of ``decode`` of the engine's own ids, chat
   goes through the default template, 16 concurrent streams of phase 3's
   traffic end in ``[DONE]``, ``/metrics`` counts every request, a client
   that leaves mid-stream frees its sequence and KV blocks within a second,
   and both attention faces launch; ``[http]`` lines print HTTP vs direct
   TTFT, ITL and throughput and the encode time of a prompt;
6. serve the same weights through the distributed path, each entry point a
   process of its own: ``python -m dynamo_tpu_torch.runtime.store``, worker
   A (``python -m dynamo_tpu_torch.worker --model 1b``, seed 0) and
   ``python -m dynamo_tpu_torch.frontend --port 0``. Completions served one
   at a time must give phase 5's texts; only the worker may hold the GPU;
   phase 3's traffic goes through the three processes (``[dist]`` lines:
   TTFT, ITL and throughput beside phases 3 and 5, CPU time per token of
   each process, the codec's µs per streamed token); then worker B joins,
   both publish load metrics and serve under round robin. Worker B runs
   ``--spec-mode ngram`` with the control plane on (system server, a canary
   every second, the degradation watcher) and the frontends with their
   system servers: ``[control]`` lines show B's ``/health`` naming its
   canary, ``/live``, the ``engine_*`` gauges on B's ``/metrics`` after the
   traffic (decode MFU > 0, the ``spec_reject`` waste series), a
   degradation order written to ``planner/dynamo/degradation`` making the
   KV frontend answer tier 0 with 429 and tier 3 with 200 (and B's watcher
   meeting the ``spec_k`` clamp), and ``NO_DEGRADATION`` admitting tier 0
   again; then a second
   frontend, ``--router-mode kv``, joins the same store: of 4 groups of
   prompts sharing a 448-token prefix (28 blocks), each group's second
   request, sent one at a time, must land on the worker that served its
   first with >= 28 blocks matched (read from the frontend's
   ``router.select`` spans, ``build/dist/kv_spans.jsonl``), and 16
   concurrent shared-prefix streams go through each frontend (``[dist]``
   lines: TTFT and ITL under each sink, requests and cached prompt tokens
   per worker); worker A is SIGKILLed, once 8 in-process token streams
   have 64 tokens each, under 8 streams of 512 tokens, 4 through each
   frontend, that must all complete through migration (on the spec
   worker) while A's keys leave the store within the lease TTL + 1 s (the
   KV frontend's re-issues and A's breaker are printed); worker B leaves by
   ``POST /drain`` (exit 0, its keys gone) and both frontends exit 0 on
   SIGTERM. Both attention faces must have launched in worker A, the
   ragged face in worker B; their counts are the ``launches_dist`` of the
   ``kernels`` line.
   A ``[hash]`` line times the block hashes of one 512-token prompt. Child
   logs go to ``build/dist/``.

7. move KV (``[kvmove]`` lines), at Llama-3.2-1B width, bf16 unless said:
   (a) ``make_kv_ops`` gathers 32 random blocks of a random cache to pinned
   host memory and scatters them in place into 32 others, for bf16, int8
   and fp8 pages with their scales: bitwise equal to a plain host copy, the
   cache tensors keep their storage, and the decode face over the injected
   blocks agrees with its plain version; the bf16 gather + copy is timed;
   (b) a prefill engine and a decode engine on the card, joined by the
   device plane (``DevicePlane``, ``PrefillHandler``, ``DecodeHandler``),
   serve phase 3's traffic: every handoff moves one prompt's 16 MiB, every
   decode window is a graph replay over injected KV, both faces launch,
   and the streams meet ``check_parity`` against phase 3's engine (an
   eager rerun with its logits recorded); TTFT and ITL beside phase 3's,
   the plane's and the engine's extract times for one prompt; (e) a
   system server's ``POST /preempt`` makes the preemption coordinator
   evacuate 16 mid-stream seats to a co-resident peer engine (their
   streams go on there) and then 16 to the host tier (their re-admission
   prefills onboard the spilled blocks), each spliced stream held to
   ``check_parity``, with the report's counts and the kill-to-next-token
   time; then, after phase 6, across processes: the relay frame's host
   cost for one prompt, the ragged face at the shape of a prefill over an
   onboarded prompt against its plain version, (c) a ``--disagg-mode
   prefill --disagg-queue`` worker with a ``--disagg-mode decode`` worker,
   then one with ``--disagg-queue``, behind a frontend (TTFT and ITL beside
   phase 6's aggregated worker, the relay's spans), (d) a worker with
   ``--kvbm-host-blocks`` and a G3 directory serves phase 6's shared-prefix
   groups, its G1 is cleared and the second pass onboards from the host
   tier (onboarded blocks, prefix hit tokens, ragged launches over the
   onboarded prefix, both passes' TTFT), and (e) ``POST /preempt`` on that
   worker spills 8 mid-stream seats to its host tier and it drains and
   exits 0.

``[time]`` lines give each phase's time. The line before the last is the
card's ``nvidia-smi`` name and power limit, the line before that the
``kernels`` JSON object (launches include those that graph replays made;
its last row is the ragged face at the spec-verify shape, launched by the
spec run's verify windows);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16, published
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
# kernel vs plain, (atol, rtol) per dtype. bf16: the ragged face rounds P
# to bf16 before PV (as the einsum path and the JAX package's bf16 path do),
# so each term of PV carries a relative error <= 2^-9 while the sums stay in
# f32; the output then rounds once to bf16, in another summation order than
# the plain version's, and may land on the neighbouring bf16 value: 2^-7
# relative (~0.008 at |o| ~ 1, ~0.016 at 2 <= |o| < 4). The decode face
# keeps p in f32. f32: only the summation order differs.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 0.0)}
SEED = 0
DEV = "cuda"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DECODE_CASE = "main path decode B=16 ctx 513..576 W=512"
PREFILL_CASE = "main path prefill R=1 T=512 q_len=512 ctx 512 W=32"
# the spec engine's verify window: 16 rows of k + 1 = 5 queries over ~560
# keys, the ragged face at a shape the decode graphs never give it
SPEC_CASE = "spec verify R=16 q_len=5 ctx 518..581 W=512"
SPEC_ROWS = [(5, 518 + (37 * i) % 64, 5) for i in range(16)]


# ------------------------------ phase 1 ----------------------------------


def phase_build() -> None:
    from dynamo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"[build] {len(took)} source(s) in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{n} {s:.2f} s" for n, s in took.items()), flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"[build] {name}: {line.strip()}")


# ------------------------------ phase 2 ----------------------------------


def make_case(name, rows, *, W, face, bs=16, KV=8, G=4, hd=64, seed=SEED,
              dtype="bfloat16", kv_dtype=None):
    """A case on the card (bf16 unless ``dtype`` says otherwise).
    ``rows`` = [(q_len, ctx_len, allotment)].
    Each row's blocks are distinct and drawn at random from the pool; block
    0 (trash) and every table entry past a row's context are NaN-filled
    pages, so a key read past ctx_len would poison the output. With
    ``kv_dtype`` ("int8" | "fp8") the pages are quantized per (slot, head)
    by the port's ``kv_quantize``, and the poisoned slots get NaN scales
    (and, for fp8, NaN pages: int8 has no NaN)."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    H = KV * G
    q_start = [0]
    for _, _, alloc in rows:
        q_start.append(q_start[-1] + alloc)
    Tq = q_start[-1]
    need = [-(-cl // bs) for _, cl, _ in rows]
    nb = 2 + sum(need)
    perm = torch.randperm(nb - 2, generator=gen, device=DEV) + 1
    nan_block = nb - 1
    tables = torch.full((len(rows), W), nan_block, dtype=torch.int32,
                        device=DEV)
    off = 0
    for r, n in enumerate(need):
        tables[r, :n] = perm[off:off + n].to(torch.int32)
        off += n
        if n < W:
            tables[r, -1] = 0  # a stale tail on the trash block itself
    kw = dict(generator=gen, device=DEV, dtype=torch.float32)
    dt = getattr(torch, dtype)
    q = torch.randn(Tq, H, hd, **kw).to(dt)
    k = torch.randn(nb, KV, bs, hd, **kw).to(dt)
    v = torch.randn(nb, KV, bs, hd, **kw).to(dt)
    scales = {}
    if kv_dtype is not None:
        from dynamo_tpu_torch.engine import quant

        for key, cache in (("k", k), ("v", v)):
            pages, sc = quant.kv_quantize(cache.reshape(-1, 1, hd), kv_dtype)
            scales[key] = sc.reshape(nb, KV, bs).contiguous()
            if key == "k":
                k = pages.reshape(nb, KV, bs, hd)
            else:
                v = pages.reshape(nb, KV, bs, hd)
    for key, cache in (("k", k), ("v", v)):
        # poisoned slots: [block] or [block, :, offset:]
        poison = [(0,), (nan_block,)] + [
            (tables[r, cl // bs].item(), slice(None), slice(cl % bs, None))
            for r, (_, cl, _) in enumerate(rows) if cl % bs]
        for idx in poison:
            if kv_dtype is None:
                cache[idx] = float("nan")
                continue
            scales[key][idx] = float("nan")
            if kv_dtype == "fp8":
                cache.view(torch.uint8)[idx] = 0x7F  # e4m3fn NaN
    i32 = dict(dtype=torch.int32, device=DEV)
    lib_kv = {}
    if kv_dtype is not None:  # the library call's dequantized bf16 pages
        from dynamo_tpu_torch.engine import quant

        lib_kv = {key: quant.kv_dequantize(pages, scales[key], dt)
                  for key, pages in (("k", k), ("v", v))}
    return dict(
        name=name, face=face, bs=bs, W=W, H=H, KV=KV, hd=hd, dtype=dtype,
        kv_dtype=kv_dtype, k_scale=scales.get("k"), v_scale=scales.get("v"),
        lib_k=lib_kv.get("k", k), lib_v=lib_kv.get("v", v),
        q=q, k=k, v=v, tables=tables,
        q_start=torch.tensor(q_start, **i32),
        q_len=torch.tensor([r[0] for r in rows], **i32),
        ctx_len=torch.tensor([r[1] for r in rows], **i32),
        rows=rows, max_q_len=max(r[2] for r in rows),
    )


def case_bound(c):
    """Least time on an H100 for this call's work, counting what its data
    needs: live queries read once, each row's visible K/V pages once per KV
    head (quantized: 1 byte per element plus a 4-byte scale per slot and
    head), the output written once; 4 flops per (query head, visible key,
    dim) (QK^T and PV) at the card's peak for the query's type."""
    H, KV, hd = c["H"], c["KV"], c["hd"]
    es = c["q"].element_size()
    # bytes per (slot, KV head) of one of K or V
    slot_bytes = hd * c["k"].element_size() + (
        4 if c["kv_dtype"] is not None else 0)
    nbytes = c["q"].shape[0] * H * hd * es  # the output
    flops = 0
    for ql, cl, _ in c["rows"]:
        if ql == 0:
            continue
        nbytes += ql * H * hd * es + cl * KV * slot_bytes * 2
        # query i sees cl - ql + i + 1 keys
        seen = ql * (cl - ql) + ql * (ql + 1) // 2
        flops += 4 * seen * H * hd
    nbytes += c["tables"].numel() * 4 + 3 * len(c["rows"]) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS_PER_S if c["dtype"] == "bfloat16" else F32_FLOPS_PER_S
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def run_face(c, plain: bool):
    from dynamo_tpu_torch.ops import paged_attention as pa

    sc = dict(k_scale=c["k_scale"], v_scale=c["v_scale"])
    if c["face"] == "decode":
        if plain:
            return pa.paged_attention_ragged_plain(
                c["q"], c["k"], c["v"], c["tables"], c["q_start"],
                c["q_len"], c["ctx_len"], block_size=c["bs"], max_q_len=1,
                **sc)
        return pa.paged_attention_decode(
            c["q"], c["k"], c["v"], c["tables"], c["ctx_len"],
            block_size=c["bs"], **sc)
    fn = pa.paged_attention_ragged_plain if plain else \
        pa.paged_attention_ragged
    return fn(c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["q_len"],
              c["ctx_len"], block_size=c["bs"], max_q_len=c["max_q_len"],
              **sc)


def library_call(c):
    """``scaled_dot_product_attention`` over K/V gathered (and, for
    quantized pages, dequantized to bf16) beforehand, for a batch whose
    rows share one query count (None otherwise)."""
    import torch
    import torch.nn.functional as F

    qls = {ql for ql, _, _ in c["rows"]}
    if len(qls) != 1 and c["face"] != "decode":
        return None
    ql = 1 if c["face"] == "decode" else qls.pop()
    R = len(c["rows"])
    bs, KV, hd, H = c["bs"], c["KV"], c["hd"], c["H"]
    S = max(cl for _, cl, _ in c["rows"])
    nblk = -(-S // bs)
    tab = c["tables"][:, :nblk].long()
    k = c["lib_k"][tab].permute(0, 2, 1, 3, 4).reshape(R, KV, nblk * bs, hd)
    v = c["lib_v"][tab].permute(0, 2, 1, 3, 4).reshape(R, KV, nblk * bs, hd)
    k = torch.nan_to_num(k[:, :, :S]).contiguous()
    v = torch.nan_to_num(v[:, :, :S]).contiguous()
    q = torch.stack([
        c["q"][int(c["q_start"][r]):int(c["q_start"][r]) + ql]
        for r in range(R)
    ]).transpose(1, 2).contiguous()                      # [R, H, ql, hd]
    ctx = c["ctx_len"].long()
    kpos = torch.arange(S, device=DEV)
    qpos = (ctx[:, None] - ql) + torch.arange(ql, device=DEV)[None, :]
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & \
        (kpos[None, None, :] < ctx[:, None, None])
    mask = mask[:, None]                                 # [R, 1, ql, S]

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return call


def device_ms(fn, reps: int = 20) -> float:
    """Summed device time of the kernels one call of ``fn`` launches, mean
    over ``reps`` calls, from ``torch.profiler``. Before each call a 256 MB
    device-to-device copy evicts the 50 MB L2, as in serving, where a
    layer's K/V is cold; the copies are not counted."""
    import torch
    from torch.autograd import DeviceType

    src = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()

    def body():
        dst.copy_(src)
        fn()
    events = profile_calls(body, reps, cpu=False)
    return sum(_device_us(e) for e in events
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))) / reps / 1e3


def profile_calls(body, reps: int, cpu: bool = True):
    """``key_averages()`` of ``torch.profiler`` around ``reps`` calls of
    ``body``. A profile now and then comes back without device events:
    the first of three that has them is taken."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for _ in range(3):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                body()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(_device_us(e) > 0 for e in events
               if e.device_type == DeviceType.CUDA):
            return events
    fail("torch.profiler recorded no device time")


def kernel_cases():
    import torch

    gen = torch.Generator().manual_seed(SEED)
    lens = torch.randint(1, 1025, (64,), generator=gen).tolist()
    for dead in (3, 17, 40, 63):
        lens[dead] = 0
    # long contexts: 16 rows over 4,000-8,192 keys, one row at ctx 1 and
    # one dead row (many splits, empty splits, a one-key split)
    long_lens = [4000 + (4192 * i) // 15 for i in range(16)]
    long_lens[5], long_lens[11] = 1, 0
    long_rows = [(1 if n else 0, n, 1) for n in long_lens]
    cases = [
        make_case("decode B=64 ctx 1..1024, 4 dead rows",
                  [(1 if n else 0, n, 1) for n in lens], W=66,
                  face="decode"),
        make_case("ragged R=1 T=512 q_len=300 prior ctx 0",
                  [(300, 300, 512)], W=64, face="ragged"),
        make_case("ragged R=1 T=512 q_len=300 prior ctx 512",
                  [(300, 812, 512)], W=64, face="ragged"),
        make_case("ragged mixed R=6",
                  [(1, 577, 1), (5, 40, 8), (64, 64, 64), (0, 0, 8),
                   (130, 1000, 136), (17, 17, 24)], W=66, face="ragged"),
        # the shapes the engine phase gives the kernel: decode bucket 16
        # over the full autopilot table (max_model_len 8192 / bs 16), and
        # one 512-token prefill chunk of a fresh prompt
        make_case(DECODE_CASE,
                  [(1, 513 + (37 * i) % 64, 1) for i in range(16)],
                  W=512, face="decode"),
        make_case(PREFILL_CASE, [(512, 512, 512)], W=32, face="ragged"),
        make_case(SPEC_CASE, SPEC_ROWS, W=512, face="ragged"),
        # the kernels' other builds: head dim 128 (Llama-3-8B heads) and f32
        make_case("ragged mixed hd=128 R=3",
                  [(1, 300, 1), (40, 240, 48), (0, 0, 8)], W=20,
                  face="ragged", hd=128),
        make_case("decode hd=128 B=4 ctx 1..300, 1 dead row",
                  [(1, 300, 1), (1, 1, 1), (0, 0, 1), (1, 129, 1)], W=20,
                  face="decode", hd=128),
        make_case("ragged mixed f32 R=3",
                  [(1, 300, 1), (40, 240, 48), (0, 0, 8)], W=20,
                  face="ragged", dtype="float32"),
        make_case("decode f32 B=4 ctx 1..300, 1 dead row",
                  [(1, 300, 1), (1, 1, 1), (0, 0, 1), (1, 129, 1)], W=20,
                  face="decode", dtype="float32"),
    ]
    for kv in (None, "int8"):
        sfx = "" if kv is None else f" {kv}"
        cases += [
            make_case(f"decode B=16 ctx 4000..8192, ctx 1 + dead row, "
                      f"W=512{sfx}", long_rows, W=512, face="decode",
                      kv_dtype=kv),
            # a 512-token chunk of a long prompt
            make_case(f"ragged R=1 q_len=512 after 3584 keys, W=256{sfx}",
                      [(512, 4096, 512)], W=256, face="ragged",
                      kv_dtype=kv),
        ]
    # the quantized-KV branch: the main path's two shapes and a mixed
    # ragged batch (stale tails, dead rows, NaN trash scales and pages)
    for kv in ("int8", "fp8"):
        cases += [
            make_case(f"{DECODE_CASE} {kv}",
                      [(1, 513 + (37 * i) % 64, 1) for i in range(16)],
                      W=512, face="decode", kv_dtype=kv),
            make_case(f"{PREFILL_CASE} {kv}", [(512, 512, 512)], W=32,
                      face="ragged", kv_dtype=kv),
            make_case(f"{SPEC_CASE} {kv}", SPEC_ROWS, W=512, face="ragged",
                      kv_dtype=kv),
            make_case(f"ragged mixed R=6 {kv}",
                      [(1, 577, 1), (5, 40, 8), (64, 64, 64), (0, 0, 8),
                       (130, 1000, 136), (17, 17, 24)], W=66,
                      face="ragged", kv_dtype=kv),
        ]
    return cases


def check_case(c):
    """Kernel vs plain on the card: finite, within TOL, exact zeros past
    q_len and on dead rows. Returns max |kernel - plain|."""
    import torch

    got = run_face(c, plain=False)
    torch.cuda.synchronize()
    want = run_face(c, plain=True)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{c['name']}: kernel output not finite (trash leak)")
    atol, rtol = TOL[c["dtype"]]
    err = (got.float() - want.float()).abs()
    excess = (err - rtol * want.float().abs()).max().item()
    max_err = err.max().item()
    if excess > atol:
        fail(f"{c['name']}: max |kernel - plain| {max_err} "
             f"(atol {atol} + rtol {rtol})")
    # rows and slots with no valid query must be exact zeros
    q_start = c["q_start"].tolist()
    for r, (ql, _, alloc) in enumerate(c["rows"]):
        tail = got[q_start[r] + ql:q_start[r] + alloc]
        if tail.numel() and not torch.all(tail == 0):
            fail(f"{c['name']}: row {r} slots past q_len not zero")
    return max_err


def phase_kernels(cases):
    results = {}
    for c in cases:
        max_err = check_case(c)
        ms = device_ms(lambda: run_face(c, plain=False))
        wall_ms = cuda_ms(lambda: run_face(c, plain=False), iters=50)
        plain_ms = cuda_ms(lambda: run_face(c, plain=True), iters=5,
                           warmup=1)
        lib = library_call(c)
        lib_ms = device_ms(lib) if lib is not None else None
        lib_wall = cuda_ms(lib, iters=50) if lib is not None else None
        bound_ms, bound_by = case_bound(c)
        results[c["name"]] = dict(
            face=c["face"], dtype=c["dtype"], kv_dtype=c["kv_dtype"],
            max_abs_err=max_err, ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
            library_ms=lib_ms, library_wall_ms=lib_wall, bound_ms=bound_ms,
            bound_by=bound_by,
        )
        sdpa = ("n/a" if lib_ms is None else
                f"{lib_ms:.4f} ms (wall per call {lib_wall:.4f} ms)")
        print(f"[kernel] {c['name']}: max_abs_err {max_err:.3e} kernel "
              f"{ms:.4f} ms (wall per call {wall_ms:.4f} ms) plain "
              f"{plain_ms:.4f} ms sdpa {sdpa} bound {bound_ms:.5f} ms "
              f"({bound_by})", flush=True)
    return results


# ------------------------------ phase 3 ----------------------------------

N_REQUESTS, ISL, OSL = 16, 512, 64
# kernel path vs einsum path logits on one probe prompt, both bf16: both
# round softmax probabilities to bf16 before P@V (as the JAX reference
# does), but sum in other orders and the kernel rounds after scaling by the
# running max, so the two drift by bf16 rounding through 16 layers; random-weight logits are ~N(0, 1) and the
# top two of 128256 sit ~0.2 apart
PROBE_MAX_DIFF, PROBE_MIN_ARGMAX_AGREE = 0.5, 0.75
# run-ahead depths phase 3 serves at, in turns: the default (whose first
# run is the main path the kernels line counts), the synchronous loop, the
# default again
DEPTHS = (2, 1, 2)


def depth_stats(tag: str, cfg, outs, stamps, wall: float, obs: dict,
                n: dict) -> dict:
    """Check one phase-3 run's streams; print and return its TTFT, ITL,
    throughput, steady decode step, fetch syncs and flight-recorder
    gauges."""
    for i, out in enumerate(outs):
        if len(out) != OSL:
            fail(f"request {i} returned {len(out)} tokens, expected {OSL}")
        if not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"request {i} returned an out-of-range token id")
    ttft = sorted(times[0] - t_sub for t_sub, times in stamps)
    itl = [(times[-1] - times[0]) / (len(times) - 1)
           for _, times in stamps]
    last_first = max(times[0] for _, times in stamps)
    steady = sorted(b - a for _, times in stamps
                    for a, b in zip(times, times[1:]) if a >= last_first)
    n_out = sum(len(o) for o in outs)
    stats = dict(ttft_p50=ttft[len(ttft) // 2], ttft_max=ttft[-1],
                 itl_p50=sorted(itl)[len(itl) // 2], tok_s=n_out / wall)
    print(f"{tag} {N_REQUESTS} requests ISL {ISL} OSL {OSL} "
          f"in {wall:.3f} s: output {n_out / wall:.1f} tok/s, TTFT mean "
          f"{sum(ttft) / len(ttft) * 1e3:.1f} ms p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms, "
          f"ITL mean {sum(itl) / len(itl) * 1e3:.2f} ms p50 "
          f"{stats['itl_p50'] * 1e3:.2f} ms, decode step once every "
          f"prompt is in (p50) {steady[len(steady) // 2] * 1e3:.2f} ms, "
          f"{n['windows']} decode windows ({n['replays']} graph replays), "
          f"{n['prefills']} prefill dispatches, {n['syncs']} fetch syncs "
          f"for {n['steps']} landed batches "
          f"({n['syncs'] / max(1, n['steps']):.2f} per batch); flight "
          f"recorder: mfu_decode {obs['mfu_decode']:.5f} mfu_prefill "
          f"{obs['mfu_prefill']:.5f} mfu {obs['mfu']:.5f} goodput "
          f"{obs['goodput_tok_s']:.1f} tok/s over "
          f"{obs['window_s']:.2f} s", flush=True)
    return stats


def main_prompts(vocab: int):
    """Phase 3's traffic: N_REQUESTS random prompts of ISL tokens."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 1)
    return [torch.randint(1, vocab, (ISL,), generator=gen).tolist()
            for _ in range(N_REQUESTS)]


def phase_engine(card: str, dtype: str = "bf16", ref_logits=None):
    """Serve N_REQUESTS concurrent greedy requests through the engine API
    ``run.py in=batch`` uses, at full Llama-3.2-1B width, with weights and
    KV in ``dtype`` ("bf16" | "int8" | "fp8"). Returns the kernel launch
    counts of that run, the engine, the probe's kernel-path logits and the
    run's TTFT/ITL/throughput; ``ref_logits`` (the bf16 run's) are compared
    with a quantized run's."""
    import asyncio

    import torch
    from dynamo_tpu_torch.engine import (
        EngineConfig, InferenceEngine, ModelConfig,
    )
    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.runtime.context import Context

    cfg = ModelConfig.llama3_1b()
    quant = dict(weight_dtype=dtype, kv_dtype=dtype)
    tag = "[engine]" if dtype == "bf16" else f"[engine {dtype}/{dtype}]"
    t0 = time.perf_counter()
    # cuda by default; quantized weights are quantized from the same random
    # bf16 weights as the bf16 run's (same seed)
    engine = InferenceEngine(cfg, EngineConfig(**quant), seed=SEED)
    torch.cuda.synchronize()
    print(f"{tag} Llama-3.2-1B random weights (seed {SEED}), weights and "
          f"KV {dtype}, on {engine.device} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompts = main_prompts(cfg.vocab_size)

    async def one(token_ids, max_tokens, stamps):
        req = {"token_ids": token_ids, "max_tokens": max_tokens,
               "temperature": 0.0}
        t_sub = time.perf_counter()
        out, times = [], []
        async for o in engine.generate(req, Context()):
            out.extend(o["token_ids"])
            times.append(time.perf_counter())
        stamps.append((t_sub, times))
        return out

    async def serve(depth):
        """One run of the traffic at run-ahead ``depth``, prefix cache
        cleared, recorder reset after a warm-up request."""
        engine.pipeline_depth = depth
        engine.clear_kv_blocks()
        await engine.start()
        warm = []  # first launches, cuBLAS handles: not measured
        await one(prompts[0][:32], 4, warm)
        torch.cuda.synchronize()
        engine.clear_kv_blocks()
        engine.mark_obs_warmup_done()
        pa.reset_launches()
        before = counters()
        stamps = []
        t_start = time.perf_counter()
        outs = await asyncio.gather(*(one(p, OSL, stamps) for p in prompts))
        wall = time.perf_counter() - t_start
        launches = dict(pa.LAUNCHES)
        obs = engine.obs_snapshot()
        await engine.stop()
        after = counters()
        return (outs, stamps, wall, launches, obs,
                {k: after[k] - before[k] for k in after})

    def counters():
        return dict(windows=engine.num_windows,
                    replays=engine._ap_window_fn.replays,
                    syncs=engine.num_fetch_syncs, steps=engine.num_steps,
                    prefills=engine.num_prefill_dispatches)

    graphs = engine._ap_window_fn
    print(f"{tag} {len(graphs.capture_s)} decode graphs captured at "
          f"construction (buckets {engine.config.decode_buckets} x "
          f"greedy/stochastic): {sum(graphs.capture_s.values()):.2f} s",
          flush=True)
    for i, depth in enumerate(DEPTHS):
        outs, stamps, wall, launches, obs, n = asyncio.run(serve(depth))
        stats = depth_stats(f"{tag} {card}: pipeline_depth={depth}:",
                            cfg, outs, stamps, wall, obs, n)
        if n["replays"] != n["windows"]:
            fail(f"{n['windows'] - n['replays']} decode windows ran "
                 f"eagerly on the card (depth {depth})")
        if engine.num_einsum_rebuilds:
            fail("the stall watchdog rebuilt the decode window on einsum")
        if i == 0:
            # the default depth's first run is the main path
            main_launches, main_stats = launches, stats
    launches, stats = main_launches, main_stats
    # the counters of this run's kernel build (quantized pages count apart)
    suffix = "" if dtype == "bf16" else f"_{dtype}"
    launches = {name: launches[name] for name in (
        f"paged_attention_decode{suffix}", f"paged_attention_ragged{suffix}")}
    for name, n in launches.items():
        print(f"{tag} {name} launches in the served run (depth "
              f"{DEPTHS[0]}, graph replays counted): {n}")
        if n == 0:
            fail(f"{name} was never launched on the main path")

    # probe: logits of one prompt chunk through both attention impls
    probe_eng = EngineConfig(num_blocks=8, **quant)
    dev = engine.device
    toks = torch.tensor([prompts[1][:64]], dtype=torch.int32, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev)[None]
    tables = torch.arange(1, 5, dtype=torch.int32, device=dev)[None]
    logits = {}
    for impl in ("kernel", "einsum"):
        e = dataclasses.replace(probe_eng, attention_impl=impl)
        cache = model_lib.init_cache(cfg, e, engine.device)
        _, h = model_lib.forward(cfg, e, engine.params, cache, toks, pos,
                                 tables)
        logits[impl] = model_lib.logits_fn(cfg, engine.params, h)[0]
    torch.cuda.synchronize()
    for impl, lg in logits.items():
        if lg.shape != (64, cfg.vocab_size) or not torch.isfinite(lg).all():
            fail(f"probe logits ({impl}) not finite or misshapen")
    diff = (logits["kernel"] - logits["einsum"]).abs().max().item()
    agree = (logits["kernel"].argmax(-1) == logits["einsum"].argmax(-1)) \
        .float().mean().item()
    print(f"{tag} probe logits finite; kernel vs einsum path max |diff| "
          f"{diff:.4f}, argmax agreement {agree:.3f}", flush=True)
    if diff > PROBE_MAX_DIFF or agree < PROBE_MIN_ARGMAX_AGREE:
        fail(f"probe ({dtype}): kernel path disagrees with the einsum path "
             f"({diff} > {PROBE_MAX_DIFF} or {agree} < "
             f"{PROBE_MIN_ARGMAX_AGREE})")
    if ref_logits is not None:
        qdiff = (logits["kernel"] - ref_logits).abs()
        qagree = (logits["kernel"].argmax(-1) == ref_logits.argmax(-1)) \
            .float().mean().item()
        print(f"{tag} probe logits vs the bf16 run's: max |diff| "
              f"{qdiff.max().item():.4f}, mean |diff| "
              f"{qdiff.mean().item():.4f}, argmax agreement {qagree:.3f}",
              flush=True)
    return launches, engine, logits["kernel"], stats


GRAPH_BUCKETS = (8, 16)   # the decode buckets phase 3 runs (16 requests)


def seat(ctl, B: int, ctx0: int, max_len: int, sampled: bool = False):
    """Put B live seats into ``ctl`` in place: seat s decodes at position
    ctx0 + s over its own 40 blocks; with ``sampled`` the odd seats sample
    (temperature 0.8, top-k 40 or top-p 0.9, seeded or on the engine's
    key), the even ones stay greedy."""
    import torch

    for s in range(B):
        ctl["pos"][s] = ctx0 + s
        ctl["vu"][s] = max_len
        ctl["tables"][s, :40] = torch.arange(1 + 40 * s, 1 + 40 * (s + 1))
        odd = sampled and s % 2 == 1
        ctl["temp"][s] = 0.8 if odd else 0.0
        ctl["tk"][s] = 40 if odd and s % 4 == 1 else 0
        ctl["tp"][s] = 0.9 if odd and s % 4 == 3 else 1.0
        ctl["seed"][s] = 1000 + s if s % 3 else -1


def phase_graph(engine, card: str) -> None:
    """[graph]: each decode graph phase 3 replays (buckets 8 and 16,
    greedy and stochastic) against the eager window on identical clones of
    cache and ctl. Samples and ctl must be equal bit for bit; the cache's
    largest difference is printed (the same kernels run in the same order,
    so it should be 0). Prints each graph's capture time and the graphs'
    pool. The engine's cache and ctl are put back afterwards."""
    import torch

    window = engine._ap_window_fn
    eng = engine.config

    def clone(tree):
        return {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone()) for k, v in tree.items()}

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    saved_ctl, saved_cache = clone(engine._ctl), clone(engine.cache)
    for B in GRAPH_BUCKETS:
        for stochastic in (False, True):
            for k, v in saved_ctl.items():
                engine._ctl[k].copy_(v)
            seat(engine._ctl, B, 560, eng.max_model_len, sampled=stochastic)
            ctl_e, cache_e = clone(engine._ctl), clone(engine.cache)
            cols = list(range(B))
            _, _, want = window.raw(
                engine.params, cache_e, ctl_e,
                torch.tensor(cols, dtype=torch.int32, device=engine.device),
                stochastic)
            _, _, got = window(engine.params, engine.cache, engine._ctl,
                               window.load_rows(cols), stochastic)
            got = got.clone()
            torch.cuda.synchronize()
            same_samples = torch.equal(want, got)
            same_ctl = all(torch.equal(bits(ctl_e[k]), bits(engine._ctl[k]))
                           for k in ctl_e)
            diff = max((a.float() - b.float()).abs().max().item()
                       for key in cache_e
                       for a, b in zip(cache_e[key], engine.cache[key]))
            bitwise = all(torch.equal(bits(a), bits(b)) for key in cache_e
                          for a, b in zip(cache_e[key], engine.cache[key]))
            print(f"[graph] {card}: B={B} stochastic={stochastic} weights "
                  f"{eng.weight_dtype} KV {eng.kv_dtype}: replay vs eager "
                  f"samples equal {same_samples}, ctl bitwise equal "
                  f"{same_ctl}, cache max |diff| {diff:.3e} (bitwise "
                  f"{bitwise}); captured in "
                  f"{window.capture_s['decode', B, stochastic] * 1e3:.1f} "
                  f"ms",
                  flush=True)
            if not (same_samples and same_ctl):
                fail(f"decode graph B={B} stochastic={stochastic} "
                     "disagrees with the eager window")
    for k, v in saved_ctl.items():
        engine._ctl[k].copy_(v)
    for key, layers in saved_cache.items():
        for dst, src in zip(engine.cache[key], layers):
            dst.copy_(src)
    torch.cuda.synchronize()
    print(f"[graph] {card}: {len(window.capture_s)} graphs in one pool of "
          f"{window.pool_bytes() / 2**20:.1f} MiB; device memory reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)


# ------------------------- phase 3: spec decode ---------------------------

SPEC_K, SPEC_NGRAM = 4, (1, 3)
SPEC_SEGMENT = 64          # a seeded segment, repeated ISL / 64 times
# Parity of the spec engine's bf16 streams with the non-spec engine's: a
# spec stream may part from the non-spec one only at a near-tie of the
# non-spec run's own logits (read from a rerun whose decode windows run
# eagerly, bitwise the graphs). The limit is 2^-5 x |top logit|, eight
# bf16 steps of the top logit: the two paths round differently (the spec
# window's GEMMs see M=80 rows, the decode window's 16; the ragged face
# rounds P to bf16, the decode face keeps it in f32), and the hidden state
# is rounded to bf16 after each of the 32 residual adds, so their logits
# differ by about a percent of the top one. A wrong acceptance lands a
# token whose logit sits far below the top (random logits have unit
# scale, the top ~4.5). Each parting also shows whether it meets 1e-3 x
# |top logit|, a bound under bf16's own step (2^-8).
PARITY_MARGIN = 2.0 ** -5
PARITY_FINE = 1e-3
PARITY_TOPK = 8


def spec_prompts(vocab: int):
    """Phase 3's spec traffic: per request a seeded 64-token segment
    repeated to ISL tokens, the copy-heavy input of editing and summarising
    traffic."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 8)
    return [torch.randint(1, vocab, (SPEC_SEGMENT,), generator=gen).tolist()
            * (ISL // SPEC_SEGMENT) for _ in range(N_REQUESTS)]


def serve_batch(engine, prompts, max_tokens, after_warmup=None):
    """Serve ``prompts`` concurrently (greedy) through ``engine.generate``
    after a short warm-up request (then ``after_warmup()`` runs); returns
    (streams, per-request (submit, token times), wall s, decode-only batch
    times s of the synchronous loop)."""
    import asyncio

    from dynamo_tpu_torch.runtime.context import Context

    batch_s = []
    orig = engine._execute_batch

    def timed(batch):
        t0 = time.perf_counter()
        out = orig(batch)
        if not batch.prefills:
            batch_s.append(time.perf_counter() - t0)
        return out

    async def one(token_ids, stamps, n=max_tokens):
        t_sub = time.perf_counter()
        out, times = [], []
        async for o in engine.generate(
                {"token_ids": token_ids, "max_tokens": n,
                 "temperature": 0.0}, Context()):
            out.extend(o["token_ids"])
            times.append(time.perf_counter())
        stamps.append((t_sub, times))
        return out

    async def run():
        await engine.start()
        await one(prompts[0][:32], [], 4)   # warm-up, not measured
        engine.clear_kv_blocks()
        engine.mark_obs_warmup_done()
        if after_warmup is not None:
            after_warmup()
        engine._execute_batch = timed
        stamps = []
        t0 = time.perf_counter()
        try:
            outs = await asyncio.gather(*(one(p, stamps) for p in prompts))
        finally:
            engine._execute_batch = orig
        wall = time.perf_counter() - t0
        await engine.stop()
        return outs, stamps, wall
    engine.clear_kv_blocks()
    outs, stamps, wall = asyncio.run(run())
    return outs, stamps, wall, batch_s


def tapped_run(engine, prompts):
    """Serve ``prompts`` through the non-spec ``engine`` at depth 1 with its
    decode windows run eagerly (bitwise their graphs, as ``[graph]``
    checks), recording the top-PARITY_TOPK logits of each request's final
    prefill chunk (output index 0) and of each decode window per seat.
    Returns (streams, {(request, output index): (token ids, logits)})."""
    import torch

    from dynamo_tpu_torch.engine import model as model_lib

    index = {tuple(p[:SPEC_SEGMENT]): r for r, p in enumerate(prompts)}
    taps, rec = [], {}
    logits_fn = model_lib.logits_fn
    unpack = engine._unpack_results

    def tap(cfg, params, h):
        out = logits_fn(cfg, params, h)
        taps.append(torch.topk(out, PARITY_TOPK))
        return out

    def unpack_tapped(batch, landing):
        # one logits call per prefill chunk (dispatched first), then the
        # decode window's; a final chunk samples output index 0
        for i, chunk in enumerate(batch.prefills):
            r = index.get(tuple(chunk.seq.prompt_ids[:SPEC_SEGMENT]))
            if chunk.final and r is not None:
                vals, ids = (t.cpu().tolist() for t in taps[i])
                rec[r, 0] = (ids[0], vals[0])
        if landing.decode_shape is not None:
            vals, ids = (t.cpu().tolist() for t in taps[-1])
            col_of = {}
            for col, slot in enumerate(landing.cols):
                col_of.setdefault(slot, col)
            for row in batch.decode_rows:
                r = index.get(tuple(row.seq.prompt_ids[:SPEC_SEGMENT]))
                if r is not None:
                    c = col_of[row.slot]
                    rec[r, len(row.seq.output_ids)] = (ids[c], vals[c])
        taps.clear()
        return unpack(batch, landing)

    engine.pipeline_depth = 1
    engine._ap_window_fn.graphed = False
    model_lib.logits_fn = tap
    engine._unpack_results = unpack_tapped
    try:
        outs = serve_batch(engine, prompts, OSL)[0]
    finally:
        model_lib.logits_fn = logits_fn
        del engine._unpack_results
        engine._ap_window_fn.graphed = True
        engine.pipeline_depth = DEPTHS[0]
    return outs, rec


def check_parity(want, rec, got, what: str, tag: str = "[spec]"):
    """The parity rule: ``got`` (spec, or another path such as phase 7's
    disaggregated or evacuated streams) equals ``want`` (the non-spec run
    whose logits ``rec`` holds) token for token, but may part where the
    other token sits under PARITY_MARGIN x |top logit| below the non-spec
    run's top logit; prints each parting under ``tag``. Returns the
    partings."""
    partings = []
    for r, (a, b) in enumerate(zip(want, got)):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        if (r, j) not in rec:
            fail(f"{tag} stream {r} parts at token {j}, where no decode "
                 f"window's logits were recorded")
        ids, vals = rec[r, j]
        top = vals[0]
        margin = vals[0] - vals[1]
        gap = vals[0] - vals[ids.index(b[j])] if b[j] in ids else None
        limit = PARITY_MARGIN * abs(top)
        partings.append((r, j, margin, gap))
        print(f"{tag} parity vs {what}: request {r} parts at output token "
              f"{j}: non-spec {a[j]} (its run's top {ids[0]}, logit "
              f"{top:.4f}), spec {b[j]}: the non-spec run's top-2 margin "
              f"{margin:.5f}, spec token "
              + (f"{gap:.5f}" if gap is not None else
                 f"not in its top {PARITY_TOPK}")
              + f" under the top (limit {limit:.5f}; 1e-3 x |top| = "
              f"{PARITY_FINE * abs(top):.5f}: "
              + ("met" if margin < PARITY_FINE * abs(top) else "not met")
              + ")", flush=True)
        if ids[0] != a[j] or gap is None or gap >= limit:
            fail(f"{tag} stream {r} parts from the non-spec one ({what}) at "
                 f"token {j} away from a near-tie: gap {gap}, limit {limit}")
    return partings


def phase_spec(card: str, base):
    """[spec]: a bf16 ``spec_mode="ngram"`` engine (k=4, n-gram 1..3) with
    phase 3's weights serves 16 greedy requests of repeated 64-token
    segments (ISL 512, OSL 64); the phase 3 engine ``base`` serves the same
    prompts at depths 1 and 2. Streams must meet the parity rule, every
    spec window must be a graph replay, and the ragged face must have run
    the verify windows. Returns the spec engine and its run's
    paged-attention launches (graph replays counted, verify windows
    apart)."""
    import torch

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = base.model_config
    prompts = spec_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    spec_cfg = EngineConfig(spec_mode="ngram", spec_k=SPEC_K,
                            spec_ngram_min=SPEC_NGRAM[0],
                            spec_ngram_max=SPEC_NGRAM[1])
    engine = InferenceEngine(cfg, spec_cfg, seed=SEED)
    torch.cuda.synchronize()
    graphs = engine._ap_window_fn
    n_spec = sum(1 for key in graphs.capture_s if key[0] == "spec")
    print(f"[spec] engine spec_mode=ngram k={SPEC_K} n-gram {SPEC_NGRAM}, "
          f"same weights (seed {SEED}), pipeline_depth "
          f"{engine.pipeline_depth}, built in "
          f"{time.perf_counter() - t0:.2f} s; {n_spec} spec + "
          f"{len(graphs.capture_s) - n_spec} decode graphs captured "
          f"({sum(graphs.capture_s.values()):.2f} s)", flush=True)
    if engine.pipeline_depth != 1 or n_spec != 2 * len(
            spec_cfg.decode_buckets):
        fail("the spec engine did not force depth 1 or capture its graphs")
    if not all(torch.equal(a, b) for a, b in zip(
            engine.params["layers"]["wq"], base.params["layers"]["wq"])):
        fail("the spec engine's weights differ from phase 3's")

    runs = {}
    for depth in (1, 2):
        base.pipeline_depth = depth
        runs[depth] = serve_batch(base, prompts, OSL)
    base.pipeline_depth = DEPTHS[0]
    seat_windows = [0]
    unpack = engine._unpack_spec

    def counting(batch, out, col_of):
        seat_windows[0] += len(batch.decode_rows)
        return unpack(batch, out, col_of)
    engine._unpack_spec = counting
    before = {}

    def mark():
        seat_windows[0] = 0
        before.update(windows=engine.num_windows, replays=graphs.replays,
                      spec=graphs.spec_replays,
                      prefills=engine.num_prefill_dispatches,
                      stats=engine.spec_stats.to_dict())
        pa.reset_launches()
    outs, stamps, wall, batch_s = serve_batch(engine, prompts, OSL, mark)
    launches = dict(pa.LAUNCHES)
    obs = engine.obs_snapshot()
    engine._unpack_spec = unpack
    st = engine.spec_stats.to_dict()
    n = {k: st[k] - before["stats"][k]
         for k in ("drafted", "accepted", "emitted", "windows")}
    windows = engine.num_windows - before["windows"]
    replays = graphs.replays - before["replays"]
    spec_replays = graphs.spec_replays - before["spec"]
    prefills = engine.num_prefill_dispatches - before["prefills"]
    for i, out in enumerate(outs):
        if len(out) != OSL or not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"spec request {i}: {len(out)} tokens or an id out of range")
    if replays != windows or spec_replays != n["windows"] \
            or spec_replays != windows:
        fail(f"spec windows not all graph replays: {windows} windows, "
             f"{replays} replays, {spec_replays} spec replays, "
             f"{n['windows']} verify windows")
    L = cfg.num_layers
    verify_launches = launches["paged_attention_ragged"] - L * prefills
    if verify_launches != L * spec_replays \
            or launches["paged_attention_decode"] != 0:
        fail(f"verify windows did not run the ragged face: {launches}, "
             f"{prefills} prefills, {spec_replays} spec replays")

    def stats(tag, outs_, stamps_, wall_, batch_):
        ttft = sorted(times[0] - t for t, times in stamps_)
        itl = sorted((times[-1] - times[0]) / (len(times) - 1)
                     for _, times in stamps_)
        steady = sorted(batch_)
        out = dict(ttft=ttft[len(ttft) // 2], itl=itl[len(itl) // 2],
                   tok_s=sum(map(len, outs_)) / wall_,
                   step=steady[len(steady) // 2] if steady else 0.0)
        print(f"[spec] {card}: {tag}: TTFT p50 {out['ttft'] * 1e3:.1f} ms, "
              f"ITL p50 {out['itl'] * 1e3:.2f} ms, output "
              f"{out['tok_s']:.1f} tok/s, steady decode-only window p50 "
              f"{out['step'] * 1e3:.2f} ms over {len(steady)} windows",
              flush=True)
        return out
    summary = {f"depth {d}": stats(f"non-spec engine, depth {d}", *runs[d])
               for d in (1, 2)}
    summary["spec"] = stats("spec engine (depth 1)", outs, stamps, wall,
                            batch_s)
    rate = n["accepted"] / max(1, n["drafted"])
    print(f"[spec] {card}: acceptance {n['accepted']}/{n['drafted']} = "
          f"{rate:.3f}; {n['emitted']} tokens landed by {n['windows']} "
          f"verify windows ({seat_windows[0]} seat-windows): "
          f"{n['emitted'] / max(1, seat_windows[0]):.2f} tokens per seat "
          f"per window, {seat_windows[0] / N_REQUESTS:.1f} windows per "
          f"request; flight recorder mfu_decode {obs['mfu_decode']:.5f}, "
          f"spec_reject waste {obs['spec_reject_waste_ratio']:.3f}; "
          f"ragged-face launches in verify windows {verify_launches}",
          flush=True)
    t_tap = time.perf_counter()
    tapped, rec = tapped_run(base, prompts)
    same = sum(x == y for x, y in zip(tapped, runs[1][0]))
    print(f"[spec] the non-spec depth-1 run again, decode windows eager "
          f"with their logits recorded ({time.perf_counter() - t_tap:.1f} "
          f"s): {same} of {N_REQUESTS} streams equal the graphed run's",
          flush=True)
    if same != N_REQUESTS:
        fail("the eager rerun of the non-spec depth-1 traffic differs from "
             "its graphed run")
    partings = check_parity(tapped, rec, outs, "non-spec depth 1")
    for what, ref in (("non-spec depth 1", runs[1][0]),
                      ("non-spec depth 2", runs[2][0])):
        print(f"[spec] {sum(x == y for x, y in zip(outs, ref))} of "
              f"{N_REQUESTS} spec streams equal the {what} run's", flush=True)
    print(f"[spec] parity: {len(partings)} of {N_REQUESTS} spec streams part "
          f"from the non-spec depth-1 run, each at a near-tie of its logits "
          f"(output token, top-2 margin, spec-token gap): " + ", ".join(
              f"({j}, {m:.4f}, {g:.4f})" for _, j, m, g in partings)
          + f"; depth 2 equals depth 1 in "
          f"{sum(x == y for x, y in zip(runs[1][0], runs[2][0]))} streams",
          flush=True)
    return engine, dict(launches=verify_launches, summary=summary,
                        acceptance=rate, partings=partings)


def spec_seat(ctl, B: int, ctx0: int, max_len: int, sampled: bool) -> None:
    """``seat`` plus each seat's history: a periodic 12-token pattern up to
    its position, so the drafter proposes."""
    import torch

    seat(ctl, B, ctx0, max_len, sampled)
    pattern = torch.arange(100, 112, dtype=torch.int32,
                           device=ctl["hist"].device)
    for s in range(B):
        n = ctx0 + s + 1
        ctl["hist"][s].fill_(-1)
        ctl["hist"][s, :n] = pattern.repeat(-(-n // 12))[:n] + s
        ctl["last_tok"][s] = ctl["hist"][s, n - 1]


def phase_spec_graph(engine, card: str) -> None:
    """[graph] for the spec windows: each spec graph phase 3 replays
    (buckets 8 and 16, greedy and stochastic) against the eager spec window
    on identical clones of cache and ctl (history included): packed output
    and ctl bitwise equal."""
    import torch

    window = engine._ap_window_fn
    eng = engine.config

    def clone(tree):
        return {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone()) for k, v in tree.items()}

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    saved_ctl = clone(engine._ctl)
    for B in GRAPH_BUCKETS:
        for stochastic in (False, True):
            for k, v in saved_ctl.items():
                engine._ctl[k].copy_(v)
            spec_seat(engine._ctl, B, 560, eng.max_model_len, stochastic)
            ctl_e, cache_e = clone(engine._ctl), clone(engine.cache)
            cols = list(range(B))
            _, _, want = window.raw_spec(
                engine.params, cache_e, ctl_e,
                torch.tensor(cols, dtype=torch.int32, device=engine.device),
                stochastic)
            _, _, got = window(engine.params, engine.cache, engine._ctl,
                               window.load_rows(cols), stochastic, spec=True)
            got = got.clone()
            torch.cuda.synchronize()
            same = torch.equal(want, got)
            differ = [k for k in ctl_e
                      if not torch.equal(bits(ctl_e[k]), bits(engine._ctl[k]))]
            same_ctl = not differ
            bitwise = all(torch.equal(bits(a), bits(b)) for key in cache_e
                          for a, b in zip(cache_e[key], engine.cache[key]))
            landed = int(got[SPEC_K + 1].sum())
            drafted = int(got[SPEC_K + 2].sum())
            print(f"[graph] {card}: spec B={B} stochastic={stochastic}: "
                  f"replay vs eager packed output equal {same}, ctl (hist "
                  f"included) bitwise equal {same_ctl} {differ or ''}, cache "
                  f"bitwise "
                  f"{bitwise}; {landed} tokens landed, {drafted} drafted; "
                  f"captured in "
                  f"{window.capture_s['spec', B, stochastic] * 1e3:.1f} ms",
                  flush=True)
            if not (same and same_ctl):
                fail(f"spec graph B={B} stochastic={stochastic} disagrees "
                     "with the eager spec window")
            if drafted == 0 or landed < B:
                fail(f"spec graph B={B}: {drafted} drafts on periodic "
                     f"histories, {landed} tokens for {B} live seats")
    for k, v in saved_ctl.items():
        engine._ctl[k].copy_(v)
    torch.cuda.synchronize()


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _profiled(fn, reps: int = 5):
    """(kernel launches, device busy ms) of one call of ``fn``, from
    ``torch.profiler``."""
    from torch.autograd import DeviceType

    fn()
    events = profile_calls(fn, reps)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx")) / reps
    busy = sum(_device_us(e) for e in events
               if e.device_type == DeviceType.CUDA) / reps / 1e3
    return launches, busy


def phase_quant_costs(engine, card: str) -> None:
    """The two costs quantized serving adds to a decode step of the eager
    port, at the main path's shapes (B=16): the bf16 copy that every
    quantized matmul makes of its 1-byte weight (device time and bytes of
    all of one step's casts), and ``kv_quantize`` plus the scale scatter of
    K and V in every layer (launches, device busy time from the profiler,
    and host wall time by CUDA events around back-to-back calls, which
    host launches bound)."""
    import torch

    from dynamo_tpu_torch.engine import quant

    cfg, eng = engine.model_config, engine.config
    leaves = [w for w in engine.params["layers"].values()
              if isinstance(w, dict)]
    if isinstance(engine.params.get("lm_head"), dict):
        leaves.append(engine.params["lm_head"])
    if leaves:
        def casts():
            for w in leaves:
                w["q"].to(torch.bfloat16)
        n = sum(w["q"].numel() for w in leaves)
        ms = cuda_ms(casts, iters=10)
        print(f"[quant] {card}: weight {eng.weight_dtype}: bf16 copies of "
              f"one step's {len(leaves)} stacked weights ({n / 1e9:.3f} G "
              f"elements, {3 * n / 1e9:.2f} GB read + written): {ms:.3f} "
              f"ms, {3 * n / ms / 1e9:.2f} TB/s; {_profiled(casts)[0]:.0f} "
              f"launches", flush=True)
    if quant.is_quantized(eng.kv_dtype):
        B, KV, hd = 16, cfg.num_kv_heads, cfg.head_dim_
        x = torch.randn(B, KV, hd, device=engine.device,
                        dtype=torch.bfloat16)
        ks = engine.cache["ks"][0]
        idx = (torch.arange(1, B + 1, device=engine.device)[:, None],
               torch.arange(KV, device=engine.device)[None, :],
               torch.zeros(B, 1, dtype=torch.long, device=engine.device))

        def quantize_one():  # K or V of one layer, with its scale scatter
            _, sc = quant.kv_quantize(x, eng.kv_dtype)
            ks.index_put_(idx, sc)
        wall = cuda_ms(quantize_one, iters=50)
        n, busy = _profiled(quantize_one)
        L = cfg.num_layers
        print(f"[quant] {card}: kv {eng.kv_dtype}: kv_quantize + scale "
              f"scatter of K or V, B={B}: {n:.0f} launches, device busy "
              f"{busy:.4f} ms, back-to-back wall {wall:.4f} ms; per decode "
              f"step (x2 x {L} layers): {2 * L * n:.0f} launches, "
              f"{2 * L * busy:.3f} ms device busy, {2 * L * wall:.3f} ms "
              f"wall", flush=True)


def phase_profile(engine, card: str) -> None:
    """Where a step's time goes, at the main path's shapes: wall time of
    the engine's step functions (host clock around synchronised calls), the
    host time to enqueue one (back-to-back calls, no sync) and,
    from ``torch.profiler`` over a few calls, the device busy time and idle
    share, the host's kernel and graph launches, the kernels that ran on
    the device and the attention kernel's share. The decode window runs
    eagerly and as the engine's replayed graph, on the same seats."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from dynamo_tpu_torch.engine import model as model_lib

    cfg, eng = engine.model_config, engine.config
    dev = engine.device
    B, ctx0 = 16, 560
    ctl = model_lib.init_ctl(eng, eng.max_num_seqs, eng.max_blocks_per_seq,
                             dev)
    seat(ctl, B, ctx0, eng.max_model_len)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    window = model_lib.raw_autopilot_window_fn(cfg, eng, 1)
    graphed = engine._ap_window_fn
    if engine._window_K != 1:
        fail("phase 4 profiles 1-token decode windows")
    saved_ctl = {k: v.clone() for k, v in engine._ctl.items()}
    for k, v in ctl.items():
        engine._ctl[k].copy_(v)
    graph_rows = graphed.load_rows(list(range(B)))
    T, W = 512, 32
    prefill = model_lib.raw_packed_prefill_fn(cfg, eng, T, W)
    pint = np.zeros((1, T + W + model_lib.PP_SCALARS), np.int32)
    pint[0, :T] = np.arange(T) % (cfg.vocab_size - 1) + 1
    pint[0, T:T + W] = np.arange(1 + 40 * B, 1 + 40 * B + W)
    pint[0, T + W:] = (T, 0, B, 1, 0, -1, 0, int(model_lib.PP_QUANT))
    pint = torch.from_numpy(pint).to(dev)
    key = torch.tensor(1, device=dev)
    steps = {  # each enqueues one step and returns its sampled tokens
        f"decode window B={B} ctx ~{ctx0}, eager": lambda: window(
            engine.params, engine.cache, ctl, rows, False)[2],
        f"decode window B={B} ctx ~{ctx0}, graph replay": lambda: graphed(
            engine.params, engine.cache, engine._ctl, graph_rows,
            False)[2],
        f"prefill chunk T={T} W={W}": lambda: prefill(
            engine.params, engine.cache, ctl["last_tok"], pint, key,
            False)[2],
    }
    launch_keys = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")
    for name, enqueue in steps.items():
        def fn():
            return enqueue().cpu()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            enqueue()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        reps = 3
        events = profile_calls(fn, reps)
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset"))]
        busy = sum(_device_us(e) for e in kernels) / reps / 1e3
        # both faces: the ragged kernel and the decode split-KV kernel
        attn = sum(_device_us(e) for e in kernels
                   if "paged_attention" in e.key) / reps / 1e3
        launches = sum(e.count for e in events
                       if e.key in launch_keys) / reps
        graph_launches = sum(e.count for e in events
                             if e.key == "cudaGraphLaunch") / reps
        on_device = sum(e.count for e in kernels) / reps
        if attn <= 0:
            fail(f"{name}: no device time in the attention kernels")
        top = sorted(kernels, key=_device_us, reverse=True)[:4]
        print(f"[profile] {card}: {name}, weights {eng.weight_dtype} KV "
              f"{eng.kv_dtype}: wall {wall_ms:.2f} ms (host enqueue "
              f"{host_ms:.3f} ms), device "
              f"busy {busy:.2f} ms ({busy / wall_ms:.0%} of wall, idle "
              f"{1 - busy / wall_ms:.0%}), attention kernel {attn:.3f} ms, "
              f"{launches:.0f} kernel launches and {graph_launches:.0f} "
              f"cudaGraphLaunch from the host, {on_device:.0f} kernels on "
              f"the device; top: " + "; ".join(
                  f"{e.key[:40]} {_device_us(e) / reps / 1e3:.2f} ms"
                  for e in top), flush=True)
    for k, v in saved_ctl.items():
        engine._ctl[k].copy_(v)
    torch.cuda.synchronize()


# ------------------------------ phase 5 ----------------------------------

# Llama-3's pre-tokenizer regex (its tokenizer.json: Split, Isolated)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
LLAMA3_SPECIAL = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
                  6: "<|start_header_id|>", 7: "<|end_header_id|>",
                  9: "<|eot_id|>"}
N_REGULAR = 128_000


def synthetic_tokenizer_json(n_merges: int = N_REGULAR - 256,
                             n_special: int = 256, seed: int = SEED) -> str:
    """A byte-level BPE ``tokenizer.json`` at Llama-3's layout, made from a
    seed: the 256 byte tokens, then ``n_merges`` merges, each joining two
    existing tokens of at most 16 bytes between them, then ``n_special``
    special tokens (Llama-3's names where it has them, reserved ones
    elsewhere); Llama-3's ``Split`` regex before ``ByteLevel``,
    ``ignore_merges``, and a ``TemplateProcessing`` that puts
    ``<|begin_of_text|>`` first. Every merged token is whole UTF-8 text
    (ASCII, then Latin, Greek, Cyrillic, Arabic-Indic and Devanagari
    digits and CJK characters, each built up from its bytes, then joins of
    whole tokens), so text decoded from them splits where they do."""
    import random

    from dynamo_tpu_torch.llm.tokenizer_json import bytes_to_unicode

    table = bytes_to_unicode()
    rng = random.Random(seed)
    vocab = {table[b]: b for b in range(256)}
    merges = []

    def show(bs: bytes) -> str:
        return "".join(table[x] for x in bs)

    by_len = [[] for _ in range(17)]   # whole-text tokens by byte length

    def add(a: bytes, b: bytes, whole: bool) -> None:
        key = show(a + b)
        if key in vocab or len(merges) >= n_merges:
            return
        vocab[key] = len(vocab)
        merges.append([show(a), show(b)])
        if whole:
            by_len[len(a + b)].append(a + b)

    for b in [9, 10, *range(0x20, 0x7F)]:
        by_len[1].append(bytes([b]))
    for cp in [*range(0xC0, 0x180), *range(0x391, 0x3CA),
               *range(0x410, 0x450), *range(0x660, 0x66A),
               *range(0x966, 0x970), *range(0x4E00, 0x4E00 + 512)]:
        bs = chr(cp).encode()
        for i in range(1, len(bs)):
            add(bs[:i], bs[i:i + 1], whole=i + 1 == len(bs))
    while len(merges) < n_merges:
        la = rng.randrange(1, 16)
        if not by_len[la]:
            continue
        a = rng.choice(by_len[la])
        room = [len(by_len[n]) for n in range(1, 17 - la)]
        r = rng.randrange(sum(room))
        lb = 1
        while r >= room[lb - 1]:
            r -= room[lb - 1]
            lb += 1
        add(a, by_len[lb][r], whole=True)
    n_regular = len(vocab)
    added = []
    for i in range(n_special):
        name = LLAMA3_SPECIAL.get(i, f"<|reserved_special_token_{i}|>")
        added.append({"id": n_regular + i, "content": name,
                      "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False,
                      "special": True})
    bos = LLAMA3_SPECIAL[0]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": False}
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": {"type": "Sequence", "processors": [
            byte_level,
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [n_regular],
                                      "tokens": [bos]}}}]},
        "decoder": dict(byte_level, use_regex=True),
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }, ensure_ascii=False)


async def _http_request(port: int, method: str, path: str, body=None,
                        leave_after=None, headers=None):
    """One request on its own connection: (status, t_sent, frames, done,
    body). A streamed (chunked) answer gives ``frames``, each parsed
    ``data:`` payload stamped on arrival with the shared monotonic clock,
    and ``done`` when ``data: [DONE]`` came; with ``leave_after`` the
    client closes its socket after that many frames, mid-stream. A whole
    answer gives ``body`` (parsed JSON, else text). ``headers`` adds
    request headers."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    t_sent = time.perf_counter()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 f"Content-Type: application/json\r\nContent-Length: "
                 f"{len(payload)}\r\n{extra}Connection: close\r\n\r\n"
                 .encode() + payload)
    await writer.drain()
    head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
    status = int(head.split(" ", 2)[1])
    headers = dict(ln.lower().split(": ", 1)
                   for ln in head.split("\r\n")[1:] if ": " in ln)
    frames, done, out = [], False, None
    try:
        if headers.get("transfer-encoding") == "chunked":
            buf = b""
            while not done:
                size = int((await reader.readline()).strip(), 16)
                if size == 0:
                    break
                data = await reader.readexactly(size + 2)
                t = time.perf_counter()
                buf += data[:-2]
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    if frame == b"data: [DONE]":
                        done = True
                    elif frame.startswith(b"data: "):
                        frames.append((t, json.loads(frame[6:])))
                if leave_after is not None and len(frames) >= leave_after:
                    break
        else:
            raw = await reader.readexactly(int(headers["content-length"]))
            out = json.loads(raw) if "json" in headers.get(
                "content-type", "") else raw.decode()
    finally:
        writer.close()
    return status, t_sent, frames, done, out


def http_client(port: int, jobs):
    """Run ``jobs`` (dicts of ``_http_request``'s arguments; a job's own
    ``port`` overrides ``port``) concurrently and return their results.
    Phases 5 and 6 call this in a client process of their own, so parsing
    the answers takes no time from the server's interpreter."""
    import asyncio

    async def run():
        return await asyncio.gather(*(_http_request(**{"port": port, **job})
                                      for job in jobs))
    return asyncio.run(run())


def traffic_stats(runs, wall: float) -> dict:
    """TTFT p50/max, per-stream ITL p50 and output tok/s of a concurrent
    run; ``runs`` holds (t_sent, t_first_token, t_last_token, tokens)."""
    ttft = sorted(first - sent for sent, first, _, _ in runs)
    itl = sorted((last - first) / (n - 1) for _, first, last, n in runs)
    return dict(ttft_p50=ttft[len(ttft) // 2], ttft_max=ttft[-1],
                itl_p50=itl[len(itl) // 2],
                tok_s=sum(n for *_, n in runs) / wall)


def stats_line(s) -> str:
    return (f"TTFT p50 {s['ttft_p50'] * 1e3:.1f} ms max "
            f"{s['ttft_max'] * 1e3:.1f} ms, ITL p50 "
            f"{s['itl_p50'] * 1e3:.2f} ms, output {s['tok_s']:.1f} tok/s")


def frontend_us_per_token(tok, prompts, n_tokens: int) -> float:
    """Host time the frontend spends per generated token and stream, with
    no socket and no device: ``build_local_pipeline`` (preprocessor,
    detokenizer, stop-string holdback) over an engine that streams
    scripted ids, folded into completion chunks and SSE frames, for all
    ``prompts`` at once on one event loop."""
    import asyncio

    from dynamo_tpu_torch.llm import openai as oai
    from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.engine import FnEngine

    async def scripted(request, context):
        ids = request["token_ids"]
        for i in range(n_tokens):
            await asyncio.sleep(0)
            yield {"token_ids": [ids[i % len(ids)]], "index": i,
                   "finished": i == n_tokens - 1,
                   "finish_reason": "length" if i == n_tokens - 1 else None,
                   "num_prompt_tokens": len(ids)}

    pipeline = build_local_pipeline(FnEngine(scripted), tok, HTTP_MODEL)

    async def one(p):
        body = {"model": HTTP_MODEL, "prompt": p, "max_tokens": n_tokens}
        chunks = oai.completion_stream(pipeline.generate(body, Context()),
                                       "cmpl-x", HTTP_MODEL)
        return sum([len(oai.sse_frame(c).encode()) async for c in chunks])

    async def run():
        await asyncio.gather(*(one(p) for p in prompts))   # warm
        t0 = time.perf_counter()
        await asyncio.gather(*(one(p) for p in prompts))
        return time.perf_counter() - t0
    return asyncio.run(run()) / (len(prompts) * n_tokens) * 1e6


HTTP_MODEL = "llama-3.2-1b-random"


def phase_http(engine, card: str, direct: dict) -> None:
    """Serve the bf16 engine over HTTP through ``run.run_http`` (what
    ``python -m dynamo_tpu_torch.run in=http`` runs) with the synthetic
    128,256-token tokenizer, and check it: texts served one at a time equal
    ``decode`` of the engine's own ids; chat through the default template;
    16 concurrent streams of phase 3's traffic; ``/metrics`` and
    ``/health``; a client that leaves mid-stream frees its sequence and KV
    blocks within a second; both attention faces launched. Prints HTTP vs
    direct TTFT, ITL and throughput on ``[http]`` lines."""
    import asyncio
    import multiprocessing
    import statistics
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from dynamo_tpu_torch import run as trun
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.runtime.context import Context

    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "synthetic_tokenizer.json")
    t0 = time.perf_counter()
    data = synthetic_tokenizer_json()
    with open(path, "w", encoding="utf-8") as f:
        f.write(data)
    t1 = time.perf_counter()
    tok = trun.load_tokenizer(path)
    t2 = time.perf_counter()
    cfg = engine.model_config
    if tok.vocab_size != cfg.vocab_size:
        fail(f"tokenizer has {tok.vocab_size} tokens, the model "
             f"{cfg.vocab_size}")
    print(f"[http] synthetic tokenizer: {tok.vocab_size} tokens, "
          f"{len(data.encode()) / 1e6:.1f} MB, made in {t1 - t0:.2f} s, "
          f"loaded in {t2 - t1:.2f} s", flush=True)
    # prompts of whole-text tokens, so their text splits where they do
    gen = torch.Generator().manual_seed(SEED + 5)
    whole = [i for i in torch.randint(256, N_REGULAR, (40_000,),
                                      generator=gen).tolist()
             if "�" not in tok.decode([i])]
    prompts = [whole[i * ISL:(i + 1) * ISL] for i in range(N_REQUESTS)]
    if len(prompts[-1]) != ISL:
        fail("not enough whole-text tokens for the prompts")
    encode_s = []
    for p in prompts:
        text = tok.decode(p)
        ts = time.perf_counter()
        tok.encode(text)
        encode_s.append(time.perf_counter() - ts)
    encode_ms = statistics.median(encode_s) * 1e3

    args = trun.parse_args([
        "in=http", "out=engine", "--model", "1b", "--tokenizer", path,
        "--model-name", HTTP_MODEL, "--host", "127.0.0.1", "--port", "0"])
    cmpl = "/v1/completions"

    def completion(p, stream: bool, max_tokens: int = OSL) -> dict:
        return {"model": HTTP_MODEL, "prompt": p, "max_tokens": max_tokens,
                "temperature": 0, "ignore_eos": True, "stream": stream}

    async def serve():
        loop = asyncio.get_running_loop()
        # the client runs in a process of its own: parsing 16 streams must
        # not share the server's interpreter lock
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))

        async def client(*jobs):
            return await loop.run_in_executor(procs, http_client, port,
                                              list(jobs))

        def job(path, body=None, method="POST", **kw):
            return dict(method=method, path=path, body=body, **kw)

        stop = asyncio.Event()
        ready = loop.create_future()
        server = asyncio.create_task(
            trun.run_http(engine, tok, args, stop=stop, ready=ready))
        try:
            port = (await ready).port
            await client(job("/health", method="GET"))   # client warm-up
            pa.reset_launches()
            # every run below starts with no prefix hits, as phase 3's do:
            # a hit changes the prefill's chunk shape, and bf16 rounding
            # with it (a near-tie of random weights can flip a token)
            cold = engine.scheduler.pool.clear
            # 1. served one at a time: HTTP text == decode(engine ids)
            wants = []
            for i, p in enumerate(prompts[:4]):
                req = {"token_ids": p, "max_tokens": OSL, "ignore_eos": True,
                       "temperature": 0.0}
                cold()
                ids = [t async for o in engine.generate(req, Context())
                       for t in o["token_ids"]]
                want = tok.decode(ids)
                wants.append(want)
                cold()
                (status, _, frames, done, body), = await client(
                    job(cmpl, completion(p, stream=i % 2 == 0)))
                if status != 200:
                    fail(f"{cmpl}: HTTP {status}: {body}")
                if i % 2:
                    got = body["choices"][0]["text"]
                    n = body["usage"]["completion_tokens"]
                else:
                    if not done:
                        fail("a streamed completion did not end in [DONE]")
                    got = "".join(f["choices"][0]["text"] for _, f in frames)
                    n = frames[-1][1]["usage"]["completion_tokens"]
                if n != OSL:
                    fail(f"usage.completion_tokens {n} != {OSL}")
                if len(ids) != OSL or got != want:
                    at = next((j for j, (a, b) in enumerate(zip(got, want))
                               if a != b), min(len(got), len(want)))
                    fail(f"served-alone request {i}: HTTP text differs from "
                         f"decode of the engine's {len(ids)} ids at char "
                         f"{at} of {len(got)} / {len(want)}: "
                         f"{got[at:at + 40]!r} vs {want[at:at + 40]!r}")
            print(f"[http] 4 completions served one at a time (2 streamed): "
                  f"text equals decode of the engine's own ids", flush=True)
            # 2. chat through the default template, streamed and not
            msgs = [{"role": "system", "content": "You are terse."},
                    {"role": "user", "content": "Name three prime numbers."}]
            chat = {"model": HTTP_MODEL, "messages": msgs, "max_tokens": 16}
            (status, _, _, _, body), (_, _, frames, done, _) = await client(
                job("/v1/chat/completions", chat),
                job("/v1/chat/completions", dict(chat, stream=True)))
            if status != 200 or not body["choices"][0]["finish_reason"] \
                    or body["usage"]["completion_tokens"] < 1:
                fail(f"chat: HTTP {status}: {body}")
            if not done or not frames \
                    or not frames[-1][1]["choices"][0]["finish_reason"]:
                fail("streamed chat did not finish with a reason and [DONE]")
            print(f"[http] chat x2 (template -> "
                  f"{body['usage']['prompt_tokens']} prompt tokens): 200, "
                  f"finish {body['choices'][0]['finish_reason']}", flush=True)
            # 3. phase 3's traffic, 16 concurrent streams, over HTTP and
            # straight into the engine on this same loop, at the default
            # interpreter switch interval (5 ms) and at 0.5 ms: the event
            # loop and the device-step thread take turns at one GIL
            async def over_http():
                cold()
                t_start = time.perf_counter()
                results = await client(*(job(cmpl, completion(p, True))
                                         for p in prompts))
                wall = time.perf_counter() - t_start
                runs = []
                for status, t_sent, frames, done, _ in results:
                    content = [t for t, f in frames
                               if f["choices"][0]["text"]]
                    n = frames[-1][1]["usage"]["completion_tokens"] \
                        if frames else 0
                    if status != 200 or not done or n != OSL \
                            or len(content) < 2 \
                            or not content[0] < content[-1]:
                        fail(f"concurrent stream: HTTP {status}, [DONE] "
                             f"{done}, {n} tokens, {len(content)} content "
                             f"frames")
                    runs.append((t_sent, content[0], content[-1], n))
                return traffic_stats(runs, wall)

            async def direct():
                cold()

                async def one(p):
                    t_sent, times = time.perf_counter(), []
                    req = {"token_ids": p, "max_tokens": OSL,
                           "ignore_eos": True, "temperature": 0.0}
                    async for o in engine.generate(req, Context()):
                        times += [time.perf_counter()] * len(o["token_ids"])
                    if len(times) != OSL:
                        fail(f"direct run: {len(times)} tokens")
                    return t_sent, times[0], times[-1], len(times)
                t_start = time.perf_counter()
                runs = await asyncio.gather(*(one(p) for p in prompts))
                return traffic_stats(runs, time.perf_counter() - t_start)

            # each step's dispatch (start, end) in the device-step thread
            # (the run-ahead loop waits for tokens on the fetch thread): is
            # the dispatch slower under HTTP, or the gap before the next?
            spans = []
            execute = engine._dispatch_batch

            def timed(batch):
                t0 = time.perf_counter()
                try:
                    return execute(batch)
                finally:
                    spans.append((t0, time.perf_counter()))
            engine._dispatch_batch = timed

            async def measured(run):
                spans.clear()
                stats = await run()
                busy = sorted(e - b for b, e in spans)
                gaps = sorted(b2 - e1 for (_, e1), (b2, _) in
                              zip(spans, spans[1:]))
                return dict(stats, steps=len(spans),
                            step_p50=busy[len(busy) // 2],
                            gap_p50=gaps[len(gaps) // 2],
                            gap_sum=sum(gaps))

            rows = {}
            try:
                for interval in (None, 0.0005):
                    old = sys.getswitchinterval()
                    if interval is not None:
                        sys.setswitchinterval(interval)
                    try:
                        rows["http", interval] = await measured(over_http)
                        rows["direct", interval] = await measured(direct)
                    finally:
                        sys.setswitchinterval(old)
            finally:
                del engine._dispatch_batch
            # 4. /metrics and /health
            served = 4 + 2 + 2 * N_REQUESTS
            (status, _, _, _, text), (h_status, *_) = await client(
                job("/metrics", method="GET"), job("/health", method="GET"))
            m = re.search(r'^dynamo_frontend_ttft_seconds_count\{model="'
                          + HTTP_MODEL + r'"\} (\S+)$', text, re.M)
            if status != 200 or m is None or float(m.group(1)) != served:
                fail(f"/metrics ttft_seconds_count "
                     f"{m and m.group(1)} != {served} requests served")
            if h_status != 200:
                fail(f"/health: HTTP {h_status}")
            # 5. a client that leaves mid-stream frees its seat and blocks
            pool_free = engine.scheduler.pool.num_free
            (_, _, frames, _, _), = await client(job(
                cmpl, completion(prompts[0], True, 4000), leave_after=5))
            t_left = time.perf_counter()
            sched = engine.scheduler
            # a finished sequence with a window in flight waits as a zombie
            # until the window lands, then releases its blocks
            while sched.running or sched.waiting or sched.zombies \
                    or sched.pool.num_free != pool_free:
                if time.perf_counter() - t_left > 1.0:
                    fail(f"1 s after its client left: {len(sched.running)} "
                         f"running, {len(sched.zombies)} zombie sequences, "
                         f"{sched.pool.num_free} of {pool_free} blocks free")
                await asyncio.sleep(0.005)
            freed = time.perf_counter() - t_left
            print(f"[http] client left after {len(frames)} frames: sequence"
                  f" gone and its KV blocks free {freed * 1e3:.1f} ms later",
                  flush=True)
            launches = {name: pa.LAUNCHES[name] for name in (
                "paged_attention_decode", "paged_attention_ragged")}
        finally:
            stop.set()
            await server
            procs.shutdown(wait=True)
        return rows, launches, wants

    rows, launches, wants = asyncio.run(serve())
    for name, n in launches.items():
        print(f"[http] {name} launches in phase 5: {n}")
        if n == 0:
            fail(f"{name} was never launched in the HTTP phase")

    line = stats_line
    print(f"[http] {card}: {N_REQUESTS} streams ISL {ISL} OSL {OSL} over "
          f"HTTP (client-side, client in its own process): "
          f"{line(rows['http', None])}; median encode of a {ISL}-token "
          f"prompt's text {encode_ms:.2f} ms", flush=True)
    print(f"[http] {card}: the same traffic straight into the engine, "
          f"phase 3: {line(direct)}; phase 5, same loop and prompts: "
          f"{line(rows['direct', None])}", flush=True)
    print(f"[http] {card}: switch interval 0.5 ms (default 5 ms): HTTP "
          f"{line(rows['http', 0.0005])}; direct "
          f"{line(rows['direct', 0.0005])}", flush=True)
    for (how, interval), r in rows.items():
        print(f"[http] {card}: {how}, switch interval "
              f"{(interval or sys.getswitchinterval()) * 1e3:.1f} ms: "
              f"{r['steps']} steps, dispatch in the device-step thread p50 "
              f"{r['step_p50'] * 1e3:.2f} ms, gap before the next p50 "
              f"{r['gap_p50'] * 1e3:.3f} ms (sum {r['gap_sum'] * 1e3:.1f} "
              f"ms)", flush=True)
    us = frontend_us_per_token(tok, prompts, OSL)
    print(f"[http] {card}: frontend host work per generated token and "
          f"stream (pipeline + SSE framing, {N_REQUESTS} streams on one "
          f"loop, no socket, no device): {us:.1f} us; x {N_REQUESTS} streams "
          f"= {us * N_REQUESTS / 1e3:.2f} ms per decode step", flush=True)
    return dict(tokenizer=path, prompts=prompts, wants=wants,
                http=rows["http", None])

# ------------------------------ phase 6 ----------------------------------

DIST_LEASE_TTL_S = 2.0
# A SIGKILLed worker stays listed until its lease expires (at most the TTL
# plus the store's 0.25 s sweep after its last keepalive), and a migrated
# stream's retry may be routed to it meanwhile and spend an attempt on a
# refused connection (the JAX package does the same). 8 attempts, with
# Migration's doubling backoff from 0.05 s, outlast that window.
DIST_MIGRATION_LIMIT = 8
DIST_OSL_MIGRATE = 512
# the kill lands once every in-process token stream has this many of its
# 512 tokens, then at A's next load snapshot (<= 1 s later): with decode
# windows replayed as graphs a stream makes ~120 tokens a second, so a
# fixed delay could land after the streams end
DIST_KILL_AFTER_TOKENS = 64
DIST_LOGS = os.path.join("build", "dist")
# worker B's canary period (JAX default 10 s): the first canary lands
# within a second of B's start
DIST_CANARY_S = 1.0
# the control plane's settings on worker B (spec worker) and the frontends
DIST_CONTROL_ENV = dict(DYNTPU_SYSTEM_ENABLED="1",
                        DYNTPU_HEALTH_CHECK_ENABLED="1",
                        DYNTPU_HEALTH_CHECK_PERIOD_S=str(DIST_CANARY_S),
                        DYNTPU_PLANNER_APPLY_DEGRADATION="1")
# the KV frontend's router.select spans (worker_id, overlap_blocks)
KV_SPANS = os.path.join(DIST_LOGS, "kv_spans.jsonl")
KV_GROUPS = 4
KV_PREFIX_TOKENS = 448      # 28 blocks of 16, shared within a group


def kv_group_prompts():
    """Phase 6's shared-prefix traffic, as token ids: per group, a prefix of
    ``KV_PREFIX_TOKENS`` and six prompts of ISL tokens that continue it
    with tokens of their own (a warm-up, a check, 4 for the concurrent
    runs)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 6)

    def ids(n):
        return torch.randint(256, N_REGULAR, (n,), generator=gen).tolist()
    groups = []
    for _ in range(KV_GROUPS):
        prefix = ids(KV_PREFIX_TOKENS)
        groups.append([prefix + ids(ISL - KV_PREFIX_TOKENS)
                       for _ in range(6)])
    return groups


def read_jsonl(path):
    """The complete lines of a JSONL file another process appends to."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().split("\n")[:-1]]


def log_records(text: str):
    """The records of a log written with ``DYNTPU_JSONL_LOGGING=1``."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("{"):
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                pass
    return out


def hash_us_per_prompt(n: int = 200):
    """Host µs to hash one ISL-token prompt into its chained block hashes
    at block size 16 (``compute_block_hashes_for_seq``, what the KV router
    runs per request): the port's xxh3 beside the blake2b chain it
    replaced. Checks the reference's hashes of tokens 0..31 first."""
    import hashlib
    import random
    import struct

    from dynamo_tpu_torch.tokens import compute_block_hashes_for_seq

    want = [15310707395893867146, 7844343420941177057]
    if compute_block_hashes_for_seq(list(range(32)), 16) != want:
        fail("block hashes of tokens 0..31 differ from the JAX package's")
    key = struct.pack("<Q", 1337)

    def blake2b_chain(tokens, bs):
        out, parent = [], None
        for start in range(0, len(tokens) - bs + 1, bs):
            payload = struct.pack(f"<{bs}I", *tokens[start:start + bs])
            if parent is not None:
                payload = struct.pack("<Q", parent) + payload
            parent = int.from_bytes(hashlib.blake2b(
                payload, digest_size=8, key=key).digest(), "little")
            out.append(parent)
        return out
    rng = random.Random(SEED)
    tokens = [rng.randrange(N_REGULAR) for _ in range(ISL)]
    out = []
    for fn in (compute_block_hashes_for_seq, blake2b_chain):
        fn(tokens, 16)
        t0 = time.perf_counter()
        for _ in range(n):
            fn(tokens, 16)
        out.append((time.perf_counter() - t0) / n * 1e6)
    return out


class Child:
    """One entry point run as ``python -m MODULE ARGS`` in a process of its
    own, its output in ``build/dist/NAME.log``."""

    def __init__(self, name: str, module: str, args, env):
        os.makedirs(DIST_LOGS, exist_ok=True)
        self.name = name
        self.log_path = os.path.join(DIST_LOGS, f"{name}.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args], stdout=self._log,
            stderr=subprocess.STDOUT, env=env)
        self.pid = self.proc.pid

    def text(self) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def tail(self, n: int = 40) -> str:
        return "\n".join(self.text().splitlines()[-n:])

    async def wait_for(self, pattern: str, timeout: float):
        import asyncio

        deadline = time.monotonic() + timeout
        while True:
            m = re.search(pattern, self.text())
            if m:
                return m
            if self.proc.poll() is not None:
                fail(f"{self.name} exited ({self.proc.returncode}) before "
                     f"{pattern!r}:\n{self.tail()}")
            if time.monotonic() > deadline:
                fail(f"{self.name}: no {pattern!r} in {timeout} s:\n"
                     f"{self.tail()}")
            await asyncio.sleep(0.1)

    def cpu_s(self) -> float:
        """User + system CPU seconds so far (stat(5) fields 14 and 15)."""
        with open(f"/proc/{self.pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) \
            / os.sysconf("SC_CLK_TCK")

    def opens_gpu(self) -> bool:
        """Whether the process holds a GPU device file open (a CUDA
        context does)."""
        for fd in os.listdir(f"/proc/{self.pid}/fd"):
            try:
                target = os.readlink(f"/proc/{self.pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                return True
        return False

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._log.close()


def smi_compute_pids() -> set:
    """PIDs that ``nvidia-smi`` lists as holding a CUDA context."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return {int(x) for x in smi.stdout.split() if x.isdigit()}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def codec_us_per_token(n: int = 20000):
    """Host µs per streamed token of the transport's codec: what a worker
    packs (the output dict, then the data frame that carries it as its
    payload) and what the frontend unpacks (the frame, then the payload)."""
    from dynamo_tpu_torch.runtime import codec

    item = {"token_ids": [91234], "index": 17, "finished": False,
            "finish_reason": None, "num_prompt_tokens": ISL}
    rid = "0123456789abcdef0123456789abcdef-17"

    def pack():
        return codec.packb({"t": "data", "rid": rid,
                            "payload": codec.packb(item)})
    frame = pack()

    def unpack():
        return codec.unpackb(codec.unpackb(frame)["payload"])
    if unpack() != item:
        fail("codec round trip of a token frame changed it")
    out = []
    for fn in (pack, unpack):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
    return out


# phase 6's aggregated worker's numbers, which phase 7 compares with
DIST_STATS: dict = {}


def phase_dist(card: str, served: dict, direct: dict) -> dict:
    """The distributed path, three processes: the store, worker A and the
    frontend (``python -m dynamo_tpu_torch.runtime.store|worker|frontend``),
    then worker B. Checks: texts served one at a time equal phase 5's
    (decode of phase 3's engine ids), only the worker holds the GPU, 16
    concurrent streams end in ``[DONE]``, both workers publish load metrics
    and serve under round robin, a ``--router-mode kv`` frontend on the
    same store sends each prefix group's second request to the group's
    holder with >= 28 blocks matched, every stream through either frontend
    survives a SIGKILL of worker A mid-stream with its full token count, a
    migrated stream goes on at the join as worker B goes on from the
    prompt plus the tokens carried over, A's keys leave the store within
    the lease TTL + 1 s, worker B drains on SIGTERM and exits 0, both
    frontends exit 0, and both attention faces launched in every worker
    that served. Returns the workers' summed kernel launches, the
    KV-routed traffic's included."""
    import asyncio
    import importlib.util
    import multiprocessing
    import signal
    from concurrent.futures import ProcessPoolExecutor

    from dynamo_tpu_torch.llm.entrypoint import PushSink
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.runtime import codec
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_seq
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    root = os.path.dirname(os.path.abspath(__file__))
    if os.path.exists(KV_SPANS):
        os.remove(KV_SPANS)
    env = dict(os.environ, DYNTPU_LEASE_TTL_S=str(DIST_LEASE_TTL_S),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    addr = f"127.0.0.1:{_free_port()}"
    worker_args = ["--model", "1b", "--model-name", HTTP_MODEL,
                   "--tokenizer", os.path.abspath(served["tokenizer"]),
                   "--store-addr", addr,
                   "--migration-limit", str(DIST_MIGRATION_LIMIT)]
    children = []
    faces = ("paged_attention_decode", "paged_attention_ragged")

    def start(name, module, args, **extra_env):
        child = Child(name, module, args, dict(env, **extra_env))
        children.append(child)
        return child

    def job(prompt, max_tokens, stream=True, port=None):
        out = dict(method="POST", path="/v1/completions", body={
            "model": HTTP_MODEL, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0, "ignore_eos": True, "stream": stream})
        if port is not None:
            out["port"] = port
        return out

    def greedy(ids, max_tokens):
        return {"token_ids": list(ids), "max_tokens": max_tokens,
                "temperature": 0.0, "ignore_eos": True}

    def check_streams(results, n_tokens, what):
        runs = []
        for status, t_sent, frames, done, _ in results:
            content = [t for t, f in frames if f["choices"][0]["text"]]
            n = frames[-1][1]["usage"]["completion_tokens"] if frames else 0
            if status != 200 or not done or n != n_tokens \
                    or len(content) < 2:
                fail(f"{what}: HTTP {status}, [DONE] {done}, {n} of "
                     f"{n_tokens} tokens, {len(content)} content frames")
            runs.append((t_sent, content[0], content[-1], n))
        return runs

    async def run():
        loop = asyncio.get_running_loop()
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        rt = None
        collectors = []
        clients = []
        try:
            t0 = time.perf_counter()
            store = start("store", "dynamo_tpu_torch.runtime.store",
                          ["--host", "127.0.0.1",
                           "--port", addr.rsplit(":", 1)[1]])
            await store.wait_for(r"store listening", 60)
            worker_a = start("worker_a", "dynamo_tpu_torch.worker",
                             worker_args)
            f_sys = _free_port()
            front = start("frontend", "dynamo_tpu_torch.frontend",
                          ["--host", "127.0.0.1", "--port", "0",
                           "--store-addr", addr],
                          DYNTPU_SYSTEM_ENABLED="1",
                          DYNTPU_SYSTEM_PORT=str(f_sys))
            port = int((await front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))
            await worker_a.wait_for(r"registered model", 300)

            async def client(*jobs):
                return await loop.run_in_executor(procs, http_client, port,
                                                  list(jobs))

            async def admin(sys_port, method, path):
                (status, _, _, _, body), = await client(dict(
                    method=method, path=path, port=sys_port))
                return status, body
            while True:
                (status, _, _, _, body), = await client(
                    dict(method="GET", path="/v1/models"))
                if status == 200 and any(m["id"] == HTTP_MODEL
                                         for m in body["data"]):
                    break
                if time.perf_counter() - t0 > 300:
                    fail(f"/v1/models never listed {HTTP_MODEL}: {body}")
                await asyncio.sleep(0.2)
            print(f"[dist] store, worker A (Llama-3.2-1B width, seed 0) "
                  f"and frontend up, /v1/models lists the model, in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            # only the worker holds the GPU
            smi_pids = smi_compute_pids()
            ours = {c.pid for c in (store, worker_a, front)}
            holds = {c.name: (c.pid in smi_pids or c.opens_gpu())
                     for c in (store, worker_a, front)}
            print(f"[dist] GPU holders: nvidia-smi compute apps "
                  f"{sorted(smi_pids)} (ours {sorted(smi_pids & ours)}); "
                  f"store {holds['store']}, worker A {holds['worker_a']}, "
                  f"frontend {holds['frontend']}", flush=True)
            if not holds["worker_a"] or holds["store"] or holds["frontend"]:
                fail(f"only worker A may hold the GPU: {holds}")

            rt = await DistributedRuntime.from_settings(RuntimeConfig(
                store_addr=addr, lease_ttl_s=DIST_LEASE_TTL_S))
            backend = rt.namespace().component("backend")
            gen_client = await backend.endpoint("generate").client()
            clear_client = await backend.endpoint("clear_kv_blocks").client()
            clients += [gen_client, clear_client]
            await gen_client.wait_for_instances(1, 30)
            await clear_client.wait_for_instances(1, 30)
            a_id, = gen_client.instance_ids()

            async def clear_all():
                # no prefix hit may change a prefill's shape (phase 5)
                for iid in clear_client.instance_ids():
                    async for _ in clear_client.direct(iid, {}, Context()):
                        pass

            # 1. served one at a time: the texts of phase 5
            for i, (p, want) in enumerate(zip(served["prompts"],
                                              served["wants"])):
                await clear_all()
                (status, _, frames, done, body), = await client(
                    job(p, OSL, stream=i % 2 == 0))
                if status != 200:
                    fail(f"distributed completion: HTTP {status}: {body}")
                if i % 2:
                    got = body["choices"][0]["text"]
                else:
                    if not done:
                        fail("a streamed completion did not end in [DONE]")
                    got = "".join(f["choices"][0]["text"] for _, f in frames)
                if got != want:
                    at = next((j for j, (a, b) in enumerate(zip(got, want))
                               if a != b), min(len(got), len(want)))
                    fail(f"distributed request {i}: text differs from phase "
                         f"5's at char {at}: {got[at:at + 40]!r} vs "
                         f"{want[at:at + 40]!r}")
            print(f"[dist] {len(served['wants'])} completions served one at "
                  f"a time (2 streamed): text equals decode of phase 3's "
                  f"engine ids", flush=True)

            # 2. phase 3's traffic through the three processes
            prompts = served["prompts"]
            await clear_all()
            cpu0 = {c.name: c.cpu_s() for c in (store, worker_a, front)}
            t_start = time.perf_counter()
            results = await client(*(job(p, OSL) for p in prompts))
            wall = time.perf_counter() - t_start
            cpu = {c.name: c.cpu_s() - cpu0[c.name]
                   for c in (store, worker_a, front)}
            stats = traffic_stats(check_streams(results, OSL, "stream"),
                                  wall)
            DIST_STATS["aggregated"] = stats
            n_tok = N_REQUESTS * OSL
            print(f"[dist] {card}: {N_REQUESTS} streams ISL {ISL} OSL {OSL} "
                  f"through store + worker A + frontend (client in its own "
                  f"process): {stats_line(stats)}", flush=True)
            print(f"[dist] {card}: the same traffic, phase 3 (straight into "
                  f"the engine): {stats_line(direct)}; phase 5 (in-process "
                  f"HTTP): {stats_line(served['http'])}", flush=True)
            print(f"[dist] {card}: CPU time per generated token over the run "
                  f"({n_tok} tokens, {wall:.3f} s): worker A "
                  f"{cpu['worker_a'] / n_tok * 1e3:.3f} ms, frontend "
                  f"{cpu['frontend'] / n_tok * 1e3:.3f} ms, store "
                  f"{cpu['store'] / n_tok * 1e3:.4f} ms", flush=True)
            xxh3_us, blake2b_us = hash_us_per_prompt()
            has_xxhash = importlib.util.find_spec("xxhash") is not None
            print(f"[hash] {card}: block hashes of one {ISL}-token prompt "
                  f"at block size 16 ({ISL // 16} blocks) on this host: "
                  f"xxh3 (port, pure Python) {xxh3_us:.1f} us, blake2b "
                  f"chain it replaced {blake2b_us:.1f} us; xxhash is "
                  + ("installed here, not timed (this script imports none "
                     "of it)" if has_xxhash else "not installed here"),
                  flush=True)
            pack_us, unpack_us = codec_us_per_token()
            print(f"[dist] {card}: codec per streamed token on this host: "
                  f"worker packs payload + frame {pack_us:.2f} us, frontend "
                  f"unpacks frame + payload {unpack_us:.2f} us; x "
                  f"{N_REQUESTS} streams = {pack_us * N_REQUESTS / 1e3:.3f} "
                  f"ms of worker loop per decode step", flush=True)

            # 3. two workers: load metrics, round robin, migration
            snaps = {}
            sub = await rt.store.subscribe(
                backend.event_subject("load_metrics"))

            async def collect():
                async for ev in sub:
                    if ev.get("event") != "msg":
                        continue
                    snap = codec.unpackb(ev["value"])
                    # a worker's first snapshot may leave before its
                    # launch counts are attached
                    if "kernel_launches" in snap:
                        snaps.setdefault(int(snap["worker_id"]),
                                         []).append((time.perf_counter(), snap))
            # the sequence hashes each worker's kv_events say it holds: the
            # KV frontend's router reads the same messages
            stored = {}
            kv_sub = await rt.store.subscribe(
                backend.event_subject("kv_events"))

            async def collect_kv():
                async for ev in kv_sub:
                    if ev.get("event") != "msg":
                        continue
                    msg = codec.unpackb(ev["value"])
                    held = stored.setdefault(int(msg["worker_id"]), set())
                    kind = msg["event"]["kind"]
                    blocks = msg["event"].get("blocks", ())
                    if kind == "stored":
                        held.update(b["seq_hash"] for b in blocks)
                    elif kind == "removed":
                        held.difference_update(blocks)
                    else:
                        held.clear()
            collectors += [asyncio.create_task(collect()),
                           asyncio.create_task(collect_kv())]
            t_b = time.perf_counter()
            b_sys = _free_port()
            worker_b = start("worker_b", "dynamo_tpu_torch.worker",
                             [*worker_args, "--spec-mode", "ngram",
                              "--spec-k", str(SPEC_K)],
                             DYNTPU_SYSTEM_PORT=str(b_sys),
                             **DIST_CONTROL_ENV)
            await gen_client.wait_for_instances(2, 300)
            await clear_client.wait_for_instances(2, 30)
            b_id, = [i for i in gen_client.instance_ids() if i != a_id]
            print(f"[dist] worker B up in {time.perf_counter() - t_b:.1f} s",
                  flush=True)
            while not (snaps.get(a_id) and snaps.get(b_id)):
                if time.perf_counter() - t_b > 330:
                    fail(f"load metrics from {sorted(snaps)}, want both "
                         f"{a_id} and {b_id}")
                await asyncio.sleep(0.1)

            # the control plane on B: the canary probe on /health, /live,
            # and the frontend's own system server
            t_cp = time.perf_counter()
            while True:
                status, health = await admin(b_sys, "GET", "/health")
                canary = (health.get("probes", {}).get("backend/generate",
                                                       {})
                          if isinstance(health, dict) else {})
                if canary.get("probes", 0) >= 1:
                    break
                if time.perf_counter() - t_cp > 30:
                    fail(f"worker B's /health never ran its canary: "
                         f"{status} {health}")
                await asyncio.sleep(0.2)
            live = await admin(b_sys, "GET", "/live")
            f_health = await admin(f_sys, "GET", "/health")
            f_live = await admin(f_sys, "GET", "/live")
            print(f"[control] worker B (--spec-mode ngram) /health: HTTP "
                  f"{status} {json.dumps(health)}; /live {live}; frontend "
                  f"/health {f_health}, /live {f_live}; B's load snapshot "
                  f"spec {snaps[b_id][-1][1].get('spec')}, obs keys "
                  f"{len(snaps[b_id][-1][1].get('obs', {}))} (in "
                  f"{time.perf_counter() - t_cp:.1f} s)", flush=True)
            if status != 200 or canary.get("healthy") is not True \
                    or live != (200, {"live": True}) \
                    or f_health[0] != 200 or f_live != (200, {"live": True}) \
                    or "spec" not in snaps[b_id][-1][1] \
                    or "obs" not in snaps[b_id][-1][1]:
                fail("worker B's or the frontend's control plane did not "
                     "answer as expected")

            def decode_launches(wid):
                return snaps[wid][-1][1]["kernel_launches"][faces[0]]
            before = {w: decode_launches(w) for w in (a_id, b_id)}
            before_r = {w: snaps[w][-1][1]["kernel_launches"][faces[1]]
                        for w in (a_id, b_id)}
            await clear_all()
            t_rr = time.perf_counter()
            results = await client(*(job(p, OSL) for p in prompts))
            check_streams(results, OSL, "round-robin stream")
            await asyncio.sleep(1.5)   # one more snapshot from each
            for w, name in ((a_id, "A"), (b_id, "B")):
                running = max((s["num_requests_running"]
                               for t, s in snaps[w] if t >= t_rr), default=0)
                grew = decode_launches(w) - before[w]
                grew_r = (snaps[w][-1][1]["kernel_launches"][faces[1]]
                          - before_r[w])
                print(f"[dist] worker {name} under {N_REQUESTS} round-robin "
                      f"streams: load metrics show up to {running} running "
                      f"requests, {grew} more decode-face and {grew_r} more "
                      f"ragged-face launches", flush=True)
                # worker B's verify windows run the ragged face
                if (grew if name == "A" else grew_r) <= 0:
                    fail(f"worker {name} served nothing under round robin")
            # B's engine gauges after the traffic (refreshed at each load
            # snapshot, over the recorder's trailing 10 s)
            status, text = await admin(b_sys, "GET", "/metrics")
            m = re.search(r'^dynamo_engine_mfu_by_class\{step="decode"\} '
                          r'(\S+)$', text or "", re.M)
            waste = re.search(r'^dynamo_engine_wasted_flops_ratio\{cause='
                              r'"spec_reject"\} (\S+)$', text or "", re.M)
            print(f"[control] worker B /metrics after the traffic: HTTP "
                  f"{status}, engine_mfu_by_class{{step=\"decode\"}} "
                  f"{m.group(1) if m else None}, engine_wasted_flops_ratio"
                  f"{{cause=\"spec_reject\"}} "
                  f"{waste.group(1) if waste else None}", flush=True)
            if status != 200 or not m or float(m.group(1)) <= 0 or not waste:
                fail("worker B's /metrics lacks the decode MFU or the "
                     "spec_reject waste gauge")

            # 4. the KV-aware router: a second frontend on the same store
            name_of = {a_id: "A", b_id: "B"}
            t_kv = time.perf_counter()
            kv_sys = _free_port()
            kv_front = start(
                "frontend_kv", "dynamo_tpu_torch.frontend",
                ["--host", "127.0.0.1", "--port", "0", "--store-addr", addr,
                 "--router-mode", "kv", "--max-concurrent-requests", "64"],
                DYNTPU_SYSTEM_ENABLED="1", DYNTPU_SYSTEM_PORT=str(kv_sys),
                DYNTPU_TRACE_SAMPLE_RATIO="1",
                DYNTPU_TRACE_EXPORT_PATH=os.path.abspath(KV_SPANS),
                DYNTPU_JSONL_LOGGING="1")
            kv_port = int((await kv_front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))
            while True:
                (status, _, _, _, body), = await client(dict(
                    method="GET", path="/v1/models", port=kv_port))
                if status == 200 and any(m["id"] == HTTP_MODEL
                                         for m in body["data"]):
                    break
                if time.perf_counter() - t_kv > 60:
                    fail(f"the KV frontend never listed {HTTP_MODEL}: {body}")
                await asyncio.sleep(0.2)
            print(f"[dist] KV frontend (--router-mode kv) up on the same "
                  f"store in {time.perf_counter() - t_kv:.1f} s", flush=True)
            groups = kv_group_prompts()

            def selections():
                return [s for s in read_jsonl(KV_SPANS)
                        if s["name"] == "router.select"]

            async def one_by_one(ps, port):
                sels = []
                for p in ps:
                    n = len(selections())
                    results = await client(job(p, OSL, port=port))
                    check_streams(results, OSL, "shared-prefix stream")
                    new = selections()[n:]
                    sels.append(new[-1]["attrs"] if new else None)
                return sels

            def cached_tokens():
                # prefix-cache hits are counted in blocks of 16 tokens
                return {w: snaps[w][-1][1]["prefix_cache_hits"] * 16
                        for w in (a_id, b_id)}

            await clear_all()
            sels = await one_by_one([g[0] for g in groups], kv_port)
            if None in sels:
                fail(f"the KV frontend exported no router.select span for "
                     f"a request: {sels}")
            holders = [s["worker_id"] for s in sels]
            prefixes = [set(compute_block_hashes_for_seq(
                g[0][:KV_PREFIX_TOKENS], 16)) for g in groups]
            t_ix = time.perf_counter()
            while not all(p <= stored.get(h, set())
                          for p, h in zip(prefixes, holders)):
                if time.perf_counter() - t_ix > 30:
                    fail("the holders' kv_events never carried every "
                         "prefix block of the first requests")
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.5)   # the KV frontend applies the same
            checks = await one_by_one([g[1] for g in groups], kv_port)
            if None in checks:
                fail(f"the KV frontend exported no router.select span for "
                     f"a request: {checks}")
            print(f"[dist] KV router, {KV_GROUPS} prefix groups of "
                  f"{KV_PREFIX_TOKENS} tokens ({KV_PREFIX_TOKENS // 16} "
                  f"blocks) + {ISL - KV_PREFIX_TOKENS} own, one request at "
                  f"a time: first requests on "
                  + ", ".join(name_of[w] for w in holders)
                  + "; second requests on " + ", ".join(
                      f"{name_of.get(s['worker_id'])} with "
                      f"{s['overlap_blocks']} blocks" for s in checks),
                  flush=True)
            for g, (h, s) in enumerate(zip(holders, checks)):
                if s["worker_id"] != h \
                        or s["overlap_blocks"] < KV_PREFIX_TOKENS // 16:
                    fail(f"group {g}'s second request went to "
                         f"{name_of.get(s['worker_id'])} with "
                         f"{s['overlap_blocks']} blocks, not to its holder "
                         f"{name_of[h]} with >= {KV_PREFIX_TOKENS // 16}")

            # the same 16 shared-prefix requests through each frontend
            concurrent = [p for g in groups for p in g[2:]]
            for mode, fport in (("kv", kv_port), ("round robin", port)):
                if mode != "kv":
                    await clear_all()
                    await one_by_one([g[0] for g in groups], fport)
                await asyncio.sleep(1.2)   # a snapshot after the warm-up
                hits0 = cached_tokens()
                n = len(selections())
                t_run = time.perf_counter()
                results = await client(*(job(p, OSL, port=fport)
                                         for p in concurrent))
                wall = time.perf_counter() - t_run
                stats = traffic_stats(check_streams(
                    results, OSL, f"{mode} shared-prefix stream"), wall)
                await asyncio.sleep(1.5)   # one more snapshot from each
                hits = {w: c - hits0[w] for w, c in cached_tokens().items()}
                served_by = [s["attrs"]["worker_id"]
                             for s in selections()[n:]]
                print(f"[dist] {card}: {len(concurrent)} concurrent "
                      f"shared-prefix streams (4 per group) through the "
                      f"{mode} frontend: {stats_line(stats)}; " + ", ".join(
                          f"worker {name_of[w]} "
                          + (f"served {served_by.count(w)} requests, "
                             if mode == "kv" else "")
                          + f"{hits[w]} prompt tokens from cache"
                          for w in (a_id, b_id)), flush=True)
            select_ms = sorted(s["duration_s"] * 1e3 for s in selections())
            print(f"[dist] KV router: {len(select_ms)} selections, "
                  f"router.select span p50 "
                  f"{select_ms[len(select_ms) // 2]:.3f} ms max "
                  f"{select_ms[-1]:.3f} ms (hash of the prompt, index "
                  f"match, cost function)", flush=True)

            # 5. a degradation order in the store (what the planner writes):
            # the KV frontend, which has an admission controller, sheds tier
            # 0 and admits tier 3; B's watcher gets the spec_k clamp; then
            # NO_DEGRADATION admits tier 0 again
            from dynamo_tpu_torch.planner.degradation import (
                NO_DEGRADATION, DegradationLadder,
            )
            t_deg = time.perf_counter()
            ladder = DegradationLadder()
            while "clamp_spec_k" not in ladder.engaged:
                ladder.update(2.0)
            order = ladder.actions()
            deg_key = f"planner/{rt.namespace().name}/degradation"

            async def tiers():
                results = await client(*(dict(
                    method="POST", path="/v1/completions", port=kv_port,
                    headers={"X-Request-Tier": tier},
                    body={"model": HTTP_MODEL, "prompt": prompts[0],
                          "max_tokens": 4, "temperature": 0,
                          "ignore_eos": True}) for tier in ("0", "3")))
                return [r[0] for r in results]

            async def order_until(actions, want):
                await rt.store.put(deg_key, json.dumps(
                    dict(actions, ts=time.time())).encode())
                t_put = time.perf_counter()
                while True:
                    got = await tiers()
                    if got == want:
                        return time.perf_counter() - t_put
                    if time.perf_counter() - t_put > 15:
                        fail(f"degradation order {actions}: tiers 0 and 3 "
                             f"answer {got}, want {want}")
                    await asyncio.sleep(0.1)
            if await tiers() != [200, 200]:
                fail("tier 0 or 3 refused before any degradation order")
            shed_s = await order_until(order, [429, 200])
            clamp = await worker_b.wait_for(
                r"degradation orders applied to engine: .*"
                r"|degradation on_change failed[\s\S]*?\n([\w.]*Error: [^\n]*)",
                10)
            reopen_s = await order_until(dict(NO_DEGRADATION), [200, 200])
            print(f"[control] degradation order {json.dumps(order)} in "
                  f"{deg_key}: the KV frontend answered tier 0 with 429 and "
                  f"tier 3 with 200 {shed_s * 1e3:.0f} ms after the write; "
                  f"worker B: {clamp.group(1) or clamp.group(0)!r}; "
                  f"NO_DEGRADATION admitted tier 0 again {reopen_s * 1e3:.0f}"
                  f" ms after its write ({time.perf_counter() - t_deg:.1f} s "
                  f"in all)", flush=True)

            class Recorder(PushSink):
                """The frontend's routing sink, noting how many tokens its
                stream had yielded when each attempt was issued."""

                def __init__(self, got):
                    super().__init__(gen_client)
                    self.got, self.joins = got, []

                def generate(self, request, context):
                    self.joins.append(len(self.got))
                    return super().generate(request, context)

            progress = []

            async def token_stream(prompt):
                # the frontend's Migration over the generate endpoint, seen
                # as token ids
                got = []
                progress.append(got)
                sink = Recorder(got)
                async for item in Migration(sink, DIST_MIGRATION_LIMIT) \
                        .generate(greedy(prompt, DIST_OSL_MIGRATE), Context()):
                    got.extend(item.get("token_ids", []))
                return prompt, got, sink.joins

            # 4 streams through each frontend, so that both sinks are held
            # across the kill
            await clear_all()
            fut = asyncio.ensure_future(client(
                *(job(p, DIST_OSL_MIGRATE) for p in prompts[:4]),
                *(job(p, DIST_OSL_MIGRATE, port=kv_port)
                  for p in prompts[4:8])))
            token_futs = [asyncio.ensure_future(token_stream(p))
                          for p in prompts[8:16]]
            t_wait = time.perf_counter()
            while (len(progress) < len(token_futs)
                   or min(map(len, progress)) < DIST_KILL_AFTER_TOKENS):
                if time.perf_counter() - t_wait > 60:
                    fail("token streams did not reach "
                         f"{DIST_KILL_AFTER_TOKENS} tokens within 60 s")
                await asyncio.sleep(0.002)
            # kill right after A's next load snapshot, so the launch counts
            # it carries miss only the last milliseconds of A's work
            n_snaps = len(snaps[a_id])
            while len(snaps[a_id]) == n_snaps:
                await asyncio.sleep(0.002)
            a_launches = dict(snaps[a_id][-1][1]["kernel_launches"])
            n_sel = len(selections())
            t_kill, t_kill_unix = time.perf_counter(), time.time()
            worker_a.kill()
            while True:
                keys = [k for root_ in ("v1/instances/", "v1/models/")
                        for k, _ in await rt.store.get_prefix(root_)]
                if not any(k.endswith(f"/{a_id}") for k in keys):
                    break
                if time.perf_counter() - t_kill > DIST_LEASE_TTL_S + 1:
                    fail(f"worker A's keys still in the store "
                         f"{DIST_LEASE_TTL_S + 1} s after SIGKILL: {keys}")
                await asyncio.sleep(0.05)
            t_gone = time.perf_counter() - t_kill
            results = await fut
            check_streams(results, DIST_OSL_MIGRATE, "stream across SIGKILL")
            gaps = [sorted(min(t for t, f in frames
                               if t > t_kill and f["choices"][0]["text"])
                           - t_kill for _, _, frames, _, _ in part)
                    for part in (results[:4], results[4:])]
            # one log line per re-issue; a re-issue routed to A before its
            # lease expired (or, under the KV router, before A's breaker
            # opened) is refused and re-issued again
            reissued = [front.text().count("migrating with"),
                        kv_front.text().count("migrating with")]
            print(f"[dist] SIGKILL of worker A mid-stream: all 8 streams "
                  f"(4 per frontend) ended in [DONE] with "
                  f"{DIST_OSL_MIGRATE} tokens; A's instance and model keys "
                  f"left the store {t_gone * 1e3:.0f} ms after the kill "
                  f"(TTL {DIST_LEASE_TTL_S} s)", flush=True)
            # the KV frontend's re-issues are router.select spans of the
            # killed streams' traces
            killed = {s["trace_id"] for s in selections()[:n_sel]
                      if s["attrs"]["worker_id"] == a_id}
            reissues = [(s["start_unix"] - t_kill_unix,
                         name_of.get(s["attrs"]["worker_id"]),
                         s["attrs"]["overlap_blocks"])
                        for s in selections()[n_sel:]
                        if s["trace_id"] in killed]
            opened = [rec["ts"] - t_kill_unix
                      for rec in log_records(kv_front.text())
                      if "circuit OPEN" in rec.get("message", "")]
            for mode, part, n in zip(("round robin", "kv"), gaps, reissued):
                print(f"[dist] {mode} frontend across the kill: {n} "
                      f"re-issues by Migration (limit {DIST_MIGRATION_LIMIT} "
                      f"per stream); kill to each stream's next token: "
                      + ", ".join(f"{g * 1e3:.0f}" for g in part) + " ms",
                      flush=True)
            print(f"[dist] KV frontend re-issues (ms after the kill, "
                  f"instance, overlap blocks): " + ", ".join(
                      f"({t * 1e3:.0f}, {w}, {o})" for t, w, o in reissues)
                  + "; A's breaker opened " + (", ".join(
                      f"{t * 1e3:.0f}" for t in opened) + " ms after the kill"
                      if opened else "never"), flush=True)
            if not reissued[0] or not reissued[1] or not reissues:
                fail(f"a frontend migrated no stream off the killed worker: "
                     f"{reissued} re-issues, KV spans {reissues}")

            # The join, token by token: a migrated stream's next token must
            # be the one B makes of the prompt plus the carried tokens,
            # served alone. A Migration that loses the carried tokens, or
            # repeats or skips one at the join, departs there in every
            # migrated stream; bf16 near-ties (another batch, another
            # split-KV split) part streams one by one, within 16 tokens in
            # 7 of 12 migrated streams on an H100, the first token in none.
            joins = []
            for prompt, got, tried in await asyncio.gather(*token_futs):
                if len(got) != DIST_OSL_MIGRATE:
                    fail(f"token stream across SIGKILL: {len(got)} of "
                         f"{DIST_OSL_MIGRATE} tokens")
                if len(tried) < 2:
                    continue
                k = tried[-1]
                await clear_all()
                want = [t async for item in gen_client.direct(
                    b_id, greedy([*prompt, *got[:k]], 16), Context())
                        for t in item.get("token_ids", [])]
                agree = next((i for i, (a, b) in
                              enumerate(zip(got[k:], want)) if a != b),
                             len(want))
                joins.append((k, len(tried) - 1, agree))
            departed = sum(1 for _, _, agree in joins if agree == 0)
            print(f"[dist] {len(joins)} of 8 token-level streams migrated "
                  f"(carried tokens, re-issues, tokens after the join equal "
                  f"to B's alone, of 16): " + ", ".join(
                      f"({k}, {n}, {a})" for k, n, a in joins), flush=True)
            if len(joins) < 2 or departed == len(joins):
                fail(f"migrated streams depart from B's continuation at the "
                     f"join: {joins}")

            # worker B leaves by its system server's POST /drain
            t_drain = time.perf_counter()
            drain = await admin(b_sys, "POST", "/drain")
            rc = await loop.run_in_executor(None, worker_b.proc.wait, 120)
            drain_s = time.perf_counter() - t_drain
            log_b = worker_b.text()
            # B revokes its lease as it closes; if the revoke is lost, the
            # lease expires within its TTL
            while True:
                keys = [k for root_ in ("v1/instances/", "v1/models/")
                        for k, _ in await rt.store.get_prefix(root_)
                        if k.endswith(f"/{b_id}")]
                if not keys or time.perf_counter() - t_drain > \
                        drain_s + DIST_LEASE_TTL_S + 1:
                    break
                await asyncio.sleep(0.05)
            print(f"[control] POST /drain to worker B: {drain}; B exited "
                  f"{rc} after {drain_s:.2f} s, its keys left in the store: "
                  f"{keys}", flush=True)
            if drain != (202, {"draining": ["dynamo/backend/generate"]}) \
                    or rc != 0 or "drain requested" not in log_b or keys:
                fail(f"worker B on POST /drain: {drain}, exit {rc}, keys "
                     f"{keys}\n{worker_b.tail()}")
            m = re.search(r"worker exiting: kernel launches (.*)", log_b)
            b_launches = {k: int(v) for k, v in
                          (kv.split("=") for kv in m.group(1).split())}
            for f in (front, kv_front):
                f.proc.send_signal(signal.SIGTERM)
                rc = await loop.run_in_executor(None, f.proc.wait, 60)
                if rc != 0:
                    fail(f"{f.name} on SIGTERM: exit {rc}\n{f.tail()}")
            launches = {}
            # B decodes through spec windows, which run the ragged face
            for name, counts, need in (("A", a_launches, faces),
                                       ("B", b_launches, faces[1:])):
                print(f"[dist] worker {name} kernel launches: " + ", ".join(
                    f"{f} {counts[f]}" for f in faces), flush=True)
                for f in need:
                    if counts[f] == 0:
                        fail(f"{f} was never launched in worker {name}")
            for name in KERNELS:
                launches[name] = a_launches[name] + b_launches[name]
            print(f"[dist] phase 6 in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return launches
        finally:
            for task in collectors:
                task.cancel()
            for c in clients:
                await c.stop()
            if rt is not None:
                await rt.shutdown()
            procs.shutdown(wait=True)
            for child in children:
                child.kill()

    return asyncio.run(run())


# ------------------------- phase 7: KV movement ---------------------------

KV_BLOCKS = ISL // 16          # one 512-token prompt: 32 blocks of 16
KV_LOGS = os.path.join(DIST_LOGS, "kvmove")
# a stream is evacuated once every seat has emitted this many tokens
EVAC_AFTER_TOKENS = 16


def same_bytes(a, b) -> bool:
    """Bitwise equality of two tensors of one shape and dtype."""
    import torch

    a, b = a.contiguous(), b.contiguous()
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def kv_round_trip(card: str) -> None:
    """(a) ``make_kv_ops`` on the card at Llama-3.2-1B width (16 layers, 8
    KV heads, hd 64, block 16): gather 32 random blocks of a random cache
    to pinned host memory and scatter them into 32 other blocks in place,
    for bf16, int8 and fp8 pages (scales too); the host payload must equal
    a plain host copy of the cache bit for bit, the scattered blocks too,
    the cache tensors must keep their storage, and the decode face over the
    injected blocks must agree with its plain version. Prints the bf16
    gather + copy to pinned memory (ms, GB/s) for one 512-token prompt
    (16 MiB)."""
    import torch

    from dynamo_tpu_torch.engine import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = ModelConfig.llama3_1b()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    perm = torch.randperm(159, generator=torch.Generator().manual_seed(
        SEED)) + 1
    src, dst = perm[:KV_BLOCKS], perm[KV_BLOCKS:2 * KV_BLOCKS]
    for kv in ("bf16", "int8", "fp8"):
        eng = EngineConfig(num_blocks=160, kv_dtype=kv)
        cache = model_lib.init_cache(cfg, eng, torch.device(DEV))
        for key, layers in cache.items():
            for t in layers:
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                          device=DEV, dtype=torch.int8))
                elif key in ("ks", "vs"):
                    t.copy_(torch.rand(t.shape, generator=gen, device=DEV)
                            * 0.05 + 1e-3)
                else:
                    t.copy_(torch.randn(t.shape, generator=gen, device=DEV)
                            .to(t.dtype))
        host = {key: [t.cpu() for t in layers]
                for key, layers in cache.items()}
        want = {key: torch.stack([t[src] for t in layers])
                for key, layers in host.items()}
        ptrs = {key: [t.data_ptr() for t in layers]
                for key, layers in cache.items()}
        extract, inject = model_lib.make_kv_ops(eng)
        src_d = src.to(DEV, torch.int32)
        dst_d = dst.to(DEV, torch.int32)

        def gather_to_host():
            data = extract(cache, src_d)
            out = {}
            for key, a in data.items():
                out[key] = torch.empty(a.shape, dtype=a.dtype,
                                       pin_memory=True)
                out[key].copy_(a, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            return data, out
        data, got = gather_to_host()
        for key in want:
            if not same_bytes(got[key], want[key]):
                fail(f"[kvmove] {kv}: extracted {key} differs from the "
                     f"plain host copy")
        inject(cache, dst_d, data)
        torch.cuda.synchronize()
        for key, layers in cache.items():
            for li, t in enumerate(layers):
                if t.data_ptr() != ptrs[key][li]:
                    fail(f"[kvmove] {kv}: inject rebound cache[{key}][{li}]")
                if not same_bytes(t[dst_d].cpu(), want[key][li]):
                    fail(f"[kvmove] {kv}: injected {key} layer {li} differs "
                         f"from the source blocks")
                other = perm[2 * KV_BLOCKS:].to(DEV)
                if not same_bytes(t[other].cpu(), host[key][li][
                        perm[2 * KV_BLOCKS:]]):
                    fail(f"[kvmove] {kv}: inject wrote outside its blocks")
        # the decode face over the injected blocks, every layer's pages
        q = torch.randn(2, cfg.num_heads, cfg.head_dim_, generator=gen,
                        device=DEV).to(torch.bfloat16)
        i32 = dict(dtype=torch.int32, device=DEV)
        tables = torch.stack([dst_d, dst_d.flip(0)])
        lens = torch.tensor([ISL, ISL - 37], **i32)
        worst = 0.0
        for li in range(cfg.num_layers):
            sc = {}
            if kv != "bf16":
                sc = dict(k_scale=cache["ks"][li], v_scale=cache["vs"][li])
            o = pa.paged_attention_decode(
                q, cache["k"][li], cache["v"][li], tables, lens,
                block_size=16, **sc)
            p = pa.paged_attention_ragged_plain(
                q, cache["k"][li], cache["v"][li], tables,
                torch.tensor([0, 1, 2], **i32), torch.ones(2, **i32), lens,
                block_size=16, max_q_len=1, **sc)
            atol, rtol = TOL["bfloat16"]
            err = (o.float() - p.float()).abs()
            if not torch.isfinite(o).all() or \
                    (err - rtol * p.float().abs()).max().item() > atol:
                fail(f"[kvmove] {kv}: decode face over injected KV "
                     f"disagrees with its plain version (layer {li})")
            worst = max(worst, err.max().item())
        nbytes = sum(a.numel() * a.element_size() for a in data.values())
        line = (f"[kvmove] {card}: round trip {kv}: {KV_BLOCKS} blocks "
                f"({nbytes / 2**20:.2f} MiB with "
                f"{'scales' if kv != 'bf16' else 'no scales'}) gathered to "
                f"pinned host memory and scattered in place: bitwise equal "
                f"to the plain host copy; decode face over the injected "
                f"blocks vs plain, 16 layers, max |diff| {worst:.2e}")
        if kv == "bf16":
            times = []
            for _ in range(12):
                t0 = time.perf_counter()
                gather_to_host()
                times.append(time.perf_counter() - t0)
            ms = sorted(times[2:])[len(times[2:]) // 2] * 1e3
            line += (f"; gather + copy to pinned host p50 {ms:.3f} ms = "
                     f"{nbytes / ms / 1e6:.1f} GB/s")
        print(line, flush=True)
        del cache, host, data, got
    torch.cuda.empty_cache()


class LocalPrefillClient:
    """The decode handler's prefill client for engines in one process: its
    requests go straight to the prefill handler (the completion signal
    still rides the transport to the decode side's ``kv_inject``)."""

    def __init__(self, handler):
        self.handler = handler

    def instance_ids(self):
        return [1]

    def round_robin(self, request, context):
        from dynamo_tpu_torch.runtime.context import Context

        return self.handler.generate(request, Context())


def phase_kvmove_local(card: str, base, direct: dict) -> dict:
    """Phase 7 in this process: (a) the round trip; (b) a prefill engine
    and a decode engine on the card, joined by ``DevicePlane``, serve phase
    3's traffic through ``DecodeHandler``/``PrefillHandler``; (e) the
    preemption coordinator, triggered by ``POST /preempt`` on a system
    server, evacuates 16 mid-stream seats of one engine to the other (the
    co-resident peer), then 16 to the host tier, whose re-admission
    prefills onboard the spilled blocks. Streams are held against phase
    3's (``base``'s eager rerun, with the parity rule of ``check_parity``).
    Returns the launch counts of (b)."""
    import asyncio

    import torch

    from dynamo_tpu_torch.disagg import (
        DecodeHandler, DevicePlane, DisaggConfig, PrefillHandler,
    )
    from dynamo_tpu_torch.engine import (
        EngineConfig, InferenceEngine, ModelConfig,
    )
    from dynamo_tpu_torch.engine.engine import Request
    from dynamo_tpu_torch.kvbm.manager import KvbmConfig
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.runtime import preemption
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.system_server import SystemServer
    from dynamo_tpu_torch.runtime.transport import IngressServer

    kv_round_trip(card)
    cfg = ModelConfig.llama3_1b()
    prompts = main_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    want, rec = tapped_run(base, prompts)
    print(f"[kvmove] phase 3's traffic rerun on the phase 3 engine (depth "
          f"1, eager windows, logits recorded) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pre = InferenceEngine(cfg, EngineConfig(), seed=SEED)
    dec = InferenceEngine(cfg, EngineConfig(), seed=SEED)
    torch.cuda.synchronize()
    print(f"[kvmove] prefill and decode engines (seed {SEED}, bf16, "
          f"EngineConfig()) on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    plane = DevicePlane()
    ph = PrefillHandler(pre, plane=plane)
    dh = DecodeHandler(dec, LocalPrefillClient(ph),
                       DisaggConfig(min_remote_prefill_tokens=32),
                       plane=plane)
    moved = []
    transfer = plane.transfer

    async def counted(*a, **kw):
        n = await transfer(*a, **kw)
        moved.append(n)
        return n
    plane.transfer = counted
    out = {}

    async def one(handler, ids, n, stamps=None):
        t_sub = time.perf_counter()
        toks, times = [], []
        async for o in handler.generate(
                {"token_ids": ids, "max_tokens": n, "temperature": 0.0},
                Context()):
            toks.extend(o["token_ids"])
            times.append(time.perf_counter())
        if stamps is not None:
            stamps.append((t_sub, times))
        return toks

    async def disagg():
        server = IngressServer(dh.inject_handler(), host="127.0.0.1",
                               port=0)
        await server.start()
        dh.kv_inject_addr = f"127.0.0.1:{server.port}"
        try:
            await one(dh, prompts[0][:64], 4)       # warm-up
            for e in (pre, dec):
                e.clear_kv_blocks()
            moved.clear()
            n0 = dict(windows=dec.num_windows,
                      replays=dec._ap_window_fn.replays)
            remote0 = dh.num_remote_prefills
            pa.reset_launches()
            stamps = []
            t_start = time.perf_counter()
            outs = await asyncio.gather(*(one(dh, p, OSL, stamps)
                                          for p in prompts))
            wall = time.perf_counter() - t_start
            out["launches"] = dict(pa.LAUNCHES)
            out["stats"] = traffic_stats(
                [(t_sub, times[0], times[-1], len(times))
                 for t_sub, times in stamps], wall)
            out["remote"] = dh.num_remote_prefills - remote0
            out["windows"] = (dec.num_windows - n0["windows"],
                              dec._ap_window_fn.replays - n0["replays"])
            out["moved"] = list(moved)
            # the device plane and the engine's extract alone, one prompt
            # (16 MiB)
            seq, _ = await pre.prefill_held(Request("t-pre", prompts[1], 1))
            dseq = dec.reserve_sequence(Request("t-dec", prompts[1], 2))
            times = []
            for _ in range(12):
                t = time.perf_counter()
                await transfer(pre, seq.block_table, dec, dseq.block_table,
                               dst_seq_id=dseq.seq_id,
                               dst_epoch=dseq.kv_epoch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            out["plane_ms"] = sorted(times[2:])[5] * 1e3
            times = []
            for _ in range(12):
                t = time.perf_counter()
                data = await pre.extract_kv(seq)
                times.append(time.perf_counter() - t)
            out["extract_ms"] = sorted(times[2:])[5] * 1e3
            out["extract_bytes"] = sum(a.numel() * a.element_size()
                                       for a in data.values())
            pre.release_held(seq)
            dec.cancel_reservation(dseq)
            return outs
        finally:
            if hasattr(ph, "_transport"):
                await ph._transport.close()
            await server.stop()
            await pre.stop()
            await dec.stop()

    outs = asyncio.run(disagg())
    for i, o in enumerate(outs):
        if len(o) != OSL or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"[kvmove] disaggregated request {i}: {len(o)} tokens or "
                 f"an id out of range")
    if out["remote"] != N_REQUESTS or len(out["moved"]) != N_REQUESTS:
        fail(f"[kvmove] {out['remote']} remote prefills and "
             f"{len(out['moved'])} device-plane handoffs for {N_REQUESTS} "
             f"requests")
    windows, replays = out["windows"]
    if windows != replays or windows == 0:
        fail(f"[kvmove] the decode engine ran {windows} windows, "
             f"{replays} of them graph replays")
    for name in ("paged_attention_decode", "paged_attention_ragged"):
        if out["launches"].get(name, 0) == 0:
            fail(f"[kvmove] {name} never launched in the disaggregated run")
    partings = check_parity(want, rec, outs,
                            "phase 3's engine (eager rerun, aggregated)",
                            tag="[kvmove]")
    s = out["stats"]
    per = out["moved"][0]
    print(f"[kvmove] {card}: disaggregated in one process (device plane): "
          f"{N_REQUESTS} requests ISL {ISL} OSL {OSL}: {stats_line(s)}; "
          f"phase 3 aggregated: {stats_line(direct)}; {per / 2**20:.2f} MiB "
          f"per handoff ({KV_BLOCKS} blocks); {windows} decode windows, all "
          f"graph replays over injected KV; {len(partings)} of {N_REQUESTS} "
          f"streams part from phase 3's at near-ties; kernel launches "
          + ", ".join(f"{k}={v}" for k, v in out["launches"].items()
                      if v), flush=True)
    pb = out["extract_bytes"]
    print(f"[kvmove] {card}: one {ISL}-token prompt ({pb / 2**20:.2f} MiB "
          f"bf16): DevicePlane.transfer p50 {out['plane_ms']:.3f} ms = "
          f"{per / out['plane_ms'] / 1e6:.1f} GB/s (gather on the prefill "
          f"engine's step thread, in-place scatter on the decode engine's); "
          f"engine.extract_kv (to pinned host) p50 {out['extract_ms']:.3f} "
          f"ms = {pb / out['extract_ms'] / 1e6:.1f} GB/s", flush=True)

    # (e) preemption in this process: POST /preempt, peer then host tier
    def evacuate(src, peer, mode, tiered: bool):
        # the host-tier drill gives the coordinator no peer: it spills
        coord = preemption.PreemptionCoordinator(
            src, peer=peer if mode == preemption.PEER else None,
            notice_grace_s=0.0)

        async def run():
            tasks = []
            server = SystemServer(host="127.0.0.1", port=0)
            server.register_preempt("kvmove", lambda: tasks.append(
                asyncio.ensure_future(coord.notice("admin"))))
            await server.start()
            progress = [0] * N_REQUESTS

            async def stream(i):
                toks = {}
                reason = None
                async for o in src.submit(Request(
                        f"ev-{mode}-{i}", prompts[i], OSL)):
                    if o.token_id >= 0:
                        toks[o.index] = o.token_id
                    progress[i] = len(toks)
                    if o.finished:
                        reason = o.finish_reason
                return [toks[j] for j in sorted(toks)], reason
            try:
                jobs = [asyncio.ensure_future(stream(i))
                        for i in range(N_REQUESTS)]
                while min(progress) < EVAC_AFTER_TOKENS:
                    if any(j.done() for j in jobs):
                        fail(f"[kvmove] a stream ended before the notice "
                             f"({mode})")
                    await asyncio.sleep(0.001)
                t_notice = time.perf_counter()
                status, _, _, _, body = await _http_request(
                    server.port, "POST", "/preempt")
                if status != 202 or body != {"evacuating": ["kvmove"]}:
                    fail(f"[kvmove] POST /preempt: {status} {body}")
                report = await tasks[0]
                t_done = time.perf_counter()
                heads = await asyncio.gather(*jobs)
            finally:
                await server.stop()
            index = {f"ev-{mode}-{i}": i for i in range(N_REQUESTS)}
            spliced = [None] * N_REQUESTS
            next_tok = []

            async def resume(res):
                i = index[res.record.seq_id]
                head, reason = heads[i]
                if res.mode == preemption.FINISHED:
                    # the seat's last token landed before it was parked
                    if reason != "length":
                        fail(f"[kvmove] finished seat {i} ended {reason!r}")
                    spliced[i] = head
                    return
                if res.mode != mode or reason != "evacuated":
                    fail(f"[kvmove] stream {i}: {res.mode}, ended "
                         f"{reason!r} ({mode})")
                toks, times = [], []
                if res.mode == preemption.PEER:
                    it = peer.resume_prefilled(res.dst_seq,
                                               res.record.first_token())
                else:
                    it = peer.submit(res.record.resume_request())
                async for o in it:
                    toks.append(o.token_id)
                    times.append(time.perf_counter())
                if res.mode == preemption.PEER:
                    # index 0 re-emits the frontier token
                    spliced[i] = head + toks[1:]
                    next_tok.append(times[1] - t_notice)
                else:
                    spliced[i] = head + toks
                    next_tok.append(times[0] - t_notice)
            await asyncio.gather(*(resume(r) for r in report.results))
            await src.stop()
            await peer.stop()
            return report, spliced, sorted(next_tok), t_done - t_notice

        pa.reset_launches()
        report, spliced, next_tok, evac_s = asyncio.run(run())
        launches = {k: v for k, v in pa.LAUNCHES.items() if v}
        for name in ("paged_attention_decode", "paged_attention_ragged"):
            if not launches.get(name):
                fail(f"[kvmove] {name} never launched in the evacuation "
                     f"drill ({mode})")
        counts = {m: report.count(m) for m in (
            preemption.PEER, preemption.SPILL, preemption.FALLBACK,
            preemption.FINISHED)}
        # seats whose stream ends while earlier ones are moved finish in
        # place (FINISHED), as the coordinator intends
        if (counts[mode] == 0
                or counts[mode] + counts[preemption.FINISHED] != N_REQUESTS):
            fail(f"[kvmove] preemption ({mode}): report {counts}")
        for i, o in enumerate(spliced):
            if o is None or len(o) != OSL:
                fail(f"[kvmove] evacuated stream {i} resumed to "
                     f"{None if o is None else len(o)} of {OSL} tokens")
        parts = check_parity(want, rec, spliced,
                             f"phase 3's engine (evacuated: {mode})",
                             tag="[kvmove]")
        moved_b = [r.bytes_moved for r in report.results
                   if r.mode == mode]
        extra = ""
        if tiered:
            extra = (f"; the resuming engine onboarded "
                     f"{peer.kvbm.stats.onboarded_blocks} blocks from the "
                     f"host tier (prefix hit tokens "
                     f"{peer.scheduler.stats.prefix_cache_hits * 16})")
            if peer.kvbm.stats.onboarded_blocks == 0:
                fail("[kvmove] the resumed prefills onboarded nothing from "
                     "the host tier")
        print(f"[kvmove] {card}: POST /preempt with {N_REQUESTS} seats "
              f"{EVAC_AFTER_TOKENS}+ tokens in, evacuation to "
              + ("a co-resident peer engine" if mode == preemption.PEER
                 else "the host tier") +
              f": PreemptionReport {counts}, deadline_blown "
              f"{report.deadline_blown}; notice to report {evac_s * 1e3:.1f} "
              f"ms; {sum(moved_b) / len(moved_b) / 2**20:.2f} MiB moved per "
              f"seat; kill to next token p50 "
              f"{next_tok[len(next_tok) // 2] * 1e3:.1f} ms max "
              f"{next_tok[-1] * 1e3:.1f} ms; {len(parts)} of {N_REQUESTS} "
              f"spliced streams part from phase 3's at near-ties{extra}; "
              f"kernel launches (both engines) "
              + ", ".join(f"{k}={v}" for k, v in launches.items()),
              flush=True)

    evacuate(dec, pre, preemption.PEER, tiered=False)
    dec.attach_kvbm(KvbmConfig(host_blocks=4096))
    pre.attach_kvbm(KvbmConfig(host_blocks=4096))
    pre.kvbm.host_pool = dec.kvbm.host_pool
    dec.clear_kv_blocks()
    pre.clear_kv_blocks()
    evacuate(dec, pre, preemption.SPILL, tiered=True)
    del pre, dec
    torch.cuda.empty_cache()
    return out["launches"]


ONBOARD_CASE = "ragged R=1 q_len=16 after 496 onboarded keys, W=32"


def codec_ms_per_prompt(reps: int = 5):
    """Host ms of the relay's frame work for one 512-token bf16 prompt
    (16 MiB) at Llama-3.2-1B width: ``kv_to_wire`` (bytes + CRC32), the
    codec's pack, its unpack and ``kv_from_wire`` (size and CRC checks,
    tensors)."""
    import torch

    from dynamo_tpu_torch.disagg.protocol import kv_from_wire, kv_to_wire
    from dynamo_tpu_torch.runtime import codec

    gen = torch.Generator().manual_seed(SEED)
    shape = (16, KV_BLOCKS, 8, 16, 64)
    data = {k: torch.randn(shape, generator=gen).to(torch.bfloat16)
            for k in ("k", "v")}
    steps = {"kv_to_wire": 0.0, "pack": 0.0, "unpack": 0.0,
             "kv_from_wire": 0.0}
    for _ in range(reps):
        t0 = time.perf_counter()
        wire = kv_to_wire(data)
        t1 = time.perf_counter()
        raw = codec.packb(wire)
        t2 = time.perf_counter()
        back = codec.unpackb(raw)
        t3 = time.perf_counter()
        got = kv_from_wire(back)
        t4 = time.perf_counter()
        for k, (a, b) in zip(steps, ((t0, t1), (t1, t2), (t2, t3),
                                     (t3, t4))):
            steps[k] += (b - a) / reps * 1e3
    if not all(same_bytes(got[k], data[k]) for k in data):
        fail("[kvmove] the relay frame changed the payload")
    return steps, len(raw)


def phase_kvmove_procs(card: str, served: dict) -> dict:
    """Phase 7 across processes, on phase 6's store/frontend/worker entry
    points: (c) a ``--disagg-mode prefill --disagg-queue`` worker and a
    ``--disagg-mode decode`` worker serve phase 3's traffic through the
    frontend over the host relay, then a decode worker with
    ``--disagg-queue`` (the store's pull queue) does; (d) a worker with
    ``--kvbm-host-blocks`` and a G3 directory serves phase 6's shared-prefix
    groups, its G1 is cleared (``clear_kv_blocks``) and it serves them
    again: the second pass onboards from the host tier and its prefills run
    the ragged face over the onboarded prefix; (e) ``POST /preempt`` on that
    worker mid-stream spills every seat to its host tier and drains it.
    Returns the workers' kernel launches per part."""
    import asyncio
    import multiprocessing
    import signal
    from concurrent.futures import ProcessPoolExecutor

    from dynamo_tpu_torch.runtime import codec
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    steps, nraw = codec_ms_per_prompt()
    print(f"[kvmove] {card}: relay frame of one {ISL}-token bf16 prompt "
          f"({nraw / 2**20:.2f} MiB packed) on this host: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in steps.items()), flush=True)
    c = make_case(ONBOARD_CASE, [(16, 512, 16)], W=32, face="ragged")
    err = check_case(c)
    print(f"[kvmove] {ONBOARD_CASE} (the shape of a prefill over an "
          f"onboarded {ISL}-token prompt): kernel vs plain max |diff| "
          f"{err:.3e}", flush=True)
    del c

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DYNTPU_LEASE_TTL_S=str(DIST_LEASE_TTL_S),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    addr = f"127.0.0.1:{_free_port()}"
    common = ["--model", "1b", "--model-name", HTTP_MODEL,
              "--tokenizer", os.path.abspath(served["tokenizer"]),
              "--store-addr", addr]
    g3 = os.path.abspath(os.path.join(DIST_LOGS, "kvmove_g3"))
    if os.path.isdir(g3):
        for f in os.listdir(g3):
            os.remove(os.path.join(g3, f))
    children = []
    spans = {}

    def start(name, module, args, **extra_env):
        child = Child(name, module, args, dict(env, **extra_env))
        children.append(child)
        return child

    def traced(name):
        path = os.path.abspath(os.path.join(DIST_LOGS, f"{name}_spans.jsonl"))
        if os.path.exists(path):
            os.remove(path)
        spans[name] = path
        return dict(DYNTPU_TRACE_SAMPLE_RATIO="1",
                    DYNTPU_TRACE_EXPORT_PATH=path)

    def job(prompt, max_tokens):
        return dict(method="POST", path="/v1/completions", body={
            "model": HTTP_MODEL, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0, "ignore_eos": True, "stream": True})

    def streams(results, what):
        runs = []
        for status, t_sent, frames, done, _ in results:
            content = [t for t, f in frames if f["choices"][0]["text"]]
            n = frames[-1][1]["usage"]["completion_tokens"] if frames else 0
            if status != 200 or not done or n != OSL or len(content) < 2:
                fail(f"[kvmove] {what}: HTTP {status}, [DONE] {done}, {n} "
                     f"of {OSL} tokens")
            runs.append((t_sent, content[0], content[-1], n))
        return runs

    def launches_of(child):
        m = re.search(r"worker exiting: kernel launches (.*)", child.text())
        if m is None:
            fail(f"[kvmove] {child.name} left no launch counts:\n"
                 f"{child.tail()}")
        return {k: int(v) for k, v in
                (kv.split("=") for kv in m.group(1).split())}

    def durations(name, span):
        return sorted(s["duration_s"] for s in read_jsonl(spans[name])
                      if s["name"] == span)

    out = {}

    async def run():
        loop = asyncio.get_running_loop()
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        rt = None
        try:
            t0 = time.perf_counter()
            store = start("kv_store", "dynamo_tpu_torch.runtime.store",
                          ["--host", "127.0.0.1",
                           "--port", addr.rsplit(":", 1)[1]])
            await store.wait_for(r"store listening", 60)
            front = start("kv_frontend", "dynamo_tpu_torch.frontend",
                          ["--host", "127.0.0.1", "--port", "0",
                           "--store-addr", addr])
            port = int((await front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))

            async def client(*jobs):
                return await loop.run_in_executor(procs, http_client, port,
                                                  list(jobs))

            async def stop(child):
                child.proc.send_signal(signal.SIGTERM)
                rc = await loop.run_in_executor(None, child.proc.wait, 120)
                if rc != 0:
                    fail(f"[kvmove] {child.name} exited {rc} on SIGTERM:\n"
                         f"{child.tail()}")

            async def serve(decode, what):
                """Wait for ``decode`` to register, warm up, then phase 3's
                traffic through the frontend."""
                await decode.wait_for(r"registered model", 300)
                t_w = time.perf_counter()
                while True:
                    (status, *_), = await client(job(
                        served["prompts"][0], 4))
                    if status == 200:
                        break
                    if time.perf_counter() - t_w > 120:
                        fail(f"[kvmove] {what}: the frontend never served")
                    await asyncio.sleep(0.2)
                t_start = time.perf_counter()
                results = await client(*(job(p, OSL)
                                         for p in served["prompts"]))
                wall = time.perf_counter() - t_start
                return traffic_stats(streams(results, what), wall)

            # (c) disaggregated across processes, the host relay
            pre = start("kv_prefill", "dynamo_tpu_torch.worker",
                        [*common, "--disagg-mode", "prefill",
                         "--disagg-queue"], **traced("kv_prefill"))
            dec = start("kv_decode", "dynamo_tpu_torch.worker",
                        [*common, "--disagg-mode", "decode"],
                        **traced("kv_decode"))
            await pre.wait_for(r"worker ready", 300)
            agg = DIST_STATS.get("aggregated")
            for mode, flags in (("push", []), ("queue", ["--disagg-queue"])):
                if mode == "queue":
                    dec = start("kv_decode_q", "dynamo_tpu_torch.worker",
                                [*common, "--disagg-mode", "decode",
                                 *flags], **traced("kv_decode_q"))
                stats = await serve(dec, f"disaggregated ({mode})")
                await stop(dec)
                n_remote = len(durations(dec.name, "disagg.handoff"))
                inject = durations(dec.name, "disagg.inject")
                if n_remote < N_REQUESTS or len(inject) < N_REQUESTS:
                    fail(f"[kvmove] {mode}: {n_remote} handoffs and "
                         f"{len(inject)} relay injects for {N_REQUESTS} "
                         f"requests:\n{dec.tail()}")
                handoff = durations(dec.name, "disagg.handoff")
                out[f"decode_{mode}"] = launches_of(dec)
                print(f"[kvmove] {card}: disaggregated across processes "
                      f"({mode} mode, host relay): {N_REQUESTS} streams ISL "
                      f"{ISL} OSL {OSL}: {stats_line(stats)}; phase 6's "
                      f"aggregated worker: "
                      + (stats_line(agg) if agg else "not run")
                      + f"; handoff (reserve to inject done) p50 "
                      f"{handoff[len(handoff) // 2] * 1e3:.1f} ms; relay "
                      f"inject on the decode side (frame checks + scatter) "
                      f"p50 {inject[len(inject) // 2] * 1e3:.1f} ms",
                      flush=True)
            await stop(pre)
            push = durations("kv_prefill", "disagg.transfer")
            if len(push) < 2 * N_REQUESTS:
                fail(f"[kvmove] the prefill worker pushed {len(push)} "
                     f"frames for {2 * N_REQUESTS} requests")
            print(f"[kvmove] {card}: relay push per handoff on the prefill "
                  f"worker (extract done; frame, send, decode-side inject "
                  f"and ack) p50 {push[len(push) // 2] * 1e3:.1f} ms max "
                  f"{push[-1] * 1e3:.1f} ms over {len(push)} pushes",
                  flush=True)
            out["prefill"] = launches_of(pre)
            # prefills run on the prefill worker, decode windows on the
            # decode workers
            for who, name in (("prefill", "paged_attention_ragged"),
                              ("decode_push", "paged_attention_decode"),
                              ("decode_queue", "paged_attention_decode")):
                if out[who].get(name, 0) == 0:
                    fail(f"[kvmove] {name} never launched in the {who} "
                         f"worker")
            print(f"[kvmove] kernel launches: prefill worker {out['prefill']}"
                  f"; decode worker (push) {out['decode_push']}; decode "
                  f"worker (queue) {out['decode_queue']}", flush=True)

            # (d) KVBM + prefix cache on one worker
            k_sys = _free_port()
            # a short notice grace: the drill's seats must still be
            # decoding when the evacuation starts
            kw = start("kv_kvbm", "dynamo_tpu_torch.worker",
                       [*common, "--kvbm-host-blocks", "4096",
                        "--kvbm-disk-dir", g3, "--kvbm-disk-blocks", "4096"],
                       DYNTPU_SYSTEM_ENABLED="1",
                       DYNTPU_SYSTEM_PORT=str(k_sys),
                       DYNTPU_PREEMPT_NOTICE_GRACE_S="0.2")
            await kw.wait_for(r"registered model", 300)
            rt = await DistributedRuntime.from_settings(RuntimeConfig(
                store_addr=addr, lease_ttl_s=DIST_LEASE_TTL_S))
            backend = rt.namespace().component("backend")
            gen = await backend.endpoint("generate").client()
            clear = await backend.endpoint("clear_kv_blocks").client()
            await gen.wait_for_instances(1, 60)
            await clear.wait_for_instances(1, 60)
            snaps = []
            sub = await rt.store.subscribe(
                backend.event_subject("load_metrics"))

            async def collect():
                async for ev in sub:
                    if ev.get("event") == "msg":
                        snap = codec.unpackb(ev["value"])
                        if "kernel_launches" in snap and "kvbm" in snap:
                            snaps.append((time.perf_counter(), snap))
            collector = asyncio.create_task(collect())

            async def fresh_snapshot():
                t = time.perf_counter()
                while not snaps or snaps[-1][0] <= t:
                    if time.perf_counter() - t > 30:
                        fail("[kvmove] the KVBM worker published no load "
                             "metrics")
                    await asyncio.sleep(0.05)
                return snaps[-1][1]

            async def drained():
                # the idle drain offloads every sealed block
                last = None
                for _ in range(200):
                    snap = await fresh_snapshot()
                    n = snap["kvbm"]["offloaded_total"]
                    if n == last and n > 0:
                        return snap
                    last = n
                fail("[kvmove] the offload backlog never drained")
            groups = kv_group_prompts()
            ps = [p for g in groups for p in g[2:6]]
            await serve(kw, "KVBM worker")        # warm-up + phase 3 traffic
            passes = []
            for i in range(2):
                if i:
                    async for _ in clear.direct(clear.instance_ids()[0], {},
                                                Context()):
                        pass
                before = await drained()
                t_start = time.perf_counter()
                results = await client(*(job(p, OSL) for p in ps))
                wall = time.perf_counter() - t_start
                stats = traffic_stats(streams(results, "shared prefix"),
                                      wall)
                after = await drained()
                passes.append((stats, before, after))
            (s1, b1, a1), (s2, b2, a2) = passes

            def delta(b, a, *path):
                x, y = b, a
                for k in path:
                    x, y = x.get(k, 0), y.get(k, 0)
                return y - x
            onboarded = delta(b2, a2, "kvbm", "onboarded_total")
            hits = delta(b2, a2, "kvbm", "prefix_hit_tokens_total")
            ragged = delta(b2, a2, "kernel_launches", "paged_attention_ragged")
            decode = delta(b2, a2, "kernel_launches", "paged_attention_decode")
            out["kvbm_second_pass"] = {"paged_attention_ragged": ragged,
                                       "paged_attention_decode": decode}
            if onboarded <= 0 or hits <= 0 or ragged <= 0 or decode <= 0:
                fail(f"[kvmove] second pass: onboarded {onboarded}, prefix "
                     f"hit tokens {hits}, ragged {ragged}, decode {decode}")
            print(f"[kvmove] {card}: KVBM worker (G2 4096 blocks, G3 on "
                  f"disk, prefix cache on): {len(ps)} shared-prefix streams "
                  f"(4 groups of a {KV_PREFIX_TOKENS}-token prefix); pass 1 "
                  f"{stats_line(s1)}; G1 cleared; pass 2 {stats_line(s2)}; "
                  f"pass 2 onboarded {onboarded} blocks from the host tier, "
                  f"prefix hit tokens {hits}, ragged launches {ragged} "
                  f"(over the onboarded prefix), decode {decode}; host "
                  f"pool {a2['kvbm']['host_pool_blocks']} blocks, "
                  f"offloaded {a2['kvbm']['offloaded_total']}", flush=True)

            # (e) POST /preempt mid-stream: seats spill to the host tier
            progress = [0] * 8
            reasons = [None] * 8
            prompts = main_prompts(128256)[:8]

            async def stream(i):
                req = {"token_ids": prompts[i], "max_tokens": 512,
                       "temperature": 0.0, "ignore_eos": True}
                async for o in gen.round_robin(req, Context()):
                    progress[i] += len(o.get("token_ids", ()))
                    if o.get("finished"):
                        reasons[i] = o.get("finish_reason")
            jobs = [asyncio.create_task(stream(i)) for i in range(8)]
            t_w = time.perf_counter()
            while min(progress) < EVAC_AFTER_TOKENS:
                if time.perf_counter() - t_w > 120:
                    fail(f"[kvmove] streams never reached "
                         f"{EVAC_AFTER_TOKENS} tokens: {progress}")
                await asyncio.sleep(0.01)
            (status, _, _, _, body), = await loop.run_in_executor(
                procs, http_client, k_sys,
                [dict(method="POST", path="/preempt")])
            t_post = time.perf_counter()
            await asyncio.wait_for(asyncio.gather(*jobs), 120)
            rc = await loop.run_in_executor(None, kw.proc.wait, 120)
            text = kw.text()
            m = re.search(r"evacuation done: (\d+) peer, (\d+) spill, "
                          r"(\d+) fallback, (\d+) finished", text)
            if (status != 202 or not body.get("evacuating") or rc != 0
                    or m is None or int(m.group(2)) != 8
                    or any(r != "evacuated" for r in reasons)):
                fail(f"[kvmove] POST /preempt on the KVBM worker: {status} "
                     f"{body}, exit {rc}, report {m and m.groups()}, "
                     f"reasons {reasons}\n{kw.tail()}")
            out["kvbm"] = launches_of(kw)
            print(f"[kvmove] {card}: POST /preempt on the KVBM worker with 8 "
                  f"streams {EVAC_AFTER_TOKENS}+ tokens in: 202 {body}; "
                  f"PreemptionReport peer {m.group(1)}, spill {m.group(2)}, "
                  f"fallback {m.group(3)}, finished {m.group(4)}; every "
                  f"stream ended 'evacuated'; the worker drained and exited "
                  f"0 {time.perf_counter() - t_post:.1f} s after the POST",
                  flush=True)
            collector.cancel()
            await sub.cancel()
            for cl in (gen, clear):
                await cl.stop()
            await stop(front)
            print(f"[kvmove] processes part in {time.perf_counter() - t0:.1f}"
                  f" s", flush=True)
        finally:
            if rt is not None:
                await rt.shutdown()
            procs.shutdown(wait=False, cancel_futures=True)
            for ch in children:
                ch.kill()
    asyncio.run(run())
    return out


KERNELS = {
    # name: (face, kv dtype, main-path case, replaced TPU function)
    "paged_attention_decode": (
        "decode", None, DECODE_CASE, "dynamo_tpu/ops/paged_attention.py:311"),
    "paged_attention_ragged": (
        "ragged", None, PREFILL_CASE,
        "dynamo_tpu/ops/paged_attention.py:175"),
}
for _kv in ("int8", "fp8"):
    # the quantized-KV branch (:73-76, :109-115, :265-281): the in-kernel
    # dequant sits at :109
    KERNELS[f"paged_attention_decode_{_kv}"] = (
        "decode", _kv, f"{DECODE_CASE} {_kv}",
        "dynamo_tpu/ops/paged_attention.py:109")
    KERNELS[f"paged_attention_ragged_{_kv}"] = (
        "ragged", _kv, f"{PREFILL_CASE} {_kv}",
        "dynamo_tpu/ops/paged_attention.py:109")


def kernels_line(results, launches, dist_launches, spec_launches) -> str:
    """The ``kernels`` JSON line: one row per kernel build, plus the
    ragged face at the spec engine's verify shape (its launches: the verify
    windows of phase 3's spec run)."""
    rows = []
    for name, (face, kv, case, replaces) in KERNELS.items():
        r = results[case]
        rows.append({
            "name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_dist": dist_launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in results.values()
                               if v["face"] == face and v["kv_dtype"] == kv
                               and v["dtype"] == "bfloat16"),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    r = results[SPEC_CASE]
    rows.append({
        "name": "paged_attention_ragged@spec_verify", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
        "replaces": KERNELS["paged_attention_ragged"][3],
        "launches": spec_launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    })
    return json.dumps({"kernels": rows})


class PhaseTimer:
    """Prints each phase's time (``[time]`` lines) as the phases end."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[time] phase {phase}: {now - self.t:.1f} s", flush=True)
        self.t = now


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    try:
        import dynamo_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"dynamo_tpu_torch not importable (run from a checkout): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    timer = PhaseTimer()
    phase_build()
    timer("1 build")
    results = phase_kernels(kernel_cases())
    timer("2 kernels")
    launches, engine, ref_logits, direct = phase_engine(card)
    phase_graph(engine, card)
    timer("3 engine bf16 + graph check")
    spec_engine, spec = phase_spec(card, engine)
    phase_spec_graph(spec_engine, card)
    del spec_engine
    torch.cuda.empty_cache()
    timer("3 spec engine + graph check")
    phase_profile(engine, card)
    timer("4 profile bf16")
    served = phase_http(engine, card, direct)
    timer("5 http")
    phase_kvmove_local(card, engine, direct)
    timer("7 kv movement in one process")
    del engine
    torch.cuda.empty_cache()
    dist_launches = phase_dist(card, served, direct)
    timer("6 distributed")
    phase_kvmove_procs(card, served)
    timer("7 kv movement across processes")
    for dtype in ("int8", "fp8"):
        torch.cuda.empty_cache()
        run_launches, engine, _, _ = phase_engine(card, dtype, ref_logits)
        launches.update(run_launches)
        phase_graph(engine, card)
        timer(f"3 engine {dtype} + graph check")
        if dtype == "int8":
            phase_profile(engine, card)
        phase_quant_costs(engine, card)
        timer(f"4 profile {dtype}")
        del engine
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(kernels_line(results, launches, dist_launches, spec["launches"]))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
