"""Startup attention auto-selection and per-shape-class launch tuning.

Port of ``dynamo_tpu.engine.autotune``. Which attention path wins depends
on the card and the shape, so ``attention_impl="auto"`` times the CUDA
paged-attention kernel against the einsum path (``model._attention`` over
the gathered context) per shape class at engine startup — decode rows, spec
``[B, k+1]`` verify windows, prefill chunks — and picks each class's winner
(``attention_impl_{decode,spec,prefill}``). The probe is one small
attention call per (impl, class), timed on the card with CUDA events.

On top of the impl choice, this module sweeps the kernel's launch
parameters per class (``engine/config.py`` says what a tile pair means):
the ragged face's ``(q_tile, kv_chunk)`` for spec and prefill, the decode
face's ``(0, n_split)`` for decode. Every candidate must pass a numeric gate
before it may win: its output on a mixed ragged batch whose trash block,
partial-block tails and (for quantized pages) trash scales are NaN must be
finite, hold exact zeros where no query is, and agree with the kernel's
plain version (``ops.paged_attention.paged_attention_ragged_plain``) within
the JAX package's tolerances. Candidates are timed at two table widths and
scored on the sum. Winners are persisted in a JSON cache
(``DYNTPU_AUTOTUNE_CACHE``) keyed by a hash of the model, the engine's
shape fields, the card's name, the torch version and the kernel source, so
startup pays the sweep once per configuration; any drift changes the key.

Precedence per class, as in the JAX package: explicit
``attention_tile_{class}`` > cache hit > the sweep on the card > the
kernel's defaults. Two rules differ from the JAX package:

- JAX resolves a class to einsum when its probe raises and marks a
  candidate that raises as ineligible. Here a kernel fault is never hidden:
  the candidates are generated inside the kernel's limits
  (:func:`tile_candidates`), and a launch or build error in the probe or
  the sweep raises. A candidate that fails the numeric gate is ineligible,
  as in JAX; a default launch that fails it raises.
- The sweep runs for ``attention_impl="auto"``: an engine that names its
  impl keeps the kernel's defaults (unless its tiles are given or cached),
  so it launches what it launched before this module existed.

On the CPU the choice is einsum without probing, as the JAX package's is on
a non-TPU backend, and nothing is swept. The JAX package's interpret-mode
bitwise harness (``reference_ragged``, ``parity_check``,
``sweep_class_parity``, ``parity_selftest``) has no counterpart: a CPU has
no CUDA kernel to run in any mode. On the card, the numeric gate here and
``chip_smoke.py`` phase 2 (every launch parameter held against the plain
version, the defaults bitwise against a call without them) do its job.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import paged_attention as pa
from ..utils.config import env_flag
from ..utils.logging import get_logger
from . import model as model_lib
from . import quant
from .config import EngineConfig, ModelConfig

log = get_logger("autotune")

# persisted sweep-winner cache path ("" / unset = no persistence)
CACHE_ENV = "DYNTPU_AUTOTUNE_CACHE"
# set to 0 to skip the startup sweep (the impl probe still runs)
SWEEP_ENV = "DYNTPU_AUTOTUNE_SWEEP"
CACHE_VERSION = 1
CLASSES = ("decode", "spec", "prefill")
KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / \
    "paged_attention.cu"
TIME_REPS = 20


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _time_device(fn: Callable[[], torch.Tensor], tile=None, W=None) -> float:
    """Device ms of one ``fn()``: ``TIME_REPS`` calls captured into a CUDA
    graph after a warm-up call (which builds the kernel and sizes the decode
    face's counters), the replay timed with CUDA events, so the wrapper's
    host work is not timed. The replays' kernel launches are counted.
    ``tile`` and ``W`` name the candidate (a stand-in timer reads them)."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    pa.take_recorded()
    graph = torch.cuda.CUDAGraph()
    with model_lib.gc_paused(), torch.cuda.graph(
            graph, stream=stream, capture_error_mode="thread_local"):
        for _ in range(TIME_REPS):
            fn()
    held = pa.take_recorded()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    pa.count_replay(held)
    pa.count_replay(held)
    return start.elapsed_time(end) / TIME_REPS


# ---------------------------------------------------------------------------
# impl microprobe (kernel vs einsum per shape class)
# ---------------------------------------------------------------------------


def _probe_class(model_config: ModelConfig, engine_config: EngineConfig,
                 B: int, T: int, device: torch.device) -> dict:
    """Time the kernel against the einsum path on a ``[B, T]`` chunk shape.

    Rows attend a full ``W * block_size`` context (the chunk is its last
    ``T`` tokens) — the worst case for the einsum path's gathered scores
    and the steady state for the kernel's block streaming.
    """
    bs = engine_config.block_size
    W = max(2, min(8, engine_config.max_blocks_per_seq))
    KV = model_config.num_kv_heads
    H = model_config.num_heads
    hd = model_config.head_dim_
    NB = 1 + B * W
    rng = np.random.default_rng(0)
    dt = model_lib.torch_dtype(model_config)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(device, dt)

    q = rand(B, T, H, hd)
    kc = rand(NB, KV, bs, hd)
    vc = rand(NB, KV, bs, hd)
    tables = torch.from_numpy(1 + np.arange(B * W).reshape(B, W)).to(
        device, torch.int32)
    lens = torch.full((B,), W * bs, dtype=torch.int32, device=device)
    q_flat = q.reshape(B * T, H, hd).contiguous()
    q_start = torch.arange(B + 1, dtype=torch.int32, device=device) * T
    q_lens = torch.full((B,), T, dtype=torch.int32, device=device)
    pos = (lens[:, None] - T) + torch.arange(T, device=device)[None, :]

    def kernel_path():
        if T == 1:
            return pa.paged_attention_decode(
                q_flat, kc, vc, tables, lens, block_size=bs)
        return pa.paged_attention_ragged(
            q_flat, kc, vc, tables, q_start, q_lens, lens, block_size=bs,
            max_q_len=T)

    def einsum_path():
        idx = tables.long().reshape(-1)
        k_all = kc[idx].reshape(B, W, KV, bs, hd).permute(
            0, 1, 3, 2, 4).reshape(B, W * bs, KV, hd)
        v_all = vc[idx].reshape(B, W, KV, bs, hd).permute(
            0, 1, 3, 2, 4).reshape(B, W * bs, KV, hd)
        return model_lib._attention(q, k_all, v_all, pos)

    kernel_ms = _time_device(kernel_path, tile="kernel", W=W)
    einsum_ms = _time_device(einsum_path, tile="einsum", W=W)
    return {
        "impl": "kernel" if kernel_ms < einsum_ms else "einsum",
        "B": B, "T": T,
        "kernel_ms": round(kernel_ms, 4),
        "einsum_ms": round(einsum_ms, 4),
        # >1 means the kernel is faster
        "ratio": round(einsum_ms / max(kernel_ms, 1e-9), 3),
    }


def probe_attention_impl(
    model_config: ModelConfig, engine_config: EngineConfig,
    device: torch.device,
) -> Tuple[EngineConfig, dict]:
    """Resolve ``attention_impl="auto"`` → concrete per-class impls.

    Returns (engine_config with the winners substituted — ``attention_impl``
    carries the decode winner and each ``attention_impl_{decode,spec,
    prefill}`` its class winner — plus a choice-info dict with the
    per-class times and ratios under "classes"). A probe that raises
    raises: there is no fallback to einsum on the card.
    """
    if engine_config.attention_impl != "auto":
        return engine_config, {
            "impl": engine_config.attention_impl, "probed": False,
        }
    choice: dict = {"probed": False, "classes": {}}
    impls = dict.fromkeys(CLASSES, "einsum")
    if not _on_card(device):
        # the CPU runs the kernel's plain version: not a contender
        choice.update(impl="einsum", reason=f"{device.type} device")
    else:
        for cls, (B, T) in class_shapes(model_config, engine_config).items():
            info = _probe_class(model_config, engine_config, B, T, device)
            impls[cls] = info["impl"]
            choice["classes"][cls] = info
            choice["probed"] = True
        choice["impl"] = impls["decode"]
    log.info("attention_impl=auto resolved: %s", choice)
    resolved = dataclasses.replace(
        engine_config,
        attention_impl=choice["impl"],
        attention_impl_decode=impls["decode"],
        attention_impl_spec=impls["spec"],
        attention_impl_prefill=impls["prefill"],
    )
    return resolved, choice


# ---------------------------------------------------------------------------
# launch sweep: candidate grid, numeric gate, timing
# ---------------------------------------------------------------------------


def class_shapes(
    model_config: ModelConfig, engine_config: EngineConfig,
) -> Dict[str, Tuple[int, int]]:
    """Representative ``(B, T)`` per shape class (the probe/sweep shapes)."""
    B_dec = min(16, max(engine_config.decode_buckets))
    shapes = {"decode": (B_dec, 1)}
    if engine_config.spec_mode != "off":
        shapes["spec"] = (B_dec, engine_config.spec_k + 1)
    shapes["prefill"] = (4, min(256, max(engine_config.prefill_buckets)))
    return shapes


def tile_candidates(
    model_config: ModelConfig, engine_config: EngineConfig,
    attn_class: str, T: int,
) -> List[Tuple[int, int]]:
    """The launch parameters swept for one shape class, every one inside
    the kernel's limits.

    ``(0, 0)`` — the kernel's default — is always first, so the sweep can
    only match or beat it. Decode: ``(0, n_split)`` for n_split 1, 2, 4, …
    and the span count of the engine's decode table (``W`` =
    ``max_blocks_per_seq``). Ragged classes: q_tile 1, 2, 4, … up to
    ``64 // G`` that divide T (the default, ``min(T, 64 // G)``, left out)
    by kv_chunk 0 and the chunk the page dtype does not take by default
    (64 or 128, when its shared memory fits; f32 queries take only 0).
    """
    if attn_class == "decode":
        _, n_spans = pa.decode_spans(engine_config.max_blocks_per_seq,
                                     engine_config.block_size)
        splits, n = [], 1
        while n < n_spans:
            splits.append(n)
            n *= 2
        return [(0, 0)] + [(0, s) for s in splits + [n_spans]]
    G = model_config.num_heads // model_config.num_kv_heads
    max_tile = max(1, 64 // G)
    default_qt = max(1, min(T, max_tile))
    q_tiles = [0]
    qt = 1
    while qt <= max_tile:
        if qt != default_qt and T % qt == 0:
            q_tiles.append(qt)
        qt *= 2
    kv_chunks = [0]
    if model_config.dtype != "float32":
        quantized = quant.is_quantized(engine_config.kv_dtype)
        default_ch = 128 if quantized else 64
        kv_chunks += [
            ch for ch in pa.KV_CHUNKS if ch != default_ch
            and pa.ragged_smem_bytes(model_config.head_dim_, ch, quantized)
            <= pa.SMEM_OPTIN_SM90]
    return [(qt, ch) for qt in q_tiles for ch in kv_chunks]


def make_sweep_case(
    model_config: ModelConfig, engine_config: EngineConfig,
    attn_class: str, B: int, T: int, *,
    W: int = 0, seed: int = 0, poison: bool = True,
    device="cpu",
) -> dict:
    """A mixed ragged batch for one shape class's gate and timing runs.

    Rows pack with stride T (the engine layout). Occupancy is deliberately
    ragged, as in the JAX package: full rows, a short-context row, a
    partial-q row (spec/prefill), a dead seat whose table is all trash
    (block 0), and — with ``poison`` — NaN in the trash block and every
    partial block tail, so a candidate that mis-masks can never pass the
    gate. The random draws and the layout are the JAX package's, in the
    same order. With a quantized ``engine_config.kv_dtype`` the pages are
    quantized per (slot, head) by ``quant.kv_quantize`` and poisoning NaNs
    the *scales* of trash/tail slots (and the fp8 pages, which can encode
    NaN). The decode class's tables are padded with trash to the engine's
    decode table width (``max_blocks_per_seq``), so every split count the
    engine may launch is valid on the case. ``W`` is raised where it cannot
    hold the short-context row of a long chunk (:func:`_min_width`; the JAX
    package's case indexes past its table there). Tensors come on
    ``device``.
    """
    bs = engine_config.block_size
    W = max(W or max(2, min(8, engine_config.max_blocks_per_seq)),
            _min_width(T, bs))
    KV = model_config.num_kv_heads
    H = model_config.num_heads
    hd = model_config.head_dim_
    rng = np.random.default_rng(seed)

    rows = []  # (q_len, ctx_len)
    full_ctx = W * bs
    for b in range(B):
        mode = b % 4
        if mode == 0:
            rows.append((T, full_ctx))               # steady state
        elif mode == 1:
            rows.append((T, T + (bs // 2)))          # short ctx, partial tail
        elif mode == 2:
            rows.append((max(1, T // 2), full_ctx - 3))  # partial q window
        else:
            rows.append((0, 0))                      # dead seat / all trash
    nb = 1 + sum((cl + bs - 1) // bs for _, cl in rows)
    q = rng.standard_normal((B * T, H, hd)).astype(np.float32)
    k_cache = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    v_cache = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    width = engine_config.max_blocks_per_seq if attn_class == "decode" \
        else W
    tables = np.zeros((B, max(W, width)), np.int32)
    nxt = 1
    poison_slots = []  # (block, first poisoned slot offset)
    for r, (ql, cl) in enumerate(rows):
        for w in range((cl + bs - 1) // bs):
            tables[r, w] = nxt
            nxt += 1
        if poison and cl % bs:
            poison_slots.append((int(tables[r, cl // bs]), cl % bs))
    if poison:
        poison_slots.append((0, 0))  # the trash block, wholesale

    dt = model_lib.torch_dtype(model_config)
    kv_dtype = engine_config.kv_dtype
    quantized = quant.is_quantized(kv_dtype)
    pages = {"k": torch.from_numpy(k_cache), "v": torch.from_numpy(v_cache)}
    scales = {"k": None, "v": None}
    for key in ("k", "v"):
        if quantized:
            # quantize the clean values first, then poison the quantized form
            qp, sc = quant.kv_quantize(pages[key].reshape(-1, 1, hd),
                                       kv_dtype)
            pages[key] = qp.reshape(nb, KV, bs, hd)
            scales[key] = sc.reshape(nb, KV, bs).contiguous()
        for blk, off in poison_slots:
            if quantized:
                scales[key][blk, :, off:] = float("nan")
                if kv_dtype == "fp8":  # e4m3fn encodes NaN; int8 cannot
                    pages[key].view(torch.uint8)[blk, :, off:] = 0x7F
            else:
                pages[key][blk, :, off:] = float("nan")
        if not quantized:
            pages[key] = pages[key].to(dt)
    i32 = dict(dtype=torch.int32)
    on = {
        "q": torch.from_numpy(q).to(dt),
        "k_cache": pages["k"], "v_cache": pages["v"],
        "tables": torch.from_numpy(tables),
        "q_start": torch.arange(B + 1, **i32) * T,
        "q_len": torch.tensor([r[0] for r in rows], **i32),
        "ctx_len": torch.tensor([r[1] for r in rows], **i32),
        "k_scale": scales["k"], "v_scale": scales["v"],
    }
    on = {k: None if t is None else t.to(device).contiguous()
          for k, t in on.items()}
    return {
        "attn_class": attn_class,
        "rows": rows,
        "kv_dtype": kv_dtype,
        "block_size": bs,
        "max_q_len": T,
        **on,
    }


def _min_width(T: int, bs: int) -> int:
    """Blocks the case's short-context row (``T + bs // 2`` keys) needs."""
    return -(-(T + bs // 2) // bs)


def run_candidate(case: dict, tile: Tuple[int, int],
                  plain: bool = False) -> torch.Tensor:
    """One call of the class's kernel face (or, with ``plain``, of the
    plain version) on ``case`` at launch parameters ``tile``."""
    sc = dict(k_scale=case["k_scale"], v_scale=case["v_scale"])
    args = (case["q"], case["k_cache"], case["v_cache"], case["tables"])
    if plain:
        return pa.paged_attention_ragged_plain(
            *args, case["q_start"], case["q_len"], case["ctx_len"],
            block_size=case["block_size"], max_q_len=case["max_q_len"],
            **sc)
    if case["attn_class"] == "decode":
        # dead seats have ctx_len 0: the decode face's seq_lens
        return pa.paged_attention_decode(
            *args, case["ctx_len"], block_size=case["block_size"],
            n_split=tile[1], **sc)
    return pa.paged_attention_ragged(
        *args, case["q_start"], case["q_len"], case["ctx_len"],
        block_size=case["block_size"], max_q_len=case["max_q_len"],
        q_tile=tile[0], kv_chunk=tile[1], **sc)


def gate(case: dict, out: torch.Tensor, ref: torch.Tensor,
         tol: float) -> Tuple[bool, float, str]:
    """The numeric gate: ``out`` finite, exact zeros in every slot with no
    valid query, and within ``tol`` of the plain version on the others.
    Returns (eligible, max error over valid slots, reason)."""
    out, ref = out.float().cpu(), ref.float().cpu()
    if not torch.isfinite(out).all():
        return False, float("nan"), "output not finite (trash leak)"
    valid = torch.zeros(out.shape[0], dtype=torch.bool)
    for r, (ql, _) in enumerate(case["rows"]):
        start = int(case["q_start"][r])
        valid[start:start + ql] = True
    dead = out[~valid]
    if dead.numel() and not torch.all(dead == 0):
        return False, float("nan"), "slots with no valid query not zero"
    err = float((out[valid] - ref[valid]).abs().max()) if valid.any() \
        else 0.0
    if err > tol:
        return False, err, f"numeric gate failed (err {err:.2e} > {tol})"
    return True, err, ""


def sweep_class(
    model_config: ModelConfig, engine_config: EngineConfig,
    attn_class: str, B: int, T: int, device: torch.device,
) -> dict:
    """Gate and time every candidate of one class; pick the fastest that
    passed the gate.

    W (the context depth in blocks) is part of the swept shape: candidates
    run at a shallow and a deep table and are scored on the sum, so a
    winner cannot overfit one context depth. A launch that raises raises.
    """
    cap = engine_config.max_blocks_per_seq
    widths = sorted({max(w, _min_width(T, engine_config.block_size))
                     for w in (max(2, min(8, cap)), max(2, min(32, cap)))})
    # the JAX package's tolerances (``_sweep_class_device``)
    tol = 2e-2 if model_config.dtype == "bfloat16" else 2e-3
    if quant.is_quantized(engine_config.kv_dtype):
        tol = max(tol, 5e-2)
    cases = {W: make_sweep_case(model_config, engine_config, attn_class, B,
                                T, W=W, device=device) for W in widths}
    refs = {W: run_candidate(c, (0, 0), plain=True)
            for W, c in cases.items()}
    results: List[dict] = []
    for tile in tile_candidates(model_config, engine_config, attn_class, T):
        entry = {"tile": list(tile), "ms": {}, "max_err": {},
                 "eligible": True}
        total = 0.0
        for W in widths:
            case = cases[W]
            ok, err, reason = gate(case, run_candidate(case, tile), refs[W],
                                   tol)
            entry["max_err"][f"W{W}"] = err
            if not ok:
                entry["eligible"] = False
                entry["reason"] = reason
                break
            ms = _time_device(lambda c=case: run_candidate(c, tile),
                              tile=tile, W=W)
            entry["ms"][f"W{W}"] = round(ms, 5)
            total += ms
        entry["total_ms"] = round(total, 5)
        results.append(entry)
    if not results[0]["eligible"]:
        raise RuntimeError(
            f"{attn_class}: the kernel's default launch failed the gate: "
            f"{results[0].get('reason')}")
    winner = min((e for e in results if e["eligible"]),
                 key=lambda e: e["total_ms"])
    return {
        "B": B, "T": T, "widths": widths, "tol": tol,
        "winner": winner["tile"],
        "candidates": results,
    }


# ---------------------------------------------------------------------------
# persisted tuning cache
# ---------------------------------------------------------------------------


def kernel_digest(path: Path = KERNEL_SOURCE) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()[:16]


def config_hash(
    model_config: ModelConfig, engine_config: EngineConfig,
    device_kind: str, *, torch_version: Optional[str] = None,
    kernel: Optional[str] = None,
) -> str:
    """Cache key: shape-relevant config + the card's name + the torch
    version + a hash of the kernel source.

    Any drift in what the sweep actually measured — model geometry, cache
    layout and KV dtype, bucket grids, spec window, card, torch release,
    kernel — changes the key, so a stale winner is never replayed; unknown
    keys fall back to the kernel's defaults.
    """
    key = {
        "model": dataclasses.asdict(model_config),
        "engine": {
            "block_size": engine_config.block_size,
            "decode_buckets": list(engine_config.decode_buckets),
            "prefill_buckets": list(engine_config.prefill_buckets),
            "spec_mode": engine_config.spec_mode,
            "spec_k": engine_config.spec_k,
            "max_model_len": engine_config.max_model_len,
            "max_num_seqs": engine_config.max_num_seqs,
            "mesh_shape": list(engine_config.mesh_shape),
            "kv_dtype": engine_config.kv_dtype,
        },
        "device_kind": device_kind,
        "torch": torch_version or torch.__version__,
        "kernel": kernel or kernel_digest(),
        "cache_version": CACHE_VERSION,
    }
    blob = json.dumps(key, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def cache_path() -> Optional[str]:
    return os.environ.get(CACHE_ENV) or None


def load_cache_entry(path: str, key: str) -> Optional[dict]:
    """The persisted entry for ``key``, or None on miss/drift/corruption."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != CACHE_VERSION:
            return None
        entry = doc.get("entries", {}).get(key)
        if not isinstance(entry, dict) or "tiles" not in entry:
            return None
        return entry
    except (OSError, ValueError, AttributeError):
        return None


def store_cache_entry(path: str, key: str, entry: dict) -> bool:
    """Merge ``entry`` under ``key``; atomic rename, best-effort."""
    doc: dict = {"version": CACHE_VERSION, "entries": {}}
    try:
        with open(path) as f:
            old = json.load(f)
        # a corrupt or other-version file is replaced, never merged into
        if (isinstance(old, dict) and old.get("version") == CACHE_VERSION
                and isinstance(old.get("entries"), dict)):
            doc = old
    except (OSError, ValueError):
        pass
    doc.setdefault("entries", {})[key] = entry
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return True
    except OSError as e:
        log.warning("autotune cache write failed (%s): %s", path, e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


# ---------------------------------------------------------------------------
# top-level: impl probe + tile resolution (what the engine calls)
# ---------------------------------------------------------------------------


def _launches() -> int:
    return sum(pa.LAUNCHES.values())


def autotune_attention(
    model_config: ModelConfig, engine_config: EngineConfig,
    device="cuda",
) -> Tuple[EngineConfig, dict]:
    """Impl probe + per-class launch resolution, cache-backed.

    Order of precedence per class: explicit ``attention_tile_{class}`` in
    the config > persisted cache hit (``DYNTPU_AUTOTUNE_CACHE``) > the sweep
    on the card (``attention_impl="auto"``; winners stored back) > the
    kernel's defaults. The returned choice dict always carries
    ``autotune_cache_hit``, ``config_hash``, the resolved ``tiles``, and
    ``probe_launches`` and ``sweep_launches`` (the kernel launches the probe
    and the sweep made) and ``tune_s`` (this call's host seconds), so
    serving and benchmarks can report what actually ran.
    """
    t0 = time.perf_counter()
    device = torch.device(device)
    launches0 = _launches()
    cfg, choice = probe_attention_impl(model_config, engine_config, device)
    choice = dict(choice)
    choice["probe_launches"] = _launches() - launches0
    launches0 = _launches()
    device_kind = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type)
    key = config_hash(model_config, cfg, device_kind)
    path = cache_path()
    choice.update(autotune_cache_hit=False, config_hash=key,
                  cache_path=path or "", device_kind=device_kind)

    tiles: Dict[str, Tuple[int, int]] = dict.fromkeys(CLASSES, (0, 0))
    shapes = class_shapes(model_config, cfg)
    kernel_classes = [
        cls for cls in shapes
        if model_lib.resolve_attention_impl(cfg, cls) == "kernel"
    ]
    entry = load_cache_entry(path, key) if path else None
    if entry is not None:
        for cls, t in entry.get("tiles", {}).items():
            if cls in tiles and len(t) == 2:
                tiles[cls] = (int(t[0]), int(t[1]))
        choice["autotune_cache_hit"] = True
        choice["sweep"] = entry.get("sweep", {})
    elif (_on_card(device) and engine_config.attention_impl == "auto"
          and kernel_classes and env_flag(SWEEP_ENV, True)):
        sweep: Dict[str, dict] = {}
        for cls in kernel_classes:
            B, T = shapes[cls]
            res = sweep_class(model_config, cfg, cls, B, T, device)
            tiles[cls] = tuple(res["winner"])
            sweep[cls] = res
        choice["sweep"] = sweep
        if path:
            store_cache_entry(path, key, {
                "device_kind": device_kind,
                "tiles": {cls: list(t) for cls, t in tiles.items()},
                "sweep": sweep,
            })

    # explicit config tiles always win over cache/sweep
    for cls in tiles:
        explicit = tuple(getattr(engine_config, f"attention_tile_{cls}"))
        if explicit != (0, 0):
            tiles[cls] = explicit
    choice["tiles"] = {cls: list(t) for cls, t in tiles.items()}
    choice["sweep_launches"] = _launches() - launches0
    choice["tune_s"] = time.perf_counter() - t0
    resolved = dataclasses.replace(
        cfg,
        attention_tile_decode=tiles["decode"],
        attention_tile_spec=tiles["spec"],
        attention_tile_prefill=tiles["prefill"],
    )
    return resolved, choice


_IMPL_CODES = ("kernel", "einsum")


def share_choice(
    engine_config: EngineConfig,
    tune: Callable[[], Tuple[EngineConfig, dict]],
    device,
) -> Tuple[EngineConfig, dict]:
    """``tune()`` on a one-rank engine. On a mesh of more than one rank,
    rank 0 runs ``tune()`` and one ``broadcast`` over the world hands its
    resolved per-class impls and tiles to every rank, so followers launch
    exactly what the leader launches and never time the card themselves
    (two ranks on one card timing at once could pick differently)."""
    from ..parallel import comm

    if model_lib.mesh_ranks(engine_config) == 1:
        return tune()
    if comm.rank() == 0:
        cfg, choice = tune()
        packed = []
        for cls in CLASSES:
            packed.append(_IMPL_CODES.index(
                model_lib.resolve_attention_impl(cfg, cls)))
            packed.extend(getattr(cfg, f"attention_tile_{cls}"))
    else:
        cfg, choice = engine_config, None
        packed = [0] * (3 * len(CLASSES))
    t = comm.broadcast(torch.tensor(packed, dtype=torch.int64,
                                    device=torch.device(device)),
                       group=comm.world_group())
    vals = [int(v) for v in t.cpu()]
    fields = {}
    for i, cls in enumerate(CLASSES):
        impl, q_tile, second = vals[3 * i:3 * i + 3]
        fields[f"attention_impl_{cls}"] = _IMPL_CODES[impl]
        fields[f"attention_tile_{cls}"] = (q_tile, second)
    cfg = dataclasses.replace(cfg, **fields)
    if choice is None:
        choice = {"impl": fields["attention_impl_decode"],
                  "from_leader": True,
                  "autotune_cache_hit": False, "probed": False,
                  "probe_launches": 0, "sweep_launches": 0,
                  "tiles": {cls: list(fields[f"attention_tile_{cls}"])
                            for cls in CLASSES}}
    return cfg, choice
