"""A local tensor-parallel world for the port's tests: N rank processes on
the CPU, joined by ``torch.distributed`` over gloo, that run the functions
a test sends them and return their results.

Each rank is a spawned process that imports torch and the port only (no
JAX). ``World.run(fn, *args)`` calls ``fn(rank, world, *args)`` on every
rank at once and returns the ranks' results in rank order; a rank that
raises fails the call with its traceback, and every call has a timeout.
Rank 0 can lead an engine whose step plans reach the followers through
the world's plan queues (:func:`lead` / :func:`follow`), so an engine-level
test exercises the port's ``step_sink`` and ``replay_plan`` without a
store; the processes-over-TCP path has its own test file.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import traceback
from typing import Any, Callable, List

START_TIMEOUT_S = 60.0
CALL_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, cmd, res, plans) -> None:
    import torch

    from dynamo_tpu_torch.parallel import comm

    torch.set_num_threads(1)
    comm.init(rank, n, f"tcp://127.0.0.1:{port}", "gloo", CALL_TIMEOUT_S)
    res.put((rank, "ready", None))
    while True:
        job = cmd.get()
        if job is None:
            break
        fn, args = job
        try:
            out = fn(rank, plans, *args)
            res.put((rank, "ok", out))
        except BaseException:  # noqa: BLE001 — reported to the test
            res.put((rank, "error", traceback.format_exc()))
    comm.destroy()


class World:
    """N gloo ranks on the CPU; use as a context manager."""

    def __init__(self, n: int):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.n = n
        self._cmd = [ctx.Queue() for _ in range(n)]
        self._res = ctx.Queue()
        plans = [ctx.Queue() for _ in range(n)]
        self._procs = [
            ctx.Process(target=_rank_main,
                        args=(r, n, port, self._cmd[r], self._res, plans),
                        daemon=True)
            for r in range(n)
        ]
        for p in self._procs:
            p.start()
        self._collect("ready", START_TIMEOUT_S)

    def _collect(self, want: str, timeout_s: float) -> List[Any]:
        out: List[Any] = [None] * self.n
        errors = []
        for _ in range(self.n):
            try:
                rank, status, val = self._res.get(timeout=timeout_s)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"a rank did not answer in {timeout_s}s")
            if status == "error":
                errors.append(f"rank {rank}:\n{val}")
            out[rank] = val
        if errors:
            self.close()
            raise RuntimeError("\n".join(errors))
        return out

    def run(self, fn: Callable, *args, timeout_s: float = CALL_TIMEOUT_S
            ) -> List[Any]:
        for q in self._cmd:
            q.put((fn, args))
        return self._collect("ok", timeout_s)

    def close(self) -> None:
        for q in self._cmd:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------ rank functions ------------------------------


def _cfg(name: str, **kw):
    """A preset by name; ``"tiny:4"`` is the preset at 4 layers."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import ModelConfig

    name, _, layers = name.partition(":")
    cfg = getattr(ModelConfig, name)(**kw)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=int(layers))
    return cfg


def forward_logits(rank, plans, cfg_name, tree, eng_kw, steps,
                   weight_dtype="bf16", other_mesh=None):
    """This rank's ``forward`` + ``logits_fn`` over its shard of the JAX
    tree ``tree`` (numpy leaves), one call per ``(tokens, positions,
    tables[, sp])`` step on one cache: [(hidden, logits)] as numpy, and the
    shard shapes of ``wq`` and a cache layer. A step with ``sp`` true runs
    the sequence-parallel forward; its hidden states are gathered over the
    dp column, so every rank returns the whole chunk's. ``forward`` takes
    its groups from ``eng.mesh_shape`` (its default); with ``other_mesh``
    a mesh of that shape is made after the engine's, just before the
    steps, as a second engine in the process would make it."""
    import torch

    from dynamo_tpu_torch.engine import model as tm
    from dynamo_tpu_torch.engine import quant
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.layout import make_mesh

    cfg = _cfg(cfg_name)
    eng = EngineConfig(weight_dtype=weight_dtype, **eng_kw)
    mesh = make_mesh(eng.mesh_shape)
    params = tm.shard_params(
        quant.quantize_params(
            params_from_numpy(tree, cfg, "cpu", weight_dtype=weight_dtype),
            weight_dtype),
        cfg, eng)
    if other_mesh is not None:
        make_mesh(other_mesh)
    cache = tm.init_cache(cfg, eng, torch.device("cpu"))
    outs = []
    with torch.inference_mode():
        for tokens, positions, tables, *sp in steps:
            sp = bool(sp and sp[0])
            cache, h = tm.forward(cfg, eng, params, cache,
                                  torch.from_numpy(tokens),
                                  torch.from_numpy(positions),
                                  torch.from_numpy(tables), sp=sp)
            if sp:
                h = comm.all_gather(h, mesh.dp_group, dim=1)
            outs.append((h.float().numpy(),
                         tm.logits_fn(cfg, params, h, mesh).numpy()))
    wq = params["layers"]["wq"]
    wq = wq["q"] if isinstance(wq, dict) else wq
    return outs, {"wq": tuple(wq.shape), "cache_k": tuple(cache["k"][0].shape)}


def lead(engine, plans, n: int) -> None:
    """Install rank 0's plan sink: each plan, encoded as the wire carries
    it, goes to every follower's queue before the leader launches."""
    from dynamo_tpu_torch.parallel.multihost import encode_plan

    emitted = {}

    def sink(kind, arrays):
        emitted[kind] = emitted.get(kind, 0) + 1
        plan = encode_plan(kind, arrays)
        for r in range(1, n):
            plans[r].put(plan)

    engine.step_sink = sink
    return emitted


def follow(engine, plans, rank: int) -> None:
    """Replay the leader's plans on this rank until it sends ``None``."""
    from dynamo_tpu_torch.parallel.multihost import decode_plan, replay_plan

    while True:
        plan = plans[rank].get(timeout=CALL_TIMEOUT_S)
        if plan is None:
            return
        replay_plan(engine, *decode_plan(plan))


def serve(rank, plans, cfg_name, tree, eng_kw, requests, weight_dtype="bf16",
          ckpt=None, sequential=False):
    """Serve ``requests`` (dicts of ``Request`` fields; with
    ``sequential``, one after another) on a multi-rank engine built from
    the full tree ``tree`` or, with ``ckpt``, from this rank's shard of
    that HF checkpoint: rank 0 leads and returns the token streams, the
    plan kinds it emitted, its launches and collectives; the others replay
    and return the kinds they replayed. Both return their sequence-
    parallel prefills and ring hops."""
    import asyncio

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine, Request
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.parallel import comm

    cfg = _cfg(cfg_name)
    eng = EngineConfig(weight_dtype=weight_dtype, **eng_kw)
    if ckpt is None:
        params = params_from_numpy(tree, cfg, "cpu",
                                   weight_dtype=weight_dtype)
    else:
        from dynamo_tpu_torch.engine.weights import load_hf_params_sharded
        from dynamo_tpu_torch.parallel.layout import make_mesh

        params = load_hf_params_sharded(ckpt, cfg, make_mesh(eng.mesh_shape),
                                        weight_dtype, device="cpu")
    engine = InferenceEngine(cfg, eng, params=params, device="cpu")
    comm.reset_stats()
    n = comm.world_size()
    if rank != 0:
        follow(engine, plans, rank)
        return {"replayed": dict(engine.num_replayed),
                "all_reduce_calls": comm.STATS["all_reduce_calls"],
                "sp_prefills": engine.num_sp_prefills,
                "ppermute_calls": comm.STATS["ppermute_calls"],
                "ppermute_bytes": comm.STATS["ppermute_bytes"]}
    emitted = lead(engine, plans, n)

    async def go():
        async def one(i, r):
            req = Request(request_id=f"r{i}", **r)
            return [o.token_id async for o in engine.submit(req)]
        try:
            if sequential:
                return [await one(i, r) for i, r in enumerate(requests)]
            return await asyncio.gather(
                *(one(i, r) for i, r in enumerate(requests)))
        finally:
            await engine.stop()

    try:
        streams = asyncio.run(go())
    finally:
        for r in range(1, n):
            plans[r].put(None)
    return {"streams": streams, "emitted": emitted,
            "windows": engine.num_windows,
            "spec_drafted": (engine.spec_stats.drafted
                             if engine.spec_stats is not None else 0),
            "all_reduce_calls": comm.STATS["all_reduce_calls"],
            "sp_prefills": engine.num_sp_prefills,
            "ppermute_calls": comm.STATS["ppermute_calls"],
            "ppermute_bytes": comm.STATS["ppermute_bytes"]}


def step_plans(rank, plans, cfg_name, tree, eng_kw, step_arrays):
    """Every rank replays the same ``p`` / ``d`` plans (the unified step a
    pipeline-parallel leader emits) on an engine over its stage; each
    returns the K pages of its first layer as numpy."""
    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.parallel.multihost import (
        decode_plan, encode_plan, replay_plan,
    )

    cfg = _cfg(cfg_name)
    engine = InferenceEngine(cfg, EngineConfig(**eng_kw),
                             params=params_from_numpy(tree, cfg, "cpu"),
                             device="cpu")
    for kind, arrays in step_arrays:
        replay_plan(engine, *decode_plan(encode_plan(kind, arrays)))
    return engine.cache["k"][0].numpy(), dict(engine.num_replayed)


def attention_case(rank, plans, which, q, k, v, causal=True, dp=None):
    """The port's ``make_ring_attention`` (``which="ring"``) or
    ``make_ulysses_attention`` over the dp column of a ``(dp, 1)`` mesh on
    the whole ``[B, T, ., hd]`` numpy tensors: (out, the collectives'
    counters of the call), or (None, the message) of a refusal."""
    import torch

    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.layout import make_mesh
    from dynamo_tpu_torch.parallel.ring_attention import make_ring_attention
    from dynamo_tpu_torch.parallel.ulysses import make_ulysses_attention

    dpg = make_mesh((dp or comm.world_size(), 1)).dp_group
    make = make_ring_attention if which == "ring" else make_ulysses_attention
    comm.reset_stats()
    try:
        with torch.inference_mode():
            out = make(dpg, causal=causal)(*(torch.from_numpy(x)
                                             for x in (q, k, v)))
    except ValueError as e:    # a refusal, returned (a raise ends the world)
        return None, str(e)
    return out.numpy(), dict(comm.STATS)


def ring_body(rank, plans, q, k, v):
    """The per-rank ``ring_attention`` on this rank's chunk of T, with the
    counters of that one ring."""
    import torch

    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.layout import make_mesh
    from dynamo_tpu_torch.parallel.ring_attention import ring_attention

    n = comm.world_size()
    dpg = make_mesh((n, 1)).dp_group
    C = q.shape[1] // n
    sl = slice(rank * C, (rank + 1) * C)
    comm.reset_stats()
    with torch.inference_mode():
        out = ring_attention(*(torch.from_numpy(x[:, sl].copy())
                               for x in (q, k, v)), dpg)
    return out.numpy(), dict(comm.STATS)


def collectives(rank, plans, dp, tp):
    """Each collective of ``parallel/comm.py`` once on a ``(dp, tp)``
    mesh: this rank's coordinates, its groups' ranks, and what each
    collective returned (an all_gather of ``-0.0`` and rank-coded values,
    a ppermute, an all_to_all, sums over the tp row and the dp column)."""
    import torch

    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.layout import make_mesh

    mesh = make_mesh((dp, tp))
    tpg, dpg = mesh.tp_group, mesh.dp_group
    mine = torch.tensor([-0.0, float(rank), 0.5 + rank])
    return {
        "coords": dict(mesh.coords), "tp_ranks": list(tpg.ranks),
        "dp_ranks": list(dpg.ranks), "tp_rank": tpg.index,
        "gather_dp": comm.all_gather(mine, dpg).numpy(),
        "gather_world": comm.all_gather(mine, comm.world_group()).numpy(),
        "ppermute_dp": comm.ppermute(mine, dpg).numpy(),
        "a2a_world": comm.all_to_all(
            torch.arange(comm.world_size(), dtype=torch.float32)
            + 10 * rank, comm.world_group()).numpy(),
        "sum_tp": comm.all_reduce(torch.tensor([float(rank)]), tpg).item(),
        "sum_dp": comm.all_reduce(torch.tensor([float(rank)]),
                                  dpg).item(),
        "bcast_world": comm.broadcast(torch.tensor([float(rank)]),
                                      comm.world_group()).item(),
    }


def sp_step_sample(rank, plans, cfg_name, tree, eng_kw, tokens, positions,
                   tables, last_idx):
    """``make_sp_prefill_fn``'s greedy sample of one chunk on this rank's
    shard (every rank must return the same)."""
    import torch

    from dynamo_tpu_torch.engine import model as tm
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.weights import params_from_numpy

    cfg = _cfg(cfg_name)
    eng = EngineConfig(**eng_kw)
    params = tm.shard_params(params_from_numpy(tree, cfg, "cpu"), cfg, eng)
    cache = tm.init_cache(cfg, eng, torch.device("cpu"))
    B = tokens.shape[0]
    _, sampled = tm.make_sp_prefill_fn(cfg, eng)(
        params, cache, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables), torch.from_numpy(last_idx),
        torch.tensor(7, dtype=torch.int64), torch.zeros(B),
        torch.zeros(B, dtype=torch.int32), torch.ones(B),
        torch.full((B,), -1, dtype=torch.int32), False)
    return sampled.tolist()


# ---------------------------- pipeline parallel ----------------------------


def _residual_mlp(p, x):
    """``tests/test_pipeline.py``'s stage: a residual MLP block."""
    import torch

    return x + torch.tanh(x @ p["w1"]) @ p["w2"]


def pipeline_case(rank, plans, params, x):
    """The port's ``make_pipeline`` over the world on the residual MLP
    stage: ``params`` numpy leaves stacked ``[S, ...]`` (this rank keeps
    its ``stage_slice``), ``x [M, mb, D]``. Returns the output, this
    rank's hop count and the bytes it sent."""
    import torch

    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.pipeline import make_pipeline, stage_slice

    g = comm.world_group()
    tree = {k: torch.from_numpy(v) for k, v in params.items()}
    comm.reset_stats()
    out = make_pipeline(g, _residual_mlp)(
        stage_slice(tree, g.index, g.size), torch.from_numpy(x))
    return (out.numpy(), comm.STATS["ppermute_calls"],
            comm.STATS["ppermute_bytes"])


def pp_step_case(rank, plans, cfg_name, tree, eng_kw, steps, M=4):
    """``raw_pp_step_fn`` of this rank's stage over the JAX tree ``tree``:
    one call per ``(tokens, positions, tables, last_idx)`` step on one
    stage cache, greedy. Returns the sampled tokens of each step, the
    stage's cache planes (``k``/``v``, [Lp, NB, KV, bs, hd]) and layers,
    and the hops."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.parallel import comm, pp_serving

    cfg = _cfg(cfg_name)
    eng = EngineConfig(**eng_kw)
    g = pp_serving.make_pp_mesh(eng.pp_stages)
    params = pp_serving.pp_param_shardings(
        params_from_numpy(tree, cfg, "cpu"), cfg, g.index, g.size)
    cache = pp_serving.init_pp_cache(cfg, eng, torch.device("cpu"))
    step = pp_serving.make_pp_step_fn(cfg, eng, g, M)
    comm.reset_stats()
    sampled = []
    for tokens, positions, tables, last_idx in steps:
        B = tokens.shape[0]
        cache, s = step(
            params, cache, torch.from_numpy(tokens),
            torch.from_numpy(positions), torch.from_numpy(tables),
            torch.from_numpy(last_idx), torch.tensor(7, dtype=torch.int64),
            torch.zeros(B), torch.zeros(B, dtype=torch.int32),
            torch.ones(B), torch.full((B,), -1, dtype=torch.int32), False)
        sampled.append(s.tolist())
    return {"sampled": sampled,
            "k": np.stack([t.numpy() for t in cache["k"]]),
            "v": np.stack([t.numpy() for t in cache["v"]]),
            "layers": pp_serving.stage_layers(cfg, g.size, g.index),
            "ppermute_calls": comm.STATS["ppermute_calls"],
            "ppermute_bytes": comm.STATS["ppermute_bytes"],
            "broadcast_calls": comm.STATS["broadcast_calls"]}


def pp_engine_probe(rank, plans, cfg_name, eng_kw):
    """Build a pp engine on this rank and report what it holds and what
    it refuses (messages, never raised: a raise ends the world): the
    stage's layers, cache planes, parameter leaf shapes, loop depth,
    the recorder's chips, the warnings it logged, and each guarded
    call's exception type and message."""
    import asyncio
    import logging

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.engine.engine import EngineCore, Request

    logs = []

    class Grab(logging.Handler):
        def emit(self, record):
            logs.append((record.levelname, record.getMessage()))

    handler = Grab()
    port_log = logging.getLogger("dynamo_tpu_torch")   # propagates nowhere
    port_log.addHandler(handler)
    try:
        engine = InferenceEngine(_cfg(cfg_name), EngineConfig(**eng_kw),
                                 device="cpu")
    finally:
        port_log.removeHandler(handler)
    calls = {
        "extract": lambda: asyncio.run(engine.extract_kv_blocks([1])),
        "inject": lambda: asyncio.run(engine.inject_kv_blocks([1], {})),
        "kvbm": lambda: engine.attach_kvbm(),
        "evacuation": engine.evacuable_seats,
        "embed": lambda: asyncio.run(engine.embed([[1, 2]])),
        "mm": lambda: asyncio.run(EngineCore.submit(engine, Request(
            request_id="m", token_ids=[1, 2], mm_positions=[0],
        )).__anext__()),
    }
    refused = {}
    for what, call in calls.items():
        try:
            call()
            refused[what] = None
        except Exception as e:  # noqa: BLE001 — reported to the test
            refused[what] = (type(e).__name__, str(e))
    return {
        "stage_layers": engine.stage_layers,
        "cache_layers": len(engine.cache["k"]),
        "wq": tuple(engine.params["layers"]["wq"].shape),
        "embed": tuple(engine.params["embed"].shape),
        "pipeline_depth": engine.pipeline_depth,
        "graphs": engine._ap_window_fn is not None,
        "ctl": engine._ctl is not None,
        "ladders": sorted(engine._ladders),
        "obs_chips": engine.obs.n_chips if engine.obs is not None else None,
        "world": engine.world,
        "warnings": [m for lvl, m in logs if lvl == "WARNING"],
        "refused": refused,
    }
