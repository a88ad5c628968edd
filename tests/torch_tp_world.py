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
    shard shapes of ``wq`` and a cache layer and each step's rows on this
    rank (``tl``). A step with ``sp`` true runs
    the sequence-parallel forward; its hidden states are gathered over the
    seq column, so every rank returns the whole chunk's. ``forward`` takes
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
    outs, tl = [], []
    with torch.inference_mode():
        for tokens, positions, tables, *sp in steps:
            sp = bool(sp and sp[0])
            cache, h = tm.forward(cfg, eng, params, cache,
                                  torch.from_numpy(tokens),
                                  torch.from_numpy(positions),
                                  torch.from_numpy(tables), sp=sp)
            tl.append(h.shape[1])
            if sp:
                h = comm.all_gather(h, mesh.seq_group, dim=1)
            outs.append((h.float().numpy(),
                         tm.logits_fn(cfg, params, h, mesh,
                                      tm.param_specs(cfg, eng)).numpy()))
    wq = params["layers"]["wq"]
    wq = wq["q"] if isinstance(wq, dict) else wq
    return outs, {"wq": tuple(wq.shape),
                  "cache_k": tuple(cache["k"][0].shape), "tl": tl}


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

    def stored():
        wq = engine.params["layers"]["wq"]
        wq = wq["q"] if isinstance(wq, dict) else wq
        return {"wq": tuple(wq.shape),
                "fsdp_gather_calls": comm.STATS["fsdp_gather_calls"]}

    if rank != 0:
        follow(engine, plans, rank)
        return {"replayed": dict(engine.num_replayed),
                "all_reduce_calls": comm.STATS["all_reduce_calls"],
                "sp_prefills": engine.num_sp_prefills,
                "ppermute_calls": comm.STATS["ppermute_calls"],
                "ppermute_bytes": comm.STATS["ppermute_bytes"], **stored()}
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
            "ppermute_bytes": comm.STATS["ppermute_bytes"], **stored()}


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


def collectives(rank, plans, dp, tp, fsdp=None):
    """Each collective of ``parallel/comm.py`` once on a ``(dp, tp)``
    mesh (``(dp, fsdp, tp)`` with ``fsdp``): this rank's coordinates, its
    groups' ranks, and what each collective returned (an all_gather of
    ``-0.0`` and rank-coded values, a ppermute, an all_to_all, sums over
    the tp row, the dp column, the fsdp group and the seq column)."""
    import torch

    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.layout import make_mesh

    mesh = make_mesh((dp, tp) if fsdp is None else (dp, fsdp, tp))
    tpg, dpg = mesh.tp_group, mesh.dp_group
    mine = torch.tensor([-0.0, float(rank), 0.5 + rank])
    return {
        "coords": dict(mesh.coords), "tp_ranks": list(tpg.ranks),
        "dp_ranks": list(dpg.ranks), "tp_rank": tpg.index,
        "fsdp_ranks": list(mesh.fsdp_group.ranks),
        "seq_ranks": list(mesh.seq_group.ranks),
        "sum_fsdp": comm.all_reduce(torch.tensor([float(rank)]),
                                    mesh.fsdp_group).item(),
        "sum_seq": comm.all_reduce(torch.tensor([float(rank)]),
                                   mesh.seq_group).item(),
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


PROBE_EMBED = [[1, 2], [7, 8, 9, 10, 11]]


def pp_engine_probe(rank, plans, cfg_name, eng_kw, tree=None):
    """Build a pp engine on this rank (over the full numpy ``tree`` when
    given) and report what it holds and what it refuses (messages, never
    raised: a raise ends the world): the stage's layers, cache planes,
    parameter leaf shapes, loop depth, the recorder's chips, the warnings
    it logged, each guarded call's exception type and message (None when
    served), and the vectors of ``embed(PROBE_EMBED)``, which every stage
    calls together."""
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
    cfg = _cfg(cfg_name)
    params = None
    if tree is not None:
        from dynamo_tpu_torch.engine.weights import params_from_numpy

        params = params_from_numpy(tree, cfg, "cpu")
    try:
        engine = InferenceEngine(cfg, EngineConfig(**eng_kw), params=params,
                                 device="cpu")
    finally:
        port_log.removeHandler(handler)
    calls = {
        "extract": lambda: asyncio.run(engine.extract_kv_blocks([1])),
        "inject": lambda: asyncio.run(engine.inject_kv_blocks([1], {})),
        "kvbm": lambda: engine.attach_kvbm(),
        "evacuation": engine.evacuable_seats,
        "embed": lambda: asyncio.run(engine.embed(PROBE_EMBED)),
        "mm": lambda: asyncio.run(EngineCore.submit(engine, Request(
            request_id="m", token_ids=[1, 2], mm_positions=[0],
        )).__anext__()),
    }
    refused, served = {}, {}
    for what, call in calls.items():
        try:
            served[what] = call()
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
        "embedded": served.get("embed"),
    }


# ------------------------ single-rank paths on a mesh ------------------------


def _numpy_payload(data):
    """A KV payload dict as numpy (fp8 as its uint8 bits)."""
    import torch

    return {k: (v.view(torch.uint8) if v.dtype == torch.float8_e4m3fn
                else v).numpy() for k, v in data.items()}


def _solo_engine(cfg, tree, eng_kw):
    """A one-rank engine over the same tree (in a rank's process, beside
    the multi-rank one: it runs no collective)."""
    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.engine.weights import params_from_numpy

    kw = {k: v for k, v in eng_kw.items()
          if k not in ("mesh_shape", "pp_stages", "pp_microbatches")}
    return InferenceEngine(cfg, EngineConfig(**kw),
                           params=params_from_numpy(tree, cfg, "cpu"),
                           device="cpu")


async def _tokens(stream):
    return [o.token_id async for o in stream]


async def kv_script(engine, cfg, tree, eng_kw, prompt, max_tokens):
    """Prefill ``prompt`` held, extract its blocks (the payload), inject
    the payload into a fresh reservation (first with a stale epoch, then
    payloads that do not fit — a head short, a block short, another
    dtype, a key missing — each of which must raise before any plan),
    extract those blocks again, and decode the reservation from the
    injected KV."""
    import torch

    from dynamo_tpu_torch.disagg.ici import StaleEpochError
    from dynamo_tpu_torch.engine import Request

    try:
        seq, first = await engine.prefill_held(Request(
            request_id="held", token_ids=list(prompt), max_tokens=1))
        payload = await engine.extract_kv_blocks(seq.block_table)
        dst = engine.reserve_sequence(Request(
            request_id="dst", token_ids=list(prompt),
            max_tokens=max_tokens, ignore_eos=True))
        try:
            await engine.inject_kv(dst, payload, epoch=dst.kv_epoch + 1)
            stale = None
        except StaleEpochError as e:
            stale = str(e)
        misfits = {}
        for name, bad in (
                ("head", {k: v[:, :, :-1] for k, v in payload.items()}),
                ("block", {k: v[:, :-1] for k, v in payload.items()}),
                ("dtype", {k: v.to(torch.float64)
                           for k, v in payload.items()}),
                ("key", {"k": payload["k"]})):
            try:
                await engine.inject_kv(dst, bad, epoch=dst.kv_epoch)
                misfits[name] = None
            except ValueError as e:
                misfits[name] = str(e)
        await engine.inject_kv(dst, payload, epoch=dst.kv_epoch)
        back = await engine.extract_kv_blocks(dst.block_table)
        engine.release_held(seq)
        stream = await _tokens(engine.resume_prefilled(dst, first))
        return {"payload": _numpy_payload(payload),
                "back": _numpy_payload(back), "stale": stale,
                "misfits": misfits,
                "first": first, "stream": stream}
    finally:
        await engine.stop()


class _LocalPrefillClient:
    """An in-process prefill handler behind the component client's
    ``round_robin`` (the relay hop still rides the real transport)."""

    def __init__(self, handler):
        self.handler = handler

    def instance_ids(self):
        return [1]

    def round_robin(self, request, context):
        from dynamo_tpu_torch.runtime.context import Context

        return self.handler.generate(request, Context())


async def disagg_script(engine, cfg, tree, eng_kw, role, prompts, request):
    """Disaggregated serving between this multi-rank engine (``role``:
    the prefill or the decode side) and a one-rank engine over the same
    tree, both handlers on one device plane: the streams, the handlers'
    counters, whether the decode engine is registered on the plane, and
    the plane's answer when asked to register the multi-rank engine."""
    from dynamo_tpu_torch.disagg import handlers as th
    from dynamo_tpu_torch.disagg.ici import DevicePlane
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.transport import IngressServer

    solo = _solo_engine(cfg, tree, eng_kw)
    pre, dec = (engine, solo) if role == "prefill" else (solo, engine)
    plane = DevicePlane()
    ph = th.PrefillHandler(pre, plane=plane)
    dh = th.DecodeHandler(dec, prefill_client=_LocalPrefillClient(ph),
                          plane=plane,
                          config=th.DisaggConfig(min_remote_prefill_tokens=8))
    server = IngressServer(dh.inject_handler(), host="127.0.0.1", port=0)
    await server.start()
    dh.kv_inject_addr = f"127.0.0.1:{server.port}"
    try:
        streams = []
        for p in prompts:
            toks = []
            async for out in dh.generate(dict(request, token_ids=p),
                                         Context()):
                toks.extend(out["token_ids"])
            streams.append(toks)
        try:
            plane.register("mesh", engine)
            refused = None
        except ValueError as e:
            refused = str(e)
        return {"streams": streams,
                "counts": (dh.num_remote_prefills, dh.num_local_prefills,
                           ph.num_device_transfers, ph.num_relay_transfers),
                "decode_registered": dh.plane_id is not None,
                "refused": refused}
    finally:
        dh.close()
        if hasattr(ph, "_transport"):
            await ph._transport.close()
        await server.stop()
        await solo.stop()
        await engine.stop()


async def _settle(engine):
    import asyncio

    for _ in range(400):
        kvbm = engine.kvbm
        if (not engine.scheduler.running
                and (kvbm is None or not kvbm._pending)):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("engine never went idle")


def shared_prompts(seed, n=3, shared=16, tail=6):
    """``tests/test_torch_prefix_cache.py``'s prompts sharing a prefix."""
    import random

    rng = random.Random(seed)
    base = [rng.randrange(1, 200) for _ in range(shared)]
    return [base + [rng.randrange(1, 200) for _ in range(tail)]
            for _ in range(n)]


def index_dump(index):
    """Every node of a prefix index with all of its state, in key order."""
    return {h: (n.block_hash, n.parent, n.depth, sorted(n.children),
                {t: sorted(ws) for t, ws in n.holders.items()}, n.last_use)
            for h, n in sorted(index._nodes.items())}


async def kvbm_prefix_script(engine, cfg, tree, eng_kw):
    """``tests/test_torch_prefix_cache.py``'s prefix scenario with the
    KVBM host tier on this engine: offloads, prefix demotion
    (``evict_to_host``), ``clear_kv_blocks`` and onboarding back."""
    from dynamo_tpu_torch.engine import Request
    from dynamo_tpu_torch.kvbm.manager import KvbmConfig

    async def run(p, rid):
        return await _tokens(engine.submit(Request(
            request_id=rid, token_ids=list(p), max_tokens=4,
            ignore_eos=True)))

    engine.attach_kvbm(KvbmConfig(host_blocks=64))
    engine.attach_prefix_cache(worker_id=7)
    prompts = shared_prompts(11) + shared_prompts(12, n=2, shared=24)
    streams, snaps, dumps, demoted = [], [], [], []
    try:
        for i, p in enumerate(prompts + prompts[:2]):
            streams.append(await run(p, f"r{i}"))
            await _settle(engine)
            if i in (2, 5):
                demoted.append(await engine.prefix.evict_to_host(6))
            snaps.append(engine.prefix.snapshot())
            dumps.append(index_dump(engine.prefix.index))
        engine.clear_kv_blocks()
        snaps.append(engine.prefix.snapshot())
        dumps.append(index_dump(engine.prefix.index))
        streams.append(await run(prompts[0], "last"))
        await _settle(engine)
        snaps.append(engine.prefix.snapshot())
        dumps.append(index_dump(engine.prefix.index))
        return streams, snaps, dumps, demoted, engine.kvbm.snapshot()
    finally:
        await engine.stop()


async def evac_script(engine, cfg, tree, eng_kw, mode, prompt, max_tokens):
    """``tests/test_torch_preemption.py``'s scenario with this multi-rank
    engine as the source: drive one seat two tokens in, send a notice,
    then resume where the report says (one-rank engines over the same
    tree: the peer for PEER, a fresh engine on the spilled host pool for
    SPILL; a fresh one-rank engine on the journal record for FALLBACK).
    Returns the stream, the reason, the mode, the seats the notice
    journaled and the one-rank engine's stream of the same request."""
    import asyncio

    from dynamo_tpu_torch.engine import Request
    from dynamo_tpu_torch.kvbm.host_pool import HostBlockPool
    from dynamo_tpu_torch.kvbm.manager import KvbmConfig
    from dynamo_tpu_torch.runtime import preemption as tpre

    def req():
        return Request(request_id="r0", token_ids=list(prompt),
                       max_tokens=max_tokens, ignore_eos=True)

    async def collect(stream):
        toks, reason = {}, None
        async for out in stream:
            if out.token_id >= 0:
                toks[out.index] = out.token_id
            if out.finished:
                reason = out.finish_reason
        return [toks[i] for i in sorted(toks)], reason

    ref = _solo_engine(cfg, tree, eng_kw)
    peer = _solo_engine(cfg, tree, eng_kw) if mode == "peer" else None
    resume = _solo_engine(cfg, tree, eng_kw)
    pool = None
    if mode == "spill":
        pool = HostBlockPool(128)
        resume.attach_kvbm(KvbmConfig(host_blocks=128))
        resume.kvbm.host_pool = pool
    coord = tpre.PreemptionCoordinator(engine, peer=peer, host_pool=pool,
                                       notice_grace_s=0.0)
    try:
        want, _ = await collect(ref.submit(req()))
        progress = {"n": 0}

        async def drive():
            toks, reason = {}, None
            async for out in engine.submit(req()):
                if out.token_id >= 0:
                    toks[out.index] = out.token_id
                progress["n"] = len(toks)
                if out.finished:
                    reason = out.finish_reason
            return [toks[i] for i in sorted(toks)], reason

        task = asyncio.create_task(drive())
        while progress["n"] < 2 and not task.done():
            await asyncio.sleep(0.002)
        report = await coord.notice("test")
        got, reason = await task
        res = report.results[0]
        if res.mode == tpre.PEER:
            tail, _ = await collect(peer.resume_prefilled(
                res.dst_seq, res.record.first_token()))
            stream = got + tail[1:]
        else:
            tail, _ = await collect(resume.submit(
                res.record.resume_request()))
            stream = got + tail
        return {"reason": reason, "stream": stream, "want": want,
                "mode": res.mode, "moved": res.bytes_moved > 0,
                "results": len(report.results),
                "journaled": coord.journal.get("r0") is not None,
                "src_running": len(engine.scheduler.running)}
    finally:
        for e in (engine, ref, peer, resume):
            if e is not None:
                await e.stop()


async def embed_script(engine, cfg, tree, eng_kw, batch):
    """``engine.embed(batch)`` as numpy rows."""
    import numpy as np

    try:
        return np.asarray(await engine.embed(batch), np.float32)
    finally:
        await engine.stop()


async def mm_script(engine, cfg, tree, eng_kw, requests):
    """Greedy streams of multimodal requests (``Request`` field dicts),
    one after another, and the engine's mm prefill chunks."""
    from dynamo_tpu_torch.engine import Request

    try:
        out = []
        for i, r in enumerate(requests):
            out.append(await _tokens(engine.submit(
                Request(request_id=f"m{i}", **r))))
        return {"streams": out, "mm_prefills": engine.num_mm_prefills}
    finally:
        await engine.stop()


SCRIPTS = {"kv": kv_script, "disagg": disagg_script,
           "kvbm_prefix": kvbm_prefix_script, "evac": evac_script,
           "embed": embed_script, "mm": mm_script}


def mesh_script(rank, plans, cfg_kw, tree, eng_kw, script, *args):
    """A multi-rank engine (``eng_kw``: a ``mesh_shape`` or ``pp_stages``
    over the world) of ``ModelConfig.tiny(**cfg_kw)`` over the full tree:
    rank 0 leads and runs ``SCRIPTS[script](engine, cfg, tree, eng_kw,
    *args)``, returning its result, the plans it emitted and its
    collectives' counters; the others replay and return the plans they
    replayed, their counters and their mm prefill chunks. Every script
    stops its engines."""
    import asyncio

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.parallel import comm

    cfg = _cfg("tiny", **cfg_kw)
    engine = InferenceEngine(cfg, EngineConfig(**eng_kw),
                             params=params_from_numpy(tree, cfg, "cpu"),
                             device="cpu")
    comm.reset_stats()
    n = comm.world_size()
    if rank != 0:
        follow(engine, plans, rank)
        return {"replayed": dict(engine.num_replayed),
                "stats": dict(comm.STATS),
                "mm_prefills": engine.num_mm_prefills}
    emitted = lead(engine, plans, n)
    try:
        result = asyncio.run(SCRIPTS[script](engine, cfg, tree, eng_kw,
                                             *args))
    finally:
        for r in range(1, n):
            plans[r].put(None)
    return {"result": result, "emitted": emitted, "stats": dict(comm.STATS)}


def _np_bits(t):
    """A CPU tensor as a numpy array of its bits: bf16 as uint16, fp8 as
    uint8, the rest as they are."""
    import numpy as np
    import torch

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def ckpt_restore(rank, plans, path, cfg_name, shape, weight_dtype="bf16"):
    """This rank's sharded restore of the checkpoint ``path`` on mesh
    ``shape`` (``load_checkpoint(cfg=, mesh=)``), held bitwise against
    ``shard_params`` of the full restore. Returns (equal, bytes read by the
    sharded restore, {leaf path: its bits as numpy})."""
    from dynamo_tpu_torch.engine import EngineConfig
    from dynamo_tpu_torch.engine import model as tm
    from dynamo_tpu_torch.engine import weights as tweights
    from dynamo_tpu_torch.parallel.layout import make_mesh

    cfg = _cfg(cfg_name)
    got = tweights.load_checkpoint(path, cfg=cfg, mesh=make_mesh(shape),
                                   device="cpu")
    read = tweights.last_restore_stats["bytes"]
    ref = tm.shard_params(tweights.load_checkpoint(path, device="cpu"), cfg,
                          EngineConfig(mesh_shape=tuple(shape),
                                       weight_dtype=weight_dtype))
    got = {k: _np_bits(a) for k, a in tweights._flatten(got)}
    ref = {k: _np_bits(a) for k, a in tweights._flatten(ref)}
    same = set(got) == set(ref) and all(
        a.dtype == ref[k].dtype and a.shape == ref[k].shape
        and a.tobytes() == ref[k].tobytes() for k, a in got.items())
    return same, read, got
