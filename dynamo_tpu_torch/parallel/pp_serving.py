"""Pipeline-parallel SERVING: the engine's unified prefill/decode step run
GPipe-style over stages that are ranks, with the paged KV cache split by
layer.

Port of ``dynamo_tpu.parallel.pp_serving``. The JAX package decides the
layout by shardings over a ``pp`` mesh axis; here each stage is a rank of
the ``torch.distributed`` world (``parallel/comm.py``), one engine per
rank, and the layout is what each rank holds:

- stage s holds layers ``[s*L/S, (s+1)*L/S)`` of the stacked layer tree
  (:func:`pp_param_shardings` slices it, or ``weights.load_hf_params``
  reads only those layers) and the cache planes of those layers only
  (:func:`init_pp_cache`);
- ``embed``, ``final_norm`` and ``lm_head`` are replicated: embedding and
  sampling are small next to the layer stack, and replicating them avoids
  edge hops.

Schedule: GPipe over the BATCH axis (``parallel/pipeline.py`` ``gpipe``):
B rows split into M microbatches (M clamped so that it divides B), the
activation ``[mb, T, D]`` hops stage to stage by ``comm.ppermute``. A
decode batch microbatches well; a single-sequence prefill chunk runs M = 1
(full bubble), as in JAX. Stage 0 embeds; each stage runs its layers
through the engine's own layer body (``model.layer_forward``: the
kernel's decode face for decode steps, its ragged face for prefill
chunks, where the JAX stage always runs the gathered-context einsum — the
same function by another route, as ``forward`` is); the last stage
normalises, takes the logits and samples, and one ``broadcast`` hands the
sampled tokens to every stage, so every rank's step returns the same
``sampled[B]``. Every rank draws its step key in lockstep (the engine's
generator), the last stage uses it.

Correctness notes, as in JAX: pad rows (position -1) scatter to the
trash block 0; a bubble tick runs no layer at all here (it is known on the
host), so it touches no cache; the causal order within a sequence holds
because each stage processes microbatches in order.

Same signature as ``model.raw_step_fn``, so the engine and
``multihost.replay_plan`` call it unchanged.

Embeddings (:func:`make_pp_encode_fn`): the JAX pp engine encodes with a
mesh-less encode fn over its whole tree; a stage here holds only its
layers, so the stages run the encode together, the same schedule at
M = 1: stage 0 looks up the tokens, each stage runs its layers through
the encode body (``model.encode_layer``) on ``[B, T, D]``, the hidden
state hops by ``ppermute``, and the last stage norms and pools, then one
``broadcast`` hands the ``[B, D]`` vectors to every stage.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..engine import model as model_lib
from ..engine.config import EngineConfig, ModelConfig
from ..parallel.layout import make_mesh
from . import comm
from .pipeline import broadcast_last, gpipe, stage_slice

Cache = model_lib.Cache


def make_pp_mesh(num_stages: int) -> comm.Group:
    """The pp group: the world, whose rank r is stage r (a ``(1, 1)``
    serving mesh, so the world is the only group). Needs ``comm``
    initialised with ``world_size == num_stages``."""
    if comm.world_size() != num_stages:
        raise RuntimeError(
            f"pp_stages={num_stages} needs a world of {num_stages} ranks; "
            f"torch.distributed has {comm.world_size()} (call "
            "parallel.multihost.initialize_distributed first)")
    return comm.world_group()


def stage_layers(cfg: ModelConfig, num_stages: int,
                 stage: int) -> Tuple[int, int]:
    """``(lo, hi)``: the layers stage ``stage`` of ``num_stages`` holds."""
    if cfg.num_layers % num_stages:
        raise ValueError(
            f"num_layers {cfg.num_layers} not divisible by pp={num_stages}")
    per = cfg.num_layers // num_stages
    return stage * per, (stage + 1) * per


def init_pp_cache(cfg: ModelConfig, eng: EngineConfig,
                  device: torch.device) -> Cache:
    """This stage's paged cache: the per-layer planes of its
    ``L / pp_stages`` layers only (the JAX stacked cache's stage shard)."""
    return model_lib.init_cache(cfg, eng, device,
                                num_layers=cfg.num_layers // eng.pp_stages)


def pp_param_shardings(params: model_lib.Params, cfg: ModelConfig,
                       stage: int, num_stages: int) -> model_lib.Params:
    """This stage's tree: the layer stack cut to the stage's layers (each
    leaf copied, so the caller can free the full tree), everything else
    replicated. A tree already holding only the stage's layers
    (``weights.load_hf_params(..., layers=)``) passes unchanged."""
    lo, hi = stage_layers(cfg, num_stages, stage)
    if params["layers"]["attn_norm"].shape[0] == hi - lo:
        return params
    out = dict(params)
    out["layers"] = {
        name: ({k: t.clone() for k, t in leaf.items()}
               if isinstance(leaf, dict) else leaf.clone())
        for name, leaf in stage_slice(params["layers"], stage,
                                      num_stages).items()
    }
    return out


def _stage_layers(cfg: ModelConfig, eng: EngineConfig, Lp: int,
                  layers: Any, cache: Cache, h: torch.Tensor,
                  positions: torch.Tensor, block_tables: torch.Tensor,
                  mesh) -> torch.Tensor:
    """This stage's ``Lp`` layers over one microbatch ``h [mb, T, D]``,
    its K/V scattered into the stage's cache in place."""
    c = model_lib.chunk_plan(cfg, eng, positions, block_tables, False, mesh)
    for li in range(Lp):
        h = model_lib.layer_forward(cfg, eng,
                                    model_lib._layer_slice(layers, li),
                                    cache, li, h, c)
    return h


def raw_pp_step_fn(cfg: ModelConfig, eng: EngineConfig, group: comm.Group,
                   num_microbatches: int = 4):
    """The pipelined unified step of this rank's stage (``group.index``
    of ``group.size``), with ``model.raw_step_fn``'s signature:

      step(params, cache, tokens[B,T], positions[B,T], block_tables[B,W],
           last_idx[B], key, temperature[B], top_k[B], top_p[B], seeds[B],
           stochastic) -> (cache, sampled[B])

    ``params`` and ``cache`` are the stage's; ``sampled`` is the same on
    every rank."""
    S = group.size
    Lp = stage_layers(cfg, S, 0)[1]
    mesh = make_mesh(eng.mesh_shape)

    def step(params, cache, tokens, positions, block_tables, last_idx, key,
             temperature, top_k, top_p, seeds, stochastic):
        B, T = tokens.shape
        W = block_tables.shape[1]
        M = num_microbatches
        while B % M:                # bucketed B is a power of two
            M //= 2
        mb = B // M
        positions = positions.long()
        tok_mb = tokens.reshape(M, mb, T)
        pos_mb = positions.reshape(M, mb, T)
        tbl_mb = block_tables.to(torch.int32).reshape(M, mb, W)
        embed = params["embed"]

        def feed(m: int) -> torch.Tensor:
            return model_lib._embed_lookup(embed, tok_mb[m], cfg.vocab_size,
                                           mesh.tp_group)

        def run(m: int, h: torch.Tensor) -> torch.Tensor:
            return _stage_layers(cfg, eng, Lp, params["layers"], cache, h,
                                 pos_mb[m], tbl_mb[m].contiguous(), mesh)

        blank = torch.zeros((mb, T, cfg.hidden_size), dtype=embed.dtype,
                            device=tokens.device)
        banked = gpipe(group, M, feed, run, blank)
        sampled: Optional[torch.Tensor] = None
        if banked is not None:          # the last stage samples
            h = model_lib._rms_norm(torch.cat(banked), params["final_norm"],
                                    cfg.rms_norm_eps)
            rows = torch.arange(B, device=tokens.device)
            last = last_idx.long()
            logits = model_lib.logits_fn(cfg, params, h[rows, last])
            sampled = model_lib.sample(logits, key, temperature, top_k,
                                       top_p, seeds, positions[rows, last],
                                       stochastic)
        sampled = broadcast_last(
            sampled, group,
            torch.empty((B,), dtype=torch.int32, device=tokens.device))
        return cache, sampled

    return step


def make_pp_encode_fn(cfg: ModelConfig, group: comm.Group):
    """The encode step of this rank's stage, with ``model.make_encode_fn``'s
    signature: ``encode(params, tokens[B,T], positions[B,T]) -> [B, D]``
    f32, the same on every rank, run without autograd."""
    S = group.size
    Lp = stage_layers(cfg, S, 0)[1]

    def run_layers(params, h, positions, cos, sin):
        for li in range(Lp):
            h = model_lib.encode_layer(
                cfg, model_lib._layer_slice(params["layers"], li), h,
                positions, cos, sin, comm.SOLO)
        return h

    @torch.inference_mode()
    def encode(params, tokens, positions):
        B, T = tokens.shape
        positions = positions.long()
        cos, sin = model_lib._rope_tables(positions, cfg.rope_theta,
                                          cfg.head_dim_)
        embed = params["embed"]
        blank = torch.zeros((B, T, cfg.hidden_size), dtype=embed.dtype,
                            device=tokens.device)
        banked = gpipe(group, 1, lambda m: embed[tokens.long()],
                       lambda m, h: run_layers(params, h, positions, cos,
                                               sin), blank)
        pooled = None
        if banked is not None:          # the last stage pools
            pooled = model_lib.encode_pool(cfg, params, banked[0], positions)
        return broadcast_last(
            pooled, group,
            torch.empty((B, cfg.hidden_size), dtype=torch.float32,
                        device=tokens.device))

    return encode


def make_pp_step_fn(cfg: ModelConfig, eng: EngineConfig, group: comm.Group,
                    num_microbatches: int = 4):
    """The engine's pp step: :func:`raw_pp_step_fn` run without autograd
    (the JAX package jits it with the cache donated; here the cache is
    updated in place)."""
    raw = raw_pp_step_fn(cfg, eng, group, num_microbatches)

    def step(*args):
        with torch.inference_mode():
            return raw(*args)

    return step
