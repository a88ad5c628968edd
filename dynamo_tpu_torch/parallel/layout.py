"""Canonical sharding layout: the one place axis names, meshes and
per-leaf partition specs come from.

Port of ``dynamo_tpu.parallel.layout``. The JAX package is single-program:
GSPMD reads a ``PartitionSpec`` per leaf and partitions one program over a
``Mesh``. Here each rank is a process (``torch.distributed``), so a spec is
read twice: once to slice the rank's part of a full tensor
(:func:`shard_tensor`), and once by the model, whose ``forward`` is written
for the slices (column-sharded projections local, one ``all_reduce`` after
each row-sharded one; ``engine/model.py``). A spec is a tuple with one entry
per dim: ``None`` (replicated along that dim) or an axis name, the same
entries as the JAX ``PartitionSpec`` of the same leaf.

The serving mesh is ``(dp, tp)`` or ``(dp, fsdp, tp)``, mesh-major: rank
``r = (d * fsdp + f) * tp + t`` sits at ``(d, f, t)``, the row-major order
JAX's ``make_mesh`` enumerates devices in (and its composite sequence axis,
:meth:`SpecLayout.seq_axes`, too). Parameters are *stored* sharded over
``fsdp`` as the JAX table says (a rank holds ``D / fsdp`` of every
column and row leaf's model dim) and gathered whole over the rank's fsdp
group just before use, as ZeRO-3 does (``engine/model.py``); the cache
and the hidden states are replicated over ``dp`` and ``fsdp``. The dp and
fsdp replicas run the dense step redundantly, as GSPMD runs the JAX
package's replicated activations, and differ only in a
sequence-parallel prefill, where the ranks of one tp index (the rank's
*seq column*, ``dp * fsdp`` ranks) each take a contiguous slice of the
prompt. :func:`check_divisible` and :func:`shard_range` refuse shards
that do not split evenly by name. ``ep`` falls back to ``tp`` as in the
JAX layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"
AXIS_FSDP = "fsdp"

ALL_AXES: Tuple[str, ...] = (
    AXIS_DP, AXIS_TP, AXIS_SP, AXIS_EP, AXIS_PP, AXIS_FSDP,
)

Spec = Tuple[Optional[str], ...]

UNEVEN = "uneven shards (ROADMAP.md queue A, item 6.8)"


def spec(*entries: Optional[str]) -> Spec:
    """The one validated spec constructor (entries: None or an axis)."""
    for e in entries:
        if e is not None and e not in ALL_AXES:
            raise ValueError(f"unknown mesh axis {e!r}; canonical axes: "
                             f"{ALL_AXES}")
    return tuple(entries)


SpecEntry = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the serving mesh: the axis sizes, its
    coordinate on each axis (``dp`` and ``tp``, and ``fsdp`` on a 3-D
    mesh, as the JAX mesh of the shape names them; an absent axis has
    size 1), the world's process group (``None`` for a one-rank mesh),
    and its groups (``comm.Group``; a one-rank group where the axis has
    size 1): its tp row, its dp column, its fsdp group (the ranks of
    equal dp and tp index) and its seq column (the ranks of equal tp
    index, over dp and fsdp, in rank order)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    group: Any = None
    tp_group: Any = None
    dp_group: Any = None
    fsdp_group: Any = None
    seq_group: Any = None


def check_mesh_shape(shape: Sequence[int]) -> Tuple[int, int, int]:
    """``(dp, fsdp, tp)`` of a served mesh shape: ``(dp, tp)`` (``fsdp``
    1) or ``(dp, fsdp, tp)``, every axis at least 1."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 2:
        dp, tp = shape
        fsdp = 1
    elif len(shape) == 3:
        dp, fsdp, tp = shape
    else:
        raise ValueError(
            f"mesh shape must be (dp, tp) or (dp, fsdp, tp), got {shape}")
    if min(dp, fsdp, tp) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    return dp, fsdp, tp


def make_mesh(shape: Sequence[int]) -> Mesh:
    """The rank's coordinates on the serving mesh, mesh-major (``r = (d *
    fsdp + f) * tp + t``), and its groups: its tp row, dp column, fsdp
    group, seq column and the world (``parallel/comm.py``; made once per
    world and shape, by every rank alike). A one-rank mesh needs no
    process group; a larger one needs ``comm`` initialised with
    ``world_size == dp * fsdp * tp``."""
    from . import comm

    dp, fsdp, tp = check_mesh_shape(shape)
    # the axes of the JAX mesh of this shape: a 2-D mesh has no fsdp axis
    axes = (AXIS_DP, AXIS_TP) if len(tuple(shape)) == 2 else (
        AXIS_DP, AXIS_FSDP, AXIS_TP)
    n = dp * fsdp * tp
    r = 0
    groups = (comm.SOLO,) * 4
    if n > 1:
        if comm.world_size() != n:
            raise RuntimeError(
                f"mesh {tuple(shape)} needs a world of {n} ranks; "
                f"torch.distributed has {comm.world_size()} (call "
                "parallel.multihost.initialize_distributed first)")
        groups = comm.mesh_groups(dp, fsdp, tp)
        r = comm.rank()
    sizes = {AXIS_DP: dp, AXIS_FSDP: fsdp, AXIS_TP: tp}
    coords = {AXIS_DP: r // (fsdp * tp), AXIS_FSDP: (r // tp) % fsdp,
              AXIS_TP: r % tp}
    return Mesh({a: sizes[a] for a in axes}, {a: coords[a] for a in axes},
                comm.group() if n > 1 else None, *groups)


def check_divisible(cfg, tp: int, fsdp: int = 1) -> None:
    """Refuse a model whose head, KV-head, expert, FFN or vocab count the
    tp axis does not divide (each rank holds whole heads and experts), or
    whose model dim the fsdp axis does not divide."""
    counts = [("num_heads", cfg.num_heads, AXIS_TP, tp),
              ("num_kv_heads", cfg.num_kv_heads, AXIS_TP, tp),
              ("vocab_size", cfg.vocab_size, AXIS_TP, tp),
              ("num_experts", cfg.num_experts, AXIS_TP, tp) if cfg.is_moe
              else ("intermediate_size", cfg.intermediate_size, AXIS_TP, tp),
              ("hidden_size", cfg.hidden_size, AXIS_FSDP, fsdp)]
    for what, n, axis, size in counts:
        if n % size:
            raise NotImplementedError(
                f"{what}={n} is not divisible by {axis}={size}: {UNEVEN}")


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Frozen per-leaf spec table over the serving mesh; each field holds
    the axis a role shards over, or ``None`` when the mesh does not carry
    it at a size above 1. The table is the JAX ``SpecLayout``'s:

    ====================  ====================  =============================
    leaf                  shape                 spec
    ====================  ====================  =============================
    embed                 [V, D]                (tp, fsdp)   vocab-sharded
    layers/attn_norm      [L, D]                ()           replicated
    layers/wq, wk, wv     [L, D, Hx*hd]         (None, fsdp, tp)   column
    layers/wo             [L, H*hd, D]          (None, tp, fsdp)   row
    layers/mlp_norm       [L, D]                ()           replicated
    layers/w_gate, w_up   [L, D, F]             (None, fsdp, tp)   column
    layers/w_down         [L, F, D]             (None, tp, fsdp)   row
    layers/w_router       [L, D, E]             ()           replicated
    layers/w_* (moe)      [L, E, ., .]          (None, ep, None, None)
    final_norm            [D]                   ()           replicated
    lm_head               [D, V]                (fsdp, tp)   column
    KV cache (per layer)  [NB, KV, bs, hd]      (None, tp, None, None)
    logits                [B, V]                (None, tp)
    ====================  ====================  =============================

    A quantized leaf is ``{"q": weight spec, "s": scale spec}``; the scale
    keeps the weight's spec with the contraction entry (-2) replicated.
    """

    dp: Optional[str] = None
    fsdp: Optional[str] = None
    tp: Optional[str] = None
    ep: Optional[str] = None

    @staticmethod
    def for_mesh(mesh_shape: Optional[Sequence[int]]) -> "SpecLayout":
        """The layout of a ``(dp, tp)`` or ``(dp, fsdp, tp)`` mesh shape,
        singleton axes dropped; ``ep`` rides ``tp``."""
        if mesh_shape is None:
            return SpecLayout()
        dp, fsdp, tp = check_mesh_shape(mesh_shape)
        have_tp = AXIS_TP if tp > 1 else None
        return SpecLayout(dp=AXIS_DP if dp > 1 else None,
                          fsdp=AXIS_FSDP if fsdp > 1 else None, tp=have_tp,
                          ep=have_tp)

    @staticmethod
    def of(mesh: Mesh) -> "SpecLayout":
        """The layout of a rank's :class:`Mesh` (its axis sizes)."""
        return SpecLayout.for_mesh((mesh.shape[AXIS_DP],
                                    mesh.shape.get(AXIS_FSDP, 1),
                                    mesh.shape[AXIS_TP]))

    # ------------------------- sequence axis ---------------------------

    def seq_axes(self) -> SpecEntry:
        """The composite axis a sequence-parallel prefill splits the
        chunk's T over: every data-carrying serving axis, mesh-major —
        ``("dp", "fsdp", "tp")`` on a 3-D mesh, one name where one axis is
        above 1, ``None`` alone. Row-major over the composite axis is the
        rank order, so the JAX chunk ``c`` of ``dp * fsdp * tp`` sits on
        rank ``c``; the port's forward gives the rank at seq index ``s =
        d * fsdp + f`` the union of chunks ``s*tp .. s*tp+tp-1`` (one
        contiguous slice), which agrees with it."""
        axes = tuple(a for a in (self.dp, self.fsdp, self.tp) if a)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    # ----------------------- parameter specs ---------------------------

    def embed(self) -> Spec:
        return spec(self.tp, self.fsdp)

    def norm_stacked(self) -> Spec:
        return spec(None, None)

    def norm(self) -> Spec:
        return spec(None)

    def column_stacked(self) -> Spec:
        """[L, in, out] column-parallel: wq/wk/wv, dense w_gate/w_up."""
        return spec(None, self.fsdp, self.tp)

    def row_stacked(self) -> Spec:
        """[L, in, out] row-parallel: wo, dense w_down."""
        return spec(None, self.tp, self.fsdp)

    def router_stacked(self) -> Spec:
        return spec(None, None, None)

    def expert_stacked(self) -> Spec:
        """[L, E, in, out]: experts spread over ep (tp fallback)."""
        return spec(None, self.ep, None, None)

    def lm_head(self) -> Spec:
        return spec(self.fsdp, self.tp)

    @staticmethod
    def scale_spec(weight_spec: Spec) -> Spec:
        """Per-channel scales: the weight's spec with the contraction
        entry (-2, size 1 in the scale) replicated."""
        entries = list(weight_spec)
        entries[-2] = None
        return spec(*entries)

    def param_specs(self, cfg, weight_dtype: str = "bf16") -> Dict[str, Any]:
        """Spec tree matching ``model.init_params(cfg)`` (quantized matmul
        leaves as ``{"q", "s"}`` dicts)."""
        from ..engine import quant

        def w(s: Spec, name: str) -> Any:
            if quant.is_quantized(weight_dtype) and quant.is_weight_leaf(
                    name):
                return {"q": s, "s": self.scale_spec(s)}
            return s

        layers: Dict[str, Any] = {
            "attn_norm": self.norm_stacked(),
            "wq": w(self.column_stacked(), "wq"),
            "wk": w(self.column_stacked(), "wk"),
            "wv": w(self.column_stacked(), "wv"),
            "wo": w(self.row_stacked(), "wo"),
            "mlp_norm": self.norm_stacked(),
        }
        if cfg.is_moe:
            layers["w_router"] = self.router_stacked()
            layers["w_gate"] = w(self.expert_stacked(), "w_gate")
            layers["w_up"] = w(self.expert_stacked(), "w_up")
            layers["w_down"] = w(self.expert_stacked(), "w_down")
        else:
            layers["w_gate"] = w(self.column_stacked(), "w_gate")
            layers["w_up"] = w(self.column_stacked(), "w_up")
            layers["w_down"] = w(self.row_stacked(), "w_down")
        specs: Dict[str, Any] = {
            "embed": self.embed(),
            "layers": layers,
            "final_norm": self.norm(),
        }
        if not cfg.tie_word_embeddings:
            specs["lm_head"] = w(self.lm_head(), "lm_head")
        return specs

    # ---------------------- cache / activations ------------------------

    def cache_block(self) -> Spec:
        """One paged-cache layer [NB, KV, bs, hd]: KV heads over tp."""
        return spec(None, self.tp, None, None)

    def cache_scale_block(self) -> Spec:
        """Per-layer KV-scale cache [NB, KV, bs] of a quantized cache."""
        return spec(None, self.tp, None)

    def kv_blocks(self) -> Spec:
        """An extracted or injected KV block payload [L, N, KV, bs, hd]:
        KV heads over tp, as in the cache, so a rank's slice of a payload
        is its cache's heads."""
        return spec(None, None, self.tp, None, None)

    def kv_scale_blocks(self) -> Spec:
        """The scale payload [L, N, KV, bs] of a quantized cache."""
        return spec(None, None, self.tp, None)

    def kv_payload_specs(self, keys) -> Dict[str, Spec]:
        """Per-key specs of a KV block payload dict (the JAX
        ``kv_payload_shardings``): pages ``kv_blocks``, scale planes
        ``kv_scale_blocks``."""
        return {k: (self.kv_scale_blocks() if k in ("ks", "vs")
                    else self.kv_blocks()) for k in keys}

    def cache_specs(self, cfg, kv_dtype: str = "bf16") -> Dict[str, Any]:
        from ..engine import quant

        specs = {
            "k": [self.cache_block()] * cfg.num_layers,
            "v": [self.cache_block()] * cfg.num_layers,
        }
        if quant.is_quantized(kv_dtype):
            specs["ks"] = [self.cache_scale_block()] * cfg.num_layers
            specs["vs"] = [self.cache_scale_block()] * cfg.num_layers
        return specs

    def hidden(self) -> Spec:
        """Activations [B, T, D]: replicated (Megatron)."""
        return spec(None, None, None)

    def hidden_seq(self) -> Tuple[SpecEntry, ...]:
        """Sequence-parallel prefill activations [B, T, D]: T over the
        composite sequence axis."""
        return (None, self.seq_axes(), None)

    def heads_seq(self) -> Tuple[SpecEntry, ...]:
        """Sequence-parallel prefill q/k/v [B, T, Hx, hd]: T over the
        composite sequence axis."""
        return (None, self.seq_axes(), None, None)

    def logits(self) -> Spec:
        """[B, V]: vocab over tp, matching the vocab-sharded head."""
        return spec(None, self.tp)


# ----------------------------- slicing -------------------------------------


def shard_range(n: int, axis: Optional[str], mesh: Mesh) -> Tuple[int, int]:
    """``[lo, hi)`` of this rank's even share of a dim of size ``n``
    split over ``axis`` (the whole dim for ``None``)."""
    if axis is None:
        return 0, n
    size = mesh.shape.get(axis, 1)
    idx = mesh.coords.get(axis, 0)
    if n % size:
        raise NotImplementedError(
            f"a dim of {n} does not split evenly over {axis}={size}: "
            f"{UNEVEN}")
    step = n // size
    return idx * step, (idx + 1) * step


def shard_index(shape: Sequence[int], sp: Spec,
                mesh: Mesh) -> Tuple[slice, ...]:
    """This rank's slice of each dim of a leaf of ``shape`` under ``sp``:
    the one slicing rule that :func:`shard_tensor`, the sharded HF loader
    and the sharded checkpoint restore (``engine/weights.py``) share."""
    return tuple(slice(*shard_range(n, axis, mesh))
                 for n, axis in zip(shape, sp))


def shard_shape(shape: Sequence[int], sp: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of this rank's slice of a leaf of ``shape``."""
    return tuple(s.stop - s.start for s in shard_index(shape, sp, mesh))


def shard_tensor(t, sp: Spec, mesh: Mesh):
    """This rank's slice of a full tensor, contiguous (a new tensor, so
    the full one can be freed)."""
    return t[shard_index(t.shape, sp, mesh)].contiguous()


def map_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a param/cache tree and its spec tree."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, tree[k], specs[k]) for k in specs}
    if isinstance(specs, list):
        return [map_specs(fn, a, s) for a, s in zip(tree, specs)]
    return fn(tree, specs)
