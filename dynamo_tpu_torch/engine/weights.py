"""Model weights: HF safetensors checkpoints, and parameters from a numpy
tree.

Port of ``dynamo_tpu.engine.weights`` (the one-device loader). The stacked
layout wants every per-layer leaf stacked on a leading L axis (and expert
leaves on ``[L, E, …]``), and ``x @ W`` wants HF's ``[out, in]`` Linear
weights transposed. Dense (Llama 2/3) and MoE (Mixtral-style
``block_sparse_moe``) checkpoints are read.

:func:`load_hf_params` streams tensor by tensor from the memory-mapped files
(``engine/safetensors.py``, the port's own reader) into leaves preallocated
on the target device: each tensor is copied to the device once, transposed
there, quantized there when ``weight_dtype`` asks for it (per-output-channel
scales over axis -2, the bytes of the JAX loader's ``quant.quantize_np``),
and written into its slot; its file pages are then dropped. Host memory
holds about one tensor at a time, never a stacked leaf.
:func:`load_hf_params_sharded` does the same for one rank of a tensor-
parallel mesh: it reads only the rank's slice of each tensor (its experts
only, for MoE stacks) into leaves of the shard's shape. With ``layers=(lo,
hi)`` :func:`load_hf_params` reads only those layers' tensors (plus the
embedding, final norm and head), for a pipeline stage.

:func:`save_checkpoint` / :func:`load_checkpoint` are the counterparts of
the JAX package's orbax checkpoints, in the port's own format: a directory
of safetensors files holding the parameter tree as the model keeps it (the
stacked ``[in, out]`` leaves; a quantized leaf as its ``q`` and ``s``), with
a manifest in each file's ``__metadata__``. Restored with a ``cfg`` and a
``mesh``, each rank reads only its own slice of each leaf from the files
(:func:`abstract_params` gives each leaf's shape, dtype and spec).

:func:`params_from_numpy` turns the JAX package's parameter tree
(``dynamo_tpu.engine.model.init_params``), converted leaf by leaf to numpy,
into this package's parameters on ``device`` — so both packages compute the
same thing in the tests. bf16 leaves arrive as numpy ``uint16`` views of
their bits, because ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``. A
tree quantized by the JAX package (``quant.quantize_params``) carries
``{"q", "s"}`` leaves: ``q`` int8, or fp8 e4m3 as a ``uint8`` view of its
bits, and ``s`` float32; given the ``weight_dtype`` they become this
package's quantized leaves, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.layout import (
    Mesh, Spec, SpecLayout, make_mesh, shard_index, shard_range,
    shard_shape, shard_tensor,
)
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from . import quant
from .config import ModelConfig
from .model import Params, torch_dtype
from .safetensors import DTYPES, SafeFile, save_file

log = get_logger("engine.weights")

# stats of the most recent load_hf_params call: tensors, files, bytes read,
# seconds, read rate, and the process's resident set before the load and
# its peak over the load (sampled after each tensor)
last_load_stats: Dict[str, Any] = {}


def _scale_shape(shape: tuple) -> tuple:
    """Per-output-channel scale shape for a weight of ``shape``: the
    contraction axis (-2) collapses to 1, ``keepdims`` style."""
    return shape[:-2] + (1,) + shape[-1:]


def _stacked_shapes(cfg: ModelConfig,
                    L: Optional[int] = None) -> Dict[str, tuple]:
    """Each stacked layer leaf's shape at ``L`` layers (default all)."""
    L = cfg.num_layers if L is None else L
    hd = cfg.head_dim_
    D, H, KV, F, E = (
        cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
        cfg.intermediate_size, cfg.num_experts,
    )
    layers = {
        "attn_norm": (L, D),
        "wq": (L, D, H * hd),
        "wk": (L, D, KV * hd),
        "wv": (L, D, KV * hd),
        "wo": (L, H * hd, D),
        "mlp_norm": (L, D),
    }
    if cfg.is_moe:
        layers.update({
            "w_router": (L, D, E),
            "w_gate": (L, E, D, F),
            "w_up": (L, E, D, F),
            "w_down": (L, E, F, D),
        })
    else:
        layers.update({
            "w_gate": (L, D, F),
            "w_up": (L, D, F),
            "w_down": (L, F, D),
        })
    return layers


_LAYER_TABLE = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "block_sparse_moe.gate.weight": ("w_router", True),
}
# Mixtral: w1 = gate, w3 = up, w2 = down
_EXPERT_TABLE = {"w1.weight": "w_gate", "w3.weight": "w_up",
                 "w2.weight": "w_down"}


def _dest(cfg: ModelConfig, name: str):
    """Map an HF tensor name to (leaf_path, layer_idx, expert_idx,
    transpose). Returns None for tensors we ignore (rotary inv_freq etc.)."""
    if name == "model.embed_tokens.weight":
        return ("embed", None, None, False)
    if name == "model.norm.weight":
        return ("final_norm", None, None, False)
    if name == "lm_head.weight":
        if cfg.tie_word_embeddings:
            return None
        return ("lm_head", None, None, True)
    if not name.startswith("model.layers."):
        return None
    rest = name[len("model.layers."):]
    idx, _, sub = rest.partition(".")
    i = int(idx)
    if sub in _LAYER_TABLE:
        leaf, t = _LAYER_TABLE[sub]
        return (leaf, i, None, t)
    if sub.startswith("block_sparse_moe.experts."):
        erest = sub[len("block_sparse_moe.experts."):]
        eidx, _, ew = erest.partition(".")
        if ew in _EXPERT_TABLE:
            return (_EXPERT_TABLE[ew], i, int(eidx), True)
    return None


_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> Optional[int]:
    """The process's resident set now, from ``/proc/self/statm`` (None
    where there is none). Not ``ru_maxrss``: Linux carries a parent's peak
    across ``fork`` + ``exec`` into it."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return None


def load_hf_params(path, cfg: ModelConfig, weight_dtype: str = "bf16",
                   device=None, layers: Optional[Tuple[int, int]] = None
                   ) -> Params:
    """Load an HF-format checkpoint directory (``*.safetensors``) into the
    stacked param tree on ``device`` (``cuda`` unless asked for the CPU),
    cast to ``cfg.dtype``. With a quantized ``weight_dtype`` each matmul
    tensor is quantized as it arrives, so the leaves hold the 1-byte
    payload plus float32 scales and no full-precision copy of a quantized
    leaf ever exists.

    ``layers=(lo, hi)`` loads a pipeline stage: the layer stack holds
    layers ``lo..hi-1`` only (its leading axis ``hi - lo``; the other
    layers' tensors are never read), the embedding, final norm and head
    whole — bitwise the ``[lo:hi]`` slice of the full load."""
    return _load(path, cfg, weight_dtype, device, None, layers)


def load_hf_params_sharded(path, cfg: ModelConfig, mesh: Mesh,
                           weight_dtype: str = "bf16", device=None) -> Params:
    """This rank's shard of an HF checkpoint: every leaf at its shard shape
    on the ``(dp, tp)`` or ``(dp, fsdp, tp)`` ``mesh``
    (``parallel/layout.py``), bitwise equal to slicing what
    :func:`load_hf_params` loads.

    Only the rank's part of each tensor is read from the mapping: its
    tp range and its fsdp range of each dim the layout shards (a row
    range and a strided column range of an HF ``[out, in]`` tensor; the
    embedding and head likewise), the rank's experts of an MoE stack (the
    others are never read), the whole of a replicated one. A quantized
    leaf whose contraction axis is split (a row-sharded ``wo`` or dense
    ``w_down`` over tp, a column leaf or the head over fsdp) is the
    exception: its per-output-channel scale is an amax over that axis,
    which the ranks split, so the whole tensor is staged, quantized, then
    sliced — as the JAX loader quantizes after staging. Peak host staging
    stays one tensor (``last_load_stats["peak_staging_bytes"]``)."""
    return _load(path, cfg, weight_dtype, device, mesh)


def _load(path, cfg: ModelConfig, weight_dtype: str, device,
          mesh: Optional[Mesh],
          layers: Optional[Tuple[int, int]] = None) -> Params:
    t0 = time.perf_counter()
    path = Path(path)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    quantized = quant.is_quantized(weight_dtype)
    if mesh is None:
        mesh = make_mesh((1, 1, 1))
    specs = SpecLayout.of(mesh).param_specs(cfg)   # weight specs

    def _buf(name: str, shape: tuple):
        shape = shard_shape(shape, specs["layers"][name], mesh)
        if quantized and quant.is_weight_leaf(name):
            return {"q": torch.zeros(shape, device=device,
                                     dtype=quant.storage_dtype(weight_dtype)),
                    "s": torch.zeros(_scale_shape(shape), device=device,
                                     dtype=torch.float32)}
        return torch.zeros(shape, device=device, dtype=dt)

    first, end = (0, cfg.num_layers) if layers is None else layers
    layers = {k: _buf(k, shape)
              for k, shape in _stacked_shapes(cfg, end - first).items()}
    top: Dict[str, Any] = {}
    seen = set()
    nbytes = 0
    staged = 0
    rss = [_rss_bytes()]   # before, then after each tensor

    for f in files:
        with SafeFile(f) as sf:
            for name in sf.keys():
                dest = _dest(cfg, name)
                if dest is None:
                    continue
                leaf, i, e, transpose = dest
                if i is not None:
                    if not first <= i < end:
                        continue        # another pipeline stage's layer
                    i -= first
                # the spec of this one tensor in our [in, out] layout (the
                # stacked leaf's without its L / (L, E) dims)
                sp = specs[leaf] if i is None else specs["layers"][leaf]
                if e is not None:
                    lo, hi = shard_range(cfg.num_experts, sp[1], mesh)
                    if not lo <= e < hi:
                        continue        # another rank's expert
                    e -= lo
                sp = sp[-2:] if i is not None else sp
                whole = (quantized and quant.is_weight_leaf(leaf)
                         and sp[-2] is not None)
                t = sf.get_tensor(name)
                if not whole:
                    hf_sp = sp[::-1] if transpose else sp
                    t = t[shard_index(t.shape, hf_sp, mesh)]
                n = t.numel() * t.element_size()
                staged = max(staged, n)
                t = t.to(device, copy=True)
                nbytes += n
                sf.release(name)
                if transpose:
                    t = t.T
                slot = (i,) if e is None else (i, e)
                if quantized and quant.is_weight_leaf(leaf):
                    qd = quant.quantize(t, weight_dtype)
                    if whole:
                        qd = {"q": shard_tensor(qd["q"], sp, mesh),
                              "s": shard_tensor(qd["s"],
                                                SpecLayout.scale_spec(sp),
                                                mesh)}
                    if i is None:
                        top[leaf] = {k: v.contiguous() for k, v in qd.items()}
                    else:
                        for k in ("q", "s"):
                            layers[leaf][k][slot].copy_(qd[k])
                elif i is None:
                    top[leaf] = t.to(dt).contiguous()
                else:
                    layers[leaf][slot].copy_(t)
                seen.add((leaf, i, e))
                rss.append(_rss_bytes())

    params: Params = {
        "embed": top["embed"],
        "layers": layers,
        "final_norm": top["final_norm"],
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = top["lm_head"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    peak = None if None in rss else max(rss)
    last_load_stats.clear()
    last_load_stats.update(
        n_tensors=len(seen), n_files=len(files), bytes=nbytes, seconds=secs,
        gb_s=nbytes / max(secs, 1e-9) / 1e9, rss_before_bytes=rss[0],
        peak_rss_bytes=peak, peak_staging_bytes=staged,
        shard=(mesh.coords["tp"], mesh.shape["tp"]),
        fsdp_shard=(mesh.coords.get("fsdp", 0), mesh.shape.get("fsdp", 1)),
        layers=(first, end))
    log.info("loaded %d tensors (%.3f GB) from %s (%d files, "
             "weight_dtype=%s, shard %d/%d, fsdp %d/%d, layers %d..%d) onto "
             "%s in %.2f s: %.2f GB/s, peak host RSS %s", len(seen),
             nbytes / 1e9, path, len(files), weight_dtype, mesh.coords["tp"],
             mesh.shape["tp"], mesh.coords.get("fsdp", 0),
             mesh.shape.get("fsdp", 1), first, end - 1, device, secs,
             last_load_stats["gb_s"],
             "not measured" if peak is None else
             f"{peak / 2**30:.2f} GiB ({rss[0] / 2**30:.2f} GiB before)")
    return params


def model_config_from_hf(path) -> ModelConfig:
    """Build a ModelConfig from an HF ``config.json``. As in the reference,
    ``rope_scaling`` and ``torch_dtype`` are not read (ROADMAP.md logs
    it)."""
    with open(Path(path) / "config.json") as f:
        c = json.load(f)
    return ModelConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c.get("num_key_value_heads",
                           c["num_attention_heads"]),
        head_dim=c.get("head_dim"),
        rope_theta=c.get("rope_theta", 10000.0),
        rms_norm_eps=c.get("rms_norm_eps", 1e-5),
        max_position=c.get("max_position_embeddings", 8192),
        tie_word_embeddings=c.get("tie_word_embeddings", False),
        num_experts=c.get("num_local_experts", 0),
        num_experts_per_token=c.get("num_experts_per_tok", 0),
    )


# ------------------- writing a checkpoint (tests, smoke) -------------------


def hf_config(cfg: ModelConfig) -> Dict[str, Any]:
    """The ``config.json`` that :func:`model_config_from_hf` reads back as
    ``cfg`` (dtype aside: the reader ignores ``torch_dtype``)."""
    c: Dict[str, Any] = {
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": cfg.dtype,
    }
    if cfg.head_dim is not None:
        c["head_dim"] = cfg.head_dim
    if cfg.is_moe:
        c["num_local_experts"] = cfg.num_experts
        c["num_experts_per_tok"] = cfg.num_experts_per_token
    return c


def hf_tensors(params: Params, cfg: ModelConfig
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(HF name, tensor in HF's ``[out, in]`` layout) for every tensor of an
    unquantized param tree — the inverse of :func:`_dest`."""
    rev = {leaf: sub for sub, (leaf, _) in _LAYER_TABLE.items()}
    erev = {leaf: sub for sub, leaf in _EXPERT_TABLE.items()}
    yield "model.embed_tokens.weight", params["embed"]
    yield "model.norm.weight", params["final_norm"]
    if not cfg.tie_word_embeddings:
        yield "lm_head.weight", params["lm_head"].T
    for i in range(cfg.num_layers):
        for leaf, w in params["layers"].items():
            if isinstance(w, dict):
                raise TypeError("hf_tensors writes unquantized trees only")
            if cfg.is_moe and leaf in erev:
                for e in range(cfg.num_experts):
                    yield (f"model.layers.{i}.block_sparse_moe.experts.{e}."
                           f"{erev[leaf]}", w[i, e].T)
                continue
            sub = rev[leaf]
            yield (f"model.layers.{i}.{sub}",
                   w[i].T if _LAYER_TABLE[sub][1] else w[i])


def save_hf_params(path, params: Params, cfg: ModelConfig,
                   n_shards: int = 1) -> None:
    """Write ``params`` as an HF checkpoint directory: ``config.json`` and
    ``n_shards`` ``model-XXXXX-of-XXXXX.safetensors`` files of about equal
    size, in the port's own safetensors writer (for tests and the card
    smoke; the loader never needs it)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_config(cfg), indent=2))
    names = [(n, t.numel() * t.element_size())
             for n, t in hf_tensors(params, cfg)]
    per = sum(b for _, b in names) / n_shards
    shards, acc = [[] for _ in range(n_shards)], 0
    for n, b in names:
        shards[min(int(acc // per), n_shards - 1)].append(n)
        acc += b
    tensors = dict(hf_tensors(params, cfg))
    for k, shard in enumerate(shards):
        save_file({n: tensors[n] for n in shard},
                  path / f"model-{k + 1:05d}-of-{n_shards:05d}.safetensors",
                  metadata={"format": "pt"})


# ----------------------- checkpoints (the port's own) ----------------------

CHECKPOINT_FORMAT = "dynamo_tpu_torch.checkpoint"
CHECKPOINT_VERSION = 1
# leaves are packed into files of about this many bytes (never split)
CHECKPOINT_FILE_BYTES = 4 << 30
_CKPT_GLOB = "checkpoint-*.safetensors"
_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}

# stats of the most recent load_checkpoint call: leaves, files, bytes read
# (the rank's slices only), seconds, read rate, the resident set before the
# restore and its peak over it (sampled after each leaf)
last_restore_stats: Dict[str, Any] = {}


@dataclasses.dataclass(frozen=True)
class AbstractLeaf:
    """A parameter leaf without its data: full shape, dtype and, on a mesh
    of more than one rank, its spec (the counterpart of a
    ``jax.ShapeDtypeStruct`` carrying a ``NamedSharding``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Optional[Spec] = None


def _param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Full param-tree shapes matching ``model.init_params(cfg)``."""
    D, V = cfg.hidden_size, cfg.vocab_size
    shapes: Dict[str, Any] = {
        "embed": (V, D),
        "layers": _stacked_shapes(cfg),
        "final_norm": (D,),
    }
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def _mesh_specs(cfg: ModelConfig, mesh: Optional[Mesh],
                weight_dtype: str) -> Optional[Dict[str, Any]]:
    """The spec tree of ``mesh`` (``None`` off a mesh or on one rank)."""
    if mesh is None or all(n == 1 for n in mesh.shape.values()):
        return None
    return SpecLayout.of(mesh).param_specs(cfg, weight_dtype)


def abstract_params(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                    weight_dtype: str = "bf16") -> Params:
    """The param tree's structure with an :class:`AbstractLeaf` per leaf
    (full shape, dtype, and on a ``mesh`` of more than one rank its
    ``SpecLayout`` spec); allocates nothing. With a quantized
    ``weight_dtype`` the matmul leaves are ``{"q", "s"}`` sub-trees
    (storage payload + float32 scales)."""
    dt = torch_dtype(cfg)
    quantized = quant.is_quantized(weight_dtype)
    specs = _mesh_specs(cfg, mesh, weight_dtype)

    def leaf(name: str, shape: tuple, sp):
        if quantized and quant.is_weight_leaf(name):
            return {"q": AbstractLeaf(
                        tuple(shape), quant.storage_dtype(weight_dtype),
                        None if sp is None else sp["q"]),
                    "s": AbstractLeaf(
                        _scale_shape(tuple(shape)), torch.float32,
                        None if sp is None else sp["s"])}
        return AbstractLeaf(tuple(shape), dt, sp)

    tree: Params = {}
    for name, sub in _param_shapes(cfg).items():
        sp = None if specs is None else specs[name]
        if name == "layers":
            tree[name] = {k: leaf(k, shape, None if sp is None else sp[k])
                          for k, shape in sub.items()}
        else:
            tree[name] = leaf(name, sub, sp)
    return tree


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` of a nested dict, paths ``"layers/wq/q"``,
    sorted by path."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out.extend(_flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(items) -> Params:
    tree: Params = {}
    for path, leaf in items:
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def save_checkpoint(path, params: Params,
                    cfg: Optional[ModelConfig] = None) -> None:
    """Write ``params`` (any device; one leaf is staged on the host at a
    time) as a checkpoint directory: ``checkpoint-XXXXX-of-XXXXX.safetensors``
    files of about ``CHECKPOINT_FILE_BYTES`` each, the leaves under their
    tree paths (``layers/wq/q``), fp8 as ``F8_E4M3``, MoE stacks whole.
    Each file's ``__metadata__`` holds the manifest: the format's name and
    version, the path, dtype, shape and file of every leaf, and ``cfg``'s
    fields (null without it). The same tree always gives the same bytes.
    Files of an earlier checkpoint in ``path`` are replaced."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = _flatten(params)
    files: List[List[Tuple[str, torch.Tensor]]] = [[]]
    acc = 0
    for name, t in leaves:
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"checkpoint leaf {name}: dtype {t.dtype} is "
                             "not writable")
        n = t.numel() * t.element_size()
        if files[-1] and acc + n > CHECKPOINT_FILE_BYTES:
            files.append([])
            acc = 0
        files[-1].append((name, t))
        acc += n
    names = [f"checkpoint-{k + 1:05d}-of-{len(files):05d}.safetensors"
             for k in range(len(files))]
    manifest = {
        "format": CHECKPOINT_FORMAT,
        "version": CHECKPOINT_VERSION,
        "config": None if cfg is None else dataclasses.asdict(cfg),
        "leaves": [{"path": name, "dtype": _DTYPE_NAMES[t.dtype],
                    "shape": list(t.shape), "file": names[k]}
                   for k, group in enumerate(files) for name, t in group],
    }
    meta = {"format": CHECKPOINT_FORMAT,
            "version": str(CHECKPOINT_VERSION),
            "manifest": json.dumps(manifest, sort_keys=True,
                                   separators=(",", ":"))}
    for old in path.glob(_CKPT_GLOB):
        old.unlink()
    for fname, group in zip(names, files):
        save_file(dict(group), path / fname, metadata=meta)


def read_manifest(path) -> Dict[str, Any]:
    """The manifest of the checkpoint directory ``path``."""
    files = sorted(Path(path).glob(_CKPT_GLOB))
    if not files:
        raise FileNotFoundError(f"no {_CKPT_GLOB} under {path}")
    with SafeFile(files[0]) as sf:
        return _check_manifest(files[0], sf.metadata())


def _check_manifest(fname, meta) -> Dict[str, Any]:
    if not meta or meta.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{fname}: not a {CHECKPOINT_FORMAT} file")
    if meta.get("version") != str(CHECKPOINT_VERSION):
        raise ValueError(f"{fname}: format version {meta.get('version')}, "
                         f"this reader takes {CHECKPOINT_VERSION}")
    return json.loads(meta["manifest"])


def _saved_weight_dtype(leaves) -> str:
    """The ``weight_dtype`` a saved tree was quantized to ("bf16" for
    none), from the dtype of its ``q`` leaves."""
    for e in leaves:
        if e["path"].endswith("/q"):
            return "fp8" if e["dtype"] == "F8_E4M3" else "int8"
    return "bf16"


def load_checkpoint(path, target: Optional[Params] = None,
                    cfg: Optional[ModelConfig] = None,
                    mesh: Optional[Mesh] = None, device=None) -> Params:
    """Restore a checkpoint written by :func:`save_checkpoint` onto
    ``device`` (``cuda`` unless asked for the CPU), one leaf at a time,
    read with ``pread`` (nothing is mapped); onto the card through one
    pinned host buffer the size of the largest leaf (or slice).

    With no other argument the tree comes back as saved. With ``target``
    (a tree of :class:`AbstractLeaf` or tensors of the full shapes) the
    tree's structure, every leaf's shape and its dtype are checked
    against it first, and a mismatch raises naming the leaf. With ``cfg``
    the saved config must equal it and the target is
    :func:`abstract_params` of ``cfg`` (and ``mesh``) when none is given.
    With a ``mesh`` (``parallel/layout.Mesh``, ``(dp, tp)`` or ``(dp,
    fsdp, tp)``) each leaf comes back as this rank's slice, by the specs
    of ``target`` or, without them, of ``SpecLayout`` (the slicing of
    ``model.shard_params`` and the sharded HF loader): only that slice's
    bytes are read, one ``pread`` per contiguous run, so no rank ever
    holds the full tree."""
    t0 = time.perf_counter()
    files = sorted(Path(path).glob(_CKPT_GLOB))
    if not files:
        raise FileNotFoundError(f"no {_CKPT_GLOB} under {path}")
    device = resolve_device(device)
    rss = [_rss_bytes()]
    nbytes = 0
    with contextlib.ExitStack() as stack:
        sfs = {f.name: stack.enter_context(SafeFile(f)) for f in files}
        manifest = _check_manifest(files[0], sfs[files[0].name].metadata())
        saved = manifest["leaves"]
        wd = _saved_weight_dtype(saved)
        if cfg is not None and manifest["config"] is not None:
            fields = dataclasses.asdict(cfg)
            diff = sorted(k for k in set(fields) | set(manifest["config"])
                          if fields.get(k) != manifest["config"].get(k))
            if diff:
                raise ValueError(
                    f"{path}: saved config differs from cfg in {diff}")
        if target is None and cfg is not None:
            target = abstract_params(cfg, mesh, wd)
        want = None if target is None else dict(_flatten(target))
        if want is not None:
            _check_target(path, saved, want)
        spec_of: Dict[str, Any] = {}
        if want is not None and any(getattr(a, "spec", None) is not None
                                    for a in want.values()):
            spec_of = {p: a.spec for p, a in want.items()}
        elif mesh is not None:
            # the target carries no specs: the layout's, by leaf path
            if cfg is None:
                if manifest["config"] is None:
                    raise ValueError(
                        f"{path}: a sharded restore needs cfg (the "
                        "checkpoint was saved without one)")
                cfg = ModelConfig(**manifest["config"])
            spec_of = dict(_flatten(_mesh_specs(cfg, mesh, wd) or {}))
        blocks = []
        for e in saved:
            shape, dt = tuple(e["shape"]), DTYPES.get(e["dtype"])
            if dt is None:
                raise ValueError(f"{path}: checkpoint leaf {e['path']}: "
                                 f"dtype {e['dtype']} not readable")
            sp = spec_of.get(e["path"]) if mesh is not None else None
            idx = (shard_index(shape, sp, mesh) if sp is not None
                   else tuple(slice(0, n) for n in shape))
            blocks.append((e, dt, idx))
        # onto the card through one pinned host buffer of the largest slice
        stage = None
        if device.type == "cuda":
            stage = torch.empty(max((_numel(idx) * dt.itemsize
                                     for _, dt, idx in blocks), default=0),
                                dtype=torch.uint8, pin_memory=True)
        out = []
        for e, dt, idx in blocks:
            shape = tuple(s.stop - s.start for s in idx)
            n = _numel(idx) * dt.itemsize
            nbytes += n
            leaf = torch.empty(shape, dtype=dt, device=device)
            host = leaf if stage is None else stage[:n].view(dt).view(shape)
            if n:
                _read_block(sfs[e["file"]], e["path"], e["shape"], idx,
                            dt.itemsize, host.reshape(-1).view(torch.uint8)
                            .numpy())
            if stage is not None and n:
                leaf.copy_(host, non_blocking=True)
                torch.cuda.current_stream(device).synchronize()
            out.append((e["path"], leaf))
            rss.append(_rss_bytes())
        stage = None
    secs = time.perf_counter() - t0
    peak = None if None in rss else max(rss)
    last_restore_stats.clear()
    last_restore_stats.update(
        n_leaves=len(out), n_files=len(files), bytes=nbytes, seconds=secs,
        gb_s=nbytes / max(secs, 1e-9) / 1e9, rss_before_bytes=rss[0],
        peak_rss_bytes=peak,
        mesh=None if mesh is None else (dict(mesh.shape),
                                        dict(mesh.coords)))
    log.info("restored %d leaves (%.3f GB read) from %s (%d files%s) onto "
             "%s in %.2f s: %.2f GB/s, peak host RSS %s", len(out),
             nbytes / 1e9, path, len(files),
             "" if mesh is None else f", rank at {dict(mesh.coords)} of "
             f"{dict(mesh.shape)}", device, secs,
             last_restore_stats["gb_s"],
             "not measured" if peak is None else
             f"{peak / 2**30:.2f} GiB ({rss[0] / 2**30:.2f} GiB before)")
    return _unflatten(out)


def _numel(idx) -> int:
    n = 1
    for s in idx:
        n *= s.stop - s.start
    return n


# a block of large runs is read in pieces of at most _READ_PIECE bytes by
# _READ_THREADS threads at once (pread releases the GIL); runs under
# _THREADED_RUN bytes on average (a tp slice of a column leaf: one run of
# a few KB per row) are read on one thread, which was faster on the card's
# host (2.7 s against 8.6 s for a 1B rank's slices)
_READ_THREADS = 8
_READ_PIECE = 16 << 20
_THREADED_RUN = 1 << 20


def _block_runs(shape, idx, itemsize: int) -> List[Tuple[int, int]]:
    """``(byte offset in the tensor, length)`` of each contiguous run of
    the block ``idx`` (a slice per dim) of a C-ordered tensor of
    ``shape``, in the block's C order."""
    if not shape:
        return [(0, itemsize)]
    strides = [itemsize] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    # the innermost dim from which on the block is one run: the dims after
    # it are taken whole
    d0 = len(shape) - 1
    while d0 > 0 and idx[d0].start == 0 and idx[d0].stop == shape[d0]:
        d0 -= 1
    run = (idx[d0].stop - idx[d0].start) * strides[d0]
    offsets = [idx[d0].start * strides[d0]]
    for d in range(d0 - 1, -1, -1):
        offsets = [i * strides[d] + o
                   for i in range(idx[d].start, idx[d].stop)
                   for o in offsets]
    return [(o, run) for o in offsets]


def _read_block(sf: SafeFile, name: str, shape, idx, itemsize: int,
                out) -> None:
    """Read the block ``idx`` of the tensor ``name`` of ``shape`` into
    ``out`` (its bytes, C order): one ``pread`` per contiguous run, so
    exactly the block's bytes are read and nothing of the file is mapped;
    large runs are read by several threads."""
    runs = [(o + k, min(_READ_PIECE, n - k))
            for o, n in _block_runs(shape, idx, itemsize)
            for k in range(0, n, _READ_PIECE)]
    pos = [0]
    for _, n in runs:
        pos.append(pos[-1] + n)

    def read(lo: int, hi: int) -> None:
        for k in range(lo, hi):
            sf.read_into(name, out[pos[k]:pos[k + 1]], runs[k][0])

    if len(runs) < 2 or pos[-1] < len(runs) * _THREADED_RUN:
        read(0, len(runs))
        return
    step = -(-len(runs) // _READ_THREADS)
    with ThreadPoolExecutor(_READ_THREADS) as pool:
        list(pool.map(lambda lo: read(lo, min(lo + step, len(runs))),
                      range(0, len(runs), step)))


def _check_target(path, saved, want: Dict[str, Any]) -> None:
    """Raise, naming the leaf, where the saved tree and ``want`` (path ->
    leaf of the full shape) differ in structure, shape or dtype."""
    have = {e["path"]: e for e in saved}
    for name in sorted(set(have) | set(want)):
        if name not in want:
            raise ValueError(f"{path}: checkpoint leaf {name} is not in "
                             "the target")
        if name not in have:
            raise ValueError(f"{path}: target leaf {name} is not in the "
                             "checkpoint")
        e, a = have[name], want[name]
        shape, dtype = tuple(e["shape"]), DTYPES.get(e["dtype"])
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(
                f"{path}: checkpoint leaf {name} is {e['dtype']} {list(shape)}"
                f", the target's is {a.dtype} {list(a.shape)}")


# ------------------------- parameters from numpy --------------------------


def _leaf(arr: np.ndarray, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    a = np.array(arr, copy=True, order="C")  # owned, writable, contiguous
    if a.dtype == np.uint16:
        if dtype != torch.bfloat16:
            raise TypeError("uint16 leaves carry bf16 bits; the model "
                            f"dtype is {dtype}")
        t = torch.from_numpy(a).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _quant_leaf(leaf: Dict[str, np.ndarray], weight_dtype: str,
                device: torch.device) -> Dict[str, torch.Tensor]:
    if not quant.is_quantized(weight_dtype):
        raise TypeError("a quantized {q, s} leaf needs weight_dtype int8 "
                        f"or fp8, not {weight_dtype!r}")
    q = np.array(leaf["q"], copy=True, order="C")
    want = np.int8 if weight_dtype == "int8" else np.uint8
    if q.dtype != want:
        raise TypeError(f"{weight_dtype} leaf q arrives as {np.dtype(want)}"
                        f" (fp8 as uint8 bits), got {q.dtype}")
    t = torch.from_numpy(q)
    if weight_dtype == "fp8":
        t = t.view(quant.storage_dtype("fp8"))
    s = torch.from_numpy(np.array(leaf["s"], np.float32, copy=True))
    return {"q": t.to(device), "s": s.to(device)}


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device,
                      weight_dtype: str = "bf16") -> Params:
    """The JAX parameter tree (numpy leaves) as this package's params;
    ``{"q", "s"}`` leaves of a tree quantized to ``weight_dtype`` stay
    quantized."""
    dt = torch_dtype(cfg)
    device = torch.device(device)

    def leaf(x):
        if isinstance(x, dict):
            return _quant_leaf(x, weight_dtype, device)
        return _leaf(x, dt, device)

    layers = tree["layers"]
    keys = tuple(_stacked_shapes(cfg))
    missing = [k for k in keys if k not in layers]
    if missing:
        raise KeyError(f"layer leaves missing from the tree: {missing}")
    params: Params = {
        "embed": leaf(tree["embed"]),
        "layers": {k: leaf(layers[k]) for k in keys},
        "final_norm": leaf(tree["final_norm"]),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = leaf(tree["lm_head"])
    return params
