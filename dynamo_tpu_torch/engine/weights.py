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
``load_hf_params_sharded`` waits for multi-device serving (ROADMAP.md queue
A, item 6), the orbax checkpoints for item 7.

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

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging import get_logger
from . import quant
from .config import ModelConfig
from .model import Params, torch_dtype
from .safetensors import SafeFile, save_file

log = get_logger("engine.weights")

# stats of the most recent load_hf_params call: tensors, files, bytes read,
# seconds, read rate, and the process's resident set before the load and
# its peak over the load (sampled after each tensor)
last_load_stats: Dict[str, Any] = {}


def _scale_shape(shape: tuple) -> tuple:
    """Per-output-channel scale shape for a weight of ``shape``: the
    contraction axis (-2) collapses to 1, ``keepdims`` style."""
    return shape[:-2] + (1,) + shape[-1:]


def _stacked_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    hd = cfg.head_dim_
    D, H, KV, F, L, E = (
        cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
        cfg.intermediate_size, cfg.num_layers, cfg.num_experts,
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
                   device=None) -> Params:
    """Load an HF-format checkpoint directory (``*.safetensors``) into the
    stacked param tree on ``device`` (``cuda`` unless asked for the CPU),
    cast to ``cfg.dtype``. With a quantized ``weight_dtype`` each matmul
    tensor is quantized as it arrives, so the leaves hold the 1-byte
    payload plus float32 scales and no full-precision copy of a quantized
    leaf ever exists."""
    t0 = time.perf_counter()
    path = Path(path)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    quantized = quant.is_quantized(weight_dtype)

    def _buf(name: str, shape: tuple):
        if quantized and quant.is_weight_leaf(name):
            return {"q": torch.zeros(shape, device=device,
                                     dtype=quant.storage_dtype(weight_dtype)),
                    "s": torch.zeros(_scale_shape(shape), device=device,
                                     dtype=torch.float32)}
        return torch.zeros(shape, device=device, dtype=dt)

    layers = {k: _buf(k, shape) for k, shape in _stacked_shapes(cfg).items()}
    top: Dict[str, Any] = {}
    seen = set()
    nbytes = 0
    rss = [_rss_bytes()]   # before, then after each tensor

    for f in files:
        with SafeFile(f) as sf:
            for name in sf.keys():
                dest = _dest(cfg, name)
                if dest is None:
                    continue
                leaf, i, e, transpose = dest
                t = sf.get_tensor(name).to(device, copy=True)
                nbytes += sf.nbytes(name)
                sf.release(name)
                if transpose:
                    t = t.T
                slot = (i,) if e is None else (i, e)
                if quantized and quant.is_weight_leaf(leaf):
                    qd = quant.quantize(t, weight_dtype)
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
        peak_rss_bytes=peak)
    log.info("loaded %d tensors (%.3f GB) from %s (%d files, "
             "weight_dtype=%s) onto %s in %.2f s: %.2f GB/s, peak host RSS "
             "%s", len(seen), nbytes / 1e9, path, len(files), weight_dtype,
             device, secs, last_load_stats["gb_s"],
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
