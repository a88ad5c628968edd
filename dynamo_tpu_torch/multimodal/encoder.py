"""Vision encoder: image → prompt embeddings (the E of encode-prefill-decode).

Port of ``dynamo_tpu.multimodal.encoder``: a compact ViT-style patchifier
(conv-as-matmul patch embedding, a few pre-norm attention/MLP blocks, a
projection to the language model's hidden size) in plain PyTorch, f32, with
an explicit device and an explicit ``torch.Generator`` for its weights. The
JAX function's numerics are kept: the tanh GELU (``jax.nn.gelu``'s default)
and the population variance in the layer norm.

On a card the encoder launches on a CUDA stream of its own, never on the
legacy default stream, so an encode on the encode handler's thread never
joins the engine's stream nor a decode graph being captured on another
thread. The encode worker serves it behind an ``encode`` endpoint
(:class:`EncodeHandler`); embeddings travel as raw binary arrays
(``array_to_wire``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import math
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..observability.profiling import LAUNCH_GATE
from ..runtime.context import Context
from ..runtime.engine import AsyncEngine
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from .wire import array_from_wire, array_to_wire

log = get_logger("mm.encoder")

__all__ = [
    "EncodeHandler", "VisionEncoder", "VisionEncoderConfig",
    "array_from_wire", "array_to_wire", "encode_image",
    "init_vision_params", "vision_params_from_numpy",
]


# ------------------------------ the model ---------------------------------


@dataclass(frozen=True)
class VisionEncoderConfig:
    image_size: int = 32          # square inputs (resized by the processor)
    patch_size: int = 8
    channels: int = 3
    width: int = 64               # encoder hidden size
    num_layers: int = 2
    num_heads: int = 4
    model_dim: int = 64           # language model hidden size (projection)

    def __post_init__(self):
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}"
            )
        if self.width % self.num_heads != 0:
            raise ValueError(
                f"width {self.width} not divisible by num_heads "
                f"{self.num_heads}"
            )

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def tokens_per_image(self) -> int:
        return self.num_patches

    @staticmethod
    def tiny(model_dim: int = 64) -> "VisionEncoderConfig":
        return VisionEncoderConfig(model_dim=model_dim)


def init_vision_params(generator: torch.Generator,
                       cfg: VisionEncoderConfig) -> Dict[str, Any]:
    """Random f32 weights on the generator's device, in the JAX tree's
    layout (stacked ``[L, …]`` layer leaves). The draws differ from
    ``jax.random``'s for the same seed; :func:`vision_params_from_numpy`
    carries a JAX tree across."""
    dev = generator.device
    p = cfg.patch_size
    in_dim = p * p * cfg.channels
    W, F_, L = cfg.width, cfg.width * 4, cfg.num_layers

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x / math.sqrt(fan_in)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=torch.float32)

    return {
        "patch": norm((in_dim, W), in_dim),
        "pos": norm((cfg.num_patches, W), W),
        "layers": {
            "ln1": ones((L, W)),
            "wqkv": norm((L, W, 3 * W), W),
            "wo": norm((L, W, W), W),
            "ln2": ones((L, W)),
            "w1": norm((L, W, F_), W),
            "w2": norm((L, F_, W), F_),
        },
        "ln_f": ones((W,)),
        "proj": norm((W, cfg.model_dim), W),
    }


def vision_params_from_numpy(tree: Dict[str, Any],
                             device) -> Dict[str, Any]:
    """The JAX encoder's parameter tree (numpy leaves) as f32 tensors on
    ``device``."""
    device = torch.device(device)

    def leaf(x):
        return torch.from_numpy(np.array(x, np.float32, copy=True)).to(
            device)

    return {
        "patch": leaf(tree["patch"]),
        "pos": leaf(tree["pos"]),
        "layers": {k: leaf(v) for k, v in tree["layers"].items()},
        "ln_f": leaf(tree["ln_f"]),
        "proj": leaf(tree["proj"]),
    }


def _ln(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    return (x - mu) * torch.rsqrt(var + 1e-5) * w


def encode_image(cfg: VisionEncoderConfig, params: Dict[str, Any],
                 image: torch.Tensor) -> torch.Tensor:
    """[H, W, C] float32 in [0, 1] → [num_patches, model_dim]."""
    p = cfg.patch_size
    n = cfg.image_size // p
    H = cfg.num_heads
    hd = cfg.width // H
    # patchify: conv-as-matmul, [N, p*p*C] @ [p*p*C, W]
    x = image.reshape(n, p, n, p, cfg.channels)
    x = x.permute(0, 2, 1, 3, 4).reshape(n * n, p * p * cfg.channels)
    h = x @ params["patch"] + params["pos"]              # [N, W]

    stacked = params["layers"]
    for li in range(cfg.num_layers):
        lp = {k: v[li] for k, v in stacked.items()}
        x = _ln(h, lp["ln1"])
        qkv = (x @ lp["wqkv"]).reshape(-1, 3, H, hd)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]        # [N, H, hd]
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("hqk,khd->qhd", a, v).reshape(-1, cfg.width)
        h = h + o @ lp["wo"]
        x = _ln(h, lp["ln2"])
        # jax.nn.gelu defaults to the tanh approximation
        h = h + F.gelu(x @ lp["w1"], approximate="tanh") @ lp["w2"]
    h = _ln(h, params["ln_f"])
    return h @ params["proj"]                            # [N, model_dim]


class VisionEncoder:
    """The encoder on ``device`` (``cuda`` unless asked for the CPU) with
    deterministic weights from a seed (or ``params``, e.g. a JAX tree
    carried across by :func:`vision_params_from_numpy`); the language
    worker derives the same placeholder count from the config."""

    def __init__(self, config: VisionEncoderConfig, seed: int = 0,
                 device=None, params: Optional[Dict[str, Any]] = None):
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_vision_params(gen, config)
        self.params = params
        self._stream = None
        if self.device.type == "cuda":
            # the encoder's own stream, after the weights' writes
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self.num_encoded = 0

    def encode(self, image: np.ndarray) -> np.ndarray:
        """[H, W, C] (any float/int dtype; resized here when its shape is
        not the config's) → [tokens_per_image, model_dim] float32."""
        cfg = self.config
        # dtype decides normalisation — a value heuristic would leave a
        # near-black uint8 image unscaled and encode it inconsistently
        is_int = np.issubdtype(np.asarray(image).dtype, np.integer)
        img = np.asarray(image, np.float32)
        if is_int:
            img = img / 255.0
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], cfg.channels, axis=2)
        if img.shape != (cfg.image_size, cfg.image_size, cfg.channels):
            img = _resize_nearest(
                img, cfg.image_size, cfg.image_size, cfg.channels
            )
        x = torch.from_numpy(np.ascontiguousarray(img))
        on_stream = (torch.cuda.stream(self._stream)
                     if self._stream is not None else contextlib.nullcontext())
        with LAUNCH_GATE.launching(), torch.inference_mode(), on_stream:
            # the copy to the host waits on the encoder's stream only
            out = encode_image(cfg, self.params, x.to(self.device)).cpu()
        self.num_encoded += 1
        return out.numpy()


def _resize_nearest(img: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] / h).astype(int)
    xs = (np.arange(w) * img.shape[1] / w).astype(int)
    out = img[ys][:, xs]
    if out.shape[2] > c:
        out = out[:, :, :c]
    elif out.shape[2] < c:
        out = np.repeat(out[:, :, :1], c, axis=2)
    return out


class EncodeHandler(AsyncEngine):
    """The encode worker's wire endpoint: images in, embeddings out
    (served as ``encode`` next to the language worker's ``generate``).

    Encoding blocks on the device, so it runs on a dedicated executor
    thread: a colocated language worker's event loop keeps pumping token
    streams while images encode."""

    def __init__(self, encoder: VisionEncoder):
        self.encoder = encoder
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mm-encode"
        )

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[dict]:
        loop = asyncio.get_running_loop()
        embeddings = []
        for img_wire in request.get("images", []):
            out = await loop.run_in_executor(
                self._executor, self.encoder.encode,
                array_from_wire(img_wire),
            )
            embeddings.append(array_to_wire(out))
        yield {
            "embeddings": embeddings,
            "tokens_per_image": self.encoder.config.tokens_per_image,
        }

    def close(self) -> None:
        self._executor.shutdown(wait=False)
