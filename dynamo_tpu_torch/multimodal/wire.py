"""Binary arrays on the wire: ``{"d": bytes, "t": dtype str, "s": shape}``.

The JAX package's ``array_to_wire`` / ``array_from_wire``
(``dynamo_tpu.multimodal.encoder``), in a module of their own that imports
numpy only: the frontend's multimodal preprocessor and the engine's wire
adapter use them, and the frontend never loads torch.
"""

from __future__ import annotations

import numpy as np


def array_to_wire(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"d": a.tobytes(), "t": a.dtype.str, "s": list(a.shape)}


def array_from_wire(m: dict) -> np.ndarray:
    return np.frombuffer(m["d"], np.dtype(m["t"])).reshape(m["s"]).copy()
