"""Device selection for the package's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the one asked for, else ``cuda``.

    With no device given and no GPU present this raises: the package never
    carries on quietly on the CPU. Tests and CPU runs pass ``"cpu"``.
    """
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is not "
                               "available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' (or --device cpu) "
            "to run on the CPU"
        )
    return torch.device("cuda")
