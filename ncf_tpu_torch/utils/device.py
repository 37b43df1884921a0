"""Device selection for the port's entry points.

Entry points default to the card.  Without CUDA they raise instead of
carrying on on the CPU: a run that silently fell back would report CPU
numbers as device results.  Tests ask for ``"cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """Config dtype name (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    if name is None:
        return None
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
