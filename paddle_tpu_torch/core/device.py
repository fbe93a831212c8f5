"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "canonical_device", "same_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and no card is
    visible — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


def canonical_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with a CUDA index filled in: ``"cuda"`` means the
    current card, ``torch.cuda.current_device()``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: Union[str, torch.device],
                b: Union[str, torch.device]) -> bool:
    """Whether ``a`` and ``b`` name one device (``"cuda"`` and
    ``"cuda:0"`` do when card 0 is current)."""
    return canonical_device(a) == canonical_device(b)
