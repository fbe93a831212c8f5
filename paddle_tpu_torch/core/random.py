"""Random state of the port (the counterpart of ``paddle_tpu.core.random``).

``seed(s)`` fixes the global seed. Every device then draws from its own
explicit ``torch.Generator``, seeded from ``s`` the first time that device
asks, so parameter initialisation and the flash-attention dropout seeds
are reproducible on the CPU and on the card alike. The JAX package splits
Threefry keys instead; the two give different numbers from one seed, so
parity tests hand both sides the same numpy-made values.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from .device import canonical_device, resolve_device

__all__ = ["seed", "generator", "next_seed"]

_SEED = 0
_GENERATORS: Dict[str, torch.Generator] = {}


def seed(s: int) -> None:
    """Set the global seed and reset every device's generator."""
    global _SEED
    _SEED = int(s)
    _GENERATORS.clear()


def generator(device: Optional[Union[str, torch.device]] = None
              ) -> torch.Generator:
    """The generator of ``device`` (the current card by default; raises
    without one), seeded from the global seed at first use."""
    dev = canonical_device(resolve_device(device))
    key = str(dev)
    gen = _GENERATORS.get(key)
    if gen is None:
        gen = _GENERATORS[key] = torch.Generator(device=dev).manual_seed(
            _SEED)
    return gen


def next_seed(device: Optional[Union[str, torch.device]] = None) -> int:
    """A fresh int32 seed in ``[0, 2**31 - 1)`` drawn from ``device``'s
    generator (the flash-attention dropout seed of a step); ``device``
    defaults to the current card, as in :func:`generator`."""
    gen = generator(device)
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             device=gen.device).item())
