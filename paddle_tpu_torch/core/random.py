"""Random state of the port (the counterpart of ``paddle_tpu.core.random``).

``seed(s)`` fixes the global seed. Every device then draws from its own
explicit ``torch.Generator``, seeded from ``s`` the first time that device
asks, so parameter initialisation is reproducible on the CPU and on the
card alike. The flash-attention dropout seeds of a device come from a
second generator of its own that lives on the host, seeded from ``s`` as
well: drawing one reads nothing back from the card, so a training step
with dropout makes no device-to-host sync. The JAX package splits
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
_SEED_GENERATORS: Dict[str, torch.Generator] = {}  # on the host, per device


def seed(s: int) -> None:
    """Set the global seed and reset every device's generators."""
    global _SEED
    _SEED = int(s)
    _GENERATORS.clear()
    _SEED_GENERATORS.clear()


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
    """A fresh int32 seed in ``[0, 2**31 - 1)`` for ``device`` (the
    flash-attention dropout seed of a step), drawn on the host from the
    device's seed generator: no tensor is made on the device and nothing
    is read back from it. ``device`` defaults to the current card, as in
    :func:`generator`; a device named explicitly needs no card."""
    dev = canonical_device(resolve_device(device) if device is None
                           else device)
    gen = _SEED_GENERATORS.get(str(dev))
    if gen is None:
        gen = _SEED_GENERATORS[str(dev)] = torch.Generator().manual_seed(
            _SEED)
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))
