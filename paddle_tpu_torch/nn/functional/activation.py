"""Activations (``paddle_tpu.nn.functional.activation``)."""
from __future__ import annotations

import torch.nn.functional as F

from ... import amp

__all__ = ["gelu"]


def gelu(x, approximate: bool = False):
    """GELU; exact (erf) unless ``approximate``, as ``jax.nn.gelu`` with
    the reference's default. The training GPT uses the exact form; the
    serving model's tanh GELU is its own."""
    (x,) = amp.cast("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")
