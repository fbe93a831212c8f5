"""Common functionals: linear, embedding, dropout and the residual add
(the counterparts of ``paddle_tpu.nn.functional.common`` and of the
elementwise ``add``). Each applies the AMP cast rule under its reference
op name."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import amp
from ...core import random as rng

__all__ = ["linear", "embedding", "dropout", "add"]


def linear(x, weight, bias=None):
    """``x @ W + b`` with the paddle weight layout ``[in, out]``."""
    x, weight, bias = amp.cast("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(ids, weight):
    """Rows of ``weight [V, E]`` (dense gradient)."""
    (weight,) = amp.cast("embedding", weight)
    return F.embedding(ids, weight)


def dropout(x, p: float = 0.5, training: bool = True):
    """Upscale-in-train dropout. The mask comes from the port's generator
    of ``x``'s device, so its bits differ from the JAX package's."""
    if not training or p == 0:
        return x
    (x,) = amp.cast("dropout", x)
    if p == 1:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=rng.generator(x.device),
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def add(x, y):
    """The elementwise add (residual connections) under the AMP rule:
    under O2 an fp32 operand is cast down, as the reference's ``add``."""
    x, y = amp.cast("add", x, y)
    return x + y
