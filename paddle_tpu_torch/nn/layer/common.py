"""Layers (``paddle_tpu.nn.layer.common``): Linear, Embedding, Dropout.

Parameters keep the reference's layouts and default initialisers, so
weights carry over between the two packages unchanged: ``Linear.weight``
is ``[in, out]`` (not ``torch.nn.Linear``'s ``[out, in]``) with Xavier
uniform over (in, out) and a zero bias; ``Embedding.weight`` is ``[V, E]``
with Xavier normal. Initial values come from the port's generator of the
device, so they differ from the JAX package's draws. ``device=None`` means
the current card (``core.device.resolve_device``): without one the layers
raise; pass ``device="cpu"`` to build them on the CPU.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core import random as rng
from ...core.device import resolve_device
from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        device = resolve_device(device)
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features, device=device)
        w.uniform_(-limit, limit, generator=rng.generator(w.device))
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        std = math.sqrt(2.0 / (num_embeddings + embedding_dim))
        w = torch.empty(num_embeddings, embedding_dim, device=device)
        w.normal_(0.0, std, generator=rng.generator(w.device))
        self.weight = nn.Parameter(w)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Dropout(nn.Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)
