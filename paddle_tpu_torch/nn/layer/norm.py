"""Normalisation layers (``paddle_tpu.nn.layer.norm``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; weight 1, bias 0 at init."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(normalized_shape,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)
