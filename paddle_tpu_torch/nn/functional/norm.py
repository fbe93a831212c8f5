"""Normalisation functionals (``paddle_tpu.nn.functional.norm``)."""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["layer_norm"]


def layer_norm(x, weight=None, bias=None, epsilon: float = 1e-5):
    """LayerNorm over the last axis, written out as the reference writes
    it: mean and (biased) variance in the input dtype, then
    ``(x - mean) / sqrt(var + eps) * w + b``. On the black list: under
    AMP a low-precision input is cast to fp32 first."""
    x, weight, bias = amp.cast("layer_norm", x, weight, bias)
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
