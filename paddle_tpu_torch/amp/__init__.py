"""Automatic mixed precision: the JAX package's op-level cast rule.

The reference casts at op dispatch (``paddle_tpu/ops/_dispatch.py``
``_amp_cast``, lists in ``paddle_tpu/core/amp_state.py``): under O2 every
op that is not on the black list runs with its fp32 inputs cast to the low
dtype, and black-list ops (LayerNorm, cross-entropy, softmax, the
reductions) run with low-precision inputs cast back to fp32. O1 (only
white-list ops cast down) is not ported. Parameters stay fp32 masters:
the casts happen on the way into each op, so gradients reach the fp32
parameters through them.

``torch.autocast`` is a different rule (it keeps residual adds and
elementwise ops in fp32, for one), so the port's layers call :func:`cast`
explicitly with the reference's op name instead.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["auto_cast", "cast", "is_enabled", "BLACK_LIST"]

BLACK_LIST = frozenset({
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "cross_entropy",
    "fused_softmax_xent", "softmax_with_cross_entropy", "mean", "sum",
    "norm", "cumsum", "logsumexp", "softmax", "log_softmax", "layer_norm",
    "batch_norm", "rms_norm",
})

_LEVEL: Optional[str] = None  # None = off, or "O2"
_DTYPE = torch.bfloat16


def is_enabled() -> bool:
    return _LEVEL is not None


@contextlib.contextmanager
def auto_cast(level: Optional[str] = "O2", dtype=torch.bfloat16):
    """Run the enclosed ops under the reference's AMP rule (``level`` None
    turns it off)."""
    global _LEVEL, _DTYPE
    if level not in (None, "O2"):
        raise ValueError(f"amp level must be None or O2, got {level!r}")
    prev = (_LEVEL, _DTYPE)
    _LEVEL, _DTYPE = level, dtype
    try:
        yield
    finally:
        _LEVEL, _DTYPE = prev


def cast(op_name: str, *tensors):
    """``tensors`` as op ``op_name`` receives them under the current AMP
    state (``None`` entries pass through)."""
    if _LEVEL is None:
        return tensors
    low = _DTYPE
    in_black = op_name in BLACK_LIST
    out = []
    for t in tensors:
        if t is not None:
            if not in_black and t.dtype == torch.float32:
                t = t.to(low)
            elif in_black and t.dtype == low:
                t = t.float()
        out.append(t)
    return tuple(out)
