"""Losses (``paddle_tpu.nn.functional.loss``).

``cross_entropy`` routes as the reference does: hard labels over the
last axis of a vocabulary of at least 2048, with no class weights and no
label smoothing, go to the fused softmax cross-entropy
(``ops.softmax_xent``: the hand-written kernels on a CUDA tensor, their
plain versions on a CPU tensor); everything else to the plain route,
log-softmax, the label's log-probability picked per row, ``ignore_index``
rows 0, the mean over the valid rows (``loss.py:84-117`` of the
reference). The routing predicate is the reference's
``would_use_fused_xent`` with ``FLAGS_use_pallas_softmax_xent`` at its
default (on) and without its backend test: the device, not the
predicate, picks kernel or plain version.
"""
from __future__ import annotations

import torch

from ... import amp
from ...ops.softmax_xent import fused_softmax_cross_entropy, supports

__all__ = ["cross_entropy", "would_use_fused_xent"]


def would_use_fused_xent(n_classes: int, soft_label: bool, axis: int,
                         use_softmax: bool, label_smoothing: float,
                         has_weight: bool) -> bool:
    """The routing predicate: hard labels over axis -1 with softmax, no
    class weights, no label smoothing, and ``n_classes >= 2048`` within
    the kernels' gate (``ops.softmax_xent.supports``)."""
    if soft_label or has_weight or label_smoothing > 0 or not use_softmax:
        return False
    if axis != -1:
        return False
    return n_classes >= 2048 and supports(n_classes)


def _reduce(loss, valid, reduction: str):
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    return loss.sum() if reduction == "sum" else loss


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0):
    """Softmax cross-entropy with hard labels over the last axis.
    ``weight``, ``soft_label``, ``use_softmax=False`` and another ``axis``
    are not ported and raise."""
    if weight is not None or soft_label or not use_softmax \
            or axis not in (-1, input.dim() - 1):
        raise NotImplementedError(
            "cross_entropy: only hard labels over the last axis with "
            "softmax and no class weights are ported")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean|sum|none, got "
                         f"{reduction!r}")
    lab = label.long()
    if lab.dim() == input.dim():
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    v = input.shape[-1]
    if would_use_fused_xent(v, soft_label, axis, use_softmax,
                            label_smoothing, weight is not None):
        (logits,) = amp.cast("fused_softmax_xent", input)
        loss = fused_softmax_cross_entropy(
            logits.reshape(-1, v), lab.reshape(-1), ignore_index)
        # the reference hands the loss back in the logits' dtype
        return _reduce(loss.reshape(lab.shape).to(logits.dtype), valid,
                       reduction)
    (input,) = amp.cast("cross_entropy", input)
    logp = torch.log_softmax(input, dim=-1)
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = -picked
    if label_smoothing > 0:
        loss = (1 - label_smoothing) * loss \
            - label_smoothing * logp.mean(dim=-1)
    return _reduce(torch.where(valid, loss, torch.zeros_like(loss)), valid,
                   reduction)
