"""Attention functionals (``paddle_tpu.nn.functional.attention``).

``scaled_dot_product_attention`` routes by shape, as the reference does:
long sequences without a mask go to flash attention
(``ops.flash_attention``: the hand-written kernels on a CUDA tensor, their
plain versions on a CPU tensor), everything else to the reference's plain
composition, :func:`_sdpa_reference`. The routing predicate is the
reference's ``would_use_pallas`` without its backend test: the device,
not the predicate, picks kernel or plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import amp
from ...core import random as rng
from ...ops.flash_attention import flash_attention, supports

__all__ = ["scaled_dot_product_attention", "would_use_flash"]


def would_use_flash(seq_q: int, seq_k: int, head_dim: int,
                    causal: bool = False, has_mask: bool = False) -> bool:
    """The routing predicate: no mask, ``seq_q >= 256`` and the flash
    shape gate (``ops.flash_attention.supports``)."""
    if has_mask:
        return False
    return seq_q >= 256 and supports(seq_q, seq_k, head_dim, causal=causal)


def _sdpa_reference(q, k, v, mask, dropout_p: float, is_causal: bool,
                    scale: Optional[float], training: bool):
    """The reference's composition on ``[B, S, H, D]``: scores in the
    input dtype, masked positions at -1e9 (the kernels use -inf), softmax
    in fp32 cast back to the input dtype."""
    s = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * s
    neg = torch.tensor(-1e9, dtype=logits.dtype, device=logits.device)
    if is_causal:
        sq, sk = logits.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=logits.device).tril(sk - sq)
        logits = torch.where(keep, logits, neg)
    if mask is not None:
        logits = (torch.where(mask, logits, neg) if mask.dtype == torch.bool
                  else logits + mask)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        keep = torch.rand(probs.shape, device=probs.device,
                          generator=rng.generator(probs.device)) \
            >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.matmul(probs, vh).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None):
    """Attention on paddle-layout ``[batch, seq, heads, head_dim]``."""
    eff_dropout = dropout_p if training else 0.0
    if would_use_flash(query.shape[1], key.shape[1], query.shape[-1],
                       causal=is_causal, has_mask=attn_mask is not None):
        q, k, v = amp.cast("flash_attention", query, key, value)
        seed = rng.next_seed(q.device) if eff_dropout > 0.0 else None
        return flash_attention(q, k, v, causal=is_causal, scale=scale,
                               dropout=eff_dropout, seed=seed)
    q, k, v, m = amp.cast("sdpa", query, key, value, attn_mask)
    return _sdpa_reference(q, k, v, m, dropout_p, is_causal, scale,
                           training)
