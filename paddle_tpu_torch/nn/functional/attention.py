"""Attention functionals (``paddle_tpu.nn.functional.attention``).

``scaled_dot_product_attention`` routes by shape, as the reference does:
long sequences without a mask go to flash attention
(``ops.flash_attention``: the hand-written kernels on a CUDA tensor, their
plain versions on a CPU tensor), everything else to the reference's plain
composition, :func:`_sdpa_reference`. The routing predicate is the
reference's ``would_use_pallas`` without its backend test: the device,
not the predicate, picks kernel or plain version.

``sparse_attention`` takes a CSR pattern, as the reference's op does. A
pattern that is the same for every (batch, head), aligned to 128-token
blocks and given without masks goes to block-sparse attention
(``ops.block_sparse_attention``); any other to the reference's dense
masked composition, :func:`_sa`. The routing predicate,
:func:`would_use_block_sparse`, is the reference's
``_try_block_sparse_route`` without its backend test.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import amp
from ...core import random as rng
from ...ops.block_sparse_attention import block_sparse_attention
from ...ops.flash_attention import flash_attention, supports

__all__ = ["scaled_dot_product_attention", "sparse_attention",
           "would_use_block_sparse", "would_use_flash"]


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


# ------------------------------------------------------ sparse attention

def _csr_to_block_mask(off_np, cols_np, t: int, blk: int):
    """Concrete uniform CSR pattern -> block mask [t//blk, t//blk], or None
    when the pattern is not expressible at block granularity."""
    cols_flat = cols_np.reshape(-1)
    if len(cols_flat) and (cols_flat.min() < 0 or cols_flat.max() >= t):
        return None  # out-of-range columns: dense path clips, kernel cannot
    el = np.zeros((t, t), bool)
    off_row = off_np.reshape(-1)
    for i in range(t):
        el[i, cols_flat[off_row[i]:off_row[i + 1]]] = True
    nb = t // blk
    blocks = el.reshape(nb, blk, nb, blk).any(axis=(1, 3))
    expanded = np.kron(blocks, np.ones((blk, blk), bool))
    if not (expanded == el).all():
        return None  # pattern ragged inside blocks: dense-masked path
    if not blocks.any(axis=1).all():
        return None  # empty row-block: kernel contract forbids it
    return blocks


# Route caches, as the reference keeps them: block masks by the pattern's
# bytes, and by the identity of the offset and column tensors. torch
# tensors are mutable, so the identity key also holds each tensor's
# version counter: a pattern written in place is analysed again.
_ROUTE_CACHE: dict = {}
_ROUTE_ID_CACHE: dict = {}


def _route_blocks(t: int, offset, columns):
    """The block mask a CSR pattern routes with, or None for the dense
    path. A repeated call with the same unmodified tensors copies
    nothing."""
    if t % 128:
        return None
    id_key = (id(offset), id(columns), offset._version, columns._version, t)
    entry = _ROUTE_ID_CACHE.get(id_key)
    if entry is not None and entry[0] is offset and entry[1] is columns:
        # the entry pins the tensors, so a matching `is` proves the id
        # was not recycled after a collection
        return entry[2]
    blocks = _analyse(t, offset, columns)
    if len(_ROUTE_ID_CACHE) > 16:
        _ROUTE_ID_CACHE.clear()
    _ROUTE_ID_CACHE[id_key] = (offset, columns, blocks)
    return blocks


def _analyse(t: int, offset, columns):
    """A pattern's block mask or None: the CSR tensors copied to the host,
    then the uniformity check and the O(T^2) densify, once per content."""
    off_np = offset.detach().cpu().numpy()
    cols_np = columns.detach().cpu().numpy()
    byte_key = (off_np.shape, cols_np.shape, t, off_np.tobytes(),
                cols_np.tobytes())
    if byte_key in _ROUTE_CACHE:
        return _ROUTE_CACHE[byte_key]
    if (off_np != off_np[0, 0]).any() or (cols_np != cols_np[0, 0]).any():
        blocks = None  # per-(batch, head) patterns: dense-masked path
    else:
        blocks = _csr_to_block_mask(off_np[0, 0], cols_np[0, 0], t, 128)
    if len(_ROUTE_CACHE) > 64:
        _ROUTE_CACHE.clear()
    _ROUTE_CACHE[byte_key] = blocks
    return blocks


def would_use_block_sparse(query, sparse_csr_offset, sparse_csr_columns,
                           key_padding_mask=None, attn_mask=None) -> bool:
    """The routing predicate of :func:`sparse_attention`: no masks, T a
    multiple of 128, and a pattern uniform over (batch, head) that is
    exactly a union of 128 x 128 blocks with no empty block row."""
    if key_padding_mask is not None or attn_mask is not None:
        return False
    return _route_blocks(int(query.shape[2]), sparse_csr_offset,
                         sparse_csr_columns) is not None


def _sa(q, k, v, off, cols, key_padding_mask=None, attn_mask=None):
    """The reference's dense masked composition on ``[B, H, T, D]``: the
    CSR pattern densified to a mask, scores divided by ``sqrt(d)`` in the
    input dtype, masked positions at ``finfo(dtype).min``, softmax, and
    ``p`` zeroed outside the pattern (rows with empty patterns give 0)."""
    b, h, t, d = q.shape
    nnz = cols.shape[-1]
    pos = torch.arange(nnz, device=q.device)
    offs = off.to(torch.int64)
    rows = torch.searchsorted(offs, pos.expand(b, h, nnz).contiguous(),
                              right=True) - 1
    valid = pos < offs[..., -1:]
    flat = ((torch.arange(b * h, device=q.device).view(b, h, 1) * t
             + rows.clamp(0, t - 1)) * t + cols.to(torch.int64).clamp(0, t - 1))
    mask = torch.zeros(b * h * t * t, dtype=torch.bool, device=q.device)
    mask[flat[valid]] = True
    mask = mask.view(b, h, t, t)
    scores = torch.einsum("bhid,bhjd->bhij", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    neg = torch.tensor(torch.finfo(q.dtype).min, dtype=q.dtype,
                       device=q.device)
    scores = torch.where(mask, scores, neg)
    if key_padding_mask is not None:  # [B, T]; 0 = pad
        scores = torch.where(key_padding_mask[:, None, None, :] != 0, scores,
                             neg)
    if attn_mask is not None:
        scores = (torch.where(attn_mask, scores, neg)
                  if attn_mask.dtype == torch.bool
                  else scores + attn_mask)  # additive bias
    p = torch.where(mask, torch.softmax(scores, dim=-1), 0)
    return torch.einsum("bhij,bhjd->bhid", p, v)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None):
    """Attention with a CSR sparsity pattern on ``[B, H, T, D]`` inputs,
    offsets ``[B, H, T + 1]``, columns ``[B, H, nnz]``.

    A pattern :func:`would_use_block_sparse` accepts runs as block-sparse
    attention over its 128-token blocks (inactive blocks cost nothing: the
    kernels on a CUDA tensor, their plain versions on a CPU tensor); any
    other pattern, or one given with masks, as the dense masked
    composition. Differentiable in query, key and value."""
    q, k, v, kpm, am = amp.cast("sparse_attention", query, key, value,
                                key_padding_mask, attn_mask)
    if kpm is None and am is None:
        blocks = _route_blocks(int(q.shape[2]), sparse_csr_offset,
                               sparse_csr_columns)
        if blocks is not None:
            # the kernels' layout is [B, T, H, D]
            out = block_sparse_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), blocks)
            return out.transpose(1, 2)
    return _sa(q, k, v, sparse_csr_offset, sparse_csr_columns, kpm, am)
