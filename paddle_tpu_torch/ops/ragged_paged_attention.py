"""Segmented ragged paged attention: a hand-written CUDA kernel for Hopper
and its plain PyTorch version.

The serving engine keeps every sequence's K/V in fixed-size token blocks
scattered across a preallocated pool; a block table maps a sequence's
logical positions to pool blocks. One step's token rows are grouped into
*segments* — up to ``q_tile`` consecutive rows of one sequence (a prefill
chunk, or a single decode row) sharing one block-table row — so each KV
block is read once per segment instead of once per row. Row ``i`` of a
segment sits at cache position ``seg_pos + i`` and attends every cached
position ``<= seg_pos + i`` (causal inside the tile by construction).

Shape contract (the layout of ``paddle_tpu``'s
``ragged_paged_attention_chunked``, so the two are compared like for
like)::

    q            [T, H, D]        token rows in step order
    k_pool       [N, B, H, D]     K pool: N blocks of B tokens
    v_pool       [N, B, H, D]
    seg_tables   [S, MAXB] int32  one block-table row per segment
    seg_pos      [S]       int32  position of each segment's first row
    seg_rows     [S]       int32  valid rows per segment (0 = inactive)
    seg_row_idx  [S, TQ]   int32  global row index of each tile slot
    row_gather   [T]       int32  inverse map: seg * TQ + offset per row
    -> out       [T, H, D]        rows of inactive segments are all-zero

``impl``: ``"cuda"`` launches the kernel in
``csrc/ragged_paged_attention.cu`` (fp32 or bf16, fp32 accumulation);
``"torch"`` runs the plain version below, the counterpart of the
segmented XLA reference; ``"auto"`` picks ``"cuda"`` for a CUDA tensor and
``"torch"`` for a CPU tensor. Nothing falls back: a kernel that cannot
build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["ragged_paged_attention_chunked",
           "ragged_paged_attention_chunked_torch", "check_kernel_geometry",
           "KERNEL_NAME"]

KERNEL_NAME = "ragged_paged_attention_chunked"
_SOURCE = "ragged_paged_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_TQ = 8


def check_kernel_geometry(head_dim: int, q_tile: int) -> None:
    """Raise ``ValueError`` for a geometry the kernel does not take:
    ``head_dim`` must be one of 32, 64, 128 and ``1 <= q_tile <= 8``."""
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"kernel supports head_dim {_HEAD_DIMS}, got "
                         f"{head_dim}")
    if not 1 <= q_tile <= _MAX_TQ:
        raise ValueError(f"kernel supports q_tile <= {_MAX_TQ}, got "
                         f"{q_tile}")


def ragged_paged_attention_chunked_torch(q, k_pool, v_pool, seg_tables,
                                         seg_pos, seg_rows, seg_row_idx,
                                         row_gather,
                                         scale: Optional[float] = None):
    """Plain PyTorch version: gather each segment's K/V through its table
    once, mask causally per row, full fp32 softmax. Rows of inactive
    segments come back exactly zero."""
    n_rows_total, h, d = q.shape
    n_seg, tq = seg_row_idx.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    idx = seg_row_idx.long().clamp(0, n_rows_total - 1)
    q_seg = q[idx].float() * scale                          # [S, TQ, H, D]
    tables = seg_tables.long()
    k = k_pool[tables].reshape(n_seg, -1, h, d).float()     # [S, L, H, D]
    v = v_pool[tables].reshape(n_seg, -1, h, d).float()
    scores = torch.einsum("sqhd,sthd->sqht", q_seg, k)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    row_i = torch.arange(tq, device=q.device)
    row_pos = seg_pos.long()[:, None] + row_i[None, :]      # [S, TQ]
    valid = row_i[None, :] < seg_rows.long()[:, None]       # [S, TQ]
    mask = (kv_pos[None, None, :] <= row_pos[:, :, None]) & valid[:, :, None]
    scores = scores.masked_fill(~mask[:, :, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("sqht,sthd->sqhd", p, v) / l.clamp_min(1e-30)
    out = torch.where(valid[:, :, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype).reshape(-1, h, d)[row_gather.long()]


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if lib.rpa_chunked_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rpa_chunked_launch.argtypes = [p] * 8 + [i] * 6 + [
            ctypes.c_float, i, p]
        lib.rpa_chunked_launch.restype = ctypes.c_int
        lib.rpa_error_string.argtypes = [i]
        lib.rpa_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(q, k_pool, v_pool, meta):
    if not (q.is_cuda and k_pool.is_cuda and v_pool.is_cuda):
        raise ValueError("impl='cuda' needs q and the pools on a CUDA device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel supports float32 and bfloat16, got "
                         f"{q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"q ({q.dtype}) and pools ({k_pool.dtype}, "
                         f"{v_pool.dtype}) must share a dtype")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or tuple(k_pool.shape[2:]) != tuple(q.shape[1:]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in meta.items():
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{q.device}")


def _rpa_chunked_cuda(q, k_pool, v_pool, seg_tables, seg_pos, seg_rows,
                      seg_row_idx, scale: float):
    _check_cuda_args(q, k_pool, v_pool, dict(
        seg_tables=seg_tables, seg_pos=seg_pos, seg_rows=seg_rows,
        seg_row_idx=seg_row_idx))
    n_seg, tq = seg_row_idx.shape
    check_kernel_geometry(q.shape[2], tq)
    if seg_tables.shape[0] != n_seg or seg_pos.shape != (n_seg,) \
            or seg_rows.shape != (n_seg,):
        raise ValueError("segment metadata disagree on the segment count")
    _, h, d = q.shape
    block_size = k_pool.shape[1]
    out = torch.zeros_like(q)
    if n_seg == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(q.device):  # launch on q's card, not the current
        err = lib.rpa_chunked_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            seg_tables.data_ptr(), seg_pos.data_ptr(), seg_rows.data_ptr(),
            seg_row_idx.data_ptr(), out.data_ptr(), n_seg, h, d, block_size,
            seg_tables.shape[1], tq, scale, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{KERNEL_NAME} kernel launch failed: "
            f"{lib.rpa_error_string(err).decode()} (cudaError {err})")
    _build.count_launch(KERNEL_NAME)
    return out


def ragged_paged_attention_chunked(q, k_pool, v_pool, seg_tables, seg_pos,
                                   seg_rows, seg_row_idx, row_gather,
                                   scale: Optional[float] = None,
                                   impl: str = "auto"):
    """Segmented ragged paged attention (see module doc). The kernel writes
    each valid row straight to ``out[seg_row_idx[s, i]]``, so it reads no
    ``row_gather``: that must be the inverse of ``seg_row_idx`` over the
    valid slots, as the engine builds it."""
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"impl must be auto|cuda|torch, got {impl!r}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "torch":
        return ragged_paged_attention_chunked_torch(
            q, k_pool, v_pool, seg_tables, seg_pos, seg_rows, seg_row_idx,
            row_gather, scale)
    return _rpa_chunked_cuda(q, k_pool, v_pool, seg_tables, seg_pos,
                             seg_rows, seg_row_idx, float(scale))
