"""Ragged paged attention: hand-written CUDA kernels for Hopper and their
plain PyTorch versions.

The serving engine keeps every sequence's K/V in fixed-size token blocks
scattered across a preallocated pool; a block table maps a sequence's
logical positions to pool blocks. Two entry points read the pools through
the tables:

**Segmented** (:func:`ragged_paged_attention_chunked`, the serving path).
One step's token rows are grouped into *segments* — up to ``q_tile``
consecutive rows of one sequence (a prefill chunk, or a single decode row)
sharing one block-table row — so each KV block is read once per segment
instead of once per row. Row ``i`` of a segment sits at cache position
``seg_pos + i`` and attends every cached position ``<= seg_pos + i``
(causal inside the tile by construction).

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

**Per row** (:func:`ragged_paged_attention`, the decode shape; the
counterpart of ``paddle_tpu``'s ``ragged_paged_attention``). One query
token per row; row ``s`` attends cache positions
``p < min(seq_lens[s], MAXB * B)``, position ``p`` at pool block
``block_tables[s, p // B]``, offset ``p % B``, with no causal mask inside
the row. Table entries past a row's need are never read by the kernel
(the plain version gathers them, so they must be valid pool indices: the
JAX convention pads with 0)::

    q            [S, H, D]
    k_pool       [N, B, H, D]
    v_pool       [N, B, H, D]
    block_tables [S, MAXB] int32
    seq_lens     [S]       int32  (<= 0 = inactive)
    -> out       [S, H, D]        rows with seq_len <= 0 are all-zero

``impl``: ``"cuda"`` launches the kernel in
``csrc/ragged_paged_attention.cu`` (fp32 or bf16, fp32 accumulation);
``"torch"`` runs the plain version below, the counterpart of the XLA
reference; ``"auto"`` picks ``"cuda"`` for a CUDA tensor and ``"torch"``
for a CPU tensor. Nothing falls back: a kernel that cannot build or
launch raises.

Head dims. The kernels are built at ``KERNEL_HEAD_DIMS`` (16 to 512); a
call at any other head dim up to 512 pads q and both pools with zeros to
the next of them for that call (:func:`kernel_head_dim`), as the
reference's compiled path pads to 128 lanes, and slices the output back.
That copies both pools each call: the serving engine allocates its pools
at the padded head dim instead, so it never pays it. ``q_tile`` may be any
width; the segmented kernel runs rows beyond what one pass holds (64 at
head dim 128) in further passes over the same split, each reading the
split's K/V again.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["ragged_paged_attention_chunked",
           "ragged_paged_attention_chunked_torch", "ragged_paged_attention",
           "ragged_paged_attention_torch", "check_kernel_geometry",
           "kernel_head_dim", "at_kernel_head_dim", "split_plan",
           "KERNEL_HEAD_DIMS", "KERNEL_NAME", "ROW_KERNEL_NAME"]

KERNEL_NAME = "ragged_paged_attention_chunked"
ROW_KERNEL_NAME = "ragged_paged_attention"
_SOURCE = "ragged_paged_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256, 512)
# A launch of the segmented kernel aims at this many thread blocks (about
# 8 an SM on the H100's 132): the split count follows from it and the
# static shapes, so a 16-row decode step at H = 16 runs 4 splits a row
# (ops/paged_splits.py times the others).
TARGET_BLOCKS = 1024
_SPLIT_QUANTUM = 64            # splits are whole chunks (csrc kMaxChunk)
_MAX_SPLIT = 8192              # a split's pool rows in shared memory (csrc)
_WORKSPACE_BYTES = 64 << 20    # the splits' fp32 states, at most
_SCRATCH = {}                  # (device, stream) -> [counters, states]
_PLANS = {}                    # launch shapes -> (split, n_splits, slots)


def kernel_head_dim(head_dim: int) -> int:
    """The head dim the kernels run ``head_dim`` at: the smallest of
    ``KERNEL_HEAD_DIMS`` that holds it. Raises ``ValueError`` past 512,
    the largest head dim the reference's gates take."""
    for d in KERNEL_HEAD_DIMS:
        if head_dim <= d:
            if head_dim < 1:
                break
            return d
    raise ValueError(f"kernel supports head_dim 1..{KERNEL_HEAD_DIMS[-1]}, "
                     f"got {head_dim}")


def check_kernel_geometry(head_dim: int, q_tile: int) -> None:
    """Raise ``ValueError`` for a geometry the kernels do not take:
    ``head_dim`` must be 1..512 and ``q_tile`` at least 1."""
    kernel_head_dim(head_dim)
    if q_tile < 1:
        raise ValueError(f"kernel supports q_tile >= 1, got {q_tile}")


def split_plan(n_seg: int, n_heads: int, cap: int, q_tile: int,
               head_dim: int):
    """``(split, n_splits)`` of a segmented launch, from static shapes
    only: kv positions a split covers (a multiple of 64, at most 8192, so
    that its pool rows fit the block's shared memory) and the splits that
    cover the table's ``cap = MAXB * B`` positions. Aims at
    ``TARGET_BLOCKS`` blocks over the ``n_seg * n_heads`` pairs, and keeps
    the splits' fp32 states within 64 MB where the 8192 allows."""
    pairs = n_seg * n_heads
    most = -(-cap // _SPLIT_QUANTUM)
    want = -(-TARGET_BLOCKS // pairs)
    room = _WORKSPACE_BYTES // (4 * pairs * q_tile * (head_dim + 2))
    n = max(1, min(want, most, room), -(-cap // _MAX_SPLIT))
    split = -(-cap // n)
    split = -(-split // _SPLIT_QUANTUM) * _SPLIT_QUANTUM
    return split, -(-cap // split)


def at_kernel_head_dim(fn, q, k_pool, v_pool, *args, **kwargs):
    """``fn(q, k_pool, v_pool, *args, **kwargs)`` run at the kernels' head
    dim: q and the pools zero-padded to :func:`kernel_head_dim` (copies,
    where they are narrower), the output sliced back to q's head dim.
    Zero lanes leave every score unchanged, so ``scale`` must be given for
    the unpadded head dim. The kernel launchers run through it."""
    d = q.shape[-1]
    kd = kernel_head_dim(d)
    if kd == d and k_pool.shape[-1] == d and v_pool.shape[-1] == d:
        return fn(q, k_pool, v_pool, *args, **kwargs)
    pad = lambda t: t if t.shape[-1] == kd else \
        torch.nn.functional.pad(t, (0, kd - t.shape[-1]))
    out = fn(pad(q), pad(k_pool), pad(v_pool), *args, **kwargs)
    return out if kd == d else out[..., :d].contiguous()


def _scratch(device, stream: int, n_counters: int, n_states: int):
    """The addresses of ``n_counters`` int32 merge counters, zero, and of
    room for ``n_states`` fp32 split states, for launches on ``stream`` of
    ``device`` (the current stream, on which a buffer that grows is also
    freed). The kernel's merging blocks leave the counters zero, so one
    pair of buffers serves every launch on a stream, which runs them in
    order, and a call allocates nothing; launches on two streams at once
    get two pairs. A kernel that faults midway leaves its counters set,
    but also leaves the card's context unusable, so no later launch reads
    them."""
    bufs = _SCRATCH.setdefault((device.index, stream), [None, None])
    if bufs[0] is None or bufs[0].numel() < n_counters:
        bufs[0] = torch.zeros(max(n_counters, 4096), dtype=torch.int32,
                              device=device)
    if bufs[1] is None or bufs[1].numel() < n_states:
        bufs[1] = torch.empty(n_states, dtype=torch.float32, device=device)
    return bufs[0].data_ptr(), bufs[1].data_ptr()


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
        lib.rpa_chunked_launch.argtypes = [p] * 11 + [i] * 8 + [
            ctypes.c_float, i, p]
        lib.rpa_chunked_launch.restype = ctypes.c_int
        lib.rpa_row_launch.argtypes = [p] * 6 + [i] * 5 + [
            ctypes.c_float, i, p]
        lib.rpa_row_launch.restype = ctypes.c_int
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
        if t.data_ptr() % 16:  # the kernels copy 16 bytes at a time
            raise ValueError(f"{name} must be 16-byte aligned, got address "
                             f"{t.data_ptr():#x}")
    for name, t in meta.items():
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{q.device}, got {t.dtype} on {t.device}"
                             + ("" if t.is_contiguous()
                                else " (not contiguous)"))


def _rpa_chunked_cuda(q, k_pool, v_pool, seg_tables, seg_pos, seg_rows,
                      seg_row_idx, scale: float):
    """Launch the segmented kernel. Reads nothing back from the card: the
    grid and the workspace follow from the shapes alone."""
    _check_cuda_args(q, k_pool, v_pool, dict(
        seg_tables=seg_tables, seg_pos=seg_pos, seg_rows=seg_rows,
        seg_row_idx=seg_row_idx))
    n_seg, tq = seg_row_idx.shape
    check_kernel_geometry(q.shape[2], tq)
    if seg_tables.shape[0] != n_seg or seg_pos.shape != (n_seg,) \
            or seg_rows.shape != (n_seg,):
        raise ValueError("segment metadata disagree on the segment count")
    if n_seg > 65535 or q.shape[1] > 65535:
        raise ValueError(f"kernel supports at most 65535 segments and "
                         f"heads, got {n_seg} and {q.shape[1]}")
    if n_seg == 0:
        return torch.zeros_like(q)
    if q.shape[2] in KERNEL_HEAD_DIMS:  # the pools match q (checked above)
        return _launch_chunked(q, k_pool, v_pool, seg_tables, seg_pos,
                               seg_rows, seg_row_idx, scale)
    return at_kernel_head_dim(_launch_chunked, q, k_pool, v_pool,
                              seg_tables, seg_pos, seg_rows, seg_row_idx,
                              scale)


def _launch_plan(n_seg, h, kd, block_size, max_blocks, tq):
    """``(split, n_splits, slots)`` of a launch, ``slots`` the workspace's
    fp32 rows (0 when one split covers the table), cached by shape and by
    the planner and its target, so a replaced :func:`split_plan` or
    ``TARGET_BLOCKS`` plans afresh."""
    key = (split_plan, TARGET_BLOCKS, n_seg, h, kd, block_size, max_blocks,
           tq)
    plan = _PLANS.get(key)
    if plan is None:
        split, n_splits = split_plan(n_seg, h, block_size * max_blocks, tq,
                                     kd)
        slots = n_seg * h * n_splits * tq if n_splits > 1 else 0
        plan = _PLANS[key] = (split, n_splits, slots)
    return plan


def _launch_chunked(q, k_pool, v_pool, seg_tables, seg_pos, seg_rows,
                    seg_row_idx, scale):
    n_seg, tq = seg_row_idx.shape
    h, kd = q.shape[1], q.shape[2]
    block_size, max_blocks = k_pool.shape[1], seg_tables.shape[1]
    split, n_splits, slots = _launch_plan(n_seg, h, kd, block_size,
                                          max_blocks, tq)
    out = torch.zeros_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work_acc = work_ml = counters = None
    if slots:
        # the splits' states: fp32 rows [slots, kd], then (m, l) pairs
        counters, work_acc = _scratch(q.device, stream, n_seg * h,
                                      slots * (kd + 2))
        work_ml = work_acc + 4 * slots * kd
    lib = _kernel_lib()
    with torch.cuda.device(q.device):  # launch on q's card, not the current
        err = lib.rpa_chunked_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            seg_tables.data_ptr(), seg_pos.data_ptr(), seg_rows.data_ptr(),
            seg_row_idx.data_ptr(), out.data_ptr(), work_acc, work_ml,
            counters, n_seg, h, kd, block_size, max_blocks, tq, split,
            n_splits, scale, _DTYPE_CODES[q.dtype], stream)
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


def ragged_paged_attention_torch(q, k_pool, v_pool, block_tables, seq_lens,
                                 scale: Optional[float] = None):
    """Plain PyTorch version of the per-row attention (the counterpart of
    the JAX package's ``ragged_paged_attention_reference``): gather each
    row's whole table once, mask the positions at or past the row's
    length, full fp32 softmax. Rows with ``seq_len <= 0`` come back exactly
    zero. Takes any head dim and dtype."""
    n_rows, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    max_blocks = block_tables.shape[1]
    n_pos = max_blocks * k_pool.shape[1]
    tables = block_tables.long()
    k = k_pool[tables].reshape(n_rows, n_pos, h, d).float()  # [S, L, H, D]
    v = v_pool[tables].reshape(n_rows, n_pos, h, d).float()
    scores = torch.einsum("shd,sthd->sht", q.float() * scale, k)
    lens = seq_lens.long()
    valid = torch.arange(n_pos, device=q.device)[None, :] < lens[:, None]
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("sht,sthd->shd", p, v) / l.clamp_min(1e-30)
    out = torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def _rpa_row_cuda(q, k_pool, v_pool, block_tables, seq_lens, scale: float):
    _check_cuda_args(q, k_pool, v_pool, dict(block_tables=block_tables,
                                             seq_lens=seq_lens))
    n_rows, h, d = q.shape
    kernel_head_dim(d)
    if block_tables.dim() != 2 or block_tables.shape[0] != n_rows \
            or tuple(seq_lens.shape) != (n_rows,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} and "
                         f"seq_lens {tuple(seq_lens.shape)} must be "
                         f"[{n_rows}, MAXB] and [{n_rows}]")
    if h > 65535:
        raise ValueError(f"kernel supports at most 65535 heads, got {h}")
    if n_rows == 0:
        return torch.empty_like(q)
    if d in KERNEL_HEAD_DIMS:  # the pools match q (checked above)
        return _launch_row(q, k_pool, v_pool, block_tables, seq_lens, scale)
    return at_kernel_head_dim(_launch_row, q, k_pool, v_pool, block_tables,
                              seq_lens, scale)


def _launch_row(q, k_pool, v_pool, block_tables, seq_lens, scale):
    n_rows, h, kd = q.shape
    out = torch.empty_like(q)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):  # launch on q's card, not the current
        err = lib.rpa_row_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            n_rows, h, kd, k_pool.shape[1], block_tables.shape[1], scale,
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{ROW_KERNEL_NAME} kernel launch failed: "
            f"{lib.rpa_error_string(err).decode()} (cudaError {err})")
    _build.count_launch(ROW_KERNEL_NAME)
    return out


def ragged_paged_attention(q, k_pool, v_pool, block_tables, seq_lens,
                           scale: Optional[float] = None, impl: str = "auto"):
    """Per-row ragged paged attention over a block-paged KV pool (see the
    module doc): one query token per row, ``scale`` ``1 / sqrt(D)`` by
    default. ``impl`` is ``"auto" | "cuda" | "torch"``; the JAX package's
    ``"pallas"`` and ``"xla"`` are not routes here and raise."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if _build.pick_impl(impl, q) == "torch":
        return ragged_paged_attention_torch(q, k_pool, v_pool, block_tables,
                                            seq_lens, scale)
    return _rpa_row_cuda(q, k_pool, v_pool, block_tables, seq_lens,
                         float(scale))
