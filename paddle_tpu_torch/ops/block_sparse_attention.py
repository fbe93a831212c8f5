"""Block-sparse attention, forward and backward: three hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

The counterpart of ``paddle_tpu.ops.pallas.block_sparse_attention``.
Sparsity is at block granularity: a boolean ``block_mask[n_q, n_kv]``
says which kv blocks each q block attends (block sizes ``S / n``, 128
multiples up to 512, ``blk_q`` and ``blk_k`` may differ). The mask is
compacted once per pattern into q-major lists (``cols [n_q, a_max]``,
``counts [n_q]``: the active kv blocks of each q block) and kv-major lists
(``rows [n_kv, b_max]``, ``rcounts [n_kv]``: the q blocks that attend each
kv block), kept with their device copies in a :class:`BlockMask`. The
forward and dQ kernels walk a q block's list, the dK/dV kernel a kv
block's (``csrc/block_sparse_attention.cu``), so inactive blocks cost
neither operations nor bytes. ``delta = rowsum(do * out)`` is plain torch,
as the reference leaves it to XLA.

Semantics, as the reference's: scores ``q k^T * scale`` in fp32, p (and
ds) rounded to the input dtype before their matmuls, ``lse = m + log(l)``
fp32 ``[BH, S]``; ``causal`` keeps ``row + (sk - sq) >= col`` inside the
active blocks and drops blocks wholly above the diagonal from the lists.
One difference: with ``causal`` and ``blk_q > blk_k`` a row can see no
unmasked column at all. The reference divides 0 by 0 there and returns
NaN for the row; the port returns 0 (lse -inf), and its gradients through
the row are 0.

Each entry point (:func:`bsa_fwd`, :func:`bsa_dq`, :func:`bsa_dkv`) picks
by the device of its tensors: on a CUDA tensor it launches the kernel or
raises, on a CPU tensor it runs the plain version (``impl`` forces one,
for comparisons). Nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import _check as check_tensors

__all__ = ["block_sparse_attention", "local_global_mask", "supports",
           "BlockMask", "heavy_first", "block_mask_spec", "bsa_fwd",
           "bsa_dq", "bsa_dkv", "bsa_fwd_torch", "bsa_dq_torch",
           "bsa_dkv_torch", "KERNEL_NAMES"]

KERNEL_NAMES = ("block_sparse_attention_fwd", "block_sparse_attention_dq",
                "block_sparse_attention_dkv")
_SOURCE = "block_sparse_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_block(seq: int) -> Optional[int]:
    for blk in (256, 128):
        if seq % blk == 0:
            return blk
    return None


def supports(seq_q: int, seq_k: int, head_dim: int) -> bool:
    """The reference's static shape gate."""
    return (_pick_block(seq_q) is not None and _pick_block(seq_k) is not None
            and 1 <= head_dim <= 512)


def local_global_mask(n_q: int, n_kv: int, window: int = 1,
                      global_blocks: int = 0,
                      causal: bool = False) -> np.ndarray:
    """Block mask for the local-window (+leading global blocks) pattern:
    query block i attends kv blocks [i-window, i+window] plus the first
    ``global_blocks`` blocks; ``causal`` drops j > i."""
    m = np.zeros((n_q, n_kv), bool)
    off = n_kv - n_q  # rectangular case aligns diagonals at the end
    for i in range(n_q):
        lo = max(0, i + off - window)
        hi = min(n_kv - 1, i + off if causal else i + off + window)
        m[i, lo:hi + 1] = True
        m[i, :min(global_blocks, n_kv)] = True
        if causal:
            m[i, max(i + off + 1, 0):] = False
    return m


def _compact(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """bool [n_q, n_kv] -> (cols [n_q, A] int32, counts [n_q] int32), rows
    padded by repeating their last active column. Every q block must keep
    an active kv block."""
    n_q, _ = mask.shape
    counts = mask.sum(axis=1).astype(np.int32)
    if (counts == 0).any():
        raise ValueError("block_sparse_attention: every query block must "
                         "attend at least one kv block (empty rows are NaN)")
    cols = np.zeros((n_q, int(counts.max())), np.int32)
    for i in range(n_q):
        act = np.nonzero(mask[i])[0]
        cols[i, :len(act)] = act
        cols[i, len(act):] = act[-1]
    return cols, counts


def _compact_kv(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The kv-major lists: (rows [n_kv, B] int32, rcounts [n_kv] int32),
    ``B = max(1, max rcounts)``; a kv block nothing attends has count 0."""
    rmask = mask.T
    rcounts = rmask.sum(axis=1).astype(np.int32)
    rows = np.zeros((rmask.shape[0], max(int(rcounts.max()), 1)), np.int32)
    for j in range(rmask.shape[0]):
        act = np.nonzero(rmask[j])[0]
        if len(act):
            rows[j, :len(act)] = act
            rows[j, len(act):] = act[-1]
    return rows, rcounts


def heavy_first(counts: np.ndarray) -> np.ndarray:
    """Block indices by list length, longest first (ties in index order),
    int32: the order the wgmma kernels launch their blocks in, so that a
    long list (BigBird's global blocks) does not start last and set the
    tail."""
    return np.argsort(-counts, kind="stable").astype(np.int32)


class BlockMask:
    """One pattern's compactions (the reference's ``_MaskSpec``): the
    block mask as the kernels see it (after the causal drop), block sizes,
    the q-major and kv-major lists on the host, their launch orders
    (:func:`heavy_first`), and their int32 device copies, made once per
    device."""

    def __init__(self, mask: np.ndarray, blk_q: int, blk_k: int):
        self.mask = mask
        self.blk_q, self.blk_k = blk_q, blk_k
        self.cols, self.counts = _compact(mask)
        self.rows, self.rcounts = _compact_kv(mask)
        self.order_q = heavy_first(self.counts)
        self.order_kv = heavy_first(self.rcounts)
        self._on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def lists(self, device) -> Tuple[torch.Tensor, ...]:
        """``(cols, counts, order_q, rows, rcounts, order_kv)`` as int32
        tensors on ``device``."""
        device = torch.device(device)
        got = self._on.get(device)
        if got is None:
            got = self._on[device] = tuple(
                torch.from_numpy(a).to(device) for a in
                (self.cols, self.counts, self.order_q, self.rows,
                 self.rcounts, self.order_kv))
        return got


_SPECS: Dict[tuple, BlockMask] = {}


def block_mask_spec(block_mask, seq_q: int, seq_k: int,
                    causal: bool) -> BlockMask:
    """The :class:`BlockMask` of ``block_mask`` for these sequence lengths,
    with the reference's checks and causal drop; built once per pattern
    (cached on the mask's bytes)."""
    mask = np.asarray(block_mask, bool)
    n_q, n_kv = mask.shape
    if seq_q % n_q or seq_k % n_kv:
        raise ValueError(f"block_mask {mask.shape} does not tile "
                         f"({seq_q}, {seq_k})")
    blk_q, blk_k = seq_q // n_q, seq_k // n_kv
    if blk_q % 128 or blk_k % 128 or blk_q > 512 or blk_k > 512:
        raise ValueError(
            f"block sizes ({blk_q}, {blk_k}) must be 128-multiples <= 512")
    key = (mask.shape, mask.tobytes(), seq_q, seq_k, bool(causal))
    spec = _SPECS.get(key)
    if spec is None:
        if causal:
            # drop blocks fully above the diagonal so they don't waste slots
            off = seq_k - seq_q
            keep = np.zeros_like(mask)
            for i in range(n_q):
                last = i * blk_q + blk_q - 1 + off
                keep[i, :last // blk_k + 1] = True
            mask = mask & keep
        spec = BlockMask(mask, blk_q, blk_k)
        if len(_SPECS) > 64:
            _SPECS.clear()
        _SPECS[key] = spec
    return spec


# ------------------------------------------------------- plain versions

def _span(blocks, blk: int, device) -> torch.Tensor:
    """Row indices of the listed blocks, in list order."""
    idx = (np.asarray(blocks, np.int64)[:, None] * blk
           + np.arange(blk)[None, :]).reshape(-1)
    return torch.from_numpy(idx).to(device)


def _scores(qb, kb, q_idx, k_idx, causal: bool, scale: float, offset: int):
    """fp32 ``q k^T * scale`` of the gathered rows, the causal mask as
    -inf; returns (scores, keep mask or None)."""
    s = torch.matmul(qb.float(), kb.float().transpose(-1, -2)) * scale
    if not causal:
        return s, None
    keep = q_idx[:, None] + offset >= k_idx[None, :]
    return s.masked_fill(~keep, float("-inf")), keep


def _p(s, lse, keep):
    """p recomputed from lse; 0 where masked (every column of a row that
    saw none, whose lse is -inf)."""
    p = torch.exp(s - lse[..., None])
    return p if keep is None else torch.where(keep, p, 0.0)


def bsa_fwd_torch(q, k, v, spec: BlockMask, causal: bool, scale: float):
    """Plain forward on ``[BH, S, D]`` over the q-major lists: returns
    ``(out, lse)``."""
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    offset = k.shape[1] - q.shape[1]
    for i in range(spec.cols.shape[0]):
        q_idx = _span([i], spec.blk_q, q.device)
        k_idx = _span(spec.cols[i, :spec.counts[i]], spec.blk_k, q.device)
        s, _ = _scores(q[:, q_idx], k[:, k_idx], q_idx, k_idx, causal,
                       scale, offset)
        m = s.amax(dim=-1, keepdim=True)
        m_use = torch.where(m == float("-inf"), 0.0, m)
        p = torch.exp(s - m_use)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p.to(q.dtype).float(), v[:, k_idx].float())
        seen = l > 0
        out[:, q_idx] = torch.where(seen, acc / l, 0.0).to(q.dtype)
        lse[:, q_idx] = torch.where(seen, m + torch.log(l),
                                    float("-inf")).squeeze(-1)
    return out, lse


def bsa_dq_torch(q, k, v, do, lse, delta, spec: BlockMask, causal: bool,
                 scale: float):
    """Plain dQ on ``[BH, S, D]`` over the q-major lists (p recomputed
    from ``lse``)."""
    dq = torch.empty_like(q)
    offset = k.shape[1] - q.shape[1]
    for i in range(spec.cols.shape[0]):
        q_idx = _span([i], spec.blk_q, q.device)
        k_idx = _span(spec.cols[i, :spec.counts[i]], spec.blk_k, q.device)
        kb = k[:, k_idx]
        s, keep = _scores(q[:, q_idx], kb, q_idx, k_idx, causal, scale,
                          offset)
        p = _p(s, lse[:, q_idx], keep)
        dp = torch.matmul(do[:, q_idx].float(),
                          v[:, k_idx].float().transpose(-1, -2))
        ds = p * (dp - delta[:, q_idx, None]) * scale
        dq[:, q_idx] = torch.matmul(ds.to(q.dtype).float(),
                                    kb.float()).to(q.dtype)
    return dq


def bsa_dkv_torch(q, k, v, do, lse, delta, spec: BlockMask, causal: bool,
                  scale: float):
    """Plain dK/dV on ``[BH, S, D]`` over the kv-major lists: returns
    ``(dk, dv)``; a kv block nothing attends gets zeros."""
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    offset = k.shape[1] - q.shape[1]
    for j in range(spec.rows.shape[0]):
        if spec.rcounts[j] == 0:
            continue
        k_idx = _span([j], spec.blk_k, q.device)
        q_idx = _span(spec.rows[j, :spec.rcounts[j]], spec.blk_q, q.device)
        qb, dob = q[:, q_idx], do[:, q_idx]
        s, keep = _scores(qb, k[:, k_idx], q_idx, k_idx, causal, scale,
                          offset)
        p = _p(s, lse[:, q_idx], keep)
        dp = torch.matmul(dob.float(), v[:, k_idx].float().transpose(-1, -2))
        ds = p * (dp - delta[:, q_idx, None]) * scale
        dv[:, k_idx] = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                                    dob.float()).to(v.dtype)
        dk[:, k_idx] = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                                    qb.float()).to(k.dtype)
    return dk, dv


# ------------------------------------------------------------ the kernels

def set_signatures(lib) -> None:
    """The C entries' argument and result types on ``lib``: tensors, then
    the lists and their launch order, then width, bh, sq, sk, head_dim,
    blk_q, blk_k, causal, scale, dtype, stream."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 8 + [f, i, p]
    lib.bsa_fwd_launch.argtypes = [p] * 8 + tail
    lib.bsa_dq_launch.argtypes = [p] * 10 + tail
    lib.bsa_dkv_launch.argtypes = [p] * 11 + tail
    for fn in (lib.bsa_fwd_launch, lib.bsa_dq_launch, lib.bsa_dkv_launch):
        fn.restype = ctypes.c_int
    lib.bsa_error_string.argtypes = [i]
    lib.bsa_error_string.restype = ctypes.c_char_p


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if lib.bsa_fwd_launch.argtypes is None:
        set_signatures(lib)
    return lib


def _check(tensors, q, k, spec: BlockMask):
    """Raise on what the kernels do not take: the flash kernels' tensor
    checks (device, layout, dtype, [BH, S, D], head_dim a multiple of 64
    up to 512), and lists that tile the sequences."""
    check_tensors(tensors, q, k)
    n_q, n_kv = spec.mask.shape
    if q.shape[1] != n_q * spec.blk_q or k.shape[1] != n_kv * spec.blk_k:
        raise ValueError(f"block mask {spec.mask.shape} at blocks "
                         f"({spec.blk_q}, {spec.blk_k}) does not tile "
                         f"({q.shape[1]}, {k.shape[1]})")


def _launch(name: str, fn, ptrs, lists, width, q, k, spec, causal, scale):
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            *ptrs, *(t.data_ptr() for t in lists), width, q.shape[0],
            q.shape[1], k.shape[1], q.shape[2], spec.blk_q, spec.blk_k,
            int(causal), float(scale), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.bsa_error_string(err).decode()} "
                           f"(cudaError {err})")
    _build.count_launch(name)


def bsa_fwd(q, k, v, spec: BlockMask, causal: bool, scale: float,
            impl: str = "auto"):
    """Forward on ``[BH, S, D]`` (D a multiple of 64 up to 512 on the
    card): ``(out, lse)``."""
    if _build.pick_impl(impl, q) == "torch":
        return bsa_fwd_torch(q, k, v, spec, causal, scale)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _check(dict(q=q, k=k, v=v, out=out, lse=lse), q, k, spec)
    q_lists = spec.lists(q.device)[:3]
    _launch(KERNEL_NAMES[0], "bsa_fwd_launch",
            [t.data_ptr() for t in (q, k, v, out, lse)], q_lists,
            q_lists[0].shape[1], q, k, spec, causal, scale)
    return out, lse


def bsa_dq(q, k, v, do, lse, delta, spec: BlockMask, causal: bool,
           scale: float, impl: str = "auto"):
    if _build.pick_impl(impl, q) == "torch":
        return bsa_dq_torch(q, k, v, do, lse, delta, spec, causal, scale)
    dq = torch.empty_like(q)
    _check(dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, dq=dq), q, k,
           spec)
    q_lists = spec.lists(q.device)[:3]
    _launch(KERNEL_NAMES[1], "bsa_dq_launch",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)],
            q_lists, q_lists[0].shape[1], q, k, spec, causal, scale)
    return dq


def bsa_dkv(q, k, v, do, lse, delta, spec: BlockMask, causal: bool,
            scale: float, impl: str = "auto"):
    if _build.pick_impl(impl, q) == "torch":
        return bsa_dkv_torch(q, k, v, do, lse, delta, spec, causal, scale)
    # every kv tile is written, an unattended one with zeros
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, dk=dk, dv=dv),
           q, k, spec)
    kv_lists = spec.lists(q.device)[3:]
    _launch(KERNEL_NAMES[2], "bsa_dkv_launch",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)],
            kv_lists, kv_lists[0].shape[1], q, k, spec, causal, scale)
    return dk, dv


# ------------------------------------------------------------- autograd

class _BlockSparseBHSD(torch.autograd.Function):
    """``[BH, S, D]`` block-sparse attention whose backward is the dQ and
    dK/dV kernels (the reference's ``_bsa_bhsd`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, spec, causal, scale, impl):
        out, lse = bsa_fwd(q, k, v, spec, causal, scale, impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (spec, causal, scale, impl)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        dq = bsa_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = bsa_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def block_sparse_attention(q, k, v, block_mask, causal: bool = False,
                           scale: Optional[float] = None,
                           impl: str = "auto"):
    """Block-sparse attention on paddle-layout ``[B, S, H, D]`` inputs.

    ``block_mask``: bool ``[seq_q // blk_q, seq_k // blk_k]`` selecting
    which kv blocks each query block attends (see
    :func:`local_global_mask`); every query block must attend one.
    ``causal`` additionally applies the element-level triangular mask
    inside active blocks; a row left with no unmasked column returns 0
    (the reference returns NaN there). ``impl`` forces the kernels
    ("cuda") or their plain versions ("torch"); "auto" picks by device.
    Differentiable in q, k and v."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    spec = block_mask_spec(block_mask, s, sk, causal)
    dpad = (-d) % 64

    def fold(x):
        x = x.transpose(1, 2).reshape(b * h, x.shape[1], d)
        if dpad:
            x = torch.nn.functional.pad(x, (0, dpad))
        return x.contiguous()

    out = _BlockSparseBHSD.apply(fold(q), fold(k), fold(v), spec,
                                 bool(causal), float(scale), impl)
    if dpad:
        out = out[..., :d]
    return out.reshape(b, h, s, d).transpose(1, 2)
