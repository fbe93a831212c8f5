"""Flash attention, forward and backward: three hand-written CUDA kernels
for Hopper and their plain PyTorch versions.

The counterpart of ``paddle_tpu.ops.pallas.flash_attention``. The public
:func:`flash_attention` takes paddle-layout ``[B, S, H, D]`` inputs, folds
them to ``[B*H, S, D]`` (batch-head ``bh = b * H + h``), zero-pads D to a
multiple of 64 and runs a ``torch.autograd.Function`` whose forward
launches the forward kernel and whose backward launches the dQ and the
dK/dV kernels (``csrc/flash_attention.cu``). ``delta = rowsum(do * o)``
is plain torch, as the reference leaves it to XLA.

Semantics, all as the reference's:

- causal masking keeps ``row + (seq_k - seq_q) >= col`` (tril with an
  offset), and needs ``seq_k >= seq_q``;
- ``lse = m + log(l)`` is fp32 ``[BH, Sq]`` (the reference's
  ``(BH, 8, Sq)`` is a TPU tiling artifact);
- dropout drops attention probabilities with a keep mask regenerated from
  a murmur3 fmix32 hash of (seed, bh, global row, global col)
  (:func:`dropout_keep`), so forward and backward see the same mask and
  the bits equal the reference's exactly; kept probabilities are scaled by
  ``1 / (1 - rate)``;
- p (forward, dK/dV) and ds (dQ, dK/dV) are rounded to the input dtype
  before their matmuls, as the reference casts them.

Each entry point (:func:`flash_fwd`, :func:`flash_dq`, :func:`flash_dkv`)
picks by the device of its tensors: on a CUDA tensor it launches the
kernel or raises, on a CPU tensor it runs the plain version (their
``impl`` forces one, for comparisons). Nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "supports", "dropout_keep", "flash_fwd",
           "flash_dq", "flash_dkv", "flash_fwd_torch", "flash_dq_torch",
           "flash_dkv_torch", "KERNEL_NAMES"]

KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv")
_SOURCE = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 at 192 and 256 runs the list kernels, bf16 past 256 the D-split
# kernels (bsa_fwd_dsplit_wgmma_kernel, bsa_dq_dsplit_wgmma_kernel,
# bsa_dkv_dsplit_wgmma_kernel); fp32 past 128 the 3xTF32 forward and dK/dV
# (bsa_fwd_tf32_kernel, bsa_dkv_tf32_kernel) and the FMA wide_dq_kernel
_HEAD_DIMS = tuple(range(64, 513, 64))
_TILE = 64
_M32 = 0xFFFFFFFF


def _pick_block(seq: int) -> Optional[int]:
    for blk in (256, 128):
        if seq % blk == 0:
            return blk
    return None


def supports(seq_q: int, seq_k: int, head_dim: int,
             causal: bool = False) -> bool:
    """The reference's static shape gate: both lengths multiples of 128,
    ``1 <= head_dim <= 512``, and ``seq_k >= seq_q`` when causal."""
    if _pick_block(seq_q) is None or _pick_block(seq_k) is None:
        return False
    if not 1 <= head_dim <= 512:
        return False
    return not (causal and seq_k < seq_q)


# ---------------------------------------------------------------- dropout

def _mul32(x, c: int):
    """``x * c`` modulo 2**32 for int64 tensors holding uint32 values,
    split into 16-bit halves of ``c`` so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dropout_threshold(rate: float) -> int:
    return min(int(rate * float(2 ** 32)), 2 ** 32 - 1)


def dropout_keep(seed: int, bh: int, seq_q: int, seq_k: int, rate: float,
                 device=None) -> torch.Tensor:
    """The reference's keep mask ``[bh, seq_q, seq_k]`` (bool): murmur3
    fmix32 over (seed, batch-head, global row, global col) in uint32
    arithmetic, emulated in int64."""
    seed = int(seed) & _M32
    heads = torch.arange(bh, device=device, dtype=torch.int64)
    rows = torch.arange(seq_q, device=device, dtype=torch.int64)
    cols = torch.arange(seq_k, device=device, dtype=torch.int64)
    key = (_mul32(heads, 0x27D4EB2F) + (seed * 0xC2B2AE3D & _M32)) & _M32
    x = (_mul32(rows, 0x9E3779B1)[None, :, None]
         ^ _mul32(cols, 0x85EBCA77)[None, None, :] ^ key[:, None, None])
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= dropout_threshold(rate)


# ------------------------------------------------------- plain versions

def _scores(q, k, causal: bool, scale: float):
    """fp32 ``q k^T * scale`` with the causal mask as -inf."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2:]
        rows = torch.arange(sq, device=s.device)[:, None]
        cols = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(rows + (sk - sq) < cols, float("-inf"))
    return s


def _keep(q, k, dropout: float, seed: int):
    return dropout_keep(seed, q.shape[0], q.shape[1], k.shape[1], dropout,
                        q.device)


def flash_fwd_torch(q, k, v, causal: bool, scale: float,
                    dropout: float = 0.0, seed: int = 0):
    """Plain forward on ``[BH, S, D]``: returns ``(out, lse)``."""
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout > 0.0:
        p = torch.where(_keep(q, k, dropout, seed), p / (1.0 - dropout), 0.0)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _p_dp(q, k, v, do, lse, causal, scale):
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, dp


def flash_dq_torch(q, k, v, do, lse, delta, causal: bool, scale: float,
                   dropout: float = 0.0, seed: int = 0):
    """Plain dQ on ``[BH, S, D]`` (p recomputed from ``lse``)."""
    p, dp = _p_dp(q, k, v, do, lse, causal, scale)
    if dropout > 0.0:
        dp = torch.where(_keep(q, k, dropout, seed), dp / (1.0 - dropout),
                         0.0)
    ds = p * (dp - delta[..., None]) * scale
    return torch.matmul(ds.to(q.dtype).float(), k.float()).to(q.dtype)


def flash_dkv_torch(q, k, v, do, lse, delta, causal: bool, scale: float,
                    dropout: float = 0.0, seed: int = 0):
    """Plain dK/dV on ``[BH, S, D]``: returns ``(dk, dv)``."""
    p, dp = _p_dp(q, k, v, do, lse, causal, scale)
    p_drop = p
    if dropout > 0.0:
        keep = _keep(q, k, dropout, seed)
        inv = 1.0 / (1.0 - dropout)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.matmul(p_drop.to(do.dtype).float().transpose(-1, -2),
                      do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ the kernels

def set_signatures(lib) -> None:
    """The C entries' argument and result types on ``lib``: tensors, then
    bh, sq, sk, head_dim, causal, scale, the dropout arguments, dtype,
    stream."""
    p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint32)
    tail = [i, f, u, u, f, f, i, i, p]  # causal .. dtype, stream
    lib.fa_fwd_launch.argtypes = [p] * 5 + [i] * 4 + tail
    lib.fa_dq_launch.argtypes = [p] * 7 + [i] * 4 + tail
    lib.fa_dkv_launch.argtypes = [p] * 8 + [i] * 4 + tail
    for fn in (lib.fa_fwd_launch, lib.fa_dq_launch, lib.fa_dkv_launch):
        fn.restype = ctypes.c_int
    lib.fa_error_string.argtypes = [i]
    lib.fa_error_string.restype = ctypes.c_char_p


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if lib.fa_fwd_launch.argtypes is None:
        set_signatures(lib)
    return lib


def _check(tensors, q, k):
    """Raise on what the kernels do not take."""
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device} (a CUDA device)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernels support float32 and bfloat16, got "
                         f"{q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"be [BH, S, D] with one BH and D")
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
    if q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"kernels support padded head_dim {_HEAD_DIMS}, "
                         f"got {q.shape[2]}")
    sq, sk = q.shape[1], k.shape[1]
    if sq % _TILE or sk % _TILE or sq == 0 or sk == 0:
        raise ValueError(f"kernels need sequence lengths that are "
                         f"multiples of {_TILE}, got {sq} and {sk}")


def _drop_args(dropout: float, seed: int):
    if dropout <= 0.0:
        return [0, 0, 1.0, 1.0, 0]
    return [int(seed) & _M32, dropout_threshold(dropout), 1.0 - dropout,
            1.0 / (1.0 - dropout), 1]


def _launch(name: str, fn, args, q, k, causal, scale, dropout, seed):
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            *args, q.shape[0], q.shape[1], k.shape[1], q.shape[2],
            int(causal), float(scale), *_drop_args(dropout, seed),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.fa_error_string(err).decode()} "
                           f"(cudaError {err})")
    _build.count_launch(name)


def flash_fwd(q, k, v, causal: bool, scale: float, dropout: float = 0.0,
              seed: int = 0, impl: str = "auto"):
    """Forward on ``[BH, S, D]`` (D a multiple of 64 up to 512 on the
    card): ``(out, lse)``."""
    if _build.pick_impl(impl, q) == "torch":
        return flash_fwd_torch(q, k, v, causal, scale, dropout, seed)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _check(dict(q=q, k=k, v=v, out=out, lse=lse), q, k)
    _launch(KERNEL_NAMES[0], "fa_fwd_launch",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()], q, k, causal, scale, dropout, seed)
    return out, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
             dropout: float = 0.0, seed: int = 0, impl: str = "auto"):
    if _build.pick_impl(impl, q) == "torch":
        return flash_dq_torch(q, k, v, do, lse, delta, causal, scale,
                              dropout, seed)
    dq = torch.empty_like(q)
    _check(dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, dq=dq), q, k)
    _launch(KERNEL_NAMES[1], "fa_dq_launch",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()],
            q, k, causal, scale, dropout, seed)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
              dropout: float = 0.0, seed: int = 0, impl: str = "auto"):
    if _build.pick_impl(impl, q) == "torch":
        return flash_dkv_torch(q, k, v, do, lse, delta, causal, scale,
                               dropout, seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, dk=dk, dv=dv),
           q, k)
    _launch(KERNEL_NAMES[2], "fa_dkv_launch",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr()], q, k, causal, scale, dropout, seed)
    return dk, dv


# ------------------------------------------------------------- autograd

class _FlashBHSD(torch.autograd.Function):
    """``[BH, S, D]`` flash attention whose backward is the dQ and dK/dV
    kernels (the reference's ``jax.custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout, seed):
        out, lse = flash_fwd(q, k, v, causal, scale, dropout, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, dropout, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout: float = 0.0,
                    seed: Optional[int] = None):
    """Flash attention on paddle-layout inputs ``[B, S, H, D]``.

    ``dropout`` drops attention probabilities inside the kernels, the mask
    regenerated in the backward and never stored; ``seed`` (an int) is
    required when ``dropout > 0``. Differentiable in q, k and v."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if seed is None:
        if dropout > 0.0:
            raise ValueError(
                "flash_attention with dropout > 0 needs an explicit seed — "
                "a constant default would drop the same entries every step")
        seed = 0
    dpad = (-d) % 64

    def fold(x):
        x = x.transpose(1, 2).reshape(b * h, x.shape[1], d)
        if dpad:
            x = torch.nn.functional.pad(x, (0, dpad))
        return x.contiguous()

    out = _FlashBHSD.apply(fold(q), fold(k), fold(v), bool(causal),
                           float(scale), float(dropout), int(seed))
    if dpad:
        out = out[..., :d]
    return out.reshape(b, h, s, d).transpose(1, 2)
