"""Fused LayerNorm: a hand-written CUDA forward kernel for Hopper and its
plain PyTorch version, with the reference's closed-form backward.

The counterpart of ``paddle_tpu.ops.pallas.layer_norm``. The forward over
``[N, F]`` rows is one kernel (``csrc/layer_norm.cu``): fp32 mean, then
the variance as the mean of ``(x - mean)^2``, ``rsqrt(var + eps)``, the
affine in fp32, the output in x's dtype. The backward is the reference's
closed form (``_ln_bwd``), which it leaves to XLA: plain torch here.

:func:`ln_fwd` picks by the device of its tensor: on a CUDA tensor it
launches the kernel or raises, on a CPU tensor it runs the plain version
(``impl`` forces one, for comparisons). Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_layer_norm", "ln_fwd", "ln_fwd_torch", "KERNEL_NAME"]

KERNEL_NAME = "layer_norm_fwd"
_SOURCE = "layer_norm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ln_fwd_torch(x, gamma, beta, eps: float):
    """Plain forward over the last axis of ``[N, F]`` (the reference
    kernel's arithmetic)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if lib.ln_fwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ln_fwd_launch.argtypes = [p] * 4 + [i, i, ctypes.c_float, i, p]
        lib.ln_fwd_launch.restype = ctypes.c_int
        lib.ln_error_string.argtypes = [i]
        lib.ln_error_string.restype = ctypes.c_char_p
    return lib


def ln_fwd(x, gamma, beta, eps: float, impl: str = "auto"):
    """Forward over ``[N, F]``: fp32 or bf16 x on the card; gamma and beta
    of any float dtype, ``[F]``."""
    if _build.pick_impl(impl, x) == "torch":
        return ln_fwd_torch(x, gamma, beta, eps)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel supports float32 and bfloat16, got "
                         f"{x.dtype}")
    if x.dim() != 2 or gamma.shape != (x.shape[1],) \
            or beta.shape != (x.shape[1],):
        raise ValueError(f"x must be [N, F] with gamma and beta [F], got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    # the kernel reads the affine in fp32 (a widening, exact)
    g, b = (t.to(torch.float32).contiguous() for t in (gamma, beta))
    y = torch.empty_like(x)
    for name, t in dict(x=x, gamma=g, beta=b, y=y).items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} (a CUDA device)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    n, f = x.shape
    if n == 0:
        return y
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.ln_fwd_launch(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), n, f,
            float(eps), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} kernel launch failed: "
                           f"{lib.ln_error_string(err).decode()} "
                           f"(cudaError {err})")
    _build.count_launch(KERNEL_NAME)
    return y


class _LayerNorm2d(torch.autograd.Function):
    """LayerNorm over ``[N, F]``: the kernel forward, the reference's
    closed-form backward (``layer_norm.py`` ``_ln_bwd``) in fp32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, impl):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return ln_fwd(x, gamma, beta, eps, impl)

    @staticmethod
    def backward(ctx, dy):
        x2d, gamma = ctx.saved_tensors
        x, g, dyf = x2d.float(), gamma.float(), dy.float()
        mu = x.mean(dim=-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + ctx.eps)
        xhat = xc * inv
        dgamma = (dyf * xhat).sum(dim=0)
        dbeta = dyf.sum(dim=0)
        dxhat = dyf * g
        f = x.shape[-1]
        dx = inv / f * (f * dxhat - dxhat.sum(dim=-1, keepdim=True)
                        - xhat * (dxhat * xhat).sum(dim=-1, keepdim=True))
        return (dx.to(x2d.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None)


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5, impl: str = "auto"):
    """LayerNorm over the last axis, any leading shape, fp32 statistics;
    differentiable in x, gamma and beta. ``impl`` forces the kernel
    ("cuda") or its plain version ("torch"); "auto" picks by device."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).contiguous()
    return _LayerNorm2d.apply(x2d, gamma, beta, float(eps),
                              impl).reshape(shape)
