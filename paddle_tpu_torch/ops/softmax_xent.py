"""Fused softmax cross-entropy, forward and backward: two hand-written
CUDA kernels for Hopper and their plain PyTorch versions.

The counterpart of ``paddle_tpu.ops.pallas.softmax_xent``.
:func:`fused_softmax_cross_entropy` takes logits ``[N, V]`` (fp32 or
bf16) and labels ``[N]`` and returns the fp32 per-row loss
``logsumexp(z) - z[label]``, 0 on ``ignore_index`` rows; it is a
``torch.autograd.Function`` whose forward launches the forward kernel
(loss and lse in one sweep of the vocabulary, the ``[N, V]``
log-softmax never written) and whose backward launches the backward
kernel, ``dz = (exp(z - lse) - onehot(label)) * g`` written in the
logits' dtype (``csrc/softmax_xent.cu``).

Semantics, all as the reference's: a label outside ``[0, V)`` that is
not ``ignore_index`` picks no logit (its loss is the lse); the gradient
of an ``ignore_index`` row is 0.

Each entry point (:func:`xent_fwd`, :func:`xent_bwd`) picks by the
device of its tensors: on a CUDA tensor it launches the kernel or
raises, on a CPU tensor it runs the plain version (their ``impl`` forces
one, for comparisons). Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_softmax_cross_entropy", "supports", "xent_fwd",
           "xent_bwd", "xent_fwd_torch", "xent_bwd_torch", "KERNEL_NAMES"]

KERNEL_NAMES = ("softmax_xent_fwd", "softmax_xent_bwd")
_SOURCE = "softmax_xent"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supports(vocab: int) -> bool:
    """The reference's static gate: any vocabulary of at least 128."""
    return vocab >= 128


# ------------------------------------------------------- plain versions

def xent_fwd_torch(z, labels, ignore_index: int = -100):
    """Plain forward on ``[N, V]``: returns fp32 ``(loss, lse)``."""
    zf = z.float()
    lse = torch.logsumexp(zf, dim=-1)
    lab = labels.long()
    in_vocab = (lab >= 0) & (lab < z.shape[-1])
    picked = zf.gather(-1, torch.where(in_vocab, lab, 0)[:, None])[:, 0]
    loss = lse - torch.where(in_vocab, picked, 0.0)
    return torch.where(lab != ignore_index, loss, 0.0), lse


def xent_bwd_torch(z, labels, lse, g, ignore_index: int = -100):
    """Plain backward: ``dz`` in ``z``'s dtype."""
    lab = labels.long()
    cols = torch.arange(z.shape[-1], device=z.device)
    onehot = (cols[None, :] == lab[:, None]).float()
    gr = torch.where(lab != ignore_index, g.float(), 0.0)
    return ((torch.exp(z.float() - lse[:, None]) - onehot)
            * gr[:, None]).to(z.dtype)


# ------------------------------------------------------------ the kernels

def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if lib.xent_fwd_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xent_fwd_launch.argtypes = [p] * 4 + [i, i, ll, i, p]
        lib.xent_bwd_launch.argtypes = [p] * 5 + [i, i, ll, i, p]
        for fn in (lib.xent_fwd_launch, lib.xent_bwd_launch):
            fn.restype = ctypes.c_int
        lib.xent_error_string.argtypes = [i]
        lib.xent_error_string.restype = ctypes.c_char_p
    return lib


def _check(z, tensors):
    """Raise on what the kernels do not take."""
    if z.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernels support float32 and bfloat16 logits, "
                         f"got {z.dtype}")
    if z.dim() != 2 or z.shape[0] == 0 or z.shape[1] == 0:
        raise ValueError(f"logits must be a non-empty [N, V], got "
                         f"{tuple(z.shape)}")
    want = dict(z=z.dtype, labels=torch.int64, dz=z.dtype)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != z.device:
            raise ValueError(f"{name} must be on {z.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != want.get(name, torch.float32):
            raise ValueError(f"{name} must be {want.get(name, torch.float32)}"
                             f", got {t.dtype}")
        if name not in ("z", "dz") and tuple(t.shape) != (z.shape[0],):
            raise ValueError(f"{name} must be [{z.shape[0]}], got "
                             f"{tuple(t.shape)}")


def _launch(name: str, fn, ptrs, z, ignore_index: int):
    lib = _kernel_lib()
    with torch.cuda.device(z.device):
        err = getattr(lib, fn)(
            *ptrs, z.shape[0], z.shape[1], int(ignore_index),
            _DTYPE_CODES[z.dtype],
            torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.xent_error_string(err).decode()} "
                           f"(cudaError {err})")
    _build.count_launch(name)


def xent_fwd(z, labels, ignore_index: int = -100, impl: str = "auto"):
    """Forward on logits ``[N, V]`` and int64 labels ``[N]``: fp32
    ``(loss, lse)``."""
    if _build.pick_impl(impl, z) == "torch":
        return xent_fwd_torch(z, labels, ignore_index)
    loss = torch.empty(z.shape[:1], dtype=torch.float32, device=z.device)
    lse = torch.empty_like(loss)
    _check(z, dict(z=z, labels=labels, loss=loss, lse=lse))
    _launch(KERNEL_NAMES[0], "xent_fwd_launch",
            [z.data_ptr(), labels.data_ptr(), loss.data_ptr(),
             lse.data_ptr()], z, ignore_index)
    return loss, lse


def xent_bwd(z, labels, lse, g, ignore_index: int = -100,
             impl: str = "auto"):
    """Backward: ``dz`` (``z``'s dtype) from the forward's ``lse`` and the
    fp32 upstream gradient ``g [N]``."""
    if _build.pick_impl(impl, z) == "torch":
        return xent_bwd_torch(z, labels, lse, g, ignore_index)
    dz = torch.empty_like(z)
    _check(z, dict(z=z, labels=labels, lse=lse, g=g, dz=dz))
    _launch(KERNEL_NAMES[1], "xent_bwd_launch",
            [z.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
             dz.data_ptr()], z, ignore_index)
    return dz


# ------------------------------------------------------------- autograd

class _FusedXent(torch.autograd.Function):
    """The reference's ``jax.custom_vjp``: the backward recomputes the
    probabilities from the saved lse."""

    @staticmethod
    def forward(ctx, z, labels, ignore_index):
        loss, lse = xent_fwd(z, labels, ignore_index)
        ctx.save_for_backward(z, labels, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        z, labels, lse = ctx.saved_tensors
        dz = xent_bwd(z, labels, lse, g.float().contiguous(),
                      ctx.ignore_index)
        return dz, None, None


def fused_softmax_cross_entropy(logits, labels, ignore_index: int = -100):
    """``loss[i] = logsumexp(logits[i]) - logits[i, labels[i]]``, fp32,
    zero on ``ignore_index`` rows. ``logits [N, V]`` fp32 or bf16,
    ``labels [N]`` int. Differentiable in ``logits``."""
    return _FusedXent.apply(logits.contiguous(), labels.long().contiguous(),
                            int(ignore_index))
