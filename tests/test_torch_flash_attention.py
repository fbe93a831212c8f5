"""The port's flash attention (paddle_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernels in interpret mode, on the same
seeded inputs.

On the CPU the port runs the kernels' plain versions (forward, dQ, dK/dV)
through its ``torch.autograd.Function``; the JAX side runs the three
Pallas kernels under ``interpret=True``, as tests/test_pallas.py does.
Forward outputs and the q/k/v gradients agree within 2e-5 (fp32; the two
sides sum in different orders), and the dropout keep bits are equal.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_cuda_kernels.py).
"""
import ctypes
import os
import re
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.ops.pallas.flash_attention import supports as jax_supports
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.flash_attention import (KERNEL_NAMES,
                                                  dropout_keep,
                                                  flash_attention, flash_fwd,
                                                  supports)

pytestmark = pytest.mark.torch_port

ATOL = 2e-5

CASES = [
    # (b, sq, sk, h, d, causal, dropout)
    (1, 256, 256, 2, 64, False, 0.0),
    (1, 256, 256, 2, 64, True, 0.0),
    (1, 256, 512, 2, 64, True, 0.0),     # causal offset sk - sq = 256
    (2, 256, 512, 1, 64, False, 0.0),
    (1, 256, 256, 2, 48, True, 0.0),     # D zero-padded to 64
    # in-kernel dropout, seeded. Non-causal: the reference's interpret
    # mode cannot lower the dropout mask's program_id inside its causal
    # branch (pl.when); causal dropout is held kernel-vs-plain on the card.
    (1, 256, 256, 2, 64, False, 0.5),
    # the shapes the 128-row blocks of the card's bf16 kernels stress
    (1, 256, 256, 2, 128, True, 0.0),    # the training path's head dim
    (1, 256, 256, 2, 96, False, 0.0),    # D zero-padded to 128
    (1, 384, 384, 2, 64, True, 0.0),     # an odd count of 128-row tiles
    (1, 256, 384, 2, 64, True, 0.0),     # causal offset 128
    (1, 384, 256, 2, 64, False, 0.0),    # sq > sk, non-causal
    (1, 256, 256, 2, 128, False, 0.3),   # dropout at D = 128
    # head dims past 128: in bf16 the card runs the list kernels of
    # attention_wgmma.cuh at padded D 192 and 256 and its D-split kernels
    # past; in fp32 the 3xTF32 forward and dK/dV of attention_tf32.cuh
    (1, 256, 256, 2, 160, False, 0.0),   # D zero-padded to 192
    (1, 256, 256, 2, 160, True, 0.0),
    (1, 256, 256, 2, 256, False, 0.0),
    (1, 256, 256, 2, 256, True, 0.0),
    (1, 256, 256, 2, 256, False, 0.3),   # dropout at D = 256
    (1, 256, 384, 2, 192, True, 0.0),    # causal offset 128 at D = 192
    # past 256 the card's bf16 forward splits D across two warpgroups
    # (bsa_fwd_dsplit_wgmma_kernel): 192 + 128 columns at D 320
    (1, 256, 256, 1, 320, True, 0.0),
    (1, 128, 256, 1, 512, True, 0.0),    # causal offset 128 at D = 512
]


def _inputs(b, sq, sk, h, d, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, sk, h, d).astype(np.float32)
    v = rs.randn(b, sk, h, d).astype(np.float32)
    g = rs.randn(b, sq, h, d).astype(np.float32)  # output cotangent
    return q, k, v, g


def _float64_attention(q, k, v, g, causal, dropout, seed):
    """out and the q/k/v gradients of ``sum(out * g)`` through a float64
    softmax attention that drops the port's entries, on ``[B, S, H, D]``
    numpy inputs: the exact values both sides round."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q64, k64, v64 = (torch.from_numpy(x).double().requires_grad_(True)
                     for x in (q, k, v))
    qh, kh, vh = (x.transpose(1, 2).reshape(b * h, -1, d)
                  for x in (q64, k64, v64))
    s = qh @ kh.transpose(-1, -2) / d ** 0.5
    if causal:
        rows = torch.arange(sq)[:, None] + (sk - sq)
        s = s.masked_fill(rows < torch.arange(sk)[None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if dropout:
        keep = dropout_keep(seed, b * h, sq, sk, dropout)
        p = torch.where(keep, p / (1.0 - dropout), torch.zeros_like(p))
    out = (p @ vh).reshape(b, h, sq, d).transpose(1, 2)
    (out * torch.from_numpy(g).double()).sum().backward()
    return {"out": out.detach().numpy(), "dq": q64.grad.numpy(),
            "dk": k64.grad.numpy(), "dv": v64.grad.numpy()}


def _miss_report(name, got, want, exact):
    """Where ``got`` (the port) is furthest from ``want`` (the JAX side),
    each side's distance from the float64 value there, and the process
    state a difference between runs of the same inputs could come from:
    thread counts, matmul precisions, XLA flags, denormal flushing, the
    xdist worker."""
    err = np.abs(got - want)
    at = np.unravel_index(int(err.argmax()), err.shape)
    tiny = np.array([1e-38], np.float32)
    return (f"{name} worst at {tuple(int(i) for i in at)}: port {got[at]!r} "
            f"jax {want[at]!r} float64 {exact[at]!r} (port off by "
            f"{abs(got[at] - exact[at]):.3g}, jax by "
            f"{abs(want[at] - exact[at]):.3g}); torch threads "
            f"{torch.get_num_threads()}/{torch.get_num_interop_threads()}, "
            f"torch fp32 matmul {torch.get_float32_matmul_precision()}, "
            f"jax matmul {jax.config.jax_default_matmul_precision}, "
            f"XLA_FLAGS {os.environ.get('XLA_FLAGS')!r}, numpy flushes "
            f"denormals {bool((tiny * np.float32(0.25))[0] == 0)}, torch "
            f"flushes denormals "
            f"{bool((torch.from_numpy(tiny) * 0.25)[0] == 0)}, worker "
            f"{os.environ.get('PYTEST_XDIST_WORKER')}")


@pytest.mark.parametrize("b,sq,sk,h,d,causal,dropout", CASES)
def test_flash_attention_matches_pallas_interpret(b, sq, sk, h, d, causal,
                                                 dropout):
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=sq + sk + d)
    seed = 1234 if dropout else None

    def jax_loss(qa, ka, va):
        out = jax_flash(qa, ka, va, causal=causal, dropout=dropout,
                        seed=seed, interpret=True)
        return jnp.sum(out * g), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    _build.reset_launches()
    got = flash_attention(qt, kt, vt, causal=causal, dropout=dropout,
                          seed=seed)
    (got * torch.from_numpy(g)).sum().backward()
    assert _build.launches() == {}  # CPU tensors: the plain versions ran
    assert got.shape == (b, sq, h, d)
    for name, a, ref in zip(("out", "dq", "dk", "dv"),
                            (got.detach(), qt.grad, kt.grad, vt.grad),
                            (want,) + tuple(grads)):
        a, ref = a.numpy(), np.asarray(ref)
        try:
            np.testing.assert_allclose(a, ref, atol=ATOL, rtol=0)
        except AssertionError as miss:
            exact = _float64_attention(q, k, v, g, causal, dropout,
                                       seed)[name]
            raise AssertionError(
                f"{miss}\n{_miss_report(name, a, ref, exact)}") from None


@pytest.mark.parametrize("seed,rate", [(7, 0.5), (-3, 0.1), (2 ** 31 - 1,
                                                               0.9)])
def test_dropout_keep_bits_equal_the_reference(seed, rate):
    """q = k = 0 makes every probability 1/sk, and v = I makes
    ``out[r, c] = keep[r, c] / (sk * (1 - rate))``: the reference kernel's
    own mask, read back from its output, against the port's."""
    b, h, s = 1, 2, 128
    zeros = np.zeros((b, s, h, s), np.float32)
    eye = np.broadcast_to(np.eye(s, dtype=np.float32)[None, :, None, :],
                          (b, s, h, s)).copy()
    out = np.asarray(jax_flash(zeros, zeros, eye, dropout=rate, seed=seed,
                               interpret=True))
    want = np.swapaxes(out, 1, 2).reshape(b * h, s, s) != 0
    got = dropout_keep(seed, b * h, s, s, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1
    # and the port's forward drops exactly those entries
    port = flash_attention(torch.zeros(b, s, h, s), torch.zeros(b, s, h, s),
                           torch.from_numpy(eye), dropout=rate, seed=seed)
    np.testing.assert_array_equal(
        port.transpose(1, 2).reshape(b * h, s, s).numpy() != 0, want)


TWIN_CASES = [
    # (bh, sq, sk, d, causal, dropout): 64-multiples the reference's gate
    # refuses but the card's kernels take, so only the plain versions
    # they are held to stand for them on the CPU
    (1, 192, 320, 128, False, 0.5),
    (1, 192, 320, 64, True, 0.0),     # causal offset 128
    (2, 64, 192, 64, True, 0.3),      # one 64-row tile, offset 128
    (2, 320, 128, 128, False, 0.0),   # sq > sk, odd count of 64-row tiles
    (1, 128, 128, 64, True, 0.9),
    (3, 64, 64, 128, False, 0.0),
    # the bf16 dQ kernel's geometry: 128-row blocks of two 64-row
    # warpgroups over a K/V ring
    (1, 192, 320, 128, True, 0.0),    # causal, odd count of 64-row tiles
    (1, 512, 512, 64, True, 0.0),     # causal S = 512 at D = 64
    (2, 256, 384, 128, True, 0.2),    # causal dropout, offset 128
    # the bf16 list kernels past D 128: a dQ block of one live 64-row
    # warpgroup, 64-row dK/dV blocks, sq > sk
    (1, 192, 320, 256, True, 0.2),    # odd tile count, offset, dropout
    (2, 320, 128, 192, False, 0.0),   # sq > sk, odd count of 64-row tiles
]


@pytest.mark.parametrize("bh,sq,sk,d,causal,dropout", TWIN_CASES)
def test_plain_versions_match_float64_autograd(bh, sq, sk, d, causal,
                                               dropout):
    """The plain forward, dQ and dK/dV (the card kernels' twins) against
    autograd through a float64 softmax attention that drops the same
    entries: out, lse and the q/k/v gradients."""
    from paddle_tpu_torch.ops.flash_attention import (flash_dkv_torch,
                                                      flash_dq_torch,
                                                      flash_fwd_torch)

    rs = np.random.RandomState(sq + sk + d)
    q, k, v, do = (torch.from_numpy(rs.randn(bh, n, d).astype(np.float32))
                   for n in (sq, sk, sk, sq))
    scale, seed = 1.0 / d ** 0.5, 77
    out, lse = flash_fwd_torch(q, k, v, causal, scale, dropout, seed)
    delta = (do * out).sum(-1)
    dq = flash_dq_torch(q, k, v, do, lse, delta, causal, scale, dropout,
                        seed)
    dk, dv = flash_dkv_torch(q, k, v, do, lse, delta, causal, scale,
                             dropout, seed)

    q64, k64, v64 = (x.double().requires_grad_(True) for x in (q, k, v))
    s = q64 @ k64.transpose(-1, -2) * scale
    if causal:
        rows = torch.arange(sq)[:, None] + (sk - sq)
        s = s.masked_fill(rows < torch.arange(sk)[None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if dropout:
        keep = dropout_keep(seed, bh, sq, sk, dropout)
        p = torch.where(keep, p / (1.0 - dropout), torch.zeros_like(p))
    want = p @ v64
    want.backward(do.double())
    np.testing.assert_allclose(out.numpy(), want.detach().numpy(),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(s, -1).detach().numpy(),
                               atol=2e-5, rtol=0)
    for got, ref in ((dq, q64), (dk, k64), (dv, v64)):
        np.testing.assert_allclose(got.numpy(), ref.grad.numpy(), atol=1e-4,
                                   rtol=0)


def test_supports_is_the_reference_gate():
    for args in [(1024, 1024, 128, False), (512, 512, 80, False),
                 (512, 256, 128, False), (256, 512, 128, True),
                 (1000, 1000, 128, False), (512, 512, 640, False),
                 (512, 256, 128, True), (384, 384, 64, True),
                 (128, 128, 1, False), (64, 64, 64, False)]:
        assert supports(*args) == jax_supports(*args[:3], causal=args[3])


def test_dropout_needs_a_seed():
    x = torch.zeros(1, 128, 1, 64)
    with pytest.raises(ValueError, match="explicit seed"):
        flash_attention(x, x, x, dropout=0.1)


@pytest.mark.parametrize("entry", ["fa_fwd_launch", "fa_dq_launch",
                                   "fa_dkv_launch"])
def test_signatures_match_the_c_entries(entry):
    """The ctypes signature the wrapper sets is the C entry's in
    ``csrc/flash_attention.cu``, slot by slot."""
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int": ctypes.c_int, "float": ctypes.c_float,
               "unsigned": ctypes.c_uint32}
    text = (_build.CSRC / "flash_attention.cu").read_text()
    decl = re.search(r"\bint " + entry + r"\((.*?)\)\s*\{", text, re.S)
    want = [c_types[" ".join(arg.split()).rsplit(" ", 1)[0]]
            for arg in decl.group(1).split(",")]
    lib = types.SimpleNamespace(**{
        name: types.SimpleNamespace(argtypes=None, restype=None)
        for name in ("fa_fwd_launch", "fa_dq_launch", "fa_dkv_launch",
                     "fa_error_string")})
    fa.set_signatures(lib)
    assert getattr(lib, entry).argtypes == want
    assert getattr(lib, entry).restype is ctypes.c_int


def test_kernel_route_raises_without_a_card():
    """``impl="cuda"`` on CPU tensors does not run the plain version: it
    raises (the kernel path checks its tensors first)."""
    x = torch.zeros(2, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(x, x, x, causal=True, scale=0.125, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        flash_fwd(x, x, x, causal=True, scale=0.125, impl="xla")
    assert KERNEL_NAMES == ("flash_attention_fwd", "flash_attention_dq",
                            "flash_attention_dkv")
