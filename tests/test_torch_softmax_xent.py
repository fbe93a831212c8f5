"""The port's fused softmax cross-entropy (paddle_tpu_torch.ops.softmax_xent)
and its route in ``cross_entropy`` against the JAX package's, on the same
seeded inputs.

On the CPU the port runs the kernels' plain versions (forward, backward)
through its ``torch.autograd.Function``; the JAX side runs the two Pallas
kernels under ``interpret=True``, as tests/test_pallas.py does. Per-row
losses and the logits' gradient agree within 1e-5 in fp32 (the two sides
sum the vocabulary in different orders; measured 2e-6); with bf16
logits the losses agree within 1e-5 and the bf16 gradients within one
bf16 ulp (2**-7 relative: two fp32 values a hair apart can round to
neighbouring bf16 values; measured 7.6e-3). ``-s`` prints the
readings. The CUDA kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jax_F
from paddle_tpu.ops.pallas import softmax_xent as jax_xent
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.softmax_xent import (fused_softmax_cross_entropy,
                                               xent_fwd)

pytestmark = pytest.mark.torch_port

CASES = [
    # (rows, vocab, dtype): rows pad to 128 on the reference's side; 2100
    # is a ragged vocabulary (masked final block there)
    (200, 2048, "float32"),
    (130, 2100, "float32"),
    (128, 2048, "bfloat16"),
]


def _inputs(n, v, seed):
    rs = np.random.RandomState(seed)
    z = (rs.randn(n, v) * 3).astype(np.float32)
    labels = rs.randint(0, v, n).astype(np.int64)
    labels[[1, 5]] = -100   # ignore_index rows: loss 0, gradient 0
    labels[7] = -5          # outside the vocabulary: picks no logit
    w = rs.randn(n).astype(np.float32)  # upstream gradient of each row
    return z, labels, w


@pytest.mark.parametrize("n,v,dtype", CASES)
def test_fused_xent_matches_pallas_interpret(n, v, dtype):
    z, labels, w = _inputs(n, v, seed=n + v)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)

    def jax_loss(za):
        loss = jax_xent.fused_softmax_cross_entropy(
            za, jnp.asarray(labels, jnp.int32), interpret=True)
        return jnp.sum(loss * jnp.asarray(w)), loss

    (_, want_loss), want_dz = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(z, jdt))
    zt = torch.from_numpy(z).to(tdt).requires_grad_(True)
    _build.reset_launches()
    loss = fused_softmax_cross_entropy(zt, torch.from_numpy(labels))
    (loss * torch.from_numpy(w)).sum().backward()
    assert _build.launches() == {}  # CPU: the kernels' plain versions
    assert loss.dtype == torch.float32 and zt.grad.dtype == tdt
    np.testing.assert_allclose(loss.detach().numpy(),
                               np.asarray(want_loss), rtol=0, atol=1e-5)
    assert (loss[[1, 5]] == 0).all() and (zt.grad[[1, 5]] == 0).all()
    got = zt.grad.float().numpy()
    want = np.asarray(want_dz, np.float32)
    diff = np.abs(got - want)
    print(f"{dtype} {n}x{v}: loss max abs err "
          f"{np.abs(loss.detach().numpy() - np.asarray(want_loss)).max():.2e}"
          f", dz max abs err {diff.max():.2e}, max relative "
          f"{(diff / np.maximum(np.abs(want), 1e-30)).max():.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_fused_xent_forward_returns_the_lse():
    z, labels, _ = _inputs(16, 256, seed=3)
    loss, lse = xent_fwd(torch.from_numpy(z), torch.from_numpy(labels))
    want = torch.logsumexp(torch.from_numpy(z).double(), -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6)
    assert loss.dtype == lse.dtype == torch.float32


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_fused_route_matches_jax(monkeypatch, reduction):
    """At V >= 2048 the port's ``cross_entropy`` takes the fused route; on
    the CPU the JAX package takes its plain composition, the same math."""
    z, labels, _ = _inputs(64, 2048, seed=11)
    labels[7] = 0  # the reference's plain route needs labels in range
    want = jax_F.cross_entropy(paddle.to_tensor(z), paddle.to_tensor(labels),
                               reduction=reduction)
    calls = []
    real = F.loss.fused_softmax_cross_entropy

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(F.loss, "fused_softmax_cross_entropy", spy)
    got = F.cross_entropy(torch.from_numpy(z), torch.from_numpy(labels),
                          reduction=reduction)
    assert calls == [(64, 2048)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=1e-5)


def test_cross_entropy_fused_route_keeps_the_logits_dtype():
    """The reference hands the fused loss back in the logits' dtype, so
    bf16 logits give a bf16 loss; it is the mean over valid rows."""
    z, labels, _ = _inputs(32, 2048, seed=12)
    zt = torch.from_numpy(z).bfloat16()
    got = F.cross_entropy(zt, torch.from_numpy(labels))
    per_row = F.cross_entropy(zt, torch.from_numpy(labels),
                              reduction="none")
    assert got.dtype == per_row.dtype == torch.bfloat16
    valid = labels != -100
    torch.testing.assert_close(got, per_row.sum() / int(valid.sum()))


def test_routing_predicate_is_the_reference_gate():
    """``would_use_fused_xent`` is the reference's predicate with
    ``FLAGS_use_pallas_softmax_xent`` on and without its backend test (the
    device, not the predicate, picks kernel or plain version)."""
    from paddle_tpu.core.flags import flag
    from paddle_tpu.ops.pallas.softmax_xent import supports as gate

    assert flag("FLAGS_use_pallas_softmax_xent")  # the reference's default
    for n in (256, 2047, 2048, 2100, 30522, 50304):
        for soft, ax, use_sm, ls, w in [
                (False, -1, True, 0.0, False), (True, -1, True, 0.0, False),
                (False, 0, True, 0.0, False), (False, -1, False, 0.0, False),
                (False, -1, True, 0.1, False), (False, -1, True, 0.0, True)]:
            want = (not soft and ax == -1 and use_sm and ls == 0 and not w
                    and n >= 2048 and gate(n))
            assert F.would_use_fused_xent(n, soft, ax, use_sm, ls, w) == want
