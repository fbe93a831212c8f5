"""The port's fused LayerNorm (paddle_tpu_torch.ops.layer_norm) against
the JAX package's Pallas kernel in interpret mode, on the same seeded
inputs.

On the CPU the port runs the kernel's plain version and the reference's
closed-form backward; the JAX side runs ``fused_layer_norm(...,
interpret=True)``, as tests/test_pallas.py does. The CUDA kernel itself is
held against the plain version on the card
(tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import fused_layer_norm as jax_fused_layer_norm
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.layer_norm import fused_layer_norm, ln_fwd

pytestmark = pytest.mark.torch_port

ATOL = 2e-5  # fp32: the same arithmetic reduced in another order


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    f = shape[-1]
    return (rs.randn(*shape).astype(np.float32) * 2 + 0.5,
            rs.randn(f).astype(np.float32), rs.randn(f).astype(np.float32))


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp of max |x|: 2^(exponent - 7)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


@pytest.mark.parametrize("shape", [(2, 48, 256), (3, 5, 2101), (1, 8, 64)])
def test_forward_and_grads_match_pallas_interpret(shape):
    """fp32 forward and the gradients of sum(out**3) in x, gamma, beta
    (as tests/test_pallas.py differentiates the reference), within 2e-5
    relative to max(1, max |reference|)."""
    x, g, b = _inputs(shape, seed=shape[-1])

    def jax_loss(xa, ga, ba):
        out = jax_fused_layer_norm(xa, ga, ba, interpret=True)
        return jnp.sum(out ** 3), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(x, g, b)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, g, b)]
    _build.reset_launches()
    out = fused_layer_norm(*ts)
    (out ** 3).sum().backward()
    assert _build.launches() == {}  # a CPU tensor: the plain version ran
    assert out.shape == shape and out.dtype == torch.float32
    for got, ref in [(out.detach().numpy(), want)] + [
            (t.grad.numpy(), r) for t, r in zip(ts, grads)]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("shape", [(2, 16, 2048), (4, 3, 200)])
def test_bf16_forward_within_one_ulp(shape):
    """bf16 x (fp32 statistics and affine inside, output cast to bf16):
    every element within one bf16 ulp of max |reference|."""
    x, g, b = _inputs(shape, seed=7)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_fused_layer_norm(xb, g, b, interpret=True)
                      .astype(jnp.float32))
    got = fused_layer_norm(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(want))


def test_bf16_grads_within_one_ulp():
    """bf16 x and affine through autograd: dx, dgamma and dbeta (cast to
    the parameters' dtype, as the reference casts them) within one bf16
    ulp of max |reference|."""
    x, g, b = _inputs((2, 4, 128), seed=3)
    xb, gb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (x, g, b))
    grads = jax.grad(lambda *a: jnp.sum(jax_fused_layer_norm(
        *a, interpret=True).astype(jnp.float32) ** 3),
        argnums=(0, 1, 2))(xb, gb, bb)
    ts = [torch.from_numpy(a).bfloat16().requires_grad_(True)
          for a in (x, g, b)]
    (fused_layer_norm(*ts).float() ** 3).sum().backward()
    for t, ref in zip(ts, grads):
        ref = np.asarray(ref.astype(jnp.float32))
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), ref, rtol=0,
                                   atol=_bf16_ulp(ref))


def test_kernel_route_raises_without_a_card():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ln_fwd(x, torch.ones(64), torch.zeros(64), 1e-5, impl="cuda")
