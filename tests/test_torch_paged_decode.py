"""The port's per-row (decode) ragged paged attention against the JAX
package's.

The plain PyTorch version (what ``ragged_paged_attention`` runs on a CPU
tensor) is held against ``paddle_tpu``'s Pallas kernel ``_rpa_pallas`` in
interpret mode and its XLA reference ``ragged_paged_attention_reference``
on the same seeded numpy inputs, to 1e-5 in fp32 (the two sum in
different orders). Every batch scatters each row's blocks through a pool
whose background is noise, and pads the tables with block 0, a noise
block, so a read of a foreign or masked block shows. Rows of length 0 (or
below) must come back exactly zero on both sides. The CUDA kernel itself
is compared with the plain version on the card in
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas.ragged_paged_attention import (
    _rpa_pallas, ragged_paged_attention_reference)
from paddle_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_chunked_torch,
    ragged_paged_attention_torch)

pytestmark = pytest.mark.torch_port

ATOL = 1e-5

# the JAX package's own cases (tests/test_ragged_paged_attention.py):
# (lens, heads, head_dim, block_size, max_blocks)
CASES = [
    ([1, 7, 0, 24, 13], 2, 16, 4, 6),            # empty row, partial blocks
    ([5, 5, 5, 5], 4, 8, 8, 2),                  # uniform, partial blocks
    ([32, 1, 16, 9, 0, 0, 3, 31], 2, 32, 16, 2),  # full tables + empties
    ([2], 1, 64, 2, 4),                          # single row
]


def build_paged(seed, lens, heads, hdim, bs, maxb, num_blocks=64):
    """Seeded inputs: each row's blocks drawn without replacement from
    blocks 1.. of a noise pool; table entries past a row's need stay 0,
    itself a noise block that no row owns."""
    rs = np.random.RandomState(seed)
    n = len(lens)
    q = rs.randn(n, heads, hdim).astype(np.float32)
    k_pool = rs.randn(num_blocks, bs, heads, hdim).astype(np.float32)
    v_pool = rs.randn(num_blocks, bs, heads, hdim).astype(np.float32)
    tables = np.zeros((n, maxb), np.int32)
    free = list(range(1, num_blocks))
    for s, length in enumerate(lens):
        for j in range(min(-(-max(int(length), 0) // bs), maxb)):
            tables[s, j] = free.pop(rs.randint(len(free)))
    return q, k_pool, v_pool, tables, np.asarray(lens, np.int32)


def jax_pallas(args, scale):
    return np.asarray(_rpa_pallas(*[jnp.asarray(a) for a in args], scale,
                                  interpret=True))


def jax_xla(args, scale=None):
    return np.asarray(ragged_paged_attention_reference(
        *[jnp.asarray(a) for a in args], scale=scale))


def port(args, **kwargs):
    return ragged_paged_attention(
        *[torch.from_numpy(a) for a in args], **kwargs).numpy()


def _check(got, want, lens):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    dead = np.asarray(lens) <= 0
    assert np.all(got[dead] == 0.0) and np.all(want[dead] == 0.0)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("lens,heads,hdim,bs,maxb", CASES)
def test_plain_matches_pallas_interpret(lens, heads, hdim, bs, maxb):
    args = build_paged(len(lens) * 100 + hdim, lens, heads, hdim, bs, maxb)
    _check(port(args), jax_pallas(args, 1.0 / hdim ** 0.5), lens)


@pytest.mark.parametrize("lens,heads,hdim,bs,maxb", CASES)
def test_plain_matches_xla_reference(lens, heads, hdim, bs, maxb):
    args = build_paged(len(lens) * 100 + hdim + 1, lens, heads, hdim, bs,
                       maxb)
    _check(port(args), jax_xla(args), lens)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_lengths_past_the_end_and_below_zero(jax_impl):
    """A length above MAXB * B attends the whole table (both JAX paths
    clamp: the grid walks MAXB blocks, the reference masks MAXB * B
    positions); a negative length is an inactive row."""
    lens = [3, 40, -5, 24, 0, 1000]
    args = build_paged(3, lens, 2, 16, 4, 6)
    want = (jax_xla(args) if jax_impl == "xla"
            else jax_pallas(args, 1.0 / 16 ** 0.5))
    got = port(args)
    _check(got, want, lens)
    full = list(args[:4]) + [np.asarray([3, 24, 0, 24, 0, 24], np.int32)]
    np.testing.assert_array_equal(got[[1, 5]], port(full)[[1, 5]])


def test_bf16_matches_jax_reference_in_bf16():
    """bf16 q and pools give a bf16 output within 2e-2 x max(1, max |ref|)
    of the JAX reference run on the same bf16 values."""
    lens = [1, 7, 0, 24, 13, 19]
    args = build_paged(11, lens, 2, 32, 4, 6)
    t = [torch.from_numpy(a) for a in args]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    got = ragged_paged_attention(*t)
    assert got.dtype == torch.bfloat16
    as_bf16 = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
               for x in t[:3]]
    want = np.asarray(ragged_paged_attention_reference(
        *as_bf16, jnp.asarray(args[3]),
        jnp.asarray(args[4]))).astype(np.float32)
    got = got.float().numpy()
    limit = 2e-2 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= limit
    assert np.all(got[2] == 0.0)


def test_routing_and_scale():
    """``auto`` on CPU tensors is the plain version; the JAX routes
    ``pallas``/``xla`` and ``cuda`` on CPU tensors raise (no silent
    fallback); ``scale`` is honoured."""
    lens = [0, 6, 11]
    args = build_paged(7, lens, 2, 8, 4, 3, num_blocks=16)
    t = [torch.from_numpy(a) for a in args]
    assert torch.equal(ragged_paged_attention(*t),
                       ragged_paged_attention_torch(*t))
    for impl in ("pallas", "xla"):
        with pytest.raises(ValueError, match="impl"):
            ragged_paged_attention(*t, impl=impl)
    with pytest.raises(ValueError, match="CUDA"):
        ragged_paged_attention(*t, impl="cuda")
    scaled = port(args, scale=0.01)
    _check(scaled, jax_xla(args, scale=0.01), lens)
    assert not np.allclose(scaled[1:], port(args)[1:], atol=1e-3)


def test_empty_batch():
    args = build_paged(0, [], 2, 8, 4, 3, num_blocks=8)
    assert port(args).shape == (0, 2, 8)


@pytest.mark.parametrize("lens,heads,hdim,bs,maxb", CASES)
def test_per_row_equals_chunked_at_one_row_segments(lens, heads, hdim, bs,
                                                    maxb):
    """Every row given as its own 1-row segment (TQ = 1, seg_pos =
    len - 1) through the chunked plain version gives the per-row plain
    version's output; rows of length 0 are inactive segments."""
    q, kp, vp, tables, lens_np = build_paged(len(lens) + hdim, lens, heads,
                                             hdim, bs, maxb)
    n = len(lens)
    seg_pos = np.maximum(lens_np - 1, 0).astype(np.int32)
    seg_rows = (lens_np > 0).astype(np.int32)
    seg_row_idx = np.arange(n, dtype=np.int32)[:, None]
    row_gather = np.arange(n, dtype=np.int32)
    t = lambda a: torch.from_numpy(a)
    chunked = ragged_paged_attention_chunked_torch(
        t(q), t(kp), t(vp), t(tables), t(seg_pos), t(seg_rows),
        t(seg_row_idx), t(row_gather)).numpy()
    per_row = ragged_paged_attention_torch(t(q), t(kp), t(vp), t(tables),
                                           t(lens_np)).numpy()
    _check(per_row, chunked, lens)
