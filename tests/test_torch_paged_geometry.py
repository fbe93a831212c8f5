"""The paged-attention kernels' geometry against the JAX package's, on the
CPU: every head dim up to 512 and every ``q_tile``.

The kernels are built at head dims 16, 32, 64, 128, 256 and 512; a call at
another head dim runs through ``at_kernel_head_dim``, which zero-pads q and
the pools to the next of them and slices the output back. Here that
wrapper runs the plain twins (what the CUDA launchers hand the kernels,
the kernels replaced by their plain versions) and is held against the JAX
package's XLA references on the same seeded numpy inputs, to 1e-5 in fp32
(the two sum in different orders), at D 16/48/96/256 and q_tile 12/16.
Then the serving side: ``token_step`` on pools padded to the kernel's head
dim equals ``token_step`` on unpadded pools, and the engine serves the
``gpt_tiny`` preset (D = 16) at q_tile 16 token for token with the JAX
engine. The kernels themselves are held to their plain versions at these
shapes on the card in tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.serving as jax_serving
from paddle_tpu.ops.pallas.ragged_paged_attention import (
    ragged_paged_attention_chunked as jax_rpa_chunked,
    ragged_paged_attention_reference)
from paddle_tpu_torch.ops.ragged_paged_attention import (
    at_kernel_head_dim, check_kernel_geometry, kernel_head_dim,
    ragged_paged_attention_chunked_torch, ragged_paged_attention_torch,
    split_plan)
from paddle_tpu_torch.serving import (Engine, EngineConfig, GPTServingModel,
                                      SamplingParams, params_from_jax)
from paddle_tpu_torch.text.models import gpt_tiny

pytestmark = pytest.mark.torch_port

ATOL = 1e-5


def make_step(segs, n_pad, heads, hdim, bs, maxb, tq, seed, num_blocks=24):
    """Seeded numpy inputs of one segmented step: ``segs`` lists (rows,
    pos0) segments laid out consecutively, then ``n_pad`` pad rows that
    point at an inactive segment; pools are noise everywhere."""
    rs = np.random.RandomState(seed)
    n_live = sum(n for n, _ in segs)
    total = n_live + n_pad
    n_seg = len(segs) + 1
    seg_pos = np.zeros(n_seg, np.int32)
    seg_rows = np.zeros(n_seg, np.int32)
    seg_row_idx = np.zeros((n_seg, tq), np.int32)
    row_gather = np.zeros(total, np.int32)
    r = 0
    for s, (n, pos0) in enumerate(segs):
        seg_pos[s], seg_rows[s] = pos0, n
        seg_row_idx[s, :n] = np.arange(r, r + n)
        row_gather[r:r + n] = s * tq + np.arange(n)
        r += n
    row_gather[n_live:] = len(segs) * tq
    f = lambda *shape: rs.randn(*shape).astype(np.float32)
    return (f(total, heads, hdim), f(num_blocks, bs, heads, hdim),
            f(num_blocks, bs, heads, hdim),
            rs.randint(0, num_blocks, (n_seg, maxb)).astype(np.int32),
            seg_pos, seg_rows, seg_row_idx, row_gather), n_live


class Recorder:
    """Wraps a plain twin and records the head dim it was handed."""

    def __init__(self, fn):
        self.fn, self.head_dims = fn, []

    def __call__(self, q, k_pool, v_pool, *args, **kwargs):
        self.head_dims.append((q.shape[-1], k_pool.shape[-1],
                               v_pool.shape[-1]))
        return self.fn(q, k_pool, v_pool, *args, **kwargs)


PAD_CASES = [
    # (segments as (rows, pos0), pad rows, heads, hdim, block, maxb, q_tile)
    ([(12, 3), (1, 20), (5, 0)], 2, 2, 16, 4, 8, 12),
    ([(16, 9), (1, 0), (7, 30)], 1, 2, 48, 8, 6, 16),
    ([(12, 0), (3, 40)], 0, 2, 96, 16, 4, 12),
    ([(16, 17), (1, 5)], 3, 1, 256, 8, 6, 16),
]


@pytest.mark.parametrize("segs,n_pad,heads,hdim,bs,maxb,tq", PAD_CASES)
def test_padded_segmented_call_matches_jax(segs, n_pad, heads, hdim, bs,
                                           maxb, tq):
    """The segmented launcher's padding and q_tile, through the plain
    twin, equal the JAX XLA reference at the unpadded head dim; pad rows
    are exactly zero."""
    args, n_live = make_step(segs, n_pad, heads, hdim, bs, maxb, tq,
                             seed=hdim + tq)
    want = np.asarray(jax.jit(lambda *a: jax_rpa_chunked(*a, impl="xla"))(
        *[jnp.asarray(a) for a in args]))
    plain = Recorder(ragged_paged_attention_chunked_torch)
    got = at_kernel_head_dim(plain, *[torch.from_numpy(a) for a in args],
                             scale=1.0 / hdim ** 0.5).numpy()
    kd = kernel_head_dim(hdim)
    assert plain.head_dims == [(kd, kd, kd)]
    assert got.shape == want.shape == (n_live + n_pad, heads, hdim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    assert np.all(got[n_live:] == 0.0)


@pytest.mark.parametrize("hdim", [16, 48, 96, 256])
def test_padded_row_call_matches_jax(hdim):
    """The per-row launcher's padding, through the plain twin, equals the
    JAX reference; rows of length 0 are exactly zero."""
    rs = np.random.RandomState(hdim)
    lens = np.asarray([0, 1, 17, 40, 9], np.int32)
    heads, bs, maxb, num_blocks = 2, 8, 6, 32
    q = rs.randn(len(lens), heads, hdim).astype(np.float32)
    kp = rs.randn(num_blocks, bs, heads, hdim).astype(np.float32)
    vp = rs.randn(num_blocks, bs, heads, hdim).astype(np.float32)
    tables = rs.randint(0, num_blocks, (len(lens), maxb)).astype(np.int32)
    args = (q, kp, vp, tables, lens)
    want = np.asarray(ragged_paged_attention_reference(
        *[jnp.asarray(a) for a in args]))
    plain = Recorder(ragged_paged_attention_torch)
    got = at_kernel_head_dim(plain, *[torch.from_numpy(a) for a in args],
                             scale=1.0 / hdim ** 0.5).numpy()
    kd = kernel_head_dim(hdim)
    assert plain.head_dims == [(kd, kd, kd)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    assert np.all(got[0] == 0.0)


def test_kernel_geometry_takes_every_head_dim_and_q_tile():
    """Head dims 1..512 pad to the next kernel head dim, any q_tile >= 1 is
    taken; past 512, or a q_tile below 1, raises."""
    pads = {d: kernel_head_dim(d) for d in (1, 16, 17, 48, 96, 128, 129,
                                            200, 256, 300, 512)}
    assert pads == {1: 16, 16: 16, 17: 32, 48: 64, 96: 128, 128: 128,
                    129: 256, 200: 256, 256: 256, 300: 512, 512: 512}
    for d, tq in ((16, 16), (48, 12), (128, 33), (512, 1), (96, 1024)):
        check_kernel_geometry(d, tq)
    with pytest.raises(ValueError, match="head_dim 1..512, got 513"):
        check_kernel_geometry(513, 8)
    with pytest.raises(ValueError, match="head_dim 1..512, got 0"):
        kernel_head_dim(0)
    with pytest.raises(ValueError, match="q_tile >= 1, got 0"):
        check_kernel_geometry(64, 0)


@pytest.mark.parametrize("n_seg,heads,cap,tq,d,want", [
    (16, 16, 2048, 1, 128, (512, 4)),    # a 16-row decode step
    (256, 16, 2048, 8, 128, (2048, 1)),  # 256 segment slots: one split
    (46, 16, 2048, 8, 128, (1024, 2)),   # a mixed step
    (3, 2, 32, 16, 16, (64, 1)),         # a table shorter than a split
    (1, 1, 4096, 1024, 512, (192, 22)),  # workspace-bound: 64 MB
    (256, 16, 40960, 8, 128, (8192, 5)),    # long tables: split-bound
    (1, 1, 1 << 20, 1024, 512, (8192, 128)),  # past 64 MB: split-bound
])
def test_split_plan_is_static_and_bounded(n_seg, heads, cap, tq, d, want):
    """The splits come from static shapes alone: whole 64-token chunks
    covering the table, about TARGET_BLOCKS blocks, at most 8192 positions
    (a split's pool rows sit in the block's shared memory), the splits'
    fp32 states within 64 MB unless that 8192 forbids it."""
    split, n = split_plan(n_seg, heads, cap, tq, d)
    assert (split, n) == want
    assert split % 64 == 0 and split * n >= cap > split * (n - 1)
    assert split <= 8192
    assert n == 1 or split == 8192 or \
        n_seg * heads * n * tq * (d + 2) * 4 <= 64 << 20


# ----------------------------------------------------------- serving

def tiny_weights(rs, n_layers, heads, hdim, ffn, vocab):
    """Seeded per-layer weights in the serving model's layout."""
    e = heads * hdim
    mk = lambda *s: (rs.randn(*s) * 0.25).astype(np.float32)
    layers = [dict(ln_scale=np.ones(e, np.float32),
                   ln_bias=np.zeros(e, np.float32), qkv_w=mk(3, heads, hdim, e),
                   qkv_b=mk(3, heads, hdim), out_w=mk(e, e), out_b=mk(e),
                   ffn_ln_scale=np.ones(e, np.float32),
                   ffn_ln_bias=np.zeros(e, np.float32), ffn1_w=mk(e, ffn),
                   ffn1_b=mk(ffn), ffn2_w=mk(ffn, e), ffn2_b=mk(e))
              for _ in range(n_layers)]
    return mk(vocab, e), mk(e, vocab), layers


def test_token_step_on_padded_pools_matches_unpadded():
    """A model at head dim 48 stepped on pools padded to 64 lanes (as the
    engine allocates them for the kernel) gives the logits of the same
    step on 48-lane pools, writes the same K/V into the first 48 lanes and
    leaves the pad lanes zero."""
    rs = np.random.RandomState(4)
    heads, hdim, n_layers, bs, num_blocks = 2, 48, 2, 4, 16
    emb, head, layers = tiny_weights(rs, n_layers, heads, hdim, 64, 50)
    model = GPTServingModel(emb, head, layers, n_heads=heads,
                            head_dim=hdim, max_position=64, device="cpu")
    # two segments of one sequence (rows 0..5 at positions 7..12, q_tile 4)
    # and a decode row of another at position 9
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    tables = [[3, 5, 1, 8], [3, 5, 1, 8], [2, 9, 11, 4]]
    step = [i32(rs.randint(0, 50, 7)), i32([7, 8, 9, 10, 11, 12, 9]),
            i32(tables), i32([7, 11, 9]), i32([4, 2, 1]),
            i32([[0, 1, 2, 3], [4, 5, 0, 0], [6, 0, 0, 0]]),
            i32([0, 1, 2, 3, 4, 5, 8]), i32([0, 0, 0, 0, 1, 1, 2])]
    pools = [torch.from_numpy(rs.randn(num_blocks, bs, heads, hdim)
                              .astype(np.float32))
             for _ in range(2 * n_layers)]
    padded = [torch.nn.functional.pad(p, (0, 64 - hdim)) for p in pools]
    want = model.token_step(pools[:n_layers], pools[n_layers:], *step)
    got = model.token_step(padded[:n_layers], padded[n_layers:], *step)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    for p, q in zip(padded, pools):
        assert torch.equal(p[..., :hdim], q)
        assert torch.all(p[..., hdim:] == 0)


PROMPTS = [[5, 200, 17, 3] * 9 + [1], [250, 7, 7, 8, 9], list(range(20)),
           [42], list(range(100, 116)), [9, 8, 7] * 10]
TINY_ENGINE = dict(max_slots=4, token_budget=32, block_size=8,
                   num_blocks=64, max_blocks_per_seq=8, q_tile=16)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_gpt_tiny_engine_at_q_tile_16_matches_jax(mode):
    """The ``gpt_tiny`` preset's geometry (E 64, H 4, D 16, V 256, 2
    layers) served at q_tile 16 (prefill segments of 16 rows) with seeded
    weights: the port's engine on the CPU gives the JAX engine's streams
    token for token."""
    cfg = gpt_tiny()
    rs = np.random.RandomState(16)
    hdim = cfg.hidden_size // cfg.num_heads
    emb, head, layers = tiny_weights(rs, cfg.num_layers, cfg.num_heads, hdim,
                                     4 * cfg.hidden_size, cfg.vocab_size)
    kw = dict(n_heads=cfg.num_heads, head_dim=hdim, use_rope=True,
              max_position=cfg.max_position_embeddings)
    jax_model = jax_serving.GPTServingModel(emb, head, layers, **kw)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.params),
                        device="cpu")
    port_model = GPTServingModel(p["embedding"], p["head"], p["layers"],
                                 device="cpu", **kw)

    def params(cls):
        return [cls(max_new_tokens=8,
                    temperature=0.9 if mode == "sampled" and i % 2 else 0.0,
                    top_k=20, seed=7 + i) for i in range(len(PROMPTS))]

    jax_engine = jax_serving.Engine(jax_model,
                                    jax_serving.EngineConfig(**TINY_ENGINE))
    jax_reqs = [jax_engine.submit(pr, sp) for pr, sp in
                zip(PROMPTS, params(jax_serving.SamplingParams))]
    jax_engine.run()
    want = [list(r.output_tokens) for r in jax_reqs]
    engine = Engine(port_model, EngineConfig(**TINY_ENGINE), device="cpu")
    reqs = [engine.submit(pr, sp)
            for pr, sp in zip(PROMPTS, params(SamplingParams))]
    engine.run()
    assert engine._tq == 16
    assert [list(r.output_tokens) for r in reqs] == want
    assert all(len(r.output_tokens) == 8 for r in reqs)
