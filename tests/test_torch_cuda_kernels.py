"""The port's CUDA kernels on the card, against their plain versions.

A hand-written kernel has no CPU mode, so every test here needs a CUDA
card and skips without one. The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.ragged_paged_attention import (
    KERNEL_NAME, ragged_paged_attention_chunked)

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# ||got - want|| / ||want||: a few times what a right kernel reads at
# bf16 (its outputs differ from the plain version's by bf16 roundings of
# single elements) and far below what a kernel that skips one tile reads
# (test_flash_limits_reject_a_kernel_that_skips_a_tile)
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def step_inputs(segs, n_pad, heads, hdim, bs, maxb, tq, num_blocks, dtype,
                device, seed):
    """(rows, pos0) segments laid out consecutively, then ``n_pad`` rows
    pointing at an inactive segment; pools are noise everywhere."""
    rs = np.random.RandomState(seed)
    n_live = sum(n for n, _ in segs)
    total = n_live + n_pad
    n_seg = len(segs) + 2
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
    f = lambda *shape: torch.from_numpy(
        rs.randn(*shape).astype(np.float32)).to(device, dtype)
    i = lambda a: torch.from_numpy(a).to(device)
    tables = rs.randint(0, num_blocks, (n_seg, maxb)).astype(np.int32)
    return (f(total, heads, hdim), f(num_blocks, bs, heads, hdim),
            f(num_blocks, bs, heads, hdim), i(tables), i(seg_pos),
            i(seg_rows), i(seg_row_idx), i(row_gather)), n_live


MIXES = [
    # (segments as (rows, pos0), pad rows, heads, hdim, block, maxb, q_tile)
    ([(4, 0), (1, 9), (3, 5)], 2, 2, 32, 4, 4, 4),
    ([(1, 0), (1, 2047)], 0, 16, 128, 16, 128, 8),
    ([(8, 13), (8, 21), (1, 47), (5, 3)], 4, 4, 64, 16, 4, 8),
    ([(8, 1000), (8, 1008), (1, 1500)], 3, 16, 128, 64, 32, 8),  # big smem
    ([(1, 63)], 5, 1, 128, 4, 16, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("segs,n_pad,heads,hdim,bs,maxb,tq", MIXES)
def test_kernel_matches_plain(card, segs, n_pad, heads, hdim, bs, maxb, tq,
                              dtype):
    args, n_live = step_inputs(segs, n_pad, heads, hdim, bs, maxb, tq,
                               num_blocks=64, dtype=dtype, device=card,
                               seed=hdim + tq)
    before = _build.launches().get(KERNEL_NAME, 0)
    got = ragged_paged_attention_chunked(*args)  # auto -> cuda on the card
    want = ragged_paged_attention_chunked(*args, impl="torch")
    torch.cuda.synchronize()
    assert _build.launches()[KERNEL_NAME] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.all(got[n_live:] == 0)


def test_kernel_rejects_what_it_does_not_take(card):
    args, _ = step_inputs([(2, 3)], 1, 2, 32, 4, 4, 4, num_blocks=8,
                          dtype=torch.float32, device=card, seed=1)
    q, kp, vp, *meta = args
    with pytest.raises(ValueError, match="contiguous"):
        ragged_paged_attention_chunked(q.transpose(0, 1).contiguous()
                                       .transpose(0, 1), kp, vp, *meta)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        ragged_paged_attention_chunked(q.half(), kp.half(), vp.half(), *meta)
    with pytest.raises(ValueError, match="share a dtype"):
        ragged_paged_attention_chunked(q, kp.bfloat16(), vp.bfloat16(),
                                       *meta)
    with pytest.raises(ValueError, match="int32"):
        ragged_paged_attention_chunked(q, kp, vp, meta[0].long(), *meta[1:])
    small = [t[..., :16].contiguous() for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="head_dim"):
        ragged_paged_attention_chunked(*small, *meta)


def test_engine_kernel_path_matches_plain_path(card):
    """A small fp32 model served through the kernel and through the plain
    attention gives the same greedy streams, and the kernel ran once per
    layer per step."""
    from paddle_tpu_torch.serving import (Engine, EngineConfig,
                                          GPTServingModel, SamplingParams)

    rs = np.random.RandomState(0)
    e, h, d, ffn, vocab, n_layers = 64, 2, 32, 128, 100, 2
    mk = lambda *s: (rs.randn(*s) * 0.2).astype(np.float32)
    layers = [dict(ln_scale=np.ones(e, np.float32),
                   ln_bias=np.zeros(e, np.float32), qkv_w=mk(3, h, d, e),
                   out_w=mk(e, e), ffn_ln_scale=np.ones(e, np.float32),
                   ffn_ln_bias=np.zeros(e, np.float32), ffn1_w=mk(e, ffn),
                   ffn2_w=mk(ffn, e)) for _ in range(n_layers)]
    model = GPTServingModel(mk(vocab, e), mk(e, vocab), layers, n_heads=h,
                            head_dim=d, max_position=256)
    prompts = [list(rs.randint(0, vocab, n)) for n in (3, 17, 40, 1, 9)]
    outs = {}
    for attention in ("cuda", "torch"):
        engine = Engine(model, EngineConfig(
            max_slots=4, token_budget=16, block_size=8, num_blocks=64,
            max_blocks_per_seq=16, attention=attention))
        _build.reset_launches()
        outs[attention] = engine.generate(
            prompts, SamplingParams(max_new_tokens=8))
        steps = _build.launches().get(KERNEL_NAME, 0)
        if attention == "cuda":
            assert steps > 0 and steps % n_layers == 0
        else:
            assert steps == 0
        assert engine.kv.blocks_in_use == 0
    assert outs["cuda"] == outs["torch"]


# ------------------------------------------------------- flash attention

FLASH_CASES = [
    # (bh, sq, sk, d, causal, dropout)
    (2, 128, 128, 64, False, 0.0),
    (3, 256, 256, 128, True, 0.0),
    (2, 128, 384, 128, True, 0.0),    # causal offset sk - sq = 256
    (2, 256, 128, 64, False, 0.0),    # sq > sk, non-causal
    (2, 256, 256, 64, True, 0.3),     # causal dropout
    (1, 192, 320, 128, False, 0.5),   # 64-multiples the gate would refuse
]


def flash_inputs(bh, sq, sk, d, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda s: torch.randn(bh, s, d, generator=g, device=device).to(dtype)
    return r(sq), r(sk), r(sk), r(sq)


def rel_err(got, want) -> float:
    """``||got - want|| / ||want||`` over all elements, in fp32."""
    diff = (got.float() - want.float()).norm()
    return (diff / want.float().norm().clamp_min(1e-30)).item()


def _close(got, want, dtype):
    """Within REL_TOL of the plain version in relative norm, and every
    element within TOL relative to max(1, max |plain|)."""
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert err <= TOL[dtype] * scale, (err, scale)
    assert rel_err(got, want) <= REL_TOL[dtype], rel_err(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal,dropout", FLASH_CASES)
def test_flash_kernels_match_plain(card, bh, sq, sk, d, causal, dropout,
                                   dtype):
    from paddle_tpu_torch.ops.flash_attention import (KERNEL_NAMES,
                                                      flash_dkv, flash_dq,
                                                      flash_fwd)

    q, k, v, do = flash_inputs(bh, sq, sk, d, dtype, card, seed=sq + d)
    args = (causal, 1.0 / d ** 0.5, dropout, 99)
    _build.reset_launches()
    out, lse = flash_fwd(q, k, v, *args)
    want_out, want_lse = flash_fwd(q, k, v, *args, impl="torch")
    _close(out, want_out, dtype)
    _close(lse, want_lse, torch.float32)
    delta = (do.float() * want_out.float()).sum(-1)
    _close(flash_dq(q, k, v, do, want_lse, delta, *args),
           flash_dq(q, k, v, do, want_lse, delta, *args, impl="torch"),
           dtype)
    got = flash_dkv(q, k, v, do, want_lse, delta, *args)
    want = flash_dkv(q, k, v, do, want_lse, delta, *args, impl="torch")
    for a, b in zip(got, want):
        _close(a, b, dtype)
    torch.cuda.synchronize()
    assert _build.launches() == {name: 1 for name in KERNEL_NAMES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_runs_the_kernels(card, dtype, monkeypatch):
    import paddle_tpu_torch.ops.flash_attention as fa

    g = torch.Generator(device=card).manual_seed(3)
    x = [torch.randn(2, 256, 4, 48, generator=g, device=card).to(dtype)
         .requires_grad_(True) for _ in range(3)]
    grads = {}
    for impl in ("cuda", "torch"):
        # every kernel entry point takes the route ``impl``
        monkeypatch.setattr(_build, "pick_impl", lambda _, t, i=impl: i)
        _build.reset_launches()
        out = fa.flash_attention(*x, causal=True)
        grads[impl] = torch.autograd.grad(out.square().sum(), x)
        counts = _build.launches()
        assert counts == ({n: 1 for n in fa.KERNEL_NAMES}
                          if impl == "cuda" else {})
    for a, b in zip(grads["cuda"], grads["torch"]):
        _close(a, b, dtype)


def test_flash_kernels_reject_what_they_do_not_take(card):
    from paddle_tpu_torch.ops.flash_attention import flash_fwd

    q, k, v, _ = flash_inputs(1, 128, 128, 64, torch.float32, card, 0)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                  v[..., :32].contiguous(), False, 0.125)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        flash_fwd(q.half(), k.half(), v.half(), False, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                  False, 0.125)
    with pytest.raises(ValueError, match="multiples"):
        flash_fwd(q[:, :96].contiguous(), k, v, False, 0.125)


MUTATIONS = {
    # kind: (kernel, loop it walks, the loop with one tile left out)
    "fwd": ("fa_fwd_mma_kernel", "for (int t = 0; t <= last; ++t) {",
            "for (int t = (last > 0); t <= last; ++t) {"),
    "dq": ("fa_dq_mma_kernel", "for (int t = 0; t <= last; ++t) {",
           "for (int t = (last > 0); t <= last; ++t) {"),
    "dkv": ("fa_dkv_mma_kernel",
            "for (int r0 = 0; r0 < sq; r0 += kQTileKV) {",
            "for (int r0 = 0; r0 < sq - kQTileKV; r0 += kQTileKV) {"),
}


def _mutated_source(kernel: str, loop: str, broken: str) -> str:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    at = src.index(loop, src.index(kernel + "("))
    return src[:at] + broken + src[at + len(loop):]


def _flash_case(kind, q, k, v, do, args, impl=None):
    from paddle_tpu_torch.ops.flash_attention import (flash_dkv, flash_dq,
                                                      flash_fwd)

    kw = {} if impl is None else dict(impl=impl)
    if kind == "fwd":
        return flash_fwd(q, k, v, *args, **kw)[0]
    out, lse = flash_fwd(q, k, v, *args, impl="torch")
    delta = (do.float() * out.float()).sum(-1)
    if kind == "dq":
        return flash_dq(q, k, v, do, lse, delta, *args, **kw)
    return torch.cat(flash_dkv(q, k, v, do, lse, delta, *args, **kw))


def test_flash_limits_reject_a_kernel_that_skips_a_tile(card, tmp_path,
                                                       monkeypatch):
    """The bf16 limits tell a right kernel from a broken one: each
    tensor-core kernel is rebuilt with one tile of its loop left out (kv
    tile 0 for the forward and dQ, the last q tile for dK/dV), and at the
    training path's sequence length and head size its result must miss
    REL_TOL, while the right kernel meets it. Prints both readings."""
    import ctypes
    import subprocess

    q, k, v, do = flash_inputs(8, 1024, 1024, 128, torch.bfloat16, card,
                               seed=17)
    args = (True, 1.0 / 128 ** 0.5, 0.0, 0)
    want = {kind: _flash_case(kind, q, k, v, do, args, impl="torch")
            for kind in MUTATIONS}
    right = {kind: rel_err(_flash_case(kind, q, k, v, do, args), want[kind])
             for kind in MUTATIONS}
    procs = {}
    for kind, (kernel, loop, broken) in MUTATIONS.items():
        src = tmp_path / f"{kind}.cu"
        src.write_text(_mutated_source(kernel, loop, broken))
        lib = tmp_path / f"lib{kind}.so"
        procs[kind] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    broken_err = {}
    for kind, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out.decode()[-2000:]
        monkeypatch.setitem(_build._LIBS, "flash_attention",
                            ctypes.CDLL(str(lib)))
        broken_err[kind] = rel_err(_flash_case(kind, q, k, v, do, args),
                                   want[kind])
    print(f"flash bf16 rel err, right kernels: {right}; kernels missing "
          f"one tile: {broken_err}; limit {REL_TOL[torch.bfloat16]}")
    for kind in MUTATIONS:
        assert right[kind] <= REL_TOL[torch.bfloat16] < broken_err[kind]


# ----------------------------------------------- softmax cross-entropy

XENT_CASES = [
    # (rows, vocab): 16-byte vector rows, a ragged vocabulary the vectors
    # cannot cover (scalar sweep), and the training path's vocabulary
    (300, 2048),
    (67, 2101),
    (64, 50304),
]


def xent_inputs(n, v, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    z = (torch.randn(n, v, generator=g, device=device) * 3).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=device)
    labels[1] = -100   # ignore_index: loss 0, gradient 0
    labels[2] = -7     # outside the vocabulary: picks no logit
    labels[3] = v - 1
    grad = torch.randn(n, generator=g, device=device)
    return z, labels, grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", XENT_CASES)
def test_xent_kernels_match_plain(card, n, v, dtype):
    from paddle_tpu_torch.ops.softmax_xent import (KERNEL_NAMES, xent_bwd,
                                                   xent_fwd)

    z, labels, g = xent_inputs(n, v, dtype, card, seed=n + v)
    _build.reset_launches()
    loss, lse = xent_fwd(z, labels)
    want_loss, want_lse = xent_fwd(z, labels, impl="torch")
    _close(loss, want_loss, torch.float32)
    _close(lse, want_lse, torch.float32)
    assert loss[1].item() == 0.0
    dz = xent_bwd(z, labels, want_lse, g)
    _close(dz, xent_bwd(z, labels, want_lse, g, impl="torch"), dtype)
    assert (dz[1] == 0).all()
    torch.cuda.synchronize()
    assert _build.launches() == {name: 1 for name in KERNEL_NAMES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_runs_the_xent_kernels(card, dtype, monkeypatch):
    import paddle_tpu_torch.ops.softmax_xent as sx
    from paddle_tpu_torch.nn import functional as F

    z, labels, _ = xent_inputs(256, 4096, dtype, card, seed=5)
    grads, losses = {}, {}
    for impl in ("cuda", "torch"):
        monkeypatch.setattr(_build, "pick_impl", lambda _, t, i=impl: i)
        x = z.clone().requires_grad_(True)
        _build.reset_launches()
        losses[impl] = F.cross_entropy(x, labels)
        grads[impl], = torch.autograd.grad(losses[impl], x)
        assert _build.launches() == ({n: 1 for n in sx.KERNEL_NAMES}
                                     if impl == "cuda" else {})
    _close(losses["cuda"], losses["torch"], dtype)
    _close(grads["cuda"], grads["torch"], dtype)


def test_xent_kernels_reject_what_they_do_not_take(card):
    from paddle_tpu_torch.ops.softmax_xent import xent_fwd

    z, labels, _ = xent_inputs(8, 256, torch.float32, card, seed=0)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        xent_fwd(z.half(), labels)
    with pytest.raises(ValueError, match="int64"):
        xent_fwd(z, labels.int())
    with pytest.raises(ValueError, match="contiguous"):
        xent_fwd(z.t().contiguous().t(), labels)
    with pytest.raises(ValueError, match="CUDA"):
        xent_fwd(z, labels.cpu(), impl="cuda")
