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
    KERNEL_NAME, ROW_KERNEL_NAME, ragged_paged_attention,
    ragged_paged_attention_chunked)

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
    assert rel_err(got, want) <= REL_TOL[dtype], rel_err(got, want)
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


# ------------------------------------------- per-row (decode) attention

def row_inputs(lens, heads, hdim, bs, maxb, dtype, device, seed):
    """A decode batch: each row's blocks distinct, drawn from blocks 1.. of
    a noise pool; table entries past a row's need point at block 0, a
    noise block no row owns (the kernel must not read them)."""
    rs = np.random.RandomState(seed)
    need = [min(-(-max(n, 0) // bs), maxb) for n in lens]
    num_blocks = sum(need) + 1
    perm = rs.permutation(np.arange(1, num_blocks)).astype(np.int32)
    tables = np.zeros((len(lens), maxb), np.int32)
    at = 0
    for s, n in enumerate(need):
        tables[s, :n] = perm[at:at + n]
        at += n
    f = lambda *shape: torch.from_numpy(
        rs.randn(*shape).astype(np.float32)).to(device, dtype)
    i = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    return (f(len(lens), heads, hdim), f(num_blocks, bs, heads, hdim),
            f(num_blocks, bs, heads, hdim), i(tables), i(lens))


def as_segments(tables, lens):
    """The per-row batch as 1-row segments of the chunked kernel (TQ = 1,
    seg_pos = len - 1; rows of length 0 are inactive segments)."""
    n = lens.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=lens.device)
    return (tables, (lens - 1).clamp_min(0), (lens > 0).int(), rows[:, None],
            rows)


ROW_MIXES = [
    # (lens, heads, hdim, block, maxb)
    ([5, 0, 17, 1, 64], 2, 32, 4, 16),
    ([0, 1, 15, 16, 17, 2047, 2048, 3000], 16, 128, 16, 128),  # full width
    ([33, -4, 100, 64, 65, 128], 4, 64, 16, 8),
    ([129, 7, 300], 1, 128, 64, 4),          # big blocks, one clamped row
    ([3, 9, 16], 3, 32, 1, 16),              # one token a block
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens,heads,hdim,bs,maxb", ROW_MIXES)
def test_row_kernel_matches_plain(card, lens, heads, hdim, bs, maxb, dtype):
    args = row_inputs(lens, heads, hdim, bs, maxb, dtype, card,
                      seed=hdim + len(lens))
    before = _build.launches().get(ROW_KERNEL_NAME, 0)
    got = ragged_paged_attention(*args)  # auto -> cuda on the card
    want = ragged_paged_attention(*args, impl="torch")
    torch.cuda.synchronize()
    assert _build.launches()[ROW_KERNEL_NAME] == before + 1
    _close(got, want, dtype)
    dead = torch.tensor(lens, device=card) <= 0
    assert torch.all(got[dead] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_kernel_matches_chunked_kernel(card, dtype):
    """Row 2's kernel and row 1's kernel on the same full-width decode
    batch, given to row 1 as 1-row segments."""
    lens = [1, 15, 16, 17, 300, 0, 2047, 2048, 1000, 33]
    q, kp, vp, tables, seq_lens = row_inputs(lens, 16, 128, 16, 128, dtype,
                                             card, seed=5)
    got = ragged_paged_attention(q, kp, vp, tables, seq_lens, impl="cuda")
    want = ragged_paged_attention_chunked(
        q, kp, vp, *as_segments(tables, seq_lens), impl="cuda")
    torch.cuda.synchronize()
    _close(got, want, dtype)
    assert torch.all(got[5] == 0) and torch.all(want[5] == 0)


def test_row_kernel_rejects_what_it_does_not_take(card):
    q, kp, vp, tables, lens = row_inputs([3, 9], 2, 32, 4, 4,
                                         torch.float32, card, seed=1)
    call = ragged_paged_attention
    with pytest.raises(ValueError, match="contiguous"):
        call(q.transpose(0, 1).contiguous().transpose(0, 1), kp, vp, tables,
             lens)
    with pytest.raises(ValueError, match="got torch.float16"):
        call(q.half(), kp.half(), vp.half(), tables, lens)
    with pytest.raises(ValueError, match="share a dtype"):
        call(q, kp.bfloat16(), vp.bfloat16(), tables, lens)
    with pytest.raises(ValueError, match="int64"):
        call(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="cpu"):
        call(q, kp, vp, tables, lens.cpu())
    small = [t[..., :16].contiguous() for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="head_dim .* got 16"):
        call(*small, tables, lens)
    with pytest.raises(ValueError, match="seq_lens"):
        call(q, kp, vp, tables, lens[:1])
    empty = call(q[:0], kp, vp, tables[:0], lens[:0])
    assert empty.shape == (0, 2, 32)


# each paged kernel with its second KV block left out, for every row or
# segment that has two or more: (kernel, the line, the line broken)
PAGED_MUTATIONS = {
    "chunked": ("rpa_chunked_kernel",
                "for (int b = 0; b < n_blocks; ++b) {",
                "for (int b = 0; b < n_blocks; "
                "b += 1 + (b == 0 && n_blocks > 1)) {"),
    "row": ("rpa_row_kernel", "const bool live = tok < n_tok;",
            "const bool live = tok < n_tok && (kv_len <= block_size "
            "|| (c0 + tok) / block_size != 1);"),
}


def test_paged_limits_reject_a_kernel_that_skips_a_block(card, tmp_path,
                                                        monkeypatch):
    """The bf16 limits tell a right paged kernel from a broken one: each is
    rebuilt with the second KV block of every row (segment) of two or more
    blocks left out, and on a full-width decode batch (H 16, D 128, B 16,
    MAXB 128, 64 rows of 1..2048 tokens) its output must miss REL_TOL,
    while the right kernel meets it. Prints both readings."""
    import ctypes
    import subprocess

    lens = np.random.RandomState(3).randint(1, 2049, 64).tolist()
    q, kp, vp, tables, seq_lens = row_inputs(lens, 16, 128, 16, 128,
                                             torch.bfloat16, card, seed=23)
    segs = as_segments(tables, seq_lens)
    run = {"row": lambda: ragged_paged_attention(q, kp, vp, tables,
                                                 seq_lens, impl="cuda"),
           "chunked": lambda: ragged_paged_attention_chunked(
               q, kp, vp, *segs, impl="cuda")}
    want = ragged_paged_attention(q, kp, vp, tables, seq_lens, impl="torch")
    right = {kind: rel_err(fn(), want) for kind, fn in run.items()}
    procs = {}
    for kind, (kernel, line, broken) in PAGED_MUTATIONS.items():
        src = tmp_path / f"{kind}.cu"
        src.write_text(_mutated_source(kernel, line, broken,
                                       "ragged_paged_attention"))
        lib = tmp_path / f"lib{kind}.so"
        procs[kind] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    broken_err = {}
    for kind, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out.decode()[-2000:]
        monkeypatch.setitem(_build._LIBS, "ragged_paged_attention",
                            ctypes.CDLL(str(lib)))
        broken_err[kind] = rel_err(run[kind](), want)
    print(f"paged bf16 rel err, right kernels: {right}; kernels missing "
          f"one KV block: {broken_err}; limit {REL_TOL[torch.bfloat16]}")
    for kind in PAGED_MUTATIONS:
        assert right[kind] <= REL_TOL[torch.bfloat16] < broken_err[kind]


# ------------------------------------------------------- flash attention

FLASH_CASES = [
    # (bh, sq, sk, d, causal, dropout)
    (2, 128, 128, 64, False, 0.0),
    (3, 256, 256, 128, True, 0.0),
    (2, 128, 384, 128, True, 0.0),    # causal offset sk - sq = 256
    (2, 256, 128, 64, False, 0.0),    # sq > sk, non-causal
    (2, 256, 256, 64, True, 0.3),     # causal dropout
    (1, 192, 320, 128, False, 0.5),   # 64-multiples the gate would refuse
    (1, 192, 320, 128, True, 0.0),    # causal, odd count of 64-row tiles
    (1, 2048, 2048, 128, True, 0.0),  # the K/V ring wraps many times
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
    # kind: (kernel, a line of its loop, the line with one tile left out)
    # The wgmma kernels' consumers leave the tile out; the ring's loads
    # and releases go on, so the pipeline keeps turning.
    "fwd": ("fa_fwd_wgmma_kernel",
            "if (live && !(causal && c0 > row0 + kWgRows - 1 + offset))",
            "if (live && (t > 0 || n_t == 1) "
            "&& !(causal && c0 > row0 + kWgRows - 1 + offset))"),
    "dq": ("fa_dq_wgmma_kernel",
           "if (live && !(causal && c0 > row0 + kWgRows - 1 + offset))",
           "if (live && (t > 0 || n_t == 1) "
           "&& !(causal && c0 > row0 + kWgRows - 1 + offset))"),
    "dkv": ("fa_dkv_wgmma_kernel",
            "if (live && !(causal && r0 + kTile - 1 + offset < col0))",
            "if (live && (i < n_t - 1 || n_t == 1) "
            "&& !(causal && r0 + kTile - 1 + offset < col0))"),
}


def _mutated_source(kernel: str, loop: str, broken: str,
                    source: str = "flash_attention") -> str:
    src = (_build.CSRC / f"{source}.cu").read_text()
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
    tile 0 for the forward and dQ, the last q tile for dK/dV, wherever the
    loop has more than one), and at the training path's sequence length
    and head size its result must miss REL_TOL, while the right kernel
    meets it. Prints both readings."""
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


def test_flash_dropout_call_makes_no_host_sync(card):
    """A dropout call of ``scaled_dot_product_attention`` on the flash
    route, forward and backward, runs with every device-to-host sync made
    an error: the dropout seed is drawn on the host."""
    from paddle_tpu_torch.core import random as rng
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    from paddle_tpu_torch.ops.flash_attention import KERNEL_NAMES

    g = torch.Generator(device=card).manual_seed(5)
    x = [torch.randn(2, 256, 4, 64, generator=g, device=card)
         .to(torch.bfloat16).requires_grad_(True) for _ in range(3)]
    call = lambda: scaled_dot_product_attention(*x, dropout_p=0.1,
                                                is_causal=True)
    call().sum().backward()  # builds and loads the kernels first
    torch.cuda.synchronize()
    rng.seed(0)
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
        out.backward(torch.ones_like(out))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _build.launches() == {name: 1 for name in KERNEL_NAMES}
    assert torch.isfinite(out).all()


def test_flash_route_raises_for_head_dims_past_128(card):
    """Head dims above 128 pass the reference's gate (up to 512), so the
    flash route takes them, but the kernels cover only 64 and 128: the
    call raises rather than run something else, until they do."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_fwd)

    q = torch.zeros(1, 256, 256, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim .* got 256"):
        flash_fwd(q, q, q, True, 256 ** -0.5)
    x = torch.zeros(1, 256, 2, 200, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim .* got 256"):
        flash_attention(x, x, x, causal=True)
    with pytest.raises(ValueError, match="head_dim .* got 256"):
        scaled_dot_product_attention(x, x, x, is_causal=True)


# ------------------------------------------------ block-sparse attention

def block_mask(n_q, n_kv, seed, empty_col=None):
    """A seeded random block mask: about half the pairs active, every q
    block with one, and kv block ``empty_col`` attended by none."""
    rs = np.random.RandomState(seed)
    m = rs.rand(n_q, n_kv) < 0.5
    if empty_col is not None:
        m[:, empty_col] = False
    fallback = 1 if empty_col == 0 else 0
    m[~m.any(axis=1), fallback] = True
    return m


BSA_CASES = [
    # (bh, sq, sk, d, blk_q, blk_k, causal, kv block nothing attends)
    (2, 512, 512, 64, 128, 128, False, 1),
    (2, 512, 512, 128, 128, 128, True, None),
    (2, 1024, 1024, 128, 256, 128, True, 4),   # rows that see no column
    (1, 1024, 1024, 64, 128, 256, False, 0),
    (2, 1024, 1024, 128, 512, 256, False, 2),
    (1, 512, 1024, 64, 256, 512, True, None),  # causal offset 512
    (1, 1024, 768, 128, 512, 256, True, None),  # sq > sk: rows see none
]


def bsa_case(bh, sq, sk, d, blk_q, blk_k, causal, empty, dtype, device):
    """A case's lists and inputs. Causal masks keep kv block 0 in every
    row (the causal drop would empty some rows otherwise); with blk_q =
    2 blk_k, odd q blocks attend only the kv block of their second half,
    so their first half sees no column."""
    from paddle_tpu_torch.ops.block_sparse_attention import block_mask_spec

    n_q, n_kv = sq // blk_q, sk // blk_k
    mask = block_mask(n_q, n_kv, seed=sq + blk_q + blk_k, empty_col=empty)
    if causal:
        mask[:, 0] = True
        if blk_q == 2 * blk_k and sq == sk:
            mask[1::2] = False
            for i in range(1, n_q, 2):
                mask[i, 2 * i + 1] = True
    spec = block_mask_spec(mask, sq, sk, causal)
    q, k, v, do = flash_inputs(bh, sq, sk, d, dtype, device, seed=d + sq)
    return spec, q, k, v, do


def _close_lse(got, want):
    """lse: -inf on the same rows (those that saw no column), else
    within the fp32 limits."""
    inf = torch.isinf(want)
    assert torch.equal(inf, torch.isinf(got))
    _close(got.masked_fill(inf, 0.0), want.masked_fill(inf, 0.0),
           torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,blk_q,blk_k,causal,empty", BSA_CASES)
def test_block_sparse_kernels_match_plain(card, bh, sq, sk, d, blk_q, blk_k,
                                          causal, empty, dtype):
    from paddle_tpu_torch.ops.block_sparse_attention import (
        KERNEL_NAMES, bsa_dkv, bsa_dq, bsa_fwd)

    spec, q, k, v, do = bsa_case(bh, sq, sk, d, blk_q, blk_k, causal, empty,
                                 dtype, card)
    args = (spec, causal, 1.0 / d ** 0.5)
    _build.reset_launches()
    out, lse = bsa_fwd(q, k, v, *args)
    want_out, want_lse = bsa_fwd(q, k, v, *args, impl="torch")
    _close(out, want_out, dtype)
    _close_lse(lse, want_lse)
    empty_rows = torch.isinf(want_lse)
    assert (out[empty_rows] == 0).all()
    delta = (do.float() * want_out.float()).sum(-1)
    _close(bsa_dq(q, k, v, do, want_lse, delta, *args),
           bsa_dq(q, k, v, do, want_lse, delta, *args, impl="torch"), dtype)
    got = bsa_dkv(q, k, v, do, want_lse, delta, *args)
    want = bsa_dkv(q, k, v, do, want_lse, delta, *args, impl="torch")
    for a, b in zip(got, want):
        _close(a, b, dtype)
    if empty is not None:  # written as exact zeros, not left unwritten
        rows = slice(empty * blk_k, (empty + 1) * blk_k)
        assert all((t[:, rows] == 0).all() for t in got)
    torch.cuda.synchronize()
    assert _build.launches() == {name: 1 for name in KERNEL_NAMES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_autograd_runs_the_kernels(card, dtype, monkeypatch):
    import paddle_tpu_torch.ops.block_sparse_attention as bsa

    g = torch.Generator(device=card).manual_seed(4)
    x = [torch.randn(2, 1024, 4, 48, generator=g, device=card).to(dtype)
         .requires_grad_(True) for _ in range(3)]
    mask = block_mask(4, 8, seed=9, empty_col=5)
    mask[:, 0] = True
    grads = {}
    for impl in ("cuda", "torch"):
        monkeypatch.setattr(_build, "pick_impl", lambda _, t, i=impl: i)
        _build.reset_launches()
        out = bsa.block_sparse_attention(*x, mask, causal=True)
        grads[impl] = torch.autograd.grad(out.square().sum(), x)
        assert _build.launches() == ({n: 1 for n in bsa.KERNEL_NAMES}
                                     if impl == "cuda" else {})
    for a, b in zip(grads["cuda"], grads["torch"]):
        _close(a, b, dtype)


def test_block_sparse_kernels_reject_what_they_do_not_take(card):
    from paddle_tpu_torch.ops.block_sparse_attention import (
        block_mask_spec, bsa_fwd)

    spec, q, k, v, _ = bsa_case(1, 256, 256, 64, 128, 128, False, None,
                                torch.float32, card)
    with pytest.raises(ValueError, match="head_dim"):
        bsa_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                v[..., :32].contiguous(), spec, False, 0.125)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        bsa_fwd(q.half(), k.half(), v.half(), spec, False, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        bsa_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, spec,
                False, 0.125)
    other = block_mask_spec(np.ones((4, 4), bool), 512, 512, False)
    with pytest.raises(ValueError, match="does not tile"):
        bsa_fwd(q, k, v, other, False, 0.125)


def test_block_sparse_limit_rejects_a_kernel_that_skips_a_block(
        card, tmp_path, monkeypatch):
    """The bf16 limit tells a right kernel from a broken one: the
    tensor-core forward is rebuilt with the first active block of every
    list of two or more left out, and at the sparse path's shapes (BH 32,
    S 4096, D 128, BigBird's pattern) its output must miss REL_TOL, while
    the right kernel meets it. Prints both readings."""
    import ctypes
    import subprocess

    from paddle_tpu_torch.ops.block_sparse_attention import (
        block_mask_spec, bsa_fwd)

    rs = np.random.RandomState(0)
    n = 32
    mask = np.zeros((n, n), bool)
    for i in range(n):  # window 3, global 2, random 3
        mask[i, max(0, i - 1):i + 2] = True
        mask[i, :2] = True
        mask[i, rs.choice(n, 3, replace=False)] = True
    spec = block_mask_spec(mask, 4096, 4096, False)
    q, k, v, _ = flash_inputs(32, 4096, 4096, 128, torch.bfloat16, card,
                              seed=21)
    args = (spec, False, 1.0 / 128 ** 0.5)
    want = bsa_fwd(q, k, v, *args, impl="torch")[0]
    right = rel_err(bsa_fwd(q, k, v, *args)[0], want)
    src = tmp_path / "bsa.cu"
    src.write_text(_mutated_source(
        "bsa_fwd_mma_kernel", "for (int a = 0; a < n; ++a) {",
        "for (int a = (n > 1); a < n; ++a) {", "block_sparse_attention"))
    lib = tmp_path / "libbsa.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert proc.returncode == 0, proc.stdout.decode()[-2000:]
    monkeypatch.setitem(_build._LIBS, "block_sparse_attention",
                        ctypes.CDLL(str(lib)))
    broken = rel_err(bsa_fwd(q, k, v, *args)[0], want)
    print(f"block-sparse bf16 rel err, right kernel: {right}; kernel "
          f"missing a block: {broken}; limit {REL_TOL[torch.bfloat16]}")
    assert right <= REL_TOL[torch.bfloat16] < broken


# -------------------------------------------------------------- LayerNorm

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f", [(300, 2048), (67, 2101), (16, 2048),
                                 (5, 64)] + [
    # every branch of the launch plan: one warp to eight a row, 1 to 16
    # vectors a thread, and the looping kernel (F = 2101)
    (n, f) for n in (1, 16, 8192) for f in (64, 2048, 2101, 8192)
    if (n, f) != (16, 2048)])
def test_layer_norm_kernel_matches_plain(card, n, f, dtype):
    from paddle_tpu_torch.ops.layer_norm import KERNEL_NAME, ln_fwd

    g = torch.Generator(device=card).manual_seed(n + f)
    x = (torch.randn(n, f, generator=g, device=card) * 3 + 1).to(dtype)
    gamma = torch.randn(f, generator=g, device=card)
    beta = torch.randn(f, generator=g, device=card).to(dtype)
    _build.reset_launches()
    got = ln_fwd(x, gamma, beta, 1e-5)
    want = ln_fwd(x, gamma, beta, 1e-5, impl="torch")
    torch.cuda.synchronize()
    assert _build.launches() == {KERNEL_NAME: 1}
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_norm_autograd_runs_the_kernel(card, dtype, monkeypatch):
    from paddle_tpu_torch.ops.layer_norm import KERNEL_NAME, fused_layer_norm

    g = torch.Generator(device=card).manual_seed(1)
    leaves = [torch.randn(*s, generator=g, device=card).to(dtype)
              for s in ((4, 33, 2048), (2048,), (2048,))]
    res = {}
    for impl in ("cuda", "torch"):
        xs = [t.clone().requires_grad_(True) for t in leaves]
        _build.reset_launches()
        out = fused_layer_norm(*xs, impl=impl)
        res[impl] = [out] + list(torch.autograd.grad(
            out.float().square().sum(), xs))
        assert _build.launches() == ({KERNEL_NAME: 1} if impl == "cuda"
                                     else {})
    for a, b in zip(res["cuda"], res["torch"]):
        _close(a, b, dtype)


# the first 32 16-byte vectors of each row left out of the register
# kernel's mean and variance (256 of 2048 bf16 elements)
LN_MUTATION = [
    ("for (int c = 0; c < C; ++c) sum += vec_sum<T>(raw[c]);",
     "for (int c = 0; c < C; ++c)\n"
     "    if (c * kRowThreads + tr >= 32) sum += vec_sum<T>(raw[c]);"),
    ("if (c * kRowThreads + tr < nv) sq += vec_sq<T>(raw[c], mean);",
     "if (c * kRowThreads + tr >= 32 && c * kRowThreads + tr < nv)\n"
     "      sq += vec_sq<T>(raw[c], mean);"),
]


def test_layer_norm_limit_rejects_a_kernel_that_skips_a_chunk(
        card, tmp_path, monkeypatch):
    """The bf16 limit tells a right kernel from a broken one: the register
    kernel is rebuilt with one chunk of each row (its first 32 16-byte
    vectors, an eighth of a 2048-wide bf16 row) left out of the
    statistics, and at the train path's activations ([8192, 2048] bf16)
    its output must miss REL_TOL, while the right kernel meets it. Prints
    both readings."""
    import ctypes
    import subprocess

    from paddle_tpu_torch.ops.layer_norm import _plan, ln_fwd

    assert _plan(2048, 2) != (0, 0)  # the register kernel runs
    g = torch.Generator(device=card).manual_seed(8)
    x = (torch.randn(8192, 2048, generator=g, device=card) * 2
         + 0.5).bfloat16()
    gamma = torch.randn(2048, generator=g, device=card)
    beta = torch.randn(2048, generator=g, device=card)
    want = ln_fwd(x, gamma, beta, 1e-5, impl="torch")
    right = rel_err(ln_fwd(x, gamma, beta, 1e-5), want)
    text = (_build.CSRC / "layer_norm.cu").read_text()
    for old, new in LN_MUTATION:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    src, lib = tmp_path / "ln.cu", tmp_path / "libln.so"
    src.write_text(text)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert proc.returncode == 0, proc.stdout.decode()[-2000:]
    monkeypatch.setitem(_build._LIBS, "layer_norm", ctypes.CDLL(str(lib)))
    broken = rel_err(ln_fwd(x, gamma, beta, 1e-5), want)
    print(f"layer_norm bf16 rel err, right kernel: {right}; kernel missing "
          f"a chunk: {broken}; limit {REL_TOL[torch.bfloat16]}")
    assert right <= REL_TOL[torch.bfloat16] < broken


def test_layer_norm_kernel_rejects_what_it_does_not_take(card):
    from paddle_tpu_torch.ops.layer_norm import ln_fwd

    x = torch.zeros(4, 64, device=card)
    w = torch.ones(64, device=card)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        ln_fwd(x.half(), w, w, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        ln_fwd(x.t().contiguous().t()[:, :4], w[:4], w[:4], 1e-5)
    with pytest.raises(ValueError, match=r"\[N, F\]"):
        ln_fwd(x, w[:32], w, 1e-5)


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
