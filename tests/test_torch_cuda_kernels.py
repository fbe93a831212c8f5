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
    # split-KV (auto splits of 64 tokens at these shapes): rows over many
    # splits; rows ending on a split boundary and a 1-token row at 0
    ([(1, 700), (8, 333), (3, 1000)], 2, 4, 128, 16, 64, 8),
    ([(1, 127), (8, 120), (1, 0)], 1, 2, 64, 16, 16, 8),
    # head dims 16, 48 (run at 64), 256, 512
    ([(4, 5), (1, 40), (2, 0)], 1, 4, 16, 8, 8, 4),
    ([(6, 70), (1, 9), (3, 0)], 2, 2, 48, 16, 8, 8),
    ([(8, 100), (1, 200), (5, 3)], 1, 2, 256, 16, 16, 8),
    ([(8, 30), (1, 77)], 1, 1, 512, 16, 8, 8),
    # q_tile 16 and 32, and tiles past one pass (64 rows at D 128, 16 at
    # D 512)
    ([(16, 90), (16, 106), (1, 63), (9, 0)], 3, 2, 128, 16, 16, 16),
    ([(32, 200), (20, 7), (1, 31)], 2, 2, 64, 16, 16, 32),
    ([(80, 10), (1, 5)], 0, 1, 128, 16, 8, 80),
    ([(20, 3)], 0, 1, 512, 16, 4, 32),
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


def test_tensor_core_pass_keeps_p_to_16_bits(card):
    """A full-width bf16 serving mix (H 16, D 128, B 16, MAXB 128, q_tile
    8: decode rows of 1..2048 tokens and 8-row prefill tiles at unaligned
    offsets) through the segmented kernel, whose multi-row tiles run the
    tensor-core pass: p enters P.V as a bf16 high and low part, so the
    output is the fp32-p plain version's within 1e-4 in relative norm
    (p rounded to bf16 alone read 1.5e-3). Prints the reading."""
    rs = np.random.RandomState(11)
    segs = [(1, int(n)) for n in rs.randint(0, 2048, 16)]
    segs += [(8, int(p)) for p in rs.randint(1, 2040, 24)]
    args, _ = step_inputs(segs, 8, 16, 128, 16, 128, 8, num_blocks=2048,
                          dtype=torch.bfloat16, device=card, seed=12)
    got = ragged_paged_attention_chunked(*args, impl="cuda")
    want = ragged_paged_attention_chunked(*args, impl="torch")
    rel = rel_err(got, want)
    print(f"segmented bf16 mix rel err: {rel} (limit 1e-4)")
    _close(got, want, torch.bfloat16)
    assert rel <= 1e-4


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
    with pytest.raises(ValueError, match="shape mismatch"):
        ragged_paged_attention_chunked(q[..., :16].contiguous(), kp, vp,
                                       *meta)
    wide = [torch.zeros(*t.shape[:-1], 520, device=card) for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="head_dim 1..512, got 520"):
        ragged_paged_attention_chunked(*wide, *meta)


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
    ([5, 0, 17, 64], 2, 16, 4, 16),          # head dim 16
    ([33, 1, 0, 100], 2, 48, 16, 8),         # 48, run at 64
    ([200, 7, 0, 129], 2, 256, 16, 16),      # 256: 32-token chunks
    ([40, 3, 130], 1, 512, 8, 16),           # 512: 16-token chunks
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
    with pytest.raises(ValueError, match="shape mismatch"):
        call(q[..., :16].contiguous(), kp, vp, tables, lens)
    wide = [torch.zeros(*t.shape[:-1], 520, device=card) for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="head_dim 1..512, got 520"):
        call(*wide, tables, lens)
    with pytest.raises(ValueError, match="seq_lens"):
        call(q, kp, vp, tables, lens[:1])
    empty = call(q[:0], kp, vp, tables[:0], lens[:0])
    assert empty.shape == (0, 2, 32)


# each paged kernel with its second KV block left out, for every row or
# segment that has two or more: (kernel, the line, the line broken)
PAGED_MUTATIONS = {
    # (B = 16 below; the decode segments run the kernel's one-row path)
    "chunked": ("run_row", "live[u] = p < w.hi;",
                "live[u] = p < w.hi && (p < 16 || p >= 32 || w.hi <= 16);"),
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


def decode_segments(dtype, device, n_rows=64, seed=23):
    """A full-width decode batch (H 16, D 128, B 16, MAXB 128, rows of
    1..2048 tokens) as 1-row segments, and its plain result."""
    lens = np.random.RandomState(seed).randint(1, 2049, n_rows).tolist()
    q, kp, vp, tables, seq_lens = row_inputs(lens, 16, 128, 16, 128, dtype,
                                             device, seed=seed)
    args = (q, kp, vp, *as_segments(tables, seq_lens))
    return args, ragged_paged_attention_chunked(*args, impl="torch")


def test_paged_limit_rejects_a_kernel_that_skips_a_split(card, tmp_path,
                                                         monkeypatch):
    """The bf16 limits tell a right split-KV merge from one that leaves
    split 1 out (rows of more than one 256-token split): the segmented
    kernel rebuilt so must miss REL_TOL on a full-width decode batch, the
    right kernel meets it. Prints both readings."""
    import ctypes
    import subprocess

    args, want = decode_segments(torch.bfloat16, card)
    monkeypatch.setattr(_rpa_module(), "split_plan",
                        lambda *a: (256, -(-a[2] // 256)))
    call = lambda: ragged_paged_attention_chunked(*args, impl="cuda")
    right = rel_err(call(), want)
    src = tmp_path / "split.cu"
    src.write_text(_mutated_source(
        "rpa_chunked_kernel",
        "for (int j = 0; j < n_live; ++j) {  // the splits' states, merged",
        "for (int j = 0; j < n_live; j += 1 + (j == 0)) {",
        "ragged_paged_attention"))
    lib = tmp_path / "libsplit.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    monkeypatch.setitem(_build._LIBS, "ragged_paged_attention",
                        ctypes.CDLL(str(lib)))
    broken = rel_err(call(), want)
    print(f"segmented bf16 rel err, right kernel: {right}; merge without "
          f"split 1: {broken}; limit {REL_TOL[torch.bfloat16]}")
    assert right <= REL_TOL[torch.bfloat16] < broken


def _rpa_module():
    import sys

    # the module (ops.ragged_paged_attention is the entry-point function)
    return sys.modules["paddle_tpu_torch.ops.ragged_paged_attention"]


@pytest.mark.parametrize("split", [64, 192, 1024, 2048])
def test_chunked_kernel_matches_plain_at_any_split(card, split, monkeypatch):
    """One fp32 decode batch at splits of 64 to 2048 tokens (32 splits to
    one): the kernel meets the fp32 limits at each, and leaves the merge
    counters zero."""
    rpa = _rpa_module()
    args, want = decode_segments(torch.float32, card, n_rows=24, seed=31)
    monkeypatch.setattr(rpa, "split_plan",
                        lambda *a: (split, -(-a[2] // split)))
    got = ragged_paged_attention_chunked(*args, impl="cuda")
    torch.cuda.synchronize()
    _close(got, want, torch.float32)
    assert all(int(counters.abs().sum().item()) == 0
               for counters, _ in rpa._SCRATCH.values())


def test_chunked_call_makes_no_host_sync(card):
    """Segmented calls that split (a full-width decode batch) and that pad
    the head dim (48 to 64) run with every device-to-host sync made an
    error: the launcher reads nothing back from the card."""
    args, want = decode_segments(torch.bfloat16, card, n_rows=16)
    small, _ = step_inputs([(8, 100), (1, 7)], 1, 2, 48, 16, 16, 8,
                           num_blocks=64, dtype=torch.bfloat16, device=card,
                           seed=3)
    ragged_paged_attention_chunked(*args)  # builds and loads the kernel
    ragged_paged_attention_chunked(*small)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ragged_paged_attention_chunked(*args)
        got_small = ragged_paged_attention_chunked(*small)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _build.launches() == {KERNEL_NAME: 2}
    _close(got, want, torch.bfloat16)
    _close(got_small, ragged_paged_attention_chunked(*small, impl="torch"),
           torch.bfloat16)


def test_engine_serves_head_dim_16_at_q_tile_16(card):
    """A model at head dim 16 (the gpt_tiny preset's) served through the
    kernel at q_tile 16 gives the plain attention's greedy streams."""
    from paddle_tpu_torch.serving import (Engine, EngineConfig,
                                          GPTServingModel, SamplingParams)

    rs = np.random.RandomState(1)
    e, h, d, ffn, vocab = 64, 4, 16, 256, 256
    mk = lambda *s: (rs.randn(*s) * 0.25).astype(np.float32)
    layers = [dict(ln_scale=np.ones(e, np.float32),
                   ln_bias=np.zeros(e, np.float32), qkv_w=mk(3, h, d, e),
                   out_w=mk(e, e), ffn_ln_scale=np.ones(e, np.float32),
                   ffn_ln_bias=np.zeros(e, np.float32), ffn1_w=mk(e, ffn),
                   ffn2_w=mk(ffn, e)) for _ in range(2)]
    model = GPTServingModel(mk(vocab, e), mk(e, vocab), layers, n_heads=h,
                            head_dim=d, max_position=128)
    prompts = [list(rs.randint(0, vocab, n)) for n in (37, 5, 20, 1, 16)]
    outs = {}
    for attention in ("cuda", "torch"):
        engine = Engine(model, EngineConfig(
            max_slots=4, token_budget=32, block_size=8, num_blocks=64,
            max_blocks_per_seq=16, attention=attention, q_tile=16))
        outs[attention] = engine.generate(
            prompts, SamplingParams(max_new_tokens=8))
    assert outs["cuda"] == outs["torch"]


# the segmented kernel's multi-row paths with KV chunk 1 of every split's
# pass left out: path -> (dtype, function, the line, the line broken)
_SCORE_MASK = ("const bool ok = row < w.rows && pos < w.hi && "
               "pos <= w.row0 + row;")
PASS_MUTATIONS = {
    "mma": (torch.bfloat16, "run_pass_mma", _SCORE_MASK,
            _SCORE_MASK[:-1] + " && c != 1;"),
    "fma": (torch.float32, "chunk_group", _SCORE_MASK,
            _SCORE_MASK[:-1] + " && (c0 - w.k0) / kChunk != 1;"),
}


def test_paged_limits_reject_multi_row_passes_that_skip_a_chunk(
        card, tmp_path, monkeypatch):
    """The limits tell right multi-row passes from broken ones: segments
    of 8 to 16 rows at full width (H 16, D 128, B 16, MAXB 128, q_tile
    16) run the tensor-core pass in bf16 and the FMA pass in fp32; each
    pass rebuilt to leave KV chunk 1 of every split out must miss its
    dtype's REL_TOL, while the right kernel meets it. Prints both
    readings."""
    import ctypes
    import subprocess

    segs = [(16, 300), (16, 900), (16, 1500), (16, 2000), (8, 250),
            (8, 700), (12, 1200), (8, 1800)]
    args = {}
    for path, (dtype, _, _, _) in PASS_MUTATIONS.items():
        a, _ = step_inputs(segs, 2, 16, 128, 16, 128, 16, num_blocks=2048,
                           dtype=dtype, device=card, seed=41)
        args[path] = (a, ragged_paged_attention_chunked(*a, impl="torch"))
    run = lambda path: ragged_paged_attention_chunked(*args[path][0],
                                                      impl="cuda")
    right = {path: rel_err(run(path), args[path][1]) for path in args}
    procs = {}
    for path, (_, fn, line, broken) in PASS_MUTATIONS.items():
        src = tmp_path / f"{path}.cu"
        src.write_text(_mutated_source(fn, line, broken,
                                       "ragged_paged_attention"))
        lib = tmp_path / f"lib{path}.so"
        procs[path] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    broken_err = {}
    for path, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out.decode()[-2000:]
        monkeypatch.setitem(_build._LIBS, "ragged_paged_attention",
                            ctypes.CDLL(str(lib)))
        broken_err[path] = rel_err(run(path), args[path][1])
    print(f"segmented multi-row rel err, right kernel: {right}; passes "
          f"missing KV chunk 1: {broken_err}; limits {REL_TOL}")
    for path, (dtype, _, _, _) in PASS_MUTATIONS.items():
        assert right[path] <= REL_TOL[dtype] < broken_err[path]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_kernel_takes_long_tables(card, dtype, monkeypatch):
    """Tables of 40,960 positions with one split wanted for each
    (segment, head) (TARGET_BLOCKS 1): split_plan caps the split at 8192
    positions, whose pool rows fit shared memory beside a 16-row tile's
    ring and pass, and the kernel meets the limits."""
    monkeypatch.setattr(_rpa_module(), "TARGET_BLOCKS", 1)
    args, _ = step_inputs([(16, 40000), (1, 39000), (5, 8189)], 1, 2, 128,
                          16, 2560, 16, num_blocks=4096, dtype=dtype,
                          device=card, seed=43)
    got = ragged_paged_attention_chunked(*args, impl="cuda")
    _close(got, ragged_paged_attention_chunked(*args, impl="torch"), dtype)


def test_chunked_calls_on_two_streams_at_once(card):
    """Two split decode batches launched on two streams, neither waiting
    for the other, five times over: each stream merges through counters
    and states of its own, and both outputs meet the bf16 limits."""
    a, want_a = decode_segments(torch.bfloat16, card, n_rows=16, seed=5)
    b, want_b = decode_segments(torch.bfloat16, card, n_rows=16, seed=6)
    ragged_paged_attention_chunked(*a)  # builds and loads the kernel
    torch.cuda.synchronize()
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    got = []
    for _ in range(5):
        for stream, args in zip(streams, (a, b)):
            with torch.cuda.stream(stream):
                got.append(ragged_paged_attention_chunked(*args))
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        _close(out, (want_a, want_b)[i % 2], torch.bfloat16)


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
    # padded head dims past 128: bf16 at 192 and 256 on the list kernels
    # of attention_wgmma.cuh over the dense walk (bsa_fwd_wgmma_kernel,
    # bsa_dq_wgmma_kernel, bsa_dkv_split_wgmma_kernel), the rest on the
    # wide kernels
    (2, 256, 256, 192, True, 0.0),
    (2, 512, 512, 256, True, 0.0),
    (1, 192, 320, 256, True, 0.3),    # dropout, offset 128, odd tile count
    (2, 192, 256, 192, False, 0.0),
    (2, 256, 256, 256, False, 0.0),
    (1, 256, 384, 192, True, 0.0),    # causal offset 128
    (1, 320, 320, 192, True, 0.0),    # odd count: a dQ block of one live 64
    (2, 320, 128, 256, False, 0.0),   # sq > sk, odd tile count
    (1, 512, 512, 192, True, 0.2),    # causal dropout
    (1, 320, 448, 256, True, 0.2),    # causal dropout, offset 128, odd count
    (1, 128, 384, 320, True, 0.3),    # causal offset 256, dropout
    (1, 256, 128, 512, False, 0.0),   # sq > sk
    (1, 192, 320, 512, True, 0.2),    # causal dropout, offset 128
    (2, 128, 128, 448, False, 0.5),
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
    """``csrc/<source>.cu`` (or the file ``source`` names with its
    suffix) with the first ``loop`` after ``kernel``'s definition
    replaced by ``broken``."""
    name = source if "." in source else f"{source}.cu"
    src = (_build.CSRC / name).read_text()
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
    """Head dims past 512 pass no gate of the reference: the flash kernels
    (padded D 64..512) refuse D 576 rather than run something else, and
    ``scaled_dot_product_attention`` routes it to the plain composition."""
    from paddle_tpu_torch.nn.functional import (
        scaled_dot_product_attention, would_use_flash)
    from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_fwd)

    q = torch.zeros(1, 256, 576, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim .* got 576"):
        flash_fwd(q, q, q, True, 576 ** -0.5)
    x = torch.zeros(1, 256, 2, 550, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim .* got 576"):
        flash_attention(x, x, x, causal=True)
    assert not would_use_flash(256, 256, 550, causal=True)
    _build.reset_launches()
    out = scaled_dot_product_attention(x, x, x, is_causal=True)
    assert out.shape == x.shape and _build.launches() == {}


def _route_grads(call, leaves, impl, monkeypatch):
    """out and the leaves' gradients of sum(out * w) through ``call``
    with every kernel entry point on route ``impl``, and the launches."""
    monkeypatch.setattr(_build, "pick_impl", lambda _, t, i=impl: i)
    xs = [t.clone().requires_grad_(True) for t in leaves]
    _build.reset_launches()
    out = call(*xs)
    w = torch.linspace(-1, 1, out.numel(), device=out.device).view_as(out)
    grads = torch.autograd.grad((out.float() * w).sum(), xs)
    torch.cuda.synchronize()
    return [out.detach(), *grads], _build.launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_runs_the_wide_kernels_at_head_dim_200(card, dtype,
                                                    monkeypatch):
    """``scaled_dot_product_attention`` at D 200 (padded to 256) takes the
    flash route, launches each kernel once (fp32: the wide kernels; bf16:
    the list kernels of attention_wgmma.cuh), and agrees with the same
    route on the plain versions, forward and q/k/v gradients; and the
    plain flash route with the dense composition (fp32)."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    from paddle_tpu_torch.nn.functional import attention as att
    from paddle_tpu_torch.ops.flash_attention import KERNEL_NAMES

    g = torch.Generator(device=card).manual_seed(6)
    leaves = [torch.randn(2, 256, 2, 200, generator=g, device=card)
              .to(dtype) for _ in range(3)]
    call = lambda q, k, v: scaled_dot_product_attention(q, k, v,
                                                        is_causal=True)
    got, launches = _route_grads(call, leaves, "cuda", monkeypatch)
    assert launches == {name: 1 for name in KERNEL_NAMES}
    want, plain = _route_grads(call, leaves, "torch", monkeypatch)
    assert plain == {}
    for a, b in zip(got, want):
        _close(a, b, dtype)
    if dtype == torch.float32:
        dense = lambda q, k, v: att._sdpa_reference(q, k, v, None, 0.0,
                                                    True, None, True)
        ref, _ = _route_grads(dense, leaves, "torch", monkeypatch)
        for a, b in zip(want, ref):
            assert rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_attention_runs_the_wide_kernels_at_head_dim_256(
        card, dtype, monkeypatch):
    """``sparse_attention``'s block route at D 256 (a BigBird-like CSR at
    128-token blocks, T 1024) launches each block-sparse kernel once (fp32:
    the wide kernels; bf16: the list kernels of attention_wgmma.cuh) and
    agrees with the same route on the plain versions, forward and
    q/k/v gradients, and with the dense masked composition (fp32)."""
    from paddle_tpu_torch.nn.functional import attention as att
    from paddle_tpu_torch.nn.functional import sparse_attention
    from paddle_tpu_torch.ops.block_sparse_attention import (
        KERNEL_NAMES, local_global_mask)

    b, h, t, d = 1, 2, 1024, 256
    mask = local_global_mask(8, 8, window=1, global_blocks=1)
    mask[3, 6] = True
    el = np.kron(mask, np.ones((128, 128), bool))
    off = np.concatenate([[0], np.cumsum(el.sum(axis=1))])
    csr = [torch.from_numpy(a.astype(np.int32)).to(card).expand(
        b, h, a.size).contiguous() for a in (off, np.nonzero(el)[1])]
    g = torch.Generator(device=card).manual_seed(7)
    leaves = [torch.randn(b, h, t, d, generator=g, device=card).to(dtype)
              for _ in range(3)]
    call = lambda q, k, v: sparse_attention(q, k, v, *csr)
    got, launches = _route_grads(call, leaves, "cuda", monkeypatch)
    assert launches == {name: 1 for name in KERNEL_NAMES}
    want, plain = _route_grads(call, leaves, "torch", monkeypatch)
    assert plain == {}
    for a, b_ in zip(got, want):
        _close(a, b_, dtype)
    if dtype == torch.float32:
        dense = lambda q, k, v: att._sa(q, k, v, *csr)
        ref, _ = _route_grads(dense, leaves, "torch", monkeypatch)
        for a, b_ in zip(want, ref):
            assert rel_err(a, b_) <= 1e-5


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
    # the bf16 kernels on wgmma: 128-row blocks of 256-row lists
    (2, 1024, 1024, 64, 256, 256, True, 1),
    (2, 2048, 1024, 128, 128, 512, False, 1),
    # padded head dims past 128: bf16 at 192 and 256 on the list kernels
    # of attention_wgmma.cuh, the rest on the wide kernels
    (2, 512, 512, 192, 128, 128, True, 1),
    (2, 1024, 1024, 192, 128, 256, False, 1),
    (1, 1024, 1024, 256, 256, 128, False, 3),
    (1, 1024, 768, 192, 512, 256, True, None),  # sq > sk: rows see none
    (1, 1024, 768, 256, 512, 256, True, None),  # sq > sk: rows see none
    (1, 1024, 1024, 192, 256, 128, True, 2),   # rows that see no column
    (2, 1024, 1024, 256, 128, 256, False, 2),
    (1, 1024, 1024, 256, 256, 128, True, None),  # rows that see no column
    (1, 512, 1024, 256, 256, 512, True, None),  # causal offset 512
    (1, 1024, 1024, 320, 256, 128, True, None),  # rows that see no column
    (1, 512, 1024, 512, 256, 512, False, 0),
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


def bigbird_like(n, seed, global_blocks=2):
    """BigBird's pattern at n blocks: window 3, ``global_blocks`` leading
    kv blocks every q block attends, 3 random kv blocks a q block."""
    rs = np.random.RandomState(seed)
    mask = np.zeros((n, n), bool)
    for i in range(n):
        mask[i, max(0, i - 1):i + 2] = True
        mask[i, :global_blocks] = True
        mask[i, rs.choice(n, 3, replace=False)] = True
    return mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_block_sparse_backward_on_a_global_heavy_pattern(card, d, causal):
    """The bf16 wgmma dQ and dK/dV kernels on BigBird's pattern at 16
    blocks of 128 (the two global kv blocks' lists are the longest, and
    the launch order puts them first; kv block 5 attended by nothing),
    against the plain versions; dK/dV's zeros exact."""
    from paddle_tpu_torch.ops.block_sparse_attention import (
        block_mask_spec, bsa_dkv, bsa_dq, bsa_fwd)

    mask = bigbird_like(16, seed=d)
    mask[:, 5] = False
    spec = block_mask_spec(mask, 2048, 2048, causal)
    assert list(spec.order_kv[:2]) == [0, 1]
    q, k, v, do = flash_inputs(4, 2048, 2048, d, torch.bfloat16, card,
                               seed=d + 1)
    args = (spec, causal, 1.0 / d ** 0.5)
    out, lse = bsa_fwd(q, k, v, *args, impl="torch")
    delta = (do.float() * out.float()).sum(-1)
    _close(bsa_dq(q, k, v, do, lse, delta, *args),
           bsa_dq(q, k, v, do, lse, delta, *args, impl="torch"),
           torch.bfloat16)
    got = bsa_dkv(q, k, v, do, lse, delta, *args)
    want = bsa_dkv(q, k, v, do, lse, delta, *args, impl="torch")
    for a, b in zip(got, want):
        _close(a, b, torch.bfloat16)
        assert (a[:, 5 * 128:6 * 128] == 0).all()


# each bf16 block-sparse kernel with the first entry of every list of two
# or more left out: kind -> (the file, its kernel, a line of the kernel's
# loop, the line broken). The consumers leave the entry's tiles out; the
# ring's loads and releases go on.
BSA_MUTATIONS = {
    "fwd": ("attention_wgmma.cuh", "bsa_fwd_wgmma_kernel",
            "if (live && !(causal && c0 > row0 + kWgRows - 1 + offset))",
            "if (live && (t >= per_entry || n == 1) "
            "&& !(causal && c0 > row0 + kWgRows - 1 + offset))"),
    "dq": ("attention_wgmma.cuh", "bsa_dq_wgmma_kernel",
           "if (live && !(causal && c0 > row0 + kWgRows - 1 + offset))",
           "if (live && (t >= per_entry || n == 1) "
           "&& !(causal && c0 > row0 + kWgRows - 1 + offset))"),
    "dkv": ("block_sparse_attention.cu", "bsa_dkv_wgmma_kernel",
            "if (!(causal && r0 + kTile - 1 + offset < col0))",
            "if ((first + i >= per_entry || n == 1) "
            "&& !(causal && r0 + kTile - 1 + offset < col0))"),
}


def _build_mutant(kind: str, out_dir, mutations=BSA_MUTATIONS,
                  source: str = "block_sparse_attention.cu"):
    """``source`` built in its own directory beside the mutated file of
    ``mutations[kind]`` (a header there is the one its quoted include
    finds): returns (library, nvcc process)."""
    import shutil
    import subprocess

    file, kernel, loop, broken = mutations[kind]
    out_dir.mkdir()
    (out_dir / file).write_text(_mutated_source(kernel, loop, broken, file))
    src = out_dir / source
    if not src.exists():
        shutil.copy(_build.CSRC / source, src)
    lib = out_dir / f"lib{kind}.so"
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def test_block_sparse_limit_rejects_a_kernel_that_skips_a_block(
        card, tmp_path, monkeypatch):
    """The bf16 limit tells a right kernel from a broken one: the
    tensor-core forward, dQ and dK/dV are each rebuilt with the first
    entry of every list of two or more left out, and at the sparse path's
    shapes (BH 32, S 4096, D 128, BigBird's pattern) each result must miss
    REL_TOL, while the right kernel meets it; the forward also at D 256
    (BH 8, S 2048). Prints both readings."""
    import ctypes

    from paddle_tpu_torch.ops.block_sparse_attention import (
        block_mask_spec, bsa_dkv, bsa_dq, bsa_fwd)

    spec = block_mask_spec(bigbird_like(32, seed=0), 4096, 4096, False)
    q, k, v, do = flash_inputs(32, 4096, 4096, 128, torch.bfloat16, card,
                               seed=21)
    args = (spec, False, 1.0 / 128 ** 0.5)
    out, lse = bsa_fwd(q, k, v, *args, impl="torch")
    delta = (do.float() * out.float()).sum(-1)
    spec_w = block_mask_spec(bigbird_like(16, seed=1), 2048, 2048, False)
    wide = flash_inputs(8, 2048, 2048, 256, torch.bfloat16, card, seed=22)
    args_w = (spec_w, False, 1.0 / 256 ** 0.5)
    run = {
        "fwd": lambda **kw: bsa_fwd(q, k, v, *args, **kw)[0],
        "fwd_d256": lambda **kw: bsa_fwd(*wide[:3], *args_w, **kw)[0],
        "dq": lambda **kw: bsa_dq(q, k, v, do, lse, delta, *args, **kw),
        "dkv": lambda **kw: torch.cat(bsa_dkv(q, k, v, do, lse, delta,
                                              *args, **kw)),
    }
    lib_of = {"fwd": "fwd", "fwd_d256": "fwd", "dq": "dq", "dkv": "dkv"}
    want = {case: fn(impl="torch") for case, fn in run.items()}
    right = {case: rel_err(fn(), want[case]) for case, fn in run.items()}
    procs = {kind: _build_mutant(kind, tmp_path / kind)
             for kind in BSA_MUTATIONS}
    libs = {}
    for kind, (lib, proc) in procs.items():
        out_ = proc.communicate()[0]
        assert proc.returncode == 0, out_.decode()[-2000:]
        libs[kind] = ctypes.CDLL(str(lib))
    broken_err = {}
    for case, fn in run.items():
        monkeypatch.setitem(_build._LIBS, "block_sparse_attention",
                            libs[lib_of[case]])
        broken_err[case] = rel_err(fn(), want[case])
    print(f"block-sparse bf16 rel err, right kernels: {right}; kernels "
          f"missing a list entry: {broken_err}; limit "
          f"{REL_TOL[torch.bfloat16]}")
    for case in run:
        assert right[case] <= REL_TOL[torch.bfloat16] < broken_err[case]


# bsa_fwd_dsplit_wgmma_kernel, the bf16 forward at padded D 320..512:
# flash (bh, sq, sk, causal, dropout) and block-sparse (bh, sq, sk, blk_q,
# blk_k, causal, kv block nothing attends) cases
DSPLIT_FLASH_CASES = [
    (2, 256, 256, True, 0.0),
    (2, 256, 256, False, 0.0),
    (1, 256, 384, True, 0.0),     # causal offset 128
    (2, 320, 128, False, 0.0),    # sq > sk
    (1, 192, 320, True, 0.0),     # an odd count of 64-row tiles
    (1, 512, 512, True, 0.2),     # causal dropout
]
DSPLIT_SPARSE_CASES = [
    (2, 1024, 1024, 256, 128, False, 1),
    (2, 1024, 1024, 128, 256, True, None),
    (1, 1024, 768, 512, 256, True, None),  # sq > sk: rows see none
]


def _forward_agrees(fwd, q, k, v, args, name, dtype):
    """One forward call launches ``name`` once, and its result (out, lse)
    is within the limits of the plain version's; rows that see no column
    are 0, lse -inf. (Which kernel ran is read from the profiler in
    test_forward_dispatch_takes_the_wgmma_list_kernel: a process records
    device activity in a limited number of profiler windows.)"""
    _build.reset_launches()
    out, lse = fwd(q, k, v, *args)
    torch.cuda.synchronize()
    assert _build.launches() == {name: 1}
    want, want_lse = fwd(q, k, v, *args, impl="torch")
    _close(out, want, dtype)
    _close_lse(lse, want_lse)
    assert (out[torch.isinf(want_lse)] == 0).all()


@pytest.mark.parametrize("d", [320, 384, 448, 512])
@pytest.mark.parametrize("bh,sq,sk,causal,dropout", DSPLIT_FLASH_CASES)
def test_dsplit_forward_matches_plain_flash(card, bh, sq, sk, causal,
                                            dropout, d):
    """The bf16 flash forward past D 256 (bsa_fwd_dsplit_wgmma_kernel,
    whose two warpgroups split D: 3 + 2, 3 + 3, 4 + 3, 4 + 4 column blocks
    of 64) launches once and agrees with the plain version, dropout keep
    bits and causal offsets included; and so does the fp32 forward
    (bsa_fwd_tf32_kernel: 64 q rows a block, two warps a row group
    splitting the output's columns and the scores' depth) at d, and at
    192 and 256 beside 320, within the fp32 limits."""
    from paddle_tpu_torch.ops.flash_attention import KERNEL_NAMES, flash_fwd

    q, k, v, _ = flash_inputs(bh, sq, sk, d, torch.bfloat16, card,
                              seed=sq + sk + d)
    _forward_agrees(flash_fwd, q, k, v, (causal, d ** -0.5, dropout, 77),
                    KERNEL_NAMES[0], torch.bfloat16)
    for dd in _tf32_dims(d):
        q, k, v, _ = flash_inputs(bh, sq, sk, dd, torch.float32, card,
                                  seed=sq + sk + dd + 2)
        _forward_agrees(flash_fwd, q, k, v,
                        (causal, dd ** -0.5, dropout, 77), KERNEL_NAMES[0],
                        torch.float32)


@pytest.mark.parametrize("d", [320, 384, 448, 512])
@pytest.mark.parametrize("bh,sq,sk,blk_q,blk_k,causal,empty",
                         DSPLIT_SPARSE_CASES)
def test_dsplit_forward_matches_plain_sparse(card, bh, sq, sk, blk_q,
                                             blk_k, causal, empty, d):
    """The bf16 block-sparse forward past D 256
    (bsa_fwd_dsplit_wgmma_kernel over the q-major lists) launches once and
    agrees with the plain version, rows that see no column included; and
    so does the fp32 forward (bsa_fwd_tf32_kernel) at d, and at 192 and
    256 beside 320, within the fp32 limits."""
    from paddle_tpu_torch.ops.block_sparse_attention import (KERNEL_NAMES,
                                                             bsa_fwd)

    spec, q, k, v, _ = bsa_case(bh, sq, sk, d, blk_q, blk_k, causal, empty,
                                torch.bfloat16, card)
    _forward_agrees(bsa_fwd, q, k, v, (spec, causal, d ** -0.5),
                    KERNEL_NAMES[0], torch.bfloat16)
    for dd in _tf32_dims(d):
        spec, q, k, v, _ = bsa_case(bh, sq, sk, dd, blk_q, blk_k, causal,
                                    empty, torch.float32, card)
        _forward_agrees(bsa_fwd, q, k, v, (spec, causal, dd ** -0.5),
                        KERNEL_NAMES[0], torch.float32)


# bsa_fwd_dsplit_wgmma_kernel broken two ways: kind -> (file, kernel, a
# line of it, the line broken)
DSPLIT_MUTATIONS = {
    # the scores leave Q K^T's last 64 columns of depth out
    "s_depth": ("attention_wgmma.cuh", "bsa_fwd_dsplit_wgmma_kernel",
                "fwd_tile_wgmma<D, kOwn * 64, kTile>(",
                "fwd_tile_wgmma<D - 64, kOwn * 64, kTile>("),
    # warpgroup 1's column offset into V: both read V's first blocks
    "v_columns": ("attention_wgmma.cuh", "bsa_fwd_dsplit_wgmma_kernel",
                  "kTileBytes + v_blk * kColBytes);",
                  "kTileBytes);"),
}


def test_dsplit_forward_limit_rejects_a_short_depth_or_offset(
        card, tmp_path, monkeypatch):
    """The bf16 limit tells bsa_fwd_dsplit_wgmma_kernel from a broken
    one: the flash source is rebuilt beside a copy of attention_wgmma.cuh
    whose warpgroups leave the last 64 columns of Q and K out of their
    scores, and beside one whose second warpgroup multiplies p by V's
    first column blocks; at flash's
    wide shape (BH 16, S 1024, causal) at D 512 and D 320 each result
    must miss REL_TOL, while the right kernel meets it. Prints both
    readings."""
    import ctypes

    from paddle_tpu_torch.ops.flash_attention import flash_fwd

    cases = {}
    for d in (320, 512):
        q, k, v, _ = flash_inputs(16, 1024, 1024, d, torch.bfloat16, card,
                                  seed=41 + d)
        args = (True, d ** -0.5, 0.0, 0)
        cases[d] = (lambda q=q, k=k, v=v, a=args, **kw:
                    flash_fwd(q, k, v, *a, **kw)[0])
    want = {d: fn(impl="torch") for d, fn in cases.items()}
    right = {d: rel_err(fn(), want[d]) for d, fn in cases.items()}
    procs = {kind: _build_mutant(kind, tmp_path / kind, DSPLIT_MUTATIONS,
                                 "flash_attention.cu")
             for kind in DSPLIT_MUTATIONS}
    broken_err = {}
    for kind, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out.decode()[-2000:]
        monkeypatch.setitem(_build._LIBS, "flash_attention",
                            ctypes.CDLL(str(lib)))
        for d, fn in cases.items():
            broken_err[kind, d] = rel_err(fn(), want[d])
    print(f"D-split forward bf16 rel err, right kernel: {right}; broken: "
          f"{broken_err}; limit {REL_TOL[torch.bfloat16]}")
    for d in cases:
        assert right[d] <= REL_TOL[torch.bfloat16]
    for err in broken_err.values():
        assert err > REL_TOL[torch.bfloat16]



def _backward_agrees(fwd, dq, dkv, q, k, v, do, args, names, dtype):
    """One dQ call and one dK/dV call (on the plain forward's lse and
    delta) each launch their kernel once, and agree with the plain
    versions; rows that see no column (lse -inf) get dq 0, kv rows where
    the plain dk and dv are both 0 (no row sees them) dk and dv 0. (Which
    kernel ran is read from the profiler in
    test_backward_dispatch_takes_the_wgmma_list_kernels.)"""
    out, lse = fwd(q, k, v, *args, impl="torch")
    delta = (do.float() * out.float()).sum(-1)
    got = {}
    for kind, call, name in (("dq", dq, names[1]), ("dkv", dkv, names[2])):
        _build.reset_launches()
        got[kind] = call(q, k, v, do, lse, delta, *args)
        torch.cuda.synchronize()
        assert _build.launches() == {name: 1}
    want_dq = dq(q, k, v, do, lse, delta, *args, impl="torch")
    want_dkv = dkv(q, k, v, do, lse, delta, *args, impl="torch")
    _close(got["dq"], want_dq, dtype)
    assert (got["dq"][torch.isinf(lse)] == 0).all()
    unseen = (want_dkv[0].float().abs().amax(-1) == 0) & (
        want_dkv[1].float().abs().amax(-1) == 0)
    for a, b in zip(got["dkv"], want_dkv):
        _close(a, b, dtype)
        assert (a[unseen] == 0).all()


@pytest.mark.parametrize("d", [320, 384, 448, 512])
@pytest.mark.parametrize("bh,sq,sk,causal,dropout", DSPLIT_FLASH_CASES)
def test_dsplit_backward_matches_plain_flash(card, bh, sq, sk, causal,
                                             dropout, d):
    """The bf16 flash dQ and dK/dV past D 256 (bsa_dq_dsplit_wgmma_kernel,
    whose two warpgroups split dQ's column blocks, and
    bsa_dkv_dsplit_wgmma_kernel, whose blocks split dK's and dV's) launch
    once each and agree with the plain versions, dropout keep bits and
    causal offsets included; and so do the fp32 dK/dV (bsa_dkv_tf32_kernel:
    32 kv rows a block, a role a warp, two warps a role and row group
    splitting the columns and the scores' depth) and dQ (wide_dq_kernel)
    at d, and at 192 and 256 beside 320, within the fp32 limits."""
    from paddle_tpu_torch.ops.flash_attention import (KERNEL_NAMES,
                                                      flash_dkv, flash_dq,
                                                      flash_fwd)

    q, k, v, do = flash_inputs(bh, sq, sk, d, torch.bfloat16, card,
                               seed=sq + sk + d + 1)
    _backward_agrees(flash_fwd, flash_dq, flash_dkv, q, k, v, do,
                     (causal, d ** -0.5, dropout, 77), KERNEL_NAMES,
                     torch.bfloat16)
    for dd in _tf32_dims(d):
        q, k, v, do = flash_inputs(bh, sq, sk, dd, torch.float32, card,
                                   seed=sq + sk + dd + 3)
        _backward_agrees(flash_fwd, flash_dq, flash_dkv, q, k, v, do,
                         (causal, dd ** -0.5, dropout, 77), KERNEL_NAMES,
                         torch.float32)


@pytest.mark.parametrize("d", [320, 384, 448, 512])
@pytest.mark.parametrize("bh,sq,sk,blk_q,blk_k,causal,empty",
                         DSPLIT_SPARSE_CASES)
def test_dsplit_backward_matches_plain_sparse(card, bh, sq, sk, blk_q,
                                              blk_k, causal, empty, d):
    """The bf16 block-sparse dQ and dK/dV past D 256 (the D-split kernels
    over the q-major and kv-major lists) launch once each and agree with
    the plain versions: rows that see no column and a kv block nothing
    attends give exact zeros; and so do the fp32 dK/dV
    (bsa_dkv_tf32_kernel) and dQ at d, and at 192 and 256 beside 320,
    within the fp32 limits."""
    from paddle_tpu_torch.ops.block_sparse_attention import (KERNEL_NAMES,
                                                             bsa_dkv, bsa_dq,
                                                             bsa_fwd)

    spec, q, k, v, do = bsa_case(bh, sq, sk, d, blk_q, blk_k, causal, empty,
                                 torch.bfloat16, card)
    _backward_agrees(bsa_fwd, bsa_dq, bsa_dkv, q, k, v, do,
                     (spec, causal, d ** -0.5), KERNEL_NAMES, torch.bfloat16)
    for dd in _tf32_dims(d):
        spec, q, k, v, do = bsa_case(bh, sq, sk, dd, blk_q, blk_k, causal,
                                     empty, torch.float32, card)
        _backward_agrees(bsa_fwd, bsa_dq, bsa_dkv, q, k, v, do,
                         (spec, causal, dd ** -0.5), KERNEL_NAMES,
                         torch.float32)


# the D-split backward broken four ways: kind -> (file, kernel, a line of
# it, the line broken); the kind's first word names the output it breaks
DSPLIT_BWD_MUTATIONS = {
    # S and dP leave their last 64 columns of depth out
    "dq_depth": ("attention_wgmma.cuh", "bsa_dq_dsplit_wgmma_kernel",
                 "dq_tile_wgmma<D, kOwn * 64, R, kTile>(",
                 "dq_tile_wgmma<D - 64, kOwn * 64, R, kTile>("),
    # warpgroup 1 multiplies ds by K's first column blocks
    "dq_columns": ("attention_wgmma.cuh", "bsa_dq_dsplit_wgmma_kernel",
                   "((j + 1) / kSlots) & 1); }, own0);",
                   "((j + 1) / kSlots) & 1); }, 0);"),
    # role P's S^T leaves its last 64 columns of depth out
    "dkv_depth": ("attention_wgmma.cuh", "bsa_dkv_dsplit_wgmma_kernel",
                  "dkv_p_tile_wgmma<D, kOwn * 64, R>(",
                  "dkv_p_tile_wgmma<D - 64, kOwn * 64, R>("),
    # part 1's role dS multiplies ds^T by Q's first column blocks
    "dkv_columns": ("attention_wgmma.cuh", "bsa_dkv_dsplit_wgmma_kernel",
                    "i + 1 < n_t, own0, then);",
                    "i + 1 < n_t, 0, then);"),
}


def test_dsplit_backward_limit_rejects_a_short_depth_or_offset(
        card, tmp_path, monkeypatch):
    """The bf16 limit tells the D-split dQ and dK/dV from broken ones: the
    flash source is rebuilt beside copies of attention_wgmma.cuh whose dQ
    warpgroups leave the last 64 columns of Q, K, dO and V out of S and
    dP, whose second dQ warpgroup multiplies ds by K's first column
    blocks, whose dK/dV role P leaves the last 64 columns out of S^T, and
    whose second dK/dV part multiplies ds^T by Q's first column blocks; at
    flash's wide shape (BH 16, S 1024, causal) at D 512 and D 320 each
    result must miss REL_TOL, while the right kernels meet it; then the
    3xTF32 mutants (_tf32_mutants_miss) must miss the fp32 limits. Prints
    the readings."""
    import ctypes

    cases = {}
    for d in (320, 512):
        q, k, v, do = flash_inputs(16, 1024, 1024, d, torch.bfloat16, card,
                                   seed=51 + d)
        args = (True, d ** -0.5, 0.0, 0)
        for kind in ("dq", "dkv"):
            cases[kind, d] = (lambda kind=kind, t=(q, k, v, do), a=args,
                              **kw: _flash_case(kind, *t, a, **kw))
    want = {case: fn(impl="torch") for case, fn in cases.items()}
    right = {case: rel_err(fn(), want[case]) for case, fn in cases.items()}
    procs = {kind: _build_mutant(kind, tmp_path / kind, DSPLIT_BWD_MUTATIONS,
                                 "flash_attention.cu")
             for kind in DSPLIT_BWD_MUTATIONS}
    broken_err = {}
    for kind, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out.decode()[-2000:]
        monkeypatch.setitem(_build._LIBS, "flash_attention",
                            ctypes.CDLL(str(lib)))
        for (out_kind, d), fn in cases.items():
            if kind.startswith(out_kind + "_"):
                broken_err[kind, d] = rel_err(fn(), want[out_kind, d])
    print(f"D-split backward bf16 rel err, right kernels: {right}; broken: "
          f"{broken_err}; limit {REL_TOL[torch.bfloat16]}")
    for err in right.values():
        assert err <= REL_TOL[torch.bfloat16]
    assert len(broken_err) == 2 * len(DSPLIT_BWD_MUTATIONS)
    for err in broken_err.values():
        assert err > REL_TOL[torch.bfloat16]
    _tf32_mutants_miss(card, tmp_path / "tf32", monkeypatch)


# bsa_fwd_tf32_kernel and bsa_dkv_tf32_kernel (attention_tf32.cuh), the
# fp32 forward and dK/dV at padded D 192..512 (3xTF32 on the tensor
# cores), are held by checks in the D-split tests' cases, the determinism
# and dispatch tests and the D-split backward's limit test, not by test
# ids of their own: the count of ids moves how `pytest -n` (xdist) cuts
# the suite into chunks, and with it which worker runs what.
def _tf32_dims(d):
    """The fp32 head dims a D-split case at head dim d also runs: d, and
    192 and 256 beside the first, 320."""
    return (192, 256, d) if d == 320 else (d,)


# the 3xTF32 kernels broken: kind -> (file, function, a line of it, the
# line broken); the kind's first word names the output it breaks ("tf32"
# both)
TF32_MUTATIONS = {
    # every product plain TF32: the hi x hi term alone
    "tf32_plain": ("attention_tf32.cuh", "mma_3xtf32",
                   "  mma_tf32(d, a.lo, bh0, bh1);\n"
                   "  mma_tf32(d, a.hi, bl0, bl1);\n", ""),
    # the forward's scores leave Q K^T's last 64 columns of depth out (of
    # each warp's part)
    "fwd_depth": ("attention_tf32.cuh", "bsa_fwd_tf32_kernel",
                  "BN, cb0,\n                            cb0 + nb);",
                  "BN, cb0,\n                            cb0 + nb - 2);"),
    # the forward's column parts past the first multiply p by V's first
    # columns
    "fwd_columns": ("attention_tf32.cuh", "bsa_fwd_tf32_kernel",
                    "pv_3xtf32<BN / 8, kCols>(o, s, v_t, BN, cb0, nb);",
                    "pv_3xtf32<BN / 8, kCols>(o, s, v_t, BN, 0, nb);"),
    # S^T and dP^T leave the last 64 columns of depth out (of each part's)
    "dkv_depth": ("attention_tf32.cuh", "bsa_dkv_tf32_kernel",
                  "item, R, cb0, cb0 + nb);",
                  "item, R, cb0, cb0 + nb - 2);"),
    # role dS's column parts past the first multiply ds^T by Q's first
    # columns
    "dkv_columns": ("attention_tf32.cuh", "bsa_dkv_tf32_kernel",
                    "pv_3xtf32<R / 8, kCols>(acc, sc, q_t, R, cb0, nb);",
                    "pv_3xtf32<R / 8, kCols>(acc, sc, q_t, R, 0, nb);"),
}


def _tf32_mutants_miss(card, out_dir, monkeypatch):
    """The fp32 limits tell the 3xTF32 forward and dK/dV from broken ones:
    the flash source is rebuilt beside copies of attention_tf32.cuh whose
    products are plain TF32 (no correction terms), whose forward scores
    or dK/dV S^T and dP^T leave the last 64 columns of a part's depth
    out, and whose column parts past the first read V's (forward) or Q's
    (dK/dV) first columns; at BH 4, S 1024, causal, D 256 and 512, each result a
    mutant breaks must miss REL_TOL, while the right kernels meet the
    limits. Prints both readings."""
    import ctypes

    cases = {}
    for d in (256, 512):
        q, k, v, do = flash_inputs(4, 1024, 1024, d, torch.float32, card,
                                   seed=61 + d)
        args = (True, d ** -0.5, 0.0, 0)
        for kind in ("fwd", "dkv"):
            cases[kind, d] = (lambda kind=kind, t=(q, k, v, do), a=args,
                              **kw: _flash_case(kind, *t, a, **kw))
    want = {case: fn(impl="torch") for case, fn in cases.items()}
    right = {case: rel_err(fn(), want[case]) for case, fn in cases.items()}
    for (kind, d), fn in cases.items():
        _close(fn(), want[kind, d], torch.float32)
    out_dir.mkdir()
    procs = {kind: _build_mutant(kind, out_dir / kind, TF32_MUTATIONS,
                                 "flash_attention.cu")
             for kind in TF32_MUTATIONS}
    broken_err = {}
    for kind, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out.decode()[-2000:]
        monkeypatch.setitem(_build._LIBS, "flash_attention",
                            ctypes.CDLL(str(lib)))
        for (out_kind, d), fn in cases.items():
            if kind.startswith(("tf32_", out_kind + "_")):
                broken_err[kind, out_kind, d] = rel_err(fn(),
                                                        want[out_kind, d])
    _build._LIBS.pop("flash_attention")  # the right library again
    print(f"3xTF32 fp32 rel err, right kernels: {right}; broken: "
          f"{broken_err}; limit {REL_TOL[torch.float32]}")
    assert len(broken_err) == 4 + 4 * 2
    for err in broken_err.values():
        assert err > REL_TOL[torch.float32]


# The tests below that read kernel names from torch.profiler come after
# every test that launches a kernel for the first time: a kernel first
# launched (its module loaded, lazily) after a profiler window has torn
# CUPTI down leaves the later windows of the process without device
# activity (an H100 under torch 2.11 and CUDA 12.8).


def _device_kernels(call):
    """The device kernels one ``call()`` ran, by name (profiler). A window
    that records no device activity at all (seen at random late in a full
    run of this file) is tried again, three windows in all, as
    chip_smoke.py's check_ran does; a window that records other kernels
    is returned as it is."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    return names


def _ran(kernel: str, names) -> bool:
    # demangled (kernel<...>(...)) or mangled (kernelI...) names
    return any(kernel + c in n for n in names for c in "<I(")


@pytest.mark.parametrize("family", ["flash", "sparse"])
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 192),
    (torch.bfloat16, 256), (torch.bfloat16, 320), (torch.bfloat16, 512),
    (torch.float32, 128), (torch.float32, 256), (torch.bfloat16, 384),
    (torch.bfloat16, 448)])
def test_forward_dispatch_takes_the_wgmma_list_kernel(card, family, dtype,
                                                       d):
    """The forward's dispatch: bsa_fwd_wgmma_kernel runs the bf16
    block-sparse forward at padded D 64..256 and the bf16 flash forward at
    192 and 256; fa_fwd_wgmma_kernel the bf16 flash forward at 64 and
    128; bsa_fwd_dsplit_wgmma_kernel the bf16 forward of both families at
    320, 384, 448 and 512; bsa_fwd_tf32_kernel the fp32 forward of both
    families past 128 (the fp32 256 case checks 192, 256, 320 and 512);
    fp32 at 64 and 128 each family's FMA kernel. One launch, counted,
    within the limits."""
    from paddle_tpu_torch.ops.block_sparse_attention import (
        KERNEL_NAMES as BSA_NAMES, bsa_fwd)
    from paddle_tpu_torch.ops.flash_attention import (
        KERNEL_NAMES as FA_NAMES, flash_fwd)

    tf32 = dtype == torch.float32 and d == 256
    for d in (192, 256, 320, 512) if tf32 else (d,):
        if family == "flash":
            q, k, v, _ = flash_inputs(2, 256, 256, d, dtype, card, seed=d)
            args = (True, d ** -0.5, 0.0, 0)
            fwd, name = flash_fwd, FA_NAMES[0]
        else:
            spec, q, k, v, _ = bsa_case(2, 512, 512, d, 128, 128, False,
                                        None, dtype, card)
            args = (spec, False, d ** -0.5)
            fwd, name = bsa_fwd, BSA_NAMES[0]
        fwd(q, k, v, *args)  # builds and loads the kernels first
        _build.reset_launches()
        fwd(q, k, v, *args)
        assert _build.launches() == {name: 1}
        ran = _device_kernels(lambda: fwd(q, k, v, *args))
        bf16 = dtype == torch.bfloat16
        if bf16 and d > 256:
            want = "bsa_fwd_dsplit_wgmma_kernel"
        elif bf16 and d <= 256 and (family == "sparse" or d > 128):
            want = "bsa_fwd_wgmma_kernel"
        elif bf16 and d <= 128:
            want = "fa_fwd_wgmma_kernel"
        elif d > 128:
            want = "bsa_fwd_tf32_kernel"
        else:
            want = ("fa_fwd_kernel" if family == "flash"
                    else "bsa_fwd_kernel")
        assert _ran(want, ran), (want, ran)
        assert (want == "bsa_fwd_wgmma_kernel"
                or not _ran("bsa_fwd_wgmma_kernel", ran))
        got, got_lse = fwd(q, k, v, *args)
        ref, ref_lse = fwd(q, k, v, *args, impl="torch")
        _close(got, ref, dtype)
        _close(got_lse, ref_lse, torch.float32)


def _backward_case(family, dtype, d, device):
    """A small call of the family's dQ and dK/dV entry points (on their
    plain forward's lse and delta): (dq call, dkv call, launch names)."""
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import flash_attention as fa

    if family == "flash":
        q, k, v, do = flash_inputs(2, 256, 256, d, dtype, device, d)
        args = (True, d ** -0.5, 0.0, 0)
        mod, pfx = fa, "flash"
    else:
        spec, q, k, v, do = bsa_case(2, 512, 512, d, 128, 128, False, None,
                                     dtype, device)
        args = (spec, False, d ** -0.5)
        mod, pfx = bsa, "bsa"
    fwd, dq, dkv = (getattr(mod, f"{pfx}_{n}") for n in ("fwd", "dq", "dkv"))
    out, lse = fwd(q, k, v, *args, impl="torch")
    delta = (do.float() * out.float()).sum(-1)
    return ((lambda **kw: dq(q, k, v, do, lse, delta, *args, **kw)),
            (lambda **kw: dkv(q, k, v, do, lse, delta, *args, **kw)),
            mod.KERNEL_NAMES)


@pytest.mark.parametrize("family", ["flash", "sparse"])
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 128), (torch.bfloat16, 192), (torch.bfloat16, 256),
    (torch.bfloat16, 512), (torch.float32, 256), (torch.bfloat16, 320),
    (torch.bfloat16, 384), (torch.bfloat16, 448)])
def test_backward_dispatch_takes_the_wgmma_list_kernels(card, family, dtype,
                                                        d):
    """The backward's dispatch: bf16 at padded D 192 and 256 runs
    bsa_dq_wgmma_kernel and bsa_dkv_split_wgmma_kernel in both families;
    bf16 at 320, 384, 448 and 512 bsa_dq_dsplit_wgmma_kernel and
    bsa_dkv_dsplit_wgmma_kernel in both families; fp32 past 128
    wide_dq_kernel (FMA) and bsa_dkv_tf32_kernel (3xTF32) in both
    families (the fp32 256 case checks 192, 256, 320 and 512); bf16 at
    128 on each family's own wgmma kernels. One launch each, counted,
    within the limits."""
    tf32 = dtype == torch.float32 and d == 256
    for d in (192, 256, 320, 512) if tf32 else (d,):
        dq, dkv, names = _backward_case(family, dtype, d, card)
        bf16 = dtype == torch.bfloat16
        if bf16 and d in (192, 256):
            want = ("bsa_dq_wgmma_kernel", "bsa_dkv_split_wgmma_kernel")
        elif bf16 and d > 256:
            want = ("bsa_dq_dsplit_wgmma_kernel",
                    "bsa_dkv_dsplit_wgmma_kernel")
        elif d > 128:
            want = ("wide_dq_kernel", "bsa_dkv_tf32_kernel")
        elif family == "flash":
            want = ("fa_dq_wgmma_kernel", "fa_dkv_wgmma_kernel")
        else:
            want = ("bsa_dq_wgmma_kernel", "bsa_dkv_wgmma_kernel")
        for call, name, kernel in zip((dq, dkv), names[1:], want):
            call()  # builds and loads the kernels first
            _build.reset_launches()
            call()
            assert _build.launches() == {name: 1}
            ran = _device_kernels(call)
            assert _ran(kernel, ran), (kernel, ran)
            got, ref = call(), call(impl="torch")
            if torch.is_tensor(got):
                got, ref = (got,), (ref,)
            for a, b in zip(got, ref):
                _close(a, b, dtype)


@pytest.mark.parametrize("family", ["flash", "sparse"])
@pytest.mark.parametrize("d", [192, 256, 320, 512])
def test_split_dkv_is_deterministic(card, family, d):
    """bsa_dkv_split_wgmma_kernel (D 192, 256) and
    bsa_dkv_dsplit_wgmma_kernel (D 320, 512) keep the reference's split
    from dQ and use no atomics: two runs give the same bits (flash with
    causal dropout, block-sparse on a BigBird-like pattern with an empty
    kv block); so does the fp32 bsa_dkv_tf32_kernel at D 256 and 512."""
    from paddle_tpu_torch.ops import block_sparse_attention as bsa
    from paddle_tpu_torch.ops import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32)[:1 + (d in (256, 512))]:
        q, k, v, do = flash_inputs(4, 1024, 1024, d, dtype, card, d)
        if family == "flash":
            args = (True, d ** -0.5, 0.1, 5)
            fwd, dkv = fa.flash_fwd, fa.flash_dkv
        else:
            mask = bigbird_like(8, seed=d)
            mask[:, 3] = False
            args = (bsa.block_mask_spec(mask, 1024, 1024, False), False,
                    d ** -0.5)
            fwd, dkv = bsa.bsa_fwd, bsa.bsa_dkv
        out, lse = fwd(q, k, v, *args, impl="torch")
        delta = (do.float() * out.float()).sum(-1)
        first = dkv(q, k, v, do, lse, delta, *args)
        second = dkv(q, k, v, do, lse, delta, *args)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


# bsa_dkv_split_wgmma_kernel broken two ways: kind -> (file, function, a
# line of it, the line broken)
SPLIT_MUTATIONS = {
    # the p hand-over: each thread of role dS reads its neighbour's p
    "p_exchange": ("attention_wgmma.cuh", "dkv_ds_tile_wgmma",
                   "p[j] = p_s[j * 128 + tid];",
                   "p[j] = p_s[j * 128 + (tid ^ 1)];"),
    # the causal prefix cut one q tile too long: the tile on the diagonal
    # is never walked
    "prefix_cut": ("attention_wgmma.cuh", "bsa_dkv_split_wgmma_kernel",
                   "max(c0 - offset - entry_row(b), 0) / kTile);",
                   "(max(c0 - offset - entry_row(b), 0) + kTile) / kTile);"),
}


def test_split_dkv_limit_rejects_a_broken_p_exchange_or_prefix_cut(
        card, tmp_path, monkeypatch):
    """The bf16 limit tells the split dK/dV kernel from a broken one: the
    flash source is rebuilt beside a copy of attention_wgmma.cuh whose
    role dS reads its neighbour's p, and beside one whose causal walk
    cuts one q tile too many; at flash's wide shape (BH 16, S 1024,
    causal, D 256) each result must miss REL_TOL, while the right kernel
    meets it. Prints both readings."""
    import ctypes

    q, k, v, do = flash_inputs(16, 1024, 1024, 256, torch.bfloat16, card,
                               seed=31)
    args = (True, 256 ** -0.5, 0.0, 0)
    want = _flash_case("dkv", q, k, v, do, args, impl="torch")
    right = rel_err(_flash_case("dkv", q, k, v, do, args), want)
    procs = {kind: _build_mutant(kind, tmp_path / kind, SPLIT_MUTATIONS,
                                 "flash_attention.cu")
             for kind in SPLIT_MUTATIONS}
    broken_err = {}
    for kind, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out.decode()[-2000:]
        monkeypatch.setitem(_build._LIBS, "flash_attention",
                            ctypes.CDLL(str(lib)))
        broken_err[kind] = rel_err(_flash_case("dkv", q, k, v, do, args),
                                   want)
    print(f"split dK/dV bf16 rel err, right kernel: {right}; broken: "
          f"{broken_err}; limit {REL_TOL[torch.bfloat16]}")
    assert right <= REL_TOL[torch.bfloat16]
    for kind in SPLIT_MUTATIONS:
        assert broken_err[kind] > REL_TOL[torch.bfloat16]


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
