#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. ``device`` — needs a CUDA card (exits non-zero without one); prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. ``build`` — compiles every CUDA kernel of the port from the sources in
   this checkout (one ``nvcc`` per source, started together).
3. ``kernel`` — the ragged paged attention kernel against its plain
   PyTorch version at the serving path's full-width shapes (H=16, D=128,
   B=16, MAXB=128, TQ=8) on a seeded ragged mix of decode rows, prefill
   tiles at unaligned offsets and inactive segments, in fp32 and bf16:
   max abs and relative norm errors against their limits; median times
   over >= 20 launches with the L2 cache flushed before each, the bytes
   and operations the inputs need, and the resulting bound.
   ``decode`` — the per-row (decode) paged attention kernel behind
   ``ragged_paged_attention``, its path being that entry point: (b) right
   after ``kernel``, a decode batch that makes the card work (128 rows at
   H=16, D=128, B=16, MAXB=128, seeded lengths 1..2048 plus rows of 0,
   2048 and 3000 tokens, every row's blocks distinct in a pool of
   16,384 + 1 blocks) in fp32 and bf16; (a) once the serve phase has run,
   the rows of its first profiled decode-only step, on that step's layer-0
   bf16 pools, held against the plain version and against the segmented
   kernel on the same rows. Both: one call through the entry point with
   the launch counts reset just before and read just after, errors
   against the element and relative-norm limits, median times with the
   L2 cache flushed, the plain version's time, bytes, operations, the
   bound and the time over the bound.
4. ``model`` — GPT-3 1.3B width (``gpt3_1p3b``, seeded random weights)
   in fp32: one ``token_step`` on a packed mixed prefill+decode batch with
   the kernel and with the plain attention; logits must agree.
5. ``serve`` — the same model in bf16 behind ``Engine``: 16 seeded
   requests (32-1024 prompt tokens, 64 new tokens, half greedy, half
   temperature 0.8 / top-k 50) arriving in two waves. Every request must
   finish by length and the KV pool must drain. Launch counts are reset
   just before and read just after: every kernel must have run. A second
   pass over the same prompts in the same waves profiles its mixed step
   (step 4: decode rows and prefill chunks) and three decode-only steps:
   device time by kernel, the attention kernel's time from the profiler.
6. ``prefix`` — the prefix cache on: 8 requests sharing a 640-token
   prompt; the 7 that follow the first must skip its prefill.
   ``preempt`` — the serve traffic on the full-width model at 4 layers in
   fp32, with the serve pool and with one too small for it: preemption
   must happen in the small pool only, both pools must drain, and the
   streams must be equal token for token.
7. ``flash`` — the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain PyTorch versions at the training path's shapes
   (BH=128, S=1024, D=128, causal) in fp32 and bf16, plus a bf16 dropout
   case: max abs error and relative norm error against their limits,
   median times over >= 20 launches with the L2 cache flushed, bytes,
   operations, the bound, and each kernel's ptxas registers and spills;
   ``flash_library`` times torch's scaled_dot_product_attention forward
   and backward on the same bf16 inputs as the yardstick (25 launches
   each, the backward three times over) and names the backend it ran.
8. ``xent`` — the two fused softmax cross-entropy kernels (forward,
   backward) against their plain PyTorch versions at the training path's
   shapes (8 x 1024 rows, V=50304) in fp32 and bf16: errors against the
   limits, median times with the L2 cache flushed, bytes, operations and
   the bound; torch's ``cross_entropy`` (per-row losses) as the
   forward's yardstick.
9. ``sparse`` — the three block-sparse attention kernels (forward, dQ,
   dK/dV) against their plain versions at the sparse path's shapes (B=2,
   H=16, S=4096, D=128) on BigBird's pattern at 128-token blocks (window
   3, global 2, random 3), fp32 and bf16, and a causal bf16 case at
   blk_q 256 / blk_k 128 whose fully masked rows must come back 0: errors
   against the limits, median times with the L2 cache flushed, bytes,
   operations and the bound from the active pairs; ``sparse_library``
   times torch's scaled_dot_product_attention with the expanded boolean
   mask, forward and backward, as the yardstick.
10. ``sparse_path`` — ``nn.functional.sparse_attention`` as users call
   it, fp32, [2, 16, 4096, 128] with BigBird's pattern as an int32 CSR,
   forward and backward twice: each kernel launches once a call, the
   second call takes the route from the cache with no host copy, and out
   and the q/k/v gradients agree with the dense masked composition.
11. ``layer_norm`` — the LayerNorm kernel against its plain version at
   [8192, 2048] and [16, 2048], fp32 and bf16, with
   ``torch.nn.functional.layer_norm`` as the yardstick; then
   ``fused_layer_norm`` forward and backward through autograd, kernel
   against plain route (``layer_norm_path``).
12. ``train_parity`` — GPT-3 1.3B width at 2 layers in fp32: one forward
   and backward through the kernels (attention and cross-entropy) and
   one through their plain versions; the loss and every gradient must
   agree.
13. ``train`` — the training path: ``TrainStepper`` over the 24-layer GPT
   at GPT-3 1.3B width, O2, AdamW, batch 8 x 1024 on one seeded batch:
   2 warm-up and 10 timed steps, then one profiled step. The loss must
   fall, each flash kernel must launch 24 times per step and each
   cross-entropy kernel once.

Then one line listing every ported kernel with its numbers, and last
``{"ok": true, "device": {...}}``. Any failure raises, and the script exits
non-zero without printing the last line.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
TIME_REPS = 25

# Published peaks per card: (HBM bytes/s, fp32 non-tensor FLOP/s, bf16
# dense tensor FLOP/s), from NVIDIA's data sheets. The most specific name
# fragment that matches the card's name wins.
_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),  # H100 SXM
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_peaks(name: str):
    for frag, hbm, fp32, bf16 in _PEAKS:
        if frag in name:
            return {"name": frag, "hbm_bytes_per_s": hbm,
                    "fp32_flops": fp32, "bf16_flops": bf16}
    raise RuntimeError(f"no published peaks recorded for {name!r}")


# ------------------------------------------------------------------ timing

class Timer:
    """Median device time of a callable over ``reps`` launches (CUDA
    events around each launch), with the L2 cache flushed before each so
    every launch finds its inputs in device memory, as a serving step's
    attention does (the 24 layers' pools far exceed the 50 MB L2)."""

    def __init__(self, device):
        self._flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                  device=device)

    def median_ms(self, fn, reps: int = TIME_REPS) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


# ------------------------------------------------------------- the kernel

def rpa_inputs(rng, device, dtype, n_heads=16, head_dim=128, block_size=16,
               max_blocks=128, tq=8, num_blocks=2048, token_budget=256):
    """A seeded step of the serving path at full width: decode rows with
    caches of 1..2048 tokens, 8-row prefill tiles at offsets not aligned
    to the block size, and inactive segments padding the step to
    ``token_budget`` rows (their rows must come back exactly zero)."""
    cap = block_size * max_blocks
    segs = [(1, int(n) - 1) for n in
            np.concatenate([[1, cap], rng.integers(2, cap, 14)])]
    while sum(r for r, _ in segs) + tq <= token_budget - 32:
        pos0 = int(rng.integers(0, (cap - tq) // block_size)) * block_size
        segs.append((tq, pos0 + int(rng.integers(1, block_size))))
    n_live = sum(r for r, _ in segs)
    n_seg = token_budget  # the pad rows point at inactive segments
    seg_tables = rng.integers(0, num_blocks, (n_seg, max_blocks))
    seg_pos = np.zeros(n_seg, np.int64)
    seg_rows = np.zeros(n_seg, np.int64)
    seg_row_idx = np.zeros((n_seg, tq), np.int64)
    row_gather = np.zeros(token_budget, np.int64)
    r = 0
    for s, (n, pos0) in enumerate(segs):
        seg_pos[s], seg_rows[s] = pos0, n
        seg_row_idx[s, :n] = np.arange(r, r + n)
        row_gather[r:r + n] = s * tq + np.arange(n)
        r += n
    row_gather[n_live:] = len(segs) * tq
    as_i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 31)))
    randn = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)
    pool_shape = (num_blocks, block_size, n_heads, head_dim)
    args = (randn(token_budget, n_heads, head_dim), randn(*pool_shape),
            randn(*pool_shape), as_i32(seg_tables), as_i32(seg_pos),
            as_i32(seg_rows), as_i32(seg_row_idx), as_i32(row_gather))
    return args, n_live, len(segs)


def paged_work(q, k_pool, tables, seg_pos, seg_rows, meta_bytes):
    """Bytes and operations one paged-attention call needs, from its own
    inputs (numpy metadata). Segment ``s`` with ``seg_rows[s] > 0`` holds
    rows at cache positions ``seg_pos[s] + i``; a row attends every
    position up to its own, clamped to the table's MAXB * B. Bytes: q and
    out once, K and V of each distinct (block, offset) position the
    segments attend once, the table entries they read, and
    ``meta_bytes`` of other metadata. Operations: 4 * D per head per (row,
    attended token), QK^T and PV."""
    t, h, d = q.shape
    bs, elem = k_pool.shape[1], q.element_size()
    cap = bs * tables.shape[1]
    positions, entries, attended = [np.zeros(0, np.int64)], 0, 0
    for s in np.flatnonzero(seg_rows > 0):
        ends = np.minimum(int(seg_pos[s]) + np.arange(1, seg_rows[s] + 1),
                          cap)
        blocks = tables[s, :-(-int(ends[-1]) // bs)].astype(np.int64)
        positions.append((blocks[:, None] * bs
                          + np.arange(bs)).ravel()[:ends[-1]])
        entries += len(blocks)
        attended += int(ends.sum())
    n_pos = len(np.unique(np.concatenate(positions)))
    n_bytes = 2 * (n_pos + t) * h * d * elem + 4 * entries + meta_bytes
    return n_bytes, 4 * attended * h * d


def rpa_work(args):
    """:func:`paged_work` of one segmented call: its kernel also reads
    ``seg_pos`` and ``seg_rows`` and the live slots of ``seg_row_idx``
    (not ``row_gather``)."""
    q, k_pool, _, seg_tables, seg_pos, seg_rows = args[:6]
    pos, rows = seg_pos.cpu().numpy(), seg_rows.cpu().numpy()
    meta_bytes = 4 * (2 * len(rows) + int(rows.clip(0).sum()))
    return paged_work(q, k_pool, seg_tables.cpu().numpy(), pos, rows,
                      meta_bytes)


def rpa_bound(args, peaks):
    """The least time the card could take for one call (:func:`bound_of`
    of its work)."""
    return bound_of(*rpa_work(args), args[0].dtype, peaks)


class AttentionArgs:
    """For the engine steps run inside it: the number of attention calls
    the model makes and the arguments of the first (every layer's call in
    a step has the same segments, so the same work)."""

    def __init__(self):
        import paddle_tpu_torch.serving.model as serving_model

        self._module = serving_model
        self._real = serving_model.ragged_paged_attention_chunked
        self.args, self.calls = None, 0

    def __enter__(self):
        self._module.ragged_paged_attention_chunked = self._record
        return self

    def __exit__(self, *exc):
        self._module.ragged_paged_attention_chunked = self._real

    def _record(self, *args, **kwargs):
        if self.args is None:
            self.args = args
        self.calls += 1
        return self._real(*args, **kwargs)


def kernel_ms(prof, fragment: str):
    """Device ms and launches of the profiled kernels whose name holds
    ``fragment``."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and fragment in e.name]
    return sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events)


def attention_report(prof, probe, n_steps, peaks):
    """The attention kernel's device time over ``n_steps`` profiled steps
    (the profiler's kernel time of ``rpa_chunked_kernel``, no host gaps),
    per step and per call, beside the bound of the first call."""
    ms, launches = kernel_ms(prof, "rpa_chunked_kernel")
    if launches != probe.calls:
        raise AssertionError(f"profiler saw {launches} attention kernels, "
                             f"the model made {probe.calls} calls")
    bound = rpa_bound(probe.args, peaks)
    return dict(calls=launches, attention_ms=ms / n_steps,
                ms_per_call=ms / launches,
                rows=int(probe.args[0].shape[0]),
                live_segments=int((probe.args[5] > 0).sum().item()),
                bytes_per_call=bound["bytes"], ops_per_call=bound["ops"],
                bound_ms_per_call=bound["bound_ms"],
                bound_by=bound["bound_by"],
                x_bound=ms / launches / bound["bound_ms"])


def phase_kernel(device, peaks, timer):
    from paddle_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention_chunked

    rng = np.random.default_rng(SEED)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        args, n_live, n_segs = rpa_inputs(rng, device, dtype)
        kernel = lambda: ragged_paged_attention_chunked(*args, impl="cuda")
        plain = lambda: ragged_paged_attention_chunked(*args, impl="torch")
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = rel_err(got, want)
        pad_zero = bool((got[n_live:] == 0).all().item())
        if not (err <= tol[dtype] and rel <= REL_TOL[dtype] and pad_zero
                and torch.isfinite(got).all().item()):
            raise AssertionError(
                f"kernel disagrees with the plain version ({dtype}): max "
                f"abs err {err} (tol {tol[dtype]}), relative norm err "
                f"{rel} (limit {REL_TOL[dtype]}), inactive rows zero: "
                f"{pad_zero}")
        ms, plain_ms = timer.median_ms(kernel), timer.median_ms(plain)
        res = dict(dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   tol=tol[dtype], rel_err=rel, rel_tol=REL_TOL[dtype],
                   inactive_rows_zero=pad_zero,
                   segments=n_segs, rows=n_live, ms=ms, plain_ms=plain_ms,
                   **rpa_bound(args, peaks), peaks_of=peaks["name"])
        emit("kernel", name="ragged_paged_attention_chunked", **res)
        results[res["dtype"]] = res
        del args
    return results


# ------------------------------------------- per-row (decode) attention

def rpa_row_work(q, k_pool, block_tables, seq_lens):
    """:func:`paged_work` of one per-row call: row ``s`` is the 1-row
    segment at position ``min(len, MAXB * B) - 1``; the kernel also reads
    ``seq_lens``."""
    lens = np.clip(seq_lens.cpu().numpy().astype(np.int64), 0,
                   k_pool.shape[1] * block_tables.shape[1])
    return paged_work(q, k_pool, block_tables.cpu().numpy(), lens - 1,
                      (lens > 0).astype(np.int64), 4 * len(lens))


def decode_batch(device, dtype, n_rows=128, heads=16, head_dim=128,
                 block_size=16, max_blocks=128):
    """A seeded decode batch at the serving width: lengths uniform in
    1..2048 plus rows of 0, 2048 and 3000 tokens (3000 attends its whole
    128-block table), every row's blocks distinct, drawn from a
    permutation of blocks 1..16,384 of a 16,385-block noise pool; table
    entries past a row's need are 0, a noise block no row owns."""
    rng = np.random.default_rng(SEED + 11)
    cap = block_size * max_blocks
    lens = np.concatenate([[0, cap, 3000],
                           rng.integers(1, cap + 1, n_rows - 3)])
    need = np.minimum(-(-lens // block_size), max_blocks)
    num_blocks = n_rows * max_blocks + 1
    perm = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((n_rows, max_blocks), np.int64)
    at = 0
    for r, n in enumerate(need):
        tables[r, :n] = perm[at:at + n]
        at += n
    g = torch.Generator(device=device).manual_seed(SEED + 12)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=device,
                                       dtype=dtype)
    pool_shape = (num_blocks, block_size, heads, head_dim)
    as_i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return (randn(n_rows, heads, head_dim), randn(*pool_shape),
            randn(*pool_shape), as_i32(tables), as_i32(lens))


def row_path(args, launches_of, reset_launches):
    """``ragged_paged_attention`` called as a user calls it, with the launch
    counts reset just before and read just after: the kernel must launch
    once. Returns the output and the launches."""
    from paddle_tpu_torch.ops import ragged_paged_attention

    reset_launches()
    out = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    launches = launches_of()
    if launches != {"ragged_paged_attention": 1}:
        raise AssertionError(f"ragged_paged_attention launched {launches}")
    return out, launches["ragged_paged_attention"]


def row_report(what, args, out, timer, peaks):
    """``out`` (the kernel's) against the plain version: limits, inactive
    rows exactly zero; then both timed, and the bound of the call."""
    from paddle_tpu_torch.ops import ragged_paged_attention

    want = ragged_paged_attention(*args, impl="torch")
    torch.cuda.synchronize()
    err, rel = agreement(what, out, want)
    dead = args[4] <= 0
    if not bool((out[dead] == 0).all().item()):
        raise AssertionError(f"{what}: inactive rows are not zero")
    dtype = args[0].dtype
    bound = bound_of(*rpa_row_work(*args[:2], *args[3:5]), dtype, peaks)
    ms = timer.median_ms(lambda: ragged_paged_attention(*args, impl="cuda"))
    plain_ms = timer.median_ms(
        lambda: ragged_paged_attention(*args, impl="torch"))
    return dict(dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                rel_err=rel, tol=TOL[dtype], rel_tol=REL_TOL[dtype],
                inactive_rows=int(dead.sum().item()),
                attended_tokens=int(args[4].clamp(
                    0, args[1].shape[1] * args[3].shape[1]).sum().item()),
                ms=ms, plain_ms=plain_ms, **bound,
                x_bound=ms / bound["bound_ms"], library_ms=None,
                peaks_of=peaks["name"])


def phase_decode_batch(device, peaks, timer, launches_of, reset_launches,
                       **shape):
    """(b): the per-row kernel on a decode batch that makes the card work,
    fp32 and bf16 (see :func:`decode_batch`, which takes ``shape``)."""
    results, launches = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        args = decode_batch(device, dtype, **shape)
        out, n = row_path(args, launches_of, reset_launches)
        launches += n
        res = row_report(f"ragged_paged_attention (decode batch, {dtype})",
                         args, out, timer, peaks)
        geometry = dict(rows=int(args[0].shape[0]),
                        heads=int(args[0].shape[1]),
                        head_dim=int(args[0].shape[2]),
                        block_size=int(args[1].shape[1]),
                        max_blocks=int(args[3].shape[1]),
                        pool_blocks=int(args[1].shape[0]),
                        pool_gb=args[1].numel() * args[1].element_size()
                        / 1e9)
        emit("decode", part="b_decode_batch", name="ragged_paged_attention",
             **geometry, **res)
        results[res["dtype"]] = res
        del args, out
    torch.cuda.empty_cache()
    return results, launches


def phase_decode_step(peaks, timer, step_args, launches_of, reset_launches):
    """(a): the rows of the serve phase's first profiled decode-only step,
    on that step's layer-0 bf16 pools: the per-row kernel against its
    plain version and against the segmented kernel's output for the same
    rows (1-row segments, as the engine packs them), both kernels timed
    on the same rows."""
    from paddle_tpu_torch.ops import ragged_paged_attention_chunked

    if step_args is None:
        raise AssertionError("the serve phase recorded no decode-only step")
    q, kp, vp, seg_tables, seg_pos, seg_rows, seg_row_idx = step_args[:7]
    live = seg_rows > 0
    if not bool((seg_rows[live] == 1).all().item()):
        raise AssertionError("the recorded step is not decode-only")
    rows = seg_row_idx[live, 0].long()
    args = (q[rows].contiguous(), kp, vp, seg_tables[live].contiguous(),
            (seg_pos[live] + 1).to(torch.int32).contiguous())
    out, launches = row_path(args, launches_of, reset_launches)
    res = row_report("ragged_paged_attention (serve decode step)", args, out,
                     timer, peaks)
    chunked = lambda: ragged_paged_attention_chunked(
        *step_args[:8], impl="cuda")
    row1 = chunked()[rows]
    torch.cuda.synchronize()
    err1, rel1 = agreement("ragged_paged_attention vs the segmented kernel",
                           out, row1)
    row1_ms = timer.median_ms(chunked)
    row1_bound = rpa_bound(step_args[:8], peaks)
    emit("decode", part="a_serve_decode_step", name="ragged_paged_attention",
         rows=int(rows.numel()), heads=int(q.shape[1]),
         head_dim=int(q.shape[2]), block_size=int(kp.shape[1]),
         max_blocks=int(seg_tables.shape[1]), **res,
         vs_chunked=dict(max_abs_err=err1, rel_err=rel1,
                         chunked_ms=row1_ms,
                         chunked_bound_ms=row1_bound["bound_ms"],
                         chunked_x_bound=row1_ms / row1_bound["bound_ms"],
                         row_over_chunked=res["ms"] / row1_ms))
    return launches


# -------------------------------------------------------------- the model

def random_weights(cfg, n_layers, device, seed=SEED, std=0.02):
    """Seeded random GPT weights (fp32, on ``device``) in the serving
    model's per-layer layout, biases and final LayerNorm included."""
    g = torch.Generator(device=device).manual_seed(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, d = cfg.num_heads, cfg.head_dim
    rnd = lambda *s: torch.randn(*s, generator=g, device=device) * std
    ones = lambda n: torch.ones(n, device=device)
    zeros = lambda n: torch.zeros(n, device=device)
    layers = [dict(ln_scale=ones(e), ln_bias=zeros(e),
                   qkv_w=rnd(3, h, d, e), qkv_b=rnd(3, h, d),
                   out_w=rnd(e, e), out_b=rnd(e),
                   ffn_ln_scale=ones(e), ffn_ln_bias=zeros(e),
                   ffn1_w=rnd(e, f), ffn1_b=rnd(f),
                   ffn2_w=rnd(f, e), ffn2_b=rnd(e))
              for _ in range(n_layers)]
    return dict(embedding=rnd(v, e), head=rnd(e, v), layers=layers,
                final_ln_scale=ones(e), final_ln_bias=zeros(e))


def build_model(cfg, weights, device, dtype):
    from paddle_tpu_torch.serving import GPTServingModel

    return GPTServingModel(
        weights["embedding"], weights["head"], weights["layers"],
        n_heads=cfg.num_heads, head_dim=cfg.head_dim, use_rope=True,
        max_position=cfg.max_position_embeddings,
        epsilon=cfg.layer_norm_epsilon,
        final_ln_scale=weights["final_ln_scale"],
        final_ln_bias=weights["final_ln_bias"], device=device, dtype=dtype)


def packed_step(rng, device, block_size=16, tq=8):
    """A packed mixed step with contexts up to the model length: 8 decode
    rows of distinct sequences and two 24-row prefill chunks (three 8-row
    tiles each) at unaligned offsets, each sequence with its own blocks.
    Returns (num_blocks, step tensors)."""
    cap = 2048
    seqs = [(int(n) - 1, 1) for n in
            np.concatenate([[1, cap], rng.integers(2, cap, 6)])]
    seqs += [(int(rng.integers(1, 60)) * block_size + 5, 24)
             for _ in range(2)]
    next_block = 0
    tokens, positions, row_seg = [], [], []
    seg_tables, seg_pos, seg_rows, seg_row_idx, row_gather = [], [], [], [], []
    maxb = cap // block_size
    for pos0, n in seqs:
        need = -(-(pos0 + n) // block_size)
        table = np.zeros(maxb, np.int64)
        table[:need] = np.arange(next_block, next_block + need)
        next_block += need
        for t0 in range(0, n, tq):
            rows = min(tq, n - t0)
            s = len(seg_pos)
            seg_tables.append(table)
            seg_pos.append(pos0 + t0)
            seg_rows.append(rows)
            idx = np.zeros(tq, np.int64)
            idx[:rows] = np.arange(len(tokens), len(tokens) + rows)
            seg_row_idx.append(idx)
            for i in range(rows):
                row_gather.append(s * tq + i)
                row_seg.append(s)
                positions.append(pos0 + t0 + i)
                tokens.append(int(rng.integers(0, 50304)))
    as_i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                       device=device)
    step = [as_i32(x) for x in (tokens, positions, seg_tables, seg_pos,
                                seg_rows, seg_row_idx, row_gather, row_seg)]
    return next_block, step


def phase_model(device, cfg, weights):
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 means fp32 here
    model = build_model(cfg, weights, device, torch.float32)
    rng = np.random.default_rng(SEED + 1)
    num_blocks, step = packed_step(rng, device)
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    shape = (num_blocks, 16, cfg.num_heads, cfg.head_dim)
    pools = [torch.randn(*shape, generator=g, device=device)
             for _ in range(2 * cfg.num_layers)]
    logits = {}
    for impl in ("cuda", "torch"):
        k = [p.clone() for p in pools[:cfg.num_layers]]
        v = [p.clone() for p in pools[cfg.num_layers:]]
        logits[impl] = model.token_step(k, v, *step, attn_impl=impl)
        del k, v
    torch.cuda.synchronize()
    got, want = logits["cuda"], logits["torch"]
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ok = (got.shape == (step[0].shape[0], cfg.vocab_size)
          and torch.isfinite(got).all().item() and err <= 1e-3 * scale)
    emit("model", config="gpt3_1p3b", layers=cfg.num_layers, dtype="float32",
         rows=int(step[0].shape[0]), segments=int(step[3].shape[0]),
         max_abs_err=err, max_abs_logit=scale, tol=1e-3 * scale)
    if not ok:
        raise AssertionError(f"token_step logits disagree: max abs err {err}"
                             f" vs tolerance {1e-3 * scale}")


def profile_steps(engine, prompts, peaks):
    """After the measured run: serve the prompts again (greedy) in the
    same two waves, so that step 4 is the measured run's mixed step
    (decode rows and prefill chunks), and profile that step; once all 16
    decode, time 3 steps plainly and the next 3 under ``torch.profiler``,
    then evict the rest. Attention time is the profiler's kernel time in
    both. The profiler's overhead stays out of every end-to-end number.
    Returns (mixed step, decode breakdown, the arguments of the first
    attention call of the first profiled decode-only step)."""
    from paddle_tpu_torch.serving import SamplingParams

    sp = SamplingParams(max_new_tokens=64)
    reqs = [engine.submit(p, sp) for p in prompts[:8]]
    plain_ms, profiled_ms, prof, out, mixed = [], [], None, None, None
    probe = None
    n_steps = 0
    while out is None and engine.scheduler.has_work:
        if n_steps == 3:
            reqs += [engine.submit(p, sp) for p in prompts[8:]]
        if n_steps == 4:
            mixed = profile_one_step(engine, peaks)
            n_steps += 1
            continue
        decoding = all(r.state in ("running", "finished") for r in reqs)
        if decoding and len(plain_ms) == 3 and prof is None:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            probe = AttentionArgs().__enter__()
            prof.start()
        ts = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        n_steps += 1
        if decoding:
            (plain_ms if prof is None else profiled_ms).append(
                (time.perf_counter() - ts) * 1e3)
        if len(profiled_ms) == 3:
            prof.stop()
            probe.__exit__()
            out = device_breakdown(prof, 3, profiled_ms, plain_ms)
            out["attention"] = attention_report(prof, probe, 3, peaks)
    engine.stop(drain=False)
    if engine.kv.blocks_in_use != 0:
        raise AssertionError("KV blocks leaked in the profiling pass")
    return mixed, out or {
        "device_time": "not measured (no decode-only window)"}, (
        probe.args if probe is not None else None)


def profile_one_step(engine, peaks):
    """One engine step under the profiler: its device busy time and its
    attention kernels' share of it."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with AttentionArgs() as probe, prof:
        engine.step()
        torch.cuda.synchronize()
    busy, ops = kernel_ms(prof, "")
    res = attention_report(prof, probe, 1, peaks)
    return dict(res, device_busy_ms=busy, device_ops=ops,
                fraction=res["attention_ms"] / busy)


def device_breakdown(prof, n_steps, profiled_ms, plain_ms):
    """Device busy time per step (the sum of the profiled CUDA activity:
    kernels and copies, one stream so no overlap) against the wall time of
    unprofiled steps of the same shape, and the kernels that take it."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured (profiler saw no CUDA events)"}
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values()) / n_steps
    wall = float(np.mean(plain_ms))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(steps=n_steps, device_busy_ms_per_step=busy,
                device_ops_per_step=len(kernels) / n_steps,
                wall_ms_per_step=wall,
                wall_ms_per_step_profiled=float(np.mean(profiled_ms)),
                idle_share=1.0 - busy / wall,
                top=[dict(name=name[:90], ms_per_step=ms / n_steps,
                          calls_per_step=n / n_steps)
                     for name, (ms, n) in top])


def serve_config(**kwargs):
    from paddle_tpu_torch.serving import EngineConfig

    return EngineConfig(**dict(dict(
        max_slots=16, token_budget=256, block_size=16,
        max_blocks_per_seq=128, num_blocks=2048, dtype=torch.bfloat16),
        **kwargs))


def serve_traffic(cfg):
    """The serving traffic: 16 seeded prompts of 32..1024 tokens, 64 new
    tokens each, even requests greedy and odd ones temperature 0.8 /
    top-k 50."""
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(32, 1025, 16)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    params = [SamplingParams(max_new_tokens=64) if i % 2 == 0 else
              SamplingParams(max_new_tokens=64, temperature=0.8, top_k=50,
                             seed=i) for i in range(16)]
    return lens, prompts, params


def phase_serve(device, cfg, model, peaks, launches_of, reset_launches):
    from paddle_tpu_torch.serving import Engine

    engine = Engine(model, serve_config(), device=device)
    lens, prompts, params = serve_traffic(cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, sp) for p, sp in zip(prompts[:8], params[:8])]
    step_ms, n_steps = [], 0
    while engine.scheduler.has_work:
        if n_steps == 3:
            reqs += [engine.submit(p, sp)
                     for p, sp in zip(prompts[8:], params[8:])]
        ts = time.perf_counter()
        progressed = engine.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if not progressed:
            raise RuntimeError("engine made no progress")
        n_steps += 1
    wall = time.perf_counter() - t0
    launches = launches_of()

    bad = [r.request_id for r in reqs
           if r.finish_reason != "length" or len(r.generated) != 64
           or not all(0 <= t < cfg.vocab_size for t in r.generated)]
    if bad or engine.kv.blocks_in_use != 0:
        raise AssertionError(f"requests {bad} did not finish by length, or "
                             f"{engine.kv.blocks_in_use} KV blocks leaked")
    expected = cfg.num_layers * n_steps
    if launches.get("ragged_paged_attention_chunked") != expected:
        raise AssertionError(f"attention kernel launches {launches} != "
                             f"{expected} (layers x steps)")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs]
    n_out = sum(len(r.generated) for r in reqs)
    mixed, breakdown, decode_args = profile_steps(engine, prompts, peaks)
    emit("serve", config="gpt3_1p3b", layers=cfg.num_layers,
         dtype="bfloat16", requests=len(reqs), prompt_tokens=int(lens.sum()),
         output_tokens=n_out, steps=n_steps, wall_s=wall,
         output_tok_per_s=n_out / wall, mean_step_ms=float(np.mean(step_ms)),
         ttft_p50_ms=float(np.median(ttft)), launches=launches,
         mixed_step=mixed, decode_step_breakdown=breakdown,
         kv_blocks_peak=engine.kv.blocks_peak,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, decode_args


def phase_prefix(device, cfg, model, launches_of, reset_launches):
    """The radix prefix cache on the card: 8 requests share a 640-token
    system prompt. The first runs alone; the other 7 then admit onto its
    40 cached blocks and prefill only their own suffixes."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import Engine, SamplingParams

    engine = Engine(model, serve_config(prefix_cache=True), device=device)
    rng = np.random.default_rng(SEED + 4)
    shared = rng.integers(0, cfg.vocab_size, 640).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(8, 200, 8)]
    sp = SamplingParams(max_new_tokens=32)
    obs.enable()
    obs.reset()
    reset_launches()
    reqs, n_steps = [engine.submit(prompts[0], sp)], 0
    while engine.scheduler.has_work:
        engine.step()
        n_steps += 1
    reqs += [engine.submit(p, sp) for p in prompts[1:]]
    while engine.scheduler.has_work:
        engine.step()
        n_steps += 1
    torch.cuda.synchronize()
    launches = launches_of()
    saved = obs.default_registry().counter(
        "serving.prefix_cache.saved_tokens").value()
    obs.disable()
    alloc = engine.kv.allocator
    held = [b for b in range(alloc.num_blocks) if alloc.refcount(b) > 0]
    ok = (all(r.finish_reason == "length" and len(r.generated) == 32
              for r in reqs)
          and saved >= 7 * len(shared)
          and launches.get("ragged_paged_attention_chunked")
          == cfg.num_layers * n_steps
          and all(alloc.refcount(b) == 1 for b in held)
          and len(held) == len(engine.prefix))
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs[1:]]
    emit("prefix", requests=len(reqs), shared_prefix_tokens=len(shared),
         saved_prefill_tokens=saved, steps=n_steps, launches=launches,
         cached_blocks=len(engine.prefix),
         follower_ttft_p50_ms=float(np.median(ttft)), ok=ok)
    if not ok:
        raise AssertionError("prefix-cache serve failed its checks")


def run_waves(engine, prompts, params):
    """The serve phase's arrivals: the first 8 requests, the other 8 after
    3 steps; step until every request is done. Returns the requests and
    the step count."""
    reqs = [engine.submit(p, sp) for p, sp in zip(prompts[:8], params[:8])]
    n_steps = 0
    while engine.scheduler.has_work:
        if n_steps == 3:
            reqs += [engine.submit(p, sp)
                     for p, sp in zip(prompts[8:], params[8:])]
        if not engine.step():
            raise RuntimeError("engine made no progress")
        n_steps += 1
    torch.cuda.synchronize()
    return reqs, n_steps


def phase_preempt(device, cfg, n_layers=4):
    """Preemption on the card: the serve traffic on the full-width model
    at 4 layers in fp32 (rounding noise far below a random model's logit
    gaps), once with the serve pool and once with the smallest pool the
    engine takes (one full-length sequence, 128 blocks), a quarter of what
    the 16 requests hold at once. Both must finish every request, preempt
    only in the small pool, drain both pools and give the same streams
    token for token."""
    from paddle_tpu_torch.serving import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg, random_weights(cfg, n_layers, device), device,
                        torch.float32)
    _, prompts, params = serve_traffic(cfg)
    need = sum(-(-(len(p) + 64) // 16) for p in prompts)
    runs = {}
    for pool, num_blocks in (("serve", 2048),
                             ("small", serve_config().max_blocks_per_seq)):
        engine = Engine(model, serve_config(dtype=torch.float32,
                                            num_blocks=num_blocks),
                        device=device)
        t0 = time.perf_counter()
        reqs, n_steps = run_waves(engine, prompts, params)
        runs[pool] = dict(
            num_blocks=num_blocks, steps=n_steps,
            wall_s=time.perf_counter() - t0,
            preemptions=sum(r.preemptions for r in reqs),
            by_length=all(r.finish_reason == "length"
                          and len(r.generated) == 64 for r in reqs),
            blocks_in_use=engine.kv.blocks_in_use,
            streams=[list(r.generated) for r in reqs])
        del engine
    same = runs["serve"]["streams"] == runs["small"]["streams"]
    diverged = [i for i, (a, b) in enumerate(zip(runs["serve"]["streams"],
                                                 runs["small"]["streams"]))
                if a != b]
    ok = (same and runs["small"]["preemptions"] > 0
          and runs["serve"]["preemptions"] == 0
          and all(r["by_length"] and r["blocks_in_use"] == 0
                  for r in runs.values()))
    emit("preempt", config="gpt3_1p3b width", layers=n_layers,
         dtype="float32", requests=len(prompts), blocks_needed=need,
         streams_equal=same, diverged_requests=diverged,
         **{pool: {k: v for k, v in r.items() if k != "streams"}
            for pool, r in runs.items()}, ok=ok)
    if not ok:
        raise AssertionError("preemption changed the streams, did not "
                             "happen, or leaked KV blocks")
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------- flash attention

# Every element within TOL x max(1, max |plain|), and ||got - plain|| /
# ||plain|| within REL_TOL: a few times what a right kernel reads at bf16
# (single elements rounded to the neighbouring bf16 value) and far below
# what a kernel that skips one tile reads (tests/test_torch_cuda_kernels.py
# test_flash_limits_reject_a_kernel_that_skips_a_tile).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def rel_err(got, want) -> float:
    """``||got - want|| / ||want||`` over all elements, in fp32."""
    diff = (got.float() - want.float()).norm()
    return (diff / want.float().norm().clamp_min(1e-30)).item()


def agreement(what: str, got, want):
    """Max abs error and relative norm error of ``got`` against its plain
    version ``want``; raises past either limit (of ``want``'s dtype) or on
    a non-finite value."""
    err = (got.float() - want.float()).abs().max().item()
    rel = rel_err(got, want)
    lim = TOL[want.dtype] * max(1.0, want.float().abs().max().item())
    if not (err <= lim and rel <= REL_TOL[want.dtype]
            and torch.isfinite(got).all().item()):
        raise AssertionError(
            f"{what} disagrees with its plain version: max abs err {err} "
            f"(limit {lim}), relative norm err {rel} (limit "
            f"{REL_TOL[want.dtype]})")
    return err, rel


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(q row, kv column) pairs attention computes: all of them, or those
    with ``row + (sk - sq) >= col`` when causal."""
    if not causal:
        return sq * sk
    return sum(min(sk, r + sk - sq + 1) for r in range(sq))


def flash_work(kind: str, bh: int, sq: int, sk: int, d: int, elem: int,
               causal: bool):
    """Bytes each kernel must move (every input read once, every output
    written once) and the operations it must do, from the call's shapes:
    forward q k v -> out + lse, 2 matmuls per pair; dQ q k v do lse delta
    -> dq, 3; dK/dV q k v do lse delta -> dk dv, 4."""
    tq, tk = bh * sq * d * elem, bh * sk * d * elem
    rows = bh * sq * 4
    n_bytes, n_mm = {
        "fwd": (2 * tq + 2 * tk + rows, 2),
        "dq": (3 * tq + 2 * tk + 2 * rows, 3),
        "dkv": (2 * tq + 4 * tk + 2 * rows, 4),
    }[kind]
    return n_bytes, 2 * n_mm * bh * d * causal_pairs(sq, sk, causal)


def bound_of(n_bytes, n_ops, dtype, peaks):
    """The least time the card could take for a call: the larger of its
    bytes over the HBM rate and its operations over the peak rate of the
    inputs' type."""
    peak_ops = peaks["bf16_flops" if dtype == torch.bfloat16
                     else "fp32_flops"]
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"] * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return dict(bytes=n_bytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# the kernel each flash entry point launches at D = 128, by dtype
FLASH_KERNEL_OF = {
    ("fwd", torch.bfloat16): "fa_fwd_wgmma_kernel",
    ("dq", torch.bfloat16): "fa_dq_wgmma_kernel",
    ("dkv", torch.bfloat16): "fa_dkv_wgmma_kernel",
    ("fwd", torch.float32): "fa_fwd_kernel",
    ("dq", torch.float32): "fa_dq_kernel",
    ("dkv", torch.float32): "fa_dkv_kernel",
}


def ptxas_of(report: str, kernel: str, head_dim: int):
    """Registers and spill bytes of ``kernel``'s instantiation at
    ``head_dim``, read from a ``_build.ptxas_report`` (mangled names:
    ``<kernel>I...Li<head_dim>E``)."""
    found, cur = {}, False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            at = name.find(kernel + "I")
            cur = at >= 0 and f"Li{head_dim}E" in name[at:]
        elif cur and "spill stores" in line:
            nums = [int(x) for x in line.split() if x.isdigit()]
            found.update(spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur and "Used" in line and "registers" in line:
            found["registers"] = int(line.split("Used")[1].split()[0])
            cur = False
    return found


def phase_flash(device, peaks, timer, batch=8, heads=16, s=1024, d=128):
    """The three flash-attention kernels against their plain versions at
    the training path's shapes (B=8, H=16 -> BH=128, S=1024, D=128,
    causal), fp32 and bf16, plus a bf16 dropout case; median times with
    the L2 cache flushed; each kernel's ptxas registers and spills;
    scaled_dot_product_attention as the yardstick, with the backend it
    ran."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.flash_attention import (flash_dkv, flash_dq,
                                                      flash_fwd)

    bh, causal = batch * heads, True
    scale = 1.0 / d ** 0.5
    report = _build.ptxas_report("flash_attention")
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    results = {}
    for dtype, dropout in ((torch.float32, 0.0), (torch.bfloat16, 0.0),
                           (torch.bfloat16, 0.1)):
        rnd = lambda: torch.randn(bh, s, d, generator=g,
                                  device=device).to(dtype)
        q, k, v, do = rnd(), rnd(), rnd(), rnd()
        args = (causal, scale, dropout, 4321)
        out, lse = flash_fwd(q, k, v, *args, impl="torch")
        delta = (do.float() * out.float()).sum(-1)
        calls = {
            "fwd": lambda impl: flash_fwd(q, k, v, *args, impl=impl),
            "dq": lambda impl: flash_dq(q, k, v, do, lse, delta, *args,
                                        impl=impl),
            "dkv": lambda impl: flash_dkv(q, k, v, do, lse, delta, *args,
                                          impl=impl),
        }
        tag = str(dtype).replace("torch.", "") + (
            f"_dropout{dropout}" if dropout else "")
        for kind, call in calls.items():
            got, want = call("cuda"), call("torch")
            if torch.is_tensor(got):
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            errs = [agreement(f"flash {kind} ({tag})", a, b)
                    for a, b in zip(got, want)]
            kernel = FLASH_KERNEL_OF[(kind, dtype)]
            res = dict(kind=kind, case=tag, kernel=kernel,
                       max_abs_err=max(e for e, _ in errs),
                       rel_err=max(r for _, r in errs), tol=TOL[dtype],
                       rel_tol=REL_TOL[dtype], bh=bh, seq=s, head_dim=d,
                       causal=causal, dropout=dropout,
                       ptxas=ptxas_of(report, kernel, d))
            if not dropout:
                res.update(ms=timer.median_ms(lambda: call("cuda")),
                           plain_ms=timer.median_ms(lambda: call("torch")),
                           **bound_of(*flash_work(kind, bh, s, s, d,
                                                  q.element_size(), causal),
                                      dtype, peaks))
            emit("flash", name=f"flash_attention_{kind}", **res)
            results[(kind, tag)] = res
        if dtype == torch.bfloat16 and not dropout:
            results["library"] = sdpa_yardstick(q, k, v, do, timer, batch)
            emit("flash_library", **results["library"])
        del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return results


def sdpa_yardstick(q, k, v, do, timer, batch):
    """torch's scaled_dot_product_attention on the same bf16 inputs
    ([B, H, S, D] views of the [BH, S, D] tensors), forward alone and its
    backward as one figure, each the median of TIME_REPS launches with the
    L2 flushed; the backward timed three times over to show its spread.
    Names the backend: which SDPA backends are enabled, and the device
    kernels one forward and one backward ran (profiler). Timed here only;
    the port never calls it."""
    import torch.nn.functional as F

    shape = (batch, q.shape[0] // batch) + tuple(q.shape[1:])
    qs, ks, vs = (x.reshape(shape).detach().requires_grad_(True)
                  for x in (q, k, v))
    gout = do.reshape(shape)
    fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    out = fwd()
    bwd = lambda: torch.autograd.grad(out, (qs, ks, vs), gout,
                                      retain_graph=True)
    kernels = {}
    for what, fn in (("forward", fwd), ("backward", bwd)):
        fn()
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            fn()
            torch.cuda.synchronize()
        kernels[what] = sorted({
            e.name[:100] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA})
    backends = {name: getattr(torch.backends.cuda, f"{name}_sdp_enabled")()
                for name in ("flash", "mem_efficient", "cudnn", "math")}
    backward_runs = [timer.median_ms(bwd) for _ in range(3)]
    return dict(sdpa_forward_ms=timer.median_ms(fwd),
                sdpa_backward_ms=backward_runs[0],
                sdpa_backward_ms_runs=backward_runs, reps=TIME_REPS,
                backends_enabled=backends,
                forward_kernels=kernels["forward"],
                backward_kernels=kernels["backward"])


# ------------------------------------------------ softmax cross-entropy

def xent_work(kind: str, n: int, v: int, elem: int):
    """Bytes each kernel must move (the logits read once; labels int64,
    loss, lse and the upstream gradient once; dz written once) and its
    fp32 operations (4 a logit: max, subtract, exp, add forward; subtract,
    exp, subtract, multiply backward)."""
    logits = n * v * elem
    n_bytes = {"fwd": logits + n * (8 + 4 + 4),
               "bwd": 2 * logits + n * (8 + 4 + 4)}[kind]
    return n_bytes, 4 * n * v


def phase_xent(device, peaks, timer, n=8 * 1024, v=50304):
    """The fused softmax cross-entropy kernels against their plain
    versions at the training path's shapes (8 x 1024 rows of the 50304
    vocabulary), fp32 and bf16; median times with the L2 cache flushed;
    torch's cross_entropy (per-row losses) as the forward's yardstick."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops.softmax_xent import xent_bwd, xent_fwd

    g = torch.Generator(device=device).manual_seed(SEED + 7)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        z = (torch.randn(n, v, generator=g, device=device) * 2).to(dtype)
        labels = torch.randint(0, v, (n,), generator=g, device=device)
        grad = torch.full((n,), 1.0 / n, device=device)  # a mean's
        _, lse = xent_fwd(z, labels, impl="torch")
        calls = {
            "fwd": lambda impl: xent_fwd(z, labels, impl=impl),
            "bwd": lambda impl: xent_bwd(z, labels, lse, grad, impl=impl),
        }
        tag = str(dtype).replace("torch.", "")
        for kind, call in calls.items():
            got, want = call("cuda"), call("torch")
            if torch.is_tensor(got):
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            errs = [agreement(f"softmax_xent {kind} ({tag})", a, b)
                    for a, b in zip(got, want)]
            library = None
            if kind == "fwd":
                library = timer.median_ms(lambda: TF.cross_entropy(
                    z, labels, reduction="none"))
            res = dict(kind=kind, case=tag,
                       max_abs_err=max(e for e, _ in errs),
                       rel_err=max(r for _, r in errs),
                       rel_tol=REL_TOL[want[-1].dtype], rows=n, vocab=v,
                       ms=timer.median_ms(lambda: call("cuda")),
                       plain_ms=timer.median_ms(lambda: call("torch")),
                       library_ms=library,
                       **bound_of(*xent_work(kind, n, v, z.element_size()),
                                  torch.float32, peaks))
            emit("xent", name=f"softmax_xent_{kind}", **res)
            results[(kind, tag)] = res
        del z, labels, grad, lse
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------- block-sparse attention

SPARSE_SHAPE = dict(batch=2, heads=16, seq=4096, head_dim=128)  # GPT-3 1.3B


def bigbird_mask(n: int, seed: int = SEED):
    """BigBird's ITC pattern at 128-token blocks (Zaheer et al. 2020): a
    sliding window of 3 blocks, 2 global blocks and 3 random kv blocks per
    q block, drawn from ``numpy.random.default_rng(seed)``."""
    from paddle_tpu_torch.ops.block_sparse_attention import local_global_mask

    rng = np.random.default_rng(seed)
    mask = local_global_mask(n, n, window=1, global_blocks=2)
    for i in range(n):
        mask[i, rng.choice(n, 3, replace=False)] = True
    return mask


def causal_case_mask(mask128):
    """The pattern at blk_q 256 / blk_k 128 for the causal case: pairs of
    q blocks merged, and every odd q block i attending kv block 2i+1
    alone, so its first 128 rows see no unmasked column (rows the port
    defines as 0, the reference as NaN)."""
    mask = mask128[0::2] | mask128[1::2]
    mask[1::2] = False
    for i in range(1, mask.shape[0], 2):
        mask[i, 2 * i + 1] = True
    return mask


def sparse_pairs(spec, sq: int, sk: int, causal: bool) -> int:
    """(q row, kv column) pairs the lists make active (and causal keeps)."""
    off = sk - sq
    r = np.arange(spec.blk_q)[:, None]
    c = np.arange(spec.blk_k)[None, :]
    pairs = 0
    for i in range(spec.cols.shape[0]):
        for j in spec.cols[i, :spec.counts[i]]:
            pairs += (int(((i * spec.blk_q + r) + off
                           >= (j * spec.blk_k + c)).sum()) if causal
                      else spec.blk_q * spec.blk_k)
    return pairs


def sparse_work(kind: str, spec, bh: int, sq: int, sk: int, d: int,
                elem: int, causal: bool):
    """Bytes each kernel must move (every input read once, every output
    written once: q, k, v, out or do, dq or dk dv, lse and delta fp32, the
    int32 lists) and its operations over the active pairs: 2 D FLOP a pair
    per matmul, 2 forward (QK^T, PV), 3 dQ, 4 dK/dV."""
    tq, tk, rows = bh * sq * d * elem, bh * sk * d * elem, bh * sq * 4
    q_lists = (spec.cols.size + spec.counts.size) * 4
    kv_lists = (spec.rows.size + spec.rcounts.size) * 4
    n_bytes, n_mm = {
        "fwd": (2 * tq + 2 * tk + rows + q_lists, 2),
        "dq": (3 * tq + 2 * tk + 2 * rows + q_lists, 3),
        "dkv": (2 * tq + 4 * tk + 2 * rows + kv_lists, 4),
    }[kind]
    return n_bytes, 2 * n_mm * bh * d * sparse_pairs(spec, sq, sk, causal)


def agreement_lse(what: str, got, want):
    """:func:`agreement` for an lse, whose rows that saw no unmasked column
    are -inf on both sides."""
    inf = torch.isinf(want)
    if not torch.equal(inf, torch.isinf(got)):
        raise AssertionError(f"{what}: -inf rows differ")
    return agreement(what, got.masked_fill(inf, 0.0),
                     want.masked_fill(inf, 0.0))


def phase_sparse(device, peaks, timer):
    """The three block-sparse kernels against their plain versions at the
    sparse path's shapes (B=2, H=16, S=4096, D=128 -> BH=32) on BigBird's
    pattern at 128-token blocks, fp32 and bf16, plus a causal bf16 case
    at blk_q 256 / blk_k 128 with fully masked rows; median times with
    the L2 cache flushed; bytes, operations and the bound from the active
    pairs; scaled_dot_product_attention with the expanded boolean mask as
    the yardstick."""
    from paddle_tpu_torch.ops.block_sparse_attention import (
        block_mask_spec, bsa_dkv, bsa_dq, bsa_fwd)

    sh = SPARSE_SHAPE
    bh, s, d = sh["batch"] * sh["heads"], sh["seq"], sh["head_dim"]
    scale = 1.0 / d ** 0.5
    mask = bigbird_mask(s // 128)
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    results = {}
    for dtype, causal in ((torch.float32, False), (torch.bfloat16, False),
                          (torch.bfloat16, True)):
        spec = block_mask_spec(causal_case_mask(mask) if causal else mask,
                               s, s, causal)
        rnd = lambda: torch.randn(bh, s, d, generator=g,
                                  device=device).to(dtype)
        q, k, v, do = rnd(), rnd(), rnd(), rnd()
        args = (spec, causal, scale)
        out, lse = bsa_fwd(q, k, v, *args, impl="torch")
        delta = (do.float() * out.float()).sum(-1)
        calls = {
            "fwd": lambda impl: bsa_fwd(q, k, v, *args, impl=impl),
            "dq": lambda impl: bsa_dq(q, k, v, do, lse, delta, *args,
                                      impl=impl),
            "dkv": lambda impl: bsa_dkv(q, k, v, do, lse, delta, *args,
                                        impl=impl),
        }
        tag = str(dtype).replace("torch.", "") + ("_causal_256x128"
                                                  if causal else "")
        for kind, call in calls.items():
            got, want = call("cuda"), call("torch")
            if torch.is_tensor(got):
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            errs = [(agreement_lse if t.dtype == torch.float32 and t.dim() == 2
                     else agreement)(f"block-sparse {kind} ({tag})", a, t)
                    for a, t in zip(got, want)]
            res = dict(kind=kind, case=tag, max_abs_err=max(e for e, _ in errs),
                       rel_err=max(r for _, r in errs), tol=TOL[dtype],
                       rel_tol=REL_TOL[dtype], bh=bh, seq=s, head_dim=d,
                       blk_q=spec.blk_q, blk_k=spec.blk_k, causal=causal,
                       active_block_pairs=int(spec.counts.sum()),
                       block_pairs=spec.mask.size,
                       ms=timer.median_ms(lambda: call("cuda")),
                       plain_ms=timer.median_ms(lambda: call("torch")),
                       **bound_of(*sparse_work(kind, spec, bh, s, s, d,
                                               q.element_size(), causal),
                                  dtype, peaks))
            if causal and kind == "fwd":
                empty = torch.isinf(got[1])
                res["masked_rows"] = int(empty.sum().item())
                res["masked_rows_zero"] = bool(
                    (got[0][empty] == 0).all().item())
                if not res["masked_rows"] or not res["masked_rows_zero"]:
                    raise AssertionError("causal case: no fully masked rows, "
                                         "or their output is not 0")
            emit("sparse", name=f"block_sparse_attention_{kind}", **res)
            results[(kind, tag)] = res
        if dtype == torch.bfloat16 and not causal:
            results["library"] = masked_sdpa_yardstick(q, k, v, do, spec,
                                                       timer, sh["batch"])
            emit("sparse_library", **results["library"])
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return results


def masked_sdpa_yardstick(q, k, v, do, spec, timer, batch):
    """torch's scaled_dot_product_attention with the expanded boolean mask
    on the same bf16 inputs ([B, H, S, D] views): the same function,
    computed densely. Forward alone, and its backward (dq, dk, dv in one
    call). Timed here only; the port never calls it."""
    import torch.nn.functional as TF

    shape = (batch, q.shape[0] // batch) + tuple(q.shape[1:])
    qs, ks, vs = (x.reshape(shape).detach().requires_grad_(True)
                  for x in (q, k, v))
    mask = (torch.from_numpy(spec.mask).to(q.device)  # [S, S] elements
            .repeat_interleave(spec.blk_q, 0)
            .repeat_interleave(spec.blk_k, 1))
    fwd = lambda: TF.scaled_dot_product_attention(qs, ks, vs,
                                                  attn_mask=mask)
    out = fwd()
    bwd = lambda: torch.autograd.grad(out, (qs, ks, vs), do.reshape(shape),
                                      retain_graph=True)
    return dict(sdpa_masked_forward_ms=timer.median_ms(fwd),
                sdpa_masked_backward_ms=timer.median_ms(bwd))


def bigbird_csr(mask, blk: int, batch: int, heads: int, device):
    """The block mask as the int32 CSR pattern sparse_attention takes,
    the same for every (batch, head): offsets [B, H, T + 1], columns
    [B, H, nnz]."""
    el = np.kron(mask, np.ones((blk, blk), bool))
    _, cols = np.nonzero(el)
    off = np.concatenate([[0], np.cumsum(el.sum(axis=1))])
    expand = lambda a: torch.from_numpy(a.astype(np.int32)).to(device).expand(
        batch, heads, a.size).contiguous()
    return expand(off), expand(cols)


def phase_sparse_path(device, launches_of, reset_launches):
    """The entry point as users call it: paddle_tpu_torch.nn.functional.
    sparse_attention on [B, H, T, D] fp32 tensors with requires_grad and
    BigBird's pattern as an int32 CSR, then (out * w).sum().backward().
    Each of the three kernels must launch once; a second call must take
    the route from the cache, copying nothing to the host; out and every
    gradient must agree with the dense masked composition (the plain
    route) within 1e-4 in relative norm."""
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.nn.functional import attention as att
    from paddle_tpu_torch.ops.block_sparse_attention import KERNEL_NAMES

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = SPARSE_SHAPE
    b, h, t, d = sh["batch"], sh["heads"], sh["seq"], sh["head_dim"]
    mask = bigbird_mask(t // 128)
    off, cols = bigbird_csr(mask, 128, b, h, device)
    g = torch.Generator(device=device).manual_seed(SEED + 9)
    q, k, v, w = (torch.randn(b, h, t, d, generator=g, device=device)
                  for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    analyse = mock.Mock(wraps=att._analyse)
    timing = {}
    with mock.patch.object(att, "_analyse", analyse):
        for call in ("first", "cached"):
            for x in leaves:
                x.grad = None
            torch.cuda.synchronize()
            reset_launches()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            t0 = time.perf_counter()
            ev[0].record()
            out = TF.sparse_attention(*leaves, off, cols)
            ev[1].record()
            (out * w).sum().backward()
            ev[2].record()
            torch.cuda.synchronize()
            timing[call] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                                forward_ms=ev[0].elapsed_time(ev[1]),
                                backward_ms=ev[1].elapsed_time(ev[2]),
                                launches=launches_of(),
                                analyses=analyse.call_count)
    got = [out.detach()] + [x.grad for x in leaves]
    del out
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    reset_launches()
    ref = att._sa(*plain, off, cols)
    (ref * w).sum().backward()
    torch.cuda.synchronize()
    plain_launches = launches_of()
    want = [ref.detach()] + [x.grad for x in plain]
    rel = {name: rel_err(a, r)
           for name, a, r in zip(("out", "dq", "dk", "dv"), got, want)}
    once = {n: 1 for n in KERNEL_NAMES}
    ok = (all(r <= 1e-4 for r in rel.values())
          and all(torch.isfinite(a).all().item() for a in got)
          and timing["first"]["launches"] == once
          and timing["cached"]["launches"] == once
          and timing["first"]["analyses"] == 1
          and timing["cached"]["analyses"] == 1 and plain_launches == {})
    emit("sparse_path", batch=b, heads=h, seq=t, head_dim=d, dtype="float32",
         pattern="BigBird ITC, 128-token blocks: window 3, global 2, "
                 "random 3", active_block_pairs=int(mask.sum()),
         block_pairs=int(mask.size), csr_nnz_per_head=int(cols.shape[-1]),
         rel_err=rel, rel_tol=1e-4, **timing, ok=ok)
    if not ok:
        raise AssertionError("sparse_attention: kernel route and dense "
                             "route disagree, or the route was not the "
                             "kernels' or not cached")
    launches = timing["first"]["launches"]
    del q, k, v, w, leaves, plain, ref, got, want, off, cols
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ LayerNorm

def phase_layer_norm(device, peaks, timer, launches_of, reset_launches,
                     e=2048):
    """The LayerNorm kernel against its plain version at the train path's
    activations (8 x 1024 rows of E=2048) and a decode step's 16 rows, in
    fp32 and bf16; median times with the L2 cache flushed;
    torch.nn.functional.layer_norm as the yardstick. Then
    fused_layer_norm forward and backward through autograd once, kernel
    against plain route: the output and the three gradients must agree."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops.layer_norm import (_plan, fused_layer_norm,
                                                 ln_fwd)

    g = torch.Generator(device=device).manual_seed(SEED + 10)
    gamma = torch.randn(e, generator=g, device=device)
    beta = torch.randn(e, generator=g, device=device)
    results = {}
    for rows in (8 * 1024, 16):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows, e, generator=g, device=device) * 2
                 + 0.5).to(dtype)
            call = lambda impl: ln_fwd(x, gamma, beta, 1e-5, impl=impl)
            got, want = call("cuda"), call("torch")
            torch.cuda.synchronize()
            err, rel = agreement(f"layer_norm ({rows} x {e}, {dtype})", got,
                                 want)
            tag = f"{rows}x{e}_" + str(dtype).replace("torch.", "")
            # 8 FLOP an element in fp32: sum, subtract, square, sum,
            # subtract, two multiplies, add
            n_bytes = 2 * x.numel() * x.element_size() + 2 * e * 4
            # (warps a row, 16-byte vectors a thread), (0, 0): looping
            plan = _plan(e, x.element_size())
            res = dict(case=tag, plan=plan, max_abs_err=err, rel_err=rel,
                       tol=TOL[dtype], rel_tol=REL_TOL[dtype],
                       ms=timer.median_ms(lambda: call("cuda")),
                       plain_ms=timer.median_ms(lambda: call("torch")),
                       library_ms=timer.median_ms(lambda: TF.layer_norm(
                           x, (e,), gamma.to(dtype), beta.to(dtype), 1e-5)),
                       **bound_of(n_bytes, 8 * x.numel(), torch.float32,
                                  peaks))
            emit("layer_norm", name="layer_norm_fwd", **res)
            results[tag] = res
    x = torch.randn(8, 1024, e, generator=g, device=device)
    grads, outs, counts = {}, {}, {}
    for impl in ("cuda", "torch"):
        leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
        reset_launches()
        out = fused_layer_norm(*leaves, impl=impl)
        (out ** 3).sum().backward()
        torch.cuda.synchronize()
        counts[impl] = launches_of()
        outs[impl] = out.detach()
        grads[impl] = [t.grad for t in leaves]
    rel = {n: rel_err(a, b) for n, a, b in zip(
        ("out", "dx", "dgamma", "dbeta"), [outs["cuda"]] + grads["cuda"],
        [outs["torch"]] + grads["torch"])}
    ok = (all(r <= REL_TOL[torch.float32] for r in rel.values())
          and counts["cuda"] == {"layer_norm_fwd": 1}
          and counts["torch"] == {})
    emit("layer_norm_path", shape=[8, 1024, e], dtype="float32",
         loss="sum(out ** 3)", rel_err=rel, rel_tol=REL_TOL[torch.float32],
         launches=counts, ok=ok)
    if not ok:
        raise AssertionError("fused_layer_norm: kernel route and plain "
                             "route disagree, or the kernel did not run once")
    results["launches"] = counts["cuda"]["layer_norm_fwd"]
    return results


# ------------------------------------------------------------ training

def train_config(n_layers: int):
    """``bench.py``'s GPT-3 1.3B training configuration (its
    ``bench_gpt13``): vocab 50304, E=2048, H=16, F=8192, 1024 positions,
    dropout 0; ``n_layers`` of its 24."""
    from paddle_tpu_torch.text.models import GPTConfig

    return GPTConfig(vocab_size=50304, hidden_size=2048,
                     num_layers=n_layers, num_heads=16,
                     max_position_embeddings=1024, dropout=0.0)


def train_batch(device, batch=8, seq=1024, vocab=50304):
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    return torch.randint(0, vocab, (batch, seq), generator=g, device=device)


@contextlib.contextmanager
def route(impl: str):
    """Every kernel entry point of the training path (flash attention,
    softmax cross-entropy) runs ``impl``: "cuda" (the kernels) or "torch"
    (their plain versions)."""
    from paddle_tpu_torch.ops import _build

    with mock.patch.object(_build, "pick_impl", lambda _, t: impl):
        yield


def phase_train_parity(device, launches_of, reset_launches, cfg=None,
                       batch=8, seq=1024):
    """Full width at 2 layers, fp32: the same weights and batch through
    the kernel route and the plain route of attention and cross-entropy;
    the loss and every gradient must agree."""
    from paddle_tpu_torch.core import random as rng
    from paddle_tpu_torch.text.models import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or train_config(2)
    ids = train_batch(device, batch, seq, cfg.vocab_size)
    rng.seed(SEED)
    model = GPTForCausalLM(cfg, device=device)
    grads, losses, counts = {}, {}, {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        reset_launches()
        with route(impl):
            loss = model.loss(model(ids), ids)
            loss.backward()
        torch.cuda.synchronize()
        counts[impl] = launches_of()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad.detach().clone()
                       for n, p in model.named_parameters()}
    # relative norm of the difference per parameter; the k third of each
    # qkv.bias has a gradient of zero in exact arithmetic (the softmax
    # ignores a shift shared by every key), so both routes hold rounding
    # noise there: it is held against the largest q/v-bias gradient
    e = cfg.hidden_size
    rel, k_bias_rel = {}, 0.0
    for n, want in grads["torch"].items():
        got = grads["cuda"][n]
        if n.endswith("qkv.bias"):
            k_diff = (got[e:2 * e] - want[e:2 * e]).abs().max()
            got = torch.cat([got[:e], got[2 * e:]])
            want = torch.cat([want[:e], want[2 * e:]])
            k_bias_rel = max(k_bias_rel,
                             (k_diff / want.abs().max()).item())
        rel[n] = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    worst = max((v, n) for n, v in rel.items())
    loss_rel = abs(losses["cuda"] - losses["torch"]) / abs(losses["torch"])
    want_counts = dict({n: cfg.num_layers for n in FLASH_KERNELS},
                       **{n: 1 for n in XENT_KERNELS})
    ok = (loss_rel <= 1e-5 and worst[0] <= 1e-4
          and counts["cuda"] == want_counts and counts["torch"] == {}
          and k_bias_rel <= 1e-4)
    emit("train_parity", config="gpt3_1p3b width", layers=cfg.num_layers,
         dtype="float32", batch=list(ids.shape), loss_kernel=losses["cuda"],
         loss_plain=losses["torch"], loss_rel_err=loss_rel, loss_tol=1e-5,
         grad_worst_rel_err=worst[0], grad_worst=worst[1], grad_tol=1e-4,
         k_bias_grad_rel_err=k_bias_rel, k_bias_tol=1e-4, launches=counts,
         ok=ok)
    if not ok:
        raise AssertionError("train step: kernel route and plain route "
                             "disagree")
    del model, grads
    torch.cuda.empty_cache()


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv")
XENT_KERNELS = ("softmax_xent_fwd", "softmax_xent_bwd")
GEMM_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "nvjet", "cublas")


def train_breakdown(prof, wall_ms):
    """One profiled train step: device time by the three flash kernels,
    the two cross-entropy kernels, GEMMs and the rest, and the device's
    idle share of the step's wall time (unprofiled steps)."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return {"device_time": "not measured (profiler saw no CUDA events)"}
    flash = ("fa_fwd_", "fa_dq_", "fa_dkv_")  # FMA and tensor-core kernels
    flash += ("xent_fwd_", "xent_bwd_")
    groups = dict.fromkeys(flash + ("gemm", "rest"), 0.0)
    by_name = {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        key = next((k for k in flash if k in e.name), None)
        if key is None:
            key = "gemm" if any(m in e.name for m in GEMM_MARKS) else "rest"
        groups[key] += ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # which PyTorch ops launched the device time (self time per op)
    ops = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and not e.key.startswith(("void ", "nvjet", "sm90")):
            ops.append((us / 1e3, e.key, e.count))
    ops.sort(reverse=True)
    return dict(device_busy_ms=busy, device_ops=len(events),
                wall_ms=wall_ms, idle_share=1.0 - busy / wall_ms,
                ms={k: v for k, v in groups.items()},
                share={k: v / busy for k, v in groups.items()},
                top=[dict(name=n[:90], ms=ms) for n, ms in top],
                top_ops=[dict(op=k[:60], ms=ms, calls=c)
                         for ms, k, c in ops[:12]])


def phase_train(device, launches_of, reset_launches, cfg=None, batch=8,
                seq=1024, n_warm=2, n_timed=10):
    """GPT-3 1.3B width, 24 layers, O2, AdamW(1e-4, bf16 moments), seeded
    random weights, batch 8 x 1024: 2 warm-up steps and 10 timed steps on
    one batch through ``TrainStepper``, then one profiled step. Each flash
    kernel must launch once a layer a step, each cross-entropy kernel once
    a step."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core import random as rng
    from paddle_tpu_torch.jit import TrainStepper
    from paddle_tpu_torch.text.models import GPTForCausalLM

    cfg = cfg or train_config(24)
    rng.seed(SEED)
    model = GPTForCausalLM(cfg, device=device)
    opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                          moment_dtype="bfloat16")
    stepper = TrainStepper(model, lambda out, lab: model.loss(out, lab[0]),
                           opt, amp_level="O2")
    x = (train_batch(device, batch, seq, cfg.vocab_size),)
    n_tokens = x[0].numel()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(n_warm):
        losses.append(stepper.step(x, x)[0].item())
    reset_launches()
    for _ in range(n_timed):
        t0 = time.perf_counter()
        loss, _ = stepper.step(x, x)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = launches_of()
    peak = torch.cuda.max_memory_allocated() / 1e9
    mean_ms = float(np.mean(step_ms))
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        stepper.step(x, x)
        torch.cuda.synchronize()
    breakdown = train_breakdown(prof, mean_ms)
    want = dict({n: cfg.num_layers * n_timed for n in FLASH_KERNELS},
                **{n: n_timed for n in XENT_KERNELS})
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and launches == want)
    emit("train", config="gpt3_1p3b", layers=cfg.num_layers, amp="O2",
         optimizer="AdamW(1e-4, moments bf16)", batch=list(x[0].shape),
         losses=losses, warmup_steps=n_warm, timed_steps=n_timed,
         step_ms=step_ms, mean_step_ms=mean_ms,
         tokens_per_s=n_tokens / (mean_ms / 1e3),
         peak_device_memory_gb=peak, launches=launches,
         launches_per_step={n: c / n_timed for n, c in launches.items()},
         breakdown=breakdown, ok=ok)
    if not ok:
        raise AssertionError(f"train phase failed: losses {losses}, "
                             f"launches {launches} (want {want})")
    del stepper, opt, model
    torch.cuda.empty_cache()
    return launches


def kernel_entry(name, source, replaces, launches, res, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.text.models import gpt3_1p3b

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, peaks=peaks)

    t0 = time.perf_counter()
    per_source = _build.build()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=per_source,
         ptxas={src: _build.ptxas_report(src)
                for src in _build.KERNEL_SOURCES})

    timer = Timer(device)
    kernel = phase_kernel(device, peaks, timer)
    decode, decode_launches = phase_decode_batch(
        device, peaks, timer, _build.launches, _build.reset_launches)
    cfg = gpt3_1p3b()
    weights = random_weights(cfg, cfg.num_layers, device)
    phase_model(device, cfg, weights)
    torch.cuda.empty_cache()
    model = build_model(cfg, weights, device, torch.bfloat16)
    del weights
    serve_launches, decode_args = phase_serve(
        device, cfg, model, peaks, _build.launches, _build.reset_launches)
    # keeps only the recorded step's q and layer-0 pools alive
    decode_launches += phase_decode_step(
        peaks, timer, decode_args, _build.launches, _build.reset_launches)
    del decode_args
    phase_prefix(device, cfg, model, _build.launches, _build.reset_launches)
    del model
    torch.cuda.empty_cache()
    phase_preempt(device, cfg)

    flash = phase_flash(device, peaks, timer)
    xent = phase_xent(device, peaks, timer)
    sparse = phase_sparse(device, peaks, timer)
    sparse_launches = phase_sparse_path(device, _build.launches,
                                        _build.reset_launches)
    ln = phase_layer_norm(device, peaks, timer, _build.launches,
                          _build.reset_launches)
    del timer
    torch.cuda.empty_cache()
    phase_train_parity(device, _build.launches, _build.reset_launches)
    train_launches = phase_train(device, _build.launches,
                                 _build.reset_launches)

    fa_src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    fa_ref = "paddle_tpu/ops/pallas/flash_attention.py"
    entries = [kernel_entry(
        "ragged_paged_attention_chunked",
        "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "paddle_tpu/ops/pallas/ragged_paged_attention.py:228",
        serve_launches["ragged_paged_attention_chunked"],
        kernel["bfloat16"], None), kernel_entry(
        "ragged_paged_attention",
        "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "paddle_tpu/ops/pallas/ragged_paged_attention.py:73",
        decode_launches, decode["bfloat16"], None)]
    for kind, line in (("fwd", 162), ("dq", 277), ("dkv", 316)):
        fa_name = f"flash_attention_{kind}"
        library = (flash["library"]["sdpa_forward_ms"] if kind == "fwd"
                   else None)
        entries.append(kernel_entry(fa_name, fa_src, f"{fa_ref}:{line}",
                                    train_launches[fa_name],
                                    flash[(kind, "bfloat16")], library))
    for kind, line in (("fwd", 59), ("bwd", 97)):
        xent_name = f"softmax_xent_{kind}"
        res = xent[(kind, "bfloat16")]
        entries.append(kernel_entry(
            xent_name, "paddle_tpu_torch/ops/csrc/softmax_xent.cu",
            f"paddle_tpu/ops/pallas/softmax_xent.py:{line}",
            train_launches[xent_name], res, res["library_ms"]))
    bsa_ref = "paddle_tpu/ops/pallas/block_sparse_attention.py"
    for kind, line in (("fwd", 92), ("dq", 182), ("dkv", 216)):
        bsa_name = f"block_sparse_attention_{kind}"
        library = (sparse["library"]["sdpa_masked_forward_ms"]
                   if kind == "fwd" else None)
        entries.append(kernel_entry(
            bsa_name, "paddle_tpu_torch/ops/csrc/block_sparse_attention.cu",
            f"{bsa_ref}:{line}", sparse_launches[bsa_name],
            sparse[(kind, "bfloat16")], library))
    res = ln["8192x2048_bfloat16"]
    entries.append(kernel_entry(
        "layer_norm_fwd", "paddle_tpu_torch/ops/csrc/layer_norm.cu",
        "paddle_tpu/ops/pallas/layer_norm.py:23", ln["launches"], res,
        res["library_ms"]))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
