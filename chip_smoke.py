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
   tiles at unaligned offsets and inactive segments, in fp32 and bf16;
   median times over >= 20 launches with the L2 cache flushed before each,
   the bytes and operations the inputs need, and the resulting bound.
4. ``model`` — GPT-3 1.3B width (``gpt3_1p3b``, seeded random weights)
   in fp32: one ``token_step`` on a packed mixed prefill+decode batch with
   the kernel and with the plain attention; logits must agree.
5. ``serve`` — the same model in bf16 behind ``Engine``: 16 seeded
   requests (32-1024 prompt tokens, 64 new tokens, half greedy, half
   temperature 0.8 / top-k 50) arriving in two waves. Every request must
   finish by length and the KV pool must drain. Launch counts are reset
   just before and read just after: every kernel must have run. A second,
   profiled pass over the same prompts gives the device-time breakdown of
   decode-only steps.
6. ``prefix`` — the prefix cache on: 8 requests sharing a 640-token
   prompt; the 7 that follow the first must skip its prefill.
7. ``flash`` — the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain PyTorch versions at the training path's shapes
   (BH=128, S=1024, D=128, causal) in fp32 and bf16, plus a bf16 dropout
   case: max abs error and relative norm error against their limits,
   median times over >= 20
   launches with the L2 cache flushed, bytes, operations and the bound;
   ``flash_library`` times torch's scaled_dot_product_attention forward
   and backward on the same bf16 inputs as the yardstick.
8. ``xent`` — the two fused softmax cross-entropy kernels (forward,
   backward) against their plain PyTorch versions at the training path's
   shapes (8 x 1024 rows, V=50304) in fp32 and bf16: errors against the
   limits, median times with the L2 cache flushed, bytes, operations and
   the bound; torch's ``cross_entropy`` (per-row losses) as the
   forward's yardstick.
9. ``train_parity`` — GPT-3 1.3B width at 2 layers in fp32: one forward
   and backward through the kernels (attention and cross-entropy) and
   one through their plain versions; the loss and every gradient must
   agree.
10. ``train`` — the training path: ``TrainStepper`` over the 24-layer GPT
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


def rpa_work(args):
    """Bytes one attention call must move (q and out once, each KV block
    its live segments need once, the metadata once) and the operations it
    must do (4 * D per head per (row, attended kv token): QK^T and PV),
    from the call's own inputs."""
    q, k_pool, _, seg_tables, seg_pos, seg_rows = args[:6]
    t, h, d = q.shape
    bs, elem = k_pool.shape[1], q.element_size()
    tables = seg_tables.cpu().numpy()
    pos, rows = seg_pos.cpu().numpy(), seg_rows.cpu().numpy()
    blocks, attended = set(), 0
    for s in np.flatnonzero(rows > 0):
        n, pos0 = int(rows[s]), int(pos[s])
        blocks.update(tables[s, :-(-(pos0 + n) // bs)].tolist())
        attended += n * pos0 + n * (n + 1) // 2
    meta_bytes = sum(a.numel() * a.element_size() for a in args[3:])
    n_bytes = 2 * len(blocks) * bs * h * d * elem + 2 * t * h * d * elem \
        + meta_bytes
    return n_bytes, 4 * attended * h * d


def rpa_bound(args, peaks):
    """The least time the card could take for one call (:func:`bound_of`
    of its work)."""
    return bound_of(*rpa_work(args), args[0].dtype, peaks)


class AttentionProbe:
    """For one engine step: CUDA events around every attention call the
    model makes, and the bound of the step's first call (every layer's
    call has the same segments, so the same work)."""

    def __init__(self):
        import paddle_tpu_torch.serving.model as serving_model

        self._module = serving_model
        self._real = serving_model.ragged_paged_attention_chunked
        self._events, self._args = [], None

    def __enter__(self):
        self._module.ragged_paged_attention_chunked = self._timed
        return self

    def __exit__(self, *exc):
        self._module.ragged_paged_attention_chunked = self._real

    def _timed(self, *args, **kwargs):
        if self._args is None:
            self._args = args
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._real(*args, **kwargs)
        end.record()
        self._events.append((start, end))
        return out

    def report(self, peaks):
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self._events]
        bound = rpa_bound(self._args, peaks)
        return dict(calls=len(ms), attention_ms=sum(ms),
                    ms_per_call=sum(ms) / len(ms),
                    rows=int(self._args[0].shape[0]),
                    live_segments=int((self._args[5] > 0).sum().item()),
                    bytes_per_call=bound["bytes"], ops_per_call=bound["ops"],
                    bound_ms_per_call=bound["bound_ms"],
                    bound_by=bound["bound_by"])


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
        pad_zero = bool((got[n_live:] == 0).all().item())
        if not (err <= tol[dtype] and pad_zero
                and torch.isfinite(got).all().item()):
            raise AssertionError(
                f"kernel disagrees with the plain version ({dtype}): max "
                f"abs err {err} (tol {tol[dtype]}), inactive rows zero: "
                f"{pad_zero}")
        ms, plain_ms = timer.median_ms(kernel), timer.median_ms(plain)
        res = dict(dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   tol=tol[dtype], inactive_rows_zero=pad_zero,
                   segments=n_segs, rows=n_live, ms=ms, plain_ms=plain_ms,
                   **rpa_bound(args, peaks), peaks_of=peaks["name"])
        emit("kernel", name="ragged_paged_attention_chunked", **res)
        results[res["dtype"]] = res
        del args
    return results


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


def profile_decode_steps(engine, prompts, peaks):
    """After the measured run: serve the prompts again (greedy), and once
    all 16 decode, time 3 steps plainly, the next 3 under
    ``torch.profiler`` and one more with CUDA events around its attention
    calls, then evict the rest. The profiler's overhead stays out of every
    end-to-end number."""
    from paddle_tpu_torch.serving import SamplingParams

    reqs = [engine.submit(p, SamplingParams(max_new_tokens=64))
            for p in prompts]
    plain_ms, profiled_ms, prof, out = [], [], None, None
    while out is None and engine.scheduler.has_work:
        decoding = all(r.state in ("running", "finished") for r in reqs)
        if decoding and len(plain_ms) == 3 and prof is None:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        ts = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        if decoding:
            (plain_ms if prof is None else profiled_ms).append(
                (time.perf_counter() - ts) * 1e3)
        if len(profiled_ms) == 3:
            prof.stop()
            out = device_breakdown(prof, 3, profiled_ms, plain_ms)
            with AttentionProbe() as probe:
                engine.step()
            out["attention"] = probe.report(peaks)
    engine.stop(drain=False)
    if engine.kv.blocks_in_use != 0:
        raise AssertionError("KV blocks leaked in the profiling pass")
    return out or {"device_time": "not measured (no decode-only window)"}


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

    return EngineConfig(max_slots=16, token_budget=256, block_size=16,
                        max_blocks_per_seq=128, num_blocks=2048,
                        dtype=torch.bfloat16, **kwargs)


def phase_serve(device, cfg, model, peaks, launches_of, reset_launches):
    from paddle_tpu_torch.serving import Engine, SamplingParams

    engine = Engine(model, serve_config(), device=device)
    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(32, 1025, 16)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    params = [SamplingParams(max_new_tokens=64) if i % 2 == 0 else
              SamplingParams(max_new_tokens=64, temperature=0.8, top_k=50,
                             seed=i) for i in range(16)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, sp) for p, sp in zip(prompts[:8], params[:8])]
    step_ms, n_steps, mixed = [], 0, None
    while engine.scheduler.has_work:
        if n_steps == 3:
            reqs += [engine.submit(p, sp)
                     for p, sp in zip(prompts[8:], params[8:])]
        ts = time.perf_counter()
        if n_steps == 4:  # a mixed step: decode rows + prefill chunks
            s_start = torch.cuda.Event(enable_timing=True)
            s_end = torch.cuda.Event(enable_timing=True)
            with AttentionProbe() as probe:
                s_start.record()
                progressed = engine.step()
                s_end.record()
            mixed = dict(probe.report(peaks),
                         step_ms=s_start.elapsed_time(s_end))
            mixed["fraction"] = mixed["attention_ms"] / mixed["step_ms"]
        else:
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
    breakdown = profile_decode_steps(engine, prompts, peaks)
    emit("serve", config="gpt3_1p3b", layers=cfg.num_layers,
         dtype="bfloat16", requests=len(reqs), prompt_tokens=int(lens.sum()),
         output_tokens=n_out, steps=n_steps, wall_s=wall,
         output_tok_per_s=n_out / wall, mean_step_ms=float(np.mean(step_ms)),
         ttft_p50_ms=float(np.median(ttft)), launches=launches,
         mixed_step=mixed, decode_step_breakdown=breakdown,
         kv_blocks_peak=engine.kv.blocks_peak,
         peak_device_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


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


def phase_flash(device, peaks, timer, batch=8, heads=16, s=1024, d=128):
    """The three flash-attention kernels against their plain versions at
    the training path's shapes (B=8, H=16 -> BH=128, S=1024, D=128,
    causal), fp32 and bf16, plus a bf16 dropout case; median times with
    the L2 cache flushed; scaled_dot_product_attention as the yardstick."""
    from paddle_tpu_torch.ops.flash_attention import (flash_dkv, flash_dq,
                                                      flash_fwd)

    bh, causal = batch * heads, True
    scale = 1.0 / d ** 0.5
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
            res = dict(kind=kind, case=tag,
                       max_abs_err=max(e for e, _ in errs),
                       rel_err=max(r for _, r in errs), tol=TOL[dtype],
                       rel_tol=REL_TOL[dtype], bh=bh, seq=s, head_dim=d,
                       causal=causal, dropout=dropout)
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
    backward as one figure. Timed here only; the port never calls it."""
    import torch.nn.functional as F

    shape = (batch, q.shape[0] // batch) + tuple(q.shape[1:])
    qs, ks, vs = (x.reshape(shape).detach().requires_grad_(True)
                  for x in (q, k, v))
    gout = do.reshape(shape)
    fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    out = fwd()
    bwd = lambda: torch.autograd.grad(out, (qs, ks, vs), gout,
                                      retain_graph=True)
    return dict(sdpa_forward_ms=timer.median_ms(fwd),
                sdpa_backward_ms=timer.median_ms(bwd))


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
    cfg = gpt3_1p3b()
    weights = random_weights(cfg, cfg.num_layers, device)
    phase_model(device, cfg, weights)
    torch.cuda.empty_cache()
    model = build_model(cfg, weights, device, torch.bfloat16)
    del weights
    serve_launches = phase_serve(device, cfg, model, peaks, _build.launches,
                                 _build.reset_launches)
    phase_prefix(device, cfg, model, _build.launches, _build.reset_launches)
    del model
    torch.cuda.empty_cache()

    flash = phase_flash(device, peaks, timer)
    xent = phase_xent(device, peaks, timer)
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
        kernel["bfloat16"], None)]
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
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
