"""How the segmented paged-attention kernel's time moves with its split and
its ring, and what its launcher costs the host, on the card.

    python3 -m paddle_tpu_torch.ops.paged_splits
    python3 -m paddle_tpu_torch.ops.paged_splits --parent DIR

Times ``rpa_chunked_kernel`` (bf16, H=16, D=128, B=16, MAXB=128) on two
inputs, the L2 cache flushed before each of 25 launches:

- ``decode``: a 16-row decode step as the serving engine packs it (1-row
  segments in tiles of q_tile 8), rows of 64..1056 cached tokens (the
  serve traffic's prompts of 32..1024 tokens, 32 tokens into their
  decode), every row's blocks distinct in a 2048-block pool;
- ``mix``: a ragged step at the serving width: 16 decode rows of 1..2048
  tokens, 8-row prefill tiles at unaligned offsets, padded to 256
  segment slots with inactive ones, in a 2048-block pool; and
  ``mix_active``, the same call with only its active segments, whose
  difference from ``mix`` is what the empty blocks cost.

Without arguments: each input at several splits (``split_plan`` replaced
for the call; the launcher's own pick marked ``auto``) and with the
kernel built at other geometries (``stage16k``: 16 KB stages, so 32-token
chunks and no tensor-core path at D=128; ``row_unroll8``: 8 tokens a
decode group loads at once, not 4), in two rounds of opposite order; the
per-row kernel (``rpa_row_kernel``) on the decode rows as the yardstick.
Prints each variant's ptxas registers and spills.

With ``--parent DIR`` (DIR the root of another checkout of the repo, such
as the parent commit's ``git archive``): both paged launchers of DIR's
``paddle_tpu_torch`` and of this one, in the order DIR, this, this, DIR,
on ``decode`` and ``mix``, each timed the same way: event ms, profiler
device ms and host µs a call.

Prints one JSON object per timing, then the card's name and power limit.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import _build
from .flash_breakdown import build, load_variant, median_ms

# name -> [(a line of the source, the line in this variant)]: the kernel
# as it is, and other geometries
VARIANTS = {"as_is": [],
            "stage16k": [("constexpr int kStageBytes = 32 * 1024;",
                          "constexpr int kStageBytes = 16 * 1024;")],
            "row_unroll8": [("constexpr int kRowUnroll = 4;",
                             "constexpr int kRowUnroll = 8;")]}
SPLITS = {"decode": (64, 128, 256, 512, 2048),
          "mix": (256, 512, 1024, 2048), "mix_active": (1024, 2048)}
HEADS, HEAD_DIM, BLOCK, MAXB, POOL = 16, 128, 16, 128, 2048


def _segments(rows, tq, device):
    """Segment metadata for ``rows`` = [(n_rows, pos0, table)], padded
    with inactive slots to ``len(rows)`` or more by the caller."""
    n = len(rows)
    tables = np.zeros((n, MAXB), np.int64)
    pos = np.zeros(n, np.int64)
    cnt = np.zeros(n, np.int64)
    idx = np.zeros((n, tq), np.int64)
    r = 0
    for s, seg in enumerate(rows):
        if seg is None:
            continue
        k, pos0, table = seg
        tables[s], pos[s], cnt[s] = table, pos0, k
        idx[s, :k] = np.arange(r, r + k)
        r += k
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return r, [i32(a) for a in (tables, pos, cnt, idx)]


def inputs(kind: str, device):
    """(q, k_pool, v_pool, tables, seg_pos, seg_rows, seg_row_idx) of one
    of the inputs above, bf16, seeded."""
    rng = np.random.default_rng(7)
    cap = BLOCK * MAXB
    if kind.startswith("decode"):
        lens = rng.integers(32, 1025, 16) + 32
        perm = rng.permutation(POOL)
        rows, at = [], 0
        for n in lens:
            table = np.zeros(MAXB, np.int64)
            need = -(-int(n) // BLOCK)
            table[:need] = perm[at:at + need]
            at += need
            rows.append((1, int(n) - 1, table))
        tq = 8
    else:
        rows = [(1, int(n) - 1, rng.integers(0, POOL, MAXB)) for n in
                np.concatenate([[1, cap], rng.integers(2, cap, 14)])]
        while sum(k for k, _, _ in rows) < 224:
            pos0 = int(rng.integers(0, (cap - 8) // BLOCK)) * BLOCK
            rows.append((8, pos0 + int(rng.integers(1, BLOCK)),
                         rng.integers(0, POOL, MAXB)))
        if kind == "mix":
            rows += [None] * (256 - len(rows))
        tq = 8
    n_rows, meta = _segments(rows, tq, device)
    g = torch.Generator(device=device).manual_seed(8)
    randn = lambda *s: torch.randn(*s, generator=g, device=device).bfloat16()
    pool = (POOL, BLOCK, HEADS, HEAD_DIM)
    return (randn(n_rows, HEADS, HEAD_DIM), randn(*pool), randn(*pool),
            *meta)


def device_ms(fn, flush, fragment: str, reps: int = 25) -> float:
    """Median device time of the kernels named ``fragment`` over ``reps``
    launches of ``fn``, the L2 flushed before each, from the profiler's
    kernel records (no host time in it, unlike events around a call whose
    host side outlasts the flush); None when the profiler kept fewer than
    half of the records."""
    for _ in range(3):
        fn()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and fragment in e.name)
    if len(times) < reps // 2:  # the profiler may drop records
        return None  # not measured
    return times[len(times) // 2]


def host_us(fn, reps: int = 200) -> float:
    """Median host microseconds a call of ``fn`` takes to return, each
    call made on an idle card (a sync before it), so that no wait for
    room in the launch queue counts."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def timings(fn, flush, fragment: str) -> dict:
    return dict(ms=median_ms(fn, flush),
                device_ms=device_ms(fn, flush, fragment),
                host_us=host_us(fn))


def _rpa_module():
    # the module: ops.ragged_paged_attention is the entry-point function
    return importlib.import_module(__package__ + ".ragged_paged_attention")


def load_tree(root: Path, module: str = "ops.ragged_paged_attention"):
    """``paddle_tpu_torch.<module>`` of the checkout at ``root``, imported
    beside this one: the package's modules are set aside while it loads,
    then put back (the loaded modules keep their own, and build their
    kernels into ``root``)."""
    name = __package__.split(".")[0]
    mine = {k: sys.modules.pop(k) for k in list(sys.modules)
            if k == name or k.startswith(name + ".")}
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module(f"{name}.{module}")
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules
                  if k == name or k.startswith(name + ".")]:
            del sys.modules[k]
        sys.modules.update(mine)


def compare_launchers(parent: Path, data, flush) -> None:
    """Row 1 and row 2 of ``parent``'s tree and of this one on
    ``decode`` and ``mix``, in the order parent, this, this, parent."""
    trees = {"parent": load_tree(parent), "change": _rpa_module()}
    dummy = torch.zeros(1, dtype=torch.int32, device=flush.device)
    for rnd, tree in enumerate(("parent", "change", "change", "parent")):
        rpa = trees[tree]
        for kind in ("decode", "mix"):
            args = data[kind]
            call = lambda: rpa.ragged_paged_attention_chunked(
                *args, dummy, impl="cuda")
            print(json.dumps({"tree": tree, "round": rnd, "input": kind,
                              "kernel": "rpa_chunked_kernel",
                              **timings(call, flush,
                                        "rpa_chunked_kernel")}),
                  flush=True)
        q, kp, vp, tables, pos, cnt, _ = data["decode"]
        lens = (pos + cnt).to(torch.int32)
        row = lambda: rpa.ragged_paged_attention(q, kp, vp, tables, lens,
                                                 impl="cuda")
        print(json.dumps({"tree": tree, "round": rnd, "input": "decode",
                          "kernel": "rpa_row_kernel",
                          **timings(row, flush, "rpa_row_kernel")}),
              flush=True)


def sweep(data, flush) -> None:
    """Every input at its splits under every variant of the kernel."""
    rpa = _rpa_module()
    scale = HEAD_DIM ** -0.5
    q, kp, vp, tables, pos, cnt, _ = data["decode"]
    lens = (pos + cnt).to(torch.int32)
    row = lambda: rpa.ragged_paged_attention(q, kp, vp, tables, lens,
                                             impl="cuda")
    print(json.dumps({"input": "decode", "kernel": "rpa_row_kernel",
                      **timings(row, flush, "rpa_row_kernel")}), flush=True)
    planner = rpa.split_plan
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), rpa._SOURCE, VARIANTS)
        for name, (_, ptxas) in libs.items():
            print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        names = list(libs)
        try:
            for rnd, order in enumerate((names, names[::-1])):
                for name in order:
                    load_variant(rpa._SOURCE, libs[name][0])
                    for kind, splits in SPLITS.items():
                        args = data[kind]
                        auto, _ = planner(args[6].shape[0], HEADS,
                                          BLOCK * MAXB, args[6].shape[1],
                                          HEAD_DIM)
                        for split in sorted(set(splits) | {auto}):
                            rpa.split_plan = \
                                lambda *a, s=split: (s, -(-a[2] // s))
                            call = lambda: rpa._rpa_chunked_cuda(*args,
                                                                 scale)
                            print(json.dumps({
                                "input": kind, "variant": name,
                                "round": rnd, "split": split,
                                "auto": split == auto,
                                "segments": int(args[6].shape[0]),
                                **timings(call, flush,
                                          "rpa_chunked_kernel")}),
                                flush=True)
        finally:
            rpa.split_plan = planner
            _build._LIBS.pop(rpa._SOURCE, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout: compare the launchers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_splits: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    data = {kind: inputs(kind, dev) for kind in SPLITS}
    if args.parent is not None:
        compare_launchers(args.parent.resolve(), data, flush)
    else:
        sweep(data, flush)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
