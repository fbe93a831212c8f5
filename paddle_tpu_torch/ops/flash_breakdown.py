"""Where the bf16 flash forward's time goes, by knock-out on the card.

    python3 -m paddle_tpu_torch.ops.flash_breakdown

Builds copies of ``csrc/flash_attention.cu`` with one part of the forward
kernel (``fa_fwd_wgmma_kernel``) taken out, and times each against the
kernel as it is at the training path's shape (BH=128, S=1024, D=128),
causal and not, the L2 cache flushed before each of 25 launches, in two
rounds of opposite order. A copy's output is wrong by design: only its
time counts. The parts:

- ``no_kv_loads``: the producer stops loading K and V once the ring is
  full; the consumers reuse the tiles already there;
- ``no_tile_math``: the consumers wait for and release every tile but do
  neither product nor the softmax;
- ``no_store``: the epilogue writes neither out nor lse;
- ``skeleton``: ``no_kv_loads`` and ``no_tile_math`` together.

Prints one JSON object per (variant, causal, round), then the card's name
and power limit. Needs a CUDA card and nvcc, like the kernels.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import _build
from . import flash_attention as fa

CUTS = {
    "no_kv_loads": [(
        "        mbar_expect_tx(&full[s], 2 * kKvBytes);",
        "        if (t >= kFwdStages) {\n"
        "          mbar_arrive(&full[s]);\n"
        "          continue;\n"
        "        }\n"
        "        mbar_expect_tx(&full[s], 2 * kKvBytes);")],
    "no_tile_math": [(
        "        fwd_tile_wgmma<D>(o, m, l, q_base,",
        "        if (sq < 0) fwd_tile_wgmma<D>(o, m, l, q_base,")],
    "no_store": [("    if (live) {\n      // out through",
                  "    if (live && sq < 0) {\n      // out through")],
}
CUTS["skeleton"] = CUTS["no_kv_loads"] + CUTS["no_tile_math"]


def build(out: Path) -> dict:
    """The kernel as it is and each cut copy, built in parallel."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, cuts in [("as_is", [])] + list(CUTS.items()):
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the line to cut is not unique: "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{log[-3000:]}")
        libs[name] = lib
    return libs


def median_ms(fn, flush, reps: int = 25) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_breakdown: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(128, 1024, 128, generator=g, device=dev)
               .bfloat16() for _ in range(3))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        names = list(libs)
        for causal in (True, False):
            args = (causal, 128 ** -0.5, 0.0, 0)
            for rnd, order in enumerate((names, names[::-1])):
                for name in order:
                    _build._LIBS["flash_attention"] = ctypes.CDLL(
                        str(libs[name]))
                    ms = median_ms(lambda: fa.flash_fwd(q, k, v, *args),
                                   flush)
                    print(json.dumps({"variant": name, "causal": causal,
                                      "round": rnd, "fwd_ms": ms}),
                          flush=True)
        _build._LIBS.pop("flash_attention", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
