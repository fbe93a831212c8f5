"""Where the bf16 flash forward's and dQ's time goes, by knock-out on the
card.

    python3 -m paddle_tpu_torch.ops.flash_breakdown

Builds copies of ``csrc/flash_attention.cu`` with one part of the forward
kernel (``fa_fwd_wgmma_kernel``) or of the dQ kernel
(``fa_dq_wgmma_kernel``) taken out, and times each against the kernel as
it is at the training path's shape (BH=128, S=1024, D=128), causal and
not, the L2 cache flushed before each of 25 launches, in two rounds of
opposite order. A copy's output is wrong by design: only its time
counts. The parts, for each kernel:

- ``no_kv_loads``: K and V are loaded no more once the ring is full; the
  consumers reuse the tiles already there;
- ``no_tile_math``: the consumers wait for and release every tile but do
  none of its products (nor the softmax, or ds);
- ``no_store``: the epilogue writes nothing (neither out nor lse, or dQ);
- ``skeleton``: ``no_kv_loads`` and ``no_tile_math`` together.

Prints one JSON object per (kernel, variant, causal, round), then the
card's name and power limit. Needs a CUDA card and nvcc, like the
kernels.
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

FWD_CUTS = {
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
FWD_CUTS["skeleton"] = FWD_CUTS["no_kv_loads"] + FWD_CUTS["no_tile_math"]
DQ_CUTS = {
    "no_kv_loads": [("      load(t - 1 + kDqStages);",
                     "      mbar_arrive(&full[(t - 1) % kDqStages]);")],
    "no_tile_math": [("      dq_tile_wgmma<D>(acc, q_base,",
                      "      if (sq < 0) dq_tile_wgmma<D>(acc, q_base,")],
    "no_store": [("  if (live) {\n    // dQ through",
                  "  if (live && sq < 0) {\n    // dQ through")],
}
DQ_CUTS["skeleton"] = DQ_CUTS["no_kv_loads"] + DQ_CUTS["no_tile_math"]
# each copy's cuts, by "<kernel>_<part>"
CUTS = {"as_is": [],
        **{f"fwd_{name}": cuts for name, cuts in FWD_CUTS.items()},
        **{f"dq_{name}": cuts for name, cuts in DQ_CUTS.items()}}


def build(out: Path, source: str = "flash_attention",
          variants: dict = CUTS) -> dict:
    """Copies of ``csrc/<source>.cu`` into ``out``, each with its (line,
    replacement) edits, built in parallel: name -> (library, the ptxas
    lines of its log)."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the line to change is not "
                                   f"unique: {old!r}")
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
        libs[name] = (lib, [line for line in log.splitlines()
                            if "ptxas" in line or "spill" in line])
    return libs


def load_variant(source: str, lib: Path) -> None:
    """Make the kernel entry points of ``source`` launch from ``lib`` (a
    library :func:`build` made) until ``_build._LIBS.pop(source)``."""
    _build._LIBS[source] = ctypes.CDLL(str(lib))


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
    q, k, v, do = (torch.randn(128, 1024, 128, generator=g, device=dev)
                   .bfloat16() for _ in range(4))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for kernel in ("fwd", "dq"):
            # the kernel as it is, then its own cuts
            names = ["as_is"] + [name for name in libs
                                 if name.startswith(kernel + "_")]
            for causal in (True, False):
                args = (causal, 128 ** -0.5, 0.0, 0)
                out, lse = fa.flash_fwd(q, k, v, *args, impl="torch")
                delta = (do.float() * out.float()).sum(-1)
                call = {"fwd": lambda: fa.flash_fwd(q, k, v, *args),
                        "dq": lambda: fa.flash_dq(q, k, v, do, lse, delta,
                                                  *args)}[kernel]
                for rnd, order in enumerate((names, names[::-1])):
                    for name in order:
                        load_variant("flash_attention", libs[name][0])
                        print(json.dumps({
                            "kernel": kernel, "variant": name,
                            "causal": causal, "round": rnd,
                            "ms": median_ms(call, flush)}), flush=True)
        _build._LIBS.pop("flash_attention", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
