"""The LayerNorm forward kernel under every launch plan, timed on the card.

    python3 -m paddle_tpu_torch.ops.layer_norm_plans

At the train path's activations ([8192, 2048]) and a decode step's rows
([16, 2048]), fp32 and bf16, launches ``csrc/layer_norm.cu`` with each
(warps a row, 16-byte vectors a thread) that covers a row exactly, and
with the looping kernel (0, 0); marks the plan ``_plan`` picks; and times
each, and ``torch.nn.functional.layer_norm`` as the yardstick, as the
median of 25 launches with the L2 cache flushed before each, twice over:
by writing a 256 MB buffer (as ``chip_smoke.py`` times, which leaves
the L2 full of dirty lines for the launch to write back) and by reading
it. Every plan's output is held to the plain version first. Prints one
JSON object per (shape, dtype, plan), then the card's name and power
limit. Needs a CUDA card and nvcc, like the kernel.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from . import layer_norm as ln

SHAPES = ((8192, 2048), (16, 2048))


def median_ms(fn, flush, by_read: bool, reps: int = 25) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if by_read:
            flush.view(torch.int32).sum()
        else:
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
        print("layer_norm_plans: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    lib = ln._kernel_lib()
    g = torch.Generator(device=dev).manual_seed(0)
    for n, f in SHAPES:
        gamma = torch.randn(f, generator=g, device=dev)
        beta = torch.randn(f, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(n, f, generator=g, device=dev) * 2
                 + 0.5).to(dtype)
            want = ln.ln_fwd_torch(x, gamma, beta, 1e-5)
            vec = 16 // x.element_size()
            plans = [(w, c) for w in (1, 2, 4, 8) for c in (1, 2, 4, 8, 16)
                     if 32 * w * c * vec == f] + [(0, 0)]
            y = torch.empty_like(x)

            def launch(plan):
                err = lib.ln_fwd_launch(
                    x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    y.data_ptr(), n, f, 1e-5, ln._DTYPE_CODES[dtype], *plan,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"plan {plan}: cudaError {err}")

            calls = {plan: (lambda p=plan: launch(p)) for plan in plans}
            calls["F.layer_norm"] = lambda: torch.nn.functional.layer_norm(
                x, (f,), gamma.to(dtype), beta.to(dtype), 1e-5)
            for what, call in calls.items():
                res = {"shape": [n, f], "dtype": str(dtype), "plan": what,
                       "picked": what == ln._plan(f, x.element_size())}
                if what != "F.layer_norm":
                    y.zero_()
                    call()
                    res["rel_err"] = ((y.float() - want.float()).norm()
                                      / want.float().norm()).item()
                res["ms_write_flush"] = median_ms(call, flush, False)
                res["ms_read_flush"] = median_ms(call, flush, True)
                print(json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
