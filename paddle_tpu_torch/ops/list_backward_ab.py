"""The list dQ kernel's K/V ring at padded D 256: three slots against two,
on the card.

    python3 -m paddle_tpu_torch.ops.list_backward_ab

``bsa_dq_wgmma_kernel`` (``csrc/attention_wgmma.cuh``) streams K and V
past D 128 as items of their own, each with its barrier pair. At D 256
the 227 KB of a block hold Q and dO (128 KB) and three 32 KB slots: the
next tile's K streams while a tile runs, and a tile's V while its S is
computed. Two slots are one K + V stage: both come in after the previous
tile. This builds the flash and block-sparse sources beside a copy of
the header with two slots at D 256, and times that build's bf16 dQ and
the header's as it is at the wide shapes of ``chip_smoke.py`` (flash BH
16, S 1024, causal; block-sparse BH 8, S 2048 on BigBird's pattern at
128-token blocks), the L2 flushed before each of 25 launches, in the
order as is, two slots, two slots, as is; each variant is first held to
the plain version. Prints one JSON object per (family, variant, round),
then the card's name and power limit. Needs a CUDA card and nvcc, like
the kernels.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import _build
from . import block_sparse_attention as bsa
from . import flash_attention as fa
from .flash_breakdown import load_variant, median_ms

SLOTS = "  return D <= 128 ? kDqStages : D == 192 ? 5 : 3;"
VARIANTS = {"as_is": SLOTS, "two_slots": SLOTS.replace(": 3;", ": 2;")}
SOURCES = ("flash_attention", "block_sparse_attention")


def build(out: Path) -> dict:
    """Each variant's header beside copies of both sources, all built at
    once: (variant, source) -> library."""
    header = (_build.CSRC / "attention_wgmma.cuh").read_text()
    if header.count(SLOTS) != 1:
        raise RuntimeError("the ring's slot count is not where it was")
    procs = {}
    for name, line in VARIANTS.items():
        d = out / name
        d.mkdir()
        (d / "attention_wgmma.cuh").write_text(header.replace(SLOTS, line))
        for src in SOURCES:
            shutil.copy(_build.CSRC / f"{src}.cu", d / f"{src}.cu")
            lib = d / f"lib{src}.so"
            procs[name, src] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(d / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{key} did not build:\n{log[-3000:]}")
        libs[key] = lib
    return libs


def bigbird_mask(n: int, seed: int = 0) -> np.ndarray:
    """chip_smoke.py's pattern: a window of 3 blocks, 2 global kv blocks
    and 3 random kv blocks a q block."""
    rng = np.random.default_rng(seed)
    mask = bsa.local_global_mask(n, n, window=1, global_blocks=2)
    for i in range(n):
        mask[i, rng.choice(n, 3, replace=False)] = True
    return mask


def main() -> int:
    if not torch.cuda.is_available():
        print("list_backward_ab: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    d = 256
    cases = {}
    for fam, bh, s in (("flash", 16, 1024), ("sparse", 8, 2048)):
        q, k, v, do = (torch.randn(bh, s, d, generator=g, device=dev)
                       .bfloat16() for _ in range(4))
        if fam == "flash":
            args = (True, d ** -0.5, 0.0, 0)
            fwd, dq = fa.flash_fwd, fa.flash_dq
        else:
            spec = bsa.block_mask_spec(bigbird_mask(s // 128), s, s, False)
            args = (spec, False, d ** -0.5)
            fwd, dq = bsa.bsa_fwd, bsa.bsa_dq
        out, lse = fwd(q, k, v, *args, impl="torch")
        delta = (do.float() * out.float()).sum(-1)
        cases[fam] = (lambda impl="cuda", dq=dq, t=(q, k, v, do, lse, delta),
                      a=args: dq(*t, *a, impl=impl))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for fam, call in cases.items():
            src = SOURCES[fam == "sparse"]
            want = call(impl="torch").float()
            for rnd, name in enumerate(("as_is", "two_slots", "two_slots",
                                        "as_is")):
                load_variant(src, libs[name, src])
                err = (call().float() - want).norm() / want.norm()
                if not err <= 1e-2:
                    raise AssertionError(f"{fam} {name}: relative norm "
                                         f"error {err.item()}")
                print(json.dumps({"family": fam, "kind": "dq", "head_dim": d,
                                  "variant": name, "round": rnd,
                                  "ms": median_ms(call, flush)}), flush=True)
            _build._LIBS.pop(src, None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
