"""Build and load the port's CUDA kernels from the sources in this checkout.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes`` and
called with ``data_ptr()``s and the current stream. The build runs at first
use (or through :func:`build`, which starts one ``nvcc`` per source, all at
once) into ``paddle_tpu_torch/_build/<name>-<hash>/``, keyed by a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one
is loaded as it is. A failed build raises with the compiler's output;
nothing falls back to another path.

This module also keeps the kernels' launch counts: a wrapper calls
:func:`count_launch` where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["build", "load", "ptxas_report", "count_launch", "launches",
           "reset_launches", "pick_impl", "KERNEL_SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
# -I csrc: a source built from a copy elsewhere still finds the shared
# headers (``*.cuh``)
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}")
KERNEL_SOURCES = ("ragged_paged_attention", "flash_attention", "softmax_xent",
                  "block_sparse_attention", "layer_norm")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {}


def count_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launches() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launches`."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    _LAUNCHES.clear()


def pick_impl(impl: str, t) -> str:
    """The route a kernel entry point takes for tensor ``t``: ``impl``
    "cuda" (the kernel) or "torch" (its plain version), or for "auto" the
    kernel on a CUDA tensor and the plain version on a CPU tensor.
    Comparisons of the two routes replace this function."""
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"impl must be auto|cuda|torch, got {impl!r}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "torch"
    return impl


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "paddle_tpu_torch need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source started together. Returns seconds per source
    that was compiled. Raises ``RuntimeError`` with the compiler output of
    every source that failed."""
    names = list(KERNEL_SOURCES if names is None else names)
    procs = {}
    nvcc = None
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(lib.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, lib, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, log, tmp, lib, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + lib.with_suffix(".log").read_text())
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def ptxas_report(name: str) -> str:
    """Registers / shared memory / spills per kernel, as ``ptxas -v``
    printed them when ``name`` was built."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "ptxas" in line or "spill" in line)
