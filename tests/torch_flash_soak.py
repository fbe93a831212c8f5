"""Rerun one case of test_torch_flash_attention.py many times in one
process and report whether either side's bits ever move.

    JAX_PLATFORMS=cpu python tests/torch_flash_soak.py --case 0 --runs 150

Both sides run as the test runs them: the JAX package's Pallas kernels in
interpret mode (fp32 matmuls at "highest", as tests/conftest.py sets) and
the port's plain versions through ``flash_attention``'s autograd. Each
run is compared bit for bit with the first, and with the other side
against the test's ATOL. Prints one JSON line: the case, the runs, how
many moved on each side, and the largest difference between the sides
for out, dq, dk and dv over all runs, beside each side's distance from
the float64 values (first run) and the scale of one fp32 sum's rounding
error in each (``rounding_scale``). Start several at once to
load the machine as a parallel test run does.
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_DEFAULT_MATMUL_PRECISION", "highest")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

from paddle_tpu.ops.pallas import flash_attention as jax_flash  # noqa: E402
from paddle_tpu_torch.ops.flash_attention import flash_attention  # noqa
from test_torch_flash_attention import (ATOL, CASES,  # noqa: E402
                                        _float64_attention, _inputs)

NAMES = ("out", "dq", "dk", "dv")


def run_once(case):
    b, sq, sk, h, d, causal, dropout = case
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=sq + sk + d)
    seed = 1234 if dropout else None

    def jax_loss(qa, ka, va):
        out = jax_flash(qa, ka, va, causal=causal, dropout=dropout,
                        seed=seed, interpret=True)
        return jnp.sum(out * g), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = flash_attention(qt, kt, vt, causal=causal, dropout=dropout,
                          seed=seed)
    (got * torch.from_numpy(g)).sum().backward()
    jax_side = [np.asarray(x) for x in (want,) + tuple(grads)]
    port_side = [t.numpy() for t in (got.detach(), qt.grad, kt.grad,
                                     vt.grad)]
    return jax_side, port_side


def rounding_scale(case):
    """For each gradient's last sum (and delta's), the largest u * sum
    of |terms| over its elements, u = 2**-24, and the sum's length n:
    one rounding a term gives errors of this scale times sqrt(n) in a
    random-like order, and n times it at worst. None with dropout."""
    b, sq, sk, h, d, causal, dropout = case
    if dropout:
        return None
    q, k, v, g = (torch.from_numpy(x).double().transpose(1, 2)
                  for x in _inputs(b, sq, sk, h, d, seed=sq + sk + d))
    s = q @ k.transpose(-1, -2) / d ** 0.5
    if causal:
        rows = torch.arange(sq)[:, None] + (sk - sq)
        s = s.masked_fill(rows < torch.arange(sk)[None, :], float("-inf"))
    p = torch.softmax(s, -1)
    dp = g @ v.transpose(-1, -2)
    delta = (g * (p @ v)).sum(-1, keepdim=True)
    ds = p * (dp - delta) / d ** 0.5
    u = 2.0 ** -24
    terms = {"dq": (ds.abs() @ k.abs(), sk),
             "dk": (ds.abs().transpose(-1, -2) @ q.abs(), sq),
             "dv": (p.transpose(-1, -2) @ g.abs(), sq),
             "delta": ((g * (p @ v)).abs().sum(-1), d)}
    return {n: {"u_sum": u * float(t.max()), "n": length}
            for n, (t, length) in terms.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", type=int, default=0,
                    help="index into the test's CASES")
    ap.add_argument("--runs", type=int, default=100)
    args = ap.parse_args()
    case = CASES[args.case]
    t0 = time.perf_counter()
    jax0, port0 = run_once(case)
    b, sq, sk, h, d, causal, dropout = case
    exact = _float64_attention(*_inputs(b, sq, sk, h, d, seed=sq + sk + d),
                               causal, dropout, 1234 if dropout else None)
    from_exact = {side: {n: float(np.abs(x - exact[n]).max())
                         for n, x in zip(NAMES, xs)}
                  for side, xs in (("jax", jax0), ("port", port0))}
    moved = {"jax": 0, "port": 0}
    worst = dict.fromkeys(NAMES, 0.0)
    misses = 0
    for _ in range(args.runs):
        jax_side, port_side = run_once(case)
        moved["jax"] += any(not np.array_equal(a, b)
                            for a, b in zip(jax_side, jax0))
        moved["port"] += any(not np.array_equal(a, b)
                             for a, b in zip(port_side, port0))
        errs = [float(np.abs(a - b).max())
                for a, b in zip(jax_side, port_side)]
        misses += max(errs) > ATOL
        for n, e in zip(NAMES, errs):
            worst[n] = max(worst[n], e)
    print(json.dumps({"case": list(case), "runs": args.runs,
                      "runs_moved": moved, "runs_past_atol": misses,
                      "atol": ATOL, "max_abs_diff": worst,
                      "max_abs_from_float64": from_exact,
                      "rounding_scale": rounding_scale(case),
                      "torch_threads": torch.get_num_threads(),
                      "seconds": round(time.perf_counter() - t0, 1)}))
    return 1 if misses or moved["jax"] or moved["port"] else 0


if __name__ == "__main__":
    sys.exit(main())
