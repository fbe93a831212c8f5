"""serving.Engine — continuous batching over a paged KV cache, on one card.

One step is: plan (the scheduler picks decode rows and prefill chunks),
pack (host arrays into one device upload), one forward over the step's
token rows (``GPTServingModel.token_step``, which writes K/V into the
pools in place and runs the ragged paged attention kernel), on-device
sampling of the rows that emit a token, and ONE host sync — the fetch of
those sampled token ids, which the scheduler needs for stop conditions
and streaming (``commit_step``).

The JAX engine compiles one fixed-shape program over ``token_budget``
rows and pads. This engine runs eagerly, so a step carries exactly the
planned rows and segments, and the LM head and sampling run only on the
rows that sample; nothing is padded. Capturing the step in a CUDA graph
(which would bring fixed shapes back) is later work.

Rows are packed into *segments* (consecutive rows of one sequence, up to
``q_tile``), and each sequence's block table is built once per step.

**Prefix cache** (``EngineConfig.prefix_cache``): a radix tree over the
paged pool; admission skips cached prefix tokens, completion/preemption
donates full blocks (see ``serving/prefix_cache.py``).

SLO metrics (``serving.*``): TTFT, time per output token, step time,
queue depth, batch occupancy, preemptions, KV-pool occupancy, prefix-cache
hits — through ``paddle_tpu_torch.observability``.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import observability as _obs
from ..core.device import resolve_device, same_device
from ..ops.ragged_paged_attention import check_kernel_geometry
from .kv_cache import PagedKVCache
from .model import GPTServingModel
from .prefix_cache import RadixPrefixCache
from .sampling import sample_tokens
from .scheduler import Request, SamplingParams, Scheduler, StepPlan

__all__ = ["Engine", "EngineConfig"]


@dataclass(frozen=True)
class EngineConfig:
    """Engine geometry. ``token_budget`` rows per step (decode tokens and
    prefill chunk tokens share it); ``max_slots`` concurrent sequences;
    ``num_blocks`` x ``block_size`` tokens of pooled KV per layer;
    ``max_blocks_per_seq`` bounds one sequence's table (the model length).
    ``attention``: "auto" (the CUDA kernel on a card, the plain version on
    the CPU), "cuda" or "torch". ``dtype``: the KV pools' dtype.
    ``q_tile``: rows of one sequence per attention segment.
    ``prefix_cache``: radix prefix reuse over the pool."""
    max_slots: int = 8
    token_budget: int = 16
    block_size: int = 16
    num_blocks: int = 128
    max_blocks_per_seq: int = 8
    attention: str = "auto"
    dtype: torch.dtype = torch.float32
    q_tile: int = 8
    prefix_cache: bool = False

    @property
    def max_model_len(self) -> int:
        return self.block_size * self.max_blocks_per_seq


def kernel_route(device, attention: str) -> bool:
    """Whether the engine's attention runs the CUDA kernel: ``"cuda"``
    always, ``"auto"`` on a CUDA device."""
    return attention == "cuda" or (attention == "auto"
                                   and torch.device(device).type == "cuda")


class _StepBatch(NamedTuple):
    """One step's device inputs (views of one uploaded buffer)."""
    tokens: torch.Tensor
    positions: torch.Tensor
    seg_tables: torch.Tensor
    seg_pos: torch.Tensor
    seg_rows: torch.Tensor
    seg_row_idx: torch.Tensor
    row_gather: torch.Tensor
    row_seg: torch.Tensor
    sample_rows: torch.Tensor
    top_ks: torch.Tensor
    seeds: torch.Tensor
    gen_idx: torch.Tensor
    temps: torch.Tensor


class Engine:
    """LLM serving engine: continuous batching over a paged KV cache.

    Synchronous use::

        eng = Engine(model, EngineConfig(max_slots=8))
        outs = eng.generate(prompts)       # list of token lists

    Queue use (a server loop)::

        eng.start()                        # background stepping thread
        req = eng.submit(prompt, SamplingParams(temperature=0.7, seed=1))
        tokens = req.result(timeout=60)
        eng.stop()

    The engine runs on ``device`` (CUDA unless named), which must be the
    model's device.
    """

    def __init__(self, model: GPTServingModel, config: EngineConfig,
                 device=None):
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        if config.attention not in ("auto", "cuda", "torch"):
            raise ValueError("attention must be auto|cuda|torch, got "
                             f"{config.attention!r}")
        if config.token_budget < config.max_slots:
            raise ValueError("token_budget must be >= max_slots")
        if config.num_blocks < config.max_blocks_per_seq:
            raise ValueError(
                "num_blocks must be >= max_blocks_per_seq (the pool must "
                "hold at least one full sequence)")
        if model.use_rope and model.max_position < config.max_model_len:
            raise ValueError(
                f"model rope table ({model.max_position}) shorter than "
                f"max_model_len ({config.max_model_len})")
        if config.q_tile < 1:
            raise ValueError("q_tile must be >= 1")
        self.model = model
        self.config = config
        self._tq = max(1, min(config.q_tile, config.token_budget))
        if kernel_route(self.device, config.attention):
            # refuse here what the kernel would refuse at the first step
            check_kernel_geometry(model.head_dim, self._tq)

        shape = (config.num_blocks, config.block_size, model.n_heads,
                 model.head_dim)
        self._k_pools = [torch.zeros(shape, dtype=config.dtype,
                                     device=self.device)
                         for _ in range(model.n_layers)]
        self._v_pools = [torch.zeros_like(p) for p in self._k_pools]

        self.prefix: Optional[RadixPrefixCache] = \
            RadixPrefixCache(config.block_size) if config.prefix_cache \
            else None
        self.kv = PagedKVCache(config.num_blocks, config.block_size,
                               config.max_blocks_per_seq,
                               prefix_cache=self.prefix)
        self.scheduler = Scheduler(self.kv, config.max_slots,
                                   config.token_budget,
                                   prefix_cache=self.prefix)

        self._step_lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._loop_error: Optional[BaseException] = None
        self._intake_open = True
        # serializes the intake-open check WITH the enqueue against
        # drain()'s close+evict, so no submit lands in a swept scheduler
        self._intake_lock = threading.Lock()

    # ------------------------------------------------------------ serving
    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None) -> Request:
        """Enqueue one request; returns the live :class:`Request` handle
        (``req.result()`` blocks for the tokens)."""
        prompt = [int(t) for t in prompt]
        sampling = sampling or SamplingParams()
        with self._intake_lock:
            self._check_intake(len(prompt), sampling)
            return self.scheduler.submit(Request(prompt, sampling))

    def _check_intake(self, prompt_len: int,
                      sampling: SamplingParams) -> None:
        limit = self.config.max_model_len
        if prompt_len + sampling.max_new_tokens > limit:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({sampling.max_new_tokens}) exceeds max_model_len "
                f"({limit})")
        if self._loop_error is not None:
            raise RuntimeError("serving loop died") from self._loop_error
        if not self._intake_open:
            raise RuntimeError(
                "engine intake closed (draining or stopped); start() "
                "reopens it")

    def step(self) -> bool:
        """One scheduling iteration: plan, pack, forward, sample, commit.
        Returns False when there was nothing to run."""
        with self._step_lock:
            plan = self.scheduler.plan_step()
            if plan is None:
                return False
            t0 = time.perf_counter()
            rows = [k for k, s in enumerate(plan.slots) if s.sample]
            batch = self._pack(plan, rows)
            logits = self.model.token_step(
                self._k_pools, self._v_pools, batch.tokens, batch.positions,
                batch.seg_tables, batch.seg_pos, batch.seg_rows,
                batch.seg_row_idx, batch.row_gather, batch.row_seg,
                attn_impl=self.config.attention,
                logit_rows=batch.sample_rows)
            sampled = np.zeros(len(plan.slots), np.int32)
            if rows:
                next_tokens = sample_tokens(logits, batch.temps,
                                            batch.top_ks, batch.seeds,
                                            batch.gen_idx)
                # the one host sync per step: the scheduler needs the token
                # ids for stop conditions and streaming
                sampled[rows] = next_tokens.cpu().numpy()
            if _obs._REG.enabled:
                _obs.record_serving_step(time.perf_counter() - t0,
                                         plan.n_decode, plan.n_prefill)
            self.scheduler.commit_step(plan, sampled)
            return True

    def _pack(self, plan: StepPlan, rows: List[int]) -> _StepBatch:
        """Device inputs for a plan whose slots ``rows`` sample a token.
        Consecutive slots of one request (a prefill chunk, or a lone decode
        row) become segments of up to ``q_tile`` rows; each sequence's
        block table is built once. Every array goes up in ONE int32 buffer
        (temperatures bit-cast)."""
        tq, maxb = self._tq, self.config.max_blocks_per_seq
        slots = plan.slots
        t = len(slots)
        tokens = np.fromiter((s.token for s in slots), np.int32, t)
        positions = np.fromiter((s.position for s in slots), np.int32, t)
        seg_tables = np.zeros((t, maxb), np.int32)
        seg_pos = np.zeros(t, np.int32)
        seg_rows = np.zeros(t, np.int32)
        seg_row_idx = np.zeros((t, tq), np.int32)
        row_gather = np.zeros(t, np.int32)
        row_seg = np.zeros(t, np.int32)
        tables = {}
        si = i = 0
        while i < t:
            req = slots[i].request
            j = i
            while (j + 1 < t and slots[j + 1].request is req
                   and slots[j + 1].position == slots[j].position + 1
                   and j + 1 - i < tq):
                j += 1
            rid = req.request_id
            if rid not in tables:
                tables[rid] = self.kv.block_table(rid)
            seg_tables[si] = tables[rid]
            seg_pos[si] = slots[i].position
            seg_rows[si] = j - i + 1
            seg_row_idx[si, :j - i + 1] = np.arange(i, j + 1)
            row_gather[i:j + 1] = si * tq + np.arange(j - i + 1)
            row_seg[i:j + 1] = si
            si += 1
            i = j + 1
        samplers = [slots[k] for k in rows]
        n_s = len(rows)
        sample_rows = np.asarray(rows, np.int32)
        top_ks = np.fromiter((s.request.sampling.top_k for s in samplers),
                             np.int32, n_s)
        seeds = np.fromiter((s.request.sampling.seed for s in samplers),
                            np.int32, n_s)
        gen_idx = np.fromiter((s.gen_idx for s in samplers), np.int32, n_s)
        temps = np.fromiter((s.request.sampling.temperature
                             for s in samplers), np.float32, n_s)
        parts = [tokens, positions, seg_tables[:si], seg_pos[:si],
                 seg_rows[:si], seg_row_idx[:si], row_gather, row_seg,
                 sample_rows, top_ks, seeds, gen_idx, temps.view(np.int32)]
        buf = torch.from_numpy(np.concatenate([p.ravel() for p in parts]))
        flat = buf.to(self.device).split([p.size for p in parts])
        views = [f.view(p.shape) for f, p in zip(flat, parts)]
        views[-1] = views[-1].view(torch.float32)
        return _StepBatch(*views)

    def run(self, max_idle_iters: int = 100) -> None:
        """Drive steps until every submitted request finished. A bounded
        run of no-progress iterations (the pool cannot hold the oldest
        request's working set) raises instead of spinning."""
        idle = 0
        while self.scheduler.has_work:
            if self.step():
                idle = 0
            else:
                idle += 1
                if idle > max_idle_iters:
                    raise RuntimeError(
                        "serving made no progress for "
                        f"{max_idle_iters} iterations: KV pool "
                        f"({self.kv.num_blocks} blocks of "
                        f"{self.config.block_size}) cannot hold the "
                        "oldest request's working set")

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingParams] = None
                 ) -> List[List[int]]:
        """Synchronous batch API: submit every prompt, run to completion,
        return the generated tokens in submission order."""
        reqs = [self.submit(p, sampling) for p in prompts]
        self.run()
        return [r.output_tokens for r in reqs]

    # ------------------------------------------------- background serving
    def start(self) -> None:
        """Run the engine loop on a background thread (submit from any
        thread; ``req.result()`` to collect). Idempotent."""
        self._intake_open = True
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_event.clear()
        self._loop_error = None
        self._thread = threading.Thread(
            target=self._serve_loop, name="paddle-serving-engine",
            daemon=True)
        self._thread.start()

    def _serve_loop(self) -> None:
        while not self._stop_event.is_set():
            try:
                if not self.step():
                    self._stop_event.wait(0.001)  # idle: wait for arrivals
            except Exception as e:
                # fail every pending request (waking its waiters) and refuse
                # new submits: a dead loop must not strand callers
                self._loop_error = e
                self.scheduler.abort_all(e)
                warnings.warn(
                    f"serving engine loop died: {type(e).__name__}: {e}",
                    stacklevel=2)
                return

    def _stop_loop(self, timeout: float) -> bool:
        """Signal and join the background loop. False when the thread is
        still alive after ``timeout`` (wedged mid-step)."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                warnings.warn(
                    f"serving engine loop still running after {timeout}s "
                    "(mid-step?); call stop() again to re-join",
                    stacklevel=2)
                return False
            self._thread = None
        return True

    def _evict_leftovers(self) -> List[Request]:
        """Take every remaining request out of the scheduler exactly once,
        serialized against an in-flight step. A wedged step (lock held
        past the timeout) forfeits eviction."""
        if not self.scheduler.has_work:
            return []
        if not self._step_lock.acquire(timeout=5.0):
            warnings.warn("engine step wedged: cannot evict in-flight "
                          "requests", stacklevel=2)
            return []
        try:
            return self.scheduler.evict_all()
        finally:
            self._step_lock.release()

    def drain(self, timeout: Optional[float] = None) -> List[Request]:
        """Finish-or-requeue with a deadline: close intake, stop the
        background loop after its current step, keep stepping inline until
        every request finished or ``timeout`` elapsed, then evict what is
        left. Returns the evicted requests (state WAITING, generated tokens
        intact)."""
        with self._intake_lock:
            self._intake_open = False
        deadline = None if timeout is None else time.monotonic() + timeout
        join = 10.0 if deadline is None else \
            max(0.1, min(10.0, deadline - time.monotonic()))
        wedged = not self._stop_loop(join)
        idle = 0
        while not wedged and self.scheduler.has_work \
                and self._loop_error is None:
            if deadline is not None and time.monotonic() >= deadline:
                break
            try:
                progressed = self.step()
            except Exception as e:
                self._loop_error = e
                self.scheduler.abort_all(e)
                warnings.warn(
                    f"engine step failed during drain: "
                    f"{type(e).__name__}: {e}", stacklevel=2)
                break
            if progressed:
                idle = 0
            else:
                idle += 1
                if idle > 100:
                    break  # the pool cannot serve the rest: evict it
        return self._evict_leftovers()

    def stop(self, timeout: float = 10.0,
             drain: bool = True) -> List[Request]:
        """Stop the engine. With ``drain`` (the default) in-flight requests
        finish within ``timeout`` and the rest are evicted and returned;
        ``drain=False`` stops the loop after its current step and evicts
        everything at once."""
        if drain:
            return self.drain(timeout)
        with self._intake_lock:
            self._intake_open = False
        self._stop_loop(timeout)
        return self._evict_leftovers()
