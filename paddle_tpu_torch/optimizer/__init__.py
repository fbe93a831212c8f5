"""Optimizers (``paddle_tpu.optimizer``): Adam and AdamW.

The update rule is the reference's (``optimizer/__init__.py`` ``Adam``,
``AdamW`` and ``apply_gradients_functional``): moments are read as fp32,
updated in fp32 and stored in ``moment_dtype`` (fp32 by default; bf16
halves their memory), bias-corrected with ``1 - beta ** step``, and the
parameter moves by ``lr * m_hat / (sqrt(v_hat) + eps)``. AdamW first
decays every parameter by ``p *= 1 - lr * weight_decay`` (decoupled), or
only those ``apply_decay_param_fun(name)`` accepts. Updates are in place
under ``torch.no_grad()``: the JAX package returns new arrays, the port
overwrites the parameters and moments where they lie.

The learning rate is a constant (``lr.py``'s schedulers are not ported),
and gradient clipping is not ported: an optimizer given a ``grad_clip``
raises.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    """Base: the parameters, the constant learning rate and per-parameter
    state (``_state[id(p)]``)."""

    def __init__(self, learning_rate: float = 0.001,
                 parameters: Optional[Iterable[torch.nn.Parameter]] = None,
                 weight_decay: Optional[float] = None, grad_clip=None,
                 moment_dtype=None):
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported to paddle_tpu_torch")
        if parameters is None:
            raise ValueError("pass parameters=model.parameters()")
        self._lr = float(learning_rate)
        self._parameters: List[torch.nn.Parameter] = list(parameters)
        self._weight_decay = weight_decay
        self._moment_dtype = (torch.float32 if moment_dtype is None
                              else _as_dtype(moment_dtype))
        self._state: Dict[int, List[torch.Tensor]] = {}
        self._step_count = 0
        self._names: Dict[int, str] = {}

    def set_param_names(self, named: Iterable[Tuple[str, torch.Tensor]]):
        """Names for ``apply_decay_param_fun`` (the trainer passes the
        model's ``named_parameters()``)."""
        self._names = {id(p): n for n, p in named}

    def clear_grad(self) -> None:
        for p in self._parameters:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient."""
        self._step_count += 1
        lr = self._lr
        for p in self._parameters:
            if p.grad is None:
                continue
            state = self._state.get(id(p))
            if state is None:
                state = self._state[id(p)] = [
                    torch.zeros_like(p, dtype=self._moment_dtype)
                    for _ in range(2)]
            self._update(p, p.grad.to(p.dtype), state, lr,
                         self._step_count, self._names.get(id(p)))

    def _update(self, p, g, state, lr, step, name):
        raise NotImplementedError


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(dtype)]


class Adam(Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: Optional[float] = None,
                 grad_clip=None, moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         moment_dtype)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _decay(self, p, g, lr, name):
        """Coupled L2 for Adam: ``g + wd * p``."""
        if self._weight_decay:
            return g + float(self._weight_decay) * p
        return g

    def _update(self, p, g, state, lr, step, name):
        g = self._decay(p, g, lr, name)
        m, v = state
        b1, b2 = self._beta1, self._beta2
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32.square()
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self._epsilon)
        p.sub_(lr * update.to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01) on every parameter,
    or on those ``apply_decay_param_fun(name)`` accepts."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: float = 0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]]
                 = None, grad_clip=None, moment_dtype=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay(self, p, g, lr, name):
        wd = float(self._weight_decay or 0.0)
        decay = True
        if self._apply_decay_param_fun is not None and name is not None:
            decay = self._apply_decay_param_fun(name)
        if decay and wd:
            p.mul_(1 - lr * wd)
        return g
