"""The train step (``paddle_tpu.jit.TrainStepper``).

``TrainStepper(layer, loss_fn, optimizer, amp_level).step(inputs,
labels)`` runs forward, loss, backward and the optimizer update, and
returns ``(loss, outputs)``, as the reference's does. The reference traces
all of it into one XLA program; the port runs it eagerly, the attention
forward and backward through the hand-written kernels.

``amp_level`` is None or "O2" (O1 is not ported and raises). As in the
reference, ``amp_level="O2"`` runs the *forward* under the AMP
rule (``paddle_tpu_torch.amp``, bf16) with fp32 master parameters, and
``loss_fn`` runs after it, outside the AMP scope, on the forward's
outputs as they come (bf16 logits under O2); the loss is returned as
fp32.

Not ported (a stepper given them raises): gradient merge, quantized
gradient collectives (``comm_quant``), the non-finite guard, ``remat``,
and the compile cache (there is no compiled program to cache).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import amp

__all__ = ["TrainStepper"]

def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


class TrainStepper:
    def __init__(self, layer: torch.nn.Module, loss_fn: Callable, optimizer,
                 amp_level: Optional[str] = None, nonfinite_guard=None,
                 remat: bool = False, comm_quant=None):
        left_out = [name for name, on in (
            ("nonfinite_guard", nonfinite_guard is not None),
            ("remat", remat), ("comm_quant", comm_quant is not None),
            ("gradient merge",
             int(getattr(optimizer, "_gradient_merge_k", 1) or 1) > 1))
            if on]
        if left_out:
            raise NotImplementedError(
                f"TrainStepper options not ported to paddle_tpu_torch: "
                f"{', '.join(left_out)}")
        if amp_level == "O1":
            raise NotImplementedError("amp_level O1 is not ported to "
                                      "paddle_tpu_torch")
        if amp_level not in (None, "O2"):
            raise ValueError(f"amp_level must be None or O2, got "
                             f"{amp_level!r}")
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        optimizer.set_param_names(layer.named_parameters())

    def step(self, inputs, labels):
        """One train step; updates the layer's parameters and the
        optimizer state in place. Returns ``(loss, outputs)``, the loss a
        fp32 scalar, both detached."""
        self.layer.train()
        self.optimizer.clear_grad()
        with amp.auto_cast(self.amp_level, torch.bfloat16):
            out = self.layer(*_as_tuple(inputs))
        loss = self.loss_fn(out, labels).float()
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach(), out.detach()

    def run_steps(self, inputs, labels, n_steps: Optional[int] = None):
        """``n_steps`` steps over inputs and labels whose tensors carry a
        leading ``[n_steps]`` axis, one slice per step (a Python loop; the
        reference scans one compiled program). Returns the ``[n_steps]``
        losses."""
        ins, labs = _as_tuple(inputs), _as_tuple(labels)
        if n_steps is None:
            n_steps = int(ins[0].shape[0])
        return torch.stack([
            self.step(tuple(x[i] for x in ins),
                      tuple(y[i] for y in labs))[0]
            for i in range(n_steps)])
