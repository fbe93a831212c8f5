"""Weights between the JAX package's GPT and the port's.

The port keeps the JAX model's parameter names and layouts, so the
conversion is a copy: every name of ``named_parameters()`` of
``paddle_tpu.text.models.GPTForCausalLM`` is a key of the port's
``state_dict()``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ...core.device import resolve_device

__all__ = ["gpt_params_from_jax"]


def gpt_params_from_jax(named_params: Mapping[str, np.ndarray],
                        device=None) -> Dict[str, torch.Tensor]:
    """A state dict for :class:`GPTForCausalLM` from the JAX model's
    ``{name: array}`` (numpy arrays or anything ``np.asarray`` takes),
    as fp32 tensors on ``device`` — CUDA unless the caller names another;
    raises without a card. Load it with ``model.load_state_dict(...)``."""
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.asarray(value, dtype=np.float32),
                                  device=dev)
            for name, value in named_params.items()}
