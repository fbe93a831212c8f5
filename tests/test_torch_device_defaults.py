"""The port's layers and random state default to the CUDA card.

``nn.Linear``, ``nn.Embedding``, ``nn.LayerNorm``, ``core.random.generator``
and ``core.random.next_seed`` resolve ``device=None`` to the current card,
as every entry point of the port does, and raise where there is none
rather than carry on quietly on the CPU. Given ``device="cpu"`` they work
as before, and a layer draws the same initial values from a fixed seed.
"""
import math

import pytest
import torch

from paddle_tpu_torch.core import random as rng
from paddle_tpu_torch.nn.layer.common import Embedding, Linear
from paddle_tpu_torch.nn.layer.norm import LayerNorm

pytestmark = pytest.mark.torch_port

DEFAULTS = {
    "Linear": lambda **kw: Linear(4, 3, **kw),
    "Embedding": lambda **kw: Embedding(5, 2, **kw),
    "LayerNorm": lambda **kw: LayerNorm(6, **kw),
    "generator": lambda **kw: rng.generator(**kw),
    "next_seed": lambda **kw: rng.next_seed(**kw),
}


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_default_device_is_the_card(name, monkeypatch):
    """``device=None`` means the card: without one the call raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng.seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULTS[name](device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULTS[name]()


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_cpu_when_asked(name):
    rng.seed(0)
    made = DEFAULTS[name](device="cpu")
    if isinstance(made, torch.nn.Module):
        assert all(p.device.type == "cpu" for p in made.parameters())
    elif isinstance(made, torch.Generator):
        assert made.device.type == "cpu"
    else:
        assert isinstance(made, int) and 0 <= made < 2 ** 31 - 1


def test_cpu_layers_draw_the_same_numbers_from_a_seed():
    """A layer built on the CPU draws from the CPU generator seeded with
    the global seed, exactly as before the default moved to the card."""
    rng.seed(7)
    lin = Linear(8, 5, device="cpu")
    emb = Embedding(11, 4, device="cpu")
    g = torch.Generator().manual_seed(7)
    limit = math.sqrt(6.0 / (8 + 5))
    want_lin = torch.empty(8, 5).uniform_(-limit, limit, generator=g)
    want_emb = torch.empty(11, 4).normal_(0.0, math.sqrt(2.0 / 15),
                                          generator=g)
    assert torch.equal(lin.weight.detach(), want_lin)
    assert torch.equal(lin.bias.detach(), torch.zeros(5))
    assert torch.equal(emb.weight.detach(), want_emb)
    ln = LayerNorm(6, device="cpu")
    assert torch.equal(ln.weight.detach(), torch.ones(6))
    assert torch.equal(ln.bias.detach(), torch.zeros(6))
    rng.seed(7)
    assert rng.next_seed("cpu") == int(torch.randint(
        0, 2 ** 31 - 1, (1,), generator=torch.Generator().manual_seed(7)))
