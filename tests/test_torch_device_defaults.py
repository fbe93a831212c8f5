"""The port's layers and random state default to the CUDA card.

``nn.Linear``, ``nn.Embedding``, ``nn.LayerNorm``, ``core.random.generator``
and ``core.random.next_seed`` resolve ``device=None`` to the current card,
as every entry point of the port does, and raise where there is none
rather than carry on quietly on the CPU. Given ``device="cpu"`` they work
as before, and a layer draws the same initial values from a fixed seed.
Dropout seeds are drawn on the host from a generator of their own per
device: reproducible from ``seed(s)``, and no card is touched to draw one.
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


# ------------------------------------------------ dropout seeds (host side)

@pytest.mark.parametrize("s", [0, 7, 2 ** 31 - 5])
def test_dropout_seed_stream_is_reproducible(s):
    """The same ``seed(s)`` gives the same dropout seeds, for every device:
    the stream of ``torch.Generator().manual_seed(s)`` on the host."""
    def draw(device, n=5):
        return [rng.next_seed(device) for _ in range(n)]

    rng.seed(s)
    first = {dev: draw(dev) for dev in ("cuda:0", "cpu")}
    rng.seed(s)
    again = {dev: draw(dev) for dev in ("cpu", "cuda:0")}
    g = torch.Generator().manual_seed(s)
    want = [int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g))
            for _ in range(5)]
    assert first == again == {"cuda:0": want, "cpu": want}
    rng.seed(s + 1)
    assert draw("cuda:0") != want


def test_dropout_seed_for_a_card_reads_nothing_from_it(monkeypatch):
    """``next_seed("cuda:0")`` works on a machine without a card: the seed
    is drawn on the host, so no tensor is made on the card and nothing is
    read back from it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng.seed(3)
    seeds = [rng.next_seed("cuda:0"), rng.next_seed(torch.device("cuda", 0))]
    assert all(isinstance(x, int) and 0 <= x < 2 ** 31 - 1 for x in seeds)
    assert seeds[0] != seeds[1]


def test_dropout_seeds_do_not_move_with_parameter_draws():
    """Initialising layers between two steps leaves the dropout seeds
    where they were: the two draw from separate generators."""
    rng.seed(11)
    plain = [rng.next_seed("cpu") for _ in range(3)]
    rng.seed(11)
    mixed = []
    for _ in range(3):
        Linear(16, 16, device="cpu")
        mixed.append(rng.next_seed("cpu"))
    assert mixed == plain
