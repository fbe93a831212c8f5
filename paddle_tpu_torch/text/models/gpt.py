"""GPT decoder-only language model (``paddle_tpu.text.models.gpt``).

Pre-LN blocks (LayerNorm -> attention -> residual add, LayerNorm -> MLP
with exact GELU -> residual add), learned position embeddings, a final
LayerNorm and an LM head tied to the token embedding (``h @ wte^T``).
Parameter names and layouts are the JAX model's (``gpt.wte.weight``,
``gpt.block_0.attn.qkv.weight`` ``[E, 3E]``, ...), so
:func:`~paddle_tpu_torch.text.models.convert.gpt_params_from_jax` loads
its ``named_parameters()`` as they are. Attention goes through
``nn.functional.scaled_dot_product_attention``: flash attention (the
hand-written kernels on the card) at ``S >= 256``, the plain composition
below that.

Tensor parallel, sequence parallel, mixture-of-experts and recompute are
not ported: a model given them raises.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device
from ...nn import functional as F
from ...nn.layer import Dropout, Embedding, LayerNorm, Linear
from ... import amp

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt2_small", "gpt2_medium", "gpt3_1p3b"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_position_embeddings=1024,
                 intermediate_size=None, dropout=0.0,
                 layer_norm_epsilon=1e-5, tensor_parallel=False,
                 sequence_parallel=False, use_recompute=False,
                 num_experts=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_position_embeddings = max_position_embeddings
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.use_recompute = use_recompute
        self.num_experts = num_experts

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _check_ported(cfg: GPTConfig) -> None:
    left_out = [name for name, on in (
        ("tensor_parallel", cfg.tensor_parallel),
        ("sequence_parallel", cfg.sequence_parallel),
        ("use_recompute", cfg.use_recompute),
        ("num_experts > 1", cfg.num_experts > 1)) if on]
    if left_out:
        raise NotImplementedError(
            f"GPT options not ported to paddle_tpu_torch: "
            f"{', '.join(left_out)}")


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = d // cfg.num_heads
        self.qkv = Linear(d, 3 * d, device=device)
        self.proj = Linear(d, d, device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        b, s, e = x.shape
        q, k, v = self.qkv(x).split(e, dim=-1)  # q: the first E columns
        shape = (b, s, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            q.reshape(shape), k.reshape(shape), v.reshape(shape),
            is_causal=True, training=self.training)
        return self.dropout(self.proj(out.reshape(b, s, e)))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size,
                          device=device)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size,
                          device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x))))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=eps, device=device)
        self.attn = GPTAttention(cfg, device=device)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=eps, device=device)
        self.mlp = GPTMLP(cfg, device=device)

    def forward(self, x):
        x = F.add(x, self.attn(self.ln1(x)))
        return F.add(x, self.mlp(self.ln2(x)))


class GPTModel(nn.Module):
    """Backbone: token + position embeddings -> N pre-LN blocks -> final
    LayerNorm."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        _check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             device=device)
        self.drop = Dropout(cfg.dropout)
        self.blocks = []
        for i in range(cfg.num_layers):
            blk = GPTBlock(cfg, device=device)
            self.add_module(f"block_{i}", blk)  # the reference's names
            self.blocks.append(blk)
        self.ln_f = LayerNorm(cfg.hidden_size,
                              epsilon=cfg.layer_norm_epsilon, device=device)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.drop(F.add(self.wte(input_ids), self.wpe(pos)))
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """LM head tied to the token embedding. Built on ``device`` (CUDA
    unless the caller names another; raises without a card)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=device)

    def forward(self, input_ids):
        h = self.gpt(input_ids)
        h, w = amp.cast("matmul", h, self.gpt.wte.weight)
        return torch.matmul(h, w.t())

    def loss(self, logits, labels):
        v = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1))


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128, **kw)


def gpt2_small(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_position_embeddings=1024, **kw)


def gpt2_medium(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                     num_heads=16, max_position_embeddings=1024, **kw)


def gpt3_1p3b(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_position_embeddings=2048, **kw)
