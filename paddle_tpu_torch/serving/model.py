"""The serving model: a GPT-style decoder forward over the paged KV cache.

One forward (:meth:`GPTServingModel.token_step`) covers both serving
phases, because the unit is a *token row*, not a request: each row carries
(token id, cache position), writes its K/V into the paged pool at its
position, and attends through its sequence's block table over positions
``<= position``. A decode batch is rows from different sequences; a
prefill chunk is consecutive rows sharing one block table; a mixed step is
any combination. Every row's math is row-independent, so a token's hidden
state does not depend on what else shares the batch.

Rows are grouped into *segments* (consecutive rows of one sequence) so the
attention kernel reads each KV block once per segment
(``ops.ragged_paged_attention_chunked``).

The architecture mirrors ``paddle_tpu.serving.model`` (pre-LN attention +
pre-LN FFN with residuals, rotate-half RoPE, tanh-approximate GELU), and
the fused-weights layout of ``examples/serve_gpt_kv_cache.py`` loads
through :meth:`GPTServingModel.from_fused_weights`. Unlike the JAX model,
which returns new pools from a pure function, ``token_step`` updates the
pools in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops.ragged_paged_attention import ragged_paged_attention_chunked

__all__ = ["GPTServingModel", "make_rope_tables"]

_LAYER_KEYS = ("ln_scale", "ln_bias", "qkv_w", "qkv_b", "out_w", "out_b",
               "ffn_ln_scale", "ffn_ln_bias", "ffn1_w", "ffn1_b", "ffn2_w",
               "ffn2_b")


def make_rope_tables(max_position: int, head_dim: int,
                     theta: float = 10000.0, device=None):
    """Rotate-half RoPE tables ``(cos, sin)``, each
    ``[max_position, head_dim // 2]`` float32 (computed in float64 on the
    host, as the JAX model does)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(half) * 2.0 / head_dim))
    ang = np.arange(max_position)[:, None] * inv[None, :]
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def _rope(x, cos, sin):
    """Rotate-half on ``x [T, H, D]`` with per-row tables ``[T, D//2]``:
    ``out_l = l*cos - r*sin``, ``out_r = r*cos + l*sin``. The result stays
    float32, as the reference's does (its fp32 tables promote it); k is
    cast to the pool's dtype where it is written, q where it enters the
    attention kernel."""
    half = x.shape[-1] // 2
    c = cos[:, None, :]
    s = sin[:, None, :]
    xf = x.float()
    l, r = xf[..., :half], xf[..., half:]
    return torch.cat([l * c - r * s, r * c + l * s], dim=-1)


def _layer_norm(x, scale, bias, eps: float):
    """LayerNorm written out as the reference writes it: mean, variance
    and the normalisation in the activation dtype (bf16 when serving in
    bf16), each op rounding to it."""
    xm = x - x.mean(dim=-1, keepdim=True)
    y = xm * torch.rsqrt(xm.square().mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


class _DecoderLayer(nn.Module):
    """One pre-LN block's weights (buffers; ``None`` for absent biases)."""

    def __init__(self, weights: Dict[str, Any], convert):
        super().__init__()
        for key in _LAYER_KEYS:
            self.register_buffer(key, convert(weights.get(key)))


class GPTServingModel(nn.Module):
    """GPT decoder for serving. Per-layer weights: ``ln_scale``,
    ``ln_bias``, ``qkv_w [3, H, D, E]``, ``qkv_b [3, H, D] | None``,
    ``out_w [E, E]``, ``out_b [E] | None``, ``ffn_ln_scale``,
    ``ffn_ln_bias``, ``ffn1_w [E, F]``, ``ffn1_b | None``,
    ``ffn2_w [F, E]``, ``ffn2_b | None`` (the layout of
    ``paddle_tpu.serving.GPTServingModel``). Weights may be numpy arrays
    or tensors; they are moved to ``device`` (CUDA unless the caller names
    another) and, when ``dtype`` is given, cast to it."""

    def __init__(self, embedding, head, layers: Sequence[Dict[str, Any]],
                 n_heads: int, head_dim: int, use_rope: bool = True,
                 rope_theta: float = 10000.0, max_position: int = 2048,
                 epsilon: float = 1e-5, activation: str = "gelu",
                 final_ln_scale=None, final_ln_bias=None, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if activation not in ("gelu", "relu"):
            raise ValueError(f"activation must be gelu|relu, got {activation}")
        if use_rope and head_dim % 2:
            raise ValueError("RoPE needs an even head_dim")
        self.device = resolve_device(device)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.embed_dim = self.n_heads * self.head_dim
        self.n_layers = len(layers)
        self.use_rope = bool(use_rope)
        self.rope_theta = float(rope_theta)
        self.max_position = int(max_position)
        self.epsilon = float(epsilon)
        self.activation = activation

        def convert(x):
            if x is None:
                return None
            t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                else x)
            return t.to(device=self.device,
                        dtype=dtype if dtype is not None else t.dtype)

        self.register_buffer("embedding", convert(embedding))
        self.register_buffer("head", convert(head))
        self.register_buffer("final_ln_scale", convert(final_ln_scale))
        self.register_buffer("final_ln_bias", convert(final_ln_bias))
        self.layers = nn.ModuleList(_DecoderLayer(w, convert) for w in layers)
        self.vocab_size = int(self.embedding.shape[0])
        cos, sin = (make_rope_tables(self.max_position, self.head_dim,
                                     self.rope_theta, self.device)
                    if self.use_rope else (None, None))
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)

    @classmethod
    def from_fused_weights(cls, weights: Dict[str, Any], embedding, head,
                           n_heads: int, head_dim: int, **kwargs
                           ) -> "GPTServingModel":
        """Adapt a ``fused_multi_transformer`` weights dict (the layout of
        ``examples/serve_gpt_kv_cache.py``) into per-layer dicts."""
        def at(name, i):
            seq = weights.get(name)
            return None if seq is None else seq[i]

        n_layers = len(weights["qkv_weights"])
        layers = [{
            "ln_scale": at("ln_scales", i), "ln_bias": at("ln_biases", i),
            "qkv_w": at("qkv_weights", i), "qkv_b": at("qkv_biases", i),
            "out_w": at("linear_weights", i),
            "out_b": at("linear_biases", i),
            "ffn_ln_scale": at("ffn_ln_scales", i),
            "ffn_ln_bias": at("ffn_ln_biases", i),
            "ffn1_w": at("ffn1_weights", i), "ffn1_b": at("ffn1_biases", i),
            "ffn2_w": at("ffn2_weights", i), "ffn2_b": at("ffn2_biases", i),
        } for i in range(n_layers)]
        return cls(embedding, head, layers, n_heads=n_heads,
                   head_dim=head_dim, **kwargs)

    @torch.no_grad()
    def token_step(self, k_pools: List[torch.Tensor],
                   v_pools: List[torch.Tensor], tokens, positions,
                   seg_tables, seg_pos, seg_rows, seg_row_idx, row_gather,
                   row_seg, n_active: Optional[int] = None,
                   attn_impl: str = "auto", logit_rows=None):
        """One serving step over ``T`` token rows (see module doc).

        ``k_pools``/``v_pools``: per-layer ``[N, B, H, D]`` pools, updated
        in place. ``tokens``/``positions`` ``[T]`` int32. Segment metadata
        as in :func:`~paddle_tpu_torch.ops.ragged_paged_attention_chunked`;
        ``row_seg [T]`` is each row's segment. The first ``n_active`` rows
        are live (all when None) and only they write K/V: the rest are pad
        rows. ``logit_rows`` (optional ``[R]`` row indices) restricts the
        LM head to those rows. Returns fp32 logits ``[T or R, V]``."""
        n_live = tokens.shape[0] if n_active is None else int(n_active)
        eps = self.epsilon
        n_heads, head_dim, embed = self.n_heads, self.head_dim, self.embed_dim
        block_size = k_pools[0].shape[1]
        pool_rows = k_pools[0].shape[0] * block_size
        act = (lambda x: F.gelu(x, approximate="tanh")) \
            if self.activation == "gelu" else F.relu

        h = F.embedding(tokens, self.embedding)             # [T, E]
        if self.use_rope:
            cos = self.rope_cos[positions]                  # [T, D/2]
            sin = self.rope_sin[positions]
        # each live row's write target: table[pos // B] * B + pos % B
        # through its segment's table row; pad rows write nothing
        live_pos = positions[:n_live].long()
        row_tables = seg_tables[row_seg[:n_live].long()]    # [n, MAXB]
        block_of = row_tables.gather(
            1, (live_pos // block_size)[:, None])[:, 0].long()
        write_idx = block_of * block_size + live_pos % block_size

        for layer, kp, vp in zip(self.layers, k_pools, v_pools):
            x = _layer_norm(h, layer.ln_scale, layer.ln_bias, eps)
            qkv_b = None if layer.qkv_b is None \
                else layer.qkv_b.reshape(3 * embed)
            qkv = F.linear(x, layer.qkv_w.reshape(3 * embed, embed), qkv_b)
            qkv = qkv.view(-1, 3, n_heads, head_dim)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]       # [T, H, D]
            if self.use_rope:
                q, k = _rope(q, cos, sin), _rope(k, cos, sin)
            kp.view(pool_rows, n_heads, head_dim).index_copy_(
                0, write_idx, k[:n_live].to(kp.dtype))
            vp.view(pool_rows, n_heads, head_dim).index_copy_(
                0, write_idx, v[:n_live].to(vp.dtype))
            # the kernel takes q in the pools' dtype; the reference hands
            # its fp32 q to attention as it is
            attn = ragged_paged_attention_chunked(
                q.to(kp.dtype).contiguous(), kp, vp, seg_tables, seg_pos,
                seg_rows, seg_row_idx, row_gather,
                scale=1.0 / (head_dim ** 0.5), impl=attn_impl)
            attn = attn.reshape(-1, embed).to(h.dtype) @ layer.out_w
            if layer.out_b is not None:
                attn = attn + layer.out_b
            h = h + attn
            x2 = _layer_norm(h, layer.ffn_ln_scale, layer.ffn_ln_bias, eps)
            ffn_in = x2 @ layer.ffn1_w                       # [T, F]
            if layer.ffn1_b is not None:
                ffn_in = ffn_in + layer.ffn1_b
            ffn = act(ffn_in) @ layer.ffn2_w
            if layer.ffn2_b is not None:
                ffn = ffn + layer.ffn2_b
            h = h + ffn
        if logit_rows is not None:
            h = h.index_select(0, logit_rows)
        if self.final_ln_scale is not None or self.final_ln_bias is not None:
            h = _layer_norm(h, self.final_ln_scale, self.final_ln_bias, eps)
        return (h @ self.head).float()                       # [T|R, V]
