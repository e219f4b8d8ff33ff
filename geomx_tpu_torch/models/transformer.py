"""Decoder-only transformer with pluggable attention.

Counterpart of ``geomx_tpu/models/transformer.py``. The modules keep the
flax model's parameter names and layouts — Dense kernels are ``[in,
out]`` and apply as ``x @ kernel + bias`` — so the sorted parameter
names of :func:`geomx_tpu_torch.models.convert.leaf_names` give the flax
``tree_flatten`` leaf order, and a trainer's flat vector, kv keys and
BSC indices line up with the JAX package's coordinate for coordinate.

The arithmetic follows flax's: Dense and Embed cast their fp32
parameters to ``compute_dtype``; LayerNorm reduces in fp32 with the fast
variance E[x^2] - E[x]^2 and epsilon 1e-6; the MLP uses the tanh GELU;
the head's output is fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def make_attention(impl: str = "auto", *, causal: bool = True, mesh=None,
                   block_q: int = 128, block_k: int = 128) -> Callable:
    """Attention implementation selector for ``Transformer(attn_fn=...)``.

    ``"flash"`` — FlashAttention-2 (geomx_tpu_torch.ops.flash_attention):
    the CUDA kernels for CUDA tensors, their plain versions for CPU
    tensors. ``"dense"`` — the einsum reference. ``"auto"`` picks flash
    for CUDA tensors and dense elsewhere, as the JAX package picks flash
    on the accelerator only.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sharded attention over a device mesh is not ported yet "
            "(ROADMAP queue A item 9)")
    if impl not in ("auto", "flash", "dense"):
        raise ValueError(f"unknown attention impl {impl!r}")
    from geomx_tpu_torch.ops.flash_attention import flash_attention

    def flash(q, k, v):
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)

    def dense(q, k, v):
        return dense_attention(q, k, v, causal=causal)

    def auto(q, k, v):
        return (flash if q.is_cuda else dense)(q, k, v)

    return {"auto": auto, "flash": flash, "dense": dense}[impl]


def dense_attention(q, k, v, *, causal: bool = True):
    """Plain attention (single-device, Tq == Tk under ``causal``)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
        math.sqrt(d), dtype=torch.float32).to(q.dtype)
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _lecun_normal(shape, generator) -> torch.Tensor:
    # flax lecun_normal: truncated normal on [-2, 2] std, variance 1/fan_in
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return w


class Dense(nn.Module):
    def __init__(self, din: int, dout: int, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(_lecun_normal((din, dout), generator))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x):
        dt = self.dtype
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Embed(nn.Module):
    def __init__(self, num: int, features: int, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        w = torch.empty(num, features)
        w.normal_(0.0, 1.0 / math.sqrt(features), generator=generator)
        self.embedding = nn.Parameter(w)

    def forward(self, ids):
        return F.embedding(ids.long(), self.embedding.to(self.dtype))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 attn_fn: Optional[Callable] = None, moe_experts: int = 0,
                 compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(
                "MoE blocks need models/moe.py, not ported yet "
                "(ROADMAP queue A item 10)")
        dt, g = compute_dtype, generator
        self.dim, self.heads = dim, heads
        self.attn_fn = attn_fn
        self.ln1 = LayerNorm(dim, dt)
        self.qkv = Dense(dim, 3 * dim, dt, g)
        self.proj = Dense(dim, dim, dt, g)
        self.ln2 = LayerNorm(dim, dt)
        self.up = Dense(dim, mlp_ratio * dim, dt, g)
        self.down = Dense(mlp_ratio * dim, dim, dt, g)

    def forward(self, x):
        B, T, _ = x.shape
        h = self.ln1(x)
        q, k, v = self.qkv(h).split(self.dim, dim=-1)
        shp = (B, T, self.heads, self.dim // self.heads)
        attn = self.attn_fn or dense_attention
        o = attn(q.reshape(shp), k.reshape(shp), v.reshape(shp))
        x = x + self.proj(o.reshape(B, T, self.dim))
        h = F.gelu(self.up(self.ln2(x)), approximate="tanh")
        return x + self.down(h)


class Transformer(nn.Module):
    """Token ids ``[B, T]`` -> fp32 logits ``[B, T, vocab]``. Blocks are
    named ``block{i}`` as in flax; ``remat`` recomputes each block's
    activations in the backward pass (``torch.utils.checkpoint``)."""

    def __init__(self, vocab: int = 256, dim: int = 128, depth: int = 2,
                 heads: int = 4, max_len: int = 2048,
                 attn_fn: Optional[Callable] = None, moe_experts: int = 0,
                 remat: bool = False, compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dt = compute_dtype
        self.depth, self.remat = depth, remat
        self.embed = Embed(vocab, dim, dt, generator)
        self.pos = Embed(max_len, dim, dt, generator)
        for i in range(depth):
            self.add_module(f"block{i}", Block(
                dim, heads, attn_fn=attn_fn, moe_experts=moe_experts,
                compute_dtype=dt, generator=generator))
        self.lnf = LayerNorm(dim, dt)
        self.head = Dense(dim, vocab, dt, generator)

    def forward(self, tokens):
        x = self.embed(tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = x + self.pos(pos)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x,
                                                      use_reentrant=False)
            else:
                x = block(x)
        return self.head(self.lnf(x)).to(torch.float32)
