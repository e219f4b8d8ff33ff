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
the head's output is fp32. With ``moe_experts`` every block's FFN is a
top-1 MoE (:mod:`.moe`, JAX ``:86-90``).

A mesh's ranks share one card (:mod:`geomx_tpu_torch.parallel.mesh`):
``transformer_param_sharding`` records the Megatron layout rules of the
JAX package (``:131-157``) and the model computes the unsplit function.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def make_attention(impl: str = "auto", *, causal: bool = True, mesh=None,
                   block_q: int = 128, block_k: int = 128) -> Callable:
    """Attention implementation selector for ``Transformer(attn_fn=...)``
    (JAX ``models/transformer.py:20-52``).

    ``"flash"`` — FlashAttention-2 (geomx_tpu_torch.ops.flash_attention):
    the CUDA kernels for CUDA tensors, their plain versions for CPU
    tensors. ``"dense"`` — the einsum reference. ``"auto"`` picks flash
    for CUDA tensors and dense elsewhere, as the JAX package picks flash
    on the accelerator only.

    With a ``mesh`` of more than one rank the flash path is
    :func:`~geomx_tpu_torch.ops.flash_attention.make_sharded_flash_attention`
    over it (attention is independent per batch and head, so the kernels
    take the whole batch at once); a sequence-sharded mesh ("sp" > 1)
    needs ring attention and is rejected, by ``"flash"`` at once and by
    ``"auto"`` when it first meets a CUDA tensor.
    """
    if impl not in ("auto", "flash", "dense"):
        raise ValueError(f"unknown attention impl {impl!r}")
    from geomx_tpu_torch.ops.flash_attention import (
        flash_attention, make_sharded_flash_attention)

    def dense(q, k, v):
        return dense_attention(q, k, v, causal=causal)

    if impl == "dense":
        return dense
    if mesh is not None and mesh.size > 1:
        if impl == "flash" or mesh.shape.get("sp", 1) == 1:
            flash = make_sharded_flash_attention(
                mesh, causal=causal, block_q=block_q, block_k=block_k)
        else:   # "auto": the rejection waits for a CUDA tensor
            def flash(q, k, v):
                return make_sharded_flash_attention(mesh, causal=causal)(
                    q, k, v)
    else:
        def flash(q, k, v):
            return flash_attention(q, k, v, causal=causal, block_q=block_q,
                                   block_k=block_k)
    if impl == "flash":
        return flash

    def auto(q, k, v):
        return (flash if q.is_cuda else dense)(q, k, v)

    return auto


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
    """Attention and FFN (or MoE) with residuals. ``forward(x)`` returns
    ``(x, aux)``: the MoE block's auxiliary loss, None without one."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 attn_fn: Optional[Callable] = None, moe_experts: int = 0,
                 compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt, g = compute_dtype, generator
        self.dim, self.heads = dim, heads
        self.attn_fn = attn_fn
        self.ln1 = LayerNorm(dim, dt)
        self.qkv = Dense(dim, 3 * dim, dt, g)
        self.proj = Dense(dim, dim, dt, g)
        if moe_experts:
            from geomx_tpu_torch.models.moe import MoEBlock

            self.moe = MoEBlock(dim, num_experts=moe_experts,
                                mlp_ratio=mlp_ratio, compute_dtype=dt,
                                generator=g)
        else:
            self.moe = None
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
        if self.moe is not None:
            return self.moe(x)
        h = F.gelu(self.up(self.ln2(x)), approximate="tanh")
        return x + self.down(h), None


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

    def forward(self, tokens, return_aux: bool = False):
        """fp32 logits; with ``return_aux`` also the list of the MoE
        blocks' auxiliary losses, in block order (flax's "losses"
        collection)."""
        x = self.embed(tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = x + self.pos(pos)
        aux = []
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                x, a = torch.utils.checkpoint.checkpoint(block, x,
                                                         use_reentrant=False)
            else:
                x, a = block(x)
            if a is not None:
                aux.append(a)
        logits = self.head(self.lnf(x)).to(torch.float32)
        return (logits, aux) if return_aux else logits


def transformer_param_sharding(mesh):
    """Megatron-style layout rules by parameter path suffix (plus expert
    layouts over "ep" for MoE blocks when the mesh has that axis), JAX
    ``:131-157``. ``shard(params)`` maps each parameter of a module (or
    a name -> tensor dict) to its spec, a tuple as ``PartitionSpec``
    reads, under flax's '/'-joined path, and raises where a split axis
    does not divide, as ``device_put`` does. The ranks share one card,
    so the rules are recorded, not applied."""
    has_ep = "ep" in mesh.axis_names

    def spec_for(path: str, ndim: int = 2):
        from geomx_tpu_torch.models.moe import expert_spec, is_expert_param

        if has_ep and is_expert_param(path):
            return expert_spec(ndim)
        if path.endswith("qkv/kernel") or path.endswith("up/kernel"):
            return (None, "tp")
        if path.endswith("qkv/bias") or path.endswith("up/bias"):
            return ("tp",)
        if path.endswith("proj/kernel") or path.endswith("down/kernel"):
            return ("tp", None)
        return ()  # embeddings, norms, head, remaining biases: replicated

    def shard(params):
        from geomx_tpu_torch.parallel.mesh import param_layouts

        return param_layouts(mesh, params, spec_for)

    return shard
