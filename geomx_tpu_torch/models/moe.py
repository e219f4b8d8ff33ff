"""Mixture-of-Experts FFN with its expert-parallel ("ep") layout rules.

Counterpart of ``geomx_tpu/models/moe.py`` (``is_expert_param`` /
``expert_spec`` ``:38-48``, ``MoEBlock`` ``:50-103``,
``moe_param_sharding`` ``:106-117``). Expert weights are stacked along a
leading expert dimension (``w_up`` ``[E, D, H]``, ``w_dn`` ``[E, H, D]``)
and their layout rule splits that dimension over "ep". The ranks of a
port mesh share one card (:mod:`geomx_tpu_torch.parallel.mesh`), so the
rule is recorded, not applied: the block computes the unsplit function.

Dense dispatch, the JAX package's documented divergence from
capacity-factor MoE systems: every expert computes every token and the
router mask zeroes the outputs of the experts not chosen. Router: top-1
(Switch-style) in fp32 on the fp32 cast of the normed input, softmax,
argmax (the first maximum, as ``jnp.argmax``), one-hot; the
load-balancing auxiliary loss ``E * sum(frac_tokens * frac_gates)``.
Where flax ``sow``s the aux loss into a "losses" collection, the block
returns it beside its output.

Parameter names and layouts are flax's (``ln``, ``router``, ``w_up``,
``b_up``, ``w_dn``, ``b_dn``), so the flax leaves load unchanged
(:mod:`geomx_tpu_torch.models.convert`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MoEBlock", "moe_param_sharding", "is_expert_param",
           "expert_spec"]

# leaf names of expert-stacked params (leading axis = expert dim)
EXPERT_PARAM_NAMES = ("w_up", "b_up", "w_dn", "b_dn")


def is_expert_param(path: str) -> bool:
    """True when a '/'-joined param path names an expert-stacked leaf
    (the single source of truth for ep-sharding rules)."""
    return path.rsplit("/", 1)[-1] in EXPERT_PARAM_NAMES


def expert_spec(ndim: int) -> Tuple:
    """Layout of an expert-stacked leaf: experts over "ep", everything
    else replicated (a ``PartitionSpec`` as a tuple)."""
    return tuple(["ep"] + [None] * (ndim - 1))


def _stacked_lecun_normal(shape, generator) -> torch.Tensor:
    # flax lecun_normal on [E, in, out]: fan_in = in * E (the leading
    # axis counts as receptive field), truncated normal on [-2, 2] std
    fan_in = shape[0] * shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return w


class MoEBlock(nn.Module):
    """Drop-in FFN block: LayerNorm -> top-1 MoE MLP -> residual.
    ``forward(x)`` returns ``(x + moe(x), aux_loss)``."""

    def __init__(self, dim: int, num_experts: int = 4, mlp_ratio: int = 4,
                 jitter: float = 0.0, compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from geomx_tpu_torch.models.transformer import Dense, LayerNorm

        E, D, H = num_experts, dim, mlp_ratio * dim
        self.num_experts, self.jitter = E, jitter
        self.dtype = compute_dtype
        self.ln = LayerNorm(D, compute_dtype)
        self.router = Dense(D, E, torch.float32, generator)
        self.w_up = nn.Parameter(_stacked_lecun_normal((E, D, H), generator))
        self.b_up = nn.Parameter(torch.zeros(E, H))
        self.w_dn = nn.Parameter(_stacked_lecun_normal((E, H, D), generator))
        self.b_dn = nn.Parameter(torch.zeros(E, D))

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        dt, E = self.dtype, self.num_experts
        h = self.ln(x)
        logits = self.router(h.to(torch.float32))
        if train and self.jitter > 0.0:
            noise = torch.rand(logits.shape, generator=generator,
                               device=logits.device)
            logits = logits * (1.0 - self.jitter + 2.0 * self.jitter * noise)
        gates = torch.softmax(logits, dim=-1)                    # [B, T, E]
        onehot = F.one_hot(gates.argmax(dim=-1), E).to(gates.dtype)
        gate_val = (gates * onehot).sum(-1)                      # [B, T]
        # load-balancing aux loss (Switch Transformer eq. 4-6)
        frac_tokens = onehot.mean(dim=(0, 1))
        frac_gates = gates.mean(dim=(0, 1))
        aux = E * (frac_tokens * frac_gates).sum()
        # dense dispatch: every expert runs every token
        he = torch.einsum("btd,edh->ebth", h, self.w_up.to(dt)) \
            + self.b_up.to(dt)[:, None, None]
        he = F.gelu(he, approximate="tanh")
        ye = torch.einsum("ebth,ehd->ebtd", he, self.w_dn.to(dt)) \
            + self.b_dn.to(dt)[:, None, None]
        mask = (onehot * gate_val[..., None]).to(dt)             # [B, T, E]
        y = torch.einsum("bte,ebtd->btd", mask, ye)
        return x + y.to(x.dtype), aux


def moe_param_sharding(mesh):
    """The layout rule of MoE params: ``shard(params)`` maps each
    parameter of a module (or a name -> tensor dict) to its spec tuple
    under flax's '/'-joined path — experts over "ep", router and norm
    replicated — and raises where the expert count does not divide."""

    def spec_for(path: str, ndim: int):
        return expert_spec(ndim) if is_expert_param(path) else ()

    def shard(params):
        from geomx_tpu_torch.parallel.mesh import param_layouts

        return param_layouts(mesh, params, spec_for)

    return shard
