"""Ring attention: sequence/context parallelism over the "sp" mesh axis.

Counterpart of ``geomx_tpu/parallel/ring_attention.py`` (``_block_attn``
``:27``, ``ring_attention`` ``:48``, ``make_ring_attention`` ``:98``).
The sequence is split into ``sp`` blocks, one per rank; keys and values
rotate around the ring while each rank accumulates its queries'
attention with a streaming softmax. The JAX package runs it under
``shard_map`` with ``ppermute`` hops; here the ranks share one card
(:mod:`.mesh`), so the sp blocks are stacked on an axis of their own and
each of the ring's ``sp - 1`` hops is one ``torch.roll`` along it: rank
r receives rank r-1's block, as ``ppermute`` with ``(j, j+1)`` pairs
gives it. Batch ("dp") and heads ("tp") need no ring: attention is
independent along them, so the port computes them in one piece.

The arithmetic follows the JAX code step by step, in the input dtype:
scores divided by ``sqrt(d)`` cast to that dtype, masked with -1e30,
every merge in the input dtype. The running max is bookkeeping for
numerical stability (it cancels in o / l), so every use of it is
detached: the block max, and through it both merge rescales.

Layout: ``[batch, seq, heads, head_dim]``, the JAX convention.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from geomx_tpu_torch.parallel.mesh import Mesh, _ways, check_divisible

__all__ = ["ring_attention", "make_ring_attention"]

NEG_INF = -1e30


def _block_attn(q, k, v, mask):
    """One blockwise contribution for every rank at once: ``(scores max,
    exp_scores @ v, exp_scores row-sum)``. ``q``: [B, R, Tq, H, D], ``k``
    / ``v``: [B, R, Tk, H, D], ``mask``: [R, Tq, Tk] -> max and row-sum
    [B, R, H, Tq, 1], o [B, R, Tq, H, D]. The max is detached (see the
    module docstring)."""
    d = q.shape[-1]
    s = torch.einsum("brqhd,brkhd->brhqk", q, k) / torch.tensor(
        math.sqrt(d), dtype=torch.float32).to(q.dtype)
    mask = mask[None, :, None]                                # [1,R,1,Tq,Tk]
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype))
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype))
    o = torch.einsum("brhqk,brkhd->brqhd", p, v)
    l = p.sum(dim=-1, keepdim=True)
    return m, o, l


def ring_attention(q, k, v, *, sp: int, causal: bool = False):
    """Ring attention of ``q``, ``k``, ``v`` ([B, T, H, D]) with the
    sequence split over ``sp`` ranks; the result is [B, T, H, D]."""
    B, T, H, D = q.shape
    if T % sp:
        raise ValueError(f"sequence {T} does not split over sp={sp}")
    t = T // sp
    q, k, v = (x.reshape(B, sp, t, H, D) for x in (q, k, v))
    dev = q.device
    rank = torch.arange(sp, device=dev)
    q_pos = rank[:, None] * t + torch.arange(t, device=dev)      # [R, t]

    def mask_for(src):                                          # src: [R]
        if not causal:
            return torch.ones((sp, t, t), dtype=torch.bool, device=dev)
        k_pos = src[:, None] * t + torch.arange(t, device=dev)
        return q_pos[:, :, None] >= k_pos[:, None, :]

    # step 0: each rank's own block seeds the accumulators
    m_acc, o_acc, l_acc = _block_attn(q, k, v, mask_for(rank))
    k_blk, v_blk = k, v
    for i in range(1, sp):
        # one hop: rank r now holds rank r-1's block, (r - i) % sp's
        # after i hops
        k_blk = torch.roll(k_blk, 1, dims=1)
        v_blk = torch.roll(v_blk, 1, dims=1)
        m_blk, o_blk, l_blk = _block_attn(q, k_blk, v_blk,
                                          mask_for((rank - i) % sp))
        # streaming softmax merge; every max here is detached
        m_new = torch.maximum(m_acc, m_blk)
        c_acc = torch.exp(m_acc - m_new)
        c_blk = torch.exp(m_blk - m_new)
        o_acc = (o_acc * c_acc.movedim(2, 3) + o_blk * c_blk.movedim(2, 3))
        l_acc = l_acc * c_acc + l_blk * c_blk
        m_acc = m_new
    denom = l_acc.movedim(2, 3)                                 # [B,R,t,H,1]
    out = o_acc / torch.clamp(denom, min=1e-20)
    return out.reshape(B, T, H, D)


def make_ring_attention(mesh: Mesh, *, causal: bool = False,
                        q_spec: Optional[Sequence] = None):
    """``fn(q, k, v)``: ring attention over ``mesh``.

    ``q_spec`` is the layout of q, k and v, by default ``("dp", "sp",
    "tp", None)``: batch over dp, sequence over sp, heads over tp. Each
    axis must divide by the mesh axes it is mapped to, as shard_map
    requires; the ring runs over the mesh axes of the sequence entry."""
    spec = tuple(q_spec) if q_spec is not None else ("dp", "sp", "tp", None)
    sp = _ways(mesh, spec[1]) if len(spec) > 1 else 1

    def fn(q, k, v):
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_divisible(mesh, spec, x.shape, f"ring attention's {name}")
        return ring_attention(q, k, v, sp=sp, causal=causal)

    return fn
