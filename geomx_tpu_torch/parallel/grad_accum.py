"""Gradient accumulation: large effective batches in bounded memory.

Counterpart of ``geomx_tpu/parallel/grad_accum.py``
(``accumulate_gradients`` ``:21-71``). The JAX package scans the
microbatches inside its jitted step; here they are a Python loop of
forward and backward passes, one per microbatch, each freeing its
activations before the next. Accumulation runs in fp32 and the mean
gradients come back in each parameter's dtype, as there.

Parameters and gradients are any pytree of tensors (a list, a dict),
walked with ``torch.utils._pytree``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

__all__ = ["accumulate_gradients"]


def accumulate_gradients(grad_fn: Callable, num_microbatches: int, *,
                         axis_name: Optional[str] = None) -> Callable:
    """Wrap ``grad_fn(params, *batch) -> (loss, grads)`` into
    ``fn(params, *batch) -> (mean_loss, mean_grads)`` where every batch
    array carries a leading batch dim divisible by ``num_microbatches``
    (any number of batch arrays — X-only losses need no dummy labels).

    Accumulation runs in fp32; the returned mean gradients are cast back
    to each parameter leaf's dtype.

    With ``axis_name`` (the JAX package's ``pmean`` over that mesh axis)
    every batch array is rank-stacked over the axis, ``(ranks, B, ...)``
    as :func:`geomx_tpu_torch.parallel.mesh.batch_sharded` lays it out:
    each rank accumulates over its own rows, and the loss and the mean
    gradients are then averaged over the ranks once per step.
    """
    if num_microbatches < 1:
        raise ValueError("num_microbatches must be >= 1")

    def local(params, batch):
        B = batch[0].shape[0]
        if B % num_microbatches:
            raise ValueError(
                f"batch {B} not divisible by {num_microbatches} "
                "microbatches")
        mb = B // num_microbatches
        loss_sum = grads_sum = None
        for i in range(num_microbatches):
            xs = tuple(a[i * mb:(i + 1) * mb] for a in batch)
            loss, grads = grad_fn(params, *xs)
            loss = loss.detach().to(torch.float32)
            grads = pytree.tree_map(
                lambda g: g.detach().to(torch.float32), grads)
            if grads_sum is None:
                loss_sum, grads_sum = loss, grads
            else:
                loss_sum = loss_sum + loss
                grads_sum = pytree.tree_map(torch.add, grads_sum, grads)
        n = float(num_microbatches)
        grads = pytree.tree_map(lambda g, p: (g / n).to(p.dtype),
                                grads_sum, params)
        return loss_sum / n, grads

    def fn(params, *batch):
        if not batch:
            raise ValueError("need at least one batch array")
        if axis_name is None:
            return local(params, batch)
        ranks = batch[0].shape[0]
        outs = [local(params, tuple(a[r] for a in batch))
                for r in range(ranks)]
        loss = torch.stack([lo for lo, _ in outs]).mean()
        grads = pytree.tree_map(
            lambda *gs: torch.stack(gs).mean(0), *[g for _, g in outs])
        return loss, grads

    return fn
