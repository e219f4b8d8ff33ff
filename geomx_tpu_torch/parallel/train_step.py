"""Data-parallel train steps over a party's ranks (tier 0/1).

Counterpart of ``DataParallelTrainer`` in
``geomx_tpu/parallel/train_step.py``: the parameters are replicated, the
batch is split over the "dp" ranks, and the step either mean-reduces the
gradient and applies the optimizer (``step``) or hands back each rank's
local gradient for an explicit collective such as the quantized ring
(``local_grads``). The party's ranks share one device
(:mod:`.mesh`), so one replica of the parameters serves every rank and
``local_grads`` runs one forward and backward pass per rank over its
shard of the batch.

The model is a ``torch.nn.Module`` (parameters in flax leaf order as
:func:`geomx_tpu_torch.models.convert.leaf_names` gives it) and the
optimizer a ``torch.optim`` optimizer over its parameters. The loss is
the JAX package's: the mean softmax cross-entropy of the logits against
integer labels. ``HierarchicalTrainer`` waits for the kv store tiers
(ROADMAP queue A items 4 and 9).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from geomx_tpu_torch.models.convert import leaf_names

__all__ = ["DataParallelTrainer"]


class DataParallelTrainer:
    """Pure in-party DP: params replicated, batch split over "dp"."""

    def __init__(self, model: torch.nn.Module, optimizer, mesh,
                 num_classes: int = 10):
        self.mesh = mesh
        self.model = model.to(mesh.device)
        self.optimizer = optimizer
        self.num_classes = int(num_classes)
        named = dict(self.model.named_parameters())
        # the replicated parameters, in flax leaf order
        self.params = [named[n] for n in leaf_names(self.model)]

    def _loss(self, X, y):
        logits = self.model(X)
        if logits.shape[-1] != self.num_classes:
            raise ValueError(f"logits have {logits.shape[-1]} classes, "
                             f"num_classes is {self.num_classes}")
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, y.long().unsqueeze(-1)).mean()

    def _grad(self, X, y) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        loss = self._loss(X, y)
        return loss.detach(), list(torch.autograd.grad(loss, self.params))

    def shard_batch(self, X, y):
        """The batch as tensors on the party's device."""
        dev = self.mesh.device
        return torch.as_tensor(X).to(dev), torch.as_tensor(y).to(dev)

    def step(self, X, y) -> float:
        X, y = self.shard_batch(X, y)
        loss, grads = self._grad(X, y)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        return float(loss)

    def grads(self, X, y):
        """Party-aggregated (mean) gradients: ``(loss, [grad leaf])`` in
        flax leaf order — tier-1 output for tier-2."""
        X, y = self.shard_batch(X, y)
        return self._grad(X, y)

    def local_grads(self, X, y):
        """Per-rank local mean grads, each leaf stacked ``(P, *shape)``
        over "dp" (NOT reduced — feed these to the quantized ring);
        losses come back ``(P,)``, one per rank."""
        X, y = self.shard_batch(X, y)
        size = self.mesh.size
        if X.shape[0] % size:
            raise ValueError(f"batch {X.shape[0]} does not split over "
                             f"{size} ranks")
        per = X.shape[0] // size
        out = [self._grad(X[r * per:(r + 1) * per], y[r * per:(r + 1) * per])
               for r in range(size)]
        losses = torch.stack([loss for loss, _ in out])
        grads = [torch.stack([g[i] for _, g in out])
                 for i in range(len(self.params))]
        return losses, grads
