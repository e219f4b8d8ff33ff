"""FSDP / ZeRO-style parameter and optimizer-state sharding over "dp".

Counterpart of ``geomx_tpu/parallel/fsdp.py`` (``fsdp_spec`` ``:40-56``,
``fsdp_shardings`` ``:59``, ``FSDPTrainer`` ``:67-131``). Each leaf is
split along its largest axis divisible by the "dp" size (the first such
axis among equals); a leaf with no such axis stays whole. Where the JAX
package lets GSPMD place the all-gather on use and the reduce-scatter on
the gradient, the port keeps each leaf as its dp shards, rank-stacked
(:class:`~geomx_tpu_torch.parallel.mesh.Sharded`), gathers the whole
leaf for the forward pass, and hands the gradient back per shard, so the
optimizer (and its state) works on the shards. The ranks share one card
(:mod:`.mesh`): this is the ZeRO-3 layout, and per-card memory does not
drop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from geomx_tpu_torch.models.convert import leaf_names
from geomx_tpu_torch.parallel.mesh import Mesh, shard

__all__ = ["fsdp_spec", "fsdp_shardings", "FSDPTrainer"]


def fsdp_spec(shape, mesh: Mesh, axis: str = "dp") -> tuple:
    """Spec (a ``PartitionSpec`` as a tuple) splitting the LARGEST axis
    divisible by mesh[axis]; fully replicated when nothing divides."""
    n = mesh.shape[axis]
    if n == 1 or not shape:
        return ()
    best = -1
    best_dim = -1
    for d, s in enumerate(shape):
        if s % n == 0 and s > best_dim:
            best, best_dim = d, s
    if best < 0:
        return ()
    parts: list = [None] * len(shape)
    parts[best] = axis
    return tuple(parts)


def fsdp_shardings(tree, mesh: Mesh, axis: str = "dp"):
    """The spec of every leaf of ``tree`` under the FSDP rule."""
    return pytree.tree_map(
        lambda leaf: fsdp_spec(tuple(getattr(leaf, "shape", ())), mesh,
                               axis), tree)


class FSDPTrainer:
    """Fully-sharded DP train loop: params, grads and optimizer state
    split over "dp", the batch split over "dp".

    ``optimizer`` builds the torch optimizer over a list of tensors
    (e.g. ``functools.partial(torch.optim.Adam, lr=3e-3)``); it is given
    the shard stacks. ``model`` starts from its own parameters. The
    default loss is the mean softmax cross-entropy against integer
    labels; ``loss_fn(logits, y)`` replaces it."""

    def __init__(self, model: torch.nn.Module, optimizer: Callable, mesh: Mesh,
                 num_classes: int = 10, loss_fn: Optional[Callable] = None):
        self.mesh = mesh
        self.model = model.to(mesh.device)
        self.num_classes = int(num_classes)
        named = dict(self.model.named_parameters())
        self.params = {}
        for n in leaf_names(self.model):
            p = named[n].detach()
            s = shard(p, mesh, fsdp_spec(tuple(p.shape), mesh))
            s.shards.requires_grad_(True)
            self.params[n] = s
        self.optimizer = optimizer([s.shards for s in self.params.values()])
        self.loss_fn = loss_fn or self._xent

    def _xent(self, logits, y):
        if logits.shape[-1] != self.num_classes:
            raise ValueError(f"logits have {logits.shape[-1]} classes, "
                             f"num_classes is {self.num_classes}")
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, y.long().unsqueeze(-1)).mean()

    def shard_batch(self, X, y):
        """The batch rank-stacked over "dp": ``(dp, B/dp, ...)``."""
        dp = self.mesh.shape["dp"]
        out = []
        for a in (X, y):
            t = torch.as_tensor(a).to(self.mesh.device)
            if t.ndim == 0 or t.shape[0] % dp:
                raise ValueError(f"a batch of {tuple(t.shape)} does not "
                                 f"split over dp={dp}")
            out.append(t.reshape(dp, t.shape[0] // dp, *t.shape[1:]))
        return tuple(out)

    def step(self, X, y) -> float:
        X, y = self.shard_batch(X, y)
        X, y = X.flatten(0, 1), y.flatten(0, 1)
        full = {n: s.full() for n, s in self.params.items()}
        logits = torch.func.functional_call(self.model, full, (X,))
        loss = self.loss_fn(logits, y)
        shards = [s.shards for s in self.params.values()]
        for t, g in zip(shards, torch.autograd.grad(loss, shards)):
            t.grad = g
        self.optimizer.step()
        return float(loss.detach())

    def param_shard_fraction(self) -> float:
        """Mean over leaves of (per-rank shard elems / leaf elems) —
        ~1/|dp| when sharding engaged."""
        fracs = []
        for s in self.params.values():
            num = 1
            for d in s.shard_shape:
                num *= d
            den = 1
            for d in s.shape:
                den *= d
            fracs.append(num / max(den, 1))
        return sum(fracs) / len(fracs)
