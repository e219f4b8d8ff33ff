"""Data-parallel train steps over a party's ranks (tier 0/1), and the
hierarchical trainer that composes them with the HiPS kv store (tier 2).

Counterpart of ``geomx_tpu/parallel/train_step.py``.
``DataParallelTrainer``: the parameters are replicated, the
batch is split over the "dp" ranks, and the step either mean-reduces the
gradient and applies the optimizer (``step``) or hands back each rank's
local gradient for an explicit collective such as the quantized ring
(``local_grads``). One replica of the parameters serves the ranks of
the mesh's local rows (:mod:`.mesh`), and ``local_grads`` runs one
forward and backward pass per local rank over its shard of the batch:
every rank of the party on a :class:`~.mesh.PartyMesh`, this process's
own rank on a :class:`~.mesh.ProcessPartyMesh`, where the party mean is
the group's all-reduce, or the quantized ring (``step``'s
``reducer``).

The model is a ``torch.nn.Module`` (parameters in flax leaf order as
:func:`geomx_tpu_torch.models.convert.leaf_names` gives it) and the
optimizer a ``torch.optim`` optimizer over its parameters. The loss is
the JAX package's: the mean softmax cross-entropy of the logits against
integer labels.

``HierarchicalTrainer`` exchanges the party's aggregated gradient with
the HiPS global tier through the kv store each round: the global server
runs the optimizer (FSA) and the fresh parameters are installed back
into the model. Over a mesh-party store the party's ranks aggregate on
the device first (the fp32 mean, or the store's quantized ring per key
with ``GEOMX_MESH_CODEC``) and only the party's global worker speaks the
van, one combined ``push_pull`` per round. Over processes the other
ranks take the fresh parameters by the store's broadcast
(``put_replicated``), the initial ones too: the JAX package's
``init_on_kvstore`` pulls on every rank, which its non-global ranks
refuse.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from geomx_tpu_torch.models.convert import leaf_names
from geomx_tpu_torch.parallel import mesh as pmesh

__all__ = ["DataParallelTrainer", "HierarchicalTrainer"]


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

    @property
    def _one_pass(self) -> bool:
        """Whether this process holds every rank of the party, so the
        party mean is one pass over the whole batch."""
        return len(self.mesh.row_ranks) == self.mesh.size

    def shard_batch(self, X, y):
        """The batch as tensors on the party's device."""
        dev = self.mesh.device
        return torch.as_tensor(X).to(dev), torch.as_tensor(y).to(dev)

    def _mean_loss(self, losses) -> torch.Tensor:
        """The party's mean of the local ranks' ``(R,)`` losses."""
        return self.mesh.all_rows(losses).mean()

    def _party_mean(self, X, y, reducer=None, timings=None):
        """The local ranks' grads reduced to the party mean by ``reducer``
        (a :class:`QuantRingReducer` over the flat gradient) or, without
        one, the fp32 sum over the ranks; ``(mean loss, [grad leaf])``."""
        t0 = time.perf_counter()
        losses, grads = self.local_grads(X, y)
        flat = torch.cat([g.reshape(g.shape[0], -1) for g in grads], dim=1)
        del grads
        if timings is not None:
            _sync(flat)
            timings["local_grads"] = time.perf_counter() - t0
        out = reducer.reduce(flat, timings)[0] if reducer is not None \
            else self.mesh.sum_rows(flat) / self.mesh.size
        sizes = [p.numel() for p in self.params]
        return self._mean_loss(losses), [
            g.view(p.shape) for g, p in zip(out.split(sizes), self.params)]

    def step(self, X, y, reducer=None, timings: Optional[dict] = None
             ) -> float:
        """One optimizer step on the party-mean gradient: with
        ``reducer`` (the quantized ring over the flattened gradient) the
        local grads and their ring mean; without, one pass over the whole
        batch where this process holds every rank, else the local grads
        and the group's all-reduce. ``timings``: a dict that gains the
        seconds of the local grads, the ring's parts and the apply."""
        if reducer is not None:
            loss, grads = self._party_mean(X, y, reducer, timings)
        else:
            loss, grads = self.grads(X, y)
        t0 = time.perf_counter()
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        if timings is not None:
            _sync(self.params[0])
            timings["apply"] = time.perf_counter() - t0
        return float(loss)

    def grads(self, X, y):
        """Party-aggregated (mean) gradients: ``(loss, [grad leaf])`` in
        flax leaf order — tier-1 output for tier-2."""
        if not self._one_pass:
            return self._party_mean(X, y)
        X, y = self.shard_batch(X, y)
        return self._grad(X, y)

    def local_grads(self, X, y):
        """Per-rank local mean grads of the mesh's local rows, each leaf
        stacked ``(R, *shape)`` (NOT reduced — feed these to the
        quantized ring); losses come back ``(R,)``, one per local rank.
        R is P on one device, 1 over processes."""
        X = pmesh.batch_sharded(self.mesh, X)
        y = pmesh.batch_sharded(self.mesh, y)
        out = [self._grad(X[i], y[i]) for i in range(X.shape[0])]
        losses = torch.stack([loss for loss, _ in out])
        grads = [torch.stack([g[i] for _, g in out])
                 for i in range(len(self.params))]
        return losses, grads


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize()


class HierarchicalTrainer:
    """Tier-1 party aggregation + tier-2 HiPS exchange (geo-DP).

    Replaces the reference worker's per-layer push/pull loop
    (examples/cnn.py:121-124): the party IS the data center; the kv store
    carries only one aggregated gradient per key across the WAN. The
    global server runs the optimizer (FSA semantics) and the fresh
    parameters are installed back into the model.
    """

    def __init__(self, trainer: DataParallelTrainer, kvstore,
                 priority_by_key: bool = True):
        self.t = trainer
        self.kv = kvstore
        self.priority_by_key = priority_by_key
        # mesh-party store (kvstore.mesh_party): the trainer's mesh IS the
        # party — the van round shrinks to the global worker's combined
        # push_pull and the fresh params come back through _install
        self._mesh_store = getattr(kvstore, "mesh", None) is not None \
            and hasattr(kvstore, "record_round_collectives")
        self._host = [p.detach().cpu().numpy().copy() for p in self.t.params]

    def init_on_kvstore(self) -> None:
        if getattr(self.kv, "is_global_worker", True):
            for idx, leaf in enumerate(self._host):
                self.kv.init(idx, leaf)
                if not getattr(self.kv, "is_master_worker", False):
                    self.kv.pull(idx, out=self._host[idx])
            self.kv.wait()
        self._install()

    @torch.no_grad()
    def _install(self) -> None:
        """The fresh parameters into the model; over processes every
        rank takes the global worker's by the store's broadcast."""
        vals = self.kv.put_replicated(self._host) if self._mesh_store \
            else [torch.from_numpy(h) for h in self._host]
        for p, v in zip(self.t.params, vals):
            p.copy_(v)

    def step(self, X, y) -> float:
        if self._mesh_store and \
                getattr(self.kv, "mesh_codec", "none") != "none":
            return self._step_mesh_quant(X, y)
        loss, glist = self.t.grads(X, y)
        if self._mesh_store:
            return self._step_mesh(glist, loss)
        for idx, g in enumerate(glist):
            pr = -idx if self.priority_by_key else 0
            self.kv.push(idx, g.cpu().numpy(), priority=pr)
            self.kv.pull(idx, out=self._host[idx], priority=pr)
        self.kv.wait()
        self._install()
        return float(loss)

    def _step_mesh_quant(self, X, y) -> float:
        """Quantized mesh round (GEOMX_MESH_CODEC != "none"): the ranks'
        local grads go through one quantized ring PER KEY
        (``kv.ring_reducer`` — the error-feedback residual streams live
        in the store, keyed, so round aborts reset them in one place)
        instead of the fp32 mean. Every rank's copy of the ring's output
        is the same; the van leg and the accounting are
        :meth:`_step_mesh`'s."""
        losses, grads = self.t.local_grads(X, y)
        glist = []
        for idx, g in enumerate(grads):
            shape = g.shape[1:]
            n = int(np.prod(shape)) if len(shape) else 1
            red = self.kv.ring_reducer(idx, n, mean=True)
            glist.append(red.reduce(g.reshape(g.shape[0], -1))[0]
                         .reshape(shape))
        return self._step_mesh(glist, self.t._mean_loss(losses))

    def _step_mesh(self, glist, loss) -> float:
        """Mesh-party round: the party's aggregate is in ``glist`` —
        account its collective under tier=mesh, then one combined
        push_pull round on the van by the party's global worker; the
        result goes back into the model (every rank's)."""
        self.kv.record_round_collectives(glist)
        if getattr(self.kv, "is_global_worker", True):
            vals = [g.cpu().numpy() for g in glist]
            if len(vals) == 1:
                self.kv.push_pull(0, vals[0], self._host[0], priority=0)
            else:
                self.kv.push_pull(list(range(len(vals))), vals, self._host,
                                  priority=0)
            self.kv.wait()
        self._install()
        return float(loss)
