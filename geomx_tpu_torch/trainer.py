"""Trainer: parameter/optimizer/kvstore wiring for the worker loop.

Counterpart of ``geomx_tpu/trainer.py``, numpy on the host as there. It
plays the role of gluon's ``Trainer`` (reference:
python/mxnet/gluon/trainer.py:27 — holds the parameter list, owns the
kvstore interaction, ``step()`` applies one update): the model's
parameters live as a flat list of numpy leaves whose index is the kv
key, gradients come from the caller's step (torch autograd, on any
device; ``step`` takes numpy arrays or tensors), and the optimizer runs
on the global aggregation server (set once by the master worker via
``kv.set_optimizer``; reference kvstore.py:452).

Usage (see examples/cnn.py for the manual version this wraps):

    trainer = Trainer(leaves, kv)       # kv.init + initial pull
    ...
    loss, grads = grad_step(trainer.leaves, X, y)
    trainer.step(grads)                 # push grads, pull fresh params

Checkpointing: ``save(prefix, epoch)`` / ``Trainer.load`` persist the
leaves (and through ``kv.save_optimizer_states`` the updater state when
the optimizer is local) — reference: module/module.py:165/791.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from geomx_tpu_torch import checkpoint as ckpt_mod
from geomx_tpu_torch.kvstore.base import _to_numpy
from geomx_tpu_torch.kvstore.frontier import RoundAborted

__all__ = ["Trainer"]

log = logging.getLogger("geomx.trainer")

# how many times one training round may be re-issued after a
# RoundAborted / WorkerLostError before the abort propagates
MAX_ROUND_RETRIES = 3


class Trainer:
    def __init__(self, params: Sequence[Any], kvstore,
                 begin_key: int = 0, priority_descending: bool = True,
                 overlap: Optional[bool] = None):
        """``params``: list of array leaves; key of leaf i = begin_key+i.

        ``priority_descending`` pushes earlier (closer-to-output in the
        usual flatten order) keys at higher priority, matching the
        examples' ``priority=-idx`` P3 pattern.

        ``overlap`` (default: the store's GEOMX_OVERLAP config) defers
        ``step``'s round barrier to the point of first use: the next
        ``leaves`` access — usually the next forward, or an HFA K2
        global round riding behind K1 local steps — joins the in-flight
        round. Sync semantics are unchanged (nothing reads stale
        params); only the blocking moves.
        """
        self.kv = kvstore
        self.begin_key = begin_key
        self.priority_descending = priority_descending
        if overlap is None:
            overlap = bool(getattr(getattr(kvstore, "cfg", None),
                                   "overlap", False))
        self._overlap = overlap
        self._dirty = False      # a step's round is still in flight
        self._round = 0          # 1-based training-round counter
        # the round in flight, kept for RoundAborted re-issue:
        # (gradient arrays, pull flag)
        self._inflight: Optional[Tuple[List[np.ndarray], bool]] = None
        self._leaves: List[np.ndarray] = [_to_numpy(p) for p in params]
        for i, leaf in enumerate(self._leaves):
            self.kv.init(begin_key + i, leaf)
        # a REJOINING worker (is_recovery=True: it was declared dead and
        # re-registered) must adopt the cluster's CURRENT weights — its
        # init pushes are acked-and-ignored as duplicates, and training
        # from its stale local leaves would fork the model. The master
        # worker normally skips the pull (its init IS the weights).
        van = getattr(getattr(kvstore, "po", None), "van", None)
        rejoining = bool(van is not None
                         and getattr(van, "is_recovery", False))
        if not getattr(self.kv, "is_master_worker", False) or rejoining:
            for i in range(len(self._leaves)):
                self.kv.pull(begin_key + i, out=self._leaves[i])
        self.kv.wait()

    @property
    def leaves(self) -> List[np.ndarray]:
        """Current parameters — the point of first use: joins any
        in-flight overlapped round before handing them out."""
        self.sync()
        return self._leaves

    def sync(self) -> None:
        """Join the in-flight round, if any (the moved barrier)."""
        if self._dirty:
            self._dirty = False
            self._join()

    # -- one update ------------------------------------------------------

    def step(self, grads: Sequence[Any], pull: bool = True) -> None:
        """Push per-leaf gradients; pull back the updated parameters.
        With overlap on, returns with the round in flight — the barrier
        runs at the next ``leaves`` access instead of here.

        A round that aborts mid-flight because membership changed
        (:class:`RoundAborted` — e.g. a server this round depended on
        was declared dead and recovered) is re-issued against the new
        epoch up to ``MAX_ROUND_RETRIES`` times before propagating."""
        assert len(grads) == len(self._leaves), (
            f"got {len(grads)} grads for {len(self._leaves)} params")
        self.sync()   # at most one round in flight (same-buffer pulls)
        self._round += 1
        notify = getattr(self.kv, "notify_round", None)
        if notify is not None:
            # FaultPlan at_round crash rules key off this counter
            notify(self._round)
        garr = [_to_numpy(g) for g in grads]
        self._inflight = (garr, pull)
        self._issue(garr, pull)
        if self._overlap and pull:
            self._dirty = True
            return
        self._join()

    def _issue(self, garr: List[np.ndarray], pull: bool) -> None:
        if (getattr(self.kv, "type", "") == "dist_sync_mesh" and pull
                and len(garr) > 1):
            # mesh-party store: the gradients handed in are already the
            # party aggregate (reduced on the party's device in the
            # caller's step) — account that collective under tier=mesh
            # and run ONE combined van round from the global worker
            self.kv.record_round_collectives(garr)
            keys = [self.begin_key + i for i in range(len(garr))]
            self.kv.push_pull(keys, list(garr), self._leaves, priority=0)
            return
        for i, g in enumerate(garr):
            prio = -i if self.priority_descending else 0
            key = self.begin_key + i
            self.kv.push(key, g, priority=prio)
            if pull:
                self.kv.pull(key, out=self._leaves[i], priority=prio)

    def _join(self) -> None:
        """Join the in-flight round. On :class:`RoundAborted` (the
        membership epoch bumped mid-round and the transport abandoned
        part of it) re-pull the epoch's current weights and re-issue
        the saved gradients, a bounded number of times."""
        for attempt in range(MAX_ROUND_RETRIES + 1):
            try:
                self.kv.wait()
                self._inflight = None
                return
            except RoundAborted as exc:
                if (self._inflight is None
                        or attempt >= MAX_ROUND_RETRIES):
                    raise
                garr, pull = self._inflight
                log.warning(
                    "training round %d aborted (%s); re-pulling weights "
                    "and re-issuing gradients (attempt %d/%d)",
                    self._round, exc, attempt + 1, MAX_ROUND_RETRIES)
                try:
                    for i in range(len(self._leaves)):
                        self.kv.pull(self.begin_key + i,
                                     out=self._leaves[i])
                    self.kv.wait()
                    self._issue(garr, pull)
                except RoundAborted:
                    # the epoch moved again mid-recovery; the next loop
                    # iteration joins whatever survived
                    continue

    def pull_all(self) -> None:
        self.sync()
        for i in range(len(self._leaves)):
            self.kv.pull(self.begin_key + i, out=self._leaves[i])
        self.kv.wait()

    # -- checkpoint ------------------------------------------------------

    def save(self, prefix: str, epoch: int,
             metadata: Optional[dict] = None) -> str:
        return ckpt_mod.save_checkpoint(prefix, epoch, list(self.leaves),
                                        metadata=metadata)

    @staticmethod
    def load(prefix: str, epoch: int, kvstore, **kw) -> "Trainer":
        params, _opt, _meta = ckpt_mod.load_checkpoint(prefix, epoch)
        return Trainer(params, kvstore, **kw)
