"""KVStorePartyMesh — the mesh-party intra-DC tier (``dist_sync_mesh``).

Counterpart of ``geomx_tpu/kvstore/mesh_party.py``. Vanilla HiPS moves
every gradient byte of a party over the LAN PS hop (worker -> local
server -> worker). In the mesh-party tier the party's workers become the
ranks of one party mesh (:mod:`geomx_tpu_torch.parallel.mesh`) and the
intra-party aggregate is computed on the device, inside the trainer's
step: no host round trip, no local-server push/pull, no van message
between members of one party.

Topology:

- the party's former van workers become the ranks of one party mesh;
  on one card they share it, single-controller, as the quantized ring
  already runs (a party over several cards is ROADMAP queue A item 9);
- exactly ONE rank per party — the "global worker" — speaks the van to
  the party server through an inner :class:`KVStoreDist`, whose combined
  wire, P3 slicing, BSC, quantized wire codecs, membership epochs and
  trace stamping are unchanged. The party's config says
  ``num_workers=1``: the van sees one worker per party;
- results come back into the mesh as replicated tensors on the party's
  device (:meth:`put_replicated`), and batches split over the "dp" axis
  as ``(P, B/P, ...)`` stacks (:meth:`shard_batch`).

Mesh-tier collectives never touch the van, so their bytes get their own
counter family (``mesh.bytes{tier=mesh,...}``, from shapes, per round)
and :func:`telemetry.wan_bytes` excludes them.

Round aborts fan out: when the inner store's round dies (remote server
crash, membership epoch bump, blown resend deadline), every live
RoundFuture issued through this store is failed at once
(``RoundFuture.abort_pending``), and every ring residual is re-seeded at
zero. The abort runs on a van thread while a trainer's thread may be in
the middle of a ring, so the reset is deferred: it is marked here and
carried out on the trainer's thread, before its next ring
(:meth:`ring_reducer` for the store-keyed reducers, the registered hooks
for trainers that hold their own residual).
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

from geomx_tpu_torch import config as cfg_mod
from geomx_tpu_torch import telemetry
from geomx_tpu_torch.compression.device import MESH_CODECS
from geomx_tpu_torch.kvstore.base import KVStore
from geomx_tpu_torch.kvstore.dist import KVStoreDist
from geomx_tpu_torch.kvstore.frontier import RoundFuture
from geomx_tpu_torch.parallel import mesh as pmesh
from geomx_tpu_torch.parallel.quant_collectives import (QuantRingReducer,
                                                        ring_wire_bytes)

__all__ = ["KVStorePartyMesh", "maybe_init_multihost"]


def _ring_bytes(party_size: int, nbytes: int) -> int:
    """Link bytes of one ring all-reduce of ``nbytes`` over the party:
    each of P ranks sends 2*(P-1) chunks of nbytes/P — summed over links
    that is 2*(P-1)*nbytes. Counted from shapes, not measured: an honest
    per-round magnitude for the mesh tier, kept out of wan_bytes()."""
    return 2 * max(0, party_size - 1) * int(nbytes)


def maybe_init_multihost(cfg) -> bool:
    """The JAX package joins a multi-process party mesh here
    (``jax.distributed.initialize`` from the GEOMX_MESH_* settings). A
    single-process party — every party of this port — is a no-op that
    returns False; a party over several processes is refused."""
    if int(cfg.mesh_num_processes) > 1:
        raise NotImplementedError(
            f"GEOMX_MESH_NUM_PROCS={cfg.mesh_num_processes}: a party mesh "
            "over several processes (torch.distributed) is not ported yet "
            "(ROADMAP queue A item 9); the port's party ranks share one "
            "device in one process")
    return False


class KVStorePartyMesh(KVStore):
    def __init__(self, sync_global: bool = True,
                 cfg: Optional[cfg_mod.Config] = None,
                 mesh=None, party_index: int = 0, device=None):
        """``mesh``: the party's :class:`PartyMesh`; None builds one of
        ``cfg.party_mesh_size`` ranks on ``device`` (None: the CUDA
        card)."""
        super().__init__()
        self.cfg = cfg or cfg_mod.load()
        maybe_init_multihost(self.cfg)
        if mesh is None:
            mesh = pmesh.make_party_mesh(self.cfg.party_mesh_size,
                                         party_index, device=device)
        self.mesh = mesh
        self.party_size = int(mesh.size)
        # quantized mesh collective (GEOMX_MESH_CODEC): "none" keeps the
        # plain fp32 party mean; other codecs route gradient all-reduces
        # through the quantized ring, one stateful reducer (= one set of
        # error-feedback residual streams) per key
        self.mesh_codec = self.cfg.mesh_codec or "none"
        if self.mesh_codec not in MESH_CODECS:
            raise ValueError(
                f"GEOMX_MESH_CODEC={self.mesh_codec!r}: expected one of "
                f"{MESH_CODECS}")
        self.mesh_block = int(self.cfg.mesh_block)
        self._reducers: Dict = {}
        # trainers holding their own ring residuals register here so an
        # abort re-seeds EVERY residual stream, not just the keyed ones
        self._residual_reset_hooks: list = []
        self._reset_pending = threading.Event()
        # the party's ONLY van-speaking worker
        self.inner = KVStoreDist(sync_global=sync_global, cfg=self.cfg)
        self._live_futs: "weakref.WeakSet[RoundFuture]" = weakref.WeakSet()
        self.inner.round_abort_hook = self._fail_fast_pending

    # -- identity --------------------------------------------------------

    @property
    def type(self) -> str:
        return "dist_sync_mesh"

    @property
    def is_global_worker(self) -> bool:
        # single-controller: this process drives every rank of the party
        # and is its only van speaker
        return True

    @property
    def rank(self) -> int:
        return self.inner.rank

    @property
    def num_workers(self) -> int:
        return self.inner.num_workers

    @property
    def num_all_workers(self) -> int:
        return self.inner.num_all_workers

    @property
    def is_master_worker(self) -> bool:
        return self.inner.is_master_worker

    @property
    def po(self):
        return self.inner.po

    def membership_epoch(self) -> int:
        return self.inner.membership_epoch()

    def get_num_dead_node(self, role=None) -> int:
        return self.inner.get_num_dead_node(role)

    def notify_round(self, round_idx: int) -> None:
        self.inner.notify_round(round_idx)

    # -- mesh side -------------------------------------------------------

    def put_replicated(self, tree):
        """Host or device leaves (one, or a list) as replicated tensors on
        the party's device (the "results back into the mesh" leg: no van
        traffic)."""
        if isinstance(tree, (list, tuple)):
            return [pmesh.replicated(self.mesh, x) for x in tree]
        return pmesh.replicated(self.mesh, tree)

    def shard_batch(self, *arrays):
        """Split batch arrays over the party's "dp" axis as ``(P, B/P,
        ...)`` stacks (``None`` passes through — e.g. an unused label
        operand)."""
        out = tuple(a if a is None else pmesh.batch_sharded(self.mesh, a)
                    for a in arrays)
        return out[0] if len(out) == 1 else out

    def ring_reducer(self, key, n: int, mean: bool = False):
        """The per-key quantized ring reducer (one reducer = one set of
        error-feedback streams per key, never mixed across keys, rebuilt
        when the vector length changes). None when the codec is "none" —
        callers keep the plain fp32 mean. Runs on the trainer's thread,
        so a reset an abort marked is carried out here."""
        if self.mesh_codec == "none":
            return None
        self._apply_pending_reset()
        n = int(n)
        red = self._reducers.get(key)
        if red is None or red.n != n or red.mean != bool(mean):
            red = QuantRingReducer(
                self.mesh, self.mesh_codec, n, block=self.mesh_block,
                threshold=self.cfg.wire_2bit_threshold, mean=mean)
            self._reducers[key] = red
        return red

    def register_residual_reset_hook(self, fn) -> None:
        """Callback run by :meth:`reset_mesh_residuals` — for trainers
        that thread their OWN ring residual through their step instead of
        borrowing a store-keyed reducer. The hook must only mark its
        residual for a reset on the trainer's own thread."""
        self._residual_reset_hooks.append(fn)

    def reset_mesh_residuals(self) -> None:
        """Re-seed every ring residual stream at zero — abort and
        membership recovery must not replay stale error into the retried
        round (an abort loses at most the one drained quantized step).
        The store-keyed reducers reset before their next ring, on the
        thread that runs it."""
        self._reset_pending.set()
        for fn in self._residual_reset_hooks:
            fn()

    def _apply_pending_reset(self) -> None:
        if self._reset_pending.is_set():
            self._reset_pending.clear()
            for red in self._reducers.values():
                red.reset()

    def count_collective(self, nbytes: int, op: str = "psum",
                         n_msgs: int = 1) -> None:
        """Account one mesh collective of ``nbytes`` fp32 payload under
        the tier=mesh counter family (never tier=global: wan_bytes() must
        stay honest about what crossed the WAN). With a quantized codec
        the ring model counts what the hops move — codes plus the
        exponent/threshold sidecar — under its own codec= label."""
        if self.mesh_codec == "none":
            wire = _ring_bytes(self.party_size, nbytes)
        else:
            wire = ring_wire_bytes(self.mesh_codec, int(nbytes) // 4,
                                   self.party_size, self.mesh_block)
        telemetry.counter_inc("mesh.bytes", wire, tier="mesh", op=op,
                              codec=self.mesh_codec)
        telemetry.counter_inc("mesh.messages", n_msgs, tier="mesh", op=op)

    def record_round_collectives(self, leaves, op: str = "psum") -> None:
        """Count one round's worth of gradient all-reduces from the leaves'
        shapes (shape metadata only: nothing is copied to the host)."""
        nbytes = 0
        for leaf in leaves:
            nbytes += int(getattr(leaf, "nbytes", 0))
        self.count_collective(nbytes, op=op)

    # -- round-abort fan-out ---------------------------------------------

    def _fail_fast_pending(self, reason: str) -> None:
        """round_abort_hook on the inner store: the van round is dead —
        fail every pending key of every live future NOW so joiners on
        other keys unblock with RoundAborted instead of waiting out
        op_timeout (give_up_exc maps "round aborted" to RoundAborted,
        which the trainer's re-issue loop handles)."""
        for fut in list(self._live_futs):
            fut.abort_pending(f"round aborted: {reason}")
        # the aborted round's drained quantized step is lost; stale error
        # must not replay into the retried round
        self.reset_mesh_residuals()

    def _watch(self, fut: RoundFuture) -> RoundFuture:
        self._live_futs.add(fut)
        return fut

    # -- data plane (van traffic: this process speaks for the party) ---

    def init(self, key, value) -> None:
        self.inner.init(key, value)

    def push(self, key, value, priority: int = 0) -> None:
        self.inner.push(key, value, priority=priority)

    def pull(self, key, out=None, priority: int = 0):
        return self.inner.pull(key, out=out, priority=priority)

    def push_pull(self, key, value, out, priority: int = 0) -> None:
        self.inner.push_pull(key, value, out, priority=priority)

    def push_pull_async(self, key, value, out, priority: int = 0,
                        slice_bytes: Optional[int] = None) -> RoundFuture:
        return self._watch(self.inner.push_pull_async(
            key, value, out, priority=priority, slice_bytes=slice_bytes))

    def push_bsc(self, key, values, indices, priority: int = 0) -> None:
        self.inner.push_bsc(key, values, indices, priority=priority)

    def pull_bsc(self, key, priority: int = 0, timeout: float = None):
        return self.inner.pull_bsc(key, priority=priority, timeout=timeout)

    def push_bsc_batch(self, keys, values_list, indices_list,
                       priority: int = 0) -> None:
        self.inner.push_bsc_batch(keys, values_list, indices_list,
                                  priority=priority)

    def pull_bsc_batch(self, keys, priority: int = 0, timeout: float = None):
        return self.inner.pull_bsc_batch(keys, priority=priority,
                                         timeout=timeout)

    def push_pull_bsc_batch(self, keys, values_list, indices_list,
                            priority: int = 0, timeout: float = None):
        return self.inner.push_pull_bsc_batch(
            keys, values_list, indices_list, priority=priority,
            timeout=timeout)

    def push_pull_bsc_batch_async(self, keys, values_list, indices_list,
                                  priority: int = 0,
                                  slice_bytes: Optional[int] = None
                                  ) -> RoundFuture:
        return self._watch(self.inner.push_pull_bsc_batch_async(
            keys, values_list, indices_list, priority=priority,
            slice_bytes=slice_bytes))

    def wait(self, keys=None, timeout: float = None) -> None:
        self.inner.wait(keys, timeout=timeout)

    waitall = wait

    # -- control plane ---------------------------------------------------

    def set_optimizer(self, optimizer) -> None:
        self.inner.set_optimizer(optimizer)

    def set_gradient_compression(self, compression_params: Dict) -> None:
        super().set_gradient_compression(compression_params)
        self.inner.set_gradient_compression(compression_params)

    def set_multi_precision(self, multi_precision: bool = True) -> None:
        self.inner.set_multi_precision(multi_precision)

    def save_optimizer_states(self, fname: str) -> None:
        self.inner.save_optimizer_states(fname)

    def load_optimizer_states(self, fname: str) -> None:
        self.inner.load_optimizer_states(fname)

    def metrics(self, timeout: float = 30.0) -> Dict[str, object]:
        return self.inner.metrics(timeout=timeout)

    def barrier(self, is_global: bool = False) -> None:
        self.inner.barrier(is_global=is_global)

    def close(self) -> None:
        self.inner.close()
