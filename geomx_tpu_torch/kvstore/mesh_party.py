"""KVStorePartyMesh — the mesh-party intra-DC tier (``dist_sync_mesh``).

Counterpart of ``geomx_tpu/kvstore/mesh_party.py``. Vanilla HiPS moves
every gradient byte of a party over the LAN PS hop (worker -> local
server -> worker). In the mesh-party tier the party's workers become the
ranks of one party mesh (:mod:`geomx_tpu_torch.parallel.mesh`) and the
intra-party aggregate is computed on the device, inside the trainer's
step: no host round trip, no local-server push/pull, no van message
between members of one party.

Topology:

- the party's former van workers become the ranks of one party mesh:
  on one device they share it, single-controller
  (:class:`~geomx_tpu_torch.parallel.mesh.PartyMesh`); with the
  ``GEOMX_MESH_*`` settings each rank is a process of a
  ``torch.distributed`` group (:func:`maybe_init_multihost`,
  :class:`~geomx_tpu_torch.parallel.mesh.ProcessPartyMesh`);
- exactly ONE rank per party — the "global worker", rank 0 of the group
  — speaks the van to the party server through an inner
  :class:`KVStoreDist`, whose combined wire, P3 slicing, BSC, quantized
  wire codecs, membership epochs and trace stamping are unchanged. Only
  it builds that store; on the other ranks of a process party the van
  operations raise, as the JAX package's ``_require_global`` does. The
  party's config says ``num_workers=1``: the van sees one worker per
  party;
- results come back into the mesh as replicated tensors on the party's
  device (:meth:`put_replicated`: over processes a broadcast from the
  global worker), and batches split over the "dp" axis
  (:meth:`shard_batch`: ``(R, B/P, ...)`` stacks of the mesh's local
  rows, every rank's in one process, each process's own over several).

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

import torch.distributed as dist

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

# what a non-global rank of a process party takes from its global worker
_IDENTITY = ("rank", "num_workers", "num_all_workers", "is_master_worker")


def _ring_bytes(party_size: int, nbytes: int) -> int:
    """Link bytes of one ring all-reduce of ``nbytes`` over the party:
    each of P ranks sends 2*(P-1) chunks of nbytes/P — summed over links
    that is 2*(P-1)*nbytes. Counted from shapes, not measured: an honest
    per-round magnitude for the mesh tier, kept out of wan_bytes()."""
    return 2 * max(0, party_size - 1) * int(nbytes)


def maybe_init_multihost(cfg) -> bool:
    """Join the party's process group from the GEOMX_MESH_* settings
    (``GEOMX_MESH_COORDINATOR`` host:port, ``GEOMX_MESH_NUM_PROCS``,
    ``GEOMX_MESH_PROC_ID``): ``torch.distributed`` over gloo, rendezvous
    at the coordinator (rank 0 listens there). The JAX package calls
    ``jax.distributed.initialize`` here.

    Returns True when this process is in a multi-process party (after
    which ``torch.distributed.get_rank()`` picks the global worker);
    False on single-process runs (the settings unset). A repeat call is
    a no-op that returns True. Gloo runs on the CPU and on the card
    alike: NCCL would refuse two ranks on one GPU."""
    if not cfg.mesh_coordinator or int(cfg.mesh_num_processes) <= 1:
        return False
    if dist.is_initialized():
        return True
    world, rank = int(cfg.mesh_num_processes), int(cfg.mesh_process_id)
    if not 0 <= rank < world:
        raise ValueError(f"GEOMX_MESH_PROC_ID={cfg.mesh_process_id}: "
                         f"expected 0..{world - 1}")
    dist.init_process_group("gloo",
                            init_method="tcp://" + cfg.mesh_coordinator,
                            world_size=world, rank=rank)
    return True


class KVStorePartyMesh(KVStore):
    def __init__(self, sync_global: bool = True,
                 cfg: Optional[cfg_mod.Config] = None,
                 mesh=None, party_index: int = 0, device=None):
        """``mesh``: the party's mesh; None builds one of
        ``cfg.party_mesh_size`` ranks on ``device`` (None: the CUDA
        card) — over the processes of the group when the GEOMX_MESH_*
        settings name one (joined first, as the JAX package does)."""
        super().__init__()
        self.cfg = cfg or cfg_mod.load()
        maybe_init_multihost(self.cfg)
        if mesh is None:
            mesh = pmesh.make_party_mesh(self.cfg.party_mesh_size,
                                         party_index, device=device)
        self.mesh = mesh
        self.party_size = int(mesh.size)
        self.procs = isinstance(mesh, pmesh.ProcessPartyMesh)
        # one process drives a one-process party; over processes rank 0
        # of the group is the party's van speaker
        self._is_global_worker = not self.procs or mesh.rank == 0
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
        self._live_futs: "weakref.WeakSet[RoundFuture]" = weakref.WeakSet()
        # the party's ONLY van-speaking worker; the other ranks of a
        # process party mirror its van identity
        self.inner = None
        self._ident = {}
        if self._is_global_worker:
            self.inner = KVStoreDist(sync_global=sync_global, cfg=self.cfg)
            self.inner.round_abort_hook = self._fail_fast_pending
        if self.procs:
            box = [{name: getattr(self.inner, name) for name in _IDENTITY}
                   if self.inner is not None else None]
            dist.broadcast_object_list(box, src=0)
            self._ident = box[0]

    # -- identity --------------------------------------------------------

    @property
    def type(self) -> str:
        return "dist_sync_mesh"

    @property
    def is_global_worker(self) -> bool:
        return self._is_global_worker

    def _van(self, name: str):
        """The van store's ``name`` (on a non-global rank of a process
        party: the global worker's, as it was when the party formed)."""
        if self.inner is not None:
            return getattr(self.inner, name)
        return self._ident[name]

    @property
    def rank(self) -> int:
        return self._van("rank")

    @property
    def num_workers(self) -> int:
        return self._van("num_workers")

    @property
    def num_all_workers(self) -> int:
        return self._van("num_all_workers")

    @property
    def is_master_worker(self) -> bool:
        return self._van("is_master_worker")

    @property
    def po(self):
        self._require_global("po")
        return self.inner.po

    def membership_epoch(self) -> int:
        self._require_global("membership_epoch")
        return self.inner.membership_epoch()

    def get_num_dead_node(self, role=None) -> int:
        self._require_global("get_num_dead_node")
        return self.inner.get_num_dead_node(role)

    def notify_round(self, round_idx: int) -> None:
        if self._is_global_worker:
            self.inner.notify_round(round_idx)

    # -- mesh side -------------------------------------------------------

    def put_replicated(self, tree):
        """Host or device leaves (one, or a list) as replicated tensors on
        the party's device (the "results back into the mesh" leg: no van
        traffic). Over processes every rank calls it with leaves of the
        same shapes and gets the global worker's values (a broadcast)."""
        if isinstance(tree, (list, tuple)):
            return [pmesh.replicated(self.mesh, x) for x in tree]
        return pmesh.replicated(self.mesh, tree)

    def shard_batch(self, *arrays):
        """Split batch arrays over the party's "dp" axis as ``(R, B/P,
        ...)`` stacks of the mesh's local rows: ``(P, B/P, ...)`` in one
        process, this rank's ``(1, B/P, ...)`` over processes (``None``
        passes through — e.g. an unused label operand)."""
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

    # -- data plane (van traffic: the global worker speaks for the party)

    def _require_global(self, opname: str) -> None:
        if not self._is_global_worker:
            raise RuntimeError(
                f"{opname}: only the party's global worker speaks the "
                f"van; non-global mesh ranks aggregate via device "
                f"collectives only")

    def init(self, key, value) -> None:
        if self._is_global_worker:
            self.inner.init(key, value)

    def push(self, key, value, priority: int = 0) -> None:
        self._require_global("push")
        self.inner.push(key, value, priority=priority)

    def pull(self, key, out=None, priority: int = 0):
        self._require_global("pull")
        return self.inner.pull(key, out=out, priority=priority)

    def push_pull(self, key, value, out, priority: int = 0) -> None:
        self._require_global("push_pull")
        self.inner.push_pull(key, value, out, priority=priority)

    def push_pull_async(self, key, value, out, priority: int = 0,
                        slice_bytes: Optional[int] = None) -> RoundFuture:
        self._require_global("push_pull_async")
        return self._watch(self.inner.push_pull_async(
            key, value, out, priority=priority, slice_bytes=slice_bytes))

    def push_bsc(self, key, values, indices, priority: int = 0) -> None:
        self._require_global("push_bsc")
        self.inner.push_bsc(key, values, indices, priority=priority)

    def pull_bsc(self, key, priority: int = 0, timeout: float = None):
        self._require_global("pull_bsc")
        return self.inner.pull_bsc(key, priority=priority, timeout=timeout)

    def push_bsc_batch(self, keys, values_list, indices_list,
                       priority: int = 0) -> None:
        self._require_global("push_bsc_batch")
        self.inner.push_bsc_batch(keys, values_list, indices_list,
                                  priority=priority)

    def pull_bsc_batch(self, keys, priority: int = 0, timeout: float = None):
        self._require_global("pull_bsc_batch")
        return self.inner.pull_bsc_batch(keys, priority=priority,
                                         timeout=timeout)

    def push_pull_bsc_batch(self, keys, values_list, indices_list,
                            priority: int = 0, timeout: float = None):
        self._require_global("push_pull_bsc_batch")
        return self.inner.push_pull_bsc_batch(
            keys, values_list, indices_list, priority=priority,
            timeout=timeout)

    def push_pull_bsc_batch_async(self, keys, values_list, indices_list,
                                  priority: int = 0,
                                  slice_bytes: Optional[int] = None
                                  ) -> RoundFuture:
        self._require_global("push_pull_bsc_batch_async")
        return self._watch(self.inner.push_pull_bsc_batch_async(
            keys, values_list, indices_list, priority=priority,
            slice_bytes=slice_bytes))

    def wait(self, keys=None, timeout: float = None) -> None:
        if self._is_global_worker:
            self.inner.wait(keys, timeout=timeout)

    waitall = wait

    # -- control plane ---------------------------------------------------

    def set_optimizer(self, optimizer) -> None:
        self._require_global("set_optimizer")
        self.inner.set_optimizer(optimizer)

    def set_gradient_compression(self, compression_params: Dict) -> None:
        super().set_gradient_compression(compression_params)
        if self._is_global_worker:
            self.inner.set_gradient_compression(compression_params)

    def set_multi_precision(self, multi_precision: bool = True) -> None:
        if self._is_global_worker:
            self.inner.set_multi_precision(multi_precision)

    def save_optimizer_states(self, fname: str) -> None:
        self._require_global("save_optimizer_states")
        self.inner.save_optimizer_states(fname)

    def load_optimizer_states(self, fname: str) -> None:
        self._require_global("load_optimizer_states")
        self.inner.load_optimizer_states(fname)

    def metrics(self, timeout: float = 30.0) -> Dict[str, object]:
        self._require_global("metrics")
        return self.inner.metrics(timeout=timeout)

    def barrier(self, is_global: bool = False) -> None:
        if self._is_global_worker:
            self.inner.barrier(is_global=is_global)

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()
