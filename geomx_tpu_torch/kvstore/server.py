"""KVStoreDistServer — the HiPS two-tier aggregation state machine.

A ground-up re-implementation of the reference's server (reference:
src/kvstore/kvstore_dist_server.h:169-2091) with the same observable
protocol, re-designed for host-side asynchrony without the MXNet engine:

- one process, two Postoffice overlays: an intra-DC ("local") tier where
  this process is a server, and the inter-DC ("global") tier where it is
  either a global worker (ordinary party server) or a global server
  (central party; reference kvstore_dist.h:237-258 RunServer);
- per-(key, shard-offset) states each guarded by their OWN lock, so
  independent keys aggregate in parallel (the reference serializes per
  key via update_buf_ + engine var-deps); all protocol transitions are callback-driven (no spin-waits, unlike the reference's
  DataHandlePullDefault sleep-loop at kvstore_dist_server.h:1736-1739);
- the synchronization backbone mirrors the reference exactly: worker push
  acks are DEFERRED until the round's fresh parameters are in the store
  (kvstore_dist_server.h:1146-1167), and workers do not issue a pull for a
  key until its push ack arrived (the engine-var ordering the reference
  gets from comm_buf_ read/write deps), so a pull always observes fresh
  parameters; additionally each forward/pull-back is tagged with a
  per-(key, offset) CYCLE id — stale global-tier responses (e.g. an
  init-time pull-back overtaken by a training round) are discarded
  instead of completing the wrong round — and the outbound aggregate is
  staged OUTSIDE the weight store, with local pulls buffered while a
  cycle is in flight, so a stale or mid-round pull is impossible by
  construction (the reference's store_ dual-use at :519 plus engine
  ordering only makes it unlikely);
- init-on-first-push, with a pull-back from the global tier that gates all
  early pulls (kvstore_dist_server.h:1241-1274);
- HFA milestone-delta logic (kvstore_dist_server.h:988-998, 1327-1346);
- MixedSync: the global tier applies the updater per arriving push with no
  global barrier (DataHandleAsyncDefault, kvstore_dist_server.h:1532);
- the optimizer runs ONLY on global servers (ApplyUpdates,
  kvstore_dist_server.h:512), shipped from the master worker as a pickle
  over the command channel (CommandType kController);
- WAN compression (FP16 / BSC / MPQ) applies on the inter-DC hop only:
  party servers compress forwarded aggregates and request compressed pulls;
  the LAN tier stays uncompressed — matching the reference's placement.

Generalization over the reference: a global server stores its CANONICAL
RANGES of each key (from the deterministic sharding over the full key
size) and accepts any (offset, length) sub-slice pushes against them,
counting round completion in contributed elements — so parties with
different local-server counts interoperate (the reference requires
aligned wire-key ranges and supports only matching layouts).
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import pickle
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from geomx_tpu_torch import checkpoint  # module-level: used in handler threads
from geomx_tpu_torch import config as cfg_mod
from geomx_tpu_torch import kernels_native
from geomx_tpu_torch import lr_scheduler
from geomx_tpu_torch import optimizer
from geomx_tpu_torch import profiler
from geomx_tpu_torch import telemetry
from geomx_tpu_torch.compression import make_compressor
from geomx_tpu_torch.compression.device import WireCodec
from geomx_tpu_torch.kvstore import sharding
from geomx_tpu_torch.kvstore.base import Command, DATA_INIT
from geomx_tpu_torch.kvstore.controller import TransportController
from geomx_tpu_torch.kvstore.frontier import slice_bytes_from_shape
from geomx_tpu_torch.ps import base as psbase
from geomx_tpu_torch.ps import locks
from geomx_tpu_torch.ps.kv_app import KVPairs, KVServer, KVWorker, ReqMeta
from geomx_tpu_torch.ps.message import Role
from geomx_tpu_torch.ps.postoffice import Postoffice

log = logging.getLogger("geomx.server")

Action = Callable[[], None]


# a JAX-package class the port has a twin of: the same name, the same
# plain attributes and the same numpy state
_TWINS = {"geomx_tpu.optimizer": optimizer,
          "geomx_tpu.lr_scheduler": lr_scheduler}


class _SysModulesUnpickler(pickle.Unpickler):
    """Unpickler that never triggers ``__import__`` for loaded modules.

    Kept from the JAX package, whose server processes block inside the
    package import, where a plain pickle.loads of the shipped optimizer
    would wait on the parent package's import lock. The port's server
    loop runs from ``python -m geomx_tpu_torch.kvstore_server`` and has no
    such lock; resolving from sys.modules is still what both servers do.

    A JAX-package master ships ``geomx_tpu.optimizer.<Cls>`` (with a
    ``geomx_tpu.lr_scheduler.<Cls>`` inside): those resolve to the port's
    class of the same name, so a port server never imports the JAX
    package (and with it jax and flax). Any other class of the JAX
    package is refused.
    """

    def find_class(self, module, name):
        if module.split(".")[0] == "geomx_tpu":
            twin = _TWINS.get(module)
            if twin is None or name not in twin.__all__:
                raise pickle.UnpicklingError(
                    f"{module}.{name}: a class of the JAX package with no "
                    "counterpart in geomx_tpu_torch; a port server takes "
                    "only optimizers and lr schedulers from it")
            return getattr(twin, name)
        mod = sys.modules.get(module)
        if mod is not None:
            return getattr(mod, name)
        return super().find_class(module, name)


def _safe_unpickle(data: bytes):
    return _SysModulesUnpickler(io.BytesIO(data)).load()


from contextlib import nullcontext as _null_ctx


class _BatchResponder:
    """One response per multi-key request message.

    A request carrying N (key, offset) entries is handled by N
    independent per-key state machines, each of which acks exactly once
    (possibly deferred across a round). The transport allows ONE
    response per request (the worker tracker fires on the first, and
    the resender dedups by timestamp), so this proxy counts the per-key
    acks and emits a single merged response when the last one lands.
    Pull responses merge their per-key KVPairs entry lists; push acks
    merge to an empty ack.
    """

    __slots__ = ("_srv", "_left", "_parts", "_lock")

    def __init__(self, srv, n: int):
        self._srv = srv
        self._left = n
        self._parts: List[KVPairs] = []
        self._lock = locks.make_lock("_BatchResponder._lock")

    # this proxy only merges parts into its own buffer; it exists and
    # runs exclusively behind the constructing handler's is_stale fence
    # (_handle_data checks before building one), so the per-class fence
    # closure cannot see it.
    # geomx-lint: disable=GX-P304
    def response(self, req, kvs: Optional[KVPairs] = None,
                 body: str = "") -> None:
        with self._lock:
            if kvs is not None:
                self._parts.append(kvs)
            self._left -= 1
            if self._left > 0:
                return
            parts, self._parts = self._parts, []
        if not parts:
            self._srv.response(req)
            return
        # one merged response carries ONE compr tag; per-key machines
        # answering the same request with different codecs would make the
        # worker decompress every part with whichever tag won — corrupt
        # pulls. Divergence is a server-side logic bug: fail loudly.
        tags = {p.compr for p in parts if p.compr}
        if len(tags) > 1:
            raise ValueError(
                f"_BatchResponder: divergent compr tags {sorted(tags)} "
                f"across per-key parts of one merged response")
        merged = KVPairs(compr=next(iter(tags), ""))
        for p in parts:
            for i in range(len(p.keys)):
                merged.keys.append(p.keys[i])
                merged.vals.append(p.vals[i])
                merged.aux.append(p.aux[i] if i < len(p.aux) else None)
                merged.offsets.append(p.offset_of(i))
                merged.totals.append(p.total_of(i))
                merged.lens.append(p.len_of(i))
        self._srv.response(req, merged)


class _KeyState:
    """Per-(key, shard-offset) protocol state (UpdateBuf + store_ entry)."""

    __slots__ = (
        "lock",
        "stored", "outbound", "milestone", "merged", "push_reqs",
        "deferred_acks", "pending_pulls", "initialized", "staging", "rounds",
        "offset", "length", "total", "dtype", "elems_received", "init_elems",
        "fwd_parts", "fwd_expected", "fwd_acks_left", "version", "cycle",
        "fwd_wire", "pre_init_pushes", "central_pushes", "master",
        "push_compr", "rsp_wire",
    )

    def __init__(self, offset: int):
        # every access to this state goes through this lock (RLock: the
        # pre-init replay path re-enters _global_slice_push)
        self.lock = locks.make_rlock("_KeyState.lock")
        self.stored: Optional[np.ndarray] = None
        # the aggregate staged for the global tier lives here, NEVER in
        # `stored` — `stored` always holds parameters, so a pull can never
        # observe a gradient
        self.outbound: Optional[np.ndarray] = None
        self.milestone: Optional[np.ndarray] = None
        self.merged: Optional[np.ndarray] = None
        self.push_reqs: List[Tuple[ReqMeta, KVServer]] = []
        self.deferred_acks: List[Tuple[ReqMeta, KVServer]] = []
        # (req, srv, off, length, compr, aux) — compr/aux retained so a
        # buffered row-sparse pull keeps its response format when flushed
        self.pending_pulls: List[Tuple] = []
        self.initialized = False
        # True between a local round completing and its global pull-back
        # being applied; local pulls buffer while set, making the stale
        # window impossible rather than rare
        self.staging = False
        self.rounds = 0
        self.offset = offset
        self.length = 0
        self.total = 0
        self.dtype = np.dtype(np.float32)
        # fp32 master weights for multi-precision training (reference:
        # kSetMultiPrecision + CreateMultiPrecisionCopies,
        # kvstore_dist_server.h:50,324): created lazily at the first
        # update after the flag lands on a non-fp32 key
        self.master: Optional[np.ndarray] = None
        self.elems_received = 0
        self.init_elems = 0
        self.fwd_parts: Dict[int, np.ndarray] = {}
        self.fwd_expected = 0
        self.fwd_acks_left = 0
        # lo -> (wire_val, aux, compr) for the CURRENT cycle's forward.
        # Compression (BSC momentum/residual) destructively updates its
        # state, so a WAN retry must resend the SAME wire payload — a
        # recompress would double-count the gradient and lose the first
        # selection's mass
        self.fwd_wire: Dict[int, tuple] = {}
        self.version = 0
        # id of the CURRENT forward/pull-back cycle. Every global-tier
        # callback (push ack, pull data, TS model) carries the cycle it was
        # issued for and is DISCARDED if the state has moved on — a stale
        # init-time pull-back can otherwise complete a newer training round
        # and release its deferred acks early (the root cause of a
        # flake: init's _global_pull response, buffered at the
        # global server until the master's init, arrived after this
        # party's workers had already pushed a full training round)
        self.cycle = 0
        self.central_pushes = 0
        # gradient pushes that raced ahead of initialization (replayed)
        self.pre_init_pushes: List = []
        # wire codec the last gradient round's pushes arrived with
        # (quantized combined wire): the WAN forward inherits it when no
        # explicit GEOMX_WIRE_CODEC_WAN override is configured
        self.push_compr = ""
        # (lo, hi, tag) -> (version, wire_vals, aux): per-round response
        # encode cache. Every puller of one round must receive IDENTICAL
        # wire bytes, and a stateful codec (2bit error feedback) must
        # drain its residual exactly once per round — the version stamp
        # invalidates the cache when the store advances
        self.rsp_wire: Dict = {}


@locks.guarded_by("_lock", "_states", "_key_total", "_stops_received",
                  "_stop_forwarded", "_gb_reqs", "_party_nsrv_by_sender")
class KVStoreDistServer:
    """Runs in every DMLC_ROLE=server process (global server included)."""

    def __init__(self, cfg: Optional[cfg_mod.Config] = None):
        self.cfg = cfg or cfg_mod.load()
        c = self.cfg
        if c.p3_slice_bytes < 0:
            # P3_SLICE_BYTES=-1 (auto): resolve against the shape plan
            # exactly like KVStoreDist does — the FSA sub-splits its
            # canonical ranges at this budget, so both wire ends must
            # land on the same value from the same plan
            c = self.cfg = dataclasses.replace(
                c, p3_slice_bytes=slice_bytes_from_shape(c))
        self.is_global_server = c.is_global_server
        # party servers forward to the global tier; the global server IS it
        self.has_global_tier = c.has_global_tier and not self.is_global_server

        self.po_local = Postoffice(
            my_role=Role.SERVER, is_global=False,
            root_uri=c.ps_root_uri, root_port=c.ps_root_port,
            num_workers=c.num_workers, num_servers=c.num_servers, cfg=c,
        )
        self.po_global: Optional[Postoffice] = None
        if c.has_global_tier:
            self.po_global = Postoffice(
                my_role=Role.SERVER if self.is_global_server else Role.WORKER,
                is_global=True,
                root_uri=c.ps_global_root_uri, root_port=c.ps_global_root_port,
                num_workers=c.num_global_workers, num_servers=c.num_global_servers,
                cfg=c,
            )

        # short-lived structural lock (states dict, counters, barriers);
        # data-plane work runs under per-state locks
        self._lock = locks.make_rlock("KVStoreDistServer._lock")
        # build/load the native kernels BEFORE serving traffic: the lazy
        # first-use build (g++, seconds) would otherwise run inside a
        # push handler while holding a key's state lock
        kernels_native.lib()
        self._states: Dict[Tuple[int, int], _KeyState] = {}
        self._key_total: Dict[int, int] = {}
        # global-store FSA granularity in ELEMENTS: >0 sub-splits the
        # canonical ranges at the P3 chunk budget so a sliced key's
        # round releases shard by shard (each fine state counts its own
        # parties' pushes) instead of holding every response until the
        # whole key lands. Finalized in start() — TSEngine offers
        # models per canonical shard, so overlays keep coarse states.
        self._fsa_slice_elems = 0
        self.sync_mode = True
        # False by default (reference: kvstore_dist_server.h:2019); set by the
        # master worker's kSyncGlobalMode command for "dist_sync" only —
        # "dist_async" leaves it unset, which IS MixedSync
        self.sync_global_mode = False
        self._stops_received = 0
        self.updater = None            # optimizer; applied on the global store
        self.gc = make_compressor(None)
        # quantized combined wire (compression/device.py): one encode
        # engine holds this server's error-feedback residuals — WAN
        # forwards key them ("fwd", key, lo), response legs ("rsp", key,
        # lo), so the two streams never mix. The optional WAN-only
        # policy override picks the forward codec independently of what
        # the workers pushed with.
        self._wire = WireCodec.from_config(c)
        self._wire_wan = (WireCodec.from_config(c, policy=c.wire_codec_wan)
                          if c.wire_codec_wan else None)
        # self-tuning transport on the WAN leg (GEOMX_TRANSPORT_CONTROLLER;
        # kvstore/controller.py): a party server plans the forward codec
        # per round from its global van's OWN link estimates — the leg
        # where links are genuinely heterogeneous. None when off: the
        # static _wan_wire_tag precedence is untouched.
        self._transport = None
        if c.transport_controller and c.health and self.has_global_tier:
            self._transport = TransportController.for_van(
                self.po_global.van, c, tier="global")
        # fp32 master-weight updates for fp16-stored keys (reference:
        # kSetMultiPrecision, kvstore_dist_server.h:324)
        self.multi_precision = False
        self.use_hfa = c.use_hfa
        self.period_k2 = max(c.hfa_k2, 1)
        self._stop = threading.Event()
        self._stop_forwarded = False
        # requests can arrive on the local tier while the global tier is
        # still starting (the local startup barrier releases workers first);
        # handlers block on this gate until start() completes
        self._ready = threading.Event()

        self.server_local: Optional[KVServer] = None
        self.server_global: Optional[KVServer] = None
        self.worker_global: Optional[KVWorker] = None
        # lazily-created command-rebroadcast client (customer_id=2); must be
        # initialized here — reading it uninitialized in the handler thread
        # swallows the ack and deadlocks every kv.create
        self._cmd_kvw: Optional[KVWorker] = None

        # TSEngine endpoints (reference: ENABLE_INTRA_TS / ENABLE_INTER_TS)
        self.ts_local = None     # model dissemination to local workers
        self.ts_global = None    # global-tier overlay (party/global server)
        self._ts_kvw_local: Optional[KVWorker] = None
        self._ts_kvw_global: Optional[KVWorker] = None
        # party-server: per (key, slice-offset) global round counter
        self._g_rounds: Dict[Tuple[int, int], int] = {}
        # per-transport-thread forward collector (batched WAN hop)
        self._fwd_tls = threading.local()
        # trace context of the most recent traced worker push (round id,
        # origin rank): stamped onto the WAN forwards so the merged
        # trace follows one round across both tiers. Last-writer-wins is
        # fine — all messages of one round carry the same round id, and
        # an overlapping round mislabels at most its neighbor's frames.
        self._wan_trace: Tuple[int, int] = (-1, -1)
        # ESync state server (Command.ESYNC_STATE; geomx_tpu_torch.esync) —
        # constructed eagerly: lazy init would be a check-then-set race
        # across per-connection reader threads
        from geomx_tpu_torch.esync import ESyncStateServer

        self._esync = ESyncStateServer()
        # global-server: party size per global-worker sender, for FSA round
        # counting + uniformity validation
        self._party_nsrv = 1
        self._party_nsrv_by_sender: Dict[int, int] = {}
        # durable recovery: periodic snapshots + peer replicas; a
        # FaultPlan-induced van crash sets _crashed so shutdown skips
        # the exit barrier (survivors aren't waiting for a dead node)
        from geomx_tpu_torch.kvstore.replication import ReplicationManager

        self.replication = ReplicationManager(self, c)
        self._crashed = False

    # ------------------------------------------------------------------
    # lifecycle (reference: kvstore_dist.h:237-258 RunServer)
    # ------------------------------------------------------------------

    def start(self, timeout: float = 120.0) -> None:
        self.po_local.start(timeout)
        # elastic membership: epoch bumps re-check every pending
        # aggregation countdown, and esync's reporter window tracks the
        # same live view the countdowns use
        self.po_local.add_membership_listener(self._on_membership)
        self._esync.live_fn = self.po_local.live_worker_ids
        self.server_local = KVServer(self.po_local)
        self.server_local.set_request_handle(
            lambda req, kvs, srv: self._handle(req, kvs, srv, global_tier=False))
        if self.cfg.enable_intra_ts:
            # model dissemination to this party's workers (reference:
            # DefaultAutoPull, kvstore_dist_server.h:1372); a dedicated
            # KVWorker (customer_id=1) carries the model hops
            from geomx_tpu_torch.ps.tsengine import TSNode

            self._ts_kvw_local = KVWorker(self.po_local, customer_id=1)
            # live view, not the static worker count: a contributor that
            # dies mid-round must shrink the merge target or the round
            # never reaches tgt (GX-P305)
            self.ts_local = TSNode(self.po_local, self._ts_kvw_local,
                                   tgt_merge=self.po_local.num_live_workers)
        # startup barrier, local tier (reference: kvstore_dist.h:246);
        # a recovering server skips it — survivors won't re-join
        # (reference: kvstore_dist.h:63 via is_recovery)
        if not self.po_local.van.is_recovery:
            self.po_local.barrier(psbase.ALL_GROUP,
                                  timeout=self.cfg.barrier_timeout_s)
        if self.po_global is not None:
            if self.is_global_server:
                # align this process's GLOBAL server rank with its
                # central-party LOCAL rank: the master worker's init
                # shards are routed by local rank, and the canonical
                # range owner is identified by global rank — MultiGPS
                # breaks unless they name the same process
                self.po_global.van.sort_key = self.po_local.my_rank
            self.po_global.start(timeout)
            self.po_global.add_membership_listener(self._on_membership)
            if self.is_global_server:
                self.server_global = KVServer(self.po_global)
                self.server_global.set_request_handle(
                    lambda req, kvs, srv: self._handle(req, kvs, srv,
                                                       global_tier=True))
                if self.cfg.enable_inter_ts:
                    from geomx_tpu_torch.ps.tsengine import TSNode

                    self._ts_kvw_global = KVWorker(self.po_global,
                                                   customer_id=1)
                    self.ts_global = TSNode(
                        self.po_global, self._ts_kvw_global,
                        tgt_merge=self._num_parties)
            else:
                self.worker_global = KVWorker(self.po_global)
                if self.cfg.enable_inter_ts:
                    from geomx_tpu_torch.ps.tsengine import TSNode

                    self.ts_global = TSNode(
                        self.po_global, self.worker_global,
                        tgt_merge=self._num_parties,
                        final_push=self._ts_global_final_push)
                    # TS relay/model hops first; everything else falls
                    # through to the command handler
                    self.worker_global.set_request_handle(
                        lambda req, kvs, srv:
                        self.ts_global.handle_request(req, kvs, srv)
                        or self._handle(req, kvs, srv, global_tier=True))
                else:
                    # config commands re-broadcast by the global server
                    # arrive on the global overlay (reference:
                    # kvstore_dist_server.h:311-318)
                    self.worker_global.set_request_handle(
                        lambda req, kvs, srv: self._handle(req, kvs, srv,
                                                           global_tier=True))
        if self.po_global is not None and not self.po_global.van.is_recovery:
            # startup barrier, global tier (reference: kvstore_dist.h:249-251);
            # gated like the local one — a recovering server must not wait
            # for a barrier round the survivors already passed
            self.po_global.barrier(psbase.ALL_GROUP,
                                   timeout=self.cfg.barrier_timeout_s)
        # a FaultPlan crash primitive stops the van; propagate to the
        # server loop so run() exits and shutdown skips dead barriers
        self.po_local.van.on_crash = self._on_van_crash
        if self.po_global is not None:
            self.po_global.van.on_crash = self._on_van_crash
        if (self.po_local.van.is_recovery
                or (self.po_global is not None
                    and self.po_global.van.is_recovery)):
            # repopulate from snapshot/replica BEFORE serving any request:
            # resumed training must observe pre-crash weights, not re-init
            self.replication.restore()
        self.replication.start()
        # fine-grained FSA states: only with a P3 chunk budget and no
        # TSEngine (overlays offer models per canonical shard — fine
        # states would fragment the offers). Fixed here, before _ready
        # releases the first request, because the per-(key, offset)
        # states pin to whatever granularity the first contact sees.
        if self.cfg.p3_slice_bytes > 0 and self.ts_global is None \
                and self.ts_local is None:
            self._fsa_slice_elems = max(1, self.cfg.p3_slice_bytes // 4)
        self._ready.set()

    def run(self) -> None:
        """Blocking server loop (reference: kvstore_dist_server.h:114-130)."""
        self.start()
        while not self._stop.wait(0.2):
            pass
        self.shutdown()

    def shutdown(self) -> None:
        # clean exit flushes a final snapshot; after a crash the point is
        # to test recovery from the last PERIODIC tick, and the vans are
        # already dead, so skip both the flush and the exit barriers
        self.replication.stop(flush=not self._crashed)
        try:
            self.po_local.finalize(do_barrier=not self._crashed)
        finally:
            if self.po_global is not None:
                self.po_global.finalize(do_barrier=not self._crashed)

    def crash(self) -> None:
        """Hard-kill this server as a fault would: stop both vans NOW, no
        exit barriers, no final snapshot flush. Tests use this (directly
        or via the FaultPlan crash primitive) to simulate a server death
        that a replacement with ``is_recovery=True`` then recovers from."""
        self._crashed = True
        self._stop.set()
        self.po_local.van.stop()
        if self.po_global is not None:
            self.po_global.van.stop()

    def _on_van_crash(self) -> None:
        # called by the van after a FaultPlan "crash" rule fired (the van
        # itself is already stopped; crash() re-stopping it is a no-op)
        self.crash()

    def _on_membership(self, epoch: int, dead: frozenset) -> None:
        """Membership epoch bump (the scheduler declared nodes dead):
        rounds mid-flight may now be complete — the corpse's push is
        never coming — so re-run every pending countdown against the
        LIVE view and release what finishes (the elastic-membership
        round release). Runs on a van thread; acks and WAN forwards
        fire outside the per-state locks like every other handler."""
        with self._lock:
            items = list(self._states.items())
        acts: List[Action] = []
        released = 0
        for (key, _off), st in items:
            with st.lock:
                if self.is_global_server:
                    # FSA store: every state on a global server
                    if (st.initialized and st.merged is not None
                            and st.elems_received > 0
                            and st.elems_received
                            >= self._expected_global_elems(st)):
                        acts += self._complete_fsa_round(st, key)
                        released += 1
                elif (st.stored is not None and st.push_reqs
                        and not st.staging
                        and len(st.push_reqs)
                        >= self._expected_local_pushes()):
                    acts += self._complete_local_round(st, key)
                    released += 1
        if released:
            log.warning("membership epoch %d (dead=%s): released %d "
                        "stalled aggregation round(s)", epoch,
                        sorted(dead), released)
            telemetry.event("membership.rounds_released",
                            cat="membership", epoch=epoch, n=released)
            telemetry.counter_inc("membership.rounds_released", released)
        for fn in acts:
            fn()
        # the cross-party worker barrier may be satisfied now too
        self._recheck_global_barrier()
        # and the stop countdown (a dead global worker's cascaded stop
        # never arrives)
        if self.is_global_server:
            with self._lock:
                n_gw = (self.po_global.num_live_workers()
                        if self.po_global else 0)
                done = (self._stops_received > 0
                        and self._stops_received >= max(n_gw, 1))
            if done:
                self._stop.set()

    # ------------------------------------------------------------------
    # request entry (reference: DataHandleEx, kvstore_dist_server.h:432)
    # ------------------------------------------------------------------

    def _handle(self, req: ReqMeta, kvs: KVPairs, srv: KVServer,
                global_tier: bool) -> None:
        if not self._ready.is_set():
            self._ready.wait(self.cfg.barrier_timeout_s)
        if req.simple_app:
            self._handle_command(req, srv, global_tier)
            return
        global_store = self.is_global_server or global_tier
        if profiler.is_running():
            tag = ("server.push" if req.push else "server.pull") + (
                ".global" if global_tier else "")
            with profiler.scope(tag, cat="kvstore"):
                self._handle_data(req, kvs, srv, global_store, global_tier)
            return
        self._handle_data(req, kvs, srv, global_store, global_tier)

    def _handle_data(self, req: ReqMeta, kvs: KVPairs, srv: KVServer,
                     global_store: bool, global_tier: bool) -> None:
        if req.push and not req.simple_app:
            # zombie fencing: a push from a sender this tier has declared
            # dead — or one stamped with the sender's pre-rejoin epoch —
            # must never aggregate (it would double-count against the
            # live round sized without it). Dropped WITHOUT an ack: the
            # corpse's resender gives up on its own, and a rejoined
            # sender's fresh pushes carry the new epoch and pass.
            van = (self.po_global.van
                   if global_tier and self.po_global is not None
                   else self.po_local.van)
            if van.is_stale(req.sender, req.epoch):
                log.warning("dropping stale push from node %d "
                            "(epoch %d, membership epoch %d)",
                            req.sender, req.epoch, van.membership_epoch)
                telemetry.event("membership.stale_push_dropped",
                                cat="membership", sender=req.sender,
                                epoch=req.epoch)
                telemetry.counter_inc("membership.stale_pushes_dropped")
                return
            if not global_tier and req.trace_round >= 0:
                self._wan_trace = (req.trace_round, req.trace_origin)
        acts: List[Action] = []
        if len(kvs.keys) > 1:
            # multi-key request: N independent per-key machines each ack
            # once; the transport allows one response per message, so a
            # countdown proxy merges them (see _BatchResponder)
            srv = _BatchResponder(srv, len(kvs.keys))
        # a multi-key worker push that completes rounds for many keys at
        # once would fan out per-key WAN messages; collect the forwards
        # issued while running the actions and coalesce them into ONE
        # global push per (server, compression) instead (the 10-key layout spent 80 of its 88 messages/round on
        # the per-key server->global hop)
        collect = (req.push and not global_store and len(kvs.keys) > 1
                   and self.has_global_tier
                   and self.worker_global is not None
                   and not (self.ts_global is not None
                            and self.sync_global_mode))
        if collect:
            self._fwd_tls.entries = entries = []
        # per-operator engine tags (reference: PROFILER_MESSAGE_FUNCNAME
        # op tagging in the server handler, kvstore_dist_server.h:570):
        # when the profiler runs, each key's state-machine step records
        # its own span so a trace shows WHICH key dominated the round
        tagging = profiler.is_running()
        for i, key in enumerate(kvs.keys):
            off = kvs.offset_of(i)
            total = kvs.total_of(i)
            # a real `with` (not a bare __enter__/__exit__ pair): a raise
            # in key handling must still close the span, or the profiler
            # trace shows a span covering every later request
            _tag = profiler.scope(
                f"{'push' if req.push else 'pull'}:key{key}",
                cat="kvstore.op", offset=off) if tagging else _null_ctx()
            with _tag:
                self._handle_one_key(req, kvs, srv, global_store,
                                     global_tier, acts, i, key, off,
                                     total, tagging)
        if collect:
            try:
                for fn in acts:
                    fn()
            finally:
                self._fwd_tls.entries = None
            if entries:
                self._flush_forward_batch(entries)
        else:
            for fn in acts:
                fn()
        if telemetry.enabled():
            # aggregation queue depth: key states still holding queued
            # pushes (lock-free reads — a gauge tolerates a torn glance)
            with self._lock:
                states = list(self._states.values())
            depth = sum(1 for st in states
                        if st.push_reqs or st.staging)
            telemetry.gauge_set("server.agg_pending", depth,
                                tier="global" if global_tier else "local")

    def _handle_one_key(self, req, kvs, srv, global_store, global_tier,
                        acts, i, key, off, total, tagging) -> None:
        """One (key, shard-offset) entry of a data request (the loop body
        of :meth:`_handle_data`)."""
        if req.push:
            val = np.asarray(kvs.vals[i]).ravel()
            if kvs.compr:
                with profiler.scope(f"decompress:{kvs.compr}",
                                    cat="kvstore.op") if tagging \
                        else _null_ctx():
                    val = self.gc.decompress_push(
                        kvs.compr, val, kvs.aux[i],
                        kvs.len_of(i) or val.size)
            total = total or val.size
            with self._lock:
                self._key_total[key] = max(self._key_total.get(key, 0),
                                           total)
            if global_store:
                acts += self._push_global_store(
                    req, srv, key, off, val, total, global_tier)
            else:
                st = self._state(key, off)
                with st.lock:
                    acts += self._push_local_store(req, srv, key, off,
                                                   val, total,
                                                   wire_compr=kvs.compr)
        elif req.pull:
            length = kvs.len_of(i)
            aux = kvs.aux[i] if i < len(kvs.aux) else None
            if global_store:
                acts += self._pull_global_store(
                    req, srv, key, off, length, total, kvs.compr, aux)
            else:
                st = self._state(key, off)
                with st.lock:
                    acts += self._pull_local_store(req, srv, key, off,
                                                   length, kvs.compr,
                                                   aux)

    # ------------------------------------------------------------------
    # party (intra-DC) server: push (reference: DataHandleSyncDefault)
    # ------------------------------------------------------------------

    def _push_local_store(self, req, srv, key, off, val, total,
                          wire_compr: str = "") -> List[Action]:
        st = self._state(key, off)
        if req.head != DATA_INIT:
            # remember the wire codec this round's gradients travel with
            # (all pushes of one (key, shard) round share the chunk's
            # codec); the WAN forward inherits it when no explicit
            # GEOMX_WIRE_CODEC_WAN policy overrides
            st.push_compr = wire_compr \
                if wire_compr in ("fp16", "2bit", "bsc16") else ""
        if st.stored is None:
            # init-on-first-push (reference: kvstore_dist_server.h:1241);
            # kv.init marks its pushes DATA_INIT — a gradient should never
            # arrive first (workers init+pull before training)
            if req.head != DATA_INIT:
                log.warning("first push for key %d is not an init push", key)
            st.stored = val.copy()
            st.length, st.total = val.size, total
            st.dtype = val.dtype
            if self.has_global_tier:
                # authoritative params live on the global tier: ack the init,
                # then pull them back before serving any local pull
                # (reference: DataPullFromGlobalServersDefault at :1274).
                # This is cycle 1; if a training round overtakes it, the
                # response is discarded by the cycle guard.
                st.cycle += 1
                cyc = st.cycle
                return [lambda: srv.response(req),
                        lambda: self._global_pull(key, off, cyc)]
            st.initialized = True
            return [lambda: srv.response(req)] + self._flush_pulls(st, key)

        if req.head == DATA_INIT:
            # duplicate init (e.g. a recovered rank-0 worker re-running
            # kv.init against a surviving server): ack and ignore — it
            # must NOT be aggregated as a gradient (reference initialized_
            # gate, kvstore_dist_server.h:1241-1262)
            return [lambda: srv.response(req)]

        # aggregate (reference: :1288-1298); the += runs natively (GIL
        # released) when the kernels library is available, so concurrent
        # keys aggregate in parallel under their per-state locks
        if not st.push_reqs:
            st.merged = val.astype(np.float32, copy=True)
        else:
            v32 = np.ascontiguousarray(val, dtype=np.float32)
            if not kernels_native.acc(st.merged, v32):
                st.merged += v32
        st.push_reqs.extend([(req, srv)] * max(req.num_merge, 1))
        if len(st.push_reqs) < self._expected_local_pushes():
            return []
        return self._complete_local_round(st, key)

    def _expected_local_pushes(self) -> int:
        """Local-round countdown target: one push per LIVE worker. Sized
        from the membership view at check time so a worker declared dead
        mid-round stops being waited for — the survivors' pushes release
        the round (elastic membership)."""
        return max(self.po_local.num_live_workers(), 1)

    def _complete_local_round(self, st, key) -> List[Action]:
        """The round-complete tail of :meth:`_push_local_store` (runs
        under ``st.lock``); also invoked by :meth:`_on_membership` when
        an epoch bump shrinks the countdown below what already arrived."""
        off = st.offset
        # round complete (reference: :1324)
        st.rounds += 1
        reqs, st.push_reqs = st.push_reqs, []
        check = getattr(self.po_local.van, "statecheck", None)
        if check is not None:
            # conformance: every aggregated contribution must have
            # passed the is_stale fence (duplicates from num_merge
            # collapse into one (sender, epoch) pair)
            check.on_release(key, {(r.sender, r.epoch) for r, _srv in reqs})

        if not self.has_global_tier:
            # single-tier PS: apply the update here
            st.stored = (self._run_updater(st, (key, off), st.merged)
                         if self.updater else
                         np.asarray(st.merged, dtype=st.dtype).ravel())
            st.initialized = True
            st.version += 1
            return (self._push_round_acks(st, key, reqs)
                    + self._flush_pulls(st, key)
                    + self._offer_local(st, key))

        if self.use_hfa and st.rounds % self.period_k2 != 0:
            # HFA local round: store the averaged weights, ack immediately
            # (reference: :1327-1333)
            st.stored = st.merged.astype(st.dtype)
            st.version += 1
            return (self._push_round_acks(st, key, reqs)
                    + self._flush_pulls(st, key)
                    + self._offer_local(st, key))

        if self.use_hfa:
            # milestone delta (reference: :1334-1338)
            if st.milestone is None:
                st.milestone = st.stored.astype(np.float32, copy=True)
            payload = (st.merged - st.milestone) / max(
                self.po_global.num_live_workers(), 1)
        else:
            payload = st.merged
        # stage the outbound aggregate in its OWN slot (`stored` keeps the
        # last weights; the reference's store_ dual-use at :519 is exactly
        # what let a pull observe the gradient) and open a new cycle; worker
        # acks defer until THIS cycle's pull-back lands fresh params
        st.outbound = payload.astype(st.dtype)
        st.staging = True
        st.cycle += 1
        cyc = st.cycle
        st.deferred_acks = reqs
        return [lambda: self._forward_to_global(key, off, cyc)]

    # ------------------------------------------------------------------
    # global store: push (init / FSA aggregate / MixedSync)
    # ------------------------------------------------------------------

    def _push_global_store(self, req, srv, key, off, val, total,
                           from_global_tier) -> List[Action]:
        hits = []
        for rng in self._canonical_ranges(key, total):
            lo = max(off, rng.offset)
            hi = min(off + val.size, rng.offset + rng.length)
            if lo < hi:
                hits.append((rng, lo, hi))
        if len(hits) > 1:
            # one push entry spanning several fine FSA states (a
            # whole-range init, or a peer chunking coarser than this
            # server): each state acks once — possibly rounds apart —
            # and the transport allows ONE response per request
            srv = _BatchResponder(srv, len(hits))
        acts: List[Action] = []
        touched = bool(hits)
        for rng, lo, hi in hits:
            sub = val[lo - off:hi - off]
            st = self._state(key, rng.offset)
            with st.lock:
                acts += self._global_slice_push(req, srv, key, rng, lo, sub,
                                                total, from_global_tier)
        if not touched:
            log.warning("push key=%d off=%d total=%d missed all canonical "
                        "ranges of global rank %d", key, off, total,
                        self.po_global.my_rank if self.po_global else -1)
            acts.append(lambda: srv.response(req))
        return acts

    def _global_slice_push(self, req, srv, key, rng, lo, sub, total,
                           from_global_tier) -> List[Action]:
        st = self._state(key, rng.offset)
        if st.stored is None:
            st.stored = np.zeros(rng.length, dtype=sub.dtype)
            st.length, st.total = rng.length, total
            st.dtype = sub.dtype

        if not st.initialized:
            if req.head != DATA_INIT:
                # a party's forwarded gradient raced ahead of the master's
                # init: buffer and replay once initialization completes
                # (the reference would mis-store it as init data)
                st.pre_init_pushes.append(
                    (req, srv, rng, lo, sub, total, from_global_tier))
                return []
            # initialization pushes fill the canonical range (master worker's
            # init; reference: :1241-1262 + initialized_ flag)
            st.stored[lo - rng.offset:lo - rng.offset + sub.size] = sub
            st.init_elems += sub.size
            acts: List[Action] = [lambda: srv.response(req)]
            if st.init_elems >= st.length:
                st.initialized = True
                acts += self._flush_pulls(st, key)
                replay, st.pre_init_pushes = st.pre_init_pushes, []
                for r, s, rg, l, sb, t, fg in replay:
                    acts += self._global_slice_push(r, s, key, rg, l, sb, t, fg)
            return acts
        if req.head == DATA_INIT:
            # late/duplicate init (other parties' rank-0 workers): ignore
            return [lambda: srv.response(req)]

        if not from_global_tier and not self.cfg.enable_central_worker:
            # central-worker gradients ignored (reference: :1281); unlike the
            # reference we still ack so the pusher never hangs. With
            # intra-TS the ignoring must still disseminate the CURRENT
            # params, or the pusher's auto_pull would wait forever — the
            # monotonic counter over-advances past any worker's push count,
            # which auto_pull's >= comparison tolerates. A combined
            # push+pull still gets the CURRENT params in its ack —
            # an empty ack would let the client zero its buffers
            if req.pull:
                acts = [self._pull_response_action(
                    st, req, srv, key, lo, sub.size,
                    self._ack_tag(req, sub.size, wan=True))]
            else:
                acts = [lambda: srv.response(req)]
            if self.ts_local is not None:
                st.central_pushes += 1
                data, total = st.stored.copy(), st.total
                o, v = st.offset, st.rounds + st.central_pushes
                acts.append(lambda: self.ts_local.offer_model(
                    key, o, total, data, v))
            return acts

        if not self.sync_global_mode:
            # MixedSync: update per arriving push, no barrier (reference:
            # DataHandleAsyncDefault :1532)
            grad = np.zeros(st.length, dtype=np.float32)
            grad[lo - rng.offset:lo - rng.offset + sub.size] = sub
            st.stored = (self._run_updater(st, (key, rng.offset), grad)
                         if self.updater else st.stored)
            st.version += 1
            if req.pull:
                # combined push+pull: the ack carries fresh params for
                # the pushed slice, halving WAN round-trips (batched
                # forward wire)
                acts = [self._pull_response_action(
                    st, req, srv, key, lo, sub.size,
                    self._ack_tag(req, sub.size, wan=True))]
            else:
                acts = [lambda: srv.response(req)]
            if self.ts_local is not None:
                # MixedSync + intra-TS: st.version counts every arriving
                # push, so it is >= any one worker's push count and
                # satisfies their auto_pull version waits
                data, total, o, v = (st.stored.copy(), st.total,
                                     st.offset, st.version)
                acts.append(lambda: self.ts_local.offer_model(
                    key, o, total, data, v))
            return acts

        # FSA: element-counted aggregation. Each PARTY covers the canonical
        # range exactly once per round across its local servers (a party's
        # servers partition the key), and each enabled central worker covers
        # it once — so the round completes at
        #   length x (num_parties + central_workers)
        # elements, with num_parties = num_global_workers / party servers
        # (uniform party sizes — true of every reference topology; this
        # generalizes the reference's aligned-wire-key counting,
        # kvstore_dist_server.h:1305-1319, which deadlocks for multi-server
        # parties).
        if st.merged is None:
            st.merged = np.zeros(st.length, dtype=np.float32)
            st.elems_received = 0
        seg = st.merged[lo - rng.offset:lo - rng.offset + sub.size]
        sub32 = np.ascontiguousarray(sub, dtype=np.float32)
        if not kernels_native.acc(seg, sub32):
            seg += sub32
        # TSEngine final hops carry num_merge parties' worth of gradient in
        # one push (reference counting: kvstore_dist_server.h:1301)
        st.elems_received += sub.size * max(req.num_merge, 1)
        # the slice is retained so a combined push+pull request can be
        # answered with exactly the range its sender pushed
        st.push_reqs.append((req, srv, lo, lo + sub.size))
        if from_global_tier:
            pn = max(req.party_nsrv, 1)
            with self._lock:
                prev = self._party_nsrv_by_sender.setdefault(req.sender, pn)
            if prev != pn:
                log.error("global worker %d changed party_nsrv %d -> %d "
                          "mid-run; round counting may be wrong",
                          req.sender, prev, pn)
                self._party_nsrv_by_sender[req.sender] = pn
            if (len(set(self._party_nsrv_by_sender.values())) > 1
                    and not self.cfg.num_parties):
                # without an explicit DMLC_NUM_PARTY the formula below
                # must infer the party count from a uniform size;
                # surface violations loudly instead of silently
                # mis-counting
                log.error(
                    "non-uniform party sizes %s: set DMLC_NUM_PARTY for "
                    "exact FSA round counting (inference assumes every "
                    "party runs the same number of local servers)",
                    dict(self._party_nsrv_by_sender))
            self._party_nsrv = pn
        if st.elems_received < self._expected_global_elems(st):
            return []
        return self._complete_fsa_round(st, key)

    def _expected_global_elems(self, st) -> int:
        """FSA countdown target in ELEMENTS, sized from the live
        membership view at check time: a party whose servers are
        declared dead stops being counted, so the surviving parties'
        pushes release the global round. An explicit DMLC_NUM_PARTY
        stays authoritative (the operator pinned the topology)."""
        if self.cfg.num_parties:
            # explicit count: exact for any mix of party sizes — each
            # party covers the canonical range exactly once per round
            n_parties = self.cfg.num_parties
        else:
            n_gw = (max(self.po_global.num_live_workers(), 1)
                    if self.po_global else 1)
            n_parties = max(n_gw // max(self._party_nsrv, 1), 1)
        expected = n_parties
        if self.is_global_server and self.cfg.enable_central_worker:
            expected += self.po_local.num_live_workers()
        return st.length * max(expected, 1)

    def _complete_fsa_round(self, st, key) -> List[Action]:
        """The round-complete tail of :meth:`_global_slice_push` (runs
        under ``st.lock``); also invoked by :meth:`_on_membership` when
        an epoch bump shrinks the countdown below what already arrived."""
        # global round complete: run the optimizer (reference: :1305-1319)
        st.rounds += 1
        st.stored = (self._run_updater(st, (key, st.offset), st.merged)
                     if self.updater else
                     np.asarray(st.merged, dtype=st.dtype).ravel())
        st.merged = None
        st.elems_received = 0
        st.version += 1
        reqs, st.push_reqs = st.push_reqs, []
        acts = []
        for t in self._uniq(reqs):
            r, s = t[0], t[1]
            if r.pull and len(t) >= 4:
                # combined push+pull: serve the fresh params for the
                # pushed slice in the ack (see MixedSync branch)
                acts.append(self._pull_response_action(
                    st, r, s, key, t[2], t[3] - t[2],
                    self._ack_tag(r, t[3] - t[2], wan=True)))
            else:
                acts.append(lambda r=r, s=s: s.response(r))
        acts += self._flush_pulls(st, key)
        if self.ts_global is not None and st.rounds > 0:
            # inter-TS: disseminate fresh params through the overlay
            # instead of waiting for party pulls (AutoPullUpdate1/2,
            # kv_app.h:549-659)
            data, total, o, v = (st.stored.copy(), st.total, st.offset,
                                 st.rounds)
            acts.append(lambda: self.ts_global.offer_model(key, o, total,
                                                           data, v))
        # the global server's OWN local workers (central party) get their
        # models via intra-TS dissemination too
        acts += self._offer_local(st, key)
        return acts


    # ------------------------------------------------------------------
    # pull paths
    # ------------------------------------------------------------------

    def _pull_local_store(self, req, srv, key, off, length: int = 0,
                          req_compr: str = "", aux=None) -> List[Action]:
        # length semantics: dense pulls ask for a range (0 = whole
        # shard, which is what local-tier workers do); row-sparse pulls
        # carry the ROW LENGTH there
        rsp_len = length if req_compr == "rsp" else 0
        st = self._state(key, off)
        if not st.initialized or st.staging:
            # buffered until the in-flight cycle applies fresh params —
            # sync-mode pulls must never be served mid-round (reference
            # buffered-pull semantics, kvstore_dist_server.h:1146-1167).
            # compr/aux are retained: a flushed row-sparse pull must keep
            # its row-gather response format
            st.pending_pulls.append((req, srv, off, rsp_len, req_compr, aux))
            return []
        return [self._pull_response_action(st, req, srv, key, off, rsp_len,
                                           req_compr, aux)]

    def _pull_global_store(self, req, srv, key, off, length, total,
                           req_compr, aux=None) -> List[Action]:
        with self._lock:
            total = total or self._key_total.get(key, 0)
        overlapping = []
        for rng in self._canonical_ranges(key, total):
            req_lo = off
            if req_compr == "rsp":
                req_hi = rng.offset + rng.length  # row gather: whole shard
            else:
                req_hi = off + (length or rng.length + rng.offset - off)
            if req_hi <= rng.offset or req_lo >= rng.offset + rng.length:
                continue
            overlapping.append(rng)
        if not overlapping:
            # a pull outside every canonical range must still be ACKED:
            # silently dropping it parks the requester until its op
            # timeout (the zero-iteration drop GX-P302's lexical pass
            # cannot see — kept fixed by test_pull_missed_range_acks)
            log.warning("pull of key %d [%d:+%d] overlaps no canonical "
                        "range; acking empty", key, off, length or 0)
            return [lambda: srv.response(req)]
        if len(overlapping) > 1:
            # one request gets ONE response: merge the per-range parts
            # exactly like multi-key requests do (the transport tracker
            # fires on the first response, so a second would be lost —
            # and the wire sanitizer counts it as a double ack)
            srv = _BatchResponder(srv, len(overlapping))
        acts: List[Action] = []
        for rng in overlapping:
            st = self._state(key, rng.offset)
            with st.lock:
                if not st.initialized:
                    st.pending_pulls.append((req, srv, off, length,
                                             req_compr, aux))
                    continue
                acts.append(self._pull_response_action(st, req, srv, key, off,
                                                       length, req_compr,
                                                       aux))
        return acts

    def _pull_response_action(self, st: _KeyState, req, srv, key,
                              req_off: int, req_len: int,
                              req_compr: str, aux=None) -> Action:
        """Build the response closure for one pull against state ``st``."""
        if req_compr == "rsp":
            # row-sparse gather (reference: PullRowSparse, kvstore.h:59):
            # aux = row ids, req_len = row length; respond with just those
            # rows + the SERVED ids echoed (out-of-range ids are dropped
            # here rather than crashing the handler — the client errors on
            # the mismatch)
            row_len = max(req_len, 1)
            ids = np.asarray(aux, dtype=np.int64).ravel() \
                if aux is not None else np.zeros(0, np.int64)
            n_rows = st.length // row_len
            ok = (ids >= 0) & (ids < n_rows)
            if not ok.all():
                log.warning("row-sparse pull: dropping %d out-of-range "
                            "row ids (key %d has %d rows)",
                            int((~ok).sum()), key, n_rows)
                ids = ids[ok]
            gathered = st.stored.reshape(n_rows, row_len)[ids] \
                if ids.size else np.zeros((0, row_len), np.float32)
            out = KVPairs(keys=[key], vals=[gathered.ravel().copy()],
                          aux=[ids], offsets=[st.offset],
                          totals=[st.total], lens=[row_len], compr="rsp")
            return lambda: srv.response(req, out)
        if req_len:
            lo = max(req_off, st.offset)
            hi = min(req_off + req_len, st.offset + st.length)
        else:
            lo, hi = st.offset, st.offset + st.length
        data = st.stored[lo - st.offset:hi - st.offset]
        if req_compr == "bsc":
            if self.updater is not None:
                # BSC pull-compression assumes the store holds a SPARSE
                # gradient aggregate (no server-side optimizer — reference
                # cnn_bsc.py uses a local Trainer); with an updater the
                # store is dense weights and the non-zero filter would
                # truncate them. Serve dense.
                if not getattr(self, "_warned_bsc_dense", False):
                    self._warned_bsc_dense = True
                    log.warning("BSC pull-compression disabled: an optimizer "
                                "is set, the store holds dense weights")
                req_compr = ""
            else:
                # Aggregator mode: the store holds the round's aggregated
                # gradient, whose support is bounded by (workers x top-k) —
                # serve its EXACT nonzero set. Divergence from the
                # reference's BSCPullCompress capacity cap
                # (gradient_compression.cc:271: threshold*multiplier,
                # truncating beyond it): our wire carries variable-length
                # (values, indices), so the lossless superset costs the
                # same protocol and never drops aggregate entries. Works
                # with or without a compressor configured.
                nz = np.nonzero(data)[0]
                out = KVPairs(keys=[key],
                              vals=[data[nz].astype(np.float32)],
                              aux=[nz.astype(np.int32)], offsets=[lo],
                              totals=[st.total], lens=[hi - lo],
                              compr="bsc")
                return lambda: srv.response(req, out)
        if req_compr == "bsc16":
            # quantized combined wire: the "bsc" exact-nonzeros response
            # with float16 values. Same dense-downgrade rule: an updater
            # means the store holds dense weights, where the non-zero
            # filter truncates — serve dense fp16 instead (still narrow)
            if self.updater is not None:
                req_compr = "fp16"
            else:
                nz = np.nonzero(data)[0]
                out = KVPairs(keys=[key],
                              vals=[data[nz].astype(np.float16)],
                              aux=[nz.astype(np.int32)], offsets=[lo],
                              totals=[st.total], lens=[hi - lo],
                              compr="bsc16")
                return lambda: srv.response(req, out)
        if req_compr == "2bit":
            # threshold codes carry GRADIENT sign/magnitude with error
            # feedback; against an updater's dense weights they would
            # replace every parameter with +-threshold — downgrade to
            # the half-width cast (mirrors the BSC dense-downgrade)
            if self.updater is not None:
                req_compr = "fp16"
            else:
                payload, thr_aux = self._rsp_wire(st, key, lo, hi, "2bit")
                out = KVPairs(keys=[key], vals=[payload], aux=[thr_aux],
                              offsets=[lo], totals=[st.total],
                              lens=[hi - lo], compr="2bit")
                return lambda: srv.response(req, out)
        if req_compr:
            # pull-side compression on the WAN hop (reference:
            # DefaultStorageResponse BSC branch, :1190-1210)
            payload, aux = self.gc.compress_pull(
                req_compr, data, self._pull_compress_factor())
            out = KVPairs(keys=[key], vals=[payload], aux=[aux],
                          offsets=[lo], totals=[st.total],
                          lens=[hi - lo], compr=req_compr)
        else:
            out = KVPairs(keys=[key], vals=[data.copy()], offsets=[lo],
                          totals=[st.total], lens=[hi - lo])
        return lambda: srv.response(req, out)

    def _run_updater(self, st: _KeyState, key_off, grad) -> np.ndarray:
        """Apply the optimizer to this key's weights, returning the new
        stored value in the key's wire dtype.

        Multi-precision (reference: kSetMultiPrecision +
        CreateMultiPrecisionCopies, kvstore_dist_server.h:50,324): when
        the flag is on and the key is stored below fp32 (fp16 models,
        examples/cnn_fp16.py), the optimizer runs against a PERSISTENT
        fp32 master copy — repeated fp16 round-trips would otherwise
        swallow small updates (lr * g below the fp16 ulp of the weight).
        """
        assert self.updater is not None, \
            "_run_updater requires an optimizer; aggregator-mode " \
            "fallbacks are per-site (merged aggregate vs kept weights)"
        if profiler.is_running():
            with profiler.scope(f"update:key{key_off[0]}",
                                cat="kvstore.op"):
                return self._run_updater_inner(st, key_off, grad)
        return self._run_updater_inner(st, key_off, grad)

    def _run_updater_inner(self, st: _KeyState, key_off, grad) -> np.ndarray:
        if self.multi_precision and st.dtype != np.float32:
            if st.master is None or st.master.size != st.length:
                st.master = st.stored.astype(np.float32).ravel()
            st.master = np.asarray(
                self.updater(key_off, grad, st.master),
                dtype=np.float32).ravel()
            return st.master.astype(st.dtype)
        return np.asarray(self.updater(key_off, grad, st.stored),
                          dtype=st.dtype).ravel()

    def _pull_compress_factor(self) -> int:
        return max(self.po_global.num_live_workers()
                   if self.po_global else 1, 1)

    def _rsp_wire(self, st: _KeyState, key: int, lo: int, hi: int,
                  tag: str):
        """Encode (and cache) one response range with a stateful wire
        codec. Runs under ``st.lock`` (every _pull_response_action call
        site holds it): all pullers of one round get IDENTICAL bytes and
        the ("rsp", key, lo) error-feedback residual drains exactly once
        per store version."""
        ck = (lo, hi, tag)
        cached = st.rsp_wire.get(ck)
        if cached is None or cached[0] != st.version:
            wv, aux, _t = self._wire.encode(
                tag, st.stored[lo - st.offset:hi - st.offset],
                ("rsp", key, lo))
            cached = st.rsp_wire[ck] = (st.version, wv, aux)
        return cached[1], cached[2]

    def _ack_tag(self, r: ReqMeta, n: int, wan: bool = False) -> str:
        """Wire tag for a combined push+pull ack: echo the requester's
        codec — the quantized combined wire narrows BOTH directions —
        downgraded when an updater means the response carries dense
        WEIGHTS (threshold codes destroy them, sparse filters truncate).
        Falls back to the configured compressor's pull tag on the WAN
        tier and to raw on the LAN tier (its pre-wire behavior)."""
        c = r.compr
        if c in ("fp16", "2bit", "bsc", "bsc16"):
            if self.updater is not None:
                return "" if c == "bsc" else "fp16"
            return c
        return self.gc.pull_compr_tag(n) if wan else ""

    def _push_round_acks(self, st: _KeyState, key: int,
                         reqs) -> List[Action]:
        """Ack a completed local round's pushes. A combined push+pull
        request (reference: ZPushPull, kv_app.h:140) gets the fresh
        post-round state in its ack — one message instead of a separate
        pull round-trip; BSC pushers get the aggregate's exact nonzeros
        (their pull wire format). Plain pushes get the empty ack."""
        acts: List[Action] = []
        for t in self._uniq(reqs):
            r, s = t[0], t[1]
            if r.pull:
                acts.append(self._pull_response_action(
                    st, r, s, key, st.offset, 0,
                    self._ack_tag(r, st.length)))
            else:
                acts.append(lambda r=r, s=s: s.response(r))
        return acts

    def _flush_pulls(self, st: _KeyState, key: int) -> List[Action]:
        acts = []
        pulls, st.pending_pulls = st.pending_pulls, []
        for req, srv, off, length, compr, aux in pulls:
            # dense flushes drop pull-compression (the fresh store holds
            # weights); row-sparse keeps its format, and "bsc" keeps its
            # sparse response (it self-downgrades to dense in
            # _pull_response_action when an updater holds dense weights)
            acts.append(self._pull_response_action(
                st, req, srv, key, off, length,
                compr if compr in ("rsp", "bsc", "bsc16") else "", aux))
        return acts

    # ------------------------------------------------------------------
    # party server -> global tier forwarding
    # (reference: DataPushToGlobalServers* :745-830, push-ack counting
    #  :936-950, pull-back assembly :952-1167)
    # ------------------------------------------------------------------

    def _wan_wire_tag(self, st: _KeyState, n: int) -> str:
        """Wire codec for one forwarded slice of ``n`` elements: an
        explicit GEOMX_WIRE_CODEC_WAN policy wins (operator intent),
        else the transport controller's live per-link plan (once it has
        measured evidence), else the forward inherits the codec the
        workers pushed this round with, else the party's own
        GEOMX_WIRE_CODEC routes by size. "" = leave the hop to the
        configured gradient compressor."""
        if self._wire_wan is not None:
            return self._wire_wan.resolve(n)
        if self._transport is not None:
            tag = self._transport.wan_tag(n)
            if tag is not None:
                return tag
        if st.push_compr:
            return st.push_compr
        if self._wire.enabled():
            return self._wire.resolve(n)
        return ""

    def _wan_compress(self, st: _KeyState, key: int, lo: int,
                      sub: np.ndarray):
        """Compress one WAN-forward slice -> (wire_val, aux, compr).

        The configured compressor still runs first so BSC momentum /
        selection state advances exactly as before; an active wire
        codec then narrows a sparse payload's values to fp16 ("bsc16")
        or, when the compressor was a no-op, packs the slice itself
        (fp16 / 2bit with the ("fwd", key, lo) residual). Callers cache
        the result in ``st.fwd_wire`` — a WAN retry must resend the
        SAME bytes, never re-encode."""
        tag = self._wan_wire_tag(st, int(sub.size))
        if not tag:
            return self.gc.compress_push(sub, (key, lo))
        wv, aux, t = self.gc.compress_push(sub, (key, lo))
        if t == "bsc":
            # keep the selection (its momentum/residual state already
            # advanced); only the values narrow on the wire
            return np.asarray(wv, np.float16), aux, "bsc16"
        if t:
            return wv, aux, t
        if tag in ("bsc", "bsc16"):
            # no sparse selection available for this slice: dense fp16
            tag = "fp16"
        return self._wire.encode(tag, sub, ("fwd", key, lo))

    def _wan_trace_kwargs(self) -> Dict[str, int]:
        """Trace context for WAN re-issues of the current round — the
        forwarded frames inherit the worker push's round id and origin
        rank so trace_merge can stitch the tiers."""
        r, o = self._wan_trace
        return {"trace_round": r, "trace_origin": o}

    def _forward_to_global(self, key: int, off: int, cycle: int) -> None:
        if self.ts_global is not None and self.sync_global_mode:
            self._ts_forward_to_global(key, off, cycle)
            return
        ents = getattr(self._fwd_tls, "entries", None)
        if ents is not None:
            # a batched worker push is running this key's action list —
            # coalesce (see _handle_data / _flush_forward_batch)
            ents.append((key, off, cycle))
            return
        # single-key forward: still a one-item "batch" so the pull-back
        # rides the push ack (pull=True). The legacy per-slice path
        # (_push_slice_global, plain push) costs a SECOND WAN round-trip
        # for the explicit pull — on a shaped 50ms link that extra RTT
        # made lone P3 shard chunks slower pipelined than serial. It
        # remains the retry fallback for undeliverable batches.
        self._flush_forward_batch([(key, off, cycle)])

    def _push_slice_global(self, key, off, cycle, g_rank, lo, hi,
                           total) -> None:
        st = self._state(key, off)
        with st.lock:
            if st.cycle != cycle or st.outbound is None:
                return
            cached = st.fwd_wire.get(lo)
            if cached is None:
                sub = np.ascontiguousarray(st.outbound[lo - off:hi - off])
                cached = self._wan_compress(st, key, lo, sub)
                st.fwd_wire[lo] = cached
        wire_val, aux, compr = cached
        kvs = KVPairs(keys=[key], vals=[wire_val], aux=[aux],
                      offsets=[lo], totals=[total], lens=[hi - lo],
                      compr=compr)
        self.worker_global.push(
            kvs, g_rank, party_nsrv=self.po_local.num_servers,
            **self._wan_trace_kwargs(),
            cb=lambda ts, k=key, o=off, c=cycle, g=g_rank, l=lo, h=hi,
            t=total: self._on_global_push_ack(k, o, c, g, l, h, t, ts))

    # -- batched WAN hop ----------------------------------------------
    #
    # One worker-side batched push completes the round for MANY keys in
    # one _handle_data call; forwarding each per-key (push + ack + pull
    # + resp, per slice) made the two-tier round cost 80 messages at the
    # 10-key layout. These methods coalesce the staged forwards into one
    # multi-key global push per (global server, compression tag), one
    # merged ack back (the global tier's _BatchResponder), one multi-key
    # pull, one merged response. Per-key state machines, cycle guards,
    # and the fwd_wire retry cache are untouched — failures fall back to
    # the per-slice retry path, which revalidates cycles individually.
    # (Reference bar: the engine-async C++ path the 25k img/s estimate
    # assumes, kvstore_dist.h:567-618, which likewise amortizes per-key
    # overheads across the send queue.)

    def _flush_forward_batch(self, entries) -> None:
        if self._transport is not None:
            # refresh the transport plan once per WAN round (idempotent
            # per round) so _wan_wire_tag sees the freshest decisions
            self._transport.plan(self._wan_trace[0])
        per_rank: Dict[Tuple[int, str], List[tuple]] = {}
        for key, off, cycle in entries:
            st = self._state(key, off)
            with st.lock:
                if st.cycle != cycle or st.outbound is None:
                    continue
                slices = self._global_slices(key, off, st.length, st.total)
                st.fwd_acks_left = len(slices)
                # the pull-back rides the push ack (pull=True below), so
                # the response accounting starts at push time
                st.fwd_expected = len(slices)
                st.fwd_parts = {}
                st.fwd_wire = {}
                total = st.total
                for g_rank, lo, hi in slices:
                    sub = np.ascontiguousarray(st.outbound[lo - off:hi - off])
                    cached = self._wan_compress(st, key, lo, sub)
                    st.fwd_wire[lo] = cached
                    wire_val, aux, compr = cached
                    per_rank.setdefault((g_rank, compr), []).append(
                        (key, off, cycle, lo, hi, total, wire_val, aux))
        for (g_rank, compr), items in per_rank.items():
            kvs = KVPairs(
                keys=[it[0] for it in items],
                vals=[it[6] for it in items],
                aux=[it[7] for it in items],
                offsets=[it[3] for it in items],
                totals=[it[5] for it in items],
                lens=[it[4] - it[3] for it in items],
                compr=compr)
            self.worker_global.push(
                kvs, g_rank, party_nsrv=self.po_local.num_servers,
                pull=True, **self._wan_trace_kwargs(),
                cb=lambda ts, its=items, g=g_rank:
                    self._on_global_push_ack_batch(its, g, ts))

    def _on_global_push_ack_batch(self, items, g_rank, ts) -> None:
        fail = self.worker_global.take_failure(ts)
        if fail is not None:
            # WAN batch undeliverable: drop to the per-slice retry path
            # (it revalidates each key's cycle and resends the SAME
            # cached fwd_wire payload — see _KeyState.fwd_wire)
            log.error("batched global push of %d keys undeliverable "
                      "(%s); retrying per-slice in 1s", len(items), fail)
            for key, off, cycle, lo, hi, total, _v, _a in items:
                self._retry_later(self._push_slice_global, key, off,
                                  cycle, g_rank, lo, hi, total)
            return
        # fresh params ride the ack (combined push+pull): apply each
        # key's slice FIRST, then decrement the ack counters — at the
        # final decrement every other rank's callback has already
        # applied its part, so completion sees the full set
        resps = self.worker_global.take_response(ts)
        # a key can appear several times in one batch (P3 slicing gives
        # one (key, off) state per slice): route each response entry to
        # every item of that key whose slice range overlaps the data
        by_key: Dict[int, List[tuple]] = {}
        for it in items:
            by_key.setdefault(it[0], []).append(it)
        acts: List[Action] = []
        for kvs in resps:
            for i, k in enumerate(kvs.keys):
                cands = by_key.get(int(k))
                if not cands:
                    continue
                r_off = kvs.offset_of(i)
                match = next((c for c in cands if c[3] == r_off),
                             cands[0])
                data = np.asarray(kvs.vals[i]).ravel()
                if kvs.compr:
                    data = self.gc.decompress_pull(
                        kvs.compr, data, kvs.aux[i],
                        kvs.len_of(i) or match[4] - match[3],
                        self._pull_compress_factor())
                for it in cands:
                    key, off, cycle, lo, hi, total, _v, _a = it
                    lo2 = max(lo, r_off)
                    hi2 = min(hi, r_off + data.size)
                    if hi2 <= lo2:
                        continue
                    st = self._state(key, off)
                    with st.lock:
                        if st.cycle != cycle:
                            continue
                        st.fwd_parts[lo2] = data[lo2 - r_off:hi2 - r_off]
        need_pull = []
        for key, off, cycle, lo, hi, total, _v, _a in items:
            st = self._state(key, off)
            with st.lock:
                if st.cycle != cycle:
                    continue
                st.fwd_acks_left -= 1
                if st.fwd_acks_left != 0:
                    continue
                if (len(st.fwd_parts) >= st.fwd_expected
                        and st.fwd_expected > 0):
                    acts += self._complete_global_round(st, key)
                else:
                    # ack arrived without (all) data — an anomaly with
                    # our server but a legal wire state; fall back to an
                    # explicit batched pull (resets part accounting)
                    need_pull.append((key, off, cycle))
        for fn in acts:
            fn()
        if need_pull:
            self._global_pull_batch(need_pull)

    def _global_pull_batch(self, ready) -> None:
        per_rank: Dict[Tuple[int, str], List[tuple]] = {}
        for key, off, cycle in ready:
            st = self._state(key, off)
            with st.lock:
                if st.cycle != cycle:
                    continue
                slices = self._global_slices(key, off, st.length, st.total)
                st.fwd_expected = len(slices)
                st.fwd_parts = {}
                total = st.total
            for g_rank, lo, hi in slices:
                tag = self.gc.pull_compr_tag(hi - lo)
                per_rank.setdefault((g_rank, tag), []).append(
                    (key, off, cycle, lo, hi, total))
        for (g_rank, tag), items in per_rank.items():
            self.worker_global.pull(
                [it[0] for it in items], g_rank,
                offsets=[it[3] for it in items],
                totals=[it[5] for it in items],
                lens=[it[4] - it[3] for it in items],
                compr=tag, **self._wan_trace_kwargs(),
                cb=lambda ts, its=items, g=g_rank:
                    self._on_global_pull_data_batch(its, g, ts))

    def _on_global_pull_data_batch(self, items, g_rank, ts) -> None:
        fail = self.worker_global.take_failure(ts)
        if fail is not None:
            log.error("batched global pull of %d keys undeliverable "
                      "(%s); retrying per-slice in 1s", len(items), fail)
            for key, off, cycle, lo, hi, total in items:
                self._retry_later(self._pull_slice_global, key, off,
                                  cycle, g_rank, lo, hi, total)
            return
        resps = self.worker_global.take_response(ts)
        # route each response entry to its (key, off) slice; a key can
        # appear several times in one batch (P3 slicing gives one
        # (key, off) state per slice), so match by range overlap
        by_key: Dict[int, List[tuple]] = {}
        for it in items:
            by_key.setdefault(it[0], []).append(it)
        acts: List[Action] = []
        for kvs in resps:
            for i, k in enumerate(kvs.keys):
                cands = by_key.get(int(k))
                if not cands:
                    continue
                r_off = kvs.offset_of(i)
                match = next((c for c in cands if c[3] == r_off),
                             cands[0])
                data = np.asarray(kvs.vals[i]).ravel()
                if kvs.compr:
                    data = self.gc.decompress_pull(
                        kvs.compr, data, kvs.aux[i],
                        kvs.len_of(i) or match[4] - match[3],
                        self._pull_compress_factor())
                for it in cands:
                    key, off, cycle, lo, hi, total = it
                    lo2 = max(lo, r_off)
                    hi2 = min(hi, r_off + data.size)
                    if hi2 <= lo2:
                        continue
                    st = self._state(key, off)
                    with st.lock:
                        if st.cycle != cycle:
                            continue
                        st.fwd_parts[lo2] = data[lo2 - r_off:hi2 - r_off]
                        if (len(st.fwd_parts) >= st.fwd_expected
                                and st.fwd_expected > 0):
                            acts += self._complete_global_round(st, key)
        for fn in acts:
            fn()

    def _ts_forward_to_global(self, key: int, off: int, cycle: int) -> None:
        """Inter-TS: contribute each global slice to the overlay (merged
        party-to-party), watch for the disseminated model (reference: the
        TS_Push / AutoPull2 path)."""
        if self._transport is not None:
            self._transport.plan(self._wan_trace[0])
        st = self._state(key, off)
        with st.lock:
            if st.cycle != cycle:
                return
            payload = st.outbound
            total = st.total
            length = st.length
            ranges = sharding.assign(key, total, self.po_global.num_servers,
                                     self.cfg.bigarray_bound)
            overlaps = []
            for rng in ranges:
                lo = max(off, rng.offset)
                hi = min(off + length, rng.offset + rng.length)
                if lo < hi:
                    overlaps.append((rng, lo, hi))
            v = self._g_rounds[(key, off)] = self._g_rounds.get((key, off),
                                                               0) + 1
            st.fwd_expected = len(overlaps)
            st.fwd_parts = {}
        for rng, lo, hi in overlaps:
            sub = np.ascontiguousarray(payload[lo - off:hi - off])
            # the model comes back as the WHOLE canonical range, relayed to
            # every global worker — watch the range offset, extract overlap
            self.ts_global.when_model(
                key, rng.offset, v,
                lambda k=key, o=off, ro=rng.offset, l=lo, h=hi, c=cycle:
                    self._on_ts_global_model(k, o, ro, l, h, c))
            self.ts_global.contribute(key, lo, total, sub, v)

    def _on_ts_global_model(self, key, off, rng_off, lo, hi, cycle) -> None:
        data = self.ts_global.model_of(key, rng_off)
        acts: List[Action] = []
        st = self._state(key, off)
        with st.lock:
            if st.cycle != cycle:
                return
            if data is not None:
                hi2 = min(hi, rng_off + data.size)
                if hi2 > lo:
                    st.fwd_parts[lo] = data[lo - rng_off:hi2 - rng_off]
            if st.fwd_expected > 0 and len(st.fwd_parts) >= st.fwd_expected:
                acts = self._complete_global_round(st, key)
        for fn in acts:
            fn()

    def _ts_global_final_push(self, key: int, off: int, total: int,
                              arr: np.ndarray, num_merge: int,
                              ver: int) -> None:
        """Terminal inter-TS hop: deliver the party-merged aggregate slice
        to the global server that owns it."""
        for rng in sharding.assign(key, total, self.po_global.num_servers,
                                   self.cfg.bigarray_bound):
            lo = max(off, rng.offset)
            hi = min(off + arr.size, rng.offset + rng.length)
            if lo >= hi:
                continue
            sub = np.ascontiguousarray(arr[lo - off:hi - off])
            # WAN compression still applies on the terminal WAN hop; the
            # peer-to-peer relay hops and the model dissemination travel
            # uncompressed (the reference TSEngine predates compression
            # composition and does the same)
            wire_val, aux, compr = self._wan_compress(
                self._state(key, off), key, lo, sub)
            kvs = KVPairs(keys=[key], vals=[wire_val], aux=[aux],
                          offsets=[lo], totals=[total], lens=[hi - lo],
                          compr=compr)
            self.worker_global.push(
                kvs, rng.server_rank, num_merge=num_merge,
                party_nsrv=self.po_local.num_servers,
                **self._wan_trace_kwargs(),
                cb=lambda _ts: None)

    def _num_parties(self) -> int:
        if self.po_global is None:
            return 1
        spp = max(self.po_local.num_servers, 1)
        n_gw = max(self.po_global.num_live_workers(), 1)
        return max(n_gw // spp, 1)

    @staticmethod
    def _uniq(reqs):
        """Collapse duplicated (req, srv, ...) ack entries: a TSEngine
        final push appears ``num_merge`` times in the round's request
        list but must be acked exactly once. The KVServer identity is
        part of the key — both tiers use the same node-id scheme and
        independent timestamp counters, so (sender, timestamp) alone
        could collapse a local-tier and a global-tier request into one.
        Entries are (req, srv) on the local tier and (req, srv, lo, hi)
        on the global tier (push+pull slice bookkeeping). The slice
        range is part of the key: one multi-entry message can carry
        SEVERAL slices of the same key into one canonical-range state
        (P3 slicing), and each entry owes the message's countdown
        responder its own ack — only same-range entries are true
        duplicates."""
        seen = {}
        for t in reqs:
            r, s = t[0], t[1]
            seen[(r.sender, r.timestamp, r.customer_id, id(s))
                 + tuple(t[2:])] = t
        return list(seen.values())

    def _offer_local(self, st: "_KeyState", key: int) -> List[Action]:
        """Start intra-TS model dissemination for a completed round."""
        if self.ts_local is None or st.rounds <= 0:
            return []
        data, total, o, v = st.stored.copy(), st.total, st.offset, st.rounds
        return [lambda: self.ts_local.offer_model(key, o, total, data, v)]

    def _global_slices(self, key, off, length, total):
        """Overlaps of this server's shard with global canonical ranges."""
        out = []
        for rng in sharding.assign(key, total, self.po_global.num_servers,
                                   self.cfg.bigarray_bound):
            lo = max(off, rng.offset)
            hi = min(off + length, rng.offset + rng.length)
            if lo < hi:
                out.append((rng.server_rank, lo, hi))
        return out

    def _on_global_push_ack(self, key, off, cycle, g_rank, lo, hi, total,
                            ts) -> None:
        fail = self.worker_global.take_failure(ts)
        if fail is not None:
            # the WAN hop gave up (resender retries exhausted). The cycle
            # must not wedge: retry this slice after a backoff — the peer
            # may have recovered (recovery re-assigns its id/address); the
            # cycle guard discards retries of superseded rounds
            log.error("global push of key %d [%d:%d) undeliverable (%s); "
                      "retrying in 1s", key, lo, hi, fail)
            self._retry_later(self._push_slice_global, key, off, cycle,
                              g_rank, lo, hi, total)
            return
        issue = False
        st = self._state(key, off)
        with st.lock:
            if st.cycle != cycle:
                return
            st.fwd_acks_left -= 1
            if st.fwd_acks_left == 0:
                issue = True
        if issue:
            self._global_pull(key, off, cycle)

    def _retry_later(self, fn, *args, delay: float = 1.0) -> None:
        t = threading.Timer(delay, fn, args=args)
        t.daemon = True
        t.start()

    def _global_pull(self, key: int, off: int, cycle: int) -> None:
        st = self._state(key, off)
        with st.lock:
            if st.cycle != cycle:
                return
            slices = self._global_slices(key, off, st.length, st.total)
            st.fwd_expected = len(slices)
            st.fwd_parts = {}
            total = st.total
        for g_rank, lo, hi in slices:
            self._pull_slice_global(key, off, cycle, g_rank, lo, hi, total)

    def _pull_slice_global(self, key, off, cycle, g_rank, lo, hi,
                           total) -> None:
        st = self._state(key, off)
        with st.lock:
            if st.cycle != cycle:
                return
        self.worker_global.pull(
            [key], g_rank, offsets=[lo], totals=[total], lens=[hi - lo],
            compr=self.gc.pull_compr_tag(hi - lo),
            **self._wan_trace_kwargs(),
            cb=lambda ts, k=key, o=off, l=lo, h=hi, c=cycle, g=g_rank,
            t=total: self._on_global_pull_data(k, o, l, h, ts, c, g, t))

    def _on_global_pull_data(self, key, off, lo, hi, ts, cycle, g_rank,
                             total) -> None:
        fail = self.worker_global.take_failure(ts)
        if fail is not None:
            log.error("global pull of key %d [%d:%d) undeliverable (%s); "
                      "retrying in 1s", key, lo, hi, fail)
            self._retry_later(self._pull_slice_global, key, off, cycle,
                              g_rank, lo, hi, total)
            return
        # drain the tracker even when the cycle guard discards the data
        resps = self.worker_global.take_response(ts)
        acts: List[Action] = []
        st = self._state(key, off)
        with st.lock:
            if st.cycle != cycle:
                return
            for kvs in resps:
                for i, _k in enumerate(kvs.keys):
                    data = np.asarray(kvs.vals[i]).ravel()
                    if kvs.compr:
                        data = self.gc.decompress_pull(
                            kvs.compr, data, kvs.aux[i], kvs.len_of(i) or hi - lo,
                            self._pull_compress_factor())
                    r_off = kvs.offset_of(i)
                    lo2 = max(lo, r_off)
                    hi2 = min(hi, r_off + data.size)
                    st.fwd_parts[lo2] = data[lo2 - r_off:hi2 - r_off]
            if len(st.fwd_parts) >= st.fwd_expected and st.fwd_expected > 0:
                acts = self._complete_global_round(st, key)
        for fn in acts:
            fn()

    def _complete_global_round(self, st: _KeyState, key: int) -> List[Action]:
        assembled = np.concatenate(
            [st.fwd_parts[o] for o in sorted(st.fwd_parts)]).astype(np.float32)
        st.fwd_parts = {}
        st.fwd_expected = 0
        if assembled.size != st.length:
            log.warning("assembled %d elems for key %d shard of %d",
                        assembled.size, key, st.length)
        if self.use_hfa and st.milestone is not None:
            # stored = milestone + pulled delta; milestone follows
            # (reference: :993-998)
            st.stored = (st.milestone + assembled).astype(st.dtype)
            st.milestone = st.stored.astype(np.float32, copy=True)
        elif self.use_hfa:
            # first pull-back: milestone is born from the CURRENT stored
            # values; the pulled data is intentionally not applied
            # (reference: :988-992 — CopyFromTo(stored, milestone) only)
            st.milestone = st.stored.astype(np.float32, copy=True)
        else:
            st.stored = assembled.astype(st.dtype)
        st.initialized = True
        st.staging = False
        st.outbound = None
        st.fwd_wire = {}
        st.version += 1
        acks, st.deferred_acks = st.deferred_acks, []
        acts: List[Action] = self._push_round_acks(st, key, acks)
        acts += self._flush_pulls(st, key)
        acts += self._offer_local(st, key)
        return acts

    # ------------------------------------------------------------------
    # command channel (reference: kvstore_dist_server.h:286-430)
    # ------------------------------------------------------------------

    def _handle_command(self, req: ReqMeta, srv: KVServer,
                        global_tier: bool) -> None:
        van = (self.po_global.van
               if global_tier and self.po_global is not None
               else self.po_local.van)
        if van.is_stale(req.sender, req.epoch):
            # zombie/pre-rejoin command: drop WITHOUT ack, mirroring
            # _handle_data's fence. A dead worker's STOP_SERVER must not
            # tick the stop countdown, and its GLOBAL_BARRIER entry
            # would count a worker that is never coming back.
            log.warning("dropping stale command %d from %d (epoch %d)",
                        req.head, req.sender, req.epoch)
            return
        head, body = req.head, req.body
        if head == Command.STOP_SERVER:
            srv.response(req)
            if self.is_global_server:
                # stop only once every global worker has cascaded its stop
                # (reference: kvstore_dist_server.h:290-295)
                with self._lock:
                    self._stops_received += 1
                    n_gw = (self.po_global.num_live_workers()
                            if self.po_global else 0)
                    done = self._stops_received >= max(n_gw, 1)
                if done:
                    self._stop.set()
            else:
                self._cascade_stop()
                self._stop.set()
            return
        if head == Command.GLOBAL_BARRIER:
            self._handle_global_barrier(req, srv)
            return
        if head == Command.ESYNC_STATE:
            # ESync state server (geomx_tpu_torch.esync): hosted on the
            # party's rank-0 PS per the paper's co-located deployment;
            # workers report (tau, c), the response body carries their next
            # local step count
            srv.response(req, body=self._esync.handle(body, req.sender))
            return
        if head == Command.GET_OPTIMIZER_STATES:
            # the LIVE updater runs where updates apply: the GLOBAL tier in
            # HiPS (ApplyUpdates gate, reference kvstore_dist_server.h:512),
            # this server otherwise. A party server answering with its own
            # never-updated copy was a bug: relay
            # to the global servers instead and merge their answers.
            # Response body: JSON {global_server_rank: states_hex, ...}.
            if (self.has_global_tier and not global_tier
                    and self.worker_global is not None):
                srv.response(req, body=json.dumps(
                    self._relay_optimizer_states_get()))
                return
            states_hex = checkpoint.serialize_states(
                self._snapshot_states()).hex()
            rank = (self.po_global.my_rank
                    if self.is_global_server and self.po_global is not None
                    else self.po_local.my_rank)
            srv.response(req, body=json.dumps({str(rank): states_hex}))
            return
        if head == Command.METRICS:
            # this node's telemetry snapshot (worker pull via
            # kv.metrics()); the registry is process-wide, so a server
            # process answers once with both tiers' counters in it
            srv.response(req, body=telemetry.snapshot_json())
            return
        if head == Command.HEALTH:
            # cluster health board (ps/linkstate.py): boards live on the
            # SCHEDULER of each tier, so a server has no board of its
            # own. A party server is the worker's window into the global
            # tier — relay the query to the GLOBAL scheduler and answer
            # with its board JSON; single-tier servers answer empty (the
            # worker already queried its local scheduler directly).
            if (self.has_global_tier and not global_tier
                    and self.worker_global is not None):
                srv.response(req, body=self._relay_health())
                return
            srv.response(req, body="")
            return
        if head == Command.REPLICA_UPDATE:
            # a peer server's snapshot delta (kvstore/replication.py);
            # accumulate it so we can serve that peer's replacement later
            self.replication.accept_replica(body)
            srv.response(req)
            return
        if head == Command.REPLICA_FETCH:
            # a recovering peer asks for its full replica image
            srv.response(req, body=self.replication.serve_replica(body))
            return
        if head == Command.SET_OPTIMIZER_STATES:
            if (self.has_global_tier and not global_tier
                    and self.worker_global is not None):
                # restore must land on the live (global-tier) updater
                self._relay_optimizer_states_set(body)
                srv.response(req)
                return
            per_server = json.loads(body)
            if set(per_server) == {"rank", "states"}:
                # legacy single-server wire shape ({"rank": r, "states": s})
                per_server = {str(per_server["rank"]): per_server["states"]}
            rank = (self.po_global.my_rank
                    if self.is_global_server and self.po_global is not None
                    else self.po_local.my_rank)
            mine = per_server.get(str(rank))
            if mine is not None and self.updater is not None:
                # whole-dict replacement: a single GIL-atomic assignment
                self.updater.set_states(
                    checkpoint.deserialize_states(bytes.fromhex(mine)))
            srv.response(req)
            return
        # apply + rebroadcast BEFORE responding: the master's set_* call
        # returning must establish a happens-before with every server having
        # applied the config — otherwise a worker push racing a
        # fire-and-forget rebroadcast reaches a party server still running
        # the old config (e.g. BSC pushes handled uncompressed)
        try:
            self._apply_config_command(head, body)
            if not global_tier:
                self._rebroadcast_command(head, body)
        finally:
            # the ack must go out even if applying or rebroadcasting the
            # command fails — an unacked command blocks the master worker
            # forever (dist.py wait)
            srv.response(req)

    def _apply_config_command(self, head: int, body: str) -> None:
        if head == Command.SYNC_MODE:
            self.sync_mode = body != "0"
        elif head == Command.SYNC_GLOBAL_MODE:
            self.sync_global_mode = body != "0"
        elif head == Command.CONTROLLER:
            self.updater = _safe_unpickle(bytes.fromhex(body))
        elif head == Command.SET_GRADIENT_COMPRESSION:
            self.gc = make_compressor(json.loads(body))
        elif head == Command.SET_MULTI_PRECISION:
            # idempotent enable (reference only ever turns it on,
            # kvstore_dist_server.h:324-329)
            self.multi_precision = body != "0"
        elif head == Command.SET_PROFILER_PARAMS:
            # workers remotely drive this server's profiler (reference:
            # ProcessServerProfilerCommands, kvstore_dist_server.h:383-430).
            # NOTE: must use the module-level import — handler threads run
            # while the server's main thread is blocked inside
            # ``import geomx_tpu_torch``, so a function-local geomx_tpu_torch import
            # here deadlocks on the package import lock.
            # The prefix must be CLUSTER-unique: every party's server 0
            # shares local rank 0, so in HiPS topologies we use the
            # global-tier node id instead (divergence from the reference's
            # local rank, kvstore_dist_server.h:415, which clobbers files
            # when parties share a filesystem)
            uid = (self.po_global.my_id if self.po_global is not None
                   else self.po_local.my_rank)
            profiler.apply_remote_command(body, uid)

    def _handle_global_barrier(self, req: ReqMeta, srv: KVServer) -> None:
        """Cross-party worker barrier: when all local workers arrived, this
        server joins a global-overlay barrier over every party server and
        global server, then releases its workers. Gives kv.barrier(
        is_global=True) true all-party semantics (the reference's
        kWorkerGroupGlobal barrier, kvstore_dist.h:208-211)."""
        with self._lock:
            if not hasattr(self, "_gb_reqs"):
                self._gb_reqs = []
            self._gb_reqs.append((req, srv))
        self._recheck_global_barrier()

    def _recheck_global_barrier(self) -> None:
        """Release the cross-party worker barrier if every LIVE local
        worker has arrived (re-run on membership epoch bumps: a dead
        worker's barrier request is never coming)."""
        with self._lock:
            reqs = getattr(self, "_gb_reqs", None)
            if (not reqs
                    or len(reqs) < self._expected_local_pushes()):
                return
            reqs, self._gb_reqs = self._gb_reqs, []
        if self.po_global is not None:
            # party servers + global servers all participate
            self.po_global.barrier(psbase.WORKER_SERVER_GROUP,
                                   timeout=self.cfg.barrier_timeout_s)
        for r, s in reqs:
            s.response(r)

    def _snapshot_states(self) -> Dict:
        """Consistent deep copy of the updater's per-key states.

        Updates run GIL-FREE (native kernels) under each key's state
        lock, so a plain read could capture a half-written m/v buffer;
        copy each entry while holding its key's lock. The dict itself is
        snapshotted first (per-key inserts are GIL-atomic)."""
        import copy as _copy

        if self.updater is None:
            return {}
        out: Dict = {}
        for k, v in dict(self.updater.get_states()).items():
            key, offset = k if isinstance(k, tuple) else (k, 0)
            st = self._state(key, offset)
            with st.lock:
                out[k] = _copy.deepcopy(v)
        return out

    def _relay_optimizer_states_get(self) -> Dict[str, str]:
        """Party server: fetch the live states from every global server
        and merge them into one {global_rank: states_hex} dict."""
        merged: Dict[str, str] = {}
        tss = []
        for rank in range(self.po_global.num_servers):
            tss.append(self.worker_global.request(
                Command.GET_OPTIMIZER_STATES, "",
                psbase.server_rank_to_id(rank)))
        for ts in tss:
            try:
                self.worker_global.wait(ts, 60.0)
            except (TimeoutError, RuntimeError) as e:
                log.warning("optimizer-state fetch from global tier "
                            "failed: %s", e)
                continue
            for resp in self.worker_global.take_response_bodies(ts):
                merged.update(json.loads(resp))
        return merged

    def _relay_health(self) -> str:
        """Party server: pull the GLOBAL scheduler's health board for a
        local worker's ``kv.health()`` query (the global scheduler
        answers at the van level — see ``Van._answer_health``)."""
        ts = self.worker_global.request(Command.HEALTH, "", psbase.SCHEDULER)
        try:
            self.worker_global.wait(ts, 30.0)
        except (TimeoutError, RuntimeError) as e:
            log.warning("health-board fetch from global scheduler "
                        "failed: %s", e)
            return ""
        for resp in self.worker_global.take_response_bodies(ts):
            if resp:
                return resp
        return ""

    def _relay_optimizer_states_set(self, body: str) -> None:
        """Party server: forward a restore to every global server
        (idempotent — several party servers may relay the same body).
        All requests go out before any wait so a slow global server
        can't push the total past the caller's own timeout."""
        tss = []
        for rank in range(self.po_global.num_servers):
            tss.append(self.worker_global.request(
                Command.SET_OPTIMIZER_STATES, body,
                psbase.server_rank_to_id(rank)))
        for ts in tss:
            try:
                self.worker_global.wait(ts, 60.0)
            except (TimeoutError, RuntimeError) as e:
                log.warning("optimizer-state restore relay failed: %s", e)

    def _rebroadcast_command(self, head: int, body: str) -> None:
        """A global server re-broadcasts config commands to its peers and
        waits for their acks (reference fire-and-forgets,
        kvstore_dist_server.h:311-318 — we wait so the master's set_* call
        returning means the whole cluster runs the new config)."""
        if not self.is_global_server or self.po_global is None:
            return
        # SET_OPTIMIZER_STATES is NOT rebroadcast: the live updaters are
        # the global servers themselves (all of which the master's local
        # SERVER_GROUP send already reached); pushing global-rank-keyed
        # states onto party servers' unused copies would mis-apply them
        if head not in (Command.CONTROLLER, Command.SET_GRADIENT_COMPRESSION,
                        Command.SYNC_GLOBAL_MODE, Command.SET_PROFILER_PARAMS):
            return
        if self.po_global.my_rank != 0:
            # every global server received the master's command directly
            # (the master's local SERVER_GROUP is all of them); one
            # rebroadcaster suffices — and global-to-global rebroadcast
            # would land on the peer's handler-less _cmd_kvw and deadlock
            # the waits (MultiGPS hang found in round 3)
            return
        if self._cmd_kvw is None:
            self._cmd_kvw = KVWorker(self.po_global, customer_id=2)
        # party servers (the global tier's workers)
        targets = [psbase.worker_rank_to_id(r)
                   for r in range(self.po_global.num_workers)]
        tss = []
        for nid in targets:
            if nid == self.po_global.my_id:
                continue
            tss.append(self._cmd_kvw.request(head, body, nid))
        for ts in tss:
            try:
                self._cmd_kvw.wait(ts, 60.0)
            except TimeoutError:
                log.warning("command %d rebroadcast ack timed out", head)

    def _cascade_stop(self) -> None:
        """Every party server forwards StopServer to the global servers,
        which count them (reference: :296-301)."""
        with self._lock:
            if self._stop_forwarded:
                return
            self._stop_forwarded = True
        if self.worker_global is not None:
            for rank in range(self.po_global.num_servers):
                try:
                    ts = self.worker_global.request(
                        Command.STOP_SERVER, "", psbase.server_rank_to_id(rank))
                    self.worker_global.wait(ts, 10.0)
                except (TimeoutError, OSError):
                    pass

    # ------------------------------------------------------------------

    def _state(self, key: int, offset: int) -> _KeyState:
        with self._lock:
            return self._states.setdefault((key, offset), _KeyState(offset))

    def _canonical_ranges(self, key: int, total: int) -> List[sharding.Shard]:
        """This global server's canonical shard(s) of ``key``.

        With a P3 chunk budget (and no TSEngine) the shards sub-split
        at the budget so each slice runs its OWN FSA countdown: a
        sliced key's round then releases shard by shard as the parties'
        chunks land, instead of parking every combined push+pull
        response until the key's last shard arrives — on a shaped WAN
        that parking serialized a full extra bandwidth-delay product
        into the pipelined round's tail. Peers addressing the coarse
        range still work: a request overlapping several fine states is
        fanned out and its acks merge through a _BatchResponder.
        """
        po = self.po_global if self.po_global else self.po_local
        my_rank = po.my_rank
        n = po.num_servers
        mine = [s for s in sharding.assign(key, total, n,
                                           self.cfg.bigarray_bound)
                if s.server_rank == my_rank]
        return sharding.split_slices(
            mine, getattr(self, "_fsa_slice_elems", 0))
