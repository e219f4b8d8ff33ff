"""KVStoreDist — the worker-side distributed store.

Re-implements the reference's worker side (reference:
src/kvstore/kvstore_dist.h:50-1002) without the MXNet engine:

- key -> server sharding via the shared deterministic heuristic
  (EncodeDefaultKey, kvstore_dist.h:725-816 -> geomx_tpu_torch.kvstore.sharding);
- async push/pull with the crucial ordering invariant the reference gets
  from engine var-deps on comm_buf_: a pull for key K is not SENT until
  K's outstanding push has been ACKED by the server (the server defers
  push acks until fresh params are in its store, so pull responses are
  always fresh — see kvstore.server docstring);
- ``priority`` propagates into message meta; with ENABLE_P3 the van sends
  data messages through a priority queue (reference: van.cc:548,851) and
  pushes are sliced at bigarray granularity so later layers' small slices
  can overtake earlier layers' bulk (reference: P3_EncodeDefaultKey,
  kvstore_dist.h:768-805);
- control commands: optimizer shipping (master worker -> global server,
  pickled), sync modes, gradient compression, profiler, stop
  (reference: kvstore_dist.h:180-235, kvstore.cc:56-63).

TPU stance: this class carries HOST-side traffic only. Device-level
gradient aggregation (the reference's comm_->Reduce over local GPUs,
kvstore_dist.h:478) belongs inside the jitted train step as a psum over
the ICI mesh — push the already-reduced host array, or pass a list of
per-device arrays to ``push`` and they are summed on host as a fallback.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from geomx_tpu_torch import config as cfg_mod
from geomx_tpu_torch import profiler
from geomx_tpu_torch import telemetry
from geomx_tpu_torch.compression.device import (WireCodec, _host_array,
                                                decode_wire)
from geomx_tpu_torch.kvstore import sharding
from geomx_tpu_torch.kvstore.controller import TransportController
from geomx_tpu_torch.kvstore.base import Command, DATA_INIT, KVStore, _sum_values
from geomx_tpu_torch.kvstore.frontier import (RoundFuture, give_up_exc,
                                        plan_chunks,
                                        slice_bytes_from_shape)
from geomx_tpu_torch.ps import base as psbase
from geomx_tpu_torch.ps.kv_app import KVPairs, KVWorker
from geomx_tpu_torch.ps.message import Role
from geomx_tpu_torch.ps.postoffice import Postoffice

log = logging.getLogger("geomx.dist")


def _give_up_exc(errs) -> type:
    """Exception class for surfacing transport give-ups — one mapping,
    shared with RoundFuture (kvstore.frontier.give_up_exc): "declared
    dead" raises WorkerLostError, a blown PS_RESEND_DEADLINE is a
    TimeoutError, retry-cap give-ups stay RuntimeError."""
    return give_up_exc(errs)


def _wire_decode(kvs, i: int) -> np.ndarray:
    """Decode dense response entry ``i`` of ``kvs`` to flat float32:
    the combined-wire server echoes the requester's codec on its acks
    ("" / "fp16" / "2bit" — compression.device), so every dense
    response path funnels through the tag-driven decode instead of a
    raw astype. The original element count rides the entry's ``lens``
    meta (the 2-bit pack is 4 codes/byte)."""
    aux = kvs.aux[i] if i < len(kvs.aux) else None
    return decode_wire(kvs.compr, kvs.vals[i], aux, kvs.len_of(i) or 0)


def _is_tensor_value(value) -> bool:
    """A ``torch.Tensor`` (or a list of them, one per device): with the
    quantized wire on, the combined wire keeps it where it lies until
    the per-chunk encode (the port's ``WireCodec``, the 2-bit kernel on
    a CUDA tensor), so the device-to-host copy moves packed bytes."""
    if isinstance(value, (list, tuple)):
        return bool(value) and all(isinstance(v, torch.Tensor)
                                   for v in value)
    return isinstance(value, torch.Tensor)


def _sum_tensors(value) -> torch.Tensor:
    """:func:`_sum_values` for tensors, on their device (the first
    tensor's)."""
    if isinstance(value, (list, tuple)):
        out = value[0].detach()
        for v in value[1:]:
            out = out + v.detach().to(out.device)
        return out
    return value.detach()


def _numel(seg) -> int:
    return int(seg.numel()) if isinstance(seg, torch.Tensor) \
        else int(seg.size)


class _KeyInfo:
    __slots__ = ("total", "shape", "dtype", "shards")

    def __init__(self, total, shape, dtype, shards):
        self.total = total
        self.shape = shape
        self.dtype = dtype
        self.shards = shards


class KVStoreDist(KVStore):
    def __init__(self, sync_global: bool = True,
                 cfg: Optional[cfg_mod.Config] = None):
        super().__init__()
        self.cfg = cfg or cfg_mod.load()
        c = self.cfg
        if c.p3_slice_bytes < 0:
            # P3_SLICE_BYTES=-1: auto-size the chunk budget to the
            # shaped topology's worst-link BDP. Must resolve HERE —
            # _shards fixes shard boundaries at init from this value,
            # so it cannot float per call.
            c = self.cfg = dataclasses.replace(
                c, p3_slice_bytes=slice_bytes_from_shape(c))
        self._sync_global = sync_global
        self.po = Postoffice(
            my_role=Role.WORKER, is_global=False,
            root_uri=c.ps_root_uri, root_port=c.ps_root_port,
            num_workers=c.num_workers, num_servers=c.num_servers, cfg=c,
        )
        self.po.start()
        self.kvw = KVWorker(self.po)

        # TSEngine (reference: ENABLE_INTRA_TS, kv_app.h:110): gradients
        # merge worker-to-worker along a scheduler-built overlay; models
        # come back via relay + auto_pull instead of server pulls
        self._ts = None
        self._ts_ver: Dict[int, int] = {}
        if c.enable_intra_ts:
            from geomx_tpu_torch.ps.tsengine import TSNode

            # live view, not the static worker count: a peer that dies
            # mid-round must shrink the merge target (GX-P305)
            self._ts = TSNode(self.po, self.kvw,
                              tgt_merge=self.po.num_live_workers,
                              final_push=self._ts_final_push)
            self._ts.on_push_sent = lambda _k, _o, _v: self._untrack(_k)
            self.kvw.set_request_handle(
                lambda req, kvs, app: self._ts.handle_request(req, kvs, app))

        self._key_info: Dict[int, _KeyInfo] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # per-key: outstanding push shard-acks, and deferred pulls waiting
        # on them (the engine-ordering equivalent)
        self._push_acks_left: Dict[int, int] = {}
        self._deferred: Dict[int, List] = {}
        self._outstanding = 0
        # per-key outstanding op count so wait(keys=[...]) can drain a
        # subset (reference per-key semantics, kvstore.h WaitToRead on the
        # key's comm_buf)
        self._outstanding_key: Dict[int, int] = {}
        # transport give-ups recorded by callbacks; surfaced by wait()
        self._transport_errors: List[str] = []
        # round clock for trace stamping: every combined round gets an
        # id carried in Meta.trace_round on each of its wire messages;
        # notify_round() re-syncs it to the trainer's numbering
        self._round_seq = 0
        # quantized combined wire (GEOMX_WIRE_CODEC; compression.device):
        # per-chunk codecs for push_pull_async / push_pull_bsc_batch_async
        # with 2-bit error-feedback residuals keyed per (key, offset)
        self._wire = WireCodec.from_config(c)
        # self-tuning transport (GEOMX_TRANSPORT_CONTROLLER;
        # kvstore/controller.py): per-round plan over this van's OWN
        # link estimates — per-server chunk codec + live-BDP chunk
        # budget for push_pull_async. Off (the default) leaves every
        # path below bit-for-bit untouched.
        self._controller = None
        if c.transport_controller and c.health:
            self._controller = TransportController.for_van(
                self.po.van, c, tier="local")

        # startup barrier (reference: kvstore_dist.h:64), then the
        # creation-time command protocol (reference: kvstore.cc:56-63).
        # A recovering worker skips both: the survivors will not re-join
        # the barrier (reference: is_recovery gate, kvstore_dist.h:63)
        # and the cluster already runs the right modes.
        if not self.po.van.is_recovery:
            self.po.barrier(psbase.ALL_GROUP,
                            timeout=self.cfg.barrier_timeout_s)
            if self.rank == 0:
                self._send_command(Command.SYNC_MODE, "1")
            if self.is_master_worker:
                self._send_command(Command.SYNC_GLOBAL_MODE,
                                   "1" if sync_global else "0")
        self._closed = False
        import atexit

        atexit.register(self.close)

    # -- identity --------------------------------------------------------

    @property
    def type(self) -> str:
        return "dist_sync" if self._sync_global else "dist_async"

    @property
    def rank(self) -> int:
        return self.po.my_rank

    @property
    def num_workers(self) -> int:
        return self.po.num_workers

    @property
    def num_all_workers(self) -> int:
        return self.cfg.num_all_workers

    @property
    def is_master_worker(self) -> bool:
        return self.cfg.is_master_worker

    def get_num_dead_node(self, role=None) -> int:
        """Dead-node count, optionally filtered by role ("worker" /
        "server" or a ps.message.Role), mirroring the reference's
        GetDeadNodes(role). Emits the count as a profiler gauge so
        operators can watch membership shrink."""
        if isinstance(role, str):
            role = {"worker": Role.WORKER, "server": Role.SERVER}[
                role.lower()]
        n = self.po.num_dead_nodes(role=role)
        tag = ("dead_nodes" if role is None
               else f"dead_{Role(role).name.lower()}s")
        telemetry.sample(f"membership.{tag}", n, cat="membership")
        return n

    def membership_epoch(self) -> int:
        return self.po.membership_epoch()

    def notify_round(self, round_idx: int) -> None:
        """Advance the training-round clock (deterministic FaultPlan
        kill-at-round rules consult it); also exports this node's
        telemetry snapshot for the closing round (GEOMX_TELEMETRY_DIR)
        and re-syncs the trace-round clock to the trainer's numbering."""
        self.po.van.notify_round(round_idx)
        with self._lock:
            self._round_seq = max(self._round_seq, round_idx)
        telemetry.export_round(round_idx)

    def _begin_round(self) -> int:
        """Next trace-round id: stamped into Meta.trace_round on every
        message of one combined round so the merged cross-node trace can
        follow it worker -> local server -> global server -> worker."""
        with self._lock:
            self._round_seq += 1
            return self._round_seq

    def _abort_round(self, reason: str) -> None:
        """RoundFuture on_abort hook: a round died at the caller
        (timeout / give-up) — preserve this node's recent wire history."""
        telemetry.event("round.abort", cat="kvstore", reason=reason[:200])
        rec = self.po.van.flightrec
        rec.record("note", event="round_abort", reason=reason[:200])
        rec.dump("round_abort")
        # mesh-party fan-out (kvstore.mesh_party): the wrapping store
        # fails every pending key of every live future so mesh ranks
        # joining other keys unblock immediately instead of waiting out
        # op_timeout on a round that cannot complete
        hook = getattr(self, "round_abort_hook", None)
        if hook is not None:
            try:
                hook(reason)
            except Exception:  # noqa: BLE001 — never mask the round error
                pass

    # -- helpers ---------------------------------------------------------

    def _shards(self, key: int, total: int) -> List[sharding.Shard]:
        if self.cfg.enable_p3:
            # P3: slice every key at bigarray granularity so the priority
            # send thread can interleave layers (kvstore_dist.h:768-805)
            return sharding.assign_p3(key, total, self.po.num_servers,
                                      self.cfg.bigarray_bound)
        if self.cfg.p3_slice_bytes > 0:
            # pipelined round: slice big keys at the chunk budget so
            # push_pull_async can put each slice in its own chunk — shard
            # boundaries must be fixed at init (the server FSA registers
            # per-(key, offset) states on first contact), so the budget
            # feeds the slicer here, not per call
            return sharding.assign_p3(
                key, total, self.po.num_servers,
                max(1, self.cfg.p3_slice_bytes // 4))
        return sharding.assign(key, total, self.po.num_servers,
                               self.cfg.bigarray_bound)

    def _info(self, key: int, value: Optional[np.ndarray] = None) -> _KeyInfo:
        if key not in self._key_info:
            assert value is not None, f"key {key} used before init"
            v = np.asarray(value)
            self._key_info[key] = _KeyInfo(
                v.size, v.shape, v.dtype, self._shards(key, v.size))
        return self._key_info[key]

    def _track(self, n: int = 1, key: Optional[int] = None) -> None:
        with self._cv:
            self._outstanding += n
            if key is not None:
                self._outstanding_key[key] = (
                    self._outstanding_key.get(key, 0) + n)

    def _untrack(self, key: Optional[int] = None) -> None:
        with self._cv:
            self._outstanding -= 1
            if key is not None and key in self._outstanding_key:
                self._outstanding_key[key] -= 1
                if self._outstanding_key[key] <= 0:
                    del self._outstanding_key[key]
            self._cv.notify_all()

    # -- data plane ------------------------------------------------------

    def init(self, key, value) -> None:
        """Rank-0 of each party pushes initial values; everyone barriers
        (reference: kvstore_dist.h:262-299 InitImpl)."""
        keys = self._as_key_list(key)
        values = value if isinstance(value, (list, tuple)) and len(keys) > 1 \
            else [value]
        for k, v in zip(keys, values):
            info = self._info(k, np.asarray(v))
            if self.rank != 0:
                continue
            flat = np.ascontiguousarray(np.asarray(v)).ravel()
            for sh in info.shards:
                kvs = KVPairs(keys=[k],
                              vals=[flat[sh.offset:sh.offset + sh.length]],
                              offsets=[sh.offset], totals=[sh.total],
                              lens=[sh.length])
                ts = self.kvw.push(kvs, sh.server_rank, cmd=DATA_INIT)
                self.kvw.wait(ts, 120.0)
        if not self.po.van.is_recovery:
            # survivors won't re-join init barriers; the store is already
            # initialized (a duplicate DATA_INIT is acked and ignored)
            self.barrier()

    def push(self, key, value, priority: int = 0,
             trace_round: int = -1) -> None:
        keys = self._as_key_list(key)
        values = value if isinstance(value, (list, tuple)) and len(keys) > 1 \
            else [value]
        if len(keys) > 1:
            # a key twice in one round would double-count this worker's
            # FSA contribution and wedge the round barrier — reject it
            # loudly here rather than hanging in wait()
            if len(set(keys)) != len(keys):
                raise ValueError("push: duplicate keys in one round")
            if self._ts is None and not self.cfg.enable_p3:
                # list form = batched wire: ONE message per server
                # carrying every (key, shard) entry for it, acked once
                # (the server merges per-key acks —
                # kvstore.server._BatchResponder). Cuts the per-round
                # message count from 2*n_keys to 2*n_servers.
                self._push_batch(keys, values, priority,
                                 trace_round=trace_round)
                return
            if self.cfg.enable_p3:
                # P3 wants per-key messages so the priority send thread
                # can interleave layers: list order IS layer order, so
                # later entries get lower priority (reference:
                # kvstore_dist.h:768 slicing + van.cc:548 queues)
                for i, (k, v) in enumerate(zip(keys, values)):
                    self.push(k, v, priority=priority - i,
                              trace_round=trace_round)
                return
        for k, v in zip(keys, values):
            merged = _sum_values(v)
            info = self._info(k, merged)
            flat = np.ascontiguousarray(merged).ravel()
            if self._ts is not None:
                # TSEngine: contribute to the reduction overlay; the last
                # holder pushes the merged gradient for everyone
                ver = self._ts_ver[k] = self._ts_ver.get(k, 0) + 1
                self._track(1, k)
                self._ts.contribute(k, 0, info.total, flat, ver)
                continue
            with self._lock:
                self._push_acks_left[k] = (
                    self._push_acks_left.get(k, 0) + len(info.shards))
            self._track(len(info.shards), k)
            for sh in info.shards:
                kvs = KVPairs(keys=[k],
                              vals=[flat[sh.offset:sh.offset + sh.length]],
                              offsets=[sh.offset], totals=[sh.total],
                              lens=[sh.length])
                self.kvw.push(kvs, sh.server_rank, priority=priority,
                              trace_round=trace_round,
                              cb=lambda ts, kk=k: self._on_push_ack(kk, ts))

    def _push_batch(self, keys: List[int], values, priority: int,
                    trace_round: int = -1) -> None:
        per_server: Dict[int, KVPairs] = {}
        server_keys: Dict[int, List[int]] = {}
        for k, v in zip(keys, values):
            merged = _sum_values(v)
            info = self._info(k, merged)
            flat = np.ascontiguousarray(merged).ravel()
            for sh in info.shards:
                kvs = per_server.setdefault(sh.server_rank, KVPairs())
                kvs.keys.append(k)
                kvs.vals.append(flat[sh.offset:sh.offset + sh.length])
                kvs.offsets.append(sh.offset)
                kvs.totals.append(sh.total)
                kvs.lens.append(sh.length)
                server_keys.setdefault(sh.server_rank, []).append(k)
        self._send_batch_pushes(per_server, server_keys, priority,
                                trace_round=trace_round)

    def _send_batch_pushes(self, per_server: Dict[int, KVPairs],
                           server_keys: Dict[int, List[int]],
                           priority: int, trace_round: int = -1) -> None:
        """Shared tail of the batched push paths: register per-(server,
        shard) ack bookkeeping and send one message per server."""
        with self._lock:
            for ks in server_keys.values():
                for k in ks:
                    self._push_acks_left[k] = (
                        self._push_acks_left.get(k, 0) + 1)
        for ks in server_keys.values():
            for k in ks:
                self._track(1, k)
        for srank, kvs in per_server.items():
            ks = tuple(server_keys[srank])
            self.kvw.push(kvs, srank, priority=priority,
                          trace_round=trace_round,
                          cb=lambda ts, kk=ks:
                          self._on_batch_push_ack(kk, ts))

    def _on_batch_push_ack(self, keys, ts: int) -> None:
        fail = self.kvw.take_failure(ts)
        if fail is not None:
            with self._lock:
                self._transport_errors.append(
                    f"push keys {list(keys)}: {fail}")
        ready = []
        with self._lock:
            for k in keys:
                self._push_acks_left[k] -= 1
                if self._push_acks_left[k] == 0 and k in self._deferred:
                    ready.extend(self._deferred.pop(k))
        for k in keys:
            self._untrack(k)
        for fn in ready:
            fn()

    def _ts_final_push(self, key: int, off: int, total: int,
                       arr: np.ndarray, num_merge: int, ver: int) -> None:
        """The last overlay holder pushes the merged gradient to the
        server tier with ``num_merge`` contributions (reference: the
        terminal TS hop, kvstore_dist.h:97-121 + server counting at
        kvstore_dist_server.h:1301)."""
        info = self._key_info[key]
        remaining = [len(info.shards)]

        def on_ack(_ts):
            with self._lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                self._untrack(key)

        for sh in info.shards:
            kvs = KVPairs(keys=[key],
                          vals=[arr[sh.offset:sh.offset + sh.length]],
                          offsets=[sh.offset], totals=[sh.total],
                          lens=[sh.length])
            self.kvw.push(kvs, sh.server_rank, num_merge=num_merge,
                          cb=on_ack)

    def _on_push_ack(self, key: int, ts: int) -> None:
        fail = self.kvw.take_failure(ts)
        if fail is not None:
            # record and fall through: the ack bookkeeping must still
            # advance (a wedged counter would hang wait() silently) and
            # wait() raises the recorded error
            with self._lock:
                self._transport_errors.append(f"push key {key}: {fail}")
        ready = []
        with self._lock:
            self._push_acks_left[key] -= 1
            if self._push_acks_left[key] == 0 and key in self._deferred:
                ready = self._deferred.pop(key)
        self._untrack(key)
        for fn in ready:
            fn()

    def push_pull(self, key, value, out, priority: int = 0) -> None:
        """Combined push+pull (reference: ZPushPull, kv_app.h:140): ONE
        request per server per round — the ack carries the post-round
        parameters, eliminating the separate pull round-trip. Semantics
        match push(list) followed by pull(list, out=...): ``out`` fills
        with the post-round state; join with wait().

        Falls back to the two-op sequence for single keys, TSEngine
        overlays (models disseminate out-of-band) and P3 (per-key
        priority interleaving wants separate messages)."""
        keys = self._as_key_list(key)
        values = value if isinstance(value, (list, tuple)) \
            and len(keys) > 1 else [value]
        outs = out if isinstance(out, (list, tuple)) and len(keys) > 1 \
            else [out]
        if (len(keys) == 1 or self._ts is not None
                or self.cfg.enable_p3):
            # still one logical round: both legs carry the same trace id
            rid = self._begin_round()
            self.push(key, value, priority=priority, trace_round=rid)
            self.pull(key, out=out, priority=priority, trace_round=rid)
            return
        if len(set(keys)) != len(keys):
            raise ValueError("push_pull: duplicate keys in one round")
        for o in outs:
            if not (isinstance(o, np.ndarray) and o.flags.writeable):
                raise TypeError(
                    "push_pull requires writable numpy ndarrays")
        rid = self._begin_round()
        per_server: Dict[int, KVPairs] = {}
        server_keys: Dict[int, List[int]] = {}
        for k, v in zip(keys, values):
            merged = _sum_values(v)
            info = self._info(k, merged)
            flat = np.ascontiguousarray(merged).ravel()
            for sh in info.shards:
                kvs = per_server.setdefault(sh.server_rank, KVPairs())
                kvs.keys.append(k)
                kvs.vals.append(flat[sh.offset:sh.offset + sh.length])
                kvs.offsets.append(sh.offset)
                kvs.totals.append(sh.total)
                kvs.lens.append(sh.length)
                server_keys.setdefault(sh.server_rank, []).append(k)
        bufs = {k: np.zeros(self._key_info[k].total, np.float32)
                for k in keys}
        out_of = dict(zip(keys, outs))
        msgs_left: Dict[int, int] = {}
        with self._lock:
            for srank, ks in server_keys.items():
                for k in set(ks):
                    msgs_left[k] = msgs_left.get(k, 0) + 1
            for ks in server_keys.values():
                for k in ks:
                    self._push_acks_left[k] = (
                        self._push_acks_left.get(k, 0) + 1)
        for ks in server_keys.values():
            for k in ks:
                self._track(1, k)

        got_data: set = set()

        def on_resp(ts: int, srank: int):
            # scatter the response data BEFORE the ack bookkeeping: the
            # final untrack releases wait(), which must observe outs
            fail = self.kvw.take_failure(ts)
            if fail is not None:
                with self._lock:
                    self._transport_errors.append(
                        f"push_pull keys "
                        f"{sorted(set(server_keys[srank]))}: {fail}")
            finished = []
            for kvs in self.kvw.take_response(ts):
                for i, k in enumerate(kvs.keys):
                    data = _wire_decode(kvs, i)
                    r_off = kvs.offset_of(i)
                    buf = bufs[k]
                    n = min(data.size, buf.size - r_off)
                    buf[r_off:r_off + n] = data[:n]
                    with self._lock:
                        got_data.add((k, srank))
            with self._lock:
                for k in set(server_keys[srank]):
                    msgs_left[k] -= 1
                    if msgs_left[k] == 0:
                        finished.append(k)
            fallback = []
            for k in finished:
                with self._lock:
                    complete = all((k, sr) in got_data
                                   for sr, ks in server_keys.items()
                                   if k in ks)
                if complete:
                    info = self._key_info[k]
                    np.copyto(out_of[k], bufs[k].reshape(info.shape)
                              .astype(info.dtype, copy=False))
                else:
                    # a server acked without data (e.g. a range the
                    # store doesn't hold): NEVER copy the zero-filled
                    # buffer over the caller's params — fall back to an
                    # explicit pull for this key, at the caller's own
                    # priority so the retry doesn't queue behind traffic
                    # the original request was meant to beat
                    fallback.append(k)
            if fallback:
                self._pull_batch(fallback,
                                 [out_of[k] for k in fallback], priority,
                                 trace_round=rid)
            # the ack also advances the push-ordering bookkeeping so a
            # subsequent plain pull stays ordered after this round
            ready = []
            with self._lock:
                for k in server_keys[srank]:
                    self._push_acks_left[k] -= 1
                    if (self._push_acks_left[k] == 0
                            and k in self._deferred):
                        ready.extend(self._deferred.pop(k))
            for k in server_keys[srank]:
                self._untrack(k)
            for fn in ready:
                fn()

        for srank, kvs in per_server.items():
            self.kvw.push(kvs, srank, priority=priority, pull=True,
                          trace_round=rid,
                          cb=lambda ts, s=srank: on_resp(ts, s))

    def _consume_errors(self, errs: List[str]) -> None:
        """RoundFuture consume hook: the future raised these give-ups,
        so remove them from the global list a later wait() would drain
        (errors surface exactly once — the BSC join contract)."""
        with self._lock:
            self._transport_errors = [
                e for e in self._transport_errors if e not in errs]

    def push_pull_async(self, key, value, out, priority: int = 0,
                        slice_bytes: Optional[int] = None) -> RoundFuture:
        """Non-blocking chunked combined round (the P3-pipelined form of
        :meth:`push_pull`): the (key, shard) entry list — layer order
        preserved — splits into ~``slice_bytes``-byte chunks (default
        ``cfg.p3_slice_bytes``; <= 0 means one chunk), each chunk ONE
        message per server at descending priority, every chunk's send
        and response flowing independently. Returns a
        :class:`RoundFuture`: each key's ``out`` array holds the
        post-round state when the future completes that key, so the
        caller can apply key i while key j's bytes are still on the
        wire. Give-ups surface through ``fut.wait()`` with the same
        class mapping as :meth:`wait`.

        Big keys chunk at ``_shards`` granularity — set ``P3_SLICE_BYTES``
        before init so the slicer feeds the shard map (the server FSA
        pins per-(key, offset) states at first contact). Not available
        on TSEngine overlays (models disseminate out-of-band)."""
        if self._ts is not None:
            raise NotImplementedError(
                "push_pull_async is not supported on TSEngine overlays")
        keys = self._as_key_list(key)
        values = value if isinstance(value, (list, tuple)) \
            and len(keys) > 1 else [value]
        outs = out if isinstance(out, (list, tuple)) and len(keys) > 1 \
            else [out]
        if len(set(keys)) != len(keys):
            raise ValueError("push_pull_async: duplicate keys in one round")
        for o in outs:
            if not (isinstance(o, np.ndarray) and o.flags.writeable):
                raise TypeError(
                    "push_pull_async requires writable numpy ndarrays")
        rid = self._begin_round()
        # self-tuning transport: one plan per round, computed from the
        # freshest link estimates. It can re-size the chunk budget to
        # the measured BDP (explicit slice_bytes= still wins — operator
        # intent) and override the per-server codec below. None when
        # the controller is off: everything stays bit-for-bit static.
        tplan = (self._controller.plan(rid)
                 if self._controller is not None else None)
        sb = self.cfg.p3_slice_bytes if slice_bytes is None else slice_bytes
        if tplan is not None and slice_bytes is None \
                and tplan.slice_bytes > 0:
            sb = tplan.slice_bytes
        wire_on = self._wire.enabled() \
            or (tplan is not None and tplan.has_codecs())
        # layer-ordered (key, shard, flat-segment) entry list
        entries = []
        for k, v in zip(keys, values):
            if wire_on and _is_tensor_value(v):
                # quantized wire + tensor gradient: stay on its device —
                # the per-chunk encode below packs there, so the D2H
                # is the packed bytes, not fp32
                merged = _sum_tensors(v)
                info = self._info(k, np.broadcast_to(
                    np.float32(0), tuple(merged.shape)))
                flat = merged.reshape(-1)
            else:
                merged = _sum_values(v)
                info = self._info(k, merged)
                flat = np.ascontiguousarray(merged).ravel()
            for sh in info.shards:
                entries.append(
                    (k, sh, flat[sh.offset:sh.offset + sh.length]))
        chunks = plan_chunks(
            list(range(len(entries))),
            [_numel(e[2]) * 4 for e in entries],
            sb, base_priority=priority,
            codec_for=self._wire.chunk_codec
            if self._wire.enabled() else None)
        fut = RoundFuture(keys, consume=self._consume_errors,
                          max_retries=self.cfg.chunk_retries,
                          on_abort=self._abort_round)
        bufs = {k: np.zeros(self._key_info[k].total, np.float32)
                for k in keys}
        out_of = dict(zip(keys, outs))
        # one message per (chunk, server); a key completes when every
        # message carrying one of its entries has responded with data
        msgs = []  # (mid, cid, srank, kvs, msg_keys, chunk_priority)
        key_msgs: Dict[int, List[int]] = {k: [] for k in keys}
        for ch in chunks:
            per_server: Dict[int, KVPairs] = {}
            server_keys: Dict[int, List[int]] = {}
            ch_elems = sum(_numel(entries[ei][2]) for ei in ch.items)
            for ei in ch.items:
                k, sh, seg = entries[ei]
                # per-(chunk, server) codec: the transport plan's
                # per-peer assignment (fat links fp16, thin 2bit/mpq)
                # overrides the chunk's static tag; servers decode
                # tag-driven, so no protocol change rides with this
                codec = ch.codec if tplan is None else tplan.wire_tag(
                    psbase.server_rank_to_id(sh.server_rank),
                    ch.codec, ch_elems)
                kvs = per_server.setdefault(
                    sh.server_rank, KVPairs(compr=codec))
                kvs.keys.append(k)
                if kvs.compr:
                    # encode ONCE at message build: chunk retries below
                    # resend these bytes, so the 2-bit residual for
                    # (key, offset) drains exactly once per round
                    wv, aux, _tag = self._wire.encode(
                        kvs.compr, seg, (k, sh.offset))
                    kvs.vals.append(wv)
                    # always append (None for fp16): the server's push
                    # decompress indexes aux[i] positionally
                    kvs.aux.append(aux)
                else:
                    kvs.vals.append(_host_array(seg))
                kvs.offsets.append(sh.offset)
                kvs.totals.append(sh.total)
                kvs.lens.append(sh.length)
                server_keys.setdefault(sh.server_rank, []).append(k)
            for srank, kvs in per_server.items():
                mid = len(msgs)
                for k in set(server_keys[srank]):
                    key_msgs[k].append(mid)
                msgs.append((mid, ch.cid, srank, kvs,
                             server_keys[srank], ch.priority))
        msgs_left = {k: len(key_msgs[k]) for k in keys}
        with self._lock:
            for _mid, _cid, _srank, _kvs, mks, _p in msgs:
                for k in mks:
                    self._push_acks_left[k] = (
                        self._push_acks_left.get(k, 0) + 1)
        for _mid, _cid, _srank, _kvs, mks, _p in msgs:
            for k in mks:
                self._track(1, k)

        got_data: set = set()

        def on_resp(ts: int, mid: int):
            _m, cid, srank, m_kvs, mks, m_prio = msgs[mid]
            fail = self.kvw.take_failure(ts)
            # bounded per-chunk retry (PS_CHUNK_RETRIES): transient
            # give-ups re-issue the identical message — bookkeeping
            # (msgs_left, push acks, tracking) stays registered until a
            # terminal response lands. "declared dead" never retries:
            # that peer is gone for the epoch; surface WorkerLostError.
            if (fail is not None and "declared dead" not in fail
                    and fut.retry_budget(cid)):
                log.warning("push_pull_async chunk %d to server %d "
                            "failed (%s); retry %d/%d", cid, srank,
                            fail, fut.retries_used(cid), fut.max_retries)
                telemetry.event("chunk.retry", cat="kvstore",
                                chunk=cid, server=srank)
                telemetry.counter_inc("chunk.retries")
                self.kvw.push(m_kvs, srank, priority=m_prio, pull=True,
                              trace_round=rid, trace_chunk=cid,
                              cb=lambda ts2, m=mid: on_resp(ts2, m))
                return
            failed_keys = []
            if fail is not None:
                with self._lock:
                    for k in sorted(set(mks)):
                        err = f"push_pull_async key {k}: {fail}"
                        self._transport_errors.append(err)
                        failed_keys.append((k, err))
            for k, err in failed_keys:
                fut.add_error(k, err)   # future methods outside _lock
            finished = []
            with profiler.chunk_scope("recv", cid, server=srank):
                for kvs in self.kvw.take_response(ts):
                    for i, k in enumerate(kvs.keys):
                        data = _wire_decode(kvs, i)
                        r_off = kvs.offset_of(i)
                        buf = bufs[k]
                        n = min(data.size, buf.size - r_off)
                        buf[r_off:r_off + n] = data[:n]
                        with self._lock:
                            got_data.add((k, mid))
            with self._lock:
                for k in set(mks):
                    msgs_left[k] -= 1
                    if msgs_left[k] == 0:
                        finished.append(k)
            fallback = []
            completed = []
            for k in finished:
                with self._lock:
                    complete = all((k, m) in got_data
                                   for m in key_msgs[k])
                if complete:
                    info = self._key_info[k]
                    np.copyto(out_of[k], bufs[k].reshape(info.shape)
                              .astype(info.dtype, copy=False))
                    completed.append(k)
                elif fut.errors(k):
                    # data is never coming (transport gave up): complete
                    # so joins raise the error instead of timing out
                    completed.append(k)
                else:
                    # a server acked without data — same no-zero-copyback
                    # rule as push_pull: explicit async re-pull, future
                    # completes when the out array holds real data
                    fallback.append(k)
            if fallback:
                self._pull_batch(fallback,
                                 [out_of[k] for k in fallback], priority,
                                 on_key=fut.complete_key, trace_round=rid)
            ready = []
            with self._lock:
                for k in mks:
                    self._push_acks_left[k] -= 1
                    if (self._push_acks_left[k] == 0
                            and k in self._deferred):
                        ready.extend(self._deferred.pop(k))
            for k in mks:
                self._untrack(k)
            for fn in ready:
                fn()
            for k in completed:
                fut.complete_key(k)

        # dispatch largest message first: the biggest chunks are the
        # lone shards of sliced keys, and a sliced key's global round
        # releases only when EVERY shard from every party lands — on a
        # bandwidth-shaped WAN, sending them first starts the response
        # stream back while the small chunks are still serializing
        # upstream (loopback is order-indifferent). Bookkeeping is
        # positional over ``msgs``, so only the send order changes.
        for mid, cid, srank, kvs, _mks, prio in sorted(
                msgs, key=lambda m: -sum(
                    np.asarray(v).nbytes for v in m[3].vals)):
            with profiler.chunk_scope("send", cid, server=srank,
                                      keys=len(kvs.keys)):
                self.kvw.push(kvs, srank, priority=prio, pull=True,
                              trace_round=rid, trace_chunk=cid,
                              cb=lambda ts, m=mid: on_resp(ts, m))
        return fut

    def pull(self, key, out=None, priority: int = 0,
             trace_round: int = -1):
        """Async pull into ``out`` (ordered after this key's push acks);
        blocking when ``out`` is None. Use wait()/waitall to join.

        The list form with ``out`` batches the wire like list pushes:
        one request per server covering every (key, shard) entry, one
        merged response back."""
        keys = self._as_key_list(key)
        outs = out if isinstance(out, (list, tuple)) and len(keys) > 1 \
            else [out] * len(keys)
        if len(keys) > 1 and len(set(keys)) != len(keys):
            raise ValueError("pull: duplicate keys in one call")
        if len(keys) > 1 and self.cfg.enable_p3 and out is not None:
            # per-key prioritized pulls (see the push list form)
            for i, (k, o) in enumerate(zip(keys, outs)):
                self._pull_one(k, o, priority - i, trace_round=trace_round)
            return None
        if (len(keys) > 1 and out is not None
                and not (self._ts is not None
                         and any(self._ts_ver.get(k, 0) for k in keys))):
            self._pull_batch(keys, list(outs), priority,
                             trace_round=trace_round)
            return None
        results = []
        for k, o in zip(keys, outs):
            results.append(self._pull_one(k, o, priority,
                                          trace_round=trace_round))
        if out is None:
            return results[0] if len(results) == 1 else results
        return None

    def _pull_batch(self, keys: List[int], outs: List, priority: int,
                    on_key: Optional[Callable[[int], None]] = None,
                    trace_round: int = -1) -> None:
        for k, o in zip(keys, outs):
            assert self._key_info.get(k) is not None, \
                f"pull of key {k} before init"
            if not (isinstance(o, np.ndarray) and o.flags.writeable):
                raise TypeError(
                    "batched pull requires writable numpy ndarrays")
        bufs = {k: np.zeros(self._key_info[k].total, np.float32)
                for k in keys}
        out_of = dict(zip(keys, outs))
        # per-server request covering every (key, shard) entry on it
        per_server: Dict[int, KVPairs] = {}
        server_keys: Dict[int, List[int]] = {}
        msgs_left: Dict[int, int] = {}   # key -> responses outstanding
        for k in keys:
            info = self._key_info[k]
            for sh in info.shards:
                kvs = per_server.setdefault(sh.server_rank, KVPairs())
                kvs.keys.append(k)
                kvs.vals.append(np.zeros(0, np.float32))
                kvs.offsets.append(sh.offset)
                kvs.totals.append(sh.total)
                kvs.lens.append(sh.length)
                server_keys.setdefault(sh.server_rank, []).append(k)
        # one response per server message; a key completes when every
        # server holding one of its shards has responded
        with self._lock:
            for srank, ks in server_keys.items():
                for k in set(ks):
                    msgs_left[k] = msgs_left.get(k, 0) + 1
        for k in keys:
            self._track(1, k)

        def on_data(ts: int, srank: int):
            fail = self.kvw.take_failure(ts)
            if fail is not None:
                with self._lock:
                    self._transport_errors.append(
                        f"pull keys {sorted(set(server_keys[srank]))}: "
                        f"{fail}")
            finished = []
            for kvs in self.kvw.take_response(ts):
                for i, k in enumerate(kvs.keys):
                    data = _wire_decode(kvs, i)
                    r_off = kvs.offset_of(i)
                    buf = bufs[k]
                    n = min(data.size, buf.size - r_off)
                    buf[r_off:r_off + n] = data[:n]
            with self._lock:
                for k in set(server_keys[srank]):
                    msgs_left[k] -= 1
                    if msgs_left[k] == 0:
                        finished.append(k)
            for k in finished:
                info = self._key_info[k]
                np.copyto(out_of[k], bufs[k].reshape(info.shape)
                          .astype(info.dtype, copy=False))
                self._untrack(k)
                if on_key is not None:
                    # async completion hook (push_pull_async fallback
                    # path): fires AFTER the out array holds the data
                    on_key(k)

        for srank, kvs in per_server.items():
            def issue(sr=srank, kv=kvs):
                self.kvw.pull(kv.keys, sr, offsets=kv.offsets,
                              totals=kv.totals, lens=kv.lens,
                              priority=priority, trace_round=trace_round,
                              cb=lambda ts, s=sr: on_data(ts, s))

            # the message must not go out until EVERY key in it has its
            # push round acked (the per-key freshness ordering, batched)
            self._issue_after_push_acks(set(server_keys[srank]), issue)

    def _pull_one(self, key: int, out, priority: int,
                  trace_round: int = -1):
        info = self._key_info.get(key)
        assert info is not None, f"pull of key {key} before init"
        if self._ts is not None and self._ts_ver.get(key, 0) > 0:
            # TSEngine: gather the disseminated model (AutoPull,
            # kv_app.h:1694) — blocking by design; before the first push
            # (initial broadcast) the normal pull path below still runs
            ver = self._ts_ver[key]
            buf = np.zeros(info.total, dtype=np.float32)
            for sh in info.shards:
                part = self._ts.auto_pull(key, sh.offset, ver)
                n = min(part.size, sh.length)
                buf[sh.offset:sh.offset + n] = part[:n]
            result = buf.reshape(info.shape).astype(info.dtype, copy=False)
            if out is not None:
                np.copyto(out, result)
                return None
            return result
        if out is not None and not (isinstance(out, np.ndarray)
                                    and out.flags.writeable):
            raise TypeError(
                "pull(out=...) requires a writable numpy ndarray; for torch "
                "tensors use the blocking return form: x = kv.pull(key)")
        done = threading.Event()
        buf = np.zeros(info.total, dtype=np.float32)
        remaining = [len(info.shards)]
        self._track(1, key)

        def issue():
            for sh in info.shards:
                self.kvw.pull(
                    [key], sh.server_rank, offsets=[sh.offset],
                    totals=[sh.total], lens=[sh.length], priority=priority,
                    trace_round=trace_round,
                    cb=lambda ts, s=sh: on_data(ts, s))

        def on_data(ts: int, sh: sharding.Shard):
            fail = self.kvw.take_failure(ts)
            if fail is not None:
                with self._lock:
                    self._transport_errors.append(f"pull key {key}: {fail}")
            resps = self.kvw.take_response(ts)
            for kvs in resps:
                for i, _k in enumerate(kvs.keys):
                    data = _wire_decode(kvs, i)
                    r_off = kvs.offset_of(i)
                    n = min(data.size, info.total - r_off)
                    buf[r_off:r_off + n] = data[:n]
            with self._lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                if out is not None:
                    # out must be a writable numpy ndarray (views are fine;
                    # jax arrays are immutable — use the return form instead)
                    np.copyto(out, buf.reshape(info.shape)
                              .astype(info.dtype, copy=False))
                done.set()
                self._untrack(key)

        self._issue_after_push_acks(key, issue)
        if out is None:
            if not done.wait(self.cfg.op_timeout_s):
                raise TimeoutError(f"pull of key {key} timed out")
            return buf.reshape(info.shape).astype(info.dtype, copy=False)
        return None

    def _issue_after_push_acks(self, key, issue: Callable) -> None:
        """Run ``issue`` now, or defer it until the in-flight push round
        of ``key`` (an int, or an iterable of keys for batched
        requests — then ALL of them) is fully acked: the push-ack ->
        pull ordering that guarantees a pull observes fresh
        parameters."""
        keys = [key] if isinstance(key, int) else list(key)
        with self._lock:
            waiting = [k for k in keys
                       if self._push_acks_left.get(k, 0) > 0]
            if waiting:
                pending = [len(waiting)]

                def arm():
                    with self._lock:
                        pending[0] -= 1
                        ready = pending[0] == 0
                    if ready:
                        issue()

                for k in waiting:
                    self._deferred.setdefault(k, []).append(arm)
                return
        issue()

    # -- row-sparse (reference: kvstore.h:59 PullRowSparse,
    # kvstore_dist.h:906 EncodeRowSparseKey) -----------------------------
    # Wire format: tag "rsp"; aux carries the row ids, vals the touched
    # rows flattened, lens the row length. The server scatters pushes to
    # a dense delta (so overlapping rows sum across workers) and gathers
    # pulls. Row-sparse keys must live on ONE server shard — init them
    # below MXNET_KVSTORE_BIGARRAY_BOUND or raise it (the reference's
    # EncodeRowSparseKey also pins whole rows to single servers).

    def _rsp_info(self, key: int, row_len: int):
        info = self._key_info.get(key)
        assert info is not None, f"row-sparse use of key {key} before init"
        assert len(info.shards) == 1, \
            "row-sparse keys must not be sharded (raise bigarray_bound)"
        assert info.total % row_len == 0
        return info

    def push_row_sparse(self, key, row_ids, values,
                        priority: int = 0) -> None:
        """Push only the touched rows of a 2-D key (embedding-style
        updates); rows aggregate by sum across workers."""
        ids = np.asarray(row_ids, dtype=np.int64).ravel()
        rows = np.ascontiguousarray(values, dtype=np.float32)
        rows = rows.reshape(ids.size, -1) if ids.size else rows.reshape(0, 1)
        info = self._rsp_info(key, rows.shape[1] if ids.size else 1)
        n_rows = info.total // rows.shape[1] if ids.size else 0
        if ids.size and (ids.min() < 0 or ids.max() >= n_rows):
            raise IndexError(
                f"push_row_sparse: row ids out of range for key {key} "
                f"({n_rows} rows)")
        sh = info.shards[0]
        with self._lock:
            self._push_acks_left[key] = self._push_acks_left.get(key, 0) + 1
        self._track(1, key)
        kvs = KVPairs(keys=[key], vals=[rows.ravel()], aux=[ids],
                      offsets=[sh.offset], totals=[sh.total],
                      lens=[sh.length], compr="rsp")
        self.kvw.push(kvs, sh.server_rank, priority=priority,
                      cb=lambda ts, kk=key: self._on_push_ack(kk, ts))

    def pull_row_sparse(self, key, row_ids, priority: int = 0,
                        timeout: float = None) -> np.ndarray:
        """Gather specific rows; blocking (ordered after this key's push
        acks, like dense pulls). Returns an (n_rows, row_len) array."""
        timeout = self.cfg.op_timeout_s if timeout is None else timeout
        ids = np.asarray(row_ids, dtype=np.int64).ravel()
        info = self._key_info.get(key)
        assert info is not None, f"pull_row_sparse of key {key} before init"
        assert len(info.shape) == 2, "row-sparse keys must be 2-D"
        row_len = info.shape[-1]
        self._rsp_info(key, row_len)
        if ids.size and (ids.min() < 0 or ids.max() >= info.shape[0]):
            raise IndexError(
                f"pull_row_sparse: row ids out of range for key {key} "
                f"({info.shape[0]} rows)")
        sh = info.shards[0]
        out = np.zeros((ids.size, row_len), np.float32)
        done = threading.Event()
        self._track(1, key)

        def on_data(ts):
            fail = self.kvw.take_failure(ts)
            if fail is not None:
                with self._lock:
                    self._transport_errors.append(
                        f"pull_row_sparse key {key}: {fail}")
            for kvs in self.kvw.take_response(ts):
                for i, _k in enumerate(kvs.keys):
                    data = np.asarray(kvs.vals[i], dtype=np.float32)
                    got = np.asarray(kvs.aux[i], dtype=np.int64).ravel() \
                        if kvs.aux[i] is not None else ids
                    if got.size:
                        rows = data.reshape(got.size, -1)
                        if got.size == ids.size and (got == ids).all():
                            out[:] = rows       # common case: echo order
                        else:
                            with self._lock:
                                self._transport_errors.append(
                                    f"pull_row_sparse key {key}: server "
                                    f"served {got.size}/{ids.size} rows")
                            pos = {int(r): j for j, r in enumerate(got)}
                            for j, rid in enumerate(ids):
                                if int(rid) in pos:
                                    out[j] = rows[pos[int(rid)]]
            done.set()
            self._untrack(key)

        def issue():
            self.kvw.pull([key], sh.server_rank, offsets=[sh.offset],
                          totals=[sh.total], lens=[row_len],
                          priority=priority, compr="rsp", aux=[ids],
                          cb=on_data)

        self._issue_after_push_acks(key, issue)
        if not done.wait(timeout):
            raise TimeoutError(f"pull_row_sparse of key {key} timed out")
        return out

    # -- element-sparse push/pull (the TPU-native BSC wire) ---------------
    # The device-resident trainer (geomx_tpu_torch.trainer_device) selects
    # top-k gradient coordinates ON THE CHIP; shipping them to the party
    # server as a dense scatter would put O(total) bytes on the LAN hop
    # and O(total) host allocations per round.
    # Wire format: tag "bsc" — vals = selected values, aux = within-shard
    # element indices (int32). The server's generic push decompression
    # (compression._generic_decompress) scatters to dense for
    # aggregation; a "bsc"-tagged pull returns the aggregated gradient's
    # exact nonzero set (server._pull_response_action). Semantically
    # identical to a dense push of the scattered selection — only the
    # bytes differ.

    def push_bsc(self, key, values, indices, priority: int = 0) -> None:
        """Push a sparse gradient selection: ``values[j]`` belongs at
        flat position ``indices[j]`` of this key. Aggregates by sum with
        other workers' selections (server scatters to dense)."""
        vals = np.ascontiguousarray(values, dtype=np.float32).ravel()
        idx = np.asarray(indices, dtype=np.int64).ravel()
        assert vals.size == idx.size, "values/indices length mismatch"
        info = self._key_info.get(key)
        assert info is not None, f"push_bsc of key {key} before init"
        if idx.size and (idx.min() < 0 or idx.max() >= info.total):
            raise IndexError(
                f"push_bsc: indices out of range for key {key} "
                f"({info.total} elements)")
        with self._lock:
            self._push_acks_left[key] = (
                self._push_acks_left.get(key, 0) + len(info.shards))
        self._track(len(info.shards), key)
        for sh in info.shards:
            # every shard gets a push (possibly empty) — the server's FSA
            # round counts contributed elements per shard, so skipping an
            # empty shard would stall the round
            sel = (idx >= sh.offset) & (idx < sh.offset + sh.length)
            kvs = KVPairs(
                keys=[key], vals=[vals[sel]],
                aux=[(idx[sel] - sh.offset).astype(np.int32)],
                offsets=[sh.offset], totals=[sh.total],
                lens=[sh.length], compr="bsc")
            self.kvw.push(kvs, sh.server_rank, priority=priority,
                          cb=lambda ts, kk=key: self._on_push_ack(kk, ts))

    def pull_bsc(self, key, priority: int = 0, timeout: float = None):
        """Pull the aggregated gradient's nonzeros: returns
        ``(values float32, flat_indices int64)`` for this key. Ordered
        after this key's push acks like dense pulls. Falls back
        transparently when a server serves dense (e.g. optimizer-mode
        stores): nonzeros are extracted host-side."""
        timeout = self.cfg.op_timeout_s if timeout is None else timeout
        info = self._key_info.get(key)
        assert info is not None, f"pull_bsc of key {key} before init"
        parts: List = []
        done = threading.Event()
        remaining = [len(info.shards)]
        self._track(1, key)

        fails: List[str] = []

        def on_data(ts: int, sh: sharding.Shard):
            fail = self.kvw.take_failure(ts)
            if fail is not None:
                # recorded locally AND globally: join() raises this
                # call's own failures (and consumes nothing else); the
                # global list still surfaces them to a later wait() if
                # the caller never joins
                with self._lock:
                    fails.append(f"pull_bsc key {key}: {fail}")
                    self._transport_errors.append(
                        f"pull_bsc key {key}: {fail}")
            for kvs in self.kvw.take_response(ts):
                for i, _k in enumerate(kvs.keys):
                    data = np.asarray(kvs.vals[i],
                                      dtype=np.float32).ravel()
                    r_off = kvs.offset_of(i)
                    aux = kvs.aux[i] if i < len(kvs.aux) else None
                    if kvs.compr in ("bsc", "bsc16") and aux is not None:
                        gidx = (np.asarray(aux, np.int64).ravel() + r_off)
                        with self._lock:
                            parts.append((data, gidx))
                    else:
                        # dense response: extract nonzeros here
                        nz = np.nonzero(data)[0]
                        with self._lock:
                            parts.append((data[nz].astype(np.float32),
                                          nz + r_off))
            with self._lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                done.set()
                self._untrack(key)

        def issue():
            for sh in info.shards:
                self.kvw.pull([key], sh.server_rank, offsets=[sh.offset],
                              totals=[sh.total], lens=[sh.length],
                              priority=priority, compr="bsc",
                              cb=lambda ts, s=sh: on_data(ts, s))

        self._issue_after_push_acks(key, issue)

        def join():
            if not done.wait(timeout):
                raise TimeoutError(f"pull_bsc of key {key} timed out")
            with self._lock:
                errs = list(fails)
                if errs:
                    # consume from the global list too — this call's
                    # failure is surfaced here, not re-raised by every
                    # later wait()
                    self._transport_errors = [
                        e for e in self._transport_errors
                        if e not in fails]
            if errs:
                raise _give_up_exc(errs)("transport gave up on "
                                         + "; ".join(errs))
            with self._lock:
                got = list(parts)
            if not got:
                return (np.zeros(0, np.float32), np.zeros(0, np.int64))
            return (np.concatenate([p[0] for p in got]),
                    np.concatenate([p[1] for p in got]))

        return join

    def _prepare_bsc_shards(self, keys, values_list, indices_list,
                            wire_tag: str = "bsc"):
        """Validate per-key sparse selections and partition them into
        one KVPairs per server (shared by the separate and combined BSC
        wire sends). ``wire_tag="bsc16"`` ships the selected values as
        float16 (the quantized combined wire; indices stay int32) — the
        trainer's device-side error feedback makes the narrowing
        lossless on the wire (trainer_device.select)."""
        per_server: Dict[int, KVPairs] = {}
        server_keys: Dict[int, List[int]] = {}
        prepared = []
        for k, values, indices in zip(keys, values_list, indices_list):
            vals = np.ascontiguousarray(values, dtype=np.float32).ravel()
            idx = np.asarray(indices, dtype=np.int64).ravel()
            assert vals.size == idx.size, "values/indices mismatch"
            info = self._key_info.get(k)
            assert info is not None, f"push_bsc of key {k} before init"
            if idx.size and (idx.min() < 0 or idx.max() >= info.total):
                raise IndexError(
                    f"push_bsc: indices out of range for key {k}")
            prepared.append((k, vals, idx, info))
        for k, vals, idx, info in prepared:
            for sh in info.shards:
                sel = (idx >= sh.offset) & (idx < sh.offset + sh.length)
                kvs = per_server.setdefault(sh.server_rank,
                                            KVPairs(compr=wire_tag))
                kvs.keys.append(k)
                kvs.vals.append(vals[sel].astype(np.float16)
                                if wire_tag == "bsc16" else vals[sel])
                kvs.aux.append((idx[sel] - sh.offset).astype(np.int32))
                kvs.offsets.append(sh.offset)
                kvs.totals.append(sh.total)
                kvs.lens.append(sh.length)
                server_keys.setdefault(sh.server_rank, []).append(k)
        return per_server, server_keys

    def push_bsc_batch(self, keys, values_list, indices_list,
                       priority: int = 0) -> None:
        """Batched ``push_bsc``: one message per server carrying every
        key's sparse selection (same countdown-merged ack as the dense
        batched wire). Under ENABLE_P3 it fans out per key with
        descending priority, like the dense list form — one coalesced
        message would defeat the priority send thread's interleaving."""
        assert len(set(keys)) == len(keys), "duplicate keys in one round"
        if self.cfg.enable_p3:
            for i, (k, v, ix) in enumerate(zip(keys, values_list,
                                               indices_list)):
                self.push_bsc(k, v, ix, priority=priority - i)
            return
        per_server, server_keys = self._prepare_bsc_shards(
            keys, values_list, indices_list,
            wire_tag="bsc16" if self._wire.enabled() else "bsc")
        self._send_batch_pushes(per_server, server_keys, priority)

    def push_pull_bsc_batch(self, keys, values_list, indices_list,
                            priority: int = 0, timeout: float = None):
        """Combined sparse round (ZPushPull over the element-sparse BSC
        wire): one message per server per round; the countdown-merged
        ack carries the aggregate's exact nonzeros. Returns a ``join()
        -> {key: (values, flat_indices)}`` callable like
        ``pull_bsc_batch``. Falls back to the two-op sequence under
        ENABLE_P3 (per-key priority interleaving)."""
        timeout = self.cfg.op_timeout_s if timeout is None else timeout
        assert len(set(keys)) == len(keys), "duplicate keys in one round"
        if self.cfg.enable_p3:
            self.push_bsc_batch(keys, values_list, indices_list,
                                priority=priority)
            return self.pull_bsc_batch(keys, priority=priority,
                                       timeout=timeout)
        per_server, server_keys = self._prepare_bsc_shards(
            keys, values_list, indices_list,
            wire_tag="bsc16" if self._wire.enabled() else "bsc")
        rid = self._begin_round()
        parts: Dict[int, List] = {k: [] for k in keys}
        fails: List[str] = []
        done = threading.Event()
        remaining = [len(per_server)]
        with self._lock:
            for ks in server_keys.values():
                for k in ks:
                    self._push_acks_left[k] = (
                        self._push_acks_left.get(k, 0) + 1)
        for ks in server_keys.values():
            for k in ks:
                self._track(1, k)

        def on_resp(ts: int, srank: int):
            fail = self.kvw.take_failure(ts)
            if fail is not None:
                with self._lock:
                    fails.append(
                        f"push_pull_bsc keys "
                        f"{sorted(set(server_keys[srank]))}: {fail}")
                    self._transport_errors.append(fails[-1])
            for kvs in self.kvw.take_response(ts):
                for i, k in enumerate(kvs.keys):
                    data = np.asarray(kvs.vals[i],
                                      dtype=np.float32).ravel()
                    r_off = kvs.offset_of(i)
                    aux = kvs.aux[i] if i < len(kvs.aux) else None
                    if kvs.compr in ("bsc", "bsc16") and aux is not None:
                        entry = (data,
                                 np.asarray(aux, np.int64).ravel()
                                 + r_off)
                    else:
                        nz = np.nonzero(data)[0]
                        entry = (data[nz].astype(np.float32), nz + r_off)
                    with self._lock:
                        parts[k].append(entry)
            ready = []
            with self._lock:
                remaining[0] -= 1
                last = remaining[0] == 0
                for k in server_keys[srank]:
                    self._push_acks_left[k] -= 1
                    if (self._push_acks_left[k] == 0
                            and k in self._deferred):
                        ready.extend(self._deferred.pop(k))
            if last:
                done.set()
            for k in server_keys[srank]:
                self._untrack(k)
            for fn in ready:
                fn()

        for srank, kvs in per_server.items():
            self.kvw.push(kvs, srank, priority=priority, pull=True,
                          trace_round=rid,
                          cb=lambda ts, s=srank: on_resp(ts, s))

        expected_parts = {k: sum(1 for ks in server_keys.values()
                                 if k in ks) for k in keys}

        def join():
            if not done.wait(timeout):
                raise TimeoutError("push_pull_bsc_batch timed out")
            with self._lock:
                errs = list(fails)
                if errs:
                    self._transport_errors = [
                        e for e in self._transport_errors
                        if e not in fails]
            if errs:
                raise _give_up_exc(errs)("transport gave up on "
                                         + "; ".join(errs))
            out = {}
            with self._lock:
                got = {k: list(v) for k, v in parts.items()}
            short = [k for k in keys
                     if len(got[k]) < expected_parts[k]]
            if short:
                # a server acked without data for these keys: a missing
                # entry is NOT an empty aggregate — re-pull explicitly
                agg = self.pull_bsc_batch(short, timeout=timeout)()
                for k in short:
                    got[k] = [agg[k]]
            for k, ps in got.items():
                if not ps:
                    out[k] = (np.zeros(0, np.float32),
                              np.zeros(0, np.int64))
                else:
                    out[k] = (np.concatenate([p[0] for p in ps]),
                              np.concatenate([p[1] for p in ps]))
            return out

        return join

    def push_pull_bsc_batch_async(self, keys, values_list, indices_list,
                                  priority: int = 0,
                                  slice_bytes: Optional[int] = None
                                  ) -> RoundFuture:
        """Non-blocking chunked combined sparse round (the P3-pipelined
        form of :meth:`push_pull_bsc_batch`): keys group in layer order
        into ~``slice_bytes``-byte chunks (~8 wire bytes per selected
        element; default ``cfg.p3_slice_bytes``, <= 0 = one chunk), one
        message per (chunk, server) at descending priority. Keys stay
        WHOLE — the server FSA counts one push per (key, shard) per
        worker per round, so intra-key splitting would double-count.
        Returns a :class:`RoundFuture` whose per-key result is
        ``(values float32, flat_indices int64)``, completing each key as
        its last response lands — apply key i while key j is still on
        the wire. Give-ups surface through ``fut.wait()``."""
        assert len(set(keys)) == len(keys), "duplicate keys in one round"
        keys = list(keys)
        sb = self.cfg.p3_slice_bytes if slice_bytes is None else slice_bytes
        sizes = [np.asarray(v).size * 8 for v in values_list]
        chunks = plan_chunks(
            list(range(len(keys))), sizes, sb, base_priority=priority,
            codec_for=(self._wire.chunk_codec if self._wire.enabled()
                       else None))
        rid = self._begin_round()
        fut = RoundFuture(keys, consume=self._consume_errors,
                          max_retries=self.cfg.chunk_retries,
                          on_abort=self._abort_round)
        parts: Dict[int, List] = {k: [] for k in keys}
        expected_parts: Dict[int, int] = {}
        msgs = []  # (mid, cid, srank, kvs, msg_keys, chunk_priority)
        key_msgs: Dict[int, List[int]] = {k: [] for k in keys}
        for ch in chunks:
            cks = [keys[i] for i in ch.items]
            # sparse chunks have exactly two widths: raw fp32 values
            # ("bsc") or fp16 values ("bsc16") — any active wire codec
            # maps to the narrow one (indices dominate past that)
            per_server, server_keys = self._prepare_bsc_shards(
                cks, [values_list[i] for i in ch.items],
                [indices_list[i] for i in ch.items],
                wire_tag="bsc16" if ch.codec else "bsc")
            for srank, kvs in per_server.items():
                mid = len(msgs)
                for k in set(server_keys[srank]):
                    key_msgs[k].append(mid)
                for k in server_keys[srank]:
                    expected_parts[k] = expected_parts.get(k, 0) + 1
                msgs.append((mid, ch.cid, srank, kvs,
                             server_keys[srank], ch.priority))
        msgs_left = {k: len(key_msgs[k]) for k in keys}
        with self._lock:
            for _mid, _cid, _srank, _kvs, mks, _p in msgs:
                for k in mks:
                    self._push_acks_left[k] = (
                        self._push_acks_left.get(k, 0) + 1)
        for _mid, _cid, _srank, _kvs, mks, _p in msgs:
            for k in mks:
                self._track(1, k)

        def on_resp(ts: int, mid: int):
            _m, cid, srank, m_kvs, mks, m_prio = msgs[mid]
            fail = self.kvw.take_failure(ts)
            # same bounded retry as push_pull_async's on_resp: re-issue
            # the identical chunk message while the budget lasts, except
            # to declared-dead peers (epoch recovery handles those)
            if (fail is not None and "declared dead" not in fail
                    and fut.retry_budget(cid)):
                log.warning("push_pull_bsc_async chunk %d to server %d "
                            "failed (%s); retry %d/%d", cid, srank,
                            fail, fut.retries_used(cid), fut.max_retries)
                telemetry.event("chunk.retry", cat="kvstore",
                                chunk=cid, server=srank)
                telemetry.counter_inc("chunk.retries")
                self.kvw.push(m_kvs, srank, priority=m_prio, pull=True,
                              trace_round=rid, trace_chunk=cid,
                              cb=lambda ts2, m=mid: on_resp(ts2, m))
                return
            failed_keys = []
            if fail is not None:
                with self._lock:
                    for k in sorted(set(mks)):
                        err = f"push_pull_bsc_async key {k}: {fail}"
                        self._transport_errors.append(err)
                        failed_keys.append((k, err))
            for k, err in failed_keys:
                fut.add_error(k, err)   # future methods outside _lock
            with profiler.chunk_scope("recv", cid, server=srank):
                for kvs in self.kvw.take_response(ts):
                    for i, k in enumerate(kvs.keys):
                        data = np.asarray(kvs.vals[i],
                                          dtype=np.float32).ravel()
                        r_off = kvs.offset_of(i)
                        aux = kvs.aux[i] if i < len(kvs.aux) else None
                        if kvs.compr in ("bsc", "bsc16") and aux is not None:
                            entry = (data,
                                     np.asarray(aux, np.int64).ravel()
                                     + r_off)
                        else:
                            nz = np.nonzero(data)[0]
                            entry = (data[nz].astype(np.float32),
                                     nz + r_off)
                        with self._lock:
                            parts[k].append(entry)
            finished = []
            ready = []
            with self._lock:
                for k in set(mks):
                    msgs_left[k] -= 1
                    if msgs_left[k] == 0:
                        finished.append(k)
                for k in mks:
                    self._push_acks_left[k] -= 1
                    if (self._push_acks_left[k] == 0
                            and k in self._deferred):
                        ready.extend(self._deferred.pop(k))
            for k in mks:
                self._untrack(k)
            for fn in ready:
                fn()
            short = []
            for k in finished:
                with self._lock:
                    ps = list(parts[k])
                if fut.errors(k):
                    # data is never coming: complete so joins raise
                    fut.complete_key(k, (np.zeros(0, np.float32),
                                         np.zeros(0, np.int64)))
                elif len(ps) < expected_parts[k]:
                    # a server acked without data — a missing entry is
                    # NOT an empty aggregate; async re-pull (this runs
                    # on a transport thread: never block here)
                    short.append(k)
                elif not ps:
                    fut.complete_key(k, (np.zeros(0, np.float32),
                                         np.zeros(0, np.int64)))
                else:
                    fut.complete_key(
                        k, (np.concatenate([p[0] for p in ps]),
                            np.concatenate([p[1] for p in ps])))
            if short:
                self._repull_bsc_async(short, priority, fut)

        for mid, cid, srank, kvs, _mks, prio in msgs:
            with profiler.chunk_scope("send", cid, server=srank,
                                      keys=len(kvs.keys)):
                self.kvw.push(kvs, srank, priority=prio, pull=True,
                              trace_round=rid, trace_chunk=cid,
                              cb=lambda ts, m=mid: on_resp(ts, m))
        return fut

    def _repull_bsc_async(self, keys, priority: int,
                          fut: RoundFuture) -> None:
        """Async fallback pull for BSC keys whose combined ack came back
        short: per-server "bsc" pulls, completing each key on ``fut`` as
        its last response lands (the non-blocking twin of the
        pull_bsc_batch re-pull in push_pull_bsc_batch's join)."""
        per_server: Dict[int, KVPairs] = {}
        server_keys: Dict[int, List[int]] = {}
        for k in keys:
            info = self._key_info[k]
            for sh in info.shards:
                kvs = per_server.setdefault(sh.server_rank,
                                            KVPairs(compr="bsc"))
                kvs.keys.append(k)
                kvs.vals.append(np.zeros(0, np.float32))
                kvs.offsets.append(sh.offset)
                kvs.totals.append(sh.total)
                kvs.lens.append(sh.length)
                server_keys.setdefault(sh.server_rank, []).append(k)
        parts: Dict[int, List] = {k: [] for k in keys}
        msgs_left: Dict[int, int] = {}
        with self._lock:
            for srank, ks in server_keys.items():
                for k in set(ks):
                    msgs_left[k] = msgs_left.get(k, 0) + 1
        for ks in server_keys.values():
            for k in ks:
                self._track(1, k)

        def on_data(ts: int, srank: int):
            fail = self.kvw.take_failure(ts)
            failed_keys = []
            if fail is not None:
                with self._lock:
                    for k in sorted(set(server_keys[srank])):
                        err = f"pull_bsc key {k}: {fail}"
                        self._transport_errors.append(err)
                        failed_keys.append((k, err))
            for k, err in failed_keys:
                fut.add_error(k, err)
            for kvs in self.kvw.take_response(ts):
                for i, k in enumerate(kvs.keys):
                    data = np.asarray(kvs.vals[i],
                                      dtype=np.float32).ravel()
                    r_off = kvs.offset_of(i)
                    aux = kvs.aux[i] if i < len(kvs.aux) else None
                    if kvs.compr in ("bsc", "bsc16") and aux is not None:
                        entry = (data,
                                 np.asarray(aux, np.int64).ravel()
                                 + r_off)
                    else:
                        nz = np.nonzero(data)[0]
                        entry = (data[nz].astype(np.float32), nz + r_off)
                    with self._lock:
                        parts[k].append(entry)
            finished = []
            with self._lock:
                for k in set(server_keys[srank]):
                    msgs_left[k] -= 1
                    if msgs_left[k] == 0:
                        finished.append(k)
            for k in server_keys[srank]:
                self._untrack(k)
            for k in finished:
                with self._lock:
                    ps = list(parts[k])
                if not ps:
                    fut.complete_key(k, (np.zeros(0, np.float32),
                                         np.zeros(0, np.int64)))
                else:
                    fut.complete_key(
                        k, (np.concatenate([p[0] for p in ps]),
                            np.concatenate([p[1] for p in ps])))

        for srank, kvs in per_server.items():
            def issue(sr=srank, kv=kvs):
                self.kvw.pull(kv.keys, sr, offsets=kv.offsets,
                              totals=kv.totals, lens=kv.lens,
                              priority=priority, compr="bsc",
                              cb=lambda ts, s=sr: on_data(ts, s))

            self._issue_after_push_acks(set(server_keys[srank]), issue)

    def pull_bsc_batch(self, keys, priority: int = 0,
                       timeout: float = None):
        """Batched ``pull_bsc``: one request per server; returns a
        ``join() -> {key: (values, flat_indices)}`` callable. Under
        ENABLE_P3 it fans out per key (see push_bsc_batch)."""
        timeout = self.cfg.op_timeout_s if timeout is None else timeout
        assert len(set(keys)) == len(keys), "duplicate keys in one call"
        if self.cfg.enable_p3:
            joins = [(k, self.pull_bsc(k, priority=priority - i,
                                       timeout=timeout))
                     for i, k in enumerate(keys)]

            def join_all():
                return {k: j() for k, j in joins}

            return join_all
        per_server: Dict[int, KVPairs] = {}
        server_keys: Dict[int, List[int]] = {}
        for k in keys:
            info = self._key_info.get(k)
            assert info is not None, f"pull_bsc of key {k} before init"
            for sh in info.shards:
                kvs = per_server.setdefault(sh.server_rank,
                                            KVPairs(compr="bsc"))
                kvs.keys.append(k)
                kvs.vals.append(np.zeros(0, np.float32))
                kvs.offsets.append(sh.offset)
                kvs.totals.append(sh.total)
                kvs.lens.append(sh.length)
                server_keys.setdefault(sh.server_rank, []).append(k)
        parts: Dict[int, List] = {k: [] for k in keys}
        fails: List[str] = []
        done = threading.Event()
        remaining = [len(per_server)]
        # tracked per (server, shard) entry, untracked the same way on
        # that server's response — symmetric with _on_batch_push_ack
        for ks in server_keys.values():
            for k in ks:
                self._track(1, k)

        def on_data(ts: int, srank: int):
            fail = self.kvw.take_failure(ts)
            if fail is not None:
                with self._lock:
                    fails.append(
                        f"pull_bsc keys {sorted(set(server_keys[srank]))}"
                        f": {fail}")
                    self._transport_errors.append(fails[-1])
            for kvs in self.kvw.take_response(ts):
                for i, k in enumerate(kvs.keys):
                    # array work OUTSIDE the store lock (it serializes
                    # every transport callback on this worker)
                    data = np.asarray(kvs.vals[i],
                                      dtype=np.float32).ravel()
                    r_off = kvs.offset_of(i)
                    aux = kvs.aux[i] if i < len(kvs.aux) else None
                    if kvs.compr in ("bsc", "bsc16") and aux is not None:
                        entry = (data,
                                 np.asarray(aux, np.int64).ravel()
                                 + r_off)
                    else:
                        nz = np.nonzero(data)[0]
                        entry = (data[nz].astype(np.float32), nz + r_off)
                    with self._lock:
                        parts[k].append(entry)
            last = False
            with self._lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                done.set()
            for k in server_keys[srank]:
                self._untrack(k)

        for srank, kvs in per_server.items():
            def issue(sr=srank, kv=kvs):
                self.kvw.pull(kv.keys, sr, offsets=kv.offsets,
                              totals=kv.totals, lens=kv.lens,
                              priority=priority, compr="bsc",
                              cb=lambda ts, s=sr: on_data(ts, s))

            self._issue_after_push_acks(set(server_keys[srank]), issue)

        def join():
            if not done.wait(timeout):
                raise TimeoutError("pull_bsc_batch timed out")
            with self._lock:
                errs = list(fails)
                if errs:
                    self._transport_errors = [
                        e for e in self._transport_errors
                        if e not in fails]
            if errs:
                raise _give_up_exc(errs)("transport gave up on "
                                         + "; ".join(errs))
            out = {}
            with self._lock:
                got = {k: list(v) for k, v in parts.items()}
            for k, ps in got.items():
                if not ps:
                    out[k] = (np.zeros(0, np.float32),
                              np.zeros(0, np.int64))
                else:
                    out[k] = (np.concatenate([p[0] for p in ps]),
                              np.concatenate([p[1] for p in ps]))
            return out

        return join

    def wait(self, keys=None, timeout: float = None) -> None:
        """Block until outstanding pushes/pulls complete. With ``keys``,
        drain only those keys (reference per-key WaitToRead semantics);
        without, drain everything (the mx.nd.waitall() moment)."""
        timeout = self.cfg.op_timeout_s if timeout is None else timeout
        if keys is not None:
            klist = self._as_key_list(keys)
            with self._cv:
                if not self._cv.wait_for(
                    lambda: all(self._outstanding_key.get(k, 0) <= 0
                                for k in klist),
                    timeout,
                ):
                    left = {k: self._outstanding_key.get(k, 0)
                            for k in klist if self._outstanding_key.get(k, 0)}
                    raise TimeoutError(f"wait(keys): still outstanding {left}")
        else:
            with self._cv:
                if not self._cv.wait_for(lambda: self._outstanding <= 0,
                                         timeout):
                    raise TimeoutError(
                        f"wait: {self._outstanding} ops still outstanding")
        with self._lock:
            errs, self._transport_errors = self._transport_errors, []
        if errs:
            raise _give_up_exc(errs)("transport gave up on " + "; ".join(errs))

    waitall = wait

    # -- control plane ---------------------------------------------------

    def set_optimizer(self, optimizer) -> None:
        """Ship the optimizer to the server tier that applies updates:
        the master worker in HiPS topologies (reference: kvstore.py:452 +
        kvstore_dist_server.h kController), rank 0 in single-tier PS."""
        if self.cfg.has_global_tier or self.cfg.is_master_worker:
            assert self.is_master_worker, \
                "set_optimizer must run on the master worker in HiPS mode"
        else:
            assert self.rank == 0, "set_optimizer must run on rank 0"
        self._optimizer = optimizer  # kept for save_optimizer_states
        body = pickle.dumps(optimizer).hex()
        self._send_command(Command.CONTROLLER, body)

    def set_gradient_compression(self, compression_params: Dict) -> None:
        super().set_gradient_compression(compression_params)
        if self.is_master_worker:
            import json
            self._send_command(Command.SET_GRADIENT_COMPRESSION,
                               json.dumps(self._compression_params))

    def set_multi_precision(self, multi_precision: bool = True) -> None:
        """Keep fp32 master weights server-side for sub-fp32 models
        (reference: kvstore.py sends kSetMultiPrecision when the
        optimizer has multi_precision and weights are fp16; handled at
        kvstore_dist_server.h:324). Send from the node that ships the
        optimizer (master worker in HiPS, rank 0 single-tier)."""
        if self.is_master_worker or (not self.cfg.has_global_tier
                                     and self.rank == 0):
            self._send_command(Command.SET_MULTI_PRECISION,
                               "1" if multi_precision else "0")

    # -- optimizer state persistence (reference: kvstore.py:566/582) -----
    # In HiPS the LIVE optimizer states live on the server that applies
    # updates (its unpickled updater copy), not on this worker — so dump/
    # restore is a command round-trip. States are kept per-server (keyed
    # by server rank) because sharded keys have independent per-shard
    # states on each server.

    def save_optimizer_states(self, fname: str) -> None:
        import json

        from geomx_tpu_torch import checkpoint

        ts = self.kvw.request(Command.GET_OPTIMIZER_STATES, "",
                              psbase.SERVER_GROUP)
        self.kvw.wait(ts, 120.0)
        # each local server answers {global_rank: states_hex} — party
        # servers relay to the global tier (where the live updater runs)
        # and may return overlapping ranks; merging dedups them
        per_server: Dict[str, str] = {}
        for body in self.kvw.take_response_bodies(ts):
            per_server.update(json.loads(body))
        checkpoint._atomic_write(
            fname, json.dumps(per_server).encode())

    def metrics(self, timeout: float = 30.0) -> Dict[str, object]:
        """Pull telemetry snapshots over the command channel: this
        worker's own registry plus one per local server that answers
        (Command.METRICS). Returns ``{"worker": snap,
        "servers": [snap, ...]}`` — snapshots are the plain-dict form of
        :func:`geomx_tpu_torch.telemetry.snapshot`."""
        import json

        ts = self.kvw.request(Command.METRICS, "", psbase.SERVER_GROUP)
        self.kvw.wait(ts, timeout)
        servers = [json.loads(b)
                   for b in self.kvw.take_response_bodies(ts) if b]
        return {"worker": telemetry.snapshot(), "servers": servers}

    def health(self, timeout: float = 30.0) -> Dict[str, object]:
        """Pull the cluster health boards (``ps/linkstate.py``) over the
        command channel: the LOCAL tier's board straight from this
        party's scheduler, plus the GLOBAL tier's board relayed through
        any party server that is a member of both tiers
        (Command.HEALTH). Returns ``{"local": board_or_None,
        "global": [board, ...]}`` — boards are the plain-dict form of
        ``ClusterHealthBoard.render``; None/empty when GEOMX_HEALTH is
        off or the tier has no board yet."""
        import json

        ts = self.kvw.request(Command.HEALTH, "", psbase.SCHEDULER)
        self.kvw.wait(ts, timeout)
        local = None
        for b in self.kvw.take_response_bodies(ts):
            if b and b != "{}":
                local = json.loads(b)
        ts = self.kvw.request(Command.HEALTH, "", psbase.SERVER_GROUP)
        self.kvw.wait(ts, timeout)
        glob = [json.loads(b)
                for b in self.kvw.take_response_bodies(ts)
                if b and b != "{}"]
        return {"local": local, "global": glob}

    def load_optimizer_states(self, fname: str) -> None:
        with open(fname, "rb") as f:
            body = f.read().decode()
        self._send_command(Command.SET_OPTIMIZER_STATES, body)

    def set_profiler_params(self, cmd: int, **params) -> None:
        """Remotely drive the SERVER-side profilers (reference:
        kvstore_dist.h:197-203 kSetProfilerParams; cmd is one of
        profiler.CMD_SET_CONFIG/CMD_STATE/CMD_PAUSE/CMD_DUMP)."""
        import json

        self._send_command(Command.SET_PROFILER_PARAMS,
                           json.dumps({"cmd": cmd, "params": params}))

    def _send_command(self, head: int, body: str) -> None:
        ts = self.kvw.request(head, body, psbase.SERVER_GROUP)
        self.kvw.wait(ts, 120.0)

    def esync_state(self, tau_s: float, c_s: float) -> int:
        """Report this worker's measured per-step compute time and sync
        round-trip to the ESync state server (rank-0 local PS); returns
        the assigned local step count M_i (geomx_tpu_torch.esync). The
        body is JSON, so either package's server answers it."""
        import json

        ts = self.kvw.request(Command.ESYNC_STATE,
                              json.dumps({"tau": tau_s, "c": c_s}),
                              psbase.server_rank_to_id(0))
        self.kvw.wait(ts, 120.0)
        bodies = self.kvw.take_response_bodies(ts)
        return int(bodies[0]) if bodies else 1

    def barrier(self, is_global: bool = False) -> None:
        if is_global:
            # all-party barrier relayed through the servers: every worker of
            # every party must call this (reference: Barrier(is_global),
            # kvstore_dist.h:208-211)
            self._send_command(Command.GLOBAL_BARRIER, "")
        else:
            self.po.barrier(psbase.WORKER_GROUP)

    def close(self) -> None:
        if getattr(self, "_closed", False):
            return
        self._closed = True
        # a crashed (stopped) van can neither flush pending ops nor
        # reach the scheduler: skip the goodbye protocol entirely
        # instead of serially bleeding through the op, command and
        # barrier timeouts — a chaos-crashed worker's atexit must exit
        # promptly, not minutes later
        dead = self.po.van.stopped.is_set()
        if not dead:
            try:
                self.wait(timeout=30.0)
            except TimeoutError:
                pass
            # the master worker must NOT stop its local server (= the
            # global server); party rank-0 workers do (reference:
            # kvstore_dist.h:76-82)
            if self.rank == 0 and not self.is_master_worker:
                try:
                    self._send_command(Command.STOP_SERVER, "")
                except (TimeoutError, OSError):
                    pass
        self.po.finalize(do_barrier=not dead)

    def __del__(self):
        pass  # explicit close() required; avoid surprises at gc time
