"""TSEngine: adaptive communication-overlay scheduling.

A ground-up re-implementation of the reference's TSEngine (reference:
3rdparty/ps-lite/src/van.cc:1197-1458 ProcessAskPush/PullCommand — the
scheduler-side matchmaking with throughput matrix ``A``, greedy-vs-random
selection via ``MAX_GREED_RATE_TS``; include/ps/kv_app.h:234-246 the ZPush
TS branch, :508-659 TS_Push/AutoPullUpdate relays, :1440 TS_Process, :1694
AutoPull; src/kvstore/kvstore_dist.h:91-121 WorkersMerge).

The idea: instead of every worker pushing its gradient to the server
(N-to-1 incast) and the server answering N pulls (1-to-N outcast), the
scheduler builds an ADAPTIVE OVERLAY:

- **push**: workers (or, on the inter-DC tier, party servers acting as
  global workers) ask the scheduler who to send to; the scheduler pairs
  askers so gradients merge in a reduction tree shaped by measured link
  throughput; the last holder pushes the fully-merged gradient to the
  server with ``num_merge`` = contributions it carries;
- **pull**: after a round completes the server asks the scheduler for a
  receiver, sends the fresh model to that one node, and every receiving
  node itself becomes a disseminator (asks the scheduler, forwards),
  growing a multicast tree; workers obtain the model from their local slot
  via :meth:`TSNode.auto_pull` instead of pulling from the server.

Protocol (all control-plane messages ride the van's control path):

- ``ASKPUSH``  worker -> scheduler  body = {key, off, ver, nm, tgt, rep}
- ``ASKPULL``  holder -> scheduler  body = {key, off, ver, rep}
- ``REPLY``    scheduler -> asker   body = {kind, key, off, ver, dest}
  (dest: node id to send to; 0 = "push to the server tier"; -1 = done)

Data-plane hops are ordinary KV requests with ``meta.head`` in
{DATA_TS_RELAY, DATA_TS_MODEL} so they reuse framing, acks, DGT and P3.

Divergences from the reference, by design: the busy-vector ``B`` is
subsumed by removing paired nodes from the pending set (a node re-enters
only by re-asking); throughput is measured sender-side per relay hop and
piggybacked on the next ask instead of a dedicated feedback verb.
"""

from __future__ import annotations

import json
import logging
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from geomx_tpu_torch import telemetry
from geomx_tpu_torch.ps import base, linkstate, locks
from geomx_tpu_torch.ps.kv_app import KVPairs
from geomx_tpu_torch.ps.message import Control, Message, Meta

log = logging.getLogger("geomx.tsengine")

# data-plane cmd heads (share the namespace of kvstore.base DATA_*)
DATA_TS_RELAY = 2   # gradient relay hop between peers (WorkersMerge)
DATA_TS_MODEL = 3   # model dissemination hop (AutoPullUpdate)

SERVER_DEST = 0     # REPLY dest sentinel: "push to the server tier"
DONE_DEST = -1      # REPLY dest sentinel: "no receiver left"

_EWMA = 0.3         # throughput smoothing (reference uses per-link EWMA)


@locks.guarded_by("_lock", "A", "_push_rounds", "_pull_rounds")
class TSScheduler:
    """Scheduler-side matchmaking (reference: van.cc:1197-1458).

    Attached to the scheduler node's van; one instance per tier overlay.
    """

    def __init__(self, van, num_workers: int, greed_rate: float = 0.9,
                 avoid_degraded: bool = False):
        self.van = van
        self.num_workers = num_workers
        self.greed = min(max(greed_rate, 0.0), 1.0)
        # self-tuning transport (GEOMX_TRANSPORT_CONTROLLER): when the
        # colocated health board has a link latched degraded, route the
        # overlay around it — the link_degraded detector as an input,
        # not just an alert. Off = the plain matchmaking.
        self.avoid_degraded = avoid_degraded
        self._lock = locks.make_lock("TSScheduler._lock")
        # measured throughput matrix A: (src_id, dst_id) -> MB/s EWMA
        self.A: Dict[Tuple[int, int], float] = {}
        # (key, off, ver) -> pending push asker node ids (round completion
        # is detected from the incoming ask's nm, not scheduler-side sums)
        self._push_rounds: Dict[Tuple[int, int, int], set] = {}
        # (key, off, ver) -> set of worker ids already assigned the model
        self._pull_rounds: Dict[Tuple[int, int, int], set] = {}
        self._rng = random.Random(0x75)

    # -- inbound (wired as van.ts_handler on the scheduler) --------------

    def handle(self, msg: Message) -> None:
        try:
            d = json.loads(msg.meta.body) if msg.meta.body else {}
        except ValueError:
            log.warning("malformed TS ask body from %d", msg.meta.sender)
            return
        sender = msg.meta.sender
        for dst, mbps in d.get("rep", []):
            self._update_tput(sender, int(dst), float(mbps))
        if msg.meta.control_cmd == Control.ASKPUSH:
            self._ask_push(sender, d)
        elif msg.meta.control_cmd == Control.ASKPULL:
            self._ask_pull(sender, d)

    def _update_tput(self, src: int, dst: int, mbps: float) -> None:
        with self._lock:
            old = self.A.get((src, dst))
            self.A[(src, dst)] = (mbps if old is None
                                  else _EWMA * old + (1 - _EWMA) * mbps)

    # -- push matchmaking (reference: ProcessAskPushCommand) -------------

    def _ask_push(self, sender: int, d: dict) -> None:
        key, off, ver = int(d["key"]), int(d.get("off", 0)), int(d["ver"])
        nm, tgt = int(d.get("nm", 1)), int(d.get("tgt", self.num_workers))
        replies: List[Tuple[int, int]] = []  # (to, dest)
        bad = self._degraded()  # board lock stays outside ours
        rerouted: List[Tuple[int, int]] = []
        with self._lock:
            self._prune(self._push_rounds, key, off, ver)
            if nm >= tgt:
                self._push_rounds.pop((key, off, ver), None)
                replies.append((sender, SERVER_DEST))
            else:
                pend = self._push_rounds.setdefault((key, off, ver), set())
                pend.add(sender)
                while len(pend) >= 2:
                    s, r = self._pick_pair(pend, bad, rerouted)
                    pend.discard(s)
                    pend.discard(r)
                    replies.append((s, r))
        for s, r in rerouted:
            self._note_reroute("push", s, r)
        for to, dest in replies:
            self._reply(to, "push", key, off, ver, dest)

    def _degraded(self) -> frozenset:
        """Latched-degraded (src, dst) pairs from the colocated health
        board; empty when the bias is off or no board runs here. Called
        BEFORE taking our lock (the board has its own)."""
        board = getattr(self.van, "healthboard", None)
        if not self.avoid_degraded or board is None:
            return frozenset()
        return board.degraded_links()

    def _note_reroute(self, kind: str, s: int, r: int) -> None:
        telemetry.event("transport.reroute", cat="transport", kind=kind,
                        src=s, dst=r)
        rec = getattr(self.van, "flightrec", None)
        if rec is not None:
            rec.record("transport_reroute", kind=kind, src=s, dst=r)

    def _pick_pair(self, pend: set, bad: frozenset = frozenset(),
                   rerouted: Optional[list] = None) -> Tuple[int, int]:
        """Choose (sender, receiver) among pending askers: greedy by the
        throughput matrix with probability ``greed``, uniformly random
        otherwise so unmeasured links keep getting explored (reference:
        MAX_GREED_RATE_TS, van.cc:436-443). Pairs whose link is latched
        degraded on the health board are avoided while any clean pair
        remains (every-pair-degraded falls back to the plain pick — a
        stalled overlay is worse than a slow hop)."""
        ids = list(pend)
        pairs = [(s, r) for s in ids for r in ids if s != r]
        filtered = False
        if bad:
            good = [p for p in pairs if p not in bad]
            if good and len(good) < len(pairs):
                pairs, filtered = good, True
        if self._rng.random() >= self.greed:
            s, r = self._rng.sample(ids, 2)
            if filtered and (s, r) not in pairs:
                s, r = self._rng.choice(pairs)
                if rerouted is not None:
                    rerouted.append((s, r))
            return s, r
        # shuffling makes the argmax tie-break random, so links with no
        # measurement yet (A=0) are sampled instead of dict-order-pinned
        self._rng.shuffle(pairs)
        best, best_t = pairs[0], -1.0
        for s, r in pairs:
            t = self.A.get((s, r), 0.0)
            if t > best_t:
                best, best_t = (s, r), t
        if filtered and rerouted is not None:
            rerouted.append(best)
        return best

    # -- pull matchmaking (reference: ProcessAskPullCommand) -------------

    def _ask_pull(self, sender: int, d: dict) -> None:
        key, off, ver = int(d["key"]), int(d.get("off", 0)), int(d["ver"])
        bad = self._degraded()
        reroute = None
        with self._lock:
            self._prune(self._pull_rounds, key, off, ver)
            served = self._pull_rounds.setdefault((key, off, ver), set())
            cands = [base.worker_rank_to_id(r) for r in range(self.num_workers)]
            # never disseminate toward a declared-dead worker: the model
            # hop would park in the resender against a corpse and the
            # round's multicast tree stalls on the give-up timeout
            dead = self.van.declared_dead_ids()
            cands = [c for c in cands if c != sender and c not in served
                     and c not in dead]
            if not cands:
                # keep the completed round's served-set until _prune drops
                # it: senders re-ask from their ack callbacks, and popping
                # here would recreate empty state and restart the whole
                # dissemination in a livelock
                dest = DONE_DEST
            else:
                pool = cands
                if bad:
                    clean = [c for c in cands if (sender, c) not in bad]
                    if clean and len(clean) < len(cands):
                        pool = clean
                        reroute = sender
                if self._rng.random() < self.greed:
                    dest = max(pool, key=lambda c: self.A.get((sender, c), 0.0))
                else:
                    dest = self._rng.choice(pool)
                served.add(dest)
        if reroute is not None:
            self._note_reroute("pull", reroute, dest)
        self._reply(sender, "pull", key, off, ver, dest)

    # -- plumbing --------------------------------------------------------

    def _prune(self, rounds: dict, key: int, off: int, ver: int) -> None:
        """Drop stale round state for this (key, off) (bounded memory)."""
        for rk in [rk for rk in rounds
                   if rk[0] == key and rk[1] == off and rk[2] < ver - 2]:
            rounds.pop(rk, None)

    def _reply(self, to: int, kind: str, key: int, off: int, ver: int,
               dest: int) -> None:
        body = json.dumps({"kind": kind, "key": key, "off": off, "ver": ver,
                           "dest": dest}, separators=(",", ":"))
        try:
            self.van.send(Message(Meta(
                recver=to, control_cmd=Control.REPLY, body=body,
                is_global=self.van.is_global)))
        except OSError as e:
            log.warning("TS reply to %d failed: %s", to, e)


class _Slot:
    """Per-(key, off) TS state on a member node."""

    __slots__ = ("buf", "nm", "ver", "total", "model", "model_ver", "sent")

    def __init__(self):
        self.buf: Optional[np.ndarray] = None
        self.nm = 0          # merged contributions currently held
        self.ver = -1        # push round the buffer belongs to
        self.total = 0
        self.model: Optional[np.ndarray] = None
        self.model_ver = -1
        self.sent = False    # buffer relayed away / final-pushed this round


@locks.guarded_by("_lock", "_slots", "_reports", "_watches")
class TSNode:
    """Member-side TSEngine endpoint on one tier overlay.

    On the intra-DC tier: workers contribute gradients and auto_pull
    models; servers offer models. On the inter-DC tier: party servers
    (global workers) contribute their aggregates and watch for models;
    global servers offer models. One TSNode per (process, tier).

    ``kvw`` is the KVWorker used for data hops; the owner must route
    DATA_TS_* request heads into :meth:`handle_request` from the worker's
    request handle (reference: kvstore_dist.h:58 WorkersMerge binding).
    """

    def __init__(self, po, kvw, *, tgt_merge,
                 final_push: Optional[Callable] = None):
        self.po = po
        self.kvw = kvw
        # int OR zero-arg callable (e.g. po.num_live_workers): a static
        # count frozen at construction can never be satisfied once a
        # contributor dies mid-round (GX-P305), so owners pass the live
        # view and `tgt` re-evaluates per ask
        self._tgt_merge = tgt_merge
        # final_push(key, off, total, arr, num_merge, ver): deliver the
        # fully-merged gradient to the server tier (normal sharded push)
        self.final_push = final_push
        self._lock = locks.make_lock("TSNode._lock")
        self._cv = locks.make_condition(self._lock, name="TSNode._cv")
        self._slots: Dict[Tuple[int, int], _Slot] = {}
        self._reports: List[List[float]] = []
        # (key, off) -> [(min_ver, callback)] async model watches
        self._watches: Dict[Tuple[int, int], List[Tuple[int, Callable]]] = {}
        # owner hook: fired when this node's gradient round ends with a
        # relay hop (it handed its buffer to a peer); final pushes notify
        # through final_push's own acks instead
        self.on_push_sent: Optional[Callable[[int, int, int], None]] = None
        po.attach_ts(self)

    @property
    def tgt(self) -> int:
        t = self._tgt_merge() if callable(self._tgt_merge) \
            else self._tgt_merge
        return max(int(t), 1)

    # ------------------------------------------------------------------
    # push side (reference: ZPush TS branch kv_app.h:234-246)
    # ------------------------------------------------------------------

    def contribute(self, key: int, off: int, total: int, arr: np.ndarray,
                   ver: int, nm: int = 1) -> None:
        """Merge a local gradient into this round's buffer and ask the
        scheduler for a receiver (WorkersMerge self-merge)."""
        arr = np.ascontiguousarray(arr, dtype=np.float32).ravel()
        with self._lock:
            slot = self._slot(key, off)
            if slot.ver != ver:
                slot.buf = arr.copy()
                slot.nm = nm
                slot.ver = ver
                slot.sent = False
            else:
                slot.buf = slot.buf + arr if slot.buf is not None else arr.copy()
                slot.nm += nm
            slot.total = total or arr.size
            cur_nm = slot.nm
        self._ask_push(key, off, ver, cur_nm)

    def _ask_push(self, key: int, off: int, ver: int, nm: int) -> None:
        body = json.dumps({"key": key, "off": off, "ver": ver, "nm": nm,
                           "tgt": self.tgt, "rep": self._take_reports()},
                          separators=(",", ":"))
        self.po.van.send(Message(Meta(
            recver=base.SCHEDULER, control_cmd=Control.ASKPUSH, body=body,
            is_global=self.po.is_global)))

    def _on_push_reply(self, key: int, off: int, ver: int, dest: int) -> None:

        with self._lock:
            slot = self._slots.get((key, off))
            if slot is None or slot.ver != ver or slot.sent or slot.buf is None:
                return  # stale reply
            slot.sent = True
            arr, nm, total = slot.buf, slot.nm, slot.total
        if dest == SERVER_DEST:
            if self.final_push is not None:
                self.final_push(key, off, total, arr, nm, ver)
            return
        kvs = KVPairs(keys=[key], vals=[arr], offsets=[off], totals=[total],
                      lens=[arr.size])
        t0 = time.monotonic()
        nbytes = arr.nbytes

        def acked(_ts):
            self._hop_acked(dest, nbytes, t0)
            if self.on_push_sent is not None:
                self.on_push_sent(key, off, ver)

        self.kvw.push(kvs, recver_id=dest, cmd=DATA_TS_RELAY, version=ver,
                      num_merge=nm, cb=acked)

    def _hop_acked(self, dest: int, nbytes: int, t0: float) -> None:
        dt = max(time.monotonic() - t0, 1e-6)
        mb_s = nbytes / dt / 1e6
        # measured push->ack wall time: a shaped link's serialization +
        # RTT lands here, so the scheduler's throughput matrix — and
        # the link.* observability gauge (emitted via the linkstate
        # funnel, GX-M402) — reflect emulated WAN conditions
        linkstate.note_goodput(
            self.po.van.my_id, dest, mb_s,
            tier="global" if self.po.van.is_global else "local")
        with self._lock:
            self._reports.append([dest, mb_s])

    def _take_reports(self) -> List[List[float]]:
        with self._lock:
            out, self._reports = self._reports, []
        return out[-16:]

    # ------------------------------------------------------------------
    # data hops in (reference: WorkersMerge kvstore_dist.h:91-121 and
    # TS_Process kv_app.h:1440)
    # ------------------------------------------------------------------

    def handle_request(self, req, kvs, app) -> bool:
        """Route DATA_TS_* requests; returns False if not TS traffic."""
        if req.simple_app or not req.push:
            return False
        if req.head in (DATA_TS_RELAY, DATA_TS_MODEL) \
                and self.po.van.is_stale(req.sender, req.epoch):
            # zombie/pre-rejoin hop: drop WITHOUT ack (same fence as the
            # server's _handle_data) so a dead peer's relay cannot be
            # merged into a live round's slot countdown
            log.warning("TS: dropping stale hop from %d (epoch %d)",
                        req.sender, req.epoch)
            return True
        if req.head == DATA_TS_RELAY:
            for i, key in enumerate(kvs.keys):
                off = kvs.offset_of(i)
                val = np.asarray(kvs.vals[i]).ravel()
                total = kvs.total_of(i) or val.size
                with self._lock:
                    slot = self._slot(key, off)
                    if slot.ver < req.version:
                        slot.buf = val.astype(np.float32)
                        slot.nm = req.num_merge
                        slot.ver = req.version
                        slot.sent = False
                    elif slot.ver == req.version:
                        slot.buf = (slot.buf + val if slot.buf is not None
                                    else val.astype(np.float32))
                        slot.nm += req.num_merge
                    else:
                        app.response(req)  # stale hop: ack and drop
                        continue
                    slot.total = total
                    cur_nm = slot.nm
                app.response(req)
                self._ask_push(key, off, req.version, cur_nm)
            return True
        if req.head == DATA_TS_MODEL:
            for i, key in enumerate(kvs.keys):
                off = kvs.offset_of(i)
                val = np.asarray(kvs.vals[i]).ravel()
                total = kvs.total_of(i) or val.size
                self._store_model(key, off, total, val, req.version)
            app.response(req)  # AUTOPULLREPLY
            for i, key in enumerate(kvs.keys):
                off = kvs.offset_of(i)
                # become a disseminator (reference: AutoPullUpdate :1484)
                self._ask_pull(key, off, req.version)
            return True
        return False

    # ------------------------------------------------------------------
    # pull side (reference: DefaultAutoPull / AutoPullUpdate / AutoPull)
    # ------------------------------------------------------------------

    def offer_model(self, key: int, off: int, total: int, arr: np.ndarray,
                    ver: int) -> None:
        """Called by the model holder (server after a round, or a worker
        after receiving) to start/continue dissemination."""
        self._store_model(key, off, total, np.asarray(arr).ravel(), ver)
        self._ask_pull(key, off, ver)

    def _ask_pull(self, key: int, off: int, ver: int) -> None:
        body = json.dumps({"key": key, "off": off, "ver": ver,
                           "rep": self._take_reports()},
                          separators=(",", ":"))
        self.po.van.send(Message(Meta(
            recver=base.SCHEDULER, control_cmd=Control.ASKPULL, body=body,
            is_global=self.po.is_global)))

    def _on_pull_reply(self, key: int, off: int, ver: int, dest: int) -> None:

        if dest == DONE_DEST:
            return
        with self._lock:
            slot = self._slots.get((key, off))
            if slot is None or slot.model is None or slot.model_ver != ver:
                return  # model superseded; the new round has its own relay
            arr, total = slot.model, slot.total
        kvs = KVPairs(keys=[key], vals=[arr], offsets=[off], totals=[total],
                      lens=[arr.size])
        t0 = time.monotonic()
        nbytes = arr.nbytes

        def acked(_ts, k=key, o=off, v=ver):
            self._hop_acked(dest, nbytes, t0)
            self._ask_pull(k, o, v)  # loop: next receiver

        self.kvw.push(kvs, recver_id=dest, cmd=DATA_TS_MODEL, version=ver,
                      cb=acked)

    def _store_model(self, key: int, off: int, total: int,
                     arr: np.ndarray, ver: int) -> None:
        fire: List[Callable] = []
        with self._cv:
            slot = self._slot(key, off)
            if ver >= slot.model_ver:
                slot.model = np.asarray(arr, dtype=np.float32).ravel()
                slot.model_ver = ver
                slot.total = total or slot.total
            watches = self._watches.get((key, off), [])
            keep = []
            for min_ver, cb in watches:
                if slot.model_ver >= min_ver:
                    fire.append(cb)
                else:
                    keep.append((min_ver, cb))
            if keep:
                self._watches[(key, off)] = keep
            else:
                self._watches.pop((key, off), None)
            self._cv.notify_all()
        for cb in fire:
            cb()

    def auto_pull(self, key: int, off: int, min_ver: int,
                  timeout: float = 300.0) -> np.ndarray:
        """Blocking gather of the disseminated model (kv_app.h:1694).

        Must NOT be called from the customer receive thread (models arrive
        there) — worker user threads only.
        """
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._slots.get((key, off)) is not None
                and self._slots[(key, off)].model_ver >= min_ver, timeout)
            if not ok:
                raise TimeoutError(
                    f"auto_pull(key={key}, off={off}, ver>={min_ver}) timed out")
            return self._slots[(key, off)].model.copy()

    def when_model(self, key: int, off: int, min_ver: int,
                   cb: Callable[[], None]) -> None:
        """Async watch: run ``cb`` once a model with version >= min_ver is
        in the slot (safe from any thread; used by party servers)."""
        with self._cv:
            slot = self._slot(key, off)
            if slot.model_ver >= min_ver:
                pass  # fire below, outside the lock
            else:
                self._watches.setdefault((key, off), []).append((min_ver, cb))
                return
        cb()

    def model_of(self, key: int, off: int) -> Optional[np.ndarray]:
        with self._lock:
            slot = self._slots.get((key, off))
            return None if slot is None or slot.model is None \
                else slot.model.copy()

    # ------------------------------------------------------------------

    def on_control(self, msg: Message) -> None:
        """REPLY dispatch (wired as van.ts_handler on member nodes)."""
        if msg.meta.control_cmd != Control.REPLY:
            return
        try:
            d = json.loads(msg.meta.body)
        except ValueError:
            return
        key, off, ver = int(d["key"]), int(d.get("off", 0)), int(d["ver"])
        dest = int(d["dest"])
        if d.get("kind") == "push":
            self._on_push_reply(key, off, ver, dest)
        else:
            self._on_pull_reply(key, off, ver, dest)

    def _slot(self, key: int, off: int) -> _Slot:
        return self._slots.setdefault((key, off), _Slot())
