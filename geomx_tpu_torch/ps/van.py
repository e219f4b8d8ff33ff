"""The van: framed-TCP message router for one tier overlay.

Plays the role of ps-lite's ``Van``/``ZMQVan`` (reference:
3rdparty/ps-lite/src/van.cc:26-1497, src/zmq_van.h:41-516) for a single
overlay; a process participating in both HiPS tiers runs two vans (the
reference multiplexes both overlays through one Van with a second receiver
thread, van.cc:557-671 — we use two instances for isolation).

Responsibilities:
- listener socket + accept/reader threads; outbound connections dialed
  lazily per destination id;
- scheduler-side rendezvous: collect ADD_NODE registrations, assign ranks
  deterministically, broadcast the node table (reference: van.cc:41-234
  ProcessAddNodeCommandAtScheduler);
- counted group barriers (reference: van.cc:259-288);
- heartbeats and dead-node tracking (reference: van.cc:1128-1140);
- fault injection via PS_DROP_MSG (reference: van.cc:498-499, 871-877);
- optional priority-ordered sending thread (P3 — reference: van.cc:548,851);
- recovery: a node re-registering for a dead slot is handed the dead
  node's id with ``is_recovery=True`` (reference: van.cc:176-193).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import logging
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from geomx_tpu_torch import profiler, telemetry
from geomx_tpu_torch.ps import base
from geomx_tpu_torch.ps import dgt as dgt_mod
from geomx_tpu_torch.ps import faults as faults_mod
from geomx_tpu_torch.ps import locks
from geomx_tpu_torch.ps import native as native_mod
from geomx_tpu_torch.ps import linkstate as linkstate_mod
from geomx_tpu_torch.ps import resender as resender_mod
from geomx_tpu_torch.ps import shaping as shaping_mod
from geomx_tpu_torch.ps.flightrec import FlightRecorder
from geomx_tpu_torch.ps.message import (Control, Message, Meta, Node, Role,
                                  read_message)

log = logging.getLogger("geomx.van")

# How long a failed send to a peer that has dialled this node anew waits
# for the peer to move: a node that takes a dead slot (recovery) is
# announced to every member by the scheduler's table broadcast, and its
# first request can arrive before that broadcast does, so the answer to
# it would go to the dead holder's address.
ROUTE_CHANGE_WAIT_S = 5.0


@locks.guarded_by("_member_lock", "my_id", "is_recovery",
                  "membership_epoch", "_declared_dead", "_rejoin_epoch")
@locks.guarded_by("_stats_lock", "send_bytes", "recv_bytes",
                  "num_data_recv")
@locks.guarded_by("_conn_lock", "_conns")
@locks.guarded_by("_reg_lock", "_registrations")
@locks.guarded_by("_barrier_lock", "_barrier_done", "_barrier_members")
class Van:
    """One overlay's message router."""

    def __init__(
        self,
        *,
        my_role: int,
        is_global: bool,
        root_uri: str,
        root_port: int,
        num_workers: int,
        num_servers: int,
        bind_host: str = "127.0.0.1",
        advertise_host: str = "",
        drop_rate: float = 0.0,
        resend_timeout_s: float = 0.0,
        resend_deadline_s: float = 0.0,
        resend_backoff_max_s: float = 30.0,
        resend_jitter: float = 0.1,
        heartbeat_interval_s: float = 0.0,
        heartbeat_timeout_s: float = 60.0,
        epoch_grace_s: float = 0.0,
        use_priority_send: bool = False,
        verbose: int = 0,
        dgt: Optional[dict] = None,
        seed: Optional[int] = None,
        fault_plan: Optional["faults_mod.FaultPlan"] = None,
        shape_plan: Optional["shaping_mod.ShapePlan"] = None,
        wire_sanitizer: bool = False,
        state_sanitizer: bool = False,
        flightrec_size: int = 256,
        flightrec_dir: str = "",
        health: bool = False,
        health_dir: str = "",
        health_opts: Optional[dict] = None,
    ):
        self.my_role = my_role
        self.is_global = is_global
        self.root_uri = root_uri
        self.root_port = root_port
        self.num_workers = num_workers
        self.num_servers = num_servers
        self.bind_host = bind_host
        # the address peers DIAL (put into the broadcast node table) —
        # distinct from bind_host so a van can listen on every interface
        # (0.0.0.0) while advertising its DMLC_NODE_HOST (reference:
        # van.cc:427-477 Node.hostname from DMLC_NODE_HOST/interface IP)
        self.advertise_host = advertise_host or bind_host
        if self.advertise_host in ("0.0.0.0", ""):
            raise ValueError(
                "a van bound to 0.0.0.0 needs an explicit advertise "
                "address (DMLC_NODE_HOST) — peers cannot dial 0.0.0.0")
        self.drop_rate = drop_rate
        self.resend_timeout_s = resend_timeout_s
        self.resend_deadline_s = resend_deadline_s
        self.resend_backoff_max_s = resend_backoff_max_s
        self.resend_jitter = resend_jitter
        # ACK/retransmit layer (reference: resender.h, PS_RESEND)
        self._resender: Optional["resender_mod.Resender"] = None
        # per-van RNG for legacy PS_DROP_MSG injection: seeded from
        # PS_SEED (via faults.van_seed) so even the uniform drop is
        # reproducible; None keeps wall-clock entropy
        self.seed = seed
        self._rng = random.Random(seed)
        # declarative chaos (PS_FAULT_PLAN): consulted by every inbound
        # dispatch before the legacy drop_rate check
        self._faults = fault_plan.bind(self) if fault_plan is not None \
            else None
        # per-link RTT/bandwidth emulation (GEOMX_SHAPE_PLAN): consulted
        # by every inbound dispatch after the chaos layers — a frame a
        # fault drops was never on the wire, so it is never shaped
        self._shaper = shape_plan.bind(self) if shape_plan is not None \
            else None
        # fired (after stop()) when a FaultPlan crash rule kills this
        # van — the owner simulates full process death (e.g. a
        # KVStoreDistServer also drops its other tier's van)
        self.on_crash: Optional[Callable[[], None]] = None
        # inbound non-control frames accepted through the gate; chaos
        # tests use it to place crash points on exact message indices
        self.num_data_recv = 0
        # runtime wire sanitizer (GEOMX_WIRE_SANITIZER): checks the
        # dynamic duals of the GX-P3xx protocol invariants on this van's
        # send/recv path; report() runs at stop()
        self.sanitizer = None
        if wire_sanitizer:
            from geomx_tpu_torch.ps.sanitizer import WireSanitizer
            self.sanitizer = WireSanitizer(self)
        # crash flight recorder (GEOMX_FLIGHTREC_SIZE/_DIR): always-on
        # bounded ring of recent wire/membership events, dumped when the
        # van dies, a round aborts or the sanitizer flags a violation
        self.flightrec = FlightRecorder(self.node_tag, size=flightrec_size,
                                        out_dir=flightrec_dir)
        # runtime state-model conformance sanitizer
        # (GEOMX_STATE_SANITIZER): mirrors membership/epoch/recovery
        # transitions through the executable model the GX-S50x lint pass
        # freezes and tools/modelcheck.py explores; report() at stop()
        self.statecheck = None
        if state_sanitizer:
            from geomx_tpu_torch.ps.conformance import StateSanitizer
            self.statecheck = StateSanitizer(self)
        # geomx-healthd (GEOMX_HEALTH): every van continuously estimates
        # per-link RTT/goodput/loss from send→ack spans; non-schedulers
        # piggyback a digest on their HEARTBEAT frames, the scheduler
        # aggregates digests into the ClusterHealthBoard and runs the
        # anomaly detectors. Both stay None when the plane is off so the
        # wire hot path pays one attribute check.
        tier = "global" if is_global else "local"
        opts = health_opts or {}
        self.linkstate: Optional[linkstate_mod.LinkEstimator] = None
        self.healthboard: Optional[linkstate_mod.ClusterHealthBoard] = None
        if health:
            self.linkstate = linkstate_mod.LinkEstimator(
                lambda: self.my_id, tier,
                window=opts.get("window", 16))
            if my_role == Role.SCHEDULER:
                self.healthboard = linkstate_mod.ClusterHealthBoard(
                    tier, self.node_tag, out_dir=health_dir,
                    degrade_factor=opts.get("degrade_factor", 0.5),
                    straggler_rounds=opts.get("straggler_rounds", 1),
                    straggler_persist=opts.get("straggler_persist", 3),
                    rtx_burst=opts.get("rtx_burst", 5),
                    stall_s=opts.get("stall_s", 30.0),
                    flightrec=self.flightrec)
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.use_priority_send = use_priority_send
        self.verbose = verbose

        self.my_id: int = -1
        self.is_scheduler = my_role == Role.SCHEDULER
        # True when the scheduler handed us a dead node's slot (reference:
        # is_recovery, postoffice.h:161) — recovering nodes skip startup
        # barriers (the survivors won't join them again)
        self.is_recovery = False
        self.ready = threading.Event()
        self.stopped = threading.Event()

        # id -> (hostname, port); filled from the broadcast node table
        self.node_table: Dict[int, Tuple[str, int]] = {}
        self.node_roles: Dict[int, int] = {}

        # outbound connections: id -> (socket, send_lock)
        self._conns: Dict[int, Tuple[socket.socket, threading.Lock]] = {}
        self._conn_lock = locks.make_lock("Van._conn_lock")

        # scheduler rendezvous state
        self._registrations: List[Node] = []
        self._reg_lock = locks.make_lock("Van._reg_lock")
        # group -> ids whose barrier request arrived this round; a barrier
        # releases when every LIVE member of the group has arrived, so a
        # mid-barrier death cannot wedge the survivors
        self._barrier_members: Dict[int, set] = {}

        # member-side barrier release
        self._barrier_done: Dict[int, threading.Event] = {}
        self._barrier_lock = locks.make_lock("Van._barrier_lock")

        # heartbeat bookkeeping (scheduler side)
        self._heartbeats: Dict[int, float] = {}

        # -- membership epochs ------------------------------------------
        # The scheduler promotes a heartbeat lapse (after epoch_grace_s of
        # sustained silence) into a DEAD_NODE broadcast carrying the FULL
        # dead set plus a bumped epoch; every member mirrors the view
        # here. Zombie fencing: a push is stale when its sender is in the
        # dead set, or its epoch predates the sender's rejoin (is_stale).
        self.epoch_grace_s = epoch_grace_s
        self.membership_epoch = 0
        self._member_lock = locks.make_lock("Van._member_lock")
        self._declared_dead: set = set()
        # node id -> epoch at which its slot was re-filled; pushes from
        # the PREVIOUS holder of the id carry an older epoch and are
        # rejected even after the revival removes the id from the dead set
        self._rejoin_epoch: Dict[int, int] = {}
        # sender id -> the inbound connection its last frame came on, and
        # the senders heard on a new connection since the last send to
        # them went through (_heard_on; both under _stats_lock)
        self._inbound_conn: Dict[int, Any] = {}
        self._redialed: set = set()
        # owner hook fired (off the member lock) after every epoch change:
        # on_membership(epoch, dead_ids) — the Postoffice fans it out to
        # kvstore listeners (aggregation re-checks, esync pruning)
        self.on_membership: Optional[Callable[[int, frozenset], None]] = None

        # upward dispatch: set by Postoffice before start()
        self.msg_handler: Optional[Callable[[Message], None]] = None
        # notified with the original request Message when the resender
        # gives up on delivering it; Postoffice fails the issuing
        # customer's tracker entry so wait() raises instead of hanging
        self.give_up_handler: Optional[Callable[[Message], None]] = None
        # TSEngine control traffic (ASKPUSH/ASKPULL/REPLY): set by the
        # Postoffice when TSEngine is enabled for this tier
        self.ts_handler: Optional[Callable[[Message], None]] = None
        # called on the scheduler when the topology is (re)broadcast
        self.on_node_update: Optional[Callable[[List[Node]], None]] = None

        # DGT (reference: van.cc:613-646): only meaningful on the global
        # tier's van; ``dgt`` holds {mode, channels, block_size, alpha, k,
        # k_min, adaptive}
        self._dgt_cfg = dgt if dgt and dgt.get("mode", 0) else None
        self._dgt_sender: Optional[dgt_mod.DGTSender] = None
        self._dgt_queues: Optional[dgt_mod.DGTQueues] = None
        self._dgt_reasm = dgt_mod.DGTReassembler(
            grace_s=(dgt or {}).get("grace_s", 0.1), deliver=self._process)
        self._udp_socks: List[socket.socket] = []
        self.udp_ports: List[int] = []
        # id -> [udp ports] learned from the node table
        self._node_udp: Dict[int, List[int]] = {}
        self._udp_send_sock: Optional[socket.socket] = None

        # transport backend: the native C++ core (native/transport.cc —
        # our ZMQVan equivalent) when buildable and not disabled via
        # GEOMX_NATIVE_VAN=0; pure-Python sockets otherwise. Both speak
        # the same wire format and interoperate within one job.
        self._native: Optional["native_mod.NativeTransport"] = None
        self.use_native = native_mod.enabled()
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._send_queue: List[Tuple[int, int, Message]] = []
        self._send_cv = locks.make_condition(name="Van._send_cv")
        self._send_seq = itertools.count()
        # wire-byte counters are bumped from every reader/sender thread;
        # the unguarded += was a (benign-looking) lost-update race the
        # lockmodel pass flags as GX-L005
        self._stats_lock = locks.make_lock("Van._stats_lock")
        self.send_bytes = 0
        self.recv_bytes = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self, timeout: float = 60.0) -> None:
        self._bind()
        if self.resend_timeout_s > 0:
            self._resender = resender_mod.Resender(
                self, self.resend_timeout_s,
                deadline_s=self.resend_deadline_s,
                max_backoff_s=self.resend_backoff_max_s,
                jitter=self.resend_jitter, seed=self.seed)
            self._resender.on_give_up = self._on_resend_give_up
        if self._faults is not None:
            self._faults.arm()
        if self._shaper is not None:
            self._shaper.arm()
        if self._native is not None:
            self._spawn(self._native_recv_loop, "van-nrecv")
        else:
            self._spawn(self._accept_loop, "van-accept")
        if self._dgt_cfg is not None:
            self._start_dgt()
        if self.use_priority_send:
            self._spawn(self._priority_send_loop, "van-psend")
        if self.is_scheduler:
            with self._member_lock:
                self.my_id = base.SCHEDULER
            self.node_table[base.SCHEDULER] = (self.advertise_host,
                                               self.root_port)
            self.node_roles[base.SCHEDULER] = Role.SCHEDULER
            # scheduler is ready once every node has registered; barrier-less
            # callers may proceed as soon as the table is broadcast
        else:
            self._register(timeout)
        if not self.ready.wait(timeout):
            raise TimeoutError(
                f"van ({'global' if self.is_global else 'local'} tier, role "
                f"{Role(self.my_role).name}) rendezvous timed out after {timeout}s"
            )
        if self.heartbeat_interval_s > 0 and not self.is_scheduler:
            self._spawn(self._heartbeat_loop, "van-heartbeat")
        if self.heartbeat_interval_s > 0 and self.is_scheduler:
            self._spawn(self._membership_loop, "van-membership")

    def stop(self) -> None:
        log.debug("%s van.stop()", self._tag())
        if self.sanitizer is not None:
            self.sanitizer.on_shutdown()
        if self.statecheck is not None:
            self.statecheck.on_shutdown()
        self.stopped.set()
        if self._resender is not None:
            self._resender.stop()
        with self._send_cv:
            self._send_cv.notify_all()
        if self._dgt_queues is not None:
            self._dgt_queues.stop()
        for s in self._udp_socks:
            try:
                s.close()
            except OSError:
                pass
        if self._udp_send_sock is not None:
            try:
                self._udp_send_sock.close()
            except OSError:
                pass
        if self._native is not None:
            self._native.stop()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conn_lock:
            for sock, _ in self._conns.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._conns.clear()

    def _bind(self) -> None:
        port = self.root_port if self.is_scheduler else 0
        if self.use_native:
            try:
                self._native = native_mod.NativeTransport(self.bind_host, port)
                self.my_port = self._native.port
                return
            except (OSError, RuntimeError) as e:
                log.warning("native transport bind failed (%s); "
                            "falling back to Python sockets", e)
                self._native = None
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.bind_host, port))
        s.listen(128)
        self._listener = s
        self.my_port = s.getsockname()[1]

    def _native_recv_loop(self) -> None:
        """Drain complete frames from the native core's inbound queue."""
        assert self._native is not None
        while not self.stopped.is_set():
            try:
                got = self._native.recv(timeout_s=0.5)
            except ConnectionAbortedError:
                return
            except MemoryError:
                log.error("native recv allocation failure; retrying")
                time.sleep(0.1)
                continue
            if got is None:
                continue
            buf, conn = got
            try:
                msg = Message.unpack(buf)
                self._heard_on(msg.meta.sender, conn, len(buf))
                if not self._inbound_gate(msg):
                    continue
                self._process(msg)
            except Exception:
                log.exception("error processing inbound frame; loop kept")

    def _inbound_gate(self, msg: Message) -> bool:
        """Every inbound frame passes here before dispatch: first the
        FaultPlan (if any), then the legacy uniform PS_DROP_MSG check —
        now drawn from the per-van seeded RNG instead of the process
        global one, so drop schedules reproduce under PS_SEED."""
        if self._faults is not None and not self._faults.on_inbound(msg):
            return False
        if (self.drop_rate > 0 and not msg.is_control
                and self._rng.random() < self.drop_rate):
            if self.verbose:
                log.info("PS_DROP_MSG: dropping frame from %d",
                         msg.meta.sender)
            return False
        if not msg.is_control:
            # count on ACCEPTANCE, before any shaping hold — a held
            # frame is on the (emulated) wire, so crash-at-message-N
            # fault points land identically shaped or not
            with self._stats_lock:
                self.num_data_recv += 1
        if self._shaper is not None and not self._shaper.on_inbound(msg):
            # accepted but held for its link delay; re-enters through
            # _process (same path as fault-delayed frames), which
            # bypasses this gate — never gated or shaped twice
            return False
        return True

    def _crash_from_fault(self, reason: str) -> None:
        """A FaultPlan crash rule fired: hard-kill this van (no goodbye,
        no barrier — indistinguishable from a process death to peers)
        and tell the owner via on_crash."""
        log.warning("%s crashing van: %s", self._tag(), reason)
        telemetry.event("fault.crash", cat="fault",
                        node=self.my_id, reason=reason)
        # dump the ring BEFORE stop(): the last events are this van's
        # view of the in-flight round at the moment of death
        self.flightrec.record("crash", reason=reason)
        self.flightrec.dump("crash:" + reason)
        cb = self.on_crash
        self.stop()
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001
                log.exception("on_crash hook failed")

    def _on_resend_give_up(self, target: int, msg: Message,
                           exc: type = RuntimeError,
                           reason: str = "") -> None:
        """A message exhausted its retransmit budget (``exc`` is
        RuntimeError) or blew its overall delivery deadline (``exc`` is
        TimeoutError). For requests WE issued, surface the failure to
        the issuing customer so its wait() raises instead of blocking to
        its own timeout."""
        telemetry.event("resender.give_up", cat="transport",
                        node=self.my_id, target=target, reason=reason,
                        mts=msg.meta.timestamp)
        telemetry.counter_inc("resender.give_ups",
                              tier="global" if self.is_global else "local")
        if self.linkstate is not None:
            self.linkstate.note_give_up(target)
        self.flightrec.record("give_up", peer=target,
                              ts=msg.meta.timestamp, reason=reason,
                              round=msg.meta.trace_round)
        if msg.meta.request and msg.meta.timestamp >= 0:
            if self.sanitizer is not None:
                self.sanitizer.on_give_up(msg)
            if self.give_up_handler is not None:
                self.give_up_handler(msg, exc, reason)

    def _start_dgt(self) -> None:
        """Bind UDP channels + spawn schedulers (reference: van.cc:613-646)."""
        c = self._dgt_cfg
        mode = c["mode"]
        nch = max(c.get("channels", 1), 1)
        if mode == 1:
            for _ in range(nch):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.bind((self.bind_host, 0))
                self._udp_socks.append(s)
                self.udp_ports.append(s.getsockname()[1])
                self._spawn(self._udp_reader_loop, "van-udp", s)
            self._udp_send_sock = socket.socket(socket.AF_INET,
                                                socket.SOCK_DGRAM)
        self._dgt_sender = dgt_mod.DGTSender(
            mode=mode, num_channels=nch,
            block_size=c.get("block_size", 4096),
            contri_alpha=c.get("alpha", 0.3),
            k=c.get("k", 0.8), k_min=c.get("k_min", 0.2),
            adaptive_k=c.get("adaptive", False))
        self._dgt_queues = dgt_mod.DGTQueues(
            send_fn=lambda t, m: self._send_one(t, m),
            send_udp_fn=self._send_udp, mode=mode)

    def _send_udp(self, channel: int, target: int, msg: Message) -> None:
        ports = self._node_udp.get(target)
        addr = self.node_table.get(target)
        if not ports or addr is None or self._udp_send_sock is None:
            # peer has no UDP channels (or table not ready): fall back TCP
            self._send_one(target, msg)
            return
        port = ports[(channel - 1) % len(ports)]
        buf = msg.pack()
        self._udp_send_sock.sendto(buf, (addr[0], port))
        with self._stats_lock:
            self.send_bytes += len(buf)

    def _udp_reader_loop(self, sock: socket.socket) -> None:
        while not self.stopped.is_set():
            try:
                data, _addr = sock.recvfrom(65535)
            except OSError:
                return
            with self._stats_lock:
                self.recv_bytes += len(data)
            try:
                msg = Message.unpack(data)
                if not self._inbound_gate(msg):
                    continue
                self._process(msg)
            except Exception:
                log.exception("error processing UDP datagram; reader kept")

    def _register(self, timeout: float) -> None:
        """Send ADD_NODE to the scheduler (reference: van.cc:509-516)."""
        node = Node(
            role=self.my_role,
            hostname=self.advertise_host,
            port=self.my_port,
            udp_ports=list(self.udp_ports),
            sort_key=getattr(self, "sort_key", -1),
        )
        msg = Message(
            Meta(
                recver=base.SCHEDULER,
                control_cmd=Control.ADD_GLOBAL_NODE if self.is_global else Control.ADD_NODE,
                nodes=[node],
                is_global=self.is_global,
            )
        )
        deadline = time.monotonic() + timeout
        while not self.stopped.is_set():
            try:
                self._send_to_addr((self.root_uri, self.root_port), msg)
                return
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)

    # ------------------------------------------------------------------
    # sending
    # ------------------------------------------------------------------

    def send(self, msg: Message) -> int:
        """Send a message; group recvers fan out (reference: van.cc:835)."""
        recver = msg.meta.recver
        assert recver > 0, f"invalid recver {recver}"
        msg.meta.sender = self.my_id
        msg.meta.is_global = self.is_global
        # stamp the current membership epoch on data traffic so receivers
        # can fence stale senders (zombies / pre-rejoin traffic)
        if not msg.is_control and msg.meta.epoch == 0:
            msg.meta.epoch = self.membership_epoch
        # traced frames carry the rank that first put them on a wire, so
        # the merged cross-node trace can tell a worker's original push
        # from the server's WAN re-issue of the same round
        if (not msg.is_control and msg.meta.trace_round >= 0
                and msg.meta.trace_origin < 0):
            msg.meta.trace_origin = self.my_id
        targets = (
            base.expand_group(recver, self.num_workers, self.num_servers)
            if base.is_group(recver)
            else [recver]
        )
        if base.is_group(recver) and self._declared_dead:
            # group fan-outs skip declared-dead members: a barrier release
            # or command broadcast must not queue retransmits to a corpse
            dead = self.declared_dead_ids()
            targets = [t for t in targets if t not in dead]
        # deliver any self-loopback LAST: a loopback can wake the local
        # waiter (e.g. a barrier release), which may tear the van down
        # while the remaining remote sends are still in flight
        targets = sorted(targets, key=lambda t: t == self.my_id)
        total = 0
        for t in targets:
            if t == self.my_id and msg.is_control:
                # loopback for barrier/self messages
                self._process(self._reframe(msg, t))
                continue
            m = self._reframe(msg, t)
            if (not m.is_control and t != self.my_id
                    and t in self._declared_dead):
                # fail-fast: a data frame to a declared-dead peer never
                # enters the send pipeline (e.g. a deferred chained
                # pull whose push "ack" was the give-up itself). With
                # the resender on, register the frame so the monitor
                # fails it on its next cycle with the declared-dead
                # reason — the terminal state a wire attempt would
                # reach, minus the doomed frame; without it the caller
                # sees the OSError a dead TCP peer would produce.
                if (self._resender is not None and m.meta.msg_sig == 0
                        and m.meta.control_cmd != Control.ACK
                        and self.my_id >= 0):
                    self._resender.assign_sig(m)
                    self._resender.add_outgoing(t, m)
                    continue
                raise OSError(
                    f"send to node {t}: peer declared dead")
            if self.sanitizer is not None:
                # before the DGT split so the logical message is recorded
                # once, not per block
                self.sanitizer.on_send(t, m)
            if (self._dgt_sender is not None and not m.is_control
                    and self._dgt_sender.applicable(m)):
                # DGT: split into channelized blocks (reference: TS_Send,
                # kv_app.h:1146-1205)
                for ch, bmsg in self._dgt_sender.split(m):
                    total += len(bmsg.data[-1]) if bmsg.data else 0
                    self._dgt_queues.put(ch, t, bmsg)
                continue
            if self.use_priority_send and not m.is_control:
                with self._send_cv:
                    heapq.heappush(
                        self._send_queue, (-m.meta.priority, next(self._send_seq), m)
                    )
                    self._send_cv.notify()
            elif len(targets) > 1 and m.is_control:
                # control fan-out: one unreachable member (e.g. a peer that
                # already tore down during shutdown) must not starve the
                # rest — a lost barrier release deadlocks every survivor.
                # Data fan-outs still raise so callers see the failure.
                try:
                    total += self._send_one(t, m)
                except OSError as e:
                    log.warning("%s group send to %d failed: %s",
                                self._tag(), t, e)
            else:
                total += self._send_one(t, m)
        return total

    @staticmethod
    def _reframe(msg: Message, target: int) -> Message:
        if msg.meta.recver == target:
            return msg
        meta = dataclasses.replace(msg.meta, recver=target)
        return Message(meta=meta, data=msg.data)

    def _priority_send_loop(self) -> None:
        while not self.stopped.is_set():
            with self._send_cv:
                while not self._send_queue and not self.stopped.is_set():
                    self._send_cv.wait(0.5)
                if self.stopped.is_set():
                    return
                _, _, msg = heapq.heappop(self._send_queue)
            try:
                self._send_one(msg.meta.recver, msg)  # retries once internally
            except OSError as e:
                # with PS_RESEND on, _send_one_inner already registered
                # the message for retransmission before this attempt, so
                # the monitor retries it; without the resender a lost
                # data message stalls the requester until its wait()
                # timeout — surface loudly either way
                log.error("priority send to %d failed (resender %s): %s",
                          msg.meta.recver,
                          "will retry" if self._resender else "off", e)

    def _send_one(self, target: int, msg: Message) -> int:
        if profiler.is_running() and not msg.is_control:
            t0 = profiler.now_us()
            n = self._send_one_inner(target, msg)
            profiler.record(
                "van.send", "transport", t0, profiler.now_us() - t0,
                self._span_args(target, msg.meta, n))
            return n
        return self._send_one_inner(target, msg)

    def _span_args(self, peer: int, meta: Meta, nbytes: int) -> dict:
        """Args for van.send/van.recv spans. Carries everything
        tools/trace_merge.py needs to pair the send on one node with the
        recv on another: the overlay (``ovl`` — local tiers of different
        parties reuse node ids), both endpoints, the request id and the
        request/response direction. ``node`` identifies the emitting van
        when several share one process-wide profiler (InProcessHiPS)."""
        args = {
            "node": self.node_tag(),
            "ovl": f"{self.root_uri}:{self.root_port}:"
                   f"{'g' if self.is_global else 'l'}",
            "from": meta.sender, "to": peer,
            "mts": meta.timestamp, "req": meta.request,
            "verb": self._verb_of(meta), "bytes": nbytes,
        }
        if meta.trace_round >= 0:
            args["round"] = meta.trace_round
            args["chunk"] = meta.trace_chunk
            args["origin"] = meta.trace_origin
        return args

    def _retried_later(self, target: int, msg: Message) -> bool:
        """A data frame the resender registered is its to deliver: a
        failed wire attempt (a peer whose process died, before its
        replacement takes the slot) is retransmitted by the monitor
        until the frame is acked, its peer declared dead or
        PS_RESEND_DEADLINE passes, instead of raising into the caller
        at once."""
        if (self._resender is None or msg.meta.msg_sig == 0
                or msg.is_control):
            return False
        log.warning("%s send to node %d failed; the resender retries it",
                    self._tag(), target)
        return True

    def _send_one_inner(self, target: int, msg: Message) -> int:
        # send-side crash counting ("crash ... on: send" rules): the van
        # dies BEFORE this frame reaches the wire
        if self._faults is not None and not self._faults.on_send(target, msg):
            return 0
        # register for retransmission before the wire attempt so even a
        # failed first send is retried by the monitor (reference:
        # resender.h:36 AddOutgoing). sig==0 means not-yet-registered;
        # ACKs and pre-rendezvous sends (no id to route the ACK back to)
        # stay outside the protocol.
        if (self._resender is not None and msg.meta.msg_sig == 0
                and msg.meta.control_cmd != Control.ACK
                and self.my_id >= 0 and target != self.my_id):
            self._resender.assign_sig(msg)
            self._resender.add_outgoing(target, msg)
        if not msg.is_control and target in self._declared_dead:
            # fail-fast: a data frame to a declared-dead peer must not
            # touch the wire (sanitizer send-to-dead — e.g. a deferred
            # chained pull whose push "ack" was the give-up itself).
            # With the resender on, the frame is registered above, so
            # the monitor fails it on its next cycle with the
            # declared-dead reason — the same terminal state a wire
            # attempt would reach, minus the doomed frame; without the
            # resender the caller sees the OSError a dead TCP peer
            # would have produced.
            if self._resender is not None and msg.meta.msg_sig != 0:
                return 0
            raise OSError(f"send to node {target}: peer declared dead")
        buf = msg.pack()
        if not msg.is_control:
            self._note_wire("sent", target, msg.meta, len(buf))
        if self._native is not None:
            addr = self.node_table.get(target)
            if addr is None:
                raise OSError(f"no route to node {target}")
            # set_route is a no-op when unchanged; on an address change it
            # evicts the cached connection (peer recovered elsewhere)
            self._native.set_route(target, addr[0], addr[1])
            try:
                n = self._native.send(target, buf)
            except OSError:
                # a peer that dialled us anew may have re-registered at
                # a new address that the table broadcast has not brought
                # yet: resend once when it does
                if not self._await_route_change(target, addr):
                    if self._retried_later(target, msg):
                        return 0
                    raise
                addr = self.node_table[target]
                self._native.set_route(target, addr[0], addr[1])
                try:
                    n = self._native.send(target, buf)
                except OSError:
                    if self._retried_later(target, msg):
                        return 0
                    raise
            self._sent_to(target, n)
            return n
        for attempt in (0, 1):
            addr = self.node_table.get(target)
            conn = self._get_conn(target)
            if conn is None:
                raise OSError(f"no route to node {target}")
            sock, lock = conn
            try:
                with lock:
                    sock.sendall(buf)
                self._sent_to(target, len(buf))
                return len(buf)
            except OSError:
                # evict the (possibly stale) cached connection and re-dial
                # once — the peer may have restarted at a new address,
                # which the table broadcast may still be bringing if the
                # peer dialled us anew
                self._evict_conn(target, sock)
                if attempt == 1:
                    if self._retried_later(target, msg):
                        return 0
                    raise
                self._await_route_change(target, addr)
        return 0

    def _heard_on(self, sender: int, conn, nbytes: int) -> None:
        """Count a frame of ``nbytes`` from ``sender`` that came on
        inbound connection ``conn``. A sender heard on another connection
        than its last frame's has dialled this node anew: a process that
        took its slot (recovery) does so, and its first requests can come
        before the table broadcast that gives its address."""
        with self._stats_lock:
            self.recv_bytes += nbytes
            prev = self._inbound_conn.get(sender)
            if prev != conn:
                self._inbound_conn[sender] = conn
                if prev is not None:
                    self._redialed.add(sender)

    def _sent_to(self, target: int, nbytes: int) -> None:
        with self._stats_lock:
            self.send_bytes += nbytes
            self._redialed.discard(target)

    def _await_route_change(self, target: int, old) -> bool:
        """After a failed send to ``target`` at ``old``: if ``target``
        has dialled this node anew since the last send to it that went
        through (:meth:`_heard_on`), wait at most ROUTE_CHANGE_WAIT_S for
        the table broadcast that moves it to another address, once per
        such redial; True if it moved. Otherwise False at once: a send to
        a peer that is gone, with no process in its slot, fails as
        before."""
        with self._stats_lock:
            if target not in self._redialed:
                return False
            self._redialed.discard(target)
        deadline = time.monotonic() + ROUTE_CHANGE_WAIT_S
        while not self.stopped.is_set():
            if self.node_table.get(target) not in (None, old):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return False

    def _evict_conn(self, target: int, sock: Optional[socket.socket] = None) -> None:
        with self._conn_lock:
            cur = self._conns.get(target)
            if cur is not None and (sock is None or cur[0] is sock):
                self._conns.pop(target, None)
                try:
                    cur[0].close()
                except OSError:
                    pass

    def _get_conn(self, target: int):
        with self._conn_lock:
            c = self._conns.get(target)
        if c is not None:
            return c
        addr = self.node_table.get(target)
        if addr is None:
            return None
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.connect(addr)
        # per-socket send lock stays a RAW primitive on purpose: its one
        # job is serializing a blocking sendall(), which the lock
        # sanitizer's blocking-call-under-lock probe would flag on every
        # frame (the static dual is a baselined GX-L003)
        pair = (sock, threading.Lock())
        with self._conn_lock:
            # lost the race? keep the existing one
            if target in self._conns:
                try:
                    sock.close()
                except OSError:
                    pass
                return self._conns[target]
            self._conns[target] = pair
        return pair

    def _send_to_addr(self, addr: Tuple[str, int], msg: Message) -> None:
        """One-shot registration send before the node table exists."""
        msg.meta.sender = self.my_id
        if self._native is not None:
            self._native.send_to_addr(addr[0], addr[1], msg.pack())
            return
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(10.0)
        sock.connect(addr)
        sock.sendall(msg.pack())
        sock.close()

    # ------------------------------------------------------------------
    # receiving
    # ------------------------------------------------------------------

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self.stopped.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._spawn(self._reader_loop, "van-read", conn)

    def _reader_loop(self, conn: socket.socket) -> None:
        while not self.stopped.is_set():
            try:
                got = read_message(conn)
            except (ValueError, OSError):
                break
            if got is None:
                break
            msg, nbytes = got
            self._heard_on(msg.meta.sender, conn, nbytes)
            try:
                if not self._inbound_gate(msg):
                    continue
                self._process(msg)
            except Exception:
                # an exception here must not kill the reader thread — that
                # would silently sever the connection for all future frames
                log.exception("error processing inbound frame; connection kept")
        try:
            conn.close()
        except OSError:
            pass

    def _process(self, msg: Message) -> None:
        r = self._resender
        if r is not None:
            if msg.meta.control_cmd == Control.ACK:
                r.handle_ack(msg.meta.msg_sig)
                return
            if msg.meta.msg_sig:
                if r.is_duplicate(msg.meta.msg_sig):
                    # our previous ACK may have been lost: re-ACK, drop
                    r.send_ack(msg)
                    return
                # mark seen ON RECEIPT, before processing (reference:
                # resender.h:54) — marking after _process_inner leaves a
                # window where a retransmit arriving while the original is
                # still being handled (inline control handling can block on
                # dials) passes is_duplicate and is processed twice; a
                # BARRIER counted twice releases early. The ACK goes out
                # immediately too: processing is at-most-once, the same
                # guarantee the reference's resender provides.
                r.mark_seen(msg.meta.msg_sig)
                r.send_ack(msg)
        self._process_inner(msg)

    def _process_inner(self, msg: Message) -> None:
        if self.sanitizer is not None:
            # post-dedup (resender dropped duplicate frames already) and
            # post-ACK-handling, so this sees each logical delivery once
            self.sanitizer.on_inbound(msg)
        cmd = msg.meta.control_cmd
        if cmd in (Control.ADD_NODE, Control.ADD_GLOBAL_NODE):
            self._process_add_node(msg)
        elif cmd in (Control.BARRIER, Control.BARRIER_GLOBAL):
            self._process_barrier(msg)
        elif cmd == Control.HEARTBEAT:
            self._heartbeats[msg.meta.sender] = time.monotonic()
            # geomx-healthd: members piggyback their link-state digest on
            # the heartbeats they already send; fold it into the board
            if self.healthboard is not None and msg.meta.health:
                self.healthboard.ingest(msg.meta.sender, msg.meta.health)
        elif cmd == Control.DEAD_NODE:
            self._process_dead_node(msg)
        # TERMINATE is dispatched but never sent by this tree: it is the
        # reference protocol's remote kill verb, kept receivable so a
        # native/operator van can still take a python node down.
        # geomx-lint: disable=GX-P301
        elif cmd == Control.TERMINATE:
            self.stopped.set()
        # AUTOPULLREPLY likewise arrives only from reference-protocol
        # peers (our TSEngine acks models via the normal response path).
        # geomx-lint: disable=GX-P301
        elif cmd in (Control.ASKPUSH, Control.ASKPULL, Control.REPLY,
                     Control.AUTOPULLREPLY):
            # TSEngine matchmaking (reference: van.cc:1197-1458). Handlers
            # may themselves send (model relays) and block on a slow peer;
            # dispatch on a dedicated thread so a stalled relay can never
            # freeze the receive path (fatal for the native backend's
            # single recv thread).
            if self.ts_handler is not None:
                self._ts_dispatch(msg)
            else:
                log.warning("TS control message but TSEngine not enabled "
                            "on this node (cmd=%d)", cmd)
        elif msg.meta.msg_type in (dgt_mod.MSG_TYPE_BLOCK,
                                   dgt_mod.MSG_TYPE_TAIL):
            # DGT block: reassemble; a completed group re-enters as a
            # normal data message (reference: ProcessDataMsg van.cc:330-370)
            whole = self._dgt_reasm.accept(msg)
            if whole is not None:
                self._process(whole)
        else:
            if not msg.is_control:
                # approximate payload size: the exact framed length was
                # accounted in recv_bytes by the reader; spans only need
                # a comparable magnitude and the trace-context args
                nbytes = sum(len(d) for d in msg.data)
                self._note_wire("recv", msg.meta.sender, msg.meta, nbytes)
                if profiler.is_running():
                    t = profiler.now_us()
                    profiler.record(
                        "van.recv", "transport", t, 0,
                        self._span_args(msg.meta.recver, msg.meta, nbytes))
            # geomx-healthd board query (kv.health() -> Command.HEALTH):
            # answered at van level on the scheduler — the scheduler's
            # Postoffice registers no customers, so routing this through
            # msg_handler would drop it
            if (self.is_scheduler and msg.meta.request
                    and msg.meta.simple_app
                    and msg.meta.head == linkstate_mod.HEALTH_CMD):
                self._answer_health(msg)
                return
            handler = self.msg_handler
            if handler is not None:
                handler(msg)

    def _answer_health(self, req: Message) -> None:
        """Respond to a HEALTH simple_app request with the board JSON
        (``{}`` when the health plane is off, so callers never hang)."""
        board = self.healthboard
        body = board.render_json() if board is not None else "{}"
        resp = Message(Meta(
            recver=req.meta.sender,
            app_id=req.meta.app_id,
            customer_id=req.meta.customer_id,
            timestamp=req.meta.timestamp,
            request=False,
            simple_app=True,
            head=req.meta.head,
            body=body,
            is_global=self.is_global,
        ))
        try:
            self.send(resp)
        except OSError as e:
            log.warning("health response to %d failed: %s",
                        req.meta.sender, e)

    # ------------------------------------------------------------------
    # rendezvous (scheduler + member sides)
    # ------------------------------------------------------------------

    def _process_add_node(self, msg: Message) -> None:
        if self.is_scheduler and msg.meta.request is False and msg.meta.sender == -1:
            # a fresh registration from an unidentified node
            self._scheduler_register(msg.meta.nodes[0])
        elif not self.is_scheduler:
            # the broadcast node table; find my slot by (host, port)
            for n in msg.meta.nodes:
                old = self.node_table.get(n.id)
                if old is not None and old != (n.hostname, n.port):
                    # peer recovered at a new address: drop the stale route
                    self._evict_conn(n.id)
                self.node_table[n.id] = (n.hostname, n.port)
                self.node_roles[n.id] = n.role
                if n.udp_ports:
                    self._node_udp[n.id] = list(n.udp_ports)
                if (
                    n.hostname == self.advertise_host
                    and n.port == self.my_port
                    and n.role == self.my_role
                ):
                    with self._member_lock:
                        self.my_id = n.id
                        self.is_recovery = n.is_recovery
            # the table broadcast carries the scheduler's membership
            # epoch; recovery entries revive their slot (the newcomer is
            # live, the PREVIOUS holder of the id stays fenced via
            # _rejoin_epoch)
            with self._member_lock:
                changed = False
                if msg.meta.epoch > self.membership_epoch:
                    self.membership_epoch = msg.meta.epoch
                    changed = True
                for n in msg.meta.nodes:
                    if n.is_recovery and n.id in self._declared_dead:
                        self._declared_dead.discard(n.id)
                        self._rejoin_epoch[n.id] = self.membership_epoch
                        changed = True
                epoch_now = self.membership_epoch
                dead_now = frozenset(self._declared_dead)
                if self.statecheck is not None:
                    self.statecheck.on_table(
                        msg.meta.epoch,
                        [n.id for n in msg.meta.nodes if n.is_recovery],
                        (epoch_now, dead_now))
            if changed:
                # a revival learned through the table broadcast re-fires
                # the side effects exactly like a DEAD_NODE adoption —
                # without this a server that missed the rejoin DEAD_NODE
                # never re-checks its countdowns against the new view
                self._membership_side_effects(epoch_now, dead_now)
            if self.my_id != -1:
                self.ready.set()

    def _scheduler_register(self, node: Node) -> None:
        with self._reg_lock:
            expected = self.num_workers + self.num_servers
            dead = self.dead_nodes()
            log.debug("%s registration %s:%d role=%d (have %d/%d, dead=%s)",
                      self._tag(), node.hostname, node.port, node.role,
                      len(self._registrations), expected, dead)
            if len(self._registrations) >= expected and dead:
                # recovery path: hand the dead slot's id to the newcomer
                # (reference: van.cc:176-193)
                for i, old in enumerate(self._registrations):
                    if old.id in dead and old.role == node.role:
                        node.id = old.id
                        node.is_recovery = True
                        self._registrations[i] = node
                        self._heartbeats.pop(old.id, None)
                        # revive the slot: bump the epoch BEFORE the table
                        # broadcast so the rejoined node starts on the new
                        # epoch while the old holder's in-flight pushes
                        # stay fenced (_rejoin_epoch)
                        with self._member_lock:
                            if old.id in self._declared_dead:
                                self._declared_dead.discard(old.id)
                                self.membership_epoch += 1
                                self._rejoin_epoch[old.id] = \
                                    self.membership_epoch
                                if self.statecheck is not None:
                                    self.statecheck.on_revive(
                                        old.id, self.membership_epoch)
                        break
                else:
                    log.warning("re-registration with no matching dead slot")
                    return
            else:
                self._registrations.append(node)
            if len(self._registrations) < expected:
                return
            # assign ranks deterministically: sort per role by the
            # explicit sort_key when provided (rank alignment across
            # tiers — see Node.sort_key), else by (host, port) so the
            # same physical topology gets the same ids across runs
            key = lambda n: ((0, n.sort_key, n.hostname, n.port)
                             if n.sort_key >= 0
                             else (1, n.hostname, n.port))  # noqa: E731
            servers = sorted(
                (n for n in self._registrations if n.role == Role.SERVER), key=key
            )
            workers = sorted(
                (n for n in self._registrations if n.role == Role.WORKER), key=key
            )
            for rank, n in enumerate(servers):
                if n.id == -1:
                    n.id = base.server_rank_to_id(rank)
            for rank, n in enumerate(workers):
                if n.id == -1:
                    n.id = base.worker_rank_to_id(rank)
            all_nodes = servers + workers + [
                Node(
                    role=Role.SCHEDULER,
                    id=base.SCHEDULER,
                    hostname=self.advertise_host,
                    port=self.root_port,
                )
            ]
            for n in all_nodes:
                old = self.node_table.get(n.id)
                if old is not None and old != (n.hostname, n.port):
                    self._evict_conn(n.id)
                self.node_table[n.id] = (n.hostname, n.port)
                self.node_roles[n.id] = n.role
                if n.udp_ports:
                    self._node_udp[n.id] = list(n.udp_ports)
                # a fresh registration counts as a liveness signal so
                # dead-node detection starts from "alive", not "unknown"
                self._heartbeats[n.id] = time.monotonic()
            self.ready.set()
        # broadcast the table (outside the lock; sends can block). The
        # meta carries the membership epoch so a recovering node — which
        # never saw the DEAD_NODE broadcasts — joins on the current epoch.
        bcast = Message(
            Meta(
                control_cmd=Control.ADD_GLOBAL_NODE if self.is_global else Control.ADD_NODE,
                nodes=all_nodes,
                epoch=self.membership_epoch,
                is_global=self.is_global,
            )
        )
        for n in all_nodes:
            if n.role == Role.SCHEDULER:
                continue
            # sender must be stamped here (send() normally does it): the
            # resender routes members' ACKs back to meta.sender
            m = Message(meta=dataclasses.replace(
                bcast.meta, recver=n.id, sender=self.my_id), data=[])
            try:
                self._send_one(n.id, m)
            except OSError as e:
                log.warning("failed to send node table to %d: %s", n.id, e)
        if self.on_node_update:
            self.on_node_update(all_nodes)
        if any(n.is_recovery for n in all_nodes):
            # propagate the revival (pruned dead set + bumped epoch) to
            # members that may have missed a table broadcast
            with self._member_lock:
                epoch = self.membership_epoch
                dead_now = frozenset(self._declared_dead)
            self._broadcast_membership(epoch, dead_now)

    # ------------------------------------------------------------------
    # barriers (reference: van.cc:259-288)
    # ------------------------------------------------------------------

    def barrier(self, group: int, timeout: float = 300.0) -> None:
        # a stopped (crashed or shut-down) van can neither deliver the
        # request nor receive the release — fail fast instead of
        # parking the caller for the full timeout (a crashed chaos
        # worker's exit path must not bleed out through serial barrier
        # timeouts)
        if self.stopped.is_set():
            raise OSError("van stopped; barrier unavailable")
        ev = threading.Event()
        with self._barrier_lock:
            self._barrier_done[group] = ev
        msg = Message(
            Meta(
                recver=base.SCHEDULER,
                control_cmd=Control.BARRIER_GLOBAL if self.is_global else Control.BARRIER,
                barrier_group=group,
                request=True,
                is_global=self.is_global,
            )
        )
        self.send(msg)
        end = time.monotonic() + timeout
        while not ev.wait(min(1.0, max(0.0, end - time.monotonic()))):
            if self.stopped.is_set():
                raise OSError("van stopped during barrier")
            if time.monotonic() >= end:
                raise TimeoutError(f"barrier on group {group} timed out")

    def _process_barrier(self, msg: Message) -> None:
        if msg.meta.request:
            assert self.is_scheduler
            group = msg.meta.barrier_group
            with self._barrier_lock:
                arrived = self._barrier_members.setdefault(group, set())
                arrived.add(msg.meta.sender)
            self._maybe_release_barrier(group, msg.meta.control_cmd)
        else:
            with self._barrier_lock:
                ev = self._barrier_done.get(msg.meta.barrier_group)
            if ev is not None:
                ev.set()

    def _maybe_release_barrier(self, group: int, control_cmd: int) -> None:
        """Release ``group`` if every live member's request has arrived.

        Called per arriving request AND on every epoch bump
        (_recheck_barriers): a member dying mid-barrier shrinks the
        expected set, which can satisfy an already-pending barrier."""
        dead = self.declared_dead_ids()
        with self._barrier_lock:
            arrived = self._barrier_members.get(group)
            if not arrived:
                return
            expected = [
                t for t in base.expand_group(group, self.num_workers,
                                             self.num_servers)
                if t not in dead
            ]
            done = all(t in arrived for t in expected)
            log.debug("%s barrier group=%d count=%d/%d (dead=%d)",
                      self._tag(), group, len(arrived), len(expected),
                      len(dead))
            if done:
                self._barrier_members[group] = set()
        if done:
            resp = Message(
                Meta(
                    recver=group,
                    control_cmd=control_cmd,
                    barrier_group=group,
                    request=False,
                    is_global=self.is_global,
                )
            )
            self.send(resp)

    def _recheck_barriers(self) -> None:
        """Epoch bump: re-evaluate every pending barrier round."""
        cmd = Control.BARRIER_GLOBAL if self.is_global else Control.BARRIER
        with self._barrier_lock:
            groups = [g for g, m in self._barrier_members.items() if m]
        for g in groups:
            self._maybe_release_barrier(g, cmd)

    # ------------------------------------------------------------------
    # heartbeats (reference: van.cc:1128-1140)
    # ------------------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self.stopped.wait(self.heartbeat_interval_s):
            try:
                meta = Meta(
                    recver=base.SCHEDULER,
                    control_cmd=Control.HEARTBEAT,
                    is_global=self.is_global,
                )
                # geomx-healthd: ride the link-state digest on the frame
                # this loop already sends — zero new per-round messages
                if self.linkstate is not None:
                    meta.health = self.linkstate.digest_json(
                        epoch=self.membership_epoch)
                self.send(Message(meta))
            except OSError:
                pass

    def dead_nodes(self) -> List[int]:
        """Nodes whose heartbeat has lapsed (reference: postoffice.h:187).

        Heartbeats flow member -> scheduler only (as in the reference), so
        this is meaningful on the scheduler; elsewhere it returns [].
        """
        if self.heartbeat_interval_s <= 0 or not self.is_scheduler:
            return []
        now = time.monotonic()
        dead = []
        for nid in list(self.node_table):
            if nid in (base.SCHEDULER, self.my_id):
                continue
            last = self._heartbeats.get(nid)
            if last is not None and now - last > self.heartbeat_timeout_s:
                dead.append(nid)
        return dead

    # ------------------------------------------------------------------
    # membership epochs (scheduler-driven DEAD_NODE broadcasts)
    # ------------------------------------------------------------------

    def _membership_loop(self) -> None:
        """Scheduler: promote sustained heartbeat lapses into membership
        epochs. A node must stay lapsed for ``epoch_grace_s`` beyond its
        heartbeat timeout before it is declared — a straggler that
        resumes heartbeating within the grace window is pardoned."""
        period = max(min(self.heartbeat_interval_s, 1.0), 0.1)
        suspects: Dict[int, float] = {}
        while not self.stopped.wait(period):
            lapsed = set(self.dead_nodes())
            now = time.monotonic()
            for nid in list(suspects):
                if nid not in lapsed:
                    suspects.pop(nid)  # pardoned: heartbeat resumed
            newly = []
            for nid in lapsed:
                if nid in self._declared_dead:
                    continue
                t0 = suspects.setdefault(nid, now)
                if now - t0 >= self.epoch_grace_s:
                    newly.append(nid)
            if newly:
                for nid in newly:
                    suspects.pop(nid, None)
                self.declare_dead(newly)

    def declare_dead(self, ids: List[int]) -> None:
        """Scheduler: declare ``ids`` dead, bump the epoch, broadcast."""
        with self._member_lock:
            fresh = [i for i in ids if i not in self._declared_dead
                     and i in self.node_table and i != base.SCHEDULER]
            if not fresh:
                return
            self._declared_dead.update(fresh)
            self.membership_epoch += 1
            epoch = self.membership_epoch
            dead = frozenset(self._declared_dead)
            if self.statecheck is not None:
                self.statecheck.on_declare(fresh, epoch, dead)
        log.warning("%s membership epoch %d: declaring %s dead (dead set "
                    "now %s)", self._tag(), epoch, sorted(fresh),
                    sorted(dead))
        telemetry.event("membership.declare_dead", cat="membership",
                        epoch=epoch, dead=sorted(dead))
        telemetry.gauge_set("membership.epoch", epoch,
                            tier="global" if self.is_global else "local")
        self.flightrec.record("membership", event="declare_dead",
                              epoch=epoch, dead=sorted(dead))
        self._broadcast_membership(epoch, dead)
        self._membership_side_effects(epoch, dead)

    def _broadcast_membership(self, epoch: int, dead: frozenset) -> None:
        """Send DEAD_NODE (full dead set + epoch) to every live member.

        The full-set encoding makes broadcasts idempotent and
        self-healing: a member that missed one learns everything from the
        next. Declared-dead nodes are NOT told — a wrongly-declared
        zombie keeps stamping the old epoch and stays fenced until it
        re-registers."""
        nodes = [Node(role=self.node_roles.get(i, Role.WORKER), id=i)
                 for i in sorted(dead)]
        for nid, role in sorted(self.node_roles.items()):
            if (nid in dead or nid == self.my_id
                    or role == Role.SCHEDULER):
                continue
            m = Message(Meta(
                recver=nid, sender=self.my_id,
                control_cmd=Control.DEAD_NODE, nodes=nodes,
                epoch=epoch, is_global=self.is_global))
            try:
                self._send_one(nid, m)
            except OSError as e:
                log.warning("%s DEAD_NODE broadcast to %d failed: %s",
                            self._tag(), nid, e)

    def _process_dead_node(self, msg: Message) -> None:
        """Member: adopt the scheduler's membership view."""
        epoch = msg.meta.epoch
        new_dead = {n.id for n in msg.meta.nodes}
        with self._member_lock:
            if epoch < self.membership_epoch:
                # stale broadcast (reordered/retransmitted)
                outcome = "stale"
            elif (epoch == self.membership_epoch
                    and new_dead == self._declared_dead):
                outcome = "duplicate"  # side effects already fired
            else:
                outcome = "adopt"
                # ids leaving the dead set were revived (slot
                # re-filled): fence the previous holder's traffic
                for nid in self._declared_dead - new_dead:
                    self._rejoin_epoch[nid] = epoch
                self._declared_dead = set(new_dead)
                self.membership_epoch = epoch
            dead = frozenset(self._declared_dead)
            if self.statecheck is not None:
                self.statecheck.on_dead_node(
                    epoch, new_dead, outcome,
                    (self.membership_epoch, dead))
        if outcome != "adopt":
            return
        log.info("%s membership epoch %d: dead set %s", self._tag(),
                 epoch, sorted(dead))
        self._membership_side_effects(epoch, dead)

    def _membership_side_effects(self, epoch: int, dead: frozenset) -> None:
        """Post-epoch-change actions, run OFF the member lock."""
        r = self._resender
        if r is not None:
            for nid in dead:
                r.fail_peer(nid, f"peer {nid} declared dead "
                                 f"(membership epoch {epoch})")
        if self.is_scheduler:
            self._recheck_barriers()
        hook = self.on_membership
        if hook is not None:
            try:
                hook(epoch, dead)
            except Exception:  # noqa: BLE001 — owner hooks must not kill us
                log.exception("on_membership hook failed")

    def declared_dead_ids(self) -> frozenset:
        with self._member_lock:
            return frozenset(self._declared_dead)

    def live_ids(self, role: Optional[int] = None) -> List[int]:
        """Ids from the node table that are not declared dead, optionally
        filtered by role (scheduler excluded unless asked for)."""
        with self._member_lock:
            dead = set(self._declared_dead)
        out = []
        for nid, r in self.node_roles.items():
            if nid in dead:
                continue
            if role is None and r == Role.SCHEDULER:
                continue
            if role is not None and r != role:
                continue
            out.append(nid)
        return sorted(out)

    def is_stale(self, sender: int, epoch: int) -> bool:
        """True when a data message from ``sender`` must be fenced: the
        sender is declared dead, or its epoch predates the sender id's
        rejoin (the previous holder of a re-filled slot)."""
        with self._member_lock:
            stale = (sender in self._declared_dead
                     or epoch < self._rejoin_epoch.get(sender, 0))
            if self.statecheck is not None:
                self.statecheck.on_fence(sender, epoch, stale)
            return stale

    def notify_round(self, round_idx: int) -> None:
        """Training-round clock for deterministic fault injection
        (FaultRule.at_round) and the health digest's round progress."""
        if self._faults is not None:
            self._faults.on_round(round_idx)
        if self.linkstate is not None:
            self.linkstate.note_round(round_idx)

    # ------------------------------------------------------------------

    def _ts_dispatch(self, msg: Message) -> None:
        """Hand a TS control message to the lazily-started TS thread."""
        with self._send_cv:  # reuse an existing lock for lazy init
            if not hasattr(self, "_ts_queue"):
                import queue as _queue

                self._ts_queue: "_queue.Queue[Message]" = _queue.Queue()
                self._spawn(self._ts_loop, "van-ts")
        self._ts_queue.put(msg)

    def _ts_loop(self) -> None:
        while not self.stopped.is_set():
            try:
                msg = self._ts_queue.get(timeout=0.5)
            except Exception:
                continue
            h = self.ts_handler
            if h is None:
                continue
            try:
                h(msg)
            except Exception:
                log.exception("TS handler failed; dispatcher kept")

    def _tag(self) -> str:
        """Log identity: tier, id, and bind port."""
        return (f"[{'g' if self.is_global else 'l'}"
                f"/{self.my_id}@{getattr(self, 'my_port', '?')}]")

    def node_tag(self) -> str:
        """Filename-safe node identity for telemetry and flight-recorder
        dumps: tier + id + overlay root port. The root port disambiguates
        overlays that reuse the same id space (every party's local tier
        numbers its workers/servers identically)."""
        return (f"{'g' if self.is_global else 'l'}{self.my_id}"
                f"p{self.root_port}")

    @staticmethod
    def _verb_of(meta: Meta) -> str:
        if meta.push:
            return "push"
        if meta.pull:
            return "pull"
        if meta.simple_app:
            return "command"
        return "data"

    def _note_wire(self, direction: str, peer: int, meta: Meta,
                   nbytes: int) -> None:
        """One wire event: flight-recorder ring entry + telemetry
        counters labeled by tier/verb/codec. Called for non-control
        frames only; both callers sit off the disabled-fast paths."""
        verb = self._verb_of(meta)
        if self.flightrec.enabled:
            self.flightrec.record(
                direction, peer=peer, verb=verb, bytes=nbytes,
                req=meta.request, ts=meta.timestamp,
                round=meta.trace_round, chunk=meta.trace_chunk,
                origin=meta.trace_origin, epoch=meta.epoch)
        if telemetry.enabled():
            tier = "global" if self.is_global else "local"
            codec = meta.compr or "raw"
            telemetry.counter_inc(f"van.bytes_{direction}", nbytes,
                                  tier=tier, verb=verb, codec=codec)
            telemetry.counter_inc(f"van.messages_{direction}",
                                  tier=tier, verb=verb, codec=codec)
        ls = self.linkstate
        if ls is not None:
            if direction == "sent":
                ls.note_sent(peer, nbytes, meta.compr or "raw",
                             meta.trace_round)
            else:
                ls.note_recv(peer, meta.trace_round)

    def _spawn(self, fn, name: str, *args) -> None:
        t = threading.Thread(target=fn, args=args, name=name, daemon=True)
        t.start()
        self._threads.append(t)
