"""Per-tier node management: the Postoffice.

Plays the role of ps-lite's dual-overlay ``Postoffice`` (reference:
3rdparty/ps-lite/include/ps/internal/postoffice.h:18-234, src/postoffice.cc).
The reference threads ``is_global`` flags through one singleton; we instead
instantiate one Postoffice per tier — a server process participating in HiPS
owns two (its intra-DC tier as a server, the inter-DC tier as a global
worker or global server).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from geomx_tpu_torch import config as cfg_mod
from geomx_tpu_torch import telemetry
from geomx_tpu_torch.ps import base
from geomx_tpu_torch.ps import faults
from geomx_tpu_torch.ps import locks
from geomx_tpu_torch.ps import shaping
from geomx_tpu_torch.ps.customer import Customer
from geomx_tpu_torch.ps.message import Message, Role
from geomx_tpu_torch.ps.van import Van

log = logging.getLogger("geomx.postoffice")


@locks.guarded_by("_customers_lock", "_customers")
class Postoffice:
    def __init__(
        self,
        *,
        my_role: int,
        is_global: bool,
        root_uri: str,
        root_port: int,
        num_workers: int,
        num_servers: int,
        cfg: Optional[cfg_mod.Config] = None,
    ):
        cfg = cfg or cfg_mod.load()
        self.cfg = cfg
        self.is_global = is_global
        self.my_role = my_role
        self.num_workers = num_workers
        self.num_servers = num_servers
        _bind_host, _advertise_host = cfg.node_addr()
        # GEOMX_LOCK_SANITIZER: the witness is process-wide; affirmative-
        # only (like telemetry.configure below) and BEFORE the Van is
        # built so every make_lock in its __init__ comes out traced
        if cfg.lock_sanitizer:
            locks.enable(True)
        self.van = Van(
            my_role=my_role,
            is_global=is_global,
            root_uri=root_uri,
            root_port=root_port,
            num_workers=num_workers,
            num_servers=num_servers,
            bind_host=_bind_host,
            advertise_host=_advertise_host,
            drop_rate=cfg.drop_rate,
            resend_timeout_s=(cfg.resend_timeout_ms / 1000.0
                              if cfg.resend else 0.0),
            resend_deadline_s=cfg.resend_deadline_s,
            resend_backoff_max_s=cfg.resend_backoff_max_s,
            resend_jitter=cfg.resend_jitter,
            # PS_SEED / PS_FAULT_PLAN: deterministic fault injection
            seed=faults.van_seed(cfg, my_role, is_global),
            fault_plan=faults.plan_from_config(cfg),
            # GEOMX_SHAPE_PLAN / GEOMX_SHAPE_SEED: per-link WAN shaping
            shape_plan=shaping.plan_from_config(cfg),
            heartbeat_interval_s=cfg.heartbeat_interval_s,
            heartbeat_timeout_s=cfg.heartbeat_timeout_s,
            epoch_grace_s=cfg.epoch_grace_s,
            # the priority Sending thread runs in EVERY van (reference:
            # van.cc:548,851) — the party-server→global WAN hop is where
            # ordering matters most
            use_priority_send=cfg.enable_p3,
            verbose=cfg.verbose,
            # GEOMX_WIRE_SANITIZER: per-van protocol-invariant checking
            wire_sanitizer=cfg.wire_sanitizer,
            # GEOMX_STATE_SANITIZER: per-van membership/epoch model
            # conformance checking (ps/conformance.py)
            state_sanitizer=cfg.state_sanitizer,
            # GEOMX_FLIGHTREC_SIZE/_DIR: crash flight recorder ring
            flightrec_size=cfg.flightrec_size,
            flightrec_dir=cfg.flightrec_dir,
            # GEOMX_HEALTH*: live link-state estimation + scheduler-side
            # cluster health board (ps/linkstate.py)
            health=cfg.health,
            health_dir=cfg.health_dir,
            health_opts={
                "window": cfg.health_window,
                "degrade_factor": cfg.health_degrade_factor,
                "straggler_rounds": cfg.health_straggler_rounds,
                "straggler_persist": cfg.health_straggler_persist,
                "rtx_burst": cfg.health_rtx_burst,
                "stall_s": cfg.health_stall_s,
            },
            # DGT runs on the inter-DC (global) tier only (reference:
            # StartGlobal binds the UDP channels, van.cc:613-646)
            dgt={
                "mode": cfg.enable_dgt,
                "channels": cfg.udp_channel_num or 1,
                "block_size": cfg.dgt_block_size,
                "alpha": cfg.dgt_contri_alpha,
                "k": cfg.dmlc_k,
                "k_min": cfg.dmlc_k_min,
                "adaptive": cfg.adaptive_k_flag,
                "grace_s": cfg.dgt_grace_ms / 1000.0,
            } if (is_global and cfg.enable_dgt) else None,
        )
        # PS_SORT_KEY: deterministic local-tier registration rank (the
        # scheduler sorts registrations by Node.sort_key before falling
        # back to ephemeral bind-port order, which is a per-run coin
        # flip). Global vans keep the server-rank alignment assigned in
        # kvstore/server.py instead
        if cfg.sort_key >= 0 and not is_global:
            self.van.sort_key = cfg.sort_key
        # GEOMX_TELEMETRY/_DIR: the registry is process-wide; only push
        # affirmative settings so several in-process nodes (simulate.
        # InProcessHiPS) can't have the last default Config turn it off
        telemetry.configure(enabled=True if cfg.telemetry else None,
                            export_dir=cfg.telemetry_dir or None)
        if cfg.lock_sanitizer:
            # violations ride the crash flight recorder (kind="race")
            # next to the wire sanitizer's protocol events
            locks.witness().attach_flightrec(self.van.flightrec)
        self.van.msg_handler = self._dispatch
        self.van.give_up_handler = self._on_request_undeliverable
        self.van.on_membership = self._fire_membership
        # membership listeners: fn(epoch, dead_ids), called off-lock on
        # every epoch change (kvstore servers re-check aggregation
        # countdowns; esync prunes its reporter window)
        self._membership_listeners: List = []
        self._customers: Dict[Tuple[int, int], Customer] = {}
        self._customers_lock = locks.make_lock("Postoffice._customers_lock")
        self._started = False
        # TSEngine: the scheduler of a TS-enabled tier runs the matchmaker
        # (reference: van.cc:1197-1458); members attach a TSNode later
        self.ts_scheduler = None
        ts_on = cfg.enable_inter_ts if is_global else cfg.enable_intra_ts
        if my_role == Role.SCHEDULER and ts_on:
            from geomx_tpu_torch.ps.tsengine import TSScheduler

            self.ts_scheduler = TSScheduler(
                self.van, num_workers, greed_rate=cfg.max_greed_rate_ts,
                avoid_degraded=cfg.transport_controller)
            self.van.ts_handler = self.ts_scheduler.handle

    # -- lifecycle -------------------------------------------------------

    def start(self, timeout: float = 60.0) -> None:
        if self._started:
            return
        self.van.start(timeout)
        self._started = True
        log.debug(
            "postoffice started: tier=%s role=%s id=%d",
            "global" if self.is_global else "local",
            Role(self.my_role).name,
            self.van.my_id,
        )

    def finalize(self, do_barrier: bool = True,
                 barrier_timeout: float = None) -> None:
        """Exit protocol: one ALL-group barrier, then teardown.

        Every tier member performs exactly two ALL-group barriers over its
        lifetime — one at startup, one here — so the scheduler's passive
        exit-wait (kvstore_server._run_scheduler) aligns with the rounds.
        """
        if not self._started:
            return
        if barrier_timeout is None:
            barrier_timeout = self.cfg.barrier_timeout_s
        if do_barrier:
            try:
                self.barrier(base.ALL_GROUP, timeout=barrier_timeout)
            except (TimeoutError, OSError):
                log.warning("finalize barrier failed; stopping anyway")
        # snapshot under the lock, stop outside it: Customer.stop
        # enqueues the shutdown sentinel (a blocking Queue.put), and a
        # recv thread delivering a late frame may need the registry
        # lock to route it — stopping under the lock is the exact
        # blocking-call-under-lock pattern the lock sanitizer flags
        with self._customers_lock:
            customers = list(self._customers.values())
        for c in customers:
            c.stop()
        self.van.stop()
        self._started = False

    # -- identity --------------------------------------------------------

    @property
    def my_id(self) -> int:
        return self.van.my_id

    @property
    def my_rank(self) -> int:
        return base.id_to_rank(self.van.my_id)

    @property
    def is_worker(self) -> bool:
        return self.my_role == Role.WORKER

    @property
    def is_server(self) -> bool:
        return self.my_role == Role.SERVER

    @property
    def is_scheduler(self) -> bool:
        return self.my_role == Role.SCHEDULER

    def worker_ids(self) -> List[int]:
        return [base.worker_rank_to_id(r) for r in range(self.num_workers)]

    def server_ids(self) -> List[int]:
        return [base.server_rank_to_id(r) for r in range(self.num_servers)]

    # -- elastic membership ----------------------------------------------

    def add_membership_listener(self, fn) -> None:
        """Register fn(epoch, dead_ids) for membership epoch changes."""
        self._membership_listeners.append(fn)

    def _fire_membership(self, epoch: int, dead: frozenset) -> None:
        for fn in list(self._membership_listeners):
            try:
                fn(epoch, dead)
            except Exception:  # noqa: BLE001 — one listener must not
                log.exception("membership listener failed")  # starve the rest

    def membership_epoch(self) -> int:
        return self.van.membership_epoch

    def live_worker_ids(self) -> List[int]:
        dead = self.van.declared_dead_ids()
        return [i for i in self.worker_ids() if i not in dead]

    def num_live_workers(self) -> int:
        return len(self.live_worker_ids())

    def live_server_ids(self) -> List[int]:
        dead = self.van.declared_dead_ids()
        return [i for i in self.server_ids() if i not in dead]

    def num_live_servers(self) -> int:
        return len(self.live_server_ids())

    # -- customers -------------------------------------------------------

    def register_customer(self, customer: Customer) -> None:
        key = (customer.app_id, customer.customer_id)
        with self._customers_lock:
            assert key not in self._customers, f"duplicate customer {key}"
            self._customers[key] = customer

    def deregister_customer(self, customer: Customer) -> None:
        with self._customers_lock:
            self._customers.pop((customer.app_id, customer.customer_id), None)

    def _dispatch(self, msg: Message) -> None:
        key = (msg.meta.app_id, msg.meta.customer_id)
        with self._customers_lock:
            cust = self._customers.get(key)
        if cust is None and msg.meta.request:
            # REQUESTS may fall back to any customer of the app (e.g. TS
            # relay traffic reaching a node that registered only cid 0).
            # RESPONSES must NOT: the customer_id identifies the issuing
            # tracker, and handing a late response to a different
            # KVWorker (TS = cid 1, command rebroadcast = cid 2) could
            # satisfy the wrong tracker's wait.
            with self._customers_lock:
                for (app, _cid), c in self._customers.items():
                    if app == msg.meta.app_id:
                        cust = c
                        break
        if cust is None:
            log.warning("no customer for app=%s cid=%s (request=%s); "
                        "dropping message", key[0], key[1], msg.meta.request)
            return
        cust.accept(msg)

    def _on_request_undeliverable(self, msg: Message,
                                  exc: type = RuntimeError,
                                  reason: str = "") -> None:
        """Resender gave up on one of OUR requests (retry cap, or the
        delivery deadline — then ``exc`` is TimeoutError): fail the
        tracker entry so wait() raises promptly, and with the right
        exception class, instead of blocking to its timeout."""
        with self._customers_lock:
            cust = self._customers.get((msg.meta.app_id, msg.meta.customer_id))
        if cust is not None:
            cust.fail_request(
                msg.meta.timestamp,
                f"request ts={msg.meta.timestamp} to node {msg.meta.recver} "
                f"undeliverable: "
                + (reason or "retransmit retries exhausted"),
                exc=exc)

    def attach_ts(self, node) -> None:
        """Register a member-side TSNode to receive REPLY control traffic."""
        self.van.ts_handler = node.on_control

    # -- barriers (reference: postoffice.h:167) --------------------------

    def barrier(self, group: int, timeout: float = None) -> None:
        self.van.barrier(group, timeout if timeout is not None
                         else self.cfg.barrier_timeout_s)

    # -- key ranges (reference: postoffice.h:76 GetServerKeyRanges) ------

    def server_key_ranges(self, max_key: int = 1 << 58) -> List[Tuple[int, int]]:
        n = self.num_servers
        step = max_key // n
        return [
            (i * step, (i + 1) * step if i + 1 < n else max_key) for i in range(n)
        ]

    def num_dead_nodes(self, role: Optional[int] = None) -> int:
        """Nodes known dead: the declared (epoch) set on every member,
        plus — on the scheduler — the live heartbeat-lapse scan. ``role``
        filters to workers or servers (reference:
        postoffice.h:187 GetDeadNodes(role))."""
        dead = set(self.van.declared_dead_ids()) | set(self.van.dead_nodes())
        if role is not None:
            dead = {i for i in dead if self.van.node_roles.get(i) == role}
        return len(dead)
