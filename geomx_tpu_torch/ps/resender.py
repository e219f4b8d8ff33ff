"""ACK-based retransmission for van messages.

Plays the role of ps-lite's ``Resender`` (reference:
3rdparty/ps-lite/src/resender.h:15-141): every eligible outbound message
carries a unique signature (``msg_sig``); the receiver replies with an ACK
control frame carrying the same signature and drops duplicate signatures
it has already accepted; a monitor thread re-sends messages whose ACK has
not arrived within ``PS_RESEND_TIMEOUT`` milliseconds.

Deltas from the reference, on purpose:
- signatures are a per-van nonce (node id + clock-seeded counter) instead
  of a content hash — collision-free and cheaper than hashing payloads;
- the receiver marks-seen and ACKs ON RECEIPT, before processing
  (matching the reference, resender.h:54): processing is at-most-once —
  ACK confirms transport delivery, not application success (handler
  exceptions are logged by the dispatch loops). Marking after processing
  would let a retransmit that arrives mid-handling be processed twice;
- retries are capped (``max_retries``, default 10) so a permanently dead
  peer cannot accumulate an unbounded resend queue — the reference leans
  on heartbeat-based dead-node eviction for that instead. On give-up the
  ``on_give_up`` hook fires and the van routes request failures back to
  the issuing customer (wait() raises; callbacks get a failure flag);
- retransmit intervals back off exponentially from ``PS_RESEND_TIMEOUT``
  (capped at ``PS_RESEND_BACKOFF_MAX``) with seedable +-jitter, instead
  of the reference's fixed interval, and an optional overall delivery
  deadline (``PS_RESEND_DEADLINE``) abandons a message with a clear
  ``TimeoutError`` raised at the issuing customer's wait().

Enabled via ``PS_RESEND=1`` (reference: van.cc:527-533). Pairs with the
``PS_DROP_MSG`` fault injection: a lossy van with resend enabled must
still complete every push/pull (tested in tests/test_resender.py).
"""

from __future__ import annotations

import itertools
import logging
import random
import threading
import time
from collections import OrderedDict, deque
from typing import TYPE_CHECKING, Deque, Dict, Set, Tuple

from geomx_tpu_torch import telemetry
from geomx_tpu_torch.ps import locks
from geomx_tpu_torch.ps.message import Control, Message, Meta

if TYPE_CHECKING:  # pragma: no cover
    from geomx_tpu_torch.ps.van import Van

log = logging.getLogger("geomx.resender")

_DEDUP_WINDOW = 100_000  # remembered accepted signatures


@locks.guarded_by("_lock", "_outgoing", "_seen", "_seen_order")
class Resender:
    """Tracks in-flight messages for one van and re-sends unACKed ones."""

    def __init__(self, van: "Van", timeout_s: float, max_retries: int = 10,
                 deadline_s: float = 0.0, max_backoff_s: float = 30.0,
                 jitter: float = 0.1, seed=None):
        self.van = van
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        # overall per-message delivery deadline: past it the message is
        # abandoned with TimeoutError semantics (PS_RESEND_DEADLINE);
        # 0 = retry-count cap only
        self.deadline_s = deadline_s
        # retransmit intervals back off exponentially (timeout_s * 2^n,
        # capped at max_backoff_s) with +-jitter so a congested link
        # isn't hammered at a fixed period and retransmit storms from
        # many peers decorrelate; the jitter RNG is seeded (PS_SEED) so
        # retry schedules reproduce
        self.max_backoff_s = max_backoff_s
        self.jitter = max(0.0, min(jitter, 0.99))
        self._rng = random.Random(seed)
        self._lock = locks.make_lock("Resender._lock")
        # sig -> (target, message, first_send_monotonic, next_due, num_resends)
        self._outgoing: "OrderedDict[int, Tuple[int, Message, float, float, int]]" = (
            OrderedDict())
        self._seen: Set[int] = set()
        self._seen_order: Deque[int] = deque()
        # seed the counter from the wall clock so a recovered node (same
        # id, fresh Resender) never reuses an old incarnation's signatures
        # — peers' dedup windows would silently swallow the new messages.
        # 16ns ticks: the clock outruns any plausible send rate (a node
        # would need a sustained 62M msg/s for its counter to catch the
        # next incarnation's seed); 48-bit space wraps only after ~52 days
        self._counter = itertools.count(
            (time.time_ns() >> 4) & ((1 << 48) - 1))
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._monitor, name="van-resend", daemon=True)
        self._thread.start()
        self.num_resends = 0
        self.num_duplicates = 0
        # invoked (outside the lock) with (target, msg, exc, reason)
        # when a message exhausts max_retries (exc=RuntimeError) or its
        # delivery deadline (exc=TimeoutError) — the van routes request
        # give-ups back to the issuing customer so its wait() fails fast
        # with the right exception type (the reference has no cap and
        # leans on heartbeat eviction; with a cap, silence would leave
        # the requester blocked to its timeout)
        self.on_give_up = None

    # -- sender side -----------------------------------------------------

    def assign_sig(self, msg: Message) -> int:
        """Unique signature: node id in the high bits, counter in the low."""
        sig = ((self.van.my_id & 0x7FFF) << 48) | (
            next(self._counter) & ((1 << 48) - 1))
        msg.meta.msg_sig = sig
        return sig

    def _backoff(self, n: int) -> float:
        """Interval before resend n+1: exponential with +-jitter."""
        b = min(self.timeout_s * (2 ** n), self.max_backoff_s)
        if self.jitter > 0:
            b *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return b

    def add_outgoing(self, target: int, msg: Message) -> None:
        now = time.monotonic()
        with self._lock:
            self._outgoing[msg.meta.msg_sig] = (
                target, msg, now, now + self._backoff(0), 0)

    def handle_ack(self, sig: int) -> None:
        with self._lock:
            ent = self._outgoing.pop(sig, None)
        if ent is None:
            return
        # geomx-healthd: the send→ack span of a never-retransmitted data
        # frame is the raw material for per-link RTT/bandwidth estimation
        # (linkstate.LinkEstimator); retransmitted frames are ambiguous
        # (the ACK may answer any copy) and control frames carry no
        # payload worth timing
        ls = self.van.linkstate
        if ls is not None:
            target, msg, t0, _due, n = ent
            if n == 0 and not msg.is_control:
                nbytes = sum(len(d) for d in msg.data) if msg.data else 0
                ls.note_span(target, nbytes, time.monotonic() - t0)

    # -- receiver side ---------------------------------------------------

    def is_duplicate(self, sig: int) -> bool:
        with self._lock:
            if sig in self._seen:
                self.num_duplicates += 1
                telemetry.counter_inc(
                    "resender.duplicates",
                    tier="global" if self.van.is_global else "local")
                return True
            return False

    def mark_seen(self, sig: int) -> None:
        """Record an accepted signature ON RECEIPT, before the message is
        processed (reference: resender.h:54) — marking later leaves a
        window where a retransmit of a message still being handled is
        processed a second time."""
        with self._lock:
            if sig in self._seen:
                return
            self._seen.add(sig)
            self._seen_order.append(sig)
            if len(self._seen_order) > _DEDUP_WINDOW:
                self._seen.discard(self._seen_order.popleft())

    def send_ack(self, msg: Message) -> None:
        """ACK an accepted (or duplicate) inbound message back to its sender."""
        ack = Message(Meta(
            recver=msg.meta.sender,
            sender=self.van.my_id,
            control_cmd=Control.ACK,
            msg_sig=msg.meta.msg_sig,
            is_global=self.van.is_global,
        ))
        try:
            self.van._send_one(msg.meta.sender, ack)
        except OSError:
            # sender unreachable (teardown); it will retransmit or give up
            pass

    # -- dead-peer fast fail (elastic membership) ------------------------

    def fail_peer(self, target: int, reason: str = "") -> None:
        """Fail every pending send to ``target`` NOW. Fired when the
        scheduler declares the peer dead — without this, each in-flight
        message to a corpse burns its full PS_RESEND_DEADLINE (or retry
        budget) before the issuing customer's wait() raises."""
        reason = reason or f"peer {target} declared dead"
        gave_up = []
        with self._lock:
            for sig, (t, msg, _t0, _due, n) in list(self._outgoing.items()):
                if t != target:
                    continue
                self._outgoing.pop(sig, None)
                gave_up.append((t, msg, RuntimeError,
                                f"{reason} ({n} retransmits)"))
        if gave_up:
            log.warning("failing %d pending message(s) to dead peer %d",
                        len(gave_up), target)
        self._fire_give_ups(gave_up)

    def _fire_give_ups(self, gave_up) -> None:
        for target, msg, exc, reason in gave_up:
            if self.on_give_up is not None:
                try:
                    self.on_give_up(target, msg, exc, reason)
                except Exception:  # noqa: BLE001 — monitor must survive
                    log.exception("on_give_up hook failed")

    # -- monitor ---------------------------------------------------------

    def _monitor(self) -> None:
        period = max(self.timeout_s / 4.0, 0.02)
        while not self._stopped.wait(period):
            now = time.monotonic()
            to_resend = []
            gave_up = []
            # messages registered AFTER the declaration (racing sends)
            # are caught here each cycle; fail_peer drains the rest at
            # declaration time
            ddi = getattr(self.van, "declared_dead_ids", None)
            dead_peers = ddi() if ddi is not None else frozenset()
            with self._lock:
                for sig, (target, msg, t0, due,
                          n) in list(self._outgoing.items()):
                    if target in dead_peers:
                        self._outgoing.pop(sig, None)
                        gave_up.append((
                            target, msg, RuntimeError,
                            f"peer {target} declared dead (membership "
                            f"epoch {self.van.membership_epoch}, "
                            f"{n} retransmits)"))
                        continue
                    if self.deadline_s > 0 and now - t0 >= self.deadline_s:
                        log.error("abandoning msg sig=%x to %d: no ACK "
                                  "within the %.1fs delivery deadline "
                                  "(%d resends)", sig, target,
                                  self.deadline_s, n)
                        self._outgoing.pop(sig, None)
                        gave_up.append((
                            target, msg, TimeoutError,
                            f"no ACK from node {target} within the "
                            f"{self.deadline_s:.1f}s delivery deadline "
                            f"({n} retransmits)"))
                        continue
                    if now < due:
                        continue
                    if n >= self.max_retries:
                        log.error("giving up on msg sig=%x to %d after %d "
                                  "resends", sig, target, n)
                        self._outgoing.pop(sig, None)
                        gave_up.append((
                            target, msg, RuntimeError,
                            f"retransmit retries exhausted to node "
                            f"{target} ({n} resends)"))
                        continue
                    self._outgoing[sig] = (
                        target, msg, t0, now + self._backoff(n + 1), n + 1)
                    to_resend.append((target, msg))
            self._fire_give_ups(gave_up)
            ls = self.van.linkstate
            for target, msg in to_resend:
                self.num_resends += 1
                telemetry.counter_inc(
                    "resender.resends",
                    tier="global" if self.van.is_global else "local")
                if ls is not None:
                    ls.note_retransmit(target)
                try:
                    self.van._send_one(target, msg)
                except OSError as e:
                    log.debug("resend to %d failed (%s); will retry", target, e)

    def pending(self) -> int:
        with self._lock:
            return len(self._outgoing)

    def stop(self) -> None:
        self._stopped.set()
