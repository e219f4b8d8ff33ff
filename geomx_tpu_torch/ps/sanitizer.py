"""Runtime wire sanitizer: the dynamic dual of the GX-P3xx protocol
pass (tools/analyze/protocol.py).

Opt-in via ``GEOMX_WIRE_SANITIZER=1`` (Config.wire_sanitizer); the van
then routes every outbound frame (post-reframe, pre-DGT-split) through
:meth:`WireSanitizer.on_send` and every inbound dispatch through
:meth:`WireSanitizer.on_inbound`, and calls :meth:`on_shutdown` (forgive
in-flight issued requests, then :meth:`report`) at ``van.stop()``. The
sanitizer checks, per van:

- **acked exactly once**: every non-control request we receive is
  answered by exactly one response; a response with no matching pending
  request (double-ack, or an ack routed to the wrong requester) is a
  violation. The one legal drop-without-ack is an ``is_stale`` fenced
  zombie — recognized here exactly the way the servers fence.
- **countdown leaks**: at :meth:`report` (round/process close) no
  received request is still pending an answer and no issued request is
  still unanswered — a leak means some aggregation countdown kept a
  requester parked forever.
- **epoch monotonicity**: a sender's stamped membership epoch never
  goes backwards (a regression means zombie traffic got past fencing).
- **no sends to the dead**: no data frame is addressed to a node this
  van has seen declared dead.

Violations are logged immediately at ERROR with the grep-able
``WIRE-SANITIZER VIOLATION`` marker (scripts/run_chaos_matrix.sh fails
on it) and collected in :attr:`violations` for tests.

Duplicate-delivery accounting assumes the resender's receipt dedup is
on (``PS_RESEND=1``) when a fault plan injects ``dup`` — without it a
duplicated frame legitimately reaches the app twice and the double-ack
report is the app-level truth, not a transport bug.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Tuple

from geomx_tpu_torch import telemetry
from geomx_tpu_torch.ps import dgt as dgt_mod

log = logging.getLogger("geomx.sanitizer")

MARKER = "WIRE-SANITIZER VIOLATION"

_Key = Tuple[int, int, int, int]  # (peer, app_id, customer_id, timestamp)


class WireSanitizer:
    def __init__(self, van):
        self.van = van
        self._lock = threading.Lock()
        # requests we received, awaiting our response: key -> recv line
        self._inbound: Dict[_Key, str] = {}
        # requests we issued, awaiting the peer's response
        self._outbound: Dict[_Key, str] = {}
        # issued requests the resender gave up on (late replies are not
        # double-acks)
        self._given_up: set = set()
        # sender id -> highest membership epoch seen from it
        self._epochs: Dict[int, int] = {}
        self.violations: List[str] = []
        self._reported = False

    # -- hooks (called by the van) --------------------------------------

    def on_send(self, target: int, msg) -> None:
        meta = msg.meta
        if msg.is_control:
            return
        dead = target in self.van.declared_dead_ids()
        key = (target, meta.app_id, meta.customer_id, meta.timestamp)
        with self._lock:
            if dead:
                self._violate(
                    f"send-to-dead: data frame addressed to declared-"
                    f"dead node {target} (app={meta.app_id} "
                    f"ts={meta.timestamp})")
            if meta.timestamp < 0:
                return
            if meta.request:
                self._outbound[key] = self._describe(meta, target)
            elif self._inbound.pop(key, None) is None:
                self._violate(
                    f"unmatched-response: response to {target} "
                    f"(app={meta.app_id} cust={meta.customer_id} "
                    f"ts={meta.timestamp}) matches no pending request "
                    f"— double ack or mis-routed ack")

    def on_inbound(self, msg) -> None:
        meta = msg.meta
        if msg.is_control or meta.msg_type in (dgt_mod.MSG_TYPE_BLOCK,
                                               dgt_mod.MSG_TYPE_TAIL):
            return
        stale = (meta.request and meta.push
                 and self.van.is_stale(meta.sender, meta.epoch))
        key = (meta.sender, meta.app_id, meta.customer_id, meta.timestamp)
        with self._lock:
            if meta.epoch > 0:
                last = self._epochs.get(meta.sender, 0)
                if meta.epoch < last:
                    self._violate(
                        f"epoch-regression: sender {meta.sender} stamped "
                        f"epoch {meta.epoch} after {last}")
                else:
                    self._epochs[meta.sender] = meta.epoch
            if meta.timestamp < 0:
                return
            if meta.request:
                if stale:
                    return  # the app fence-drops this; no ack is owed
                if key in self._inbound:
                    self._violate(
                        f"duplicate-request: {self._describe(meta, None)} "
                        f"delivered twice (transport dedup off or "
                        f"broken?)")
                else:
                    self._inbound[key] = self._describe(meta, None)
            elif self._outbound.pop(key, None) is None \
                    and key not in self._given_up:
                self._violate(
                    f"unexpected-response: response from "
                    f"{meta.sender} (app={meta.app_id} "
                    f"cust={meta.customer_id} ts={meta.timestamp}) "
                    f"matches no outstanding request")

    def on_give_up(self, msg) -> None:
        meta = msg.meta
        key = (meta.recver, meta.app_id, meta.customer_id, meta.timestamp)
        with self._lock:
            self._outbound.pop(key, None)
            self._given_up.add(key)

    # -- close-out -------------------------------------------------------

    def on_shutdown(self) -> List[str]:
        """Van close: forgive in-flight issued requests, then report.

        The last ack of a teardown cascade can always be lost (two
        generals): e.g. the final STOP_SERVER's response races the
        responder's own van.stop(), and the issuer already tolerates it
        with a bounded wait. Stopping the van IS the give-up for
        anything still awaiting a response, so those are moved to the
        forgiven set exactly like an explicit resender give-up. The
        responder-side checks (ack exactly once, countdown leaks) stay
        fully strict — so does a manual :meth:`report` call.
        """
        with self._lock:
            for key in list(self._outbound):
                self._outbound.pop(key)
                self._given_up.add(key)
        return self.report()

    def report(self) -> List[str]:
        """Flag every still-pending request as a leak; idempotent."""
        with self._lock:
            if self._reported:
                return list(self.violations)
            self._reported = True
            for desc in self._inbound.values():
                self._violate(
                    f"unacked-request (countdown leak): {desc} was never "
                    f"answered")
            for desc in self._outbound.values():
                self._violate(
                    f"unanswered-request: {desc} got no response and no "
                    f"give-up")
            n = len(self.violations)
        tag = getattr(self.van, "_tag", lambda: "?")()
        if n:
            log.error("%s wire sanitizer: %d violation(s)", tag, n)
        else:
            log.info("%s wire sanitizer: clean (0 violations)", tag)
        return list(self.violations)

    # -- plumbing --------------------------------------------------------

    def _describe(self, meta, target) -> str:
        kind = ("push" if meta.push else "pull" if meta.pull
                else "command" if meta.simple_app else "request")
        to = f"->{target} " if target is not None else f"<-{meta.sender} "
        return (f"{kind} {to}app={meta.app_id} cust={meta.customer_id} "
                f"ts={meta.timestamp} head={meta.head}")

    def _violate(self, desc: str) -> None:
        # caller holds self._lock
        self.violations.append(desc)
        log.error("%s [van %s] %s", MARKER,
                  getattr(self.van, "my_id", "?"), desc)
        telemetry.event("sanitizer.violation", cat="sanitizer",
                        node=getattr(self.van, "my_id", "?"), desc=desc)
        telemetry.counter_inc("sanitizer.violations")
        # a violation is exactly the moment the flight recorder exists
        # for: dump the recent wire history (dedup by reason class keeps
        # a cascade from rewriting the first, most interesting dump)
        rec = getattr(self.van, "flightrec", None)
        if rec is not None:
            rec.record("violation", desc=desc)
            rec.dump("violation:" + desc)
