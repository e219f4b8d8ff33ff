"""Runtime conformance sanitizer: the dynamic dual of the GX-S50x
state-model pass (tools/analyze/statemodel.py).

Opt-in via ``GEOMX_STATE_SANITIZER=1`` (Config.state_sanitizer); the van
then mirrors every membership/epoch/recovery transition through the
SAME executable model the lint pass freezes and ``tools/modelcheck.py``
exhaustively explores (:class:`tools.analyze.statemodel.MemberView` /
:class:`SchedulerView`), in lock-step with the real handlers:

- ``declare_dead``         -> :meth:`StateSanitizer.on_declare`
- ``_process_dead_node``   -> :meth:`on_dead_node`
- ``_process_add_node``    -> :meth:`on_table` (member table adoption)
- ``_scheduler_register``  -> :meth:`on_revive` (slot re-fill)
- ``is_stale``             -> :meth:`on_fence` (zombie-fence verdicts)
- ``_complete_local_round``-> :meth:`on_release` (no fenced contributor
  in a released round)
- ``replication.restore``  -> :meth:`on_restore` (restore precedes
  serving)

Any divergence between the real transition's outcome and the model's —
a different adopt/stale/duplicate verdict, a different post-state, a
fence verdict the model disagrees with, a released round carrying a
contribution the model would fence — is latched with the grep-able
``STATE-SANITIZER VIOLATION`` marker (scripts/run_chaos_matrix.sh fails
on it), mirrored into telemetry and dumped by the flight recorder,
exactly like the wire sanitizer (ps/sanitizer.py) and the lock witness
(ps/locks.py).

All van hooks are invoked UNDER ``_member_lock`` (the sanitizer's own
lock is a leaf: ``_member_lock -> StateSanitizer._lock``), so the
mirror advances in the same total order as the real state.

The model import is guarded: in a deployment that ships only the
``geomx_tpu_torch`` package (no ``tools/``), the sanitizer disables itself
with a warning instead of breaking the van.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Sequence, Tuple

from geomx_tpu_torch import telemetry

try:                                        # tools/ ships with the repo,
    from tools.analyze.statemodel import (  # not with a bare package
        MemberView, SchedulerView)
except ImportError:                         # pragma: no cover
    MemberView = SchedulerView = None       # type: ignore[assignment]

log = logging.getLogger("geomx.conformance")

MARKER = "STATE-SANITIZER VIOLATION"


class StateSanitizer:
    """Lock-step model mirror for one van (plus its server's round
    release and restore, reached via ``getattr(van, "statecheck")``)."""

    def __init__(self, van):
        self.van = van
        self._lock = threading.Lock()
        self._mirror = None
        # (sender, epoch) pairs that passed an is_stale fence check at
        # least once — bounded by #nodes x #epochs. on_release uses it:
        # the CURRENT mirror view cannot judge a released round (a push
        # legitimately accepted before its sender died is still in the
        # round — the accepted staleness window), but every aggregated
        # contribution must have PASSED a fence check at accept time.
        self._fence_ok = set()
        self.violations: List[str] = []
        self._reported = False
        self.enabled = MemberView is not None
        if not self.enabled:                # pragma: no cover
            log.warning("GEOMX_STATE_SANITIZER=1 but tools.analyze is "
                        "not importable — conformance checks disabled")

    def _model(self):
        # lazy: van.is_scheduler is assigned after the sanitizer in
        # Van.__init__
        if self._mirror is None:
            self._mirror = (SchedulerView() if self.van.is_scheduler
                            else MemberView())
        return self._mirror

    # -- van hooks (caller holds van._member_lock) -----------------------

    def on_declare(self, fresh: Sequence[int], epoch: int,
                   dead: frozenset) -> None:
        """``Van.declare_dead`` committed: mirror must land on the same
        (epoch, dead set)."""
        if not self.enabled:
            return
        with self._lock:
            m = self._model()
            res = m.declare_dead(fresh)
            if res is None or res != (epoch, frozenset(dead)):
                self._violate(
                    f"declare_dead diverged: van -> epoch {epoch} dead "
                    f"{sorted(dead)}, model -> "
                    f"{res and (res[0], sorted(res[1]))}")

    def on_dead_node(self, epoch: int, new_dead, outcome: str,
                     post: Tuple[int, frozenset]) -> None:
        """``Van._process_dead_node`` ran: same stale/duplicate/adopt
        verdict and same post-state as the model."""
        if not self.enabled:
            return
        with self._lock:
            m = self._model()
            want = m.adopt_broadcast(epoch, new_dead)
            if want != outcome:
                self._violate(
                    f"DEAD_NODE(epoch={epoch}) outcome diverged: van "
                    f"{outcome!r}, model {want!r}")
            elif (m.epoch, frozenset(m.dead)) != (post[0],
                                                  frozenset(post[1])):
                self._violate(
                    f"DEAD_NODE(epoch={epoch}) post-state diverged: "
                    f"van (epoch {post[0]}, dead {sorted(post[1])}), "
                    f"model (epoch {m.epoch}, dead {sorted(m.dead)})")

    def on_table(self, epoch: int, recovery_ids: Sequence[int],
                 post: Tuple[int, frozenset]) -> None:
        """Member branch of ``Van._process_add_node`` adopted a table
        broadcast (epoch + recovery slots)."""
        if not self.enabled:
            return
        with self._lock:
            m = self._model()
            m.adopt_table(epoch, recovery_ids)
            if (m.epoch, frozenset(m.dead)) != (post[0],
                                                frozenset(post[1])):
                self._violate(
                    f"ADD_NODE table(epoch={epoch}, recovery="
                    f"{sorted(recovery_ids)}) post-state diverged: van "
                    f"(epoch {post[0]}, dead {sorted(post[1])}), model "
                    f"(epoch {m.epoch}, dead {sorted(m.dead)})")

    def on_revive(self, old_id: int, epoch: int) -> None:
        """Scheduler revived a dead slot (``_scheduler_register``)."""
        if not self.enabled:
            return
        with self._lock:
            m = self._model()
            want = m.revive(old_id)
            if want != epoch:
                self._violate(
                    f"revive({old_id}) diverged: van -> epoch {epoch}, "
                    f"model -> epoch {want}")

    def on_fence(self, sender: int, epoch: int, stale: bool) -> None:
        """``Van.is_stale`` answered: the model must agree."""
        if not self.enabled:
            return
        with self._lock:
            m = self._model()
            want = m.is_stale(sender, epoch)
            if want != stale:
                self._violate(
                    f"is_stale({sender}, epoch={epoch}) diverged: van "
                    f"{stale}, model {want} (model epoch {m.epoch}, "
                    f"dead {sorted(m.dead)}, rejoin "
                    f"{sorted(m.rejoin.items())})")
            if not stale:
                self._fence_ok.add((sender, epoch))

    # -- server / replication hooks (via getattr(van, "statecheck")) -----

    def on_release(self, key,
                   contributors: Sequence[Tuple[int, int]]) -> None:
        """A local round released with ``(sender, epoch)`` contributors:
        each must have PASSED an ``is_stale`` fence check at some point
        (a push legitimately accepted before its sender died may release
        later — the accepted staleness window — but a contribution that
        never saw a fence means the fence was bypassed or removed, the
        dynamic dual of GX-S504)."""
        if not self.enabled:
            return
        with self._lock:
            m = self._model()
            for sender, epoch in contributors:
                if (sender, epoch) not in self._fence_ok:
                    self._violate(
                        f"round release for key {key!r} aggregated a "
                        f"contribution that never passed the is_stale "
                        f"fence: sender {sender} epoch {epoch} (model "
                        f"dead {sorted(m.dead)}, rejoin "
                        f"{sorted(m.rejoin.items())})")

    def on_restore(self, source: Optional[str], served: bool) -> None:
        """``replication.restore`` ran; it must precede serving."""
        if not self.enabled:
            return
        with self._lock:
            if served:
                self._violate(
                    f"restore (source={source}) ran AFTER the server "
                    f"started serving — requests observed a "
                    f"half-restored store")

    # -- close-out -------------------------------------------------------

    def on_shutdown(self) -> List[str]:
        return self.report()

    def report(self) -> List[str]:
        with self._lock:
            if self._reported:
                return list(self.violations)
            self._reported = True
            n = len(self.violations)
        tag = getattr(self.van, "_tag", lambda: "?")()
        if n:
            log.error("%s state sanitizer: %d violation(s)", tag, n)
        else:
            log.info("%s state sanitizer: clean (0 violations)", tag)
        return list(self.violations)

    # -- plumbing --------------------------------------------------------

    def _violate(self, desc: str) -> None:
        # caller holds self._lock
        self.violations.append(desc)
        log.error("%s [van %s] %s", MARKER,
                  getattr(self.van, "my_id", "?"), desc)
        telemetry.event("conformance.violation", cat="sanitizer",
                        node=getattr(self.van, "my_id", "?"), desc=desc)
        telemetry.counter_inc("conformance.violations")
        rec = getattr(self.van, "flightrec", None)
        if rec is not None:
            rec.record("violation", desc=desc)
            rec.dump("conformance:" + desc)
