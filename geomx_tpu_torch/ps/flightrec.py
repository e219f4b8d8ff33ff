"""Crash flight recorder: a bounded ring of recent wire/membership
events per van, always on.

Chaos failures (scripts/run_chaos_matrix.sh) used to be debugged by log
archaeology: by the time a node dies, the interesting part — the last
few frames it sent and received — has scrolled away or was never
logged. The recorder keeps the last ``GEOMX_FLIGHTREC_SIZE`` events
(Config.flightrec_size, default 256; 0 disables) in memory at a cost of
one deque append per data frame, and dumps them as JSON when something
goes wrong:

- the van is killed by a FaultPlan crash rule (``van._crash_from_fault``),
- a WIRE-SANITIZER violation fires (``sanitizer._violate``),
- a round dies at the caller — ``RoundFuture.wait`` raising
  ``TimeoutError``/``RoundAborted`` (``kvstore/frontier.py``),
- the process is shut down — SIGTERM or interpreter exit (reason class
  ``shutdown``, own ``*_shutdown.json`` file so it never clobbers a
  crash dump). Clean kills in the chaos matrix leave post-mortems too;
  only recorders created with an EXPLICIT ``GEOMX_FLIGHTREC_DIR`` are
  enrolled, so ordinary test runs don't litter ``$TMPDIR``.

Dumps land in ``GEOMX_FLIGHTREC_DIR`` (default: ``$TMPDIR/
geomx_flightrec``) as ``flightrec_<node>_pid<pid>.json`` — one file per
van per reason class, first trigger wins, written atomically so the
chaos matrix collects whole files. ``tools/flight_report.py`` renders
a dump as a readable narrative.

Event fields are flat and tiny: ``t`` (wall clock), ``kind`` (send /
recv / membership / give_up / violation / crash / note) plus whatever
the van attaches (peer, verb, bytes, request flag, trace round/chunk,
epoch). Wire events carry the trace context so a dump's tail
reads as "the in-flight round's frames".
"""

from __future__ import annotations

import atexit
import collections
import json
import logging
import os
import signal
import tempfile
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("geomx.flightrec")


def default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "geomx_flightrec")


# -- shutdown dumps ---------------------------------------------------------
# Recorders with an explicit out_dir enroll here; SIGTERM / interpreter
# exit dumps every live ring (reason class "shutdown") so clean kills in
# the chaos matrix leave post-mortems, not just crashes and violations.
_shutdown_registry: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_shutdown_hooks = threading.Lock()
_hooks_installed = False
_prev_sigterm: Any = None


def dump_all(reason: str) -> List[str]:
    """Dump every enrolled recorder with a non-empty ring; never raises."""
    paths = []
    for rec in list(_shutdown_registry):
        try:
            if rec.snapshot():
                p = rec.dump(reason)
                if p:
                    paths.append(p)
        except Exception:  # noqa: BLE001 — shutdown must not fail louder
            log.exception("shutdown dump failed")
    return paths


def _on_sigterm(signum, frame) -> None:
    dump_all("shutdown:sigterm")
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    elif prev != signal.SIG_IGN:
        # default disposition: restore it and re-deliver so the exit
        # status still says "killed by SIGTERM"
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _register_for_shutdown(rec: "FlightRecorder") -> None:
    global _hooks_installed, _prev_sigterm
    with _shutdown_hooks:
        _shutdown_registry.add(rec)
        if _hooks_installed:
            return
        _hooks_installed = True
    atexit.register(dump_all, "shutdown:atexit")
    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        # signals can only be installed from the main thread; vans built
        # off-main (tests, InProcessHiPS helpers) still get atexit dumps
        pass


class FlightRecorder:
    """One ring per van. ``node_fn`` is consulted lazily (the van only
    learns its id at rendezvous)."""

    def __init__(self, node_fn: Callable[[], str], size: int = 256,
                 out_dir: str = ""):
        self._node_fn = node_fn
        self.size = max(int(size), 0)
        self.out_dir = out_dir or default_dir()
        if out_dir and self.size > 0:
            _register_for_shutdown(self)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.size or 1)
        self._seq = 0
        # reason class (first token of the reason) -> dump path; a crash
        # cascade must not rewrite the interesting first dump N times
        self._dumped: Dict[str, str] = {}

    @property
    def enabled(self) -> bool:
        return self.size > 0

    def record(self, kind: str, **fields: Any) -> None:
        if self.size == 0:
            return
        with self._lock:
            self._seq += 1
            self._ring.append((self._seq, time.time(), kind, fields))

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            raw = list(self._ring)
        return [{"seq": s, "t": t, "kind": k, **f} for s, t, k, f in raw]

    def dump(self, reason: str, path: Optional[str] = None) -> str:
        """Write the ring; returns the path ("" when disabled or this
        reason class already dumped). Never raises — a failing dump must
        not mask the crash being recorded."""
        if self.size == 0:
            return ""
        cls = reason.split(":", 1)[0]
        with self._lock:
            if path is None and cls in self._dumped:
                return ""
            self._dumped.setdefault(cls, "")
        try:
            node = self._node_fn()
        except Exception:  # noqa: BLE001
            node = "unknown"
        doc = {
            "node": node,
            "reason": reason,
            "dumped_at": time.time(),
            "pid": os.getpid(),
            "events": self.snapshot(),
        }
        try:
            if path is None:
                os.makedirs(self.out_dir, exist_ok=True)
                # shutdown dumps get their own file: a clean-kill ring
                # must never overwrite the crash/violation dump that made
                # the run interesting
                suffix = "_shutdown" if cls == "shutdown" else ""
                path = os.path.join(
                    self.out_dir,
                    f"flightrec_{node}_pid{os.getpid()}{suffix}.json")
            tmp = f"{path}.tmp.{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("flight recorder dump failed (%s): %s", reason, e)
            with self._lock:
                # release the class reservation: a failed write must not
                # burn the one dump this class gets
                if not self._dumped.get(cls):
                    self._dumped.pop(cls, None)
            return ""
        with self._lock:
            self._dumped[cls] = path
        log.warning("flight recorder dumped %d event(s) to %s (%s)",
                    len(doc["events"]), path, reason)
        return path
