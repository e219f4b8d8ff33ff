"""Per-app request/response tracking and receive-thread dispatch.

Plays the role of ps-lite's ``Customer`` (reference:
3rdparty/ps-lite/include/ps/internal/customer.h:27-128, src/customer.cc):
each application object (KVWorker / KVServer) owns one Customer; the van
routes inbound messages to ``accept``; a dedicated processing thread invokes
the app's receive handler; request timestamps are matched against expected
response counts so ``wait`` can block until completion.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

from geomx_tpu_torch.ps.message import Message


class Customer:
    def __init__(
        self,
        app_id: int,
        customer_id: int,
        recv_handle: Callable[[Message], None],
    ):
        self.app_id = app_id
        self.customer_id = customer_id
        self.recv_handle = recv_handle
        self._queue: "queue.Queue[Optional[Message]]" = queue.Queue()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # ts -> [num_expected, num_received]
        self._tracker: Dict[int, list] = {}
        # ts -> (failure reason, exception type); set by the transport
        # when a request becomes undeliverable (resender give-up /
        # delivery deadline) so wait_request fails fast — with the right
        # exception class — instead of blocking to its timeout
        self._errors: Dict[int, tuple] = {}
        # callback-driven requests are never wait()ed; auto-drop their
        # tracker entries on completion to avoid unbounded growth
        self._auto_clear: set = set()
        self._next_ts = 0
        self._thread = threading.Thread(
            target=self._receiving, name=f"customer-{app_id}-{customer_id}", daemon=True
        )
        self._thread.start()

    # -- request lifecycle (reference: customer.h:66-90) -----------------

    def new_request(self, num_responses: int, auto_clear: bool = False) -> int:
        with self._lock:
            ts = self._next_ts
            self._next_ts += 1
            self._tracker[ts] = [num_responses, 0]
            if auto_clear:
                self._auto_clear.add(ts)
            return ts

    def wait_request(self, ts: int, timeout: Optional[float] = None) -> None:
        """Block until all responses for ``ts`` arrived.

        Completed entries are dropped from the tracker here (the reference
        keeps them forever, customer.cc — a leak we don't reproduce); waiting
        again on an already-completed ts returns immediately.
        """
        with self._cv:
            if not self._cv.wait_for(
                lambda: ts not in self._tracker
                or self._tracker[ts][1] >= self._tracker[ts][0]
                or ts in self._errors,
                timeout,
            ):
                self._errors.pop(ts, None)  # no leak on the timeout path
                raise TimeoutError(f"wait_request(ts={ts}) timed out")
            err = self._errors.pop(ts, None)
            entry = self._tracker.pop(ts, None)
            if err is not None and not (entry and entry[1] >= entry[0]):
                reason, exc = err
                raise exc(reason)

    def num_response(self, ts: int) -> int:
        with self._lock:
            return self._tracker.get(ts, [0, 0])[1]

    def add_response(self, ts: int, n: int = 1) -> None:
        with self._cv:
            if ts in self._tracker:
                self._tracker[ts][1] += n
                if (ts in self._auto_clear
                        and self._tracker[ts][1] >= self._tracker[ts][0]):
                    self._tracker.pop(ts)
                    self._auto_clear.discard(ts)
                self._cv.notify_all()

    # invoked with (ts, reason) when fail_request hits a callback-driven
    # (auto_clear) entry, so the app layer can run its failure path — a
    # cb request has no wait() to surface the error through
    on_fail = None

    def fail_request(self, ts: int, reason: str,
                     exc: type = RuntimeError) -> None:
        """Mark an in-flight request undeliverable (transport give-up).

        ``exc`` is the exception class wait_request raises for it —
        RuntimeError for a retry-cap give-up, TimeoutError for a blown
        delivery deadline.

        Waited requests: the error is recorded and wait_request raises.
        Callback-driven (auto_clear) requests: the tracker entry is
        dropped and ``on_fail`` fires so the owner can retry or abort —
        leaving the callback silently un-invoked would wedge protocol
        state machines built on it (e.g. a HiPS staging cycle)."""
        hook = None
        with self._cv:
            if ts not in self._tracker:
                return
            if ts in self._auto_clear:
                self._tracker.pop(ts, None)
                self._auto_clear.discard(ts)
                hook = self.on_fail
            else:
                self._errors[ts] = (reason, exc)
                self._cv.notify_all()
        if hook is not None:
            hook(ts, reason)

    # -- inbound ---------------------------------------------------------

    def accept(self, msg: Message) -> None:
        self._queue.put(msg)

    def _receiving(self) -> None:
        import logging

        log = logging.getLogger("geomx.customer")
        while True:
            msg = self._queue.get()
            if msg is None:
                return
            try:
                self.recv_handle(msg)
            except Exception:
                # a handler crash must not kill the processing thread —
                # that would silently hang every later request
                log.exception("recv handler failed (app=%s cid=%s)",
                              self.app_id, self.customer_id)
            if not msg.meta.request and msg.meta.timestamp >= 0:
                self.add_response(msg.meta.timestamp)

    def stop(self) -> None:
        self._queue.put(None)
