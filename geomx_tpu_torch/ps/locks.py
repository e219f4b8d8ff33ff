"""geomx-racecheck: runtime lock/race sanitizer — the dynamic dual of
the GX-L0xx concurrency pass (tools/analyze/concurrency.py +
tools/analyze/lockmodel.py).

Opt-in via ``GEOMX_LOCK_SANITIZER=1`` (Config.lock_sanitizer). The hot
concurrency surfaces (van, resender, postoffice, kvstore server,
replication, linkstate, tsengine) build their primitives through the
factories here — :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition` — which return **raw** ``threading`` primitives
when the sanitizer is off, so the off-path cost is one branch at
construction time and zero per acquisition. When on, the traced
drop-ins feed one process-global :class:`LockWitness`:

- **held-lock stacks**: every thread's current stack of traced locks.
- **acquisition-order graph**: lockdep-style, keyed by lock *name*
  (``"Van._conn_lock"`` is one node across every van instance). A
  *potential* deadlock — any cycle in the order graph, the inverted
  pair being the 2-cycle — is flagged on the FIRST inversion ever
  observed, naming both locks and both acquisition stacks; no actual
  deadlock has to occur.
- **blocking-call-under-lock**: with the sanitizer on, ``time.sleep``,
  ``Queue.get/put``, ``Thread.join`` and the socket send/recv/accept/
  connect family are probed; calling one while holding any traced lock
  is a violation (``Condition.wait`` on its OWN lock is exempt — wait
  releases it — but waiting while holding another traced lock fires).
- **Eraser-style lockset checking**: shared fields are declared with
  the :func:`guarded_by` class decorator. Writes to a declared field
  are intercepted (``__setattr__`` hook, installed only when the
  sanitizer is on): a write while holding the declared lock publishes
  the field; an unlocked write is legal only while the field is still
  confined to the single thread that first wrote it (the construction
  phase). Reads are not intercepted — this is a write-side lockset.

Violations are latched per fingerprint (the seeded-inversion test pins
"exactly one"), logged at ERROR with the grep-able ``LOCK-SANITIZER
VIOLATION`` marker (scripts/run_chaos_matrix.sh fails on it), counted
through the telemetry funnel, and recorded into every attached flight
recorder as ``kind=race`` with an immediate dump — mirroring
``ps/sanitizer.py`` exactly.

One shared model: the witness loads ``tools/analyze/locks.lock.json``
— the same file the static ``lockmodel`` pass freezes (GX-L007) — and
cross-checks every runtime :func:`guarded_by` registration against it,
so the static declarations and the runtime locksets cannot silently
diverge.
"""

from __future__ import annotations

import json
import logging
import threading
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

from geomx_tpu_torch import config as cfg_mod
from geomx_tpu_torch import telemetry

log = logging.getLogger("geomx.locks")

MARKER = "LOCK-SANITIZER VIOLATION"

# field published under its lock: unlocked writes are violations from
# here on, whichever thread issues them
_SHARED = "<shared>"

_enabled = cfg_mod.env_bool("GEOMX_LOCK_SANITIZER")

_tls = threading.local()


def _held() -> List[Tuple[str, Any]]:
    """This thread's stack of (name, primitive) for held traced locks."""
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


_OWN_FILE = __file__  # exact match — "tests/test_locks.py" must survive


def _stack_summary(limit: int = 16, keep: int = 6) -> str:
    """Short ``file:line fn`` chain of the caller, newest frame last,
    with this module's own frames dropped."""
    frames = [f for f in traceback.extract_stack(limit=limit)
              if f.filename != _OWN_FILE]
    return " -> ".join(
        f"{Path(f.filename).name}:{f.lineno}:{f.name}"
        for f in frames[-keep:])


def _twin_path(module: str) -> str:
    """Repo path of ``module``'s twin in the JAX package: the port's host
    layers are copies of ``geomx_tpu``'s, and the frozen lock model is
    keyed by ``geomx_tpu/...`` paths, so ``geomx_tpu_torch/<p>`` is looked
    up under ``geomx_tpu/<p>``."""
    rel = module.replace(".", "/") + ".py"
    head, _, tail = rel.partition("/")
    return f"geomx_tpu/{tail}" if head == "geomx_tpu_torch" else rel


def _lock_model_path() -> Path:
    return (Path(__file__).resolve().parents[2]
            / "tools" / "analyze" / "locks.lock.json")


class LockWitness:
    """Process-global collector for every traced primitive."""

    def __init__(self):
        # internal lock is deliberately RAW: the witness must never
        # trace itself
        self._mu = threading.Lock()
        # (held_name, acquired_name) -> stack summary at first sighting
        self._edges: Dict[Tuple[str, str], str] = {}
        self._succ: Dict[str, Set[str]] = {}
        self.violations: List[str] = []
        self._fired: Set[str] = set()
        self._flightrecs: List[Any] = []
        self._model = self._load_model()
        self._reported = False

    # -- shared model ---------------------------------------------------

    @staticmethod
    def _load_model() -> Dict[str, Any]:
        """``tools/analyze/locks.lock.json`` — absent (installed wheel,
        fixture project) means no cross-check, never an error."""
        try:
            p = _lock_model_path()
            if p.exists():
                return json.loads(p.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            log.warning("lock model unreadable; runtime cross-check off")
        return {}

    def check_declaration(self, module: str, cls_name: str, field: str,
                          lock_name: str) -> None:
        """Cross-check one runtime ``@guarded_by`` registration against
        the static lock model (same JSON GX-L007 freezes)."""
        files = self._model.get("files")
        if not files:
            return
        rel = _twin_path(module)
        entry = files.get(rel)
        if entry is None:
            return
        guarded = (entry.get("classes", {}).get(cls_name, {})
                   .get("guarded", {}))
        static_lock = guarded.get(field)
        if static_lock is None:
            # new runtime declaration the frozen model has not seen:
            # GX-L007 fails the static gate; at runtime a warning is
            # enough to point at --update-lock-model
            log.warning("guarded_by(%r, %r) on %s.%s is not in the lock "
                        "model — run python -m tools.analyze "
                        "--update-lock-model", lock_name, field,
                        cls_name, module)
        elif static_lock != lock_name:
            self.violate(
                "model-divergence",
                f"{cls_name}.{field} declared guarded by {lock_name!r} "
                f"at runtime but by {static_lock!r} in the static lock "
                f"model ({_lock_model_path().name})")

    # -- acquisition-order graph ----------------------------------------

    def before_acquire(self, name: str) -> None:
        """Record order edges held->name BEFORE blocking on the lock, so
        a would-be deadlock is reported rather than silently entered."""
        held = _held()
        if not held:
            return
        stack = None
        with self._mu:
            for h, _obj in held:
                if h == name:
                    continue  # same-name re-entry is GX-L004's business
                if (h, name) in self._edges:
                    continue
                if stack is None:
                    # extract_stack is the expensive part: pay for it
                    # only on a pair's FIRST sighting, never in the
                    # steady state where every edge is already latched
                    stack = _stack_summary()
                self._edges[(h, name)] = stack
                self._succ.setdefault(h, set()).add(name)
                cycle = self._find_cycle(name, h)
                if cycle is not None:
                    self._flag_cycle(h, name, stack, cycle)

    def _find_cycle(self, frm: str, to: str) -> Optional[List[str]]:
        """Path frm ->* to in the order graph (the new edge to->frm just
        closed a cycle when one exists)."""
        stack, seen = [(frm, [frm])], set()
        while stack:
            node, path = stack.pop()
            if node == to:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self._succ.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def _flag_cycle(self, held: str, acq: str, stack: str,
                    path: List[str]) -> None:
        # caller holds self._mu
        pair = "/".join(sorted(set([held, acq] + path)))
        if len(path) == 2:
            other_stack = self._edges.get((acq, held), "?")
            desc = (f"lock-order inversion: {held!r} then {acq!r}\n"
                    f"  this thread:  {held} -> {acq} at {stack}\n"
                    f"  seen before:  {acq} -> {held} at {other_stack}")
        else:
            desc = (f"lock-order cycle {' -> '.join(path + [path[0]])} "
                    f"closed by {held} -> {acq} at {stack}")
        self._violate_locked(f"inversion:{pair}", desc)

    # -- blocking calls / waits ------------------------------------------

    def on_blocking(self, callname: str) -> None:
        held = _held()
        if not held:
            return
        names = [h for h, _obj in held]
        self.violate(
            f"blocking:{callname}:{'/'.join(sorted(set(names)))}",
            f"blocking call {callname}() while holding traced lock(s) "
            f"{sorted(set(names))} at {_stack_summary()}")

    def on_wait(self, own: str) -> None:
        """Condition.wait releases its own lock but keeps every other
        held lock across the sleep."""
        others = sorted({h for h, _obj in _held() if h != own})
        if others:
            self.violate(
                f"wait-under-lock:{own}:{'/'.join(others)}",
                f"Condition.wait on {own!r} while still holding "
                f"{others} at {_stack_summary()}")

    # -- Eraser-style lockset --------------------------------------------

    def on_guarded_write(self, obj: Any, cls_name: str, field: str,
                         lock_name: str) -> None:
        lk = getattr(obj, lock_name, None)
        d = getattr(obj, "__dict__", None)
        if d is None:
            return  # __slots__ class: nowhere to hang lockset state
        states = d.setdefault("__lockset__", {})
        if lk is not None and getattr(lk, "held_by_me", None) is not None \
                and lk.held_by_me():
            states[field] = _SHARED
            return
        tid = threading.get_ident()
        st = states.get(field)
        if st is None:
            states[field] = tid     # construction phase: thread-confined
        elif st != tid:
            self.violate(
                f"lockset:{cls_name}.{field}",
                f"unguarded write to {cls_name}.{field} (declared "
                f"@guarded_by({lock_name!r})) "
                + ("after it was published under its lock"
                   if st == _SHARED else
                   f"from a second thread (first writer {st})")
                + f" at {_stack_summary()}")

    # -- violation funnel ------------------------------------------------

    def attach_flightrec(self, rec: Any) -> None:
        with self._mu:
            if rec is not None and rec not in self._flightrecs:
                self._flightrecs.append(rec)

    def violate(self, fingerprint: str, desc: str) -> None:
        with self._mu:
            self._violate_locked(fingerprint, desc)

    def _violate_locked(self, fingerprint: str, desc: str) -> None:
        # caller holds self._mu; latch so a loop spinning on a bad pair
        # reports exactly once
        if fingerprint in self._fired:
            return
        self._fired.add(fingerprint)
        self.violations.append(desc)
        recs = list(self._flightrecs)
        log.error("%s %s", MARKER, desc)
        telemetry.event("lock_sanitizer.violation", cat="sanitizer",
                        desc=desc.splitlines()[0])
        telemetry.counter_inc("lock_sanitizer.violations")
        for rec in recs:
            try:
                rec.record("race", desc=desc)
                rec.dump("race:" + desc.splitlines()[0])
            except Exception:  # noqa: BLE001 — reporting must not raise
                log.exception("flight recorder race dump failed")

    def report(self) -> List[str]:
        """Log a summary once; returns the violation list (stable)."""
        with self._mu:
            n = len(self.violations)
            first = self._reported
            self._reported = True
        if not first:
            if n:
                log.error("lock sanitizer: %d violation(s)", n)
            else:
                log.info("lock sanitizer: clean (0 violations)")
        return list(self.violations)


_witness = LockWitness()


def witness() -> LockWitness:
    return _witness


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    """Turn the sanitizer on for primitives constructed AFTER this call
    (tests; Postoffice applies Config.lock_sanitizer affirmatively, like
    telemetry.configure). Installs the blocking probes on first enable."""
    global _enabled
    _enabled = on
    if on:
        _install_blocking_probes()


def reset_for_tests(on: Optional[bool] = None) -> LockWitness:
    """Fresh witness + empty held stacks for the current thread."""
    global _witness
    _witness = LockWitness()
    _tls.held = []
    if on is not None:
        enable(on)
    return _witness


# ---------------------------------------------------------------------------
# traced primitives
# ---------------------------------------------------------------------------

class TracedLock:
    """Drop-in ``threading.Lock`` feeding the witness."""

    def __init__(self, name: str = ""):
        self.name = name or f"lock@{id(self):x}"
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _witness.before_acquire(self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _held().append((self.name, self))
        return ok

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                del held[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_me(self) -> bool:
        return any(obj is self for _n, obj in _held())

    # threading.Condition interop
    def _is_owned(self) -> bool:
        return self.held_by_me()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TracedLock {self.name} locked={self.locked()}>"


class TracedRLock:
    """Drop-in ``threading.RLock``: only the 0->1 acquisition and the
    1->0 release touch the witness/held stack."""

    def __init__(self, name: str = ""):
        self.name = name or f"rlock@{id(self):x}"
        self._inner = threading.RLock()

    def _depths(self) -> Dict[int, int]:
        d = getattr(_tls, "rdepth", None)
        if d is None:
            d = _tls.rdepth = {}
        return d

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        depths = self._depths()
        if depths.get(id(self), 0) == 0:
            _witness.before_acquire(self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            depth = depths.get(id(self), 0) + 1
            depths[id(self)] = depth
            if depth == 1:
                _held().append((self.name, self))
        return ok

    def release(self) -> None:
        depths = self._depths()
        depth = depths.get(id(self), 0) - 1
        if depth <= 0:
            depths.pop(id(self), None)
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i][1] is self:
                    del held[i]
                    break
        else:
            depths[id(self)] = depth
        self._inner.release()

    def held_by_me(self) -> bool:
        return self._depths().get(id(self), 0) > 0

    # threading.Condition interop: an RLock-backed condition must
    # release EVERY recursion level across a wait
    def _is_owned(self) -> bool:
        return self.held_by_me()

    def _release_save(self):
        depths = self._depths()
        depth = depths.pop(id(self), 0)
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                del held[i]
                break
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, saved) -> None:
        inner_state, depth = saved
        self._inner._acquire_restore(inner_state)
        if depth > 0:
            self._depths()[id(self)] = depth
            _held().append((self.name, self))

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TracedRLock {self.name}>"


class TracedCondition:
    """Drop-in ``threading.Condition`` over a traced lock. Waiting on
    the condition's OWN lock is the sanctioned pattern; waiting while
    holding any OTHER traced lock is a violation (the other lock sleeps
    with you)."""

    def __init__(self, lock=None, name: str = ""):
        if lock is None:
            lock = TracedLock(f"{name}.lock" if name else "")
        self.name = name or f"cond<{getattr(lock, 'name', '?')}>"
        self._lk = lock
        self._cond = threading.Condition(lock)

    def acquire(self, *a, **kw):
        return self._lk.acquire(*a, **kw)

    def release(self) -> None:
        self._lk.release()

    def held_by_me(self) -> bool:
        held = getattr(self._lk, "held_by_me", None)
        return held() if held is not None else False

    def wait(self, timeout: Optional[float] = None):
        _witness.on_wait(getattr(self._lk, "name", "?"))
        # the delegating wrapper itself: the CALLER's while loop is the
        # predicate loop GX-L006 wants
        return self._cond.wait(timeout)  # geomx-lint: disable=GX-L006

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _witness.on_wait(getattr(self._lk, "name", "?"))
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __enter__(self):
        return self._lk.__enter__()

    def __exit__(self, *exc) -> None:
        self._lk.__exit__(*exc)

    def __repr__(self) -> str:
        return f"<TracedCondition {self.name}>"


# ---------------------------------------------------------------------------
# factories: the ONE branch the off path pays, at construction time
# ---------------------------------------------------------------------------

def make_lock(name: str = ""):
    """``threading.Lock()`` when the sanitizer is off; traced when on."""
    if not _enabled:
        return threading.Lock()
    return TracedLock(name)


def make_rlock(name: str = ""):
    if not _enabled:
        return threading.RLock()
    return TracedRLock(name)


def make_condition(lock=None, name: str = ""):
    """``threading.Condition(lock)`` when off. When on, a traced
    condition; holding it counts as holding ``lock`` (pass the traced
    lock the class already built so the held stacks alias correctly)."""
    if not _enabled:
        return threading.Condition(lock)
    if lock is not None and not isinstance(lock, (TracedLock, TracedRLock)):
        # a raw lock slipped in after enable(): stay functional, untraced
        return threading.Condition(lock)
    return TracedCondition(lock, name)


# ---------------------------------------------------------------------------
# @guarded_by: the declaration both the static lockmodel pass and the
# runtime lockset checker read
# ---------------------------------------------------------------------------

def guarded_by(lock_name: str, *fields: str):
    """Class decorator: declare that writes to ``fields`` require
    holding ``self.<lock_name>``. Stack one decorator per lock::

        @locks.guarded_by("_lock", "_links", "_round")
        class LinkEstimator: ...

    Off path: records ``__guarded_by__`` metadata and returns the class
    untouched. Sanitizer on: installs a ``__setattr__`` hook running the
    Eraser-style lockset check on every write to a declared field.
    """
    def deco(cls):
        gmap = dict(cls.__dict__.get("__guarded_by__", {}))
        for f in fields:
            gmap[f] = lock_name
        cls.__guarded_by__ = gmap
        if _enabled:
            for f in fields:
                _witness.check_declaration(cls.__module__, cls.__name__,
                                           f, lock_name)
            _install_lockset_hook(cls)
        return cls
    return deco


def _install_lockset_hook(cls) -> None:
    if cls.__dict__.get("__lockset_hooked__"):
        return
    cls.__lockset_hooked__ = True
    orig = cls.__setattr__

    def __setattr__(self, attr, value):
        lock_name = cls.__guarded_by__.get(attr)
        if lock_name is not None:
            _witness.on_guarded_write(self, cls.__name__, attr, lock_name)
        orig(self, attr, value)

    cls.__setattr__ = __setattr__


# ---------------------------------------------------------------------------
# blocking-call probes (installed only when the sanitizer is on)
# ---------------------------------------------------------------------------

_probes_installed = False


def _probed(callname: str, fn):
    def wrapper(*args, **kwargs):
        if getattr(_tls, "held", None) and not getattr(_tls, "probe", False):
            _tls.probe = True
            try:
                _witness.on_blocking(callname)
            finally:
                _tls.probe = False
        return fn(*args, **kwargs)
    wrapper.__name__ = getattr(fn, "__name__", callname)
    wrapper.__wrapped__ = fn
    return wrapper


def _install_blocking_probes() -> None:
    """Patch the blocking stdlib entry points GX-L003 models — sleep,
    queue get/put, thread join, the socket family — to consult the
    current thread's traced-lock stack first. Only ever installed when
    the sanitizer is on; idempotent."""
    global _probes_installed
    if _probes_installed:
        return
    _probes_installed = True
    import queue
    import socket
    import time

    time.sleep = _probed("time.sleep", time.sleep)
    queue.Queue.get = _probed("Queue.get", queue.Queue.get)
    queue.Queue.put = _probed("Queue.put", queue.Queue.put)
    threading.Thread.join = _probed("Thread.join", threading.Thread.join)
    for meth in ("send", "sendall", "sendto", "recv", "recv_into",
                 "recvfrom", "accept", "connect"):
        try:
            setattr(socket.socket, meth,
                    _probed(f"socket.{meth}", getattr(socket.socket, meth)))
        except (AttributeError, TypeError):  # platform without the method
            pass


if _enabled:
    _install_blocking_probes()
