"""Tracing/profiling: chrome-trace host events + device trace bridge.

Plays the role of the reference profiler (reference: src/profiler/
profiler.h:256 Profiler singleton, SetState :270, DumpProfile :304 —
chrome-tracing JSON output; python/mxnet/profiler.py set_config/
set_state/pause/resume/dump surface), re-designed for the TPU stack:

- host-side protocol events (push/pull handling, van traffic, aggregation
  rounds) are recorded by this module into chrome trace-event JSON,
  viewable in chrome://tracing or Perfetto — same artifact the reference
  emits;
- device-side compute profiling is delegated to ``torch.profiler``
  (CUPTI sees the card's kernels): :func:`start_device_trace` /
  :func:`stop_device_trace` start and stop one ``torch.profiler.profile``
  and export its chrome trace, so one call site controls both layers.

The distributed twist is kept: workers remotely drive SERVER profilers
over the command channel (reference: KVStoreServerProfilerCommand
{kSetConfig,kState,kPause,kDump}, include/mxnet/kvstore.h:49, sent by
kvstore_dist.h:197-203, handled by kvstore_dist_server.h:383-430 which
prefixes dump files with ``rank<N>_``). See
``KVStoreDist.set_profiler_params`` and the server's command handler.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_counters: Dict[str, float] = {}
_state_running = False
_paused = False
_device_trace_dir: Optional[str] = None
_device_prof = None
_config: Dict[str, Any] = {"filename": "profile.json"}
_t0 = time.monotonic()

# remote profiler command ids (reference: include/mxnet/kvstore.h:49)
CMD_SET_CONFIG = 0
CMD_STATE = 1
CMD_PAUSE = 2
CMD_DUMP = 3


def set_config(**kwargs) -> None:
    """Configure the profiler (reference: profiler.py set_config).

    Recognized keys: ``filename`` (chrome-trace output path),
    ``aggregate_stats`` (keep per-name duration totals). Unknown keys are
    stored but ignored, for reference-kwarg compatibility.
    """
    with _lock:
        _config.update(kwargs)


def set_state(state: str = "stop") -> None:
    """'run' starts recording; 'stop' stops (reference: SetState)."""
    global _state_running
    with _lock:
        _state_running = state == "run"


def pause() -> None:
    """Temporarily stop recording without losing state (kPause)."""
    global _paused
    with _lock:
        _paused = True


def resume() -> None:
    global _paused
    with _lock:
        _paused = False


def is_running() -> bool:
    return _state_running and not _paused


def _now_us() -> float:
    return (time.monotonic() - _t0) * 1e6


def now_us() -> float:
    """Current time on the profiler clock (µs since profiler epoch)."""
    return _now_us()


def record(name: str, cat: str, ts_us: float, dur_us: float,
           args: Optional[Dict[str, Any]] = None) -> None:
    """Record one complete ('X') trace event."""
    if not is_running():
        return
    ev = {
        "name": name, "cat": cat, "ph": "X",
        "ts": ts_us, "dur": dur_us,
        "pid": os.getpid(), "tid": threading.get_ident() % (1 << 31),
    }
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)
        if _config.get("aggregate_stats"):
            _counters[name] = _counters.get(name, 0.0) + dur_us


@contextmanager
def scope(name: str, cat: str = "geomx", **args):
    """Time a host-side region (the engine-op tag equivalent of the
    reference's PROFILER_MESSAGE_FUNCNAME, kvstore_dist_server.h:570).

    While a device trace is active (start_device_trace), the region
    ALSO emits a ``torch.profiler.record_function`` range — the analogue
    of the reference's VTune ITT domain/task bridge
    (src/profiler/vtune.cc): host protocol events appear aligned on the
    device trace's timeline next to the kernels they drive."""
    if not is_running():
        yield
        return
    start = _now_us()
    ann = None
    if _device_trace_dir is not None:
        import torch

        ann = torch.profiler.record_function(name)
        ann.__enter__()
    try:
        yield
    finally:
        if ann is not None:
            ann.__exit__(None, None, None)
        record(name, cat, start, _now_us() - start, args or None)


def chunk_scope(stage: str, chunk: int, **args):
    """Scope tag for one pipeline chunk stage — ``stage`` is one of
    fetch/send/recv/apply, ``chunk`` the chunk id — so traces show the
    pipelined round's shape (which chunk was on the wire while which
    was applying). Same exception-safe ``with`` discipline as the
    server's per-key tags; near-free when the profiler is stopped."""
    return scope(f"pipeline:{stage}:c{chunk}", cat="pipeline",
                 chunk=chunk, **args)


def instant(name: str, cat: str = "geomx", **args: Any) -> None:
    """Record an instant ('i') event — a point-in-time marker for things
    with no duration: snapshot writes, recovery restores, injected
    crashes. Process-scoped so it renders as a full-height line."""
    if not is_running():
        return
    ev = {"name": name, "cat": cat, "ph": "i", "s": "p", "ts": _now_us(),
          "pid": os.getpid(), "tid": threading.get_ident() % (1 << 31)}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def counter(name: str, value: float, cat: str = "geomx") -> None:
    """Record an instant counter sample (bytes sent, queue depths...)."""
    if not is_running():
        return
    ev = {"name": name, "cat": cat, "ph": "C", "ts": _now_us(),
          "pid": os.getpid(), "args": {name: value}}
    with _lock:
        _events.append(ev)


def dumps() -> str:
    """Serialize recorded events as chrome trace JSON."""
    with _lock:
        doc = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
    return json.dumps(doc)


def dump(finished: bool = True, filename: Optional[str] = None) -> str:
    """Write the trace file (reference: DumpProfile :304); returns path.

    The write is atomic (tmp + rename): tools/trace_merge.py and the
    chaos-matrix artifact collector read these files from other
    processes, and a dump interrupted by a crash must never leave a
    truncated JSON where a previous good trace stood."""
    path = filename or _config.get("filename", "profile.json")
    data = dumps()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)
    if finished:
        with _lock:
            _events.clear()
    return path


def aggregate_stats() -> Dict[str, float]:
    """Per-name total duration (us), when aggregate_stats was configured."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    global _state_running, _paused
    with _lock:
        _events.clear()
        _counters.clear()
        _state_running = False
        _paused = False
        _config.clear()
        _config["filename"] = "profile.json"


# ----------------------------------------------------------------------
# device-side (XLA) tracing bridge
# ----------------------------------------------------------------------


def start_device_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` trace of the host and the CUDA card
    alongside the host trace; :func:`stop_device_trace` writes it to
    ``logdir`` as chrome-trace JSON."""
    global _device_trace_dir, _device_prof
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _device_prof = torch.profiler.profile(activities=acts)
    _device_prof.__enter__()
    _device_trace_dir = logdir


def stop_device_trace() -> None:
    global _device_trace_dir, _device_prof
    if _device_trace_dir is None:
        return
    _device_prof.__exit__(None, None, None)
    os.makedirs(_device_trace_dir, exist_ok=True)
    _device_prof.export_chrome_trace(os.path.join(
        _device_trace_dir, f"device_trace.{os.getpid()}.json"))
    _device_trace_dir = _device_prof = None


# ----------------------------------------------------------------------
# remote command application (server side)
# ----------------------------------------------------------------------

def apply_remote_command(body: str, rank: int) -> None:
    """Apply a worker-issued profiler command on a server process
    (reference: ProcessServerProfilerCommands, kvstore_dist_server.h:383-
    430). Dump filenames are prefixed ``rank<N>_`` exactly as the
    reference does (:415) so per-server traces don't collide."""
    try:
        d = json.loads(body) if body else {}
    except ValueError:
        return
    cmd = d.get("cmd", -1)
    params = d.get("params", {})
    if cmd == CMD_SET_CONFIG:
        fn = params.get("filename")
        if fn:
            head, tail = os.path.split(fn)
            params["filename"] = os.path.join(head, f"rank{rank}_{tail}")
        set_config(**params)
    elif cmd == CMD_STATE:
        set_state(params.get("state", "stop"))
    elif cmd == CMD_PAUSE:
        if params.get("paused", True):
            pause()
        else:
            resume()
    elif cmd == CMD_DUMP:
        dump(finished=bool(params.get("finished", True)))
