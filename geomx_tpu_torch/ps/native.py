"""ctypes bindings for the native (C++) transport core.

The native core (``geomx_tpu_torch/native/transport.cc``, a copy of the
JAX package's ``native/transport.cc`` whose receive also reports the
inbound connection each frame came on) is the C++ counterpart of the Python
van's socket layer — the role ZMQVan plays in the reference
(3rdparty/ps-lite/src/zmq_van.h:41-516). It owns the listener, per-
connection frame-parsing reader threads, the inbound frame queue, and the
per-destination connection cache; routing and message semantics stay in
Python (van.py). Both backends speak the identical wire format
(message.py), so native and pure-Python nodes interoperate in one job.

Selection: ``GEOMX_NATIVE_VAN=1`` (default when the library is buildable)
/ ``GEOMX_NATIVE_VAN=0`` forces pure Python. The shared library is built
on demand with g++ the first time it is needed, into the package's
``_build/`` directory.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

log = logging.getLogger("geomx.native")

# the source ships inside the package; the library is built beside the
# CUDA kernels in the package's gitignored _build/ directory
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(_PKG_DIR, "native", "transport.cc")
_LIB_PATH = os.path.join(_PKG_DIR, "_build", "libgeomx_transport.so")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _build_library() -> None:
    # build to a process-unique temp path, then atomically rename: several
    # processes (scheduler/servers/workers on one host) may race through a
    # fresh checkout's first build, and interleaved writes to one output
    # path would leave a permanently corrupt .so
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread",
           "-shared", "-o", tmp, _SRC_PATH]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native transport library.

    Returns None — with the reason cached — when the library cannot be
    built/loaded; callers fall back to the pure-Python backend.
    """
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH) or (
                    os.path.exists(_SRC_PATH)
                    and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH)):
                _build_library()
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.SubprocessError) as e:
            _lib_error = str(e)
            log.warning("native transport unavailable (%s); "
                        "using pure-Python van", e)
            return None
        lib.gx_create.restype = ctypes.c_void_p
        lib.gx_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.gx_port.restype = ctypes.c_int
        lib.gx_port.argtypes = [ctypes.c_void_p]
        lib.gx_set_route.restype = None
        lib.gx_set_route.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int]
        lib.gx_send.restype = ctypes.c_int64
        lib.gx_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_uint64]
        lib.gx_send_addr.restype = ctypes.c_int64
        lib.gx_send_addr.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_uint64]
        lib.gx_recv.restype = ctypes.c_int64
        lib.gx_recv.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.c_double]
        lib.gx_free.restype = None
        lib.gx_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.gx_send_bytes.restype = ctypes.c_uint64
        lib.gx_send_bytes.argtypes = [ctypes.c_void_p]
        lib.gx_recv_bytes.restype = ctypes.c_uint64
        lib.gx_recv_bytes.argtypes = [ctypes.c_void_p]
        lib.gx_stop.restype = None
        lib.gx_stop.argtypes = [ctypes.c_void_p]
        lib.gx_destroy.restype = None
        lib.gx_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def enabled() -> bool:
    """Native backend selection: on by default when buildable."""
    flag = os.environ.get("GEOMX_NATIVE_VAN", "1")
    return flag not in ("0", "false", "no") and available()


class NativeTransport:
    """One bound endpoint of the native core.

    API mirrors exactly what van.py needs: bind-at-construction,
    set_route/send per node id, one-shot send_to_addr, blocking recv of
    complete frames, byte counters, stop.
    """

    def __init__(self, bind_host: str, port: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native transport unavailable: {_lib_error}")
        self._lib = lib
        self._h = lib.gx_create(bind_host.encode(), port)
        if not self._h:
            raise OSError(f"native bind failed on {bind_host}:{port}")
        self.port: int = lib.gx_port(self._h)
        self._stopped = False

    def set_route(self, node_id: int, host: str, port: int) -> None:
        self._lib.gx_set_route(self._h, node_id, host.encode(), port)

    def send(self, node_id: int, frame: bytes) -> int:
        n = self._lib.gx_send(self._h, node_id, frame, len(frame))
        if n == -2:
            raise OSError(f"no route to node {node_id}")
        if n < 0:
            raise OSError(f"native send to node {node_id} failed")
        return int(n)

    def send_to_addr(self, host: str, port: int, frame: bytes) -> None:
        n = self._lib.gx_send_addr(self._h, host.encode(), port,
                                   frame, len(frame))
        if n < 0:
            raise OSError(f"native send to {host}:{port} failed")

    def recv(self, timeout_s: float = 1.0) -> Optional[Tuple[bytes, int]]:
        """One complete frame and the serial number of the inbound
        connection it came on, or None on timeout; raises on shutdown."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        conn = ctypes.c_uint64()
        n = self._lib.gx_recv(self._h, ctypes.byref(out), ctypes.byref(conn),
                              timeout_s)
        if n == -1:
            return None
        if n == -3:
            # transient allocation failure; the frame stays queued
            raise MemoryError("native recv allocation failed")
        if n < 0:
            raise ConnectionAbortedError("native transport stopped")
        try:
            return ctypes.string_at(out, n), conn.value
        finally:
            self._lib.gx_free(out)

    @property
    def send_bytes(self) -> int:
        return int(self._lib.gx_send_bytes(self._h))

    @property
    def recv_bytes(self) -> int:
        return int(self._lib.gx_recv_bytes(self._h))

    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._lib.gx_stop(self._h)

    def close(self) -> None:
        self.stop()
        if self._h:
            self._lib.gx_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
