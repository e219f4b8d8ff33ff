"""Checkpoint / resume in a framework-neutral format.

Counterpart of ``geomx_tpu/checkpoint.py`` with the same surface
(``save_checkpoint`` / ``load_checkpoint`` / ``latest_checkpoint``, the
``serialize_states`` / ``serialize_blob`` codecs of server state
snapshots and the ``save_optimizer_states`` / ``load_optimizer_states``
dump), written atomically (tmp + rename) so
a crash mid-write can't corrupt the latest checkpoint. Naming follows the
reference: ``{prefix}-{epoch:04d}.ckpt``.

The JAX package serializes with flax's msgpack codec; the port has no
flax (nor msgpack), so a tree is stored as one JSON header plus the raw
bytes of its arrays:

    b"GXCK1\\n" | u64 header length | JSON header | array bytes ...

The header mirrors the tree: dicts (string or int keys), lists, tuples,
JSON scalars, ``bytes`` and numpy arrays (dtype, shape and byte range).
Torch tensors are stored as numpy arrays. The two packages' files are
therefore NOT interchangeable: a state blob written by one package's
server cannot be read by the other's (ROADMAP queue C).
"""

from __future__ import annotations

import glob
import json
import os
import re
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "serialize_states", "deserialize_states",
    "serialize_blob", "deserialize_blob",
    "save_optimizer_states", "load_optimizer_states",
]

_MAGIC = b"GXCK1\n"


def _ckpt_path(prefix: str, epoch: int) -> str:
    return f"{prefix}-{epoch:04d}.ckpt"


def _atomic_write(path: str, data: bytes) -> None:
    # per process and thread: two workers of one process (InProcessHiPS)
    # may write the same checkpoint at once
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# -- tree codec ---------------------------------------------------------

def _enc(x: Any, bufs: List[bytes], pos: List[int]) -> Any:
    if hasattr(x, "detach") and hasattr(x, "cpu"):        # torch tensor
        x = x.detach().cpu().numpy()
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)              # keeps 0-d arrays 0-d
        if not a.flags.c_contiguous:
            a = a.copy(order="C")
        raw = a.tobytes()
        bufs.append(raw)
        pos[0] += len(raw)
        return {"a": [a.dtype.str, list(a.shape), pos[0] - len(raw),
                      len(raw)]}
    if isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        bufs.append(raw)
        pos[0] += len(raw)
        return {"b": [pos[0] - len(raw), len(raw)]}
    if isinstance(x, dict):
        return {"d": [[["i", k] if isinstance(k, int) else ["s", str(k)],
                       _enc(v, bufs, pos)] for k, v in x.items()]}
    if isinstance(x, (list, tuple)):
        return {"l" if isinstance(x, list) else "t":
                [_enc(v, bufs, pos) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"v": x}
    raise TypeError(f"cannot checkpoint a value of type {type(x).__name__}")


def _dec(h: Any, body: memoryview) -> Any:
    (tag, v), = h.items()
    if tag == "a":
        dt, shape, off, n = v
        # a copy, not a view: optimizer states are updated in place
        return np.frombuffer(body[off:off + n], dtype=np.dtype(dt)
                             ).reshape(shape).copy()
    if tag == "b":
        off, n = v
        return bytes(body[off:off + n])
    if tag == "d":
        return {(int(k) if kt == "i" else k): _dec(val, body)
                for (kt, k), val in v}
    if tag == "l":
        return [_dec(e, body) for e in v]
    if tag == "t":
        return tuple(_dec(e, body) for e in v)
    return v


def _dumps(tree: Any) -> bytes:
    bufs: List[bytes] = []
    header = json.dumps(_enc(tree, bufs, [0])).encode()
    return b"".join([_MAGIC, struct.pack("<Q", len(header)), header]
                    + bufs)


def _loads(data: bytes) -> Any:
    if not data.startswith(_MAGIC):
        raise ValueError("not a geomx_tpu_torch checkpoint (bad magic)")
    p = len(_MAGIC)
    (hlen,) = struct.unpack_from("<Q", data, p)
    p += 8
    header = json.loads(bytes(data[p:p + hlen]))
    return _dec(header, memoryview(data)[p + hlen:])


# -- checkpoints --------------------------------------------------------

def save_checkpoint(prefix: str, epoch: int, params: Any,
                    optimizer_states: Any = None,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Persist a training snapshot; returns the written path.

    ``params`` is any tree of arrays (a list of leaves, a state dict,
    ...). ``optimizer_states`` is whatever the optimizer's
    ``get_states()`` returned. ``metadata`` is a small JSON-like dict."""
    payload = {
        "params": params,
        "optimizer_states": optimizer_states,
        "metadata": metadata or {},
        "epoch": epoch,
    }
    path = _ckpt_path(prefix, epoch)
    _atomic_write(path, _dumps(payload))
    return path


def load_checkpoint(prefix: str, epoch: int) -> Tuple[Any, Any, Dict]:
    """Load ``(params, optimizer_states, metadata)`` for an epoch."""
    with open(_ckpt_path(prefix, epoch), "rb") as f:
        payload = _loads(f.read())
    return (payload["params"], payload.get("optimizer_states"),
            payload.get("metadata", {}))


def latest_checkpoint(prefix: str) -> Optional[int]:
    """Highest epoch with a checkpoint under ``prefix``, or None."""
    # {4,}: ``{epoch:04d}`` zero-pads to at least 4 digits but epochs
    # >= 10000 render wider
    pat = re.compile(re.escape(os.path.basename(prefix)) + r"-(\d{4,})\.ckpt$")
    best = None
    for p in glob.glob(f"{prefix}-*.ckpt"):
        m = pat.search(os.path.basename(p))
        if m:
            e = int(m.group(1))
            best = e if best is None else max(best, e)
    return best


# -- server state snapshots -----------------------------------------------

def serialize_states(states: Dict) -> bytes:
    """Key->state dict to bytes. Keys are ints or (key, offset) shard
    tuples; both survive the round trip."""
    return _dumps([[tuple(int(x) for x in k) if isinstance(k, tuple)
                    else int(k), v] for k, v in states.items()])


def deserialize_states(data: bytes) -> Dict:
    return {k: v for k, v in _loads(data)}


def serialize_blob(doc: Dict) -> bytes:
    """A small str-keyed document (which may nest bytes produced by
    :func:`serialize_states`) to bytes — the container format of server
    state snapshots (kvstore/replication.py)."""
    return _dumps(doc)


def deserialize_blob(data: bytes) -> Dict:
    return _loads(data)


def save_optimizer_states(fname: str, optimizer) -> None:
    """Dump an optimizer's states to file (reference: kvstore.py:566),
    keyed by kv key (int) or (key, offset) shard."""
    _atomic_write(fname, serialize_states(optimizer.get_states()))


def load_optimizer_states(fname: str, optimizer) -> None:
    """Restore an optimizer's states from file (reference: kvstore.py:582)."""
    with open(fname, "rb") as f:
        optimizer.set_states(deserialize_states(f.read()))
