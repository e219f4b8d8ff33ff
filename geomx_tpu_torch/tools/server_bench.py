#!/usr/bin/env python
"""Microbench: server state-machine throughput under multi-key load.

The port's counterpart of the JAX package's ``tools/server_bench.py``:
it drives ``KVStoreDistServer._handle`` directly (no sockets) from N
handler threads hammering disjoint keys, the way concurrent transport
readers do in production. With the per-(key, offset) locking this
scales with threads; a single global lock would flatten it.

The server's work is host work on numpy arrays, as in production, where
requests arrive from the wire; the card holds nothing here. The device
is resolved as every entry point of the port resolves it (the CUDA card,
which must be there, unless ``--cpu`` / ``device="cpu"``), so a run
without a card says so.

Prints one JSON line per thread count.

    python -m geomx_tpu_torch.tools.server_bench [--cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from geomx_tpu_torch.config import Config
from geomx_tpu_torch.kvstore.base import DATA_INIT
from geomx_tpu_torch.kvstore.server import KVStoreDistServer
from geomx_tpu_torch.optimizer import SGD
from geomx_tpu_torch.ps.kv_app import KVPairs, ReqMeta
from geomx_tpu_torch._device import resolve_device

__all__ = ["N_ELEMS", "DURATION", "make_server", "push_req", "drive",
           "sweep", "main"]

N_ELEMS = 262_144          # 1 MiB fp32 per key
DURATION = 3.0


class _FakeSrv:
    def response(self, req, kvs=None, body=""):
        pass


def make_server(num_workers: int) -> KVStoreDistServer:
    srv = KVStoreDistServer(Config(role="server", num_workers=num_workers,
                                   num_servers=1))
    srv._ready.set()              # skip transport startup
    srv.updater = SGD(learning_rate=0.01)
    return srv


def push_req(push=True, head=0):
    return ReqMeta(sender=9, timestamp=0, customer_id=0, push=push,
                   pull=not push, simple_app=False, head=head, body="",
                   priority=0, version=0, iters=0, compr="", num_merge=1)


def drive(n_threads: int, keys_per_thread: int,
          duration: float = DURATION, device=None) -> float:
    """Pushes per second over ``duration`` from ``n_threads`` threads,
    each on its own ``keys_per_thread`` keys."""
    resolve_device(device)
    server = make_server(num_workers=1)
    fake = _FakeSrv()
    grad = np.random.default_rng(0).normal(
        size=N_ELEMS).astype(np.float32)

    # init every key
    for t in range(n_threads):
        for k in range(keys_per_thread):
            key = t * keys_per_thread + k
            kvs = KVPairs(keys=[key], vals=[grad], offsets=[0],
                          totals=[N_ELEMS], lens=[N_ELEMS])
            server._handle(push_req(head=DATA_INIT), kvs, fake,
                           global_tier=False)

    counts = [0] * n_threads
    stop = threading.Event()

    def worker(tidx):
        kvss = []
        for k in range(keys_per_thread):
            key = tidx * keys_per_thread + k
            kvss.append(KVPairs(keys=[key], vals=[grad], offsets=[0],
                                totals=[N_ELEMS], lens=[N_ELEMS]))
        i = 0
        while not stop.is_set():
            server._handle(push_req(), kvss[i % keys_per_thread], fake,
                           global_tier=False)
            counts[tidx] += 1
            i += 1

    ts = [threading.Thread(target=worker, args=(t,), daemon=True)
          for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    time.sleep(duration)
    stop.set()
    for t in ts:
        t.join(10)
    dt = time.perf_counter() - t0
    if any(t.is_alive() for t in ts):
        raise TimeoutError("server_bench: a handler thread did not stop")
    return sum(counts) / dt


def sweep(duration: float = DURATION, device=None):
    """The JAX tool's table: 1, 2, 4 and 8 threads of 2 keys each, every
    rate against one thread on one key; prints and returns the rows."""
    rows = []
    base = drive(1, 1, duration, device)
    for n_threads in (1, 2, 4, 8):
        rate = drive(n_threads, 2, duration, device)
        rows.append({
            "threads": n_threads,
            "keys": n_threads * 2,
            "elems_per_key": N_ELEMS,
            "rounds_per_s": round(rate, 1),
            "scaling_vs_1thread": round(rate / base, 2),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.tools.server_bench")
    ap.add_argument("--cpu", action="store_true",
                    help="run without the CUDA card (default: the card, "
                         "which must be there)")
    args = ap.parse_args(argv)
    return sweep(device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
