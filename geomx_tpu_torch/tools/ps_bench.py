#!/usr/bin/env python
"""PS protocol benchmark: the HiPS stack's intrinsic round latency and
throughput, no accelerator in the loop.

The port's counterpart of the JAX package's ``tools/ps_bench.py``: full
two-tier rounds (2 parties x 1 worker -> party servers -> global server
-> pull-back) on the port's ``simulate.InProcessHiPS`` for numpy
payloads of several sizes. This isolates the framework's own speed from
the device, the complement of the framework-in-the-loop numbers. The
topology is given the CUDA card as its device, as every entry point of
the port is (``device="cpu"`` / ``--cpu`` on the CPU); the payloads stay
on the host.

Prints one JSON line per payload size:
  {"elems": N, "rounds_per_s": R, "round_ms": L, "mb_per_s": B}

    python -m geomx_tpu_torch.tools.ps_bench [--cpu]

Without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from geomx_tpu_torch._device import resolve_device

__all__ = ["SIZES", "SECONDS", "bench_size", "main"]

SIZES = [1_024, 65_536, 1_048_576]
SECONDS = 5.0


def bench_size(n_elems: int, seconds: float = SECONDS,
               device=None) -> dict:
    """Rounds of one payload size, counted over ``seconds`` once both
    workers are past their first rounds."""
    from geomx_tpu_torch.optimizer import SGD
    from geomx_tpu_torch.simulate import InProcessHiPS

    dev = resolve_device(device)
    topo = InProcessHiPS(num_parties=2, workers_per_party=1,
                         device=dev).start()
    try:
        topo.master.set_optimizer(SGD(learning_rate=0.01))
        time.sleep(0.3)
        w0 = np.zeros(n_elems, np.float32)
        rounds = [0, 0]
        stop_round = [None]
        errs: list = []

        def master(kv):
            kv.init(0, w0)
            kv.wait()

        def worker(kv):
            widx = 0 if kv is topo.workers[0] else 1
            kv.init(0, w0)
            kv.pull(0, out=np.zeros_like(w0))
            kv.wait()
            grad = np.ones(n_elems, np.float32)
            out = np.zeros(n_elems, np.float32)
            while stop_round[0] is None or rounds[widx] < stop_round[0]:
                kv.push(0, grad)
                kv.pull(0, out=out)
                kv.wait()
                rounds[widx] += 1

        def run():
            try:
                topo.run_workers(worker, include_master=master,
                                 timeout=600.0)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while sum(rounds) < 4 and time.monotonic() < deadline:
            if errs:
                raise errs[0]
            time.sleep(0.05)
        r0 = sum(rounds)
        t0 = time.perf_counter()
        time.sleep(seconds)
        made = sum(rounds) - r0
        dt = time.perf_counter() - t0
        if errs:
            raise errs[0]
        stop_round[0] = max(rounds) + 2
        t.join(60)
        if t.is_alive():
            raise TimeoutError("ps_bench: the workers did not stop")
        if errs:
            raise errs[0]
        # per-worker round rate (both workers advance in lockstep)
        rps = made / 2 / dt
        # bytes per ROUND per worker: push grad + pull params on the LAN
        # hop, plus the party->global->party WAN exchange (counted once
        # per party = per worker here)
        bytes_per_round = 4 * n_elems * 4
        return {
            "elems": n_elems,
            "rounds_per_s": round(rps, 1),
            "round_ms": round(1000.0 / rps, 3) if rps else None,
            "mb_per_s": round(rps * bytes_per_round / 1e6, 1),
        }
    finally:
        topo.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.tools.ps_bench")
    ap.add_argument("--cpu", action="store_true",
                    help="the topology on the CPU (default: the CUDA "
                         "card, which must be there)")
    args = ap.parse_args(argv)
    for n in SIZES:
        print(json.dumps(bench_size(n, device="cpu" if args.cpu else None)),
              flush=True)


if __name__ == "__main__":
    main()
