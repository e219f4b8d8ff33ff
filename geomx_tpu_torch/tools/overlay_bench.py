#!/usr/bin/env python
"""TSEngine overlay vs direct N-to-1 incast on a shaped WAN topology.

The port's counterpart of the JAX package's ``tools/overlay_bench.py``.
It times full global FSA rounds (push + pull + wait, every byte over the
real transport) on an in-process N-party HiPS cluster whose global tier
is shaped by a ShapePlan (``ps/shaping.py``), twice: once over the
direct wire (every party server pushes its aggregate straight at the
global server, an N-to-1 incast through the server's shared access
pipe) and once with the inter-DC TSEngine overlay (party-to-party
reduction tree up, multicast tree down; only the final merged gradient
and the first model copy cross the shared pipe).

    python -m geomx_tpu_torch.tools.overlay_bench --parties 16 \\
        --shape geomx_tpu_torch/scripts/shapes/hetero16.json

The run checks that the two wires agree BIT-EXACTLY: gradients are
integer-valued, so float32 summation is exact in any merge order and
the direct and overlay results must be equal.

``--controller`` adds a third pass, the overlay with the self-tuning
transport controller on (per-link codec + slice decisions from live
health estimates, degraded-link schedule bias; health plane + resender
ride along). The controller may assign lossy codecs, so THAT pass is
checked for finiteness, not bit-exactness.

The workers' gradients are tensors on the CUDA card (``--cpu``: on the
CPU), as the port's trainers push them. Without a card and without
``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from geomx_tpu_torch._device import resolve_device
from geomx_tpu_torch.tools.chaos_sim import SHAPES

__all__ = ["run", "main"]


def run(parties: int, size: int, rounds: int, extra_cfg: dict,
        inter_ts: bool, controller: bool = False, device=None):
    """One pass; returns (per-round ms of the slowest party, final
    weights)."""
    from geomx_tpu_torch.optimizer import SGD
    from geomx_tpu_torch.simulate import InProcessHiPS

    dev = resolve_device(device)
    extra = dict(extra_cfg, enable_inter_ts=inter_ts)
    if controller:
        extra.update(transport_controller=True, health=True,
                     resend=True, resend_timeout_ms=3000,
                     resend_deadline_s=180.0)
    w0 = np.zeros(size, np.float32)
    topo = InProcessHiPS(num_parties=parties, workers_per_party=1,
                         extra_cfg=extra, device=dev).start()
    per_round = {}
    finals = []
    try:
        def master_init(kv):
            kv.set_optimizer(SGD(learning_rate=1.0))
            kv.init(0, w0.copy())
            kv.wait()

        def worker(kv):
            out = w0.copy()
            kv.init(0, w0.copy())
            kv.pull(0, out=out)
            kv.wait()
            ts = []
            for r in range(rounds):
                # integer-valued so any merge order is bit-exact
                grad = torch.full((size,), float(r + 1), device=dev)
                t0 = time.perf_counter()
                kv.push(0, grad)
                kv.pull(0, out=out)
                kv.wait()
                ts.append((time.perf_counter() - t0) * 1e3)
            per_round[id(kv)] = ts
            finals.append(out.copy())

        topo.run_workers(worker, include_master=master_init,
                         timeout=1200)
    finally:
        topo.stop()
    for f in finals[1:]:
        if not np.array_equal(finals[0], f):
            raise AssertionError("workers disagree on the final model")
    # the round completes when the SLOWEST party has its model back
    worst = [max(ts[r] for ts in per_round.values())
             for r in range(rounds)]
    return worst, finals[0]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.tools.overlay_bench")
    ap.add_argument("--parties", type=int, default=16)
    ap.add_argument("--size", type=int, default=262144,
                    help="elements per gradient (float32); default 1MB")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--shape", default=os.path.join(SHAPES, "hetero16.json"),
                    help="ShapePlan JSON path or inline JSON; '' = off")
    ap.add_argument("--shape-seed", type=int, default=-1)
    ap.add_argument("--controller", action="store_true",
                    help="add an overlay pass with the self-tuning "
                         "transport controller on (static-vs-adaptive "
                         "A/B; that pass skips the bit-exact bar: the "
                         "controller may assign lossy codecs)")
    ap.add_argument("--cpu", action="store_true",
                    help="the workers' gradients on the CPU (default: the "
                         "CUDA card, which must be there)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    extra = {}
    if args.shape:
        plan = args.shape.strip()
        extra["shape_plan"] = plan if plan.startswith(("{", "[", "@")) \
            else "@" + plan
    if args.shape_seed >= 0:
        extra["shape_seed"] = args.shape_seed

    print(f"# {args.parties} parties, {args.size * 4 // 1024} KB "
          f"gradient, {args.rounds} rounds, "
          f"shape={args.shape or 'off'}", flush=True)
    direct_ms, direct_w = run(args.parties, args.size, args.rounds,
                              extra, inter_ts=False, device=device)
    overlay_ms, overlay_w = run(args.parties, args.size, args.rounds,
                                extra, inter_ts=True, device=device)
    if not np.array_equal(direct_w, overlay_w):
        raise AssertionError("overlay result diverges from the direct wire")

    d, o = np.median(direct_ms), np.median(overlay_ms)
    print(f"direct incast : {d:8.1f} ms/round   "
          f"(rounds: {', '.join(f'{t:.0f}' for t in direct_ms)})")
    print(f"TS overlay    : {o:8.1f} ms/round   "
          f"(rounds: {', '.join(f'{t:.0f}' for t in overlay_ms)})")
    print(f"speedup       : {d / o:8.2f}x   (bit-exact: True)", flush=True)
    out = {"direct_ms": direct_ms, "overlay_ms": overlay_ms}

    if args.controller:
        ctrl_ms, ctrl_w = run(args.parties, args.size, args.rounds,
                              extra, inter_ts=True, controller=True,
                              device=device)
        if not np.all(np.isfinite(ctrl_w)):
            raise AssertionError(
                "adaptive overlay produced non-finite weights")
        c = np.median(ctrl_ms)
        print(f"TS + controller: {c:7.1f} ms/round   "
              f"(rounds: {', '.join(f'{t:.0f}' for t in ctrl_ms)})")
        print(f"speedup vs direct: {d / c:5.2f}x   "
              f"(lossy codecs allowed: finite-only bar)", flush=True)
        out["controller_ms"] = ctrl_ms
    return out


if __name__ == "__main__":
    main()
