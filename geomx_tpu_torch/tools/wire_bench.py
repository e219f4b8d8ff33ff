#!/usr/bin/env python
"""Protocol-only round time: batched list wire vs per-key messages.

The port's counterpart of the JAX package's ``tools/wire_bench.py``:
the same layouts, modes, flags and output rows. It times full two-tier
FSA rounds (push + pull + wait, every byte over the real transport) with
compute excluded, on an in-process 2-party topology
(``geomx_tpu_torch.simulate.InProcessHiPS``). The batched wire sends ONE
message per server per direction (``kvstore.server._BatchResponder``
merges the per-key acks); per-key sends 2 * n_keys messages.

The workers' dense gradients are tensors on the CUDA card (``--cpu``: on
the CPU), as the port's trainers push them: the round includes their
copy to the host, and under a quantized wire codec the worker's encode
runs on the card (the 2-bit CUDA kernel) before that copy. The sparse
mode's selections are host arrays, which is what the element-sparse wire
takes. Without a card and without ``--cpu`` it raises.

    python -m geomx_tpu_torch.tools.wire_bench --layout cnn          # 10 keys, 178k
    python -m geomx_tpu_torch.tools.wire_bench --layout transformer  # 75 keys, mixed

``--shape geomx_tpu_torch/scripts/shapes/wan2_50ms_100mbps.json``
replays any mode on an emulated WAN (``ps/shaping.py``): per-link RTT +
token-bucket bandwidth on every global-tier data frame:

    python -m geomx_tpu_torch.tools.wire_bench --overlap \\
        --shape geomx_tpu_torch/scripts/shapes/wan2_50ms_100mbps.json \\
        --trace-out /tmp/shaped_round.json

``--trace-out`` dumps the in-process chrome trace (all nodes, one file,
``geomx_tpu_torch.profiler``); ``python -m tools.trace_merge`` merges it
into the Perfetto artifact showing chunks in flight across rounds.

``--loss-bench`` is the self-tuning-transport A/B: an N-party quadratic
fit (every worker pushes ``grad = w - t`` and the server runs SGD, so
``f(w) = 0.5 * ||w - t||^2`` contracts by a known factor per exact
round) timed to a relative loss target on a shaped WAN, once per static
codec policy (raw / fp16 / 2bit / mpq as ``extra_cfg["wire_codec_wan"]``)
and once with the transport controller choosing per link
(``--policy adaptive``):

    python -m geomx_tpu_torch.tools.wire_bench --loss-bench \\
        --shape geomx_tpu_torch/scripts/shapes/hetero16.json --parties 16

``--controller`` runs any of the OTHER modes with the controller on
(health plane + resender come along) for a static-vs-adaptive capture
of the protocol-only benches.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from geomx_tpu_torch._device import resolve_device

__all__ = ["LAYOUTS", "CONTROLLER_CFG", "LOSS_POLICIES", "layout_shapes",
           "run", "run_sparse", "run_overlap", "run_loss", "main"]

LAYOUTS = {
    "cnn": [(800,), (32,), (25600,), (64,), (51200,), (128,), (65536,),
            (10,), (1176,), (84,)],
    "transformer": None,   # 75 keys, mixed sizes (seeded below)
}


def layout_shapes(layout: str):
    """The key shapes of ``layout``: "transformer" draws 75 sizes from
    {64, 512, 2048, 8192} with ``RandomState(0)``."""
    shapes = LAYOUTS[layout]
    if shapes is None:
        rng = np.random.RandomState(0)
        shapes = [(int(s),) for s in rng.choice([64, 512, 2048, 8192], 75)]
    return shapes


def run(shapes, batched: bool, rounds: int, extra_cfg=None,
        device=None) -> float:
    """ms per round (the slowest worker's) of the per-key or the batched
    dense wire."""
    from geomx_tpu_torch.optimizer import SGD
    from geomx_tpu_torch.simulate import InProcessHiPS

    dev = resolve_device(device)
    keys = list(range(len(shapes)))
    topo = InProcessHiPS(num_parties=2, workers_per_party=1,
                         extra_cfg=extra_cfg, device=dev).start()
    times = {}
    try:
        def master_init(kv):
            kv.set_optimizer(SGD(learning_rate=0.01))
            for k, sh in zip(keys, shapes):
                kv.init(k, np.zeros(sh, np.float32))
            kv.wait()

        def worker(kv):
            outs = [np.zeros(sh, np.float32) for sh in shapes]
            grads = [torch.ones(sh, device=dev) for sh in shapes]
            for k, o in zip(keys, outs):
                kv.init(k, o.copy())
                kv.pull(k, out=o)
            kv.wait()
            t0 = time.perf_counter()
            for _ in range(rounds):
                if batched:
                    kv.push_pull(keys, grads, out=outs)
                else:
                    for k, g, o in zip(keys, grads, outs):
                        kv.push(k, g)
                        kv.pull(k, out=o)
                kv.wait()
            times[id(kv)] = (time.perf_counter() - t0) / rounds * 1e3

        topo.run_workers(worker, include_master=master_init, timeout=600)
    finally:
        topo.stop()
    return max(times.values())


def run_sparse(shapes, threshold: float, rounds: int,
               extra_cfg=None, device=None) -> float:
    """Protocol-only round time of the headline sparse path: the
    combined element-sparse BSC wire (``push_pull_bsc_batch``, what the
    device-resident trainer sends per round), aggregator-mode PS, top-k
    payloads of ``size * threshold`` per key."""
    from geomx_tpu_torch.simulate import InProcessHiPS

    dev = resolve_device(device)
    keys = list(range(len(shapes)))
    topo = InProcessHiPS(num_parties=2, workers_per_party=1,
                         extra_cfg=extra_cfg, device=dev).start()
    times = {}
    try:
        def master_init(kv):
            for k, sh in zip(keys, shapes):
                kv.init(k, np.zeros(sh, np.float32))
            kv.wait()

        def worker(kv):
            rng = np.random.RandomState(3)
            sel = []
            for sh in shapes:
                n = int(np.prod(sh))
                k = max(int(n * threshold), 1)
                idx = np.sort(rng.choice(n, size=k, replace=False))
                sel.append((rng.rand(k).astype(np.float32), idx))
            for k, sh in zip(keys, shapes):
                kv.init(k, np.zeros(sh, np.float32))
            kv.wait()
            t0 = time.perf_counter()
            for _ in range(rounds):
                join = kv.push_pull_bsc_batch(
                    keys, [v for v, _ in sel], [i for _, i in sel])
                agg = join()
                if len(agg) != len(keys):
                    raise RuntimeError(f"sparse round returned {len(agg)} "
                                       f"of {len(keys)} keys")
            times[id(kv)] = (time.perf_counter() - t0) / rounds * 1e3

        topo.run_workers(worker, include_master=master_init, timeout=600)
    finally:
        topo.stop()
    return max(times.values())


def run_overlap(shapes, rounds: int, slice_bytes: int,
                extra_cfg=None, trace_out: str = "", device=None):
    """Serial vs pipelined combined round: the same dense payloads, once
    through the blocking wire (``push_pull`` + ``wait``) and once through
    the async chunked wire (``push_pull_async`` at ``slice_bytes``-budget
    P3 chunks, joined per round). Per-key host work between dispatch and
    join is what the pipeline hides; on a shaped link so is the link
    latency itself: chunk k+1 serializes while chunk k is in flight.
    Returns (serial ms, pipelined ms, chunks per round)."""
    from geomx_tpu_torch import profiler
    from geomx_tpu_torch.kvstore.frontier import plan_chunks
    from geomx_tpu_torch.optimizer import SGD
    from geomx_tpu_torch.simulate import InProcessHiPS

    dev = resolve_device(device)
    keys = list(range(len(shapes)))
    cfg = dict(extra_cfg or {})
    cfg["p3_slice_bytes"] = slice_bytes
    topo = InProcessHiPS(num_parties=2, workers_per_party=1,
                         extra_cfg=cfg, device=dev).start()
    if trace_out:
        profiler.set_config(filename=trace_out)
        profiler.set_state("run")
    times = {}
    nchunks = [0]
    try:
        def master_init(kv):
            kv.set_optimizer(SGD(learning_rate=0.01))
            for k, sh in zip(keys, shapes):
                kv.init(k, np.zeros(sh, np.float32))
            kv.wait()

        def worker(kv):
            outs = [np.zeros(sh, np.float32) for sh in shapes]
            grads = [torch.ones(sh, device=dev) for sh in shapes]
            for k, o in zip(keys, outs):
                kv.init(k, o.copy())
                kv.pull(k, out=o)
            kv.wait()
            entries = []
            for k in keys:
                info = kv._key_info[k]
                entries.extend((sh.length * 4,) for sh in info.shards)
            nchunks[0] = len(plan_chunks(
                list(range(len(entries))), [e[0] for e in entries],
                slice_bytes))
            t0 = time.perf_counter()
            for _ in range(rounds):
                kv.push_pull(keys, grads, out=outs)
                kv.wait()
            serial = (time.perf_counter() - t0) / rounds * 1e3
            t0 = time.perf_counter()
            for _ in range(rounds):
                fut = kv.push_pull_async(keys, grads, outs,
                                         slice_bytes=slice_bytes)
                fut.wait()
            piped = (time.perf_counter() - t0) / rounds * 1e3
            times[id(kv)] = (serial, piped)

        topo.run_workers(worker, include_master=master_init, timeout=600)
    finally:
        topo.stop()
        if trace_out:
            profiler.set_state("stop")
            profiler.dump(filename=trace_out)
    serial = max(t[0] for t in times.values())
    piped = max(t[1] for t in times.values())
    return serial, piped, nchunks[0]


# the controller rides the health plane, which rides the resender
# (spans come from send->ack); identical base config in every loss-bench
# pass so the ONLY variable is the codec decision mechanism
CONTROLLER_CFG = dict(
    resend=True, resend_timeout_ms=3000, resend_deadline_s=180.0,
    health=True,
)

LOSS_POLICIES = ("raw", "fp16", "2bit", "mpq", "adaptive")


def run_loss(parties: int, size: int, policy: str, target_frac: float,
             max_rounds: int, extra_cfg=None, prime: int = 2, device=None):
    """Time-to-loss-target for one codec policy. Every worker pushes
    ``grad = w - t`` (identical across workers: same target, same pulled
    model), the server applies SGD at ``lr = 0.5 / parties``, so an
    exact round halves the error and lossy codecs show up as extra
    rounds. Workers break on the same round (the loss is computed from
    the shared pulled model), so the FSA barrier never half-empties.

    Returns ``(rounds_to_target | None, wall_s | None, loss_trace)``
    where the wall time is the SLOWEST worker's."""
    from geomx_tpu_torch.optimizer import SGD
    from geomx_tpu_torch.simulate import InProcessHiPS

    dev = resolve_device(device)
    cfg = dict(extra_cfg or {})
    cfg.update(CONTROLLER_CFG)
    if policy == "adaptive":
        cfg["transport_controller"] = True
    elif policy != "raw":
        cfg["wire_codec_wan"] = policy
    topo = InProcessHiPS(num_parties=parties, workers_per_party=1,
                         extra_cfg=cfg, device=dev).start()
    res = {}
    try:
        rng = np.random.RandomState(11)
        t_vec = rng.standard_normal(size).astype(np.float32)
        t_dev = torch.from_numpy(t_vec).to(dev)
        lr = 0.5 / parties

        def master_init(kv):
            kv.set_optimizer(SGD(learning_rate=lr))
            kv.init(0, np.zeros(size, np.float32))
            kv.wait()

        def worker(kv):
            out = np.zeros(size, np.float32)
            kv.init(0, np.zeros(size, np.float32))
            kv.pull(0, out=out)
            kv.wait()
            # untimed warmup, identical for every policy: zero gradients
            # leave the model untouched (SGD no-op; 2bit codes zeros
            # exactly, residuals stay zero) but put full-size frames on
            # the wire: steady-state comparison, connection setup and
            # the controller's link classification both happen here
            zero = torch.zeros(size, device=dev)
            for _ in range(prime):
                fut = kv.push_pull_async(0, zero, out)
                fut.wait()
            loss0 = 0.5 * float(np.sum((out - t_vec) ** 2))
            target = loss0 * target_frac
            trace = []
            hit = None
            t0 = time.perf_counter()
            for r in range(max_rounds):
                grad = torch.from_numpy(out).to(dev) - t_dev
                fut = kv.push_pull_async(0, grad, out)
                fut.wait()
                loss = 0.5 * float(np.sum((out - t_vec) ** 2))
                trace.append(loss / loss0)
                if loss <= target:
                    hit = (r + 1, time.perf_counter() - t0)
                    break
            res[id(kv)] = (hit, trace)

        topo.run_workers(worker, include_master=master_init,
                         timeout=1800)
    finally:
        topo.stop()
    hits = [h for h, _ in res.values()]
    trace = max((t for _, t in res.values()), key=len, default=[])
    if any(h is None for h in hits) or not hits:
        return None, None, trace
    return max(h[0] for h in hits), max(h[1] for h in hits), trace


def loss_bench(parties, size, target, max_rounds, extra_cfg=None, prime=2,
               policies=LOSS_POLICIES, device=None):
    """``--loss-bench``: one :func:`run_loss` per policy; prints a line
    per policy and returns ``{policy: row}``."""
    extra_cfg = dict(extra_cfg or {})
    # mpq's size rule must engage at this model size, or "mpq"
    # degenerates to fp16 and the A/B loses a policy
    extra_cfg.setdefault("size_lower_bound", min(200000, max(1, size // 2)))
    rows = {}
    for pol in policies:
        rounds, wall, trace = run_loss(
            parties, size, pol, target, max_rounds, extra_cfg=extra_cfg,
            prime=prime, device=device)
        rows[pol] = {
            "rounds_to_target": rounds,
            "time_to_target_s": None if wall is None else round(wall, 2),
            "final_rel_loss": round(trace[-1], 6) if trace else None,
        }
        print(json.dumps({"policy": pol, **rows[pol]}), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.tools.wire_bench")
    ap.add_argument("--layout", choices=sorted(LAYOUTS), default="cnn")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--sparse", action="store_true",
                    help="measure the combined element-sparse BSC wire "
                         "(the device-resident trainer's round) instead "
                         "of the dense push/pull wire")
    ap.add_argument("--threshold", type=float, default=0.01,
                    help="--sparse: top-k fraction per key")
    ap.add_argument("--overlap", action="store_true",
                    help="measure serial vs pipelined combined round "
                         "(push_pull vs async chunked push_pull_async)")
    ap.add_argument("--slice-bytes", type=int, default=131072,
                    help="--overlap: P3 chunk budget in bytes")
    ap.add_argument("--shape", default="",
                    help="shape-plan JSON path (GEOMX_SHAPE_PLAN): "
                         "replay the capture on an emulated WAN; "
                         "canonical plans under "
                         "geomx_tpu_torch/scripts/shapes/")
    ap.add_argument("--shape-seed", type=int, default=-1,
                    help="--shape: jitter-stream seed "
                         "(GEOMX_SHAPE_SEED; plan-embedded seed wins)")
    ap.add_argument("--trace-out", default="",
                    help="--overlap: dump the in-process chrome trace "
                         "here (merge with tools/trace_merge.py)")
    ap.add_argument("--controller", action="store_true",
                    help="run with the self-tuning transport controller "
                         "on (health plane + resender ride along) for a "
                         "static-vs-adaptive A/B of any mode")
    ap.add_argument("--loss-bench", action="store_true",
                    help="time-to-loss-target A/B across codec policies "
                         "(raw/fp16/2bit/mpq/adaptive) on the shaped WAN")
    ap.add_argument("--parties", type=int, default=16,
                    help="--loss-bench: party count (default 16)")
    ap.add_argument("--size", type=int, default=65536,
                    help="--loss-bench: model elements (default 256KB)")
    ap.add_argument("--target", type=float, default=3e-2,
                    help="--loss-bench: relative loss target")
    ap.add_argument("--max-rounds", type=int, default=40,
                    help="--loss-bench: round cap; a policy that never "
                         "reaches the target reports null")
    ap.add_argument("--policy", default="",
                    choices=("",) + LOSS_POLICIES,
                    help="--loss-bench: run one policy only")
    ap.add_argument("--prime", type=int, default=2,
                    help="--loss-bench: untimed zero-gradient warmup "
                         "rounds before the clock starts, same for "
                         "every policy (steady-state comparison; 0 = "
                         "include cold start)")
    ap.add_argument("--cpu", action="store_true",
                    help="the workers' gradients on the CPU (default: the "
                         "CUDA card, which must be there)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    extra_cfg = {}
    shape_tag = ""
    if args.shape:
        extra_cfg = {"shape_plan": "@" + args.shape,
                     "shape_seed": args.shape_seed}
        shape_tag = os.path.splitext(os.path.basename(args.shape))[0]
    if args.controller:
        extra_cfg.update(CONTROLLER_CFG, transport_controller=True)

    if args.loss_bench:
        if args.controller:
            ap.error("--loss-bench runs its own adaptive policy; "
                     "drop --controller")
        rows = loss_bench(
            args.parties, args.size, args.target, args.max_rounds,
            extra_cfg=extra_cfg, prime=args.prime,
            policies=[args.policy] if args.policy else LOSS_POLICIES,
            device=device)
        out = {"loss_bench": True, "shape": shape_tag,
               "parties": args.parties, "size": args.size,
               "target_rel": args.target, "max_rounds": args.max_rounds,
               "prime": args.prime, "policies": rows}
        print(json.dumps(out))
        return out

    shapes = layout_shapes(args.layout)
    if args.overlap:
        serial, piped, nchunks = run_overlap(
            shapes, args.rounds, args.slice_bytes,
            extra_cfg=extra_cfg, trace_out=args.trace_out, device=device)
        out = {"layout": args.layout, "keys": len(shapes), "overlap": True,
               "shape": shape_tag,
               "slice_bytes": args.slice_bytes, "chunks": nchunks,
               "serial_ms_per_round": round(serial, 2),
               "pipelined_ms_per_round": round(piped, 2),
               "speedup": round(serial / piped, 2)}
    elif args.sparse:
        ms = run_sparse(shapes, args.threshold, args.rounds,
                        extra_cfg=extra_cfg, device=device)
        out = {"layout": args.layout, "keys": len(shapes), "sparse": True,
               "shape": shape_tag, "threshold": args.threshold,
               "bsc_push_pull_ms_per_round": round(ms, 2)}
    else:
        per_key = run(shapes, batched=False, rounds=args.rounds,
                      extra_cfg=extra_cfg, device=device)
        batched = run(shapes, batched=True, rounds=args.rounds,
                      extra_cfg=extra_cfg, device=device)
        out = {"layout": args.layout, "keys": len(shapes),
               "shape": shape_tag,
               "per_key_ms_per_round": round(per_key, 2),
               "batched_ms_per_round": round(batched, 2),
               "speedup": round(per_key / batched, 2)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
