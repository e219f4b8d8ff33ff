#!/usr/bin/env python
"""Shaped N-party chaos case: WAN shaping + faults + wire sanitizer.

The port's counterpart of the JAX package's ``tools/chaos_sim.py`` (the
reference: the same plans, seeds, shapes and bars). The multi-process
chaos matrix (``geomx_tpu_torch/scripts/run_chaos_matrix.sh``) tops out
at 3 parties / 12 processes; this tool scales the same bar to 16-64
in-process parties on a shaped heterogeneous topology
(``geomx_tpu_torch/scripts/shapes/hetero16.json`` by default) with the
full chaos stack composed on top of the link emulation:

- **stragglers**: seeded delay faults on the thin transoceanic
  parties' global links, on top of their shaped 150 ms / 20 Mbps pipes;
- **one flapping node**: a party server partitioned from the global
  tier in repeated windows; the resender must heal each flap, not
  declare anything dead (heartbeats stay off: a flap is a transport
  outage, not a membership event);
- **asymmetric per-link codecs**: the thin parties compress their WAN
  leg with the 2-bit error-feedback codec while fat parties send raw
  (results are not bit-exact by construction, so the bar is
  completion, not equality);
- **GEOMX_WIRE_SANITIZER=1**: every van audits ack-exactly-once,
  countdown drains and epoch monotonicity; any ``WIRE-SANITIZER
  VIOLATION`` marker fails the run (exit 1).

Each worker's gradient is a tensor on the CUDA card (``--cpu``: on the
CPU); without a card and without ``--cpu`` the run raises.

``--health`` turns the same topology into a closed-loop check of the
cluster health plane (``geomx_tpu_torch/ps/linkstate.py``): the run
fails unless the board raised a straggler event naming a planned
straggler (thin party or the flapper) and a link-degradation event
naming the flapper; a second, un-faulted run on the identical shaped
topology must then raise zero ``HEALTH-ANOMALY`` markers.

``--controller`` turns it into the adaptive-transport chaos case: the
self-tuning transport controller is on (per-link codec + slice
decisions from live health estimates), both sanitizers audit every van,
and a mid-run squeeze drops party 9's shaped uplink to 5 Mbps while
rounds are in flight. The bar: every worker completes every round,
zero sanitizer markers, and the controller exported per-link transport
plans with at least one live codec decision.

Same seed => the identical drop/delay/flap schedule and the identical
shaped delivery schedule.

    python -m geomx_tpu_torch.tools.chaos_sim --parties 16 --seed 7
    python -m geomx_tpu_torch.tools.chaos_sim --parties 16 --seed 7 --health
    python -m geomx_tpu_torch.tools.chaos_sim --parties 4 --rounds 2 --cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import time

import numpy as np
import torch

SHAPES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "shapes")


def _fault_plan(thin_ids, flapper, seed):
    """Stragglers on the thin links, one flapping party server."""
    return json.dumps({"seed": seed, "rules": [
        # thin-party gradients straggle: +50-100 ms on half their
        # frames, beyond what their shaped 20 Mbps pipe already costs
        {"type": "delay", "src": thin_ids, "tier": "global",
         "delay_s": 0.05, "jitter_s": 0.05, "p": 0.5},
        # one mid-tier party flaps: two 1.5 s total outages from the
        # global tier; the resender replays through each window
        {"type": "partition", "between": [flapper, "*"],
         "tier": "global", "start_s": 6.0, "duration_s": 1.5},
        {"type": "partition", "between": [flapper, "*"],
         "tier": "global", "start_s": 10.0, "duration_s": 1.5},
        # background loss on every global link
        {"type": "drop", "p": 0.05, "tier": "global"},
    ]})


def _health_fault_plan(thin_ids, flapper, seed):
    """The health-mode plan: faults the anomaly detectors exist for.

    The straggler delays sit on the thin parties' DOWNLINK (dst) —
    round progress is stamped when a node issues its combined round,
    so only delaying what a party must RECEIVE before its next round
    (the global pull response) makes its round clock genuinely lag the
    cluster; +1.0 s is several heartbeat refreshes past the board's
    persistence bar. The flap windows set ``"control": true`` so the
    flapper's heartbeat/digest stream is cut too: its board entry goes
    stale (straggler signal) and the severed heartbeats per window
    retransmit after heal as one burst (loss-degradation signal). No
    background loss: every raised event must be attributable to a
    planned fault.
    """
    return json.dumps({"seed": seed, "rules": [
        {"type": "delay", "dst": thin_ids, "tier": "global",
         "delay_s": 1.0, "jitter_s": 0.2, "p": 0.9},
        {"type": "partition", "between": [flapper, "*"], "control": True,
         "tier": "global", "start_s": 3.0, "duration_s": 1.5},
        {"type": "partition", "between": [flapper, "*"], "control": True,
         "tier": "global", "start_s": 6.5, "duration_s": 1.5},
    ]})


class _MarkerTrap(logging.Handler):
    """Collect every marker-carrying log line as it happens."""

    def __init__(self, marker, level=logging.ERROR):
        super().__init__(level=level)
        self.marker = marker
        self.hits = []

    def emit(self, record):
        msg = record.getMessage()
        if self.marker in msg:
            self.hits.append(msg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, default=16)
    ap.add_argument("--size", type=int, default=None,
                    help="elements per gradient (float32); default "
                         "256KB, or 64KB with --health (smaller rounds "
                         "keep the shared incast pipe's intrinsic "
                         "queueing skew under the straggler bar)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--shape", default=os.path.join(SHAPES, "hetero16.json"),
                    help="ShapePlan JSON path or inline JSON; '' = off")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--health", action="store_true",
                    help="health-plane closed loop: faulted run must "
                         "raise straggler + link-degradation events "
                         "for the planned culprits; a clean run on the "
                         "same shaped topology must raise none")
    ap.add_argument("--controller", action="store_true",
                    help="adaptive-transport chaos: transport "
                         "controller on, both sanitizers on, a mid-run "
                         "squeeze of one shaped uplink; fails on any "
                         "sanitizer marker or aborted round")
    ap.add_argument("--cpu", action="store_true",
                    help="workers' gradients on the CPU (default: the "
                         "CUDA card, which must be there)")
    args = ap.parse_args(argv)
    if args.health and args.controller:
        ap.error("--health and --controller are separate cases")
    size = args.size if args.size is not None \
        else (16384 if (args.health or args.controller) else 65536)

    from geomx_tpu_torch._device import resolve_device
    from geomx_tpu_torch.optimizer import SGD
    from geomx_tpu_torch.ps import base, linkstate, locks, sanitizer
    from geomx_tpu_torch.simulate import InProcessHiPS

    dev = resolve_device("cpu" if args.cpu else None)

    n = args.parties
    gids = [base.worker_rank_to_id(r) for r in range(n)]
    # mirror hetero16.json's tiers at any party count: last quarter
    # thin (straggler + 2-bit codec), one mid-tier party flaps
    thin = list(range(n - max(1, n // 4), n))
    thin_ids = [gids[p] for p in thin]
    flapper = gids[n // 2]

    rounds = max(args.rounds, 8) if (args.health or args.controller) \
        else args.rounds
    extra = dict(
        ps_seed=args.seed,
        wire_sanitizer=True,
        lock_sanitizer=True,
        # drops/flaps heal through the resender; the deadline outlives
        # the longest flap window by a wide margin
        resend=True, resend_timeout_ms=500, resend_deadline_s=120.0,
    )
    if not args.controller:
        # the controller case injects no faults: the mid-run squeeze IS
        # the chaos, and it rides the shaping plane, not the fault plane
        extra["fault_plan"] = (
            _health_fault_plan(thin_ids, flapper, args.seed)
            if args.health else _fault_plan(thin_ids, flapper, args.seed))
    plan_dir = ""
    if args.controller:
        import tempfile
        plan_dir = tempfile.mkdtemp(prefix="geomx_ctrl_chaos_")
        extra.update(
            transport_controller=True,
            health=True, health_dir=plan_dir,
            heartbeat_interval_s=0.2, heartbeat_timeout_s=60,
            # the shared 25 Mbps incast pipe queues ~1 s at 16 parties
            # (same bar as --health): the retransmit timeout must clear
            # it or healthy queueing reads as loss
            resend_timeout_ms=3000,
            health_degrade_factor=0.0, health_rtx_burst=3,
            health_stall_s=300.0,
        )
    if args.health:
        extra.update(
            health=True,
            # digests ride heartbeats; a node's straggler streak
            # advances only on its OWN digests, so at a 0.2 s cadence
            # the 4-refresh persistence bar means "lagging for ~0.8 s
            # straight" — above the shared incast pipe's intrinsic
            # queueing skew (~0.4 s at 64 KB gradients), below the
            # +1.0 s injected downlink delays. The flaps are transport
            # outages, NOT membership events: the timeout outlives
            # the run.
            heartbeat_interval_s=0.2, heartbeat_timeout_s=60,
            # the shared 25 Mbps incast pipe to the global server
            # legitimately queues ~1 s at 16 parties: the retransmit
            # timeout must clear that or the CLEAN run retransmits
            # (and the board would call the queueing "loss")
            resend_timeout_ms=3000,
            # burst-only degradation: on a shared incast pipe each
            # flow's implied bandwidth is a queueing lottery, so the
            # bw-vs-own-baseline detector is off (factor 0) and the
            # flap must surface through retransmit bursts instead.
            # The FSA rounds legitimately pause during a flap, so the
            # stall detector is parked out of reach.
            health_degrade_factor=0.0, health_rtx_burst=3,
            health_stall_s=300.0,
            health_straggler_rounds=1, health_straggler_persist=4,
        )
    if args.shape:
        plan = args.shape.strip()
        extra["shape_plan"] = plan if plan.startswith(("{", "[", "@")) \
            else "@" + plan
    # static per-party thin-leg codecs — except in controller mode,
    # where a static override would win over the controller's decision
    # (explicit config beats the plan) and defeat the case
    per_party = {} if args.controller \
        else {p: {"wire_codec_wan": "2bit"} for p in thin}

    trap = _MarkerTrap(sanitizer.MARKER)
    logging.getLogger("geomx.sanitizer").addHandler(trap)
    ltrap = _MarkerTrap(locks.MARKER)
    logging.getLogger("geomx.locks").addHandler(ltrap)
    htrap = _MarkerTrap(linkstate.MARKER, level=logging.WARNING)
    logging.getLogger("geomx.health").addHandler(htrap)

    def one_run(extra_cfg, label, squeeze_after=0.0):
        print(f"# shaped chaos[{label}]: {n} parties, "
              f"{size * 4 // 1024} KB gradient, {rounds} rounds, "
              f"seed={args.seed}, shape={args.shape or 'off'}, "
              f"thin={thin_ids}, flapper={flapper}, gradients on {dev}")
        t0 = time.perf_counter()
        topo = InProcessHiPS(num_parties=n, workers_per_party=1,
                             extra_cfg=extra_cfg,
                             per_party_cfg=per_party, device=dev).start()
        squeezer = None
        if squeeze_after > 0:
            # mid-run link squeeze: party 9's shaped uplink to the
            # global server collapses to 5 Mbps while rounds are in
            # flight — prepended so it wins the first-match lookup
            import threading
            from geomx_tpu_torch.ps.shaping import ShapeLink
            gsrv = next(s for s in topo.servers if s.is_global_server)
            shaper = gsrv.po_global.van._shaper

            def _squeeze():
                if shaper is None:
                    return
                shaper.plan.links.insert(0, ShapeLink(
                    src=9, dst=8, tier="global",
                    rtt_ms=150.0, bw_mbps=5.0))
                print(f"# squeeze: link 9>8 now 5 Mbps / 150 ms "
                      f"(t+{time.perf_counter() - t0:.1f}s)")

            squeezer = threading.Timer(squeeze_after, _squeeze)
            squeezer.start()
        finals = []
        try:
            def master_init(kv):
                kv.set_optimizer(SGD(learning_rate=0.1))
                kv.init(0, np.zeros(size, np.float32))
                kv.wait()

            def worker(kv):
                out = np.zeros(size, np.float32)
                kv.init(0, np.zeros(size, np.float32))
                for r in range(rounds):
                    grad = torch.full((size,), float(r + 1), device=dev)
                    if args.health or args.controller:
                        # combined rounds stamp Meta.trace_round — the
                        # clock the board and the transport controller
                        # both run on
                        kv.push_pull(0, grad, out)
                    else:
                        kv.push(0, grad)
                        kv.pull(0, out=out)
                    kv.wait()
                finals.append(out.copy())

            topo.run_workers(worker, include_master=master_init,
                             timeout=args.timeout)
        finally:
            if squeezer is not None:
                squeezer.cancel()
            topo.stop()
        return finals, time.perf_counter() - t0

    label = ("faulted" if args.health
             else "adaptive" if args.controller else "chaos")
    finals, wall = one_run(
        extra, label, squeeze_after=5.0 if args.controller else 0.0)

    ok = True
    if len(finals) != n:
        print(f"FAILED: only {len(finals)}/{n} workers completed")
        ok = False
    for i, f in enumerate(finals):
        if not np.all(np.isfinite(f)):
            print(f"FAILED: worker {i} final model has non-finite values")
            ok = False
    if trap.hits:
        print(f"FAILED: {len(trap.hits)} wire-sanitizer violation(s):")
        for h in trap.hits[:10]:
            print("  " + h)
        ok = False
    if ltrap.hits:
        print(f"FAILED: {len(ltrap.hits)} lock-sanitizer violation(s):")
        for h in ltrap.hits[:10]:
            print("  " + h)
        ok = False

    if args.controller:
        # the controller must have made live decisions: per-node plan
        # exports with at least one codec assignment on a WAN link
        plans = [f for f in os.listdir(plan_dir)
                 if f.startswith("plan_")] if plan_dir else []
        decided = 0
        for f in plans:
            try:
                with open(os.path.join(plan_dir, f)) as fh:
                    doc = json.load(fh)
                decided += sum(1 for lk in doc.get("links", {}).values()
                               if lk.get("codec"))
            except (OSError, ValueError):
                continue
        print(f"# controller: {len(plans)} plan export(s), "
              f"{decided} live codec decision(s)")
        if not plans:
            print("FAILED: controller exported no transport plans")
            ok = False
        elif decided == 0:
            print("FAILED: controller made no live codec decision")
            ok = False

    if args.health:
        planned = set(thin_ids) | {flapper}
        stragglers = [int(m.group(1)) for m in
                      (re.search(r"\bnode=(\d+)", h) for h in htrap.hits
                       if " straggler " in h) if m]
        degraded = [(int(m.group(1)), int(m.group(2))) for m in
                    (re.search(r"\bsrc=(\d+) dst=(\d+)", h)
                     for h in htrap.hits if " link_degraded " in h) if m]
        print(f"# health[faulted]: {len(htrap.hits)} anomaly marker(s); "
              f"stragglers={sorted(set(stragglers))}, "
              f"degraded={sorted(set(degraded))}")
        if not any(s in planned for s in stragglers):
            print(f"FAILED: no straggler event named a planned culprit "
                  f"(thin {thin_ids} or flapper {flapper}); "
                  f"got {sorted(set(stragglers))}")
            ok = False
        if not any(flapper in (s, d) for s, d in degraded):
            print(f"FAILED: no link-degradation event named the "
                  f"flapping server {flapper}; "
                  f"got {sorted(set(degraded))}")
            ok = False

        # clean control run: identical shaped topology, no fault plan —
        # the detectors must stay silent (no events from shaping alone)
        htrap.hits = []
        clean_extra = {k: v for k, v in extra.items() if k != "fault_plan"}
        clean_finals, clean_wall = one_run(clean_extra, "clean")
        if len(clean_finals) != n:
            print(f"FAILED: clean run: only {len(clean_finals)}/{n} "
                  f"workers completed")
            ok = False
        if htrap.hits:
            print(f"FAILED: clean run raised {len(htrap.hits)} "
                  f"anomaly event(s):")
            for h in htrap.hits[:10]:
                print("  " + h)
            ok = False
        wall += clean_wall

    if ok:
        bar = ("health events fire on faults only, sanitizer clean"
               if args.health
               else "controller live through the squeeze, sanitizer clean"
               if args.controller else "sanitizer clean")
        print(f"OK: {n} shaped chaotic parties completed "
              f"{rounds} rounds in {wall:.1f}s, {bar}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
