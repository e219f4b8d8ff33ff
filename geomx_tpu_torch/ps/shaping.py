"""Deterministic per-link RTT/bandwidth shaping for the van transport.

FaultPlan (``ps/faults.py``) answers "what if this frame is lost" —
this module answers "what if this link is a real WAN". A ShapePlan is
a per-(src, dst) latency/bandwidth matrix loaded from a JSON topology
file (``GEOMX_SHAPE_PLAN``, inline JSON or ``@/path``, seeded like
PS_FAULT_PLAN) that every van consults on every inbound data frame:

- **fixed one-way delay**: ``rtt_ms / 2`` per traversal, plus a
  seeded per-frame jitter drawn from the link's own RNG stream;
- **token-bucket serialization**: each link direction owns a
  ``busy_until`` horizon; a frame of ``n`` bytes extends it by
  ``n * 8 / (bw_mbps * 1e6)`` seconds, and the frame is not delivered
  before the horizon it extended — back-to-back frames queue behind
  each other exactly like packets on a thin pipe. Jitter is folded
  into the horizon too, so per-link delivery stays FIFO (a TCP link
  never reorders) and the schedule stays deterministic.

Held frames re-enter through :func:`faults.deliver_later` — the same
timer/delivery machinery the fault injector's delay/dup rules use —
so drop/dup/partition compose with shaping deterministically: faults
run first in ``Van._inbound_gate``, a dropped frame is never shaped,
and a re-injected frame bypasses the gate so it is never shaped twice.

Plan JSON::

    {"seed": 7,
     "default": {"rtt_ms": 50, "bw_mbps": 100},
     "links": [
       {"src": 9, "dst": 8, "tier": "global",
        "rtt_ms": 150, "bw_mbps": 20, "jitter_ms": 2},
       {"dst": 8, "tier": "global", "shared": true,
        "rtt_ms": 50, "bw_mbps": 100}]}

``links`` match like fault rules (int / list / "*" node specs, tier
"local" | "global" | "*"); first match wins, else ``default`` (omit
``default`` to leave unmatched links unshaped). Control frames
(rendezvous, barriers, heartbeats, transport ACKs) are exempt unless
a link sets ``"control": true`` — shaping targets the data plane; a
shaped control plane would just slow rendezvous at 16-64 parties
without changing what any capture measures.

``"shared": true`` makes every frame matched by the rule queue on ONE
token bucket instead of a private per-(src, dst) bucket: the rule
models a node's access pipe rather than a dedicated path, so an N-to-1
incast genuinely contends — N concurrent flows serialize behind each
other exactly like traffic converging on a parameter server's uplink.
Without it, per-pair buckets make an incast embarrassingly parallel
and TSEngine's overlay has nothing to win. The pipe's owner is derived
from the rule: a concrete single ``src`` owns an egress pipe, else the
receiving node owns an ingress pipe. Because shaping is evaluated in
the receiver's van, shared buckets live in a process-global registry
(all in-process vans see the same horizon) — an egress pipe must
contend across frames fanning out to MANY receivers' shapers. Shapers
driven by an injectable test clock keep shared buckets private to the
instance instead: mixing fake-clock horizons with wall-clock ones
would wedge deliveries, and determinism tests need isolation anyway.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from geomx_tpu_torch.ps import faults as faults_mod
from geomx_tpu_torch.ps import linkstate
from geomx_tpu_torch.ps.faults import _match

log = logging.getLogger("geomx.shaping")

_ALLOWED = {"src", "dst", "tier", "rtt_ms", "bw_mbps", "jitter_ms",
            "control", "shared"}


@dataclasses.dataclass
class ShapeLink:
    src: object = "*"          # sender match: int / list / "*"
    dst: object = "*"          # receiver match
    tier: str = "*"            # "local" | "global" | "*"
    rtt_ms: float = 0.0        # round-trip latency; each traversal adds half
    bw_mbps: float = 0.0       # link bandwidth; 0 = infinite (no ser. delay)
    jitter_ms: float = 0.0     # seeded uniform [0, jitter_ms) per frame
    control: bool = False      # shape control frames on this link too
    shared: bool = False       # one bucket per receiver, not per (src,dst)

    @classmethod
    def from_dict(cls, d: dict) -> "ShapeLink":
        unknown = set(d) - _ALLOWED
        if unknown:
            raise ValueError(f"shape link: unknown keys {sorted(unknown)}")
        ln = cls(**d)
        if ln.tier not in ("local", "global", "*"):
            raise ValueError(f"shape link: bad tier {ln.tier!r}")
        if ln.rtt_ms < 0 or ln.bw_mbps < 0 or ln.jitter_ms < 0:
            raise ValueError("shape link: rtt_ms/bw_mbps/jitter_ms >= 0")
        return ln

    def tier_matches(self, is_global: bool) -> bool:
        if self.tier == "*":
            return True
        return self.tier == ("global" if is_global else "local")


class ShapePlan:
    """Immutable parsed topology; ``bind(van)`` yields a per-van shaper."""

    def __init__(self, links: List[ShapeLink],
                 default: Optional[ShapeLink] = None,
                 seed: Optional[int] = None):
        self.links = list(links)
        self.default = default
        self.seed = seed

    @classmethod
    def parse(cls, text: str, seed: Optional[int] = None) -> "ShapePlan":
        text = text.strip()
        if text.startswith("@"):
            with open(text[1:], "r", encoding="utf-8") as f:
                text = f.read()
        doc = json.loads(text)
        default = None
        links = doc
        if isinstance(doc, dict):
            seed = doc.get("seed", seed)
            if "default" in doc:
                default = ShapeLink.from_dict(doc["default"])
            links = doc.get("links", [])
        return cls([ShapeLink.from_dict(ln) for ln in links],
                   default=default, seed=seed)

    def bind(self, van) -> "LinkShaper":
        return LinkShaper(self, van)

    def link_for(self, src: int, dst: int,
                 is_global: bool) -> Optional[ShapeLink]:
        for ln in self.links:
            if (ln.tier_matches(is_global) and _match(ln.src, src)
                    and _match(ln.dst, dst)):
                return ln
        if self.default is not None \
                and self.default.tier_matches(is_global):
            return self.default
        return None

    def worst_link(self, is_global: bool = True
                   ) -> Optional[Tuple[float, float]]:
        """(rtt_ms, bw_mbps) of the highest-BDP shaped link on a tier —
        the sizing input for :func:`frontier.auto_slice_bytes`. A link
        with ``bw_mbps == 0`` (latency-only) contributes rtt only."""
        best: Optional[Tuple[float, float]] = None
        cands = [ln for ln in self.links if ln.tier_matches(is_global)]
        if self.default is not None and self.default.tier_matches(is_global):
            cands.append(self.default)
        for ln in cands:
            if ln.rtt_ms <= 0 and ln.bw_mbps <= 0:
                continue
            if best is None or _bdp(ln) > _bdp_pair(best):
                best = (ln.rtt_ms, ln.bw_mbps)
        return best


def _bdp(ln: ShapeLink) -> float:
    return (ln.rtt_ms / 1e3) * (ln.bw_mbps or 1e3) * 1e6 / 8.0


def _bdp_pair(p: Tuple[float, float]) -> float:
    return (p[0] / 1e3) * (p[1] or 1e3) * 1e6 / 8.0


# process-global shared-pipe horizons: (is_global, "in"|"out", owner)
# -> busy-until in time.monotonic() terms. Stale entries from a torn-
# down topology sit in the past, so max(now, horizon) ignores them.
_shared_lock = threading.Lock()
_shared_horizons: Dict[Tuple[bool, str, int], float] = {}


def reset_shared_buckets() -> None:
    """Drop all process-global shared-pipe horizons (test isolation)."""
    with _shared_lock:
        _shared_horizons.clear()


def plan_from_config(cfg) -> Optional[ShapePlan]:
    """GEOMX_SHAPE_PLAN -> ShapePlan. Seed precedence mirrors faults:
    plan-embedded ``"seed"`` beats GEOMX_SHAPE_SEED beats PS_SEED."""
    if not cfg.shape_plan:
        return None
    seed = cfg.shape_seed if cfg.shape_seed >= 0 else (
        cfg.ps_seed if cfg.ps_seed >= 0 else None)
    return ShapePlan.parse(cfg.shape_plan, seed=seed)


class LinkShaper:
    """Per-van shaping evaluator with deterministic RNG streams.

    ``on_inbound(msg)`` returns True to deliver now (unshaped link or
    exempt control frame); False means the frame was accepted but held
    and will re-enter via ``van._process`` once its link delay elapses.

    ``clock`` is injectable so tests can drive the token bucket with a
    fake monotonic clock and assert the full delivery schedule —
    queueing included — is identical for identical plan + seed.
    """

    def __init__(self, plan: ShapePlan, van, clock=time.monotonic):
        self.plan = plan
        self.van = van
        self.clock = clock
        self._lock = threading.Lock()
        # (src, dst) -> serialization horizon, in clock() time
        self._busy_until: Dict[Tuple[int, int], float] = {}
        self._rngs: Dict[Tuple[int, int], random.Random] = {}
        self._seq: Dict[Tuple[int, int], int] = {}
        # (src, dst, seq, nbytes, delay_ms) — the audit trail the
        # determinism tests compare across runs (delay excludes the
        # wall-clock queue wait unless driven by a fake clock)
        self.decision_log: List[Tuple] = []

    def arm(self) -> None:  # symmetry with FaultInjector.arm
        pass

    def _rng(self, src: int, dst: int) -> random.Random:
        key = (src, dst)
        r = self._rngs.get(key)
        if r is None:
            base = self.plan.seed if self.plan.seed is not None else 0
            # same stable integer mix as FaultInjector._rng — NOT
            # hash(), which is salted per process
            r = random.Random(base * 1_000_003 * 7_919
                              + (src & 0xFFFF) * 104_729 + (dst & 0xFFFF))
            self._rngs[key] = r
        return r

    def on_inbound(self, msg) -> bool:
        src = msg.meta.sender
        dst = self.van.my_id
        link = self.plan.link_for(src, dst, self.van.is_global)
        if link is None:
            return True
        if msg.is_control and not link.control:
            return True
        nbytes = sum(len(d) for d in msg.data) if msg.data else 0
        with self._lock:
            now = self.clock()
            rng = self._rng(src, dst)
            ser_s = (nbytes * 8.0 / (link.bw_mbps * 1e6)
                     if link.bw_mbps > 0 else 0.0)
            jit_s = (rng.random() * link.jitter_ms / 1e3
                     if link.jitter_ms > 0 else 0.0)
            occ = ser_s + jit_s
            if link.shared:
                # shared access pipe: a concrete single src owns an
                # egress pipe, otherwise the receiver owns an ingress
                # pipe. The horizon lives in the process-global registry
                # so the egress case contends across ALL receiver-side
                # shapers, not just this van's. (-2, owner) keys the
                # per-instance seq/log stream; real ids are >= 0.
                if isinstance(link.src, int):
                    bkey = (self.van.is_global, "out", link.src)
                else:
                    bkey = (self.van.is_global, "in", dst)
                key = (-2 if bkey[1] == "out" else -1, bkey[2])
                if self.clock is time.monotonic:
                    with _shared_lock:
                        horizon = max(_shared_horizons.get(bkey, now),
                                      now) + occ
                        _shared_horizons[bkey] = horizon
                else:   # fake clock: keep the bucket instance-private
                    horizon = max(self._busy_until.get(key, now),
                                  now) + occ
                    self._busy_until[key] = horizon
            else:
                key = (src, dst)
                # token bucket: this frame occupies the pipe for ser_s
                # (+ jitter) starting when the previous frame drains —
                # folding jitter into the horizon keeps per-link
                # delivery FIFO
                horizon = max(self._busy_until.get(key, now), now) + occ
                self._busy_until[key] = horizon
            delay = (horizon - now) + link.rtt_ms / 2e3
            seq = self._seq.get(key, 0) + 1
            self._seq[key] = seq
            self.decision_log.append(
                (src, dst, seq, nbytes, round(delay * 1e3, 6)))
        if delay <= 0.0:
            return True
        tier = "global" if self.van.is_global else "local"
        linkstate.note_shaped_delay(src, dst, delay, tier=tier)
        linkstate.note_shaped_bytes(src, dst, nbytes, tier=tier)
        faults_mod.deliver_later(self.van, delay, msg)
        return False
