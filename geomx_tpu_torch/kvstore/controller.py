"""Self-tuning transport: the health plane closed into an actuator.

The health plane is the sensor — every van runs a :class:`ps.linkstate.
LinkEstimator` fed by resender send→ack spans, and schedulers aggregate
digests into a :class:`ClusterHealthBoard` with latched anomaly
detectors. This module is ROADMAP item 3's actuator: a per-link,
per-round :class:`TransportController` that reads the freshest
estimate each round and emits a :class:`TransportPlan` —

- **per-peer wire codec**: fp16 on fat links, 2bit/mpq on thin ones,
  with hysteresis (a class change needs ``GEOMX_CTRL_PERSIST``
  consecutive proposals, and a dip from a healthy baseline must clear
  the link's own learned noise floor) so a noisy-but-healthy link never
  flaps;
- **P3 slice budget**: re-sized from the *measured* BDP
  (:func:`frontier.auto_slice_bytes` over live estimates instead of the
  declared shape plan), re-published only past a fractional hold band;
- **degraded-link input**: a latched ``link_degraded`` event (from the
  colocated board, where one exists) or a retransmit burst seen by the
  local estimator short-circuits the hysteresis — the detector already
  carries its own noise floor, so the squeeze converges immediately.

The plan rides the existing ``Meta.compr`` tag machinery: servers
decode tag-driven (``decode_wire``), so per-peer codec changes need no
new protocol verbs. Consumers: ``KVStoreDist.push_pull_async`` (chunk
codec + chunk budget per round), the party server's WAN forward
(``_wan_wire_tag``), and ``TSScheduler`` (degraded-link schedule bias,
fed from the board directly).

Every decision is post-mortem-able: one ``transport_plan`` flight-
recorder record per (round, peer) carrying the full inputs AND the
pre-decision state (baseline, variance, streak), so each record can be
re-verified standalone with :func:`replay_record` from a dump — no
replaying of the whole history needed. Slice-budget changes log as
``transport_slice``. The active plan also exports atomically to
``GEOMX_HEALTH_DIR/plan_<tier>_<node>.json`` for ``tools/geomx_top.py``.

Decision table (docs/adaptive-transport.md holds the prose version):

    measured bw        baseline context              proposal
    -----------        ----------------              --------
    degraded latch /   (detector's own floor)        thin, NOW
      rtx burst
    bw <  thin_mbps    base >= thin and dip <= noise (hold: noise dip)
    bw <  thin_mbps    otherwise                     thin
    bw >= fat_mbps     base <  fat and rise <= noise (hold: noise spike)
    bw >= fat_mbps     otherwise                     fat
    else               no codec assigned yet         fat (fp16 floor)
    else               dead zone                     (hold)

    The fp16 floor: once a WAN link is MEASURED, fp16 beats raw
    outright — the model pull-back rides the same pipe at >= fp16-
    equivalent bytes, so halving the push is pure savings at ~zero
    precision cost (PERF.md "Self-tuning transport"). The same
    measurement says 2bit's convergence tax only pays off on severely
    squeezed links, hence the low ``thin_mbps`` default: mpq/2bit is
    the emergency policy (squeeze, degraded latch, rtx burst), not the
    steady-state one. A link that recovers from thin re-promotes only
    past ``fat_mbps`` — conservative by design.

    A proposal only becomes the assigned codec after ``persist``
    consecutive rounds — except detector-driven proposals and the
    first-ever classification of a fresh link (no learned baseline yet),
    which apply immediately.

Module-level imports only (frontier + telemetry + locks + stdlib): the
controller is touched from van/server threads, and a lazy package
import from there can deadlock on the import lock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

from geomx_tpu_torch import telemetry
from geomx_tpu_torch.kvstore.frontier import slice_bytes_from_links
from geomx_tpu_torch.ps import locks

__all__ = ["Knobs", "TransportPlan", "TransportController",
           "step_link", "replay_record", "resolve_policy",
           "FAT_POLICY", "THIN_POLICY"]

# wire policies the controller assigns per link class. Thin links get
# the paper's size rule (bulk chunks 2bit, small ones fp16) rather than
# blanket 2bit: tiny head chunks don't amortize residual noise.
FAT_POLICY = "fp16"
THIN_POLICY = "mpq"

# baseline learning mirrors the board's detector: freeze while a drop
# is suspected (a squeeze must not erode its own reference), slow EWMA
# otherwise
_BASE_GAIN = 0.1
_VAR_GAIN = 0.3
_FREEZE_RATIO = 0.5


@dataclasses.dataclass(frozen=True)
class Knobs:
    """Controller tuning surface (GEOMX_CTRL_*; see config.py)."""

    thin_mbps: float = 15.0
    fat_mbps: float = 150.0
    persist: int = 2
    noise_sigma: float = 2.0
    slice_hold: float = 0.25
    rtt_floor_ms: float = 1.0
    rtx_burst: int = 5
    size_lower_bound: int = 200000

    @classmethod
    def from_config(cls, cfg) -> "Knobs":
        return cls(thin_mbps=cfg.ctrl_thin_mbps,
                   fat_mbps=cfg.ctrl_fat_mbps,
                   persist=max(1, cfg.ctrl_persist),
                   noise_sigma=cfg.ctrl_noise_sigma,
                   slice_hold=cfg.ctrl_slice_hold,
                   rtt_floor_ms=cfg.ctrl_rtt_floor_ms,
                   rtx_burst=cfg.health_rtx_burst,
                   size_lower_bound=cfg.size_lower_bound)


def resolve_policy(policy: str, num_elems: int,
                   size_lower_bound: int) -> str:
    """Per-chunk wire tag for a controller-assigned policy — the same
    size rule as ``WireCodec.chunk_codec`` so "mpq" routes bulk chunks
    to 2bit and small ones to fp16."""
    if policy in ("", "fp16", "2bit"):
        return policy
    return "2bit" if num_elems >= size_lower_bound else "fp16"


_FRESH_STATE = {"codec": None, "base": 0.0, "var": 0.0, "streak": 0,
                "proposed": None}


def step_link(state: Optional[dict], bw_mbps: float, rtt_ms: float,
              rtx_delta: int, degraded: bool, knobs: Knobs
              ) -> Tuple[dict, dict]:
    """One link's per-round decision step — PURE (state in, state out),
    so a flight-recorder record carrying the pre-state and inputs can be
    re-verified offline (:func:`replay_record`).

    Returns ``(new_state, record)``; ``record`` holds the inputs, the
    embedded pre-state, and the action (``codec``/``changed``/
    ``reason``)."""
    st = dict(state) if state else dict(_FRESH_STATE)
    pre = dict(st)
    base = st["base"]
    noise = knobs.noise_sigma * (st["var"] ** 0.5)
    prop: Optional[str] = None
    if degraded or (knobs.rtx_burst > 0 and rtx_delta >= knobs.rtx_burst):
        # the detector (or a local retransmit burst) already cleared its
        # own noise floor: bypass the persistence bar below
        prop, reason = THIN_POLICY, ("degraded" if degraded
                                     else "rtx_burst")
    elif bw_mbps <= 0:
        reason = "no_evidence"
    elif bw_mbps < knobs.thin_mbps:
        if base >= knobs.thin_mbps and (base - bw_mbps) <= noise:
            reason = "noise_dip"      # healthy baseline, dip within floor
        else:
            prop, reason = THIN_POLICY, "thin_bw"
    elif bw_mbps >= knobs.fat_mbps:
        if 0.0 < base < knobs.fat_mbps and (bw_mbps - base) <= noise:
            reason = "noise_spike"
        else:
            prop, reason = FAT_POLICY, "fat_bw"
    elif st["codec"] is None:
        # the fp16 floor: a measured-but-unclassified link defaults to
        # fp16 — halving push bytes is free once evidence exists (the
        # pull-back already rides the pipe at >= that), raw never wins
        prop, reason = FAT_POLICY, "fp16_floor"
    else:
        reason = "dead_zone"
    # baseline/floor learning (frozen while a drop is suspected)
    if bw_mbps > 0:
        if base == 0.0:
            st["base"] = bw_mbps
        elif bw_mbps >= _FREEZE_RATIO * base:
            dev = bw_mbps - base
            st["base"] = (1.0 - _BASE_GAIN) * base + _BASE_GAIN * bw_mbps
            st["var"] = (1.0 - _VAR_GAIN) * st["var"] \
                + _VAR_GAIN * dev * dev
    # hysteresis: a differing proposal must persist; detector-driven
    # proposals (their floor already passed) switch immediately, and so
    # does the FIRST-ever classification (pre_base == 0: hysteresis
    # guards changes against flapping, not the bootstrap — making a
    # fresh link wait `persist` rounds just taxes every run's start)
    changed = False
    if prop is not None and prop != st["codec"]:
        st["streak"] = st["streak"] + 1 if st["proposed"] == prop else 1
        st["proposed"] = prop
        need = 1 if (reason in ("degraded", "rtx_burst")
                     or (pre["codec"] is None and pre["base"] == 0.0)) \
            else knobs.persist
        if st["streak"] >= need:
            st["codec"] = prop
            st["streak"] = 0
            st["proposed"] = None
            changed = True
    else:
        st["streak"] = 0
        st["proposed"] = None
    record = {
        "bw": round(bw_mbps, 3), "rtt": round(rtt_ms, 3),
        "rtx_delta": int(rtx_delta), "degraded": bool(degraded),
        "pre_codec": pre["codec"], "pre_base": round(pre["base"], 3),
        "pre_var": round(pre["var"], 3), "pre_streak": pre["streak"],
        "pre_proposed": pre["proposed"],
        "codec": st["codec"], "changed": changed, "reason": reason,
    }
    return st, record


def replay_record(rec: dict, knobs: Knobs) -> dict:
    """Re-run one logged decision from its embedded pre-state + inputs.
    Returns the action fields the controller must have produced — the
    dump-replay test asserts they match the record."""
    st = {"codec": rec["pre_codec"], "base": rec["pre_base"],
          "var": rec["pre_var"], "streak": rec["pre_streak"],
          "proposed": rec["pre_proposed"]}
    _, out = step_link(st, rec["bw"], rec["rtt"], rec["rtx_delta"],
                       rec["degraded"], knobs)
    return {k: out[k] for k in ("codec", "changed", "reason")}


class TransportPlan:
    """One round's frozen transport decisions. ``codecs`` maps peer van
    id -> assigned policy (absent peer = keep the static default);
    ``slice_bytes`` is the live-BDP chunk budget (0 = no override)."""

    __slots__ = ("round", "codecs", "slice_bytes", "reasons",
                 "size_lower_bound")

    def __init__(self, round_idx: int, codecs: Dict[int, str],
                 slice_bytes: int, reasons: Dict[int, str],
                 size_lower_bound: int):
        self.round = round_idx
        self.codecs = codecs
        self.slice_bytes = slice_bytes
        self.reasons = reasons
        self.size_lower_bound = size_lower_bound

    def has_codecs(self) -> bool:
        return bool(self.codecs)

    def wire_tag(self, peer: int, default_tag: str,
                 num_elems: int) -> str:
        """Wire tag for one (chunk, peer) message: the peer's assigned
        policy resolved at chunk granularity, or the static default when
        the controller has no decision for this peer yet."""
        pol = self.codecs.get(peer)
        if pol is None:
            return default_tag
        return resolve_policy(pol, num_elems, self.size_lower_bound)


@locks.guarded_by("_lock", "_state", "_last_rtx", "_slice",
                  "_last_round", "_plan")
class TransportController:
    """Per-node transport controller: one instance per van that sends
    data (the worker store's local van; the party server's global van).
    ``plan(round_idx)`` is idempotent per round — the first caller of a
    new round recomputes, everyone else gets the cached plan — so the
    hot path pays a lock + dict lookup."""

    def __init__(self, cfg, tier: str, node_fn, estimator=None,
                 board_fn=None, flightrec=None, out_dir: str = ""):
        self.knobs = Knobs.from_config(cfg)
        self.tier = tier
        self.node_fn = node_fn
        self._est = estimator
        self._board_fn = board_fn          # () -> board render dict
        self._flightrec = flightrec
        self.out_dir = out_dir
        self._lock = locks.make_lock("TransportController._lock")
        self._state: Dict[int, dict] = {}
        self._last_rtx: Dict[int, int] = {}
        self._slice = 0
        self._last_round = -1
        self._plan: Optional[TransportPlan] = None

    @classmethod
    def for_van(cls, van, cfg, tier: str) -> "TransportController":
        board = van.healthboard
        return cls(cfg, tier, node_fn=lambda: van.my_id,
                   estimator=van.linkstate,
                   board_fn=(board.render if board is not None else None),
                   flightrec=van.flightrec, out_dir=cfg.health_dir)

    # -- per-round planning ----------------------------------------------

    def plan(self, round_idx: int) -> TransportPlan:
        with self._lock:
            if self._plan is not None and round_idx <= self._last_round:
                return self._plan
        links = {}
        if self._est is not None:
            links = self._est.digest().get("lk", {})
        degraded = self._degraded_peers()
        records: List[Tuple[int, dict]] = []
        live_links: List[Tuple[float, float]] = []
        with self._lock:
            if self._plan is not None and round_idx <= self._last_round:
                return self._plan            # lost the recompute race
            for peer_s, row in links.items():
                peer = int(peer_s)
                rtt_ms, bw = float(row[0]), float(row[1])
                rtx = int(row[5])
                rtx_delta = rtx - self._last_rtx.get(peer, 0)
                self._last_rtx[peer] = rtx
                st, rec = step_link(self._state.get(peer), bw, rtt_ms,
                                    rtx_delta, peer in degraded,
                                    self.knobs)
                self._state[peer] = st
                records.append((peer, rec))
                live_links.append((rtt_ms, bw))
            slice_rec = self._update_slice(live_links)
            codecs = {p: s["codec"] for p, s in self._state.items()
                      if s["codec"] is not None}
            reasons = {p: rec["reason"] for p, rec in records}
            plan = TransportPlan(round_idx, codecs, self._slice, reasons,
                                 self.knobs.size_lower_bound)
            self._plan = plan
            self._last_round = round_idx
        self._log(round_idx, records, slice_rec, plan)
        self._export(plan)
        return plan

    def current(self) -> Optional[TransportPlan]:
        with self._lock:
            return self._plan

    def wan_tag(self, num_elems: int) -> Optional[str]:
        """Codec for one WAN-forward slice (the party server's
        ``_wan_wire_tag`` hook): the thinnest class any decided WAN peer
        carries — the forward fans out to all global servers, so the
        narrowest link governs. None = no decision yet."""
        plan = self.current()
        if plan is None or not plan.codecs:
            return None
        pol = (THIN_POLICY if THIN_POLICY in plan.codecs.values()
               else FAT_POLICY)
        return resolve_policy(pol, num_elems, plan.size_lower_bound)

    # -- internals --------------------------------------------------------

    def _degraded_peers(self) -> frozenset:
        """Peers whose outbound link from THIS node is latched degraded
        on the colocated board (scheduler-side consumers only; data
        nodes fall back to the estimator's retransmit signal)."""
        if self._board_fn is None:
            return frozenset()
        try:
            board = self._board_fn()
        except Exception:  # noqa: BLE001 - the sensor must never kill a send
            return frozenset()
        me = self.node_fn()
        bad = set()
        for key, lk in (board.get("links") or {}).items():
            if not lk.get("degraded"):
                continue
            src, _, dst = key.partition(">")
            if int(src) == me:
                bad.add(int(dst))
        return frozenset(bad)

    def _update_slice(self, live_links) -> Optional[dict]:
        """Worst-link (highest-BDP) chunk budget with a hold band: a
        re-publish needs a > ``slice_hold`` fractional move, so jittery
        estimates don't re-plan chunking every round. Called under
        ``_lock``."""
        new = slice_bytes_from_links(
            live_links, rtt_floor_ms=self.knobs.rtt_floor_ms)
        if new <= 0:
            return None
        cur = self._slice
        if cur > 0 and abs(new - cur) <= self.knobs.slice_hold * cur:
            return None
        self._slice = new
        return {"slice_bytes": new, "prev": cur}

    def _log(self, round_idx: int, records, slice_rec, plan) -> None:
        node = self.node_fn()
        for peer, rec in records:
            if self._flightrec is not None:
                self._flightrec.record("transport_plan", round=round_idx,
                                       tier=self.tier, peer=peer, **rec)
            if rec["changed"]:
                telemetry.event("transport.codec", cat="transport",
                                src=node, dst=peer, tier=self.tier,
                                codec=rec["codec"], reason=rec["reason"],
                                round=round_idx)
        if slice_rec is not None:
            if self._flightrec is not None:
                self._flightrec.record("transport_slice",
                                       round=round_idx, tier=self.tier,
                                       **slice_rec)
            telemetry.event("transport.slice", cat="transport",
                            src=node, tier=self.tier, round=round_idx,
                            **slice_rec)
        if plan.slice_bytes:
            telemetry.gauge_set("transport.slice_bytes",
                                plan.slice_bytes, src=node,
                                tier=self.tier)

    def _export(self, plan: TransportPlan) -> None:
        """Atomic active-plan export (tmp + rename, the board.export
        contract) for the geomx_top dashboard; never raises."""
        if not self.out_dir:
            return
        with self._lock:
            links = {str(p): {"codec": st["codec"] or "",
                              "reason": plan.reasons.get(p, ""),
                              "base_mbps": round(st["base"], 3),
                              "streak": st["streak"]}
                     for p, st in self._state.items()}
        doc = {"node": self.node_fn(), "tier": self.tier,
               "round": plan.round, "slice_bytes": plan.slice_bytes,
               "links": links}
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            # tier in the name: local and global van ids overlap (a
            # worker's local id and a party server's global id can both
            # be 9), and each tier's controller is a separate instance
            path = os.path.join(self.out_dir,
                                f"plan_{self.tier}_{self.node_fn()}.json")
            fd, tmp = tempfile.mkstemp(dir=self.out_dir,
                                       suffix=".tmp.json")
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(doc, separators=(",", ":")))
            os.replace(tmp, path)
        except OSError:
            pass
