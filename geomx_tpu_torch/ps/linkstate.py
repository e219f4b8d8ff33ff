"""geomx-healthd: continuous per-link estimation + the cluster health
board.

Two halves, one module (the lint rule GX-M402 makes this file the ONLY
legitimate ``link.*`` gauge emitter, so everything that measures a link
funnels through here):

- :class:`LinkEstimator` — one per van. Fed from the resender's
  send→ack spans (every non-control frame on every wire: combined
  push_pull, P3-sliced chunks, WAN forwards — the generalization of
  TSEngine's ``_hop_acked`` single-gauge measurement), it keeps a
  two-bucket windowed estimate per (src, dst): small frames (≤
  ``SMALL_FRAME_MAX`` bytes) bound the RTT as ``2 * min(dt)`` — the
  minimum rejects queueing behind large frames — while large frames
  yield an implied bandwidth ``bits / (dt - rtt/2)`` whose windowed
  *median* rejects occasional contention without lagging a real shift
  by more than half the window. EWMA mean/variance ride along for the
  digest, plus loss signals (resender retransmits / give-ups), per-peer
  round progress observed on received frames (``Meta.trace_round``),
  and the codec byte mix of sent traffic.

- :class:`ClusterHealthBoard` — scheduler-side. Every member van
  piggybacks a compact JSON digest of its estimator on the HEARTBEAT
  frames it already sends (``Meta.health`` — zero new per-round WAN
  messages); the scheduler aggregates them into a versioned board
  (per-node liveness/epoch/round progress, per-link RTT/goodput/loss,
  codec mix) queryable via ``kv.health()`` (``HEALTH_CMD``) and
  exported per-round to ``GEOMX_HEALTH_DIR``. On ingest it runs three
  anomaly detectors — straggler (round-progress skew persisting across
  digests), link degradation (bandwidth drop against the link's own
  slow EWMA baseline, or a retransmit burst), epoch stall (no progress
  anywhere) — each latched per episode so one fault raises one event,
  emitted through the telemetry funnel, the flight recorder and the log
  with the grep-able ``HEALTH-ANOMALY`` marker.

Module-level imports only (telemetry + stdlib): vans and handler
threads touch this module, and infra roles hold the package import lock
forever — a lazy ``geomx_tpu_torch.*`` import from here would deadlock.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import statistics
import tempfile
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .. import telemetry
from . import locks

LOG = logging.getLogger("geomx.health")

# grep-able anomaly marker (flight-recorder dumps + log lines)
MARKER = "HEALTH-ANOMALY"

# mirrors kvstore.base.Command.HEALTH — duplicated as a literal so the
# van can answer board queries without importing the kvstore layer
HEALTH_CMD = 15

DIGEST_VERSION = 1
BOARD_VERSION = 1

# frames at or under this ride the RTT bucket; larger frames carry
# enough serialization time to bound bandwidth instead
SMALL_FRAME_MAX = 4096

# windowed-median width for implied bandwidth: odd, small enough that a
# real shift dominates the median within ceil(W/2) samples (the "board
# reflects a degradation within 3 rounds" bar at one big frame/round)
_BW_WINDOW = 5
_RTT_WINDOW = 16
_EWMA_ALPHA = 0.3
# sliding window for retransmit-burst detection (seconds)
_RTX_WINDOW_S = 2.0
# healthy digests (beyond the baseline-setting first) the board must
# see on a link before its bw-drop detector may fire: the noise floor
# needs that many deviations to learn what "steady" looks like
_BW_HEALTHY_MIN = 3


# ---------------------------------------------------------------------------
# the sanctioned link.* gauge funnel (GX-M402)
# ---------------------------------------------------------------------------

def note_goodput(src, dst, mb_s: float, tier: str) -> None:
    """Per-hop goodput observation (TSEngine overlay acks + estimator)."""
    telemetry.gauge_set("link.goodput_mb_s", mb_s, src=src, dst=dst,
                        tier=tier)


def note_shaped_delay(src, dst, delay_s: float, tier: str) -> None:
    """Emulated hold applied to one inbound frame (ps.shaping)."""
    telemetry.gauge_set("link.shaped_delay_ms", delay_s * 1e3, src=src,
                        dst=dst, tier=tier)


def note_shaped_bytes(src, dst, nbytes: int, tier: str) -> None:
    """Bytes carried over an emulated link (ps.shaping)."""
    telemetry.counter_inc("link.shaped_bytes", nbytes, src=src, dst=dst,
                          tier=tier)


# ---------------------------------------------------------------------------
# per-van estimator
# ---------------------------------------------------------------------------

class _LinkStats:
    """Windowed per-(dst) estimate seen from one sending van."""

    __slots__ = ("small", "big", "rtt_ms", "rtt_ewma", "rtt_var",
                 "bw_mbps", "bw_ewma", "bw_var", "goodput_mb_s",
                 "rtx", "give_ups", "n_small", "n_big")

    def __init__(self):
        self.small: Deque[float] = collections.deque(maxlen=_RTT_WINDOW)
        self.big: Deque[float] = collections.deque(maxlen=_BW_WINDOW)
        self.rtt_ms = 0.0       # 2 * min(small window)
        self.rtt_ewma = 0.0
        self.rtt_var = 0.0
        self.bw_mbps = 0.0      # median(big window)
        self.bw_ewma = 0.0
        self.bw_var = 0.0
        self.goodput_mb_s = 0.0
        self.rtx = 0
        self.give_ups = 0
        self.n_small = 0
        self.n_big = 0

    def _ewma(self, attr_mean: str, attr_var: str, x: float) -> None:
        mean = getattr(self, attr_mean)
        if mean == 0.0:
            setattr(self, attr_mean, x)
            return
        d = x - mean
        setattr(self, attr_var,
                (1 - _EWMA_ALPHA) * getattr(self, attr_var)
                + _EWMA_ALPHA * d * d)
        setattr(self, attr_mean, mean + _EWMA_ALPHA * d)


@locks.guarded_by("_lock", "_links", "_peer_rounds", "_codec_bytes",
                  "_round")
class LinkEstimator:
    """Continuous per-link RTT/goodput/loss estimation for one van.

    Thread-safe; every mutator is a few dict/deque operations under one
    lock, cheap enough for the wire hot path (and the whole object is
    absent when ``GEOMX_HEALTH`` is off).
    """

    def __init__(self, id_fn: Callable[[], int], tier: str,
                 window: int = _RTT_WINDOW):
        self._id_fn = id_fn
        self.tier = tier
        self._window = max(4, int(window))
        self._lock = locks.make_lock("LinkEstimator._lock")
        self._links: Dict[int, _LinkStats] = {}
        self._peer_rounds: Dict[int, int] = {}
        self._codec_bytes: Dict[str, int] = {}
        self._round = -1

    def _stats(self, peer: int) -> _LinkStats:
        st = self._links.get(peer)
        if st is None:
            st = _LinkStats()
            st.small = collections.deque(maxlen=self._window)
            self._links[peer] = st
        return st

    # -- feeds (resender acks, TSEngine hops, van wire notes) ------------

    def note_span(self, peer: int, nbytes: int, dt_s: float) -> None:
        """One clean (never-retransmitted) send→ack span to ``peer``."""
        if dt_s <= 0:
            dt_s = 1e-6
        with self._lock:
            st = self._stats(peer)
            if nbytes <= SMALL_FRAME_MAX:
                st.small.append(dt_s)
                st.n_small += 1
                st.rtt_ms = 2e3 * min(st.small)
                st._ewma("rtt_ewma", "rtt_var", 2e3 * dt_s)
                rtt_ms, bw = st.rtt_ms, None
            else:
                rtt_half = min(st.small) if st.small else 0.0
                net = dt_s - rtt_half
                if net <= 0:
                    net = dt_s
                st.big.append(nbytes * 8.0 / net / 1e6)
                st.n_big += 1
                st.bw_mbps = statistics.median(st.big)
                st._ewma("bw_ewma", "bw_var", st.big[-1])
                mb_s = nbytes / dt_s / 1e6
                st.goodput_mb_s += _EWMA_ALPHA * (mb_s - st.goodput_mb_s) \
                    if st.goodput_mb_s else mb_s - st.goodput_mb_s
                rtt_ms, bw = None, st.bw_mbps
        # gauges outside the lock; no-ops when telemetry is off
        src = self._id_fn()
        if rtt_ms is not None:
            telemetry.gauge_set("link.rtt_ms", rtt_ms, src=src, dst=peer,
                                tier=self.tier)
        if bw is not None:
            telemetry.gauge_set("link.bw_mbps", bw, src=src, dst=peer,
                                tier=self.tier)

    def note_retransmit(self, peer: int) -> None:
        with self._lock:
            self._stats(peer).rtx += 1

    def note_give_up(self, peer: int) -> None:
        with self._lock:
            self._stats(peer).give_ups += 1

    def note_sent(self, peer: int, nbytes: int, codec: str,
                  trace_round: int) -> None:
        with self._lock:
            self._codec_bytes[codec] = \
                self._codec_bytes.get(codec, 0) + nbytes
            if trace_round > self._round:
                self._round = trace_round

    def note_recv(self, peer: int, trace_round: int) -> None:
        """Arrival-side round progress: the freshest ``trace_round``
        seen ON frames FROM ``peer`` — the receiver-side skew signal the
        straggler detector runs on (send times are synchronized in FSA
        rounds; arrivals are where stragglers show)."""
        if trace_round < 0:
            return
        with self._lock:
            if trace_round > self._peer_rounds.get(peer, -1):
                self._peer_rounds[peer] = trace_round
            if trace_round > self._round:
                self._round = trace_round

    def note_round(self, round_idx: int) -> None:
        with self._lock:
            if round_idx > self._round:
                self._round = round_idx

    # -- digest ----------------------------------------------------------

    def digest(self, epoch: int = 0) -> dict:
        with self._lock:
            lk = {}
            for peer, st in self._links.items():
                if not (st.n_small or st.n_big or st.rtx or st.give_ups):
                    continue
                lk[str(peer)] = [
                    round(st.rtt_ms, 3), round(st.bw_mbps, 3),
                    round(st.rtt_var, 3), round(st.bw_var, 3),
                    round(st.goodput_mb_s, 3), st.rtx, st.give_ups,
                    st.n_small, st.n_big]
            d = {"v": DIGEST_VERSION, "id": self._id_fn(),
                 "ep": epoch, "rd": self._round}
            if lk:
                d["lk"] = lk
            if self._peer_rounds:
                d["pr"] = {str(p): r
                           for p, r in self._peer_rounds.items()}
            if self._codec_bytes:
                d["cx"] = dict(self._codec_bytes)
        return d

    def digest_json(self, epoch: int = 0) -> str:
        return json.dumps(self.digest(epoch), separators=(",", ":"))


# ---------------------------------------------------------------------------
# scheduler-side board
# ---------------------------------------------------------------------------

@locks.guarded_by("_lock", "version", "_nodes", "_links", "_arrivals",
                  "_max_round", "_exported_round", "_last_progress",
                  "_stall_latched", "_events", "_event_counts")
class ClusterHealthBoard:
    """Aggregates member digests into one versioned board + detectors.

    Single-writer in practice (the scheduler van's receive loop), but
    locked anyway so ``render()`` can be called from a query handler.
    Event emission and file export happen OUTSIDE the lock.
    """

    def __init__(self, tier: str, node_fn: Callable[[], str],
                 out_dir: str = "", *, degrade_factor: float = 0.5,
                 straggler_rounds: int = 1, straggler_persist: int = 3,
                 rtx_burst: int = 5, stall_s: float = 30.0,
                 min_big_samples: int = 4, flightrec=None):
        self.tier = tier
        self.node_fn = node_fn
        self.out_dir = out_dir
        self.degrade_factor = float(degrade_factor)
        self.straggler_rounds = int(straggler_rounds)
        self.straggler_persist = max(1, int(straggler_persist))
        self.rtx_burst = int(rtx_burst)
        self.stall_s = float(stall_s)
        self.min_big_samples = int(min_big_samples)
        self.flightrec = flightrec
        self._lock = locks.make_lock("ClusterHealthBoard._lock")
        self._t0 = time.monotonic()
        self.version = 0
        self._nodes: Dict[int, dict] = {}
        self._links: Dict[Tuple[int, int], dict] = {}
        self._arrivals: Dict[int, int] = {}
        self._max_round = -1
        self._exported_round = -1
        self._last_progress = time.monotonic()
        self._stall_latched = False
        self._events: Deque[dict] = collections.deque(maxlen=64)
        self._event_counts: Dict[str, int] = {}

    # -- ingest ----------------------------------------------------------

    def ingest(self, sender: int, digest_json: str) -> None:
        """Fold one member digest in; runs the detectors; exports the
        board when the cluster round clock advanced."""
        try:
            d = json.loads(digest_json)
        except (ValueError, TypeError):
            return
        if not isinstance(d, dict) or d.get("v") != DIGEST_VERSION:
            return
        now = time.monotonic()
        fired: List[dict] = []
        export_round = None
        with self._lock:
            self.version += 1
            node = self._nodes.setdefault(
                int(d.get("id", sender)),
                {"rd": -1, "ep": 0, "streak": 0, "straggler": False})
            node["last_seen"] = now
            node["ep"] = int(d.get("ep", 0))
            node["rd"] = max(node["rd"], int(d.get("rd", -1)))
            for p, r in (d.get("pr") or {}).items():
                p = int(p)
                if int(r) > self._arrivals.get(p, -1):
                    self._arrivals[p] = int(r)
            if "cx" in d:
                node["cx"] = d["cx"]
            src = int(d.get("id", sender))
            for dst, row in (d.get("lk") or {}).items():
                self._ingest_link(src, int(dst), row, now, fired)
            self._update_progress(now, src, fired)
            if self._max_round > self._exported_round and self.out_dir:
                self._exported_round = self._max_round
                export_round = self._max_round
            for ev in fired:
                self._events.append(ev)
                self._event_counts[ev["kind"]] = \
                    self._event_counts.get(ev["kind"], 0) + 1
        for ev in fired:
            self._emit(ev)
        if export_round is not None:
            self.export(export_round)

    def _ingest_link(self, src: int, dst: int, row: list, now: float,
                     fired: List[dict]) -> None:
        try:
            (rtt_ms, bw, rtt_var, bw_var, gp, rtx, gu, ns, nb) = row
        except (ValueError, TypeError):
            return
        lk = self._links.setdefault(
            (src, dst), {"baseline_bw": None, "baseline_var": 0.0,
                         "healthy_n": 0, "rtx_total": 0,
                         "rtx_win": collections.deque(),
                         "bw_latched": False, "loss_latched": False})
        lk.update(rtt_ms=rtt_ms, bw_mbps=bw, rtt_var=rtt_var,
                  bw_var=bw_var, goodput_mb_s=gp, rtx=rtx, give_ups=gu,
                  n_small=ns, n_big=nb, last_seen=now)
        # loss burst: retransmit delta over a short sliding window
        delta = max(0, rtx - lk["rtx_total"])
        lk["rtx_total"] = max(lk["rtx_total"], rtx)
        win = lk["rtx_win"]
        if delta:
            win.append((now, delta))
        while win and now - win[0][0] > _RTX_WINDOW_S:
            win.popleft()
        burst = sum(n for _, n in win)
        if self.rtx_burst > 0:
            if burst >= self.rtx_burst and not lk["loss_latched"]:
                lk["loss_latched"] = True
                fired.append(self._event("link_degraded", src=src,
                                         dst=dst, cause="loss",
                                         rtx_burst=burst))
            elif burst == 0:
                lk["loss_latched"] = False
        # bandwidth drop against the link's own slow EWMA baseline.
        # The drop must also clear the link's healthy-state noise floor:
        # 2 sigma of the deviations the BOARD has seen between digested
        # medians while the link was keeping up. On an unshaped link —
        # localhost, an idle LAN — the implied bandwidth swings with CPU
        # scheduling, so a ratio test alone latches constantly; the
        # floor learns those swings and stays quiet, while a genuinely
        # squeezed link fires off its small pre-squeeze variance. The
        # estimator's raw-sample variance (bw_var) is NOT used here: its
        # heavy queueing tail spikes it orders of magnitude above the
        # median's real wander. While a drop is suspected the baselines
        # freeze, so a squeeze can't erode its own reference.
        # baseline/floor learning starts from the FIRST big sample so
        # the link is armed before trouble can arrive; FIRING still
        # requires min_big_samples of estimator evidence
        if self.degrade_factor > 0 and nb > 0 and bw > 0:
            base = lk["baseline_bw"]
            noise = 2.0 * (lk["baseline_var"] ** 0.5
                           if lk["baseline_var"] > 0 else 0.0)
            if base is None:
                lk["baseline_bw"] = bw
            elif bw < self.degrade_factor * base:
                # suspected drop: baselines freeze (a squeeze must not
                # erode its own reference or inflate the floor); fire
                # only once armed and past the floor
                if nb >= self.min_big_samples \
                        and base - bw > noise \
                        and lk["healthy_n"] >= _BW_HEALTHY_MIN \
                        and not lk["bw_latched"]:
                    lk["bw_latched"] = True
                    fired.append(self._event(
                        "link_degraded", src=src, dst=dst, cause="bw",
                        bw_mbps=round(bw, 3),
                        baseline_mbps=round(base, 3)))
            else:
                dev = bw - base
                lk["baseline_bw"] = 0.9 * base + 0.1 * bw
                lk["baseline_var"] = \
                    (1.0 - _EWMA_ALPHA) * lk["baseline_var"] \
                    + _EWMA_ALPHA * dev * dev
                lk["healthy_n"] += 1
                if bw >= 0.8 * lk["baseline_bw"]:
                    lk["bw_latched"] = False

    def _update_progress(self, now: float, src: int, fired) -> None:
        prog = {n: max(st["rd"], self._arrivals.get(n, -1))
                for n, st in self._nodes.items()}
        for p, r in self._arrivals.items():
            prog[p] = max(prog.get(p, -1), r)
        if not prog:
            return
        cluster_max = max(prog.values())
        if cluster_max > self._max_round:
            self._max_round = cluster_max
            self._last_progress = now
            self._stall_latched = False
        elif self.stall_s > 0 and self._max_round >= 1 \
                and now - self._last_progress > self.stall_s \
                and not self._stall_latched:
            self._stall_latched = True
            fired.append(self._event(
                "epoch_stall", round=self._max_round,
                stalled_s=round(now - self._last_progress, 1)))
        if self.straggler_rounds <= 0:
            return
        # A node's streak advances only on its OWN digests, so the
        # persistence bar means the same wall-clock duration for every
        # node (persist x its heartbeat interval). Advancing on every
        # digest that merely *mentions* a node would let well-connected
        # nodes (the global server shows up in every party's arrival
        # report) burn through the bar in a fraction of the time.
        node = self._nodes.get(src)
        if node is None:
            return
        p = prog.get(src, -1)
        lag = cluster_max - p
        if p >= 0 and lag < self.straggler_rounds:
            # keeping up (re)arms the detector: a node is only a
            # straggler relative to its own demonstrated parity —
            # the baseline requirement that keeps startup ramp
            # (nodes that have never been current) from firing,
            # mirroring the bw detector's baseline
            node["seen_current"] = True
            node["streak"] = 0
            node["straggler"] = False
        elif p >= 0 and node.get("seen_current"):
            node["streak"] += 1
            if node["streak"] >= self.straggler_persist \
                    and not node["straggler"]:
                node["straggler"] = True
                fired.append(self._event(
                    "straggler", node=src, lag=lag, round=p,
                    cluster_round=cluster_max))
        else:
            node["streak"] = 0
            node["straggler"] = False

    # -- events ----------------------------------------------------------

    def _event(self, kind: str, **fields) -> dict:
        ev = {"t": round(time.monotonic() - self._t0, 3), "kind": kind}
        ev.update(fields)
        return ev

    def _emit(self, ev: dict) -> None:
        fields = {k: v for k, v in ev.items() if k not in ("kind", "t")}
        telemetry.event("health." + ev["kind"], cat="health", **fields)
        LOG.warning("%s %s %s", MARKER, ev["kind"],
                    " ".join(f"{k}={v}" for k, v in fields.items()))
        rec = self.flightrec
        if rec is not None:
            # "anomaly" is the ring-entry kind; the detector that fired
            # rides as a field (record() owns the ``kind`` name)
            rec.record("anomaly", marker=MARKER, anomaly=ev["kind"],
                       **fields)

    # -- render / query / export -----------------------------------------

    def render(self) -> dict:
        now = time.monotonic()
        with self._lock:
            nodes = {}
            for n, st in self._nodes.items():
                row = {"round": st["rd"], "epoch": st["ep"],
                       "age_s": round(now - st.get("last_seen", now), 3),
                       "straggler": st["straggler"]}
                if "cx" in st:
                    row["codec_bytes"] = st["cx"]
                nodes[str(n)] = row
            links = {}
            for (src, dst), lk in self._links.items():
                links[f"{src}>{dst}"] = {
                    k: lk[k] for k in
                    ("rtt_ms", "bw_mbps", "rtt_var", "bw_var",
                     "goodput_mb_s", "rtx", "give_ups", "n_small",
                     "n_big") if k in lk}
                links[f"{src}>{dst}"]["degraded"] = \
                    lk["bw_latched"] or lk["loss_latched"]
            return {
                "v": BOARD_VERSION, "version": self.version,
                "tier": self.tier, "node": self.node_fn(),
                "max_round": self._max_round,
                "arrival_rounds": {str(p): r
                                   for p, r in self._arrivals.items()},
                "nodes": nodes, "links": links,
                "events": list(self._events),
                "event_counts": dict(self._event_counts),
            }

    def render_json(self) -> str:
        return json.dumps(self.render(), separators=(",", ":"))

    def degraded_links(self) -> frozenset:
        """Currently-latched degraded ``(src, dst)`` pairs — the
        transport controller / TSEngine schedule-bias input (the
        ``link_degraded`` detector as an actuator signal, not just an
        alert). Cheap enough for the matchmaking path."""
        with self._lock:
            return frozenset(
                pair for pair, lk in self._links.items()
                if lk["bw_latched"] or lk["loss_latched"])

    def export(self, round_idx: int) -> str:
        """Atomic per-round board export (tmp + rename, same contract
        as telemetry.export_round); never raises."""
        if not self.out_dir:
            return ""
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            doc = self.render_json()
            path = os.path.join(
                self.out_dir,
                f"board_{self.node_fn()}_round{round_idx}.json")
            fd, tmp = tempfile.mkstemp(dir=self.out_dir,
                                       suffix=".tmp.json")
            with os.fdopen(fd, "w") as f:
                f.write(doc)
            os.replace(tmp, path)
            return path
        except OSError:
            return ""
