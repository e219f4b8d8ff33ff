"""TSEngine in the port, against the JAX package.

The scheduler's matchmaking (``ps/tsengine.py`` ``TSScheduler``;
reference: ProcessAskPush/PullCommand, 3rdparty/ps-lite/src/van.cc:
1197-1458) must take the same decisions as the JAX package's for the
same scripted asks, greedy and random alike (its RNG is seeded), and the
intra-DC, inter-DC and combined overlays must give the same HiPS
parameters bit for bit: the port alone, and mixed topologies both ways
(JAX tiers with port workers, port tiers with JAX workers). Integer
gradients keep every merge order exact.
"""

import json

import numpy as np
import pytest

import geomx_tpu.ps.base as jbase
import geomx_tpu.ps.message as jmsg
import geomx_tpu.ps.tsengine as jts
import geomx_tpu_torch.ps.base as tbase
import geomx_tpu_torch.ps.message as tmsg
import geomx_tpu_torch.ps.tsengine as tts
from geomx_tpu import optimizer as jopt
from geomx_tpu_torch import optimizer as topt
from torch_parity_kit import (PORT_LAYOUTS, assert_same, make_topo,
                              run_rounds, worker_pkg)

PKG = {"jax": (jbase, jmsg, jts), "torch": (tbase, tmsg, tts)}
OPT = {"jax": jopt, "torch": topt}


class FakeVan:
    is_global = False

    def __init__(self, dead=()):
        self.sent = []
        self.dead = set(dead)

    def send(self, msg):
        self.sent.append((msg.meta.recver, json.loads(msg.meta.body)))

    def declared_dead_ids(self):
        return frozenset(self.dead)


def _w(r):
    return tbase.worker_rank_to_id(r)


SERVER = tbase.server_rank_to_id(0)

# scenario -> (workers, greed, dead ranks, asks); an ask is (command,
# sender, body). Pushes: nm merged so far, tgt to reach; rep: the
# sender's throughput reports (MB/s to a peer)
SCENARIOS = {
    "push_pairing_to_server": (4, 1.0, (), [
        ("push", _w(0), dict(key=0, off=0, ver=1, nm=1, tgt=4)),
        ("push", _w(1), dict(key=0, off=0, ver=1, nm=1, tgt=4)),
        ("push", _w(2), dict(key=0, off=0, ver=1, nm=1, tgt=4)),
        ("push", _w(3), dict(key=0, off=0, ver=1, nm=1, tgt=4)),
        ("push", _w(1), dict(key=0, off=0, ver=1, nm=2, tgt=4)),
        ("push", _w(3), dict(key=0, off=0, ver=1, nm=2, tgt=4)),
        ("push", _w(3), dict(key=0, off=0, ver=1, nm=4, tgt=4)),
        ("push", _w(1), dict(key=0, off=0, ver=1, nm=4, tgt=4))]),
    "pull_relay_each_once": (3, 0.0, (), [
        ("pull", SERVER, dict(key=5, off=0, ver=2))] * 4),
    "pull_excludes_holder": (2, 1.0, (), [
        ("pull", _w(0), dict(key=1, off=0, ver=1))]),
    "pull_skips_declared_dead": (2, 0.0, (1,), [
        ("pull", SERVER, dict(key=2, off=0, ver=1))] * 2),
    "push_greedy_fat_link": (4, 1.0, (), [
        ("push", _w(0), dict(key=0, off=0, ver=1, nm=1, tgt=4,
                             rep=[[_w(1), 500.0], [_w(2), 2.0],
                                  [_w(3), 2.0]])),
        ("push", _w(1), dict(key=0, off=0, ver=1, nm=1, tgt=4,
                             rep=[[_w(0), 3.0], [_w(2), 2.0]]))]),
    "pull_greedy_measured": (3, 1.0, (), [
        ("pull", SERVER, dict(key=9, off=0, ver=1,
                              rep=[[_w(2), 1000.0], [_w(0), 1.0]]))] * 4),
    # greed 0.5: the seeded RNG picks greedy or random per decision, the
    # same draws in both packages
    "mixed_greed_many_keys": (4, 0.5, (), [
        ("push", _w(r), dict(key=k, off=0, ver=v, nm=1, tgt=4,
                             rep=[[_w((r + 1) % 4), 10.0 * (r + 1)]]))
        for v in (1, 2) for k in (0, 3) for r in range(4)] + [
        ("pull", SERVER, dict(key=k, off=0, ver=1,
                              rep=[[_w(3), 50.0]])) for k in (0, 3)
        for _ in range(5)]),
}


def _decisions(pkg, scenario):
    base, msg, ts = PKG[pkg]
    nw, greed, dead, asks = SCENARIOS[scenario]
    van = FakeVan(dead=[base.worker_rank_to_id(r) for r in dead])
    sched = ts.TSScheduler(van, num_workers=nw, greed_rate=greed)
    cmd = {"push": msg.Control.ASKPUSH, "pull": msg.Control.ASKPULL}
    for kind, sender, body in asks:
        m = msg.Message(msg.Meta(control_cmd=cmd[kind],
                                 body=json.dumps(body)))
        m.meta.sender = sender
        sched.handle(m)
    return van.sent


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_decisions_match_the_jax_package(scenario):
    got = _decisions("torch", scenario)
    assert got and got == _decisions("jax", scenario)


def test_scheduler_reroute_matches_the_jax_package():
    """A degraded link (EWMA decays on every fresh report) stops being
    chosen, in the same step in both packages."""
    picks = {}
    for pkg in PKG:
        sched = PKG[pkg][2].TSScheduler(FakeVan(), num_workers=4,
                                        greed_rate=1.0)
        w = [_w(r) for r in range(4)]
        sched._update_tput(w[0], w[1], 1000.0)
        sched._update_tput(w[2], w[3], 100.0)
        seq = [sched._pick_pair(set(w))]
        for _ in range(8):
            sched._update_tput(w[0], w[1], 1.0)
            seq.append((sched._pick_pair(set(w)),
                        sched.A[(w[0], w[1])]))
        picks[pkg] = seq
    assert picks["torch"] == picks["jax"]
    assert picks["torch"][-1][0] == (_w(2), _w(3))


# overlay -> the Config switches on every node
OVERLAYS = {
    "intra": {"enable_intra_ts": True},
    "inter": {"enable_inter_ts": True},
    "intra_inter": {"enable_intra_ts": True, "enable_inter_ts": True},
}
SIZE, ROUNDS = 24, 3


def _rounds(layout, overlay):
    pkg = worker_pkg(layout)
    w0 = np.arange(SIZE, dtype=np.float32)

    def master(kv):
        kv.set_optimizer(OPT[pkg].SGD(learning_rate=1.0))
        kv.init(0, w0)
        kv.wait()

    def worker(kv, w):
        kv.init(0, w0)
        kv.wait()
        rng = np.random.default_rng(40 + w)
        out = []
        for _ in range(ROUNDS):
            kv.push(0, rng.integers(-3, 4, SIZE).astype(np.float32))
            out.append(kv.pull(0))
            kv.wait()
        return [np.array(o) for o in out]

    topo = make_topo(layout, num_parties=2, workers_per_party=2,
                     extra_cfg=OVERLAYS[overlay])
    return run_rounds(topo, worker, master)


_REF = {}


def _reference(overlay):
    if overlay not in _REF:
        _REF[overlay] = _rounds("jax", overlay)
    return _REF[overlay]


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
@pytest.mark.parametrize("overlay", sorted(OVERLAYS))
def test_ts_hips_rounds_match_the_jax_package(overlay, layout):
    ref = _reference(overlay)
    got = _rounds(layout, overlay)
    assert_same(got, ref)
    for g in got[1:]:
        assert_same([g], [got[0]])
