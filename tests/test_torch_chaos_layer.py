"""The port's chaos layer beside the fault plan: the resender, the wire
sanitizer, the flight recorder, link shaping, the health plane and the
self-tuning transport controller.

Every case of ``tests/test_{resender,sanitizer,flightrec,shaping,
health,controller}.py`` runs on the port (``torch_twin``: the JAX file
with the package name changed; a case keeps its name after
``test_<layer>_``). Where a layer's output is a function of its inputs
and its seed, the two packages are held against each other: the shaped
delivery schedule, the link estimator's digest, the controller's
per-link decisions, the sanitizer's verdicts. Last, a 2-bit combined
wire run under drops and duplicates (resender on) must end on the same
bits as the same run without faults, in both packages: a retransmit
replays the bytes as built and never drains a residual twice.
"""

import json
import types

import numpy as np
import pytest

import geomx_tpu.kvstore.controller as jctrl
import geomx_tpu.ps.linkstate as jlink
import geomx_tpu.ps.sanitizer as jsan
import geomx_tpu.ps.shaping as jshape
import geomx_tpu.simulate as jsim
import geomx_tpu_torch.kvstore.controller as tctrl
import geomx_tpu_torch.ps.linkstate as tlink
import geomx_tpu_torch.ps.sanitizer as tsan
import geomx_tpu_torch.ps.shaping as tshape
import geomx_tpu_torch.simulate as tsim
from torch_parity_kit import within
from torch_twin import export

for _layer in ("resender", "sanitizer", "flightrec", "shaping", "health",
               "controller"):
    export(globals(), f"test_{_layer}", prefix=f"{_layer}_")

# the JAX file's chaos round trip waits out its reorder window through
# the resender's backoff: about 30 s in either package
globals()["test_sanitizer_chaos_push_pull_with_sanitizer_clean"] = \
    pytest.mark.slow(test_sanitizer_chaos_push_pull_with_sanitizer_clean)

PKG = {"jax": types.SimpleNamespace(shape=jshape, link=jlink, ctrl=jctrl,
                                    san=jsan, sim=jsim),
       "torch": types.SimpleNamespace(shape=tshape, link=tlink, ctrl=tctrl,
                                      san=tsan, sim=tsim)}


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.0005
        return self.t


class _ShapeVan:
    def __init__(self, my_id=8, is_global=True):
        import threading
        self.my_id = my_id
        self.is_global = is_global
        self.stopped = threading.Event()
        self.delivered = []

    def _process(self, m):
        self.delivered.append(m)


def _shaped_schedule(pkg, plan, seed):
    P = PKG[pkg].shape
    sh = P.LinkShaper(P.ShapePlan.parse(plan, seed=seed), _ShapeVan(),
                      clock=_Clock())
    for i in range(40):
        m = types.SimpleNamespace(
            meta=types.SimpleNamespace(sender=9 + 2 * (i % 3)),
            is_control=(i % 13 == 4), data=[b"\0" * (1000 + 997 * i)])
        sh.on_inbound(m)
    return list(sh.decision_log)


@pytest.mark.parametrize("plan", [
    '[{"rtt_ms": 30, "bw_mbps": 50, "jitter_ms": 4}]',
    '[{"src": 9, "rtt_ms": 150, "bw_mbps": 20, "jitter_ms": 10},'
    ' {"rtt_ms": 10, "bw_mbps": 1000}]',
    '{"seed": 3, "links": [{"rtt_ms": 60, "bw_mbps": 25, "jitter_ms": 2,'
    ' "control": true}]}',
], ids=["one-link", "two-links", "embedded-seed"])
def test_shaped_schedule_matches_the_jax_package(plan):
    j = _shaped_schedule("jax", plan, 7)
    assert j and _shaped_schedule("torch", plan, 7) == j


def _estimator_digest(pkg, seed):
    L = PKG[pkg].link
    est = L.LinkEstimator(lambda: 9, "global")
    rng = np.random.RandomState(seed)
    for i in range(200):
        peer = int(rng.choice([8, 10, 12]))
        op = rng.randint(5)
        if op == 0:
            est.note_span(peer, int(rng.randint(50, 4000)),
                          float(rng.uniform(0.005, 0.05)))
        elif op == 1:
            est.note_span(peer, int(rng.randint(10_000, 2_000_000)),
                          float(rng.uniform(0.01, 0.5)))
        elif op == 2:
            est.note_retransmit(peer)
        elif op == 3:
            est.note_sent(peer, int(rng.randint(100, 100_000)),
                          str(rng.choice(["", "fp16", "2bit"])),
                          trace_round=i // 10)
        else:
            est.note_recv(peer, trace_round=i // 10)
    return est.digest_json(epoch=3)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_link_estimator_digest_matches_the_jax_package(seed):
    j = json.loads(_estimator_digest("jax", seed))
    assert j["lk"] and json.loads(_estimator_digest("torch", seed)) == j


def _decisions(pkg, seed):
    C = PKG[pkg].ctrl
    k = C.Knobs()
    rng = np.random.RandomState(seed)
    st, out = None, []
    for _ in range(80):
        bw = float(rng.choice([0.0, 5.0, 10.0, 30.0, 60.0, 100.0, 220.0]))
        st, rec = C.step_link(st, bw, float(rng.uniform(1, 200)),
                              int(rng.choice([0, 0, 0, 7])),
                              bool(rng.rand() < 0.05), k)
        out.append((rec["codec"], rec["changed"], rec["reason"]))
    return out


@pytest.mark.parametrize("seed", [5, 6])
def test_controller_decisions_match_the_jax_package(seed):
    j = _decisions("jax", seed)
    assert any(c for c, _, _ in j)
    assert _decisions("torch", seed) == j


class _SanVan:
    my_id = 8

    def declared_dead_ids(self):
        return frozenset({13})

    def is_stale(self, sender, epoch):
        return (sender, epoch) == (11, 1)


def _verdicts(pkg, seed):
    san = PKG[pkg].san.WireSanitizer(_SanVan())
    rng = np.random.RandomState(seed)
    for _ in range(120):
        peer = int(rng.choice([9, 11, 13]))
        meta = types.SimpleNamespace(
            sender=peer, recver=8, app_id=0, customer_id=0,
            timestamp=int(rng.randint(6)), request=bool(rng.rand() < 0.6),
            push=bool(rng.rand() < 0.5), pull=bool(rng.rand() < 0.5),
            simple_app=False, head=0, epoch=int(rng.randint(3)),
            msg_type=0)
        m = types.SimpleNamespace(meta=meta,
                                  is_control=bool(rng.rand() < 0.1))
        if rng.rand() < 0.5:
            san.on_inbound(m)
        else:
            meta.sender, meta.recver = 8, peer
            san.on_send(peer, m)
    return list(san.violations) + san.report()


@pytest.mark.parametrize("seed", [0, 1])
def test_sanitizer_verdicts_match_the_jax_package(seed):
    j = _verdicts("jax", seed)
    assert j and _verdicts("torch", seed) == j


# -- the 2-bit combined wire under drops and duplicates --------------------

THR = 0.1     # low enough that every leg passes most elements
SIZES = [6, 9, 40]
FAULTS = json.dumps({"rules": [{"type": "drop", "p": 0.1},
                               {"type": "dup", "p": 0.05}]})


def _quant_rounds(pkg, faulted, rounds=3):
    extra = {"wire_codec": "2bit", "wire_2bit_threshold": THR,
             "resend": True, "resend_timeout_ms": 150, "ps_seed": 11,
             "wire_sanitizer": True}
    if faulted:
        extra["fault_plan"] = FAULTS
    keys = list(range(len(SIZES)))

    def body():
        topo = PKG[pkg].sim.InProcessHiPS(
            num_parties=2, workers_per_party=1, extra_cfg=extra).start()
        res = {}
        try:
            def master(kv):
                for k, n in zip(keys, SIZES):
                    kv.init(k, np.zeros(n, np.float32))
                kv.wait()

            def worker(kv):
                w = topo.workers.index(kv)
                outs = [np.zeros(n, np.float32) for n in SIZES]
                for k, o in zip(keys, outs):
                    kv.init(k, o.copy())
                    kv.pull(k, out=o)
                kv.wait()
                got = []
                for r in range(rounds):
                    rng = np.random.RandomState(100 * w + r)
                    grads = [rng.uniform(-1, 1, n).astype(np.float32)
                             for n in SIZES]
                    kv.push_pull_async(keys, grads, outs).wait(timeout=40)
                    got.append([o.copy() for o in outs])
                res[w] = got

            topo.run_workers(worker, include_master=master, timeout=50)
            vans = [kv.po.van for kv in topo.workers] + [
                po.van for s in topo.servers
                for po in (s.po_local, s.po_global) if po is not None]
            drops = sum(e[5] == "drop" for v in vans if v._faults
                        for e in v._faults.decision_log)
        finally:
            topo.stop()
        return [res[0], res[1]], drops

    return within(55, body)


@pytest.mark.chaos
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_quant_wire_under_drops_and_dups_equals_the_fault_free_run(pkg):
    clean, _ = _quant_rounds(pkg, faulted=False)
    faulted, drops = _quant_rounds(pkg, faulted=True)
    assert drops > 0, "the plan dropped no frame"
    for a_w, b_w in zip(faulted, clean):
        for a_r, b_r in zip(a_w, b_w):
            for a, b in zip(a_r, b_r):
                np.testing.assert_array_equal(a, b)
    assert any(np.abs(a).sum() > 0 for a in clean[0][-1])
