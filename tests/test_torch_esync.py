"""ESync in the port, against the JAX package.

``geomx_tpu_torch/esync.py``: the state server's step-count assignments
for one scripted report sequence (clock injected through ``time_fn``)
must equal the JAX package's, and ``ESyncTrainer`` over a live
``InProcessHiPS`` must run the same rounds: the same local step counts
and the same parameters. The step counts depend on measured times, so
the trainers' reports are fixed per worker and reach the state server in
a fixed order. The port alone and mixed topologies both ways (the
request body is JSON, so a port worker asks a JAX-package state server,
and the reverse). Parameters: identical numpy code on both sides, held
bit for bit. The port's ``examples/cnn_esync.py`` against the JAX
package's on the same inputs and step counts: LeNet's Adam steps in two
frameworks, held within 1e-5 and by the displacement's relative norm.
"""

import functools
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import geomx_tpu.esync as jes
import geomx_tpu_torch.esync as tes
from geomx_tpu import optimizer as jopt
from geomx_tpu_torch import optimizer as topt
from torch_parity_kit import (DEADLINE, PORT_LAYOUTS,
                              assert_adam_leaves_close, assert_same,
                              make_topo, near_eps, record_grads, run_rounds,
                              worker_pkg)

ES = {"jax": jes, "torch": tes}
OPT = {"jax": jopt, "torch": topt}

# (clock s, sender, tau s, c s); live = the membership view where wired
REPORTS = [
    (0.0, 1, 0.1, 0.01), (0.0, 2, 0.01, 0.01), (0.1, 1, 0.1, 0.01),
    (0.2, 3, 0.002, 0.0), (0.3, 2, 0.03, 0.02), (0.4, 3, 1e-9, -1.0),
    (0.5, 1, 0.5, 0.05),
    # sender 2 falls silent: aged out after stale_rounds x reach
    (3.5, 1, 0.2, 0.01), (3.6, 3, 0.01, 0.0), (9.0, 3, 0.02, 0.001),
]


def _assign(pkg, cap, live):
    clock = SimpleNamespace(now=0.0)
    ss = ES[pkg].ESyncStateServer(cap=cap, time_fn=lambda: clock.now,
                                  live_fn=live)
    out = []
    for now, sender, tau, c in REPORTS:
        clock.now = now
        out.append(ss.report(sender, tau, c))
        out.append(ss.live_workers())
    out.append(ss.handle('{"tau": 0.004, "c": 0.001}', 2))
    out.append(ss.handle("{}", 4))
    return out


@pytest.mark.parametrize("cap,live", [
    (32, None), (4, None), (32, lambda: [1, 3]), (8, lambda: [1, 2, 3])])
def test_state_server_assignments_match_the_jax_package(cap, live):
    got = _assign("torch", cap, live)
    assert got == _assign("jax", cap, live)
    assert max(x for x in got if isinstance(x, int)) > 1


class FixedReports:
    """The store of one worker, except that its ESync reports carry a
    fixed ``(tau, c)`` and reach the state server in worker order each
    round (worker 1's k-th report after worker 0's k-th), so both
    packages assign the same step counts whatever the threads' timing.
    Its ``rank`` is the worker's index ``w``: the scheduler numbers the
    workers in the order they register, which the threads' timing
    decides, and the examples take their data slice from the rank."""

    def __init__(self, kv, w, tau, c, turns):
        self._kv, self._w, self._tau, self._c = kv, w, tau, c
        self._turns = turns
        self._n = 0

    @property
    def rank(self):
        return self._w

    def __getattr__(self, name):
        return getattr(self._kv, name)

    def esync_state(self, _tau, _c):
        cv = self._turns
        with cv:
            if not cv.wait_for(lambda: cv.done >= 2 * self._n + self._w,
                               DEADLINE):
                raise TimeoutError("the other worker never reported")
            m = self._kv.esync_state(self._tau, self._c)
            cv.done += 1
            cv.notify_all()
        self._n += 1
        return m


# worker -> (tau, c): worker 0 ten times slower, so worker 1 fills its
# reach time with (11 - 1) / 1 = 10 local steps per round; times large
# enough that no report ages out while the rounds run
TIMES = {0: (10.0, 1.0), 1: (1.0, 1.0)}
TARGET = [np.full((8,), 3.0, np.float32),
          np.linspace(-2.0, 2.0, 5).astype(np.float32)]
ROUNDS = 6


def _trainer_rounds(layout):
    pkg = worker_pkg(layout)
    turns = threading.Condition()
    turns.done = 0

    def grad_fn(leaves, X, y):
        # quadratic bowl: loss = 0.5 * sum((w - target)^2)
        grads = [l - t for l, t in zip(leaves, TARGET)]
        return sum(0.5 * float(np.sum(g * g)) for g in grads), grads

    def master(kv):
        for i, t in enumerate(TARGET):
            kv.init(i, np.zeros_like(t))
        kv.wait()

    def worker(kv, w):
        tr = ES[pkg].ESyncTrainer(
            [np.zeros_like(t) for t in TARGET],
            FixedReports(kv, w, *TIMES[w], turns), grad_fn,
            OPT[pkg].SGD(learning_rate=0.05))
        out, steps = [], []
        for _ in range(ROUNDS):
            steps.append(tr.steps)
            out.append(np.float64(tr.round([(None, None)])))
            out.extend(np.array(l) for l in tr.leaves)
        out.append(np.array(steps))
        return out

    topo = make_topo(layout, num_parties=1, workers_per_party=2)
    return run_rounds(topo, worker, master)


_REF = {}


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
def test_esync_trainer_rounds_match_the_jax_package(layout):
    if "ref" not in _REF:
        _REF["ref"] = _trainer_rounds("jax")
    ref = _REF["ref"]
    got = _trainer_rounds(layout)
    assert_same(got, ref)
    # the fast worker ran 10 local steps a round once both reported
    steps0, steps1 = got[0][-1], got[1][-1]
    assert list(steps0) == [1] * ROUNDS
    assert list(steps1) == [1] + [10] * (ROUNDS - 1)
    # replicas leave every sync identical (model averaging), and the
    # bowl's loss fell; per round: the loss, then the leaves
    per_round = 1 + len(TARGET)
    for r in range(ROUNDS):
        for a, b in zip(got[0][r * per_round + 1:(r + 1) * per_round],
                        got[1][r * per_round + 1:(r + 1) * per_round]):
            np.testing.assert_array_equal(a, b)
    losses = got[1][:-1:per_round]
    assert losses[-1] < losses[0] / 10


# the examples' run: worker 0 twice as slow, so worker 1 runs
# (30 - 10) / 10 = 2 local steps a round once both reported, worker 0 one
EX_TIMES = {0: (20.0, 10.0), 1: (10.0, 10.0)}
EX_ROUNDS, EX_BATCH = 3, 16
# Adam from the same leaves in two frameworks: each leaf within 1e-5, and
# the leaves' distance from the JAX run within DISP_TOL of their
# displacement from init by relative norm (the JAX run one round short
# reads far above it, the check's power)
EX_TOL, DISP_TOL = 1e-5, 1e-3


def _disp_err(got, want, init):
    def flat(leaves):
        return np.concatenate([np.ravel(l).astype(np.float64)
                               for l in leaves])

    want = flat(want)
    return np.linalg.norm(flat(got) - want) / np.linalg.norm(
        want - flat(init))


def _jax_example(monkeypatch):
    """The JAX package's ``examples/cnn_esync.py`` ``main`` on every node
    of a one-party JAX topology, each worker's store under FixedReports;
    returns each worker's leaves and step count after every round."""
    import examples.cnn_esync as jex
    import geomx_tpu.kvstore as jkv

    node = threading.local()
    turns = threading.Condition()
    turns.done = 0
    rounds = {}

    class Recorded(jes.ESyncTrainer):
        def round(self, batches):
            steps = self.steps
            loss = super().round(batches)
            rounds.setdefault(node.w, []).append(
                ([np.array(l) for l in self.leaves], steps))
            return loss

    monkeypatch.setattr(jkv, "create", lambda name: node.kv)
    monkeypatch.setattr(jes, "ESyncTrainer", Recorded)
    monkeypatch.setattr(sys, "argv", [jex.__file__, "-r", str(EX_ROUNDS),
                                      "-bs", str(EX_BATCH)])

    def master(kv):
        node.kv = kv
        jex.main()

    def worker(kv, w):
        node.kv, node.w = FixedReports(kv, w, *EX_TIMES[w], turns), w
        jex.main()

    run_rounds(make_topo("jax", num_parties=1, workers_per_party=2),
               worker, master, deadline=2 * DEADLINE)
    return [rounds[w] for w in (0, 1)]


def _port_example(monkeypatch, init):
    """The port example's ``run_worker`` on a one-party port topology from
    the JAX package's initial leaves, under the same FixedReports."""
    from geomx_tpu_torch.examples import cnn_esync
    from geomx_tpu_torch.examples import utils as tutils

    monkeypatch.setattr(tutils, "build_model_and_step", functools.partial(
        tutils.build_model_and_step, init_leaves=init))
    turns = threading.Condition()
    turns.done = 0
    args = cnn_esync.parse_args(["-r", str(EX_ROUNDS), "-bs", str(EX_BATCH),
                                 "--cpu"])

    def master(kv):
        assert cnn_esync.run_worker(kv, args, "cpu") is None

    return run_rounds(
        make_topo("torch", num_parties=1, workers_per_party=2),
        lambda kv, w: cnn_esync.run_worker(
            FixedReports(kv, w, *EX_TIMES[w], turns), args, "cpu"),
        master, deadline=2 * DEADLINE)


def test_cnn_esync_example_runs_over_port_hips(monkeypatch, capsys):
    """``examples/cnn_esync.py``'s loop (LeNet Adam steps, /n model
    averaging, 8 cycled batches) in the port against the JAX package's
    example on the same inputs and step counts: the same M_i each round,
    the leaves within EX_TOL and their displacement within DISP_TOL;
    both workers leave every sync with the same leaves."""
    from examples.utils import build_model_and_step as jax_cnn

    import examples.cnn_esync as jex

    init = [np.array(l) for l in jax_cnn(EX_BATCH)[0]]
    jax_grads = record_grads(jex, monkeypatch)
    want = _jax_example(monkeypatch)
    got = _port_example(monkeypatch, init)
    near = near_eps(jax_grads)
    for w in (0, 1):
        assert got[w]["steps"] == [s for _l, s in want[w]]
        last, prev = want[w][-1][0], want[w][-2][0]
        assert len(got[w]["leaves"]) == len(last) == 10
        for g, r, i in zip(got[w]["leaves"], last, init):
            assert g.dtype == np.float32 and g.shape == r.shape
            assert not np.array_equal(g, i)          # it trained
        # Adam at lr 1e-3, at most 1 + 2 (EX_ROUNDS - 1) local steps;
        # gradients near its eps bounded apart (ROADMAP, divergences)
        assert_adam_leaves_close(got[w]["leaves"], last, near, EX_TOL,
                                 lr=1e-3, steps=1 + 2 * (EX_ROUNDS - 1))
        assert _disp_err(got[w]["leaves"], last, init) <= DISP_TOL
        # the check's power: the JAX run one round short, or its
        # displacement negated, fail it
        assert _disp_err(prev, last, init) > DISP_TOL
        assert _disp_err([2 * i - r for i, r in zip(init, last)], last,
                         init) > DISP_TOL
        assert all(np.isfinite(got[w]["losses"]))
        assert 0.0 <= got[w]["acc"] <= 1.0
    assert got[0]["steps"] == [1] * EX_ROUNDS
    assert got[1]["steps"] == [1] + [2] * (EX_ROUNDS - 1)
    assert [got[w]["local_steps"] for w in (0, 1)] == [
        EX_ROUNDS, 1 + 2 * (EX_ROUNDS - 1)]
    for a, b in zip(got[0]["leaves"], got[1]["leaves"]):
        np.testing.assert_array_equal(a, b)
    assert "final acc=" in capsys.readouterr().out
