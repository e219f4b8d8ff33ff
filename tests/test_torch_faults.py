"""The FaultPlan chaos layer in the port, against the JAX package.

Every case of ``tests/test_faults.py`` runs on the port
(``torch_twin``: the JAX file with the package name changed), and the
two packages must draw the same decisions: one plan and one seed give
the same ``decision_log`` (rule, frame, verdict, delay) and the same
delivery order in both, and ``van_seed`` derives the same per-van seed
from one ``PS_SEED``. A run seeded in one package therefore reproduces
in the other.
"""

import threading
import time
import types

import pytest

import geomx_tpu.config as jcfg
import geomx_tpu.ps.faults as jfaults
import geomx_tpu_torch.config as tcfg
import geomx_tpu_torch.ps.faults as tfaults
from torch_twin import export

export(globals(), "test_faults")

PKGS = {"jax": (jfaults, jcfg), "torch": (tfaults, tcfg)}

PLANS = [
    '[{"type": "drop", "p": 0.5}]',
    '[{"type": "drop", "p": 0.3, "src": 8, "dst": [9, 11]}]',
    '[{"type": "dup", "p": 0.5}]',
    '[{"type": "delay", "delay_s": 0.001, "jitter_s": 0.002, "p": 0.7}]',
    '[{"type": "reorder", "window": 4}]',
    '[{"type": "drop", "p": 0.1}, {"type": "reorder", "window": 3},'
    ' {"type": "dup", "p": 0.05}]',
    '[{"type": "crash", "node": 9, "at": 17, "on": "recv"}]',
]


class _Van:
    """The injector's view of a van: identity, a stop event and the
    re-injection sink."""

    def __init__(self, my_id=9):
        self.my_id = my_id
        self.is_global = False
        self.stopped = threading.Event()
        self.delivered = []

    def _process(self, m):
        self.delivered.append(m.tag)

    def _crash_from_fault(self, reason):
        self.stopped.set()


def _stream(pkg, plan, seed, senders=(8, 10), n=64):
    faults = PKGS[pkg][0]
    van = _Van()
    inj = faults.FaultPlan.parse(plan, seed=seed).bind(van)
    inj.arm()
    verdicts = []
    for i in range(n):
        m = types.SimpleNamespace(
            meta=types.SimpleNamespace(sender=senders[i % len(senders)]),
            is_control=(i % 11 == 5), tag=i)
        verdicts.append(inj.on_inbound(m))
    # delayed frames come back on timers: wait until every one is in
    held = sum(1 for e in inj.decision_log
               if e[5] == "dup" or e[5].startswith("delay:"))
    deadline = time.monotonic() + 5
    while len(van.delivered) < held and time.monotonic() < deadline:
        time.sleep(0.005)
    time.sleep(0.1)     # timers beside the synchronous reorder flushes
    return verdicts, list(inj.decision_log), van.delivered


@pytest.mark.parametrize("seed", [7, 123])
@pytest.mark.parametrize("plan", PLANS, ids=range(len(PLANS)))
def test_same_seed_same_decisions_in_both_packages(plan, seed):
    j_verdicts, j_log, j_deliv = _stream("jax", plan, seed)
    t_verdicts, t_log, t_deliv = _stream("torch", plan, seed)
    assert t_verdicts == j_verdicts
    assert t_log == j_log
    # timers may land in either order; the set and the synchronous
    # reorder flushes must agree
    assert sorted(t_deliv) == sorted(j_deliv)
    if "reorder" in plan and "delay" not in plan and "dup" not in plan:
        assert t_deliv == j_deliv
    assert j_log, "the plan made no decision"


@pytest.mark.parametrize("ps_seed", [0, 7, 2 ** 31 - 1])
def test_van_seed_matches_the_jax_package(ps_seed):
    for role in (0, 1, 2):
        for is_global in (False, True):
            assert tfaults.van_seed(tcfg.Config(ps_seed=ps_seed), role,
                                    is_global) == \
                jfaults.van_seed(jcfg.Config(ps_seed=ps_seed), role,
                                 is_global)


def test_plan_parsing_matches_the_jax_package():
    plan = ('{"seed": 11, "rules": [{"type": "partition", "between": '
            '[8, "*"], "start_s": 1.0, "duration_s": 2.0, "tier": '
            '"global"}, {"type": "crash", "node": 8, "at": 50, "on": '
            '"recv", "tier": "local"}, {"type": "delay", "delay_s": 0.1,'
            ' "jitter_s": 0.05, "p": 0.5, "dst": [9, 11]}]}')
    j = jfaults.FaultPlan.parse(plan)
    t = tfaults.FaultPlan.parse(plan)
    assert t.seed == j.seed == 11
    assert [vars(r) for r in t.rules] == [vars(r) for r in j.rules]
