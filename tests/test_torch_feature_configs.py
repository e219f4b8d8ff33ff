"""The BASELINE.md feature configs through the port, against the JAX package.

Tiers: integer-valued rounds through the port's ``InProcessHiPS`` and the
JAX package's (two parties x one worker) under each setting the feature
configs use: Adam on the global server under FSA (``cnn.py``),
multi-precision fp16 (``cnn_fp16.py``), BSC at 0.25 (``cnn_bsc.py``),
MPQ with a size bound that sends one key to fp16 and the other to BSC
(``cnn_mpq.py``), HFA at K2 = 2 (``cnn_hfa.py``) and ``dist_async`` with
DCASGD (``cnn.py -dc``; the workers take turns, so the asynchronous
global tier sees one order). The parameters the workers pull must be
BIT-IDENTICAL, and identical between the two workers where the tiers are
synchronous. Mixed topologies hold the same rounds: a JAX-package master
shipping the JAX package's Adam to port servers (ROADMAP queue C item 1),
and port workers setting the codecs on JAX-package servers.

Loops: each port example's ``run_worker`` (``cnn.py``, ``cnn_bsc.py``,
``cnn_mpq.py``, ``cnn_hfa.py``, ``cnn_fp16.py``) against the JAX
example's own ``main`` (its ``kv.create`` handed the topology's store)
over a two-party ``InProcessHiPS`` at batch 32, from the JAX package's
initial leaves and the same batches: fp32 within atol = rtol = 1e-5 (the
convolutions sum in other orders), ``cnn_fp16.py``'s bf16 compute within
2e-2. A few Adam steps move each parameter by about the learning rate,
so each leaf's displacement from its initial value is also held to the
JAX example's by relative norm, tightly enough that the JAX loop's own
leaves one step earlier fail the check. ``cnn.py --checkpoint-prefix``
saves and resumes in the port's format.
"""

import functools
import sys
import tempfile
import threading

import numpy as np
import pytest

import examples.cnn as jcnn
import examples.cnn_bsc as jbsc
import examples.cnn_fp16 as jfp16
import examples.cnn_hfa as jhfa
import examples.cnn_mpq as jmpq
import geomx_tpu.kvstore as jkv
import geomx_tpu.simulate as jsim
import geomx_tpu_torch.simulate as tsim
from examples.utils import build_model_and_step as jax_cnn
from geomx_tpu import optimizer as jopt
from geomx_tpu_torch import checkpoint
from geomx_tpu_torch import optimizer as topt
from geomx_tpu_torch.examples import cnn, cnn_bsc, cnn_fp16, cnn_hfa, cnn_mpq
from geomx_tpu_torch.examples import utils as tutils
from geomx_tpu_torch.models.convert import LENET_LEAVES
from test_torch_hips import TIMEOUT, MixedHiPS
from torch_parity_kit import assert_adam_leaves_close, near_eps, record_grads

OPT = {"jax": jopt, "torch": topt}

# ---------------------------------------------------------------------------
# the tiers, on integer-valued rounds
# ---------------------------------------------------------------------------

KEYS = {3: 40, 5: 20_000}       # 20,000 >= kernels_native.MIN_N: native Adam
ROUNDS = 3
MPQ_BOUND = 1_000               # key 3 -> fp16, key 5 -> BSC


def _adam(pkg, kv):
    kv.set_optimizer(OPT[pkg].Adam(learning_rate=0.25))


def _fp16(pkg, kv):
    _adam(pkg, kv)
    kv.set_multi_precision()


SETTINGS = {
    # name: (topology keywords, master's set-up, the rounds' wire form)
    "adam_fsa": ({}, _adam, "push_pull"),
    "fp16_multi_precision": ({}, _fp16, "lists"),
    "bsc": ({}, lambda pkg, kv: kv.set_gradient_compression(
        {"type": "bsc", "threshold": 0.25}), "lists"),
    "mpq": ({}, lambda pkg, kv: kv.set_gradient_compression(
        {"type": "mpq", "threshold": 0.25, "size_lower_bound": MPQ_BOUND}),
        "lists"),
    "hfa_k2_2": ({"use_hfa": True, "hfa_k2": 2}, None, "hfa"),
    "dcasgd_async": ({"sync_global": False}, lambda pkg, kv: kv.set_optimizer(
        OPT[pkg].DCASGD(learning_rate=0.25, momentum=0.5)), "turns"),
}


class _Turns:
    """Worker ``w`` takes round ``r`` at turn ``2 r + w``: one order of
    arrival at the asynchronous global tier, run after run."""

    def __init__(self):
        self.cv = threading.Condition()
        self.turn = 0

    def take(self, t):
        with self.cv:
            if not self.cv.wait_for(lambda: self.turn == t, TIMEOUT):
                raise TimeoutError(f"turn {t} never came")

    def done(self):
        with self.cv:
            self.turn += 1
            self.cv.notify_all()


def _tier_rounds(kv, widx, setting, ready, turns):
    form = SETTINGS[setting][2]
    dt = np.float16 if setting.startswith("fp16") else np.float32
    vals = {k: (np.arange(n) % 7 - 3).astype(dt) for k, n in KEYS.items()}
    for k in KEYS:
        kv.init(k, vals[k])
    for k in KEYS:
        kv.pull(k, out=vals[k])
    kv.wait()
    if not ready.wait(TIMEOUT):
        raise TimeoutError("the master did not finish its set-up")
    rng = np.random.default_rng(10 + widx)
    keys, out = list(KEYS), []
    for r in range(ROUNDS):
        grads = [rng.integers(-8, 9, KEYS[k]).astype(dt) for k in keys]
        bufs = [vals[k] for k in keys]
        if form == "push_pull":
            kv.push_pull(keys, grads, out=bufs)
        elif form == "lists":
            kv.push(keys, grads)
            kv.pull(keys, out=bufs)
        elif form == "hfa":         # weights, as cnn_hfa.py pushes them
            for i, (k, g) in enumerate(zip(keys, grads)):
                kv.push(k, vals[k] + g, priority=-i)
                kv.pull(k, out=vals[k], priority=-i)
        else:
            turns.take(2 * r + widx)
            kv.push_pull(keys, grads, out=bufs)
        kv.wait()
        if form == "turns":
            turns.done()
        out.extend(np.array(b) for b in bufs)
    return out


def _run_tiers(topo, setting, master_pkg):
    master_setup = SETTINGS[setting][1]
    ready, turns, res = threading.Event(), _Turns(), {}
    topo.start()
    try:
        def master(kv):
            if master_setup is not None:
                master_setup(master_pkg, kv)
            dt = np.float16 if setting.startswith("fp16") else np.float32
            for k, n in KEYS.items():
                kv.init(k, (np.arange(n) % 7 - 3).astype(dt))
            kv.wait()
            ready.set()

        def worker(kv):
            w = topo.workers.index(kv)
            res[w] = _tier_rounds(kv, w, setting, ready, turns)

        topo.run_workers(worker, include_master=master, timeout=TIMEOUT)
    finally:
        topo.stop()
    return [res[w] for w in sorted(res)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g_w, r_w in zip(got, want):
        assert len(g_w) == len(r_w)
        for a, b in zip(g_w, r_w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


_REF = {}


def _reference(setting):
    """The all-JAX-package run, once per setting."""
    if setting not in _REF:
        kw = dict(num_parties=2, workers_per_party=1, **SETTINGS[setting][0])
        _REF[setting] = _run_tiers(jsim.InProcessHiPS(**kw), setting, "jax")
    return _REF[setting]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_port_tiers_match_the_jax_package(setting):
    ref = _reference(setting)
    kw = dict(num_parties=2, workers_per_party=1, **SETTINGS[setting][0])
    got = _run_tiers(tsim.InProcessHiPS(**kw), setting, "torch")
    _assert_same(got, ref)
    if setting not in ("dcasgd_async", "hfa_k2_2"):
        # FSA: one global aggregate for both (HFA's parties meet on the
        # global tier every K2 rounds only)
        _assert_same([got[0]], [got[1]])
    # the rounds moved the parameters (or the aggregates) off the init
    assert any(np.abs(a).sum() > 0 for a in got[0])


@pytest.mark.parametrize("sched,server,worker,setting", [
    # a JAX master ships the JAX package's Adam to port servers (C1)
    ("torch", "torch", "jax", "adam_fsa"),
    ("torch", "torch", "jax", "fp16_multi_precision"),
    # port workers (and master) set the codecs on JAX-package servers
    ("jax", "jax", "torch", "bsc"),
    ("jax", "jax", "torch", "mpq"),
    ("jax", "jax", "torch", "fp16_multi_precision"),
])
def test_mixed_topology_matches_the_jax_package(sched, server, worker,
                                                setting):
    ref = _reference(setting)
    topo = MixedHiPS(sched, server, worker, num_parties=2,
                     workers_per_party=1)
    got = _run_tiers(topo, setting, worker)
    _assert_same(got, ref)
    if server == "torch":
        # the port's global server runs the port's twin of what arrived
        updater = topo.servers[0].updater
        assert type(updater).__module__ == "geomx_tpu_torch.optimizer"


# ---------------------------------------------------------------------------
# the examples' loops
# ---------------------------------------------------------------------------

BATCH = 32
# The displacement of all leaves from their initial values, port against
# JAX, by relative norm. fp32: the convolutions sum in other orders (1.5e-5
# measured). bf16: the two frameworks round the bf16 partial sums
# differently, and Adam's first steps move a parameter by about lr
# whatever its gradient's size, so a small gradient that changes sign
# moves it the other way (0.096 measured on a CPU). The JAX loop one step
# short reads 0.30, its steps negated 2.
DISP_TOL = 1e-3
DISP_TOL_BF16 = 0.15
BF16_GRAD_TOL = {"kernel": 1e-2, "bias": 0.1}


@pytest.fixture(scope="module")
def jax_init():
    return jax_cnn(BATCH)[0]


def _topology(pkg, kw):
    sim = jsim if pkg == "jax" else tsim
    kw = {"num_parties": 2, **kw}
    return sim.InProcessHiPS(workers_per_party=1, **kw)


def _master_first(topo, node):
    """``node(kv)`` on the master, then on every party worker at once: the
    master's settings and init reach the global tier before any party
    pulls the initial values, the order the examples' ``time.sleep(1)``
    is there for. (A party's init pull that reaches the global server
    first is answered without the WAN codec, one that comes after with
    it: under MPQ the parties would start from exact or fp16-rounded
    weights as the threads happen to run, in both packages; ROADMAP
    queue C.)"""
    done = threading.Event()

    def master(kv):
        try:
            node(kv)
        finally:
            done.set()

    def worker(kv):
        if not done.wait(TIMEOUT):
            raise TimeoutError("the master did not finish its set-up")
        node(kv)

    topo.run_workers(worker, include_master=master, timeout=TIMEOUT)


def _jax_example(mod, argv, topo_kw, monkeypatch, tmp_path):
    """The JAX example's ``main`` on every node of a JAX-package
    topology (its ``kv.create`` returns the node's store); returns each
    worker's leaves at each of its evaluations, one per iteration."""
    node = threading.local()
    monkeypatch.setattr(jkv, "create", lambda name: node.kv)
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    monkeypatch.setattr(mod, "Measure", functools.partial(
        mod.Measure, log_dir=str(tmp_path)))
    seen, res = {}, {}
    real_eval = mod.eval_acc

    def eval_acc(test_iter, leaves, eval_step):
        seen.setdefault(threading.get_ident(), []).append(
            [np.array(l) for l in leaves])
        return real_eval(test_iter, leaves, eval_step)

    monkeypatch.setattr(mod, "eval_acc", eval_acc)
    topo = _topology("jax", topo_kw).start()
    try:
        def run(kv):
            node.kv = kv
            mod.main()
            if kv is not topo.master:
                res[topo.workers.index(kv)] = seen[threading.get_ident()]

        _master_first(topo, run)
    finally:
        topo.stop()
    return [res[w] for w in sorted(res)]


def _port_example(mod, argv, topo_kw, init_leaves, monkeypatch, tmp_path):
    """The port example's ``run_worker`` on every node of a port
    topology, from ``init_leaves``; returns each worker's result."""
    real = tutils.build_model_and_step
    monkeypatch.setattr(tutils, "build_model_and_step", functools.partial(
        real, init_leaves=init_leaves))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))   # Measure
    res = {}
    topo = _topology("torch", topo_kw).start()
    try:
        def run(kv):
            out = mod.run_worker(kv, mod.parse_args(argv + ["--cpu"]), "cpu")
            if kv is not topo.master:
                res[topo.workers.index(kv)] = out

        _master_first(topo, run)
    finally:
        topo.stop()
    return [res[w] for w in sorted(res)]


EXAMPLES = {
    # name: (port module, JAX module, argv, topology keywords, tolerance
    # of the values, of the displacements' relative norm)
    "cnn": (cnn, jcnn, ["--max-iters", "3"], {}, 1e-5, DISP_TOL),
    "cnn_bsc": (cnn_bsc, jbsc, ["--max-iters", "3"], {}, 1e-5, DISP_TOL),
    "cnn_mpq": (cnn_mpq, jmpq, ["--max-iters", "3"], {}, 1e-5, DISP_TOL),
    "cnn_hfa": (cnn_hfa, jhfa, ["--max-iters", "4"],
                {"use_hfa": True, "hfa_k2": 2}, 1e-5, DISP_TOL),
    "cnn_fp16": (cnn_fp16, jfp16, ["--max-iters", "3"], {}, 2e-2,
                 DISP_TOL_BF16),
}


def _disp_err(got, want, init):
    """||got - want|| / ||want - init|| over all leaves: the error against
    the size of the displacement from ``init``."""
    def flat(leaves):
        return np.concatenate([np.ravel(l).astype(np.float64)
                               for l in leaves])

    want = flat(want)
    return np.linalg.norm(flat(got) - want) / np.linalg.norm(
        want - flat(init))


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_loop_matches_the_jax_example(name, jax_init, monkeypatch,
                                              tmp_path, capsys):
    port_mod, jax_mod, argv, topo_kw, tol, disp_tol = EXAMPLES[name]
    # K1 = 2 (the reference's default); MPQ's bound splits LeNet's keys:
    # Dense_0.kernel and Dense_1.kernel to BSC, the other 8 to fp16
    monkeypatch.setenv("MXNET_KVSTORE_HFA_K1", "2")
    monkeypatch.setenv("MXNET_KVSTORE_SIZE_LOWER_BOUND", "20000")
    argv = argv + ["-bs", str(BATCH)]
    jax_grads = record_grads(jax_mod, monkeypatch)
    want = _jax_example(jax_mod, argv, topo_kw, monkeypatch, tmp_path)
    got = _port_example(port_mod, argv, topo_kw, jax_init, monkeypatch,
                        tmp_path)
    # the leaves the loop starts from: cnn_fp16 pulls them through fp16
    wire = np.float16 if port_mod is cnn_fp16 else np.float32
    init = [l.astype(wire) for l in jax_init]
    # every example steps Adam at lr 1e-3 once an iteration; gradients
    # near Adam's eps take a bound of their own (ROADMAP, divergences)
    near = near_eps(jax_grads)
    for w in (0, 1):
        last, prev = want[w][-1], want[w][-2]
        assert len(got[w]["leaves"]) == len(last) == 10
        for g, r, i in zip(got[w]["leaves"], last, init):
            assert g.dtype == np.float32 and g.shape == r.shape
            assert not np.array_equal(g, i)          # it trained
        assert_adam_leaves_close(got[w]["leaves"], last, near, tol,
                                 lr=1e-3, steps=int(argv[1]))
        assert _disp_err(got[w]["leaves"], last, init) <= disp_tol
        # the check's power: the JAX loop one step earlier, or its steps
        # negated, fail it
        assert _disp_err(prev, last, init) > disp_tol
        assert _disp_err([2 * i - r for i, r in zip(init, last)], last,
                         init) > disp_tol
        assert all(np.isfinite(got[w]["losses"]))
    # FSA (and HFA's synchronized pulls) keep the replicas identical
    for a, b in zip(got[0]["leaves"], got[1]["leaves"]):
        np.testing.assert_array_equal(a, b)
    out = capsys.readouterr().out
    assert f"[Iteration {argv[1]}] Test Acc" in out


def test_bf16_compute_matches_flax(jax_init):
    """``build_model_and_step(compute_dtype=bf16)``, ``cnn_fp16.py``'s
    model: bf16 leaves and inputs, fp32 loss and fp32 gradients, within
    the bf16 tolerance of the flax step with ``compute_dtype=bfloat16``
    from the same leaves."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(4)
    X = rng.random((BATCH, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    _l, _t, jgrad, jeval = jax_cnn(BATCH, compute_dtype=jnp.bfloat16)
    jloss, jgrads = jgrad([jnp.asarray(l) for l in jax_init], X, y)
    _l, _n, tgrad, teval = tutils.build_model_and_step(
        BATCH, compute_dtype=torch.bfloat16, device="cpu",
        init_leaves=jax_init)
    leaves = [torch.tensor(l) for l in jax_init]
    loss, grads = tgrad(leaves, torch.tensor(X), torch.tensor(y))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-2,
                               rtol=2e-2)
    for g, jg, (name, _n, _k) in zip(grads, jgrads, LENET_LEAVES):
        assert g.dtype == torch.float32 and tuple(g.shape) == jg.shape
        g, jg = g.numpy().astype(np.float64), np.asarray(jg, np.float64)
        np.testing.assert_allclose(g, jg, atol=2e-2, rtol=2e-2)
        # each leaf within a share of its own norm: a bias's gradient sums
        # bf16 terms over the batch and the positions that largely cancel
        # (Conv_0.bias 0.042 measured), a kernel's does not (1.5e-3)
        tol = BF16_GRAD_TOL["bias" if name.endswith("bias") else "kernel"]
        assert np.linalg.norm(g - jg) <= tol * np.linalg.norm(jg), name
    assert float(teval(leaves, torch.tensor(X), torch.tensor(y))) == \
        pytest.approx(float(jeval(jax_init, X, y)), abs=2 / BATCH)


def test_checkpoint_save_and_resume(tmp_path, monkeypatch, capsys):
    """``cnn.py --checkpoint-prefix``: one epoch saves
    ``{prefix}-0001.ckpt`` in the port's format; a second run resumes from
    it (the counted iterations go on) and saves epoch 2."""
    prefix = str(tmp_path / "ckpt" / "lenet")
    argv = ["-bs", "256", "--checkpoint-prefix", prefix]   # 8 rounds / epoch
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def train(epochs):
        res = {}
        topo = _topology("torch", {}).start()
        try:
            def run(kv):
                out = cnn.run_worker(kv, cnn.parse_args(
                    argv + ["-ep", str(epochs), "--cpu"]), "cpu")
                if kv is not topo.master:
                    res[topo.workers.index(kv)] = out

            _master_first(topo, run)
        finally:
            topo.stop()
        return res[0]

    first = train(1)
    assert open(f"{prefix}-0001.ckpt", "rb").read(6) == b"GXCK1\n"
    params, _, meta = checkpoint.load_checkpoint(prefix, 1)
    assert meta == {"iters": 8}
    for a, b in zip(params, first["leaves"]):
        np.testing.assert_array_equal(a, b)

    second = train(2)
    out = capsys.readouterr().out
    assert f"Resumed from {prefix}-0001.ckpt (epoch 1, iter 8)." in out
    assert "[Iteration 16] Test Acc" in out and "[Iteration 17]" not in out
    assert checkpoint.latest_checkpoint(prefix) == 2
    params, _, meta = checkpoint.load_checkpoint(prefix, 2)
    assert meta == {"iters": 16} and len(second["losses"]) == 8
    for a, b in zip(params, second["leaves"]):
        np.testing.assert_array_equal(a, b)
