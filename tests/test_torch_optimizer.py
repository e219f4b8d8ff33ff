"""The port's optimizers and lr schedulers against the JAX package's.

``geomx_tpu_torch.optimizer`` and ``geomx_tpu_torch.lr_scheduler`` are
the JAX package's numpy code under the port's imports, so every update
and every schedule must be BIT-IDENTICAL on the same inputs: the cases of
``tests/test_optimizer.py`` (the quadratic bowl for all 14 optimizers,
the per-class formulas, the pickle round trip, the schedulers, DCASGD and
LBSGD), the native kernels' path (SGD and Adam at 16,384 elements and
more), and the optimizer states through the port's checkpoint format.

A pickled JAX-package optimizer unpickles on a port server as the port's
class of the same name, in a process that never imports jax, flax or
``geomx_tpu`` (ROADMAP queue C item 1); any other JAX-package class is
refused.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geomx_tpu import lr_scheduler as jlrs
from geomx_tpu import optimizer as jopt
from geomx_tpu_torch import checkpoint
from geomx_tpu_torch import lr_scheduler as tlrs
from geomx_tpu_torch import optimizer as topt
from geomx_tpu_torch.kvstore import server as tserver
from geomx_tpu_torch.kvstore.local import KVStoreLocal

ROOT = Path(__file__).resolve().parents[1]
ALL_NAMES = sorted(jopt._REGISTRY)
PKGS = {"jax": (jopt, jlrs), "torch": (topt, tlrs)}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_registry_and_factories_match():
    assert sorted(topt._REGISTRY) == ALL_NAMES
    assert [n for n in topt.__all__] == [n for n in jopt.__all__]
    assert sorted(tlrs._REGISTRY) == sorted(jlrs._REGISTRY)
    for name in ALL_NAMES:
        assert type(topt.create(name.upper())).__name__ == \
            type(jopt.create(name)).__name__
    with pytest.raises(KeyError):
        topt.create("nope")


# ---------------------------------------------------------------------------
# the quadratic bowl, every optimizer (tests/test_optimizer.py:31)
# ---------------------------------------------------------------------------

def _bowl(mod, name):
    kw, iters, bound = {"learning_rate": 0.05}, 400, 0.5
    if name in ("adadelta", "adagrad", "ftrl"):
        kw, iters, bound = {"learning_rate": 0.5}, 2000, 0.05
    elif name == "sgld":
        kw, iters, bound = {"learning_rate": 0.002, "seed": 3}, 2000, 1.5
    opt = mod.create(name, **kw)
    w = np.full(64, 5.0, np.float32)
    for _ in range(iters):
        w = np.asarray(opt.update(0, w, w.copy()), np.float32)
    return w, bound


@pytest.mark.parametrize("name", ALL_NAMES)
def test_quadratic_trajectory_is_bit_identical(name):
    want, bound = _bowl(jopt, name)
    got, _ = _bowl(topt, name)
    _same(got, want)
    assert float(np.mean(np.abs(got))) < bound


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_native_kernel_path_is_bit_identical(name):
    """SGD (with momentum) and Adam hand arrays of 16,384 elements or
    more to the native kernels (``kernels_native``), in both packages;
    torch CPU tensors in, numpy out."""
    kw = {"momentum": 0.9} if name == "sgd" else {}
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal(20_000).astype(np.float32)
    grads = [rng.standard_normal(20_000).astype(np.float32)
             for _ in range(4)]
    out = {}
    for pkg, (mod, _) in PKGS.items():
        opt = mod.create(name, learning_rate=0.01, wd=1e-4, **kw)
        w = w0.copy()
        for g in grads:
            if pkg == "torch":
                w = opt.update(0, torch.from_numpy(w), torch.from_numpy(g))
                assert isinstance(w, np.ndarray)
            else:
                w = np.asarray(opt.update(0, w, g))
        out[pkg] = w
    _same(out["torch"], out["jax"])


# ---------------------------------------------------------------------------
# the per-class formulas (tests/test_optimizer.py:52-161)
# ---------------------------------------------------------------------------

def _f32(*x):
    return np.array(x, np.float32)


def _two_steps(cls, kw, w, g, g2=None):
    def run(mod):
        opt = getattr(mod, cls)(**kw)
        w1 = np.asarray(opt.update(0, w, g))
        return [w1, np.asarray(opt.update(0, w1, g if g2 is None else g2))]
    return run


FORMULAS = {
    "nag": _two_steps("NAG", dict(learning_rate=0.1, momentum=0.9),
                      _f32(1.0), _f32(0.5), _f32(0.2)),
    "signum": _two_steps("Signum", dict(learning_rate=0.1, momentum=0.0,
                                        wd_lh=0.1),
                         _f32(2.0, -2.0), _f32(0.003, -7.0)),
    "signum_momentum": _two_steps("Signum", dict(learning_rate=0.1),
                                  _f32(2.0, -2.0), _f32(0.003, -7.0),
                                  _f32(-0.5, 1.0)),
    "adagrad": _two_steps("AdaGrad", dict(learning_rate=0.5, eps=1e-7),
                          _f32(1.0), _f32(2.0)),
    "rmsprop": _two_steps("RMSProp", dict(learning_rate=0.1, gamma1=0.9,
                                          epsilon=1e-8),
                          _f32(1.0), _f32(1.0)),
    "rmsprop_centered": _two_steps(
        "RMSProp", dict(learning_rate=0.1, gamma1=0.9, gamma2=0.9,
                        centered=True, epsilon=1e-8, clip_weights=0.95),
        _f32(1.0), _f32(1.0)),
    "adadelta": _two_steps("AdaDelta", dict(rho=0.9, epsilon=1e-5),
                           _f32(1.0), _f32(2.0)),
    "ftrl": _two_steps("Ftrl", dict(lamda1=1.0, learning_rate=0.1,
                                    beta=1.0),
                       _f32(0.0, 0.0), _f32(0.01, 50.0)),
    "adamax": _two_steps("Adamax", dict(learning_rate=0.002, beta1=0.9,
                                        beta2=0.999),
                         _f32(1.0), _f32(4.0)),
    "nadam": _two_steps("Nadam", dict(learning_rate=0.1, beta1=0.9,
                                      beta2=0.999, epsilon=1e-8),
                        _f32(1.0), _f32(1.0)),
    "ftml": _two_steps("FTML", dict(learning_rate=0.1, beta1=0.6,
                                    beta2=0.999, epsilon=1e-8),
                       _f32(1.0), _f32(2.0)),
    "sgld": _two_steps("SGLD", dict(learning_rate=0.01, seed=7),
                       np.zeros(1000, np.float32),
                       np.zeros(1000, np.float32)),
    "adam_wd_clip_rescale": _two_steps(
        "Adam", dict(learning_rate=0.01, wd=0.1, clip_gradient=0.5,
                     rescale_grad=0.25),
        _f32(1.0, -3.0, 0.5), _f32(4.0, -0.2, 9.0)),
}


@pytest.mark.parametrize("case", sorted(FORMULAS))
def test_formula_is_bit_identical(case):
    for got, want in zip(FORMULAS[case](topt), FORMULAS[case](jopt)):
        _same(got, want)


def test_formulas_hold_on_the_port():
    """Spot checks of the hand formulas of ``tests/test_optimizer.py`` on
    the port's outputs (the bit-identity above carries the rest)."""
    w1, w2 = FORMULAS["nag"](topt)
    np.testing.assert_allclose(w1, 1.0 - 0.1 * (0.5 + 0.9 * 0.5))
    np.testing.assert_allclose(
        w2, w1 - 0.1 * (0.2 + 0.9 * (0.9 * 0.5 + 0.2)), rtol=1e-6)
    out = FORMULAS["ftrl"](topt)[0]
    assert out[0] == 0.0 and out[1] != 0.0
    oa = FORMULAS["sgld"](topt)[0]
    assert 0.05 < float(np.std(oa)) < 0.2


# ---------------------------------------------------------------------------
# pickling and states (tests/test_optimizer.py:176)
# ---------------------------------------------------------------------------

def _five_steps(mod, name, sched=None):
    kw = {"learning_rate": 0.05}
    if sched is not None:
        kw["lr_scheduler"] = sched
    opt = mod.create(name, **kw)
    w = np.full(4, 3.0, np.float32)
    rng = np.random.default_rng(0)
    for _ in range(5):
        w = np.asarray(opt.update(0, w, rng.normal(size=4).astype(
            np.float32)))
    return opt, w


@pytest.mark.parametrize("name", ALL_NAMES)
def test_pickle_round_trip_continues_identically(name):
    opt, w = _five_steps(topt, name)
    jax_opt, jax_w = _five_steps(jopt, name)
    _same(w, jax_w)
    clone = pickle.loads(pickle.dumps(opt))
    assert type(clone) is type(opt)
    g = np.ones(4, np.float32)
    nxt = opt.update(0, w.copy(), g)
    _same(clone.update(0, w.copy(), g), nxt)
    _same(nxt, jax_opt.update(0, jax_w.copy(), g))


@pytest.mark.parametrize("name", ALL_NAMES)
def test_states_round_trip_through_the_port_checkpoint(name, tmp_path):
    """``get_states`` / ``set_states`` through
    ``checkpoint.save_optimizer_states`` / ``load_optimizer_states`` (the
    port's numpy + JSON format): a fresh optimizer with the loaded states
    takes the same next step."""
    opt, w = _five_steps(topt, name)
    fname = str(tmp_path / "opt.states")
    checkpoint.save_optimizer_states(fname, opt)
    assert open(fname, "rb").read(6) == b"GXCK1\n"
    fresh = topt.create(name, learning_rate=0.05)
    checkpoint.load_optimizer_states(fname, fresh)
    assert set(fresh.get_states()) == set(opt.get_states())
    if name == "nadam":                 # its schedule lives on the object
        fresh.m_schedule = opt.m_schedule
    if name == "sgld":                  # so does its noise stream
        fresh._rng = pickle.loads(pickle.dumps(opt._rng))
    fresh._index_update_count = dict(opt._index_update_count)
    fresh.num_update = opt.num_update
    g = np.linspace(-1, 1, 4).astype(np.float32)
    _same(fresh.update(0, w.copy(), g), opt.update(0, w.copy(), g))


def test_local_store_saves_and_loads_optimizer_states(tmp_path):
    """``KVStoreLocal.save_optimizer_states`` / ``load_optimizer_states``
    go through the port's checkpoint; without an optimizer they raise."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    kv = KVStoreLocal()
    with pytest.raises(RuntimeError, match="no optimizer"):
        kv.save_optimizer_states(str(tmp_path / "x"))
    kv.set_optimizer(topt.Adam(learning_rate=0.1))
    kv.init(3, a)
    for _ in range(3):
        kv.push(3, a + 1)
    fname = str(tmp_path / "local.states")
    kv.save_optimizer_states(fname)
    w = np.array(kv.pull(3))

    kv2 = KVStoreLocal()
    kv2.set_optimizer(topt.Adam(learning_rate=0.1))
    kv2.init(3, w)
    kv2.load_optimizer_states(fname)
    kv.push(3, a)
    kv2.push(3, a)
    _same(kv2.pull(3), kv.pull(3))
    assert kv2._optimizer.get_states()[3]["t"] == 4


# ---------------------------------------------------------------------------
# lr schedulers (tests/test_optimizer.py:194-259)
# ---------------------------------------------------------------------------

SCHEDULES = {
    "factor": (lambda m: m.FactorScheduler(step=10, factor=0.1, base_lr=1.0,
                                           stop_factor_lr=1e-3),
               [1, 11, 21, 31, 41, 51, 99]),
    "factor_jump": (lambda m: m.FactorScheduler(step=3, factor=0.5),
                    [0, 2, 40, 41, 7]),
    "multifactor": (lambda m: m.MultiFactorScheduler(step=[5, 8], factor=0.5,
                                                     base_lr=1.0),
                    [5, 6, 8, 9, 100]),
    "poly": (lambda m: m.PolyScheduler(max_update=100, base_lr=1.0, pwr=2,
                                       final_lr=0.1),
             [0, 1, 37, 99, 100, 150]),
    "cosine": (lambda m: m.CosineScheduler(max_update=100, base_lr=1.0,
                                           final_lr=0.0),
               [0, 1, 50, 77, 100, 101]),
    "cosine_warmup": (lambda m: m.CosineScheduler(
        max_update=20, base_lr=1.0, warmup_steps=10, warmup_begin_lr=0.0),
        [0, 5, 9, 10, 15, 20]),
    "poly_constant_warmup": (lambda m: m.PolyScheduler(
        max_update=30, base_lr=0.5, warmup_steps=4, warmup_begin_lr=0.1,
        warmup_mode="constant"), [0, 3, 4, 17, 30]),
    "factory": (lambda m: m.create("cosine", max_update=10),
                [0, 3, 10, 11]),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_is_bit_identical(case):
    make, updates = SCHEDULES[case]
    ts, js = make(tlrs), make(jlrs)
    assert type(ts).__name__ == type(js).__name__
    for nu in updates:
        assert ts(nu) == js(nu), nu


def test_scheduler_values_and_validation():
    s = tlrs.FactorScheduler(step=10, factor=0.1, base_lr=1.0,
                             stop_factor_lr=1e-3)
    assert s(1) == 1.0 and abs(s(11) - 0.1) < 1e-12
    for nu in (21, 31, 41, 51):
        s(nu)
    assert s(99) == 1e-3
    c = tlrs.CosineScheduler(max_update=100, base_lr=1.0, final_lr=0.0)
    assert abs(c(50) - 0.5) < 1e-9
    sched = tlrs.FactorScheduler(step=2)
    assert tlrs.create(sched) is sched
    with pytest.raises(ValueError):
        tlrs.create("nope")
    with pytest.raises(ValueError):
        tlrs.FactorScheduler(step=0)
    with pytest.raises(ValueError):
        tlrs.MultiFactorScheduler(step=[5, 3])


def _scheduled_sgd(mod, lrs):
    sched = lrs.MultiFactorScheduler(step=[2], factor=0.1, base_lr=0.5)
    opt = mod.SGD(learning_rate=0.5, lr_scheduler=sched)
    w, g = np.zeros(1, np.float32), np.ones(1, np.float32)
    for _ in range(3):
        opt.update(0, w, g)
    return opt.update(1, w.copy(), g)


def test_optimizer_uses_scheduler_with_max_key_count():
    out = _scheduled_sgd(topt, tlrs)
    _same(out, _scheduled_sgd(jopt, jlrs))
    np.testing.assert_allclose(out, -0.05, rtol=1e-6)


def test_scheduler_travels_in_pickle():
    opt = topt.SGD(learning_rate=1.0, lr_scheduler=tlrs.FactorScheduler(
        step=1, factor=0.5, base_lr=1.0))
    w, g = np.zeros(1, np.float32), np.ones(1, np.float32)
    for _ in range(3):
        opt.update(0, w, g)
    clone = pickle.loads(pickle.dumps(opt))
    assert type(clone.lr_scheduler) is tlrs.FactorScheduler
    _same(clone.update(0, w.copy(), g), opt.update(0, w.copy(), g))


# ---------------------------------------------------------------------------
# DCASGD and LBSGD (tests/test_optimizer.py:271-333)
# ---------------------------------------------------------------------------

def _dcasgd(mod):
    opt = mod.DCASGD(learning_rate=0.1, lamda=0.04)
    w0, g = _f32(1.0, -2.0), _f32(0.5, 0.5)
    state = opt.create_state(0, w0)
    w1 = opt.step(0, w0, g, state, 0.1)
    prev = state["prev"].copy()
    w2 = opt.step(0, w1, g, state, 0.1)
    mom = mod.DCASGD(learning_rate=0.1, momentum=0.9)
    w3 = np.asarray(mom.update(0, w2, g))
    return [w1, prev, w2, w3, np.asarray(mom.update(0, w3, -g))]


def _lbsgd_macro(mod):
    opt = mod.LBSGD(learning_rate=0.1, batch_scale=3, warmup_epochs=0)
    w = _f32(1.0, 2.0)
    st = opt.create_state(0, w)
    outs = [opt.step(0, w, g, st, 0.1)
            for g in (_f32(0.3, 0.6), _f32(0.6, 0.9), _f32(0.0, 0.3))]
    assert outs[0] is w and outs[1] is w and st["cum"] is None
    return outs


def _lbsgd_warmup(mod):
    out = []
    for strategy in ("linear", "power2", "sqrt", "lars"):
        opt = mod.LBSGD(learning_rate=1.0, batch_scale=8, warmup_epochs=1,
                        updates_per_epoch=16, warmup_strategy=strategy)
        out.append(np.array([opt._lbmult(n) for n in (0, 3, 8, 16, 999)]))
    return out


def _lbsgd_lars(mod):
    opt = mod.LBSGD(learning_rate=0.1, warmup_strategy="lars", wd=0.0)
    w, g = _f32(3.0, 4.0), _f32(0.6, 0.8)
    return [np.array([opt._lars(w, g),
                      opt._lars(w, np.zeros(2, np.float32) + 1e-12),
                      opt._lars(np.zeros(2, np.float32) + 1e-12, g)])]


def _lbsgd_begin_epoch(mod):
    opt = mod.LBSGD(learning_rate=0.1, batch_scale=3, updates_per_epoch=32,
                    begin_epoch=1, warmup_epochs=0, momentum=0.5)
    w = _f32(1.0)
    st = opt.create_state(0, w)
    outs = [np.asarray(opt.step(0, w, _f32(0.3), st, 0.1))
            for _ in range(6)]
    assert np.array_equal(outs[0], w) and not np.array_equal(outs[2], w)
    return outs


SPECIAL = {"dcasgd": _dcasgd, "lbsgd_macro": _lbsgd_macro,
           "lbsgd_warmup": _lbsgd_warmup, "lbsgd_lars": _lbsgd_lars,
           "lbsgd_begin_epoch": _lbsgd_begin_epoch}


@pytest.mark.parametrize("case", sorted(SPECIAL))
def test_dcasgd_and_lbsgd_are_bit_identical(case):
    for got, want in zip(SPECIAL[case](topt), SPECIAL[case](jopt)):
        _same(got, want)


def test_dcasgd_prev_is_pre_update_weight():
    w1, prev, w2, _, _ = _dcasgd(topt)
    np.testing.assert_array_equal(prev, _f32(1.0, -2.0))
    g = _f32(0.5, 0.5)
    np.testing.assert_allclose(
        w2, w1 - 0.1 * (g + 0.04 * g * g * (w1 - prev)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the pickled optimizer across packages (ROADMAP queue C item 1)
# ---------------------------------------------------------------------------

def _jax_adam():
    return jopt.Adam(learning_rate=1e-3, lr_scheduler=jlrs.FactorScheduler(
        step=2, factor=0.5))


def test_jax_adam_unpickles_as_the_port_adam_without_jax(tmp_path):
    """A JAX-package Adam (with a FactorScheduler), pickled as a JAX
    master ships it, loads in a process that never imports ``geomx_tpu``
    through the port server's unpickler: it is the port's Adam, with the
    same hyperparameters and the same next updates, and jax, flax and
    geomx_tpu stay out of ``sys.modules``."""
    blob = tmp_path / "adam.pkl"
    blob.write_bytes(pickle.dumps(_jax_adam()))
    w = np.linspace(-1, 1, 8).astype(np.float32)
    g = np.cos(np.arange(8)).astype(np.float32)
    np.save(tmp_path / "wg.npy", np.stack([w, g]))
    code = f"""
import sys, json
import numpy as np
from geomx_tpu_torch.kvstore.server import _safe_unpickle
opt = _safe_unpickle(open({str(blob)!r}, "rb").read())
hyper = [opt.learning_rate, opt.beta1, opt.beta2, opt.epsilon,
         opt.lr_scheduler.step, opt.lr_scheduler.factor,
         opt.lr_scheduler.base_lr]
w, g = np.load({str(tmp_path / 'wg.npy')!r})
for _ in range(3):
    w = opt.update(0, w, g)
np.save({str(tmp_path / 'out.npy')!r}, w)
print(json.dumps({{
    "cls": type(opt).__module__ + "." + type(opt).__name__,
    "sched": type(opt.lr_scheduler).__module__ + "."
             + type(opt.lr_scheduler).__name__,
    "hyper": hyper,
    "mods": sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "geomx_tpu"))}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    import json

    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["mods"] == []
    assert got["cls"] == "geomx_tpu_torch.optimizer.Adam"
    assert got["sched"] == "geomx_tpu_torch.lr_scheduler.FactorScheduler"
    ref = _jax_adam()
    assert got["hyper"] == [ref.learning_rate, ref.beta1, ref.beta2,
                            ref.epsilon, 2, 0.5, 1e-3]
    want = w
    for _ in range(3):
        want = np.asarray(ref.update(0, want, g))
    _same(np.load(tmp_path / "out.npy"), want)


def test_other_jax_package_classes_are_refused():
    from geomx_tpu.kvstore import server as jserver
    from geomx_tpu.kvstore.base import Command

    port = tserver._safe_unpickle(pickle.dumps(jopt.SGD(momentum=0.9)))
    assert type(port) is topt.SGD and port.momentum == 0.9
    for obj in (Command(), jserver._safe_unpickle):
        with pytest.raises(pickle.UnpicklingError, match="JAX package"):
            tserver._safe_unpickle(pickle.dumps(obj))
