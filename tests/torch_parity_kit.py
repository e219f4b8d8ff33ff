"""Shared scaffolding of the port-against-JAX topology tests.

One run of a workload through a live ``InProcessHiPS`` in one of four
layouts: the JAX package alone, the port alone, JAX-package schedulers
and servers with the port's workers, and the reverse. Every run sits
under a wall deadline of its own, so a hang fails its test and never
holds the worker process.
"""

import threading
import time

import numpy as np
import pytest

import geomx_tpu.simulate as jsim
import geomx_tpu_torch.simulate as tsim
from test_torch_hips import MixedHiPS

DEADLINE = 60.0         # seconds per topology, start to stop

# layout -> (schedulers, servers, workers and master)
LAYOUTS = {
    "jax": ("jax", "jax", "jax"),
    "torch": ("torch", "torch", "torch"),
    "jax_tiers_torch_workers": ("jax", "jax", "torch"),
    "torch_tiers_jax_workers": ("torch", "torch", "jax"),
}
PORT_LAYOUTS = [l for l in LAYOUTS if l != "jax"]


def make_topo(layout, **kw):
    """An ``InProcessHiPS`` of ``layout`` with the keywords of either
    package's (``extra_cfg`` reaches every node)."""
    if layout == "jax":
        return jsim.InProcessHiPS(**kw)
    if layout == "torch":
        return tsim.InProcessHiPS(**kw)
    return MixedHiPS(*LAYOUTS[layout], **kw)


def worker_pkg(layout):
    return LAYOUTS[layout][2]


def within(seconds, fn, *args):
    """``fn(*args)`` on a daemon thread; the test fails if it has not
    returned after ``seconds``. Re-raises what ``fn`` raised."""
    box, err = [], []

    def run():
        try:
            box.append(fn(*args))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} still running after "
                    f"{seconds} s")
    if err:
        raise err[0]
    return box[0]


def parallel(fns, seconds=DEADLINE):
    """Every ``fn()`` at once on its own thread; fails if any is still
    running after ``seconds`` (one shared deadline), re-raises the first
    error, returns the results in order."""
    out, err = [None] * len(fns), []

    def wrap(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)

    ts = [threading.Thread(target=wrap, args=(i, fn), daemon=True)
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + seconds
    for t in ts:
        t.join(max(deadline - time.monotonic(), 0.0))
    if err:
        raise err[0]
    if any(t.is_alive() for t in ts):
        pytest.fail(f"{sum(t.is_alive() for t in ts)} thread(s) still "
                    f"running after {seconds} s")
    return out


def run_rounds(topo, worker, master=None, deadline=DEADLINE,
               sync_global=True):
    """Start ``topo``, run ``master(kv)`` on the master worker, then
    ``worker(kv, widx)`` on every party worker at once, and stop; the
    whole run under ``deadline``. Returns the workers' results by
    index."""
    def body():
        topo.start(sync_global=sync_global)
        res = {}
        try:
            if master is not None:
                master(topo.master)

            def one(kv):
                w = topo.workers.index(kv)
                res[w] = worker(kv, w)

            topo.run_workers(one, timeout=deadline)
        finally:
            topo.stop()
        return [res[w] for w in sorted(res)]

    return within(deadline, body)


def assert_same(got, want):
    """Lists (per worker) of arrays, bit for bit."""
    assert len(got) == len(want)
    for g_w, r_w in zip(got, want):
        assert len(g_w) == len(r_w)
        for a, b in zip(g_w, r_w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# -- Adam from the same leaves in two frameworks ----------------------------

# Adam's epsilon in the examples (the optimizers' default)
ADAM_EPS = 1e-8
# a gradient this close to zero, yet not zero, leaves Adam's first steps
# m / (sqrt(v) + eps) at the mercy of its last bits: the two frameworks'
# float reorderings (about 1e-7 of a leaf's largest gradient) move such a
# step by a few percent of the learning rate
NEAR_EPS = 100 * ADAM_EPS
# at most this share of a run's coordinates may be near eps, or the
# per-coordinate bound would carry the check
NEAR_EPS_SHARE = 1e-2


def record_grads(mod, monkeypatch, inits=None):
    """Keep every gradient list that the grad_step of the JAX example
    module ``mod``'s ``build_model_and_step`` returns (all workers, all
    rounds), as numpy arrays, in the list this returns; and each built
    leaf list in ``inits``, when given."""
    real, kept, lock = mod.build_model_and_step, [], threading.Lock()

    def build(*args, **kw):
        leaves, treedef, grad_step, eval_step = real(*args, **kw)
        if inits is not None:
            inits.append([np.array(l) for l in leaves])

        def step(*step_args):
            loss, grads = grad_step(*step_args)
            with lock:
                kept.append([np.array(g) for g in grads])
            return loss, grads

        return leaves, treedef, step, eval_step

    monkeypatch.setattr(mod, "build_model_and_step", build)
    return kept


def near_eps(grads):
    """Per leaf, the coordinates whose gradient was non-zero and below
    NEAR_EPS in any of the recorded ``grads`` (a list of leaf lists).
    A gradient that is exactly zero (a dead ReLU) is zero in both
    frameworks and is no such coordinate."""
    out = []
    for per_leaf in zip(*grads):
        a = np.abs(np.stack(per_leaf))
        out.append(((a > 0) & (a < NEAR_EPS)).any(axis=0))
    return out


def assert_adam_leaves_close(got, want, near, tol, lr, steps, names=None):
    """``got`` against ``want`` leaf by leaf: every coordinate within
    ``tol`` (atol = rtol), except those in ``near`` (see ``near_eps``),
    which may differ by what ``steps`` Adam steps can move a coordinate,
    lr each, and by no more. No leaf is bounded as a whole. ``names``
    label the leaves in a failure."""
    total = sum(int(m.size) for m in near)
    assert sum(int(m.sum()) for m in near) <= NEAR_EPS_SHARE * total
    for i, (g, r, m) in enumerate(zip(got, want, near)):
        name = "" if names is None else names[i]
        np.testing.assert_allclose(g[~m], r[~m], atol=tol, rtol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(g[m], r[m], rtol=0,
                                   atol=max(tol, lr * steps), err_msg=name)
