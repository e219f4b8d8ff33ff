"""The port's DeviceResidentTrainer on the CPU through the port's live
HiPS, against the JAX trainer through the JAX package's HiPS.

Two parties x one worker each (``InProcessHiPS``), every byte over real
loopback sockets:

- the quadratic bowl of ``tests/test_trainer_device.py`` over three
  leaves, at threshold 1.0 and 0.25, with the pipelined round
  (``GEOMX_OVERLAP``, one chunk per key) and the serial round: the leaves
  are BIT-IDENTICAL after 10 rounds (the last two through
  ``step_timed``; the losses, reductions summed in other orders, within
  1e-6 relative). Targets and worker shifts are random floats, so no
  two |v| tie at the k-th place (``torch.topk`` and ``jax.lax.top_k``
  break ties differently);
- LeNet for 3 rounds at the main path's threshold (0.02) from the JAX
  package's initial leaves, within fp32
  tolerance (atol 1e-5): the convolutions and products sum in other
  orders;
- a 2-layer, dim-64 transformer for 2 rounds, within the fp32 flash
  tolerance of ``tests/test_torch_transformer.py`` (1e-5 abs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geomx_tpu.simulate as jsim
import geomx_tpu_torch.simulate as tsim
from examples.transformer_bsc_device import \
    build_transformer_grad_step as jax_transformer
from examples.utils import build_model_and_step as jax_cnn
from geomx_tpu.io import datasets as jds
from geomx_tpu.trainer_device import DeviceResidentTrainer as JaxTrainer
from geomx_tpu_torch.examples.transformer_bsc_device import (
    build_transformer_grad_step, synth_batch)
from geomx_tpu_torch.examples.utils import build_model_and_step
from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

TIMEOUT = 60.0                      # per topology
SHAPES = [(2, 4), (3,), (5,)]
_rng = np.random.default_rng(5)
TARGETS = [_rng.standard_normal(s).astype(np.float32) for s in SHAPES]
SHIFTS = (np.float32(0.37), np.float32(-0.61))


def _jax_bowl(leaves, X, y):
    diffs = [w - jnp.asarray(t) + X for w, t in zip(leaves, TARGETS)]
    return 0.5 * sum(jnp.sum(d * d) for d in diffs), diffs


def _torch_bowl(leaves, X, y):
    diffs = [w - torch.from_numpy(t) + X for w, t in zip(leaves, TARGETS)]
    return 0.5 * sum((d * d).sum() for d in diffs), diffs


def _run(pkg, leaves, make_trainer, batches, rounds, timed=0,
         overlap=True, slice_bytes=0):
    """``rounds`` rounds (the last ``timed`` through ``step_timed``) on
    each worker of a 2x1 topology of package ``pkg``; returns each
    worker's leaves, losses and trainer. ``slice_bytes`` is
    P3_SLICE_BYTES (it also slices the dense init pushes, so only tiny
    models take a tiny one)."""
    sim = jsim if pkg == "jax" else tsim
    topo = sim.InProcessHiPS(
        num_parties=2, workers_per_party=1,
        extra_cfg={"overlap": overlap,
                   "p3_slice_bytes": slice_bytes}).start()
    out = {}
    try:
        def master_init(kv):
            for i, leaf in enumerate(leaves):
                kv.init(i, np.array(leaf))
            kv.wait()

        def worker(kv):
            w = topo.workers.index(kv)
            tr = make_trainer([np.array(l) for l in leaves], kv)
            losses = []
            for r in range(rounds):
                X, y = batches[w][r % len(batches[w])]
                if r < rounds - timed:
                    losses.append(float(tr.step(X, y)))
                else:
                    loss, phases = tr.step_timed(X, y)
                    assert set(phases) == {"compute_ms", "d2h_ms",
                                           "wire_ms", "h2d_ms", "apply_ms"}
                    losses.append(float(loss))
            out[w] = (tr.leaves, losses, tr)

        topo.run_workers(worker, include_master=master_init,
                         timeout=TIMEOUT)
    finally:
        topo.stop()
    return out


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["pipelined", "serial"])
@pytest.mark.parametrize("threshold,momentum", [(1.0, 0.0), (0.25, 0.9)])
def test_bowl_is_bit_identical(threshold, momentum, overlap):
    leaves = [np.zeros(s, np.float32) for s in SHAPES]
    kw = dict(threshold=threshold, learning_rate=0.2, momentum=momentum)
    batches = [[(s, None)] for s in SHIFTS]
    ref = _run("jax", leaves, lambda lv, kv: JaxTrainer(
        lv, kv, _jax_bowl, **kw), batches, 10, timed=2, overlap=overlap,
        slice_bytes=8)                  # one chunk per key
    got = _run("torch", leaves, lambda lv, kv: DeviceResidentTrainer(
        lv, kv, _torch_bowl, device="cpu", **kw), batches, 10, timed=2,
        overlap=overlap, slice_bytes=8)
    tr = got[0][2]
    assert tr._pipeline is overlap
    if overlap:
        assert len(tr._chunks) == len(SHAPES)
    for w in (0, 1):
        for a, b in zip(got[w][0], ref[w][0]):
            np.testing.assert_array_equal(a.view(np.int32),
                                          b.view(np.int32))
        # the loss is a reduction XLA orders its own way: not state
        np.testing.assert_allclose(got[w][1], ref[w][1], rtol=1e-6)
    for a, b in zip(got[0][0], got[1][0]):           # FSA lockstep
        np.testing.assert_array_equal(a, b)
    # the bowl moved toward its optimum
    assert np.abs(got[0][0][0] - TARGETS[0]).max() < np.abs(TARGETS[0]).max()


def _mnist_batches(n=16):
    out = []
    for w in (0, 1):
        X, y = jds.synthetic_mnist(3 * n, seed=20 + w)
        out.append([(X[i * n:(i + 1) * n, ..., None], y[i * n:(i + 1) * n])
                    for i in range(3)])
    return out


def test_lenet_three_rounds_match_the_jax_trainer():
    leaves, _td, jgrad, _je = jax_cnn(16)
    _tl, _n, tgrad, _te = build_model_and_step(16, device="cpu",
                                               init_leaves=leaves)
    kw = dict(threshold=0.02, learning_rate=0.05, momentum=0.0)
    batches = _mnist_batches()
    ref = _run("jax", leaves, lambda lv, kv: JaxTrainer(
        lv, kv, jgrad, **kw), batches, 3)
    got = _run("torch", leaves, lambda lv, kv: DeviceResidentTrainer(
        lv, kv, tgrad, device="cpu", **kw), batches, 3)
    for w in (0, 1):
        np.testing.assert_allclose(got[w][1], ref[w][1], atol=1e-5,
                                   rtol=1e-5)
        for a, b in zip(got[w][0], ref[w][0]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for a, b in zip(got[0][0], got[1][0]):
        np.testing.assert_array_equal(a, b)


TDIMS = dict(dim=64, depth=2, heads=2, vocab=64, seq_len=16)


def test_tiny_transformer_two_rounds_match_the_jax_trainer():
    leaves, jgrad = jax_transformer(**TDIMS, compute_dtype=jnp.float32)
    _l, tgrad = build_transformer_grad_step(
        **TDIMS, compute_dtype=torch.float32, device="cpu",
        init_leaves=leaves)
    kw = dict(threshold=1.0, learning_rate=0.05, momentum=0.9)
    batches = []
    for w in (0, 1):
        rng = np.random.default_rng(1234 + w)
        batches.append([(synth_batch(rng, 2, TDIMS["seq_len"],
                                     TDIMS["vocab"]), None)
                        for _ in range(2)])
    jb = [[(jnp.asarray(t), None) for t, _ in b] for b in batches]
    ref = _run("jax", leaves, lambda lv, kv: JaxTrainer(
        lv, kv, jgrad, **kw), jb, 2)
    got = _run("torch", leaves, lambda lv, kv: DeviceResidentTrainer(
        lv, kv, tgrad, device="cpu", **kw), batches, 2)
    for w in (0, 1):
        np.testing.assert_allclose(got[w][1], ref[w][1], atol=1e-5,
                                   rtol=1e-4)
        for a, b in zip(got[w][0], ref[w][0]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
