"""``examples/cnn.py --model resnet18 -dt cifar10`` through the port
against the JAX example.

The port example's ``run_worker`` and the JAX example's ``main`` run two
iterations (batch 4, Adam at lr 1e-3 on the global server) over a live
one-party ``InProcessHiPS`` of their own package, from the JAX example's
initial leaves, and must end on the same 62 parameter leaves: each
coordinate within 1e-5, except those whose gradient came near Adam's
epsilon (``torch_parity_kit.assert_adam_leaves_close``, the method of
the LeNet loops), and the displacement from the initial leaves within
DISP_TOL by relative norm, which the JAX loop one step short fails.

Both loops compute in float64 (``compute_dtype``; the leaves, the wire
and Adam stay float32). In float32 the JAX example's round-1 gradients
sit 0.5% (relative norm, BatchNorm leaves) from the port's: flax's
float32 BatchNorm takes the variance as E[x^2] - E[x]^2, 5.5e-3 from
float64 on ``tests/test_torch_zoo.py``'s ResNet, and Adam turns that into
different steps on 4% of the coordinates. The float32 models are held
against flax in ``tests/test_torch_zoo.py``. The synthetic CIFAR-10
stand-in is cut to 16 training and 4 test images in both packages, so
the per-iteration evaluation stays cheap on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.cnn as jcnn
from geomx_tpu_torch.examples import cnn
from geomx_tpu_torch.examples import utils as tutils
from test_torch_feature_configs import (DISP_TOL, _disp_err, _jax_example,
                                        _port_example)
from torch_parity_kit import assert_adam_leaves_close, near_eps, record_grads

ARGV = ["--max-iters", "2", "-bs", "4", "-m", "resnet18", "-dt", "cifar10"]
SMALL = dict(synthetic_train_size=16, synthetic_test_size=4)
TOPO = {"num_parties": 1}


@pytest.fixture
def x64():
    """64-bit JAX for the test's duration (the JAX loop's float64
    compute); restored after, whatever the outcome."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_resnet18_example_loop_matches_the_jax_example(x64, monkeypatch,
                                                       tmp_path, capsys):
    monkeypatch.setattr(jcnn, "load_data",
                        functools.partial(jcnn.load_data, **SMALL))
    monkeypatch.setattr(tutils, "load_data",
                        functools.partial(tutils.load_data, **SMALL))
    monkeypatch.setattr(jcnn, "build_model_and_step", functools.partial(
        jcnn.build_model_and_step, compute_dtype=jnp.float64))
    monkeypatch.setattr(tutils, "build_model_and_step", functools.partial(
        tutils.build_model_and_step, compute_dtype=torch.float64))
    inits = []
    jax_grads = record_grads(jcnn, monkeypatch, inits)
    want = _jax_example(jcnn, ARGV, TOPO, monkeypatch, tmp_path)
    init = inits[0]
    got = _port_example(cnn, ARGV, TOPO, init, monkeypatch, tmp_path)
    assert len(want) == len(got) == 1
    last, prev = want[0][-1], want[0][-2]
    leaves = got[0]["leaves"]
    assert len(leaves) == len(last) == len(init) == 62
    for g, r, i in zip(leaves, last, init):
        assert g.dtype == np.float32 and g.shape == r.shape
        assert not np.array_equal(g, i)          # it trained
    assert_adam_leaves_close(leaves, last, near_eps(jax_grads), 1e-5,
                             lr=1e-3, steps=2)
    assert _disp_err(leaves, last, init) <= DISP_TOL
    # the check's power: the JAX loop one step short, or its steps
    # negated, fail it
    assert _disp_err(prev, last, init) > DISP_TOL
    assert _disp_err([2 * i - r for i, r in zip(init, last)], last,
                     init) > DISP_TOL
    assert all(np.isfinite(got[0]["losses"]))
    assert "[Iteration 2] Test Acc" in capsys.readouterr().out
