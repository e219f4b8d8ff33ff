"""The port's LeNet, its flax conversion and its data against the JAX
package's.

From the same flax leaves and batch, the port's grad step gives the loss
and the 10 gradient leaves of ``examples/utils.py``'s flax step within
fp32 tolerance (atol 1e-5, rtol 1e-4); the conversion keeps flax's leaf
order (sorted keys, bias before kernel) and layouts (HWIO conv kernels,
``[in, out]`` dense kernels); ``synthetic_mnist`` and ``load_data`` give
the JAX package's arrays bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from examples.utils import build_model_and_step as jax_build
from geomx_tpu.io import datasets as jds
from geomx_tpu_torch.examples.utils import build_model_and_step, eval_acc
from geomx_tpu_torch.io import datasets as tds
from geomx_tpu_torch.models.cnn import create_cnn
from geomx_tpu_torch.models.convert import (LENET_LEAVES, lenet_flax_leaves,
                                            lenet_params_from_flax)

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def jax_cnn():
    return jax_build(16)


def _batch(n=16, seed=3):
    X, y = jds.synthetic_mnist(n, seed=seed)
    return X[..., None], y


def test_leaf_order_and_layouts_match_flax(jax_cnn):
    leaves, treedef, _gs, _es = jax_cnn
    params = jax.tree_util.tree_unflatten(treedef, leaves)["params"]
    names = [f"{layer}.{p}" for layer in sorted(params)
             for p in sorted(params[layer])]
    assert names == [f for f, _n, _k in LENET_LEAVES]
    port = lenet_flax_leaves(create_cnn())
    assert [l.shape for l in port] == [l.shape for l in leaves]
    # flax -> torch -> flax is the identity, and the views are torch's
    # layouts: OIHW convs, [out, in] linears
    tl = [torch.tensor(l) for l in leaves]
    net = create_cnn()
    net.load_state_dict(lenet_params_from_flax(tl))
    for a, b in zip(lenet_flax_leaves(net), leaves):
        np.testing.assert_array_equal(a, b)
    assert tuple(net.conv0.weight.shape) == (16, 1, 5, 5)
    assert tuple(net.dense0.weight.shape) == (256, 512)


def test_loss_and_gradients_match_flax(jax_cnn):
    leaves, _td, jgrad, jeval = jax_cnn
    X, y = _batch()
    jloss, jgrads = jgrad(leaves, X, y)
    tleaves, names, tgrad, teval = build_model_and_step(
        16, device="cpu", init_leaves=leaves)
    assert len(names) == 10
    tl = [torch.tensor(l) for l in tleaves]
    loss, grads = tgrad(tl, torch.tensor(X), torch.tensor(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    assert len(grads) == 10
    for g, jg in zip(grads, jgrads):
        assert tuple(g.shape) == tuple(jg.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL)
    assert float(teval(tl, torch.tensor(X), torch.tensor(y))) == \
        pytest.approx(float(jeval(leaves, X, y)))


def test_eval_acc_and_seeded_init_on_the_cpu():
    leaves, _n, _gs, es = build_model_and_step(8, device="cpu")
    again, *_ = build_model_and_step(8, device="cpu")
    for a, b in zip(leaves, again):
        np.testing.assert_array_equal(a, b)
    assert all(np.all(l == 0) for l in leaves[0::2])   # zero biases
    _tr, test_iter, _a, _b = tds.load_data(64, synthetic_test_size=128)
    acc = eval_acc(test_iter, leaves, es, device="cpu")
    assert 0.0 <= acc <= 1.0
    # a zoo name builds, as in the JAX examples; an unknown one raises
    zoo_leaves, names, _gs, _es = build_model_and_step(
        8, model="resnet18", device="cpu")
    assert len(zoo_leaves) == len(names) == 62
    with pytest.raises(ValueError, match="unknown model"):
        build_model_and_step(8, model="lenet5", device="cpu")


def test_exact_cudnn_only_for_the_card(monkeypatch):
    from geomx_tpu_torch._device import exact_cudnn

    cudnn = torch.backends.cudnn
    # PyTorch's defaults; monkeypatch restores the flags afterwards
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    build_model_and_step(8, device="cpu")
    assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
    exact_cudnn()
    assert (cudnn.allow_tf32, cudnn.deterministic) == (False, True)


@pytest.mark.parametrize("seed,shape", [(7, (28, 28)), (11, (32, 32, 3))])
def test_synthetic_mnist_matches_the_jax_package(seed, shape):
    for a, b in zip(tds.synthetic_mnist(64, seed, shape=shape),
                    jds.synthetic_mnist(64, seed, shape=shape)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_data_matches_the_jax_package(tmp_path):
    kw = dict(num_workers=2, data_slice_idx=1, root=str(tmp_path),
              synthetic_train_size=256, synthetic_test_size=64)
    t_train, t_test, tn, ttn = tds.load_data(32, **kw)
    j_train, j_test, jn, jtn = jds.load_data(32, **kw)
    assert (tn, ttn) == (jn, jtn)
    for ti, ji in ((t_train, j_train), (t_test, j_test)):
        for (tx, ty), (jx, jy) in zip(ti, ji):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
