"""The port's ``get_model`` against the JAX package's, name by name, and
the recurrent models and dropout.

- Every name the JAX ``get_model`` accepts builds in the port, at its
  published width (224 x 224 x 3, 299 x 299 x 3 for InceptionV3, 1,000
  classes; the language models at their defaults), with each ``params``
  and ``batch_stats`` leaf at the flax path and shape that
  ``jax.eval_shape`` of the flax ``init`` gives (traced, never compiled;
  the port's modules are built on the ``meta`` device). Names it refuses,
  the port refuses with the same exception type.
- ``lstm_lm``, ``gru_lm`` and ``rnn_lm`` at a narrow width give flax's
  logits and gradients from carried leaves (float32 within RNN_TOL).
- The port's dropout keeps 1 - rate of the elements, scaled, and draws
  the same masks from the same generator state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.models import get_model as jax_get_model
from geomx_tpu.models import rnn as jrnn
from geomx_tpu_torch.models import convert, layers, rnn
from geomx_tpu_torch.models import get_model

NAMES = (["alexnet"]
         + [f"vgg{d}{bn}" for d in (11, 13, 16, 19) for bn in ("", "_bn")]
         + ["squeezenet1.0", "squeezenet1.1"]
         + [f"mobilenet{m}" for m in ("1.0", "0.75", "0.5", "0.25")]
         + [f"mobilenetv2_{m}" for m in ("1.0", "0.75", "0.5", "0.25")]
         + [f"densenet{d}" for d in (121, 161, 169, 201)]
         + ["inceptionv3"]
         + [f"resnet{d}" for d in (18, 34, 50, 101, 152)]
         + ["resnet50_v1", "lstm_lm", "gru_lm", "rnn_lm"])
RNN_TOL = 1e-5


def _flax_leaves(name):
    jm = jax_get_model(name, num_classes=1000)
    if name.endswith("_lm"):
        x = jnp.zeros((1, 8), jnp.int32)
    else:
        s = 299 if name == "inceptionv3" else 224
        x = jnp.zeros((1, s, s, 3), jnp.float32)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)

    def paths(tree):
        return [(".".join(k.key for k in p), tuple(l.shape)) for p, l in
                jax.tree_util.tree_flatten_with_path(tree)[0]]

    return paths(v["params"]), paths(v.get("batch_stats", {}))


@pytest.mark.parametrize("name", NAMES)
def test_full_width_leaves_match_flax(name):
    want_params, want_stats = _flax_leaves(name)
    with torch.device("meta"):
        tm = get_model(name, num_classes=1000)
    params, bufs = dict(tm.named_parameters()), dict(tm.named_buffers())
    got_params = [(f, tuple(convert._to_flax(params[n], k).shape))
                  for f, n, k in convert.zoo_leaves(tm)]
    got_stats = [(f, tuple(bufs[n].shape)) for f, n in convert.zoo_stats(tm)]
    assert got_params == want_params
    assert got_stats == want_stats
    # every parameter and statistic of the module is one of those leaves
    assert len(got_params) == len(params)
    assert len(got_stats) == len(bufs)


ODD = ["resnet20", "vgg12", "vgg16_bnx", "densenet100", "mobilenetx",
       "mobilenetv2_abc", "inceptionv4", "lenet", "lstm_lmx", "squeezenet",
       "squeezenet2.0"]


@pytest.mark.parametrize("name", ODD)
def test_get_model_refuses_what_the_jax_package_refuses(name):
    try:
        jax_get_model(name, num_classes=10)
        want = None
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        want = type(e)
    if want is None:                # accepted: flax builds lazily
        with torch.device("meta"):
            assert get_model(name, num_classes=10) is not None
    else:
        with torch.device("meta"), pytest.raises(want):
            get_model(name, num_classes=10)


@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_recurrent_models_match_flax(cell):
    jm = jrnn.RNNModel(vocab=32, hidden=16, depth=2, cell_type=cell)
    tm = rnn.RNNModel(vocab=32, hidden=16, depth=2, cell_type=cell,
                      generator=torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(2).integers(0, 32, (3, 7))
    y = np.random.default_rng(3).integers(0, 32, (3, 7))
    variables = convert.flax_variables(tm)
    assert jax.tree_util.tree_structure(variables) == \
        jax.tree_util.tree_structure(dict(jax.eval_shape(
            jm.init, jax.random.PRNGKey(0), jnp.asarray(tokens))))

    def loss_fn(params):
        logits = jm.apply({"params": params}, jnp.asarray(tokens))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], -1)), logits

    (jl, jlog), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    table = convert.zoo_leaves(tm)
    leaves = [torch.tensor(l).requires_grad_(True)
              for l in jax.tree_util.tree_leaves(variables["params"])]
    logits = torch.func.functional_call(
        tm, convert.zoo_params_from_flax(table, leaves),
        (torch.tensor(tokens),))
    assert logits.dtype == torch.float32 and logits.shape == (3, 7, 32)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               rtol=0, atol=RNN_TOL * np.abs(jlog).max())
    loss = -torch.log_softmax(logits, -1).gather(
        -1, torch.tensor(y)[..., None]).mean()
    assert abs(float(loss.detach()) - float(jl)) <= RNN_TOL * abs(float(jl))
    for (path, _n, _k), g, r in zip(table, torch.autograd.grad(loss, leaves),
                                    jax.tree_util.tree_leaves(jg)):
        r = np.asarray(r)
        assert np.linalg.norm(g.numpy() - r) <= RNN_TOL * (
            np.linalg.norm(r) + 1e-3), path


def test_dropout_keeps_and_scales_from_its_generator():
    x = torch.ones(200_000)
    a = layers.dropout(x, 0.5, True, torch.Generator().manual_seed(7))
    b = layers.dropout(x, 0.5, True, torch.Generator().manual_seed(7))
    c = layers.dropout(x, 0.5, True, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert abs(float((a != 0).float().mean()) - 0.5) < 0.01
    assert torch.equal(layers.dropout(x, 0.5, False, None), x)
    with pytest.raises(ValueError, match="Generator"):
        layers.dropout(x, 0.5, True, None)
