"""The port's model zoo against the JAX package's flax modules.

For each family a narrow instance is built from the classes of both
packages; the port's seeded variables are carried out to flax
(``convert.flax_variables``: the tree that flax's ``init`` builds, leaf
for leaf) and into a fresh port module (``load_flax_variables``; exact
both ways). On one seeded batch the flax module runs in float64 (its
``compute_dtype``, under ``jax.enable_x64``) as the reference, and the
port's module:

- in float64 gives the eval-mode logits, the train-mode loss, every
  gradient leaf and the updated ``batch_stats`` within F64_TOL: the
  same function, not merely a close one;
- in float32, as it trains, gives them within F32_TOL (logits, loss),
  GRAD_TOL of each leaf's norm plus GRAD_FLOOR of the whole gradient's
  (a conv bias ahead of a BatchNorm has no gradient, only rounding) and
  STATS_TOL.

The reference is float64 because flax's float32 BatchNorm computes the
batch variance as E[x^2] - E[x]^2: measured on ``resnet_basic``, its
float32 gradients sit up to 5.6e-3 (relative norm, stem BatchNorm bias)
from its own float64 ones, the port's float32 ones within 6.5e-6.
The float32 step runs on torch's own CPU convolutions: oneDNN's, which
torch picks by default on an AVX-512 CPU, gave float32 convolution
gradients up to 2.8e-3 from float64 there (``resnet_bottleneck``, an AMD
EPYC; 5.4e-6 without oneDNN).
Dropout's masks are each framework's own (ROADMAP, divergences), so the
train-mode step runs with dropout off on both sides; the port's dropout
is checked on its own.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.models import resnet as jres
from geomx_tpu.models import zoo as jzoo
from geomx_tpu_torch.models import convert, resnet, zoo

F64_TOL = 1e-9          # float64 port against float64 flax, relative
F32_TOL = 1e-5          # float32 logits and loss, relative to the largest
GRAD_TOL = 1e-4         # a float32 gradient leaf's error over its norm,
GRAD_FLOOR = 1e-6       # plus this share of the whole gradient's norm
STATS_TOL = 1e-5        # float32 batch_stats, atol = rtol


def _family(name):
    """(flax module, port module, input shape HWC) of a narrow instance."""
    g = torch.Generator().manual_seed(0)
    if name.startswith("resnet"):
        block = "Bottleneck" if name.endswith("bottleneck") else "Basic"
        small = "imagenet" not in name
        jb = getattr(jres, block + "Block")
        tb = getattr(resnet, block + "Block")
        shape = (32, 32, 3)
        return (jres.ResNet(stage_sizes=[1, 1], block=jb, num_classes=10,
                            small_images=small),
                resnet.ResNet([1, 1], tb, 10, small, shape, generator=g),
                shape)
    if name == "alexnet":
        shape = (64, 64, 3)
        return (jzoo.AlexNet(num_classes=10),
                zoo.AlexNet(10, shape, generator=g), shape)
    if name.startswith("vgg"):
        bn = name.endswith("_bn")
        shape = (32, 32, 3)
        return (jzoo.VGG(layers=[1, 2], filters=[8, 16], batch_norm=bn,
                         num_classes=10),
                zoo.VGG([1, 2], [8, 16], bn, 10, shape, generator=g), shape)
    if name.startswith("squeezenet"):
        version = name.removeprefix("squeezenet")
        shape = (64, 64, 3)
        return (jzoo.SqueezeNet(version=version, num_classes=10),
                zoo.SqueezeNet(version, 10, shape, generator=g), shape)
    # the mobile nets reduce by 32: an input that leaves a 2 x 2 map
    if name == "mobilenet0.25":
        shape = (64, 64, 3)
        return (jzoo.MobileNetV1(multiplier=0.25, num_classes=10),
                zoo.MobileNetV1(0.25, 10, shape, generator=g), shape)
    if name == "mobilenetv2_0.25":
        shape = (64, 64, 3)
        return (jzoo.MobileNetV2(multiplier=0.25, num_classes=10),
                zoo.MobileNetV2(0.25, 10, shape, generator=g), shape)
    if name == "densenet":
        shape = (32, 32, 3)
        return (jzoo.DenseNet(num_init_features=8, growth_rate=4,
                              block_config=[2, 2], num_classes=10),
                zoo.DenseNet(8, 4, [2, 2], 10, shape, generator=g), shape)
    if name == "inceptionv3":
        shape = (75, 75, 3)
        return (jzoo.InceptionV3(num_classes=10),
                zoo.InceptionV3(10, shape, generator=g), shape)
    raise KeyError(name)


# the mobile nets and InceptionV3 are held in test_torch_zoo_deep.py
FAMILIES = ["resnet_basic", "resnet_bottleneck", "resnet_imagenet_basic",
            "alexnet", "vgg", "vgg_bn", "squeezenet1.0", "squeezenet1.1",
            "densenet"]
BATCH = 4
# families whose float32 train step is chaotic at these sizes: their
# last BatchNorms normalize over a few values, and the gradients' norms
# reach 46 (MobileNetV2) and 1,290 (InceptionV3). Measured against
# float64 at batch 16, flax's own float32 gradients are off by up to
# 0.67 (MobileNetV2, a kernel's error norm) and 62 (InceptionV3), the
# port's by 0.17 and 49. Their train step is held in float64 only, and
# their float32 eval-mode logits, which read the running statistics.
NOISY = {"mobilenetv2_0.25", "inceptionv3"}


def _no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    monkeypatch.setattr(zoo, "dropout", lambda x, *a, **k: x)


def _flax(jm, variables, X, y, dtype=jnp.float64):
    """flax in ``dtype`` (float64 under ``jax.enable_x64``): eval logits,
    train loss, gradient leaves, updated batch_stats leaves."""
    with jax.enable_x64(dtype == jnp.float64):
        jm = jm.clone(compute_dtype=dtype)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                   variables)
        x = jnp.asarray(X, dtype)
        has_bn = "batch_stats" in v

        def loss_fn(params, stats):
            vs = {"params": params, **({"batch_stats": stats} if has_bn
                                       else {})}
            if has_bn:
                logits, upd = jm.apply(vs, x, train=True,
                                       mutable=["batch_stats"])
            else:
                logits, upd = jm.apply(vs, x, train=True), {}
            logp = jax.nn.log_softmax(logits.astype(dtype))
            loss = -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))
            return loss, upd

        @jax.jit
        def both(v):
            return jm.apply(v, x), jax.value_and_grad(loss_fn, has_aux=True)(
                v["params"], v.get("batch_stats", {}))

        logits, ((loss, upd), grads) = both(v)
        f64 = lambda t: [np.asarray(a, np.float64)        # noqa: E731
                         for a in jax.tree_util.tree_leaves(t)]
        return (np.asarray(logits, np.float64), float(loss), f64(grads),
                f64(upd.get("batch_stats", {}) if upd else {}))


def _port(tm, variables, X, y, dtype):
    """The port's module in ``dtype`` from the carried variables: eval
    logits, train loss, gradient leaves (flax layouts), updated
    batch_stats leaves."""
    convert.load_flax_variables(tm, variables)
    tm = tm.to(dtype)
    x = torch.tensor(X, dtype=dtype)
    with torch.no_grad():
        logits = tm(x).double().numpy()
    table = convert.zoo_leaves(tm)
    leaves = [torch.tensor(np.asarray(l), dtype=dtype).requires_grad_(True)
              for l in jax.tree_util.tree_leaves(variables["params"])]
    assert len(leaves) == len(table)
    out = torch.func.functional_call(
        tm, convert.zoo_params_from_flax(table, leaves), (x,),
        {"train": True})
    loss = -torch.log_softmax(out.to(dtype), -1).gather(
        -1, torch.tensor(y).long()[:, None]).mean()
    grads = torch.autograd.grad(loss, leaves)
    bufs = dict(tm.named_buffers())
    return (logits, float(loss.detach()),
            [g.double().numpy() for g in grads],
            [bufs[n].double().numpy() for _f, n in convert.zoo_stats(tm)])


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(
        np.linalg.norm(np.asarray(b, np.float64)), 1e-30)


@pytest.mark.parametrize("family", FAMILIES)
def test_zoo_family_matches_flax(family, monkeypatch):
    check_family(family, monkeypatch)


def check_family(family, monkeypatch):
    """The module docstring's checks for one family."""
    _no_dropout(monkeypatch)
    jm, tm, shape = _family(family)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((BATCH, *shape)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    # the port's seeded init, carried out to flax: the tree flax's init
    # builds, leaf for leaf (traced, not run), and back in exactly
    variables = convert.flax_variables(tm)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(3), jnp.asarray(X))
    assert jax.tree_util.tree_structure(variables) == \
        jax.tree_util.tree_structure(dict(want))
    assert [a.shape for a in jax.tree_util.tree_leaves(variables)] == \
        [a.shape for a in jax.tree_util.tree_leaves(want)]
    _, fresh, _ = _family(family)
    convert.load_flax_variables(fresh, variables)
    for a, b in zip(jax.tree_util.tree_leaves(convert.flax_variables(fresh)),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    r_log, r_loss, r_grads, r_stats = _flax(jm, variables, X, y)
    assert len(r_stats) == len(convert.zoo_stats(tm))
    # float64: the same function
    import copy

    t_log, t_loss, t_grads, t_stats = _port(copy.deepcopy(tm), variables,
                                            X, y, torch.float64)
    assert _rel(t_log, r_log) <= F64_TOL
    assert abs(t_loss - r_loss) <= F64_TOL * abs(r_loss)
    whole = np.sqrt(sum(np.sum(r * r) for r in r_grads))
    for g, r in zip(t_grads, r_grads):
        assert np.linalg.norm(g - r) <= F64_TOL * (np.linalg.norm(r) +
                                                   whole)
    for g, r in zip(t_stats, r_stats):
        np.testing.assert_allclose(g, r, rtol=F64_TOL, atol=1e-14)
    # float32, as the port trains (train mode only where it is not
    # chaotic: see NOISY)
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    t_log, t_loss, t_grads, t_stats = _port(tm, variables, X, y,
                                            torch.float32)
    np.testing.assert_allclose(t_log, r_log, rtol=0,
                               atol=F32_TOL * np.abs(r_log).max())
    if family in NOISY:
        return
    assert abs(t_loss - r_loss) <= F32_TOL * abs(r_loss)
    for (path, _n, _k), g, r in zip(convert.zoo_leaves(tm), t_grads,
                                    r_grads):
        assert g.shape == r.shape, path
        assert np.linalg.norm(g - r) <= GRAD_TOL * np.linalg.norm(r) + \
            GRAD_FLOOR * whole, path
    for g, r in zip(t_stats, r_stats):
        np.testing.assert_allclose(g, r, atol=STATS_TOL, rtol=STATS_TOL)
