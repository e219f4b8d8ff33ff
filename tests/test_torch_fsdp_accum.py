"""geomx_tpu_torch FSDP and gradient accumulation vs the JAX package.

``fsdp_spec`` is held against the JAX rule over a table of shapes (JAX's
own five cases among them) on the 8-device virtual CPU mesh;
``FSDPTrainer`` (each leaf kept as its dp shards, rank-stacked) against
the JAX package's ``FSDPTrainer`` on LeNet from the same init and
batches (losses within 2e-4, as the JAX package's test holds its pair;
final leaves by their displacement), and against the port's replicated
``DataParallelTrainer`` within 2e-4; its ``param_shard_fraction``
against the JAX trainer's. ``accumulate_gradients`` against the JAX
function on the same numpy data (values, errors, the parameter dtype
kept, the dp mean over rank-stacked batches); remat against no remat.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geomx_tpu.compat import shard_map
from geomx_tpu.models import create_cnn as jax_create_cnn
from geomx_tpu.parallel.fsdp import FSDPTrainer as JaxFSDPTrainer
from geomx_tpu.parallel.fsdp import fsdp_spec as jax_fsdp_spec
from geomx_tpu.parallel.grad_accum import (
    accumulate_gradients as jax_accumulate)
from geomx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from geomx_tpu_torch.io import load_data
from geomx_tpu_torch.models import create_cnn
from geomx_tpu_torch.models.convert import (lenet_flax_leaves,
                                            lenet_params_from_flax)
from geomx_tpu_torch.models.transformer import Transformer
from geomx_tpu_torch.parallel.fsdp import (FSDPTrainer, fsdp_shardings,
                                           fsdp_spec)
from geomx_tpu_torch.parallel.grad_accum import accumulate_gradients
from geomx_tpu_torch.parallel.mesh import make_mesh
from geomx_tpu_torch.parallel.train_step import DataParallelTrainer

SHAPES = [(16, 3), (3, 24), (5, 3), (), (8, 800), (8,), (7,), (16, 16),
          (4, 8, 16), (5, 5, 1, 16), (32, 16, 5, 5), (2, 3, 5), (800, 8),
          (24, 24, 8)]


@pytest.mark.parametrize("dp", [8, 4, 1])
def test_fsdp_spec_matches_jax(dp):
    jmesh = jax_make_mesh(jax.devices()[:dp])
    mesh = make_mesh(dp, device="cpu")
    for shape in SHAPES:
        assert fsdp_spec(shape, mesh) == tuple(jax_fsdp_spec(shape, jmesh)), \
            shape
    if dp == 8:   # the JAX package's own cases
        assert fsdp_spec((16, 3), mesh) == ("dp", None)
        assert fsdp_spec((3, 24), mesh) == (None, "dp")
        assert fsdp_spec((5, 3), mesh) == ()
        assert fsdp_spec((), mesh) == ()
        assert fsdp_spec((8, 800), mesh) == (None, "dp")
    tree = {"w": torch.zeros(16, 3), "b": [torch.zeros(7)]}
    assert fsdp_shardings(tree, mesh) == {
        "w": fsdp_spec((16, 3), mesh), "b": [()]}


def test_fsdp_trainer_matches_data_parallel():
    """The port's FSDP trainer against the JAX package's, stepped on the
    same batches from the JAX init (losses and final leaves within 2e-4),
    and against the port's replicated ``DataParallelTrainer``."""
    jtr = JaxFSDPTrainer(jax_create_cnn(), optax.adam(3e-3),
                         jax_make_mesh(jax.devices()),
                         jnp.zeros((1, 28, 28, 1), jnp.float32))
    init = [torch.tensor(np.asarray(l))
            for l in jax.tree_util.tree_leaves(jtr.params)]
    mesh = make_mesh(8, device="cpu")
    model = create_cnn()
    model.load_state_dict(lenet_params_from_flax(init))
    replica = copy.deepcopy(model)
    fsdp = FSDPTrainer(model, functools.partial(torch.optim.Adam, lr=3e-3),
                       mesh)
    repl = DataParallelTrainer(replica, torch.optim.Adam(
        replica.parameters(), lr=3e-3), mesh)
    frac = fsdp.param_shard_fraction()
    assert frac < 0.6
    # the JAX trainer on the same layout reads the same fraction (the
    # port's LeNet keeps torch layouts, with the same axes in another
    # order, so the same leaves split)
    assert frac == pytest.approx(jtr.param_shard_fraction(), abs=1e-12)
    train_iter, _, _, _ = load_data(64, num_workers=1)
    l_f, l_r, l_j = [], [], []
    for i, (X, y) in enumerate(train_iter):
        l_f.append(fsdp.step(X, y))
        l_r.append(repl.step(X, y))
        l_j.append(jtr.step(np.asarray(X), np.asarray(y)))
        if i >= 10:
            break
    np.testing.assert_allclose(l_f, l_j, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(l_f, l_r, rtol=2e-4, atol=2e-4)
    assert l_f[-1] < l_f[0]
    # final leaves by the relative norm of their difference to the JAX
    # run's displacement from the init (at most 3.4e-4 measured): Adam
    # turns a few near-zero gradients' rounding into steps of up to lr / 6
    # (elementwise, 3 of 170k elements lie beyond 2e-4, by 5.0e-4 at most)
    net = create_cnn()
    net.load_state_dict({n: s.full().detach()
                         for n, s in fsdp.params.items()})
    for got, want, start in zip(lenet_flax_leaves(net),
                                jax.tree_util.tree_leaves(jtr.params),
                                init):
        want, start = np.asarray(want), start.numpy()
        assert np.linalg.norm(got - want) <= \
            1e-3 * np.linalg.norm(want - start), got.shape
    for name, p in replica.named_parameters():
        np.testing.assert_allclose(fsdp.params[name].full().detach().numpy(),
                                   p.detach().numpy(), rtol=2e-4, atol=2e-4)
    # the optimizer state lives on the shards, split like them
    shards = [s.shards for s in fsdp.params.values()]
    assert [fsdp.optimizer.state[t]["exp_avg"].shape for t in shards] == \
        [t.shape for t in shards]


def _lsq_jax(params, X, y):
    return jax.value_and_grad(lambda p: jnp.mean((X @ p - y) ** 2))(params)


def _lsq_torch(params, X, y):
    p = params.detach().requires_grad_()
    loss = torch.mean((X @ p - y) ** 2)
    return loss.detach(), torch.autograd.grad(loss, p)[0]


def test_accumulate_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.normal(size=(6,)).astype(np.float32)
    X = rng.normal(size=(12, 6)).astype(np.float32)
    y = rng.normal(size=(12,)).astype(np.float32)
    for m in (1, 2, 3, 4, 6):
        jl, jg = jax.jit(jax_accumulate(_lsq_jax, m))(
            jnp.asarray(w), jnp.asarray(X), jnp.asarray(y))
        tl, tg = accumulate_gradients(_lsq_torch, m)(
            torch.tensor(w), torch.tensor(X), torch.tensor(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)
    # pytrees of parameters: a list of leaves in, a list of grads out
    def pair(params, X, y):
        a, b = (p.detach().requires_grad_() for p in params)
        loss = torch.mean((X @ a + b - y) ** 2)
        return loss.detach(), list(torch.autograd.grad(loss, (a, b)))

    tl, (ga, gb) = accumulate_gradients(pair, 3)(
        [torch.tensor(w), torch.tensor(0.5)], torch.tensor(X),
        torch.tensor(y))
    assert ga.shape == (6,) and gb.shape == ()


def test_accumulate_errors_match_jax():
    def grad_fn(p, X, y):
        return torch.tensor(0.0), p

    for fn in (jax_accumulate, accumulate_gradients):
        with pytest.raises(ValueError, match=">= 1"):
            fn(grad_fn, 0)
    with pytest.raises(ValueError, match="divisible") as terr:
        accumulate_gradients(grad_fn, 5)(torch.zeros(3), torch.zeros(12, 2),
                                         torch.zeros(12))
    with pytest.raises(ValueError, match="divisible") as jerr:
        jax_accumulate(lambda p, X, y: (jnp.float32(0), p), 5)(
            jnp.zeros(3), jnp.zeros((12, 2)), jnp.zeros(12))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="at least one batch"):
        accumulate_gradients(grad_fn, 2)(torch.zeros(3))


def test_accumulate_keeps_param_dtype():
    def grad_fn(p, X):   # X-only loss: no labels needed
        q = p.detach().requires_grad_()
        loss = torch.mean((X @ q.float()) ** 2)
        return loss.detach(), torch.autograd.grad(loss, q)[0]

    loss, grad = accumulate_gradients(grad_fn, 4)(
        torch.ones(4, dtype=torch.bfloat16), torch.ones(8, 4))
    assert grad.dtype == torch.bfloat16
    assert np.isfinite(float(loss))


def test_accumulate_dp_mean_matches_jax_pmean():
    """``axis_name``: the JAX pmean over dp of each rank's accumulated
    mean, with the batch rank-stacked in the port."""
    rng = np.random.RandomState(1)
    w = rng.normal(size=(4,)).astype(np.float32)
    X = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.normal(size=(16,)).astype(np.float32)
    from jax.sharding import PartitionSpec as P

    jfn = jax.jit(shard_map(
        jax_accumulate(_lsq_jax, 2, axis_name="dp"),
        mesh=jax_make_mesh(jax.devices()),
        in_specs=(P(), P("dp"), P("dp")), out_specs=(P(), P()),
        check_vma=False))
    jl, jg = jfn(jnp.asarray(w), jnp.asarray(X), jnp.asarray(y))
    tl, tg = accumulate_gradients(_lsq_torch, 2, axis_name="dp")(
        torch.tensor(w), torch.tensor(X).reshape(8, 2, 4),
        torch.tensor(y).reshape(8, 2))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("moe", [0, 2])
def test_remat_same_values(moe):
    """Rematerialised blocks (``torch.utils.checkpoint``) give the same
    logits, MoE aux losses and gradients as stored activations."""
    tok = torch.as_tensor(np.random.RandomState(0).randint(0, 64, (2, 16)))
    outs = []
    for remat in (False, True):
        model = Transformer(vocab=64, dim=32, depth=2, heads=2, max_len=32,
                            moe_experts=moe, remat=remat,
                            generator=torch.Generator().manual_seed(1))
        logits, aux = model(tok, return_aux=True)
        loss = (logits ** 2).mean() + sum(aux, torch.tensor(0.0))
        outs.append((logits, aux, torch.autograd.grad(
            loss, list(model.parameters()))))
    (l0, a0, g0), (l1, a1, g1) = outs
    assert torch.equal(l0, l1)
    assert len(a0) == len(a1) == (2 if moe else 0)
    for a, b in zip(a0, a1):
        assert torch.equal(a, b)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
