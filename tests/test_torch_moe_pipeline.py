"""geomx_tpu_torch MoE block, layout rules and GPipe pipeline vs the JAX
package.

The flax MoE block's (and MoE transformer's) initial parameters go
across through ``geomx_tpu_torch.models.convert``; the same numpy input
then goes through both, and output, aux loss and every gradient must
agree (fp32, 1e-5). The layout rules (Megatron tp, experts over ep) are
compared as tuples with the specs the JAX package's ``device_put``
leaves on every parameter of a MoE transformer. The pipeline runs the
JAX schedule on the 8-device virtual CPU mesh and the port's on stacked
stage rows; both against the stages applied in sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.models.moe import MoEBlock as FlaxMoEBlock
from geomx_tpu.models.moe import moe_param_sharding as jax_moe_sharding
from geomx_tpu.models.transformer import Transformer as FlaxTransformer
from geomx_tpu.models.transformer import (
    transformer_param_sharding as jax_tf_sharding)
from geomx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from geomx_tpu.parallel.pipeline import make_pipeline_fn as jax_pipeline
from geomx_tpu_torch.models import convert
from geomx_tpu_torch.models.moe import MoEBlock, moe_param_sharding
from geomx_tpu_torch.models.transformer import (
    Transformer, transformer_param_sharding)
from geomx_tpu_torch.parallel.mesh import make_mesh
from geomx_tpu_torch.parallel.pipeline import make_pipeline_fn

TOL = 1e-5
MOE_TF = dict(vocab=64, dim=16, depth=2, heads=2, moe_experts=4)


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k.key) for k in path), np.asarray(leaf))
            for path, leaf in flat]


def test_moe_block_matches_flax():
    dim, E = 16, 4
    x = np.random.RandomState(0).normal(size=(4, 6, dim)).astype(np.float32)
    fmodel = FlaxMoEBlock(dim=dim, num_experts=E)
    variables = {"params": fmodel.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x))["params"]}
    leaves, treedef = jax.tree_util.tree_flatten(variables)

    def loss_fn(lv, x):
        out, state = fmodel.apply(jax.tree_util.tree_unflatten(treedef, lv),
                                  x, mutable=["losses"])
        aux = state["losses"]["moe_aux"][0]
        return jnp.sum(out * jnp.cos(out)) + aux, (out, aux)

    (_, (jout, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(leaves, jnp.asarray(x))

    model = MoEBlock(dim, num_experts=E)
    names = convert.leaf_names(model)
    assert names == [p.replace("params/", "").replace("/", ".")
                     for p, _ in _flat(variables)]
    convert.load_flax_leaves(model, [np.asarray(l) for l in leaves])
    tx = torch.tensor(x, requires_grad=True)
    out, aux = model(tx)
    loss = (out * torch.cos(out)).sum() + aux
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, [params[n] for n in names] + [tx])

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL, rtol=TOL)
    assert 1.0 <= float(aux) < E
    # the tokens really spread over several experts
    assert len(set(torch.argmax(model.router(model.ln(tx)), -1)
                   .flatten().tolist())) > 1
    for name, a, b in zip(names + ["x"], grads, list(jg) + [jgx]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=name)
        assert np.abs(a.numpy()).max() > 0, name


def _moe_transformer_leaves():
    model = FlaxTransformer(**MOE_TF, max_len=8)
    return {"params": model.init(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 8), jnp.int32))["params"]}


def test_moe_transformer_matches_flax():
    """Leaf order (flax sorts ``moe/b_dn`` before ``moe/ln``), the
    expert-stacked leaves carried across unchanged, logits, aux and
    every gradient."""
    variables = _moe_transformer_leaves()
    fmodel = FlaxTransformer(**MOE_TF, max_len=8)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    toks = np.random.RandomState(2).randint(0, 64, (4, 8)).astype(np.int32)

    def loss_fn(lv):
        logits, state = fmodel.apply(
            jax.tree_util.tree_unflatten(treedef, lv), toks,
            mutable=["losses"])
        aux = sum(jnp.asarray(v).sum()
                  for v in jax.tree_util.tree_leaves(state["losses"]))
        return jnp.mean(logits ** 2) + aux, (logits, aux)

    (_, (jlogits, jaux)), jg = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(leaves)

    model = Transformer(**MOE_TF, max_len=8)
    names = convert.leaf_names(model)
    assert names == [p.replace("params/", "").replace("/", ".")
                     for p, _ in _flat(variables)]
    assert names.index("block0.moe.b_dn") < names.index("block0.moe.ln.bias")
    convert.load_flax_leaves(model, [np.asarray(l) for l in leaves])
    assert [a.shape for a in convert.flax_leaves(model)] == \
        [np.shape(l) for l in leaves]
    logits, aux = model(torch.as_tensor(toks), return_aux=True)
    aux = sum(aux)
    loss = (logits ** 2).mean() + aux
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL, rtol=TOL)
    for name, a, b in zip(names, grads, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("kw", [dict(tp=2), dict(tp=2, ep=2), dict(ep=4),
                                dict(tp=4, pp=2)])
def test_layout_rules_match_jax(kw):
    """For every parameter path of a MoE transformer (and a dense one),
    the port's spec equals the JAX package's PartitionSpec."""
    jmesh = jax_make_mesh(jax.devices(), **kw)
    mesh = make_mesh(8, device="cpu", **kw)
    for moe in (4, 0):
        dims = dict(MOE_TF, dim=32, heads=4, moe_experts=moe)
        variables = FlaxTransformer(**dims, max_len=8).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        with jmesh:
            placed = jax_tf_sharding(jmesh)(variables["params"])
        want = {p: tuple(l.sharding.spec) for p, l in
                zip([p for p, _ in _flat(placed)],
                    jax.tree_util.tree_leaves(placed))}
        got = transformer_param_sharding(mesh)(
            Transformer(**dims, max_len=8))
        assert got == want
        if moe and "ep" not in mesh.axis_names:
            # no "ep" axis to split experts over: both refuse
            with pytest.raises(ValueError):
                jax_moe_sharding(jmesh)(variables["params"])
            with pytest.raises(ValueError, match="'ep'"):
                moe_param_sharding(mesh)(Transformer(**dims, max_len=8))
        elif moe:
            placed = jax_moe_sharding(jmesh)(variables["params"])
            want = {p: tuple(l.sharding.spec) for p, l in
                    zip([p for p, _ in _flat(placed)],
                        jax.tree_util.tree_leaves(placed))}
            assert moe_param_sharding(mesh)(
                Transformer(**dims, max_len=8)) == want
            if "ep" in mesh.axis_names:
                assert got["block0/moe/w_up"][0] == "ep"


def test_layout_rules_reject_indivisible_axes():
    mesh = make_mesh(8, ep=8, device="cpu")
    with pytest.raises(ValueError, match="mesh axis 'ep'"):
        moe_param_sharding(mesh)(MoEBlock(8, num_experts=4))


def _stage_fn_jax(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _stage_fn(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _stacked(S, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 0.5, (S, D, D)).astype(np.float32),
            rng.normal(0, 0.1, (S, D)).astype(np.float32))


def _sequential(params, x_mb):
    w, b = params
    out = []
    for m in range(x_mb.shape[0]):
        x = x_mb[m]
        for s in range(w.shape[0]):
            x = _stage_fn((w[s], b[s]), x)
        out.append(x)
    return torch.stack(out)


@pytest.mark.parametrize("pp,M", [(2, 4), (4, 6)])
def test_pipeline_matches_jax_and_sequential(pp, M):
    D, mb = 8, 4
    w, b = _stacked(pp, D)
    x = np.random.RandomState(1).normal(size=(M, mb, D)).astype(np.float32)
    jfn = jax_pipeline(jax_make_mesh(jax.devices(), pp=pp), _stage_fn_jax)

    def jloss(p):
        out = jfn(p, jnp.asarray(x))
        return jnp.sum(out ** 2), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (jnp.asarray(w), jnp.asarray(b)))

    fn = make_pipeline_fn(make_mesh(8, pp=pp, device="cpu"), _stage_fn)
    tw, tb = (torch.tensor(a, requires_grad=True) for a in (w, b))
    out = fn((tw, tb), torch.tensor(x))
    grads = torch.autograd.grad((out ** 2).sum(), (tw, tb))
    sw, sb = (torch.tensor(a, requires_grad=True) for a in (w, b))
    seq = _sequential((sw, sb), torch.tensor(x))
    sgrads = torch.autograd.grad((seq ** 2).sum(), (sw, sb))

    assert out.shape == (M, mb, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out.detach().numpy(), seq.detach().numpy(),
                               atol=TOL, rtol=TOL)
    for a, b_, c in zip(grads, jg, sgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=TOL, rtol=TOL)


def test_pipeline_bubbles_are_selected_out_not_masked():
    """A stage that returns NaN on the all-zero bubble input must leave
    the outputs finite (a ``* 0`` mask would keep the NaN)."""
    def stage(params, x):
        (w,) = params
        bad = (x == 0).all()
        return torch.where(bad, torch.full_like(x, float("nan")), x @ w)

    S, M = 2, 3
    w = torch.eye(4).expand(S, 4, 4).clone()
    x = torch.ones(M, 2, 4)
    out = make_pipeline_fn(make_mesh(S, pp=S, device="cpu"), stage)((w,), x)
    assert torch.isfinite(out).all() and torch.equal(out, x)
    with pytest.raises(ValueError, match="stage axis"):
        make_pipeline_fn(make_mesh(4, pp=4, device="cpu"), stage)((w,), x)
