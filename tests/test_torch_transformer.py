"""geomx_tpu_torch Transformer vs the flax Transformer of geomx_tpu.

The flax model's initial parameters go across through
``geomx_tpu_torch.models.convert``; the same numpy token batch then goes
through both, and logits, the LM loss and all 30 gradient leaves must
agree, with dense and with flash attention (the JAX flash runs its
Pallas kernels in interpret mode, the port's its plain version on the
CPU). fp32 within 1e-5 abs / 1e-4 rel (summation order); bf16 within
3e-2 (bf16 rounding after every operation; the JAX side is compiled with
XLA's excess precision off, so that it rounds where eager PyTorch does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.models.transformer import Transformer as FlaxTransformer
from geomx_tpu.models.transformer import make_attention as jax_attention
from geomx_tpu_torch.models import convert
from geomx_tpu_torch.models.transformer import Transformer, make_attention

DIMS = dict(vocab=64, dim=32, depth=2, heads=2)
SEQ, BATCH = 16, 4


def _tokens():
    rng = np.random.default_rng(7)
    return rng.integers(0, DIMS["vocab"], size=(BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params():
    """The flax initial parameters (fp32 whatever the compute dtype)."""
    model = FlaxTransformer(**DIMS, max_len=SEQ)
    return jax.jit(model.init)(jax.random.PRNGKey(3),
                               jnp.zeros((1, SEQ), jnp.int32))


def _jax_side(impl, dtype, toks, params):
    model = FlaxTransformer(**DIMS, max_len=SEQ, attn_fn=jax_attention(impl),
                            compute_dtype=jnp.dtype(dtype))
    leaves, treedef = jax.tree_util.tree_flatten(params)

    def loss_fn(lv):
        logits = model.apply(jax.tree_util.tree_unflatten(treedef, lv),
                             toks[:, :-1])
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.take_along_axis(logp, toks[:, 1:, None], -1))
        return loss, logits

    (loss, logits), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)).lower(leaves).compile(
            {"xla_allow_excess_precision": False})(leaves)
    return [np.asarray(l) for l in leaves], logits, loss, grads


def _torch_side(impl, dtype, toks, leaves):
    model = Transformer(**DIMS, max_len=SEQ, attn_fn=make_attention(impl),
                        compute_dtype=getattr(torch, dtype))
    convert.load_flax_leaves(model, leaves)
    t = torch.as_tensor(toks).long()
    logits = model(t[:, :-1])
    logp = torch.log_softmax(logits, -1)
    loss = -logp.gather(-1, t[:, 1:, None]).mean()
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(
        loss, [params[n] for n in convert.leaf_names(model)])
    return model, logits.detach(), loss.detach(), grads


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_flax_transformer(impl, dtype, flax_params):
    toks = _tokens()
    leaves, jlogits, jloss, jgrads = _jax_side(impl, dtype, toks,
                                               flax_params)
    model, tlogits, tloss, tgrads = _torch_side(impl, dtype, toks, leaves)
    atol, rtol = (1e-5, 1e-4) if dtype == "float32" else (3e-2, 3e-2)

    assert len(tgrads) == len(jgrads) == 30
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=atol,
                               rtol=rtol)
    for name, a, b in zip(convert.leaf_names(model), tgrads, jgrads):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg=name)


def test_leaf_order_matches_tree_flatten_past_ten_blocks():
    """Keys sort lexicographically, so block10 precedes block2."""
    dims = dict(vocab=16, dim=8, depth=11, heads=2)
    flax_model = FlaxTransformer(**dims, max_len=4)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    flax_names = [".".join(str(k.key) for k in path[1:]) for path, _ in flat]
    model = Transformer(**dims, max_len=4)
    params = dict(model.named_parameters())
    names = convert.leaf_names(model)
    assert names == flax_names
    assert [tuple(params[n].shape) for n in names] == \
        [leaf.shape for _, leaf in flat]
    assert names.index("block10.down.bias") < names.index("block2.down.bias")


def test_leaves_round_trip():
    model = Transformer(**DIMS, max_len=SEQ,
                        generator=torch.Generator().manual_seed(1))
    leaves = convert.flax_leaves(model)
    other = Transformer(**DIMS, max_len=SEQ)
    convert.load_flax_leaves(other, leaves)
    for a, b in zip(leaves, convert.flax_leaves(other)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="leaves for"):
        convert.load_flax_leaves(other, leaves[:-1])


def test_unported_options_raise():
    """MoE blocks and attention over a mesh are ported now: a MoE
    transformer builds, and of the mesh options only the one the JAX
    package refuses raises, flash attention over a sequence-split mesh
    (the sharded-flash and MoE parity tests are in
    test_torch_ring_attention.py and test_torch_moe_pipeline.py)."""
    from geomx_tpu_torch.parallel.mesh import make_mesh

    model = Transformer(**DIMS, moe_experts=2)
    assert all(getattr(model, f"block{i}").moe is not None
               for i in range(DIMS["depth"]))
    with pytest.raises(ValueError, match="ring_attention"):
        make_attention("flash", mesh=make_mesh(4, sp=2, device="cpu"))


def test_remat_gives_the_same_gradients():
    toks = torch.as_tensor(_tokens()).long()
    grads = []
    for remat in (False, True):
        model = Transformer(**DIMS, max_len=SEQ, remat=remat,
                            generator=torch.Generator().manual_seed(2))
        loss = model(toks).sum()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
