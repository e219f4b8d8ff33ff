"""geomx_tpu_torch ring attention, sharded flash and the mesh vs the JAX
package.

The JAX side runs on the 8-device virtual CPU mesh (tests/conftest.py):
ring attention under shard_map with ppermute hops, flash attention under
shard_map with its Pallas kernels in interpret mode. The port's ranks
share one device, its ring hops are rolls along a stacked sp axis. The
same numpy inputs go through both: ring attention forward and q/k/v
gradients (through the non-trivial cotangent of ``sum(o * cos(o))``)
within 2e-5, fp32; sharded flash within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.ops.flash_attention import (
    make_sharded_flash_attention as jax_sharded_flash)
from geomx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from geomx_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from geomx_tpu.parallel.ring_attention import (
    make_ring_attention as jax_ring)
from geomx_tpu_torch.models.transformer import dense_attention, make_attention
from geomx_tpu_torch.ops.flash_attention import make_sharded_flash_attention
from geomx_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from geomx_tpu_torch.parallel.ring_attention import make_ring_attention

TOL = 2e-5


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _torch_value_and_grads(fn, q, k, v):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    loss = (out * torch.cos(out)).sum()
    return out.detach().numpy(), [g.numpy() for g in
                                  torch.autograd.grad(loss, ts)]


def _jax_value_and_grads(fn, q, k, v):
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * jnp.cos(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("tp,sp,shape", [(2, 2, (4, 32, 4, 16)),
                                         (1, 4, (2, 16, 2, 8))])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(tp, sp, shape, causal):
    q, k, v = _qkv(shape, seed=tp + sp)
    jfn = jax_ring(jax_make_mesh(jax.devices(), tp=tp, sp=sp), causal=causal)
    tfn = make_ring_attention(make_mesh(8, tp=tp, sp=sp, device="cpu"),
                              causal=causal)
    jo, jg = _jax_value_and_grads(jfn, q, k, v)
    to, tg = _torch_value_and_grads(tfn, q, k, v)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=TOL)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=name)
        assert np.abs(a).max() > 0, name


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_port_dense(causal):
    """The streaming max is detached everywhere: the ring's gradients
    equal dense attention's (a missing detach once gave the JAX package
    q/k gradients ~70% wrong with a forward right to 2e-7)."""
    q, k, v = _qkv((2, 16, 2, 8), seed=11)
    ring = make_ring_attention(make_mesh(4, sp=4, device="cpu"),
                               causal=causal)
    ro, rg = _torch_value_and_grads(ring, q, k, v)
    do, dg = _torch_value_and_grads(
        lambda q, k, v: dense_attention(q, k, v, causal=causal), q, k, v)
    np.testing.assert_allclose(ro, do, atol=TOL, rtol=TOL)
    for a, b in zip(rg, dg):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_ring_attention_rejects_indivisible_layouts():
    ring = make_ring_attention(make_mesh(8, tp=2, sp=2, device="cpu"))
    for shape, axis in (((3, 8, 4, 8), "'dp'"), ((2, 9, 4, 8), "'sp'"),
                        ((2, 8, 3, 8), "'tp'")):
        x = torch.zeros(shape)
        with pytest.raises(ValueError, match=f"mesh axis {axis}"):
            ring(x, x, x)


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_flash_matches_jax(tp):
    """Pallas in interpret mode per shard vs the port's plain flash over
    the whole batch (the kernels' CPU path)."""
    q, k, v = _qkv((8, 24, 4, 16), seed=5)
    jfn = jax_sharded_flash(jax_make_mesh(jax.devices(), tp=tp),
                            causal=True, block_q=8, block_k=8)
    mesh = make_mesh(8, tp=tp, device="cpu")
    tfn = make_sharded_flash_attention(mesh, causal=True, block_q=8,
                                       block_k=8)
    jo, jg = _jax_value_and_grads(jfn, q, k, v)
    to, tg = _torch_value_and_grads(tfn, q, k, v)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    # make_attention routes a multi-rank mesh through the sharded flash
    att = make_attention("flash", mesh=mesh, block_q=8, block_k=8)
    np.testing.assert_allclose(
        att(*(torch.tensor(x) for x in (q, k, v))).numpy(), to, atol=0,
        rtol=0)


def test_sharded_flash_rejects_sequence_sharding():
    jmesh = jax_make_mesh(jax.devices(), tp=2, sp=2)
    with pytest.raises(ValueError) as jerr:
        jax_sharded_flash(jmesh)
    mesh = make_mesh(8, tp=2, sp=2, device="cpu")
    with pytest.raises(ValueError) as terr:
        make_sharded_flash_attention(mesh)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="ring_attention"):
        make_attention("flash", mesh=mesh)
    # "auto" rejects only when it would take the flash path (a CUDA
    # tensor); CPU tensors take dense attention, as on the JAX CPU backend
    x = torch.zeros(2, 8, 2, 8)
    auto = make_attention("auto", mesh=mesh)
    assert torch.equal(auto(x, x, x), dense_attention(x, x, x))


@pytest.mark.parametrize("kw", [dict(), dict(tp=2), dict(tp=2, sp=2),
                                dict(sp=4), dict(pp=2), dict(ep=4),
                                dict(tp=2, pp=2, ep=2)])
def test_make_mesh_matches_jax(kw):
    jmesh = jax_make_mesh(jax.devices(), **kw)
    mesh = make_mesh(8, device="cpu", **kw)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.size == jmesh.devices.size
    assert mesh_shape_for(8, **kw) == jax_mesh_shape_for(8, **kw)


def test_mesh_shape_errors_match_jax():
    with pytest.raises(AssertionError) as jerr:
        jax_mesh_shape_for(8, tp=3)
    with pytest.raises(AssertionError) as terr:
        mesh_shape_for(8, tp=3)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(AssertionError, match="not divisible"):
        make_mesh(6, tp=4, device="cpu")
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(2)
