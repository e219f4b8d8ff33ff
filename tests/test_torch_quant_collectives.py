"""geomx_tpu_torch's quantized ring all-reduce and DataParallelTrainer vs
geomx_tpu's, on the CPU.

The JAX ring runs as a shard_map over 4 (or 2) of the 8 virtual CPU
devices ``tests/conftest.py`` forces; the port's ring runs on CPU tensors
(the plain version of the 2-bit kernel). For int8, 2-bit and fp16 both
rings must give the same bits — every rank's replica and the carried
error-feedback residual — over 3 rounds, the schedule
``tests/test_mesh_quant.py`` holds against its numpy oracle; ``none``
(the psum) agrees within 1e-6 since the sum order may differ.

``DataParallelTrainer`` is held against the JAX one on a small
transformer, the weights carried across by ``models/convert.py``, within
the fp32 tolerance of ``tests/test_torch_transformer.py`` (1e-5 abs,
1e-4 rel). The slice end to end — local grads, the 2-rank 2-bit ring,
SGD on the replicated parameters — runs 3 rounds through both packages:
the ring is bit-exact (both rings get the JAX side's gradient stack, so
float noise in the gradients cannot flip a code and pass for a ring
fault), the parameters agree within that tolerance.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from geomx_tpu.compression import device as jax_dev
from geomx_tpu.models.transformer import Transformer as FlaxTransformer
from geomx_tpu.parallel import quant_collectives as jax_qc
from geomx_tpu.parallel import train_step as jax_ts
from geomx_tpu.parallel.mesh import batch_sharded, make_mesh
from geomx_tpu_torch.compression import device as dev
from geomx_tpu_torch.models import convert
from geomx_tpu_torch.models.transformer import Transformer
from geomx_tpu_torch.parallel import mesh as pmesh
from geomx_tpu_torch.parallel import quant_collectives as qc
from geomx_tpu_torch.parallel.train_step import DataParallelTrainer

ATOL, RTOL = 1e-5, 1e-4
DIMS = dict(vocab=64, dim=64, depth=2, heads=2)
SEQ, BATCH, LR = 32, 4, 0.1


def _jax_mesh(size):
    return make_mesh(jax.devices()[:size])


@pytest.mark.parametrize("codec,n", [("int8", 1000), ("2bit", 1000),
                                     ("fp16", 1000), ("int8", 77),
                                     ("2bit", 77), ("fp16", 77)])
def test_ring_bit_exact_vs_jax(codec, n):
    P, block, thr = 4, 64, 0.5
    theirs = jax_qc.QuantRingReducer(_jax_mesh(P), codec, n, block=block,
                                     threshold=thr)
    ours = qc.QuantRingReducer(pmesh.make_party_mesh(P, device="cpu"),
                               codec, n, block=block, threshold=thr)
    rng = np.random.RandomState(3)
    for rnd in range(3):
        xs = rng.randn(P, n).astype(np.float32)
        want = np.asarray(theirs.reduce(xs))
        got = ours.reduce(torch.as_tensor(xs))
        assert got.shape == (P, n)
        for r in range(P):
            np.testing.assert_array_equal(
                got[r].numpy(), want,
                err_msg=f"codec={codec} round={rnd} rank={r}")
        np.testing.assert_array_equal(ours._res.numpy(),
                                      np.asarray(theirs._res))
    assert ours.wire_bytes_per_round() == theirs.wire_bytes_per_round()


def test_none_is_the_sum_and_bytes_models_agree():
    P, n = 4, 1000
    xs = np.random.RandomState(4).randn(P, n).astype(np.float32)
    for mean in (False, True):
        want = np.asarray(jax_qc.QuantRingReducer(
            _jax_mesh(P), "none", n, mean=mean).reduce(xs))
        got = qc.QuantRingReducer(pmesh.make_party_mesh(P, device="cpu"),
                                  "none", n, mean=mean
                                  ).reduce(torch.as_tensor(xs))
        for r in range(P):
            np.testing.assert_allclose(got[r].numpy(), want, atol=1e-6,
                                       rtol=1e-6)
    for codec in dev.MESH_CODECS:
        for size, n, block in ((1, 10, 256), (2, 1 << 20, 256), (4, 77, 64)):
            assert qc.ring_wire_bytes(codec, n, size, block) == \
                jax_qc.ring_wire_bytes(codec, n, size, block)
        assert dev.mesh_wire_bytes(codec, 1001, 64) == \
            jax_dev.mesh_wire_bytes(codec, 1001, 64)
    assert pmesh.ring_chunk_layout(1001, 4, 64) == (256, 1024)


def test_ring_helpers_and_errors():
    x = torch.arange(4)[:, None]
    rolled = torch.roll(x, 1, dims=0)
    for src, dst in pmesh.ring_perm(4):
        assert rolled[dst] == x[src]
    assert pmesh.party_devices(2, 1, devices=list("abcd")) == ["c", "d"]
    mesh = pmesh.make_party_mesh(2, device="cpu")
    assert mesh.shape == {"dp": 2}
    with pytest.raises(ValueError, match="none"):
        qc.ring_all_reduce(torch.zeros(2, 8), qc.zero_residual(2, 8, "2bit"),
                           size=2, codec="none")
    with pytest.raises(ValueError, match="GEOMX_MESH_CODEC"):
        qc.QuantRingReducer(mesh, "int4", 8)
    red = qc.QuantRingReducer(mesh, "int8", 8, block=4)
    red.reduce(torch.randn(2, 8))
    assert bool(red._res.abs().sum() > 0)
    red.reset()
    assert bool((red._res == 0).all())


# -- DataParallelTrainer and the slice end to end --------------------------


def _batch(rnd):
    rng = np.random.default_rng(50 + rnd)
    toks = rng.integers(0, DIMS["vocab"], size=(BATCH, SEQ + 1)
                        ).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX trainer for the module (its jitted steps compile once);
    each test puts the initial parameters back first."""
    X, _ = _batch(0)
    t = jax_ts.DataParallelTrainer(
        FlaxTransformer(**DIMS, max_len=SEQ), optax.sgd(LR), _jax_mesh(2),
        X, num_classes=DIMS["vocab"])
    leaves, treedef = jax.tree_util.tree_flatten(t.params)
    init = [np.array(l) for l in leaves]

    def reset():
        t.params = jax.device_put(
            jax.tree_util.tree_unflatten(treedef, init), t.repl)
        t.opt_state = jax.device_put(t.optimizer.init(t.params), t.repl)

    return t, init, treedef, reset


def _torch_trainer(init):
    model = Transformer(**DIMS, max_len=SEQ)
    convert.load_flax_leaves(model, init)
    return DataParallelTrainer(
        model, torch.optim.SGD(model.parameters(), lr=LR),
        pmesh.make_party_mesh(2, device="cpu"), num_classes=DIMS["vocab"])


def _assert_params(tt, jt):
    for a, b in zip(convert.flax_leaves(tt.model),
                    jax.tree_util.tree_leaves(jt.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL)


def test_data_parallel_trainer_matches_jax(jax_trainer):
    jt, init, _, reset = jax_trainer
    reset()
    tt = _torch_trainer(init)
    X, y = _batch(1)
    jl, jg = jt.local_grads(X, y)
    tl, tg = tt.local_grads(X, y)
    assert tl.shape == (2,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves) == 30
    for a, b in zip(tg, jleaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    loss, mean_grads = tt.grads(X, y)
    for a, b in zip(mean_grads, tg):      # equal shards: mean of the ranks
        np.testing.assert_allclose(a.numpy(), b.mean(0).numpy(), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(tt.step(X, y), jt.step(X, y), atol=ATOL,
                               rtol=RTOL)
    _assert_params(tt, jt)


def test_slice_end_to_end_matches_jax(jax_trainer):
    """3 rounds: local grads -> 2-rank 2-bit ring (mean) -> SGD."""
    jt, init, treedef, reset = jax_trainer
    reset()
    tt = _torch_trainer(init)
    n = sum(l.size for l in init)
    thr = 0.01
    theirs = jax_qc.QuantRingReducer(jt.mesh, "2bit", n, mean=True,
                                     threshold=thr)
    ours = qc.QuantRingReducer(tt.mesh, "2bit", n, mean=True, threshold=thr)
    for rnd in range(3):
        X, y = _batch(rnd)
        _jl, jg = jt.local_grads(X, y)
        _tl, tg = tt.local_grads(X, y)
        jstack = np.concatenate([np.asarray(g).reshape(2, -1)
                                 for g in jax.tree_util.tree_leaves(jg)], 1)
        tstack = torch.cat([g.reshape(2, -1) for g in tg], 1)
        np.testing.assert_allclose(tstack.numpy(), jstack, atol=ATOL,
                                   rtol=RTOL)
        want = np.asarray(theirs.reduce(
            jax.device_put(jstack, batch_sharded(jt.mesh))))
        got = ours.reduce(torch.as_tensor(jstack))
        assert np.count_nonzero(want) > 0.01 * n
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert torch.equal(got[0], got[1])
        # SGD on the replicated parameters, on both sides
        for p, g in zip(tt.params, got[0].split([p.numel()
                                                  for p in tt.params])):
            p.grad = g.view(p.shape)
        tt.optimizer.step()
        sizes = np.cumsum([l.size for l in init])[:-1]
        new = [np.asarray(p) - np.float32(LR) * g.reshape(p.shape)
               for p, g in zip(jax.tree_util.tree_leaves(jt.params),
                               np.split(want, sizes))]
        jt.params = jax.device_put(
            jax.tree_util.tree_unflatten(treedef, new), jt.repl)
        _assert_params(tt, jt)
