"""geomx_tpu_torch DeviceResidentTrainer vs the JAX package's.

With one injected gradient (tie-free, so ``jax.lax.top_k`` and
``torch.topk`` pick the same coordinates) the BSC select gives the same
bits — values, indices and the u/v buffers — with and without the fp16
wire narrowing, and the sparse SGD apply gives the same bits from the
same packed upload. Trained end to end on each package's "local" store,
the small transformer follows the same losses and parameters within
1e-5 at threshold 1.0 (lossless selection).
"""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

from examples.transformer_bsc_device import (  # noqa: E402
    build_transformer_grad_step as jax_build)
from geomx_tpu.kvstore.local import KVStoreLocal as JaxLocal  # noqa: E402
from geomx_tpu.trainer_device import (  # noqa: E402
    DeviceResidentTrainer as JaxTrainer)
from geomx_tpu_torch.examples.transformer_bsc_device import (  # noqa: E402
    build_transformer_grad_step, synth_batch)
from geomx_tpu_torch.kvstore.local import KVStoreLocal  # noqa: E402
from geomx_tpu_torch.trainer_device import DeviceResidentTrainer  # noqa: E402

SHAPES = [(7, 5), (11,), (3, 4, 2), (1,)]
SIZES = [int(np.prod(s)) for s in SHAPES]
TOTAL = sum(SIZES)


def _stores(wire16):
    """A local store of each package; ``wire16`` sets the fp16 codec."""
    cfg = SimpleNamespace(wire_codec="fp16" if wire16 else "",
                          overlap=False)
    jkv, tkv = JaxLocal(), KVStoreLocal()
    jkv.cfg = tkv.cfg = cfg
    return jkv, tkv


def _injected_pair(wire16, momentum=0.0, lr=0.05):
    """Trainers whose grad_fn returns the flat gradient passed as X."""
    rng = np.random.default_rng(11)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    offs = np.cumsum([0] + SIZES)

    def jax_grad(lv, X, y):
        return jnp.float32(1.25), [X[o:o + n].reshape(s) for o, n, s in
                                   zip(offs, SIZES, SHAPES)]

    def torch_grad(lv, X, y):
        return torch.tensor(1.25), [X[o:o + n].reshape(s) for o, n, s in
                                    zip(offs, SIZES, SHAPES)]

    jkv, tkv = _stores(wire16)
    kw = dict(threshold=0.25, learning_rate=lr, momentum=momentum)
    return (JaxTrainer([l.copy() for l in leaves], jkv, jax_grad, **kw),
            DeviceResidentTrainer([l.copy() for l in leaves], tkv,
                                  torch_grad, device="cpu", **kw))


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("wire16", [False, True])
def test_bsc_select_is_bit_identical(wire16):
    jt, tt = _injected_pair(wire16)
    assert jt._ks == tt._ks == [8, 2, 6, 1]
    rng = np.random.default_rng(5)
    ju, jv = jt._u, jt._v
    tu, tv = tt._u, tt._v
    for _ in range(3):    # rounds accumulate into u and v
        # fp16-representable range, values far from fp16-exact
        g = (rng.standard_normal(TOTAL) * 1e3).astype(np.float32)
        assert np.unique(np.abs(g)).size == TOTAL    # tie-free
        jp, ju, jv = jt._fwd_compress(jt._flat, ju, jv, jnp.asarray(g), None)
        tp, tu, tv = tt._fwd_compress(tt._flat, tu, tv, torch.tensor(g),
                                      None)
        assert tp.dtype == torch.int32 and tp.shape == (1 + 2 * tt.k,)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(_bits(tu.numpy()), _bits(ju))
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))


def test_packed_wire_is_int32_and_index_exact():
    _, tt = _injected_pair(False)
    g = np.random.default_rng(2).standard_normal(TOTAL).astype(np.float32)
    packed, _u, _v = tt._fwd_compress(tt._flat, tt._u, tt._v,
                                      torch.tensor(g), None)
    loss, vals, idx = tt._unpack(packed.numpy())
    assert loss == 1.25
    offs = np.cumsum([0] + SIZES)
    for i, kk in enumerate(tt._ks):
        lo, hi = int(tt._kofs[i]), int(tt._kofs[i + 1])
        seg = g[offs[i]:offs[i + 1]]
        want = np.argsort(-np.abs(seg), kind="stable")[:kk] + offs[i]
        np.testing.assert_array_equal(idx[lo:hi], want)
        np.testing.assert_array_equal(vals[lo:hi], g[want])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_apply_sgd_is_bit_identical(momentum):
    jt, tt = _injected_pair(False, momentum=momentum)
    rng = np.random.default_rng(9)
    cap = tt._up_cap
    assert jt._up_cap == cap
    n = cap - 3                                  # three pad slots
    up = np.zeros(2 * cap, np.int32)
    up[:n] = rng.standard_normal(n).astype(np.float32).view(np.int32)
    up[cap:cap + n] = rng.choice(TOTAL, n, replace=False)
    mom0 = rng.standard_normal(TOTAL).astype(np.float32)
    jflat, jmom = jt._flat, (jnp.asarray(mom0) if momentum else None)
    tflat, tmom = tt._flat, (torch.tensor(mom0) if momentum else None)
    for _ in range(2):
        jflat, jmom = jt._apply(jflat, jmom, jnp.asarray(up))
        tflat, tmom = tt._apply(tflat, tmom, torch.tensor(up))
    np.testing.assert_array_equal(_bits(tflat.numpy()), _bits(jflat))
    if momentum:
        np.testing.assert_array_equal(_bits(tmom.numpy()), _bits(jmom))


DIMS = dict(dim=32, depth=1, heads=2, vocab=64, seq_len=16)


def _batches(n):
    rng = np.random.default_rng(100)
    return [synth_batch(rng, 4, DIMS["seq_len"], DIMS["vocab"])
            for _ in range(n)]


def test_three_steps_match_the_jax_trainer():
    leaves, jgrad = jax_build(**DIMS, compute_dtype=jnp.float32)
    _, tgrad = build_transformer_grad_step(
        **DIMS, compute_dtype=torch.float32, device="cpu",
        init_leaves=leaves)
    kw = dict(threshold=1.0, learning_rate=0.1, momentum=0.9)
    jt = JaxTrainer([l.copy() for l in leaves], JaxLocal(), jgrad, **kw)
    tt = DeviceResidentTrainer([l.copy() for l in leaves], KVStoreLocal(),
                               tgrad, device="cpu", **kw)
    for toks in _batches(3):
        jl = jt.step(jnp.asarray(toks), None)
        tl = tt.step(toks, None)
        assert abs(tl - jl) <= 1e-5
    for a, b in zip(tt.leaves, jt.leaves):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_sparse_threshold_loss_decreases():
    leaves, grad = build_transformer_grad_step(
        **DIMS, compute_dtype=torch.float32, device="cpu")
    tr = DeviceResidentTrainer(leaves, KVStoreLocal(), grad, threshold=0.05,
                               learning_rate=0.1, device="cpu")
    batches = _batches(10)
    tr.warmup(batches[0], None)
    losses = [tr.step(toks, None) for toks in batches]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0]
    loss, phases = tr.step_timed(batches[0], None)
    assert np.isfinite(loss)
    assert set(phases) == {"compute_ms", "d2h_ms", "wire_ms", "h2d_ms",
                           "apply_ms"}


def test_unported_store_paths_raise():
    class Overlapped(KVStoreLocal):
        cfg = SimpleNamespace(overlap=True)

        def push_bsc(self, *a, **k): ...
        def pull_bsc(self, *a, **k): ...
        def push_pull_bsc_batch_async(self, *a, **k): ...

    class Meshed(KVStoreLocal):
        mesh = object()

    grad = lambda lv, X, y: (None, lv)  # noqa: E731
    # the pipelined round is ported: an overlapped async sparse store
    # gets its chunk plan; a mesh that is not a one-device party mesh
    # (parallel.mesh.PartyMesh) is refused, pointing at the trainer that
    # runs a party over processes
    tr = DeviceResidentTrainer([np.zeros(4, np.float32)], Overlapped(),
                               grad, device="cpu")
    assert tr.pipelined and len(tr._chunks) == 1
    with pytest.raises(NotImplementedError, match="HierarchicalTrainer"):
        DeviceResidentTrainer([np.zeros(4, np.float32)], Meshed(), grad,
                              device="cpu")
