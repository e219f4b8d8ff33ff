"""The port's quantized mesh tier and "nccl" store against the JAX
package's, on the CPU.

Counterpart of ``tests/test_mesh_quant.py:335-380`` and of the JAX
package's ``kvstore/device.py``:

- ``HierarchicalTrainer`` with the MLP over two mesh parties of 2 ranks,
  codecs int8 and 2bit, 3 rounds with SGD on the global server: the
  parties' parameters BIT-IDENTICAL, and equal to the JAX package's run
  bit for bit. The two frameworks' matmuls round apart (the port's local
  gradients agree with the JAX package's within 1e-5, checked every
  round), and a code of a quantized ring may flip on such noise, so both
  rings are fed the JAX side's local gradients of the same parameters:
  what is held is the trainer, the per-key reducers and the tiers;
- ``build_mesh_ring_step`` against the JAX example harness's, 3 rounds
  of int8 and 2bit on exactly computed gradients: bit for bit;
- the 2-layer, dim-64, seq-32 transformer through the 2bit mesh round of
  ``DeviceResidentTrainer``: within 1e-4 of the JAX trainer after 2
  rounds (fp32 rounding apart, so a 2-bit code may flip; one flip moves
  a weight by lr x threshold / 4 = 1.25e-5), and the displacement from
  the initial leaves within 1e-3 of the JAX run's by relative norm (0.0
  measured on the CPU; the JAX run one round short reads 0.66 and its
  rounds negated 2.0, so both fail it);
- the count of the ring's bytes under ``mesh.bytes{codec=...}``, out of
  wan_bytes;
- ``KVStoreDeviceAllreduce`` ("nccl") on integer-valued data: the sum of
  the per-device values and the updater path, bit for bit.
"""

import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import geomx_tpu.simulate as jsim
import geomx_tpu_torch.simulate as tsim
from examples.transformer_bsc_device import \
    build_transformer_grad_step as jax_transformer
from examples.utils import build_mesh_ring_step as jax_ring_step
from geomx_tpu import config as jcfg
from geomx_tpu.kvstore.device import KVStoreDeviceAllreduce as JaxNccl
from geomx_tpu.kvstore.mesh_party import KVStorePartyMesh as JaxMeshStore
from geomx_tpu.models import MLP as FlaxMLP
from geomx_tpu.optimizer import SGD as JaxSGD
from geomx_tpu.parallel import train_step as jax_ts
from geomx_tpu.parallel.mesh import make_party_mesh as jax_party_mesh
from geomx_tpu.trainer_device import DeviceResidentTrainer as JaxDRT
from geomx_tpu_torch import kvstore as tkv
from geomx_tpu_torch import telemetry
from geomx_tpu_torch.examples.transformer_bsc_device import (
    build_transformer_grad_step, synth_batch)
from geomx_tpu_torch.examples.utils import build_mesh_ring_step
from geomx_tpu_torch.kvstore.device import KVStoreDeviceAllreduce
from geomx_tpu_torch.kvstore.mesh_party import (KVStorePartyMesh,
                                                _ring_bytes)
from geomx_tpu_torch.models import MLP
from geomx_tpu_torch.optimizer import SGD
from geomx_tpu_torch.parallel import quant_collectives as qc
from geomx_tpu_torch.parallel.mesh import make_party_mesh
from geomx_tpu_torch.parallel.train_step import (DataParallelTrainer,
                                                 HierarchicalTrainer)
from geomx_tpu_torch.trainer_device import DeviceResidentTrainer
from test_torch_feature_configs import _disp_err
from test_torch_hips import TIMEOUT

pytestmark = pytest.mark.mesh

FEATURES, IN = (16, 4), 8


def _mlp_init():
    params = FlaxMLP(features=FEATURES).init(
        jax.random.PRNGKey(42), jnp.zeros((1, IN), jnp.float32))
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]


def _batch():
    rng = np.random.RandomState(0)
    return rng.randn(8, IN).astype(np.float32), rng.randint(0, 4, (8,))


def _run_hierarchical(pkg, codec, init):
    """3 rounds of HierarchicalTrainer on each of two mesh parties; the
    port's ranks take the JAX package's local gradients of the same
    parameters (module docstring). Returns each party's flat parameters
    and losses."""
    sim = tsim if pkg == "torch" else jsim
    kw = {"device": "cpu"} if pkg == "torch" else {}
    topo = sim.InProcessHiPS(num_parties=2, workers_per_party=2,
                             party_mesh_size=2,
                             extra_cfg={"mesh_codec": codec,
                                        "mesh_block": 8,
                                        "wire_2bit_threshold": 0.05},
                             **kw).start()
    out = {}
    X, y = _batch()
    try:
        topo.master.set_optimizer(
            (SGD if pkg == "torch" else JaxSGD)(learning_rate=0.1))
        done = threading.Event()

        def master(kv):
            for i, leaf in enumerate(init):
                kv.init(i, leaf)
            kv.wait()
            done.set()

        def worker(kv):
            assert done.wait(TIMEOUT)
            p = topo.workers.index(kv)
            jdp = jax_ts.DataParallelTrainer(
                FlaxMLP(features=FEATURES), optax.sgd(0.1),
                jax_party_mesh(2, p), jnp.zeros((1, IN), jnp.float32),
                num_classes=4)
            if pkg == "jax":
                ht = jax_ts.HierarchicalTrainer(jdp, kv)
            else:
                model = MLP(IN, FEATURES)
                dp = DataParallelTrainer(
                    model, torch.optim.SGD(model.parameters(), lr=0.1),
                    kv.mesh, num_classes=4)
                treedef = jax.tree_util.tree_structure(jdp.params)
                own = dp.local_grads

                def fed(Xb, yb):
                    losses, grads = own(Xb, yb)
                    jdp.params = jax.device_put(
                        jax.tree_util.tree_unflatten(
                            treedef, [p_.detach().numpy()
                                      for p_ in dp.params]), jdp.repl)
                    jl, jg = jdp.local_grads(Xb, yb)
                    jleaves = [np.asarray(g)
                               for g in jax.tree_util.tree_leaves(jg)]
                    for a, b in zip(grads, jleaves):
                        np.testing.assert_allclose(a.numpy(), b, atol=1e-5,
                                                   rtol=1e-5)
                    return (torch.from_numpy(np.array(jl)),
                            [torch.tensor(b) for b in jleaves])

                dp.local_grads = fed
                ht = HierarchicalTrainer(dp, kv)
            ht.init_on_kvstore()
            losses = [ht.step(X, y) for _ in range(3)]
            leaves = (jax.tree_util.tree_leaves(ht.t.params) if pkg == "jax"
                      else [p_.detach() for p_ in ht.t.params])
            out[p] = (np.concatenate([np.asarray(l).ravel()
                                      for l in leaves]), losses)

        topo.run_workers(worker, include_master=master, timeout=TIMEOUT)
    finally:
        topo.stop()
    return out


@pytest.mark.parametrize("codec", ["int8", "2bit"])
def test_hierarchical_trainer_mlp_matches_jax(codec):
    init = _mlp_init()
    want = _run_hierarchical("jax", codec, init)
    got = _run_hierarchical("torch", codec, init)
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][0], want[0][0])
    flat0 = np.concatenate([l.ravel() for l in init])
    assert not np.array_equal(got[0][0], flat0)          # it trained
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-6)


# -- build_mesh_ring_step --------------------------------------------------


def _jax_store(codec):
    store = object.__new__(JaxMeshStore)
    store.mesh, store.party_size = jax_party_mesh(2, 0), 2
    store.mesh_codec, store.mesh_block = codec, 4
    store.cfg = jcfg.Config(wire_2bit_threshold=0.25)
    store._reducers = {}
    return store


def _torch_store(codec):
    store = object.__new__(KVStorePartyMesh)
    store.mesh, store.party_size = make_party_mesh(2, device="cpu"), 2
    store.mesh_codec, store.mesh_block = codec, 4
    store.cfg = SimpleNamespace(wire_2bit_threshold=0.25)
    store._reducers = {}
    store._reset_pending = threading.Event()
    return store


@pytest.mark.parametrize("codec", ["int8", "2bit"])
def test_mesh_ring_step_matches_jax(codec):
    """The gradient of a quadratic is one subtraction per row, exact in
    both packages, so the per-leaf rings are fed the same bits."""
    rng = np.random.default_rng(3)
    t = [rng.standard_normal(s).astype(np.float32) for s in ((6,), (2, 5))]

    def jgrad(lv, X, y):
        d = [w[None] - tt[None] + X.reshape((-1,) + (1,) * w.ndim)
             for w, tt in zip(lv, t)]
        return jnp.sum(d[0]), [d[0][0], d[1][0]]

    def tgrad(lv, X, y):
        d = [w[None] - torch.from_numpy(tt)[None]
             + X.reshape((-1,) + (1,) * w.ndim) for w, tt in zip(lv, t)]
        return d[0].sum(), [d[0][0], d[1][0]]

    theirs = jax_ring_step(_jax_store(codec), jgrad)
    ours = build_mesh_ring_step(_torch_store(codec), tgrad)
    w = [rng.standard_normal(tt.shape).astype(np.float32) for tt in t]
    for _ in range(3):
        X = rng.standard_normal(2).astype(np.float32)
        y = np.zeros(2, np.int32)
        _jl, jg = theirs([jnp.asarray(l) for l in w], X, y)
        _tl, tg = ours([torch.from_numpy(l) for l in w], torch.from_numpy(X),
                       torch.from_numpy(y))
        for a, b in zip(tg, jg):
            assert tuple(a.shape) == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert any(np.any(np.asarray(b) != 0) for b in jg)
        w = [l - 0.5 * np.asarray(b) for l, b in zip(w, jg)]


# -- the transformer through the 2-bit mesh round --------------------------


TDIMS = dict(dim=64, depth=2, heads=2, vocab=64, seq_len=32)
TF_DISP_TOL = 1e-3


def _run_transformer(pkg, init, grad, batches):
    sim = tsim if pkg == "torch" else jsim
    kw = {"device": "cpu"} if pkg == "torch" else {}
    topo = sim.InProcessHiPS(num_parties=2, workers_per_party=2,
                             party_mesh_size=2,
                             extra_cfg={"mesh_codec": "2bit",
                                        "wire_2bit_threshold": 1e-3},
                             **kw).start()
    out = {}
    tkw = dict(threshold=1.0, learning_rate=0.05, momentum=0.9)
    try:
        done = threading.Event()

        def master(kv):
            for i, leaf in enumerate(init):
                kv.init(i, leaf)
            kv.wait()
            done.set()

        def worker(kv):
            assert done.wait(TIMEOUT)
            p = topo.workers.index(kv)
            lv = [np.array(l) for l in init]
            tr = (DeviceResidentTrainer(lv, kv, grad, device="cpu", **tkw)
                  if pkg == "torch" else JaxDRT(lv, kv, grad, **tkw))
            losses, trail = [], []
            for b in batches[p]:
                losses.append(float(tr.step(b, None)))
                trail.append([np.array(l) for l in tr.leaves])
            out[p] = (trail, losses)

        topo.run_workers(worker, include_master=master, timeout=TIMEOUT)
    finally:
        topo.stop()
    return out


def test_tiny_transformer_2bit_mesh_round_matches_jax():
    init, jgrad = jax_transformer(**TDIMS, compute_dtype=jnp.float32)
    _l, tgrad = build_transformer_grad_step(
        **TDIMS, compute_dtype=torch.float32, device="cpu",
        init_leaves=init)
    batches = []
    for p in (0, 1):
        rng = np.random.default_rng(1234 + p)
        batches.append([synth_batch(rng, 4, TDIMS["seq_len"],
                                    TDIMS["vocab"]) for _ in range(2)])
    want = _run_transformer("jax", init, jgrad, batches)
    got = _run_transformer("torch", init, tgrad, batches)
    for a, b in zip(got[0][0][-1], got[1][0][-1]):      # parties identical
        np.testing.assert_array_equal(a, b)
    last = want[0][0][-1]
    for a, b, i in zip(got[0][0][-1], last, init):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        assert np.any(a != i)                           # every leaf trained
    # what the two rounds moved, port against JAX, by relative norm; the
    # check's power: the JAX run one round short, and its two rounds
    # negated, fail it
    assert _disp_err(got[0][0][-1], last, init) <= TF_DISP_TOL
    assert _disp_err(want[0][0][-2], last, init) > TF_DISP_TOL
    negated = [2 * i - b for b, i in zip(last, init)]
    assert _disp_err(negated, last, init) > TF_DISP_TOL
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-4)


# -- accounting ------------------------------------------------------------


def test_count_collective_codec_label_and_wan_exclusion():
    was = telemetry.enabled()
    try:
        telemetry.reset()
        telemetry.enable(True)
        nbytes = 4096 * 4
        for codec in ("none", "int8"):
            shim = SimpleNamespace(mesh_codec=codec, party_size=4,
                                   mesh_block=256)
            KVStorePartyMesh.count_collective(shim, nbytes)
        snap = telemetry.snapshot()
    finally:
        telemetry.reset()
        telemetry.enable(was)
    by_codec = telemetry.mesh_bytes_by_codec(snap)
    assert by_codec["none"] == _ring_bytes(4, nbytes)
    assert by_codec["int8"] == qc.ring_wire_bytes("int8", 4096, 4, 256)
    assert by_codec["int8"] < by_codec["none"] / 3.5
    assert telemetry.mesh_bytes(snap) == sum(by_codec.values())
    assert telemetry.wan_bytes(snap) == 0.0


# -- the "nccl" store ------------------------------------------------------


def test_device_allreduce_store_matches_jax():
    """Integer-valued pushes of one value per device, summed; then the
    same with SGD as the updater (host mirror path): bit for bit."""
    rng = np.random.default_rng(9)
    shapes = {3: (4,), 5: (2, 3)}
    ours = tkv.create("nccl", device="cpu")
    assert ours.type == "nccl" and ours.num_devices == 1
    ours = KVStoreDeviceAllreduce(["cpu"] * 4)
    theirs = JaxNccl(jax.devices()[:4])
    assert ours.num_devices == theirs.num_devices == 4
    for kv in (ours, theirs):
        for k, s in shapes.items():
            kv.init(k, np.zeros(s, np.float32))
    for rnd in range(3):
        if rnd == 1:
            ours.set_optimizer(SGD(learning_rate=0.25))
            theirs.set_optimizer(JaxSGD(learning_rate=0.25))
        for k, s in shapes.items():
            vals = [rng.integers(-8, 9, s).astype(np.float32)
                    for _ in range(4)]
            ours.push(k, vals)
            theirs.push(k, vals)
            got = ours.pull(k)
            np.testing.assert_array_equal(got, theirs.pull(k))
            assert torch.equal(ours.pull_device(k), torch.from_numpy(got))
    assert np.any(got != 0)
    # several keys at once, one already-reduced value each
    ours.push([3, 5], [np.ones(4, np.float32), np.ones((2, 3), np.float32)])
    theirs.push([3, 5], [np.ones(4, np.float32), np.ones((2, 3), np.float32)])
    for k in shapes:
        np.testing.assert_array_equal(ours.pull(k), theirs.pull(k))
    with pytest.raises(ValueError, match="per-device"):
        ours.push(3, [np.ones(4, np.float32)] * 3)
