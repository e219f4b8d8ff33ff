"""The port's mesh-party tier against the JAX package's, on the CPU.

Counterpart of ``tests/test_mesh_party.py``. Each party of a two-party
``InProcessHiPS`` is ONE ``KVStorePartyMesh`` over a 2-rank party mesh:
the JAX package's over 2 of the 8 virtual CPU devices
(``tests/conftest.py``), the port's over CPU tensors stacked on a rank
axis. Every topology waits with its own timeout, so a hang fails the
test instead of stalling the run.

- dense FSA through ``Trainer`` on integer-valued data (every sum exact
  in any order): the port's mesh parties, the JAX package's mesh parties
  and the port's 2 x 2 wire run end on the SAME bits; the mesh tier's
  bytes count under tier=mesh and never in wan_bytes;
- mixed topologies, each direction: port mesh workers against the JAX
  package's schedulers and servers, and JAX mesh workers against the
  port's: the same bits again;
- ``DeviceResidentTrainer`` over the mesh store with BSC: codec "none"
  within 1e-5 of the JAX trainer on every leaf after 3 rounds (the port
  takes the party mean as the gradient of the whole party batch, the JAX
  package as the psum of the ranks' shard means: fp32 rounding apart);
  codecs int8, 2bit and fp16 BIT-EXACT (each rank's gradient is one
  subtraction of its single row, so both packages feed their rings the
  same bits, and the rings are bit-exact); the parties bit-identical in
  every port run. ``torch.topk`` and ``lax.top_k`` break ties apart, so
  the selection must be tie-free: "none" keeps half of each key from
  random-float targets, the quantized codecs (whose outputs are
  multiples of a few steps, full of ties) keep every coordinate
  (threshold 1.0, as ``tests/test_mesh_quant.py`` does);
- an abort in the middle of a round re-seeds the ring residual on the
  trainer's own thread, before its next ring, never from the van thread;
- ``_ring_bytes``, ``RoundFuture.abort_pending`` and the store's
  ``_fail_fast_pending``;
- the port's ``examples/cnn.py`` ``run_worker`` against the JAX
  example's ``main`` under ``GEOMX_PARTY_MESH=1`` (the displacement
  check of ``tests/test_torch_feature_configs.py``: values within 1e-5,
  the displacement from the initial leaves within 1e-3 by relative norm);
- (slow, chaos) the surviving mesh party does not hang when a remote
  party's server is killed.
"""

import threading
import time
import weakref
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.cnn as jcnn
import geomx_tpu.simulate as jsim
import geomx_tpu_torch.simulate as tsim
from geomx_tpu.kvstore.mesh_party import KVStorePartyMesh as JaxMeshStore
from geomx_tpu.optimizer import SGD as JaxSGD
from geomx_tpu.parallel.mesh import make_party_mesh as jax_party_mesh
from geomx_tpu.trainer import Trainer as JaxTrainer
from geomx_tpu.trainer_device import DeviceResidentTrainer as JaxDRT
from geomx_tpu_torch import telemetry
from geomx_tpu_torch.examples import cnn
from geomx_tpu_torch.kvstore.frontier import RoundAborted, RoundFuture
from geomx_tpu_torch.kvstore.mesh_party import (KVStorePartyMesh,
                                                _ring_bytes)
from geomx_tpu_torch.optimizer import SGD
from geomx_tpu_torch.parallel import quant_collectives as qc
from geomx_tpu_torch.parallel.mesh import make_party_mesh
from geomx_tpu_torch.trainer import Trainer
from geomx_tpu_torch.trainer_device import DeviceResidentTrainer
from test_torch_feature_configs import (BATCH, DISP_TOL, _disp_err,
                                        _jax_example, _port_example)
from test_torch_hips import KITS, TIMEOUT, MixedHiPS
from torch_parity_kit import assert_adam_leaves_close, near_eps, record_grads

pytestmark = pytest.mark.mesh

ROUNDS = 5
SHAPES = [(4,), (2, 2)]
# per-(round, party, member) data: integers scaled by 2^-2, so every
# gradient and weight below is an exact fp32 value
_rng = np.random.RandomState(7)
DATA = [_rng.randint(-8, 9, size=(ROUNDS, 2, 2) + shp).astype(np.float32)
        * 0.25 for shp in SHAPES]


def _zeros():
    return [np.zeros(s, np.float32) for s in SHAPES]


def _master_init(kv):
    for i, w in enumerate(_zeros()):
        kv.init(i, w)
    kv.wait()


# -- dense FSA through Trainer ---------------------------------------------


def _torch_dense_grads(kv, w, r, p):
    """The party-mean gradient of the quadratic on the party's batch,
    split over the mesh's ranks, by torch autograd."""
    wd = [t.requires_grad_(True) for t in kv.put_replicated(
        [torch.from_numpy(l.copy()) for l in w])]
    X0, X1 = kv.shard_batch(DATA[0][r, p], DATA[1][r, p])
    assert tuple(X0.shape) == (2, 1, 4) and tuple(X1.shape) == (2, 1, 2, 2)
    d0 = wd[0][None] - X0.flatten(0, 1)
    d1 = wd[1][None] - X1.flatten(0, 1)
    loss = 0.5 * ((d0 * d0).sum(-1).mean() + (d1 * d1).sum((-2, -1)).mean())
    return torch.autograd.grad(loss, wd)


def _jax_dense_grads():
    def _loss(w0, w1, X0, X1):
        d0 = w0[None] - X0
        d1 = w1[None] - X1
        return 0.5 * (jnp.mean(jnp.sum(d0 * d0, axis=-1))
                      + jnp.mean(jnp.sum(d1 * d1, axis=(-2, -1))))

    gstep = jax.jit(jax.value_and_grad(_loss, argnums=(0, 1)))

    def grads(kv, w, r, p):
        wd = [kv.put_replicated(jnp.asarray(l)) for l in w]
        X0, X1 = kv.shard_batch(DATA[0][r, p], DATA[1][r, p])
        return [np.asarray(g) for g in gstep(wd[0], wd[1], X0, X1)[1]]

    return grads


def _mesh_dense_worker(topo, pkg, out):
    grads_of = _torch_dense_grads if pkg == "torch" else _jax_dense_grads()
    make = Trainer if pkg == "torch" else JaxTrainer

    def worker(kv):
        p = topo.workers.index(kv)
        assert kv.type == "dist_sync_mesh"
        assert kv.party_size == 2 and kv.num_workers == 1
        tr = make(_zeros(), kv)
        for r in range(ROUNDS):
            tr.step(grads_of(kv, tr.leaves, r, p))
        out[p] = [np.array(l) for l in tr.leaves]

    return worker


def _run_dense(topo, pkg):
    """Mesh parties: Trainer on each party's store, SGD on the global
    server; returns each party's leaves."""
    out = {}
    topo.start()
    try:
        topo.master.set_optimizer(
            (SGD if topo.master.__module__.startswith("geomx_tpu_torch")
             else JaxSGD)(learning_rate=0.25))
        _master_first_run(topo, _master_init,
                          _mesh_dense_worker(topo, pkg, out))
    finally:
        topo.stop()
    return out


def _master_first_run(topo, master, worker):
    done = threading.Event()

    def m(kv):
        try:
            master(kv)
        finally:
            done.set()

    def w(kv):
        if not done.wait(TIMEOUT):
            raise TimeoutError("the master did not finish its set-up")
        worker(kv)

    topo.run_workers(w, include_master=m, timeout=TIMEOUT)


def _run_wire_dense():
    """The port's 2 parties x 2 van workers, per-member host gradients
    (w - t)/2: a party's two members sum to the party-mean gradient."""
    topo = tsim.InProcessHiPS(num_parties=2, workers_per_party=2).start()
    out = {}
    try:
        topo.master.set_optimizer(SGD(learning_rate=0.25))

        def worker(kv):
            widx = topo.workers.index(kv)
            p, m = divmod(widx, 2)
            tr = Trainer(_zeros(), kv)
            for r in range(ROUNDS):
                w = tr.leaves
                tr.step([((w[i] - DATA[i][r, p, m]) / 2).astype(np.float32)
                         for i in range(len(SHAPES))])
            out[widx] = [np.array(l) for l in tr.leaves]

        _master_first_run(topo, _master_init, worker)
    finally:
        topo.stop()
    return out


_JAX_DENSE = {}


def _jax_dense():
    if not _JAX_DENSE:
        _JAX_DENSE.update(_run_dense(jsim.InProcessHiPS(
            num_parties=2, workers_per_party=2, party_mesh_size=2), "jax"))
    return _JAX_DENSE


def test_dense_fsa_through_trainer_is_bit_exact():
    """Exact: every input is an integer multiple of 2^-2 far below 2^24,
    so fp32 sums are exact in any order."""
    ref = _jax_dense()
    was = telemetry.enabled()
    try:
        telemetry.reset()
        telemetry.enable(True)
        wire = _run_wire_dense()
        wire_snap = telemetry.snapshot()
        telemetry.reset()
        telemetry.enable(True)
        mesh = _run_dense(tsim.InProcessHiPS(
            num_parties=2, workers_per_party=2, party_mesh_size=2,
            device="cpu"), "torch")
        mesh_snap = telemetry.snapshot()
    finally:
        telemetry.reset()
        telemetry.enable(was)
    for p in (0, 1):
        for a, b in zip(mesh[p], ref[p]):
            np.testing.assert_array_equal(a, b)
    for widx in range(4):
        for a, b in zip(wire[widx], ref[0]):
            np.testing.assert_array_equal(a, b)
    assert any(np.any(l != 0) for l in ref[0])       # it trained
    # the mesh tier's collectives count under tier=mesh, stay out of
    # wan_bytes, and the party members put no message on the LAN van
    assert telemetry.mesh_bytes(mesh_snap) == ROUNDS * 2 * _ring_bytes(
        2, sum(4 * int(np.prod(s)) for s in SHAPES))
    assert telemetry.mesh_bytes(wire_snap) == 0

    def local_msgs(snap):
        return sum(v for k, v in snap["counters"].items()
                   if k.startswith("van.messages_sent{")
                   and "tier=local" in k)

    assert local_msgs(mesh_snap) < local_msgs(wire_snap)
    for snap in (wire_snap, mesh_snap):
        assert telemetry.wan_bytes(snap) > 0
        for key in snap["counters"]:
            if key.startswith("mesh."):
                assert "tier=mesh" in key


class MixedMeshHiPS(MixedHiPS):
    """Two mesh parties whose schedulers and servers come from ``sched``
    / ``server`` and whose party workers are the ``worker`` package's
    ``KVStorePartyMesh`` (the master a plain store of that package): the
    van sees one worker per party, as in ``InProcessHiPS(
    party_mesh_size=2)``."""

    def __init__(self, sched, server, worker):
        super().__init__(sched, server, worker, num_parties=2,
                         workers_per_party=1)
        kit = KITS[worker]

        def make(sync_global, cfg):
            if cfg.is_master_worker:
                return kit.Dist(sync_global=sync_global, cfg=cfg)
            p = self.cports.index(cfg.ps_root_port) - 1
            if worker == "jax":
                return JaxMeshStore(sync_global=sync_global, cfg=cfg,
                                    mesh=jax_party_mesh(2, p))
            return KVStorePartyMesh(sync_global=sync_global, cfg=cfg,
                                    mesh=make_party_mesh(2, p, device="cpu"))

        self.kit["worker"] = SimpleNamespace(Config=kit.Config, Dist=make)


@pytest.mark.parametrize("sched,server,worker", [
    ("jax", "jax", "torch"),        # port mesh workers, JAX tiers
    ("torch", "torch", "jax"),      # JAX mesh workers, port tiers
])
def test_mixed_mesh_topology_is_bit_exact(sched, server, worker):
    ref = _jax_dense()
    got = _run_dense(MixedMeshHiPS(sched, server, worker), worker)
    for p in (0, 1):
        for a, b in zip(got[p], ref[p]):
            np.testing.assert_array_equal(a, b)


# -- DeviceResidentTrainer over the mesh store -----------------------------


LEAVES = [(2, 4), (3,), (5,)]
_trng = np.random.default_rng(5)
TARGETS = [_trng.standard_normal(s).astype(np.float32) for s in LEAVES]
BSC_ROUNDS = 3
# (round, party, party batch of 2 rows) shifts: one row per rank
SHIFTS = _trng.standard_normal((BSC_ROUNDS, 2, 2)).astype(np.float32)
BSC_KW = dict(learning_rate=0.25, momentum=0.0)
MESH_CFG = {"mesh_block": 4, "wire_2bit_threshold": 0.25}


def _bowl_jax(leaves, X, y):
    diffs = [w[None] - jnp.asarray(t)[None]
             + X.reshape((-1,) + (1,) * w.ndim)
             for w, t in zip(leaves, TARGETS)]
    loss = 0.5 * sum(jnp.mean(jnp.sum(d * d, axis=tuple(range(1, d.ndim))))
                     for d in diffs)
    return loss, [jnp.mean(d, axis=0) for d in diffs]


def _bowl_torch(leaves, X, y):
    diffs = [w[None] - torch.from_numpy(t)[None]
             + X.reshape((-1,) + (1,) * w.ndim)
             for w, t in zip(leaves, TARGETS)]
    loss = 0.5 * sum((d * d).sum(tuple(range(1, d.ndim))).mean()
                     for d in diffs)
    return loss, [d.mean(0) for d in diffs]


def _run_bsc(pkg, codec):
    sim = tsim if pkg == "torch" else jsim
    kw = {"device": "cpu"} if pkg == "torch" else {}
    topo = sim.InProcessHiPS(num_parties=2, workers_per_party=2,
                             party_mesh_size=2,
                             extra_cfg={"mesh_codec": codec, **MESH_CFG},
                             **kw).start()
    out = {}
    try:
        def worker(kv):
            p = topo.workers.index(kv)
            assert kv.mesh_codec == codec
            leaves = [np.zeros(s, np.float32) for s in LEAVES]
            kw = dict(BSC_KW, threshold=0.5 if codec == "none" else 1.0)
            if pkg == "torch":
                tr = DeviceResidentTrainer(leaves, kv, _bowl_torch,
                                           device="cpu", **kw)
            else:
                tr = JaxDRT(leaves, kv, _bowl_jax, **kw)
            assert tr._mesh_quant == (codec != "none")
            for r in range(BSC_ROUNDS):
                tr.step(SHIFTS[r, p], None)
            out[p] = [np.array(l) for l in tr.leaves]

        def master(kv):
            for i, s in enumerate(LEAVES):
                kv.init(i, np.zeros(s, np.float32))
            kv.wait()

        _master_first_run(topo, master, worker)
    finally:
        topo.stop()
    return out


@pytest.mark.parametrize("codec", ["none", "int8", "2bit", "fp16"])
def test_device_trainer_mesh_round_matches_jax(codec):
    want = _run_bsc("jax", codec)
    got = _run_bsc("torch", codec)
    for a, b in zip(got[0], got[1]):            # parties bit-identical
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[0], want[0]):
        assert not np.array_equal(a, np.zeros_like(a))
        if codec == "none":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(a.view(np.int32),
                                          b.view(np.int32))


def test_abort_mid_round_reseeds_the_residual_on_the_trainer_thread(
        monkeypatch):
    """The store's round-abort hook fires on another thread while the
    trainer is inside a round: the residual tensor is not touched from
    there; the trainer's next ring starts from zero."""
    import geomx_tpu_torch.trainer_device as td

    topo = tsim.InProcessHiPS(num_parties=2, workers_per_party=2,
                              party_mesh_size=2, device="cpu",
                              extra_cfg={"mesh_codec": "2bit",
                                         **MESH_CFG}).start()
    seen, box = [], {}
    real_ring = qc.ring_all_reduce

    def ring(stack, res, **kw):
        seen.append((threading.get_ident(), bool((res == 0).all())))
        return real_ring(stack, res, **kw)

    monkeypatch.setattr(td.qc, "ring_all_reduce", ring)

    def grad(leaves, X, y):
        tr, kv = box.get(threading.get_ident(), (None, None))
        if tr is not None and tr.rounds == 2 and not tr.aborted:
            tr.aborted = True
            before = tr._mesh_res
            t = threading.Thread(target=kv._fail_fast_pending,
                                 args=("remote server declared dead",))
            t.start()
            t.join(TIMEOUT)
            assert tr._mesh_res is before       # untouched mid-round
            assert tr._mesh_res_stale.is_set()
        return _bowl_torch(leaves, X, y)

    try:
        def worker(kv):
            p = topo.workers.index(kv)
            tr = DeviceResidentTrainer(
                [np.zeros(s, np.float32) for s in LEAVES], kv, grad,
                device="cpu", threshold=1.0, **BSC_KW)
            tr.rounds, tr.aborted = 0, False
            box[threading.get_ident()] = (tr, kv)
            for r in range(BSC_ROUNDS):
                tr.rounds = r
                tr.step(SHIFTS[r, p], None)
            assert not tr._mesh_res_stale.is_set()

        def master(kv):
            for i, s in enumerate(LEAVES):
                kv.init(i, np.zeros(s, np.float32))
            kv.wait()

        _master_first_run(topo, master, worker)
    finally:
        topo.stop()
    by_thread = {}
    for tid, zero in seen:
        by_thread.setdefault(tid, []).append(zero)
    assert len(by_thread) == 2
    for zeros in by_thread.values():
        # round 0 starts at zero; round 1 carries error; round 2's ring,
        # after the abort, starts at zero again
        assert zeros == [True, False, True]


# -- the store's pieces ----------------------------------------------------


def test_ring_bytes_model():
    assert _ring_bytes(1, 1000) == 0
    assert _ring_bytes(2, 1000) == 2000
    assert _ring_bytes(4, 1000) == 6000


def test_abort_pending_unblocks_joiners_immediately():
    fut = RoundFuture([0, 1, 2])
    fut.complete_key(0, "done")
    woke = {}

    def join():
        t0 = time.monotonic()
        try:
            fut.wait(timeout=30.0)
        except RoundAborted as e:
            woke["exc"] = e
        woke["elapsed"] = time.monotonic() - t0

    t = threading.Thread(target=join, daemon=True)
    t.start()
    time.sleep(0.1)
    fut.abort_pending("round aborted: remote server declared dead")
    t.join(5.0)
    assert not t.is_alive()
    assert isinstance(woke.get("exc"), RoundAborted)
    assert woke["elapsed"] < 5.0
    assert fut.done()


def test_fail_fast_pending_aborts_watched_futures():
    """The round-abort hook fails every live future the store issued
    (the WeakSet drops collected ones), runs the trainers' reset hooks,
    and re-seeds the keyed reducers before their next ring."""
    store = object.__new__(KVStorePartyMesh)
    store._live_futs = weakref.WeakSet()
    store._residual_reset_hooks = []
    store._reset_pending = threading.Event()
    store.mesh = make_party_mesh(2, device="cpu")
    store.mesh_codec, store.mesh_block = "int8", 4
    store.cfg = SimpleNamespace(wire_2bit_threshold=0.5)
    store._reducers = {}
    red = store.ring_reducer(0, 8)
    red.reduce(torch.randn(2, 8, generator=torch.Generator().manual_seed(0)))
    assert bool((red._res != 0).any())
    resets = []
    store.register_residual_reset_hook(lambda: resets.append(1))
    fut = store._watch(RoundFuture([0, 1]))
    gone = store._watch(RoundFuture([7]))
    del gone
    store._fail_fast_pending("server 9 declared dead")
    with pytest.raises(RoundAborted):
        fut.wait(timeout=1.0)
    assert resets == [1]
    assert bool((red._res != 0).any())          # not from this thread
    assert store.ring_reducer(0, 8) is red
    assert bool((red._res == 0).all())


# -- the example loop ------------------------------------------------------


def test_cnn_example_under_party_mesh_matches_the_jax_example(
        monkeypatch, tmp_path, capsys):
    """``GEOMX_PARTY_MESH=1``: each party's one worker trains on the
    party batch over its mesh store; the port's run_worker against the
    JAX example's main, from the JAX package's initial leaves."""
    from examples.utils import build_model_and_step as jax_cnn

    monkeypatch.setenv("GEOMX_PARTY_MESH", "1")
    init = jax_cnn(BATCH)[0]
    argv = ["--max-iters", "3", "-bs", str(BATCH)]
    topo_kw = {"party_mesh_size": 2}
    jax_grads = record_grads(jcnn, monkeypatch)
    want = _jax_example(jcnn, argv, topo_kw, monkeypatch, tmp_path)
    topo_kw["device"] = "cpu"
    got = _port_example(cnn, argv, topo_kw, init, monkeypatch, tmp_path)
    near = near_eps(jax_grads)
    for w in (0, 1):
        last = want[w][-1]
        for g, r, i in zip(got[w]["leaves"], last, init):
            assert not np.array_equal(g, i)
        # Adam at lr 1e-3, 3 steps; gradients near its eps bounded apart
        assert_adam_leaves_close(got[w]["leaves"], last, near, 1e-5,
                                 lr=1e-3, steps=3)
        assert _disp_err(got[w]["leaves"], last, init) <= DISP_TOL
        assert _disp_err(want[w][-2], last, init) > DISP_TOL
    for a, b in zip(got[0]["leaves"], got[1]["leaves"]):
        np.testing.assert_array_equal(a, b)
    assert "[Iteration 3] Test Acc" in capsys.readouterr().out


# -- chaos -----------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.chaos
def test_mesh_party_survives_remote_server_kill():
    """A remote party's server is killed mid-training; the surviving mesh
    party's round completes, aborts or times out — it never hangs."""
    from geomx_tpu_torch.kvstore.server import KVStoreDistServer

    sim = tsim.InProcessHiPS(
        num_parties=2, workers_per_party=2, party_mesh_size=2, device="cpu",
        extra_cfg={"heartbeat_interval_s": 0.2,
                   "heartbeat_timeout_s": 1.0}).start()
    try:
        sim.master.set_optimizer(SGD(learning_rate=1.0))
        w0 = np.zeros(6, np.float32)
        g = np.ones(6, np.float32)

        def init_and_round(kv):
            kv.init(0, w0)
            outb = np.zeros_like(w0)
            kv.pull(0, out=outb)
            kv.wait()
            kv.push_pull(0, g, outb, priority=0)
            kv.wait()

        sim.master.init(0, w0)
        sim.master.wait()
        sim.run_workers(init_and_round, timeout=120)
        victim = sim.servers[2]
        assert not victim.is_global_server
        victim.crash()
        survivor = sim.workers[0]
        done = {}

        def survivor_round():
            outb = np.zeros_like(w0)
            try:
                survivor.push_pull(0, g, outb, priority=0)
                survivor.wait(timeout=60.0)
                done["outcome"] = "completed"
            except RoundAborted:
                done["outcome"] = "aborted"
            except TimeoutError:
                done["outcome"] = "timeout"

        t = threading.Thread(target=survivor_round, daemon=True)
        t.start()
        t.join(90.0)
        assert not t.is_alive(), "the mesh party hung after the remote " \
            "server died"
        assert done["outcome"] in ("completed", "aborted", "timeout")
        revived = KVStoreDistServer(victim.cfg)
        rt = threading.Thread(target=revived.run, daemon=True)
        rt.start()
        sim.threads.append(rt)
        for _ in range(300):
            if revived._ready.is_set():
                break
            time.sleep(0.1)
        assert revived._ready.is_set(), "revived party server not ready"
        sim.servers[2] = revived
    finally:
        sim.stop()
