"""The port's HiPS host tiers against the JAX package's, bit for bit.

Both packages speak one wire (``ps/message.py``, BINMETA_VERSION 4), so
the same integer-valued rounds through the port's ``InProcessHiPS``, the
JAX package's, and mixed topologies (port workers against JAX-package
schedulers and servers, and JAX workers against port schedulers and
servers) must give identical results: dense push/pull, ``push_bsc`` /
``pull_bsc`` and the batch variants, sharded and not. Integer values keep
every sum exact whatever order the servers add in, so any departure is a
protocol or codec fault, not rounding.
"""

import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import geomx_tpu.config as jcfg
import geomx_tpu.kvstore.dist as jdist
import geomx_tpu.kvstore.server as jserver
import geomx_tpu.ps.base as jbase
import geomx_tpu.ps.message as jmsg
import geomx_tpu.ps.postoffice as jpo
import geomx_tpu.simulate as jsim
import geomx_tpu_torch.config as tcfg
import geomx_tpu_torch.kvstore.dist as tdist
import geomx_tpu_torch.kvstore.server as tserver
import geomx_tpu_torch.ps.base as tbase
import geomx_tpu_torch.ps.message as tmsg
import geomx_tpu_torch.ps.postoffice as tpo
import geomx_tpu_torch.simulate as tsim

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 60.0          # per topology: a hang fails the test, never the run

KITS = {
    "jax": SimpleNamespace(Config=jcfg.Config, Postoffice=jpo.Postoffice,
                           Role=jmsg.Role, psbase=jbase,
                           Server=jserver.KVStoreDistServer,
                           Dist=jdist.KVStoreDist),
    "torch": SimpleNamespace(Config=tcfg.Config, Postoffice=tpo.Postoffice,
                             Role=tmsg.Role, psbase=tbase,
                             Server=tserver.KVStoreDistServer,
                             Dist=tdist.KVStoreDist),
}


class MixedHiPS(tsim.InProcessHiPS):
    """``InProcessHiPS`` whose roles come from either package: the
    schedulers from ``sched``, the servers of both tiers from
    ``server``, the party workers and the master from ``worker``. The
    wiring mirrors ``geomx_tpu/simulate.py`` ``_start_once``."""

    def __init__(self, sched: str, server: str, worker: str, **kw):
        super().__init__(**kw)
        self.kit = {"sched": KITS[sched], "server": KITS[server],
                    "worker": KITS[worker]}

    def _cfg(self, pkg_of: str, **kw):
        base = dict(
            ps_global_root_uri="127.0.0.1", ps_global_root_port=self.gport,
            num_global_workers=self.ngw, num_global_servers=self.ngs,
            num_parties=0, num_all_workers=self.num_all,
            enable_central_worker=False, bigarray_bound=self.bigarray_bound)
        base.update(kw)
        return self.kit[pkg_of].Config(**base)

    def _run_sched(self, root_port, is_global, nw, ns):
        k = self.kit["sched"]
        po = k.Postoffice(my_role=k.Role.SCHEDULER, is_global=is_global,
                          root_uri="127.0.0.1", root_port=root_port,
                          num_workers=nw, num_servers=ns, cfg=k.Config())
        po.start(60.0)
        po.barrier(k.psbase.ALL_GROUP, timeout=120.0)
        po.barrier(k.psbase.ALL_GROUP, timeout=600.0)
        po.van.stop()

    def _server(self, **kw):
        srv = self.kit["server"].Server(self._cfg("server", **kw))
        self.servers.append(srv)
        self._spawn(srv.run)

    def _start_once(self):
        self._spawn(self._run_sched, self.gport, True, self.ngw, self.ngs)
        self._spawn(self._run_sched, self.cports[0], False, 1, self.ngs)
        for _ in range(self.ngs):
            self._server(role="server", role_global="global_server",
                         ps_root_uri="127.0.0.1",
                         ps_root_port=self.cports[0], num_workers=1,
                         num_servers=self.ngs)
        Dist = self.kit["worker"].Dist
        boxes = []
        for p in range(self.num_parties):
            port = self.cports[p + 1]
            self._spawn(self._run_sched, port, False, self.wpp, self.spp)
            for _ in range(self.spp):
                self._server(role="server", ps_root_uri="127.0.0.1",
                             ps_root_port=port, num_workers=self.wpp,
                             num_servers=self.spp)
            for _ in range(self.wpp):
                c = self._cfg("worker", role="worker",
                              ps_root_uri="127.0.0.1", ps_root_port=port,
                              num_workers=self.wpp, num_servers=self.spp)
                box = []
                boxes.append(box)
                self._spawn(lambda b=box, c=c: b.append(
                    Dist(sync_global=True, cfg=c)))
        mc = self._cfg("worker", role="worker", is_master_worker=True,
                       ps_root_uri="127.0.0.1", ps_root_port=self.cports[0],
                       num_workers=1, num_servers=self.ngs)
        mbox = []
        self._spawn(lambda: mbox.append(Dist(sync_global=True, cfg=mc)))
        for _ in range(int(TIMEOUT * 10)):
            if self.errors:
                raise self.errors[0]
            if mbox and all(boxes):
                break
            threading.Event().wait(0.1)
        if not (mbox and all(boxes)):
            raise TimeoutError("mixed topology failed to start")
        self.master = mbox[0]
        self.workers = [b[0] for b in boxes]
        return self


N_SMALL, N_BIG = 40, 64
KEYS = (7, 9)
SIZES = {7: N_SMALL, 9: N_BIG}


def _sparse(rng, n, k):
    idx = np.sort(rng.choice(n, k, replace=False)).astype(np.int64)
    return rng.integers(-8, 9, k).astype(np.float32), idx


def _canon(vals, idx):
    """A sparse aggregate in index order: sharded pulls concatenate the
    shards in arrival order, which no package fixes."""
    order = np.argsort(idx, kind="stable")
    return [vals[order], idx[order]]


def _workload(kv, widx):
    """Two dense rounds per key, then every sparse form: single-key
    ``push_bsc``/``pull_bsc``, ``push_bsc_batch`` + ``pull_bsc_batch``,
    the combined ``push_pull_bsc_batch`` and its async twin."""
    out = []
    for key in KEYS:
        kv.init(key, np.zeros(SIZES[key], np.float32))
    kv.pull(KEYS[0], out=np.zeros(N_SMALL, np.float32))
    kv.wait()
    rng = np.random.default_rng(100 + widx)
    for _ in range(2):
        for key in KEYS:
            kv.push(key, rng.integers(-8, 9, SIZES[key]).astype(np.float32))
            o = np.zeros(SIZES[key], np.float32)
            kv.pull(key, out=o)
            kv.wait()
            out.append(o)
    vals, idx = _sparse(rng, N_BIG, 6)
    kv.push_bsc(9, vals, idx)
    out.extend(_canon(*kv.pull_bsc(9)()))
    for form in ("batch", "combined", "async"):
        parts = [_sparse(rng, SIZES[k], 5) for k in KEYS]
        vl, il = [p[0] for p in parts], [p[1] for p in parts]
        if form == "batch":
            kv.push_bsc_batch(list(KEYS), vl, il)
            agg = kv.pull_bsc_batch(list(KEYS))()
        elif form == "combined":
            agg = kv.push_pull_bsc_batch(list(KEYS), vl, il)()
        else:
            agg = kv.push_pull_bsc_batch_async(list(KEYS), vl, il).results()
        for k in KEYS:
            out.extend(_canon(*agg[k]))
    return out


def _run(topo):
    topo.start()
    res = {}
    try:
        def master_init(kv):
            for key in KEYS:
                kv.init(key, np.zeros(SIZES[key], np.float32))
            kv.wait()

        def worker(kv):
            widx = topo.workers.index(kv)
            res[widx] = _workload(kv, widx)

        topo.run_workers(worker, include_master=master_init,
                         timeout=TIMEOUT)
    finally:
        topo.stop()
    return [res[w] for w in sorted(res)]


def _topo_kw(sharded):
    kw = dict(num_parties=2, workers_per_party=1)
    if sharded:
        # two servers per party and a bigarray bound below the key size:
        # each key's selection is partitioned across server shards
        kw.update(servers_per_party=2, bigarray_bound=16)
    return kw


def _assert_same(got, want):
    assert len(got) == len(want)
    for g_w, r_w in zip(got, want):
        assert len(g_w) == len(r_w)
        for a, b in zip(g_w, r_w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


_REF = {}


def _reference(sharded):
    """The all-JAX-package run, once per layout."""
    if sharded not in _REF:
        _REF[sharded] = _run(jsim.InProcessHiPS(**_topo_kw(sharded)))
    return _REF[sharded]


@pytest.mark.parametrize("sharded", [False, True])
def test_port_hips_matches_the_jax_package(sharded):
    ref = _reference(sharded)
    got = _run(tsim.InProcessHiPS(**_topo_kw(sharded)))
    _assert_same(got, ref)
    # FSA: both workers see the same aggregates
    _assert_same([got[0]], [got[1]])
    # the dense rounds really aggregated both workers' pushes
    assert np.abs(got[0][0]).sum() > 0


@pytest.mark.parametrize("sched,server,worker", [
    ("jax", "jax", "torch"),         # port workers, JAX tiers
    ("torch", "torch", "jax"),       # JAX workers, port tiers
])
def test_mixed_topology_matches_the_jax_package(sched, server, worker):
    ref = _reference(True)
    got = _run(MixedHiPS(sched, server, worker, **_topo_kw(True)))
    _assert_same(got, ref)


def test_mesh_party_refused_up_front():
    with pytest.raises(NotImplementedError, match="item 9"):
        tsim.InProcessHiPS(num_parties=2, party_mesh_size=2)


def test_simulate_import_leaves_jax_out_of_the_process():
    code = ("import sys\n"
            "import geomx_tpu_torch.simulate\n"
            "import geomx_tpu_torch.kvstore_server\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'geomx_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_checkpoint_format_round_trips(tmp_path):
    """The port's framework-neutral format (numpy + JSON header) keeps
    what server snapshots and checkpoints hold: int and (key, offset)
    keys, nested dicts, lists, tuples, bytes, scalars and arrays of any
    dtype, as writable copies."""
    from geomx_tpu_torch import checkpoint as ck

    states = {3: np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2].T,
              (9, 16): {"mom": np.ones(4, np.float16), "t": 7},
              np.int64(5): [np.array(2.5), None, "x", (1, 2.0)]}
    back = ck.deserialize_states(ck.serialize_states(states))
    assert set(back) == {3, (9, 16), 5}
    np.testing.assert_array_equal(back[3], states[3])
    assert back[(9, 16)]["mom"].dtype == np.float16 and back[(9, 16)]["t"] == 7
    assert back[5][1:] == [None, "x", (1, 2.0)]
    assert back[5][0].shape == () and float(back[5][0]) == 2.5
    back[3][0, 0] = -1.0                          # writable
    doc = ck.deserialize_blob(ck.serialize_blob(
        {"entries": ck.serialize_states(states), "epoch": 2}))
    assert doc["epoch"] == 2 and isinstance(doc["entries"], bytes)
    prefix = str(tmp_path / "run")
    for epoch in (1, 12):
        ck.save_checkpoint(prefix, epoch, [states[3]], {"lr": 0.1},
                           {"it": epoch})
    assert ck.latest_checkpoint(prefix) == 12
    params, opt, meta = ck.load_checkpoint(prefix, 12)
    np.testing.assert_array_equal(params[0], states[3])
    assert opt == {"lr": 0.1} and meta == {"it": 12}
    with pytest.raises(ValueError, match="magic"):
        ck.deserialize_blob(b"not a checkpoint")


def test_wan_bytes_count_the_same_wire():
    """``telemetry.wan_bytes`` counts the same global-tier bytes in both
    packages for the same rounds: the messages are byte for byte the
    same size."""
    import geomx_tpu.telemetry as jtel
    import geomx_tpu_torch.telemetry as ttel

    counted = {}
    for name, tel, sim in (("jax", jtel, jsim), ("torch", ttel, tsim)):
        was = tel.enabled()
        tel.enable(True)
        try:
            before = tel.wan_bytes()
            _run(sim.InProcessHiPS(**_topo_kw(False)))
            counted[name] = tel.wan_bytes() - before
        finally:
            tel.enable(was)
    assert counted["torch"] == counted["jax"] > 0
