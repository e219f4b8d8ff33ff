"""Failure detection and recovery in the port, against an uninterrupted
port run.

The port's counterpart of ``tests/test_recovery.py`` for every case that
needs no checkpoint blob to cross packages (the two packages' blob
formats differ; ROADMAP queue C). A node is killed mid-training (hard van
stop, no goodbye), the scheduler sees its heartbeats lapse, a new node
takes the dead slot (reference: 3rdparty/ps-lite/src/van.cc:176-193,
``is_recovery``), and training resumes. Each case runs the same rounds
on the same inputs without the kill, and the recovered run must pull the
same parameters, bit for bit (integer-valued gradients).

Every op has a short deadline (``op_timeout_s``) and every case a wall
deadline of its own: a round that never completes fails its test and
never holds the worker process.
"""

import functools
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import geomx_tpu.config as jcfg
import geomx_tpu.kvstore.dist as jdist
import geomx_tpu.kvstore.server as jserver
import geomx_tpu.optimizer as jopt
import geomx_tpu.ps.base as jbase
import geomx_tpu.ps.message as jmsg
import geomx_tpu.ps.postoffice as jpo
from geomx_tpu_torch.config import Config
from geomx_tpu_torch.kvstore import sharding
from geomx_tpu_torch.kvstore.dist import KVStoreDist
from geomx_tpu_torch.kvstore.server import KVStoreDistServer
from geomx_tpu_torch.optimizer import SGD
from geomx_tpu_torch.ps import base as psbase
from geomx_tpu_torch.ps.message import Role
from geomx_tpu_torch.ps.postoffice import Postoffice
from geomx_tpu_torch.simulate import InProcessHiPS, free_port
from torch_parity_kit import parallel, within

PORT = SimpleNamespace(Config=Config, Postoffice=Postoffice, Role=Role,
                       psbase=psbase, Server=KVStoreDistServer,
                       Dist=KVStoreDist, SGD=SGD)
JAX = SimpleNamespace(Config=jcfg.Config, Postoffice=jpo.Postoffice,
                      Role=jmsg.Role, psbase=jbase,
                      Server=jserver.KVStoreDistServer,
                      Dist=jdist.KVStoreDist, SGD=jopt.SGD)

HB = {"heartbeat_interval_s": 0.2, "heartbeat_timeout_s": 1.0,
      "op_timeout_s": 20.0}
# In-place recovery (the reference's: a replacement takes the dead slot
# and joins the round in flight) against elastic membership (the
# scheduler declares a lapsed node dead and the server releases the
# round without it). With no grace the declaration follows the lapse by
# one membership period and races the survivor's push: released first,
# the replacement's push waits for a round its peer has left. The
# in-place cases hold the declaration off past the revival; the elastic
# order has a case of its own.
IN_PLACE = dict(HB, epoch_grace_s=60.0)
CASE_S = 90.0               # wall deadline of one case, both runs
OP_S = 30.0                 # one parallel step of a case


class SingleTier:
    """scheduler + N servers + 2 workers of ``kit``'s package (the port
    by default), fast heartbeats; ``extra`` merges into every node's
    Config."""

    def __init__(self, extra=None, num_servers=1, num_workers=2, kit=PORT):
        self.kit = kit
        self.port = free_port()
        self.extra = dict(extra or {})
        self.num_servers = num_servers
        self.num_workers = num_workers
        self.threads = []
        self.errors = []
        self.sched_po = None
        self.server = None
        self.servers = []
        self.workers = []

    def _run(self, fn):
        def w():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001
                self.errors.append(e)

        t = threading.Thread(target=w, daemon=True)
        t.start()
        self.threads.append(t)

    def _cfg(self, **kw):
        base = dict(ps_root_uri="127.0.0.1", ps_root_port=self.port,
                    num_workers=self.num_workers,
                    num_servers=self.num_servers, **HB)
        base.update(self.extra)
        base.update(kw)
        return self.kit.Config(**base)

    def start(self):
        k = self.kit
        sched_cfg = dict(HB)
        sched_cfg.update(self.extra)
        self.sched_po = k.Postoffice(
            my_role=k.Role.SCHEDULER, is_global=False,
            root_uri="127.0.0.1", root_port=self.port,
            num_workers=self.num_workers, num_servers=self.num_servers,
            cfg=k.Config(**sched_cfg))

        def sched():
            self.sched_po.start(30)
            self.sched_po.barrier(k.psbase.ALL_GROUP, timeout=30)
            self.sched_po.barrier(k.psbase.ALL_GROUP, timeout=CASE_S)
            self.sched_po.van.stop()

        self._run(sched)
        self.servers = [k.Server(self._cfg(role="server"))
                        for _ in range(self.num_servers)]
        self.server = self.servers[0]
        for s in self.servers:
            self._run(s.run)
        boxes = [[] for _ in range(self.num_workers)]
        for i in range(self.num_workers):
            self._run(lambda b=boxes[i]: b.append(
                k.Dist(cfg=self._cfg(role="worker"))))
        for _ in range(300):
            if self.errors:
                raise self.errors[0]
            if all(len(b) == 1 for b in boxes):
                break
            time.sleep(0.1)
        assert all(len(b) == 1 for b in boxes), "workers failed to start"
        self.workers = [b[0] for b in boxes]
        return self

    def rank(self, r):
        return next(kv for kv in self.workers if kv.rank == r)

    def close(self):
        parallel([kv.close for kv in self.workers], OP_S)
        for t in self.threads:
            t.join(5)
        if self.errors:
            raise self.errors[0]


def _wait_dead(topo, dead_id, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if dead_id in topo.sched_po.van.dead_nodes():
            return
        time.sleep(0.1)
    assert dead_id in topo.sched_po.van.dead_nodes()


def _revive_server(topo, **cfg_kw):
    revived = KVStoreDistServer(topo._cfg(role="server", **cfg_kw))
    t = threading.Thread(target=revived.run, daemon=True)
    t.start()
    topo.threads.append(t)
    for _ in range(300):
        if revived._ready.is_set():
            break
        time.sleep(0.1)
    assert revived._ready.is_set(), "revived server never became ready"
    return revived


# one round's wire: "single" (push then pull per key), "batched" (the
# list wire), "combined" (push_pull)
def _round(kv, keys, w0, wire):
    grads = [np.ones_like(w0[k]) for k in keys]
    outs = [np.zeros_like(w0[k]) for k in keys]
    if wire == "combined":
        kv.push_pull(keys, grads, out=outs)
    elif wire == "batched":
        kv.push(keys, grads)
        kv.pull(keys, out=outs)
    else:
        for k, g, o in zip(keys, grads, outs):
            kv.push(k, g)
            kv.pull(k, out=o)
    kv.wait()
    return outs


def _pull_now(kv, key, like):
    out = np.zeros_like(like)
    kv.pull(key, out=out)
    kv.wait()
    return out


def _uninterrupted(w0, wire, rounds, extra=IN_PLACE, num_servers=1):
    """Both workers, ``rounds`` rounds, no kill: each round's pulls by
    rank."""
    def body():
        topo = SingleTier(extra=extra, num_servers=num_servers).start()
        keys = sorted(w0)
        try:
            topo.rank(0).set_optimizer(SGD(learning_rate=1.0))
            parallel([lambda kv=kv: [kv.init(k, w0[k]) for k in keys]
                      for kv in topo.workers], OP_S)
            return [parallel([lambda r=r: _round(topo.rank(r), keys, w0, wire)
                              for r in (0, 1)], OP_S)
                    for _ in range(rounds)]
        finally:
            topo.close()

    return within(CASE_S, body)


def _same(got, want):
    """Nested lists of arrays, bit for bit."""
    if isinstance(got, np.ndarray):
        np.testing.assert_array_equal(got, want)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def _worker_dies(w0, wire, kit=PORT, elastic=False):
    """Round 1 with both workers; the rank-1 worker is hard-killed. In
    place (the reference's recovery): the survivor's round 2 blocks on
    the missing peer until a new worker takes the dead slot and joins
    round 2; round 3 with the recovered pair. ``elastic``: the scheduler
    declares the dead worker first, the server releases the survivor's
    round 2 without it, and the new worker joins at round 3. Returns
    each round's pulls by rank (round 2: the survivor's alone if
    ``elastic``)."""
    def body():
        topo = SingleTier(extra=HB if elastic else IN_PLACE, kit=kit).start()
        keys = sorted(w0)
        try:
            rank0, victim = topo.rank(0), topo.rank(1)
            rank0.set_optimizer(kit.SGD(learning_rate=1.0))
            parallel([lambda kv=kv: [kv.init(k, w0[k]) for k in keys]
                      for kv in topo.workers], OP_S)
            rounds = [parallel([lambda kv=kv: _round(kv, keys, w0, wire)
                                for kv in (rank0, victim)], OP_S)]

            dead_id = victim.po.my_id
            victim._closed = True          # disarm its atexit close
            victim.po.van.stop()           # no goodbye, no barrier
            _wait_dead(topo, dead_id)

            box = {}

            def survivor():
                box[0] = _round(rank0, keys, w0, wire)

            def revive():
                revived = kit.Dist(cfg=topo._cfg(role="worker"))
                box["kv"] = revived
                assert revived.po.van.is_recovery, \
                    "the scheduler did not hand over the slot"
                assert revived.po.my_id == dead_id and revived.rank == 1
                for k in keys:
                    revived.init(k, w0[k])  # key info; the store is live
                if not elastic:
                    box[1] = _round(revived, keys, w0, wire)

            try:
                if elastic:
                    van = topo.server.po_local.van
                    deadline = time.monotonic() + 10
                    while (dead_id not in van.declared_dead_ids()
                           and time.monotonic() < deadline):
                        time.sleep(0.05)
                    assert dead_id in van.declared_dead_ids()
                    parallel([survivor], OP_S)
                    parallel([revive], OP_S)
                else:
                    parallel([survivor, revive], OP_S)
            finally:
                if "kv" in box:
                    topo.workers = [rank0, box["kv"]]
            rounds.append([box[0], box[1]] if not elastic else [box[0]])
            rounds.append(parallel(
                [lambda kv=kv: _round(kv, keys, w0, wire)
                 for kv in (rank0, box["kv"])], OP_S))
            return rounds
        finally:
            topo.close()

    return within(CASE_S, body)


W1 = {0: np.full(12, 10.0, np.float32)}
W2 = {0: np.full(12, 10.0, np.float32), 1: np.full(5, -3.0, np.float32)}


def test_worker_dies_and_recovers_mid_training():
    got = _worker_dies(W1, "single")
    _same(got, _uninterrupted(W1, "single", 3))
    np.testing.assert_array_equal(got[2][0][0], W1[0] - 6.0)


def test_worker_recovery_with_batched_wire():
    """The batched list wire across a worker death: one merged ack per
    server must survive the re-registration."""
    got = _worker_dies(W2, "batched")
    _same(got, _uninterrupted(W2, "batched", 3))
    np.testing.assert_array_equal(got[2][1][1], W2[1] - 6.0)


def test_worker_recovery_with_push_pull_wire():
    """The combined push_pull wire across a worker death: the merged ack
    carrying post-round parameters must survive the re-registration."""
    got = _worker_dies(W2, "combined")
    _same(got, _uninterrupted(W2, "combined", 3))
    np.testing.assert_array_equal(got[2][0][0], W2[0] - 6.0)


def test_worker_declared_dead_rejoins_at_the_next_round():
    """Elastic membership, with no grace: the scheduler declares the
    killed worker dead, the server releases the survivor's round 2 with
    its push alone, and the replacement's first push joins round 3 —
    the same values as the JAX package's run of the same rounds."""
    got = _worker_dies(W1, "single", elastic=True)
    np.testing.assert_array_equal(got[1][0][0], W1[0] - 3.0)
    np.testing.assert_array_equal(got[2][0][0], W1[0] - 5.0)
    _same(got, _worker_dies(W1, "single", kit=JAX, elastic=True))


def _server_dies(extra=None, num_servers=1, restore=None):
    """Two rounds, the server holding key 0 hard-killed, a new server in
    its slot, then (``restore`` None: a volatile store) re-init, re-ship
    the optimizer and one more round, or (``restore``: the state came
    back from "snapshot" or "replica") the pre-crash pull with no re-init
    and one more round. Returns [round 1, round 2, pre-crash pull or
    None, last round] by rank."""
    w0 = {0: np.full(8, 4.0, np.float32)}

    def body():
        topo = SingleTier(extra=extra, num_servers=num_servers).start()
        try:
            rank0 = topo.rank(0)
            rank0.set_optimizer(SGD(learning_rate=1.0))
            parallel([lambda kv=kv: kv.init(0, w0[0])
                      for kv in topo.workers], OP_S)
            rounds = [parallel([lambda r=r: _round(topo.rank(r), [0], w0,
                                                   "single")
                                for r in (0, 1)], OP_S) for _ in range(2)]
            if restore is not None:
                time.sleep(0.6)            # snapshot ticks / replica deltas
            owner = sharding.assign(0, 8, num_servers,
                                    topo._cfg().bigarray_bound)[0].server_rank
            victim = next(s for s in topo.servers
                          if s.po_local.my_rank == owner)
            if restore == "snapshot":
                assert victim.replication.num_snapshots > 0
            dead_id = victim.po_local.my_id
            if restore is None:
                victim._stop.set()             # stop the run loop...
                victim.po_local.van.stop()     # ...and crash the van
            else:
                victim.crash()                 # no flush, no barrier
            _wait_dead(topo, dead_id)

            revived = _revive_server(topo)
            topo.servers = [revived if s is victim else s
                            for s in topo.servers]
            assert revived.po_local.van.is_recovery
            assert revived.po_local.my_id == dead_id
            if restore is None:
                pre = None
                rank0.set_optimizer(SGD(learning_rate=1.0))
                parallel([lambda kv=kv: kv.init(0, w0[0])
                          for kv in topo.workers], OP_S)
            else:
                assert revived.replication.restored_from == restore
                pre = [_pull_now(topo.rank(r), 0, w0[0]) for r in (0, 1)]
            rounds.append(pre)
            rounds.append(parallel(
                [lambda r=r: _round(topo.rank(r), [0], w0, "single")
                 for r in (0, 1)], OP_S))
            return rounds
        finally:
            topo.close()

    return within(CASE_S, body), w0


def test_server_dies_and_recovers_mid_training():
    """The store is volatile without snapshots (reference: SURVEY.md
    §5.4): after the handover the workers re-init and re-ship the
    optimizer, and training resumes from the re-initialized weights,
    as an uninterrupted run's first round."""
    got, w0 = _server_dies()
    ref = _uninterrupted(w0, "single", 2)
    _same(got[:2], ref)
    _same([got[3]], ref[:1])
    np.testing.assert_array_equal(got[3][0][0], w0[0] - 2.0)


def test_server_recovers_state_from_snapshot(tmp_path):
    """The replacement restores weights and optimizer from its periodic
    snapshot and serves the pre-crash values with no re-init and no
    optimizer re-ship; the next round is an uninterrupted run's third."""
    extra = {"snapshot_dir": str(tmp_path), "snapshot_interval_s": 0.1}
    got, w0 = _server_dies(extra=extra, restore="snapshot")
    ref = _uninterrupted(w0, "single", 3)
    _same(got[:2], ref[:2])
    _same([[p] for p in got[2]], [[o[0]] for o in ref[1]])
    _same([got[3]], [ref[2]])
    np.testing.assert_array_equal(got[3][1][0], w0[0] - 6.0)


def test_server_recovers_state_from_peer_replica():
    """No snapshot dir: each server replicates its dirty state to the
    next-rank peer every tick, and the revived server fetches its replica
    from that peer (Command.REPLICA_FETCH)."""
    extra = {"snapshot_interval_s": 0.1}
    got, w0 = _server_dies(extra=extra, num_servers=2, restore="replica")
    ref = _uninterrupted(w0, "single", 3, extra=extra, num_servers=2)
    _same(got[:2], ref[:2])
    _same([[p] for p in got[2]], [[o[0]] for o in ref[1]])
    _same([got[3]], [ref[2]])


def _hips(tmp_path, crash):
    """Two-tier HiPS, 2 parties x 1 worker: two rounds, then (``crash``)
    the second party's server dies and a replacement restores the
    party's cached model from its snapshot; the party behind it pulls,
    and one more cross-party round. Returns [round 1, round 2, that
    pull, round 3]."""
    extra = dict(HB)
    extra.update(snapshot_dir=str(tmp_path), snapshot_interval_s=0.1)
    w0 = np.full(6, 8.0, np.float32)

    def step(kv):
        kv.push(0, np.ones_like(w0))
        out = np.zeros_like(w0)
        kv.pull(0, out=out)
        kv.wait()
        return out

    def body():
        sim = InProcessHiPS(num_parties=2, workers_per_party=1,
                            extra_cfg=extra)
        sim.start(sync_global=True)
        try:
            sim.master.set_optimizer(SGD(learning_rate=1.0))
            parallel([lambda kv=kv: kv.init(0, w0)
                      for kv in sim.workers + [sim.master]], OP_S)
            rounds = [parallel([lambda kv=kv: step(kv)
                                for kv in sim.workers], OP_S)
                      for _ in range(2)]
            if crash:
                time.sleep(0.5)            # snapshot ticks on every server
                victim = sim.servers[2]    # servers[0]: the global server
                assert not victim.is_global_server
                victim.crash()
                time.sleep(3.0)            # heartbeat lapse on both tiers
                revived = KVStoreDistServer(victim.cfg)
                rt = threading.Thread(target=revived.run, daemon=True)
                rt.start()
                sim.threads.append(rt)
                for _ in range(300):
                    if revived._ready.is_set():
                        break
                    time.sleep(0.1)
                assert revived._ready.is_set(), "revived server not ready"
                sim.servers[2] = revived
                assert revived.po_local.van.is_recovery
                assert revived.po_global is not None
                assert revived.po_global.van.is_recovery
                assert revived.replication.restored_from == "snapshot"
            rounds.append([_pull_now(sim.workers[1], 0, w0)])
            rounds.append(parallel([lambda kv=kv: step(kv)
                                    for kv in sim.workers], OP_S))
            return rounds
        finally:
            sim.stop()

    return within(CASE_S, body)


def test_hips_party_server_recovers_state(tmp_path):
    """A party server dies between rounds; its replacement serves the
    party's pre-crash values, and a full cross-party round completes
    with an uninterrupted run's values."""
    got = _hips(tmp_path / "crash", crash=True)
    ref = _hips(tmp_path / "ref", crash=False)
    _same(got, ref)
    np.testing.assert_array_equal(got[3][0], np.full(6, 8.0 - 6.0))


OLD, NEW = ("127.0.0.1", 1000), ("127.0.0.1", 2000)


class _Wire:
    """The wire to node 11 for either transport: a send to an address in
    ``dead`` fails, as one to a process that has gone does."""

    def __init__(self, table, dead):
        self.table, self.dead, self.routes, self.route = table, dead, [], None

    def set_route(self, target, host, port):          # native
        self.route = (host, port)
        self.routes.append((target, host, port))

    def send(self, target, buf):
        if self.route in self.dead:
            raise OSError(f"native send to node {target} failed")
        return len(buf)

    def get_conn(self, target):                       # Python sockets
        addr = self.table[target]
        self.routes.append((target, *addr))

        def sendall(buf):
            if addr in self.dead:
                raise OSError(f"send to node {target}: connection refused")

        return SimpleNamespace(sendall=sendall), threading.Lock()


def _fake_van(vmod, transport):
    table = {11: OLD}
    wire = _Wire(table, {OLD})
    fake = SimpleNamespace(
        _faults=None, _resender=None, _declared_dead=set(),
        _note_wire=lambda *a: None,
        _native=wire if transport == "native" else None,
        _get_conn=wire.get_conn, _evict_conn=lambda *a: None,
        node_table=table, _stats_lock=threading.Lock(), send_bytes=0,
        recv_bytes=0, _inbound_conn={}, _redialed=set(),
        stopped=threading.Event(), wire=wire)
    for name in ("_await_route_change", "_sent_to", "_heard_on",
                 "_retried_later"):
        setattr(fake, name, functools.partial(getattr(vmod.Van, name), fake))
    fake._tag = lambda: "[fake van]"
    fake.my_id = 8
    return fake


def _reply():
    from geomx_tpu_torch.ps.message import Message, Meta

    return Message(Meta(recver=11, request=False, push=True))


@pytest.mark.parametrize("transport", ["native", "python"])
def test_failed_send_follows_the_peers_new_address(monkeypatch, transport):
    """A reply to a worker that took a dead slot can leave before the
    table broadcast that moves the slot. The worker dialled this node
    anew (its frames came on a new connection), so the van waits for the
    move and sends again; with no move it gives up after
    ROUTE_CHANGE_WAIT_S."""
    from geomx_tpu_torch.ps import van as vmod

    monkeypatch.setattr(vmod, "ROUTE_CHANGE_WAIT_S", 0.5)
    fake = _fake_van(vmod, transport)
    fake._heard_on(11, "first", 10)
    fake._heard_on(11, "first", 10)
    assert 11 not in fake._redialed
    fake._heard_on(11, "second", 10)
    assert 11 in fake._redialed and fake.recv_bytes == 30
    threading.Timer(0.1, fake.node_table.__setitem__, (11, NEW)).start()
    assert vmod.Van._send_one_inner(fake, 11, _reply()) > 0
    assert fake.wire.routes == [(11, *OLD), (11, *NEW)]
    assert 11 not in fake._redialed and fake.send_bytes > 0

    fake = _fake_van(vmod, transport)
    fake._heard_on(11, "first", 10)
    fake._heard_on(11, "second", 10)
    t0 = time.monotonic()
    with pytest.raises(OSError, match="node 11"):
        vmod.Van._send_one_inner(fake, 11, _reply())
    assert 0.4 < time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("transport", ["native", "python"])
def test_failed_send_to_a_dead_peer_fails_at_once(transport):
    """A peer that is gone, with no process in its slot, never dialled
    this node anew: a send to it fails at once (the Python transport
    re-dials its address once first), not after ROUTE_CHANGE_WAIT_S; and
    a send that went through clears a redial mark, so a later failure
    fails at once too."""
    from geomx_tpu_torch.ps import van as vmod

    assert vmod.ROUTE_CHANGE_WAIT_S == 5.0
    fake = _fake_van(vmod, transport)
    fake._heard_on(11, "first", 10)
    t0 = time.monotonic()
    with pytest.raises(OSError, match="node 11"):
        vmod.Van._send_one_inner(fake, 11, _reply())
    assert time.monotonic() - t0 < 1.0
    assert fake.wire.routes == [(11, *OLD)] * (
        1 if transport == "native" else 2)

    fake._heard_on(11, "second", 10)
    fake._sent_to(11, 10)
    t0 = time.monotonic()
    with pytest.raises(OSError, match="node 11"):
        vmod.Van._send_one_inner(fake, 11, _reply())
    assert time.monotonic() - t0 < 1.0


class _Resender:
    """Registers what the van hands it, as ``ps/resender.py`` does."""

    def __init__(self):
        self.outgoing = []

    def assign_sig(self, msg):
        msg.meta.msg_sig = 1 + len(self.outgoing)

    def add_outgoing(self, target, msg):
        self.outgoing.append((target, msg))


@pytest.mark.parametrize("transport", ["native", "python"])
def test_failed_send_with_the_resender_on_is_retried_later(transport):
    """With the resender on, a data frame is registered before its wire
    attempt; when the attempt fails (the peer's process died and its
    replacement has not taken the slot yet) the send returns and the
    resender retransmits it, instead of the error reaching the caller
    (found by the port's chaos matrix server-kill case: a party worker
    died of it while the replacement server was starting). Control
    frames and sends without the resender still fail at once."""
    from geomx_tpu_torch.ps import van as vmod
    from geomx_tpu_torch.ps.message import Message, Meta

    fake = _fake_van(vmod, transport)
    fake._resender = _Resender()
    t0 = time.monotonic()
    assert vmod.Van._send_one_inner(fake, 11, _reply()) == 0
    assert time.monotonic() - t0 < 1.0
    assert [t for t, _ in fake._resender.outgoing] == [11]
    with pytest.raises(OSError, match="node 11"):
        vmod.Van._send_one_inner(
            fake, 11, Message(Meta(recver=11, control_cmd=2)))
    # the replacement took the slot: the retransmission goes through
    fake.node_table[11] = NEW
    msg = fake._resender.outgoing[0][1]
    assert vmod.Van._send_one_inner(fake, 11, msg) > 0
    assert len(fake._resender.outgoing) == 2     # the control frame only


def test_native_frames_carry_their_connection():
    """The native core numbers its inbound connections and hands each
    frame over with its connection's number: two frames from one dialler
    share one, a second dialler's frame has another."""
    from geomx_tpu_torch.ps import native
    from geomx_tpu_torch.ps.message import Message, Meta

    assert native.available()
    rx = native.NativeTransport("127.0.0.1")
    txs = [native.NativeTransport("127.0.0.1") for _ in range(2)]
    try:
        frame = Message(Meta(recver=1, request=True, push=True)).pack()
        for tx in (txs[0], txs[0], txs[1]):
            tx.set_route(1, "127.0.0.1", rx.port)
            assert tx.send(1, frame) == len(frame)
        got = [rx.recv(10.0) for _ in range(3)]
    finally:
        for t in [rx] + txs:
            t.close()
    assert all(g is not None and g[0] == frame for g in got)
    conns = [c for _f, c in got]
    assert min(conns) >= 1 and sorted(
        conns.count(c) for c in set(conns)) == [1, 2]


@pytest.mark.chaos
def test_faultplan_crash_resume_matches_uninterrupted(tmp_path):
    """``tests/test_recovery.py``'s acceptance scenario on the port: run
    A trains 3 rounds uninterrupted; run B is identical but a FaultPlan
    crash kills the server on the first data frame of round 3. The
    replacement restores from the periodic snapshot, the workers'
    retransmits complete round 3, and the final pulled weights equal
    run A's (restored from state, not re-initialized). The JAX case
    once failed under a loaded 6-worker run ("round 3 did not complete
    after revival"); here every op has a short deadline and the case a
    wall deadline of its own."""
    w0 = {0: np.full(8, 4.0, np.float32)}
    common = dict(snapshot_interval_s=0.1, resend=True,
                  resend_timeout_ms=2000, ps_seed=7,
                  # crash -> revival must win the race against the
                  # dead-node broadcast, as in the JAX case
                  epoch_grace_s=30.0)
    server_id = psbase.server_rank_to_id(0)

    def two_rounds(topo):
        topo.rank(0).set_optimizer(SGD(learning_rate=1.0))
        parallel([lambda kv=kv: kv.init(0, w0[0]) for kv in topo.workers],
                 OP_S)
        for r in (1, 2):
            outs = parallel([lambda q=q: _round(topo.rank(q), [0], w0,
                                                "single")
                             for q in (0, 1)], OP_S)
            for out in outs:
                np.testing.assert_array_equal(out[0], w0[0] - 2.0 * r)
        time.sleep(0.5)                 # quiesce + snapshot ticks

    def run_a():
        extra = dict(common, snapshot_dir=str(tmp_path / "a"))
        del extra["ps_seed"]
        topo = SingleTier(extra=extra).start()
        try:
            two_rounds(topo)
            n_pre = topo.server.po_local.van.num_data_recv
            outs = parallel([lambda q=q: _round(topo.rank(q), [0], w0,
                                                "single")
                             for q in (0, 1)], OP_S)
        finally:
            topo.close()
        return n_pre, [o[0] for o in outs]

    def run_b(n_pre):
        plan = json.dumps({"rules": [{
            "type": "crash", "node": server_id, "at": n_pre + 1,
            "on": "recv", "tier": "local"}]})
        topo = SingleTier(extra=dict(common, snapshot_dir=str(tmp_path / "b"),
                                     fault_plan=plan)).start()
        try:
            two_rounds(topo)
            assert topo.server.po_local.my_id == server_id
            outs = {}

            def round3(q):
                outs[q] = _round(topo.rank(q), [0], w0, "single")[0]

            ts = [threading.Thread(target=round3, args=(q,), daemon=True)
                  for q in (0, 1)]
            for t in ts:
                t.start()
            _wait_dead(topo, server_id, timeout=30.0)
            assert topo.server._crashed, "FaultPlan crash did not fire"
            # the replacement gets no fault plan but the same snapshots
            revived = _revive_server(topo, fault_plan="")
            assert revived.po_local.van.is_recovery
            assert revived.replication.restored_from == "snapshot"
            for t in ts:
                t.join(OP_S)
            assert set(outs) == {0, 1}, \
                "round 3 did not complete after revival"
            topo.server = revived
            topo.servers = [revived]
        finally:
            topo.close()
        return [outs[0], outs[1]]

    def body():
        n_pre, want = run_a()
        np.testing.assert_array_equal(want[0], w0[0] - 6.0)
        got = run_b(n_pre)
        _same(got, want)

    within(CASE_S, body)
