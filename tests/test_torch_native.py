"""The port's native van core (``geomx_tpu_torch/native/transport.cc``),
against the JAX package's.

The cases of ``tests/test_native.py`` on the port, and the two cores
exchanging frames both ways. The port's core is the JAX package's with
one addition: ``gx_recv`` also hands over the serial number of the
inbound connection a frame came on (``ps/van.py`` uses it to tell a
restarted peer). That number never touches the socket: a frame sent by
either core arrives at either core byte for byte as sent, and the two
packages' ``Message.pack`` build the same bytes.
"""

import threading

import numpy as np
import pytest

import geomx_tpu.ps.message as jmsg
import geomx_tpu.ps.native as jnative
import geomx_tpu.ps.postoffice as jpo
import geomx_tpu_torch.ps.message as tmsg
import geomx_tpu_torch.ps.native as tnative
import geomx_tpu_torch.ps.postoffice as tpo
import geomx_tpu.ps.kv_app as jkv
import geomx_tpu_torch.ps.kv_app as tkv
from geomx_tpu_torch.ps.kv_app import KVPairs, KVWorker
from geomx_tpu_torch.ps.message import Message, Meta
from torch_twin import twin

_transport = twin("test_transport")
free_port, make_tier, shutdown = (_transport.free_port,
                                  _transport.make_tier, _transport.shutdown)



@pytest.fixture(autouse=True)
def _both_cores():
    """Both packages' cores build with g++ on first use (decided here,
    not at import, so every test worker collects the same tests)."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("native transport not buildable")

NATIVE = {"jax": jnative, "torch": tnative}
MSG = {"jax": jmsg, "torch": tmsg}
KV = {"jax": jkv, "torch": tkv}
PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]


def _recv(t, timeout_s):
    """A frame's bytes, whichever core ``t`` is (the port's recv also
    gives the connection's number)."""
    got = t.recv(timeout_s=timeout_s)
    if isinstance(t, tnative.NativeTransport) and got is not None:
        frame, conn = got
        assert isinstance(conn, int) and conn > 0
        return frame
    return got


def _frames(pkg, n):
    M = MSG[pkg]
    out = []
    for i in range(n):
        m = M.Message(M.Meta(sender=1, recver=7, timestamp=i))
        m.add_array(np.full((16,), float(i), dtype=np.float32))
        out.append(m.pack())
    return out


def test_both_packages_pack_the_same_frames():
    assert _frames("torch", 5) == _frames("jax", 5)
    meta = dict(recver=1, control_cmd=2, epoch=3, trace_round=4)
    node = dict(role=1, port=1234)
    assert tmsg.Message(tmsg.Meta(nodes=[tmsg.Node(**node)], **meta)).pack() \
        == jmsg.Message(jmsg.Meta(nodes=[jmsg.Node(**node)], **meta)).pack()


def test_build_and_bind():
    t = tnative.NativeTransport("127.0.0.1", 0)
    assert t.port > 0
    t.close()


@pytest.mark.parametrize("src,dst", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_frame_roundtrip_and_order(src, dst):
    a = NATIVE[src].NativeTransport("127.0.0.1", 0)
    b = NATIVE[dst].NativeTransport("127.0.0.1", 0)
    try:
        a.set_route(7, "127.0.0.1", b.port)
        frames = _frames(src, 50)
        for f in frames:
            a.send(7, f)
        for i, f in enumerate(frames):
            got = _recv(b, 5.0)
            assert got == f                     # byte-exact, in order
            m = MSG[dst].Message.unpack(got)
            assert m.meta.timestamp == i
            np.testing.assert_array_equal(m.get_array(0), float(i))
        assert a.send_bytes == sum(len(f) for f in frames)
        assert b.recv_bytes == a.send_bytes
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("src,dst", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_send_to_addr_oneshot(src, dst):
    a = NATIVE[src].NativeTransport("127.0.0.1", 0)
    b = NATIVE[dst].NativeTransport("127.0.0.1", 0)
    try:
        M = MSG[src]
        msg = M.Message(M.Meta(recver=1, control_cmd=2, nodes=[
            M.Node(role=M.Role.WORKER, port=1234)])).pack()
        a.send_to_addr("127.0.0.1", b.port, msg)
        assert _recv(b, 5.0) == msg
    finally:
        a.close()
        b.close()


def test_recv_timeout_and_stop():
    t = tnative.NativeTransport("127.0.0.1", 0)
    assert t.recv(timeout_s=0.05) is None
    t.stop()
    with pytest.raises(ConnectionAbortedError):
        t.recv(timeout_s=1.0)
    t.close()


def test_send_no_route():
    t = tnative.NativeTransport("127.0.0.1", 0)
    with pytest.raises(OSError, match="no route"):
        t.send(42, b"x")
    t.close()


def test_route_change_evicts_connection():
    """Re-pointing an id at a new address must reach the new peer."""
    a = tnative.NativeTransport("127.0.0.1", 0)
    b1 = tnative.NativeTransport("127.0.0.1", 0)
    b2 = tnative.NativeTransport("127.0.0.1", 0)
    try:
        msg = Message(Meta(recver=5)).pack()
        a.set_route(5, "127.0.0.1", b1.port)
        a.send(5, msg)
        assert _recv(b1, 5.0) == msg
        a.set_route(5, "127.0.0.1", b2.port)
        a.send(5, msg)
        assert _recv(b2, 5.0) == msg
        assert b1.recv(timeout_s=0.1) is None
    finally:
        a.close()
        b1.close()
        b2.close()


def test_redial_after_peer_restart():
    """A cached connection to a dead peer is evicted and redialed; the
    frames the restarted peer receives come on a new connection of its
    own, and two frames of one connection carry one number."""
    a = tnative.NativeTransport("127.0.0.1", 0)
    b = tnative.NativeTransport("127.0.0.1", 0)
    port = b.port
    msg = Message(Meta(recver=5)).pack()
    try:
        a.set_route(5, "127.0.0.1", port)
        a.send(5, msg)
        a.send(5, msg)
        (f1, c1), (f2, c2) = b.recv(timeout_s=5.0), b.recv(timeout_s=5.0)
        assert f1 == f2 == msg and c1 == c2
        b.close()
        b = tnative.NativeTransport("127.0.0.1", port)
        # first send may fail (stale fd detected mid-send); the van
        # retries, at most two attempts needed
        for _ in range(3):
            try:
                a.send(5, msg)
                break
            except OSError:
                pass
        assert _recv(b, 5.0) == msg
        # a new inbound connection on the replacement: a new number
        c = tnative.NativeTransport("127.0.0.1", 0)
        try:
            c.set_route(5, "127.0.0.1", port)
            c.send(5, msg)
            a.send(5, msg)
            conns = {b.recv(timeout_s=5.0)[1] for _ in range(2)}
            assert len(conns) == 2
        finally:
            c.close()
    finally:
        a.close()
        b.close()


def _serve_sum(server_po, kv=None):
    store = {}
    srv = (kv or KV["torch"]).KVServer(server_po)

    def handle(req, kvs, s):
        if req.push:
            for k, v in zip(kvs.keys, kvs.vals):
                store[k] = store.get(k, 0) + v
            s.response(req)
        elif req.pull:
            s.response(req, (kv or KV["torch"]).KVPairs(
                keys=kvs.keys, vals=[store[k] for k in kvs.keys]))

    srv.set_request_handle(handle)
    return srv


def test_native_tier_push_pull():
    """Full rendezvous + KV push/pull over the native backend."""
    sched, servers, workers = make_tier(num_workers=2, num_servers=1)
    try:
        assert sched.van._native is not None, "native backend not engaged"
        _serve_sum(servers[0])
        w0, w1 = KVWorker(workers[0]), KVWorker(workers[1])
        v = np.ones((4, 3), dtype=np.float32)
        ts0 = w0.push(KVPairs(keys=[7], vals=[v]), server_rank=0)
        ts1 = w1.push(KVPairs(keys=[7], vals=[2 * v]), server_rank=0)
        w0.wait(ts0, 10)
        w1.wait(ts1, 10)
        ts = w0.pull([7], server_rank=0)
        w0.wait(ts, 10)
        (resp,) = w0.take_response(ts)
        np.testing.assert_allclose(resp.vals[0], 3 * v)
    finally:
        shutdown(sched, *servers, *workers)


# which package's Postoffice each role of one tier runs, and whether it
# speaks through the native core
TIERS = {
    "port-native-python": (("torch", True), ("torch", False),
                           ("torch", True), ("torch", False)),
    "jax-sched-server": (("jax", True), ("jax", True),
                         ("torch", True), ("torch", True)),
    "port-sched-server": (("torch", True), ("torch", True),
                          ("jax", True), ("jax", True)),
    "mixed-every-role": (("jax", True), ("torch", True),
                         ("jax", False), ("torch", True)),
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_across_packages_and_backends(tier):
    """One tier whose scheduler, server and two workers come from
    either package, on the native core or the pure-Python van."""
    port = free_port()
    kw = dict(is_global=False, root_uri="127.0.0.1", root_port=port,
              num_workers=2, num_servers=1)
    PO = {"jax": (jpo, jmsg), "torch": (tpo, tmsg)}
    pos = []
    for role, (pkg, use_native) in zip(("SCHEDULER", "SERVER", "WORKER",
                                        "WORKER"), TIERS[tier]):
        po_mod, m = PO[pkg]
        po = po_mod.Postoffice(my_role=getattr(m.Role, role), **kw)
        po.van.use_native = use_native
        pos.append(po)
    threads = [threading.Thread(target=po.start, daemon=True) for po in pos]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    sched, server, wa, wb = pos
    try:
        for po, (_pkg, use_native) in zip(pos, TIERS[tier]):
            assert po.van.ready.is_set(), "rendezvous failed"
            assert (po.van._native is not None) == use_native
        _serve_sum(server, KV[TIERS[tier][1][0]])
        ka, kb = KV[TIERS[tier][2][0]], KV[TIERS[tier][3][0]]
        a, b = ka.KVWorker(wa), kb.KVWorker(wb)
        v = np.arange(12, dtype=np.float32).reshape(3, 4)
        ta = a.push(ka.KVPairs(keys=[1], vals=[v]), server_rank=0)
        tb = b.push(kb.KVPairs(keys=[1], vals=[v]), server_rank=0)
        a.wait(ta, 10)
        b.wait(tb, 10)
        for w in (a, b):
            ts = w.pull([1], server_rank=0)
            w.wait(ts, 10)
            (resp,) = w.take_response(ts)
            np.testing.assert_array_equal(
                np.asarray(resp.vals[0]).reshape(3, 4), 2 * v)
    finally:
        shutdown(*pos)
