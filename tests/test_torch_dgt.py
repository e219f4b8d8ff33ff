"""DGT (Differential Gradient Transmission) in the port, against the JAX
package.

``ps/dgt.py`` (reference: kv_app.h:966-1260 send path, van.cc:330-370
reassembly, van.cc:707-745 classifier): ``quantize4`` must give the same
bytes and scale, a push split into blocks must give the same channel per
block and the same packed bytes (the contribution EWMA carried over
several pushes), and either package's reassembler must rebuild the
other's blocks into the same values, lost blocks zero-filled. HiPS
training with ``ENABLE_DGT`` 1-3 on the global tier must give the JAX
package's parameters: the port alone and mixed topologies both ways.
Modes 1 and 2 are exact while no datagram is lost (loopback), mode 3
quantizes the unimportant blocks; the JAX package's own tolerances hold
against the analytic result (tests/test_dgt.py).
"""

import numpy as np
import pytest

import geomx_tpu.ps.dgt as jdgt
import geomx_tpu.ps.kv_app as jkv
import geomx_tpu.ps.message as jmsg
import geomx_tpu_torch.ps.dgt as tdgt
import geomx_tpu_torch.ps.kv_app as tkv
import geomx_tpu_torch.ps.message as tmsg
from geomx_tpu import optimizer as jopt
from geomx_tpu_torch import optimizer as topt
from torch_parity_kit import (PORT_LAYOUTS, assert_same, make_topo,
                              run_rounds, worker_pkg)

PKG = {"jax": (jdgt, jkv, jmsg), "torch": (tdgt, tkv, tmsg)}
OPT = {"jax": jopt, "torch": topt}


@pytest.mark.parametrize("n,seed", [(1001, 0), (8, 1), (4096, 2), (1, 3)])
def test_quantize4_matches_the_jax_package_byte_for_byte(n, seed):
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    pt, st = tdgt.quantize4(x)
    pj, sj = jdgt.quantize4(x)
    assert pt.dtype == pj.dtype == np.uint8
    assert pt.tobytes() == pj.tobytes() and np.float32(st) == np.float32(sj)
    np.testing.assert_array_equal(tdgt.dequantize4(pt, n, st),
                                  jdgt.dequantize4(pj, n, sj))
    z = np.zeros(n, np.float32)
    assert tdgt.quantize4(z)[0].tobytes() == jdgt.quantize4(z)[0].tobytes()


def _push_msg(pkg, val, key=3, ts=7):
    _dgt, kv, msg = PKG[pkg]
    n = val.size
    kvs = kv.KVPairs(keys=[key], vals=[val], offsets=[0], totals=[n],
                     lens=[n])
    meta = msg.Meta(recver=8, app_id=0, customer_id=0, timestamp=ts,
                    request=True, push=True)
    m = kv._pack_kv(meta, kvs)
    m.meta.sender = 9
    return m


def _splits(pkg, mode, pushes):
    """Every push's blocks as (channel, packed bytes), one sender (so
    the contribution EWMA carries from push to push)."""
    dgt = PKG[pkg][0]
    sender = dgt.DGTSender(mode=mode, num_channels=3, block_size=16,
                           contri_alpha=0.3, k=0.3, k_min=0.1,
                           adaptive_k=False)
    return [[(ch, b.pack()) for ch, b in sender.split(_push_msg(pkg, v))]
            for v in pushes]


def _pushes(n=130, count=3):
    rng = np.random.RandomState(5)
    out = []
    for i in range(count):
        v = rng.randn(n).astype(np.float32)
        v[16 * i:16 * i + 16] *= 20.0       # a hot block that moves
        out.append(v)
    return out


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_split_matches_the_jax_package_byte_for_byte(mode):
    pushes = _pushes()
    got, want = _splits("torch", mode, pushes), _splits("jax", mode, pushes)
    assert got == want
    # the EWMA moved the reliable set between pushes
    chans = [[ch for ch, _ in blocks] for blocks in got]
    assert len({tuple(c) for c in chans}) > 1
    if mode == 3:
        assert any(ch > 0 for ch in chans[0])


def _reassemble(pkg, packed, lost=()):
    dgt, _kv, msg = PKG[pkg]
    reasm = dgt.DGTReassembler()
    out = None
    for i, (_ch, raw) in enumerate(packed):
        if i in lost:
            continue
        b = msg.Message.unpack(raw)
        b.meta.sender = 9
        got = reasm.accept(b)
        if got is not None:
            out = got
    assert out is not None
    return out.get_array(4)


@pytest.mark.parametrize("mode", [1, 2, 3])
@pytest.mark.parametrize("split_by,rebuild_by", [("jax", "torch"),
                                                 ("torch", "jax")])
def test_reassembly_crosses_packages(mode, split_by, rebuild_by):
    """One package's blocks, the other's reassembler: the values of the
    same package's own round trip; in mode 1 (unreliable blocks over
    UDP) also with two of them lost, zero-filled."""
    pushes = _pushes(count=1)
    blocks = _splits(split_by, mode, pushes)[0]
    lost = [i for i, (ch, _) in enumerate(blocks) if ch > 0][:2]
    assert lost
    for drop in ((), lost) if mode == 1 else ((),):
        np.testing.assert_array_equal(
            _reassemble(rebuild_by, blocks, drop),
            _reassemble(split_by, blocks, drop))
    exact = _reassemble(rebuild_by, blocks)
    if mode != 3:
        np.testing.assert_array_equal(exact, pushes[0])


def _train(layout, mode):
    pkg = worker_pkg(layout)
    w0 = np.arange(64, dtype=np.float32)

    def master(kv):
        kv.set_optimizer(OPT[pkg].SGD(learning_rate=1.0))
        kv.init(0, w0)
        kv.wait()

    def worker(kv, w):
        kv.init(0, w0)
        kv.wait()
        out = []
        for r in range(2):
            kv.push(0, np.ones(64, np.float32))
            o = np.zeros(64, np.float32)
            kv.pull(0, out=o)
            kv.wait()
            out.append(o)
        return out

    # DGT on every node's config (only global-tier vans act on it)
    topo = make_topo(layout, num_parties=2, workers_per_party=2,
                     extra_cfg=dict(enable_dgt=mode, udp_channel_num=2,
                                    dgt_block_size=8, dmlc_k=0.5))
    return run_rounds(topo, worker, master)


def _check_analytic(got, mode):
    w0 = np.arange(64, dtype=np.float32)
    for out in got:
        for r, o in enumerate(out, 1):
            if mode == 3:
                # unimportant blocks 4-bit quantized: tests/test_dgt.py's
                # tolerance
                np.testing.assert_allclose(o, w0 - 4.0 * r, atol=0.6 * r)
            else:
                np.testing.assert_array_equal(o, w0 - 4.0 * r)


_REF = {}


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_hips_training_with_dgt_matches_the_jax_package(mode, layout):
    if mode not in _REF:
        _REF[mode] = _train("jax", mode)
        _check_analytic(_REF[mode], mode)
    got = _train(layout, mode)
    _check_analytic(got, mode)
    # every block's codec and channel is a function of the pushed values
    # (integer gradients, no datagram lost on loopback): the JAX
    # package's parameters, bit for bit
    assert_same(got, _REF[mode])
