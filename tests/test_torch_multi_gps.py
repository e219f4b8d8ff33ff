"""MultiGPS in the port, against the JAX package.

Several global servers share the central party (reference:
scripts/cpu/run_multi_gps.sh, DMLC_NUM_GLOBAL_SERVER=2): small keys hash
to one global server by ``(key * 9973) % n``, big keys split across all
of them (EncodeDefaultKey, kvstore_dist.h:725-762). The port's spreading
must equal the JAX package's, its rounds over both global servers must
give the same parameters bit for bit (the port alone and mixed
topologies both ways, integer-valued gradients), MixedSync must land
every party's update on the right shard, and the optimizer states a save
gathers must cover both servers' shards with the JAX package's values.
"""

import json
import threading

import numpy as np
import pytest

import geomx_tpu.kvstore.sharding as jshard
import geomx_tpu_torch.kvstore.sharding as tshard
from geomx_tpu import checkpoint as jck
from geomx_tpu import optimizer as jopt
from geomx_tpu_torch import checkpoint as tck
from geomx_tpu_torch import optimizer as topt
from torch_parity_kit import (DEADLINE, PORT_LAYOUTS, assert_same,
                              make_topo, run_rounds, worker_pkg)

OPT = {"jax": jopt, "torch": topt}
CK = {"jax": jck, "torch": tck}


def test_key_spreading_matches_the_jax_package():
    for n in (1, 2, 3):
        for key in range(16):
            for size in (10, 999, 1000, 5000):
                got = [(s.server_rank, s.offset, s.length)
                       for s in tshard.assign(key, size, n, 1000)]
                want = [(s.server_rank, s.offset, s.length)
                        for s in jshard.assign(key, size, n, 1000)]
                assert got == want, (key, size, n)
    # with 2 servers, small keys land on both (hash), big keys split
    assert {tshard.assign(k, 10, 2, 1000)[0].server_rank
            for k in range(8)} == {0, 1}
    assert {s.server_rank for s in tshard.assign(3, 5000, 2, 1000)} == {0, 1}


# key 1: big -> split across both global servers; keys 2, 3: small ->
# hashed ((2*9973)%2=0, (3*9973)%2=1), one per global server
W0 = {1: np.arange(48, dtype=np.float32),
      2: np.full(8, 5.0, np.float32),
      3: np.arange(12, dtype=np.float32) - 6}
ROUNDS = 3


def _train(layout, spp):
    pkg = worker_pkg(layout)

    def master(kv):
        kv.set_optimizer(OPT[pkg].SGD(learning_rate=1.0))
        for k, v in W0.items():
            kv.init(k, v)
        kv.wait()

    def worker(kv, w):
        for k, v in W0.items():
            kv.init(k, v)
        kv.wait()
        rng = np.random.default_rng(30 + w)
        out = []
        for _ in range(ROUNDS):
            for k in W0:
                kv.push(k, rng.integers(-3, 4, W0[k].size).astype(np.float32))
            outs = {k: np.zeros_like(v) for k, v in W0.items()}
            for k in W0:
                kv.pull(k, out=outs[k])
            kv.wait()
            out.extend(outs[k] for k in W0)
        return out

    topo = make_topo(layout, num_parties=2, workers_per_party=2,
                     num_global_servers=2, servers_per_party=spp,
                     bigarray_bound=16)
    return run_rounds(topo, worker, master)


_REF = {}


def _reference(spp):
    if spp not in _REF:
        _REF[spp] = _train("jax", spp)
    return _REF[spp]


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
@pytest.mark.parametrize("spp", [1, 2])
def test_multi_gps_training_matches_the_jax_package(spp, layout):
    ref = _reference(spp)
    got = _train(layout, spp)
    assert_same(got, ref)
    for g in got[1:]:
        assert_same([g], [got[0]])


def _mixed_sync(layout):
    pkg = worker_pkg(layout)
    both_done = threading.Barrier(2)

    def master(kv):
        kv.set_optimizer(OPT[pkg].SGD(learning_rate=1.0))
        kv.init(0, np.zeros(40, np.float32))
        kv.wait()

    def pull(kv):
        out = np.zeros(40, np.float32)
        kv.pull(0, out=out)
        kv.wait()
        return out

    def worker(kv, w):
        kv.init(0, np.zeros(40, np.float32))
        kv.wait()
        kv.push(0, np.ones(40, np.float32))
        first = pull(kv)
        both_done.wait(DEADLINE)
        # the master pulls the global servers' state (a party server
        # answers from its own copy)
        return [first, pull(topo.master) if w == 0 else None]

    topo = make_topo(layout, num_parties=2, workers_per_party=1,
                     num_global_servers=2, bigarray_bound=16)
    return run_rounds(topo, worker, master, sync_global=False)


@pytest.mark.parametrize("layout", ["jax"] + PORT_LAYOUTS)
def test_multi_gps_mixed_sync_lands_on_both_shards(layout):
    """MixedSync (dist_async) with 2 global servers: each party's push
    is applied on its own, shard by shard, so a worker's first pull holds
    its own party's update on both shards and the other's on none, one
    or both; once both workers are done, the global servers hold both on
    every shard."""
    got = _mixed_sync(layout)
    for first, _ in got:
        assert set(np.unique(first)) <= {-1.0, -2.0}, first
    np.testing.assert_array_equal(got[0][1], np.full(40, -2.0))


def _states(pkg, tmp_path):
    fname = str(tmp_path / f"{pkg}.states")

    def master(kv):
        kv.set_optimizer(OPT[pkg].Adam(learning_rate=0.01))
        kv.init(0, np.ones(48, np.float32))
        kv.wait()

    def worker(kv, w):
        kv.init(0, np.ones(48, np.float32))
        kv.wait()
        kv.push(0, np.arange(48, dtype=np.float32) - 20)
        out = np.zeros(48, np.float32)
        kv.pull(0, out=out)
        kv.wait()
        return [out]

    topo = make_topo(pkg, num_parties=2, workers_per_party=1,
                     num_global_servers=2, bigarray_bound=16)

    def save_then_stop(kv, w):
        out = worker(kv, w)
        if w == 0:
            kv.save_optimizer_states(fname)
        return out

    got = run_rounds(topo, save_then_stop, master)
    with open(fname) as f:
        per_server = json.load(f)
    return got, {r: CK[pkg].deserialize_states(bytes.fromhex(h))
                 for r, h in per_server.items()}


def test_multi_gps_optimizer_states_match_the_jax_package(tmp_path):
    """Each global server owns the Adam states of ITS canonical shards; a
    save merges both (keyed by global rank). The port's states are the
    JAX package's, value for value (the blobs' formats differ, so each
    package reads its own)."""
    got_t, st_t = _states("torch", tmp_path)
    got_j, st_j = _states("jax", tmp_path)
    assert_same(got_t, got_j)
    assert set(st_t) == set(st_j) == {"0", "1"}
    offsets = set()
    for rank in st_t:
        assert set(st_t[rank]) == set(st_j[rank])
        for (key, off), s in st_t[rank].items():
            offsets.add(off)
            want = st_j[rank][(key, off)]
            assert key == 0 and s["t"] == want["t"] == 1
            assert set(s) == set(want)
            for name in s:
                np.testing.assert_array_equal(np.asarray(s[name]),
                                              np.asarray(want[name]))
    assert offsets == {0, 24}
