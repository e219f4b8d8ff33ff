"""P3 priority propagation in the port, against the JAX package.

``kvstore/sharding.py`` ``assign_p3`` (reference: P3_EncodeDefaultKey,
kvstore_dist.h:768-805) must cut every key into the same slices as the
JAX package's, and a HiPS round under ``ENABLE_P3`` (keys sliced at
bigarray granularity, one message per slice through the priority send
queue) must give the same parameters, bit for bit: the port alone, and
mixed topologies both ways (JAX tiers with port workers, port tiers with
JAX workers). Integer-valued gradients keep every sum exact in any
order of arrival.
"""

import numpy as np
import pytest

import geomx_tpu.kvstore.sharding as jshard
import geomx_tpu_torch.kvstore.sharding as tshard
from geomx_tpu import optimizer as jopt
from geomx_tpu_torch import optimizer as topt
from torch_parity_kit import (PORT_LAYOUTS, assert_same, make_topo,
                              run_rounds, worker_pkg)

OPT = {"jax": jopt, "torch": topt}


def _fields(shards):
    return [(s.server_rank, s.offset, s.length, s.total) for s in shards]


@pytest.mark.parametrize("key,size,nsrv,bound", [
    (3, 100, 4, 16), (7, 10, 4, 16), (1, 0, 4, 16), (5, 1000, 3, 64),
    (11, 4097, 2, 4096), (2, 48, 2, 16), (9, 17, 1, 16)])
def test_assign_and_assign_p3_match_the_jax_package(key, size, nsrv, bound):
    assert _fields(tshard.assign_p3(key, size, nsrv, bound)) == \
        _fields(jshard.assign_p3(key, size, nsrv, bound))
    assert _fields(tshard.assign(key, size, nsrv, bound)) == \
        _fields(jshard.assign(key, size, nsrv, bound))
    # several slices per key where the key exceeds the bound
    if size > bound and nsrv > 0:
        assert len(tshard.assign_p3(key, size, nsrv, bound)) > 1


# key -> size: key 0 is cut into 3 slices of <= 16 per server shard, key
# 1 fits one slice, key 2 is cut into 7 slices
SIZES = {0: 40, 1: 8, 2: 100}
ROUNDS = 3
TOPO = dict(num_parties=2, workers_per_party=2, servers_per_party=2,
            bigarray_bound=16, extra_cfg={"enable_p3": True})


def _run(layout):
    pkg = worker_pkg(layout)
    w0 = {k: (np.arange(n) % 5).astype(np.float32) for k, n in SIZES.items()}

    def master(kv):
        kv.set_optimizer(OPT[pkg].SGD(learning_rate=0.5))
        for k, v in w0.items():
            kv.init(k, v)
        kv.wait()

    def worker(kv, w):
        for k, v in w0.items():
            kv.init(k, v)
        kv.wait()
        rng = np.random.default_rng(20 + w)
        out = []
        for _ in range(ROUNDS):
            # later keys get higher priority (reference: push(idx, g,
            # priority=-idx) in examples/cnn.py:123)
            for k in SIZES:
                kv.push(k, rng.integers(-4, 5, SIZES[k]).astype(np.float32),
                        priority=-k)
            outs = {k: np.zeros(n, np.float32) for k, n in SIZES.items()}
            for k in SIZES:
                kv.pull(k, out=outs[k], priority=-k)
            kv.wait()
            out.extend(outs[k] for k in SIZES)
        return out

    return run_rounds(make_topo(layout, **TOPO), worker, master)


_REF = {}


def _reference():
    if "ref" not in _REF:
        _REF["ref"] = _run("jax")
    return _REF["ref"]


@pytest.mark.parametrize("layout", PORT_LAYOUTS)
def test_p3_rounds_match_the_jax_package(layout):
    ref = _reference()
    got = _run(layout)
    assert_same(got, ref)
    # FSA: every worker pulls the same parameters
    for g in got[1:]:
        assert_same([g], [got[0]])
    # the rounds moved every key off its initial value
    assert all(np.abs(a - (np.arange(a.size) % 5)).sum() > 0
               for a in got[0][-len(SIZES):])
