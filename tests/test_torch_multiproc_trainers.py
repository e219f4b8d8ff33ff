"""The party trainers with each rank its own process, on the CPU.

``DataParallelTrainer.step`` over a 2-process ``ProcessPartyMesh``
(local grads on the rank's rows, the 2-bit ring over the flattened
gradient, SGD) is held for 3 rounds against the JAX
``DataParallelTrainer`` plus the JAX ring on 2 virtual CPU devices, as
``tests/test_torch_quant_collectives.py`` holds the one-process party:
each rank's own local grads within 1e-5 abs / 1e-4 rel of the JAX
rank's, both rings fed the JAX gradient stack (so float noise cannot
flip a 2-bit code), the parameters within that tolerance after every
round, and the two ranks bit for bit.

``HierarchicalTrainer`` runs a live HiPS with one party of 2 process
ranks (rank 0 holds the topology, its roles on threads; rank 1 builds
its own store and starts from zero parameters) under the 2-bit ring and
under no codec, against the same party on one process: rank 0 alone is
the global worker, rank 1 refuses the van, both take the global
worker's initial and final parameters by the store's broadcast, and they
equal the one-process party's (2-bit bit for bit; no codec, the group's
fp32 all-reduce against one pass over the party batch, within 1e-6).
Every topology has a wall deadline (``tests/torch_multiproc_kit.py``).
"""

import jax
import numpy as np
import optax
import pytest

from geomx_tpu.models.transformer import Transformer as FlaxTransformer
from geomx_tpu.parallel import quant_collectives as jax_qc
from geomx_tpu.parallel import train_step as jax_ts
from geomx_tpu.parallel.mesh import batch_sharded, make_mesh
from geomx_tpu_torch.models import MLP
from geomx_tpu_torch.models.convert import leaf_names
from torch_multiproc_kit import run_ranks

ATOL, RTOL = 1e-5, 1e-4
DIMS = dict(vocab=64, dim=64, depth=2, heads=2)
SEQ, BATCH, LR, THR, ROUNDS = 32, 4, 0.1, 0.01, 3
HIER = {"size": 2, "lr": 0.1, "rounds": 3, "codecs": ["2bit", "none"],
        "features": [16, 4], "in": 8}


@pytest.fixture(scope="module")
def hier_runs(tmp_path_factory):
    """The 2-process party and its one-process reference, started at
    once (before the JAX side of the other test compiles)."""
    rng = np.random.RandomState(0)
    model = MLP(HIER["in"], tuple(HIER["features"]))
    named = dict(model.named_parameters())
    inputs = {f"leaf{i}": (0.3 * rng.randn(*named[name].shape)).astype(
        np.float32) for i, name in enumerate(leaf_names(model))}
    for rnd in range(HIER["rounds"]):
        inputs[f"X{rnd}"] = rng.randn(8, HIER["in"]).astype(np.float32)
        inputs[f"y{rnd}"] = rng.randint(0, HIER["features"][-1], (8,))
    procs = run_ranks("hier", 2, tmp_path_factory.mktemp("hier"), inputs,
                      HIER, deadline=90, wait=False)
    ref = run_ranks("hier", 1, tmp_path_factory.mktemp("hier_ref"), inputs,
                    HIER, deadline=90, mesh=False, wait=False)
    done = {}

    def results():
        if not done:
            done.update(ranks=procs(), one=ref()[0])
        return done["ranks"], done["one"]

    return inputs, results


def test_data_parallel_trainer_across_processes_matches_jax(tmp_path,
                                                            hier_runs):
    batches = []
    for rnd in range(ROUNDS):
        toks = np.random.default_rng(50 + rnd).integers(
            0, DIMS["vocab"], size=(BATCH, SEQ + 1)).astype(np.int32)
        batches.append((toks[:, :-1], toks[:, 1:]))
    mesh = make_mesh(jax.devices()[:2])
    jt = jax_ts.DataParallelTrainer(
        FlaxTransformer(**DIMS, max_len=SEQ), optax.sgd(LR), mesh,
        batches[0][0], num_classes=DIMS["vocab"])
    leaves, treedef = jax.tree_util.tree_flatten(jt.params)
    init = [np.array(l) for l in leaves]
    n = sum(l.size for l in init)
    theirs = jax_qc.QuantRingReducer(mesh, "2bit", n, mean=True,
                                     threshold=THR)
    inputs = {"n_leaves": np.array(len(init)),
              **{f"leaf{i}": l for i, l in enumerate(init)}}
    want = []
    for rnd, (X, y) in enumerate(batches):
        jl, jg = jt.local_grads(X, y)
        jstack = np.concatenate([np.asarray(g).reshape(2, -1)
                                 for g in jax.tree_util.tree_leaves(jg)], 1)
        red = np.asarray(theirs.reduce(jax.device_put(
            jstack, batch_sharded(mesh))))
        assert np.count_nonzero(red) > 0.01 * n
        sizes = np.cumsum([l.size for l in init])[:-1]
        new = [np.asarray(p) - np.float32(LR) * g.reshape(p.shape)
               for p, g in zip(jax.tree_util.tree_leaves(jt.params),
                               np.split(red, sizes))]
        jt.params = jax.device_put(jax.tree_util.tree_unflatten(treedef, new),
                                   jt.repl)
        inputs.update({f"X{rnd}": X, f"y{rnd}": y, f"J{rnd}": jstack})
        want.append((float(np.mean(jl)), jstack,
                     np.concatenate([l.ravel() for l in new])))
    ranks = run_ranks("dp", 2, tmp_path, inputs,
                      dict(dims=DIMS, seq=SEQ, lr=LR, thr=THR, rounds=ROUNDS),
                      deadline=90)
    for rnd, (loss, jstack, params) in enumerate(want):
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(out[f"g{rnd}"], jstack[r], atol=ATOL,
                                       rtol=RTOL)
            np.testing.assert_allclose(float(out[f"loss{rnd}"]), loss,
                                       atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(out[f"p{rnd}"], params, atol=ATOL,
                                       rtol=RTOL)
        np.testing.assert_array_equal(ranks[0][f"p{rnd}"],
                                      ranks[1][f"p{rnd}"])


@pytest.mark.parametrize("codec", HIER["codecs"])
def test_hierarchical_trainer_across_processes_through_live_hips(
        hier_runs, codec):
    inputs, results = hier_runs
    ranks, one = results()
    start = np.concatenate([inputs[f"leaf{i}"].ravel()
                            for i in range(len(HIER["features"]) * 2)])
    assert [bool(o[f"{codec}_global"]) for o in ranks] == [True, False]
    assert "global worker" in str(ranks[1][f"{codec}_refusal"])
    np.testing.assert_array_equal(ranks[0][f"{codec}_van"],
                                  ranks[1][f"{codec}_van"])
    for o in ranks:
        np.testing.assert_array_equal(o[f"{codec}_init"], start)
        np.testing.assert_array_equal(o[f"{codec}_final"],
                                      ranks[0][f"{codec}_final"])
        np.testing.assert_array_equal(o[f"{codec}_loss"],
                                      ranks[0][f"{codec}_loss"])
    assert not np.array_equal(ranks[0][f"{codec}_final"], start)
    got, want = ranks[0], one
    if codec == "none":
        np.testing.assert_allclose(got[f"{codec}_final"],
                                   want[f"{codec}_final"], atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(got[f"{codec}_loss"],
                                   want[f"{codec}_loss"], rtol=1e-6)
    else:
        np.testing.assert_array_equal(got[f"{codec}_final"],
                                      want[f"{codec}_final"])
        np.testing.assert_array_equal(got[f"{codec}_loss"],
                                      want[f"{codec}_loss"])
