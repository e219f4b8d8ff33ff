"""A party whose ranks are processes: the port's quantized ring across a
gloo group against the JAX ring, on the CPU.

The GEOMX_MESH_* settings form the group (``maybe_init_multihost``) in 2
and in 4 processes (``tests/torch_multiproc_kit.py``; each topology has
a wall deadline; the processes import torch and ``geomx_tpu_torch``
only). Rank r reduces row r of each round's ``(P, n)`` input with its
own ``QuantRingReducer`` over the ``ProcessPartyMesh``; the JAX ring
runs as its shard_map over P of the 8 virtual CPU devices
``tests/conftest.py`` forces. For int8, 2-bit and fp16 every rank's
output must equal the JAX ring's bit for bit over 3 rounds, and rank r's
``(P, m)`` residual must equal row r of the JAX reducer's ``(P, P, m)``
state (the residual carries over the rounds); ``none`` (the group's
all-reduce) is held within 1e-6. Beside the ring: the group forms, a
repeat ``maybe_init_multihost`` is a no-op, rank 0 alone is rank 0, a
batch splits as ``P("dp")`` splits it, a broadcast carries rank 0's
value, and the settings' refusals.
"""

import jax
import numpy as np
import pytest

from geomx_tpu.parallel import quant_collectives as jax_qc
from geomx_tpu.parallel.mesh import make_mesh
from geomx_tpu_torch.config import Config
from geomx_tpu_torch.kvstore.mesh_party import maybe_init_multihost
from geomx_tpu_torch.parallel import mesh as pmesh
from geomx_tpu_torch.parallel import quant_collectives as qc
from torch_multiproc_kit import run_ranks

N, BLOCK, THR, ROUNDS = 1000, 64, 0.5, 3
SIZES = (2, 4)


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """Both topologies at once: ``{P: (inputs (ROUNDS, P, N), [rank
    outputs])}``."""
    runs = {}
    for P in SIZES:
        xs = np.random.RandomState(10 + P).randn(ROUNDS, P, N).astype(
            np.float32)
        runs[P] = (xs, run_ranks(
            "ring", P, tmp_path_factory.mktemp(f"ring{P}"), inputs={"xs": xs},
            args=dict(codecs=["int8", "2bit", "fp16", "none"], n=N,
                      block=BLOCK, threshold=THR, rounds=ROUNDS),
            deadline=90, wait=False))
    return {P: (xs, wait()) for P, (xs, wait) in runs.items()}


@pytest.mark.parametrize("P", SIZES)
def test_group_forms_and_rank_0_is_the_global_worker(rings, P):
    _, ranks = rings[P]
    B = 4 * P
    rows = np.arange(B * 3).reshape(B, 3)
    for r, out in enumerate(ranks):
        assert bool(out["first"]) and bool(out["again"])
        assert int(out["rank"]) == r and int(out["size"]) == P
        np.testing.assert_array_equal(out["rows"], rows[4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(out["bcast"], np.full(5, 7.0))
        np.testing.assert_array_equal(out["gathered"],
                                      np.arange(P) + 0.5)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("codec", ["int8", "2bit", "fp16"])
def test_process_ring_bit_exact_vs_jax(rings, P, codec):
    xs, ranks = rings[P]
    theirs = jax_qc.QuantRingReducer(make_mesh(jax.devices()[:P]), codec, N,
                                     block=BLOCK, threshold=THR)
    for rnd in range(ROUNDS):
        want = np.asarray(theirs.reduce(xs[rnd]))
        res = np.asarray(theirs._res)
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(
                out[f"{codec}_y{rnd}"], want,
                err_msg=f"codec={codec} P={P} round={rnd} rank={r}")
            np.testing.assert_array_equal(out[f"{codec}_res{rnd}"], res[r])
    assert np.abs(res).sum() > 0          # the residual did carry
    for out in ranks:
        assert int(out[f"{codec}_bytes"]) == theirs.wire_bytes_per_round()


@pytest.mark.parametrize("P", SIZES)
def test_process_none_is_the_all_reduce(rings, P):
    xs, ranks = rings[P]
    for mean in (False, True):
        tag = "none_mean" if mean else "none"
        red = jax_qc.QuantRingReducer(make_mesh(jax.devices()[:P]), "none",
                                      N, mean=mean)
        for rnd in range(ROUNDS):
            want = np.asarray(red.reduce(xs[rnd]))
            for out in ranks:
                np.testing.assert_allclose(out[f"{tag}_y{rnd}"], want,
                                           atol=1e-6, rtol=1e-6)
                assert out[f"{tag}_y{rnd}"].shape == (N,)


def test_settings_unset_or_wrong():
    assert maybe_init_multihost(Config()) is False
    assert maybe_init_multihost(Config(mesh_coordinator="127.0.0.1:1",
                                       mesh_num_processes=1)) is False
    with pytest.raises(ValueError, match="GEOMX_MESH_PROC_ID"):
        maybe_init_multihost(Config(mesh_coordinator="127.0.0.1:1",
                                    mesh_num_processes=2,
                                    mesh_process_id=-1))
    # without a group a party is one process
    assert isinstance(pmesh.make_party_mesh(2, device="cpu"),
                      pmesh.PartyMesh)


def test_process_ring_refuses_none_and_a_wrong_residual():
    import torch

    mesh = pmesh.ProcessPartyMesh(2, 0, torch.device("cpu"))
    assert mesh.row_ranks == range(0, 1)
    ring = dict(size=2, ranks=mesh.row_ranks, hop=mesh.hop)
    with pytest.raises(ValueError, match="none"):
        qc.ring_all_reduce(torch.zeros(1, 8), torch.zeros(1, 2, 4),
                           codec="none", **ring)
    with pytest.raises(ValueError, match="residual"):
        qc.ring_all_reduce(torch.zeros(1, 8), torch.zeros(2, 2, 4),
                           codec="2bit", **ring)
    with pytest.raises(ValueError, match="expected"):
        qc.QuantRingReducer(mesh, "int8", 8).reduce(torch.zeros(2, 8))
