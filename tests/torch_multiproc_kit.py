"""Ranks of a party as processes, for the port's tests on the CPU.

:func:`run_ranks` starts ``nproc`` Python processes of this file, each
one rank of a gloo group formed by the ``GEOMX_MESH_*`` settings, runs a
job of :data:`JOBS` in each and returns what every rank saved. Every
topology has a wall deadline: on a timeout every process is killed and
the test fails with their output. The processes import torch, numpy and
``geomx_tpu_torch`` only; each job ends by checking that no ``jax``,
``flax`` or ``geomx_tpu`` module was loaded.

A job reads its inputs from ``<dir>/in.npz`` (written by the test) and
saves ``<dir>/rank<r>.npz``.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job: str, nproc: int, tmp_path, inputs=None, args=None,
              deadline: float = 60.0, mesh: bool = True, wait: bool = True):
    """Run ``job`` in ``nproc`` processes (``mesh``: as ranks of one gloo
    group; otherwise as plain processes without the settings) and return
    each rank's saved arrays, in rank order. ``wait=False`` returns at
    once with a function that waits for them (the deadline counts from
    the start)."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    if inputs is not None:
        np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ)
    for k in ("JAX_PLATFORMS", "XLA_FLAGS"):
        env.pop(k, None)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1")
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for r in range(nproc):
        e = dict(env)
        if mesh:
            e.update(GEOMX_MESH_COORDINATOR=coord,
                     GEOMX_MESH_NUM_PROCS=str(nproc),
                     GEOMX_MESH_PROC_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, job, str(tmp_path),
             json.dumps(args or {})],
            env=e, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    end = time.monotonic() + deadline

    def waiter():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(end - time.monotonic(), 0.1))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            text = "\n".join(f"--- rank {r}\n{p.communicate()[0][-3000:]}"
                             for r, p in enumerate(procs))
            raise AssertionError(
                f"{job} x{nproc}: not done in {deadline} s\n" + text)
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode]
        assert not bad, f"{job} x{nproc}: exit codes {bad}\n" + "\n".join(
            f"--- rank {r}\n{o[-3000:]}" for r, o in enumerate(outs))
        res = []
        for r in range(nproc):
            with np.load(tmp_path / f"rank{r}.npz") as z:
                res.append({k: z[k] for k in z.files})
        return res

    return waiter() if wait else waiter


# -- the ranks' side: torch and geomx_tpu_torch only --------------------


def _job_ring(d, inp, args):
    """Every codec's ring (and ``none``) over ``rounds`` rounds: rank r
    reduces row r of each round's ``(P, n)`` input; saves each round's
    output and residual slice, plus the group-forming checks."""
    import torch

    from geomx_tpu_torch import config as cfg_mod
    from geomx_tpu_torch.kvstore.mesh_party import maybe_init_multihost
    from geomx_tpu_torch.parallel import mesh as pmesh
    from geomx_tpu_torch.parallel import quant_collectives as qc

    cfg = cfg_mod.load()
    out = {"first": np.array(maybe_init_multihost(cfg)),
           "again": np.array(maybe_init_multihost(cfg))}
    mesh = pmesh.make_party_mesh(0, device="cpu")
    assert isinstance(mesh, pmesh.ProcessPartyMesh), mesh
    r = mesh.rank
    out["rank"], out["size"] = np.array(r), np.array(mesh.size)
    for codec in args["codecs"]:
        for mean in ((False, True) if codec == "none" else (False,)):
            red = qc.QuantRingReducer(mesh, codec, args["n"],
                                      block=args["block"],
                                      threshold=args["threshold"],
                                      mean=mean)
            tag = f"{codec}{'_mean' if mean else ''}"
            for rnd in range(args["rounds"]):
                y = red.reduce(torch.as_tensor(inp["xs"][rnd][r:r + 1]))
                out[f"{tag}_y{rnd}"] = y[0].numpy()
                out[f"{tag}_res{rnd}"] = red._res[0].numpy()
            out[f"{tag}_bytes"] = np.array(red.wire_bytes_per_round())
    # the batch split and the broadcast
    B = 4 * mesh.size
    out["rows"] = pmesh.batch_sharded(mesh, torch.arange(B * 3).reshape(
        B, 3))[0].numpy()
    out["bcast"] = pmesh.replicated(
        mesh, torch.full((5,), float(r + 7), dtype=torch.float16)).numpy()
    out["gathered"] = mesh.all_rows(torch.tensor([r + 0.5])).numpy()
    return out


def _tiny_transformer(args, leaves):
    from geomx_tpu_torch.models import convert
    from geomx_tpu_torch.models.transformer import Transformer

    model = Transformer(**args["dims"], max_len=args["seq"])
    convert.load_flax_leaves(model, leaves)
    return model


def _job_dp(d, inp, args):
    """``DataParallelTrainer.step`` across the processes, through the
    2-bit ring over the flattened gradient (threshold ``thr``), for
    ``rounds`` rounds. The ring is fed row r of the round's given stack
    ``J<round>`` (the JAX trainer's local grads), so float noise in the
    gradients cannot flip a code; the rank's own local grads are saved
    beside, with the losses and the parameters after each round."""
    import torch

    from geomx_tpu_torch import config as cfg_mod
    from geomx_tpu_torch.kvstore.mesh_party import maybe_init_multihost
    from geomx_tpu_torch.models import convert
    from geomx_tpu_torch.parallel import mesh as pmesh
    from geomx_tpu_torch.parallel import quant_collectives as qc
    from geomx_tpu_torch.parallel.train_step import DataParallelTrainer

    assert maybe_init_multihost(cfg_mod.load())
    leaves = [inp[f"leaf{i}"] for i in range(int(inp["n_leaves"]))]
    model = _tiny_transformer(args, leaves)
    mesh = pmesh.make_party_mesh(0, device="cpu")
    tr = DataParallelTrainer(model, torch.optim.SGD(model.parameters(),
                                                    lr=args["lr"]),
                             mesh, num_classes=args["dims"]["vocab"])
    sizes = [p.numel() for p in tr.params]
    red = qc.QuantRingReducer(mesh, "2bit", sum(sizes), mean=True,
                              threshold=args["thr"])
    out = {}
    own = tr.local_grads

    for rnd in range(args["rounds"]):
        def fed(X, y, rnd=rnd):
            loss, grads = own(X, y)
            out[f"g{rnd}"] = torch.cat([g.reshape(-1) for g in grads]
                                       ).numpy()
            row = torch.from_numpy(inp[f"J{rnd}"][mesh.rank])
            return loss, [g.view(1, *p.shape) for g, p in
                          zip(row.split(sizes), tr.params)]

        tr.local_grads = fed
        timings = {}
        out[f"loss{rnd}"] = np.array(tr.step(inp[f"X{rnd}"], inp[f"y{rnd}"],
                                             reducer=red, timings=timings))
        assert set(timings) >= {"local_grads", "quantize", "hop",
                                "dequantize", "apply"}, timings
        out[f"p{rnd}"] = np.concatenate(
            [l.ravel() for l in convert.flax_leaves(tr.model)])
    return out


def _job_hier(d, inp, args):
    """``HierarchicalTrainer`` over a live HiPS with one party whose
    ranks are the processes, once per mesh codec of ``codecs``: rank 0
    holds the topology (every role on threads of its process, the
    party's global worker among them), the other ranks build their own
    store of the party and start from zero parameters. Run without the
    settings it is the same party on one process (``PartyMesh``), the
    reference. Saves, per codec, each rank's store identity, losses and
    parameters after the initial broadcast and at the end."""
    import torch

    from geomx_tpu_torch import config as cfg_mod
    from geomx_tpu_torch.config import Config
    from geomx_tpu_torch.kvstore.mesh_party import (KVStorePartyMesh,
                                                    maybe_init_multihost)
    from geomx_tpu_torch.models import MLP
    from geomx_tpu_torch.optimizer import SGD
    from geomx_tpu_torch.parallel import mesh as pmesh
    from geomx_tpu_torch.parallel.train_step import (DataParallelTrainer,
                                                     HierarchicalTrainer)
    from geomx_tpu_torch.simulate import InProcessHiPS

    procs = maybe_init_multihost(cfg_mod.load())
    rank = pmesh.make_party_mesh(0, device="cpu").rank if procs else 0
    out = {}

    def flat(params):
        return np.concatenate([p.detach().numpy().ravel() for p in params])

    for codec in args["codecs"]:
        extra = {"mesh_codec": codec, "mesh_block": 8,
                 "wire_2bit_threshold": 0.05}
        topo = None
        if rank == 0:
            topo = InProcessHiPS(num_parties=1, party_mesh_size=args["size"],
                                 device="cpu", extra_cfg=extra).start()
            topo.master.set_optimizer(SGD(learning_rate=args["lr"]))
            kv = topo.workers[0]
        else:
            kv = KVStorePartyMesh(cfg=Config(party_mesh=True,
                                             party_mesh_size=args["size"],
                                             **extra), device="cpu")
        out[f"{codec}_global"] = np.array(kv.is_global_worker)
        out[f"{codec}_van"] = np.array([kv.rank, kv.num_all_workers])
        if not kv.is_global_worker:
            try:
                kv.pull(0)
            except RuntimeError as e:
                out[f"{codec}_refusal"] = np.array(str(e))
        model = MLP(args["in"], tuple(args["features"]))
        tr = DataParallelTrainer(model, None, kv.mesh,
                                 num_classes=args["features"][-1])
        with torch.no_grad():   # rank 0's values; the others start at 0
            for i, p in enumerate(tr.params):
                p.copy_(torch.as_tensor(inp[f"leaf{i}"]) if rank == 0
                        else torch.zeros_like(p))
        ht = HierarchicalTrainer(tr, kv)
        if rank == 0:
            for i, leaf in enumerate(ht._host):
                topo.master.init(i, leaf)
            topo.master.wait()
        ht.init_on_kvstore()
        out[f"{codec}_init"] = flat(tr.params)
        out[f"{codec}_loss"] = np.array([
            ht.step(inp[f"X{rnd}"], inp[f"y{rnd}"])
            for rnd in range(args["rounds"])])
        out[f"{codec}_final"] = flat(tr.params)
        if topo is not None:
            topo.stop()
    return out


JOBS = {"ring": _job_ring, "dp": _job_dp, "hier": _job_hier}


def _main(argv):
    job, d, args = argv[0], Path(argv[1]), json.loads(argv[2])
    inp = {}
    if (d / "in.npz").exists():
        with np.load(d / "in.npz") as z:
            inp = {k: z[k] for k in z.files}
    out = JOBS[job](d, inp, args)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "geomx_tpu"))
    assert not leaked, f"a rank process imported {leaked[:5]}"
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    np.savez(d / f"rank{rank}.npz", **out)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
