#!/usr/bin/env python
"""One process of a party over several processes: the body of
``geomx_tpu_torch/scripts/run_mesh_multihost.sh``, which starts one per
rank with the ``GEOMX_MESH_*`` settings.

The process joins the party's gloo group
(``kvstore.mesh_party.maybe_init_multihost``) and checks that every
process agrees on the group's size and that process 0, and only it, is
the party's van-speaking global worker. Then, for each codec, it runs
the quantized ring all-reduce (mean) across the processes on one seeded
row of ``--n`` values (numpy ``RandomState(process id)``, as the JAX
package's script draws its rows) and prints one line: the link bytes per
round, the sha256 of its output and its ``two_bit`` launches.

  python -m geomx_tpu_torch.tools.mesh_multihost [--cpu] [--codecs int8 2bit]
      [--n 65536] [--out-dir DIR]

On the CUDA card unless ``--cpu`` is given. ``--out-dir`` saves each
codec's output as ``proc<id>_<codec>.npy``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from geomx_tpu_torch import config as cfg_mod
from geomx_tpu_torch.kvstore.mesh_party import maybe_init_multihost
from geomx_tpu_torch.ops import two_bit as tb
from geomx_tpu_torch.parallel import mesh as pmesh
from geomx_tpu_torch.parallel.quant_collectives import QuantRingReducer


def say(line: str) -> None:
    """One write per line: the processes share the terminal."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    parser.add_argument("--codecs", nargs="+", default=None,
                        help="ring codecs in turn (default: "
                             "GEOMX_MESH_CODEC, else int8)")
    parser.add_argument("--n", type=int, default=1 << 16)
    parser.add_argument("--out-dir", default="")
    args = parser.parse_args(argv)

    cfg = cfg_mod.load()
    if not maybe_init_multihost(cfg):
        raise SystemExit("the GEOMX_MESH_* settings formed no group")
    mesh = pmesh.make_party_mesh(0, device="cpu" if args.cpu else None)
    me = int(cfg.mesh_process_id)
    rank, world = dist.get_rank(), dist.get_world_size()
    is_global = rank == 0
    say(f"proc {me}: rank={rank} global_worker={is_global} world={world} "
        f"device={mesh.device}")
    # exactly process 0 is the party's van speaker, with no extra config
    if (rank == 0) != (me == 0):
        raise SystemExit(f"global-worker selection mismatch: proc {me} "
                         f"got rank {rank}")
    seen = mesh.all_rows(torch.tensor([[world, int(is_global)]]))
    if not bool((seen[:, 0] == world).all()) or int(seen[:, 1].sum()) != 1:
        raise SystemExit(f"sizes / global workers disagree: {seen.tolist()}")

    row = np.random.RandomState(me).randn(1, args.n).astype(np.float32)[0]
    for codec in args.codecs or [cfg.mesh_codec or "int8"]:
        red = QuantRingReducer(mesh, codec, args.n, block=cfg.mesh_block,
                               mean=True)
        before = tb.LAUNCHES["two_bit"]
        out = red.reduce(torch.from_numpy(row[None]).to(mesh.device)
                         )[0].cpu().numpy()
        say(f"proc {me}: ring all-reduce OK codec={codec} n={args.n} "
            f"bytes/round={red.wire_bytes_per_round()} "
            f"|out|={np.abs(out).max():.4f} "
            f"sha256={hashlib.sha256(out.tobytes()).hexdigest()[:16]} "
            f"two_bit={tb.LAUNCHES['two_bit'] - before}")
        if args.out_dir:
            np.save(os.path.join(args.out_dir, f"proc{me}_{codec}.npy"), out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
