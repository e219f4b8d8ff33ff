#!/usr/bin/env python
"""ESync: heterogeneity-balanced synchronous training on the demo CNN.

Counterpart of ``examples/cnn_esync.py``, with the same flags, roles and
prints. Each sync round a worker runs M_i local Adam steps (on the CUDA
card; ``--cpu``: on the CPU), M_i assigned by the state server on the
party's rank-0 PS so every worker's reach-server time balances against
the slowest, then joins a synchronous model average
(``geomx_tpu_torch/esync.py``). In a multi-process topology (``DMLC_*``
roles; infrastructure roles run ``python -m
geomx_tpu_torch.kvstore_server``) every worker runs:

  python -m geomx_tpu_torch.examples.cnn_esync [-r ROUNDS] [--cpu]

or, single-process: ``--local``. ``--slowdown S`` adds S seconds of
sleep to every local step, so heterogeneity shows on a uniform host.

``run_worker(kv, args, device)`` is the body each node runs once its
store exists, so an ``InProcessHiPS`` can drive the same loop.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-lr", "--learning-rate", type=float, default=0.001)
    parser.add_argument("-bs", "--batch-size", type=int, default=32)
    parser.add_argument("-ds", "--data-slice-idx", type=int, default=None)
    parser.add_argument("-r", "--rounds", type=int, default=30,
                        help="sync rounds to run")
    parser.add_argument("--slowdown", type=float, default=0.0,
                        help="artificial seconds of extra compute per "
                             "local step (heterogeneity injection)")
    parser.add_argument("--local", action="store_true")
    parser.add_argument("-c", "--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    return parser.parse_args(argv)


def run_worker(kv, args, device=None, on_round=None):
    """One node's part: the master inits the keys and returns None; a
    party worker runs ``args.rounds`` ESync rounds and returns
    ``{"leaves", "losses", "steps", "local_steps", "acc"}`` (``steps``:
    the M_i each round ran with). ``on_round(r)`` runs after round
    ``r``'s sync and report."""
    from geomx_tpu_torch import optimizer as gx_opt
    from geomx_tpu_torch.esync import ESyncTrainer
    from geomx_tpu_torch.examples.utils import (build_model_and_step,
                                                eval_acc, host_grad_step,
                                                load_data)

    my_rank = getattr(kv, "rank", 0)
    time.sleep(0 if args.local else 1)

    leaves, _names, grad_step, eval_step = build_model_and_step(
        args.batch_size, device=device)
    if getattr(kv, "is_master_worker", False):
        for idx, leaf in enumerate(leaves):
            kv.init(idx, leaf)
        kv.wait()
        return None

    step = host_grad_step(leaves, grad_step, device)

    def grad_fn(leaf_list, X, y):
        if args.slowdown:
            time.sleep(args.slowdown)
        loss, grads = step(leaf_list, X, y)
        return float(loss), grads

    opt = gx_opt.Adam(learning_rate=args.learning_rate)
    tr = ESyncTrainer(leaves, kv, grad_fn, opt)

    slice_idx = (args.data_slice_idx if args.data_slice_idx is not None
                 else my_rank)
    nslices = max(getattr(kv, "num_all_workers", 1), 1)
    train_iter, test_iter, _, _ = load_data(args.batch_size, nslices,
                                            slice_idx)
    batches = list(itertools.islice(train_iter, 8))
    out = {"losses": [], "steps": []}
    for r in range(args.rounds):
        out["steps"].append(tr.steps)
        loss = tr.round(batches)
        out["losses"].append(loss)
        if on_round is not None:
            on_round(r)
        if r % 5 == 0 or r == args.rounds - 1:
            print(f"[esync rank {my_rank}] round {r} steps={tr.steps} "
                  f"local_steps_total={tr.local_steps_run} "
                  f"loss={loss:.4f}", flush=True)
    acc = eval_acc(test_iter, tr.leaves, eval_step, device=device)
    print(f"[esync rank {my_rank}] final acc={acc:.4f} "
          f"local_steps_total={tr.local_steps_run}", flush=True)
    out.update(leaves=tr.leaves, local_steps=tr.local_steps_run, acc=acc)
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    import geomx_tpu_torch as gx
    from geomx_tpu_torch._device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    kv = gx.kv.create("local" if args.local else "dist_sync", device=device)
    run_worker(kv, args, device)


if __name__ == "__main__":
    main()
