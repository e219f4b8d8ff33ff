#!/usr/bin/env python
"""Bi-Sparse Compression (reference: examples/cnn_bsc.py).

Counterpart of ``examples/cnn_bsc.py``. BSC mode is gradient aggregation
only: the global server holds the summed gradient (no server optimizer),
the WAN hop is sparsified both ways (push: momentum-corrected top-k;
pull: the non-zero filter), and every worker applies Adam LOCALLY to the
pulled global gradient (reference: Trainer(update_on_kvstore=False),
examples/cnn_bsc.py:77-121). The gradients are computed on the CUDA card
(``--cpu``: on the CPU). Every worker runs:

  python -m geomx_tpu_torch.examples.cnn_bsc [--cpu]
"""

from __future__ import annotations

import argparse
import logging
import time


def make_parser(lr: float = 0.01) -> argparse.ArgumentParser:
    """The flags of ``cnn_bsc.py`` (and ``cnn_mpq.py``, whose default lr
    is 0.001)."""
    parser = argparse.ArgumentParser()
    # reference default: cnn_bsc.py:33 uses lr 0.01 (10x the vanilla
    # example's 0.001 — sparse top-k gradients need the hotter rate)
    parser.add_argument("-lr", "--learning-rate", type=float, default=lr)
    parser.add_argument("-bs", "--batch-size", type=int, default=32)
    parser.add_argument("-ds", "--data-slice-idx", type=int, default=0)
    parser.add_argument("-ep", "--epoch", type=int, default=5)
    parser.add_argument("-cr", "--compression-ratio", type=float, default=0.01)
    parser.add_argument("-sc", "--split-by-class", action="store_true")
    parser.add_argument("-c", "--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    parser.add_argument("--max-iters", type=int, default=0)
    return parser


def parse_args(argv=None):
    return make_parser().parse_args(argv)


def run_worker(kv, args, device=None, on_round=None):
    """One node's part (see ``cnn.run_worker``): the master sets BSC on
    the WAN hop and returns None; a party worker returns ``{"leaves",
    "accs", "losses", "step_ms"}``."""
    return train_local_adam(
        kv, args, {"type": "bsc", "threshold": args.compression_ratio},
        "cnn_bsc", device, on_round)


def train_local_adam(kv, args, compression, name, device=None,
                     on_round=None):
    """The loop of ``cnn_bsc.py`` and ``cnn_mpq.py``: the master ships
    ``compression``; each worker pushes its gradients, pulls the global
    aggregate and steps a local Adam."""
    import numpy as np

    from geomx_tpu_torch import optimizer as gx_opt
    from geomx_tpu_torch.examples.utils import (Measure, build_model_and_step,
                                                eval_acc, host_grad_step,
                                                init_and_pull, load_data)

    if kv.is_master_worker:
        kv.set_gradient_compression(compression)
    num_all_workers = kv.num_all_workers
    my_rank = kv.rank
    time.sleep(1)

    leaves, _names, grad_step, eval_step = build_model_and_step(
        args.batch_size, device=device)
    # local optimizer per worker (reference: Trainer update_on_kvstore=False)
    local_opt = gx_opt.Adam(learning_rate=args.learning_rate)

    init_and_pull(kv, leaves)
    if kv.is_master_worker:
        return None

    train_iter, test_iter, _, _ = load_data(
        args.batch_size, num_all_workers, args.data_slice_idx,
        split_by_class=args.split_by_class)
    step = host_grad_step(leaves, grad_step, device)

    begin_time = time.time()
    global_iters = 1
    measure = Measure(sub_dir=f"{name}_rank{my_rank}")
    grad_bufs = [np.zeros_like(l) for l in leaves]
    out = {"leaves": leaves, "accs": [], "losses": [], "step_ms": []}
    print(f"Start training on {num_all_workers} workers, my rank is {my_rank}.")
    for epoch in range(args.epoch):
        for X, y in train_iter:
            t0 = time.perf_counter()
            loss, grads = step(leaves, X, y)
            # one batched message per server each way; the pull-back
            # is the globally-aggregated (sparsified) gradient
            keylist = list(range(len(grads)))
            kv.push(keylist, grads)
            kv.pull(keylist, out=grad_bufs)
            kv.wait()
            for idx in range(len(leaves)):
                leaves[idx] = local_opt.update(
                    idx, leaves[idx], grad_bufs[idx]).reshape(
                        leaves[idx].shape)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if on_round is not None:
                on_round(global_iters)

            loss = float(loss)
            test_acc = eval_acc(test_iter, leaves, eval_step, device=device)
            print("[Time %.3f][Epoch %d][Iteration %d] Test Acc %.4f"
                  % (time.time() - begin_time, epoch, global_iters, test_acc))
            measure.add(global_iters, epoch, test_acc, len(X), loss)
            out["accs"].append(test_acc)
            out["losses"].append(loss)
            if args.max_iters and global_iters >= args.max_iters:
                measure.dump()
                return out
            global_iters += 1
    measure.dump()
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    import geomx_tpu_torch as gx
    from geomx_tpu_torch._device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    run_worker(gx.kv.create("dist_sync", device=device), args, device)


if __name__ == "__main__":
    main()
