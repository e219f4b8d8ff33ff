#!/usr/bin/env python
"""Hierarchical Frequency Aggregation (reference: examples/cnn_hfa.py).

Counterpart of ``examples/cnn_hfa.py``. Each worker runs a LOCAL Adam
step every iteration (gradients on the CUDA card, ``--cpu``: on the
CPU); every K1 steps it pushes its weights divided by the local worker
count (so the party server's sum is the party average) and pulls the
synchronized weights back. The party server syncs with the global tier
only every K2 rounds, exchanging milestone deltas (server-side logic;
enable with MXNET_KVSTORE_USE_HFA=1, MXNET_KVSTORE_HFA_K1,
MXNET_KVSTORE_HFA_K2 — reference: kvstore_dist_server.h:184-187,
1327-1346). Every worker runs:

  python -m geomx_tpu_torch.examples.cnn_hfa [--cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-lr", "--learning-rate", type=float, default=0.001)
    parser.add_argument("-bs", "--batch-size", type=int, default=32)
    parser.add_argument("-ds", "--data-slice-idx", type=int, default=0)
    parser.add_argument("-ep", "--epoch", type=int, default=5)
    parser.add_argument("-sc", "--split-by-class", action="store_true")
    parser.add_argument("-c", "--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    parser.add_argument("--max-iters", type=int, default=0)
    args = parser.parse_args(argv)
    args.period_k1 = int(os.getenv("MXNET_KVSTORE_HFA_K1", 2))
    return args


def run_worker(kv, args, device=None, on_round=None):
    """One node's part (see ``cnn.run_worker``): the master inits the
    keys and returns None; a party worker returns ``{"leaves", "accs",
    "losses", "step_ms"}`` (accuracies at the syncs; ``step_ms``
    per iteration, the sync included where there is one)."""
    from geomx_tpu_torch import optimizer as gx_opt
    from geomx_tpu_torch.examples.utils import (Measure, build_model_and_step,
                                                eval_acc, host_grad_step,
                                                init_and_pull, load_data)

    num_all_workers = kv.num_all_workers
    num_local_workers = kv.num_workers
    my_rank = kv.rank
    time.sleep(1)

    leaves, _names, grad_step, eval_step = build_model_and_step(
        args.batch_size, device=device)
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
    measure = Measure(sub_dir=f"cnn_hfa_rank{my_rank}")
    out = {"leaves": leaves, "accs": [], "losses": [], "step_ms": []}
    print(f"Start training on {num_all_workers} workers, my rank is {my_rank}.")
    for epoch in range(args.epoch):
        for X, y in train_iter:
            t0 = time.perf_counter()
            loss, grads = step(leaves, X, y)
            # local step every iteration (reference: trainer.step)
            for idx, g in enumerate(grads):
                leaves[idx] = local_opt.update(idx, leaves[idx], g).reshape(
                    leaves[idx].shape)
            synced = global_iters % args.period_k1 == 0
            if synced:
                # HFA sync: push weights/num_local_workers, pull party avg
                # (reference: cnn_hfa.py:120-123)
                for idx in range(len(leaves)):
                    kv.push(idx, leaves[idx] / num_local_workers,
                            priority=-idx)
                    kv.pull(idx, out=leaves[idx], priority=-idx)
                kv.wait()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if on_round is not None:
                on_round(global_iters)
            out["losses"].append(float(loss))

            if synced:
                test_acc = eval_acc(test_iter, leaves, eval_step,
                                    device=device)
                print("[Time %.3f][Epoch %d][Iteration %d] Test Acc %.4f"
                      % (time.time() - begin_time, epoch, global_iters,
                         test_acc))
                measure.add(global_iters, epoch, test_acc, len(X),
                            out["losses"][-1])
                out["accs"].append(test_acc)
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
