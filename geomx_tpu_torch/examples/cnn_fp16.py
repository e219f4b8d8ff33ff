#!/usr/bin/env python
"""FP16 low-precision transmission (reference: examples/cnn_fp16.py).

Counterpart of ``examples/cnn_fp16.py``: LeNet computes in bf16 on the
card (bf16 parameters and inputs, fp32 logits and loss), the wire carries
fp16 both ways (init, gradient pushes and parameter pulls), and the
global server runs Adam against fp32 master weights
(``kv.set_multi_precision()``), halving the WAN bytes of the dense
round. Every worker runs:

  python -m geomx_tpu_torch.examples.cnn_fp16 [--cpu]
"""

from __future__ import annotations

import argparse
import logging
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
    return parser.parse_args(argv)


def run_worker(kv, args, device=None, on_round=None):
    """One node's part (see ``cnn.run_worker``): the master ships Adam
    and multi-precision and returns None; a party worker returns
    ``{"leaves", "accs", "losses", "step_ms"}`` with fp32 leaves."""
    import numpy as np
    import torch

    from geomx_tpu_torch import optimizer as gx_opt
    from geomx_tpu_torch.examples.utils import (Measure, build_model_and_step,
                                                eval_acc, host_grad_step,
                                                init_and_pull, load_data)

    if kv.is_master_worker:
        kv.set_optimizer(gx_opt.Adam(learning_rate=args.learning_rate))
        # weights live on the servers as fp16: keep fp32 masters there
        # (reference: kSetMultiPrecision, kvstore_dist_server.h:324)
        kv.set_multi_precision()
    num_all_workers = kv.num_all_workers
    my_rank = kv.rank
    time.sleep(1)

    leaves, _names, grad_step, eval_step = build_model_and_step(
        args.batch_size, compute_dtype=torch.bfloat16, device=device)

    # fp16 on the wire: init and all traffic in float16
    leaves16 = [l.astype(np.float16) for l in leaves]
    init_and_pull(kv, leaves16)
    if kv.is_master_worker:
        return None
    leaves = [l.astype(np.float32) for l in leaves16]

    train_iter, test_iter, _, _ = load_data(
        args.batch_size, num_all_workers, args.data_slice_idx,
        split_by_class=args.split_by_class)
    step = host_grad_step(leaves, grad_step, device)

    begin_time = time.time()
    global_iters = 1
    measure = Measure(sub_dir=f"cnn_fp16_rank{my_rank}")
    out = {"leaves": leaves, "accs": [], "losses": [], "step_ms": []}
    print(f"Start training on {num_all_workers} workers, my rank is {my_rank}.")
    for epoch in range(args.epoch):
        for X, y in train_iter:
            t0 = time.perf_counter()
            loss, grads = step(leaves, X, y)
            keylist = list(range(len(grads)))
            kv.push(keylist, [g.astype(np.float16) for g in grads])
            kv.pull(keylist, out=leaves16)
            kv.wait()
            leaves = [l.astype(np.float32) for l in leaves16]
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if on_round is not None:
                on_round(global_iters)

            loss = float(loss)
            test_acc = eval_acc(test_iter, leaves, eval_step, device=device)
            print("[Time %.3f][Epoch %d][Iteration %d] Test Acc %.4f"
                  % (time.time() - begin_time, epoch, global_iters, test_acc))
            measure.add(global_iters, epoch, test_acc, len(X), loss)
            out["leaves"] = leaves
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
