#!/usr/bin/env python
"""Bi-Sparse HiPS with the device-resident trainer on the demo CNN.

Counterpart of ``examples/cnn_bsc_device.py``, the main path of
BASELINE.md: HiPS FSA with BSC in both directions, aggregator tiers and
the worker-side SGD of ``DeviceResidentTrainer``. The parameters stay on
the CUDA card; per round the host link carries one packed top-k
selection down and the aggregated nonzeros up.

In a multi-process topology (``DMLC_*`` roles, infrastructure roles run
``python -m geomx_tpu_torch.kvstore_server``) every worker runs:

  python -m geomx_tpu_torch.examples.cnn_bsc_device

or, single-process: ``--local``; ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import time


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("-lr", "--learning-rate", type=float, default=0.05)
    ap.add_argument("-mom", "--momentum", type=float, default=0.0)
    ap.add_argument("-bs", "--batch-size", type=int, default=32)
    ap.add_argument("-ds", "--data-slice-idx", type=int, default=0)
    ap.add_argument("-ep", "--epoch", type=int, default=5)
    ap.add_argument("-cr", "--compression-ratio", type=float, default=0.02)
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--local", action="store_true",
                    help="single-process smoke (kv.create('local'))")
    ap.add_argument("--eval-every", type=int, default=5,
                    help="accuracy-eval cadence (tr.leaves pays one "
                         "full-weight device->host transfer)")
    ap.add_argument("--max-iters", type=int, default=0)
    args = ap.parse_args(argv)

    import geomx_tpu_torch as gx
    from geomx_tpu_torch._device import resolve_device
    from geomx_tpu_torch.examples.utils import (build_model_and_step,
                                                eval_acc, load_data)
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    device = resolve_device("cpu" if args.cpu else None)
    kv = gx.kv.create("local" if args.local else "dist_sync")
    if getattr(kv, "is_master_worker", False) or args.local:
        # WAN hop sparsified both directions, like cnn_bsc.py
        kv.set_gradient_compression(
            {"type": "bsc", "threshold": args.compression_ratio})
    num_all_workers = getattr(kv, "num_all_workers", 1) or 1
    my_rank = getattr(kv, "rank", 0)

    leaves, _names, grad_step, eval_step = build_model_and_step(
        args.batch_size, device=device)
    if getattr(kv, "is_master_worker", False):
        for idx, leaf in enumerate(leaves):
            kv.init(idx, leaf)
        kv.wait()
        return

    tr = DeviceResidentTrainer(
        leaves, kv, grad_step, threshold=args.compression_ratio,
        learning_rate=args.learning_rate, momentum=args.momentum,
        device=device)
    train_iter, test_iter, _, _ = load_data(
        args.batch_size, num_all_workers, args.data_slice_idx)

    begin = time.time()
    global_iters = 1
    print(f"Start training on {num_all_workers} workers, my rank is "
          f"{my_rank}, on {device}.", flush=True)
    test_acc = 0.0
    for epoch in range(args.epoch):
        for X, y in train_iter:
            tr.step(X, y)
            # tr.leaves copies the full params to the host: eval on a
            # cadence, off the per-round path
            if global_iters % args.eval_every == 0:
                test_acc = eval_acc(test_iter, tr.leaves, eval_step,
                                    device=device)
            print("[Time %.3f][Epoch %d][Iteration %d] Test Acc %.4f"
                  % (time.time() - begin, epoch, global_iters, test_acc),
                  flush=True)
            if args.max_iters and global_iters >= args.max_iters:
                return
            global_iters += 1


if __name__ == "__main__":
    main()
