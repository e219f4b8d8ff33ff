#!/usr/bin/env python
"""Repeat the main path and report how far its result moves.

Each run is ``chip_smoke.py`` phase 4a's training: LeNet through
``DeviceResidentTrainer`` over a live two-party ``InProcessHiPS`` (one
worker per party, every role on threads of this process), BSC threshold
0.02, lr 0.05, momentum 0, 128 synthetic-MNIST images per worker, 200
rounds (``bench.py`` ``bench_hips_bsc``'s settings). Per run it prints
both workers' test accuracy and a digest of the final parameters, so
runs that should be identical can be compared.

  python -m geomx_tpu_torch.examples.lenet_hips_repeat \
      --cudnn exact --seeds 42 --runs 3

``--cudnn exact`` is what ``build_model_and_step`` sets on the card
(deterministic algorithms, no TF32); ``--cudnn default`` restores
PyTorch's defaults after the build (TF32, any algorithm) and ``--cudnn
fp32`` allows any algorithm without TF32, to measure what each does.
``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import threading
import time


def run_once(seed: int, rounds: int, device, cudnn: str = "exact",
             batch: int = 128):
    """One topology, ``rounds`` FSA rounds; returns (accuracies, digests)."""
    import numpy as np
    import torch

    from geomx_tpu_torch.examples.utils import build_model_and_step, eval_acc
    from geomx_tpu_torch.io import load_data
    from geomx_tpu_torch.simulate import InProcessHiPS
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    leaves0, _names, grad_step, eval_step = build_model_and_step(
        batch, device=device, seed=seed)
    if cudnn != "exact":
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32 = cudnn == "default"
    warm = threading.Lock()
    res = {}
    topo = InProcessHiPS(num_parties=2, workers_per_party=1).start()

    def master_init(kv):
        for i, leaf in enumerate(leaves0):
            kv.init(i, np.array(leaf))
        kv.wait()

    def worker(kv):
        w = topo.workers.index(kv)
        tr = DeviceResidentTrainer(
            list(leaves0), kv, grad_step, threshold=0.02, learning_rate=0.05,
            momentum=0.0, device=device)
        train_iter, test_iter, _, _ = load_data(batch, 2, w)
        batches = [(torch.as_tensor(X, device=device),
                    torch.as_tensor(y, device=device))
                   for X, y in train_iter]
        with warm:          # no kv round inside: it would wait on the peer
            tr.warmup(*batches[0])
        for it in range(rounds):
            tr.step(*batches[it % len(batches)])
        leaves = tr.leaves
        res[w] = (eval_acc(test_iter, leaves, eval_step, device=device),
                  hashlib.sha256(b"".join(l.tobytes() for l in leaves))
                  .hexdigest()[:16])

    try:
        topo.run_workers(worker, include_master=master_init, timeout=600)
    finally:
        topo.stop()
    return [res[0][0], res[1][0]], [res[0][1], res[1][1]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[42],
                    help="LeNet init seeds (build_model_and_step's seed)")
    ap.add_argument("--runs", type=int, default=1, help="runs per seed")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--cudnn", choices=("exact", "default", "fp32"),
                    default="exact")
    ap.add_argument("-c", "--cpu", action="store_true")
    args = ap.parse_args(argv)

    from geomx_tpu_torch._device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    for seed in args.seeds:
        for r in range(args.runs):
            t = time.perf_counter()
            accs, digests = run_once(seed, args.rounds, device, args.cudnn)
            print(f"seed {seed} run {r} cudnn {args.cudnn} device "
                  f"{device.type}: accuracy {accs[0]:.4f} / {accs[1]:.4f}, "
                  f"leaves {digests[0]} / {digests[1]}, "
                  f"{time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
