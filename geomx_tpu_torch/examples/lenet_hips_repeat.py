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

``--example <name>`` repeats a feature config's loop instead: the
example's own ``run_worker`` (``cnn``, ``cnn_fp16``, ``cnn_bsc``,
``cnn_mpq``, ``cnn_hfa``) on every node of the topology, the master's
part first, from LeNet's init at each seed, with the example's flags
after ``--``; per run it prints the first worker's accuracy every 20
rounds and the peak of the last 20:

  python -m geomx_tpu_torch.examples.lenet_hips_repeat --example cnn_bsc \
      --seeds 42 0 1 2 --rounds 200 --cpu -- -bs 128 -cr 0.01
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib
import threading
import time
from unittest import mock


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


def run_example(name: str, flags, seed: int, rounds: int, device,
                workers_per_party: int = 1):
    """The example's loop over a live two-party ``InProcessHiPS`` for
    ``rounds`` rounds from LeNet's init at ``seed``; returns each party
    worker's accuracies (one per evaluation)."""
    from geomx_tpu_torch.examples import utils
    from geomx_tpu_torch.simulate import InProcessHiPS

    mod = importlib.import_module(f"geomx_tpu_torch.examples.{name}")
    topo_kw = {"use_hfa": True} if name == "cnn_hfa" else {}
    topo = InProcessHiPS(num_parties=2, workers_per_party=workers_per_party,
                         **topo_kw).start()
    common = ["-ep", str(rounds), "--max-iters", str(rounds)] + list(flags)
    master_done = threading.Event()
    res = {}

    def master(kv):
        try:
            mod.run_worker(kv, mod.parse_args(common), device)
        finally:
            master_done.set()

    def worker(kv):
        if not master_done.wait(600):
            raise TimeoutError("the master did not finish its set-up")
        w = topo.workers.index(kv)
        res[w] = mod.run_worker(kv, mod.parse_args(common + ["-ds", str(w)]),
                                device)["accs"]

    build = functools.partial(utils.build_model_and_step, seed=seed)
    try:
        with mock.patch.object(utils, "build_model_and_step", build):
            topo.run_workers(worker, include_master=master, timeout=3600)
    finally:
        topo.stop()
    return [res[w] for w in sorted(res)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[42],
                    help="LeNet init seeds (build_model_and_step's seed)")
    ap.add_argument("--runs", type=int, default=1, help="runs per seed")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--cudnn", choices=("exact", "default", "fp32"),
                    default="exact")
    ap.add_argument("-c", "--cpu", action="store_true")
    ap.add_argument("--example", default=None,
                    help="repeat this feature config's loop instead")
    ap.add_argument("--workers-per-party", type=int, default=1)
    ap.add_argument("flags", nargs="*",
                    help="the example's own flags, after --")
    args = ap.parse_args(argv)

    from geomx_tpu_torch._device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.example is not None:
        for seed in args.seeds:
            for r in range(args.runs):
                t = time.perf_counter()
                accs = run_example(args.example, args.flags, seed,
                                   args.rounds, device,
                                   args.workers_per_party)[0]
                print(f"{args.example} {' '.join(args.flags)} parties 2 x "
                      f"{args.workers_per_party} seed {seed} run {r} device "
                      f"{device.type}: accuracy every 20 rounds "
                      f"{[round(a, 4) for a in accs[19::20]]}, peak of the "
                      f"last 20 {max(accs[-20:]):.4f}, "
                      f"{time.perf_counter() - t:.1f} s", flush=True)
        return
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
