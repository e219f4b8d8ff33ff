#!/usr/bin/env python
"""Vanilla HiPS training: dist_sync (FSA) / dist_async (MixedSync/DCASGD).

Counterpart of ``examples/cnn.py``, with the same flags, roles and
per-iteration accuracy print: the master worker ships the optimizer
(Adam, or DCASGD with ``-dc``) to the global server and steps aside after
init; every party worker computes LeNet's gradients on the CUDA card
(``--cpu``: on the CPU; ``--model`` picks a zoo model instead, e.g.
``--model resnet50 -dt cifar10``) and sends them in one combined
``push_pull`` per round, whose answer is the updated parameters. In a multi-process
topology (``DMLC_*`` roles; infrastructure roles run ``python -m
geomx_tpu_torch.kvstore_server``) every worker runs:

  python -m geomx_tpu_torch.examples.cnn [-ms | -dc] [--cpu]

With ``GEOMX_PARTY_MESH=1`` the same launch runs the mesh-party tier:
``dist_sync`` resolves to the mesh-party store, one worker per party
trains on the party's batch over a mesh of ``GEOMX_PARTY_MESH_SIZE``
ranks, and with a ``GEOMX_MESH_CODEC`` the ranks' gradients meet in the
quantized ring instead of the plain mean (``build_mesh_ring_step``).
With the ``GEOMX_MESH_*`` settings the party's ranks are processes
(``scripts/hips_env.sh`` ``MESH_PROCS``): each computes its own rows of
the party batch, the ring (or, with no codec, the group's all-reduce)
runs across them, only rank 0 speaks the van, and the others take the
parameters it pulls by the store's broadcast; every rank prints the
accuracy.

``run_worker(kv, args, device)`` is the body each node runs once its
store exists, so an ``InProcessHiPS`` can drive the same loop.
"""

from __future__ import annotations

import argparse
import logging
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    # the reference defaults to 0.01 (examples/cnn.py:32) but Adam at 0.01
    # plateaus at chance on this CNN; 0.001 learns to >0.95 within an epoch
    parser.add_argument("-lr", "--learning-rate", type=float, default=0.001)
    parser.add_argument("-bs", "--batch-size", type=int, default=32)
    parser.add_argument("-ds", "--data-slice-idx", type=int, default=0)
    parser.add_argument("-dt", "--data-type", type=str, default="mnist",
                        choices=["mnist", "fashion-mnist", "cifar10"])
    parser.add_argument("-m", "--model", type=str, default="cnn",
                        help="cnn | resnet18 | resnet34 | resnet50 | ... "
                             "(any geomx_tpu_torch.models.get_model name)")
    parser.add_argument("-ep", "--epoch", type=int, default=5)
    parser.add_argument("-ms", "--mixed-sync", action="store_true")
    parser.add_argument("-dc", "--dcasgd", action="store_true")
    parser.add_argument("-sc", "--split-by-class", action="store_true")
    parser.add_argument("-c", "--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    parser.add_argument("--max-iters", type=int, default=0,
                        help="stop after N iterations (0 = full epochs)")
    parser.add_argument("--checkpoint-prefix", type=str, default="",
                        help="save params each epoch; resume from the "
                             "latest epoch if one exists")
    return parser.parse_args(argv)


def run_worker(kv, args, device=None, on_round=None):
    """One node's part: the master ships the optimizer, inits the keys
    and returns None; a party worker trains and returns ``{"leaves",
    "accs", "losses", "step_ms", "wire_ms"}`` (``step_ms``: gradients
    plus the combined round, per iteration; ``wire_ms``: the combined
    round alone). ``on_round(i)`` runs after round
    ``i``'s wire completes."""
    import numpy as np

    from geomx_tpu_torch import checkpoint
    from geomx_tpu_torch import optimizer as gx_opt
    from geomx_tpu_torch.examples.utils import (Measure,
                                                build_mesh_ring_step,
                                                build_model_and_step,
                                                eval_acc, host_grad_step,
                                                init_and_pull, load_data,
                                                process_party, sync_leaves)

    if kv.is_master_worker:
        opt = (gx_opt.DCASGD if args.dcasgd else gx_opt.Adam)(
            learning_rate=args.learning_rate)
        kv.set_optimizer(opt)
    num_all_workers = kv.num_all_workers
    my_rank = kv.rank
    time.sleep(1)  # let configuration commands land (reference: cnn.py:86)

    input_shape = (32, 32, 3) if args.data_type == "cifar10" else (28, 28, 1)
    leaves, _names, grad_step, eval_step = build_model_and_step(
        args.batch_size, input_shape=input_shape, model=args.model,
        device=device)
    procs = process_party(kv)
    if (getattr(kv, "type", "") == "dist_sync_mesh"
            and (getattr(kv, "mesh_codec", "none") != "none" or procs)
            and args.model == "cnn"
            and not kv.is_master_worker):
        # GEOMX_MESH_CODEC: the party's gradients ride the quantized ring
        # instead of the plain mean over the party batch (the zoo's steps
        # are stateful, so only the demo CNN's, as in the JAX example);
        # over processes every rank takes its own rows
        grad_step = build_mesh_ring_step(kv, grad_step)
    elif procs:
        raise NotImplementedError(
            f"a party over processes runs the demo CNN, not {args.model!r}")

    start_epoch = 0
    resume_iters = 0
    if args.checkpoint_prefix:
        latest = checkpoint.latest_checkpoint(args.checkpoint_prefix)
        if latest is not None:
            saved, _, meta = checkpoint.load_checkpoint(
                args.checkpoint_prefix, latest)
            leaves = [np.array(l, np.float32) for l in saved]
            start_epoch = latest
            resume_iters = int(meta.get("iters", 0))
            print(f"Resumed from {args.checkpoint_prefix}-{latest:04d}.ckpt "
                  f"(epoch {latest}, iter {resume_iters}).")

    init_and_pull(kv, leaves)
    if kv.is_master_worker:
        return None

    train_iter, test_iter, _, _ = load_data(
        args.batch_size, num_all_workers, args.data_slice_idx,
        data_type=args.data_type, split_by_class=args.split_by_class)
    step = host_grad_step(leaves, grad_step, device)

    begin_time = time.time()
    global_iters = resume_iters + 1 if args.checkpoint_prefix else 1
    measure = Measure(sub_dir=f"cnn_rank{my_rank}"
                      + (f"_mesh{kv.mesh.rank}" if procs else ""))
    out = {"leaves": leaves, "accs": [], "losses": [], "step_ms": [],
           "wire_ms": []}
    print(f"Start training on {num_all_workers} workers, my rank is {my_rank}.")
    for epoch in range(start_epoch, args.epoch):
        for X, y in train_iter:
            if hasattr(kv, "notify_round"):
                # FaultPlan "crash at_round N" rules key off this counter
                kv.notify_round(global_iters)
            t0 = time.perf_counter()
            loss, grads = step(leaves, X, y)
            t1 = time.perf_counter()
            # combined push_pull: ONE message per server per round (the
            # ack carries the post-round params); falls back to the
            # two-op sequence under P3/TSEngine/local stores
            if getattr(kv, "is_global_worker", True):
                kv.push_pull(list(range(len(grads))), grads, out=leaves)
                kv.wait()
            sync_leaves(kv, leaves)
            t2 = time.perf_counter()
            out["step_ms"].append((t2 - t0) * 1e3)
            out["wire_ms"].append((t2 - t1) * 1e3)
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
        if args.checkpoint_prefix and my_rank == 0 and \
                getattr(kv, "is_global_worker", True):
            checkpoint.save_checkpoint(args.checkpoint_prefix, epoch + 1,
                                       [np.asarray(l) for l in leaves],
                                       metadata={"iters": global_iters - 1})
    measure.dump()
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    import geomx_tpu_torch as gx
    from geomx_tpu_torch._device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    # GEOMX_PARTY_MESH=1 resolves "dist_sync" to the mesh-party store,
    # whose party mesh lives on ``device``
    kv = gx.kv.create("dist_async" if args.mixed_sync or args.dcasgd
                      else "dist_sync", device=device)
    run_worker(kv, args, device)


if __name__ == "__main__":
    main()
