#!/usr/bin/env python
"""The 59M-param transformer through Bi-Sparse, device-resident, on CUDA.

Counterpart of ``examples/transformer_bsc_device.py``: the decoder-only
transformer (dim 512, depth 8, heads 8, vocab 32768, seq 512 by default)
trains through :class:`DeviceResidentTrainer` — parameters never leave
the card; the host link carries only the per-tensor BSC top-k selection
down and the aggregated nonzeros up. Attention is FlashAttention-2, the
CUDA kernels of ``geomx_tpu_torch/ops``. Without ``--local`` it is one
worker of a live HiPS topology (``dist_sync``: ``DMLC_*`` roles, the
infrastructure roles run ``python -m geomx_tpu_torch.kvstore_server``;
the master worker initialises the keys and returns); with ``--local`` it
runs alone on the single-process store:

  python -m geomx_tpu_torch.examples.transformer_bsc_device --local --max-iters 5

Synthetic LM task: next token = (3*t + 7) mod vocab, a deterministic
pattern, so the loss curve is a real learning signal."""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch


def synth_batch(rng, batch, seq_len, vocab):
    """Deterministic-pattern LM batch: x[t+1] = (3*x[t] + 7) % vocab."""
    start = rng.integers(0, vocab, size=(batch, 1))
    toks = [start]
    for _ in range(seq_len - 1):
        toks.append((3 * toks[-1] + 7) % vocab)
    return np.concatenate(toks, axis=1).astype(np.int32)


def build_transformer_grad_step(dim, depth, heads, vocab, seq_len,
                                compute_dtype=None, *, device=None,
                                attn: Union[str, Callable] = "auto",
                                init_leaves: Optional[Sequence] = None,
                                seed: int = 42):
    """(leaves, grad_step) with the leaf-list contract
    ``grad_step(leaves, tokens, None) -> (loss, grad_leaves)`` the
    trainers expect. ``leaves`` are fp32 numpy arrays in flax leaf order,
    from ``init_leaves`` (e.g. the JAX package's) or a seeded init;
    ``attn`` is a :func:`make_attention` name or an attention callable."""
    from geomx_tpu_torch._device import resolve_device
    from geomx_tpu_torch.models.convert import (flax_leaves, leaf_names,
                                                load_flax_leaves,
                                                thread_safe_call)
    from geomx_tpu_torch.models.transformer import (Transformer,
                                                    make_attention)

    dev = resolve_device(device)
    attn_fn = make_attention(attn) if isinstance(attn, str) else attn
    model = Transformer(vocab=vocab, dim=dim, depth=depth, heads=heads,
                        max_len=seq_len, attn_fn=attn_fn,
                        compute_dtype=compute_dtype or torch.bfloat16,
                        generator=torch.Generator().manual_seed(seed))
    if init_leaves is not None:
        load_flax_leaves(model, init_leaves)
    leaves = flax_leaves(model)
    names = leaf_names(model)
    call = thread_safe_call(model.to(dev))

    def loss_fn(leaf_list, toks):
        params = dict(zip(names, leaf_list))
        toks = toks.long()
        logits = call(params, toks[:, :-1])
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, toks[:, 1:, None]).mean()

    def grad_step(leaf_list, toks, _y):
        leaf_list = [p.detach().requires_grad_(True) for p in leaf_list]
        loss = loss_fn(leaf_list, toks)
        grads = torch.autograd.grad(loss, leaf_list)
        return loss.detach(), grads

    return leaves, grad_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("-bs", "--batch-size", type=int, default=8)
    ap.add_argument("-lr", "--learning-rate", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("-cr", "--compression-ratio", type=float, default=0.01,
                    help="BSC threshold: per-tensor top-k keeps this "
                         "fraction of coordinates")
    ap.add_argument("-ds", "--data-slice-idx", type=int, default=None,
                    help="worker slice id; seeds this worker's data "
                         "stream; defaults to the kv rank")
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--timed", type=int, default=0,
                    help="after training, N more rounds through "
                         "step_timed, each printed as a 'step_timed' JSON "
                         "line (compute / d2h / wire / h2d / apply ms)")
    ap.add_argument("--local", action="store_true",
                    help="single-process local kvstore (no topology)")
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    import geomx_tpu_torch as gx
    from geomx_tpu_torch._device import resolve_device
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    device = resolve_device("cpu" if args.cpu else None)
    kv = gx.kv.create("local" if args.local else "dist_sync",
                      device=device)
    num_all_workers = getattr(kv, "num_all_workers", 1) or 1
    my_rank = getattr(kv, "rank", 0)

    leaves, grad_step = build_transformer_grad_step(
        args.dim, args.depth, args.heads, args.vocab, args.seq_len,
        device=device)
    n_params = sum(l.size for l in leaves)
    if getattr(kv, "is_master_worker", False):
        for idx, leaf in enumerate(leaves):
            kv.init(idx, leaf)
        kv.wait()
        return

    tr = DeviceResidentTrainer(
        leaves, kv, grad_step, threshold=args.compression_ratio,
        learning_rate=args.learning_rate, momentum=args.momentum,
        device=device)
    print(f"[worker {my_rank}] {n_params / 1e6:.1f}M params on {device}, "
          f"per-round selection {tr.k} of {tr.total} "
          f"({100.0 * tr.k / tr.total:.2f}%)", flush=True)

    slice_idx = (my_rank if args.data_slice_idx is None
                 else args.data_slice_idx)
    rng = np.random.default_rng(1234 + slice_idx)  # disjoint data slices
    begin = time.time()
    for it in range(1, args.max_iters + 1):
        toks = synth_batch(rng, args.batch_size, args.seq_len, args.vocab)
        loss = tr.step(toks, None)
        tokens_s = (it * args.batch_size * args.seq_len * num_all_workers
                    / (time.time() - begin))
        print(f"[Time {time.time() - begin:.3f}][Iteration {it}] "
              f"Loss {loss:.4f} ({tokens_s:.0f} tok/s)", flush=True)
    for _ in range(args.timed):
        toks = synth_batch(rng, args.batch_size, args.seq_len, args.vocab)
        print("step_timed " + json.dumps(tr.step_timed(toks, None)[1]),
              flush=True)


if __name__ == "__main__":
    main()
