#!/usr/bin/env python
r"""Long-context transformer training over a dp x tp x sp mesh.

Counterpart of ``examples/train_transformer.py``, with its flags,
defaults and printed lines: batch over "dp", sequence over "sp" (ring
attention, :mod:`geomx_tpu_torch.parallel.ring_attention`), attention
heads and MLP hidden over "tp" (the Megatron layout rules of
``transformer_param_sharding``), bf16 compute, AdamW, optional gradient
accumulation (``--microbatches``), rematerialised blocks (``--remat``)
and sharded checkpoints with resume from the latest step
(``--ckpt-dir``, ``--ckpt-every``).

Every rank of the mesh shares one device (the CUDA card unless
``--cpu``), so the JAX example's "all local devices" is a flag here:
``--ranks`` (default tp x sp, i.e. dp 1). With sp 1 attention is the
FlashAttention-2 kernels on the card (one launch over all dp/tp shards),
dense attention on the CPU; with sp > 1 it is ring attention.

  python -m geomx_tpu_torch.examples.train_transformer --cpu --tp 2 \
      --sp 2 --max-iters 3
  python -m geomx_tpu_torch.examples.train_transformer --tp 2 \
      --microbatches 2 --remat --ckpt-dir ckpt
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the mesh, all on one device "
                         "(default tp*sp: dp 1)")
    ap.add_argument("-lr", "--learning-rate", type=float, default=3e-4)
    ap.add_argument("--max-iters", type=int, default=20)
    ap.add_argument("--ckpt-dir", type=str, default="",
                    help="sharded-checkpoint dir; resumes from the "
                         "latest step when one exists")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize transformer blocks")
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    return ap.parse_args(argv)


def copy_task_tokens(batch_size: int, seq_len: int, vocab: int):
    """The JAX example's stream: next token = current + 1 mod vocab,
    from ``RandomState(0)`` starts."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, (batch_size, 1))
    return (base + np.arange(seq_len)[None, :]) % vocab


def materialize_adam_state(opt: torch.optim.Optimizer) -> None:
    """Create Adam's per-parameter state (step 0, zero moments) as torch
    does on the first step, so that a checkpoint template has its
    structure before any step. Numerically a no-op."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)


def lm_loss(logits, targets):
    """Mean softmax cross-entropy of fp32 logits against integer
    targets."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           targets.reshape(-1).long())


def build(args, device, init_leaves: Optional[Sequence] = None,
          compute_dtype=torch.bfloat16):
    """The mesh, model, parameters (flax leaf order), optimizer, tokens
    and ``step() -> loss`` of the example. ``init_leaves`` (a flax leaf
    list) replaces the seeded init; ``compute_dtype`` is the example's
    bf16 unless a caller asks for another."""
    from geomx_tpu_torch.models.convert import leaf_names, load_flax_leaves
    from geomx_tpu_torch.models.transformer import (
        Transformer, make_attention, transformer_param_sharding)
    from geomx_tpu_torch.parallel.grad_accum import accumulate_gradients
    from geomx_tpu_torch.parallel.mesh import check_divisible, make_mesh
    from geomx_tpu_torch.parallel.ring_attention import make_ring_attention

    mesh = make_mesh(args.ranks or args.tp * args.sp, tp=args.tp,
                     sp=args.sp, device=device)
    # sp>1: ring attention (sequence split over the mesh); otherwise the
    # per-device pick — the flash kernels on the card, dense elsewhere
    attn = (make_ring_attention(mesh, causal=True) if args.sp > 1
            else make_attention("auto", mesh=mesh))
    model = Transformer(vocab=args.vocab, dim=args.dim, depth=args.depth,
                        heads=args.heads, max_len=args.seq_len,
                        attn_fn=attn, remat=args.remat,
                        compute_dtype=compute_dtype,
                        generator=torch.Generator().manual_seed(0))
    if init_leaves is not None:
        load_flax_leaves(model, init_leaves)
    model.to(mesh.device)
    specs = transformer_param_sharding(mesh)(model)
    named = dict(model.named_parameters())
    params = [named[n] for n in leaf_names(model)]
    opt = torch.optim.AdamW(params, lr=args.learning_rate,
                            weight_decay=1e-4)   # optax.adamw's default
    materialize_adam_state(opt)
    tokens = torch.as_tensor(copy_task_tokens(
        args.batch_size, args.seq_len, args.vocab)).to(mesh.device)
    check_divisible(mesh, ("dp", "sp"), tokens.shape, "the token batch")

    def grad_fn(p, toks):
        logits = model(toks)
        loss = lm_loss(logits, torch.roll(toks, -1, dims=1))
        return loss.detach(), list(torch.autograd.grad(loss, p))

    if args.microbatches != 1:
        grad_fn = accumulate_gradients(grad_fn, args.microbatches)

    def step():
        loss, grads = grad_fn(params, tokens)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        return loss

    return dict(mesh=mesh, model=model, params=params, opt=opt,
                tokens=tokens, step=step, specs=specs)


def main(argv=None):
    """Run the example; returns ``{"losses": [...], "step_ms": [...],
    "start": first iteration}`` (losses by iteration from ``start``)."""
    from geomx_tpu_torch._device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    run = build(args, device)
    mesh, params, opt = run["mesh"], run["params"], run["opt"]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"mesh: dp={mesh.shape['dp']} tp={args.tp} sp={args.sp} "
          f"({mesh.size} ranks on 1 x {name})", flush=True)

    start_it = 1
    if args.ckpt_dir:
        from geomx_tpu_torch.checkpoint_sharded import (
            latest_step, restore_sharded, save_sharded)

        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_sharded(
                args.ckpt_dir, last,
                {"params": params, "opt_state": opt.state_dict()})
            with torch.no_grad():
                for p, v in zip(params, state["params"]):
                    p.copy_(v)
            opt.load_state_dict(state["opt_state"])
            start_it = last + 1
            print(f"resumed from step {last}", flush=True)

    losses, step_ms = [], []
    t0 = time.time()
    for it in range(start_it, args.max_iters + 1):
        t = time.perf_counter()
        loss = float(run["step"]())
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        print(f"[Time {time.time() - t0:.3f}][Iteration {it}] "
              f"Loss {loss:.4f}", flush=True)
        if args.ckpt_dir and it % args.ckpt_every == 0:
            save_sharded(args.ckpt_dir, it,
                         {"params": params, "opt_state": opt.state_dict()})
            print(f"checkpointed step {it}", flush=True)
    return {"losses": losses, "step_ms": step_ms, "start": start_it}


if __name__ == "__main__":
    main()
