#!/usr/bin/env python
"""Expert-parallel MoE transformer training over a dp x ep mesh.

Counterpart of ``examples/train_moe.py``, with its flags, defaults and
printed lines: a decoder-only transformer whose FFNs are top-1
Switch-style MoE blocks (:mod:`geomx_tpu_torch.models.moe`, dense
dispatch), the expert layout over "ep" recorded by
``transformer_param_sharding``, bf16 compute, AdamW, and the
load-balancing auxiliary loss added with weight ``--aux-weight``.
Attention is the dense einsum, as the JAX model has no ``attn_fn`` here.

Every rank shares one device (the CUDA card unless ``--cpu``):
``--ranks`` (default ep, i.e. dp 1) names the mesh's rank count.

  python -m geomx_tpu_torch.examples.train_moe --cpu --ep 2 --experts 4
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the mesh, all on one device "
                         "(default ep: dp 1)")
    ap.add_argument("--aux-weight", type=float, default=0.01)
    ap.add_argument("-lr", "--learning-rate", type=float, default=3e-4)
    ap.add_argument("--max-iters", type=int, default=20)
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    return ap.parse_args(argv)


def build(args, device, init_leaves: Optional[Sequence] = None,
          compute_dtype=torch.bfloat16):
    """The mesh, model, parameters (flax leaf order), optimizer, tokens
    and ``step() -> (ce, aux)``. ``init_leaves`` (a flax leaf list)
    replaces the seeded init; ``compute_dtype`` is the example's bf16
    unless a caller asks for another."""
    from geomx_tpu_torch.examples.train_transformer import (
        copy_task_tokens, lm_loss)
    from geomx_tpu_torch.models.convert import leaf_names, load_flax_leaves
    from geomx_tpu_torch.models.transformer import (
        Transformer, transformer_param_sharding)
    from geomx_tpu_torch.parallel.mesh import check_divisible, make_mesh

    mesh = make_mesh(args.ranks or args.ep, ep=args.ep, device=device)
    model = Transformer(vocab=args.vocab, dim=args.dim, depth=args.depth,
                        heads=args.heads, max_len=args.seq_len,
                        moe_experts=args.experts,
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
    tokens = torch.as_tensor(copy_task_tokens(
        args.batch_size, args.seq_len, args.vocab)).to(mesh.device)
    check_divisible(mesh, ("dp", None), tokens.shape, "the token batch")

    def step():
        logits, aux_losses = model(tokens[:, :-1], return_aux=True)
        ce = lm_loss(logits, tokens[:, 1:])
        aux = sum(a.sum() for a in aux_losses)
        loss = ce + args.aux_weight * aux
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()
        return ce.detach(), aux.detach()

    return dict(mesh=mesh, model=model, params=params, opt=opt,
                tokens=tokens, step=step, specs=specs)


def main(argv=None):
    """Run the example; returns ``{"ce": [...], "aux": [...], "step_ms":
    [...]}`` by iteration."""
    from geomx_tpu_torch._device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    run = build(args, device)
    mesh = run["mesh"]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"mesh: dp={mesh.shape['dp']} ep={args.ep} ({mesh.size} ranks on "
          f"1 x {name}), {args.experts} experts", flush=True)
    out = {"ce": [], "aux": [], "step_ms": []}
    t0 = time.time()
    for it in range(1, args.max_iters + 1):
        t = time.perf_counter()
        ce, aux = (float(x) for x in run["step"]())
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["ce"].append(ce)
        out["aux"].append(aux)
        print(f"[Time {time.time() - t0:.3f}][Iteration {it}] "
              f"Loss {ce:.4f} Aux {aux:.4f}", flush=True)
    return out


if __name__ == "__main__":
    main()
