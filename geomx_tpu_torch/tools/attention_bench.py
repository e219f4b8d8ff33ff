#!/usr/bin/env python
"""Flash vs dense attention sweep on the CUDA card.

The port's counterpart of the JAX package's ``tools/attention_bench.py``:
one JSON line per sequence length with forward and forward+backward
times of the plain dense attention
(``geomx_tpu_torch.models.transformer.dense_attention``) and the
FlashAttention-2 kernels (``geomx_tpu_torch.ops.flash_attention``; its
backward runs the dQ and dK/dV kernels), bf16, causal, the JAX tool's
row keys.

Timing (:func:`_time`): the iterations thread each output back into
``q``, so the launches depend on each other end to end; on the card the
chain runs between two CUDA events recorded after a
``torch.cuda.synchronize()`` and ends in a value fetch of its last
output (on ``--cpu`` the host clock around the chain and the fetch).

``--sweep-blocks`` times the flash forward+backward per ``block_q`` x
``block_k`` on ``--cpu`` only, where the plain version blocks by them;
the CUDA kernels tile by 64 rows and never read the two, so on the card
a sweep would time one kernel several times, and it raises.

    python -m geomx_tpu_torch.tools.attention_bench --seqs 512,1024,2048,4096 [--cpu]

Without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from geomx_tpu_torch._device import resolve_device

__all__ = ["bench_row", "inputs", "main"]

SWEEP_ON_CARD = ("--sweep-blocks: the CUDA flash kernels tile by 64 rows "
                 "and never read block_q / block_k, so a sweep on the card "
                 "would time one kernel several times; run it with --cpu, "
                 "where the plain version blocks by them")


def _head(out):
    return out[0] if isinstance(out, tuple) else out


def _fence(x) -> float:
    """Value fetch of ``x``: returns once everything it depends on ran."""
    return float(x.to(torch.float32).sum())


def _time(fn, q, k, v, iters=20):
    """Mean ms per call of ``fn`` over a chain of ``iters`` calls, each
    fed the previous call's output as ``q``."""
    x = _head(fn(q, k, v))
    _fence(x)                                   # warm-up + fence
    if q.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            x = _head(fn(x, k, v))
        _fence(x)
        return max(time.perf_counter() - t0, 1e-9) / iters * 1e3
    torch.cuda.synchronize(q.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x = _head(fn(x, k, v))
    end.record()
    _fence(x)
    return start.elapsed_time(end) / iters


def _grad(attn, **kw):
    """``(q, k, v) -> (dq, dk, dv)`` of ``attn(q, k, v).float().sum()``."""
    def g(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = attn(q, k, v, **kw).to(torch.float32).sum()
        return torch.autograd.grad(out, (q, k, v))
    return g


def inputs(B, T, H, D, device, dtype=torch.bfloat16):
    """q, k, v ``[B, T, H, D]``, standard normal, seeds 0, 1, 2."""
    out = []
    for i in range(3):
        gen = torch.Generator(device="cpu").manual_seed(i)
        out.append(torch.randn((B, T, H, D), generator=gen).to(
            device=device, dtype=dtype))
    return tuple(out)


def bench_row(T, B, H, D, device="cuda", iters=20):
    """The JAX tool's row for one sequence length: dense and flash,
    forward and forward+backward, causal."""
    from geomx_tpu_torch.models.transformer import dense_attention
    from geomx_tpu_torch.ops.flash_attention import flash_attention

    dev = resolve_device(device)
    q, k, v = inputs(B, T, H, D, dev)
    row = {"T": T, "B": B, "H": H, "D": D, "causal": True,
           "dense_fwd_ms": round(_time(dense_attention, q, k, v, iters), 3),
           "flash_fwd_ms": round(_time(flash_attention, q, k, v, iters), 3),
           "dense_fwdbwd_ms": round(
               _time(_grad(dense_attention), q, k, v, iters), 3),
           "flash_fwdbwd_ms": round(
               _time(_grad(flash_attention), q, k, v, iters), 3)}
    row["fwd_speedup"] = round(row["dense_fwd_ms"] / row["flash_fwd_ms"], 2)
    row["fwdbwd_speedup"] = round(
        row["dense_fwdbwd_ms"] / row["flash_fwdbwd_ms"], 2)
    return row


def sweep_blocks(T, B, H, D, cands, dense_fwdbwd_ms, device="cpu"):
    """Flash forward+backward per (block_q, block_k) of the plain
    version; prints one line per combination and the best."""
    from geomx_tpu_torch.ops.flash_attention import flash_attention

    dev = resolve_device(device)
    if dev.type == "cuda":
        raise ValueError(SWEEP_ON_CARD)
    q, k, v = inputs(B, T, H, D, dev)
    best = None
    for bq in cands:
        for bk in cands:
            if bq > T or bk > T:
                continue
            ms = _time(_grad(flash_attention, block_q=bq, block_k=bk),
                       q, k, v, iters=10)
            print(json.dumps({"T": T, "block_q": bq, "block_k": bk,
                              "flash_fwdbwd_ms": round(ms, 3)}), flush=True)
            if best is None or ms < best[0]:
                best = (ms, bq, bk)
    if best:
        print(json.dumps({
            "T": T, "best_block_q": best[1], "best_block_k": best[2],
            "best_flash_fwdbwd_ms": round(best[0], 3),
            "dense_fwdbwd_ms": dense_fwdbwd_ms,
            "best_speedup": round(dense_fwdbwd_ms / best[0], 2)}),
            flush=True)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.tools.attention_bench")
    ap.add_argument("--seqs", type=str, default="512,1024,2048,4096")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, the plain versions in place of "
                         "the kernels (default: the CUDA card, which must "
                         "be there)")
    ap.add_argument("--sweep-blocks", action="store_true",
                    help="--cpu only: sweep the plain flash version's "
                         "block_q x block_k per seq len and report the "
                         "fastest fwd+bwd combo vs dense")
    ap.add_argument("--blocks", type=str, default="128,256,512",
                    help="candidate block sizes for --sweep-blocks")
    args = ap.parse_args(argv)
    if args.sweep_blocks and not args.cpu:
        raise ValueError(SWEEP_ON_CARD)
    device = "cpu" if args.cpu else "cuda"

    B, H, D = args.batch, args.heads, args.head_dim
    rows = []
    for T in [int(s) for s in args.seqs.split(",")]:
        row = bench_row(T, B, H, D, device)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.sweep_blocks:
            sweep_blocks(T, B, H, D, [int(b) for b in args.blocks.split(",")],
                         row["dense_fwdbwd_ms"], device)
    return rows


if __name__ == "__main__":
    main()
