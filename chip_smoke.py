#!/usr/bin/env python3
"""Drive geomx_tpu_torch on one CUDA card, end to end.

Run from the root of a checkout, on a machine with an NVIDIA card:

  python3 chip_smoke.py

Phase 0 builds the CUDA kernels from ``geomx_tpu_torch/ops/csrc`` with
nvcc. Phase 1 holds each kernel (FlashAttention-2 forward, dQ, dK/dV)
against its plain PyTorch version on the card, at the transformer
slice's shape and a few others, and times kernel, plain version,
``scaled_dot_product_attention`` (as a yardstick only) and the bound.
Phase 2 trains the 59M transformer (dim 512, depth 8, heads 8, vocab
32768, seq 512, batch 8, bf16) through ``DeviceResidentTrainer`` on the
local kv store and checks that every step went through the kernels.

Exits non-zero without a card, outside a checkout, or when any check
fails. The line before the last is the kernel table as JSON; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

SLICE = dict(B=8, T=511, H=8, D=64)        # the transformer's attention
MODEL = dict(dim=512, depth=8, heads=8, vocab=32768, seq_len=512)
BATCH, STEPS = 8, 5
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SOURCE = "geomx_tpu_torch/ops/csrc/flash_attention.cu"
KERNELS = {   # launch-count key -> (name, TPU kernel it replaces)
    "fwd": ("flash_fwd", "geomx_tpu/ops/flash_attention.py:85"),
    "dq": ("flash_bwd_dq", "geomx_tpu/ops/flash_attention.py:155"),
    "dkv": ("flash_bwd_dkv", "geomx_tpu/ops/flash_attention.py:207"),
}


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps, warmup=3):
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def visible_pairs(Tq, Tk, causal):
    if not causal:
        return Tq * Tk
    off = Tk - Tq
    return sum(min(Tk, i + off + 1) for i in range(Tq))


def bounds(B, Tq, Tk, H, D, causal, dtype):
    """(bound_ms, bound_by, bytes, flops) per kernel: each input read once,
    each output written once; products over the visible (q, k) pairs."""
    esz = 2 if dtype == "bfloat16" else 4
    q_b, kv_b = B * Tq * H * D * esz, B * Tk * H * D * esz
    row_b = B * H * Tq * 4                 # one fp32 value per query row
    mac = 2 * B * H * D * visible_pairs(Tq, Tk, causal)   # one product
    work = {   # (bytes, flops)
        "fwd": (q_b + 2 * kv_b + q_b + row_b, 2 * mac),
        "dq": (2 * q_b + 2 * kv_b + 2 * row_b + q_b, 3 * mac),
        "dkv": (2 * q_b + 2 * kv_b + 2 * row_b + 2 * kv_b, 4 * mac),
    }
    out = {}
    for k, (nbytes, flops) in work.items():
        t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[k] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations",
                  nbytes, flops)
    return out


def phase1(torch, fa):
    """Each kernel against its plain version, then timed at the slice
    shape; returns (errors, times, library times, bounds) by kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, D = SLICE["B"], SLICE["T"], SLICE["H"], SLICE["D"]
    cases = [  # Tq, Tk, causal, dtype
        (T, T, True, "bfloat16"), (T, T, True, "float32"),
        (T, T, False, "bfloat16"), (64, T, True, "bfloat16")]
    errs = {k: 0.0 for k in KERNELS}
    slice_inputs = None
    for Tq, Tk, causal, dname in cases:
        dt = getattr(torch, dname)
        q, k, v, do = (torch.randn(B, t, H, D, device="cuda", generator=g)
                       .to(dt) for t in (Tq, Tk, Tk, Tq))
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(qg, kg, vg, causal=causal)
        o.backward(do)
        _o2, lse = fa.flash_fwd(q, k, v, causal=causal)
        op, lp = fa.flash_fwd_plain(q, k, v, causal=causal)
        delta = (do.float() * op.float()).sum(-1).transpose(1, 2).contiguous()
        dqp = fa.flash_bwd_dq_plain(q, k, v, do, lp, delta, causal=causal)
        dkp, dvp = fa.flash_bwd_dkv_plain(q, k, v, do, lp, delta,
                                          causal=causal)
        torch.cuda.synchronize()
        pairs = {"fwd": [(o, op), (lse, lp)], "dq": [(qg.grad, dqp)],
                 "dkv": [(kg.grad, dkp), (vg.grad, dvp)]}
        line = []
        for kname, pp in pairs.items():
            for got, want in pp:
                if not bool(torch.isfinite(got).all()):
                    fail(f"{kname}: non-finite output")
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                scale = want.float().abs().max().item()
                # per element |got - want| <= tol + tol * |want|: one bf16
                # ulp is 0.031 for values in [4, 8)
                bad = diff > TOL[dname] * (1 + want.float().abs())
                if bool(bad.any()):
                    fail(f"{kname} {dname} Tq={Tq} Tk={Tk} causal={causal}: "
                         f"{int(bad.sum())} elements beyond atol = rtol = "
                         f"{TOL[dname]} (max abs err {err})")
                errs[kname] = max(errs[kname], err)
                line.append(f"{kname} {err:.3e} (|ref| {scale:.3e})")
        print(f"[phase1] {dname} Tq={Tq} Tk={Tk} causal={causal}: "
              + ", ".join(line), flush=True)
        if (Tq, Tk, causal, dname) == cases[0]:
            slice_inputs = (q, k, v, do, lp, delta)

    q, k, v, do, lse, delta = slice_inputs
    kw = dict(causal=True)
    times = {
        "fwd": (time_ms(lambda: fa.flash_fwd(q, k, v, **kw), 50),
                time_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw), 10)),
        "dq": (time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                               **kw), 50),
               time_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                     **kw), 10)),
        "dkv": (time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                 **kw), 50),
                time_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                       delta, **kw), 10)),
    }
    # yardstick: PyTorch's fused attention on the same values, [B, H, T, D]
    F = torch.nn.functional
    ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dol = do.transpose(1, 2).contiguous()
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True), 50)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        torch.autograd.grad(out, (ql, kl, vl), dol)

    sdpa_bwd = time_ms(fwd_bwd, 50) - sdpa_fwd
    library = {"fwd": sdpa_fwd, "dq": sdpa_bwd, "dkv": sdpa_bwd}
    bnd = bounds(SLICE["B"], SLICE["T"], SLICE["T"], SLICE["H"],
                 SLICE["D"], True, "bfloat16")
    for kname, (ms, plain) in times.items():
        print(f"[phase1] {KERNELS[kname][0]} at B8 T511 H8 D64 bf16 causal: "
              f"kernel_ms {ms:.4f} plain_ms {plain:.4f} "
              f"library_ms {library[kname]:.4f} bound_ms "
              f"{bnd[kname][0]:.4f} ({bnd[kname][1]}: {bnd[kname][2]} bytes, "
              f"{bnd[kname][3]} flops)", flush=True)
    return errs, times, library, bnd


def phase2(torch, np, fa):
    """Train the 59M transformer for STEPS rounds through the kernels."""
    import geomx_tpu_torch as gx
    from geomx_tpu_torch.examples.transformer_bsc_device import (
        build_transformer_grad_step, synth_batch)
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    t0 = time.perf_counter()
    leaves, grad_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device="cuda", attn="auto")
    n_params = sum(l.size for l in leaves)
    tr = DeviceResidentTrainer(leaves, gx.kv.create("local"), grad_step,
                               threshold=0.01, learning_rate=0.05,
                               momentum=0.9, device="cuda")
    rng = np.random.default_rng(1234)
    batches = [synth_batch(rng, BATCH, MODEL["seq_len"], MODEL["vocab"])
               for _ in range(STEPS + 1)]
    tr.warmup(batches[0], None)
    print(f"[phase2] {n_params} params ({n_params / 1e6:.1f}M), selection "
          f"{tr.k} of {tr.total}, set-up + warmup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    losses, step_ms, per_step = [], [], []
    for toks in batches[:STEPS]:
        before = dict(fa.LAUNCHES)
        t = time.perf_counter()
        losses.append(tr.step(toks, None))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({k: fa.LAUNCHES[k] - before[k] for k in before})
    before = dict(fa.LAUNCHES)
    loss_t, phases = tr.step_timed(batches[STEPS], None)
    per_step.append({k: fa.LAUNCHES[k] - before[k] for k in before})
    launches = dict(fa.LAUNCHES)

    losses.append(loss_t)
    print(f"[phase2] losses {losses}", flush=True)
    print(f"[phase2] step_ms {[round(s, 3) for s in step_ms]}", flush=True)
    print(f"[phase2] step_timed phases_ms "
          f"{ {k: round(v, 3) for k, v in phases.items()} }", flush=True)
    print(f"[phase2] launches per step {per_step}", flush=True)
    if not all(math.isfinite(l) for l in losses):
        fail(f"non-finite loss: {losses}")
    for i, counts in enumerate(per_step):
        if any(c != MODEL["depth"] for c in counts.values()):
            fail(f"step {i + 1}: kernel launches {counts}, expected "
                 f"{MODEL['depth']} of each (one per block)")
    if not all(np.isfinite(l).all() for l in tr.leaves):
        fail("non-finite parameters after training")

    # step 1's loss again, attention through the plain version on the card
    def plain_attn(q, k, v):
        return fa.flash_fwd_plain(q, k, v, causal=True)[0]

    _, plain_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device="cuda",
        attn=plain_attn, init_leaves=leaves)
    with torch.no_grad():
        ref = [torch.as_tensor(l, device="cuda") for l in leaves]
    ref_loss = float(plain_step(ref, torch.as_tensor(batches[0],
                                                     device="cuda"), None)[0])
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    print(f"[phase2] step-1 loss {losses[0]:.6f} vs plain attention "
          f"{ref_loss:.6f}: rel diff {rel:.3e}", flush=True)
    if rel > 2e-2:
        fail(f"step-1 loss differs from the plain-attention run by {rel}")
    profile_round(torch, tr, batches[0])
    return launches


def profile_round(torch, tr, toks):
    """One more round under torch.profiler: device time by kernel and the
    device's busy share of the round (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _loss, phases = tr.step_timed(toks, None)
        wall = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print("[profile] device time not measured: the profiler saw no "
              "device activity", flush=True)
        return
    print(f"[profile] round wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), compute phase "
          f"{phases['compute_ms']:.3f} ms", flush=True)
    for ms, n, name in rows[:15]:
        print(f"[profile] {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} "
              f"{name[:100]}", flush=True)


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(root, "geomx_tpu_torch",
                                       "__init__.py")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, root)
    import numpy as np

    from geomx_tpu_torch.ops import _cuda
    from geomx_tpu_torch.ops import flash_attention as fa

    # phase 0: the card, the kernels' build, the float32 matmul mode
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    t = time.perf_counter()
    logs = _cuda.build(["flash_attention"])
    print(f"[phase0] built {len(logs)} CUDA source(s) for sm_90a in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for log in logs:
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[phase0] {line.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[phase0] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    errs, times, library, bnd = phase1(torch, fa)
    launches = phase2(torch, np, fa)

    table = [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": where,
        "launches": launches[key], "max_abs_err": errs[key],
        "ms": times[key][0], "plain_ms": times[key][1],
        "bound_ms": bnd[key][0], "bound_by": bnd[key][1],
        "library_ms": library[key],
    } for key, (name, where) in KERNELS.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
