#!/usr/bin/env python3
"""Drive geomx_tpu_torch on one CUDA card, end to end.

Run from the root of a checkout, on a machine with an NVIDIA card:

  python3 chip_smoke.py

Phase 0 builds the CUDA kernels from ``geomx_tpu_torch/ops/csrc`` with
nvcc, one process per source, all started together, prints each
kernel's registers and spills, and counts the tensor-core instructions
(HMMA, HGMMA) in each kernel's SASS where ``cuobjdump`` exists, failing
if a bf16 tensor-core kernel has none. Phase 1 holds each
FlashAttention-2 kernel (forward, dQ, dK/dV) against its plain PyTorch
version on the card, at the transformer slice's shape and a few others
(head dims 32, 40, 128, the decode shape, q/k/v as views of a fused qkv
projection), and times kernel, plain version,
``scaled_dot_product_attention`` (as a yardstick only) and the bound:
back-to-back calls under CUDA events (the wrapper's host work included)
and the device time per launch under ``torch.profiler``, each kernel and
SDPA's forward and backward in a window of its own. Phase 2 trains the
59M transformer (dim 512, depth 8, heads 8, vocab 32768, seq 512, batch
8, bf16) through ``DeviceResidentTrainer`` on the local kv store and
checks that every step went through the kernels, and a profiled round
through the bf16 tensor-core ones.

Phase 3 is the intra-party tier: 3a holds the 2-bit quantize kernel bit
for bit against its plain version (up to the transformer's full
parameter count, and at the quantized ring's strided shape) and times
both beside the bound; 3b runs the quantized ring all-reduce of a 2-rank
party for every codec, checks the byte gates and the ring on the card
against the same ring on CPU tensors, bit for bit; 3c is the 200-round
convergence probe of the JAX package's bench; 3d trains the 59M
transformer as a 2-rank party, 5 steps of local grads, one 2-bit ring
over the flattened gradient and SGD, and checks every step's launches
and step 1's ring against its CPU replay.

Phase 4 is the HiPS tier: a live two-party topology (``InProcessHiPS``,
one worker per party, every role on threads of this process, every byte
over loopback sockets) with ``DeviceResidentTrainer`` on the card in
both workers. 4a is the main path, ``bench.py`` ``bench_hips_bsc``:
LeNet, BSC threshold 0.02, lr 0.05, 128 images per worker, 200 rounds
of the pipelined round, then both accuracies (at least 0.98), the
``step_timed`` medians, img/s and WAN bytes per round, and the two
workers' parameters bit for bit. 4b is ``bench_transformer_bsc``: the
59M transformer, 10 counted rounds (finite, declining losses; 8 launches
of each flash kernel per step per worker), the ``step_timed`` split with
the pipelined and the serial round, one profiled round, and the
replicas bit for bit.

Exits non-zero without a card, outside a checkout, or when any check
fails. The line before the last is the kernel table as JSON; the last is
``{"ok": true, "device": {...}}``.
"""

import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

SLICE = dict(B=8, T=511, H=8, D=64)        # the transformer's attention
MODEL = dict(dim=512, depth=8, heads=8, vocab=32768, seq_len=512)
BATCH, STEPS = 8, 5
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SOURCE = "geomx_tpu_torch/ops/csrc/flash_attention.cu"
KERNELS = {   # launch-count key -> (name, TPU kernel it replaces, the CUDA
    #                              kernel bf16 runs, as the profiler names it)
    "fwd": ("flash_fwd", "geomx_tpu/ops/flash_attention.py:85",
            "geomx_fa_fwd_tc"),
    "dq": ("flash_bwd_dq", "geomx_tpu/ops/flash_attention.py:155",
           "geomx_fa_dq_tc"),
    "dkv": ("flash_bwd_dkv", "geomx_tpu/ops/flash_attention.py:207",
            "geomx_fa_dkv_tc"),
}
# the bf16 kernels on the tensor cores: one instantiation per padded head dim
TC_KERNELS = ("geomx_fa_fwd_tc", "geomx_fa_dq_tc", "geomx_fa_dkv_tc")
PROFILE_REPS = 20           # calls per torch.profiler window
TWO_BIT = ("two_bit_quantize", "geomx_tpu_torch/ops/csrc/two_bit.cu",
           "geomx_tpu/ops/__init__.py:161")
TWO_BIT_BYTES = 12.25      # per element: read grad + residual, write
#                            residual + a quarter of a code byte
MESH_CODECS = ("none", "int8", "2bit", "fp16")
MESH_QUANT_PARITY_TOL = 5e-4        # bench.py's gate for int8 vs none
PARTY, PARTY_LR = 2, 0.05           # phase 3d: ranks, SGD step
# phase 3d's 2-bit threshold: the config default 0.5 would code nothing
# at this gradient scale; this one codes about a quarter of step 1's
# coordinates (the script prints the share and fails below 1%)
PARTY_THRESHOLD = 1e-4
# phase 4a: bench.py bench_hips_bsc's main path (bench.py:52,76,352,355)
LENET = dict(batch=128, threshold=0.02, lr=0.05, rounds=200, timed=5,
             thr_rounds=50)
PARITY_TOL_BSC = 0.02       # of the 1.0 the dense run reaches on this data
# phase 4b: bench.py bench_transformer_bsc's settings
HIPS_TF = dict(threshold=0.01, lr=0.05, momentum=0.9, batches=4, rounds=10,
               timed=2, alternations=2)
JOIN_S = 900                # per topology: a hung worker fails the phase


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


def device_ms(torch, fn, reps, match=None):
    """Mean device ms per call of ``fn`` over ``reps`` calls in a
    torch.profiler window of its own: the self device time of the kernels
    it ran (those whose name holds ``match``, else all), summed, over
    ``reps``. Returns (ms or None when the profiler saw no device time,
    the kernels seen as "name xcount")."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") \
                or e.self_device_time_total <= 0:
            continue
        if match is not None and match not in e.key:
            continue
        total += e.self_device_time_total
        seen.append(f"{e.key[:70]} x{e.count}")
    return (total / 1e3 / reps if total > 0 else None), seen


def shown(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def sass_check(_cuda, head_dims):
    """Count HMMA / HGMMA instructions in each kernel's SASS of the flash
    library; fail if a bf16 tensor-core kernel (every padded head dim)
    has none. Without cuobjdump, say that it was not checked."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = os.path.join(home, "bin", "cuobjdump")
        tool = cand if os.path.exists(cand) else None
    if tool is None:
        print("[phase0] cuobjdump not found: tensor-core instructions not "
              "checked", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(_cuda._target(
        "flash_attention"))], capture_output=True, text=True, timeout=300,
        check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            counts[cur] = 0
        elif cur is not None and ("HMMA" in line or "HGMMA" in line):
            counts[cur] += 1
    for name, n in counts.items():
        print(f"[phase0] SASS {n:4d} HMMA/HGMMA in {name}", flush=True)
    for tc in TC_KERNELS:
        found = [n for name, n in counts.items() if tc in name]
        if len(found) != len(head_dims) or min(found) == 0:
            fail(f"{tc}: tensor-core instructions per instantiation {found}, "
                 f"expected {len(head_dims)} instantiations, none empty")


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
    shape; returns (errors, times, library times, device times, library
    device times, bounds) by kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, D = SLICE["B"], SLICE["T"], SLICE["H"], SLICE["D"]
    cases = [  # B, H, D, Tq, Tk, causal, dtype, q/k/v as fused-qkv views
        (B, H, D, T, T, True, "bfloat16", False),
        (B, H, D, T, T, True, "float32", False),
        (B, H, D, T, T, False, "bfloat16", False),
        (B, H, D, 64, T, True, "bfloat16", False),
        (B, H, D, T, T, True, "bfloat16", True),
        (2, 4, 32, T, T, True, "bfloat16", False),
        (2, 4, 40, 65, 65, False, "bfloat16", False),
        (2, 4, 128, T, T, True, "bfloat16", False),
        (2, 4, 128, 64, T, True, "float32", False)]
    errs = {k: 0.0 for k in KERNELS}
    slice_inputs = None
    for Bc, Hc, Dc, Tq, Tk, causal, dname, fused in cases:
        dt = getattr(torch, dname)
        if fused:   # the model's q, k, v: per-head views of one projection,
            #         and the gradient taken through such views
            qkv = torch.randn(Bc, Tq, 3 * Hc * Dc, device="cuda",
                              generator=g).to(dt)
            leaf = qkv.clone().requires_grad_()
            q, k, v = (x.reshape(Bc, Tq, Hc, Dc)
                       for x in qkv.split(Hc * Dc, dim=-1))
            views = [x.reshape(Bc, Tq, Hc, Dc)
                     for x in leaf.split(Hc * Dc, dim=-1)]
            do = torch.randn(Bc, Tq, Hc, Dc, device="cuda",
                             generator=g).to(dt)
        else:
            q, k, v, do = (torch.randn(Bc, t, Hc, Dc, device="cuda",
                                       generator=g).to(dt)
                           for t in (Tq, Tk, Tk, Tq))
            views = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fa.flash_attention(*views, causal=causal)
        o.backward(do)
        if fused:
            grads = [x.reshape(Bc, Tq, Hc, Dc)
                     for x in leaf.grad.split(Hc * Dc, dim=-1)]
        else:
            grads = [x.grad for x in views]
        _o2, lse = fa.flash_fwd(q, k, v, causal=causal)
        op, lp = fa.flash_fwd_plain(q, k, v, causal=causal)
        delta = (do.float() * op.float()).sum(-1).transpose(1, 2).contiguous()
        dqp = fa.flash_bwd_dq_plain(q, k, v, do, lp, delta, causal=causal)
        dkp, dvp = fa.flash_bwd_dkv_plain(q, k, v, do, lp, delta,
                                          causal=causal)
        torch.cuda.synchronize()
        pairs = {"fwd": [(o, op), (lse, lp)], "dq": [(grads[0], dqp)],
                 "dkv": [(grads[1], dkp), (grads[2], dvp)]}
        what = (f"{dname} B={Bc} H={Hc} D={Dc} Tq={Tq} Tk={Tk} "
                f"causal={causal}" + (" fused-qkv views" if fused else ""))
        line = []
        for kname, pp in pairs.items():
            for got, want in pp:
                if not bool(torch.isfinite(got).all()):
                    fail(f"{kname} {what}: non-finite output")
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                scale = want.float().abs().max().item()
                # per element |got - want| <= tol + tol * |want|: one bf16
                # ulp is 0.031 for values in [4, 8)
                bad = diff > TOL[dname] * (1 + want.float().abs())
                if bool(bad.any()):
                    fail(f"{kname} {what}: {int(bad.sum())} elements beyond "
                         f"atol = rtol = {TOL[dname]} (max abs err {err})")
                errs[kname] = max(errs[kname], err)
                line.append(f"{kname} {err:.3e} (|ref| {scale:.3e})")
        print(f"[phase1] {what}: " + ", ".join(line), flush=True)
        if slice_inputs is None:
            slice_inputs = (q, k, v, do, lp, delta)

    q, k, v, do, lse, delta = slice_inputs
    kw = dict(causal=True)
    calls = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
               lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)),
        "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               **kw)),
    }
    times = {kname: (time_ms(kern, 50), time_ms(plain, 10))
             for kname, (kern, plain) in calls.items()}
    # yardstick: PyTorch's fused attention on the same values, [B, H, T, D]
    F = torch.nn.functional
    ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dol = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(sdpa(), (ql, kl, vl), dol)

    sdpa_fwd = time_ms(sdpa, 50)
    sdpa_bwd = time_ms(fwd_bwd, 50) - sdpa_fwd
    library = {"fwd": sdpa_fwd, "dq": sdpa_bwd, "dkv": sdpa_bwd}

    # device time per launch, each in a profiler window of its own; SDPA's
    # backward is the sum of its kernels, which compute dQ, dK, dV together
    dev = {}
    for kname, (kern, _plain) in calls.items():
        dev[kname], seen = device_ms(torch, kern, PROFILE_REPS,
                                     KERNELS[kname][2])
        print(f"[phase1] device time {KERNELS[kname][0]}: "
              f"{shown(dev[kname])} ms per launch ({seen})", flush=True)
    out = sdpa()
    lib_fwd, seen_f = device_ms(torch, sdpa, PROFILE_REPS)
    lib_bwd, seen_b = device_ms(torch, lambda: torch.autograd.grad(
        out, (ql, kl, vl), dol, retain_graph=True), PROFILE_REPS)
    print(f"[phase1] device time SDPA forward: {shown(lib_fwd)} ms per call "
          f"({seen_f})", flush=True)
    print(f"[phase1] device time SDPA backward: {shown(lib_bwd)} ms per call "
          f"({seen_b})", flush=True)
    library_dev = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}

    bnd = bounds(SLICE["B"], SLICE["T"], SLICE["T"], SLICE["H"],
                 SLICE["D"], True, "bfloat16")
    for kname, (ms, plain) in times.items():
        print(f"[phase1] {KERNELS[kname][0]} at B8 T511 H8 D64 bf16 causal: "
              f"kernel_ms {ms:.4f} device_ms {shown(dev[kname])} plain_ms "
              f"{plain:.4f} library_ms {library[kname]:.4f} "
              f"library_device_ms {shown(library_dev[kname])} bound_ms "
              f"{bnd[kname][0]:.4f} ({bnd[kname][1]}: {bnd[kname][2]} bytes, "
              f"{bnd[kname][3]} flops)", flush=True)
    return errs, times, library, dev, library_dev, bnd


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
    profile_round(torch, lambda: tr.step_timed(batches[0], None)[1],
                  "profile", MODEL["depth"])
    return launches, n_params


def profile_round(torch, run, tag, tc_launches):
    """One more round under torch.profiler: device time by kernel and the
    device's busy share of the round (profiler overhead included), and a
    check that each tensor-core flash kernel ran ``tc_launches`` times.
    ``run()`` drives the round and returns its phase split in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        phases = run()
        wall = (time.perf_counter() - t) * 1e3
    counts = profile_summary(prof, wall, phases, tag)
    for tc in TC_KERNELS:
        if counts is not None and counts[tc] != tc_launches:
            fail(f"{tag}: {tc} ran {counts[tc]} times in the round, "
                 f"expected {tc_launches}: the bf16 path must run the "
                 "tensor-core kernels")


def profile_summary(prof, wall, phases, tag):
    """Print a profiled round's device busy share and largest kernels;
    returns the launches of each tensor-core flash kernel (None when the
    profiler saw no device time)."""
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"[{tag}] device time not measured: the profiler saw no "
              "device activity", flush=True)
        return None
    print(f"[{tag}] round wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), phases "
          f"{ {k: round(v, 3) for k, v in phases.items()} }", flush=True)
    for ms, n, name in rows[:15]:
        print(f"[{tag}] {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} "
              f"{name[:100]}", flush=True)
    counts = {}
    for tc in TC_KERNELS:
        ms = sum(r[0] for r in rows if tc in r[2])
        counts[tc] = n = sum(r[1] for r in rows if tc in r[2])
        print(f"[{tag}] {tc}: {n} launches, {ms:.3f} ms", flush=True)
    return counts


def two_bit_bound(n):
    """(bound_ms, bytes) of the fused 2-bit quantize over n elements:
    bytes bound it, it does no tensor-core work."""
    nbytes = TWO_BIT_BYTES * n
    return nbytes / PEAK_BYTES * 1e3, nbytes


def phase3a(torch, tb, pmesh, n_params):
    """The 2-bit kernel against its plain version, bit for bit, then
    timed; returns (ms, plain ms, device ms, bound ms) at the ring's
    full-width shape."""
    g = torch.Generator(device="cuda").manual_seed(3)

    def check(what, got, want):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                fail(f"two_bit {what}: kernel != plain version "
                     f"({int((a != b).sum())} elements differ)")

    for n in (1, 3, 4, 1001, 1 << 20, n_params):
        grad = torch.randn(n, device="cuda", generator=g)
        res = torch.randn(n, device="cuda", generator=g) * 0.3
        for thr in (0.5, 0.01):
            check(f"n={n} thr={thr}", tb.two_bit_quantize(grad, res, thr),
                  tb.two_bit_quantize_plain(grad, res, thr))
        if n >= 1 << 20:
            bnd, nbytes = two_bit_bound(n)
            ms = time_ms(lambda: tb.two_bit_quantize(grad, res, 0.01), 50)
            plain = time_ms(lambda: tb.two_bit_quantize_plain(grad, res,
                                                              0.01), 10)
            print(f"[phase3a] two_bit n={n}: kernel_ms {ms:.4f} plain_ms "
                  f"{plain:.4f} library_ms none bound_ms {bnd:.4f} (bytes: "
                  f"{nbytes:.0f})", flush=True)
        del grad, res
    # the ring's form: (P, m) rows, residual slot in and out as strided
    # views of (P, P, m) state; m = 1001 takes the scalar path
    for P, m in ((3, 1001), (PARTY, pmesh.ring_chunk_layout(n_params, PARTY,
                                                            4)[0])):
        grad = torch.randn(P, m, device="cuda", generator=g)
        res = torch.randn(P, P, m, device="cuda", generator=g) * 0.3
        out = torch.empty_like(res)
        want = tb.two_bit_quantize_plain(grad, res[:, 1], PARTY_THRESHOLD)
        packed, _ = tb.two_bit_quantize(grad, res[:, 1], PARTY_THRESHOLD,
                                        out_residual=out[:, 1])
        check(f"rows {P}x{m} strided", (packed, out[:, 1]), want)

        def kernel():
            tb.two_bit_quantize(grad, res[:, 1], PARTY_THRESHOLD,
                                out_residual=out[:, 1])

        ms = time_ms(kernel, 50)
        dev, _ = device_ms(torch, kernel, PROFILE_REPS, "two_bit_kernel")
        plain = time_ms(lambda: tb.two_bit_quantize_plain(
            grad, res[:, 1], PARTY_THRESHOLD), 10)
        bnd, nbytes = two_bit_bound(P * m)
        print(f"[phase3a] two_bit rows {P}x{m} strided (the ring's shape): "
              f"kernel_ms {ms:.4f} device_ms {shown(dev)} plain_ms "
              f"{plain:.4f} library_ms none bound_ms {bnd:.4f} (bytes: "
              f"{nbytes:.0f})", flush=True)
    print("[phase3a] two_bit: kernel == plain version bit for bit at n in "
          f"(1, 3, 4, 1001, 2^20, {n_params}), thr 0.5 / 0.01, and on "
          "strided rows", flush=True)
    return ms, plain, dev, bnd


def phase3b(torch, np, qc, pmesh):
    """bench.py's bench_mesh_quant on the card: a 2-rank party, 2^20
    elements, every codec; the card's ring against its CPU replay."""
    n, reps = 1 << 20, 30
    card, host = (pmesh.make_party_mesh(2, d) for d in ("cuda", "cpu"))
    g_stack = torch.as_tensor(
        np.random.RandomState(0).randn(2, n).astype(np.float32),
        device="cuda")
    codecs = {}
    for codec in MESH_CODECS:
        red = qc.QuantRingReducer(card, codec, n, mean=True)
        red.reduce(g_stack)
        torch.cuda.synchronize()
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            red.reduce(g_stack)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        codecs[codec] = {"mesh_bytes_per_round": red.wire_bytes_per_round(),
                         "intra_party_ms": float(np.median(samples))}
        # 3 rounds with the residual carried, card against CPU tensors
        reds = [qc.QuantRingReducer(m, codec, n, mean=True)
                for m in (card, host)]
        rng = np.random.RandomState(1)
        for rnd in range(3):
            xs = torch.as_tensor(rng.randn(2, n).astype(np.float32))
            y_card = reds[0].reduce(xs.cuda())
            y_host = reds[1].reduce(xs)
            if not all(torch.equal(y_card[r], y_card[0]) for r in range(2)):
                fail(f"ring {codec} round {rnd}: rank rows differ")
            if not torch.equal(y_card.cpu(), y_host) or not torch.equal(
                    reds[0]._res.cpu(), reds[1]._res):
                fail(f"ring {codec} round {rnd}: card != CPU replay")
        print(f"[phase3b] {codec}: {codecs[codec]}; card == CPU replay bit "
              "for bit over 3 rounds, rank rows identical", flush=True)
    fp32 = codecs["none"]["mesh_bytes_per_round"]
    red_int8 = fp32 / codecs["int8"]["mesh_bytes_per_round"]
    red_2bit = fp32 / codecs["2bit"]["mesh_bytes_per_round"]
    print(f"[phase3b] reduction vs fp32: int8 {red_int8:.2f}x, 2bit "
          f"{red_2bit:.2f}x", flush=True)
    if red_int8 < 3.5 or red_2bit < 14.0:
        fail(f"byte gates: int8 {red_int8} < 3.5 or 2bit {red_2bit} < 14")


def mesh_quant_parity(torch, np, qc, pmesh, codec, rounds=200, d=512,
                      n_samples=256, lr=0.1, ranks=4):
    """bench.py's _mesh_quant_parity through the ring on the card: 4-rank
    linear regression, the ranks' local-shard gradients reduced (mean),
    SGD on the replicated output; returns the final mean squared error."""
    red = qc.QuantRingReducer(pmesh.make_party_mesh(ranks, "cuda"), codec, d,
                              mean=True, threshold=0.01)
    w_true = (np.random.RandomState(7).randn(d)
              / np.sqrt(d)).astype(np.float32)
    rng = np.random.RandomState(42)
    X = rng.randn(n_samples, d).astype(np.float32)
    y = X @ w_true
    per = n_samples // ranks
    Xs = X.reshape(ranks, per, d)
    ys = y.reshape(ranks, per)
    w = np.zeros(d, np.float32)
    for _ in range(rounds):
        g = np.stack([(2.0 / per) * Xs[r].T @ (Xs[r] @ w - ys[r])
                      for r in range(ranks)]).astype(np.float32)
        w -= lr * red.reduce(torch.as_tensor(g, device="cuda"))[0].cpu().numpy()
    r = X @ w - y
    return float(np.mean(r * r))


def phase3c(torch, np, qc, pmesh):
    losses = {c: mesh_quant_parity(torch, np, qc, pmesh, c)
              for c in MESH_CODECS}
    delta = losses["int8"] - losses["none"]
    print(f"[phase3c] 200-round probe final loss {losses}; int8 - none "
          f"{delta:.3e} (tol {MESH_QUANT_PARITY_TOL})", flush=True)
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"non-finite probe loss: {losses}")
    if delta > MESH_QUANT_PARITY_TOL:
        fail(f"int8 probe loss {losses['int8']} not within "
             f"{MESH_QUANT_PARITY_TOL} of none's {losses['none']}")


def phase3d(torch, np, fa, tb, qc, pmesh):
    """The 59M transformer as a 2-rank party: local grads through the
    flash kernels, the flattened (2, N) gradient through one 2-bit ring
    (mean), SGD on the replicated parameters. Returns the two_bit
    launches of the STEPS counted steps."""
    from geomx_tpu_torch.examples.transformer_bsc_device import synth_batch
    from geomx_tpu_torch.models.transformer import (Transformer,
                                                    make_attention)
    from geomx_tpu_torch.parallel.train_step import DataParallelTrainer

    t = time.perf_counter()
    mesh = pmesh.make_party_mesh(PARTY, "cuda")
    model = Transformer(vocab=MODEL["vocab"], dim=MODEL["dim"],
                        depth=MODEL["depth"], heads=MODEL["heads"],
                        max_len=MODEL["seq_len"],
                        attn_fn=make_attention("auto"),
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(42))
    tr = DataParallelTrainer(model, torch.optim.SGD(model.parameters(),
                                                    lr=PARTY_LR),
                             mesh, num_classes=MODEL["vocab"])
    sizes = [p.numel() for p in tr.params]
    n = sum(sizes)
    rng = np.random.default_rng(4321)
    batches = [synth_batch(rng, BATCH, MODEL["seq_len"], MODEL["vocab"])
               for _ in range(STEPS + 1)]

    def step(toks, red):
        t0 = time.perf_counter()
        losses, grads = tr.local_grads(toks[:, :-1], toks[:, 1:])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stack = torch.cat([g.reshape(PARTY, -1) for g in grads], dim=1)
        del grads
        out = red.reduce(stack)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for p, g in zip(tr.params, out[0].split(sizes)):
            p.grad = g.view(p.shape)
        tr.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ms = {"local_grads_ms": (t1 - t0) * 1e3, "ring_ms": (t2 - t1) * 1e3,
              "apply_ms": (t3 - t2) * 1e3}
        return losses.cpu().tolist(), ms, stack, out

    # warm-up on a throwaway reducer: the counted run starts at zero
    # residual, as its CPU replay does
    step(batches[STEPS], qc.QuantRingReducer(
        mesh, "2bit", n, mean=True, threshold=PARTY_THRESHOLD))
    red = qc.QuantRingReducer(mesh, "2bit", n, mean=True,
                              threshold=PARTY_THRESHOLD)
    print(f"[phase3d] {n} params, party of {PARTY} on one card, 2-bit "
          f"threshold {PARTY_THRESHOLD}, set-up + warm-up "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    counters = [fa.LAUNCHES, tb.LAUNCHES]
    for c in counters:
        for key in c:
            c[key] = 0
    losses, per_step, launches = [], [], []
    first = None
    for toks in batches[:STEPS]:
        before = {k: v for c in counters for k, v in c.items()}
        loss, ms, stack, out = step(toks, red)
        launches.append({k: v - before[k] for c in counters
                         for k, v in c.items()})
        losses.append(loss)
        per_step.append(ms)
        if first is None:
            same_rows = all(torch.equal(out[r], out[0]) for r in range(PARTY))
            first = (stack.cpu(), out.cpu(), same_rows)
        del stack, out
    total = dict(tb.LAUNCHES)

    print(f"[phase3d] per-rank losses {losses}", flush=True)
    for i, ms in enumerate(per_step):
        print(f"[phase3d] step {i + 1}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items())
            + f", total_ms {sum(ms.values()):.3f}", flush=True)
    print(f"[phase3d] launches per step {launches}", flush=True)
    if not all(math.isfinite(v) for l in losses for v in l):
        fail(f"non-finite loss: {losses}")
    want = {"two_bit": 2, **{k: PARTY * MODEL["depth"] for k in KERNELS}}
    for i, counts in enumerate(launches):
        if counts != want:
            fail(f"step {i + 1}: kernel launches {counts}, expected {want}")
    if not all(bool(torch.isfinite(p).all()) for p in tr.params):
        fail("non-finite parameters after training")

    stack, out, same_rows = first
    share = float((out[0] != 0).to(torch.float64).mean())
    replay = qc.QuantRingReducer(pmesh.make_party_mesh(PARTY, "cpu"), "2bit",
                                 n, mean=True, threshold=PARTY_THRESHOLD)
    if not same_rows:
        fail("step 1: the ranks' rows of the ring output differ")
    if not torch.equal(replay.reduce(stack), out):
        fail("step 1: the ring on the card != its CPU replay")
    print(f"[phase3d] step 1: ring output == CPU replay of the same "
          f"({PARTY}, {n}) stack bit for bit, rank rows identical; nonzero "
          f"2-bit codes {100 * share:.2f}%", flush=True)
    if share < 0.01:
        fail(f"threshold {PARTY_THRESHOLD} codes only {share} of step 1")
    profile_round(torch, lambda: step(batches[0], red)[1], "phase3d profile",
                  PARTY * MODEL["depth"])
    return total["two_bit"]


def medians(timed):
    """Per-phase medians (ms) of a list of ``step_timed`` splits."""
    return {k: round(statistics.median(t[k] for t in timed), 3)
            for k in timed[0]}


def reset(counters):
    for c in counters:
        for key in c:
            c[key] = 0


def run_hips(torch, np, worker, leaves0, tag, barriers=(), main_fn=None):
    """Start a live two-party HiPS (one worker per party, all roles on
    threads of this process, every byte over loopback sockets), init the
    keys from the master, run ``worker(kv, widx)`` on both party workers
    at once (and ``main_fn()`` on this thread meanwhile) and stop the
    topology. A failure in either worker breaks ``barriers`` and fails
    the phase; a hung worker fails it after JOIN_S."""
    from geomx_tpu_torch.simulate import InProcessHiPS

    t = time.perf_counter()
    topo = InProcessHiPS(num_parties=2, workers_per_party=1).start()
    errors = []

    def master_init(kv):
        for i, leaf in enumerate(leaves0):
            kv.init(i, np.array(leaf))
        kv.wait()

    def one(kv):
        try:
            worker(kv, topo.workers.index(kv))
        except BaseException:
            for b in barriers:
                b.abort()
            raise

    def body():
        try:
            topo.run_workers(one, include_master=master_init,
                             timeout=JOIN_S)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            for b in barriers:
                b.abort()

    try:
        runner = threading.Thread(target=body, daemon=True)
        runner.start()
        main_err = None
        try:
            if main_fn is not None:
                main_fn()
        except BaseException as e:  # noqa: BLE001 — a worker's error first
            main_err = e
        runner.join(JOIN_S + 60)
        if errors:
            raise errors[0]
        if main_err is not None:
            raise main_err
        if runner.is_alive():
            fail(f"{tag}: the workers did not finish")
    finally:
        topo.stop()
    print(f"[{tag}] topology up, trained and down in "
          f"{time.perf_counter() - t:.1f} s", flush=True)


def check_replicas(np, leaves, tag):
    for a, b in zip(leaves[0], leaves[1]):
        if a.tobytes() != b.tobytes():
            fail(f"{tag}: the two workers' parameters differ (FSA lockstep "
                 "keeps them bit-identical)")
    if not all(np.isfinite(l).all() for l in leaves[0]):
        fail(f"{tag}: non-finite parameters")
    print(f"[{tag}] the two workers' {len(leaves[0])} parameter leaves are "
          "bit-identical and finite", flush=True)


def phase4a(torch, np, fa, tb):
    """The main path: LeNet through DeviceResidentTrainer over a live
    two-party HiPS with BSC (the pipelined round, GEOMX_OVERLAP's
    default), bench_hips_bsc's settings."""
    from geomx_tpu_torch import telemetry
    from geomx_tpu_torch.examples.utils import build_model_and_step, eval_acc
    from geomx_tpu_torch.io import load_data
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    B, R = LENET["batch"], LENET["rounds"]
    telemetry.enable(True)
    leaves0, _names, grad_step, eval_step = build_model_and_step(
        B, device="cuda")
    warm = threading.Lock()
    bar = threading.Barrier(2)
    res, wan, counts = {}, {}, {}

    def worker(kv, w):
        tr = DeviceResidentTrainer(
            list(leaves0), kv, grad_step, threshold=LENET["threshold"],
            learning_rate=LENET["lr"], momentum=0.0, device="cuda")
        train_iter, test_iter, _, _ = load_data(B, 2, w)
        batches = [(torch.as_tensor(X, device="cuda"),
                    torch.as_tensor(y, device="cuda"))
                   for X, y in train_iter]
        with warm:          # no kv round inside: it would wait on the peer
            tr.warmup(*batches[0])
        bar.wait(JOIN_S)
        if w == 0:
            reset([fa.LAUNCHES, tb.LAUNCHES])
        bar.wait(JOIN_S)
        for it in range(R):
            tr.step(*batches[it % len(batches)])
        bar.wait(JOIN_S)
        if w == 0:
            counts.update(fa.LAUNCHES, **tb.LAUNCHES)
        trained = tr.leaves
        acc = eval_acc(test_iter, trained, eval_step, device="cuda")
        digest = hashlib.sha256(b"".join(l.tobytes() for l in trained))
        timed = [tr.step_timed(*batches[j % len(batches)])[1]
                 for j in range(LENET["timed"])]
        bar.wait(JOIN_S)
        if w == 0:
            wan[0] = telemetry.wan_bytes()
        bar.wait(JOIN_S)
        t0 = time.perf_counter()
        for i in range(LENET["thr_rounds"]):
            tr.step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bar.wait(JOIN_S)
        if w == 0:
            wan[1] = telemetry.wan_bytes()
        res[w] = dict(acc=acc, digest=digest.hexdigest()[:16], timed=timed,
                      wall=wall, leaves=tr.leaves,
                      pipelined=tr.pipelined, batches=len(batches))

    run_hips(torch, np, worker, leaves0, "phase4a", barriers=[bar])
    img_s = LENET["thr_rounds"] * B * 2 / max(r["wall"] for r in res.values())
    wan_round = (wan[1] - wan[0]) / LENET["thr_rounds"]
    print(f"[phase4a] LeNet, 2 parties x 1 worker, {B} images per worker, "
          f"BSC threshold {LENET['threshold']}, lr {LENET['lr']}, pipelined "
          f"round {res[0]['pipelined']}, {res[0]['batches']} batches per "
          f"worker on the card", flush=True)
    print(f"[phase4a] test accuracy after {R} rounds: worker 0 "
          f"{res[0]['acc']:.4f}, worker 1 {res[1]['acc']:.4f}; leaves "
          f"sha256 {res[0]['digest']} / {res[1]['digest']} (cuDNN fp32, "
          "deterministic: the same on every run)", flush=True)
    print(f"[phase4a] launches in the {R} rounds (LeNet runs no kernel of "
          f"the port: cuDNN convolutions, torch.topk) {counts}", flush=True)
    print(f"[phase4a] {img_s:.1f} img/s over {LENET['thr_rounds']} rounds "
          f"(both workers), {wan_round:.1f} WAN bytes per round", flush=True)
    for w in (0, 1):
        print(f"[phase4a] worker {w} step_timed medians of "
              f"{LENET['timed']} rounds (ms) {medians(res[w]['timed'])}",
              flush=True)
    for w in (0, 1):
        if res[w]["acc"] < 1.0 - PARITY_TOL_BSC:
            fail(f"phase4a: worker {w} accuracy {res[w]['acc']} < "
                 f"{1.0 - PARITY_TOL_BSC}")
    if not res[0]["pipelined"]:
        fail("phase4a: the HiPS store did not take the pipelined round")
    check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], "phase4a")
    return {"img_s": img_s, "wan_bytes_per_round": wan_round,
            "acc": [res[0]["acc"], res[1]["acc"]]}


def phase4b(torch, np, fa, tb):
    """The 59M transformer over the same live HiPS (bench_transformer_bsc's
    settings): losses, launches, the step_timed split with the pipelined
    round and with the serial round, one profiled round. Returns the
    flash launches of the counted rounds."""
    from torch.profiler import ProfilerActivity, profile

    from geomx_tpu_torch.examples.transformer_bsc_device import (
        build_transformer_grad_step, synth_batch)
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    R = HIPS_TF["rounds"]
    leaves0, grad_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device="cuda", attn="auto")
    warm = threading.Lock()
    bar = threading.Barrier(2)
    bar3 = threading.Barrier(3)     # the two workers and this thread
    res, counts, prof = {}, {}, {}

    def worker(kv, w):
        tr = DeviceResidentTrainer(
            list(leaves0), kv, grad_step, threshold=HIPS_TF["threshold"],
            learning_rate=HIPS_TF["lr"], momentum=HIPS_TF["momentum"],
            device="cuda")
        rng = np.random.default_rng(1234 + w)
        batches = [torch.as_tensor(synth_batch(rng, BATCH, MODEL["seq_len"],
                                               MODEL["vocab"]), device="cuda")
                   for _ in range(HIPS_TF["batches"])]
        with warm:          # no kv round inside: it would wait on the peer
            tr.warmup(batches[0], None)
        bar.wait(JOIN_S)
        if w == 0:
            reset([fa.LAUNCHES, tb.LAUNCHES])
        bar.wait(JOIN_S)
        t0 = time.perf_counter()
        losses = [tr.step(batches[it % len(batches)], None)
                  for it in range(R)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bar.wait(JOIN_S)
        if w == 0:
            counts.update(fa.LAUNCHES, **tb.LAUNCHES)
        on = [tr.step_timed(batches[j % len(batches)], None)[1]
              for j in range(HIPS_TF["timed"])]
        tr.pipelined = False        # the serial round: the same state
        off = [tr.step_timed(batches[j % len(batches)], None)[1]
               for j in range(HIPS_TF["timed"])]
        # round wall times, pipelined and serial in turns
        walls = {True: [], False: []}
        for _ in range(HIPS_TF["alternations"]):
            for mode in (True, False, False, True):
                tr.pipelined = mode
                t0 = time.perf_counter()
                tr.step(batches[0], None)
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
        tr.pipelined = True
        bar3.wait(JOIN_S)           # this thread starts the profiler
        bar3.wait(JOIN_S)
        phases = tr.step_timed(batches[0], None)[1]
        if w == 0:
            prof["phases"] = phases
        bar3.wait(JOIN_S)           # this thread stops it
        res[w] = dict(losses=losses, wall=wall, on=on, off=off,
                      walls=walls,
                      leaves=tr.leaves, k=tr.k, total=tr.total,
                      chunks=len(tr._chunks))

    def profile_one_round():
        """One round of both workers under torch.profiler and the host
        profiler (spans of every role), started and stopped on this (the
        main) thread."""
        from geomx_tpu_torch import profiler as hostprof
        from geomx_tpu_torch import telemetry

        telemetry.enable(True)
        bar3.wait(JOIN_S)
        hostprof.reset()
        hostprof.set_config(aggregate_stats=True)
        wan0 = telemetry.wan_bytes()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t = time.perf_counter()
            hostprof.set_state("run")
            bar3.wait(JOIN_S)
            bar3.wait(JOIN_S)
            hostprof.set_state("stop")
            prof["wall"] = (time.perf_counter() - t) * 1e3
        prof["p"] = p
        prof["wan"] = telemetry.wan_bytes() - wan0
        spans = {}
        for name, us in hostprof.aggregate_stats().items():
            name = "".join("N" if c.isdigit() else c for c in name)
            spans[name] = spans.get(name, 0.0) + us / 1e3
        prof["host"] = sorted(spans.items(), key=lambda kv: -kv[1])[:10]
        hostprof.reset()

    run_hips(torch, np, worker, leaves0, "phase4b", barriers=[bar, bar3],
             main_fn=profile_one_round)
    tok_s = R * BATCH * MODEL["seq_len"] * 2 / max(r["wall"]
                                                   for r in res.values())
    print(f"[phase4b] 59M transformer over 2 parties x 1 worker: "
          f"{res[0]['total']} params, selection {res[0]['k']} per worker, "
          f"{res[0]['chunks']} chunk(s) per pipelined round", flush=True)
    for w in (0, 1):
        print(f"[phase4b] worker {w} losses {res[w]['losses']}", flush=True)
    print(f"[phase4b] {tok_s:.0f} tokens/s over {R} rounds (both workers)",
          flush=True)
    for w in (0, 1):
        ws = res[w]["walls"]
        print(f"[phase4b] worker {w} round wall ms, in turns: pipelined "
              f"{[round(x, 3) for x in ws[True]]} (median "
              f"{statistics.median(ws[True]):.3f}), serial "
              f"{[round(x, 3) for x in ws[False]]} (median "
              f"{statistics.median(ws[False]):.3f})", flush=True)
    print(f"[phase4b] {prof['wan']:.1f} WAN bytes in the profiled round",
          flush=True)
    print("[phase4b] host spans of the profiled round (thread-ms summed "
          "over every role's threads, key and chunk numbers merged): "
          + ", ".join(f"{k} {v:.1f}" for k, v in prof["host"]), flush=True)
    print(f"[phase4b] launches in the {R} counted rounds {counts}",
          flush=True)
    for w in (0, 1):
        print(f"[phase4b] worker {w} step_timed medians of "
              f"{HIPS_TF['timed']} rounds (ms), pipelined "
              f"{medians(res[w]['on'])}, serial {medians(res[w]['off'])}",
              flush=True)
    tc = profile_summary(prof["p"], prof["wall"], prof["phases"],
                         "phase4b profile")
    for w in (0, 1):
        l = res[w]["losses"]
        if not all(math.isfinite(x) for x in l):
            fail(f"phase4b: worker {w} non-finite loss {l}")
        if not sum(l[-5:]) / 5 < l[0]:
            fail(f"phase4b: worker {w} loss did not decline: {l}")
    want = 2 * MODEL["depth"] * R
    for key in KERNELS:
        if counts[key] != want:
            fail(f"phase4b: {key} launched {counts[key]} times in {R} "
                 f"rounds of 2 workers, expected {want} (8 per step per "
                 "worker)")
    if fa.route(torch.bfloat16, MODEL["dim"] // MODEL["heads"]) == 0:
        fail("phase4b: bf16 does not route to the tensor-core kernels")
    if tc is not None:
        for name, n in tc.items():
            # the profiler window holds both workers' rounds
            if n != 2 * MODEL["depth"]:
                fail(f"phase4b profile: {name} ran {n} times in the "
                     f"round, expected {MODEL['depth']} per worker")
    check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], "phase4b")
    return counts


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
    from geomx_tpu_torch.ops import two_bit as tb
    from geomx_tpu_torch.parallel import mesh as pmesh
    from geomx_tpu_torch.parallel import quant_collectives as qc

    # phase 0: the card, the kernels' build, the float32 matmul mode
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    t = time.perf_counter()
    logs = _cuda.build(["flash_attention", "two_bit"])
    print(f"[phase0] built {len(logs)} CUDA source(s) for sm_90a in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for src in ("flash_attention", "two_bit"):
        # ptxas -v per kernel: registers, shared memory, spills (the log of
        # the build that made the library, this run's or an earlier one's)
        fn = None
        for line in _cuda._target(src).with_suffix(".log").read_text() \
                .splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("Used" in line or "spill" in line):
                print(f"[phase0] {fn}: {line.strip()}", flush=True)
    sass_check(_cuda, fa.TC_HEAD_DIMS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[phase0] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        print(f"[time] {name} {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    errs, times, library, dev, library_dev, bnd = phase1(torch, fa)
    lap("phase1")
    _launches, n_params = phase2(torch, np, fa)
    lap("phase2")
    tb_ms, tb_plain, tb_dev, tb_bound = phase3a(torch, tb, pmesh, n_params)
    phase3b(torch, np, qc, pmesh)
    phase3c(torch, np, qc, pmesh)
    tb_launches = phase3d(torch, np, fa, tb, qc, pmesh)
    lap("phase3")
    phase4a(torch, np, fa, tb)
    lap("phase4a")
    hips_launches = phase4b(torch, np, fa, tb)
    lap("phase4b")

    table = [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": where,
        "launches": hips_launches[key], "max_abs_err": errs[key],
        "ms": times[key][0], "plain_ms": times[key][1],
        "bound_ms": bnd[key][0], "bound_by": bnd[key][1],
        "library_ms": library[key], "kernel": kernel,
        "device_ms": dev[key] if dev[key] is not None else "not measured",
        "library_device_ms": (library_dev[key] if library_dev[key] is not None
                              else "not measured"),
    } for key, (name, where, kernel) in KERNELS.items()]
    table.append({
        "name": TWO_BIT[0], "route": "cuda", "source": TWO_BIT[1],
        "replaces": TWO_BIT[2], "launches": tb_launches,
        "max_abs_err": 0.0, "ms": tb_ms, "plain_ms": tb_plain,
        "bound_ms": tb_bound, "bound_by": "bytes", "library_ms": None,
        "kernel": "two_bit_kernel",
        "device_ms": tb_dev if tb_dev is not None else "not measured",
        "library_device_ms": None})
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
