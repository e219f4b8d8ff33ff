"""On-card self-check of the platform behaviour the CPU suite cannot see.

The port's counterpart of ``tools/chip_sanity.py``: five probes, each
with an ``ok``, and a top-level ``ok`` that holds when all five do.
Every later measurement on the card stands on this verdict, so a probe
that raises fails the run; nothing is caught.

1. ``transfer_bitexact``: float32 buffers holding denormal and
   NaN-payload bit patterns go host to device and back, from pageable
   and (on the card) pinned memory, blocking and ``non_blocking``; every
   byte must come back. A copy that flushes denormals or quiets NaNs
   corrupts any integer carried in float lanes.
2. ``bitcast_on_device`` (the JAX tool's ``bitcast_in_jit``): the same
   patterns made on the device, ``view(torch.float32)`` of int32, moved
   by the ops the packed wire uses (``cat``, ``index_select``,
   ``where``, and the device trainer's pack of [loss, values as int32
   bits, indices], ``trainer_device._fwd_compress``); every byte must
   come back.
3. ``matmul_precision``: the error of an fp32 matmul and an fp32
   convolution against a float64 numpy oracle, under PyTorch's defaults
   (cuBLAS without TF32, cuDNN with it), with TF32 on and off for both,
   and under the settings this process held when the probe started,
   which are the ones its entry points run under (``_device.exact_cudnn``
   switches cuDNN's TF32 off). Each mode is set here and the process's
   settings are restored afterwards. ``ok``: the exact mode is
   fp32-accurate.
4. ``blocking_honest``: a chain of 2048^3 bf16 matmuls timed by
   ``torch.cuda.synchronize()`` and by CUDA events, against a value
   fetch of its result. Red when the fetch costs more than twice the
   "blocked" time, or the implied rate beats 1.2x the card's bf16 peak.
5. ``bsc_oracle``: the port's ``DeviceResidentTrainer`` BSC cycle on a
   local store for ``rounds`` rounds against a numpy oracle of the same
   semantics (reference ``gradient_compression.cc:191-268``), on the JAX
   probe's seeded two-leaf model with well-separated magnitudes, so no
   top-k ties. The oracle rounds as the trainer does (``u = 0.9 u + g``
   and the apply as fused multiply-adds, ``ops._fma``). A corrupted index
   lands an update on the wrong coordinate and shows as a drift of the
   weights' size.

``python -m geomx_tpu_torch.tools.chip_sanity [--cpu]`` prints the
verdict as JSON and exits 1 unless it is ok.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from geomx_tpu_torch._device import resolve_device

__all__ = ["run_chip_sanity"]

# 0x00000001..0x007FFFFF are denormals, 0x7F800001..0x7FBFFFFF
# signalling NaNs, 0x7FC00000.. quiet NaNs with payloads
PATTERNS = np.array([
    0x00000001, 0x00000100, 0x007FFFFF, 0x00800000,
    0x7F800001, 0x7FBFFFFF, 0x7FC00000, 0x7FFFFFFF, 0xFFC00001,
    0x80000000, 0xFF800000, 0x3F800000, 0x00012345, 0x00ABCDEF,
], dtype=np.uint32)
# the JAX probe's indices, and the patterns above as int32
INDICES = np.concatenate([
    np.array([0, 1, 255, 70000, (1 << 23) - 1, 1 << 23, (1 << 24) + 12345,
              (1 << 30) + 7], np.int32), PATTERNS.view(np.int32)])
BF16_PEAK_TFLOPS = 989.0        # H100 SXM, dense (NVIDIA's data sheet)
EXACT_TOL = 1e-5                # relative to the oracle's largest entry
PROBES = ("transfer_bitexact", "bitcast_on_device", "matmul_precision",
          "blocking_honest", "bsc_oracle")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int32).numpy()


def _bad(got: np.ndarray, want: np.ndarray) -> list:
    """The first 8 words that did not come back, as (sent, got) hex."""
    return [(f"0x{int(want[i]) & 0xFFFFFFFF:08X}",
             f"0x{int(got[i]) & 0xFFFFFFFF:08X}")
            for i in np.flatnonzero(got != want)[:8]]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _probe_transfer_bitexact(dev: torch.device) -> dict:
    """Round-trip the patterns, and 2^20 random words beside them, host
    to device to host in every copy mode the port uses."""
    rng = np.random.default_rng(3)
    words = np.concatenate([PATTERNS, rng.integers(
        0, 1 << 32, 1 << 20, dtype=np.uint64).astype(np.uint32)])
    want = words.view(np.int32)
    pinned = [False, True] if dev.type == "cuda" else [False]
    out = {"modes": [], "corrupted": {}}
    for pin in pinned:
        for nb in (False, True):
            host = torch.from_numpy(words.view(np.float32).copy())
            if pin:
                host = host.pin_memory()
            d = host.to(dev, non_blocking=nb)
            back = torch.empty(host.shape, dtype=torch.float32,
                               pin_memory=pin)
            back.copy_(d, non_blocking=nb)
            _sync(dev)
            mode = f"{'pinned' if pin else 'pageable'}/" \
                   f"{'non_blocking' if nb else 'blocking'}"
            out["modes"].append(mode)
            bad = _bad(back.view(torch.int32).numpy(), want)
            if bad:
                out["corrupted"][mode] = bad
    out["ok"] = not out["corrupted"]
    return out


def _probe_bitcast_on_device(dev: torch.device) -> dict:
    idx = torch.from_numpy(INDICES).to(dev)
    f = idx.view(torch.float32)              # made on the device
    n = f.numel()
    rev = torch.arange(n - 1, -1, -1, device=dev)
    odd = torch.arange(n, device=dev) % 2 == 1
    loss = torch.tensor([0.5], device=dev)
    # the device trainer's pack: [loss, values as int32 bits, indices]
    packed = torch.cat([loss.view(torch.int32), f.view(torch.int32), idx])
    host = packed.cpu().numpy()
    want = INDICES
    checks = {
        "device_to_host": (_bits(f), want),
        "cat": (_bits(torch.cat([f, f])), np.concatenate([want, want])),
        "index_select": (_bits(f.index_select(0, rev)), want[::-1]),
        "where": (_bits(torch.where(odd, f, f.flip(0))),
                  np.where(np.arange(n) % 2 == 1, want, want[::-1])),
        "pack": (np.concatenate([host[1:1 + n].view(np.float32)
                                 .view(np.int32), host[1 + n:]]),
                 np.concatenate([want, want])),
        "host_to_device": (_bits(torch.from_numpy(want.view(np.float32)
                                                  .copy()).to(dev)), want),
    }
    corrupted = {name: _bad(got, exp)
                 for name, (got, exp) in checks.items()
                 if not np.array_equal(got, exp)}
    return {"checked": sorted(checks), "corrupted": corrupted,
            "ok": not corrupted}


def _conv_oracle(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """float64 stride-1, padding-1 convolution (NCHW, OIHW)."""
    xp = np.pad(x.astype(np.float64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    win = np.lib.stride_tricks.sliding_window_view(xp, w.shape[2:],
                                                   axis=(2, 3))
    return np.einsum("nchwij,ocij->nohw", win, w.astype(np.float64))


def _probe_matmul_precision(dev: torch.device) -> dict:
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    x = rng.standard_normal((8, 16, 32, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16, 3, 3)).astype(np.float32)
    mm_oracle = a.astype(np.float64) @ b.astype(np.float64)
    conv_oracle = _conv_oracle(x, w)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    tx, tw = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)

    def err(got, oracle):
        return float(np.abs(got.cpu().numpy() - oracle).max()
                     / np.abs(oracle).max())

    backends = torch.backends
    held = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    modes = {"process": held, "default": (False, True),
             "tf32": (True, True), "exact": (False, False)}
    out = {"process_settings": {"cublas_allow_tf32": held[0],
                                "cudnn_allow_tf32": held[1]}}
    try:
        for name, (mm_tf32, conv_tf32) in modes.items():
            backends.cuda.matmul.allow_tf32 = mm_tf32
            backends.cudnn.allow_tf32 = conv_tf32
            out[f"matmul_err_{name}"] = err(ta @ tb, mm_oracle)
            out[f"conv_err_{name}"] = err(
                torch.nn.functional.conv2d(tx, tw, padding=1), conv_oracle)
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = held
    for op in ("matmul", "conv"):
        ratio = out[f"{op}_err_default"] / max(out[f"{op}_err_exact"], 1e-12)
        out[f"{op}_ratio"] = ratio
        # TF32 keeps 10 mantissa bits against fp32's 23: a ratio above
        # 100 means the default is a low-precision pass
        out[f"{op}_default_is_lowprec"] = bool(ratio > 100)
    out["ok"] = bool(out["matmul_err_exact"] < EXACT_TOL
                     and out["conv_err_exact"] < EXACT_TOL)
    return out


def _probe_blocking_honest(dev: torch.device) -> dict:
    """Does a synchronise really wait for the work? A value cannot exist
    before the chain has run, so fetching one is the honest fence."""
    # on the CPU, where a call is the work, a short small chain shows
    # the same thing
    n, iters = (2048, 64) if dev.type == "cuda" else (512, 2)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(n, n, generator=gen).to(dev, torch.bfloat16)

    def chain(m):
        for _ in range(iters):
            m = torch.tanh(m @ m * (1.0 / n ** 0.5))
        return m.float().sum()

    float(chain(x))                                     # warm
    t_sync, t_value, t_events = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        chain(x)
        _sync(dev)
        t_sync.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        checksum = float(chain(x))
        t_value.append(time.perf_counter() - t0)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(x)
            end.record()
            end.synchronize()
            t_events.append(start.elapsed_time(end) / 1e3)
    # the least of three runs of each: noise only adds time
    ts, tv = min(t_sync), min(t_value)
    te = min(t_events) if t_events else None
    implied = 2.0 * n ** 3 * iters / max(te if te is not None else ts,
                                         1e-9) / 1e12
    return {"iters": iters, "t_sync_s": ts, "t_value_s": tv,
            "t_events_s": te, "checksum": checksum,
            "implied_tflops": implied,
            "ok": bool(tv <= 2.0 * ts and implied < 1.2 * BF16_PEAK_TFLOPS)}


def _probe_bsc_oracle(dev: torch.device, rounds: int) -> dict:
    """The device trainer's round on a local store (no transport) against
    numpy, with the JAX probe's seeded model and matmul-free gradient
    g = seed * mean(X), so both select the same coordinates."""
    from geomx_tpu_torch.kvstore import create
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    rng = np.random.default_rng(1)
    w1 = rng.standard_normal((20, 16)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((16, 4)).astype(np.float32) * 0.1
    sizes = [w1.size, w2.size]
    total = sum(sizes)
    seed = (rng.permutation(total).astype(np.float32) + 1.0) / total
    seed *= np.where(rng.random(total) < 0.5, -1.0, 1.0)
    seed_leaves = [torch.from_numpy(seed[:w1.size].reshape(w1.shape)).to(dev),
                   torch.from_numpy(seed[w1.size:].reshape(w2.shape)).to(dev)]

    def grad_fn(leaves, X, y):
        scale = X.mean()
        return scale, [s * scale for s in seed_leaves]

    tr = DeviceResidentTrainer([w1, w2], create("local"), grad_fn,
                               threshold=0.05, learning_rate=0.05,
                               device=dev)

    def fma(a, b, c):                   # a * b + c rounded once
        return (a.astype(np.float64) * float(np.float32(b))
                + c.astype(np.float64)).astype(np.float32)

    flat = np.concatenate([w1.ravel(), w2.ravel()]).astype(np.float32)
    u = np.zeros_like(flat)
    v = np.zeros_like(flat)
    offs = [0, w1.size]
    ks = [max(int(s * 0.05), 1) for s in sizes]
    for r in range(rounds):
        # eighths: every mean of X is exact, in torch as in numpy
        X = np.full((4, 4), 1.0 + 0.125 * (r % 7), np.float32)
        tr.step(X, None)
        g = (seed * np.float32(X.mean())).astype(np.float32)
        u = fma(u, 0.9, g)
        v = v + u
        idx = np.concatenate([
            np.argsort(-np.abs(v[o:o + s]), kind="stable")[:k] + o
            for o, s, k in zip(offs, sizes, ks)])
        vals = v[idx].copy()
        v[idx] = 0.0
        u[idx] = 0.0
        step = np.zeros_like(flat)
        step[idx] = vals
        flat = fma(step, -0.05, flat)
    got = np.concatenate([leaf.ravel() for leaf in tr.leaves])
    drift = float(np.abs(got - flat).max())
    finite = bool(np.isfinite(got).all())
    # the same selections and roundings land on the same bits; a
    # corrupted index lands an update elsewhere, a drift of the weights'
    # size (0.1)
    return {"rounds": rounds, "max_param_drift": drift,
            "device_finite": finite, "ok": finite and drift < 1e-3}


def run_chip_sanity(device=None, rounds: int = 25) -> dict:
    """The five probes on ``device`` (``None``: the CUDA card, raising
    without one; the CPU only when named) -> a JSON-able verdict."""
    dev = resolve_device(device)
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    t0 = time.perf_counter()
    out["transfer_bitexact"] = _probe_transfer_bitexact(dev)
    out["bitcast_on_device"] = _probe_bitcast_on_device(dev)
    out["matmul_precision"] = _probe_matmul_precision(dev)
    out["blocking_honest"] = _probe_blocking_honest(dev)
    out["bsc_oracle"] = _probe_bsc_oracle(dev, rounds)
    out["wall_s"] = time.perf_counter() - t0
    out["ok"] = all(out[k]["ok"] for k in PROBES)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.tools.chip_sanity",
        description="the port's on-card self-check; prints a JSON verdict")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    out = run_chip_sanity("cpu" if args.cpu else None)
    print(json.dumps(out, indent=2, default=str))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
