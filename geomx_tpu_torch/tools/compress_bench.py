#!/usr/bin/env python
"""Microbench: host (numpy) vs device (torch) compression kernels.

The port's counterpart of the JAX package's ``tools/compress_bench.py``:
the same sizes, codecs, row keys and order. The quantized combined wire
(``compression.device``) packs every round's gradients, so pack
throughput per codec (fp16 cast, 2-bit residual quantize, BSC top-k) is
a first-class number. The host columns time
``geomx_tpu_torch.compression`` (numpy); the device columns time
``geomx_tpu_torch.ops`` on the CUDA card: the fp16 cast, the 2-bit
quantize (``ops.two_bit_quantize``, the ``two_bit_kernel`` CUDA kernel)
and BSC (``ops.bsc_compress``). Device timings include the copy of the
packed payload to the host, the number that matters being
bytes-ready-to-send; they are CUDA events around the call and that copy,
taken after a ``torch.cuda.synchronize()`` (on ``--cpu`` the host
clock). ``backend`` is ``"cuda"`` or ``"cpu"``.

Prints one JSON line per size with host/device times, pack throughput
(MB/s of fp32 input consumed) and speedups; ``--json`` emits a single
machine-readable document instead.

    python -m geomx_tpu_torch.tools.compress_bench [--sizes 262144,1048576,8388608] [--json] [--cpu]

Without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from geomx_tpu_torch._device import resolve_device

__all__ = ["run_compress_bench", "timeit", "main"]


def timeit(fn, repeat=5):
    """Best host-clock seconds of ``repeat`` calls after one warm-up."""
    fn()
    ts = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def timeit_device(fn, dev, repeat=5):
    """:func:`timeit` for work on ``dev``: on the card, CUDA events
    around each call after a synchronise; ``fn`` ends in a copy to the
    host, so the chain is fetched before the end event is read."""
    if dev.type != "cuda":
        return timeit(fn, repeat)
    fn()
    ts = []
    for _ in range(repeat):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3)
    return min(ts), out


def _mbps(nbytes: int, secs: float) -> float:
    return round(nbytes / max(secs, 1e-12) / 1e6, 1)


def _first(fn, keep, key, snap=lambda out: out):
    """``fn``; with a ``keep`` dict, ``snap`` of its first output (the
    warm-up call's, from zero state) is stored under ``keep[key]``."""
    if keep is None:
        return fn

    def call():
        out = fn()
        if key not in keep:
            keep[key] = snap(out)
        return out
    return call


def run_compress_bench(sizes, threshold: float = 0.01, repeat: int = 5,
                       device="cuda", keep=None):
    """Host-vs-device pack benchmark for each codec of the quantized
    wire; returns one result dict per size (the ``--json`` document's
    ``results``). ``device``: ``"cuda"`` (the card, which must be there)
    or ``"cpu"``. ``keep``: a dict that, when given, gets for each size
    ``n`` a dict ``keep[n]`` of numpy arrays: ``"grad"`` and each codec's
    first output on either side, from zero state: ``"fp16_host"``,
    ``"fp16_device"``, ``"2bit_host"`` / ``"2bit_device"`` (packed bytes,
    residual) and ``"bsc_host"`` / ``"bsc_device"`` (values, indices)."""
    from geomx_tpu_torch import compression as host
    from geomx_tpu_torch import ops

    dev = resolve_device(device)
    results = []
    for n in sizes:
        rng = np.random.default_rng(0)
        grad = rng.normal(size=n).astype(np.float32)
        nbytes = grad.nbytes
        dg = torch.from_numpy(grad).to(dev)
        got = None
        if keep is not None:
            got = keep[n] = {"grad": grad}

        # fp16: the half-width cast (wire codec "fp16")
        t_hf, _ = timeit(_first(lambda: grad.astype(np.float16), got,
                                "fp16_host"), repeat)
        t_df, _ = timeit_device(_first(
            lambda: dg.to(torch.float16).cpu(), got, "fp16_device",
            lambda out: out.numpy()), dev, repeat)

        # 2-bit with error-feedback residual (wire codec "2bit")
        hres = np.zeros(n, np.float32)
        t_h2, _ = timeit(_first(
            lambda: host.two_bit_quantize(grad, hres, 0.5), got,
            "2bit_host", lambda out: (out, hres.copy())), repeat)
        dres = torch.zeros(n, dtype=torch.float32, device=dev)

        def dev2():
            packed, res = ops.two_bit_quantize(dg, dres, 0.5)
            return packed.cpu(), res

        t_d2, _ = timeit_device(_first(
            dev2, got, "2bit_device",
            lambda out: (out[0].numpy(), out[1].cpu().numpy())), dev, repeat)

        # BSC top-k (server WAN compressor / "bsc16" sparse wire)
        hu, hv = np.zeros(n, np.float32), np.zeros(n, np.float32)
        t_hb, _ = timeit(_first(
            lambda: host.bsc_compress(grad, hu, hv, threshold), got,
            "bsc_host"), repeat)
        du = torch.zeros(n, dtype=torch.float32, device=dev)
        dv = torch.zeros(n, dtype=torch.float32, device=dev)

        def devb():
            vals, idx, _u, _v = ops.bsc_compress(dg, du, dv, threshold)
            return vals.cpu(), idx.cpu()

        t_db, _ = timeit_device(_first(
            devb, got, "bsc_device",
            lambda out: (out[0].numpy(), out[1].numpy())), dev, repeat)

        results.append({
            "size": n,
            "backend": dev.type,
            "fp16_host_ms": round(t_hf * 1e3, 3),
            "fp16_device_ms": round(t_df * 1e3, 3),
            "fp16_host_mbps": _mbps(nbytes, t_hf),
            "fp16_device_mbps": _mbps(nbytes, t_df),
            "fp16_speedup": round(t_hf / t_df, 2),
            "2bit_host_ms": round(t_h2 * 1e3, 3),
            "2bit_device_ms": round(t_d2 * 1e3, 3),
            "2bit_host_mbps": _mbps(nbytes, t_h2),
            "2bit_device_mbps": _mbps(nbytes, t_d2),
            "2bit_speedup": round(t_h2 / t_d2, 2),
            "bsc_host_ms": round(t_hb * 1e3, 3),
            "bsc_device_ms": round(t_db * 1e3, 3),
            "bsc_host_mbps": _mbps(nbytes, t_hb),
            "bsc_device_mbps": _mbps(nbytes, t_db),
            "bsc_speedup": round(t_hb / t_db, 2),
        })
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.tools.compress_bench")
    ap.add_argument("--sizes", default="262144,1048576,8388608")
    ap.add_argument("--threshold", type=float, default=0.01)
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of per-size "
                         "lines (machine-readable)")
    ap.add_argument("--cpu", action="store_true",
                    help="device columns on the CPU (default: the CUDA "
                         "card, which must be there)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    sizes = [int(s) for s in args.sizes.split(",")]
    results = run_compress_bench(sizes, args.threshold, device=device)
    if args.json:
        print(json.dumps({"backend": device, "threshold": args.threshold,
                          "results": results}))
        return
    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
