"""geomx_tpu_torch.ops — device compression ops and kernels of the port.

Counterpart of ``geomx_tpu/ops``:

- ``bsc_compress``      — momentum-corrected exact top-k (``torch.topk``);
- ``bsc_decompress``    — scatter back to dense;
- ``bsc_pull_compress`` — top-|value| filter for pull responses;
- ``two_bit_quantize`` / ``two_bit_dequantize`` — residual-feedback 2-bit
  codes packed 4 per byte; the quantize and pack run as one CUDA kernel
  on the card (``ops.two_bit``, ``csrc/two_bit.cu``);
- ``dgt_block_contrib`` — per-block mean |g| EWMA (DGT channel score);
- ``DeviceBSCCompressor`` — the server's Compressor interface over them;
- the FlashAttention-2 kernels (``ops.flash_attention``).

Everything but the kernels is plain torch, as it is XLA in the JAX
package, and rounds where XLA does on the CPU: ``BSC_MOMENTUM * u + g``
is one fused multiply-add there (:func:`_fma`). A CUDA tensor reaches a
kernel or raises; a CPU tensor takes its plain version. The numpy
kernels in ``geomx_tpu_torch.compression`` stay the fallback for
processes without a card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from geomx_tpu_torch._device import resolve_device
from geomx_tpu_torch.ops.two_bit import two_bit_dequantize, two_bit_quantize

__all__ = [
    "bsc_compress", "bsc_decompress", "bsc_pull_compress",
    "two_bit_quantize", "two_bit_dequantize", "dgt_block_contrib",
    "DeviceBSCCompressor", "device_compression_enabled",
]

BSC_MOMENTUM = 0.9  # reference: gradient_compression.cc:198


def device_compression_enabled() -> bool:
    return os.environ.get("GEOMX_DEVICE_COMPRESSION", "") not in ("", "0")


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once (a fused multiply-add): the fp32
    product is exact in fp64, and the fp64 sum rounds to fp32."""
    b32 = float(np.float32(b))
    return (a.to(torch.float64) * b32 + c.to(torch.float64)).to(torch.float32)


def bsc_compress(grad, u, v, threshold: float):
    """Momentum-corrected EXACT top-k selection on device.

    Returns ``(values, indices, new_u, new_v)``; the inputs are not
    modified (reference: BSCompress, gradient_compression.cc:191)."""
    k = max(int(grad.numel() * threshold), 1)
    u = _fma(u, BSC_MOMENTUM, grad)
    v = v + u
    _mags, idx = torch.topk(v.abs(), k)
    vals = v[idx]
    return vals, idx.to(torch.int32), u.index_fill(0, idx, 0.0), \
        v.index_fill(0, idx, 0.0)


def bsc_decompress(values, indices, original_size: int):
    """Scatter-back (reference: BSCDecompress :310-336)."""
    out = torch.zeros(int(original_size), dtype=torch.float32,
                      device=values.device)
    out[indices.long()] = values.to(torch.float32)
    return out


def bsc_pull_compress(arr, threshold: float, multiplier: int):
    """The reference's non-zero filter (BSCPullCompress :271-308) as a
    top-|value| selection: equivalent on an aggregate whose nonzeros
    number <= cap."""
    n = arr.numel()
    cap = max(min(int(n * threshold * multiplier), n), 1)
    _mags, idx = torch.topk(arr.abs(), cap)
    return arr[idx], idx.to(torch.int32)


def dgt_block_contrib(grad, prev, block_size: int, alpha: float):
    """EWMA per-block mean |g| (reference: EvalMsgContribution,
    kv_app.h:978) — the DGT channel-assignment score, on device."""
    n, block_size = grad.numel(), int(block_size)
    nblocks = -(-n // block_size)
    pad = nblocks * block_size - n
    g = torch.nn.functional.pad(grad.abs().reshape(-1), (0, pad))
    sums = g.reshape(nblocks, block_size).sum(dim=1)
    counts = torch.full((nblocks,), float(block_size), dtype=torch.float32,
                        device=grad.device)
    if pad:
        # padded tail block: mean over its true elements
        counts[-1] = block_size - pad
    cur = sums / counts
    return alpha * prev + (1.0 - alpha) * cur


# ---------------------------------------------------------------------------
# server-side adapter
# ---------------------------------------------------------------------------

def _host():
    """geomx_tpu_torch.compression, already imported by the package."""
    import sys

    return sys.modules["geomx_tpu_torch.compression"]


class DeviceBSCCompressor:
    """Drop-in for compression.BSCCompressor with device state/kernels.

    Per-key momentum (u) and accumulation (v) stay resident on the card;
    only the compressed (values, indices) pair crosses to host for the
    wire. ``device=None`` is the CUDA card (and raises without one).
    """

    type_name = "bsc"

    def __init__(self, threshold: float = 0.01, device=None):
        self.threshold = threshold
        self.device = resolve_device(device)
        self._u = {}
        self._v = {}

    def _put(self, arr, dtype):
        return torch.as_tensor(np.asarray(arr, dtype=dtype),
                               device=self.device)

    def compress_push(self, arr, state_key=None):
        a = self._put(arr, np.float32).reshape(-1)
        if state_key not in self._u:
            self._u[state_key] = torch.zeros_like(a)
            self._v[state_key] = torch.zeros_like(a)
        vals, idx, self._u[state_key], self._v[state_key] = bsc_compress(
            a, self._u[state_key], self._v[state_key], self.threshold)
        return vals.cpu().numpy(), idx.cpu().numpy(), "bsc"

    def decompress_push(self, tag, val, aux, orig_len):
        if tag == "bsc" and orig_len >= 1 << 16:
            return bsc_decompress(self._put(val, np.float32),
                                  self._put(aux, np.int32),
                                  orig_len).cpu().numpy()
        return _host()._generic_decompress(tag, val, aux, orig_len)

    def compress_pull(self, tag, arr, factor):
        if tag != "bsc":
            return _host().Compressor().compress_pull(tag, arr, factor)
        vals, idx = bsc_pull_compress(self._put(arr, np.float32).reshape(-1),
                                      self.threshold, factor)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def decompress_pull(self, tag, val, aux, orig_len, factor):
        return self.decompress_push(tag, val, aux, orig_len)

    def pull_compr_tag(self, num_elems: int = 0) -> str:
        return "bsc"

    def push_tag(self, num_elems: int = 0) -> str:
        return "bsc"
