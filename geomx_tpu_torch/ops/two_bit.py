"""Residual-feedback 2-bit quantize and pack: CUDA kernel and plain version.

Counterpart of ``two_bit_quantize`` in ``geomx_tpu/ops/__init__.py``:
the Pallas pack ``_pallas_pack4`` and the jnp lines around it
(``_two_bit_fn``) become one CUDA kernel, ``csrc/two_bit.cu``, which
reads grad and residual once and writes the packed codes and the new
residual. Beside it sits the plain PyTorch version of the same function,
the jnp lines in torch. A CUDA tensor always reaches the kernel (or an
exception); a CPU tensor takes the plain version. There is no
``use_pallas`` switch: on the card the kernel is the only route.

Inputs are fp32 ``(n,)`` vectors or ``(rows, m)`` stacks of rows, each
row quantized and packed on its own (``ceil(m / 4)`` bytes, zero codes
past its end), which is how the quantized ring quantizes every rank's
chunk in one launch. The threshold is rounded to fp32 before any compare,
as ``jnp.float32(threshold)`` does in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from geomx_tpu_torch.ops import _cuda

__all__ = ["LAUNCHES", "two_bit_quantize", "two_bit_quantize_plain",
           "two_bit_dequantize"]

# kernel launches since the last reset (the plain version does not count)
LAUNCHES = {"two_bit": 0}


def _thr(threshold: float) -> float:
    """The threshold rounded to fp32 (``jnp.float32(threshold)``): every
    compare and add happens against this fp32 value. Held as a python
    float it is exact, and it costs no host-to-device copy, which would
    stall the host on the stream."""
    return float(np.float32(threshold))


def _check(grad, residual, out_residual) -> None:
    if grad.ndim not in (1, 2):
        raise ValueError(f"expected an (n,) vector or (rows, m) stack, got "
                         f"shape {tuple(grad.shape)}")
    for name, x in (("residual", residual), ("out_residual", out_residual)):
        if x is None:
            continue
        if x.shape != grad.shape or x.device != grad.device:
            raise ValueError(f"{name} must match grad's shape "
                             f"{tuple(grad.shape)} and device")
    for name, x in (("grad", grad), ("residual", residual),
                    ("out_residual", out_residual)):
        if x is not None and x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")


def two_bit_quantize_plain(grad, residual, threshold: float):
    """Plain version: ``(packed uint8, new_residual)``."""
    _check(grad, residual, None)
    t = _thr(threshold)
    r = residual + grad
    pos = r > t
    neg = r < -t
    codes = torch.where(pos, 1, torch.where(neg, 2, 0)).to(torch.uint8)
    r = torch.where(pos, r - t, torch.where(neg, r + t, r))
    pad = (-grad.shape[-1]) % 4
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    c = codes.reshape(*grad.shape[:-1], -1, 4)
    packed = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    return packed, r


def two_bit_dequantize(packed, original_size: int, threshold: float):
    """``{0, +thr, -thr}`` fp32 values of the first ``original_size``
    codes of each row of ``packed`` (plain torch on every device, as the
    JAX package leaves it to XLA)."""
    t = _thr(threshold)
    c = torch.stack([packed & 3, (packed >> 2) & 3, (packed >> 4) & 3,
                     (packed >> 6) & 3], dim=-1)
    c = c.reshape(*packed.shape[:-1], -1)[..., :int(original_size)]
    return torch.where(c == 1, t, torch.where(c == 2, -t, 0.0))


# -- CUDA kernel -----------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of ``struct TwoBitParams`` in csrc/two_bit.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("grad", "res_in", "res_out",
                                         "packed")]
        + [(n, ctypes.c_longlong) for n in (
            "rows", "m", "grad_rs", "res_in_rs", "res_out_rs", "packed_rs")]
        + [("thr", ctypes.c_float)])


def _lib() -> ctypes.CDLL:
    lib = _cuda.library("two_bit")
    fn = lib.geomx_two_bit_quantize
    if fn.restype is not ctypes.c_int:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a (rows, m) view; rows must be unit-stride (the kernel
    reads each row as one run), and there is no silent copy here."""
    x2 = x if x.ndim == 2 else x.view(1, -1)
    if x2.shape[1] > 1 and x2.stride(1) != 1:
        raise ValueError("two_bit kernel: rows must be unit-stride "
                         f"(got strides {tuple(x.stride())})")
    return x2


def _two_bit_cuda(grad, residual, threshold, out_residual):
    g, r = _rows(grad), _rows(residual)
    rows, m = g.shape
    if out_residual is None:
        out_residual = torch.empty_like(
            grad, memory_format=torch.contiguous_format)
    o = _rows(out_residual)
    packed = torch.empty((rows, (m + 3) // 4), dtype=torch.uint8,
                         device=grad.device)
    p = _Params(grad=g.data_ptr(), res_in=r.data_ptr(), res_out=o.data_ptr(),
                packed=packed.data_ptr(), rows=rows, m=m,
                grad_rs=g.stride(0), res_in_rs=r.stride(0),
                res_out_rs=o.stride(0), packed_rs=packed.stride(0),
                thr=float(threshold))     # ctypes rounds it to fp32
    vec = m % 4 == 0 and all(
        x.data_ptr() % 16 == 0 and (rows == 1 or x.stride(0) % 4 == 0)
        for x in (g, r, o))
    lib = _lib()
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        rc = lib.geomx_two_bit_quantize(ctypes.byref(p), int(vec), stream)
    if rc != 0:   # the C entry point returns the launch's cudaError_t
        raise RuntimeError(f"two_bit kernel launch: CUDA error {rc}")
    LAUNCHES["two_bit"] += 1
    return packed.view(*grad.shape[:-1], (m + 3) // 4), out_residual


def two_bit_quantize(grad, residual, threshold: float, *,
                     out_residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual-feedback 2-bit quantization, 4 codes per byte: returns
    ``(packed uint8, new_residual)``. The kernel on CUDA, the plain
    version on the CPU. ``out_residual`` (same shape as ``grad``, any
    row stride) receives the new residual instead of a fresh tensor."""
    _check(grad, residual, out_residual)
    if grad.device.type == "cuda":
        return _two_bit_cuda(grad, residual, threshold, out_residual)
    if grad.device.type != "cpu":
        raise RuntimeError(f"no two_bit kernel for device {grad.device}")
    packed, r = two_bit_quantize_plain(grad, residual, threshold)
    if out_residual is None:
        return packed, r
    out_residual.copy_(r)
    return packed, out_residual
