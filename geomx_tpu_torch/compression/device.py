"""Quantized combined wire and mesh codecs: the device side, in torch.

Counterpart of ``geomx_tpu/compression/device.py``. The combined wire
can carry each chunk as fp16 or residual-feedback 2-bit codes instead of
raw fp32, the codec chosen per P3 chunk (``WireCodec``). When the
gradient is still a ``torch.Tensor`` the pack runs on its device — on a
CUDA tensor the 2-bit quantize is the kernel of ``ops.two_bit`` — so the
device-to-host copy moves n/4 packed bytes, not fp32; numpy arrays take
the host kernels of :mod:`geomx_tpu_torch.compression`, which are bit
identical to the device path.

Wire format (the ``Meta.compr`` tag of the JAX package's transport):

- ``"fp16"`` — vals are float16, no aux;
- ``"2bit"`` — vals are the packed uint8 codes (4/byte), aux is the
  one-element float32 threshold;
- ``"bsc16"`` — the BSC element-sparse wire with float16 values.

Error-feedback residuals live here, per ``state_key``: an encode drains
its key's residual exactly once per round.

The mesh codecs (``MESH_CODECS``, ``block_quant_int8`` and friends) are
what the quantized ring all-reduce (``parallel.quant_collectives``)
quantizes every hop with; they are pure functions of tensors.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from geomx_tpu_torch import compression, ops

__all__ = ["WIRE_POLICIES", "WireCodec", "decode_wire", "codec_requires_aux",
           "MESH_CODECS", "block_quant_int8", "block_dequant_int8",
           "block_quant_int8_np", "block_dequant_int8_np",
           "mesh_wire_bytes"]

# accepted GEOMX_WIRE_CODEC values (Config.wire_codec):
#   ""     — off (raw fp32)
#   "fp16" — every chunk fp16
#   "2bit" — every chunk 2-bit
#   "mpq"  — per-chunk MPQ routing: chunks of >= size_lower_bound
#            elements go 2-bit, smaller chunks fp16
#   "p3"   — the P3-priority rule: the head chunk stays fp16, tail chunks
#            route like "mpq"
WIRE_POLICIES = ("", "fp16", "2bit", "mpq", "p3")

# wire tags whose payload is meaningless without the aux array
# (threshold / indices)
_AUX_REQUIRED = ("2bit", "rsp", "bsc16")


def codec_requires_aux(tag: str) -> bool:
    return tag in _AUX_REQUIRED


def _is_device_array(arr) -> bool:
    """True for a ``torch.Tensor``: its codec runs where the tensor lives
    (the kernel on a CUDA tensor), so quantization happens before the
    copy to the host."""
    return isinstance(arr, torch.Tensor)


def _host_array(arr) -> np.ndarray:
    if _is_device_array(arr):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def decode_wire(tag: str, val, aux, orig_len: int) -> np.ndarray:
    """Decode one wire entry back to a flat float32 host array: "" /
    "fp16" widen, "2bit" unpacks codes against the aux threshold. Sparse
    tags ("bsc"/"bsc16"/"rsp") stay (values, indices) pairs at the call
    sites."""
    if tag == "2bit":
        thr = float(np.asarray(aux, np.float32).ravel()[0])
        return compression.two_bit_dequantize(
            np.asarray(val, np.uint8).ravel(), orig_len, thr)
    return _host_array(val).ravel().astype(np.float32)


class WireCodec:
    """Per-chunk codec policy + stateful encode/decode for one node.

    Residuals are keyed by caller-supplied ``state_key`` tuples so the
    residual streams of a HiPS round never mix.
    """

    def __init__(self, policy: str = "", threshold: float = 0.5,
                 size_lower_bound: int = 200000):
        if policy not in WIRE_POLICIES:
            raise ValueError(
                f"GEOMX_WIRE_CODEC={policy!r}: expected one of "
                f"{WIRE_POLICIES}")
        self.policy = policy
        self.threshold = float(threshold)
        self.size_lower_bound = int(size_lower_bound)
        self._residual: Dict = {}
        # encode may run on trainer and transport threads
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, cfg, policy: Optional[str] = None) -> "WireCodec":
        return cls(cfg.wire_codec if policy is None else policy,
                   threshold=cfg.wire_2bit_threshold,
                   size_lower_bound=cfg.size_lower_bound)

    def enabled(self) -> bool:
        return self.policy != ""

    # -- policy ----------------------------------------------------------

    def chunk_codec(self, cid: int, num_chunks: int, num_elems: int) -> str:
        """Codec for chunk ``cid`` of ``num_chunks`` holding
        ``num_elems`` float32 elements."""
        p = self.policy
        if p in ("", "fp16", "2bit"):
            return p
        if p == "p3" and cid == 0:
            # the head chunk carries the layers the next forward needs
            # first — keep it at fp16 accuracy
            return "fp16"
        # "mpq" (and "p3" tails): only bulk chunks amortize 2-bit's
        # residual noise
        return "2bit" if num_elems >= self.size_lower_bound else "fp16"

    def resolve(self, num_elems: int) -> str:
        """Codec for a standalone (un-chunked) tensor."""
        return self.chunk_codec(1, 2, num_elems)

    # -- encode/decode ---------------------------------------------------

    def encode(self, tag: str, arr, state_key=None
               ) -> Tuple[np.ndarray, Optional[np.ndarray], str]:
        """Encode one wire entry; returns ``(wire_vals, aux, tag)`` as
        host arrays. 2-bit drains this state_key's error-feedback
        residual exactly once — call at message BUILD time only."""
        if tag == "" or tag is None:
            return _host_array(arr).astype(np.float32).ravel(), None, ""
        if tag == "fp16":
            if _is_device_array(arr):
                # half-width cast on the device: the copy moves 2 B/elem
                return _host_array(arr.to(torch.float16)).ravel(), None, \
                    "fp16"
            return (np.asarray(arr, np.float32).ravel()
                    .astype(np.float16), None, "fp16")
        if tag == "2bit":
            packed = self._encode_2bit(arr, state_key)
            return packed, np.asarray([self.threshold], np.float32), "2bit"
        raise ValueError(f"unknown wire codec {tag!r}")

    def _encode_2bit(self, arr, state_key) -> np.ndarray:
        if _is_device_array(arr):
            a = arr.detach().to(torch.float32).reshape(-1)
            with self._lock:
                res = self._residual.get(state_key)
                if res is None or not _is_device_array(res) \
                        or res.numel() != a.numel() or res.device != a.device:
                    res = torch.zeros_like(a)
                packed, new_res = ops.two_bit_quantize(a, res, self.threshold)
                self._residual[state_key] = new_res
            # the ONLY device-to-host copy of this entry: n/4 packed bytes
            return _host_array(packed)
        a = np.asarray(arr, np.float32).ravel()
        with self._lock:
            res = self._residual.get(state_key)
            if res is None or _is_device_array(res) or res.size != a.size:
                res = self._residual[state_key] = np.zeros(a.size,
                                                           np.float32)
            return compression.two_bit_quantize(a, res, self.threshold)

    def decode(self, tag: str, val, aux, orig_len: int) -> np.ndarray:
        return decode_wire(tag, val, aux, orig_len)

    def reset(self, state_key=None) -> None:
        """Drop residual state (all keys, or one)."""
        with self._lock:
            if state_key is None:
                self._residual.clear()
            else:
                self._residual.pop(state_key, None)


# -- mesh-collective codecs (EQuARX) -------------------------------------
#
# accepted GEOMX_MESH_CODEC values: the quantized ring all-reduce
# (parallel/quant_collectives.py) quantizes every hop's chunk with one of
# these; error-feedback residuals are threaded through by the caller.
#   "none" — fp32 sum over the ranks
#   "int8" — block-scaled int8: per-block power-of-two scale (max|block|
#            /127 rounded up to 2**k), codes round-half-even
#   "2bit" — {0, ±threshold} codes packed 4/byte, error feedback
#   "fp16" — half-width cast, error feedback
MESH_CODECS = ("none", "int8", "2bit", "fp16")


def _scale_bits(maxab: torch.Tensor) -> torch.Tensor:
    """Biased exponent of ``maxab / 127`` rounded UP to a power of two
    (a subnormal lands on 2**-126 via exponent 0 -> 1)."""
    t = maxab * float(np.float32(1.0 / 127.0))   # an fp32 product
    bits = t.view(torch.int32)
    mant = bits & 0x7FFFFF
    return ((bits >> 23) & 0xFF) + (mant != 0).to(torch.int32)


def block_quant_int8(x, block: int):
    """Block-scaled int8 quantize of a flat f32 tensor (``x.numel()`` a
    multiple of ``block``). Returns ``(codes int8 [n], exps uint8
    [n/block])``; each block's scale is ``2**(exps - 127)`` (0 encodes a
    zero block). With power-of-two scales the divide and the dequantize
    multiply are exact, so the only rounding is the round-half-even on
    the codes (``torch.round``, as ``jnp.round``)."""
    b = x.to(torch.float32).reshape(-1, block)
    maxab = b.abs().amax(dim=1)
    e2 = _scale_bits(maxab)
    scale = (e2 << 23).view(torch.float32)
    live = maxab > 0
    safe = torch.where(live, scale, 1.0)
    codes = torch.round(b / safe[:, None]).to(torch.int8)
    exps = torch.where(live, e2, 0).to(torch.uint8)
    return codes.reshape(-1), exps


def block_dequant_int8(codes, exps, block: int):
    """Inverse of :func:`block_quant_int8`. Exact: int8 times a power of
    two never rounds."""
    scales = (exps.reshape(-1).to(torch.int32) << 23).view(torch.float32)
    c = codes.reshape(-1, block).to(torch.float32)
    return (c * scales[:, None]).reshape(-1)


def block_quant_int8_np(x: np.ndarray, block: int):
    """numpy twin of :func:`block_quant_int8` — the per-hop oracle,
    operation for operation (round-half-even via ``np.rint``)."""
    b = np.asarray(x, np.float32).reshape(-1, block)
    maxab = np.max(np.abs(b), axis=1)
    t = (maxab * np.float32(1.0 / 127.0)).astype(np.float32)
    bits = t.view(np.int32)
    mant = bits & np.int32(0x7FFFFF)
    e2 = ((bits >> 23) & np.int32(0xFF)) + np.where(mant != 0, 1, 0)
    scale = (e2 << 23).astype(np.int32).view(np.float32)
    safe = np.where(maxab > 0, scale, np.float32(1.0)).astype(np.float32)
    codes = np.rint(b / safe[:, None]).astype(np.int8)
    exps = np.where(maxab > 0, e2, 0).astype(np.uint8)
    return codes.reshape(-1), exps


def block_dequant_int8_np(codes: np.ndarray, exps: np.ndarray,
                          block: int) -> np.ndarray:
    scales = (np.asarray(exps).astype(np.int32) << 23).view(np.float32)
    c = np.asarray(codes, np.int8).reshape(-1, block).astype(np.float32)
    return (c * scales[:, None]).reshape(-1)


def mesh_wire_bytes(codec: str, n_elems: int, block: int) -> int:
    """Bytes one quantized ring hop moves for a chunk of ``n_elems`` f32
    elements (codes + sidecar scales/threshold)."""
    if codec in ("none", ""):
        return 4 * n_elems
    if codec == "int8":
        blocks = -(-n_elems // max(1, block))
        return n_elems + blocks        # 1 B/code + 1-byte exponent/block
    if codec == "2bit":
        return -(-n_elems // 4) + 4            # 4 codes/byte + f32 threshold
    if codec == "fp16":
        return 2 * n_elems
    raise ValueError(
        f"GEOMX_MESH_CODEC={codec!r}: expected one of {MESH_CODECS}")
