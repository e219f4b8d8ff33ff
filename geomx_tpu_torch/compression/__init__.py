"""WAN gradient compression: FP16, Bi-Sparse (BSC), 2-bit, MPQ.

Counterpart of ``geomx_tpu/compression/__init__.py``, copied with only
the imports changed: host-side numpy kernels that re-implement the
reference's GradientCompression family (reference:
src/kvstore/gradient_compression.cc:40-336, kernels
gradient_compression-inl.h:40-155) for the inter-DC hop of the HiPS
server. They are the CPU oracle of the device ops and the fallback for
processes without a card. Device (torch + CUDA) versions live in
``geomx_tpu_torch.ops``; ``make_compressor({"type": "bsc", "device":
true})`` or GEOMX_DEVICE_COMPRESSION=1 routes the server's WAN hop
through them. Placement matches the reference: the
LAN tier is uncompressed; party servers compress the aggregated gradient
before the WAN push (BSCompress, :191), the global server decompresses,
aggregates, and compresses pull responses with the non-zero filter scaled
by the number of global workers (BSCPullCompress, :271).

Wire-format divergence from the reference (documented, intentional): the
reference pads compressed buffers to a fixed size with the placeholder
value -65530 and index -1 and smuggles the original size through a second
wire key (kvstore_dist_server.h:1479-1483); our messages carry explicit
(values, indices) arrays of exact length plus (offset,total,len) meta, so
no placeholders are needed.

Compression tags travel in ``Meta.compr`` / ``KVPairs.compr``:
"" (none), "fp16", "bsc", "2bit" — plus "bsc16" (BSC with float16
values) on the quantized combined wire (``compression.device``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["make_compressor", "Compressor", "FP16Compressor", "BSCCompressor",
           "TwoBitCompressor", "MPQCompressor", "bsc_compress", "bsc_decompress",
           "bsc_pull_compress", "two_bit_quantize", "two_bit_dequantize"]

BSC_MOMENTUM = 0.9  # reference: gradient_compression.cc:198


def _ops():
    """geomx_tpu_torch.ops via sys.modules-or-import: the server handler
    threads that call make_compressor must not take the package import
    lock while another thread holds it."""
    import sys

    mod = sys.modules.get("geomx_tpu_torch.ops")
    if mod is not None:
        return mod
    from geomx_tpu_torch import ops

    return ops


# ---------------------------------------------------------------------------
# stateless kernels
# ---------------------------------------------------------------------------

def bsc_sample_boundary(v: np.ndarray, threshold: float,
                        rng: np.random.Generator) -> float:
    """Top-k boundary from a random 0.5% sample (reference: :203-233)."""
    n = v.size
    sample_size = int(n * 0.005) if n * 0.005 * threshold >= 10 \
        else int(np.ceil(10 / threshold))
    sample_size = min(max(sample_size, 1), n)
    top_k = max(int(sample_size * threshold), 1)
    idx = rng.permutation(n)[:sample_size]
    sample = np.abs(v[idx])
    top_k = min(top_k, sample.size)
    return float(np.partition(sample, -top_k)[-top_k])


def bsc_compress(grad: np.ndarray, u: np.ndarray, v: np.ndarray,
                 threshold: float,
                 rng: Optional[np.random.Generator] = None,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Momentum-corrected top-k sparsification (reference: :191-268).

    Mutates ``u``/``v`` in place (momentum correction + residual reset for
    the transmitted coordinates). Returns (values, indices).
    """
    if rng is None:
        rng = np.random.default_rng(42)  # reference uses a fixed seed (:212)
    n = grad.size
    zipped = max(int(n * threshold), 1)
    u *= BSC_MOMENTUM
    u += grad
    v += u
    boundary = bsc_sample_boundary(v, threshold, rng)
    selected = np.nonzero(np.abs(v) >= boundary)[0][:zipped]
    values = v[selected].copy()
    v[selected] = 0.0
    u[selected] = 0.0
    return values.astype(np.float32), selected.astype(np.int32)


def bsc_pull_compress(arr: np.ndarray, threshold: float, multiplier: int,
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Non-zero filter for pull responses, capacity scaled by the number of
    contributing global workers (reference: BSCPullCompress :271-308)."""
    cap = max(int(arr.size * threshold * multiplier), 1)
    idx = np.nonzero(arr)[0][:cap]
    return arr[idx].astype(np.float32), idx.astype(np.int32)


def bsc_decompress(values: np.ndarray, indices: np.ndarray,
                   original_size: int) -> np.ndarray:
    """Scatter back to dense (reference: BSCDecompress :310-336)."""
    out = np.zeros(original_size, dtype=np.float32)
    valid = indices >= 0
    out[indices[valid]] = values[valid]
    return out


def two_bit_quantize(grad: np.ndarray, residual: np.ndarray, threshold: float,
                     ) -> np.ndarray:
    """2-bit quantization with residual feedback (reference kernels:
    gradient_compression-inl.h:40-155). Packs 4 codes per byte:
    0 = zero, 1 = +threshold, 2 = -threshold."""
    residual += grad
    pos = residual > threshold
    neg = residual < -threshold
    codes = np.zeros(grad.size, dtype=np.uint8)
    codes[pos] = 1
    codes[neg] = 2
    residual[pos] -= threshold
    residual[neg] += threshold
    pad = (-grad.size) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    c = codes.reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return packed.astype(np.uint8)


def two_bit_dequantize(packed: np.ndarray, original_size: int,
                       threshold: float) -> np.ndarray:
    codes = np.empty((packed.size, 4), dtype=np.uint8)
    codes[:, 0] = packed & 3
    codes[:, 1] = (packed >> 2) & 3
    codes[:, 2] = (packed >> 4) & 3
    codes[:, 3] = (packed >> 6) & 3
    flat = codes.reshape(-1)[:original_size]
    out = np.zeros(original_size, dtype=np.float32)
    out[flat == 1] = threshold
    out[flat == 2] = -threshold
    return out


# ---------------------------------------------------------------------------
# compressor objects (server-side dispatch)
# ---------------------------------------------------------------------------

class Compressor:
    """No-op compressor (CompressionType::kNone)."""

    type_name = "none"

    def compress_push(self, arr: np.ndarray, state_key=None):
        """-> (wire_values, aux_or_None, tag)."""
        return arr, None, ""

    def decompress_push(self, tag: str, val: np.ndarray,
                        aux: Optional[np.ndarray], orig_len: int) -> np.ndarray:
        return _generic_decompress(tag, val, aux, orig_len)

    def compress_pull(self, tag: str, arr: np.ndarray, factor: int):
        """-> (wire_values, aux_or_None) for a pull response."""
        if tag == "fp16":
            return arr.astype(np.float16), None
        return arr, None

    def decompress_pull(self, tag: str, val: np.ndarray,
                        aux: Optional[np.ndarray], orig_len: int,
                        factor: int) -> np.ndarray:
        return _generic_decompress(tag, val, aux, orig_len)

    def pull_compr_tag(self, num_elems: int = 0) -> str:
        return ""

    def push_tag(self, num_elems: int = 0) -> str:
        return ""


def _generic_decompress(tag, val, aux, orig_len):
    if tag == "" or tag is None:
        return val
    if tag == "fp16":
        return val.astype(np.float32)
    if tag == "rsp":
        # row-sparse push (reference: EncodeRowSparseKey,
        # kvstore_dist.h:906): aux = row ids, val = those rows flattened;
        # scatter-ADD into a dense delta so overlapping rows from
        # different workers aggregate by sum
        ids = np.asarray(aux, dtype=np.int64).ravel()
        out = np.zeros(orig_len, dtype=np.float32)
        if ids.size:
            rows = np.asarray(val, dtype=np.float32).reshape(ids.size, -1)
            row_len = rows.shape[1]
            n_rows = orig_len // row_len
            ok = (ids >= 0) & (ids < n_rows)
            if not ok.all():
                import logging

                logging.getLogger("geomx.compression").warning(
                    "row-sparse push: dropping %d out-of-range row ids "
                    "(key has %d rows)", int((~ok).sum()), n_rows)
                ids, rows = ids[ok], rows[ok]
            np.add.at(out.reshape(n_rows, row_len), ids, rows)
        return out
    if tag in ("bsc", "bsc16"):
        # scatter-ADD, not assignment: a push payload carrying duplicate
        # indices must aggregate by sum (same contract as the "rsp"
        # branch above); for pull payloads indices are unique (nonzeros
        # of one array) so add and set coincide. "bsc16" is the same
        # wire with float16 values (quantized combined wire) — the
        # astype below widens either way and aggregation stays fp32
        assert aux is not None, "bsc payload missing index aux array"
        idx = np.asarray(aux, dtype=np.int64).ravel()
        vals = np.asarray(val, dtype=np.float32).ravel()
        out = np.zeros(orig_len, dtype=np.float32)
        ok = (idx >= 0) & (idx < orig_len)
        if not ok.all():
            import logging

            logging.getLogger("geomx.compression").warning(
                "bsc push: dropping %d out-of-range indices "
                "(payload addresses %d elements)",
                int((~ok).sum()), orig_len)
        np.add.at(out, idx[ok], vals[ok])
        return out
    if tag == "2bit":
        assert aux is not None and aux.size == 1, "2bit payload missing threshold"
        return two_bit_dequantize(val, orig_len, float(aux[0]))
    raise ValueError(f"unknown compression tag {tag!r}")


class FP16Compressor(Compressor):
    """Low-precision FP16 transmission (the reference achieves this by
    casting the model to float16, examples/cnn_fp16.py; as a server-side
    compressor we cast on the WAN wire only, keeping fp32 aggregation)."""

    type_name = "fp16"

    def compress_push(self, arr, state_key=None):
        return arr.astype(np.float16), None, "fp16"

    def pull_compr_tag(self, num_elems: int = 0) -> str:
        return "fp16"

    def push_tag(self, num_elems: int = 0) -> str:
        return "fp16"


class BSCCompressor(Compressor):
    """Bi-Sparse Compression with per-key momentum/residual state."""

    type_name = "bsc"

    def __init__(self, threshold: float = 0.01):
        self.threshold = threshold
        self._u: Dict = {}
        self._v: Dict = {}
        self._rng = np.random.default_rng(42)
        # the boundary-sampling Generator is shared across keys, and
        # per-key-locked server threads compress different keys
        # concurrently; numpy Generators are not thread-safe
        self._rng_lock = __import__("threading").Lock()

    def compress_push(self, arr, state_key=None):
        if state_key not in self._u:
            self._u[state_key] = np.zeros(arr.size, dtype=np.float32)
            self._v[state_key] = np.zeros(arr.size, dtype=np.float32)
        with self._rng_lock:
            values, indices = bsc_compress(
                arr.astype(np.float32), self._u[state_key],
                self._v[state_key], self.threshold, self._rng)
        return values, indices, "bsc"

    def compress_pull(self, tag, arr, factor):
        if tag != "bsc":
            return super().compress_pull(tag, arr, factor)
        values, indices = bsc_pull_compress(
            np.asarray(arr, dtype=np.float32), self.threshold, factor)
        return values, indices

    def pull_compr_tag(self, num_elems: int = 0) -> str:
        return "bsc"

    def push_tag(self, num_elems: int = 0) -> str:
        return "bsc"


class TwoBitCompressor(Compressor):
    """Legacy 2-bit quantization with residual feedback."""

    type_name = "2bit"

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._residual: Dict = {}

    def compress_push(self, arr, state_key=None):
        if state_key not in self._residual:
            self._residual[state_key] = np.zeros(arr.size, dtype=np.float32)
        packed = two_bit_quantize(arr.astype(np.float32),
                                  self._residual[state_key], self.threshold)
        return packed, np.asarray([self.threshold], np.float32), "2bit"

    def push_tag(self, num_elems: int = 0) -> str:
        return "2bit"


class MPQCompressor(Compressor):
    """Mixed-Precision Quantization: route by tensor size (reference:
    examples/cnn_mpq.py + MXNET_KVSTORE_SIZE_LOWER_BOUND,
    kvstore_dist_server.h:183) — small tensors go FP16, large tensors BSC."""

    type_name = "mpq"

    def __init__(self, threshold: float = 0.01, size_lower_bound: int = 200000,
                 device: bool = False):
        self.size_lower_bound = size_lower_bound
        if device:
            # the large-tensor path is exactly what the device kernels
            # exist for (>= size_lower_bound elements go BSC)
            self._bsc = _ops().DeviceBSCCompressor(threshold)
        else:
            self._bsc = BSCCompressor(threshold)
        self._fp16 = FP16Compressor()

    def _route(self, num_elems: int) -> Compressor:
        return self._bsc if num_elems >= self.size_lower_bound else self._fp16

    def compress_push(self, arr, state_key=None):
        return self._route(arr.size).compress_push(arr, state_key)

    def compress_pull(self, tag, arr, factor):
        if tag == "bsc":
            return self._bsc.compress_pull(tag, arr, factor)
        return self._fp16.compress_pull(tag, arr, factor)

    def pull_compr_tag(self, num_elems: int = 0) -> str:
        return self._route(num_elems).pull_compr_tag(num_elems)

    def push_tag(self, num_elems: int = 0) -> str:
        return self._route(num_elems).push_tag(num_elems)


def make_compressor(params: Optional[dict]) -> Compressor:
    """Build from set_gradient_compression params (reference: SetParams,
    gradient_compression.cc:46-58; MPQ added per examples/cnn_mpq.py)."""
    if not params:
        return Compressor()
    ctype = params.get("type", "none")
    if ctype == "none":
        return Compressor()
    if ctype == "fp16":
        return FP16Compressor()
    if ctype == "bsc":
        threshold = float(params.get("threshold", 0.01))
        use_device = params.get("device")
        if use_device is None:
            use_device = _ops().device_compression_enabled()
        if use_device:
            return _ops().DeviceBSCCompressor(threshold)
        return BSCCompressor(threshold)
    if ctype == "2bit":
        return TwoBitCompressor(float(params.get("threshold", 0.5)))
    if ctype == "mpq":
        use_device = params.get("device")
        if use_device is None:
            use_device = _ops().device_compression_enabled()
        return MPQCompressor(
            float(params.get("threshold", 0.01)),
            int(params.get("size_lower_bound", 200000)),
            device=bool(use_device))
    raise ValueError(f"Unknown gradient compression type {ctype!r}")
