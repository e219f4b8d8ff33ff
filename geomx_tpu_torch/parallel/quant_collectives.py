"""Quantized ring all-reduce of the intra-party tier (GEOMX_MESH_CODEC).

Counterpart of ``geomx_tpu/parallel/quant_collectives.py``. A ring
(reduce-scatter, then all-gather) where every hop's chunk is quantized
before it crosses the link: block-scaled int8 by default, 2-bit error
feedback and fp16 as alternate policies, all from
:mod:`geomx_tpu_torch.compression.device` / :mod:`geomx_tpu_torch.ops`.

The ring is one program over the party's local rows
(:mod:`~geomx_tpu_torch.parallel.mesh`): the input is the ``(R, n)``
stack of the contributions of the ranks in ``mesh.row_ranks`` and a hop
along ``ring_perm`` is ``mesh.hop``. On a :class:`~.mesh.PartyMesh` the
party's ranks share one device, R = P and a hop is ``torch.roll(wire,
1, dims=0)`` (rank r receives from r-1): each hop quantizes all P
ranks' chunks at once, with the 2-bit codec one launch of the
``two_bit`` kernel per hop. On a :class:`~.mesh.ProcessPartyMesh` each
process is one rank, R = 1 (the JAX ring under shard_map), a hop is a
point-to-point send of the wire to rank r+1 paired with a receive from
rank r-1, and each hop's quantize is one ``two_bit`` launch in every
process.

Ring schedule (P ranks, vector padded to P chunks of m elements):

- **reduce-scatter** (P-1 hops): at step s, rank r quantizes its running
  partial for chunk ``(r - s) % P`` and sends it to rank r+1; the
  receiver dequantizes and adds its own copy of the next chunk. After
  P-1 steps rank r owns chunk ``(r + 1) % P`` fully summed.
- **all-gather** (P-1 hops): the owner quantizes its finished chunk
  ONCE; every later hop relays the codes VERBATIM. All ranks — the owner
  included — dequantize the same bytes, so the P replicas of the result
  are bit-identical by construction.

Error feedback: each rank carries a ``(P, m)`` residual — slots
``0..P-2`` feed the reduce-scatter steps, slot ``P-1`` the all-gather
origin quantize; slot s always covers chunk ``(r - s) % P``, so each
slot tracks one chunk's error stream across rounds. The local rows'
``(R, P, m)`` state (all of the ``(P, P, m)`` state in one process, the
rank's own slice over processes) is passed in and a new one returned
(state in, state out); the kernel writes each slot of the new state in
place through its strided view, with no copy.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from geomx_tpu_torch import ops
from geomx_tpu_torch.compression import device as dev
from geomx_tpu_torch.parallel.mesh import ring_chunk_layout, roll_hop

__all__ = ["RING_SLOTS", "ring_all_reduce", "residual_slots",
           "make_quant_all_reduce", "QuantRingReducer", "ring_wire_bytes",
           "zero_residual"]


def residual_slots(size: int) -> int:
    """Residual slots per rank: P-1 reduce-scatter steps + 1 all-gather
    origin quantize."""
    return max(1, int(size))


RING_SLOTS = residual_slots


def _codec_multiple(codec: str, block: int) -> int:
    """Chunk-size granularity the codec packs at."""
    if codec == "int8":
        return max(1, int(block))
    if codec == "2bit":
        return 4
    return 1


class _HopCodec:
    """Per-hop quantize/dequantize pair for chunks ``(P, m)``, one row
    per rank.

    ``quantize`` writes the new residual into ``out_res`` and returns
    ``wire``, the tuple of tensors a hop actually moves (codes +
    sidecar); ``dequantize`` recovers the receiver-identical value from
    ``wire`` alone. Only the callers that need that value dequantize:
    eager torch, unlike XLA, would not drop an unused one.
    """

    def __init__(self, codec: str, m: int, block: int, threshold: float):
        self.codec = codec
        self.m = int(m)
        self.block = max(1, int(block))
        self.threshold = float(threshold)

    def quantize(self, partial, res_slot, out_res):
        if self.codec == "2bit":
            packed, _ = ops.two_bit_quantize(
                partial, res_slot, self.threshold, out_residual=out_res)
            return (packed,)
        e = partial + res_slot
        if self.codec == "int8":
            codes, exps = dev.block_quant_int8(e, self.block)
            wire = (codes.view(e.shape[0], -1), exps.view(e.shape[0], -1))
        elif self.codec == "fp16":
            wire = (e.to(torch.float16),)
        else:
            raise ValueError(f"unknown mesh codec {self.codec!r}")
        torch.sub(e, self.dequantize(wire), out=out_res)
        return wire

    def dequantize(self, wire):
        if self.codec == "2bit":
            return ops.two_bit_dequantize(wire[0], self.m, self.threshold)
        if self.codec == "int8":
            return dev.block_dequant_int8(wire[0], wire[1], self.block
                                          ).view(wire[0].shape[0], -1)
        if self.codec == "fp16":
            return wire[0].to(torch.float32)
        raise ValueError(f"unknown mesh codec {self.codec!r}")


class _Split:
    """Seconds per part of a ring (quantize, hop, dequantize), added into
    ``timings`` when the caller passes a dict; the device is
    synchronized at each mark only then."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings = timings
        self.cuda = device.type == "cuda"
        self.t = time.perf_counter()

    def __call__(self, part: str) -> None:
        if self.timings is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.timings[part] = self.timings.get(part, 0.0) + now - self.t
        self.t = now


def ring_all_reduce(x, residual, *, size: int, codec: str = "int8",
                    block: int = 256, threshold: float = 0.5,
                    ranks: Optional[range] = None, hop=roll_hop,
                    timings: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized ring all-reduce over ``size`` ranks of the ``(R, n)``
    stack ``x`` of flat f32 contributions, row i rank ``ranks[i]``'s
    (default: every rank's, R = P), with their ``(R, P, m)`` residual
    state. ``hop`` moves each wire tensor's rows one step along the
    ring (``torch.roll`` of the whole stack by default; a party mesh's
    ``hop``). ``timings``: a dict that gains the seconds spent
    quantizing, hopping and dequantizing.

    Returns ``(replicas (R, n), new_residual (R, P, m))``: row i is rank
    ``ranks[i]``'s copy of the sum, bit-identical on every rank.
    ``codec="none"`` is the caller's branch (the plain sum) — rejected
    here.
    """
    if codec not in ("int8", "2bit", "fp16"):
        raise ValueError(
            f"ring_all_reduce: codec {codec!r} not in ('int8', '2bit', "
            "'fp16'); 'none' keeps the plain sum at the call site")
    size = int(size)
    ranks = range(size) if ranks is None else ranks
    rows = len(ranks)
    if x.ndim != 2 or x.shape[0] != rows:
        raise ValueError(f"expected a ({rows}, n) stack, got "
                         f"{tuple(x.shape)}")
    n = int(x.shape[1])
    m, padded = ring_chunk_layout(n, size, _codec_multiple(codec, block))
    if tuple(residual.shape) != (rows, residual_slots(size), m):
        raise ValueError(f"residual must be ({rows}, "
                         f"{residual_slots(size)}, {m}), got "
                         f"{tuple(residual.shape)}")
    q = _HopCodec(codec, m, block, threshold)
    split = _Split(timings, x.device)

    xp = x.to(torch.float32)
    if padded != n:
        xp = torch.nn.functional.pad(xp, (0, padded - n))
    chunks = xp.reshape(rows, size, m)
    i = torch.arange(rows, device=x.device)
    r = torch.arange(ranks.start, ranks.stop, device=x.device)
    new_res = torch.empty_like(residual)

    # reduce-scatter: quantize the running partial every hop
    send_val = chunks[i, r]
    for s in range(size - 1):
        wire = q.quantize(send_val, residual[:, s], new_res[:, s])
        split("quantize")
        rx = hop(wire)
        split("hop")
        send_val = q.dequantize(rx) + chunks[i, (r - s - 1) % size]
        split("dequantize")
    # send_val is now chunk (r+1) % size, fully summed on rank r
    wire = q.quantize(send_val, residual[:, size - 1], new_res[:, size - 1])
    split("quantize")

    # all-gather: relay the owner's codes verbatim; every rank (owner
    # included) dequantizes the same bytes -> bit-identical replicas
    out = torch.empty((rows, size, m), dtype=torch.float32, device=x.device)
    out[i, (r + 1) % size] = q.dequantize(wire)
    split("dequantize")
    cur = wire
    for t in range(size - 1):
        cur = hop(cur)
        split("hop")
        out[i, (r - t) % size] = q.dequantize(cur)
        split("dequantize")
    return out.reshape(rows, padded)[:, :n], new_res


def ring_wire_bytes(codec: str, n: int, size: int, block: int = 256) -> int:
    """Link bytes the quantized ring moves per all-reduce, in the
    ``2 * (P - 1) * wire_bytes`` model of the fp32 all-reduce — codes +
    sidecar scales/threshold per hop, summed over both phases."""
    size = int(size)
    if size <= 1:
        return 0
    if codec in ("none", ""):
        return 2 * (size - 1) * 4 * int(n)
    m, _ = ring_chunk_layout(int(n), size, _codec_multiple(codec, block))
    return 2 * (size - 1) * size * dev.mesh_wire_bytes(codec, m, block)


def zero_residual(size: int, n: int, codec: str, block: int = 256,
                  device=None, rows: Optional[int] = None) -> torch.Tensor:
    """Error-feedback state for one ring: ``(R, P, m)`` zeros, the slots
    of the rank of local row i in row i (``rows`` R defaults to P, every
    rank's)."""
    m, _ = ring_chunk_layout(int(n), int(size),
                             _codec_multiple(codec, block))
    return torch.zeros((int(size) if rows is None else int(rows),
                        residual_slots(size), m),
                       dtype=torch.float32, device=device)


def make_quant_all_reduce(mesh, codec: str, n: int, *, block: int = 256,
                          threshold: float = 0.5, mean: bool = False):
    """Standalone quantized all-reduce over the party ``mesh``.

    Returns ``fn(x_stacked, residual, timings=None) -> (reduced,
    new_residual)``: ``x_stacked`` is the ``(R, n)`` stack of the
    mesh's local rows (``mesh.row_ranks``: all P ranks in one process,
    this rank over processes), ``residual`` the ``zero_residual`` tensor
    of those rows. ``reduced`` is ``(R, n)``, one replica of the sum
    (mean when ``mean=True``) per local rank — what the JAX package's
    replicated output holds on each of its devices. ``codec="none"`` is
    the plain sum over the ranks with a pass-through residual — the
    reference the quantized paths are measured against (over processes
    the group's all-reduce). ``timings`` as :func:`ring_all_reduce`
    takes it.
    """
    size = int(mesh.shape["dp"])
    n = int(n)
    want = (len(mesh.row_ranks), n)

    def check(xs):
        if tuple(xs.shape) != want:
            raise ValueError(f"expected a stack of {want}, got "
                             f"{tuple(xs.shape)}")

    if codec == "none":
        def fn(xs, res, timings=None):
            check(xs)
            y = mesh.sum_rows(xs.to(torch.float32))
            y = y / size if mean else y
            return y.expand(*want), res

        return fn

    def fn(xs, res, timings=None):
        check(xs)
        y, new_res = ring_all_reduce(
            xs, res, size=size, codec=codec, block=block,
            threshold=threshold, ranks=mesh.row_ranks, hop=mesh.hop,
            timings=timings)
        return (y / size if mean else y), new_res

    return fn


class QuantRingReducer:
    """Stateful wrapper: one quantized all-reduce per round for one fixed
    vector size, holding the device-resident residual of the mesh's
    local rows between rounds — one per gradient key, so residual
    streams never mix across keys.
    """

    def __init__(self, mesh, codec: str, n: int, *, block: int = 256,
                 threshold: float = 0.5, mean: bool = False):
        if codec not in dev.MESH_CODECS:
            raise ValueError(
                f"GEOMX_MESH_CODEC={codec!r}: expected one of "
                f"{dev.MESH_CODECS}")
        self.mesh = mesh
        self.codec = codec
        self.n = int(n)
        self.block = int(block)
        self.mean = bool(mean)
        self.size = int(mesh.shape["dp"])
        self._fn = make_quant_all_reduce(
            mesh, codec, self.n, block=block, threshold=threshold, mean=mean)
        self._res = self._zero()

    def _zero(self) -> torch.Tensor:
        rows = len(self.mesh.row_ranks)
        if self.codec == "none":
            return torch.zeros((rows, 1, 1), dtype=torch.float32,
                               device=self.mesh.device)
        return zero_residual(self.size, self.n, self.codec, self.block,
                             device=self.mesh.device, rows=rows)

    def reduce(self, x, timings: Optional[dict] = None) -> torch.Tensor:
        """All-reduce the ``(R, n)`` local rows -> ``(R, n)`` replicas,
        advancing the residual stream by one round (``timings`` as
        :func:`ring_all_reduce` takes it)."""
        y, self._res = self._fn(x, self._res, timings)
        return y

    def reset(self) -> None:
        """Zero the residual streams (abort/membership recovery re-seeds
        rather than replaying stale error)."""
        self._res = self._zero()

    def wire_bytes_per_round(self) -> int:
        return ring_wire_bytes(self.codec, self.n, self.size, self.block)
