"""Meshes, placements and the ring helpers.

Counterpart of ``geomx_tpu/parallel/mesh.py``: the named-axis mesh
(``make_mesh`` / ``mesh_shape_for``, JAX ``:29``, ``:40``; axes "dp",
"tp", "sp" and, when asked for, "pp" and "ep"), ``ring_perm``,
``ring_chunk_layout``, ``party_devices``, the party mesh
(``make_party_mesh``) and the two placements of the mesh-party store,
``replicated`` and ``batch_sharded``.

Every rank of a mesh lives on one device, the only layout one H100 has:
NCCL refuses two ranks on one GPU, so a collective is one program that
holds every rank's data, stacked on a leading rank axis —
single-controller, as the JAX package's shard_map is. Where the JAX
package lays a value out with a ``NamedSharding``, the port uses that
rank-stacked axis: ``(P, ...)``, rank r's row at index r
(:class:`Sharded`, :func:`shard`). So ``make_mesh`` takes its rank count
from the caller, not from the device count, and the ranks share the
card's memory: splitting a value over "tp", "ep" or "dp" changes its
layout, not what one card holds.

A party can also span processes (the JAX package's multi-process mesh,
``jax.distributed``): once ``torch.distributed`` is up
(``kvstore.mesh_party.maybe_init_multihost``), ``make_party_mesh``
returns a :class:`ProcessPartyMesh`, one rank per process of the group.
Both party meshes hold their ranks' values as local rows, a ``(R, ...)``
stack of the ranks in ``row_ranks``: every rank's row in one process
(R = P), this process's own row over processes (R = 1). So the code
above them is one path, and the mesh supplies what differs: ``hop``
(one step along :func:`ring_perm`: ``torch.roll`` of the stack, or a
point-to-point send to rank r+1 paired with a receive from rank r-1),
``sum_rows`` and ``all_rows`` (over the stack, or the group's
all-reduce and all-gather), ``replicated`` (over processes a broadcast
from rank 0) and ``batch_sharded`` (the rows of the party batch that
``row_ranks`` own). The backend is gloo, on the CPU and on the card
alike (NCCL refuses two ranks on one GPU): gloo moves host tensors, so
a tensor on the card is staged through a pinned host buffer each way
and everything else stays on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from geomx_tpu_torch._device import resolve_device

__all__ = ["AXES", "AXES5", "Mesh", "mesh_shape_for", "make_mesh",
           "Sharded", "shard", "check_divisible",
           "param_layouts", "PartyMesh", "ProcessPartyMesh",
           "make_party_mesh", "party_devices", "ring_perm", "roll_hop",
           "ring_chunk_layout", "replicated", "batch_sharded"]

AXES = ("dp", "tp", "sp")
AXES5 = ("dp", "tp", "sp", "pp", "ep")


@dataclass(frozen=True)
class Mesh:
    """Named axes of ranks, every rank on ``device``."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of ranks (the JAX mesh's ``devices.size``)."""
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def row_ranks(self) -> range:
        """The ranks of this process's local rows: all of them."""
        return range(self.size)


def mesh_shape_for(n_devices: int, tp: int = 1, sp: int = 1,
                   pp: int = 1, ep: int = 1) -> Tuple[int, ...]:
    """Factor n_devices into (dp, tp, sp[, pp, ep]) given requests."""
    denom = tp * sp * pp * ep
    if n_devices % denom:
        raise AssertionError(
            f"n_devices={n_devices} not divisible by tp*sp*pp*ep={denom}")
    if pp == 1 and ep == 1:
        return (n_devices // denom, tp, sp)
    return (n_devices // denom, tp, sp, pp, ep)


def make_mesh(ranks: int, tp: int = 1, sp: int = 1, pp: int = 1,
              ep: int = 1, *, device=None) -> Mesh:
    """A mesh of ``ranks`` ranks on ``device`` (``None`` is the CUDA card,
    and raises without one), factored as the JAX ``make_mesh`` factors
    its device count: dp = ranks / (tp*sp*pp*ep). The JAX package takes
    the rank count from ``len(jax.devices())``; on one card that is 1,
    so the caller names it."""
    shape = mesh_shape_for(int(ranks), tp, sp, pp, ep)
    return Mesh(AXES if len(shape) == 3 else AXES5, shape,
                resolve_device(device))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _ways(mesh: Mesh, entry) -> int:
    n = 1
    for a in _axes(entry):
        n *= mesh.shape[a]
    return n


def check_divisible(mesh: Mesh, spec: Sequence, shape: Sequence[int],
                    what: str = "value") -> None:
    """Raise ``ValueError`` unless every axis of ``shape`` divides by the
    mesh axes that ``spec`` maps it to (shard_map's and device_put's
    check)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has more entries than {what} "
                         f"of shape {tuple(shape)} has axes")
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in mesh.shape:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, "
                                 f"not one of {mesh.axis_names}")
        n = _ways(mesh, entry)
        if shape[d] % n:
            raise ValueError(
                f"{what} of shape {tuple(shape)} with spec {tuple(spec)} "
                f"maps axis {d} (of size {shape[d]}) to mesh axis "
                f"{entry!r} (of size {n}), but {n} does not evenly divide "
                f"{shape[d]}")


def param_layouts(mesh: Mesh, params, spec_for) -> Dict[str, tuple]:
    """``{flax path: spec}`` of a module's (or a name -> tensor dict's)
    parameters under ``spec_for(path, ndim)``, each checked against
    ``mesh`` by :func:`check_divisible`: the parameter spec rules'
    common walk."""
    items = params.named_parameters() \
        if isinstance(params, torch.nn.Module) else params.items()
    out = {}
    for name, t in items:
        path = name.replace(".", "/")
        out[path] = spec_for(path, t.dim())
        check_divisible(mesh, out[path], tuple(t.shape), path)
    return out


@dataclass
class Sharded:
    """A value laid out over a mesh as ``NamedSharding(mesh, spec)`` lays
    it out, rank-stacked: ``shards`` is ``(n, *shard_shape)``, ``n`` the
    number of distinct shards (the product of the mesh axes ``spec``
    names), shard i holding block i of the value in row-major order of
    its split axes. A replicated value is one shard."""
    shards: torch.Tensor
    mesh: Mesh
    spec: Tuple
    shape: Tuple[int, ...]

    @property
    def dtype(self):
        return self.shards.dtype

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(self.shards.shape[1:])

    def full(self) -> torch.Tensor:
        """The whole value (differentiable with respect to ``shards``)."""
        ways = [_ways(self.mesh, e) for e in self.spec]
        ways += [1] * (len(self.shape) - len(ways))
        nd = len(self.shape)
        x = self.shards.reshape([*ways, *self.shard_shape])
        # (w0, .., w_{d-1}, s0, .., s_{d-1}) -> (w0, s0, w1, s1, ...)
        x = x.permute([i for d in range(nd) for i in (d, nd + d)])
        return x.reshape(self.shape)


def shard(x, mesh: Mesh, spec: Sequence = ()) -> Sharded:
    """``x`` laid out as ``jax.device_put(x, NamedSharding(mesh,
    P(*spec)))`` lays it out, rank-stacked on ``mesh.device``."""
    t = torch.as_tensor(x).to(mesh.device)
    spec = tuple(spec)
    check_divisible(mesh, spec, t.shape)
    nd = t.dim()
    ways = [_ways(mesh, e) for e in spec] + [1] * (nd - len(spec))
    pieces = [v for d in range(nd) for v in (ways[d], t.shape[d] // ways[d])]
    s = t.reshape(pieces).permute([*range(0, 2 * nd, 2),
                                   *range(1, 2 * nd, 2)])
    n = 1
    for w in ways:
        n *= w
    return Sharded(s.reshape([n, *(t.shape[d] // ways[d] for d in range(nd))])
                   .contiguous(), mesh, spec, tuple(t.shape))


@dataclass(frozen=True)
class PartyMesh:
    """``size`` data-parallel ranks of one party, all on ``device``: this
    process holds every rank's row."""
    size: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.size}

    @property
    def row_ranks(self) -> range:
        """The ranks of this process's local rows, in row order."""
        return range(self.size)

    def hop(self, tensors) -> Tuple[torch.Tensor, ...]:
        """One hop along :func:`ring_perm`: :func:`roll_hop`."""
        return roll_hop(tensors)

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of the ``(P, ...)`` stack ``x``."""
        return x.sum(dim=0)

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's row of ``x``, ``(P, ...)``: ``x`` itself."""
        return x


@dataclass(frozen=True)
class ProcessPartyMesh:
    """A party of ``size`` data-parallel ranks, one per process of the
    ``torch.distributed`` group: this process is rank ``rank`` and holds
    one local row, its own, on ``device``."""
    size: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.size}

    @property
    def row_ranks(self) -> range:
        """The ranks of this process's local rows: its own."""
        return range(self.rank, self.rank + 1)

    def hop(self, tensors) -> Tuple[torch.Tensor, ...]:
        """One hop along :func:`ring_perm` over the processes
        (``lax.ppermute`` in the JAX ring): each of this rank's tensors
        goes to rank r+1 by ``isend``, paired with an ``irecv`` of rank
        r-1's of the same shape and dtype. Returns the received tensors
        on the party's device."""
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        reqs: List = []
        got = []
        for t in tensors:
            h = _staged(t)
            b = torch.empty(h.shape, dtype=h.dtype,
                            pin_memory=h.is_pinned())
            reqs.append(dist.isend(_as_bytes(h), nxt))
            reqs.append(dist.irecv(_as_bytes(b), prv))
            got.append(b)
        for q in reqs:
            q.wait()
        return tuple(b.to(self.device) for b in got)

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every rank of the group of its ``(1, ...)`` local
        rows, in fp32, on the party's device (the group's all-reduce)."""
        h = _staged(x.to(torch.float32).sum(dim=0))
        dist.all_reduce(h, op=dist.ReduceOp.SUM)
        return h.to(self.device)

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's row of ``x``, stacked ``(P, ...)`` in rank order on
        the party's device (the group's all-gather)."""
        h = _staged(x[0])
        rows = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(rows, h)
        return torch.stack(rows).to(self.device)


def make_party_mesh(party_size: int, party_index: int = 0,
                    device=None):
    """Pure-dp mesh of party ``party_index``: ``party_size`` ranks on one
    device (``device=None`` is the CUDA card, and raises without one).
    Several parties of one process share that device, each with a mesh
    of its own. ``party_size`` 0 is the JAX package's "every local
    device": one rank per visible card, at least one.

    Once this process has joined a ``torch.distributed`` group, the party
    is the group: a :class:`ProcessPartyMesh` of the world size, this
    process's rank, its row on ``device`` (``party_size`` must be 0 or
    the world size)."""
    dev = resolve_device(device)
    size = int(party_size)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if size not in (0, world):
            raise ValueError(f"party_size {party_size} != the process "
                             f"group's {world} ranks")
        return ProcessPartyMesh(world, dist.get_rank(), dev)
    if size == 0:
        size = max(1, torch.cuda.device_count() if dev.type == "cuda" else 1)
    if size < 1:
        raise ValueError(f"party_size must be >= 0, got {party_size}")
    return PartyMesh(size, dev)


def party_devices(party_size: int = 0, party_index: int = 0,
                  devices: Optional[Sequence] = None) -> Sequence:
    """Disjoint device slice for one party: ``devices[i*size:(i+1)*size]``
    (all of them when ``party_size`` is 0). ``devices`` defaults to the
    visible CUDA cards."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if party_size <= 0:
        return list(devices)
    lo = party_index * party_size
    hi = lo + party_size
    assert hi <= len(devices), (
        f"party {party_index} needs devices [{lo}:{hi}) but only "
        f"{len(devices)} are visible")
    return list(devices[lo:hi])


def ring_perm(size: int):
    """One unidirectional ring hop as (source, destination) pairs: every
    rank forwards to its successor. On the stacked rank axis this is
    ``torch.roll(x, 1, dims=0)``: rank r receives rank r-1's row."""
    return [(i, (i + 1) % size) for i in range(size)]


def roll_hop(tensors) -> Tuple[torch.Tensor, ...]:
    """One hop along :func:`ring_perm` of each ``(P, ...)`` stack of
    every rank's row: rank r's row moves to rank r+1."""
    return tuple(torch.roll(t, 1, dims=0) for t in tensors)


def ring_chunk_layout(n: int, size: int, multiple: int = 1
                      ) -> Tuple[int, int]:
    """Chunking for an n-element ring all-reduce over ``size`` ranks.

    Returns ``(m, padded)``: each rank owns one m-element chunk, with m
    rounded up to ``multiple`` (codec packing granularity — int8 block
    size, 4 for 2-bit packing) and ``padded = size * m >= n`` the
    zero-padded total the vector is reshaped to.
    """
    m = -(-n // size)
    mult = max(1, int(multiple))
    m = -(-m // mult) * mult
    return m, size * m


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t`` that gloo may send or overwrite
    (pinned when ``t`` is on the card, so the copy is one DMA)."""
    h = torch.empty(t.shape, dtype=t.dtype,
                    pin_memory=t.device.type == "cuda")
    h.copy_(t)
    return h


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as flat bytes: gloo's point-to-point
    and broadcast move bytes whatever the dtype (fp16, bf16, int8)."""
    return t.reshape(-1).view(torch.uint8)


def replicated(mesh, x) -> torch.Tensor:
    """``x`` replicated over the party: one tensor on the party's device,
    which every rank reads (the counterpart of ``NamedSharding(mesh,
    P())``). Over processes this is a broadcast of rank 0's ``x``: every
    rank passes a value of the same shape and dtype, and gets rank 0's."""
    t = torch.as_tensor(x)
    if not isinstance(mesh, ProcessPartyMesh):
        return t.to(mesh.device)
    h = _staged(t)
    dist.broadcast(_as_bytes(h), 0)
    return h.to(mesh.device)


def batch_sharded(mesh, x) -> torch.Tensor:
    """``x`` split over the party's "dp" axis as ``jax.device_put`` with
    ``P("dp")`` splits it: rank r gets the contiguous rows ``[r*B/P,
    (r+1)*B/P)``. Every process passes the whole party batch and gets
    the rows of its ``mesh.row_ranks``, stacked ``(R, B/P, ...)`` on the
    party's device: ``(P, B/P, ...)`` in one process, ``(1, B/P, ...)``
    over processes."""
    t = torch.as_tensor(x)
    if t.ndim == 0 or t.shape[0] % mesh.size:
        raise ValueError(f"a batch of {tuple(t.shape)} does not split over "
                         f"{mesh.size} ranks")
    per = t.shape[0] // mesh.size
    ranks = mesh.row_ranks
    return t[ranks.start * per:ranks.stop * per].to(mesh.device).reshape(
        len(ranks), per, *t.shape[1:])
