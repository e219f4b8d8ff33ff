"""The party mesh and the ring helpers of the intra-party tier.

Counterpart of the part of ``geomx_tpu/parallel/mesh.py`` that the
intra-party tier needs: ``ring_perm``, ``ring_chunk_layout``,
``party_devices``, the party mesh (``make_party_mesh``) and the two
placements of the mesh-party store, ``replicated`` and
``batch_sharded``. A party is the ranks of the "dp" axis and the device
they live on. This port supports a party whose ranks share one card, the
only layout one H100 has: NCCL refuses two ranks on one GPU, so the ring
is one program that holds every rank's data, stacked on a leading rank
axis — single-controller, as the JAX package's shard_map is. Where the
JAX package lays a value out with a ``NamedSharding``, the port uses that
rank-stacked axis: ``(P, ...)``, rank r's row at index r. A party over
several cards (``torch.distributed`` point-to-point hops) is not ported
yet (ROADMAP queue A item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from geomx_tpu_torch._device import resolve_device

__all__ = ["PartyMesh", "make_party_mesh", "party_devices", "ring_perm",
           "ring_chunk_layout", "replicated", "batch_sharded"]


@dataclass(frozen=True)
class PartyMesh:
    """``size`` data-parallel ranks of one party, all on ``device``."""
    size: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.size}


def make_party_mesh(party_size: int, party_index: int = 0,
                    device=None) -> PartyMesh:
    """Pure-dp mesh of party ``party_index``: ``party_size`` ranks on one
    device (``device=None`` is the CUDA card, and raises without one).
    Several parties of one process share that device, each with a mesh
    of its own. ``party_size`` 0 is the JAX package's "every local
    device": one rank per visible card, at least one."""
    dev = resolve_device(device)
    size = int(party_size)
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


def replicated(mesh: PartyMesh, x) -> torch.Tensor:
    """``x`` replicated over the party: one tensor on the party's device,
    which every rank reads (the counterpart of ``NamedSharding(mesh,
    P())``)."""
    return torch.as_tensor(x).to(mesh.device)


def batch_sharded(mesh: PartyMesh, x) -> torch.Tensor:
    """``x`` split over the party's "dp" axis as ``jax.device_put`` with
    ``P("dp")`` splits it: rank r gets the contiguous rows ``[r*B/P,
    (r+1)*B/P)``, stacked as ``(P, B/P, ...)`` on the party's device."""
    t = torch.as_tensor(x).to(mesh.device)
    if t.ndim == 0 or t.shape[0] % mesh.size:
        raise ValueError(f"a batch of {tuple(t.shape)} does not split over "
                         f"{mesh.size} ranks")
    return t.reshape(mesh.size, t.shape[0] // mesh.size, *t.shape[1:])
