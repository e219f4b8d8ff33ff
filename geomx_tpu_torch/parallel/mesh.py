"""The party mesh and the ring helpers of the intra-party tier.

Counterpart of the part of ``geomx_tpu/parallel/mesh.py`` that the
quantized ring all-reduce needs: ``ring_perm``, ``ring_chunk_layout``,
``party_devices`` and a party mesh. A party is the ranks of the "dp"
axis and the device they live on. This port supports a party whose
ranks share one card, the only layout one H100 has: NCCL refuses two
ranks on one GPU, so the ring is one program that holds every rank's
data, stacked on a leading rank axis — single-controller, as the JAX
package's shard_map is. A party over several cards (``torch.distributed``
point-to-point hops) is not ported yet (ROADMAP queue A item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from geomx_tpu_torch._device import resolve_device

__all__ = ["PartyMesh", "make_party_mesh", "party_devices", "ring_perm",
           "ring_chunk_layout"]


@dataclass(frozen=True)
class PartyMesh:
    """``size`` data-parallel ranks, all on ``device``."""
    size: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.size}


def make_party_mesh(party_size: int, device=None) -> PartyMesh:
    """Pure-dp party of ``party_size`` ranks on one device
    (``device=None`` is the CUDA card, and raises without one)."""
    if int(party_size) < 1:
        raise ValueError(f"party_size must be >= 1, got {party_size}")
    return PartyMesh(int(party_size), resolve_device(device))


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
