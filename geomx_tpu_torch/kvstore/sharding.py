"""Key -> server assignment and big-array splitting.

Re-implements the reference's EncodeDefaultKey heuristics (reference:
src/kvstore/kvstore_dist.h:725-816): arrays smaller than
MXNET_KVSTORE_BIGARRAY_BOUND go whole to one server chosen by
``(key * 9973) % num_servers``; larger arrays are split evenly across all
servers. Used identically at both tiers (worker->local servers and
local server->global servers) — the MultiGPS central-party trick (master
worker's local servers ARE the global servers, scripts/cpu/run_multi_gps.sh)
requires the two tiers' shardings to agree when server counts match.

Unlike the reference (positional wire-key ranges), shards carry explicit
(offset, total) element addressing — see ps.kv_app.KVPairs.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class Shard:
    server_rank: int
    offset: int   # element offset into the flat key
    length: int   # element count of this shard
    total: int    # total element count of the key


def assign(key: int, num_elems: int, num_servers: int, bigarray_bound: int) -> List[Shard]:
    """Shard a key across servers (reference: kvstore_dist.h:739-762)."""
    if num_servers <= 1 or num_elems < bigarray_bound:
        rank = (key * 9973) % max(num_servers, 1)
        return [Shard(rank, 0, num_elems, num_elems)]
    shards = []
    base_len = num_elems // num_servers
    rem = num_elems % num_servers
    off = 0
    for rank in range(num_servers):
        ln = base_len + (1 if rank < rem else 0)
        if ln == 0:
            continue
        shards.append(Shard(rank, off, ln, num_elems))
        off += ln
    return shards


def split_slices(shards: List[Shard], slice_elems: int) -> List[Shard]:
    """Cut shards into at-most-``slice_elems`` pieces, keeping placement.

    Unlike :func:`assign_p3` (which re-derives placement with the slice
    bound as the bigarray bound), this refines an EXISTING assignment:
    server ranks and outer boundaries are untouched, so it is safe to
    apply to one side of the wire only — a peer still addressing the
    coarse ranges overlaps a contiguous run of the fine ones.
    """
    if slice_elems <= 0:
        return shards
    out: List[Shard] = []
    for sh in shards:
        if sh.length <= slice_elems:
            out.append(sh)
            continue
        off, end = sh.offset, sh.offset + sh.length
        while off < end:
            ln = min(slice_elems, end - off)
            out.append(Shard(sh.server_rank, off, ln, sh.total))
            off += ln
    return out


def assign_p3(key: int, num_elems: int, num_servers: int,
              slice_bound: int) -> List[Shard]:
    """P3 slicing (reference: P3_EncodeDefaultKey, kvstore_dist.h:768-805).

    Each canonical shard (from :func:`assign`, so server placement agrees
    with the server-side canonical ranges) is cut into slices of at most
    ``slice_bound`` elements. Each slice travels as its own message, so the
    worker van's priority send queue can let a later (higher-priority,
    needed-sooner-on-the-next-forward) layer's small slices overtake an
    earlier layer's bulk — the essence of P3's slicing + priority
    scheduling. (The reference round-robins slices over servers because its
    wire-key encoding makes every slice its own key; our servers validate
    explicit offsets against canonical ranges, so slices must stay inside
    their canonical shard.)
    """
    bound = max(slice_bound, 1)
    shards: List[Shard] = []
    for base_shard in assign(key, num_elems, num_servers, slice_bound):
        off = base_shard.offset
        end = base_shard.offset + base_shard.length
        while off < end or (off == end and base_shard.length == 0):
            ln = min(bound, end - off)
            shards.append(Shard(base_shard.server_rank, off, ln, num_elems))
            off += ln
            if base_shard.length == 0:
                break
    return shards
