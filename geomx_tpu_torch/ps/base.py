"""Node-id scheme and group constants.

Follows the ps-lite convention (reference:
3rdparty/ps-lite/include/ps/base.h and postoffice.h:104-116): the scheduler
is node 1; ids 1..7 are group bitmasks; real nodes start at 8 with servers
on even ids and workers on odd ids. The reference offsets its *local* tier
ids by 100 so the two overlays can share one process without id collisions;
we instead keep two fully separate Postoffice instances per process, so both
tiers use the canonical scheme.
"""

from __future__ import annotations

from typing import List

SCHEDULER = 1
SERVER_GROUP = 2
WORKER_GROUP = 4
SERVER_GROUP_AND_SCHEDULER = SERVER_GROUP + SCHEDULER
WORKER_GROUP_AND_SCHEDULER = WORKER_GROUP + SCHEDULER
WORKER_SERVER_GROUP = WORKER_GROUP + SERVER_GROUP
ALL_GROUP = WORKER_GROUP + SERVER_GROUP + SCHEDULER

FIRST_NODE_ID = 8


def server_rank_to_id(rank: int) -> int:
    return 8 + 2 * rank


def worker_rank_to_id(rank: int) -> int:
    return 9 + 2 * rank


def id_to_rank(node_id: int) -> int:
    return (node_id - 8) // 2


def is_server_id(node_id: int) -> bool:
    return node_id >= 8 and node_id % 2 == 0


def is_worker_id(node_id: int) -> bool:
    return node_id >= 8 and node_id % 2 == 1


def is_group(node_id: int) -> bool:
    return 0 < node_id < 8


def expand_group(group_id: int, num_workers: int, num_servers: int) -> List[int]:
    """Expand a group bitmask into concrete node ids."""
    ids: List[int] = []
    if group_id & SCHEDULER:
        ids.append(SCHEDULER)
    if group_id & SERVER_GROUP:
        ids.extend(server_rank_to_id(r) for r in range(num_servers))
    if group_id & WORKER_GROUP:
        ids.extend(worker_rank_to_id(r) for r in range(num_workers))
    return ids
