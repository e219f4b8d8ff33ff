"""geomx_tpu_torch.parallel — the intra-party tier.

Counterpart of ``geomx_tpu/parallel``. Ported so far: the party mesh,
its placements and the ring helpers (``mesh``), the quantized ring
all-reduce (``quant_collectives``), ``DataParallelTrainer`` and
``HierarchicalTrainer`` (``train_step``).
FSDP, pipeline, gradient accumulation and ring attention are still to
port (ROADMAP queue A item 10).
"""

from geomx_tpu_torch.parallel.mesh import (  # noqa: F401
    PartyMesh, make_party_mesh, party_devices, ring_chunk_layout, ring_perm)
from geomx_tpu_torch.parallel.quant_collectives import (  # noqa: F401
    QuantRingReducer, make_quant_all_reduce, ring_all_reduce)
from geomx_tpu_torch.parallel.train_step import (  # noqa: F401
    DataParallelTrainer, HierarchicalTrainer)
