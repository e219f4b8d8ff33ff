"""geomx_tpu_torch.parallel — device-mesh parallelism.

Counterpart of ``geomx_tpu/parallel``: the named-axis mesh and the party
mesh with their placements and ring helpers (``mesh``), the quantized
ring all-reduce (``quant_collectives``), ``DataParallelTrainer`` and
``HierarchicalTrainer`` (``train_step``), ring attention over "sp"
(``ring_attention``), gradient accumulation (``grad_accum``), the GPipe
pipeline over "pp" (``pipeline``) and FSDP over "dp" (``fsdp``). Every
rank of a mesh shares one card (see ``mesh``), except a party's over
processes (``ProcessPartyMesh``: one rank per process of a
``torch.distributed`` group).
"""

from geomx_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, PartyMesh, ProcessPartyMesh, Sharded, make_mesh, make_party_mesh,
    mesh_shape_for, party_devices, ring_chunk_layout, ring_perm, shard)
from geomx_tpu_torch.parallel.quant_collectives import (  # noqa: F401
    QuantRingReducer, make_quant_all_reduce, ring_all_reduce)
from geomx_tpu_torch.parallel.train_step import (  # noqa: F401
    DataParallelTrainer, HierarchicalTrainer)
from geomx_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_ring_attention)
from geomx_tpu_torch.parallel.grad_accum import (  # noqa: F401
    accumulate_gradients)
from geomx_tpu_torch.parallel.pipeline import make_pipeline_fn  # noqa: F401
from geomx_tpu_torch.parallel.fsdp import (  # noqa: F401
    FSDPTrainer, fsdp_shardings, fsdp_spec)
