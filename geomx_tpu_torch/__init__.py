"""geomx_tpu_torch — the PyTorch / CUDA port of geomx_tpu.

A second package beside the JAX one, held against it by tests that feed
both the same inputs. It imports torch and never jax, flax or geomx_tpu.
Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); without a card, ``device=None`` raises.

Ported so far: the single-process kv store, the transformer with
FlashAttention-2 as CUDA kernels, and the device-resident BSC trainer
(slice 1); the WAN codecs (``compression``), the device compression ops
with the 2-bit quantize as a CUDA kernel (``ops``), and the intra-party
tier's quantized ring all-reduce and ``DataParallelTrainer``
(``parallel``) (slice 2); the HiPS tiers (``ps``, the ``dist*`` stores,
``simulate.InProcessHiPS``), the trainer's pipelined round, LeNet and its
data (slice 5); the server-side optimizers (``optimizer``,
``lr_scheduler``) and the BASELINE.md feature configs as examples
(slice 6); the mesh-party tier (``kvstore.mesh_party``, the "nccl" store,
``Trainer``, ``HierarchicalTrainer`` and the device trainer's mesh round)
(slice 7). Unlike ``import geomx_tpu``, importing this package never
enters the server loop: infrastructure roles run
``python -m geomx_tpu_torch.kvstore_server``.
"""

__version__ = "0.1.0"

from geomx_tpu_torch import kvstore as kv  # noqa: F401  (mirrors mx.kv)
from geomx_tpu_torch import compression  # noqa: F401
from geomx_tpu_torch import lr_scheduler  # noqa: F401
from geomx_tpu_torch import optimizer  # noqa: F401
from geomx_tpu_torch import models  # noqa: F401
from geomx_tpu_torch import ops  # noqa: F401
from geomx_tpu_torch.kvstore import create  # noqa: F401
from geomx_tpu_torch.trainer import Trainer  # noqa: F401
from geomx_tpu_torch.trainer_device import DeviceResidentTrainer  # noqa: F401
