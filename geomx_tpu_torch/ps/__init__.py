"""geomx_tpu_torch.ps — the process-level distributed substrate (the "post office").

A ground-up, TPU-era re-design of the role ps-lite plays in the reference
(3rdparty/ps-lite): node rendezvous, dual-tier overlays (intra-DC "local"
tier and inter-DC "global" tier), request/response tracking, barriers,
heartbeats, and the KVWorker/KVServer application layer.

Differences from the reference by design:
- Transport is a framed-TCP van (Python threads or the native C++ core in
  ``geomx_tpu_torch/native``) instead of ZeroMQ; the wire format is fixed
  little-endian framing + JSON meta so both vans interoperate.
- Intra-DC *device-level* aggregation never touches this layer at all — it
  lowers to XLA collectives inside the jitted train step (see
  ``geomx_tpu_torch.parallel``). The ps layer carries host-level traffic only.
"""

from geomx_tpu_torch.ps.message import (  # noqa: F401
    Control,
    Message,
    Meta,
    Node,
)
from geomx_tpu_torch.ps.postoffice import Postoffice  # noqa: F401
from geomx_tpu_torch.ps.kv_app import KVWorker, KVServer, KVPairs  # noqa: F401
