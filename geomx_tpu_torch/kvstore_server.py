"""Blocking server loop for the infrastructure roles of a HiPS topology.

Counterpart of ``geomx_tpu/kvstore_server.py``. A process whose
``DMLC_ROLE`` / ``DMLC_ROLE_GLOBAL`` marks it as a server, scheduler,
global server or global scheduler enters the server loop and exits when
the system shuts down (reference: python/mxnet/kvstore_server.py:30-90).
The JAX package enters the loop inside ``import geomx_tpu``; the port
enters it only when run as a module, so importing the package never
blocks:

    DMLC_ROLE=server ... python -m geomx_tpu_torch.kvstore_server

Workers and non-distributed processes return at once.
"""

from __future__ import annotations

import os
import sys

from geomx_tpu_torch import config as cfg_mod


def _run_scheduler(is_global: bool) -> None:
    from geomx_tpu_torch.ps import base as psbase
    from geomx_tpu_torch.ps.message import Role
    from geomx_tpu_torch.ps.postoffice import Postoffice

    c = cfg_mod.load()
    if is_global:
        po = Postoffice(
            my_role=Role.SCHEDULER, is_global=True,
            root_uri=c.ps_global_root_uri, root_port=c.ps_global_root_port,
            num_workers=c.num_global_workers, num_servers=c.num_global_servers,
            cfg=c,
        )
    else:
        po = Postoffice(
            my_role=Role.SCHEDULER, is_global=False,
            root_uri=c.ps_root_uri, root_port=c.ps_root_port,
            num_workers=c.num_workers, num_servers=c.num_servers, cfg=c,
        )
    po.start(timeout=600.0)
    try:
        # startup barrier (round 1 of the two ALL-group rounds)
        po.barrier(psbase.ALL_GROUP, timeout=600.0)
        # exit barrier: completes when every member finalizes
        po.barrier(psbase.ALL_GROUP, timeout=24 * 3600.0)
    except (TimeoutError, OSError):
        pass
    po.van.stop()


def _init_kvstore_server_module() -> None:
    if os.environ.get("GEOMX_NO_SERVER_LOOP"):
        return  # tests drive the server objects directly
    c = cfg_mod.load()
    if c.is_global_scheduler and not c.role:
        _run_scheduler(is_global=True)
        sys.exit(0)
    if c.is_scheduler:
        _run_scheduler(is_global=False)
        sys.exit(0)
    if c.is_server:
        from geomx_tpu_torch.kvstore.server import KVStoreDistServer

        KVStoreDistServer(c).run()
        sys.exit(0)
    # workers and non-distributed processes fall through to user code


if __name__ == "__main__":
    _init_kvstore_server_module()
