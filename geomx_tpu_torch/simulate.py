"""In-process pseudo-distributed HiPS topologies.

Counterpart of ``geomx_tpu/simulate.py``. Because the Postoffice and Van
are instance-scoped (no process-global singletons, unlike ps-lite), a
whole multi-party HiPS cluster runs inside ONE process on threads —
every protocol byte still crosses real loopback sockets through the real
transport. The infrastructure roles run on CPU threads; the party
workers' compute runs wherever their trainers put it (the CUDA card by
default, so two workers of one process share the card).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, List, Optional

from geomx_tpu_torch.config import Config
from geomx_tpu_torch.kvstore.dist import KVStoreDist
from geomx_tpu_torch.kvstore.mesh_party import KVStorePartyMesh
from geomx_tpu_torch.kvstore.server import KVStoreDistServer
from geomx_tpu_torch.ps import base as psbase
from geomx_tpu_torch.ps.message import Role
from geomx_tpu_torch.parallel.mesh import make_party_mesh
from geomx_tpu_torch.ps.postoffice import Postoffice

__all__ = ["free_port", "InProcessHiPS"]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class InProcessHiPS:
    """A live HiPS cluster on threads: a central party (global scheduler,
    ``num_global_servers`` global servers, master worker, scheduler) plus
    ``num_parties`` data parties of (scheduler, ``servers_per_party``
    servers, ``workers_per_party`` workers).

    ``start()`` returns once every KVStore constructed; ``workers`` holds
    the party workers (rank-ordered per party), ``master`` the master
    worker. ``stop()`` runs the full shutdown cascade and re-raises any
    node's error.

    ``party_mesh_size`` > 0 runs the mesh-party tier: each party's
    workers collapse into ONE :class:`KVStorePartyMesh` over a party mesh
    of that many ranks on ``device`` (None: the CUDA card; every party's
    mesh shares it), so ``workers`` holds one store per party.
    """

    def __init__(self, num_parties: int = 2, workers_per_party: int = 1,
                 num_global_servers: int = 1, servers_per_party: int = 1,
                 sync_global: bool = True, use_hfa: bool = False,
                 hfa_k2: int = 1, enable_central_worker: bool = False,
                 bigarray_bound: int = 1_000_000,
                 party_mesh_size: int = 0,
                 extra_cfg: Optional[dict] = None,
                 per_party_cfg: Optional[dict] = None, device=None):
        self.gport = free_port()
        self.cports = [free_port() for _ in range(num_parties + 1)]
        self.num_parties = num_parties
        self.wpp = workers_per_party
        # mesh-party tier (kvstore.mesh_party): each party's workers
        # collapse into ONE KVStorePartyMesh over a party mesh of
        # ``party_mesh_size`` ranks on ``device`` — the van sees one worker
        # per party, intra-party aggregation runs on the device
        self.pms = int(party_mesh_size)
        self.van_wpp = 1 if self.pms > 0 else self.wpp
        self.device = device
        if self.pms > 0 and int((extra_cfg or {}).get(
                "mesh_num_processes", 0)) > 1:
            raise NotImplementedError(
                "an in-process topology runs its parties' ranks on threads "
                "of one process, and threads of one process cannot be "
                "several ranks of a process group; a party over several "
                "processes runs as processes (scripts/hips_env.sh "
                "MESH_PROCS)")
        self.ngs = num_global_servers
        # servers_per_party: an int (uniform) or a per-party list —
        # non-uniform topologies need cfg.num_parties for exact FSA
        # counting (set automatically below)
        if isinstance(servers_per_party, int):
            self.spp_list = [servers_per_party] * num_parties
        else:
            self.spp_list = list(servers_per_party)
            assert len(self.spp_list) == num_parties
        self.spp = self.spp_list[0]
        self.ngw = sum(self.spp_list)
        # in mesh mode the global tier sums one aggregate per party, so
        # the cross-party trainer count the wire scaling sees is the
        # party count, not members x parties
        self.num_all = (num_parties if self.pms > 0
                        else num_parties * workers_per_party)
        self.bigarray_bound = bigarray_bound
        self.use_hfa = use_hfa
        self.hfa_k2 = hfa_k2
        self.ecw = enable_central_worker
        self.sync_global = sync_global
        self.extra_cfg = dict(extra_cfg or {})
        # per-party Config overrides (party index -> dict), layered on
        # top of extra_cfg for that party's servers AND workers — the
        # heterogeneous-WAN chaos cases give each party its own wire
        # codec / fault plan while the shape plan stays cluster-wide
        self.per_party_cfg = {int(k): dict(v)
                              for k, v in (per_party_cfg or {}).items()}
        self.threads: List[threading.Thread] = []
        self.servers: List[KVStoreDistServer] = []
        self.workers: List[KVStoreDist] = []
        self.master: Optional[KVStoreDist] = None
        self.errors: List[BaseException] = []

    # -- wiring ----------------------------------------------------------

    def _common(self, party: Optional[int] = None, **kw) -> Config:
        base = dict(
            ps_global_root_uri="127.0.0.1", ps_global_root_port=self.gport,
            num_global_workers=self.ngw, num_global_servers=self.ngs,
            num_parties=(self.num_parties
                         if len(set(self.spp_list)) > 1 else 0),
            num_all_workers=self.num_all, use_hfa=self.use_hfa,
            hfa_k2=self.hfa_k2, enable_central_worker=self.ecw,
            bigarray_bound=self.bigarray_bound,
        )
        base.update(self.extra_cfg)
        if party is not None:
            base.update(self.per_party_cfg.get(party, {}))
        base.update(kw)
        return Config(**base)

    def _spawn(self, fn: Callable, *args) -> None:
        def runner():
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 — surfaced in stop()
                self.errors.append(e)

        t = threading.Thread(target=runner, daemon=True)
        t.start()
        self.threads.append(t)

    def _run_sched(self, root_port: int, is_global: bool, nw: int,
                   ns: int) -> None:
        po = Postoffice(
            my_role=Role.SCHEDULER, is_global=is_global,
            root_uri="127.0.0.1", root_port=root_port,
            num_workers=nw, num_servers=ns, cfg=Config(**self.extra_cfg),
        )
        po.start(60.0)
        po.barrier(psbase.ALL_GROUP, timeout=120.0)    # startup round
        po.barrier(psbase.ALL_GROUP, timeout=600.0)    # exit round
        po.van.stop()

    def start(self, sync_global: Optional[bool] = None) -> "InProcessHiPS":
        """Start the topology; retries with FRESH ports on bind/startup
        failure — free_port() probes are inherently racy against other
        processes grabbing the port between probe and bind."""
        if sync_global is not None:
            self.sync_global = sync_global
        last: Optional[BaseException] = None
        for attempt in range(3):
            try:
                return self._start_once()
            except (OSError, TimeoutError) as e:
                last = e
                # abandon the half-started attempt (daemon threads) and
                # re-roll every port; a fresh errors list detaches the
                # old attempt's late failures
                self.threads = []
                self.servers = []
                self.errors = []
                self.gport = free_port()
                self.cports = [free_port()
                               for _ in range(self.num_parties + 1)]
        raise last

    def _start_once(self) -> "InProcessHiPS":
        self._spawn(self._run_sched, self.gport, True, self.ngw, self.ngs)
        self._spawn(self._run_sched, self.cports[0], False, 1, self.ngs)
        for _ in range(self.ngs):
            cfg = self._common(
                role="server", role_global="global_server",
                ps_root_uri="127.0.0.1", ps_root_port=self.cports[0],
                num_workers=1, num_servers=self.ngs,
            )
            srv = KVStoreDistServer(cfg)
            self.servers.append(srv)
            self._spawn(srv.run)
        worker_boxes = []
        for p in range(self.num_parties):
            port = self.cports[p + 1]
            spp = self.spp_list[p]
            self._spawn(self._run_sched, port, False, self.van_wpp, spp)
            for _ in range(spp):
                cfg = self._common(
                    party=p, role="server",
                    ps_root_uri="127.0.0.1", ps_root_port=port,
                    num_workers=self.van_wpp, num_servers=spp,
                )
                srv = KVStoreDistServer(cfg)
                self.servers.append(srv)
                self._spawn(srv.run)
            if self.pms > 0:
                # mesh party: ONE van worker — the party's global worker —
                # driving a party mesh of ``pms`` ranks
                wcfg = self._common(
                    party=p, role="worker", party_mesh=True,
                    party_mesh_size=self.pms,
                    ps_root_uri="127.0.0.1", ps_root_port=port,
                    num_workers=1, num_servers=spp,
                )
                mesh = make_party_mesh(self.pms, p, device=self.device)
                box: list = []
                worker_boxes.append(box)
                self._spawn(lambda b=box, c=wcfg, m=mesh: b.append(
                    KVStorePartyMesh(sync_global=self.sync_global,
                                     cfg=c, mesh=m)))
                continue
            for _ in range(self.wpp):
                wcfg = self._common(
                    party=p, role="worker",
                    ps_root_uri="127.0.0.1", ps_root_port=port,
                    num_workers=self.wpp, num_servers=spp,
                )
                box: list = []
                worker_boxes.append(box)
                self._spawn(lambda b=box, c=wcfg: b.append(
                    KVStoreDist(sync_global=self.sync_global, cfg=c)))
        mcfg = self._common(
            role="worker", is_master_worker=True,
            ps_root_uri="127.0.0.1", ps_root_port=self.cports[0],
            num_workers=1, num_servers=self.ngs,
        )
        mbox: list = []
        self._spawn(lambda: mbox.append(
            KVStoreDist(sync_global=self.sync_global, cfg=mcfg)))
        # startup budget scales with topology size: a 64-party cluster
        # on few cores legitimately takes minutes to rendezvous
        for _ in range(1200 + 100 * self.num_parties):
            if self.errors:
                raise self.errors[0]
            if len(mbox) == 1 and all(len(b) == 1 for b in worker_boxes):
                break
            threading.Event().wait(0.1)
        if len(mbox) != 1 or not all(len(b) == 1 for b in worker_boxes):
            raise TimeoutError("in-process topology failed to start")
        self.master = mbox[0]
        self.workers = [b[0] for b in worker_boxes]
        return self

    def run_workers(self, fn: Callable[[KVStoreDist], None],
                    include_master: Optional[Callable] = None,
                    timeout: float = 600.0) -> None:
        """Run ``fn(kv)`` concurrently on every party worker (each node
        acts independently in production; tests/benches must too)."""
        errs: List[BaseException] = []

        def wrap(f, *a):
            try:
                f(*a)
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        fns = [(fn, kv) for kv in self.workers]
        if include_master is not None:
            fns.append((include_master, self.master))
        ts = [threading.Thread(target=wrap, args=(f, *a), daemon=True)
              for f, *a in fns]
        deadline = time.monotonic() + timeout
        for t in ts:
            t.start()
        for t in ts:
            # one SHARED deadline: sequential joins must not stack into
            # N x timeout when several workers hang
            t.join(max(deadline - time.monotonic(), 0.0))
        if errs:
            raise errs[0]
        hung = sum(t.is_alive() for t in ts)
        if hung:
            raise TimeoutError(
                f"{hung} worker(s) still running after {timeout}s")

    def stop(self) -> None:
        closers = [w for w in self.workers]
        if self.master is not None:
            closers.append(self.master)
        errs: List[BaseException] = []

        def close(kv):
            try:
                kv.close()
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=close, args=(kv,), daemon=True)
              for kv in closers]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        for t in self.threads:
            t.join(30)
        if self.errors:
            raise self.errors[0]
        if errs:
            raise errs[0]
