"""Device-resident sparse trainer: params never leave the accelerator.

Counterpart of ``geomx_tpu/trainer_device.py``: the monolithic and the
pipelined round, and the mesh-party round.
The parameters stay on ``device`` as one flat fp32 vector, beside the
BSC buffers u and v and the optional momentum, and each round moves
only:

- down: the per-key BSC-selected (values, indices) of the
  momentum-corrected gradient, with the loss, as ONE packed int32 array;
- up: the aggregated nonzeros from the kv store, as ONE fixed-size
  padded int32 array.

The packed wire is int32: float payloads are reinterpreted int32-wards
(``Tensor.view(torch.int32)``, the counterpart of
``lax.bitcast_convert_type``) and indices ride as native int32, so every
index a flat int32 can address is exact. The direction matters: packing
indices INTO a float32 array makes denormal bit patterns of every index
below 2^23, and float data movement that flushes denormals to zero (as
the TPU's did) would land every scatter on coordinate 0. Integer lanes
never flush.

The local optimizer is SGD (+ momentum) on the aggregated selection;
every worker applies the same update to the same aggregate, so replicas
stay identical without shipping weights. Worker pushes are scaled by
1/num_workers so the aggregate is the mean gradient.

The updates round where XLA rounds them in the JAX package, so both
packages produce the same bits: ``u = 0.9 u + g`` and ``flat - lr * x``
are fused multiply-adds (:func:`_fma`), and the momentum update adds the
aggregate onto the rounded ``momentum * mom``.

Over a mesh-party store (``kvstore.mesh_party``) the trainer drives the
whole party: its state lives once, on the party's device, the batch is
the party's, split over the ranks as ``(P, B/P, ...)``, and the BSC
selection runs on the party-MEAN gradient, so the van carries one
worker's traffic per party. ``num_all_workers`` is then the number of
parties, so the ``g / nw`` scaling matches the wire path's. With
``GEOMX_MESH_CODEC`` "none" the party mean is the gradient of the mean
loss over the whole party batch, one forward and backward pass (the
JAX package's psum of the ranks' shard means; equal up to fp32 rounding).
With "int8", "2bit" or "fp16" each rank takes the gradient of its own
shard's mean loss and the ``(P, n)`` stack goes through one quantized
ring (:func:`parallel.quant_collectives.ring_all_reduce`) whose
error-feedback residual the trainer carries from round to round; the
result over P is the party mean and is identical on every rank.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from geomx_tpu_torch import profiler
from geomx_tpu_torch._device import resolve_device
from geomx_tpu_torch.kvstore.frontier import plan_chunks
from geomx_tpu_torch.ops import _fma
from geomx_tpu_torch.parallel import quant_collectives as qc
from geomx_tpu_torch.parallel.mesh import PartyMesh

__all__ = ["DeviceResidentTrainer"]


class DeviceResidentTrainer:
    def __init__(self, params: Sequence[Any], kvstore,
                 grad_fn: Callable, threshold: float = 0.01,
                 learning_rate: float = 0.01, momentum: float = 0.0,
                 begin_key: int = 0, device=None):
        """``params``: list of array leaves (key of leaf i = ``begin_key +
        i``); ``grad_fn(leaf_list, X, y) -> (loss, grad_leaves)`` takes
        tensors on ``device``. ``device=None`` is the CUDA card, and
        raises without one; pass ``device="cpu"`` for the CPU. Over a
        mesh-party store the device is the party mesh's.

        The local optimizer is SGD on the aggregated selection, as in the
        JAX package: BSC's residual feedback delivers accumulated
        gradients, so plain SGD applies each coordinate's full mass."""
        # mesh-party store: state lives on the party's device, batches
        # split over its "dp" ranks
        self._mesh = getattr(kvstore, "mesh", None)
        if self._mesh is None:
            self.device = resolve_device(device)
        elif not isinstance(self._mesh, PartyMesh):
            # the JAX trainer's mesh rounds raise on every non-global rank
            # (geomx_tpu/trainer_device.py _place_batch), so its round
            # over several processes never completes: refused up front,
            # on every rank
            raise NotImplementedError(
                "DeviceResidentTrainer drives a party from one process "
                "(parallel.mesh.PartyMesh); a party over several processes "
                "trains through parallel.train_step.HierarchicalTrainer")
        else:
            self.device = self._mesh.device
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"device {device} is not the party mesh's "
                                 f"device {self.device}")
        self.kv = kvstore
        self.begin_key = begin_key
        self.threshold = threshold
        self.learning_rate = learning_rate
        self.momentum = momentum
        self._grad_fn = grad_fn

        leaves = [np.asarray(p, np.float32) for p in params]
        self._shapes = [l.shape for l in leaves]
        self._sizes = [int(l.size) for l in leaves]
        self._offsets = np.concatenate(
            [[0], np.cumsum(self._sizes)]).astype(np.int64)
        self.total = int(self._offsets[-1])
        if self.total >= 1 << 31:
            raise ValueError("DeviceResidentTrainer addresses elements "
                             f"with int32: < 2^31 params, got {self.total}")
        # per-key top-k (reference per-tensor BSC: every tensor keeps
        # int(size * threshold) coordinates, minimum 1)
        self._ks = [max(int(sz * threshold), 1) for sz in self._sizes]
        self.k = sum(self._ks)
        self._kofs = np.concatenate([[0], np.cumsum(self._ks)]).astype(
            np.int64)

        self._sparse_wire = (hasattr(self.kv, "push_bsc")
                             and hasattr(self.kv, "pull_bsc"))
        kcfg = getattr(self.kv, "cfg", None)
        # pipelined round (GEOMX_OVERLAP + P3_SLICE_BYTES): keys group in
        # layer order into ~P3_SLICE_BYTES wire-byte chunks (~8 bytes per
        # selected element); each chunk's D2H fetch, async combined round
        # and apply flow independently — chunk i applies while chunk
        # i+1's bytes are still on the wire. 0 = one chunk.
        self._pipeline = (bool(getattr(kcfg, "overlap", False))
                          and self._sparse_wire
                          and hasattr(self.kv, "push_pull_bsc_batch_async"))
        # quantized combined wire: the store ships values as float16;
        # narrow on the device with error feedback into v
        self._wire16 = bool(getattr(kcfg, "wire_codec", ""))

        # kv bootstrap: init + pull once (the only full-weight transfer)
        for i, leaf in enumerate(leaves):
            self.kv.init(begin_key + i, leaf)
        if not getattr(self.kv, "is_master_worker", False):
            for i in range(len(leaves)):
                self.kv.pull(begin_key + i, out=leaves[i])
        self.kv.wait()

        dev = self.device
        self._flat = torch.from_numpy(
            np.concatenate([l.ravel() for l in leaves])).to(dev)
        self._u = torch.zeros(self.total, dtype=torch.float32, device=dev)
        self._v = torch.zeros(self.total, dtype=torch.float32, device=dev)
        self._mom = (torch.zeros(self.total, dtype=torch.float32, device=dev)
                     if momentum else None)
        # scale by the TOTAL worker count across parties
        nw = max(int(getattr(self.kv, "num_all_workers", 0)
                     or getattr(self.kv, "num_workers", 1)), 1)
        self._num_workers = nw
        # the aggregate has <= nw*k nonzeros: the upload is padded to
        # that fixed size
        self._up_cap = nw * self.k
        if self._pipeline:
            self._chunks = plan_chunks(
                list(range(len(self._sizes))), [8 * kk for kk in self._ks],
                int(getattr(kcfg, "p3_slice_bytes", 0)))
            # per chunk: selection range, flat param range, upload cap —
            # chunk key runs are contiguous, so each covers one flat
            # slice [flo, flo+fsize) and the slices partition [0, total)
            meta = []
            for ch in self._chunks:
                a, b = ch.items[0], ch.items[-1]
                sel_lo, sel_hi = int(self._kofs[a]), int(self._kofs[b + 1])
                flo, fhi = int(self._offsets[a]), int(self._offsets[b + 1])
                meta.append((sel_lo, sel_hi, flo, fhi - flo,
                             nw * (sel_hi - sel_lo)))
            self._chunk_meta = meta

        # quantized mesh collective (GEOMX_MESH_CODEC != "none"): the
        # party aggregate goes through the quantized ring, whose
        # error-feedback residual the trainer carries between rounds
        mesh_codec = ((getattr(kcfg, "mesh_codec", "none") or "none")
                      if self._mesh is not None else "none")
        self._mesh_quant = mesh_codec != "none"
        if self._mesh_quant:
            self._mesh_size = int(self._mesh.size)
            self._mesh_codec = mesh_codec
            self._mesh_block = int(getattr(kcfg, "mesh_block", 256) or 256)
            self._mesh_thr = float(getattr(kcfg, "wire_2bit_threshold", 0.5))
            self._mesh_res = self._zero_mesh_res()
            self._mesh_res_stale = threading.Event()
            # abort recovery re-seeds this trainer's residual along with
            # the store-keyed reducers
            if hasattr(self.kv, "register_residual_reset_hook"):
                self.kv.register_residual_reset_hook(
                    self._reset_mesh_residual)

    @property
    def pipelined(self) -> bool:
        """True when rounds run pipelined (GEOMX_OVERLAP with an async
        sparse wire). Setting it False runs the serial round from then on,
        with the same post-round state; True is allowed only where the
        store allowed the pipeline at construction."""
        return self._pipeline

    @pipelined.setter
    def pipelined(self, on: bool) -> None:
        if on and not hasattr(self, "_chunk_meta"):
            raise ValueError("this store has no pipelined round (needs "
                             "GEOMX_OVERLAP and an async sparse wire)")
        self._pipeline = bool(on)

    # -- device steps ----------------------------------------------------

    def _leaf_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [p.view(s) for p, s in
                zip(flat.split(self._sizes), self._shapes)]

    def _grad_cat(self, flat, X, y):
        loss, grads = self._grad_fn(self._leaf_views(flat), X, y)
        return loss, torch.cat([g.reshape(-1) for g in grads])

    def _zero_mesh_res(self) -> torch.Tensor:
        return qc.zero_residual(self._mesh_size, self.total,
                                self._mesh_codec, self._mesh_block,
                                device=self.device)

    def _reset_mesh_residual(self) -> None:
        """Mark the ring's error-feedback streams for re-seeding at zero —
        round aborts must not replay stale error into the retried round.
        It runs on the store's van thread (round_abort_hook) while this
        trainer's thread may be inside a ring, so it only sets a flag:
        the next ring starts from zero."""
        self._mesh_res_stale.set()

    def _party_grad(self, flat, X, y):
        """``(loss, flat gradient)`` of one round: the worker's own, or
        over a mesh-party store the party mean of the ``(P, B/P, ...)``
        batch. The quantized ring advances ``self._mesh_res``."""
        if self._mesh is None:
            return self._grad_cat(flat, X, y)
        if not self._mesh_quant:
            # the party mean: the gradient of the mean loss over the
            # whole party batch (the JAX package's psum of the ranks'
            # shard means)
            return self._grad_cat(
                flat, X.flatten(0, 1), None if y is None else y.flatten(0, 1))
        P = self._mesh_size
        losses, grads = [], []
        for r in range(P):
            loss, g = self._grad_cat(flat, X[r], None if y is None else y[r])
            losses.append(loss.detach().to(torch.float32))
            grads.append(g)
        stack = torch.stack(grads)
        del grads
        if self._mesh_res_stale.is_set():
            self._mesh_res_stale.clear()
            self._mesh_res = self._zero_mesh_res()
        out, self._mesh_res = qc.ring_all_reduce(
            stack, self._mesh_res, size=P, codec=self._mesh_codec,
            block=self._mesh_block, threshold=self._mesh_thr)
        # every rank's row is the same sum; /P restores the party mean
        return torch.stack(losses).sum() / P, out[0] / P

    def _bsc(self, loss, g, u, v):
        """BSC: momentum-corrected accumulation, exact per-key top-k
        (reference: gradient_compression.cc:191-268, per tensor). Returns
        new u and v; the inputs are not modified."""
        u = _fma(u, 0.9, g)
        v = v + u
        vals_parts, idx_parts = [], []
        for off, sz, kk in zip(self._offsets[:-1], self._sizes, self._ks):
            seg = v[int(off):int(off) + sz]
            _mags, ii = torch.topk(seg.abs(), kk)
            vals_parts.append(seg[ii])
            idx_parts.append((ii + int(off)).to(torch.int32))
        vals = torch.cat(vals_parts)
        idx = torch.cat(idx_parts)             # model-flat positions
        lidx = idx.long()
        u[lidx] = 0.0
        if self._wire16:
            narrowed = vals.to(torch.float16).to(torch.float32)
            # selected coordinates keep the narrowing error as their
            # residual; it rides into the next round's accumulation
            v[lidx] = vals - narrowed
            vals = narrowed
        else:
            v[lidx] = 0.0
        return loss, vals, idx, u, v

    def _fwd_compress(self, flat, u, v, X, y):
        """Gradient + BSC select + pack: ``(packed, u, v)`` with packed =
        [loss, vals(K) as int32 bits, idx(K)]."""
        loss, g = self._party_grad(flat, X, y)
        loss, vals, idx, u, v = self._bsc(loss, g / self._num_workers, u, v)
        packed = torch.cat([
            loss.detach().to(torch.float32).reshape(1).view(torch.int32),
            vals.view(torch.int32), idx])
        return packed, u, v

    def _fwd_chunks(self, flat, u, v, X, y):
        """Chunked twin of :meth:`_fwd_compress`: ``(loss, packs, u, v)``
        with one packed int32 array [vals as int32 bits, idx] PER CHUNK,
        so the host can fetch and dispatch each chunk independently."""
        loss, g = self._party_grad(flat, X, y)
        loss, vals, idx, u, v = self._bsc(loss, g / self._num_workers, u, v)
        packs = [torch.cat([vals[lo:hi].view(torch.int32), idx[lo:hi]])
                 for lo, hi, _f, _s, _c in self._chunk_meta]
        return loss.detach().to(torch.float32), packs, u, v

    def _apply_chunk(self, flat, mom, up, flo: int, fsize: int):
        """Sparse SGD (+ momentum) of one chunk's flat slice [flo,
        flo+fsize) from its upload [vals(cap) as int32 bits, idx(cap)
        CHUNK-relative]; the same roundings as :meth:`_apply`, so the
        chunked round's state is bit-identical to the monolithic one.
        Updates ``flat`` and ``mom`` in place and returns them."""
        cap = up.shape[0] // 2
        vals = up[:cap].view(torch.float32)
        cidx = up[cap:].long()
        seg = flat[flo:flo + fsize]
        if mom is None:
            g = torch.zeros_like(seg).index_add_(0, cidx, vals)
            seg.copy_(_fma(g, -self.learning_rate, seg))
            return flat, None
        mseg = mom[flo:flo + fsize]
        mseg.mul_(self.momentum).index_add_(0, cidx, vals)
        seg.copy_(_fma(mseg, -self.learning_rate, seg))
        return flat, mom

    def _apply(self, flat, mom, packed):
        """Sparse SGD (+ momentum) from the packed upload [vals(cap) as
        int32 bits, idx(cap)]; returns new (flat, mom)."""
        m = self._up_cap
        vals = packed[:m].view(torch.float32)
        idx = packed[m:].long()
        # pad slots carry (0.0, idx 0) and add exactly zero, and the
        # aggregate's indices are distinct, so each sum below is exact
        # whatever order CUDA's atomics add in
        if mom is None:
            g = torch.zeros_like(flat).index_add_(0, idx, vals)
            return _fma(g, -self.learning_rate, flat), None
        # momentum * mom, then the aggregate added in: XLA rewrites the
        # JAX package's `momentum * mom + scatter(zeros)` into this form
        mom = (mom * self.momentum).index_add_(0, idx, vals)
        return _fma(mom, -self.learning_rate, flat), mom

    def _to_device(self, X):
        if X is None:
            return None
        return torch.as_tensor(X).to(self.device)

    def _place_batch(self, X, y):
        """The batch on the device; over a mesh-party store split over
        the party's ranks as ``(P, B/P, ...)``."""
        if self._mesh is None:
            return self._to_device(X), self._to_device(y)
        return self.kv.shard_batch(X, y)

    def _count_mesh_round(self) -> None:
        """Account one round's intra-party collective volume (from the
        gradient's shape, tier=mesh, so telemetry.wan_bytes() stays
        honest)."""
        if self._mesh is not None:
            self.kv.count_collective(self.total * 4)

    def _upload(self, ups: np.ndarray, upi: np.ndarray) -> torch.Tensor:
        n = len(ups)
        if n > self._up_cap:
            raise RuntimeError(
                f"aggregated selection ({n}) exceeds the upload capacity "
                f"({self._up_cap}) — is the PS tier running an optimizer? "
                "DeviceResidentTrainer requires aggregator mode")
        up = np.zeros(2 * self._up_cap, np.int32)
        up[:n] = np.asarray(ups, np.float32).view(np.int32)
        up[self._up_cap:self._up_cap + n] = upi.astype(np.int32)
        return torch.from_numpy(up).to(self.device)

    def _unpack(self, packed: np.ndarray):
        loss = float(packed[:1].view(np.float32)[0])
        vals = packed[1:1 + self.k].view(np.float32)
        idx = packed[1 + self.k:].astype(np.int64)
        return loss, vals, idx

    def _kv_round(self, vals, idx):
        if self._sparse_wire:
            return self._kv_round_sparse(vals, idx)
        return self._kv_round_dense(vals, idx)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, X, y) -> None:
        """Run both device steps once WITHOUT a kv round (results
        discarded, trainer state untouched): builds the kernels and warms
        the allocator before the first timed round."""
        X, y = self._place_batch(X, y)
        res = self._mesh_res if self._mesh_quant else None
        self._fwd_compress(self._flat, self._u, self._v, X, y)
        up = torch.zeros(2 * self._up_cap, dtype=torch.int32,
                         device=self.device)
        self._apply(self._flat, self._mom, up)
        if self._pipeline:
            self._fwd_chunks(self._flat, self._u, self._v, X, y)
            for _lo, _hi, flo, fsize, cap in self._chunk_meta:
                up0 = torch.zeros(2 * cap, dtype=torch.int32,
                                  device=self.device)
                # on copies: the chunked apply updates in place
                self._apply_chunk(
                    self._flat.clone(),
                    None if self._mom is None else self._mom.clone(),
                    up0, flo, fsize)
        if self._mesh_quant:
            self._mesh_res = res
        self._sync()

    # -- one round -------------------------------------------------------

    def step(self, X, y) -> float:
        """One FSA round: device grad+compress, kv aggregate, device
        sparse apply. Returns the loss as a host float.

        With the pipelined path active (GEOMX_OVERLAP and an async
        sparse wire) the round runs per chunk — dispatch every chunk's
        fetch+send first, then apply each as its aggregate lands — with
        the same post-round state."""
        X, y = self._place_batch(X, y)
        self._count_mesh_round()
        if self._pipeline:
            return self._step_pipelined(X, y)
        packed_d, self._u, self._v = self._fwd_compress(
            self._flat, self._u, self._v, X, y)
        # ONE compact device->host transfer (1 + 2K int32 vs total)
        loss, vals, idx = self._unpack(packed_d.cpu().numpy())
        ups, upi = self._kv_round(vals, idx)
        # ONE compact fixed-size host->device transfer; apply locally
        self._flat, self._mom = self._apply(self._flat, self._mom,
                                            self._upload(ups, upi))
        return loss

    def _fetch_async(self, packs: List[torch.Tensor]):
        """Start every chunk's D2H copy at once; returns per-chunk
        ``(host tensor, event)`` pairs (event None on the CPU)."""
        if self.device.type != "cuda":
            return [(p, None) for p in packs]
        out = []
        for p in packs:
            h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            h.copy_(p, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            out.append((h, ev))
        return out

    @staticmethod
    def _host(fetched) -> np.ndarray:
        h, ev = fetched
        if ev is not None:
            ev.synchronize()
        return h.numpy()

    def _chunk_wire_parts(self, ci: int, arr: np.ndarray):
        """Split chunk ``ci``'s fetched pack into the per-key wire lists
        (keys, values, KEY-relative indices) push_pull_bsc_batch expects."""
        sel_lo, sel_hi, _flo, _fsize, _cap = self._chunk_meta[ci]
        kc = sel_hi - sel_lo
        vals = arr[:kc].view(np.float32)
        aidx = arr[kc:].astype(np.int64)
        keys, vlist, ilist = [], [], []
        for i in self._chunks[ci].items:
            lo = int(self._kofs[i]) - sel_lo
            hi = int(self._kofs[i + 1]) - sel_lo
            keys.append(self.begin_key + i)
            vlist.append(vals[lo:hi])
            ilist.append(aidx[lo:hi] - int(self._offsets[i]))
        return keys, vlist, ilist

    def _chunk_up(self, ci: int, agg: Dict) -> torch.Tensor:
        """Chunk ``ci``'s fixed-size upload on the device from its keys'
        aggregated (values, key-relative indices): [vals(cap) as int32
        bits, idx(cap) chunk-relative], zero-padded."""
        _sel_lo, _sel_hi, flo, _fsize, cap = self._chunk_meta[ci]
        ups, upi = [], []
        for i in self._chunks[ci].items:
            avals, aidx = agg[self.begin_key + i]
            ups.append(avals)
            upi.append(aidx + (int(self._offsets[i]) - flo))
        cat_v = np.concatenate(ups)
        cat_i = np.concatenate(upi)
        n = len(cat_v)
        if n > cap:
            raise RuntimeError(
                f"aggregated selection ({n}) exceeds chunk upload "
                f"capacity ({cap}) — is the PS tier running an "
                "optimizer? DeviceResidentTrainer requires aggregator "
                "mode")
        up = np.zeros(2 * cap, np.int32)
        up[:n] = np.asarray(cat_v, np.float32).view(np.int32)
        up[cap:cap + n] = cat_i.astype(np.int32)
        return torch.from_numpy(up).to(self.device)

    def _step_pipelined(self, X, y) -> float:
        """Chunked overlapped round: fetch+dispatch every chunk in layer
        order (priority -chunk), then apply each chunk's aggregate as it
        arrives. Chunk flat ranges partition [0, total) and the
        arithmetic per coordinate is that of the monolithic apply, so
        the post-round state is bit-identical to the serial path."""
        loss_d, packs, self._u, self._v = self._fwd_chunks(
            self._flat, self._u, self._v, X, y)
        fetched = self._fetch_async(packs)
        futs = []
        for ci in range(len(self._chunks)):
            with profiler.chunk_scope("fetch", ci):
                arr = self._host(fetched[ci])
            keys, vlist, ilist = self._chunk_wire_parts(ci, arr)
            # slice_bytes=0: this call IS one chunk — one message per
            # server, the store must not re-slice it
            futs.append(self.kv.push_pull_bsc_batch_async(
                keys, vlist, ilist, priority=-ci, slice_bytes=0))
        # the loss fetch rides behind the dispatches (the wire is
        # already flying when this waits on the device)
        loss = float(loss_d)
        for ci, fut in enumerate(futs):
            agg = fut.results()
            up = self._chunk_up(ci, agg)
            _sel_lo, _sel_hi, flo, fsize, _cap = self._chunk_meta[ci]
            with profiler.chunk_scope("apply", ci):
                self._flat, self._mom = self._apply_chunk(
                    self._flat, self._mom, up, flo, fsize)
        return loss

    def step_timed(self, X, y) -> Tuple[float, Dict[str, float]]:
        """One round with a per-phase wall-ms breakdown (compute / d2h /
        wire / h2d / apply), each phase fenced by a synchronise or a
        value fetch. Phases run serially, the pipelined round's chunks
        included, so each bucket is attributable. Audit tool, not the
        training loop."""
        X, y = self._place_batch(X, y)
        self._count_mesh_round()
        if self._pipeline:
            return self._step_timed_pipelined(X, y)
        t0 = time.perf_counter()
        packed_d, self._u, self._v = self._fwd_compress(
            self._flat, self._u, self._v, X, y)
        self._sync()
        t1 = time.perf_counter()
        loss, vals, idx = self._unpack(packed_d.cpu().numpy())
        t2 = time.perf_counter()
        ups, upi = self._kv_round(vals, idx)
        t3 = time.perf_counter()
        up_d = self._upload(ups, upi)
        self._sync()
        t4 = time.perf_counter()
        self._flat, self._mom = self._apply(self._flat, self._mom, up_d)
        self._sync()
        t5 = time.perf_counter()
        return loss, {
            "compute_ms": (t1 - t0) * 1e3,
            "d2h_ms": (t2 - t1) * 1e3,
            "wire_ms": (t3 - t2) * 1e3,
            "h2d_ms": (t4 - t3) * 1e3,
            "apply_ms": (t5 - t4) * 1e3,
        }

    def _step_timed_pipelined(self, X, y):
        t0 = time.perf_counter()
        loss_d, packs, self._u, self._v = self._fwd_chunks(
            self._flat, self._u, self._v, X, y)
        loss = float(loss_d)                  # value fetch = fence
        t1 = time.perf_counter()
        arrs = [p.cpu().numpy() for p in packs]
        t2 = time.perf_counter()
        futs = [self.kv.push_pull_bsc_batch_async(
                    *self._chunk_wire_parts(ci, arrs[ci]),
                    priority=-ci, slice_bytes=0)
                for ci in range(len(self._chunks))]
        aggs = [f.results() for f in futs]
        t3 = time.perf_counter()
        ups = [self._chunk_up(ci, aggs[ci])
               for ci in range(len(self._chunks))]
        self._sync()
        t4 = time.perf_counter()
        for ci, up in enumerate(ups):
            _sl, _sh, flo, fsize, _cap = self._chunk_meta[ci]
            self._flat, self._mom = self._apply_chunk(
                self._flat, self._mom, up, flo, fsize)
        self._sync()
        t5 = time.perf_counter()
        return loss, {
            "compute_ms": (t1 - t0) * 1e3,
            "d2h_ms": (t2 - t1) * 1e3,
            "wire_ms": (t3 - t2) * 1e3,
            "h2d_ms": (t4 - t3) * 1e3,
            "apply_ms": (t5 - t4) * 1e3,
        }

    # -- host-side kv round ----------------------------------------------

    def _kv_round_sparse(self, vals: np.ndarray, idx: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Element-sparse round: O(k_i) bytes and host work per key,
        batched to one message per server per direction when the store
        supports it. The selection is per-key contiguous (segment i
        covers kofs[i]:kofs[i+1]), so partitioning is slicing."""
        n = len(self._sizes)
        keys = [self.begin_key + i for i in range(n)]
        segs = [(int(self._kofs[i]), int(self._kofs[i + 1]),
                 int(self._offsets[i])) for i in range(n)]
        if hasattr(self.kv, "push_pull_bsc_batch"):
            agg = self.kv.push_pull_bsc_batch(
                keys, [vals[lo:hi] for lo, hi, _ in segs],
                [idx[lo:hi] - off for lo, hi, off in segs])()
            ups = [agg[k][0] for k in keys]
            upi = [agg[k][1] + off
                   for k, (_, _, off) in zip(keys, segs)]
            return np.concatenate(ups), np.concatenate(upi)
        if hasattr(self.kv, "push_bsc_batch"):
            self.kv.push_bsc_batch(
                keys, [vals[lo:hi] for lo, hi, _ in segs],
                [idx[lo:hi] - off for lo, hi, off in segs])
            agg = self.kv.pull_bsc_batch(keys)()
            ups = [agg[k][0] for k in keys]
            upi = [agg[k][1] + off
                   for k, (_, _, off) in zip(keys, segs)]
            return np.concatenate(ups), np.concatenate(upi)
        handles = []
        for i, (lo, hi, off) in enumerate(segs):
            self.kv.push_bsc(keys[i], vals[lo:hi], idx[lo:hi] - off,
                             priority=-i)
            handles.append((i, self.kv.pull_bsc(keys[i], priority=-i)))
        ups, upi = [], []
        for i, join in handles:
            avals, aidx = join()
            ups.append(avals)
            upi.append(aidx + int(self._offsets[i]))
        return np.concatenate(ups), np.concatenate(upi)

    def _kv_round_dense(self, vals: np.ndarray, idx: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense round for stores without the sparse wire (e.g. the
        in-process "local" store): scatter each key's selection into a
        dense buffer, push/pull, gather nonzeros."""
        ups, upi = [], []
        for i, (off, sz) in enumerate(zip(self._offsets[:-1],
                                          self._sizes)):
            lo, hi = int(self._kofs[i]), int(self._kofs[i + 1])
            dense = np.zeros(sz, np.float32)
            dense[idx[lo:hi] - off] = vals[lo:hi]
            key = self.begin_key + i
            self.kv.push(key, dense.reshape(self._shapes[i]), priority=-i)
            out = np.zeros(self._shapes[i], np.float32)
            self.kv.pull(key, out=out, priority=-i)
            ups.append(out)
            upi.append(off)
        self.kv.wait()
        cat_v, cat_i = [], []
        for out, off in zip(ups, upi):
            flat = out.ravel()
            nz = np.nonzero(flat)[0]
            cat_v.append(flat[nz].astype(np.float32))
            cat_i.append(nz + off)
        return np.concatenate(cat_v), np.concatenate(cat_i)

    # -- escape hatch ----------------------------------------------------

    @property
    def leaves(self) -> List[np.ndarray]:
        """Current params on host (ONE transfer) — for eval or
        checkpointing, not the training loop."""
        flat = self._flat.cpu().numpy()
        return [flat[o:o + s].reshape(sh) for o, s, sh in
                zip(self._offsets[:-1], self._sizes, self._shapes)]
