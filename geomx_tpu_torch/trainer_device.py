"""Device-resident sparse trainer: params never leave the accelerator.

Counterpart of ``geomx_tpu/trainer_device.py`` (monolithic round). The
parameters stay on ``device`` as one flat fp32 vector, beside the BSC
buffers u and v and the optional momentum, and each round moves only:

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
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from geomx_tpu_torch._device import resolve_device
from geomx_tpu_torch.ops import _fma

__all__ = ["DeviceResidentTrainer"]


class DeviceResidentTrainer:
    def __init__(self, params: Sequence[Any], kvstore,
                 grad_fn: Callable, threshold: float = 0.01,
                 learning_rate: float = 0.01, momentum: float = 0.0,
                 begin_key: int = 0, device=None):
        """``params``: list of array leaves (key of leaf i = ``begin_key +
        i``); ``grad_fn(leaf_list, X, y) -> (loss, grad_leaves)`` takes
        tensors on ``device``. ``device=None`` is the CUDA card, and
        raises without one; pass ``device="cpu"`` for the CPU.

        The local optimizer is SGD on the aggregated selection, as in the
        JAX package: BSC's residual feedback delivers accumulated
        gradients, so plain SGD applies each coordinate's full mass."""
        self.device = resolve_device(device)
        self.kv = kvstore
        self.begin_key = begin_key
        self.threshold = threshold
        self.learning_rate = learning_rate
        self.momentum = momentum
        self._grad_fn = grad_fn
        if getattr(kvstore, "mesh", None) is not None:
            raise NotImplementedError(
                "mesh-party stores need the intra-party tier, not ported "
                "yet (ROADMAP queue A item 9)")

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
        if (bool(getattr(kcfg, "overlap", False)) and self._sparse_wire
                and hasattr(self.kv, "push_pull_bsc_batch_async")):
            raise NotImplementedError(
                "the pipelined round (GEOMX_OVERLAP) needs the HiPS host "
                "layers, not ported yet (ROADMAP queue A item 3)")
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

    # -- device steps ----------------------------------------------------

    def _leaf_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [p.view(s) for p, s in
                zip(flat.split(self._sizes), self._shapes)]

    def _grad_cat(self, flat, X, y):
        loss, grads = self._grad_fn(self._leaf_views(flat), X, y)
        return loss, torch.cat([g.reshape(-1) for g in grads])

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
        loss, g = self._grad_cat(flat, X, y)
        loss, vals, idx, u, v = self._bsc(loss, g / self._num_workers, u, v)
        packed = torch.cat([
            loss.detach().to(torch.float32).reshape(1).view(torch.int32),
            vals.view(torch.int32), idx])
        return packed, u, v

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
        X, y = self._to_device(X), self._to_device(y)
        self._fwd_compress(self._flat, self._u, self._v, X, y)
        up = torch.zeros(2 * self._up_cap, dtype=torch.int32,
                         device=self.device)
        self._apply(self._flat, self._mom, up)
        self._sync()

    # -- one round -------------------------------------------------------

    def step(self, X, y) -> float:
        """One FSA round: device grad+compress, kv aggregate, device
        sparse apply. Returns the loss as a host float."""
        X, y = self._to_device(X), self._to_device(y)
        packed_d, self._u, self._v = self._fwd_compress(
            self._flat, self._u, self._v, X, y)
        # ONE compact device->host transfer (1 + 2K int32 vs total)
        loss, vals, idx = self._unpack(packed_d.cpu().numpy())
        ups, upi = self._kv_round(vals, idx)
        # ONE compact fixed-size host->device transfer; apply locally
        self._flat, self._mom = self._apply(self._flat, self._mom,
                                            self._upload(ups, upi))
        return loss

    def step_timed(self, X, y) -> Tuple[float, Dict[str, float]]:
        """One round with a per-phase wall-ms breakdown (compute / d2h /
        wire / h2d / apply), each phase fenced by a synchronise or a
        value fetch. Audit tool, not the training loop."""
        X, y = self._to_device(X), self._to_device(y)
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
