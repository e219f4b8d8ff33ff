"""Data iterator family (reference: src/io/ + python/mxnet/io/io.py).

The reference ships C++ iterators behind ``mx.io`` — NDArrayIter
(io.py:492), CSVIter (iter_csv.cc), LibSVMIter (iter_libsvm.cc),
ImageRecordIter over RecordIO packs (iter_image_recordio_2.cc,
recordio.h), and a prefetching decorator (iter_prefetcher.h). The
device step wants plain host numpy batches feeding one fused transfer
(see ``examples.utils.host_grad_step``), so these are numpy-first host
iterators with the same semantics (counterpart of
``geomx_tpu/io/iterators.py``, copied numpy for numpy):

- every iterator yields ``(data, label)`` numpy pairs and supports
  ``reset()`` + re-iteration (epoch loop contract);
- ``NDArrayIter`` implements the reference's ``last_batch_handle``
  trio: 'pad' (wrap-fill the tail batch), 'discard', 'roll_over'
  (tail carries into the next epoch);
- ``PrefetchIter`` overlaps producer IO with consumer compute on a
  daemon thread (iter_prefetcher.h's double-buffering, host-side).

RecordIO (the pack format ImageRecordIter reads) lives in
``geomx_tpu_torch.io.recordio``, the JPEG/PNG decode and the augmenter
in ``geomx_tpu_torch.io.image``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = ["NDArrayIter", "CSVIter", "LibSVMIter", "PrefetchIter"]

Batch = Tuple[np.ndarray, np.ndarray]


class NDArrayIter:
    """In-memory iterator (reference: io.py:492 NDArrayIter).

    ``last_batch_handle``: 'pad' wraps the final short batch around to
    the epoch start (the reference pads with head samples), 'discard'
    drops it, 'roll_over' defers it to the start of the next epoch.
    """

    def __init__(self, data: np.ndarray, label: Optional[np.ndarray] = None,
                 batch_size: int = 1, shuffle: bool = False,
                 last_batch_handle: str = "pad", seed: int = 0):
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError(f"bad last_batch_handle {last_batch_handle!r}")
        self.data = np.asarray(data)
        self.label = (np.zeros(len(self.data), np.int32)
                      if label is None else np.asarray(label))
        if len(self.data) != len(self.label):
            raise ValueError("data/label length mismatch")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._rng = np.random.RandomState(seed)
        self._carry: list = []          # roll_over remainder (indices)

    def reset(self) -> None:
        """Drop roll-over state and restart the epoch."""
        self._carry = []

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.data)
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        if self._carry:
            idx = np.concatenate([self._carry, idx])
            self._carry = []
        bs = self.batch_size
        full, rem = divmod(len(idx), bs)
        for i in range(full):
            sel = idx[i * bs:(i + 1) * bs]
            yield self.data[sel], self.label[sel]
        if rem == 0:
            return
        tail = idx[full * bs:]
        if self.last_batch_handle == "discard":
            return
        if self.last_batch_handle == "roll_over":
            self._carry = list(tail)
            return
        sel = np.concatenate([tail, idx[:bs - rem]])  # pad from epoch head
        yield self.data[sel], self.label[sel]

    def __len__(self) -> int:
        n = len(self.data)
        if self.last_batch_handle == "discard":
            return n // self.batch_size
        return -(-n // self.batch_size)


class CSVIter:
    """CSV file iterator (reference: src/io/iter_csv.cc; mx.io.CSVIter).

    ``data_csv`` rows are flat feature vectors reshaped to
    ``data_shape``; ``label_csv`` (optional) provides one label row per
    sample. The whole file is memory-mapped-read once (these are
    tabular files, not image corpora) and then served in batches.
    """

    def __init__(self, data_csv: str, data_shape: Sequence[int],
                 batch_size: int, label_csv: Optional[str] = None,
                 round_batch: bool = True, delimiter: str = ","):
        raw = np.loadtxt(data_csv, delimiter=delimiter, dtype=np.float32,
                         ndmin=2)
        want = int(np.prod(data_shape))
        if raw.shape[1] != want:
            raise ValueError(
                f"csv row width {raw.shape[1]} != prod(data_shape) {want}")
        self.data = raw.reshape(len(raw), *data_shape)
        if label_csv is not None:
            self.label = np.loadtxt(label_csv, delimiter=delimiter,
                                    dtype=np.float32, ndmin=1)
            if self.label.ndim > 1 and self.label.shape[1] == 1:
                self.label = self.label[:, 0]
        else:
            self.label = np.zeros(len(raw), np.float32)
        if len(self.label) != len(self.data):
            raise ValueError("label_csv row count != data_csv row count")
        self._inner = NDArrayIter(
            self.data, self.label, batch_size,
            last_batch_handle="pad" if round_batch else "discard")

    def reset(self) -> None:
        self._inner.reset()

    def __iter__(self) -> Iterator[Batch]:
        return iter(self._inner)

    def __len__(self) -> int:
        return len(self._inner)


class LibSVMIter:
    """LibSVM sparse-format iterator (reference: src/io/iter_libsvm.cc).

    Lines are ``label idx:val idx:val ...`` (0-based indices like the
    reference's default). Batches densify into ``data_shape`` — the
    row-sparse wire path (kvstore push_row_sparse) is for gradients,
    not input pipelines, so dense device-feedable batches are the
    useful output here.
    """

    def __init__(self, data_libsvm: str, data_shape: Sequence[int],
                 batch_size: int, round_batch: bool = True):
        dim = int(np.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(dim, np.float32)
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    k = int(k)
                    if not 0 <= k < dim:
                        raise ValueError(f"libsvm index {k} out of range "
                                         f"for data_shape {data_shape}")
                    row[k] = float(v)
                rows.append(row.reshape(data_shape))
        self.data = (np.stack(rows) if rows
                     else np.zeros((0, *data_shape), np.float32))
        self.label = np.asarray(labels, np.float32)
        self._inner = NDArrayIter(
            self.data, self.label, batch_size,
            last_batch_handle="pad" if round_batch else "discard")

    def reset(self) -> None:
        self._inner.reset()

    def __iter__(self) -> Iterator[Batch]:
        return iter(self._inner)

    def __len__(self) -> int:
        return len(self._inner)


class PrefetchIter:
    """Background-thread prefetch (reference: src/io/iter_prefetcher.h).

    Wraps any reset-able batch iterator; a daemon producer stays
    ``prefetch`` batches ahead so host-side IO/augment overlaps the
    consumer's device step. Exceptions in the producer re-raise in the
    consumer.
    """

    _DONE = object()

    def __init__(self, base, prefetch: int = 2):
        self.base = base
        self.prefetch = max(1, int(prefetch))

    def reset(self) -> None:
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __len__(self) -> int:
        return len(self.base)

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err: list = []
        stop = threading.Event()

        def produce():
            try:
                for item in self.base:
                    # Bounded-timeout put so an abandoned consumer (break /
                    # exception in the for-loop body) cannot strand this
                    # thread on a full queue forever.
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
            finally:
                while True:
                    try:
                        q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        # Only discard queued items to make room when the
                        # consumer has already gone away — never on normal
                        # completion (that would drop real batches).
                        if stop.is_set():
                            try:
                                q.get_nowait()
                            except queue.Empty:
                                pass

        t = threading.Thread(target=produce, daemon=True,
                             name="geomx-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # Runs on normal exhaustion AND on GeneratorExit (consumer break
            # or GC): release the producer so reset()+re-iteration doesn't
            # race a live thread against the base iterator.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
            if t.is_alive():
                # Producer is stuck inside base.__next__ (slow IO source) —
                # it cannot be interrupted, so reset()+re-iteration would
                # race it against the base iterator. Surface that loudly.
                import warnings
                warnings.warn(
                    "PrefetchIter producer did not exit within 5 s; it is "
                    "blocked inside the base iterator. Do not reset() and "
                    "re-iterate until it finishes.", RuntimeWarning,
                    stacklevel=2)
