"""Datasets + iterators.

Counterpart of ``geomx_tpu/io/datasets.py``, numpy only, so both
packages produce the same arrays from the same seeds. It plays the role of the reference's IO layer (reference: src/io/iter_mnist.cc
and examples/utils.py:39-118 load_data/SplitSampler): MNIST-family loading,
per-worker contiguous slicing, optional non-IID split-by-class, batching.

Loads real MNIST/Fashion-MNIST IDX files when present under ``root``
(same file names the reference's gluon datasets download); otherwise falls
back to a DETERMINISTIC synthetic class-conditional dataset — each class
has a fixed random template, samples are template + noise — which is
learnable, so per-iteration test accuracy (the reference's observable
correctness signal, examples/cnn.py:129-131) still climbs.
"""

from __future__ import annotations

import gzip
import logging
import os
import pickle
import struct
from typing import Iterator, Tuple

import numpy as np

log = logging.getLogger("geomx.io")
_warned_synthetic = set()


def _read_idx_images(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad idx image magic {magic}"
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad idx label magic {magic}"
        return np.frombuffer(f.read(), dtype=np.uint8)


def _try_load_cifar10(root: str):
    """CIFAR-10 python-pickle batches (cifar-10-batches-py layout, the
    format the reference's gluon CIFAR10 dataset unpacks)."""
    d = root
    if os.path.isdir(os.path.join(root, "cifar-10-batches-py")):
        d = os.path.join(root, "cifar-10-batches-py")
    names = [f"data_batch_{i}" for i in range(1, 6)]
    if not all(os.path.exists(os.path.join(d, n)) for n in names + ["test_batch"]):
        return None

    def read(name):
        with open(os.path.join(d, name), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        x = np.asarray(b[b"data"], np.uint8).reshape(-1, 3, 32, 32)
        return x.transpose(0, 2, 3, 1), np.asarray(b[b"labels"], np.int32)

    xs, ys = zip(*[read(n) for n in names])
    tx, ty = read("test_batch")
    return ((np.concatenate(xs), np.concatenate(ys)), (tx, ty))


def _try_load_idx(root: str, train: bool):
    prefixes = ["train" if train else "t10k"]
    for p in prefixes:
        for suffix in ("", ".gz"):
            img = os.path.join(root, f"{p}-images-idx3-ubyte{suffix}")
            lab = os.path.join(root, f"{p}-labels-idx1-ubyte{suffix}")
            if os.path.exists(img) and os.path.exists(lab):
                return _read_idx_images(img), _read_idx_labels(lab)
    return None


def synthetic_mnist(n: int, seed: int, num_classes: int = 10,
                    shape: Tuple[int, ...] = (28, 28)):
    """Deterministic learnable stand-in: class template + gaussian noise."""
    rng = np.random.RandomState(1234)  # templates shared across workers
    templates = rng.rand(num_classes, *shape).astype(np.float32)
    sample_rng = np.random.RandomState(seed)
    labels = sample_rng.randint(0, num_classes, size=n).astype(np.int32)
    noise = sample_rng.normal(0, 0.35, size=(n, *shape)).astype(np.float32)
    images = np.clip(templates[labels] + noise, 0.0, 1.0)
    return images, labels


class DataIter:
    """Batched iterator over (images NHWC float32 in [0,1], labels int32)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0):
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return max(len(self.images) // self.batch_size, 1)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(idx)
        for i in range(len(self)):
            sel = idx[i * self.batch_size:(i + 1) * self.batch_size]
            yield self.images[sel], self.labels[sel]


def load_data(batch_size: int,
              num_workers: int = 1,
              data_slice_idx: int = 0,
              data_type: str = "mnist",
              split_by_class: bool = False,
              resize=None,
              root: str = "~/data",
              synthetic_train_size: int = 4096,
              synthetic_test_size: int = 1024):
    """Mirror of the reference loader (examples/utils.py:39-90): returns
    (train_iter, test_iter, num_train, num_test) with this worker's
    contiguous slice (SplitSampler) or class-partitioned slice."""
    assert data_slice_idx < num_workers, (
        f"Invalid slice id ({data_slice_idx}), must be < num_workers "
        f"({num_workers})")
    droot = os.path.join(os.path.expanduser(root), data_type)
    loaded = loaded_test = None
    if data_type == "cifar10":
        pair = _try_load_cifar10(droot) if os.path.isdir(droot) else None
        if pair is not None:
            loaded, loaded_test = pair
    elif os.path.isdir(droot):
        loaded = _try_load_idx(droot, train=True)
        loaded_test = _try_load_idx(droot, train=False) \
            if loaded is not None else None
    if loaded is not None and loaded_test is not None:
        train_x, train_y = loaded
        test_x, test_y = loaded_test
        train_x = train_x.astype(np.float32) / 255.0
        test_x = test_x.astype(np.float32) / 255.0
        train_y = train_y.astype(np.int32)
        test_y = test_y.astype(np.int32)
    else:
        # fall back LOUDLY — a silently-synthetic "cifar10" run is not a
        # cifar10 run
        if data_type not in _warned_synthetic:
            _warned_synthetic.add(data_type)
            log.warning("no %s files under %s; using the deterministic "
                        "SYNTHETIC stand-in dataset", data_type, droot)
        shape = (32, 32, 3) if data_type == "cifar10" else (28, 28)
        train_x, train_y = synthetic_mnist(synthetic_train_size, seed=7,
                                           shape=shape)
        test_x, test_y = synthetic_mnist(synthetic_test_size, seed=11,
                                         shape=shape)

    # per-worker slicing (reference: SplitSampler / ClassSplitSampler)
    n = len(train_x)
    if num_workers > 1:
        if split_by_class:
            order = np.argsort(train_y, kind="stable")
        else:
            order = np.arange(n)
        part = n // num_workers
        sel = order[data_slice_idx * part:(data_slice_idx + 1) * part]
        train_x, train_y = train_x[sel], train_y[sel]

    if train_x.ndim == 3:           # grayscale -> NHWC
        train_x = train_x[..., None]
        test_x = test_x[..., None]
    train_iter = DataIter(train_x, train_y, batch_size, shuffle=True,
                          seed=100 + data_slice_idx)
    test_iter = DataIter(test_x, test_y, batch_size, shuffle=False)
    return train_iter, test_iter, len(train_x), len(test_x)
