"""RecordIO pack format + image record iterator.

Wire-compatible with the reference's RecordIO framing
(reference: 3rdparty/dmlc-core/include/dmlc/recordio.h — magic
``0xced7230a``, 29-bit length word, 4-byte alignment) and the
``IRHeader`` record layout of python/mxnet/recordio.py (``IfQQ``:
flag, float label, id, id2; ``flag > 0`` means flag extra float32
labels follow the header).

``ImageRecordIter`` (reference: src/io/iter_image_recordio_2.cc)
iterates packs whose payloads are either encoded images (JPEG/PNG via
``geomx_tpu_torch.io.image.pack_img``, decoded + augmented on the fly) or
RAW uint8 arrays of a fixed ``data_shape``
(``pack_array``/``unpack_array``, codec-free). Counterpart of
``geomx_tpu/io/recordio.py``: the records are byte for byte the JAX
package's, so a file packed by either package reads in the other.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "IRHeader", "MXRecordIO", "pack", "unpack", "pack_array",
    "unpack_array", "ImageRecordIter",
]

_MAGIC = 0xced7230a
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])


def pack(header: IRHeader, s: bytes) -> bytes:
    """Header + payload -> record body (reference: recordio.py pack)."""
    label = header.label
    if isinstance(label, (np.ndarray, list, tuple)):
        label = np.asarray(label, np.float32)
        header = header._replace(flag=label.size, label=0.0)
        return (struct.pack(_IR_FORMAT, *header) + label.tobytes() + s)
    # Scalar label: flag must be 0 (reference recordio.py forces this) —
    # a caller-supplied flag > 0 would make unpack() consume 4*flag payload
    # bytes as labels and corrupt the body.
    header = header._replace(flag=0)
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(record: bytes) -> Tuple[IRHeader, bytes]:
    header = IRHeader(*struct.unpack(_IR_FORMAT, record[:_IR_SIZE]))
    body = record[_IR_SIZE:]
    if header.flag > 0:
        n = header.flag
        label = np.frombuffer(body[:4 * n], np.float32)
        header = header._replace(label=label)
        body = body[4 * n:]
    return header, body


def pack_array(header: IRHeader, arr: np.ndarray) -> bytes:
    """Raw-array payload (codec-free stand-in for pack_img)."""
    return pack(header, np.ascontiguousarray(arr, np.uint8).tobytes())


def unpack_array(record: bytes, shape: Sequence[int]
                 ) -> Tuple[IRHeader, np.ndarray]:
    header, body = unpack(record)
    return header, np.frombuffer(body, np.uint8).reshape(shape)


class MXRecordIO:
    """Sequential RecordIO reader/writer (dmlc framing)."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError("mode must be 'r' or 'w'")
        self.path = path
        self.mode = mode
        self._f = open(path, "rb" if mode == "r" else "wb")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write(self, data: bytes) -> None:
        assert self.mode == "w"
        if len(data) >= (1 << 29):
            raise ValueError("record too large (multi-part cflag records "
                             "not supported)")
        self._f.write(struct.pack("<II", _MAGIC, len(data)))
        self._f.write(data)
        pad = (-len(data)) % 4
        if pad:
            self._f.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        assert self.mode == "r"
        head = self._f.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise IOError(f"bad RecordIO magic {magic:#x} in {self.path}")
        cflag, length = lrec >> 29, lrec & ((1 << 29) - 1)
        if cflag != 0:
            raise IOError("multi-part records not supported")
        data = self._f.read(length)
        if len(data) < length:
            raise IOError(f"truncated record in {self.path}")
        pad = (-length) % 4
        if pad:
            self._f.read(pad)
        return data

    def reset(self) -> None:
        self._f.seek(0)


class ImageRecordIter:
    """Batched iterator over a RecordIO pack (reference:
    iter_image_recordio_2.cc).

    Payloads are detected per record: JPEG/PNG bodies (``pack_img``) are
    decoded on the fly — the compressed bytes stay in memory, pixels are
    materialized per batch, and an optional ``aug``
    (:class:`geomx_tpu_torch.io.image.ImageAugmenter`) runs per sample per
    epoch, exactly the reference parser's decode->augment stage; raw
    uint8 bodies (``pack_array``) are decoded once up front. Wrap in
    ``PrefetchIter`` for the thread overlap the reference gets from
    ``preprocess_threads``.

    Yields ``(data [B,*data_shape] float32, label [B])``; without an
    augmenter pixels are scaled to [0,1]. The tail batch pads from the
    file head (reference round_batch behavior).
    """

    def __init__(self, path_imgrec: str, data_shape: Sequence[int],
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 aug=None):
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.aug = aug
        self._rng = np.random.RandomState(seed)
        self._encoded: List[bytes] = []
        imgs: List[np.ndarray] = []
        labels: List[float] = []
        from geomx_tpu_torch.io.image import is_encoded_image

        raw_len = int(np.prod(self.data_shape))
        with MXRecordIO(path_imgrec, "r") as rec:
            while True:
                raw = rec.read()
                if raw is None:
                    break
                header, body = unpack(raw)
                lab = header.label
                labels.append(float(np.asarray(lab).ravel()[0]))
                # deterministic classification: a raw payload is always
                # exactly prod(data_shape) bytes (an encoded body
                # essentially never is) — size decides, the image magic
                # only validates; a 2-byte sniff alone would misread a
                # raw pack whose first pixel is (255, 216, ...)
                if len(body) == raw_len:
                    imgs.append(np.frombuffer(body, np.uint8)
                                .reshape(self.data_shape))
                elif is_encoded_image(body):
                    self._encoded.append(body)
                else:
                    raise ValueError(
                        f"{path_imgrec}: record {len(labels) - 1} is "
                        f"neither a raw array of {raw_len} bytes nor an "
                        "encoded JPEG/PNG")
        if self._encoded and imgs:
            raise ValueError(f"{path_imgrec} mixes encoded and raw "
                             "payloads")
        # raw packs with an augmenter keep uint8 pixels so the augmenter
        # runs per sample per epoch, exactly like the encoded path (aug
        # silently skipped on raw data would diverge from the same
        # pixels packed as PNG)
        self._raw_u8 = (np.stack(imgs) if imgs and aug is not None
                        else None)
        self.data = (np.stack(imgs).astype(np.float32) / 255.0
                     if imgs and aug is None else
                     np.zeros((0, *self.data_shape), np.float32))
        self.label = np.asarray(labels, np.float32)

    def _materialize(self, i: int) -> np.ndarray:
        """Decode (+augment) one sample -> float32 data_shape."""
        if self._raw_u8 is not None:
            arr = self._raw_u8[i]
        else:
            from geomx_tpu_torch.io.image import imdecode

            arr = imdecode(self._encoded[i])
        if self.aug is not None:
            out = self.aug(arr)
        else:
            out = arr.astype(np.float32) / 255.0
            if out.ndim == 2:
                out = out[..., None]
        if out.shape != self.data_shape:
            raise ValueError(
                f"decoded sample shape {out.shape} != data_shape "
                f"{self.data_shape}; add resize/crop via aug=")
        return out

    def reset(self) -> None:
        pass

    def _n_samples(self) -> int:
        if self._encoded:
            return len(self._encoded)
        if self._raw_u8 is not None:
            return len(self._raw_u8)
        return len(self.data)

    def __len__(self) -> int:
        return -(-self._n_samples() // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = self._n_samples()
        if n == 0:
            return
        lazy = bool(self._encoded) or self._raw_u8 is not None
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        for i in range(len(self)):
            sel = idx[i * bs:(i + 1) * bs]
            if len(sel) < bs:  # pad from head (round_batch)
                sel = np.concatenate([sel, idx[:bs - len(sel)]])
            if lazy:
                yield (np.stack([self._materialize(j) for j in sel]),
                       self.label[sel])
            else:
                yield self.data[sel], self.label[sel]
