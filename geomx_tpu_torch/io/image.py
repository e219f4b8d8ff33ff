"""Image decode + augmentation pipeline for RecordIO packs.

Counterpart of ``geomx_tpu/io/image.py``. The reference ships a
C++/OpenCV pipeline: packed image records are JPEG-decoded and augmented
on the fly by worker threads (reference: src/io/iter_image_recordio_2.cc
ImageRecordIOParser2, image_aug_default.cc DefaultImageAugmenter,
iter_normalize.h). Here the stage is host-side, as in the JAX package:
the device wants one fused batch upload, so decode/augment runs on the
CPU and composes with ``PrefetchIter`` for the thread overlap the
reference gets from ``preprocess_threads``.

``pack_img``/``unpack_img`` mirror mx.recordio's wire format: the
record body is ``IRHeader + encoded image bytes`` (JPEG or PNG —
decoders detect by magic), interoperable with the raw-array records
of ``pack_array`` (payloads without an image magic are rejected by
``unpack_img``).

``ImageAugmenter`` implements the reference's default-augmenter core
(image_aug_default.cc params): resize, random/center crop to
``data_shape``, horizontal mirror, rotation, brightness/contrast/
saturation jitter, then scale/mean/std normalization
(iter_normalize.h). Geometry params the reference exposes for detection
workloads (shear, PCA noise, HSL space) are out of scope.

Pillow is loaded only by the steps that need it: encoding and decoding,
resize, rotation, colour jitter and RGB -> grayscale. Crop, mirror,
grayscale -> RGB and the normalization are exact index and arithmetic
steps done in numpy, with the same results and the same random draws as
the JAX package's PIL calls, so raw-array records (``pack_array``)
augmented by crop and mirror need no Pillow.
"""

from __future__ import annotations

import io as _io
from typing import Optional, Sequence, Tuple

import numpy as np

from geomx_tpu_torch.io.recordio import IRHeader, pack, unpack

__all__ = ["imencode", "imdecode", "pack_img", "unpack_img",
           "ImageAugmenter"]

_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG"


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "the encoded-image path needs Pillow; raw-array records "
            "(pack_array) work without it") from e
    return Image


def imencode(arr: np.ndarray, img_fmt: str = ".jpg",
             quality: int = 95) -> bytes:
    """uint8 HWC (or HW) array -> encoded bytes (reference:
    mx.recordio.pack_img's cv2.imencode step)."""
    Image = _pil()
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]   # PIL has no (H, W, 1) mode — grayscale is 2-D
    img = Image.fromarray(arr)
    buf = _io.BytesIO()
    fmt = img_fmt.lstrip(".").lower()
    if fmt in ("jpg", "jpeg"):
        img.save(buf, format="JPEG", quality=quality)
    elif fmt == "png":
        img.save(buf, format="PNG")
    else:
        raise ValueError(f"unsupported image format {img_fmt!r}")
    return buf.getvalue()


def imdecode(buf: bytes) -> np.ndarray:
    """Encoded bytes -> uint8 HWC array."""
    Image = _pil()
    if not (buf.startswith(_JPEG_MAGIC) or buf.startswith(_PNG_MAGIC)):
        raise ValueError("payload is not a JPEG/PNG image "
                         "(raw-array record? use unpack_array)")
    img = Image.open(_io.BytesIO(buf))
    return np.asarray(img.convert("RGB") if img.mode not in ("L", "RGB")
                      else img)


def pack_img(header: IRHeader, arr: np.ndarray, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """Image record body (reference: python/mxnet/recordio.py pack_img)."""
    return pack(header, imencode(arr, img_fmt, quality))


def unpack_img(record: bytes) -> Tuple[IRHeader, np.ndarray]:
    header, body = unpack(record)
    return header, imdecode(body)


def is_encoded_image(payload: bytes) -> bool:
    return payload.startswith(_JPEG_MAGIC) or payload.startswith(_PNG_MAGIC)


def _through_pil(arr: np.ndarray, fn) -> np.ndarray:
    """``fn(PIL image) -> PIL image`` on a uint8 HW or HWC array."""
    return np.asarray(fn(_pil().fromarray(arr)))


class ImageAugmenter:
    """Host-side default augmenter (reference: image_aug_default.cc).

    Call order matches the reference: resize -> rotate -> crop ->
    mirror -> color jitter -> normalize. Output is float32 HWC.

    Parameters (reference names):
      resize: shorter side resized to this before cropping (0 = off)
      rand_crop: random crop position (else center crop)
      rand_mirror: horizontal flip with p=0.5
      max_rotate_angle: rotation uniformly in [-a, a] degrees
      brightness/contrast/saturation: jitter factor in [-x, x]
      scale: multiplied after [0,255] -> float (default 1/255)
      mean_rgb / std_rgb: per-channel normalization AFTER scale
        (iter_normalize.h semantics)
    """

    def __init__(self, data_shape: Sequence[int], resize: int = 0,
                 rand_crop: bool = False, rand_mirror: bool = False,
                 max_rotate_angle: float = 0.0, brightness: float = 0.0,
                 contrast: float = 0.0, saturation: float = 0.0,
                 scale: float = 1.0 / 255.0,
                 mean_rgb: Optional[Sequence[float]] = None,
                 std_rgb: Optional[Sequence[float]] = None,
                 seed: int = 0):
        self.data_shape = tuple(data_shape)   # (H, W, C)
        if len(self.data_shape) != 3:
            raise ValueError("data_shape must be (H, W, C)")
        self.resize = resize
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.max_rotate_angle = max_rotate_angle
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.scale = scale
        self.mean = (np.asarray(mean_rgb, np.float32)
                     if mean_rgb is not None else None)
        self.std = (np.asarray(std_rgb, np.float32)
                    if std_rgb is not None else None)
        self._rng = np.random.RandomState(seed)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        rng = self._rng
        arr = np.ascontiguousarray(arr, np.uint8)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]   # grayscale is 2-D, as PIL's mode "L"
        H, W, C = self.data_shape
        if C == 3 and arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)     # L -> RGB
        elif C == 3 and arr.shape[-1] == 4:
            arr = np.ascontiguousarray(arr[..., :3])        # RGBA -> RGB
        elif C == 1 and arr.ndim == 3:
            arr = _through_pil(arr, lambda im: im.convert("L"))
        if self.resize:
            h, w = arr.shape[:2]
            ratio = self.resize / min(w, h)
            size = (max(int(round(w * ratio)), W),
                    max(int(round(h * ratio)), H))
            arr = _through_pil(arr, lambda im: im.resize(
                size, _pil().BILINEAR))
        if self.max_rotate_angle:
            angle = rng.uniform(-self.max_rotate_angle,
                                self.max_rotate_angle)
            arr = _through_pil(arr, lambda im: im.rotate(
                angle, resample=_pil().BILINEAR))
        h, w = arr.shape[:2]
        if (w, h) != (W, H):
            if w < W or h < H:   # too small even after resize: upsample
                arr = _through_pil(arr, lambda im: im.resize(
                    (max(w, W), max(h, H)), _pil().BILINEAR))
                h, w = arr.shape[:2]
            if self.rand_crop:
                x0 = rng.randint(0, w - W + 1)
                y0 = rng.randint(0, h - H + 1)
            else:
                x0, y0 = (w - W) // 2, (h - H) // 2
            arr = arr[y0:y0 + H, x0:x0 + W]
        if self.rand_mirror and rng.randint(2):
            arr = arr[:, ::-1]
        for amount, enhancer in ((self.brightness, "Brightness"),
                                 (self.contrast, "Contrast"),
                                 (self.saturation, "Color")):
            if amount:
                _pil()
                from PIL import ImageEnhance

                factor = 1.0 + rng.uniform(-amount, amount)
                arr = _through_pil(np.ascontiguousarray(arr), lambda im: (
                    getattr(ImageEnhance, enhancer)(im).enhance(factor)))
        out = np.asarray(arr, np.float32)
        if out.ndim == 2:
            out = out[..., None]
        out = out * self.scale
        if self.mean is not None:
            out = out - self.mean
        if self.std is not None:
            out = out / self.std
        return out
