"""The port's image-classification host path against the JAX package's.

- RecordIO records are byte for byte the JAX package's, so files cross
  packages in both directions, raw (``pack_array``) and encoded
  (``pack_img``).
- ``ImageAugmenter`` gives the JAX package's arrays for the same seeds
  and options (crop, mirror, resize, rotation, colour jitter, grayscale,
  normalization), and raw-array records with crop, mirror and
  normalization need no Pillow; without it the encoded path raises the
  clear ImportError.
- The records path trains: raw CIFAR-shaped records through
  ``ImageRecordIter`` + ``ImageAugmenter`` + ``PrefetchIter`` into
  ``build_model_and_step("resnet18", num_classes=3)`` (the counterpart of
  ``test_image_pipeline.py::test_cifar_records_train_zoo_model``).
- ``initializer.as_torch`` gives ``as_flax``'s array for the same seed;
  ``metric`` reads torch tensors; the device store's row-sparse push and
  pull stay on its device.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from geomx_tpu import initializer as jinit
from geomx_tpu import metric as jmetric
from geomx_tpu.io import image as jimage
from geomx_tpu.io import recordio as jrec
from geomx_tpu_torch import initializer as tinit
from geomx_tpu_torch import metric as tmetric
from geomx_tpu_torch.examples.utils import build_model_and_step
from geomx_tpu_torch.io import image as timage
from geomx_tpu_torch.io import recordio as trec
from geomx_tpu_torch.io.iterators import PrefetchIter
from geomx_tpu_torch.kvstore.device import KVStoreDeviceAllreduce
from geomx_tpu_torch.optimizer import SGD


def _imgs(n, h=32, w=32, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, c), np.uint8) for _ in range(n)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_records_cross_packages(writer, tmp_path):
    w_pkg, r_pkg = (jrec, trec) if writer == "jax" else (trec, jrec)
    img_w = jimage if writer == "jax" else timage
    imgs = _imgs(5)
    paths = {}
    for kind in ("raw", "png"):
        paths[kind] = str(tmp_path / f"{kind}.rec")
        with w_pkg.MXRecordIO(paths[kind], "w") as w:
            for i, img in enumerate(imgs):
                hdr = w_pkg.IRHeader(0, [float(i), 2.0 * i], i, 0)
                w.write(w_pkg.pack_array(hdr, img) if kind == "raw" else
                        img_w.pack_img(hdr, img, img_fmt=".png"))
    # the same bytes from either package
    for i, img in enumerate(imgs):
        hdr = (float(i), i)
        assert jrec.pack_array(jrec.IRHeader(0, hdr[0], hdr[1], 0), img) \
            == trec.pack_array(trec.IRHeader(0, hdr[0], hdr[1], 0), img)
        assert jimage.pack_img(jrec.IRHeader(0, 1.0, i, 0), img, 90) == \
            timage.pack_img(trec.IRHeader(0, 1.0, i, 0), img, 90)
    for kind in ("raw", "png"):
        with r_pkg.MXRecordIO(paths[kind], "r") as r:
            for i, img in enumerate(imgs):
                header, body = r_pkg.unpack(r.read())
                np.testing.assert_array_equal(header.label, [i, 2.0 * i])
                got = (np.frombuffer(body, np.uint8).reshape(img.shape)
                       if kind == "raw" else
                       (jimage if r_pkg is jrec else timage).imdecode(body))
                np.testing.assert_array_equal(got, img)
        a = list(jrec.ImageRecordIter(paths[kind], (32, 32, 3), 2,
                                      shuffle=True, seed=3))
        b = list(trec.ImageRecordIter(paths[kind], (32, 32, 3), 2,
                                      shuffle=True, seed=3))
        assert len(a) == len(b) == 3
        for (xa, ya), (xb, yb) in zip(a, b):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


AUGS = {
    "center": dict(data_shape=(32, 32, 3)),
    "crop_mirror": dict(data_shape=(32, 32, 3), rand_crop=True,
                        rand_mirror=True),
    "resize": dict(data_shape=(32, 32, 3), resize=36, rand_crop=True),
    "rotate": dict(data_shape=(48, 40, 3), max_rotate_angle=20.0),
    "jitter": dict(data_shape=(48, 40, 3), brightness=0.4, contrast=0.4,
                   saturation=0.4),
    "gray_out": dict(data_shape=(48, 40, 1)),
    "normalize": dict(data_shape=(48, 40, 3), mean_rgb=[0.4, 0.5, 0.6],
                      std_rgb=[0.2, 0.25, 0.3], rand_mirror=True),
    "small_up": dict(data_shape=(64, 64, 3)),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenter_matches_the_jax_package(name):
    kw = dict(AUGS[name], seed=4)
    ja, ta = jimage.ImageAugmenter(**kw), timage.ImageAugmenter(**kw)
    imgs = _imgs(6, h=48, w=40) + [_imgs(1, h=48, w=40, c=1)[0][..., 0]]
    for img in imgs:
        np.testing.assert_array_equal(ta(img), ja(img))


def test_raw_records_need_no_pillow(tmp_path, monkeypatch):
    p = str(tmp_path / "raw.rec")
    imgs = _imgs(6)
    with trec.MXRecordIO(p, "w") as w:
        for i, img in enumerate(imgs):
            w.write(trec.pack_array(trec.IRHeader(0, float(i), i, 0), img))
    kw = dict(data_shape=(32, 32, 3), rand_crop=True, rand_mirror=True,
              mean_rgb=[0.5] * 3, std_rgb=[0.25] * 3, seed=2)
    want = list(jrec.ImageRecordIter(p, (32, 32, 3), 3,
                                     aug=jimage.ImageAugmenter(**kw)))
    monkeypatch.setitem(sys.modules, "PIL", None)       # no Pillow
    got = list(trec.ImageRecordIter(p, (32, 32, 3), 3,
                                    aug=timage.ImageAugmenter(**kw)))
    for (xa, ya), (xb, yb) in zip(want, got):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    with pytest.raises(ImportError, match="needs Pillow"):
        timage.imencode(imgs[0], ".png")
    with pytest.raises(ImportError, match="needs Pillow"):
        timage.ImageAugmenter((32, 32, 3), resize=40)(imgs[0])


def test_records_path_trains_a_zoo_model(tmp_path):
    """Raw CIFAR-shaped records (class = dominant channel) through the
    reader, the augmenter and the prefetcher into the port's ResNet-18:
    the loss falls over a few Adam steps."""
    rng = np.random.RandomState(0)
    p = str(tmp_path / "cifar.rec")
    with trec.MXRecordIO(p, "w") as w:
        for i in range(32):
            cls = i % 3
            img = rng.randint(0, 64, (32, 32, 3), np.uint8)
            img[..., cls] = rng.randint(160, 256, (32, 32), np.uint8)
            w.write(trec.pack_array(trec.IRHeader(0, float(cls), i, 0), img))
    aug = timage.ImageAugmenter((32, 32, 3), rand_crop=True,
                                rand_mirror=True, seed=5)
    it = trec.ImageRecordIter(p, (32, 32, 3), batch_size=16, shuffle=True,
                              aug=aug, seed=5)
    leaves, _names, grad_step, eval_step = build_model_and_step(
        16, input_shape=(32, 32, 3), model="resnet18", num_classes=3,
        device="cpu")
    params = [torch.tensor(l, requires_grad=True) for l in leaves]
    opt = torch.optim.Adam(params, lr=1e-3)
    losses = []
    for _ in range(3):
        for X, y in PrefetchIter(it, prefetch=2):
            loss, grads = grad_step(params, torch.tensor(X),
                                    torch.tensor(y.astype(np.int64)))
            for prm, g in zip(params, grads):
                prm.grad = g
            opt.step()
            losses.append(float(loss))
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert 0.0 <= float(eval_step(params, torch.tensor(X),
                                  torch.tensor(y.astype(np.int64)))) <= 1.0


@pytest.mark.parametrize("name,shape", [
    ("xavier", (8, 6)), ("uniform", (5,)), ("normal", (4, 3, 2)),
    ("orthogonal", (6, 10)), ("msraprelu", (16, 8, 3, 3)),
    ("bilinear", (1, 1, 4, 4))])
@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_as_torch_equals_as_flax(name, shape, seed):
    want = np.asarray(jinit.as_flax(name)(jax.random.PRNGKey(seed), shape))
    t = torch.empty(shape)
    out = tinit.as_torch(name)(t, torch.Generator().manual_seed(seed))
    assert out is t
    np.testing.assert_array_equal(t.numpy(), want)
    b = tinit.as_torch(name)(torch.empty(shape, dtype=torch.bfloat16),
                             torch.Generator().manual_seed(seed))
    np.testing.assert_array_equal(b.float().numpy(),
                                  torch.tensor(want).bfloat16().float())


def test_metrics_read_torch_tensors():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((20, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 20)
    for name in ("acc", "top_k_accuracy", "ce", "perplexity", "mse"):
        kw = {"top_k": 3} if name == "top_k_accuracy" else {}
        j, t = jmetric.create(name, **kw), tmetric.create(name, **kw)
        probs = np.exp(scores) / np.exp(scores).sum(1, keepdims=True)
        preds = probs if name in ("ce", "perplexity") else scores
        if name == "mse":
            preds, lab = scores[:, 0], scores[:, 1]
        else:
            lab = labels
        j.update(lab, preds)
        t.update(torch.tensor(lab), torch.tensor(preds))
        assert t.get() == j.get()
    acc = tmetric.Accuracy()
    acc.update(torch.tensor(labels), torch.tensor(scores).bfloat16())
    assert acc.get()[1] == pytest.approx(
        np.mean(np.argmax(torch.tensor(scores).bfloat16().float().numpy(),
                          -1) == labels))


def test_device_store_row_sparse_stays_on_its_device():
    kv = KVStoreDeviceAllreduce(devices=["cpu"])
    w0 = np.arange(20, dtype=np.float32).reshape(5, 4)
    kv.init(0, w0)
    kv.push_row_sparse(0, torch.tensor([1, 3, 1]), torch.ones(3, 4))
    rows = kv.pull_row_sparse(0, [0, 1, 3])
    assert torch.is_tensor(rows) and rows.device == kv.device
    # no updater: the push's reduction replaces the value (rows summed)
    expect = np.zeros_like(w0)
    expect[1] = 2.0
    expect[3] = 1.0
    np.testing.assert_array_equal(kv.pull(0), expect)
    np.testing.assert_array_equal(rows.numpy(), expect[[0, 1, 3]])
    kv.set_optimizer(SGD(learning_rate=1.0))
    kv.push_row_sparse(0, [4], np.ones((1, 4), np.float32))
    np.testing.assert_array_equal(kv.pull_row_sparse(0, [4]).numpy(),
                                  expect[[4]] - 1.0)
