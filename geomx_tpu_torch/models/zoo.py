"""Vision model zoo as torch modules.

Counterpart of ``geomx_tpu/models/zoo.py`` (reference:
python/mxnet/gluon/model_zoo/vision/ — alexnet.py, vgg.py,
squeezenet.py, mobilenet.py, densenet.py, inception.py). Each model is
a :class:`~geomx_tpu_torch.models.layers.Compact` module whose ``body``
follows the flax ``__call__`` line for line, so its parameters carry the
flax paths (``Conv_12``, ``BatchNorm_3``, ``Dense_0``) and move across
through :mod:`geomx_tpu_torch.models.convert`. Inputs are NHWC like the
JAX modules'; the body runs NCHW and returns fp32 logits.

A torch layer is built for a known input, so every model takes
``input_shape`` ``(H, W, C)`` (its default is the model's published
input); the flax modules read it from the array ``init`` is given.
``get_model(name)`` mirrors ``model_zoo.vision.get_model`` (reference:
vision/__init__.py:91-161) with the JAX package's names, including the
resnet and recurrent ones.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from geomx_tpu_torch.models.layers import (Compact, avg_pool, dropout,
                                           max_pool)

__all__ = ["AlexNet", "VGG", "SqueezeNet", "MobileNetV1", "MobileNetV2",
           "DenseNet", "InceptionV3", "get_model"]


def _same(k: int) -> list:
    p = k // 2
    return [(p, p), (p, p)]


class _Zoo(Compact):
    """Top-level model: NHWC in, fp32 logits out."""

    def __init__(self, input_shape: Sequence[int],
                 generator: Optional[torch.Generator]):
        super().__init__(generator)
        self.input_shape = tuple(input_shape)

    def _build(self):
        h, w, c = self.input_shape
        self.build((c, h, w))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: ``[N, H, W, C]``; ``rng`` draws the dropout masks of a
        train-mode call."""
        dt = next(self.parameters()).dtype
        return self.run(x.to(dt).permute(0, 3, 1, 2), train, rng).float()


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten in NHWC order, as the flax modules do."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class AlexNet(_Zoo):
    """reference: vision/alexnet.py:36-77."""

    def __init__(self, num_classes: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape, generator)
        self.num_classes = num_classes
        self._build()

    def body(self, x, train, rng):
        x = F.relu(self.conv(x, 64, (11, 11), (4, 4), [(2, 2), (2, 2)]))
        x = max_pool(x, (3, 3), (2, 2))
        x = F.relu(self.conv(x, 192, (5, 5), padding=_same(5)))
        x = max_pool(x, (3, 3), (2, 2))
        x = F.relu(self.conv(x, 384, (3, 3), padding=_same(3)))
        x = F.relu(self.conv(x, 256, (3, 3), padding=_same(3)))
        x = F.relu(self.conv(x, 256, (3, 3), padding=_same(3)))
        x = max_pool(x, (3, 3), (2, 2))
        x = _flatten_nhwc(x)
        x = dropout(F.relu(self.dense(x, 4096)), 0.5, train, rng)
        x = dropout(F.relu(self.dense(x, 4096)), 0.5, train, rng)
        return self.dense(x, self.num_classes)


class VGG(_Zoo):
    """reference: vision/vgg.py:33-104 (layers/filters specs at :105)."""

    def __init__(self, layers: Sequence[int], filters: Sequence[int],
                 batch_norm: bool = False, num_classes: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape, generator)
        self.layers, self.filters = list(layers), list(filters)
        self.batch_norm = batch_norm
        self.num_classes = num_classes
        self._build()

    def body(self, x, train, rng):
        for n, f in zip(self.layers, self.filters):
            for _ in range(n):
                x = self.conv(x, f, (3, 3), padding=_same(3))
                if self.batch_norm:
                    x = self.bn(x, train)
                x = F.relu(x)
            x = max_pool(x, (2, 2), (2, 2))
        x = _flatten_nhwc(x)
        x = dropout(F.relu(self.dense(x, 4096)), 0.5, train, rng)
        x = dropout(F.relu(self.dense(x, 4096)), 0.5, train, rng)
        return self.dense(x, self.num_classes)


_VGG_SPEC = {  # reference: vgg.py:105-109
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class SqueezeNet(_Zoo):
    """reference: vision/squeezenet.py:48-120 (fire module at :36). The
    convolutions the flax module leaves at its default padding are SAME,
    which pads the strided stems asymmetrically."""

    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape, generator)
        self.version = version
        self.num_classes = num_classes
        self._build()

    def _fire(self, x, squeeze, expand):
        s = F.relu(self.conv(x, squeeze, (1, 1)))
        e1 = F.relu(self.conv(s, expand, (1, 1)))
        e3 = F.relu(self.conv(s, expand, (3, 3), padding=_same(3)))
        return torch.cat([e1, e3], dim=1)

    def body(self, x, train, rng):
        if self.version == "1.0":
            x = F.relu(self.conv(x, 96, (7, 7), (2, 2)))
            x = max_pool(x, (3, 3), (2, 2))
            for sq in (16, 16, 32):
                x = self._fire(x, sq, sq * 4)
            x = max_pool(x, (3, 3), (2, 2))
            for sq in (32, 48, 48, 64):
                x = self._fire(x, sq, sq * 4)
            x = max_pool(x, (3, 3), (2, 2))
            x = self._fire(x, 64, 256)
        else:  # 1.1
            x = F.relu(self.conv(x, 64, (3, 3), (2, 2)))
            x = max_pool(x, (3, 3), (2, 2))
            x = self._fire(x, 16, 64)
            x = self._fire(x, 16, 64)
            x = max_pool(x, (3, 3), (2, 2))
            x = self._fire(x, 32, 128)
            x = self._fire(x, 32, 128)
            x = max_pool(x, (3, 3), (2, 2))
            for sq in (48, 48, 64, 64):
                x = self._fire(x, sq, sq * 4)
        x = dropout(x, 0.5, train, rng)
        x = F.relu(self.conv(x, self.num_classes, (1, 1)))
        return x.mean(dim=(2, 3))


class MobileNetV1(_Zoo):
    """reference: vision/mobilenet.py:131-178 (depthwise-separable at
    :42-63); ``multiplier`` scales every width."""

    def __init__(self, multiplier: float = 1.0, num_classes: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape, generator)
        self.multiplier = multiplier
        self.num_classes = num_classes
        self._build()

    def body(self, x, train, rng):
        def dw_sep(x, ch, stride):
            cin = x.shape[1]
            x = self.conv(x, cin, (3, 3), (stride, stride), _same(3),
                          feature_group_count=cin, use_bias=False)
            x = F.relu(self.bn(x, train))
            x = self.conv(x, ch, (1, 1), use_bias=False)
            return F.relu(self.bn(x, train))

        m = self.multiplier
        x = self.conv(x, int(32 * m), (3, 3), (2, 2), _same(3),
                      use_bias=False)
        x = F.relu(self.bn(x, train))
        spec = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                (512, 2)] + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
        for ch, s in spec:
            x = dw_sep(x, max(int(ch * m), 8), s)
        return self.dense(x.mean(dim=(2, 3)), self.num_classes)


class MobileNetV2(_Zoo):
    """reference: vision/mobilenet.py:180-250 (inverted residual
    "LinearBottleneck" at :66-110)."""

    def __init__(self, multiplier: float = 1.0, num_classes: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape, generator)
        self.multiplier = multiplier
        self.num_classes = num_classes
        self._build()

    def body(self, x, train, rng):
        def bottleneck(x, ch, t, stride):
            cin = x.shape[1]
            y = x
            if t != 1:
                y = F.relu6(self.bn(self.conv(y, cin * t, (1, 1),
                                              use_bias=False), train))
            y = self.conv(y, y.shape[1], (3, 3), (stride, stride),
                          _same(3), feature_group_count=y.shape[1],
                          use_bias=False)
            y = F.relu6(self.bn(y, train))
            y = self.bn(self.conv(y, ch, (1, 1), use_bias=False), train)
            if stride == 1 and cin == ch:
                y = y + x
            return y

        m = self.multiplier
        x = F.relu6(self.bn(self.conv(x, int(32 * m), (3, 3), (2, 2),
                                      _same(3), use_bias=False), train))
        # (expansion t, channels, repeats, first stride) — mobilenet.py:203
        for t, c, n, s in [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                           (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                           (6, 320, 1, 1)]:
            for i in range(n):
                x = bottleneck(x, max(int(c * m), 8), t, s if i == 0 else 1)
        last = int(1280 * m) if m > 1.0 else 1280
        x = F.relu6(self.bn(self.conv(x, last, (1, 1), use_bias=False),
                            train))
        return self.dense(x.mean(dim=(2, 3)), self.num_classes)


class DenseNet(_Zoo):
    """reference: vision/densenet.py:35-119 (dense/transition blocks)."""

    def __init__(self, num_init_features: int, growth_rate: int,
                 block_config: Sequence[int], num_classes: int = 1000,
                 input_shape: Sequence[int] = (224, 224, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape, generator)
        self.num_init_features = num_init_features
        self.growth_rate = growth_rate
        self.block_config = list(block_config)
        self.num_classes = num_classes
        self._build()

    def body(self, x, train, rng):
        def bn_relu(x):
            return F.relu(self.bn(x, train))

        def dense_layer(x):
            y = bn_relu(x)
            y = self.conv(y, 4 * self.growth_rate, (1, 1), use_bias=False)
            y = bn_relu(y)
            y = self.conv(y, self.growth_rate, (3, 3), padding=_same(3),
                          use_bias=False)
            return torch.cat([x, y], dim=1)

        x = self.conv(x, self.num_init_features, (7, 7), (2, 2), _same(7),
                      use_bias=False)
        x = bn_relu(x)
        x = max_pool(x, (3, 3), (2, 2), _same(3))
        for bi, n_layers in enumerate(self.block_config):
            for _ in range(n_layers):
                x = dense_layer(x)
            if bi != len(self.block_config) - 1:  # transition
                x = bn_relu(x)
                x = self.conv(x, x.shape[1] // 2, (1, 1), use_bias=False)
                x = avg_pool(x, (2, 2), (2, 2))
        x = bn_relu(x)
        return self.dense(x.mean(dim=(2, 3)), self.num_classes)


_DENSENET_SPEC = {  # reference: densenet.py:24-28
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


class InceptionV3(_Zoo):
    """reference: vision/inception.py:30-208. Canonical input 299x299
    (any >= 75x75 works)."""

    def __init__(self, num_classes: int = 1000,
                 input_shape: Sequence[int] = (299, 299, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_shape, generator)
        self.num_classes = num_classes
        self._build()

    def body(self, x, train, rng):
        def conv(x, ch, kernel, strides=(1, 1), padding="VALID"):
            x = self.conv(x, ch, kernel, strides, padding, use_bias=False)
            return F.relu(self.bn(x, train))

        def pool3(x):
            return avg_pool(x, (3, 3), (1, 1), _same(3))

        def block_a(x, pool_features):
            b1 = conv(x, 64, (1, 1))
            b2 = conv(conv(x, 48, (1, 1)), 64, (5, 5), padding=_same(5))
            b3 = conv(conv(conv(x, 64, (1, 1)), 96, (3, 3),
                           padding=_same(3)), 96, (3, 3), padding=_same(3))
            b4 = conv(pool3(x), pool_features, (1, 1))
            return torch.cat([b1, b2, b3, b4], dim=1)

        def block_b(x):
            b1 = conv(x, 384, (3, 3), (2, 2))
            b2 = conv(conv(conv(x, 64, (1, 1)), 96, (3, 3),
                           padding=_same(3)), 96, (3, 3), (2, 2))
            b3 = max_pool(x, (3, 3), (2, 2))
            return torch.cat([b1, b2, b3], dim=1)

        def block_c(x, ch7):
            b1 = conv(x, 192, (1, 1))
            b2 = conv(conv(conv(x, ch7, (1, 1)), ch7, (1, 7),
                           padding=[(0, 0), (3, 3)]), 192, (7, 1),
                      padding=[(3, 3), (0, 0)])
            b3 = conv(x, ch7, (1, 1))
            b3 = conv(b3, ch7, (7, 1), padding=[(3, 3), (0, 0)])
            b3 = conv(b3, ch7, (1, 7), padding=[(0, 0), (3, 3)])
            b3 = conv(b3, ch7, (7, 1), padding=[(3, 3), (0, 0)])
            b3 = conv(b3, 192, (1, 7), padding=[(0, 0), (3, 3)])
            b4 = conv(pool3(x), 192, (1, 1))
            return torch.cat([b1, b2, b3, b4], dim=1)

        def block_d(x):
            b1 = conv(conv(x, 192, (1, 1)), 320, (3, 3), (2, 2))
            b2 = conv(conv(conv(conv(x, 192, (1, 1)), 192, (1, 7),
                                padding=[(0, 0), (3, 3)]), 192, (7, 1),
                           padding=[(3, 3), (0, 0)]), 192, (3, 3), (2, 2))
            b3 = max_pool(x, (3, 3), (2, 2))
            return torch.cat([b1, b2, b3], dim=1)

        def block_e(x):
            b1 = conv(x, 320, (1, 1))
            b2 = conv(x, 384, (1, 1))
            b2 = torch.cat(
                [conv(b2, 384, (1, 3), padding=[(0, 0), (1, 1)]),
                 conv(b2, 384, (3, 1), padding=[(1, 1), (0, 0)])], dim=1)
            b3 = conv(conv(x, 448, (1, 1)), 384, (3, 3), padding=_same(3))
            b3 = torch.cat(
                [conv(b3, 384, (1, 3), padding=[(0, 0), (1, 1)]),
                 conv(b3, 384, (3, 1), padding=[(1, 1), (0, 0)])], dim=1)
            b4 = conv(pool3(x), 192, (1, 1))
            return torch.cat([b1, b2, b3, b4], dim=1)

        x = conv(x, 32, (3, 3), (2, 2))
        x = conv(x, 32, (3, 3))
        x = conv(x, 64, (3, 3), padding=_same(3))
        x = max_pool(x, (3, 3), (2, 2))
        x = conv(x, 80, (1, 1))
        x = conv(x, 192, (3, 3))
        x = max_pool(x, (3, 3), (2, 2))
        x = block_a(x, 32)
        x = block_a(x, 64)
        x = block_a(x, 64)
        x = block_b(x)
        for ch7 in (128, 160, 160, 192):
            x = block_c(x, ch7)
        x = block_d(x)
        x = block_e(x)
        x = block_e(x)
        x = dropout(x.mean(dim=(2, 3)), 0.5, train, rng)
        return self.dense(x, self.num_classes)


# ---------------------------------------------------------------------------
# factory (reference: vision/__init__.py:91-161 get_model)
# ---------------------------------------------------------------------------

def get_model(name: str, num_classes: int = 1000, seed: int = 42,
              **kwargs):
    """Model factory by gluon zoo name (e.g. ``"vgg16_bn"``,
    ``"mobilenetv2_0.5"``, ``"densenet121"``, ``"resnet50_v1"``), with
    the JAX package's names and defaults; the parameters are drawn from
    a ``torch.Generator`` seeded ``seed``. Vision models take
    ``input_shape=(H, W, C)``."""
    name = name.lower()
    gen = torch.Generator().manual_seed(seed)
    common = dict(num_classes=num_classes, generator=gen)
    if name == "alexnet":
        return AlexNet(**common, **kwargs)
    if name.startswith("vgg"):
        depth = int(name.removeprefix("vgg").removesuffix("_bn"))
        layers, filters = _VGG_SPEC[depth]
        return VGG(layers=layers, filters=filters,
                   batch_norm=name.endswith("_bn"), **common, **kwargs)
    if name.startswith("squeezenet"):
        return SqueezeNet(version=name.removeprefix("squeezenet"),
                          **common, **kwargs)
    if name.startswith("mobilenetv2_"):
        return MobileNetV2(multiplier=float(name.split("_")[1]),
                           **common, **kwargs)
    if name.startswith("mobilenet"):
        return MobileNetV1(multiplier=float(name.removeprefix("mobilenet")),
                           **common, **kwargs)
    if name.startswith("densenet"):
        init, growth, cfg = _DENSENET_SPEC[int(name.removeprefix("densenet"))]
        return DenseNet(num_init_features=init, growth_rate=growth,
                        block_config=cfg, **common, **kwargs)
    if name == "inceptionv3":
        return InceptionV3(**common, **kwargs)
    if name.endswith("_lm") and name[:-3] in ("lstm", "gru", "rnn"):
        from geomx_tpu_torch.models.rnn import RNNModel

        return RNNModel(vocab=num_classes, cell_type=name[:-3],
                        generator=gen, **kwargs)
    if name.startswith("resnet"):
        from geomx_tpu_torch.models.resnet import _CONFIGS, ResNet

        base = name.split("_")[0]  # resnet50_v1 -> resnet50
        if base not in _CONFIGS:
            raise ValueError(f"unknown resnet {base!r}; "
                             f"valid: {sorted(_CONFIGS)}")
        stages, block = _CONFIGS[base]
        # ImageNet stem and input by default (gluon-parity)
        kwargs.setdefault("small_images", False)
        kwargs.setdefault("input_shape", (224, 224, 3))
        return ResNet(stages, block, **common, **kwargs)
    raise ValueError(f"unknown model {name!r}")
