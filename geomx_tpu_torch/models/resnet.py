"""ResNet family (v1, basic + bottleneck blocks) as torch modules.

Counterpart of ``geomx_tpu/models/resnet.py`` (reference:
python/mxnet/gluon/model_zoo/vision/resnet.py — resnet18/34/50/101/152),
written as :class:`~geomx_tpu_torch.models.layers.Compact` modules so
the parameter paths are the flax module's (``BottleneckBlock_10.Conv_2``,
``downsample``). Inputs are NHWC like the JAX module's; the body runs
NCHW.

Bottleneck blocks stride the 3x3 conv (the "v1.5" placement) as the JAX
package does, instead of the reference v1's strided first 1x1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from geomx_tpu_torch.models.layers import Compact, max_pool

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "create_resnet"]

_PAD1 = [(1, 1), (1, 1)]


class BasicBlock(Compact):
    def __init__(self, filters: int, strides: Tuple[int, int] = (1, 1), *,
                 input_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.filters, self.strides = filters, tuple(strides)
        self.build(input_shape)

    def body(self, x, train, rng):
        residual = x
        y = self.conv(x, self.filters, (3, 3), self.strides, _PAD1,
                      use_bias=False)
        y = F.relu(self.bn(y, train))
        y = self.conv(y, self.filters, (3, 3), padding=_PAD1,
                      use_bias=False)
        y = self.bn(y, train)
        if residual.shape != y.shape:
            residual = self.conv(residual, self.filters, (1, 1),
                                 self.strides, use_bias=False,
                                 name="downsample")
            residual = self.bn(residual, train)
        return F.relu(y + residual)


class BottleneckBlock(Compact):
    def __init__(self, filters: int, strides: Tuple[int, int] = (1, 1), *,
                 input_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.filters, self.strides = filters, tuple(strides)
        self.build(input_shape)

    def body(self, x, train, rng):
        residual = x
        y = self.conv(x, self.filters, (1, 1), use_bias=False)
        y = F.relu(self.bn(y, train))
        y = self.conv(y, self.filters, (3, 3), self.strides, _PAD1,
                      use_bias=False)
        y = F.relu(self.bn(y, train))
        y = self.conv(y, 4 * self.filters, (1, 1), use_bias=False)
        y = self.bn(y, train)
        if residual.shape != y.shape:
            residual = self.conv(residual, 4 * self.filters, (1, 1),
                                 self.strides, use_bias=False,
                                 name="downsample")
            residual = self.bn(residual, train)
        return F.relu(y + residual)


class ResNet(Compact):
    """``small_images``: the CIFAR stem (3x3 conv, no pool); otherwise the
    ImageNet stem (7x7 stride-2 conv, 3x3 stride-2 max pool).
    ``input_shape`` is ``(H, W, C)``, as the JAX examples give it."""

    def __init__(self, stage_sizes: Sequence[int], block=BasicBlock,
                 num_classes: int = 10, small_images: bool = True,
                 input_shape: Sequence[int] = (32, 32, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.stage_sizes = list(stage_sizes)
        self.block = block
        self.num_classes = num_classes
        self.small_images = small_images
        h, w, c = input_shape
        self.build((c, h, w))

    def body(self, x, train, rng):
        if self.small_images:
            x = self.conv(x, 64, (3, 3), padding=_PAD1, use_bias=False)
            x = F.relu(self.bn(x, train))
        else:
            x = self.conv(x, 64, (7, 7), (2, 2), [(3, 3), (3, 3)],
                          use_bias=False)
            x = F.relu(self.bn(x, train))
            x = max_pool(x, (3, 3), (2, 2), _PAD1)
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                x = self.sub(self.block, x, train, rng, 64 * 2 ** i,
                             strides)
        x = x.mean(dim=(2, 3))
        return self.dense(x, self.num_classes).float()

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: ``[N, H, W, C]``; returns fp32 logits."""
        dt = self.Dense_0.weight.dtype
        return self.run(x.to(dt).permute(0, 3, 1, 2), train, rng)


_CONFIGS = {
    "resnet18": ([2, 2, 2, 2], BasicBlock),
    "resnet34": ([3, 4, 6, 3], BasicBlock),
    "resnet50": ([3, 4, 6, 3], BottleneckBlock),
    "resnet101": ([3, 4, 23, 3], BottleneckBlock),
    "resnet152": ([3, 8, 36, 3], BottleneckBlock),
}


def create_resnet(name: str = "resnet18", num_classes: int = 10,
                  small_images: bool = True,
                  input_shape: Sequence[int] = (32, 32, 3),
                  seed: int = 42) -> ResNet:
    """Zoo factory (reference: model_zoo.vision.get_resnet)."""
    if name not in _CONFIGS:
        raise ValueError(f"unknown resnet {name!r}; "
                         f"valid: {sorted(_CONFIGS)}")
    stages, block = _CONFIGS[name]
    return ResNet(stages, block, num_classes, small_images, input_shape,
                  generator=torch.Generator().manual_seed(seed))
