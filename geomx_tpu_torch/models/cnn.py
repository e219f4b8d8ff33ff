"""The reference demo CNN (LeNet) as a torch module.

Counterpart of ``geomx_tpu/models/cnn.py`` (reference:
examples/cnn.py:56-63): Conv(16,5x5)+relu -> maxpool(2,2) ->
Conv(32,5x5)+relu -> maxpool(2,2) -> Dense(256)+relu -> Dense(128)+relu
-> Dense(10). Inputs are NHWC like the JAX module's; the convolutions run
NCHW (cuDNN's layout), and the features are flattened in NHWC order so
``Dense_0`` sees its inputs in the JAX package's order.

Parameters are torch-native (OIHW conv weights, ``[out, in]`` linear
weights); :mod:`geomx_tpu_torch.models.convert` maps them to and from
the flax leaf list (HWIO conv kernels, ``[in, out]`` dense kernels,
sorted keys).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LeNetCNN", "create_cnn"]


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: normal truncated at ±2 std, variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class LeNetCNN(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 flat_features: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, 16, 5)
        self.conv1 = nn.Conv2d(16, 32, 5)
        self.dense0 = nn.Linear(flat_features, 256)
        self.dense1 = nn.Linear(256, 128)
        self.dense2 = nn.Linear(128, num_classes)
        for m in (self.conv0, self.conv1, self.dense0, self.dense1,
                  self.dense2):
            fan_in = m.weight[0].numel()
            _lecun_normal_(m.weight, fan_in, generator)
            nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [N, H, W, C] -> NCHW for the convolutions
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        # flatten in NHWC order, as the JAX module does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.dense0(x))
        x = F.relu(self.dense1(x))
        return self.dense2(x)


def create_cnn(num_classes: int = 10, in_channels: int = 1,
               flat_features: int = 512, seed: int = 42) -> LeNetCNN:
    return LeNetCNN(num_classes, in_channels, flat_features,
                    generator=torch.Generator().manual_seed(seed))
