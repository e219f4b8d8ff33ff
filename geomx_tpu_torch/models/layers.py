"""Flax-shaped building blocks for the port's model zoo.

The zoo's flax modules are ``nn.compact``: each layer is created where
the forward first calls it, takes its input width from the tensor it
sees, and is named after its class with a per-parent counter
(``Conv_0``, ``BatchNorm_3``, ``BottleneckBlock_10``) unless it is named
explicitly. :class:`Compact` gives a torch module the same shape: its
``body(x, train, rng)`` is written once, like the flax ``__call__``; the
constructor runs it on a ``meta`` tensor of the input shape, which
creates the layers in call order under flax's names without computing
anything, and every later forward takes the same layers in the same
order. So a port module's parameter paths are the flax paths, and
:mod:`geomx_tpu_torch.models.convert` moves the leaves across by path.

Layouts are torch's: the body runs NCHW, conv weights are OIHW, dense
weights ``[out, in]``. Each layer's ``FLAX`` table names its flax leaf
and the layout change (``conv``: HWIO <-> OIHW, ``dense``: transpose).

Parity traps the layers take care of:

- ``BatchNorm`` follows flax: momentum 0.99, eps 1e-5, and the *biased*
  batch variance both to normalize and to update the running variance
  (``torch.nn.BatchNorm2d`` would update with the unbiased one at
  momentum 0.1). It normalizes with ``F.batch_norm`` given no running
  stats and updates the stats itself.
- ``Conv(padding="SAME")`` pads as flax does: the total padding of a
  dimension is ``max((ceil(n / s) - 1) s + k - n, 0)``, the larger half
  after the input, so a strided SAME conv may pad asymmetrically; then
  it pads explicitly before the convolution.
- ``max_pool`` defaults to VALID; ``avg_pool`` counts the padding, as
  flax's ``nn.avg_pool`` does.
- ``dropout`` draws its mask from an explicit ``torch.Generator`` (the
  flax module's ``rngs={"dropout": key}``): the masks are torch's own.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from geomx_tpu_torch.models.cnn import _lecun_normal_

__all__ = ["Compact", "Conv", "Dense", "BatchNorm", "Embed", "max_pool",
           "avg_pool", "dropout"]

Padding = Union[str, Sequence[Tuple[int, int]]]


def _meta(t: Optional[torch.Tensor], x: torch.Tensor):
    """``t`` as a meta tensor when ``x`` is one (the shape-only pass)."""
    return t.to("meta") if t is not None and x.is_meta else t


def _pads(padding: Padding, spatial: Sequence[int], kernel: Sequence[int],
          strides: Sequence[int]) -> List[Tuple[int, int]]:
    if isinstance(padding, str):
        if padding == "VALID":
            return [(0, 0)] * len(kernel)
        if padding != "SAME":
            raise ValueError(f"padding {padding!r}")
        out = []
        for n, k, s in zip(spatial, kernel, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    return [tuple(p) for p in padding]


def _padded(x: torch.Tensor, pads: List[Tuple[int, int]], value=0.0):
    """``(x, symmetric pads)``: asymmetric padding is applied to ``x``
    here, symmetric padding is left to the op."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, value=value), (0,) * len(pads)


class Conv(nn.Module):
    """flax ``nn.Conv`` (2-D, default padding SAME) on NCHW inputs."""

    FLAX = {"weight": ("kernel", "conv"), "bias": ("bias", "")}

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides=(1, 1),
                 padding: Padding = "SAME", feature_group_count: int = 1,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel_size
        per_group = in_features // feature_group_count
        self.weight = nn.Parameter(torch.empty(features, per_group, kh, kw))
        _lecun_normal_(self.weight, per_group * kh * kw, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = feature_group_count

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _pads(self.padding, x.shape[2:], self.kernel_size,
                     self.strides)
        x, sym = _padded(x, pads)
        return F.conv2d(x, _meta(self.weight, x), _meta(self.bias, x),
                        self.strides, sym, 1, self.groups)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``[out, in]`` weight here, ``[in, out]`` kernel
    in flax."""

    FLAX = {"weight": ("kernel", "dense"), "bias": ("bias", "")}

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        _lecun_normal_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _meta(self.weight, x), _meta(self.bias, x))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over axis 1 (the channels of NCHW)."""

    FLAX = {"weight": ("scale", ""), "bias": ("bias", "")}
    FLAX_STATS = {"running_mean": "mean", "running_var": "var"}

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum = momentum
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = x.dtype            # bf16 / fp16 normalize in fp32
        ct = dt if dt in (torch.float32, torch.float64) else torch.float32
        xf = x.to(ct)
        w, b = _meta(self.weight, x).to(ct), _meta(self.bias, x).to(ct)
        if not train:
            return F.batch_norm(xf, _meta(self.running_mean, x).to(ct),
                                _meta(self.running_var, x).to(ct), w, b,
                                False, 0.0, self.epsilon).to(dt)
        if not x.is_meta:
            with torch.no_grad():
                dims = [0] + list(range(2, x.dim()))
                var, mean = torch.var_mean(xf, dim=dims, unbiased=False)
                m, st = self.momentum, self.running_mean.dtype
                self.running_mean.mul_(m).add_(mean.to(st), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.to(st), alpha=1.0 - m)
        return F.batch_norm(xf, None, None, w, b, True, 0.0,
                            self.epsilon).to(dt)


class Embed(nn.Module):
    """flax ``nn.Embed`` (the same ``[num, features]`` layout)."""

    FLAX = {"weight": ("embedding", "")}

    def __init__(self, num_embeddings: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        nn.init.normal_(self.weight, 0.0, 1.0 / math.sqrt(features),
                        generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.weight)


def max_pool(x: torch.Tensor, window, strides, padding: Padding = "VALID"):
    pads = _pads(padding, x.shape[2:], window, strides)
    x, sym = _padded(x, pads, value=-math.inf)
    return F.max_pool2d(x, window, strides, sym)


def avg_pool(x: torch.Tensor, window, strides, padding: Padding = "VALID"):
    """Counts the padding in each window's mean, as flax does."""
    pads = _pads(padding, x.shape[2:], window, strides)
    x, sym = _padded(x, pads)
    return F.avg_pool2d(x, window, strides, sym, count_include_pad=True)


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not train)``: keeps each
    element with probability ``1 - rate`` and scales it by its inverse;
    the mask is drawn from ``rng``, which a train-mode call must give."""
    if not train or rate == 0.0 or x.is_meta:
        return x
    if rng is None:
        raise ValueError("a train-mode dropout needs a torch.Generator "
                         "(rng=...)")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Compact(nn.Module):
    """A module written like a flax ``nn.compact`` one (see the module
    docstring). Subclasses implement ``body(x, train, rng)`` over NCHW
    tensors and create layers through :meth:`conv`, :meth:`dense`,
    :meth:`bn` and :meth:`sub`; their constructor ends with
    ``self.build(input_shape)``, ``input_shape`` being ``(C, H, W)``."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._counts: Dict[str, int] = {}
        self._order: List[nn.Module] = []
        self._cursor = -1               # -1: building
        self._gen = generator

    def body(self, x, train: bool, rng):
        raise NotImplementedError

    def build(self, input_shape: Sequence[int]) -> None:
        self.body(torch.empty(1, *input_shape, device="meta"), False, None)
        self._cursor = 0
        self._gen = None                # not kept: a copy needs no RNG

    def run(self, x: torch.Tensor, train: bool = False,
            rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``body`` on an NCHW tensor with the built layers."""
        self._cursor = 0
        out = self.body(x, train, rng)
        if self._cursor != len(self._order):
            raise RuntimeError(f"{type(self).__name__}: the forward used "
                               f"{self._cursor} of {len(self._order)} "
                               "layers")
        return out

    def _layer(self, kind: str, make, name: Optional[str] = None):
        if self._cursor < 0:
            module = make()
            if name is None:
                n = self._counts.get(kind, 0)
                self._counts[kind] = n + 1
                name = f"{kind}_{n}"
            self.add_module(name, module)
            self._order.append(module)
            return module
        module = self._order[self._cursor]
        self._cursor += 1
        return module

    def conv(self, x, features: int, kernel_size, strides=(1, 1),
             padding: Padding = "SAME", feature_group_count: int = 1,
             use_bias: bool = True, name: Optional[str] = None):
        return self._layer("Conv", lambda: Conv(
            x.shape[1], features, kernel_size, strides, padding,
            feature_group_count, use_bias, self._gen), name)(x)

    def dense(self, x, features: int, name: Optional[str] = None):
        return self._layer("Dense", lambda: Dense(
            x.shape[-1], features, generator=self._gen), name)(x)

    def bn(self, x, train: bool, name: Optional[str] = None):
        return self._layer("BatchNorm", lambda: BatchNorm(x.shape[1]),
                           name)(x, train)

    def sub(self, cls, x, train: bool, rng, *args, **kw):
        """A nested Compact module ``cls(*args, input_shape=..., **kw)``,
        auto-named after its class, applied to ``x``."""
        return self._layer(cls.__name__, lambda: cls(
            *args, input_shape=tuple(x.shape[1:]), generator=self._gen,
            **kw)).run(x, train, rng)
