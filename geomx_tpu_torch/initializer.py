"""Weight initializers (reference: python/mxnet/initializer.py).

Counterpart of ``geomx_tpu/initializer.py``, copied numpy for numpy:
per-instance seeded RNG (deterministic across workers — every worker
initializes identical params, matching the examples' fixed-seed
convention) plus ``as_torch(init)`` to fill a torch tensor in place
from a ``torch.Generator``, the counterpart of the JAX package's
``as_flax``. Name-pattern dispatch
follows the reference: ``__call__(name, arr)`` routes *_bias ->
zeros, *_gamma -> ones, *_beta -> zeros, *_weight -> ``_init_weight``
(reference: initializer.py:54 Initializer._legacy_init).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np

__all__ = [
    "Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
    "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
    "Mixed", "create", "as_torch",
]


class Initializer:
    """Base: name-aware dispatch + ``init(shape)`` convenience."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)

    # -- subclass hook ---------------------------------------------------

    def _init_weight(self, name: str, arr: np.ndarray) -> None:
        raise NotImplementedError

    def _init_bias(self, name: str, arr: np.ndarray) -> None:
        """Overridable bias hook (LSTMBias routes here; reference
        dispatches *_bias to _init_bias the same way)."""
        arr[...] = 0.0

    # -- entry points ----------------------------------------------------

    def __call__(self, name: str, arr: np.ndarray) -> None:
        """In-place init routed by parameter-name suffix (reference:
        _legacy_init, initializer.py:197-249)."""
        if name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("beta"):
            arr[...] = 0.0
        elif name.endswith("gamma"):
            arr[...] = 1.0
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            arr[...] = 0.0
        elif name.endswith("moving_var") or name.endswith("running_var"):
            arr[...] = 1.0
        else:
            self._init_weight(name, arr)

    def init(self, shape, name: str = "weight",
             dtype=np.float32) -> np.ndarray:
        out = np.zeros(shape, dtype)
        self(name, out)
        return out


class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[...] = 0.0


class One(Initializer):
    def _init_weight(self, name, arr):
        arr[...] = 1.0


class Constant(Initializer):
    def __init__(self, value: float = 0.0, **kw):
        super().__init__(**kw)
        self.value = value

    def _init_weight(self, name, arr):
        arr[...] = self.value


class Uniform(Initializer):
    """U(-scale, scale) (reference: initializer.py:455)."""

    def __init__(self, scale: float = 0.07, **kw):
        super().__init__(**kw)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr[...] = self._rng.uniform(-self.scale, self.scale, arr.shape)


class Normal(Initializer):
    """N(0, sigma) (reference: initializer.py:488)."""

    def __init__(self, sigma: float = 0.01, **kw):
        super().__init__(**kw)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr[...] = self._rng.normal(0.0, self.sigma, arr.shape)


class Orthogonal(Initializer):
    """SVD-orthogonalized random matrix (reference: initializer.py:521;
    Saxe et al. 2013)."""

    def __init__(self, scale: float = 1.414, rand_type: str = "uniform",
                 **kw):
        super().__init__(**kw)
        if rand_type not in ("uniform", "normal"):
            raise ValueError("rand_type must be uniform|normal")
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self._rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = self._rng.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        arr[...] = (self.scale * res).reshape(arr.shape)


class Xavier(Initializer):
    """Glorot init, mxnet conventions (reference: initializer.py:558):
    fan_in = shape[1]*prod(shape[2:]), fan_out = shape[0]*prod(shape[2:]);
    scale = sqrt(magnitude / factor)."""

    def __init__(self, rnd_type: str = "uniform",
                 factor_type: str = "avg", magnitude: float = 3.0, **kw):
        super().__init__(**kw)
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError("rnd_type must be uniform|gaussian")
        if factor_type not in ("avg", "in", "out"):
            raise ValueError("factor_type must be avg|in|out")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(
                f"Xavier cannot initialize vector {name!r}: needs >= 2D")
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[...] = self._rng.uniform(-scale, scale, shape)
        else:
            arr[...] = self._rng.normal(0.0, scale, shape)


class MSRAPrelu(Xavier):
    """He/MSRA init for (P)ReLU nets (reference: initializer.py:624)."""

    def __init__(self, factor_type: str = "avg", slope: float = 0.25,
                 **kw):
        super().__init__("gaussian", factor_type,
                         2.0 / (1 + slope ** 2), **kw)
        self.slope = slope


class Bilinear(Initializer):
    """Bilinear upsampling kernel for transposed convs
    (reference: initializer.py:648)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) != 4:
            raise ValueError("Bilinear needs a 4D conv kernel")
        weight = np.zeros(int(np.prod(shape)), np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[...] = weight.reshape(shape)


class LSTMBias(Initializer):
    """Zeros except the forget-gate quarter set to ``forget_bias``
    (reference: initializer.py:666; gate order i, f, c, o)."""

    def __init__(self, forget_bias: float = 1.0, **kw):
        super().__init__(**kw)
        self.forget_bias = forget_bias

    def _init_bias(self, name, arr):
        arr[...] = 0.0
        num_hidden = arr.shape[0] // 4
        arr[num_hidden:2 * num_hidden] = self.forget_bias

    _init_weight = _init_bias


class Mixed:
    """Patterned dispatch: first regex that matches the param name wins
    (reference: initializer.py:345)."""

    def __init__(self, patterns, initializers):
        import re

        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers length mismatch")
        self._map = [(re.compile(p), i) for p, i in
                     zip(patterns, initializers)]

    def __call__(self, name: str, arr: np.ndarray) -> None:
        for pat, init in self._map:
            if pat.match(name):
                init(name, arr)
                return
        raise ValueError(
            f"no initializer pattern matches parameter {name!r}; "
            "add a catch-all '.*' pattern")


_REGISTRY: Dict[str, Callable[..., Initializer]] = {
    "zero": Zero, "zeros": Zero, "one": One, "ones": One,
    "constant": Constant, "uniform": Uniform, "normal": Normal,
    "orthogonal": Orthogonal, "xavier": Xavier, "msraprelu": MSRAPrelu,
    "bilinear": Bilinear, "lstmbias": LSTMBias,
}


def create(name: Union[str, Initializer], **kwargs) -> Initializer:
    if isinstance(name, Initializer):
        return name
    if name.lower() not in _REGISTRY:
        raise ValueError(f"unknown initializer {name!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name.lower()](**kwargs)


def _seed_of(generator) -> int:
    """The numpy seed for ``generator``: its seed as the two 32-bit words
    of the key ``jax.random.PRNGKey(seed)`` holds, folded as the JAX
    package's ``as_flax`` folds a key's words."""
    seed = int(generator.initial_seed())
    words = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint64)
    return int((words[0] * np.uint64(2654435761) ^ words[-1])
               % np.uint64(2 ** 31 - 1))


def as_torch(init: Union[str, Initializer], name: str = "weight"):
    """Adapt to ``fn(tensor, generator=None) -> tensor``, which fills
    ``tensor`` in place (any device and float dtype) and returns it.

    The numpy-side init runs on the host with a seed taken from
    ``generator`` (``torch.default_generator`` when None), so results
    are deterministic per seed, and a generator seeded ``s`` gives the
    array that the JAX package's ``as_flax(init, name)`` gives for
    ``jax.random.PRNGKey(s)`` at the same shape.
    """
    import copy

    import torch

    init = create(init) if isinstance(init, str) else init

    def fn(tensor, generator=None):
        clone = copy.deepcopy(init)
        clone._rng = np.random.RandomState(
            _seed_of(generator or torch.default_generator))
        host = clone.init(tuple(tensor.shape), name=name)
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(host))
        return tensor

    return fn
