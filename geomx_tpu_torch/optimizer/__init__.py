"""Optimizers that can run on the global aggregation server.

Mirrors the reference's pattern of shipping a pickled Python optimizer from
the master worker to the global server, where it runs as the updater
(reference: python/mxnet/kvstore.py:452 set_optimizer -> pickled ->
kvstore_server.py:55-60 controller -> kvstore_dist_server.h:507-519
ApplyUpdates, which runs updater_ only when ps::IsGlobalServer()).

The family matches the reference optimizer library surface
(python/mxnet/optimizer/optimizer.py — SGD:452, Signum:558, FTML:625,
DCASGD:872, NAG:928, SGLD:981, Adam:1017, AdaGrad:1099, RMSProp:1158,
AdaDelta:1236, Ftrl:1294, Adamax:1370, Nadam:1426), with the same
update rules and hyperparameter names, plus the reference's
``lr_scheduler`` contract (optimizer.py:41 `_get_lr` + per-index update
counts; schedulers in ``geomx_tpu_torch.lr_scheduler``), and LBSGD:681
(gradient cumulation + warmup/LARS lr scaling — see its class
docstring for the multi-precision divergence). Omitted: the
``ccSGD``/``Test`` aliases.

Counterpart of ``geomx_tpu/optimizer/__init__.py``, the same numpy code:
the global server is a host-side process and the arrays it updates are
parameter-server shards, so the states stay numpy and pickle across the
command channel, and a JAX-package optimizer unpickles onto the class of
the same name here (``kvstore/server.py`` ``_SysModulesUnpickler``).
``update`` also takes CPU torch tensors and returns numpy. All classes
are picklable by construction (plain attributes only).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# module-level on purpose: optimizer steps run in SERVER HANDLER THREADS;
# a function-local import there can wait on a package import lock held by
# another thread (see kvstore.server _SysModulesUnpickler)
from geomx_tpu_torch import kernels_native

__all__ = [
    "Optimizer", "SGD", "NAG", "Signum", "SGLD", "Adam", "Adamax",
    "Nadam", "FTML", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "DCASGD",
    "LBSGD", "create",
]


class Optimizer:
    """Base optimizer: stateful per-key update ``w <- f(w, g)``.

    Tracks per-key update counts; when an ``lr_scheduler`` is attached
    the effective lr is ``scheduler(num_update)`` where ``num_update``
    is the max count over keys (reference: optimizer.py:41 Optimizer,
    lr_scheduler.py:71-80).
    """

    def __init__(self, learning_rate: float = 0.01, wd: float = 0.0,
                 rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None,
                 lr_scheduler=None):
        self.learning_rate = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self._states: Dict = {}
        self._index_update_count: Dict = {}
        self.num_update = 0

    # -- subclass API ----------------------------------------------------

    def create_state(self, key, weight: np.ndarray):
        return None

    def step(self, key, weight: np.ndarray, grad: np.ndarray, state,
             lr: float) -> np.ndarray:
        raise NotImplementedError

    # -- lr / bookkeeping ------------------------------------------------

    def _update_count(self, key) -> int:
        t = self._index_update_count.get(key, 0) + 1
        self._index_update_count[key] = t
        self.num_update = max(self.num_update, t)
        return t

    def _get_lr(self) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.num_update))
        return self.learning_rate

    # -- entry point -----------------------------------------------------

    def update(self, key, weight: np.ndarray, grad: np.ndarray) -> np.ndarray:
        """Return the updated weight as numpy (accepts numpy arrays or CPU
        torch tensors)."""
        grad = np.asarray(grad, dtype=np.float32) * self.rescale_grad
        if self.clip_gradient is not None:
            grad = np.clip(grad, -self.clip_gradient, self.clip_gradient)
        if key not in self._states:
            self._states[key] = self.create_state(key, weight)
        self._update_count(key)
        return self.step(key, np.asarray(weight, dtype=np.float32), grad,
                         self._states[key], self._get_lr())

    # kvstore updater signature: updater(key, grad, weight) -> new weight
    def __call__(self, key, grad: np.ndarray, weight: np.ndarray) -> np.ndarray:
        return self.update(key, weight, grad)

    def get_states(self):
        return self._states

    def set_states(self, states) -> None:
        self._states = states


class SGD(Optimizer):
    """SGD with optional momentum and weight decay (reference:
    optimizer.py:452)."""

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum

    def create_state(self, key, weight):
        if self.momentum == 0.0:
            return None
        return np.zeros_like(weight, dtype=np.float32)

    def step(self, key, weight, grad, state, lr):
        # native path (GIL-free; reference runs this math in C++ too)
        if kernels_native.usable(weight.size):
            w = np.array(weight, dtype=np.float32, copy=True)
            g = np.ascontiguousarray(grad, dtype=np.float32)
            if kernels_native.sgd(w, g, state, lr, self.momentum, self.wd):
                return w
        grad = grad + self.wd * weight
        if state is None:
            return weight - lr * grad
        state *= self.momentum
        state += grad
        return weight - lr * state


class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: optimizer.py:928-978)::

        state = momentum * state + grad + wd * weight
        weight -= lr * (grad + wd * weight + momentum * state)
    """

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum

    def create_state(self, key, weight):
        if self.momentum == 0.0:
            return None
        return np.zeros_like(weight, dtype=np.float32)

    def step(self, key, weight, grad, state, lr):
        grad = grad + self.wd * weight
        if state is None:
            return weight - lr * grad
        state *= self.momentum
        state += grad
        return weight - lr * (grad + self.momentum * state)


class Signum(Optimizer):
    """signSGD / Signum (reference: optimizer.py:558-623)::

        state = momentum * state + (1 - momentum) * rescaled_grad
        weight = (1 - lr * wd_lh) * weight - lr * sign(state)
    """

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.9,
                 wd_lh: float = 0.0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, key, weight):
        if self.momentum == 0.0:
            return None
        return np.zeros_like(weight, dtype=np.float32)

    def step(self, key, weight, grad, state, lr):
        grad = grad + self.wd * weight
        if state is None:
            direction = np.sign(grad)
        else:
            state *= self.momentum
            state += (1.0 - self.momentum) * grad
            direction = np.sign(state)
        return (1.0 - lr * self.wd_lh) * weight - lr * direction


class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (reference:
    optimizer.py:981-1008): SGD half-step plus N(0, lr) noise —
    posterior sampling rather than point optimization."""

    def __init__(self, learning_rate: float = 0.01, seed: int = 0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def step(self, key, weight, grad, state, lr):
        noise = self._rng.normal(
            0.0, np.sqrt(lr), size=weight.shape).astype(np.float32)
        return weight - lr / 2 * (grad + self.wd * weight) + noise


class Adam(Optimizer):
    """Adam (Kingma & Ba). Matches mx.optimizer.Adam hyperparameter names
    (reference: optimizer.py:1017)."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, key, weight):
        return {
            "t": 0,
            "m": np.zeros_like(weight, dtype=np.float32),
            "v": np.zeros_like(weight, dtype=np.float32),
        }

    def step(self, key, weight, grad, state, lr):
        state["t"] += 1
        t = state["t"]
        m, v = state["m"], state["v"]
        # native path (GIL-free; reference runs this math in C++ too)
        if kernels_native.usable(weight.size):
            w = np.array(weight, dtype=np.float32, copy=True)
            g = np.ascontiguousarray(grad, dtype=np.float32)
            if kernels_native.adam(w, g, m, v, lr, self.beta1, self.beta2,
                                   self.epsilon, self.wd, t):
                return w
        grad = grad + self.wd * weight
        m *= self.beta1
        m += (1 - self.beta1) * grad
        v *= self.beta2
        v += (1 - self.beta2) * np.square(grad)
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        return weight - lr * mhat / (np.sqrt(vhat) + self.epsilon)


class Adamax(Optimizer):
    """AdaMax — Adam with the infinity norm (reference:
    optimizer.py:1370-1424)::

        m = beta1 * m + (1 - beta1) * grad
        u = max(beta2 * u, |grad|)
        weight -= lr / (1 - beta1^t) * m / u
    """

    def __init__(self, learning_rate: float = 0.002, beta1: float = 0.9,
                 beta2: float = 0.999, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, key, weight):
        return {"t": 0, "m": np.zeros_like(weight, np.float32),
                "u": np.zeros_like(weight, np.float32)}

    def step(self, key, weight, grad, state, lr):
        state["t"] += 1
        t = state["t"]
        grad = grad + self.wd * weight
        m, u = state["m"], state["u"]
        m *= self.beta1
        m += (1 - self.beta1) * grad
        np.maximum(self.beta2 * u, np.abs(grad), out=u)
        return weight - lr / (1 - self.beta1 ** t) * m / np.maximum(
            u, 1e-12)


class Nadam(Optimizer):
    """Nesterov Adam (reference: optimizer.py:1426-1492), with the
    warming momentum schedule ``beta1 * (1 - 0.5 * 0.96^(t*decay))``."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 schedule_decay: float = 0.004, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, key, weight):
        return {"t": 0, "m": np.zeros_like(weight, np.float32),
                "v": np.zeros_like(weight, np.float32)}

    def step(self, key, weight, grad, state, lr):
        state["t"] += 1
        t = state["t"]
        grad = grad + self.wd * weight
        momentum_t = self.beta1 * (
            1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (
            1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule *= momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state["m"], state["v"]
        m *= self.beta1
        m += (1 - self.beta1) * grad
        v *= self.beta2
        v += (1 - self.beta2) * np.square(grad)
        grad_prime = grad / (1 - self.m_schedule)
        m_prime = m / (1 - m_schedule_next)
        v_prime = v / (1 - self.beta2 ** t)
        m_bar = (1 - momentum_t) * grad_prime + momentum_t_1 * m_prime
        return weight - lr * m_bar / (np.sqrt(v_prime) + self.epsilon)


class FTML(Optimizer):
    """Follow the Moving Leader (reference: optimizer.py:625-678)::

        v = beta2 * v + (1 - beta2) * grad^2
        d_t = (1 - beta1^t) / lr * (sqrt(v / (1 - beta2^t)) + eps)
        z = beta1 * z + (1 - beta1) * grad - (d_t - beta1 * d_{t-1}) * w
        weight = -z / d_t
    """

    def __init__(self, learning_rate: float = 0.0025, beta1: float = 0.6,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, key, weight):
        return {"t": 0, "d": np.zeros_like(weight, np.float32),
                "v": np.zeros_like(weight, np.float32),
                "z": np.zeros_like(weight, np.float32)}

    def step(self, key, weight, grad, state, lr):
        state["t"] += 1
        t = state["t"]
        grad = grad + self.wd * weight
        d, v, z = state["d"], state["v"], state["z"]
        v *= self.beta2
        v += (1 - self.beta2) * np.square(grad)
        d_t = (1 - self.beta1 ** t) / lr * (
            np.sqrt(v / (1 - self.beta2 ** t)) + self.epsilon)
        z *= self.beta1
        z += (1 - self.beta1) * grad - (d_t - self.beta1 * d) * weight
        d[...] = d_t
        return -z / d_t


class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.py:1099-1155)::

        history += grad^2
        weight -= lr * (grad / sqrt(history + eps) + wd * weight)
    """

    def __init__(self, learning_rate: float = 0.01, eps: float = 1e-7,
                 **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.float_stable_eps = eps

    def create_state(self, key, weight):
        return np.zeros_like(weight, dtype=np.float32)

    def step(self, key, weight, grad, state, lr):
        state += np.square(grad)
        div = grad / np.sqrt(state + self.float_stable_eps)
        return weight - lr * (div + self.wd * weight)


class RMSProp(Optimizer):
    """RMSProp, plain (Tieleman & Hinton 2012) or centered (Graves
    2013) (reference: optimizer.py:1158-1234)."""

    def __init__(self, learning_rate: float = 0.001, gamma1: float = 0.9,
                 gamma2: float = 0.9, epsilon: float = 1e-8,
                 centered: bool = False,
                 clip_weights: Optional[float] = None, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, key, weight):
        n = np.zeros_like(weight, dtype=np.float32)
        if not self.centered:
            return {"n": n}
        return {"n": n, "g": np.zeros_like(weight, np.float32),
                "delta": np.zeros_like(weight, np.float32)}

    def step(self, key, weight, grad, state, lr):
        grad = grad + self.wd * weight
        n = state["n"]
        n *= self.gamma1
        n += (1 - self.gamma1) * np.square(grad)
        if not self.centered:
            w = weight - lr * grad / np.sqrt(n + self.epsilon)
        else:
            g, delta = state["g"], state["delta"]
            g *= self.gamma1
            g += (1 - self.gamma1) * grad
            delta *= self.gamma2
            delta -= lr * grad / np.sqrt(n - np.square(g) + self.epsilon)
            w = weight + delta
        if self.clip_weights:
            w = np.clip(w, -self.clip_weights, self.clip_weights)
        return w


class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py:1236-1291)::

        acc_g = rho * acc_g + (1 - rho) * grad^2
        delta = sqrt(acc_delta + eps) / sqrt(acc_g + eps) * grad
        acc_delta = rho * acc_delta + (1 - rho) * delta^2
        weight -= delta + wd * weight
    """

    def __init__(self, learning_rate: float = 1.0, rho: float = 0.9,
                 epsilon: float = 1e-5, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, key, weight):
        return {"acc_g": np.zeros_like(weight, np.float32),
                "acc_delta": np.zeros_like(weight, np.float32)}

    def step(self, key, weight, grad, state, lr):
        acc_g, acc_delta = state["acc_g"], state["acc_delta"]
        acc_g *= self.rho
        acc_g += (1 - self.rho) * np.square(grad)
        delta = (np.sqrt(acc_delta + self.epsilon)
                 / np.sqrt(acc_g + self.epsilon) * grad)
        acc_delta *= self.rho
        acc_delta += (1 - self.rho) * np.square(delta)
        return weight - delta - self.wd * weight


class Ftrl(Optimizer):
    """FTRL-Proximal (reference: optimizer.py:1294-1367)::

        z += grad - (sqrt(n + grad^2) - sqrt(n)) * weight / lr
        n += grad^2
        w = (sign(z) * lamda1 - z) / ((beta + sqrt(n)) / lr + wd)
            * (|z| > lamda1)
    """

    def __init__(self, lamda1: float = 0.01, learning_rate: float = 0.1,
                 beta: float = 1.0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, key, weight):
        return {"z": np.zeros_like(weight, np.float32),
                "n": np.zeros_like(weight, np.float32)}

    def step(self, key, weight, grad, state, lr):
        z, n = state["z"], state["n"]
        z += grad - (np.sqrt(n + np.square(grad)) - np.sqrt(n)) * weight / lr
        n += np.square(grad)
        return ((np.sign(z) * self.lamda1 - z)
                / ((self.beta + np.sqrt(n)) / lr + self.wd)
                * (np.abs(z) > self.lamda1))


class DCASGD(Optimizer):
    """Delay-Compensated ASGD (reference: optimizer.py:872-930).

    Used by MixedSync on the global server: compensates gradient staleness
    with the term ``lambda * g * g * (w - w_prev)`` where ``w_prev`` is the
    weight snapshot from when the (stale) gradient departed.
    """

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 lamda: float = 0.04, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, key, weight):
        mom = None if self.momentum == 0.0 else np.zeros_like(weight, np.float32)
        return {"mom": mom, "prev": np.array(weight, dtype=np.float32, copy=True)}

    def step(self, key, weight, grad, state, lr):
        prev = state["prev"]
        comp = grad + self.wd * weight + self.lamda * grad * grad * (weight - prev)
        if state["mom"] is not None:
            state["mom"] *= self.momentum
            state["mom"] -= lr * comp
            new_w = weight + state["mom"]
        else:
            new_w = weight - lr * comp
        # Snapshot the PRE-update weight (reference: optimizer.py:924
        # previous_weight[:] = weight before the update), so the next call's
        # (weight - prev) spans exactly one update and the delay-compensation
        # term is nonzero for stale gradients.
        state["prev"] = np.array(weight, dtype=np.float32, copy=True)
        return new_w


class LBSGD(Optimizer):
    """Large-Batch SGD: gradient cumulation to an effective macro-batch
    plus a warmup-scheduled (or LARS layer-adaptive) lr multiplier
    (reference: optimizer.py:681-860).

    Per key: micro-batch gradients accumulate until ``batch_scale`` of
    them arrived; the macro update then runs heavy-ball SGD on the mean
    with lr scaled by the warmup schedule ('linear' | 'power2' | 'sqrt'
    over ``warmup_epochs * updates_per_epoch`` macro-steps, ramping
    1 -> batch_scale) or by the LARS trust ratio ('lars':
    sqrt(||w||^2 / (||g||^2 + wd*||w||^2)), clipped to [0.01, 100]).
    Off-boundary micro-steps leave the weight unchanged.

    Divergence from the reference (documented): its per-optimizer fp16
    master-copy machinery (multi_precision state tuples) is subsumed by
    the server's fp32 master path (kvstore.server._run_updater), so the
    optimizer itself is precision-agnostic.
    """

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 warmup_strategy: str = "linear", warmup_epochs: int = 5,
                 batch_scale: int = 1, updates_per_epoch: int = 32,
                 begin_epoch: int = 0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        if warmup_strategy not in ("linear", "power2", "sqrt", "lars"):
            raise ValueError(f"bad warmup_strategy {warmup_strategy!r}")
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = max(int(batch_scale), 1)
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch

    def create_state(self, key, weight):
        # "micro" counts gradients toward the NEXT macro boundary;
        # "macro" counts completed macro updates (seeded by begin_epoch)
        # — one counter for both (the reference's num_cums) misaligns
        # the boundary whenever init_updates % batch_scale != 0
        return {"mom": (np.zeros_like(weight, np.float32)
                        if self.momentum else None),
                "cum": None, "micro": 0, "macro": self.init_updates}

    def _lbmult(self, nup: int) -> float:
        """Warmup multiplier ramping 1 -> batch_scale (reference
        :758-776)."""
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            return maxmult
        if nwup <= 1:
            return 1.0
        if self.warmup_strategy == "linear":
            return 1.0 + (maxmult - 1) * nup / nwup
        if self.warmup_strategy == "power2":
            return 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        if self.warmup_strategy == "sqrt":
            return 1.0 + (maxmult - 1) * float(np.sqrt(nup / nwup))
        return 1.0

    def _lars(self, weight, g) -> float:
        """LARS trust ratio, clipped (reference :778-789)."""
        w2 = float(np.sum(weight * weight))
        g2 = float(np.sum(g * g))
        lars = float(np.sqrt(w2 / (g2 + self.wd * w2 + 1e-18)))
        return float(np.clip(lars, 0.01, 100.0))

    def step(self, key, weight, grad, state, lr):
        state["cum"] = (grad.copy() if state["cum"] is None
                        else state["cum"] + grad)
        state["micro"] += 1
        if state["micro"] % self.batch_scale != 0:
            return weight          # mid-macro-batch: accumulate only
        g = state["cum"] / self.batch_scale
        state["cum"] = None
        state["macro"] += 1
        mult = (self._lars(weight, g) if self.warmup_strategy == "lars"
                else self._lbmult(state["macro"]))
        eff_lr = lr * mult
        comp = g + self.wd * weight
        if state["mom"] is not None:
            state["mom"] *= self.momentum
            state["mom"] += eff_lr * comp
            return weight - state["mom"]
        return weight - eff_lr * comp


_REGISTRY = {
    "sgd": SGD, "nag": NAG, "signum": Signum, "sgld": SGLD,
    "adam": Adam, "adamax": Adamax, "nadam": Nadam, "ftml": FTML,
    "adagrad": AdaGrad, "rmsprop": RMSProp, "adadelta": AdaDelta,
    "ftrl": Ftrl, "dcasgd": DCASGD, "lbsgd": LBSGD,
}


def create(name: str, **kwargs) -> Optimizer:
    """Create an optimizer by name (mirrors mx.optimizer.create)."""
    return _REGISTRY[name.lower()](**kwargs)
