"""Shared example harness for the port's demo CNN.

Counterpart of ``examples/utils.py`` (``build_model_and_step`` for
``model="cnn"`` and ``eval_acc``): a grad step and an eval step over the
flax leaf list, so the device-resident trainer pushes the same keys and
arrays as the JAX package's. The model zoo (``model != "cnn"``) is not
ported yet (ROADMAP queue A item 11).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from geomx_tpu_torch.io import load_data  # noqa: F401  (re-export)


def build_model_and_step(batch_size: int, num_classes: int = 10,
                         input_shape=(28, 28, 1), model: str = "cnn",
                         device=None,
                         init_leaves: Optional[Sequence] = None,
                         seed: int = 42):
    """Returns ``(param_leaves, leaf_names, grad_step, eval_step)``.

    ``param_leaves`` are fp32 numpy arrays in flax leaf order and layout,
    from ``init_leaves`` (e.g. the JAX package's) or a seeded flax-style
    init. ``grad_step(leaves, X, y) -> (loss, grad_leaves)`` takes leaf
    tensors on ``device`` and returns mean-loss gradients in the same
    order and layouts; ``eval_step(leaves, X, y)`` returns the accuracy.
    ``device=None`` is the CUDA card; ``batch_size`` is accepted for the
    JAX signature's sake. On the card this sets cuDNN to fp32 and
    deterministic algorithms for the whole process
    (:func:`geomx_tpu_torch._device.exact_cudnn`)."""
    del batch_size
    if model != "cnn":
        raise NotImplementedError(
            f"model {model!r}: the model zoo is not ported yet (ROADMAP "
            "queue A item 11)")
    from geomx_tpu_torch._device import exact_cudnn, resolve_device
    from geomx_tpu_torch.models.cnn import create_cnn
    from geomx_tpu_torch.models.convert import (LENET_LEAVES,
                                                lenet_flax_leaves,
                                                lenet_params_from_flax,
                                                thread_safe_call)

    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_cudnn()
    h, w, c = input_shape
    flat = 32 * (((h - 4) // 2 - 4) // 2) * (((w - 4) // 2 - 4) // 2)
    net = create_cnn(num_classes, c, flat, seed=seed)
    leaves = ([np.array(l, np.float32, copy=True) for l in init_leaves]
              if init_leaves is not None else lenet_flax_leaves(net))
    call = thread_safe_call(net.to(dev))

    def logits_of(leaf_list, X):
        return call(lenet_params_from_flax(leaf_list), torch.as_tensor(X))

    def grad_step(leaf_list, X, y):
        leaf_list = [p.detach().requires_grad_(True) for p in leaf_list]
        logp = torch.log_softmax(logits_of(leaf_list, X), dim=-1)
        loss = -logp.gather(-1, torch.as_tensor(y).long()[:, None]).mean()
        grads = torch.autograd.grad(loss, leaf_list)
        return loss.detach(), list(grads)

    @torch.no_grad()
    def eval_step(leaf_list, X, y):
        pred = logits_of(leaf_list, X).argmax(dim=-1)
        return (pred == torch.as_tensor(y).long()).float().mean()

    return leaves, [f for f, _n, _k in LENET_LEAVES], grad_step, eval_step


def eval_acc(test_iter, leaves: List[np.ndarray], eval_step,
             device=None) -> float:
    """Mean accuracy of ``leaves`` over ``test_iter`` on ``device``."""
    from geomx_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    tl = [torch.as_tensor(np.asarray(l)).to(dev) for l in leaves]
    accs = [float(eval_step(tl, torch.as_tensor(X).to(dev),
                            torch.as_tensor(y).to(dev)))
            for X, y in test_iter]
    return float(np.mean(accs)) if accs else 0.0
