"""Shared example harness for the port's demo CNN.

Counterpart of ``examples/utils.py``: ``build_model_and_step`` for
``model="cnn"`` (a grad step and an eval step over the flax leaf list,
so the port's workers push the same keys and arrays as the JAX
package's), ``host_grad_step`` (one packed transfer each way per
round, the counterpart of ``build_flat_step``), ``eval_acc`` and the
``Measure`` JSON reporter, and ``build_mesh_ring_step`` (the quantized
mesh tier's gradient step). ``model`` may also name any
``geomx_tpu_torch.models.zoo.get_model`` model, as in the JAX examples.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from geomx_tpu_torch.io import load_data  # noqa: F401  (re-export)


def build_model_and_step(batch_size: int, compute_dtype=torch.float32,
                         num_classes: int = 10,
                         input_shape=(28, 28, 1), model: str = "cnn",
                         device=None,
                         init_leaves: Optional[Sequence] = None,
                         seed: int = 42):
    """Returns ``(param_leaves, leaf_names, grad_step, eval_step)``.

    ``param_leaves`` are fp32 numpy arrays in flax leaf order and layout,
    from ``init_leaves`` (e.g. the JAX package's) or a seeded flax-style
    init. ``grad_step(leaves, X, y) -> (loss, grad_leaves)`` takes leaf
    tensors on ``device`` and returns mean-loss gradients in the same
    order, layouts and dtype; ``eval_step(leaves, X, y)`` returns the
    accuracy. ``compute_dtype`` (``torch.bfloat16`` for
    ``examples/cnn_fp16.py``) is what the forward and backward run in:
    the leaves and inputs are cast to it, no autocast, and the logits and
    the loss stay fp32, as in the flax step. ``device=None`` is the CUDA
    card; ``batch_size`` is accepted for the JAX signature's sake. On the
    card this sets cuDNN to fp32 and deterministic algorithms for the
    whole process (:func:`geomx_tpu_torch._device.exact_cudnn`).

    ``model``: "cnn" (the reference demo net) or a zoo name
    ("resnet18", "mobilenet1.0", "vgg11", "densenet121", ...); see
    :func:`_build_zoo` for what differs there."""
    del batch_size
    from geomx_tpu_torch._device import exact_cudnn, resolve_device

    if model != "cnn":
        return _build_zoo(model, compute_dtype, num_classes, input_shape,
                          device, init_leaves, seed)
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
        params = lenet_params_from_flax(
            [p.to(compute_dtype) for p in leaf_list])
        return call(params, torch.as_tensor(X))

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


def _dropout_rng(device: torch.device, step: int) -> torch.Generator:
    """The dropout masks' generator for train step ``step``: seed 7 with
    the step folded in, so every step draws fresh masks and a rerun draws
    the same ones (the JAX example folds the step into PRNGKey(7); the
    masks themselves are torch's own)."""
    return torch.Generator(device=device).manual_seed((7 << 32) + step)


def _build_zoo(model: str, compute_dtype, num_classes: int, input_shape,
               device, init_leaves, seed: int):
    """``build_model_and_step`` for a zoo model (counterpart of the JAX
    example's zoo branch): the CIFAR-sized stem for the resnets
    (``small_images``), and leaves in flax order and layouts
    (``convert.zoo_leaves``). BatchNorm running statistics live in this
    call's module and stay WORKER-LOCAL: only the parameters travel
    through the store, as in the reference's kvstore flow. The steps are
    STATEFUL (the module's statistics, and a step counter that draws
    each train step's dropout masks), so build one per worker."""
    from geomx_tpu_torch._device import exact_cudnn, resolve_device
    from geomx_tpu_torch.models.convert import (zoo_flax_leaves,
                                                zoo_leaves,
                                                zoo_params_from_flax)
    from geomx_tpu_torch.models.zoo import get_model

    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_cudnn()
    extra = {"small_images": True} if model.startswith("resnet") else {}
    net = get_model(model, num_classes=num_classes, seed=seed,
                    input_shape=tuple(input_shape), **extra)
    table = zoo_leaves(net)
    leaves = ([np.array(l, np.float32, copy=True) for l in init_leaves]
              if init_leaves is not None else zoo_flax_leaves(net))
    if len(leaves) != len(table):
        raise ValueError(f"{model}: {len(table)} leaves, got {len(leaves)}")
    net = net.to(dev)
    box = {"step": 0}

    def logits_of(leaf_list, X, train, rng):
        params = zoo_params_from_flax(
            table, [p.to(compute_dtype) for p in leaf_list])
        return torch.func.functional_call(
            net, params, (torch.as_tensor(X),),
            {"train": train, "rng": rng})

    def grad_step(leaf_list, X, y):
        rng = _dropout_rng(dev, box["step"])
        box["step"] += 1
        leaf_list = [p.detach().requires_grad_(True) for p in leaf_list]
        logp = torch.log_softmax(logits_of(leaf_list, X, True, rng).float(),
                                 dim=-1)
        loss = -logp.gather(-1, torch.as_tensor(y).long()[:, None]).mean()
        grads = torch.autograd.grad(loss, leaf_list)
        return loss.detach(), list(grads)

    @torch.no_grad()
    def eval_step(leaf_list, X, y):
        pred = logits_of(leaf_list, X, False, None).argmax(dim=-1)
        return (pred == torch.as_tensor(y).long()).float().mean()

    return leaves, [f for f, _n, _k in table], grad_step, eval_step


def host_grad_step(leaves: List[np.ndarray], grad_step, device):
    """``(leaves, X, y) -> (loss, grad_leaves)`` over numpy leaves and
    batches, with the per-leaf transfers fused (counterpart of
    ``examples/utils.py`` ``build_flat_step``): one host-to-device copy
    of the packed parameters and of the batch, split and reshaped on
    ``device``, and one device-to-host copy of the packed gradients. The
    leaves must share one dtype; the loss stays a tensor on ``device``."""
    shapes = [l.shape for l in leaves]
    sizes = [int(l.size) for l in leaves]
    bounds = list(np.cumsum(sizes)[:-1])
    dtypes = {np.asarray(l).dtype for l in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"leaves must share one dtype, got {dtypes}")
    dtype = dtypes.pop()

    def step(lv, X, y):
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(l, dtype).ravel() for l in lv])).to(device)
        loss, grads = grad_step(
            [p.view(s) for p, s in zip(torch.split(flat, sizes), shapes)],
            torch.as_tensor(X).to(device), torch.as_tensor(y).to(device))
        flat_grads = torch.cat([g.reshape(-1) for g in grads]).cpu().numpy()
        return loss, [g.reshape(s) for g, s in
                      zip(np.split(flat_grads, bounds), shapes)]

    return step


def build_mesh_ring_step(kv, grad_step):
    """Mesh tier: wrap ``grad_step`` so the batch splits over the party
    mesh's "dp" ranks (``kv.shard_batch``: the rows of the ranks this
    process holds, every rank's in one process, its own over processes),
    each rank computes its LOCAL mean-loss grads, and every leaf is
    party-mean-reduced through the store's quantized ring
    (``kv.ring_reducer`` — the error-feedback residual streams live in
    the store, keyed, so round aborts reset them in one place;
    GEOMX_MESH_CODEC "none": the fp32 sum over the ranks, over processes
    the group's all-reduce). Returns a drop-in ``(lv, X, y) -> (loss,
    grads)`` whose gradients are every rank's (identical) copy of the
    ring's output and whose loss is the party's mean. Counts the ring's
    bytes under tier=mesh."""
    mesh = kv.mesh

    def ring_step(lv, X, y):
        X, y = kv.shard_batch(X, y)
        losses, per_rank = [], []
        for r in range(X.shape[0]):
            loss, grads = grad_step(lv, X[r], y[r])
            losses.append(loss)
            per_rank.append(grads)
        out = []
        for idx, gs in enumerate(zip(*per_rank)):
            shape = gs[0].shape
            stack = torch.stack([g.reshape(-1) for g in gs])
            red = kv.ring_reducer(idx, stack.shape[1], mean=True)
            out.append((red.reduce(stack)[0] if red is not None
                        else mesh.sum_rows(stack) / mesh.size).reshape(shape))
        kv.record_round_collectives(out, op="ring")
        return mesh.all_rows(torch.stack(losses)).mean(), out

    return ring_step


def process_party(kv) -> bool:
    """Whether ``kv`` is a mesh-party store whose ranks are processes."""
    return bool(getattr(kv, "procs", False))


def sync_leaves(kv, leaves: List[np.ndarray]) -> None:
    """On a party over processes, every rank's host ``leaves`` become the
    global worker's (the store's broadcast); elsewhere nothing."""
    if process_party(kv):
        for leaf, v in zip(leaves, kv.put_replicated(leaves)):
            leaf[...] = v.cpu().numpy()


def init_and_pull(kv, leaves: List[np.ndarray]) -> None:
    """Every node inits every key; party workers then pull the global
    initial values into ``leaves`` (the master steps aside), as the
    reference examples do. On a party over processes only the global
    worker speaks the van; the other ranks take its values."""
    if getattr(kv, "is_global_worker", True):
        for idx, leaf in enumerate(leaves):
            kv.init(idx, leaf)
            if kv.is_master_worker:
                continue
            kv.pull(idx, out=leaves[idx])
        kv.wait()
    sync_leaves(kv, leaves)


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


class Measure:
    """Per-iteration JSON metrics reporter (reference: utils.py:120), the
    same records as the JAX package's. Its files go under the system's
    temporary directory (``TMPDIR``) unless ``log_dir`` says otherwise."""

    def __init__(self, log_dir: Optional[str] = None, sub_dir: str = "run"):
        self.begin = time.time()
        self.records = []
        self.log_path = os.path.join(
            log_dir or os.path.join(tempfile.gettempdir(), "geomx_logs"),
            sub_dir)
        os.makedirs(self.log_path, exist_ok=True)

    def add(self, iteration: int, epoch: int, accuracy: float,
            num_samples: int, loss: float = 0.0):
        rec = {
            "iteration": iteration,
            "epoch": epoch,
            "time": round(time.time() - self.begin, 4),
            "accuracy": round(accuracy, 4),
            "num_samples": num_samples,
            "loss": round(float(loss), 5),
        }
        self.records.append(rec)
        return rec

    def dump(self, name: str = "measure.json"):
        path = os.path.join(self.log_path, name)
        with open(path, "w") as f:
            json.dump(self.records, f)
        return path
