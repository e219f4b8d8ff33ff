"""Parameters across: flax leaf lists in and out of the port's modules.

The JAX package hands parameters around as the leaf list of
``jax.tree_util.tree_flatten(params)``: dictionary keys sorted at every
level (so ``block10`` sorts before ``block2``), Dense kernels ``[in,
out]``, conv kernels HWIO. The transformer (its MoE blocks included:
``block{i}/moe/{b_dn, b_up, ln, router, w_dn, w_up}``, so ``moe/b_dn``
sorts before ``moe/ln``, the expert-stacked ``[E, D, H]`` / ``[E, H,
D]`` leaves as they are) and the MLP (``models/mlp.py``) keep flax's
names and layouts, so their leaf order is the sorted order of their
dotted parameter names split at the dots, and the arrays move across
unchanged. LeNet is
torch-native (OIHW convs, ``[out, in]`` linears) and maps through
:data:`LENET_LEAVES`.

The model zoo (``resnet.py``, ``zoo.py``, ``rnn.py``) keeps flax's
module paths and torch's layouts: each layer's ``FLAX`` table names its
flax leaf and the layout change, so :func:`zoo_leaves` lists the
``params`` leaves (and :func:`zoo_stats` the ``batch_stats`` ones) by
flax path, sorted as ``tree_flatten`` sorts them
(``BottleneckBlock_10`` before ``BottleneckBlock_2``), and the arrays
cross in either direction by path (:func:`load_flax_variables`,
:func:`flax_variables`) or as leaf lists (:func:`zoo_params_from_flax`,
:func:`zoo_flax_leaves`). The flattened Dense of AlexNet and VGG sees
its features in NHWC order, as in flax, so its kernel only transposes.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def thread_safe_call(model: torch.nn.Module) -> Callable:
    """``f(params, *args)`` = ``torch.func.functional_call(model, params,
    args)`` on a per-thread copy of ``model``: functional_call swaps the
    module's parameters for the call's duration, so two workers of one
    process (the party workers of ``InProcessHiPS``) must not share one
    module."""
    local = threading.local()

    def call(params, *args):
        m = getattr(local, "model", None)
        if m is None:
            m = local.model = copy.deepcopy(model)
        return torch.func.functional_call(m, params, args)

    return call


def leaf_names(model: torch.nn.Module) -> List[str]:
    """Parameter names of ``model`` in flax ``tree_flatten`` order."""
    return sorted((n for n, _ in model.named_parameters()),
                  key=lambda n: n.split("."))


def load_flax_leaves(model: torch.nn.Module, leaves: Sequence) -> None:
    """Copy a flax leaf list (numpy arrays, in ``tree_flatten`` order)
    into ``model``'s parameters, in place."""
    names = leaf_names(model)
    if len(leaves) != len(names):
        raise ValueError(f"{len(leaves)} leaves for {len(names)} parameters")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, leaf in zip(names, leaves):
            p = params[name]
            arr = torch.tensor(np.asarray(leaf, dtype=np.float32))
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: leaf shape {tuple(arr.shape)} "
                                 f"!= parameter shape {tuple(p.shape)}")
            p.copy_(arr)


def flax_leaves(model: torch.nn.Module) -> List[np.ndarray]:
    """``model``'s parameters as a flax-ordered list of fp32 numpy arrays."""
    params = dict(model.named_parameters())
    return [params[n].detach().to("cpu", torch.float32).numpy().copy()
            for n in leaf_names(model)]


# -- LeNet: torch-native layouts <-> the flax leaf list ---------------------

# flax leaf order of geomx_tpu.models.cnn.LeNetCNN (sorted keys: bias
# before kernel in each layer) -> the port's module and the layout kind
LENET_LEAVES = [
    ("Conv_0.bias", "conv0.bias", "bias"),
    ("Conv_0.kernel", "conv0.weight", "conv"),
    ("Conv_1.bias", "conv1.bias", "bias"),
    ("Conv_1.kernel", "conv1.weight", "conv"),
    ("Dense_0.bias", "dense0.bias", "bias"),
    ("Dense_0.kernel", "dense0.weight", "dense"),
    ("Dense_1.bias", "dense1.bias", "bias"),
    ("Dense_1.kernel", "dense1.weight", "dense"),
    ("Dense_2.bias", "dense2.bias", "bias"),
    ("Dense_2.kernel", "dense2.weight", "dense"),
]


def _from_flax(leaf: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv":                  # HWIO -> OIHW
        return leaf.permute(3, 2, 0, 1)
    if kind == "dense":                 # [in, out] -> [out, in]
        return leaf.t()
    return leaf


def _to_flax(p: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv":                  # OIHW -> HWIO
        return p.permute(2, 3, 1, 0)
    if kind == "dense":
        return p.t()
    return p


def lenet_params_from_flax(leaves: Sequence[torch.Tensor]):
    """The LeNet module's parameters, by name, as views of flax-layout
    leaf tensors (differentiable, so gradients come back in flax
    layout): for ``torch.func.functional_call``."""
    if len(leaves) != len(LENET_LEAVES):
        raise ValueError(f"LeNet has {len(LENET_LEAVES)} leaves, "
                         f"got {len(leaves)}")
    return {name: _from_flax(leaf, kind)
            for leaf, (_f, name, kind) in zip(leaves, LENET_LEAVES)}


def lenet_flax_leaves(model: torch.nn.Module) -> List[np.ndarray]:
    """``model``'s parameters as the flax leaf list (fp32 numpy, flax
    layouts and order)."""
    params = dict(model.named_parameters())
    return [_to_flax(params[name].detach().to("cpu", torch.float32),
                     kind).contiguous().numpy().copy()
            for _f, name, kind in LENET_LEAVES]


# -- the model zoo: flax paths <-> torch names -------------------------------

def zoo_leaves(model: torch.nn.Module) -> List[Tuple[str, str, str]]:
    """``(flax path, torch parameter name, layout kind)`` of every
    ``params`` leaf, in flax ``tree_flatten`` order; paths are dotted
    (``"BottleneckBlock_0.Conv_1.kernel"``)."""
    out = []
    for mpath, mod in model.named_modules():
        for tname, (fname, kind) in getattr(mod, "FLAX", {}).items():
            if getattr(mod, tname, None) is None:
                continue
            pre = f"{mpath}." if mpath else ""
            out.append((pre + fname, pre + tname, kind))
    return sorted(out, key=lambda e: e[0].split("."))


def zoo_stats(model: torch.nn.Module) -> List[Tuple[str, str]]:
    """``(flax path, torch buffer name)`` of every ``batch_stats`` leaf,
    in flax ``tree_flatten`` order."""
    out = []
    for mpath, mod in model.named_modules():
        for tname, fname in getattr(mod, "FLAX_STATS", {}).items():
            pre = f"{mpath}." if mpath else ""
            out.append((pre + fname, pre + tname))
    return sorted(out, key=lambda e: e[0].split("."))


def zoo_params_from_flax(table: Sequence[Tuple[str, str, str]],
                         leaves: Sequence[torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The module's parameters by torch name, as views of flax-layout
    leaf tensors in ``table`` order (differentiable, so gradients come
    back in flax layout): for ``torch.func.functional_call``."""
    if len(leaves) != len(table):
        raise ValueError(f"{len(table)} leaves expected, got {len(leaves)}")
    return {name: _from_flax(leaf, kind)
            for leaf, (_f, name, kind) in zip(leaves, table)}


def zoo_flax_leaves(model: torch.nn.Module) -> List[np.ndarray]:
    """``model``'s parameters as the flax leaf list (fp32 numpy)."""
    params = dict(model.named_parameters())
    return [_to_flax(params[name].detach().to("cpu", torch.float32),
                     kind).contiguous().numpy().copy()
            for _f, name, kind in zoo_leaves(model)]


def zoo_batch_stats(model: torch.nn.Module) -> List[np.ndarray]:
    """``model``'s BatchNorm running statistics as the flax
    ``batch_stats`` leaf list (fp32 numpy)."""
    bufs = dict(model.named_buffers())
    return [bufs[name].detach().to("cpu", torch.float32).numpy().copy()
            for _f, name in zoo_stats(model)]


def _lookup(tree, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _insert(tree: dict, path: str, value) -> None:
    *parents, last = path.split(".")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = value


def load_flax_variables(model: torch.nn.Module, variables) -> None:
    """Copy flax ``{"params": ..., "batch_stats": ...}`` nested dicts of
    arrays into ``model``'s parameters and buffers, in place, changing
    the layouts; every leaf of the model must be found, at its shape."""
    params = dict(model.named_parameters())
    bufs = dict(model.named_buffers())
    with torch.no_grad():
        for fpath, name, kind in zoo_leaves(model):
            leaf = torch.tensor(np.asarray(_lookup(variables["params"],
                                                   fpath), np.float32))
            _copy_checked(params[name], _from_flax(leaf, kind), fpath)
        stats = variables.get("batch_stats", {})
        for fpath, name in zoo_stats(model):
            leaf = torch.tensor(np.asarray(_lookup(stats, fpath),
                                           np.float32))
            _copy_checked(bufs[name], leaf, fpath)


def _copy_checked(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: flax shape {tuple(src.shape)} does not "
                         f"fit {tuple(dst.shape)}")
    dst.copy_(src)


def flax_variables(model: torch.nn.Module) -> dict:
    """``model``'s parameters and BatchNorm statistics as flax nested
    dicts of fp32 numpy arrays in flax layouts (``batch_stats`` only
    when the model has BatchNorm)."""
    out: dict = {"params": {}}
    for (fpath, _n, _k), leaf in zip(zoo_leaves(model),
                                     zoo_flax_leaves(model)):
        _insert(out["params"], fpath, leaf)
    stats = zoo_stats(model)
    if stats:
        out["batch_stats"] = {}
        for (fpath, _n), leaf in zip(stats, zoo_batch_stats(model)):
            _insert(out["batch_stats"], fpath, leaf)
    return out
