"""Parameters across: flax leaf lists in and out of the port's modules.

The JAX package hands parameters around as the leaf list of
``jax.tree_util.tree_flatten(params)``: dictionary keys sorted at every
level (so ``block10`` sorts before ``block2``), Dense kernels ``[in,
out]``, conv kernels HWIO. The transformer keeps flax's names and
layouts, so its leaf order is the sorted order of its dotted parameter
names split at the dots, and the arrays move across unchanged. LeNet is
torch-native (OIHW convs, ``[out, in]`` linears) and maps through
:data:`LENET_LEAVES`.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, List, Sequence

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
