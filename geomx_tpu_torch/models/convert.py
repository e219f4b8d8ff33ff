"""Parameters across: flax leaf lists in and out of the port's modules.

The JAX package hands parameters around as the leaf list of
``jax.tree_util.tree_flatten(params)``: dictionary keys sorted at every
level (so ``block10`` sorts before ``block2``), Dense kernels ``[in,
out]``. The port's modules keep flax's names and layouts, so the leaf
order is the sorted order of their dotted parameter names split at the
dots, and the arrays move across unchanged.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


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
