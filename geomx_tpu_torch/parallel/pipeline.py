"""Pipeline parallelism over the "pp" mesh axis (GPipe schedule).

Counterpart of ``geomx_tpu/parallel/pipeline.py`` (``pipeline_spmd``
``:34``, ``make_pipeline_fn`` ``:75``). Stage parameters are stacked
along a leading stage axis ``(S, ...)``; the schedule runs ``M + S - 1``
ticks for M microbatches over S stages. At each tick stage 0 takes the
next microbatch (zeros once they run out) and every other stage the
activation that reached it, each stage applies ``stage_fn`` to its row,
and the rows hop one stage on — a ``torch.roll`` along the stage axis,
where the JAX package ``ppermute``s between devices (the port's ranks
share one card, :mod:`.mesh`). Autograd through the schedule gives the
pipeline's backward, as ``jax.grad`` does there.

Bubble ticks run ``stage_fn`` on zeros. Their outputs are dropped by
selecting the last stage's row at ticks ``S-1 .. M+S-2``, never by
multiplying with a mask: a NaN from a bubble would survive ``* 0``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from geomx_tpu_torch.parallel.mesh import Mesh, check_divisible

__all__ = ["pipeline_spmd", "make_pipeline_fn"]


def pipeline_spmd(stage_fn: Callable, stage_params, x_mb):
    """Run the GPipe schedule.

    ``stage_fn(params_slice, x) -> y`` applies ONE stage (activations
    keep one shape across stages). ``stage_params`` leaves carry the
    stage axis first, one row per stage. ``x_mb``: [M, mb, ...]
    microbatches. Returns [M, mb, ...], the last stage's outputs."""
    S = pytree.tree_leaves(stage_params)[0].shape[0]
    M = x_mb.shape[0]
    zero = torch.zeros_like(x_mb[0])
    local = [pytree.tree_map(lambda p, s=s: p[s], stage_params)
             for s in range(S)]
    first = torch.zeros(S, dtype=torch.bool, device=x_mb.device)
    first[0] = True
    first = first.reshape(S, *([1] * zero.dim()))
    buf = torch.zeros((S, *zero.shape), dtype=zero.dtype, device=zero.device)
    last = []
    for t in range(M + S - 1):
        # stage 0 injects microbatch t while it exists; later stages
        # consume what arrived from the previous stage
        inj = x_mb[t] if t < M else zero
        x = torch.where(first, inj, buf)
        y = torch.stack([stage_fn(local[s], x[s]) for s in range(S)])
        buf = torch.roll(y, 1, dims=0)
        last.append(y[S - 1])
    # the last stage produced microbatch m's output at tick m + S - 1
    return torch.stack(last[S - 1:])


def make_pipeline_fn(mesh: Mesh, stage_fn: Callable, *,
                     in_spec: Sequence = (), axis_name: str = "pp"
                     ) -> Callable[[Any, Any], Any]:
    """``fn(stacked_params, x_mb) -> out`` running :func:`pipeline_spmd`
    over ``mesh``'s ``axis_name`` axis: ``stacked_params`` leaves carry a
    leading stage axis of length ``mesh[axis_name]``; ``x_mb`` is [M,
    mb, ...], laid out as ``in_spec`` (checked for divisibility, as
    shard_map checks it)."""
    S = mesh.shape[axis_name]

    def fn(stacked_params, x_mb):
        for leaf in pytree.tree_leaves(stacked_params):
            if leaf.shape[0] != S:
                raise ValueError(f"stage axis of length {leaf.shape[0]}, "
                                 f"mesh axis {axis_name!r} has {S}")
        check_divisible(mesh, tuple(in_spec), x_mb.shape, "x_mb")
        return pipeline_spmd(stage_fn, stacked_params, x_mb)

    return fn
