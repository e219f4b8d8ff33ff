"""Where the port's entry points run: the CUDA card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; ``None`` and a CUDA device both raise
    when there is no card. The CPU runs only when the caller names it
    (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (or --cpu) "
            "to run on the CPU")
    return dev


def exact_cudnn() -> None:
    """Process-wide: cuDNN convolves in true fp32 (no TF32) and by
    deterministic algorithms only. The reference computes the demo CNN in
    fp32, and the main path's 200 BSC rounds are chaotic enough that
    PyTorch's defaults (TF32, non-deterministic backward algorithms) give
    a different accuracy on every run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
