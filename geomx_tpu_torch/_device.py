"""Where the port's entry points run: the CUDA card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none; the
    CPU runs only when the caller names it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' (or --cpu) "
                "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
