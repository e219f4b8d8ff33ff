"""geomx_tpu_torch.ops — device kernels of the port.

Counterpart of ``geomx_tpu/ops``. Ported so far: the FlashAttention-2
kernels (``ops.flash_attention``, CUDA sources in ``ops/csrc``). The
BSC and 2-bit device ops of ``geomx_tpu/ops/__init__.py``, with the
2-bit pack kernel, come in a later slice (ROADMAP queue A item 6, queue
B item 1).
"""
