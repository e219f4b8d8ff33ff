"""The CUDA flash-attention kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip without a card; this file imports torch only, so it runs on a
machine with the card and without JAX:

  python -m pytest -m cuda tests/test_torch_flash_kernels.py -q

Tolerances as in ``chip_smoke.py``: per element atol = rtol = 1e-4 in
fp32 and 2e-2 in bf16 (summation order, one bf16 ulp).
"""

import pytest
import torch

from geomx_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk,causal,dtype", [
    (70, 70, True, torch.float32), (37, 100, False, torch.float32),
    (64, 130, True, torch.bfloat16)])
def test_kernels_match_plain_on_card(cuda_device, Tq, Tk, causal, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(2, t, 2, 64, device=cuda_device, generator=g)
                   .to(dtype) for t in (Tq, Tk, Tk, Tq))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    op, lp = fa.flash_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * op.float()).sum(-1).transpose(1, 2).contiguous()
    got = [o, lse, fa.flash_bwd_dq(q, k, v, do, lp, delta, causal=causal),
           *fa.flash_bwd_dkv(q, k, v, do, lp, delta, causal=causal)]
    want = [op, lp,
            fa.flash_bwd_dq_plain(q, k, v, do, lp, delta, causal=causal),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lp, delta, causal=causal)]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernels(cuda_device):
    q = torch.randn(1, 40, 2, 32, device=cuda_device)
    before = dict(fa.LAUNCHES)
    o = fa.flash_attention(q.clone().requires_grad_(), q, q, causal=True)
    o.sum().backward()
    assert {k: fa.LAUNCHES[k] - before[k] for k in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
