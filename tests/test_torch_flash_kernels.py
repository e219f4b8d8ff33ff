"""The CUDA flash-attention kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip without a card; this file imports torch only, so it runs on a
machine with the card and without JAX:

  python -m pytest -m cuda tests/test_torch_flash_kernels.py -q

One test, of the wrapper's choice of kernel by dtype, head dim and
alignment, launches nothing and runs on the CPU too.

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


def _check_against_plain(q, k, v, do, causal):
    """Every kernel output against its plain version on the same card."""
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    op, lp = fa.flash_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * op.float()).sum(-1).transpose(1, 2).contiguous()
    got = [o, lse, fa.flash_bwd_dq(q, k, v, do, lp, delta, causal=causal),
           *fa.flash_bwd_dkv(q, k, v, do, lp, delta, causal=causal)]
    want = [op, lp,
            fa.flash_bwd_dq_plain(q, k, v, do, lp, delta, causal=causal),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lp, delta, causal=causal)]
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")


# the bf16 tensor-core kernels at each template head dim (and 40, padded to
# 64), ragged and single-row sequences, causal or not, the decode shape
# Tq < Tk; one fp32 case pins the CUDA-core route
@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 40])
@pytest.mark.parametrize("T", [1, 63, 65, 511])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_kernels_match_plain(cuda_device, D, T, causal):
    g = torch.Generator(device=cuda_device).manual_seed(D * 1000 + T)
    q, k, v, do = (torch.randn(2, T, 3, D, device=cuda_device, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    _check_against_plain(q, k, v, do, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (64, torch.float32)])
def test_decode_shape_matches_plain(cuda_device, D, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, do = (torch.randn(2, 64, 4, D, device=cuda_device, generator=g)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(2, 511, 4, D, device=cuda_device, generator=g)
            .to(dtype) for _ in range(2))
    _check_against_plain(q, k, v, do, True)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [65, 511])
def test_fused_qkv_views_match_plain(cuda_device, T):
    """q, k, v as the model makes them: per-head views of one fused
    [B, T, 3 H D] projection (T stride 3 H D, offsets H D and 2 H D)."""
    B, H, D = 2, 8, 64
    g = torch.Generator(device=cuda_device).manual_seed(T)
    qkv = torch.randn(B, T, 3 * H * D, device=cuda_device,
                      generator=g).to(torch.bfloat16)
    q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    assert q.stride(1) == 3 * H * D and all(fa._aligned16(x)
                                            for x in (q, k, v))
    do = torch.randn(B, T, H, D, device=cuda_device,
                     generator=g).to(torch.bfloat16)
    _check_against_plain(q, k, v, do, True)


def test_route_by_dtype_head_dim_and_alignment(monkeypatch):
    """Runs on the CPU: which kernel each input takes, before any launch."""
    assert fa.route(torch.float32, 64) == 0
    for D, want in ((8, 32), (32, 32), (40, 64), (64, 64), (72, 128),
                    (128, 128)):
        assert fa.route(torch.bfloat16, D) == want
    with pytest.raises(ValueError):
        fa.route(torch.float16, 64)
    # a fused qkv projection's per-head views are read in place
    qkv = torch.zeros(2, 5, 3 * 4 * 8, dtype=torch.bfloat16)
    q = qkv[..., 32:64].reshape(2, 5, 4, 8)
    assert fa._aligned16(q) and fa._operand(q, 32) is q
    # a pointer off by one element, or a T stride of 20 bytes, is copied
    # first; the CUDA-core route only needs a unit last stride
    flat = torch.zeros(2 * 5 * 4 * 8 + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 5, 4, 8)
    narrow = torch.zeros(2, 5, 10, dtype=torch.bfloat16)[..., :8]
    narrow = narrow.reshape(2, 5, 1, 8)
    for x in (odd, narrow):
        assert not fa._aligned16(x)
        y = fa._operand(x, 32)
        assert y is not x and fa._aligned16(y) and torch.equal(y, x)
        assert fa._operand(x, 0) is x
    # dQ takes its route from route() as the forward and dK/dV do, and its
    # misaligned bf16 inputs are copied first: the arguments it would
    # launch with, on CPU tensors, with the launch replaced
    seen = []
    monkeypatch.setattr(fa, "_launch",
                        lambda name, p, q, arg: seen.append((name, q, arg)))
    for dtype, want in ((torch.bfloat16, 64), (torch.float32, 0)):
        flat = torch.zeros(2 * 5 * 4 * 40 + 1, dtype=dtype)
        q = flat[1:].view(2, 5, 4, 40)
        stats = torch.zeros(2, 4, 5)
        fa._dq_cuda(q, q, q, q, stats, stats, True)
        name, q_in, arg = seen.pop()
        assert (name, arg) == ("dq", want)
        assert (q_in is not q) == (want != 0) and torch.equal(q_in, q)


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernels(cuda_device):
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(1, 40, 2, 32, device=cuda_device).to(dtype)
        before = dict(fa.LAUNCHES)
        o = fa.flash_attention(q.clone().requires_grad_(), q, q, causal=True)
        o.float().sum().backward()
        assert {k: fa.LAUNCHES[k] - before[k] for k in before} == \
            {"fwd": 1, "dq": 1, "dkv": 1}, dtype


# dQ pinned at the transformer slice's shape, and at a ragged Tq < Tk whose
# decode offset (Tk - Tq = 130) is not a multiple of the 64-row tile, so a
# dead-tile or offset error in the dQ sweep shows
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk", [(8, 8, 511, 511), (2, 3, 100, 230)])
def test_dq_tensor_core_kernel_matches_plain(cuda_device, B, H, Tq, Tk):
    g = torch.Generator(device=cuda_device).manual_seed(Tq + Tk)
    q, k, v, do = (torch.randn(B, t, H, 64, device=cuda_device, generator=g)
                   .to(torch.bfloat16) for t in (Tq, Tk, Tk, Tq))
    op, lp = fa.flash_fwd_plain(q, k, v, causal=True)
    delta = (do.float() * op.float()).sum(-1).transpose(1, 2).contiguous()
    before = fa.LAUNCHES["dq"]
    got = fa.flash_bwd_dq(q, k, v, do, lp, delta, causal=True)
    want = fa.flash_bwd_dq_plain(q, k, v, do, lp, delta, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["dq"] == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
