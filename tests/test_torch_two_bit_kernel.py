"""The CUDA 2-bit quantize kernel against its plain version, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip without a card; this file imports torch only, so it runs on a
machine with the card and without JAX:

  python -m pytest -m cuda tests/test_torch_two_bit_kernel.py -q

The check is exact: codes and residual must match bit for bit (the
kernel does the plain version's fp32 adds, nothing else).
"""

import pytest
import torch

from geomx_tpu_torch.ops import two_bit
from geomx_tpu_torch.parallel import mesh as pmesh
from geomx_tpu_torch.parallel import quant_collectives as qc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 1001, 1 << 16])
@pytest.mark.parametrize("thr", [0.5, 0.01])
def test_kernel_matches_plain_on_card(cuda_device, n, thr):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    grad = torch.randn(n, device=cuda_device, generator=g)
    res = torch.randn(n, device=cuda_device, generator=g) * 0.3
    before = two_bit.LAUNCHES["two_bit"]
    packed, new_res = two_bit.two_bit_quantize(grad, res, thr)
    assert two_bit.LAUNCHES["two_bit"] == before + 1
    want_p, want_r = two_bit.two_bit_quantize_plain(grad, res, thr)
    torch.cuda.synchronize()
    assert torch.equal(packed, want_p) and torch.equal(new_res, want_r)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 10])      # vector and scalar paths
def test_kernel_strided_rows_in_place(cuda_device, m):
    P, S, thr = 3, 3, 0.25
    g = torch.Generator(device=cuda_device).manual_seed(m)
    grad = torch.randn(P, m, device=cuda_device, generator=g)
    res = torch.randn(P, S, m, device=cuda_device, generator=g)
    want_p, want_r = two_bit.two_bit_quantize_plain(grad, res[:, 1], thr)
    out = res.clone()
    packed, _ = two_bit.two_bit_quantize(grad, out[:, 1], thr,
                                         out_residual=out[:, 1])
    torch.cuda.synchronize()
    assert torch.equal(packed, want_p) and torch.equal(out[:, 1], want_r)
    assert torch.equal(out[:, 0], res[:, 0]) and torch.equal(out[:, 2],
                                                            res[:, 2])


@pytest.mark.cuda
def test_ring_on_card_equals_ring_on_cpu(cuda_device):
    P, n = 2, 4099
    xs = torch.randn(P, n, generator=torch.Generator().manual_seed(1))
    reds = [qc.QuantRingReducer(pmesh.make_party_mesh(P, device=d), "2bit", n,
                                threshold=0.5) for d in ("cpu", cuda_device)]
    before = two_bit.LAUNCHES["two_bit"]
    for _ in range(3):
        cpu, card = (r.reduce(xs.to(r.mesh.device)) for r in reds)
        assert torch.equal(card.cpu(), cpu)
    assert two_bit.LAUNCHES["two_bit"] == before + 3 * P
