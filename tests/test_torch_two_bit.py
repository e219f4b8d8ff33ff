"""geomx_tpu_torch's device compression ops vs geomx_tpu's, on the CPU.

The port's ``two_bit_quantize`` (on a CPU tensor: the plain version of
the CUDA kernel) must give the same packed bytes and residual, bit for
bit, as the JAX ``two_bit_quantize`` with and without the Pallas pack
(interpret mode here) and as the numpy host kernel. The selections of
``bsc_compress`` / ``bsc_pull_compress`` and the int8 mesh codec are
bit-exact on tie-free inputs; ``dgt_block_contrib`` agrees within fp32
1e-6 (the block sums may add in another order). The 2-bit wire codec
carries its residual across rounds the same way on a CPU tensor as the
JAX codec does on a jax array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu import compression as jax_compression
from geomx_tpu import ops as jax_ops
from geomx_tpu.compression import device as jax_dev
from geomx_tpu_torch import compression, ops
from geomx_tpu_torch.compression import device as dev
from geomx_tpu_torch.ops import two_bit


def _vec(n, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("n", [1, 3, 64, 1001])
@pytest.mark.parametrize("thr", [0.5, 0.01])
def test_two_bit_matches_jax_pallas_and_numpy(n, thr):
    grad, res = _vec(n, n), _vec(n, n + 1, 0.7)
    packed, new_res = ops.two_bit_quantize(_t(grad), _t(res), thr)
    assert packed.dtype == torch.uint8 and packed.shape == (-(-n // 4),)
    for use_pallas in (False, True):
        jp, jr = jax_ops.two_bit_quantize(jnp.asarray(grad), jnp.asarray(res),
                                          thr, use_pallas=use_pallas)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(new_res.numpy(), np.asarray(jr))
    np_res = res.copy()
    np.testing.assert_array_equal(
        packed.numpy(), jax_compression.two_bit_quantize(grad, np_res, thr))
    np.testing.assert_array_equal(new_res.numpy(), np_res)
    deq = ops.two_bit_dequantize(packed, n, thr)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jax_ops.two_bit_dequantize(
            jnp.asarray(packed.numpy()), n, thr)))
    np.testing.assert_array_equal(
        deq.numpy(), compression.two_bit_dequantize(packed.numpy(), n, thr))


def test_two_bit_rows_strided_residual_and_out():
    """The ring's form: (rows, m) with a strided residual slot view and
    the new residual written into another strided view."""
    P, S, m, thr = 3, 3, 10, 0.25
    grad = _t(_vec(P * m, 5).reshape(P, m))
    res = _t(_vec(P * S * m, 6).reshape(P, S, m))
    out = torch.full((P, S, m), 7.0)
    packed, new_res = ops.two_bit_quantize(grad, res[:, 1], thr,
                                           out_residual=out[:, 1])
    assert new_res.data_ptr() == out[:, 1].data_ptr()
    assert packed.shape == (P, 3)
    for r in range(P):
        p1, r1 = ops.two_bit_quantize(grad[r], res[r, 1].clone(), thr)
        assert torch.equal(packed[r], p1) and torch.equal(out[r, 1], r1)
    assert bool((out[:, 0] == 7.0).all() and (out[:, 2] == 7.0).all())
    deq = ops.two_bit_dequantize(packed, m, thr)
    for r in range(P):
        assert torch.equal(deq[r], ops.two_bit_dequantize(packed[r], m, thr))


def test_two_bit_rejects_what_the_kernel_does_not_take():
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="float32"):
        ops.two_bit_quantize(g.double(), g.double(), 0.5)
    with pytest.raises(ValueError, match="shape"):
        ops.two_bit_quantize(g, torch.zeros(4), 0.5)
    with pytest.raises(ValueError, match="unit-stride"):
        two_bit._rows(torch.zeros(4, 8)[:, ::2])
    assert two_bit.LAUNCHES == {"two_bit": 0}   # CPU tensors never launch


def test_bsc_compress_and_pull_match_jax():
    n, thr = 5000, 0.01
    g, u, v = _vec(n, 1), _vec(n, 2), _vec(n, 3)
    got = ops.bsc_compress(_t(g), _t(u), _t(v), thr)
    want = jax_ops.bsc_compress(jnp.asarray(g), jnp.asarray(u),
                                jnp.asarray(v), thr)
    assert got[1].dtype == torch.int32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    arr = _vec(n, 4)
    for a, b in zip(ops.bsc_pull_compress(_t(arr), thr, 3),
                    jax_ops.bsc_pull_compress(jnp.asarray(arr), thr, 3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    vals, idx = got[0], got[1]
    np.testing.assert_array_equal(
        ops.bsc_decompress(vals, idx, n).numpy(),
        np.asarray(jax_ops.bsc_decompress(jnp.asarray(vals.numpy()),
                                          jnp.asarray(idx.numpy()), n)))


@pytest.mark.parametrize("n", [256, 1000])
def test_dgt_block_contrib_matches_jax(n):
    g, prev = _vec(n, 8), np.abs(_vec(-(-n // 64), 9))
    got = ops.dgt_block_contrib(_t(g), _t(prev), 64, 0.9)
    want = jax_ops.dgt_block_contrib(jnp.asarray(g), jnp.asarray(prev),
                                     64, 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_block_int8_matches_jax_and_numpy_twin():
    x = _vec(64 * 6, 10) * np.float32(3.0)
    x[64:128] = 0.0                                  # a zero block
    codes, exps = dev.block_quant_int8(_t(x), 64)
    jc, je = jax_dev.block_quant_int8(jnp.asarray(x), 64)
    nc, ne = dev.block_quant_int8_np(x, 64)
    for a, b, c in ((codes, jc, nc), (exps, je, ne)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c)
    deq = dev.block_dequant_int8(codes, exps, 64)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jax_dev.block_dequant_int8(jc, je, 64)))
    np.testing.assert_array_equal(deq.numpy(),
                                  dev.block_dequant_int8_np(nc, ne, 64))


def test_wire_codec_2bit_on_a_tensor_matches_jax_over_rounds():
    ours, theirs = dev.WireCodec("2bit", 0.05), jax_dev.WireCodec("2bit", 0.05)
    for rnd in range(3):
        g = _vec(1001, 20 + rnd, 0.04)
        a = ours.encode("2bit", _t(g), state_key=("k", 0))
        b = theirs.encode("2bit", jnp.asarray(g), state_key=("k", 0))
        assert a[2] == b[2] == "2bit"
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(
            ours.decode("2bit", a[0], a[1], 1001),
            theirs.decode("2bit", b[0], b[1], 1001))
    assert isinstance(ours._residual[("k", 0)], torch.Tensor)
    np.testing.assert_array_equal(ours._residual[("k", 0)].numpy(),
                                  np.asarray(theirs._residual[("k", 0)]))
    fp = ours.encode("fp16", _t(g))[0]
    assert fp.dtype == np.float16
    np.testing.assert_array_equal(fp, theirs.encode("fp16", g)[0])


def test_device_bsc_compressor_matches_jax():
    ours = ops.DeviceBSCCompressor(0.01, device="cpu")
    theirs = jax_ops.DeviceBSCCompressor(0.01)
    for rnd in range(2):
        g = _vec(3000, 30 + rnd)
        for a, b in zip(ours.compress_push(g, "w"), theirs.compress_push(g, "w")):
            np.testing.assert_array_equal(a, b)
    arr = _vec(1 << 16, 40)
    for a, b in zip(ours.compress_pull("bsc", arr, 2),
                    theirs.compress_pull("bsc", arr, 2)):
        np.testing.assert_array_equal(a, b)
    vals, idx = ours.compress_pull("bsc", arr, 2)
    np.testing.assert_array_equal(
        ours.decompress_push("bsc", vals, idx, 1 << 16),
        theirs.decompress_push("bsc", vals, idx, 1 << 16))
    assert isinstance(compression.make_compressor(
        {"type": "bsc", "device": False}), compression.BSCCompressor)
