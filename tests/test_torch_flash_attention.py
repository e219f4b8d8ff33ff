"""geomx_tpu_torch flash attention (plain path) vs the JAX Pallas kernels.

The same numpy inputs go through ``geomx_tpu.ops.flash_attention`` (its
Pallas kernels in interpret mode on the CPU, as the JAX package's own
tests run them) and through the port's ``flash_attention``, whose CPU
route is the plain PyTorch version of the CUDA kernels. Forward values
and dq/dk/dv (``torch.autograd.grad`` vs ``jax.vjp``) must agree:
fp32 within 2e-5 forward and 2e-4 for gradients (summation order), bf16
within 2e-2 compared in fp32 (bf16 rounding of P and dS). The JAX side
is compiled with XLA's excess precision off, so that it rounds to bf16
after each operation, as eager PyTorch does.

The kernels themselves need the card: tests/test_torch_flash_kernels.py
holds them against the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.ops.flash_attention import flash_attention as jax_flash
from geomx_tpu_torch.ops import flash_attention as fa

CASES = [
    # B, Tq, Tk, H, D, causal, block, dtype
    pytest.param(1, 37, 37, 2, 16, True, 16, "float32", id="causal-ragged37"),
    pytest.param(1, 37, 37, 2, 16, False, 16, "float32", id="full-ragged37"),
    pytest.param(1, 15, 15, 2, 8, True, 8, "float32", id="causal-ragged15"),
    pytest.param(1, 8, 37, 2, 8, True, 8, "float32", id="decode"),
    pytest.param(1, 15, 37, 2, 8, False, 8, "float32", id="cross"),
    pytest.param(1, 37, 37, 2, 16, True, 16, "bfloat16", id="bf16-causal"),
    pytest.param(1, 15, 37, 2, 16, True, 8, "bfloat16", id="bf16-decode"),
]


def _inputs(B, Tq, Tk, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D), (B, Tq, H, D))]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _jax_run(fn, *args):
    """``fn(*args)`` compiled once, rounding as its types say."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal,block,dtype", CASES)
def test_plain_matches_jax_pallas(B, Tq, Tk, H, D, causal, block, dtype):
    q, k, v, cot = _inputs(B, Tq, Tk, H, D)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    fwd_tol, grad_tol = (2e-5, 2e-4) if dtype == "float32" else (2e-2, 2e-2)

    def jf(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=block, block_k=block)

    def fwd_bwd(q, k, v, c):
        out, vjp = jax.vjp(jf, q, k, v)
        return out, vjp(c)

    jout, jgrads = _jax_run(fwd_bwd, *(jnp.asarray(x, jdt)
                                       for x in (q, k, v, cot)))

    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    tout = fa.flash_attention(tq, tk, tv, causal=causal, block_q=block,
                              block_k=block)
    assert tout.dtype == tdt and tout.shape == (B, Tq, H, D)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv),
                                 torch.tensor(cot).to(tdt))

    np.testing.assert_allclose(_np(tout.detach().float()), _np(jout),
                               atol=fwd_tol, rtol=fwd_tol)
    for name, a, b in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(_np(a.float()), _np(b), atol=grad_tol,
                                   rtol=grad_tol, err_msg=f"d{name}")


def test_cpu_tensors_take_the_plain_path():
    q, k, v, _ = _inputs(1, 16, 16, 1, 8)
    t = [torch.tensor(x) for x in (q, k, v)]
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(*t, causal=True)
    op, lp = fa.flash_fwd_plain(*t, causal=True)
    assert fa.LAUNCHES == before
    assert torch.equal(o, op) and torch.equal(lse, lp)
    assert lse.shape == (1, 1, 16) and lse.dtype == torch.float32


@pytest.mark.parametrize("kw,match", [
    (dict(Tq=16, Tk=12, D=8, dtype=torch.float32), "Tq <= Tk"),
    (dict(Tq=8, Tk=8, D=12, dtype=torch.float32), "multiple of 8"),
    (dict(Tq=8, Tk=8, D=136, dtype=torch.float32), "multiple of 8"),
    (dict(Tq=8, Tk=8, D=8, dtype=torch.float16), "float32 or bfloat16"),
])
def test_rejects_unsupported_inputs(kw, match):
    q = torch.zeros(1, kw["Tq"], 1, kw["D"], dtype=kw["dtype"])
    k = torch.zeros(1, kw["Tk"], 1, kw["D"], dtype=kw["dtype"])
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, k, causal=True)


def test_other_devices_raise():
    q = torch.empty(1, 8, 1, 8, device="meta")
    with pytest.raises(RuntimeError, match="no flash attention kernel"):
        fa.flash_fwd(q, q, q, causal=True)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from geomx_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.library("flash_attention")
    assert _cuda._target("flash_attention").name.startswith(
        "libflash_attention_")
