"""FlashAttention-2 forward + backward: CUDA kernels and their plain versions.

Counterpart of ``geomx_tpu/ops/flash_attention.py``, whose three Pallas
TPU kernels (``fwd_kernel``, ``dq_kernel``, ``dkv_kernel``) become the
hand-written CUDA kernels of ``csrc/flash_attention.cu``. Beside each
kernel sits a plain PyTorch version of the same function, a blocked
online softmax that mirrors the Pallas arithmetic: the same -1e30 mask
sentinel, zeros for rows without a visible key, the decode offset
``kv_len - q_len`` under ``causal``, dead blocks skipped, and the same
places where bf16 rounds (P before P.V and P^T.dO, dS before dS.K and
dS^T.Q; every product sums in fp32).

Which one runs follows the tensors' device: a CPU tensor gets the plain
version, a CUDA tensor gets the kernel or an exception. The plain
versions are public so a caller can run them on any device on purpose
(the on-card comparison in ``chip_smoke.py`` does).

On CUDA the kernel is chosen by dtype before any launch (``route``),
alike for all three: bf16 runs on the tensor cores (``geomx_fa_fwd_tc``,
``geomx_fa_dq_tc``, ``geomx_fa_dkv_tc``, head dim padded to 32, 64 or
128), fp32 runs the CUDA-core kernels, whose fp32 products hold the 1e-4
tolerance that TF32 tensor cores would miss.

Layout contract as in the JAX package: ``q`` is ``[B, Tq, H, D]``,
``k`` and ``v`` are ``[B, Tk, H, D]``, the output is ``[B, Tq, H, D]``;
the logsumexp is fp32 ``[B, H, Tq]``. The kernels read the inputs
through their strides (any layout whose last stride is 1, such as the
per-head views of a fused qkv projection; the tensor-core kernels copy
16 bytes at a time, so an input whose pointer or B, T, H strides are not
16-byte multiples is copied first) and tile by 64 rows; the plain
versions block by ``block_q`` / ``block_k`` as the Pallas kernels do.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from geomx_tpu_torch.ops import _cuda

__all__ = ["LAUNCHES", "flash_attention", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_dq_plain",
           "flash_bwd_dkv_plain", "make_sharded_flash_attention", "route"]

# kernel launches since the last reset, by kernel (the plain versions
# do not count)
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}

TC_HEAD_DIMS = (32, 64, 128)   # the tensor-core kernels' padded head dims

NEG = -1e30   # the Pallas kernels' masking sentinel, not -inf
_DTYPES = (torch.float32, torch.bfloat16)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check(q, k, v, causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected [B, T, H, D] tensors, got {tuple(q.shape)}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    D = q.shape[3]
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"head dim must be a multiple of 8 up to 128, got {D}")
    Tq, Tk = q.shape[1], k.shape[1]
    if Tq == 0 or Tk == 0:
        raise ValueError("empty sequence")
    if causal and Tq > Tk:
        # no decode-convention alignment exists for more queries than keys
        raise ValueError(
            f"causal attention needs Tq <= Tk, got Tq={Tq} > Tk={Tk}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


# -- plain versions --------------------------------------------------------


def _blocks(Tq: int, Tk: int, block_q: int, block_k: int) -> Tuple[int, int]:
    return min(block_q, _round_up(Tq, 8)), min(block_k, _round_up(Tk, 8))


def _live(i0: int, j0: int, bq: int, off: int, causal: bool) -> bool:
    """Does the (q block at i0, k block at j0) pair contribute at all?"""
    return not causal or j0 < i0 + bq + off


def _mask(i0, n, j0, m, off, causal, device):
    """[n, m] visibility of keys j0.. to queries i0.. (keys past Tk are
    sliced away, so only the causal condition remains)."""
    if not causal:
        return torch.ones((n, m), dtype=torch.bool, device=device)
    qpos = torch.arange(i0, i0 + n, device=device)[:, None]
    kpos = torch.arange(j0, j0 + m, device=device)[None, :]
    return qpos + off >= kpos


def _f32(x):
    return x.to(torch.float32)


def _round(x, dtype):
    """``x.astype(dtype)`` widened back to fp32."""
    return x.to(dtype).to(torch.float32)


def flash_fwd_plain(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Plain version of the forward kernel: ``(o, lse)``."""
    _check(q, k, v, causal)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bq, bk = _blocks(Tq, Tk, block_q, block_k)
    scale = 1.0 / (D ** 0.5)
    off = Tk - Tq
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    o = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    for i0 in range(0, Tq, bq):
        qb = _f32(qt[:, :, i0:i0 + bq])
        n = qb.shape[2]
        acc = torch.zeros((B, H, n, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, n), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
        for j0 in range(0, Tk, bk):
            if not _live(i0, j0, bq, off, causal):
                break
            kb, vb = kt[:, :, j0:j0 + bk], vt[:, :, j0:j0 + bk]
            s = (qb @ _f32(kb).transpose(-1, -2)) * scale
            s = torch.where(_mask(i0, n, j0, kb.shape[2], off, causal,
                                  q.device), s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _round(p, v.dtype) @ _f32(vb)
            m = m_new
        # rows with no valid key (padding) have l == 0; emit zeros
        safe = torch.where(l > 0.0, l, 1.0)
        o[:, :, i0:i0 + n] = (acc / safe[..., None]).to(q.dtype)
        lse[:, :, i0:i0 + n] = m + torch.log(safe)
    return o.transpose(1, 2).contiguous(), lse


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                       block_q: int = 128, block_k: int = 128):
    """Plain version of the dQ kernel. ``lse`` and ``delta`` are fp32
    ``[B, H, Tq]``; ``delta = rowsum(dO * O)``."""
    _check(q, k, v, causal)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bq, bk = _blocks(Tq, Tk, block_q, block_k)
    scale = 1.0 / (D ** 0.5)
    off = Tk - Tq
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dq = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    for i0 in range(0, Tq, bq):
        qb, dob = _f32(qt[:, :, i0:i0 + bq]), _f32(dot[:, :, i0:i0 + bq])
        n = qb.shape[2]
        lse_b = lse[:, :, i0:i0 + n, None]
        dl = delta[:, :, i0:i0 + n, None]
        acc = torch.zeros((B, H, n, D), dtype=torch.float32, device=q.device)
        for j0 in range(0, Tk, bk):
            if not _live(i0, j0, bq, off, causal):
                break
            kb, vb = _f32(kt[:, :, j0:j0 + bk]), _f32(vt[:, :, j0:j0 + bk])
            s = (qb @ kb.transpose(-1, -2)) * scale
            p = torch.where(_mask(i0, n, j0, kb.shape[2], off, causal,
                                  q.device), torch.exp(s - lse_b), 0.0)
            dp = dob @ vb.transpose(-1, -2)
            ds = _round(p * (dp - dl) * scale, k.dtype)
            acc = acc + ds @ kb
        dq[:, :, i0:i0 + n] = acc.to(q.dtype)
    return dq.transpose(1, 2).contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                        block_q: int = 128, block_k: int = 128):
    """Plain version of the dK/dV kernel: ``(dk, dv)``."""
    _check(q, k, v, causal)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bq, bk = _blocks(Tq, Tk, block_q, block_k)
    scale = 1.0 / (D ** 0.5)
    off = Tk - Tq
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    dk = torch.empty((B, H, Tk, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, H, Tk, D), dtype=v.dtype, device=q.device)
    for j0 in range(0, Tk, bk):
        kb, vb = _f32(kt[:, :, j0:j0 + bk]), _f32(vt[:, :, j0:j0 + bk])
        m = kb.shape[2]
        dk_acc = torch.zeros((B, H, m, D), dtype=torch.float32,
                             device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for i0 in range(0, Tq, bq):
            if not _live(i0, j0, bq, off, causal):
                continue
            qb, dob = _f32(qt[:, :, i0:i0 + bq]), _f32(dot[:, :, i0:i0 + bq])
            n = qb.shape[2]
            lse_b = lse[:, :, i0:i0 + n, None]
            dl = delta[:, :, i0:i0 + n, None]
            s = (qb @ kb.transpose(-1, -2)) * scale
            p = torch.where(_mask(i0, n, j0, m, off, causal, q.device),
                            torch.exp(s - lse_b), 0.0)
            dv_acc = dv_acc + _round(p, do.dtype).transpose(-1, -2) @ dob
            dp = dob @ vb.transpose(-1, -2)
            ds = _round(p * (dp - dl) * scale, q.dtype)
            dk_acc = dk_acc + ds.transpose(-1, -2) @ qb
        dk[:, :, j0:j0 + m] = dk_acc.to(k.dtype)
        dv[:, :, j0:j0 + m] = dv_acc.to(v.dtype)
    return dk.transpose(1, 2).contiguous(), dv.transpose(1, 2).contiguous()


# -- CUDA kernels ----------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of ``struct AttnParams`` in csrc/flash_attention.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "dout", "out", "lse", "lse_in", "delta",
            "dq", "dk", "dv")]
        + [(f"{t}_s{a}", ctypes.c_longlong)
           for t in ("q", "k", "v", "do") for a in ("b", "t", "h")]
        + [(n, ctypes.c_int) for n in ("B", "H", "Tq", "Tk", "D", "causal")]
        + [("scale", ctypes.c_float)])


_FNS = {}   # C entry point by kernel key, looked up once


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_cuda.library("flash_attention"), f"geomx_flash_{name}")
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def route(dtype, D: int) -> int:
    """The CUDA kernel of each flash entry point for this dtype and head
    dim, chosen before any launch: 0 for fp32 (the CUDA-core kernels: TF32
    products would miss the 1e-4 fp32 tolerance), else the padded head
    dim of the bf16 tensor-core kernel (the least of 32, 64, 128 that
    holds ``D``; the columns past ``D`` are zeros in shared memory)."""
    if dtype == torch.float32:
        return 0
    if dtype != torch.bfloat16 or D > TC_HEAD_DIMS[-1]:
        raise ValueError(f"no flash attention kernel for {dtype}, D={D}")
    return next(dp for dp in TC_HEAD_DIMS if D <= dp)


def _aligned16(x) -> bool:
    """Can the tensor-core kernels' 16-byte copies read ``x`` in place?
    The last stride must be 1, the pointer and the B, T, H strides (in
    bytes) multiples of 16."""
    esz = x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s * esz % 16 == 0 for s in x.stride()[:3]))


def _operand(x, rt: int):
    """``x`` as the kernel of route ``rt`` reads it: in place where it can,
    else an explicit contiguous copy (fresh storage, so aligned)."""
    if rt == 0:
        return x if x.stride(-1) == 1 else x.contiguous()
    if _aligned16(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _params(q, k, v, causal, do=None) -> _Params:
    B, Tq, H, D = q.shape
    kw = dict(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), B=B, H=H, Tq=Tq,
              Tk=k.shape[1], D=D, causal=int(causal), scale=1.0 / (D ** 0.5))
    named = [("q", q), ("k", k), ("v", v)] + ([("do", do)] if do is not None
                                             else [])
    for t, x in named:
        sb, st, sh, _ = x.stride()
        kw[f"{t}_sb"], kw[f"{t}_st"], kw[f"{t}_sh"] = sb, st, sh
    if do is not None:
        kw["dout"] = do.data_ptr()
    return _Params(**kw)


def _launch(name: str, p: _Params, q, arg: int) -> None:
    """Launch on ``q``'s device and current stream; ``arg`` is the
    route."""
    fn = _fn(name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.device.index == torch.cuda.current_device():
        rc = fn(ctypes.byref(p), arg, stream)
    else:
        with torch.cuda.device(q.device):
            rc = fn(ctypes.byref(p), arg, stream)
    if rc != 0:   # the C entry point returns the launch's cudaError_t
        raise RuntimeError(f"flash_{name} kernel launch: CUDA error {rc}")
    _cuda.count_launch(LAUNCHES, name)


def _fwd_cuda(q, k, v, causal):
    rt = route(q.dtype, q.shape[3])
    q, k, v = (_operand(x, rt) for x in (q, k, v))
    B, Tq, H, D = q.shape
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    p = _params(q, k, v, causal)
    p.out, p.lse = o.data_ptr(), lse.data_ptr()
    _launch("fwd", p, q, rt)
    return o, lse


def _bwd_params(q, k, v, do, lse, delta, causal, rt):
    q, k, v, do = (_operand(x, rt) for x in (q, k, v, do))
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    p = _params(q, k, v, causal, do)
    p.lse_in, p.delta = lse.data_ptr(), delta.data_ptr()
    # the tensors behind the pointers must outlive the launch call
    return p, (q, k, v, do, lse, delta)


def _dq_cuda(q, k, v, do, lse, delta, causal):
    rt = route(q.dtype, q.shape[3])
    p, keep = _bwd_params(q, k, v, do, lse, delta, causal, rt)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    p.dq = dq.data_ptr()
    _launch("dq", p, keep[0], rt)
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, causal):
    rt = route(q.dtype, q.shape[3])
    p, keep = _bwd_params(q, k, v, do, lse, delta, causal, rt)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    p.dk, p.dv = dk.data_ptr(), dv.data_ptr()
    _launch("dkv", p, keep[0], rt)
    return dk, dv


# -- dispatch by device ----------------------------------------------------


def _on_cuda(x) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain
    version); any other device raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no flash attention kernel for device {x.device}")
    return x.is_cuda


def _check_bwd(q, do, lse, delta) -> None:
    B, Tq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q in shape, dtype and device")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (B, H, Tq) or x.device != q.device:
            raise ValueError(f"{name} must be [B, H, Tq] on q's device")


def flash_fwd(q, k, v, *, causal: bool = True, block_q: int = 128,
              block_k: int = 128):
    """Forward: ``(o, lse)``; the kernel on CUDA, the plain version on
    the CPU."""
    _check(q, k, v, causal)
    if _on_cuda(q):
        return _fwd_cuda(q, k, v, causal)
    return flash_fwd_plain(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 block_q: int = 128, block_k: int = 128):
    """Backward dQ; the kernel on CUDA, the plain version on the CPU."""
    _check(q, k, v, causal)
    _check_bwd(q, do, lse, delta)
    if _on_cuda(q):
        return _dq_cuda(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                              block_q=block_q, block_k=block_k)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  block_q: int = 128, block_k: int = 128):
    """Backward ``(dk, dv)``; the kernel on CUDA, the plain version on
    the CPU."""
    _check(q, k, v, causal)
    _check_bwd(q, do, lse, delta)
    if _on_cuda(q):
        return _dkv_cuda(q, k, v, do, lse, delta, causal)
    return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                               block_q=block_q, block_k=block_k)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's custom VJP: the backward recomputes P blockwise
    from the saved logsumexp (no quadratic residual)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, lse = flash_fwd(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = dict(causal=causal, block_q=block_q, block_k=block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # delta = rowsum(dO * O) stays outside the kernels, as in JAX
        delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
        delta = delta.transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **ctx.cfg)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Memory-efficient exact attention; drop-in for ``dense_attention``.

    ``q``: ``[B, Tq, H, D]``, ``k, v``: ``[B, Tk, H, D]`` (with
    ``causal`` the queries are the LAST ``Tq`` positions of the key
    sequence — the kv-cache decode convention). Scores are scaled by
    ``1/sqrt(D)``. Differentiable; the backward runs the dQ and dK/dV
    kernels on CUDA. ``block_q`` / ``block_k`` set the plain versions'
    blocking; the kernels tile by 64."""
    _check(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


def make_sharded_flash_attention(mesh, *, causal: bool = True,
                                 block_q: int = 128, block_k: int = 128):
    """:func:`flash_attention` over ``mesh``'s dp/tp layout (JAX
    ``ops/flash_attention.py:351-376``).

    The JAX package runs the Pallas kernels per shard under shard_map,
    batch over "dp" and heads over "tp". Attention is independent per
    batch and head, and the port's ranks share one card
    (:mod:`geomx_tpu_torch.parallel.mesh`), so each kernel is launched
    once over the whole ``[B, T, H, D]`` — one launch where the JAX
    package launches one per shard (ROADMAP queue C). The layout is
    still checked: B must divide by dp and H by tp, as shard_map
    requires. Sequence-sharded meshes ("sp" > 1) need ring attention
    instead and are rejected."""
    from geomx_tpu_torch.parallel.mesh import check_divisible

    if "sp" in mesh.axis_names and mesh.shape["sp"] > 1:
        raise ValueError(
            "flash attention cannot shard the sequence axis; "
            "use parallel.make_ring_attention for sp > 1")
    spec = ("dp" if "dp" in mesh.axis_names else None, None,
            "tp" if "tp" in mesh.axis_names else None, None)

    def fn(q, k, v):
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_divisible(mesh, spec, x.shape, f"flash attention's {name}")
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)

    return fn
