// FlashAttention-2 forward, dQ and dK/dV as CUDA kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of geomx_tpu/ops/flash_attention.py:
//   _kernels -> fwd_kernel  (body :85, launched by fwd     :125)
//       bf16: geomx_fa_fwd_tc<DP>   (tensor cores)   fp32: flash_fwd_kernel
//   _kernels -> dq_kernel   (body :155, launched by bwd_dq :187)
//       bf16: geomx_fa_dq_tc<DP>    (tensor cores)   fp32: flash_dq_kernel
//   _kernels -> dkv_kernel  (body :207, launched by bwd_dkv :245)
//       bf16: geomx_fa_dkv_tc<DP>   (tensor cores)   fp32: flash_dkv_kernel
// The route is chosen by dtype before any launch (geomx_tpu_torch/ops/
// flash_attention.py, `route`): bf16 takes the tensor-core kernels, fp32
// the CUDA-core ones, because TF32 products would miss the fp32 tolerance
// of 1e-4. No route falls back to another when a launch fails.
//
// What bounds them on the H100. At the transformer slice's shape (B 8, H 8,
// T 511, D 64, bf16, causal) the forward moves ~16.9 MB and does ~2.1 causal
// GFLOP: bound by bytes, 5.0 us at 3.35 TB/s against 2.2 us of tensor-core
// time at 989 TFLOP/s; dK/dV moves ~25.4 MB (7.6 us) against ~4.3 GFLOP
// (4.3 us); dQ moves ~21.2 MB (6.3 us) against ~3.2 GFLOP (3.3 us).
// mma.sync reaches roughly two thirds of the tensor-core peak, so all three
// stay bound by bytes.
//
// The bf16 tensor-core kernels (geomx_fa_*_tc), and what they do about the
// faults of the first, CUDA-core version (which fp32 still runs):
//   - products on the tensor cores: mma.sync m16n8k16 bf16 with fp32
//     accumulators (mma_bf16.cuh), operands by ldmatrix (.trans where the
//     operand's rows are the product's k), not fp32 FMAs on the CUDA cores
//     fed by shared-memory loads;
//   - tiles stay bf16 in shared memory, copied by 16-byte cp.async (one
//     copy per 8 elements, no per-element divide, no widening), rows padded
//     by 16 bytes so the 8 row addresses of an ldmatrix hit distinct banks;
//     rows at or past T and head-dim columns at or past D are zero-filled
//     by the copy's src-size operand. Forward ~45 KB, dQ ~54 KB and dK/dV
//     ~56 KB of shared memory at D = 64 (the CUDA-core versions: 66.5, 83
//     and ~100 KB);
//   - overlap: the next tile's copies are in flight (double buffer, one
//     cp.async group per tile) while the current tile's products run;
//   - no shared-memory round trip for P or dS: a warp owns 16 rows of the
//     output tile, the score tile's C fragments are rounded to bf16 in
//     place and used as the A operand of the next product;
//   - causal tail: the forward's and dQ's q tile is the slowest grid index,
//     reversed, so every (b, h)'s heaviest tiles start first; dK/dV's k tile
//     0, its heaviest, starts first by the same layout unreversed.
// The head dim is a template (DP in 32, 64, 128); a D that is a multiple of
// 8 below DP runs the next larger DP, its columns past D zero-filled in
// shared memory and never written, so every D the wrapper accepts (8..128)
// launches a kernel.
//
// Forward: one block of 4 warps per (b, h, 64-row q tile); warp w owns q rows
// 16w..16w+15 and keeps Q's A fragments and its O accumulator (16 x DP fp32)
// in registers while the block sweeps the live 64-row k tiles. S = Q K^T
// accumulates in fp32 registers; the row max and sum are quad shuffles; P is
// rounded to bf16 after the online-softmax rescale and fed to P.V from the
// same registers. O is staged through the Q tile for 16-byte stores.
//
// dQ: the forward's layout. Warp w owns q rows 16w..16w+15; Q and dO are
// copied once into shared memory and their A fragments read from there by
// ldmatrix on every k step; the rows' lse and delta and the dQ accumulator
// (16 x DP fp32) stay in registers while K and V stream through a double
// buffer (64-row steps, 32 at DP = 128). S = Q K^T and dP = dO V^T take K
// and V as B operands by plain ldmatrix; dS is built in the S registers,
// rounded to bf16 and used as the A operand of dQ += dS K, with K through
// ldmatrix.trans. dQ is its own deterministic pass, as in the
// JAX package, not atomics from dK/dV. dQ is staged through the Q tile.
//
// dK/dV: one block of 4 warps per (b, h, 64-row k tile); warp w owns k rows
// 16w..16w+15 and keeps its dK and dV accumulators (16 x DP fp32 each) in
// registers for the whole sweep over q tiles of BQS rows (64, or 32 at
// DP = 128 to keep the register count down), from the first live one. The
// scores are computed transposed, S^T = K Q^T and dP^T = V dO^T, so P^T and
// dS^T are the A operands of dV += P^T dO and dK += dS^T Q straight from
// the accumulator registers; Q and dO are the B operands through
// ldmatrix.trans. The q tile's lse and delta ride with it (4-byte cp.async).
//
// The fp32 CUDA-core kernels: one block of 256 threads per (b, h, 64-row
// tile), tiles staged in shared memory, rows padded to D + 1 floats, a 64 x 64 score tile as 4 x 4 registers per thread, row
// max and sum as half-warp shuffles, fp32 FMAs.
//
// Every kernel reads q, k, v and dO in the model's [B, T, H, D] layout
// through strides (the last one must be 1; the tensor-core kernels also need
// the pointer and the B, T and H strides at 16 bytes, which the wrapper
// checks) and masks the ragged edge itself, in place of the JAX wrapper's
// transpose and pad. Outputs are contiguous: o / dq [B, Tq, H, D], dk / dv
// [B, Tk, H, D], lse [B, H, Tq] fp32.
//
// Numerics mirror the Pallas kernels: scores scaled by 1/sqrt(D) in fp32
// (the tensor-core forward folds log2(e) into the scale and uses exp2, and
// writes lse as a natural log); masked scores set to -1e30 (not -inf); rows
// with l == 0 write zeros; causal offset kv_len - q_len (decode convention),
// dead tiles skipped as _live does; P rounded to V's type before P.V; dS
// rounded to K's / Q's type before dS.K / dS^T.Q; P rounded to dO's type
// before P^T.dO; every sum in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // k rows per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int MAXJ = 8;       // D <= 128: head-dim columns per thread, stride 16
constexpr int LDS = BK + 1;   // row stride of the score tiles in shared memory
constexpr float NEG = -1e30f; // the Pallas kernels' masking sentinel

}  // namespace

// Field order is the ctypes.Structure's in geomx_tpu_torch/ops/flash_attention.py.
struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  float* lse;
  const float* lse_in;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  int B, H, Tq, Tk, D, causal;
  float scale;
};

namespace {

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [t0, t0 + 64) of one (b, h) slice of a [B, T, H, D] tensor (src points
// at row 0 of the slice, st is the T stride) into shared [64][D + 1]; rows
// at or past t_len are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long st,
                                          int t0, int t_len, int D) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i - r * D, t = t0 + r;
    dst[r * ld + d] = t < t_len ? src[(long long)t * st + d] : 0.f;
  }
}

__device__ __forceinline__ bool visible(const AttnParams& p, int qpos, int kpos, int off) {
  return qpos < p.Tq && kpos < p.Tk && (!p.causal || qpos + off >= kpos);
}

// ---- forward: O = softmax(Q K^T / sqrt(D)) V, lse = m + log l --------------

__global__ void __launch_bounds__(NT) flash_fwd_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  const int D = p.D, ld = D + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;  // [BQ][LDS]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = p.Tk - p.Tq;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_tile(Qs, q, p.q_st, q0, p.Tq, D);

  float m[4], l[4], acc[4][MAXJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[i][j] = 0.f;
  }
  // causal: keys from q0 + BQ + off on are masked for every row of the tile
  const int kend = p.causal ? min(p.Tk, q0 + BQ + off) : p.Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous sweep step is done with Ks, Vs, Ps
    load_tile(Ks, k, p.k_st, k0, p.Tk, D);
    load_tile(Vs, v, p.v_st, k0, p.Tk, D);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(p, q0 + r, k0 + tx + 16 * j, off) ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        Ps[r * LDS + tx + 16 * j] = e;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[MAXJ];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? Vs[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc = Ps[(ty + 16 * i) * LDS + c];
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
  }

  float* o = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= p.Tq) continue;
    // rows with no visible key have l == 0: emit zeros
    const float safe = l[i] > 0.f ? l[i] : 1.f;
    float* orow = o + (((long long)b * p.Tq + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = acc[i][j] / safe;
    }
    if (tx == 0) p.lse[((long long)b * p.H + h) * p.Tq + t] = m[i] + logf(safe);
  }
}

// ---- backward dQ: dQ = sum_k dS K, dS = P (dP - delta) / sqrt(D) -----------

__global__ void __launch_bounds__(NT) flash_dq_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  const int D = p.D, ld = D + 1;
  float* Qs = smem;
  float* Os = Qs + BQ * ld;  // dO tile
  float* Ks = Os + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ss = Vs + BK * ld;  // dS tile [BQ][LDS]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = p.Tk - p.Tq;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long bh = (long long)b * p.H + h;
  load_tile(Qs, q, p.q_st, q0, p.Tq, D);
  load_tile(Os, dout, p.do_st, q0, p.Tq, D);

  float lse[4], dlt[4], acc[4][MAXJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    lse[i] = t < p.Tq ? p.lse_in[bh * p.Tq + t] : 0.f;
    dlt[i] = t < p.Tq ? p.delta[bh * p.Tq + t] : 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[i][j] = 0.f;
  }
  const int kend = p.causal ? min(p.Tk, q0 + BQ + off) : p.Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_tile(Ks, k, p.k_st, k0, p.Tk, D);
    load_tile(Vs, v, p.v_st, k0, p.Tk, D);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], c[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * ld + d];
        g[i] = Os[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Ks[(tx + 16 * j) * ld + d];
        e[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], e[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pij = visible(p, q0 + r, k0 + c, off) ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        Ss[r * LDS + c] = pij * (dp[i][j] - dlt[i]) * p.scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kk[MAXJ];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int d = tx + 16 * j;
        kk[j] = d < D ? Ks[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty + 16 * i) * LDS + c];
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
      }
    }
  }

  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= p.Tq) continue;
    float* row = dq + (((long long)b * p.Tq + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = acc[i][j];
    }
  }
}

// ---- backward dK/dV: dV = sum_q P^T dO, dK = sum_q dS^T Q ------------------

__global__ void __launch_bounds__(NT) flash_dkv_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  const int D = p.D, ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* Os = Qs + BQ * ld;  // dO tile
  float* Ps = Os + BQ * ld;  // [BQ][LDS], P rounded to dO's type
  float* Ss = Ps + BQ * LDS; // [BQ][LDS], dS rounded to Q's type
  float* Ls = Ss + BQ * LDS; // lse of the q tile's rows
  float* Es = Ls + BQ;       // delta of the q tile's rows
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = p.Tk - p.Tq;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long bh = (long long)b * p.H + h;
  load_tile(Ks, k, p.k_st, k0, p.Tk, D);
  load_tile(Vs, v, p.v_st, k0, p.Tk, D);

  float dk[4][MAXJ], dv[4][MAXJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  // causal: q tiles ending at or before k0 - off see none of these keys
  int qstart = 0;
  if (p.causal && k0 - off > 0) qstart = ((k0 - off) / BQ) * BQ;
  for (int q0 = qstart; q0 < p.Tq; q0 += BQ) {
    __syncthreads();
    load_tile(Qs, q, p.q_st, q0, p.Tq, D);
    load_tile(Os, dout, p.do_st, q0, p.Tq, D);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int t = q0 + i;
      Ls[i] = t < p.Tq ? p.lse_in[bh * p.Tq + t] : 0.f;
      Es[i] = t < p.Tq ? p.delta[bh * p.Tq + t] : 0.f;
    }
    __syncthreads();
    // scores with q rows r = ty + 16 i and k columns c = tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], c[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * ld + d];
        g[i] = Os[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Ks[(tx + 16 * j) * ld + d];
        e[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], e[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pij = visible(p, q0 + r, k0 + c, off) ? expf(s[i][j] * p.scale - Ls[r]) : 0.f;
        Ps[r * LDS + c] = pij;
        Ss[r * LDS + c] = pij * (dp[i][j] - Es[r]) * p.scale;
      }
    }
    __syncthreads();
    // accumulate with k rows c = ty + 16 i and head-dim columns d = tx + 16 j
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float go[MAXJ], qq[MAXJ];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int d = tx + 16 * j;
        go[j] = d < D ? Os[r * ld + d] : 0.f;
        qq[j] = d < D ? Qs[r * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[r * LDS + ty + 16 * i];
        const float sv = Ss[r * LDS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          dv[i][j] = fmaf(pv, go[j], dv[i][j]);
          dk[i][j] = fmaf(sv, qq[j], dk[i][j]);
        }
      }
    }
  }

  float* dkp = static_cast<float*>(p.dk);
  float* dvp = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= p.Tk) continue;
    const long long row = (((long long)b * p.Tk + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkp[row + d] = dk[i][j];
        dvp[row + d] = dv[i][j];
      }
    }
  }
}

}  // namespace

// ---- bf16 tensor-core kernels -------------------------------------------

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int TC = 128;  // threads per block: 4 warps of 16 rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Start the cp.async copies of rows [t0, t0 + ROWS) of one (b, h) slice
// (src points at its row 0, st is the T stride) into a bf16 tile with row
// stride DP + 8; rows at or past t_len and columns at or past D get zeros.
template <int ROWS, int DP>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, long long st, int t0,
                                          int t_len, int D) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % TC == 0, "whole rounds of 128 chunks");
#pragma unroll
  for (int n = 0; n < ROWS * CH / TC; ++n) {
    const int i = threadIdx.x + n * TC, r = i / CH, c = i % CH, t = t0 + r;
    const bool fill = t < t_len && c * 8 < D;
    cp_async16(dst + r * (DP + 8) + c * 8, fill ? src + t * st + c * 8 : src, fill);
  }
}

// the same for ROWS fp32 values of one row vector (lse, delta)
template <int ROWS>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int t0, int t_len) {
  for (int i = threadIdx.x; i < ROWS; i += TC) {
    const int t = t0 + i;
    cp_async4(dst + i, t < t_len ? src + t : src, t < t_len);
  }
}

// 16 rows x DP fp32 accumulators of one warp (C fragments, n-tile j holding
// columns 8j..8j+7) times `mul`, rounded to bf16, staged in the warp's own 16
// rows of a padded tile and stored as 16-byte rows of [*, H, D] from row t0.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* stage, const float (&acc)[DP / 8][4],
                                           const float (&mul)[2], bf16* out, int t0,
                                           int t_len, int H, int D) {
  constexpr int LD = DP + 8, CH = DP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * hf) * LD + 8 * j + 2 * t4) =
          pack(acc[j][2 * hf] * mul[hf], acc[j][2 * hf + 1] * mul[hf]);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 16 * CH / 32; ++n) {
    const int i = lane + 32 * n, r = i / CH, c = i % CH, t = t0 + r;
    if (t < t_len && c * 8 < D)
      *reinterpret_cast<uint4*>(out + (long long)t * H * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ldmatrix lane addresses, in elements, of a tile with row stride LD:
//   a_off: the A fragment of rows r0..r0+15, cols c0..c0+15 (non-trans)
//   b_off: the B fragments of two n-tiles, rows n0..n0+15 of a [n][k] tile,
//          k cols c0..c0+15 (non-trans): regs {b0, b1} of n0, then of n0+8
//   bt_off: the B fragments of two n-tiles, cols n0..n0+15 of a [k][n] tile,
//          k rows r0..r0+15 (.trans): regs {b0, b1} of n0, then of n0+8
__device__ __forceinline__ int a_off(int lane, int r0, int c0, int LD) {
  return (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int n0, int c0, int LD) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int r0, int n0, int LD) {
  return (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}

// A fragment of a 16-wide k-slice from the C fragments of n-tiles 2kk, 2kk+1
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

}  // namespace

// ---- forward on the tensor cores: O = softmax(Q K^T / sqrt(D)) V --------

// At DP <= 64 the compiler is held to 168 registers so that 3 blocks fit
// on an SM (unbounded it takes 175, which fit 2); at DP = 128 that would
// spill.
template <int DP>
__global__ void __launch_bounds__(TC, DP > 64 ? 1 : 3) geomx_fa_fwd_tc(const AttnParams p) {
  constexpr int LD = DP + 8, KS = DP / 16, NKT = BK / 8, NDT = DP / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                  // [2][BK][LD]
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int off = p.Tk - p.Tq;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  // causal: keys from q0 + BQ + off on are masked for every row of the tile
  const int kend = p.causal ? min(p.Tk, q0 + BQ + off) : p.Tk;
  const int nk = (kend + BK - 1) / BK;

  copy_tile<BQ, DP>(Qs, q, p.q_st, q0, p.Tq, p.D);
  copy_tile<BK, DP>(Ks, k, p.k_st, 0, p.Tk, p.D);
  copy_tile<BK, DP>(Vs, v, p.v_st, 0, p.Tk, p.D);
  cp_async_commit();

  const float sl2 = p.scale * LOG2E;  // exp(x * scale) = exp2(x * sl2)
  uint32_t qf[KS][4];
  float o[NDT][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * BK;
    const bf16* Kt = Ks + (it & 1) * BK * LD;
    const bf16* Vt = Vs + (it & 1) * BK * LD;
    if (it + 1 < nk) {  // the next tile's copy runs under this tile's products
      copy_tile<BK, DP>(Ks + ((it + 1) & 1) * BK * LD, k, p.k_st, k0 + BK, p.Tk, p.D);
      copy_tile<BK, DP>(Vs + ((it + 1) & 1) * BK * LD, v, p.v_st, k0 + BK, p.Tk, p.D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], Qs + a_off(lane, 16 * warp, 16 * ks, LD));
    }

    // S = Q K^T: 16 q rows x 64 keys per warp
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < NKT; j += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, Kt + b_off(lane, 8 * j, 16 * ks, LD));
        mma(s[j], qf[ks], bb[0], bb[1]);
        mma(s[j + 1], qf[ks], bb[2], bb[3]);
      }

    // scale, mask, online softmax; element e of n-tile j is q row
    // g + 8 (e / 2) of the warp, key 8j + 2 t4 + e % 2 of the tile
    const bool edge = k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int qpos = q0 + 16 * warp + g + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          if (!visible(p, qpos, kpos, off)) x = NEG;
        }
        s[j][e] = x;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NKT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
      const float m_new = fmaxf(m[hf], quad_max(mx));
      const float alpha = exp2f(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          sum += s[j][e];  // l sums P before its round to bf16, as Pallas does
        }
      l[hf] = l[hf] * alpha + sum;  // this thread's columns; the quad sums at the end
      m[hf] = m_new;
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        o[j][2 * hf] *= alpha;
        o[j][2 * hf + 1] *= alpha;
      }
    }

    // O += P V: P (rounded to bf16) from the S registers, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NDT; j += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, Vt + bt_off(lane, 16 * kk, 8 * j, LD));
        mma(o[j], a, bb[0], bb[1]);
        mma(o[j + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  float inv[2];
  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float lsum = quad_sum(l[hf]);
    // rows with no visible key have l == 0: emit zeros
    const float safe = lsum > 0.f ? lsum : 1.f;
    inv[hf] = 1.f / safe;
    const int t = q0 + 16 * warp + g + 8 * hf;
    if (t4 == 0 && t < p.Tq) p.lse[bh * p.Tq + t] = m[hf] * LN2 + logf(safe);
  }
  // the warp's own 16 rows of the Q tile, read only by this warp, stage O
  bf16* out = static_cast<bf16*>(p.out) + ((long long)b * p.Tq * p.H + h) * p.D;
  store_rows<DP>(Qs + 16 * warp * LD, o, inv, out, q0 + 16 * warp, p.Tq, p.H, p.D);
}

// ---- dK/dV on the tensor cores: dV = sum_q P^T dO, dK = sum_q dS^T Q ------

template <int DP>
__global__ void __launch_bounds__(TC) geomx_fa_dkv_tc(const AttnParams p) {
  constexpr int BQS = DP > 64 ? 32 : 64;  // q rows per sweep step
  constexpr int LD = DP + 8, KS = DP / 16, NQT = BQS / 8, NDT = DP / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);  // [BK][LD]
  bf16* Vs = Ks + BK * LD;                      // [BK][LD]
  bf16* Qs = Vs + BK * LD;                      // [2][BQS][LD]
  bf16* Os = Qs + 2 * BQS * LD;                 // [2][BQS][LD], dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQS * LD);  // [2][BQS] lse
  float* Es = Ls + 2 * BQS;                                  // [2][BQS] delta
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int off = p.Tk - p.Tq;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long bh = (long long)b * p.H + h;
  const float* lse = p.lse_in + bh * p.Tq;
  const float* dlt = p.delta + bh * p.Tq;
  // causal: q tiles ending at or before k0 - off see none of these keys
  int qstart = 0;
  if (p.causal && k0 - off > 0) qstart = ((k0 - off) / BQS) * BQS;
  const int nq = qstart < p.Tq ? (p.Tq - qstart + BQS - 1) / BQS : 0;

  auto copy_q = [&](int stage, int q0) {
    copy_tile<BQS, DP>(Qs + stage * BQS * LD, q, p.q_st, q0, p.Tq, p.D);
    copy_tile<BQS, DP>(Os + stage * BQS * LD, dout, p.do_st, q0, p.Tq, p.D);
    copy_row<BQS>(Ls + stage * BQS, lse, q0, p.Tq);
    copy_row<BQS>(Es + stage * BQS, dlt, q0, p.Tq);
  };
  copy_tile<BK, DP>(Ks, k, p.k_st, k0, p.Tk, p.D);
  copy_tile<BK, DP>(Vs, v, p.v_st, k0, p.Tk, p.D);
  if (nq > 0) copy_q(0, qstart);
  cp_async_commit();

  const float sl2 = p.scale * LOG2E;
  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int q0 = qstart + it * BQS;
    const bf16* Qt = Qs + (it & 1) * BQS * LD;
    const bf16* Ot = Os + (it & 1) * BQS * LD;
    const float* Lt = Ls + (it & 1) * BQS;
    const float* Et = Es + (it & 1) * BQS;
    if (it + 1 < nq) {  // the next q tile's copy runs under this one's products
      copy_q((it + 1) & 1, q0 + BQS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 k rows x BQS q columns per warp
    float s[NQT][4], dp[NQT][4];
#pragma unroll
    for (int j = 0; j < NQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, Ks + a_off(lane, 16 * warp, 16 * ks, LD));
      ldsm_x4(va, Vs + a_off(lane, 16 * warp, 16 * ks, LD));
#pragma unroll
      for (int j = 0; j < NQT; j += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, Qt + b_off(lane, 8 * j, 16 * ks, LD));
        mma(s[j], ka, bb[0], bb[1]);
        mma(s[j + 1], ka, bb[2], bb[3]);
        ldsm_x4(bb, Ot + b_off(lane, 8 * j, 16 * ks, LD));
        mma(dp[j], va, bb[0], bb[1]);
        mma(dp[j + 1], va, bb[2], bb[3]);
      }
    }

    // P^T = exp(S^T scale - lse), masked; dS^T = P^T (dP^T - delta) scale.
    // Element e of n-tile j is k row g + 8 (e / 2) of the warp, q column
    // 8j + 2 t4 + e % 2 of the tile.
    const bool edge = q0 + BQS > p.Tq || k0 + BK > p.Tk ||
                      (p.causal && q0 + off < k0 + BK - 1);
#pragma unroll
    for (int j = 0; j < NQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        float pr = exp2f(s[j][e] * sl2 - Lt[c] * LOG2E);
        if (edge && !visible(p, q0 + c, k0 + 16 * warp + g + 8 * (e >> 1), off)) pr = 0.f;
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - Et[c]) * p.scale;
      }

    // dV += P^T dO (P^T rounded to dO's type), dK += dS^T Q (dS^T rounded to
    // Q's type): A from the registers above, B through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQS / 16; ++kk) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NDT; j += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, Ot + bt_off(lane, 16 * kk, 8 * j, LD));
        mma(dv[j], pa, bb[0], bb[1]);
        mma(dv[j + 1], pa, bb[2], bb[3]);
        ldsm_x4_t(bb, Qt + bt_off(lane, 16 * kk, 8 * j, LD));
        mma(dk[j], sa, bb[0], bb[1]);
        mma(dk[j + 1], sa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  cp_async_wait<0>();  // with no live q tile, the K / V copies may still run
  __syncthreads();
  // the warp's own 16 rows of the K and V tiles, read only by this warp,
  // stage dK and dV
  const float one[2] = {1.f, 1.f};
  const long long row0 = (long long)b * p.Tk * p.H + h;
  store_rows<DP>(Ks + 16 * warp * LD, dk, one, static_cast<bf16*>(p.dk) + row0 * p.D,
                 k0 + 16 * warp, p.Tk, p.H, p.D);
  store_rows<DP>(Vs + 16 * warp * LD, dv, one, static_cast<bf16*>(p.dv) + row0 * p.D,
                 k0 + 16 * warp, p.Tk, p.H, p.D);
}

// ---- dQ on the tensor cores: dQ = sum_k dS K, dS = P (dP - delta) scale ---

// Each warp reads its Q and dO A fragments from the resident tiles on every
// k step: holding them in registers instead costs DP / 2 more registers,
// and at DP = 64 leaves room for 2 blocks per SM, not 3. At DP = 128 the k
// step drops to 32 rows to halve the S and dP tiles beside the 16 x 128 dQ
// accumulator.
template <int DP>
__global__ void __launch_bounds__(TC, DP > 64 ? 1 : 3) geomx_fa_dq_tc(const AttnParams p) {
  constexpr int BKS = DP > 64 ? 32 : 64;  // k rows per sweep step
  constexpr int LD = DP + 8, KS = DP / 16, NKT = BKS / 8, NDT = DP / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][LD]
  bf16* Os = Qs + BQ * LD;                      // [BQ][LD], dO
  bf16* Ks = Os + BQ * LD;                      // [2][BKS][LD]
  bf16* Vs = Ks + 2 * BKS * LD;                 // [2][BKS][LD]
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int off = p.Tk - p.Tq;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int kend = p.causal ? min(p.Tk, q0 + BQ + off) : p.Tk;
  const int nk = (kend + BKS - 1) / BKS;

  copy_tile<BQ, DP>(Qs, q, p.q_st, q0, p.Tq, p.D);
  copy_tile<BQ, DP>(Os, dout, p.do_st, q0, p.Tq, p.D);
  copy_tile<BKS, DP>(Ks, k, p.k_st, 0, p.Tk, p.D);
  copy_tile<BKS, DP>(Vs, v, p.v_st, 0, p.Tk, p.D);
  cp_async_commit();

  // lse (as a log2) and delta of the thread's two rows g, g + 8 of the warp
  const float sl2 = p.scale * LOG2E;
  const long long bh = (long long)b * p.H + h;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = q0 + 16 * warp + g + 8 * hf;
    lse2[hf] = t < p.Tq ? p.lse_in[bh * p.Tq + t] * LOG2E : 0.f;
    dlt[hf] = t < p.Tq ? p.delta[bh * p.Tq + t] : 0.f;
  }
  float dq[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * BKS;
    const bf16* Kt = Ks + (it & 1) * BKS * LD;
    const bf16* Vt = Vs + (it & 1) * BKS * LD;
    if (it + 1 < nk) {  // the next tile's copy runs under this tile's products
      copy_tile<BKS, DP>(Ks + ((it + 1) & 1) * BKS * LD, k, p.k_st, k0 + BKS, p.Tk, p.D);
      copy_tile<BKS, DP>(Vs + ((it + 1) & 1) * BKS * LD, v, p.v_st, k0 + BKS, p.Tk, p.D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 q rows x BKS keys per warp
    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, Qs + a_off(lane, 16 * warp, 16 * ks, LD));
      ldsm_x4(oa, Os + a_off(lane, 16 * warp, 16 * ks, LD));
#pragma unroll
      for (int j = 0; j < NKT; j += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, Kt + b_off(lane, 8 * j, 16 * ks, LD));
        mma(s[j], qa, bb[0], bb[1]);
        mma(s[j + 1], qa, bb[2], bb[3]);
        ldsm_x4(bb, Vt + b_off(lane, 8 * j, 16 * ks, LD));
        mma(dp[j], oa, bb[0], bb[1]);
        mma(dp[j + 1], oa, bb[2], bb[3]);
      }
    }

    // P = exp(S scale - lse), masked; dS = P (dP - delta) scale in place of
    // S. Element e of n-tile j is q row g + 8 (e / 2) of the warp, key
    // 8j + 2 t4 + e % 2 of the tile.
    const bool edge = k0 + BKS > p.Tk || (p.causal && k0 + BKS - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        float pr = exp2f(s[j][e] * sl2 - lse2[hf]);
        if (edge && !visible(p, q0 + 16 * warp + g + 8 * hf, k0 + 8 * j + 2 * t4 + (e & 1), off))
          pr = 0.f;
        s[j][e] = pr * (dp[j][e] - dlt[hf]) * p.scale;
      }

    // dQ += dS K: dS (rounded to K's type) from the registers above, K
    // through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BKS / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < NDT; j += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, Kt + bt_off(lane, 16 * kk, 8 * j, LD));
        mma(dq[j], a, bb[0], bb[1]);
        mma(dq[j + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // the warp's own 16 rows of the Q tile, read only by this warp, stage dQ
  const float one[2] = {1.f, 1.f};
  bf16* out = static_cast<bf16*>(p.dq) + ((long long)b * p.Tq * p.H + h) * p.D;
  store_rows<DP>(Qs + 16 * warp * LD, dq, one, out, q0 + 16 * warp, p.Tq, p.H, p.D);
}

// ---- launch -----------------------------------------------------------

namespace {

// Dynamic shared memory of each kernel, in bytes, for head dim D (the
// CUDA-core kernels) or padded head dim DP (the tensor-core ones).
size_t fwd_smem(int D) { return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * LDS); }
size_t dq_smem(int D) { return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) + BQ * LDS); }
size_t dkv_smem(int D) {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * LDS + 2 * BQ);
}
constexpr size_t fwd_tc_smem(int DP) { return sizeof(bf16) * (size_t)(BQ + 4 * BK) * (DP + 8); }
constexpr size_t dq_tc_smem(int DP) {
  return sizeof(bf16) * (size_t)(2 * BQ + 4 * (DP > 64 ? 32 : 64)) * (DP + 8);
}
constexpr size_t dkv_tc_smem(int DP) {
  return sizeof(bf16) * (size_t)(2 * BK + 4 * (DP > 64 ? 32 : 64)) * (DP + 8) +
         sizeof(float) * 4 * (DP > 64 ? 32 : 64);
}
constexpr int MAX_D = 128;

typedef void (*Kernel)(const AttnParams);

// Above 48 KB, dynamic shared memory must be opted into per kernel and
// device: done once, for the most the kernel can ask (its size at D = 128),
// not on every launch.
cudaError_t opt_in(Kernel kernel, size_t smem_max) {
  static std::mutex mu;
  static const void* done_fn[64];
  static int done_dev[64];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done_fn[i] == fn && done_dev[i] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_max));
  if (err == cudaSuccess && n_done < 64) {
    done_fn[n_done] = fn;
    done_dev[n_done++] = dev;
  }
  return err;
}

int launch(Kernel kernel, dim3 grid, int threads, size_t smem, size_t smem_max,
           const AttnParams& p, void* stream) {
  cudaError_t err = opt_in(kernel, smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// grid of the tensor-core kernels: (b, h) fastest, then the 64-row tile
dim3 tc_grid(const AttnParams& p, int t) { return dim3(p.B * p.H, (t + 63) / 64); }

template <int DP>
int fwd_tc(const AttnParams& p, void* stream) {
  return launch(geomx_fa_fwd_tc<DP>, tc_grid(p, p.Tq), TC, fwd_tc_smem(DP), fwd_tc_smem(DP), p,
                stream);
}

template <int DP>
int dq_tc(const AttnParams& p, void* stream) {
  return launch(geomx_fa_dq_tc<DP>, tc_grid(p, p.Tq), TC, dq_tc_smem(DP), dq_tc_smem(DP), p,
                stream);
}

template <int DP>
int dkv_tc(const AttnParams& p, void* stream) {
  return launch(geomx_fa_dkv_tc<DP>, tc_grid(p, p.Tk), TC, dkv_tc_smem(DP), dkv_tc_smem(DP), p,
                stream);
}

}  // namespace

// C entry points. Each returns the launch's cudaError_t (0 on success).
// route: 0 runs the fp32 CUDA-core kernel; 32, 64 or 128 the bf16
// tensor-core kernel of that padded head dim (which must hold D).
extern "C" int geomx_flash_fwd(const AttnParams* p, int route, void* stream) {
  if (route != 0 && route < p->D) return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case 0:
      return launch(flash_fwd_kernel, dim3((p->Tq + BQ - 1) / BQ, p->H, p->B), NT,
                    fwd_smem(p->D), fwd_smem(MAX_D), *p, stream);
    case 32: return fwd_tc<32>(*p, stream);
    case 64: return fwd_tc<64>(*p, stream);
    case 128: return fwd_tc<128>(*p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int geomx_flash_dq(const AttnParams* p, int route, void* stream) {
  if (route != 0 && route < p->D) return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case 0:
      return launch(flash_dq_kernel, dim3((p->Tq + BQ - 1) / BQ, p->H, p->B), NT,
                    dq_smem(p->D), dq_smem(MAX_D), *p, stream);
    case 32: return dq_tc<32>(*p, stream);
    case 64: return dq_tc<64>(*p, stream);
    case 128: return dq_tc<128>(*p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int geomx_flash_dkv(const AttnParams* p, int route, void* stream) {
  if (route != 0 && route < p->D) return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case 0:
      return launch(flash_dkv_kernel, dim3((p->Tk + BK - 1) / BK, p->H, p->B), NT,
                    dkv_smem(p->D), dkv_smem(MAX_D), *p, stream);
    case 32: return dkv_tc<32>(*p, stream);
    case 64: return dkv_tc<64>(*p, stream);
    case 128: return dkv_tc<128>(*p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
