// FlashAttention-2 forward, dQ and dK/dV as CUDA kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of geomx_tpu/ops/flash_attention.py:
//   _kernels -> fwd_kernel  (body :85, launched by fwd     :125) -> flash_fwd_kernel
//   _kernels -> dq_kernel   (body :155, launched by bwd_dq :187) -> flash_dq_kernel
//   _kernels -> dkv_kernel  (body :207, launched by bwd_dkv :245) -> flash_dkv_kernel
//
// What bounds it on the H100. At the transformer slice's shape (B 8, H 8,
// T 511, D 64, bf16, causal) the forward moves ~16.9 MB and does ~2.1 causal
// GFLOP: on paper it is bound by bytes (5.0 us at 3.35 TB/s against 2.2 us of
// tensor-core time), and the backward pair likewise. This first version does
// its products as fp32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor
// cores' 989) with operands re-read from shared memory, so in practice the
// shared-memory traffic of those FMAs bounds it, well above the bound. The
// tensor cores (wgmma) and TMA-fed pipelines are later work.
//
// Design. The TPU kernels run a sequential grid whose innermost dimension
// carries the online-softmax state (acc, m, l) or the dQ / dK / dV sums in
// VMEM scratch from one grid step to the next. Blocks on the H100 run in no
// order, so each block owns one output tile and loops over the other axis
// itself:
//   - fwd and dQ: one block per (b, h, 64-row q tile), looping over the live
//     64-row k tiles (causal tiles past the diagonal are skipped, as _live does);
//   - dK/dV: one block per (b, h, 64-row k tile), looping over q tiles from
//     the first live one.
// Tiles are staged in shared memory as fp32 (bf16 widens exactly), rows
// padded to D + 1 floats so the column walks are free of bank conflicts.
// 256 threads hold a 64 x 64 score tile as 4 x 4 registers each; the 16
// threads sharing a row are one half-warp, so row max and row sum are
// shuffles. Accumulators stay in fp32 registers for the whole sweep.
// The kernels read q, k, v and dO in the model's [B, T, H, D] layout through
// strides (the last one must be 1) and mask the ragged edge themselves, in
// place of the JAX wrapper's transpose and pad. Outputs are contiguous:
// o / dq [B, Tq, H, D], dk / dv [B, Tk, H, D], lse [B, H, Tq] fp32.
//
// Numerics mirror the Pallas kernels: scores scaled by 1/sqrt(D) in fp32;
// masked scores set to -1e30 (not -inf); rows with l == 0 write zeros; causal
// offset kv_len - q_len (decode convention); P rounded to V's type before
// P.V; dS rounded to K's / Q's type before dS.K / dS^T.Q; P rounded to dO's
// type before P^T.dO; every sum in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the storage type T and widened back (the Pallas .astype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

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
// at row 0 of the slice, st is the T stride) into shared fp32 [64][D + 1];
// rows at or past t_len are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long st,
                                          int t0, int t_len, int D) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i - r * D, t = t0 + r;
    dst[r * ld + d] = t < t_len ? to_f(src[(long long)t * st + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(const AttnParams& p, int qpos, int kpos, int off) {
  return qpos < p.Tq && kpos < p.Tk && (!p.causal || qpos + off >= kpos);
}

// ---- forward: O = softmax(Q K^T / sqrt(D)) V, lse = m + log l --------------

template <typename T>
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
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
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
        Ps[r * LDS + tx + 16 * j] = round_to<T>(e);
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

  T* o = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= p.Tq) continue;
    // rows with no visible key have l == 0: emit zeros
    const float safe = l[i] > 0.f ? l[i] : 1.f;
    T* orow = o + (((long long)b * p.Tq + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f<T>(acc[i][j] / safe);
    }
    if (tx == 0) p.lse[((long long)b * p.H + h) * p.Tq + t] = m[i] + logf(safe);
  }
}

// ---- backward dQ: dQ = sum_k dS K, dS = P (dP - delta) / sqrt(D) -----------

template <typename T>
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
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
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
        Ss[r * LDS + c] = round_to<T>(pij * (dp[i][j] - dlt[i]) * p.scale);
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

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= p.Tq) continue;
    T* row = dq + (((long long)b * p.Tq + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = from_f<T>(acc[i][j]);
    }
  }
}

// ---- backward dK/dV: dV = sum_q P^T dO, dK = sum_q dS^T Q ------------------

template <typename T>
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
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
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
        Ps[r * LDS + c] = round_to<T>(pij);
        Ss[r * LDS + c] = round_to<T>(pij * (dp[i][j] - Es[r]) * p.scale);
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

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= p.Tk) continue;
    const long long row = (((long long)b * p.Tk + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkp[row + d] = from_f<T>(dk[i][j]);
        dvp[row + d] = from_f<T>(dv[i][j]);
      }
    }
  }
}

// Dynamic shared memory of each kernel, in bytes, for head dim D.
size_t fwd_smem(int D) { return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * LDS); }
size_t dq_smem(int D) { return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) + BQ * LDS); }
size_t dkv_smem(int D) {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * LDS + 2 * BQ);
}

typedef void (*Kernel)(const AttnParams);

int launch(Kernel kernel, dim3 grid, size_t smem, const AttnParams& p, void* stream) {
  // above 48 KB, dynamic shared memory must be opted into per kernel
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: bf16 != 0 selects __nv_bfloat16 operands, else float.
// Each returns the launch's cudaError_t (0 on success).
extern "C" int geomx_flash_fwd(const AttnParams* p, int bf16, void* stream) {
  const dim3 grid((p->Tq + BQ - 1) / BQ, p->H, p->B);
  Kernel kernel = flash_fwd_kernel<float>;
  if (bf16) kernel = flash_fwd_kernel<__nv_bfloat16>;
  return launch(kernel, grid, fwd_smem(p->D), *p, stream);
}

extern "C" int geomx_flash_dq(const AttnParams* p, int bf16, void* stream) {
  const dim3 grid((p->Tq + BQ - 1) / BQ, p->H, p->B);
  Kernel kernel = flash_dq_kernel<float>;
  if (bf16) kernel = flash_dq_kernel<__nv_bfloat16>;
  return launch(kernel, grid, dq_smem(p->D), *p, stream);
}

extern "C" int geomx_flash_dkv(const AttnParams* p, int bf16, void* stream) {
  const dim3 grid((p->Tk + BK - 1) / BK, p->H, p->B);
  Kernel kernel = flash_dkv_kernel<float>;
  if (bf16) kernel = flash_dkv_kernel<__nv_bfloat16>;
  return launch(kernel, grid, dkv_smem(p->D), *p, stream);
}
