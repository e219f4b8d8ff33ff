// Residual-feedback 2-bit quantize and pack, fused, for Hopper (sm_90a).
//
// Replaces the Pallas pack of geomx_tpu/ops/__init__.py (`_pallas_pack4`,
// body `kernel` at :161) together with the jnp lines that `_two_bit_fn`
// jits around it (:138-147), in one pass over the data:
//
//   r = residual + grad
//   code = 1 where r > thr, 2 where r < -thr, else 0
//   r -= thr on code 1, r += thr on code 2
//   out[i] = c[4i] | c[4i+1] << 2 | c[4i+2] << 4 | c[4i+3] << 6
//
// with zero codes past the end of a row whose length is not a multiple of
// four (the JAX wrapper's padding, :144-146).
//
// Bound: bytes. Per element it reads 8 bytes (grad, residual) and writes
// 4.25 (new residual, a quarter of a code byte) and does three fp32 adds
// or compares, far below the card's rate. The design keeps the traffic at
// that minimum: one thread per output byte, 16-byte float4 loads and
// stores where every row is 16-byte aligned and a multiple of four long,
// a scalar path otherwise; the codes never reach device memory unpacked.
//
// Bit-exactness: the only arithmetic is one fp32 add (and one fp32
// add or subtract of thr on coded lanes), each rounded to nearest
// (__fadd_rn / __fsub_rn, so nothing is contracted), on thr passed as an
// fp32 value. That is what jnp and numpy compute, so codes and residual
// match them bit for bit.
//
// Layout: `rows` rows of `m` elements; each of grad, residual in,
// residual out and packed has its own row stride, so the quantized ring
// can hand over the strided per-slot view of its (P, slots, m) residual
// without a copy. Residual in and out may be the same memory (each
// element is read and written by one thread).

#include <cstdint>
#include <cuda_runtime.h>

struct TwoBitParams {
  const float* grad;
  const float* res_in;
  float* res_out;
  uint8_t* packed;
  long long rows, m;  // rows of m elements
  long long grad_rs, res_in_rs, res_out_rs, packed_rs;  // row strides
  float thr;
};

namespace {

__device__ __forceinline__ unsigned quantize(float g, float res, float thr,
                                             float* out) {
  float r = __fadd_rn(res, g);
  unsigned code = 0;
  if (r > thr) {
    code = 1;
    r = __fsub_rn(r, thr);
  } else if (r < -thr) {
    code = 2;
    r = __fadd_rn(r, thr);
  }
  *out = r;
  return code;
}

template <bool VEC>
__global__ void two_bit_kernel(TwoBitParams p) {
  const long long nb = (p.m + 3) / 4;  // output bytes per row
  const long long total = p.rows * nb;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / nb, b = i - row * nb, e0 = 4 * b;
    const float* g = p.grad + row * p.grad_rs + e0;
    const float* rin = p.res_in + row * p.res_in_rs + e0;
    float* rout = p.res_out + row * p.res_out_rs + e0;
    unsigned c0, c1, c2, c3;
    if (VEC) {
      const float4 gv = *reinterpret_cast<const float4*>(g);
      const float4 rv = *reinterpret_cast<const float4*>(rin);
      float4 ov;
      c0 = quantize(gv.x, rv.x, p.thr, &ov.x);
      c1 = quantize(gv.y, rv.y, p.thr, &ov.y);
      c2 = quantize(gv.z, rv.z, p.thr, &ov.z);
      c3 = quantize(gv.w, rv.w, p.thr, &ov.w);
      *reinterpret_cast<float4*>(rout) = ov;
    } else {
      unsigned c[4] = {0, 0, 0, 0};
      for (int k = 0; k < 4 && e0 + k < p.m; ++k) {
        float o;
        c[k] = quantize(g[k], rin[k], p.thr, &o);
        rout[k] = o;
      }
      c0 = c[0];
      c1 = c[1];
      c2 = c[2];
      c3 = c[3];
    }
    p.packed[row * p.packed_rs + b] =
        static_cast<uint8_t>(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
  }
}

}  // namespace

// vec != 0 asserts what the wrapper checked: m % 4 == 0, every row
// stride a multiple of 4 elements and every base pointer 16-byte aligned.
extern "C" int geomx_two_bit_quantize(const TwoBitParams* p, int vec,
                                      void* stream) {
  const long long total = p->rows * ((p->m + 3) / 4);
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride past this
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    two_bit_kernel<true><<<static_cast<unsigned>(blocks), threads, 0, s>>>(*p);
  else
    two_bit_kernel<false><<<static_cast<unsigned>(blocks), threads, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}
