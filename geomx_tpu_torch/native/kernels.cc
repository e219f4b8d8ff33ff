// Native aggregation/optimizer kernels for the host-side PS data plane.
//
// The reference runs server aggregation and optimizer math through MXNet's
// engine-scheduled C++ kernels (reference: kvstore_dist_server.h:1296
// merged += recved via elemwise ops, src/operator/tensor/
// elemwise_binary_op-inl.h; optimizer steps in C++ for the built-ins).
// Our server's hot loop is numpy, which holds the GIL for these sizes —
// flattening multi-key throughput no matter how the locking is arranged.
// ctypes calls release the GIL, so these plain-C loops restore true
// thread scaling for concurrent per-key handling (tools/server_bench.py).
//
// Build: g++ -O3 -std=c++17 -fPIC -shared (geomx_tpu/kernels_native.py,
// same on-demand pattern as the transport core).

#include <cstdint>
#include <cmath>

extern "C" {

// dst += src
void gxk_acc(float* dst, const float* src, int64_t n) {
    for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

// dst = src (with cast-free fp32 copy)
void gxk_copy(float* dst, const float* src, int64_t n) {
    for (int64_t i = 0; i < n; ++i) dst[i] = src[i];
}

// dst = a * dst + src
void gxk_scale_acc(float* dst, float a, const float* src, int64_t n) {
    for (int64_t i = 0; i < n; ++i) dst[i] = a * dst[i] + src[i];
}

// SGD with optional momentum buffer and weight decay:
//   g' = g + wd * w;  m = mom * m + g';  w -= lr * m      (mom != 0)
//   w -= lr * g'                                           (mom == 0)
void gxk_sgd(float* w, const float* g, float* mom_buf, float lr,
             float momentum, float wd, int64_t n) {
    if (mom_buf && momentum != 0.0f) {
        for (int64_t i = 0; i < n; ++i) {
            float gi = g[i] + wd * w[i];
            mom_buf[i] = momentum * mom_buf[i] + gi;
            w[i] -= lr * mom_buf[i];
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            float gi = g[i] + wd * w[i];
            w[i] -= lr * gi;
        }
    }
}

// Adam step (bias-corrected), t is the POST-increment step count.
void gxk_adam(float* w, const float* g, float* m, float* v, float lr,
              float b1, float b2, float eps, float wd, int64_t t,
              int64_t n) {
    float bc1 = 1.0f - std::pow(b1, (float)t);
    float bc2 = 1.0f - std::pow(b2, (float)t);
    for (int64_t i = 0; i < n; ++i) {
        float gi = g[i] + wd * w[i];
        m[i] = b1 * m[i] + (1.0f - b1) * gi;
        v[i] = b2 * v[i] + (1.0f - b2) * gi * gi;
        float mh = m[i] / bc1;
        float vh = v[i] / bc2;
        w[i] -= lr * mh / (std::sqrt(vh) + eps);
    }
}

}  // extern "C"
