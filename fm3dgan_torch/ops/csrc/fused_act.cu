// Fused bias + LeakyReLU + scale, NCHW, fp32 or bf16 with fp32 arithmetic:
//     y = scale * leaky_relu(x + bias[c], slope),  c = (i / HW) % C.
// Entry points declared in kernels.h, bound to the fm3dgan_torch operators
// by ops.cpp.
//
// fm_fused_leaky_relu replaces the TPU kernel
// fm3dgan/ops/pallas/fused_act_kernel.py `_call_fwd` (:48, reached through
// `_fused_leaky_relu_p` :87 and `fused_leaky_relu_pallas_maybe` :106), the
// forward of every StyledConv and every D ConvLayer.
//
// fm_fused_leaky_relu_bwd replaces `_call_bwd` (:67, reached through the VJP
// `_p_bwd` :96): dx = g * (out >= 0 ? scale : slope * scale), from the saved
// OUTPUT only (scale > 0 keeps the sign of x + bias).  dbias = sum(dx) stays
// outside the kernel, as in the JAX VJP (:99).  It also serves the double
// backward (R1, PPL), which is the same map applied to ggx + ggb.
//
// Bound on an H100: memory.  Three flops per element against one read and one
// write (two reads and one write for the backward), so the floor is the
// bytes over 3.35 TB/s.  The design reads each
// element once and writes it once with 16-byte vector accesses (4 fp32 or 8
// bf16 per thread) when HW is a multiple of the vector width and both
// pointers are 16-byte aligned; then every vector lies in one channel and
// needs one bias load.  Otherwise it takes one element per thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "kernels.h"

namespace {

__device__ __forceinline__ float act(float v, float slope, float scale) {
  return (v >= 0.f ? v : v * slope) * scale;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void fused_lrelu_scalar(const T* __restrict__ x,
                                   const T* __restrict__ bias,
                                   T* __restrict__ y, int64_t total, int C,
                                   int HW, float slope, float scale) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = to_f(x[i]);
    if (bias != nullptr) v += to_f(bias[(i / HW) % C]);
    y[i] = from_f<T>(act(v, slope, scale));
  }
}

// One uint4 (16 bytes) = VEC elements of T, all in one channel.
template <typename T, int VEC>
__global__ void fused_lrelu_vec(const uint4* __restrict__ x,
                                const T* __restrict__ bias,
                                uint4* __restrict__ y, int64_t nvec, int C,
                                int HW, float slope, float scale) {
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const float b =
        bias != nullptr ? to_f(bias[((v * VEC) / HW) % C]) : 0.f;
    uint4 in = x[v];
    uint4 out;
    const T* pin = reinterpret_cast<const T*>(&in);
    T* pout = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < VEC; ++e) pout[e] = from_f<T>(act(to_f(pin[e]) + b, slope, scale));
    y[v] = out;
  }
}

template <typename T>
__global__ void fused_lrelu_bwd_scalar(const T* __restrict__ g,
                                       const T* __restrict__ out,
                                       T* __restrict__ dx, int64_t total,
                                       float pos, float neg) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    dx[i] = from_f<T>(to_f(g[i]) * (to_f(out[i]) >= 0.f ? pos : neg));
  }
}

template <typename T, int VEC>
__global__ void fused_lrelu_bwd_vec(const uint4* __restrict__ g,
                                    const uint4* __restrict__ out,
                                    uint4* __restrict__ dx, int64_t nvec,
                                    float pos, float neg) {
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * blockDim.x) {
    uint4 gv = g[v];
    uint4 ov = out[v];
    uint4 r;
    const T* pg = reinterpret_cast<const T*>(&gv);
    const T* po = reinterpret_cast<const T*>(&ov);
    T* pr = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int e = 0; e < VEC; ++e) pr[e] = from_f<T>(to_f(pg[e]) * (to_f(po[e]) >= 0.f ? pos : neg));
    dx[v] = r;
  }
}

inline int grid_for(int64_t total, int block) {
  int64_t g = (total + block - 1) / block;
  const int64_t cap = 132 * 32;
  return (int)(g < cap ? (g > 0 ? g : 1) : cap);
}

template <typename T>
void launch(const void* x, const void* bias, void* y, int64_t total, int C,
            int HW, float slope, float scale, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int block = 256;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (aligned && HW % VEC == 0) {
    const int64_t nvec = total / VEC;
    fused_lrelu_vec<T, VEC><<<grid_for(nvec, block), block, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const T*>(bias),
        static_cast<uint4*>(y), nvec, C, HW, slope, scale);
  } else {
    fused_lrelu_scalar<T><<<grid_for(total, block), block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(bias),
        static_cast<T*>(y), total, C, HW, slope, scale);
  }
}

template <typename T>
void launch_bwd(const void* g, const void* out, void* dx, int64_t total,
                float slope, float scale, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int block = 256;
  const bool aligned = (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dx) % 16 == 0);
  if (aligned && total % VEC == 0) {
    const int64_t nvec = total / VEC;
    fused_lrelu_bwd_vec<T, VEC><<<grid_for(nvec, block), block, 0, s>>>(
        static_cast<const uint4*>(g), static_cast<const uint4*>(out),
        static_cast<uint4*>(dx), nvec, scale, slope * scale);
  } else {
    fused_lrelu_bwd_scalar<T><<<grid_for(total, block), block, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(out),
        static_cast<T*>(dx), total, scale, slope * scale);
  }
}

}  // namespace

int fm_fused_leaky_relu(const void* x, const void* bias, void* y, int dtype,
                        long long total, int C, int HW, float slope,
                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, bias, y, total, C, HW, slope, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, bias, y, total, C, HW, slope, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fm_fused_leaky_relu_bwd(const void* g, const void* out, void* dx,
                            int dtype, long long total, float slope,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(g, out, dx, total, slope, scale, s);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(g, out, dx, total, slope, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
