// The per-element arithmetic of batch norm with its SiLU, shared by bn_act.cu
// (the BN kernels) and dw_conv.cu (the depthwise convs' eval BN prologue), so
// that an eval BN+SiLU gives the same bits inside a conv as in its own pass.

#pragma once

#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dw_vec.cuh"

namespace {

// v rounded to T and back: the rounding of a bf16 intermediate; none in fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return static_cast<float>(from_float<T>(v));
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// SiLU and its gradient in the order of PyTorch's silu and silu_backward. In
// bf16 with the hardware's exponential and a fast division: the exact ones
// cost as many instructions per element as the card has cycles for at full
// bandwidth, and their fp32 differences (a few units in the last place)
// vanish in the rounding to bf16 but at the rare element on a boundary. fp32
// keeps the exact ones. bf16's SiLU takes 2^t and 1/d from the special
// function unit alone (ex2.approx.ftz, rcp.approx.ftz): __expf and
// __fdividef are the same two approximations with subnormal handling around
// them (4 more instructions an element), and a subnormal here changes no
// bf16 result: e = 2^t below 2^-126 leaves 1 + e = 1, and z is a bf16 value
// (round_to) at which both forms round to the same bf16 SiLU.
template <typename T>
__device__ __forceinline__ float sigmoid(float z) {
  if constexpr (std::is_same_v<T, float>) {
    return 1.0f / (1.0f + expf(-z));
  } else {
    return __frcp_rn(1.0f + __expf(-z));
  }
}

template <typename T>
__device__ __forceinline__ float silu(float z) {
  if constexpr (std::is_same_v<T, float>) {
    return z / (1.0f + expf(-z));
  } else {
    float e, r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * -1.4426950408889634f));
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
    return z * r;
  }
}

// dy * silu'(z).
template <typename T>
__device__ __forceinline__ float silu_grad(float dy, float z) {
  const float s = sigmoid<T>(z);
  return dy * s * (1.0f + z * (1.0f - s));
}

// Eval BN's per-channel a and b from the running statistics: y = x*a + b.
__device__ __forceinline__ void eval_affine(float mean, float var, float scale, float bias, float eps, float& a,
                                            float& b) {
  a = rsqrtf(var + eps) * scale;
  b = bias - mean * a;
}

// silu(round(x*a + b)), to be rounded to T by its store: eval BN+SiLU of one element.
template <typename T>
__device__ __forceinline__ float bn_silu(float x, float a, float b) {
  return silu<T>(round_to<T>(fmaf(x, a, b)));
}

// bn_silu of one 16-byte vector of x's channels, rounded to T as the BN
// kernels store it: the eval BN's output that a depthwise conv reads. bf16
// rounds two channels with one packed conversion, twice.
template <typename T>
__device__ __forceinline__ uint4 bn_silu_vec(uint4 raw, const float (&a)[Vec16<T>::kN],
                                             const float (&b)[Vec16<T>::kN]) {
  if constexpr (std::is_same_v<T, float>) {
    float f[4];
    Vec16<float>::unpack(f, raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = bn_silu<float>(f[i], a[i], b[i]);
    return Vec16<float>::pack(f);
  } else {
    uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float x0, x1;
      Vec16<__nv_bfloat16>::unpack2(x0, x1, w[q]);
      const __nv_bfloat162 z =
          __floats2bfloat162_rn(fmaf(x0, a[2 * q], b[2 * q]), fmaf(x1, a[2 * q + 1], b[2 * q + 1]));
      const __nv_bfloat162 y = __floats2bfloat162_rn(silu<T>(__low2float(z)), silu<T>(__high2float(z)));
      w[q] = *reinterpret_cast<const uint32_t*>(&y);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// An eval BN's running statistics and parameters, fp32 per channel, and its eps.
struct EvalBn {
  const float* mean;
  const float* var;
  const float* scale;
  const float* bias;
  float eps;
};

// a and b of `n` channels from ch: those past `valid` are 0, so a zero of the
// padding or of a channel tail stays 0 (silu(round(0*0 + 0)) = 0).
template <int N>
__device__ __forceinline__ void eval_channels(float (&a)[N], float (&b)[N], const EvalBn& bn, int ch, int valid) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = b[i] = 0.0f;
    if (i < valid) eval_affine(bn.mean[ch + i], bn.var[ch + i], bn.scale[ch + i], bn.bias[ch + i], bn.eps, a[i], b[i]);
  }
}

}  // namespace
