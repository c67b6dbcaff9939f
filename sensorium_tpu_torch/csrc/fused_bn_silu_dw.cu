// Fused BN-apply + SiLU + depthwise spatial conv, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sensorium_tpu/ops/pallas_fused.py
// fused_bn_silu_dw_spatial (stride 1: _fused_spatial_kernel; stride 2:
// _fused_spatial_s2_kernel on parity planes):
//
//   y = dwconv_{k x k, stride}(silu(x * scale + shift)),  torch "same" padding k/2,
//
// with the padding zero AFTER the prologue: silu(0 * scale + shift) != 0 in
// general, and no input fill value gives 0 when scale == 0.
//
// Layout is channels-last, as in the JAX package:
//   x (N = B*T, H, W, C) raw pre-BN activations, bf16 or fp32
//   scale, shift (C,) fp32: the BN affine folded, scale = gamma * rsqrt(var + eps),
//                 shift = beta - mean * scale (running or batch statistics alike)
//   w (k, k, C) in x's type  ->  y (N, OH, OW, C) in x's type,
//   OH = (H + 2*(k/2) - k) / stride + 1.
// The prologue runs in fp32 and is never rounded: the activation is not
// stored anywhere, so only the conv output is rounded, once, to x's type.
//
// What bounds it: bytes, as for dw_spatial_fwd. It reads x once and writes y
// once; the work per output element is k*k prologues (a multiply-add, an
// exponential and a division) and k*k multiply-adds, still below the card's
// ridge point. What the fusion saves against the eager chain is the fp32
// activation's write and re-read (and the cast), two of the chain's four
// passes over the tensor.
//
// The design is the simple one, with the prologue at the load: one block per
// output row (n, oh), threads striding over its OW*C elements, channel
// fastest, so every warp reads and writes contiguous bytes. A strided read
// is an address, so there are no parity planes; padding is a bounds
// predicate, and a tap outside the frame adds nothing, which is the
// zero-after-prologue rule (no masking pass, no padded copy). scale and
// shift are read once per element, outside the tap loop. The prologue is
// recomputed for every tap that reads an element (k*k times at stride 1)
// rather than applied once per element as it is staged. Left for the PR that
// makes it fast: dw_conv.cu's dw_spatial_fwd_kernel already stages the x
// rows of each band with their halo in a shared-memory ring and computes
// from 16-byte channel vectors; applying the prologue once per staged
// element (with out-of-frame elements kept at zero) would give this kernel
// the same design. Offsets that can exceed 2^31 are 64-bit.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// silu(v) = v * sigmoid(v) = v / (1 + exp(-v)); expf is the accurate one
// (no fast-math), so the result is within an ulp or two of the plain version.
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bn_silu_dw_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ shift, const T* __restrict__ w,
                        T* __restrict__ y, int h, int wd, int c, int oh, int ow, int k,
                        int stride) {
  const int64_t row = blockIdx.x;
  const int out_h = static_cast<int>(row % oh);
  const int64_t n = row / oh;
  const int pad = k / 2;
  const int row_len = ow * c;
  const T* xn = x + n * static_cast<int64_t>(h) * wd * c;
  T* yrow = y + row * static_cast<int64_t>(row_len);
  const int ih0 = out_h * stride - pad;
  for (int j = threadIdx.x; j < row_len; j += blockDim.x) {
    const int ch = j % c;
    const int iw0 = (j / c) * stride - pad;
    const float a = scale[ch];
    const float b = shift[ch];
    float acc = 0.0f;
    for (int di = 0; di < k; ++di) {
      const int ih = ih0 + di;
      if (ih < 0 || ih >= h) continue;
      const T* xrow = xn + static_cast<int64_t>(ih) * wd * c + ch;
      const T* wrow = w + di * k * c + ch;
      for (int dj = 0; dj < k; ++dj) {
        const int iw = iw0 + dj;
        if (iw < 0 || iw >= wd) continue;
        const float act = silu(fmaf(to_float(xrow[static_cast<int64_t>(iw) * c]), a, b));
        acc = fmaf(act, to_float(wrow[dj * c]), acc);
      }
    }
    yrow[j] = from_float<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* shift, const void* w, void* y,
           int64_t n, int64_t h, int64_t wd, int64_t c, int64_t k, int64_t stride,
           void* stream) {
  const int64_t pad = k / 2;
  const int64_t oh = (h + 2 * pad - k) / stride + 1;
  const int64_t ow = (wd + 2 * pad - k) / stride + 1;
  const int64_t rows = n * oh;
  if (rows > 0 && ow * c > 0) {
    fused_bn_silu_dw_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<const T*>(w), static_cast<T*>(y),
        static_cast<int>(h), static_cast<int>(wd), static_cast<int>(c), static_cast<int>(oh),
        static_cast<int>(ow), static_cast<int>(k), static_cast<int>(stride));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fused_bn_silu_dw_spatial_f32(const void* x, const void* scale, const void* shift,
                                 const void* w, void* y, int64_t n, int64_t h, int64_t wd,
                                 int64_t c, int64_t k, int64_t stride, void* stream) {
  return launch<float>(x, scale, shift, w, y, n, h, wd, c, k, stride, stream);
}

int fused_bn_silu_dw_spatial_bf16(const void* x, const void* scale, const void* shift,
                                  const void* w, void* y, int64_t n, int64_t h, int64_t wd,
                                  int64_t c, int64_t k, int64_t stride, void* stream) {
  return launch<__nv_bfloat16>(x, scale, shift, w, y, n, h, wd, c, k, stride, stream);
}

}  // extern "C"
