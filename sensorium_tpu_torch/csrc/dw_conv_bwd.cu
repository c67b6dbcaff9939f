// Depthwise convolutions of the DwiseNeuro core, backward, for Hopper (sm_90a).
//
// Layout is channels-last, as in dw_conv.cu and the JAX package:
//   spatial:  x (N = B*T, H, W, C), w (k, k, C), dy (N, OH, OW, C),
//             OH = (H + 2*(k/2) - k) / stride + 1, padding k/2
//   temporal: x and dy (B, T, HW, C), w (k, C), padding k/2, odd k
//
// dw_spatial_dx replaces _dw_spatial_valid of sensorium_tpu/ops/pallas_dw.py,
// as _dw_spatial_vjp_bwd calls it: a stride-1 VALID conv of the cotangent,
// dilated by the stride and edge-padded, with the taps flipped. Here the
// transposed conv is computed directly and nothing is materialised:
//   dx[n,h,w,c] = sum_{di,dj} w[di,dj,c] * dy[n, (h+p-di)/s, (w+p-dj)/s, c]
// over the taps where h+p-di and w+p-dj are >= 0, divisible by s and in range.
// At stride 2 the parity of h and w picks the taps; rows and columns that the
// strided forward never read get no tap and so 0, which is what the JAX right
// pad is there for. Bound: bytes. It reads dy and writes dx once, the same
// bytes as the forward (block 0 at batch 32: 2.35 GB in bf16, >= 0.70 ms at
// 3.35 TB/s), with k*k (stride 1) or ~k*k/4 (stride 2) multiply-adds per
// output. Design: the forward's, one block per dx row, neighbouring threads
// on neighbouring channels, fp32 accumulation rounded once to x's type,
// 64-bit offsets (block 0's dx holds 9.4e8 elements).
//
// dw_spatial_dw replaces _dw_spatial_grad_w (_dw_spatial_dw_kernel and, at
// stride 2, _dw_spatial_dw_s2_kernel on parity planes):
//   dw[di,dj,c] = sum over n, oh, ow of x_pad[n, s*oh+di, s*ow+dj, c] * dy[n,oh,ow,c]
// dw_temporal_dw replaces _dw_temporal_grad_w (_dw_temporal_dw_kernel):
//   dw[dt,c] = sum over b, t, hw of x_pad[b, t+dt, hw, c] * dy[b,t,hw,c]
// Both are sums of up to ~5e5 products per output across the whole tensor.
// The TPU grid carries the sum from step to step in VMEM; Hopper's blocks run
// in parallel and cannot. So each is two deterministic passes: (1) a block
// reduces one slab of output positions for a tile of 32 channels into a fp32
// workspace (slabs, taps, C): each thread keeps its taps' sums in registers,
// then the block adds its 8 position lanes in a fixed order; (2) a second
// kernel adds the slabs in a fixed order. No atomics, so the result is the
// same from run to run. Bound: bytes, x and dy read once (block 0 spatial:
// 2.35 GB in bf16, >= 0.70 ms). The wrapper picks the slab count so that
// every SM has several blocks. Left for later: shared-memory tiles of x, so
// that the k*k overlapping taps come from shared memory, and 16-byte loads.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing (the caller passes dx, the workspace and dw) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a kernel size it was not
// compiled for (spatial and temporal k = 3 or 5).

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

constexpr int kThreads = 256;
constexpr int kLanes = 32;  // channels per reduction block (threadIdx.x)
constexpr int kRows = 8;    // position lanes per reduction block (threadIdx.y)

// One block per dx row (n, h); its threads stride over the W*C elements of
// the row, channel fastest.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_spatial_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w, T* __restrict__ dx,
                     int h, int wd, int c, int oh, int ow, int k, int stride) {
  const int64_t row = blockIdx.x;
  const int in_h = static_cast<int>(row % h);
  const int64_t n = row / h;
  const int pad = k / 2;
  const int row_len = wd * c;
  const T* dyn = dy + n * static_cast<int64_t>(oh) * ow * c;
  T* dxrow = dx + row * static_cast<int64_t>(row_len);
  for (int j = threadIdx.x; j < row_len; j += blockDim.x) {
    const int ch = j % c;
    const int in_w = j / c;
    float acc = 0.0f;
    for (int di = 0; di < k; ++di) {
      const int num_h = in_h + pad - di;
      if (num_h < 0 || num_h % stride != 0) continue;
      const int out_h = num_h / stride;
      if (out_h >= oh) continue;
      const T* dyrow = dyn + static_cast<int64_t>(out_h) * ow * c + ch;
      const T* wrow = w + di * k * c + ch;
      for (int dj = 0; dj < k; ++dj) {
        const int num_w = in_w + pad - dj;
        if (num_w < 0 || num_w % stride != 0) continue;
        const int out_w = num_w / stride;
        if (out_w >= ow) continue;
        acc = fmaf(to_float(dyrow[static_cast<int64_t>(out_w) * c]), to_float(wrow[dj * c]), acc);
      }
    }
    dxrow[j] = from_float<T>(acc);
  }
}

// Adds the block's kRows position lanes in a fixed order and writes the
// block's (taps, 32-channel tile) partial sums into workspace slab blockIdx.y.
template <int kTaps>
__device__ __forceinline__ void write_partials(const float (&acc)[kTaps], float* __restrict__ ws, int c) {
  __shared__ float part[kRows][kTaps][kLanes];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) part[threadIdx.y][t][threadIdx.x] = acc[t];
  __syncthreads();
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int e = tid; e < kTaps * kLanes; e += kLanes * kRows) {
    const int t = e / kLanes;
    const int lane = e % kLanes;
    const int ch = blockIdx.x * kLanes + lane;
    if (ch >= c) continue;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += part[r][t][lane];
    ws[(static_cast<int64_t>(blockIdx.y) * kTaps + t) * c + ch] = s;
  }
}

// Pass 1 of dw_spatial_dw. Positions p = (n*OH + oh)*OW + ow; slab
// blockIdx.y holds positions [y*per_slab, (y+1)*per_slab).
template <typename T, int K>
__global__ void __launch_bounds__(kLanes * kRows)
dw_spatial_dw_partial(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ ws,
                      int h, int wd, int c, int oh, int ow, int stride, int positions, int per_slab) {
  constexpr int kTaps = K * K;
  constexpr int pad = K / 2;
  const int ch = blockIdx.x * kLanes + threadIdx.x;
  const int p0 = blockIdx.y * per_slab;
  const int p1 = min(p0 + per_slab, positions);
  float acc[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc[t] = 0.0f;
  if (ch < c) {
    for (int p = p0 + threadIdx.y; p < p1; p += kRows) {
      const int out_w = p % ow;
      const int q = p / ow;
      const int out_h = q % oh;
      const int64_t n = q / oh;
      const float g = to_float(dy[static_cast<int64_t>(p) * c + ch]);
      const T* xn = x + n * static_cast<int64_t>(h) * wd * c + ch;
      const int ih0 = out_h * stride - pad;
      const int iw0 = out_w * stride - pad;
#pragma unroll
      for (int di = 0; di < K; ++di) {
        const int ih = ih0 + di;
        if (ih < 0 || ih >= h) continue;
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
          const int iw = iw0 + dj;
          if (iw < 0 || iw >= wd) continue;
          acc[di * K + dj] =
              fmaf(to_float(xn[(static_cast<int64_t>(ih) * wd + iw) * c]), g, acc[di * K + dj]);
        }
      }
    }
  }
  write_partials<kTaps>(acc, ws, c);
}

// Pass 1 of dw_temporal_dw. Positions p = (b*T + t)*HW + hw.
template <typename T, int K>
__global__ void __launch_bounds__(kLanes * kRows)
dw_temporal_dw_partial(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ ws,
                       int t_len, int hw, int c, int positions, int per_slab) {
  constexpr int pad = K / 2;
  const int ch = blockIdx.x * kLanes + threadIdx.x;
  const int p0 = blockIdx.y * per_slab;
  const int p1 = min(p0 + per_slab, positions);
  float acc[K];
#pragma unroll
  for (int t = 0; t < K; ++t) acc[t] = 0.0f;
  if (ch < c) {
    for (int p = p0 + threadIdx.y; p < p1; p += kRows) {
      const int t = (p / hw) % t_len;
      const float g = to_float(dy[static_cast<int64_t>(p) * c + ch]);
#pragma unroll
      for (int dt = 0; dt < K; ++dt) {
        const int ti = t + dt - pad;
        if (ti < 0 || ti >= t_len) continue;
        const int64_t src = (static_cast<int64_t>(p) + static_cast<int64_t>(dt - pad) * hw) * c + ch;
        acc[dt] = fmaf(to_float(x[src]), g, acc[dt]);
      }
    }
  }
  write_partials<K>(acc, ws, c);
}

// Pass 2: out[i] = sum over slabs of ws[slab, i], slab 0 first.
__global__ void __launch_bounds__(kThreads)
sum_slabs(const float* __restrict__ ws, float* __restrict__ out, int slabs, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.0f;
  for (int sl = 0; sl < slabs; ++sl) s += ws[static_cast<int64_t>(sl) * len + i];
  out[i] = s;
}

int finish_reduction(const float* ws, float* out, int slabs, int len, cudaStream_t stream) {
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  sum_slabs<<<(len + kThreads - 1) / kThreads, kThreads, 0, stream>>>(ws, out, slabs, len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spatial_dx(const void* dy, const void* w, void* dx, int64_t n, int64_t h, int64_t wd,
                      int64_t c, int64_t k, int64_t stride, void* stream) {
  const int64_t pad = k / 2;
  const int64_t oh = (h + 2 * pad - k) / stride + 1;
  const int64_t ow = (wd + 2 * pad - k) / stride + 1;
  const int64_t rows = n * h;
  if (rows > 0 && wd * c > 0) {
    dw_spatial_dx_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<T*>(dx),
        static_cast<int>(h), static_cast<int>(wd), static_cast<int>(c), static_cast<int>(oh),
        static_cast<int>(ow), static_cast<int>(k), static_cast<int>(stride));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spatial_dw(const void* x, const void* dy, void* ws, void* out, int64_t n, int64_t h,
                      int64_t wd, int64_t c, int64_t k, int64_t stride, int64_t slabs, void* stream) {
  const int64_t pad = k / 2;
  const int64_t oh = (h + 2 * pad - k) / stride + 1;
  const int64_t ow = (wd + 2 * pad - k) / stride + 1;
  const int64_t positions = n * oh * ow;
  const int64_t per_slab = (positions + slabs - 1) / slabs;
  const dim3 grid(static_cast<unsigned int>((c + kLanes - 1) / kLanes), static_cast<unsigned int>(slabs));
  const dim3 block(kLanes, kRows);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* dyp = static_cast<const T*>(dy);
  auto* wsp = static_cast<float*>(ws);
  const int args[] = {static_cast<int>(h), static_cast<int>(wd), static_cast<int>(c), static_cast<int>(oh),
                      static_cast<int>(ow), static_cast<int>(stride), static_cast<int>(positions),
                      static_cast<int>(per_slab)};
  if (k == 3) {
    dw_spatial_dw_partial<T, 3><<<grid, block, 0, s>>>(xp, dyp, wsp, args[0], args[1], args[2], args[3],
                                                         args[4], args[5], args[6], args[7]);
  } else if (k == 5) {
    dw_spatial_dw_partial<T, 5><<<grid, block, 0, s>>>(xp, dyp, wsp, args[0], args[1], args[2], args[3],
                                                         args[4], args[5], args[6], args[7]);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return finish_reduction(wsp, static_cast<float*>(out), static_cast<int>(slabs), static_cast<int>(k * k * c), s);
}

template <typename T>
int launch_temporal_dw(const void* x, const void* dy, void* ws, void* out, int64_t batch, int64_t t_len,
                       int64_t hw, int64_t c, int64_t k, int64_t slabs, void* stream) {
  const int64_t positions = batch * t_len * hw;
  const int64_t per_slab = (positions + slabs - 1) / slabs;
  const dim3 grid(static_cast<unsigned int>((c + kLanes - 1) / kLanes), static_cast<unsigned int>(slabs));
  const dim3 block(kLanes, kRows);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* dyp = static_cast<const T*>(dy);
  auto* wsp = static_cast<float*>(ws);
  if (k == 3) {
    dw_temporal_dw_partial<T, 3><<<grid, block, 0, s>>>(xp, dyp, wsp, static_cast<int>(t_len),
                                                          static_cast<int>(hw), static_cast<int>(c),
                                                          static_cast<int>(positions), static_cast<int>(per_slab));
  } else if (k == 5) {
    dw_temporal_dw_partial<T, 5><<<grid, block, 0, s>>>(xp, dyp, wsp, static_cast<int>(t_len),
                                                          static_cast<int>(hw), static_cast<int>(c),
                                                          static_cast<int>(positions), static_cast<int>(per_slab));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return finish_reduction(wsp, static_cast<float*>(out), static_cast<int>(slabs), static_cast<int>(k * c), s);
}

}  // namespace

extern "C" {

int dw_spatial_dx_f32(const void* dy, const void* w, void* dx, int64_t n, int64_t h, int64_t wd, int64_t c,
                      int64_t k, int64_t stride, void* stream) {
  return launch_spatial_dx<float>(dy, w, dx, n, h, wd, c, k, stride, stream);
}

int dw_spatial_dx_bf16(const void* dy, const void* w, void* dx, int64_t n, int64_t h, int64_t wd, int64_t c,
                       int64_t k, int64_t stride, void* stream) {
  return launch_spatial_dx<__nv_bfloat16>(dy, w, dx, n, h, wd, c, k, stride, stream);
}

int dw_spatial_dw_f32(const void* x, const void* dy, void* ws, void* out, int64_t n, int64_t h, int64_t wd,
                      int64_t c, int64_t k, int64_t stride, int64_t slabs, void* stream) {
  return launch_spatial_dw<float>(x, dy, ws, out, n, h, wd, c, k, stride, slabs, stream);
}

int dw_spatial_dw_bf16(const void* x, const void* dy, void* ws, void* out, int64_t n, int64_t h, int64_t wd,
                       int64_t c, int64_t k, int64_t stride, int64_t slabs, void* stream) {
  return launch_spatial_dw<__nv_bfloat16>(x, dy, ws, out, n, h, wd, c, k, stride, slabs, stream);
}

int dw_temporal_dw_f32(const void* x, const void* dy, void* ws, void* out, int64_t batch, int64_t t_len,
                       int64_t hw, int64_t c, int64_t k, int64_t slabs, void* stream) {
  return launch_temporal_dw<float>(x, dy, ws, out, batch, t_len, hw, c, k, slabs, stream);
}

int dw_temporal_dw_bf16(const void* x, const void* dy, void* ws, void* out, int64_t batch, int64_t t_len,
                        int64_t hw, int64_t c, int64_t k, int64_t slabs, void* stream) {
  return launch_temporal_dw<__nv_bfloat16>(x, dy, ws, out, batch, t_len, hw, c, k, slabs, stream);
}

}  // extern "C"
