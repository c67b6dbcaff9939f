// Batch norm with its SiLU on Hopper (sm_90a): the training statistics, the
// apply (training and eval), and the backward's sums and input gradient.
//
// No TPU kernel is replaced: the JAX package leaves sensorium_tpu/ops/norm.py
// BatchNorm and the nn.silu after it (models/dwiseneuro.py BatchNormAct) to
// XLA, which fuses them. In PyTorch the same arithmetic was an eager fp32
// chain of casts, shifts, squares, sums and multiply-adds, then SiLU as a
// pass of its own: about 140 bytes moved per bf16 element through a training
// step and 28 through eval, where the layer needs about 16 and 4.
//
// Bound: device-memory bytes. The least traffic, which these kernels move:
//   training forward  read x twice (statistics, apply), write y once;
//   backward          read x and dy twice (sums, dx), write dx once;
//   eval              read x, write y.
// SiLU's exponential and division per element are the one cost that comes
// near it (see silu in bn_act.cuh, which dw_conv.cu shares for its eval BN
// prologue).
//
// Layout: x viewed as (rows, C), channels last and contiguous. A thread owns
// one 16-byte vector of channels (8 bf16 or 4 fp32) and keeps that vector's
// per-channel values in registers; a block owns a tile of `tv` neighbouring
// channel vectors (at most 32) and 256 / tv row lanes, so that a warp reads
// 512 contiguous bytes, and walks a slab of consecutive rows, kUnroll rows a
// lane at a time with their loads started together. The wrapper
// (ops/bn_kernels.py launch_geometry) picks tv and the slabs from (rows, C)
// so that one wave fills every SM: the core's BNs (3e4 to 2e6 rows, 64 to
// 1,792 channels) split over rows, the cortex's (512 rows, 1,024 to 4,096
// channels) over channel tiles. Where C is not a multiple of the vector width
// (or a pointer is not 16-byte aligned) the same kernels load and store
// element by element.
//
// Sums across rows (the statistics, the backward's two sums) are written as
// one fp32 partial per slab into a workspace (slabs, 2, C): each block adds
// its row lanes in a fixed order through shared memory. bn_finalize_kernel
// then adds the slabs in a fixed order (32 slab lanes a channel, then the
// lanes in turn) and derives the per-channel values. No atomics, so the same
// inputs give the same bits on every run.
//
// Numbers as the eager chain made them: statistics in fp32 with the shifted
// one-pass variance (shift c = the running mean), y = round(x*a + b) with
// a = inv_std*scale and b = bias - mean*a, then silu(y) computed in fp32 and
// rounded again (the bf16 SiLU of autograd's chain); the backward rounds
// g = dy*silu'(y) once as autograd's bf16 SiLU backward does, and dx once.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing (the caller passes the workspace and the outputs) and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry it
// refuses.

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bn_act.cuh"
#include "dw_vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileVecs = 32;
constexpr int kUnroll = 4;
constexpr int kFinalizeChannels = 32;
constexpr int kFinalizeLanes = 32;

// What bn_finalize_kernel writes from the added slabs (s1, s2) per channel.
enum FinalizeKind : int {
  kStats = 0,        // the statistics, from sums of (x - c) and (x - c)^2 over `count` rows
  kMoments = 1,      // [mean, E[(x - c)^2]], for an all-reduce over the data group
  kFromMoments = 2,  // the statistics, from one slab of reduced moments
  kSums = 3,         // the sums themselves (the backward's [sum g, sum g*xhat])
};

// The thread's place in its block: channel vector v of the tile, row lane
// `lane` of `lanes`, and the first channel of its vector.
struct Place {
  int v, lane, lanes, ch, valid;
  bool active;
};

template <int N>
__device__ __forceinline__ Place place(int c, int tv) {
  Place p;
  p.v = threadIdx.x % tv;
  p.lane = threadIdx.x / tv;
  p.lanes = blockDim.x / tv;
  p.ch = (blockIdx.y * tv + p.v) * N;
  p.valid = c - p.ch < N ? c - p.ch : N;
  p.active = p.ch < c;
  return p;
}

// Per-channel values of the thread's vector: src[ch .. ch + valid), zeros after.
template <int N>
__device__ __forceinline__ void load_channels(float (&dst)[N], const float* __restrict__ src, const Place& p) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = i < p.valid ? src[p.ch + i] : 0.0f;
}

// Adds the block's row lanes in a fixed order and writes the slab's two rows
// (blockIdx.x of the workspace (slabs, 2, C)) for the tile's channels.
template <int N>
__device__ __forceinline__ void write_slab(const float (&s1)[N], const float (&s2)[N], float* __restrict__ ws,
                                          int c, int tv, const Place& p) {
  __shared__ float red[kThreads * 2 * 8];  // [lane][2][tv * N]
  const int width = tv * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    red[(p.lane * 2) * width + p.v * N + i] = s1[i];
    red[(p.lane * 2 + 1) * width + p.v * N + i] = s2[i];
  }
  __syncthreads();
  const int c0 = blockIdx.y * width;
  for (int e = threadIdx.x; e < 2 * width; e += blockDim.x) {
    float acc = 0.0f;
    for (int l = 0; l < p.lanes; ++l) acc += red[l * 2 * width + e];
    const int which = e / width;
    const int chan = c0 + e - which * width;
    if (chan < c) ws[(static_cast<int64_t>(blockIdx.x) * 2 + which) * c + chan] = acc;
  }
}

// ------------------------------------------------------------ statistics

// Sums of (x - c) and (x - c)^2 over the block's slab of rows, per channel.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
    bn_stats_partial_kernel(const T* __restrict__ x, const float* __restrict__ shift, float* __restrict__ ws,
                            int64_t rows, int c, int tv, int64_t rows_per_slab) {
  constexpr int N = Vec16<T>::kN;
  const Place p = place<N>(c, tv);
  float sh[N], s1[N], s2[N];
  load_channels(sh, shift, p);
#pragma unroll
  for (int i = 0; i < N; ++i) s1[i] = s2[i] = 0.0f;
  const int64_t r0 = blockIdx.x * rows_per_slab;
  const int64_t r1 = r0 + rows_per_slab < rows ? r0 + rows_per_slab : rows;
  if (p.active) {
#pragma unroll 1
    for (int64_t r = r0 + p.lane; r < r1; r += kUnroll * p.lanes) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t rr = r + u * p.lanes;
        raw[u] = rr < r1 ? load_vec<T, VEC>(x + rr * c + p.ch, p.valid) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * p.lanes < r1) {
          float f[N];
          Vec16<T>::unpack(f, raw[u]);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float d = f[i] - sh[i];
            s1[i] += d;
            s2[i] = fmaf(d, d, s2[i]);
          }
        }
      }
    }
  }
  write_slab(s1, s2, ws, c, tv, p);
}

// Adds the slabs of ws (slabs, 2, C) per channel in a fixed order and writes
// what `kind` asks for. kStats and kFromMoments write out (5, C): mean,
// biased var, inv_std, a = inv_std*scale, b = bias - mean*a, and, where
// running_mean is given, move the running statistics with `momentum`, the
// variance unbiased by `unbiased` (n / (n - 1) of the global batch).
__global__ void __launch_bounds__(kFinalizeChannels * kFinalizeLanes)
    bn_finalize_kernel(const float* __restrict__ ws, int slabs, int c, int kind, float count,
                       const float* __restrict__ shift, const float* __restrict__ scale,
                       const float* __restrict__ bias, float eps, float momentum, float unbiased,
                       float* __restrict__ out, float* __restrict__ running_mean, float* __restrict__ running_var) {
  __shared__ float part[2][kFinalizeLanes][kFinalizeChannels + 1];
  const int cl = threadIdx.x % kFinalizeChannels;
  const int sl = threadIdx.x / kFinalizeChannels;
  const int ch = blockIdx.x * kFinalizeChannels + cl;
  float s1 = 0.0f, s2 = 0.0f;
  if (ch < c) {
#pragma unroll 4
    for (int s = sl; s < slabs; s += kFinalizeLanes) {
      s1 += ws[(static_cast<int64_t>(s) * 2) * c + ch];
      s2 += ws[(static_cast<int64_t>(s) * 2 + 1) * c + ch];
    }
  }
  part[0][sl][cl] = s1;
  part[1][sl][cl] = s2;
  __syncthreads();
  if (sl != 0 || ch >= c) return;
  s1 = s2 = 0.0f;
  for (int l = 0; l < kFinalizeLanes; ++l) {
    s1 += part[0][l][cl];
    s2 += part[1][l][cl];
  }
  if (kind == kSums) {
    out[ch] = s1;
    out[c + ch] = s2;
    return;
  }
  const float sh = shift[ch];
  float mean = s1, csq = s2;
  if (kind != kFromMoments) {
    mean = sh + s1 / count;
    csq = s2 / count;
  }
  if (kind == kMoments) {
    out[ch] = mean;
    out[c + ch] = csq;
    return;
  }
  const float d = mean - sh;
  const float var = csq - d * d;
  const float inv_std = rsqrtf(var + eps);
  const float a = inv_std * scale[ch];
  out[ch] = mean;
  out[c + ch] = var;
  out[2 * c + ch] = inv_std;
  out[3 * c + ch] = a;
  out[4 * c + ch] = bias[ch] - mean * a;
  if (running_mean != nullptr) {
    running_mean[ch] = (1.0f - momentum) * running_mean[ch] + momentum * mean;
    running_var[ch] = (1.0f - momentum) * running_var[ch] + momentum * (var * unbiased);
  }
}

// ----------------------------------------------------------------- apply

// y = round(x*a + b), then round(silu(y)) with ACT. Training: p0 = a, p1 = b
// (rows 3 and 4 of the statistics). EVAL: p0..p3 = the running mean and var,
// scale and bias, from which each thread derives its a and b.
template <typename T, bool VEC, bool ACT, bool EVAL>
__global__ void __launch_bounds__(kThreads, 4)
    bn_act_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ p0,
                        const float* __restrict__ p1, const float* __restrict__ p2, const float* __restrict__ p3,
                        float eps, int64_t rows, int c, int tv, int64_t rows_per_slab) {
  constexpr int N = Vec16<T>::kN;
  const Place p = place<N>(c, tv);
  if (!p.active) return;
  float a[N], b[N];
  if constexpr (EVAL) {
    eval_channels(a, b, EvalBn{p0, p1, p2, p3, eps}, p.ch, p.valid);
  } else {
    load_channels(a, p0, p);
    load_channels(b, p1, p);
  }
  const int64_t r0 = blockIdx.x * rows_per_slab;
  const int64_t r1 = r0 + rows_per_slab < rows ? r0 + rows_per_slab : rows;
#pragma unroll 1
  for (int64_t r = r0 + p.lane; r < r1; r += kUnroll * p.lanes) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t rr = r + u * p.lanes;
      raw[u] = rr < r1 ? load_vec<T, VEC>(x + rr * c + p.ch, p.valid) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t rr = r + u * p.lanes;
      if (rr < r1) {
        float f[N];
        Vec16<T>::unpack(f, raw[u]);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          if constexpr (ACT) {
            f[i] = bn_silu<T>(f[i], a[i], b[i]);
          } else {
            f[i] = fmaf(f[i], a[i], b[i]);
          }
        }
        store_vec<T, VEC>(y + rr * c + p.ch, f, p.valid);
      }
    }
  }
}

// -------------------------------------------------------------- backward

// The per-element gradient of the BN output: g = round(dy * silu'(z)) with
// z = round(x*a + b) under ACT, else dy; and xhat = (x - mean) * inv_std.
template <typename T, bool ACT>
__device__ __forceinline__ void grad_terms(float xf, float dyf, float a, float b, float mean, float inv_std,
                                           float& g, float& xhat) {
  g = dyf;
  if constexpr (ACT) g = round_to<T>(silu_grad<T>(dyf, round_to<T>(fmaf(xf, a, b))));
  xhat = (xf - mean) * inv_std;
}

// Sums of g and g*xhat over the block's slab of rows, per channel. stats is
// (5, C): mean, var, inv_std, a, b.
template <typename T, bool VEC, bool ACT>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_grad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ stats,
                               float* __restrict__ ws, int64_t rows, int c, int tv, int64_t rows_per_slab) {
  constexpr int N = Vec16<T>::kN;
  const Place p = place<N>(c, tv);
  float mean[N], inv_std[N], a[N], b[N], sg[N], sgx[N];
  load_channels(mean, stats, p);
  load_channels(inv_std, stats + 2 * c, p);
  load_channels(a, stats + 3 * c, p);  // read only under ACT
  load_channels(b, stats + 4 * c, p);
#pragma unroll
  for (int i = 0; i < N; ++i) sg[i] = sgx[i] = 0.0f;
  const int64_t r0 = blockIdx.x * rows_per_slab;
  const int64_t r1 = r0 + rows_per_slab < rows ? r0 + rows_per_slab : rows;
  if (p.active) {
#pragma unroll 1
    for (int64_t r = r0 + p.lane; r < r1; r += kUnroll * p.lanes) {
      uint4 raw_x[kUnroll], raw_dy[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t rr = r + u * p.lanes;
        const bool inside = rr < r1;
        raw_x[u] = inside ? load_vec<T, VEC>(x + rr * c + p.ch, p.valid) : make_uint4(0u, 0u, 0u, 0u);
        raw_dy[u] = inside ? load_vec<T, VEC>(dy + rr * c + p.ch, p.valid) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * p.lanes < r1) {
          float fx[N], fdy[N];
          Vec16<T>::unpack(fx, raw_x[u]);
          Vec16<T>::unpack(fdy, raw_dy[u]);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            float g, xhat;
            grad_terms<T, ACT>(fx[i], fdy[i], a[i], b[i], mean[i], inv_std[i], g, xhat);
            sg[i] += g;
            sgx[i] = fmaf(g, xhat, sgx[i]);
          }
        }
      }
    }
  }
  write_slab(sg, sgx, ws, c, tv, p);
}

// dx = round(((g - sum_g / n) - xhat * (sum_gxhat / n)) * inv_std * scale),
// sums (2, C) the batch's [sum g, sum g*xhat] (over the data group under a mesh).
template <typename T, bool VEC, bool ACT>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ stats,
                     const float* __restrict__ sums, const float* __restrict__ scale, T* __restrict__ dx,
                     float count, int64_t rows, int c, int tv, int64_t rows_per_slab) {
  constexpr int N = Vec16<T>::kN;
  const Place p = place<N>(c, tv);
  if (!p.active) return;
  float mean[N], inv_std[N], a[N], b[N], mg[N], mgx[N], k[N];
  load_channels(mean, stats, p);
  load_channels(inv_std, stats + 2 * c, p);
  load_channels(a, stats + 3 * c, p);  // read only under ACT
  load_channels(b, stats + 4 * c, p);
  load_channels(mg, sums, p);
  load_channels(mgx, sums + c, p);
  load_channels(k, scale, p);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mg[i] = mg[i] / count;
    mgx[i] = mgx[i] / count;
    k[i] = inv_std[i] * k[i];
  }
  const int64_t r0 = blockIdx.x * rows_per_slab;
  const int64_t r1 = r0 + rows_per_slab < rows ? r0 + rows_per_slab : rows;
#pragma unroll 1
  for (int64_t r = r0 + p.lane; r < r1; r += kUnroll * p.lanes) {
    uint4 raw_x[kUnroll], raw_dy[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t rr = r + u * p.lanes;
      const bool inside = rr < r1;
      raw_x[u] = inside ? load_vec<T, VEC>(x + rr * c + p.ch, p.valid) : make_uint4(0u, 0u, 0u, 0u);
      raw_dy[u] = inside ? load_vec<T, VEC>(dy + rr * c + p.ch, p.valid) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t rr = r + u * p.lanes;
      if (rr < r1) {
        float fx[N], fdy[N];
        Vec16<T>::unpack(fx, raw_x[u]);
        Vec16<T>::unpack(fdy, raw_dy[u]);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float g, xhat;
          grad_terms<T, ACT>(fx[i], fdy[i], a[i], b[i], mean[i], inv_std[i], g, xhat);
          fx[i] = ((g - mg[i]) - xhat * mgx[i]) * k[i];
        }
        store_vec<T, VEC>(dx + rr * c + p.ch, fx, p.valid);
      }
    }
  }
}

// ---------------------------------------------------------------- launchers

struct Geometry {
  dim3 grid;
  dim3 block;
  bool ok;
};

// The grid of the row kernels for `slabs` slabs of `rows_per_slab` rows and
// channel tiles of `tv` vectors; refuses a geometry that does not cover the
// rows exactly once or exceeds CUDA's limits.
template <typename T>
Geometry row_geometry(int64_t rows, int64_t c, int64_t tv, int64_t rows_per_slab, int64_t slabs) {
  constexpr int N = Vec16<T>::kN;
  Geometry g{dim3(1), dim3(1), false};
  if (rows < 1 || c < 1 || c > INT32_MAX || tv < 1 || tv > kMaxTileVecs || rows_per_slab < 1) return g;
  const int64_t vectors = (c + N - 1) / N;
  const int64_t tiles = (vectors + tv - 1) / tv;
  const int64_t lanes = kThreads / tv;
  if (slabs != (rows + rows_per_slab - 1) / rows_per_slab || slabs > INT32_MAX || tiles > 65535) return g;
  g.grid = dim3(static_cast<unsigned>(slabs), static_cast<unsigned>(tiles));
  g.block = dim3(static_cast<unsigned>(tv * lanes));
  g.ok = true;
  return g;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
bool vectorized(int64_t c, std::initializer_list<const void*> pointers) {
  if (c % Vec16<T>::kN != 0) return false;
  for (const void* q : pointers) {
    if (!aligned16(q)) return false;
  }
  return true;
}

template <typename T>
int launch_stats_partial(const void* x, const void* shift, void* ws, int64_t rows, int64_t c, int64_t tv,
                         int64_t rows_per_slab, int64_t slabs, void* stream) {
  const Geometry g = row_geometry<T>(rows, c, tv, rows_per_slab, slabs);
  if (!g.ok) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(shift);
  float* wp = static_cast<float*>(ws);
  const int ci = static_cast<int>(c), ti = static_cast<int>(tv);
  if (vectorized<T>(c, {x})) {
    bn_stats_partial_kernel<T, true><<<g.grid, g.block, 0, s>>>(xp, sp, wp, rows, ci, ti, rows_per_slab);
  } else {
    bn_stats_partial_kernel<T, false><<<g.grid, g.block, 0, s>>>(xp, sp, wp, rows, ci, ti, rows_per_slab);
  }
  return cudaGetLastError();
}

template <typename T, bool VEC, bool ACT>
void apply_act(dim3 grid, dim3 block, cudaStream_t s, bool eval, const T* x, T* y, const float* p0,
               const float* p1, const float* p2, const float* p3, float eps, int64_t rows, int c, int tv,
               int64_t rows_per_slab) {
  if (eval) {
    bn_act_apply_kernel<T, VEC, ACT, true><<<grid, block, 0, s>>>(x, y, p0, p1, p2, p3, eps, rows, c, tv,
                                                                  rows_per_slab);
  } else {
    bn_act_apply_kernel<T, VEC, ACT, false><<<grid, block, 0, s>>>(x, y, p0, p1, p2, p3, eps, rows, c, tv,
                                                                   rows_per_slab);
  }
}

template <typename T>
int launch_apply(const void* x, void* y, const void* p0, const void* p1, const void* p2, const void* p3,
                 double eps, int64_t rows, int64_t c, int64_t tv, int64_t rows_per_slab, int64_t slabs, int64_t act,
                 int64_t eval, void* stream) {
  const Geometry g = row_geometry<T>(rows, c, tv, rows_per_slab, slabs);
  if (!g.ok) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const float *q0 = static_cast<const float*>(p0), *q1 = static_cast<const float*>(p1);
  const float *q2 = static_cast<const float*>(p2), *q3 = static_cast<const float*>(p3);
  const float e = static_cast<float>(eps);
  const int ci = static_cast<int>(c), ti = static_cast<int>(tv);
  const bool vec = vectorized<T>(c, {x, y});
  if (vec && act) {
    apply_act<T, true, true>(g.grid, g.block, s, eval, xp, yp, q0, q1, q2, q3, e, rows, ci, ti, rows_per_slab);
  } else if (vec) {
    apply_act<T, true, false>(g.grid, g.block, s, eval, xp, yp, q0, q1, q2, q3, e, rows, ci, ti, rows_per_slab);
  } else if (act) {
    apply_act<T, false, true>(g.grid, g.block, s, eval, xp, yp, q0, q1, q2, q3, e, rows, ci, ti, rows_per_slab);
  } else {
    apply_act<T, false, false>(g.grid, g.block, s, eval, xp, yp, q0, q1, q2, q3, e, rows, ci, ti, rows_per_slab);
  }
  return cudaGetLastError();
}

template <typename T, bool VEC>
void grad_partial(dim3 grid, dim3 block, cudaStream_t s, bool act, const T* x, const T* dy, const float* stats,
                  float* ws, int64_t rows, int c, int tv, int64_t rows_per_slab) {
  if (act) {
    bn_act_grad_partial_kernel<T, VEC, true><<<grid, block, 0, s>>>(x, dy, stats, ws, rows, c, tv, rows_per_slab);
  } else {
    bn_act_grad_partial_kernel<T, VEC, false><<<grid, block, 0, s>>>(x, dy, stats, ws, rows, c, tv, rows_per_slab);
  }
}

template <typename T>
int launch_grad_partial(const void* x, const void* dy, const void* stats, void* ws, int64_t rows, int64_t c,
                        int64_t tv, int64_t rows_per_slab, int64_t slabs, int64_t act, void* stream) {
  const Geometry g = row_geometry<T>(rows, c, tv, rows_per_slab, slabs);
  if (!g.ok) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const T *xp = static_cast<const T*>(x), *dp = static_cast<const T*>(dy);
  const float* st = static_cast<const float*>(stats);
  float* wp = static_cast<float*>(ws);
  const int ci = static_cast<int>(c), ti = static_cast<int>(tv);
  if (vectorized<T>(c, {x, dy})) {
    grad_partial<T, true>(g.grid, g.block, s, act, xp, dp, st, wp, rows, ci, ti, rows_per_slab);
  } else {
    grad_partial<T, false>(g.grid, g.block, s, act, xp, dp, st, wp, rows, ci, ti, rows_per_slab);
  }
  return cudaGetLastError();
}

template <typename T, bool VEC>
void dx_act(dim3 grid, dim3 block, cudaStream_t s, bool act, const T* x, const T* dy, const float* stats,
            const float* sums, const float* scale, T* dx, float count, int64_t rows, int c, int tv,
            int64_t rows_per_slab) {
  if (act) {
    bn_act_dx_kernel<T, VEC, true><<<grid, block, 0, s>>>(x, dy, stats, sums, scale, dx, count, rows, c, tv,
                                                          rows_per_slab);
  } else {
    bn_act_dx_kernel<T, VEC, false><<<grid, block, 0, s>>>(x, dy, stats, sums, scale, dx, count, rows, c, tv,
                                                           rows_per_slab);
  }
}

template <typename T>
int launch_dx(const void* x, const void* dy, const void* stats, const void* sums, const void* scale, void* dx,
              double count, int64_t rows, int64_t c, int64_t tv, int64_t rows_per_slab, int64_t slabs, int64_t act,
              void* stream) {
  const Geometry g = row_geometry<T>(rows, c, tv, rows_per_slab, slabs);
  if (!g.ok || !(count > 0.0)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const T *xp = static_cast<const T*>(x), *dp = static_cast<const T*>(dy);
  const float *st = static_cast<const float*>(stats), *sm = static_cast<const float*>(sums);
  const float* sc = static_cast<const float*>(scale);
  T* out = static_cast<T*>(dx);
  const float n = static_cast<float>(count);
  const int ci = static_cast<int>(c), ti = static_cast<int>(tv);
  if (vectorized<T>(c, {x, dy, dx})) {
    dx_act<T, true>(g.grid, g.block, s, act, xp, dp, st, sm, sc, out, n, rows, ci, ti, rows_per_slab);
  } else {
    dx_act<T, false>(g.grid, g.block, s, act, xp, dp, st, sm, sc, out, n, rows, ci, ti, rows_per_slab);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bn_stats_partial_f32(const void* x, const void* shift, void* ws, int64_t rows, int64_t c, int64_t tv,
                         int64_t rows_per_slab, int64_t slabs, void* stream) {
  return launch_stats_partial<float>(x, shift, ws, rows, c, tv, rows_per_slab, slabs, stream);
}

int bn_stats_partial_bf16(const void* x, const void* shift, void* ws, int64_t rows, int64_t c, int64_t tv,
                          int64_t rows_per_slab, int64_t slabs, void* stream) {
  return launch_stats_partial<__nv_bfloat16>(x, shift, ws, rows, c, tv, rows_per_slab, slabs, stream);
}

// One launch for every kind: ws (slabs, 2, C) fp32 in, out (2, C) for kMoments
// and kSums, (5, C) for kStats and kFromMoments; running_mean and running_var
// null (no running update) or both given.
int bn_finalize(const void* ws, int64_t slabs, int64_t c, int64_t kind, double count, const void* shift,
                const void* scale, const void* bias, double eps, double momentum, double unbiased, void* out,
                void* running_mean, void* running_var, void* stream) {
  if (slabs < 1 || slabs > INT32_MAX || c < 1 || c > INT32_MAX || kind < kStats || kind > kSums ||
      (running_mean == nullptr) != (running_var == nullptr) || !(count > 0.0)) {
    return cudaErrorInvalidValue;
  }
  const unsigned blocks = static_cast<unsigned>((c + kFinalizeChannels - 1) / kFinalizeChannels);
  bn_finalize_kernel<<<blocks, kFinalizeChannels * kFinalizeLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<int>(slabs), static_cast<int>(c), static_cast<int>(kind),
      static_cast<float>(count), static_cast<const float*>(shift), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float>(eps), static_cast<float>(momentum),
      static_cast<float>(unbiased), static_cast<float*>(out), static_cast<float*>(running_mean),
      static_cast<float*>(running_var));
  return cudaGetLastError();
}

int bn_act_apply_f32(const void* x, void* y, const void* p0, const void* p1, const void* p2, const void* p3,
                     double eps, int64_t rows, int64_t c, int64_t tv, int64_t rows_per_slab, int64_t slabs,
                     int64_t act, int64_t eval, void* stream) {
  return launch_apply<float>(x, y, p0, p1, p2, p3, eps, rows, c, tv, rows_per_slab, slabs, act, eval, stream);
}

int bn_act_apply_bf16(const void* x, void* y, const void* p0, const void* p1, const void* p2, const void* p3,
                      double eps, int64_t rows, int64_t c, int64_t tv, int64_t rows_per_slab, int64_t slabs,
                      int64_t act, int64_t eval, void* stream) {
  return launch_apply<__nv_bfloat16>(x, y, p0, p1, p2, p3, eps, rows, c, tv, rows_per_slab, slabs, act, eval,
                                     stream);
}

int bn_act_grad_partial_f32(const void* x, const void* dy, const void* stats, void* ws, int64_t rows, int64_t c,
                            int64_t tv, int64_t rows_per_slab, int64_t slabs, int64_t act, void* stream) {
  return launch_grad_partial<float>(x, dy, stats, ws, rows, c, tv, rows_per_slab, slabs, act, stream);
}

int bn_act_grad_partial_bf16(const void* x, const void* dy, const void* stats, void* ws, int64_t rows, int64_t c,
                             int64_t tv, int64_t rows_per_slab, int64_t slabs, int64_t act, void* stream) {
  return launch_grad_partial<__nv_bfloat16>(x, dy, stats, ws, rows, c, tv, rows_per_slab, slabs, act, stream);
}

int bn_act_dx_f32(const void* x, const void* dy, const void* stats, const void* sums, const void* scale, void* dx,
                  double count, int64_t rows, int64_t c, int64_t tv, int64_t rows_per_slab, int64_t slabs,
                  int64_t act, void* stream) {
  return launch_dx<float>(x, dy, stats, sums, scale, dx, count, rows, c, tv, rows_per_slab, slabs, act, stream);
}

int bn_act_dx_bf16(const void* x, const void* dy, const void* stats, const void* sums, const void* scale, void* dx,
                   double count, int64_t rows, int64_t c, int64_t tv, int64_t rows_per_slab, int64_t slabs,
                   int64_t act, void* stream) {
  return launch_dx<__nv_bfloat16>(x, dy, stats, sums, scale, dx, count, rows, c, tv, rows_per_slab, slabs, act,
                                  stream);
}

}  // extern "C"
