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
// over the taps where h+p-di and w+p-dj are >= 0, divisible by s and in range;
// p = k/2. Bound: bytes. It reads dy and writes dx once (block 0 of a batch of
// 32 x 16 frames: 2.35 GB in bf16, >= 0.70 ms at 3.35 TB/s; the 9 blocks of a
// step >= 2.42 ms), with k*k multiply-adds per output at stride 1 and k*k per
// 2x2 outputs at stride 2.
// Design (dw_spatial_dx_kernel):
//  - k and the stride are template parameters (k in {3, 5}, stride in {1, 2}),
//    so every tap loop unrolls and no division is left in it. A "step" is one
//    dx row (column) at stride 1 and two at stride 2: at stride 2 a thread
//    computes the 2x2 micro-tile of dx rows 2a..2a+1 and columns 2b..2b+1, and
//    the parity of each output picks its taps at compile time, so each
//    micro-tile does exactly k*k multiply-adds per channel and skips nothing.
//    A step reads the dy rows a-lo .. a+hi (lo = p/s, hi = ceil(p/s)).
//  - A thread owns one 16-byte vector of channels (8 bf16 or 4 fp32) and keeps
//    its k*k weight vectors in registers, packed as loaded; neighbouring
//    threads own neighbouring vectors, so a warp reads and writes 4 pixels of
//    128 contiguous bytes.
//  - A block owns one frame n (or a group of its row steps), a tile of 8
//    channel vectors and a tile of up to 32 column steps. It walks its row
//    steps in bands and stages the dy rows they read, with the halo and zeros
//    outside dy, in a ring of rows in shared memory with cp.async: the next
//    band's new rows are copied while this band computes (double-buffered),
//    and every dy element leaves L2 once per block. Out-of-range rows and
//    columns of dy are zeros in the ring, so the tap loops have no bounds
//    checks; dx rows and columns that the strided forward never read come out
//    0, as the JAX right pad makes them.
//  - The tile arithmetic (band, column tile, bands per block, shared-memory
//    bytes) comes from the wrapper (ops/dw_kernels.py dx_launch_geometry);
//    the launcher derives the grid from it and refuses shared-memory bytes
//    that do not match its own count.
//  - 32-bit offsets inside a frame, one 64-bit frame base; fp32 accumulation
//    rounded once to dy's type; one pass, no atomics, so reruns are bitwise
//    equal. Where C is not a multiple of the vector width (or a pointer is not
//    16-byte aligned) the same kernel stages and stores element by element.
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
// compiled for (spatial and temporal k = 3 or 5) or a dx geometry it refuses.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dw_vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;  // channels per reduction block (threadIdx.x)
constexpr int kRows = 8;    // position lanes per reduction block (threadIdx.y)

// ---------------------------------------------------------------- dw_spatial_dx

constexpr int kDxThreads = 256;
constexpr int kDxTileVecs = 8;                      // channel vectors per block
constexpr int kDxLanes = kDxThreads / kDxTileVecs;  // position lanes per block

// The launch geometry of dw_spatial_dx_kernel (ops/dw_kernels.py dx_launch_geometry).
// Row and column steps are dy's rows and columns: oh = ceil(h / S) for odd k
// and padding k/2, and likewise ow.
struct DxGeometry {
  int h, wd, c, oh, ow;
  int band;              // row steps per band
  int col_tile;          // column steps per block
  int bands_per_block;   // bands walked by one block
  int groups;            // blocks per frame along the rows
  int ring;              // dy rows held in the ring
  int tile_cols;         // dy columns per ring row: col_tile + lo + hi
  int vec;               // 1: 16-byte copies and stores; 0: element by element
};

// dy rows [r_begin, r_end] of frame dyn, columns col0 - LO .. col0 - LO +
// tile_cols - 1, this block's channel vectors, into their ring slots; zeros
// outside dy.
template <typename T, int LO>
__device__ __forceinline__ void stage_dy_rows(uint4* __restrict__ ring, const T* __restrict__ dyn,
                                              const DxGeometry& g, int r_begin, int r_end, int col0, int cv0) {
  constexpr int kVec = Vec16<T>::kN;
  const int chunks = (r_end - r_begin + 1) * g.tile_cols * kDxTileVecs;
  for (int e = threadIdx.x; e < chunks; e += kDxThreads) {
    const int v = e % kDxTileVecs;
    const int rest = e / kDxTileVecs;
    const int cc = rest % g.tile_cols;
    const int r = r_begin + rest / g.tile_cols;
    const int col = col0 - LO + cc;
    const int ch = (cv0 + v) * kVec;
    uint4* dst = ring + (((r + LO) % g.ring) * g.tile_cols + cc) * kDxTileVecs + v;
    const bool inside = r >= 0 && r < g.oh && col >= 0 && col < g.ow && ch < g.c;
    const T* src = inside ? dyn + (r * g.ow + col) * g.c + ch : dyn;
    if (g.vec) {
      cp_async16(dst, src, inside ? 16 : 0);
    } else {
      *dst = inside ? Vec16<T>::load(src, g.c - ch) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Block (frame n and row group, channel tile, column tile); thread (channel
// vector v = tid % 8, position lane tid / 8). The ring holds dy row r in slot
// (r + LO) % ring; each band adds its `band` new rows while the last band's
// are read. For k = 3 the registers are capped so that 3 blocks fit an SM:
// at the small frames of the deep blocks a block's life is short, and the
// copies of one block hide behind the arithmetic of the others.
template <typename T, int K, int S>
__global__ void __launch_bounds__(kDxThreads)
dw_spatial_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w, T* __restrict__ dx, const DxGeometry g) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kP = K / 2;
  constexpr int kLo = kP / S;
  constexpr int kHi = (kP + S - 1) / S;
  extern __shared__ uint4 ring[];  // [g.ring][g.tile_cols][kDxTileVecs]

  const int v = threadIdx.x % kDxTileVecs;
  const int lane = threadIdx.x / kDxTileVecs;
  const int group = blockIdx.x % g.groups;
  const int64_t n = blockIdx.x / g.groups;
  const int cv0 = blockIdx.y * kDxTileVecs;
  const int cv = cv0 + v;
  const int ch = cv * kVec;
  const int col0 = blockIdx.z * g.col_tile;
  const int step0 = group * g.bands_per_block * g.band;
  const int step_end = min(step0 + g.bands_per_block * g.band, g.oh);
  const T* dyn = dy + n * g.oh * g.ow * g.c;
  T* dxn = dx + n * g.h * g.wd * g.c;

  stage_dy_rows<T, kLo>(ring, dyn, g, step0 - kLo, step0 + g.band - 1 + kHi, col0, cv0);
  cp_async_commit();
  uint4 wv[K * K];  // loaded while the first band's rows are in flight
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    if (ch >= g.c) {
      wv[t] = make_uint4(0u, 0u, 0u, 0u);
    } else if (g.vec) {
      wv[t] = *reinterpret_cast<const uint4*>(w + t * g.c + ch);
    } else {
      wv[t] = V::load(w + t * g.c + ch, g.c - ch);
    }
  }
  for (int s = step0; s < step_end; s += g.band) {
    if (s + g.band < step_end) {
      stage_dy_rows<T, kLo>(ring, dyn, g, s + g.band + kHi, s + 2 * g.band - 1 + kHi, col0, cv0);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    const int positions = min(g.band, step_end - s) * g.col_tile;
    for (int pos = lane; pos < positions; pos += kDxLanes) {
      const int rs = pos / g.col_tile;
      const int cs = pos - rs * g.col_tile;
      const int a = s + rs;
      const int b = col0 + cs;
      if (b >= g.ow || ch >= g.c) continue;
      const int slot_a = (a + kLo) % g.ring;
#pragma unroll
      for (int rh = 0; rh < S; ++rh) {
        const int hh = a * S + rh;
        if (hh >= g.h) continue;
#pragma unroll
        for (int rw = 0; rw < S; ++rw) {
          const int ww = b * S + rw;
          if (ww >= g.wd) continue;
          float acc[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
#pragma unroll
          for (int di = 0; di < K; ++di) {
            if ((rh + kP - di) % S != 0) continue;  // decided at compile time
            int slot = slot_a + (rh + kP - di) / S;
            slot += slot < 0 ? g.ring : 0;
            slot -= slot >= g.ring ? g.ring : 0;
            const uint4* row = ring + (slot * g.tile_cols + cs + kLo) * kDxTileVecs + v;
#pragma unroll
            for (int dj = 0; dj < K; ++dj) {
              if ((rw + kP - dj) % S != 0) continue;
              V::fma(acc, row[(rw + kP - dj) / S * kDxTileVecs], wv[di * K + dj]);
            }
          }
          T* out = dxn + (hh * g.wd + ww) * g.c + ch;
          if (g.vec) {
            *reinterpret_cast<uint4*>(out) = V::pack(acc);
          } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i) {
              if (ch + i < g.c) out[i] = from_float<T>(acc[i]);
            }
          }
        }
      }
    }
    __syncthreads();
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

template <typename T, int K, int S>
int launch_spatial_dx_kernel(const T* dy, const T* w, T* dx, const DxGeometry& g, dim3 grid, int smem,
                             cudaStream_t stream) {
  auto* kernel = dw_spatial_dx_kernel<T, K, S>;
  if (smem > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<grid, kDxThreads, smem, stream>>>(dy, w, dx, g);
  return static_cast<int>(cudaGetLastError());
}

// band, col_tile, bands_per_block and smem_bytes come from the wrapper; the
// rest of the geometry follows from them here.
template <typename T>
int launch_spatial_dx(const void* dy, const void* w, void* dx, int64_t n, int64_t h, int64_t wd, int64_t c,
                      int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t bands_per_block,
                      int64_t smem_bytes, void* stream) {
  constexpr int kVec = Vec16<T>::kN;
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || band < 1 || col_tile < 1 || bands_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pad = k / 2;
  const int64_t lo = pad / stride, hi = (pad + stride - 1) / stride;
  DxGeometry g;
  g.h = static_cast<int>(h);
  g.wd = static_cast<int>(wd);
  g.c = static_cast<int>(c);
  g.oh = static_cast<int>((h + 2 * pad - k) / stride + 1);
  g.ow = static_cast<int>((wd + 2 * pad - k) / stride + 1);
  g.band = static_cast<int>(band);
  g.col_tile = static_cast<int>(col_tile);
  g.bands_per_block = static_cast<int>(bands_per_block);
  const int64_t bands = (g.oh + band - 1) / band;
  g.groups = static_cast<int>((bands + bands_per_block - 1) / bands_per_block);
  g.ring = static_cast<int>((bands_per_block > 1 ? 2 * band : band) + lo + hi);
  g.tile_cols = static_cast<int>(col_tile + lo + hi);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec = c % kVec == 0 && aligned(dy) && aligned(w) && aligned(dx);
  if (smem_bytes != static_cast<int64_t>(g.ring) * g.tile_cols * kDxTileVecs * 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || h == 0 || wd == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const int64_t cvecs = (c + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned int>(n * g.groups), static_cast<unsigned int>((cvecs + kDxTileVecs - 1) / kDxTileVecs),
                  static_cast<unsigned int>((g.ow + col_tile - 1) / col_tile));
  const auto* dyp = static_cast<const T*>(dy);
  const auto* wp = static_cast<const T*>(w);
  auto* dxp = static_cast<T*>(dx);
  const auto s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(smem_bytes);
  if (k == 3) {
    return stride == 1 ? launch_spatial_dx_kernel<T, 3, 1>(dyp, wp, dxp, g, grid, smem, s)
                       : launch_spatial_dx_kernel<T, 3, 2>(dyp, wp, dxp, g, grid, smem, s);
  }
  return stride == 1 ? launch_spatial_dx_kernel<T, 5, 1>(dyp, wp, dxp, g, grid, smem, s)
                     : launch_spatial_dx_kernel<T, 5, 2>(dyp, wp, dxp, g, grid, smem, s);
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
                      int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t bands_per_block,
                      int64_t smem_bytes, void* stream) {
  return launch_spatial_dx<float>(dy, w, dx, n, h, wd, c, k, stride, band, col_tile, bands_per_block, smem_bytes,
                                  stream);
}

int dw_spatial_dx_bf16(const void* dy, const void* w, void* dx, int64_t n, int64_t h, int64_t wd, int64_t c,
                       int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t bands_per_block,
                       int64_t smem_bytes, void* stream) {
  return launch_spatial_dx<__nv_bfloat16>(dy, w, dx, n, h, wd, c, k, stride, band, col_tile, bands_per_block,
                                          smem_bytes, stream);
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
