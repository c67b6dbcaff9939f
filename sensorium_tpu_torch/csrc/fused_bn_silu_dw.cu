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
// The prologue runs in fp32 and is never rounded: the activation lives only
// in shared memory, in fp32, so only the conv output is rounded, once, to x's
// type.
//
// What bounds it: bytes in principle (x read once, y written once, as for
// dw_spatial_fwd; 2.42 ms over one flagship step's 9 blocks in bf16 at the
// 3.35 TB/s of an H100 SXM), but in practice instructions: the prologue
// costs an exponential and a reciprocal per x element on the special
// function unit (16 a clock an SM, about 1.4 ms over the 9 blocks), and the
// staging, the prologue pass and the tap loops run one after another in a
// block. So the prologue runs once per x element, its pass and the staging
// spend as few instructions per cell as they can, and the copies of the
// next band overlap this band's arithmetic.
//
// Design of fused_bn_silu_dw_kernel<T, K, S, W>, dw_conv.cu's
// dw_spatial_fwd_kernel with the prologue applied as x is staged:
//  - k, the stride and W (output columns per thread) are template parameters
//    (k in {3, 5}; stride 1 with W in {2, 4}, stride 2 with W = 2), so every
//    tap loop unrolls and no division or modulo is left in it.
//  - A thread owns one 16-byte vector of channels (8 bf16 or 4 fp32). A block
//    owns one frame n (or a group of its output rows), a tile of 8 channel
//    vectors and a tile of col_tile output columns, and walks its rows in
//    bands of `band` output rows; where one band holds a whole frame and the
//    frames give enough blocks, it walks two frames instead, one band each.
//  - Two rings in shared memory, each of the S*(band-1)+K x rows a band reads
//    with their halo: x row r sits in slot (r + K/2) % ring of both. The
//    landing ring takes the raw rows by cp.async; the activation ring holds
//    silu(x * scale + shift) in fp32. At the top of a band one pass turns the
//    band's new rows (all of a frame's for its first band, the S*band below
//    the last band's otherwise), landed raw, into activations, once per
//    element: the rows the band shares with the last one (its halo) stay in
//    the activation ring and are not turned again. Then the next band's new
//    rows are copied into the landing ring while this band computes.
//    Elements outside the frame and channels past C become exactly 0
//    (dw_vec.cuh x_inside, the staging's predicate), which is the zero
//    padding after the prologue, so the tap loops carry no bounds check.
//  - The copies and the prologue pass walk the same cells: a band's new
//    (row, column) cells dealt to the lanes in turn, each lane stepping its
//    row, column and ring index by 32 cells with no division (for_cells).
//  - The prologue's forms: fp32 data takes the accurate expf and an IEEE
//    division. bf16 data, whose output is rounded to 8 bits, takes 2^t and
//    1/d from the special function unit alone (ex2.approx.ftz and
//    rcp.approx.ftz, a few fp32 ulps): 6 instructions an element, against 10
//    for __expf and __fdividef, whose subnormal handling costs 4.
//  - The block's weights are converted to fp32 once, into shared memory;
//    scale and shift likewise, read element by element and never past C.
//  - A thread computes W adjacent outputs of one row from a register window:
//    for each tap row it loads the row's K weight vectors and then the
//    S*(W-1)+K activation vectors its outputs read, each used by up to
//    ceil(K/S) outputs.
//  - The tile arithmetic (band, column tile, W, frames or bands per block,
//    shared-memory bytes) comes from the wrapper (ops/dw_kernels.py
//    fused_launch_geometry); the launcher derives the rest and refuses
//    shared-memory bytes that do not match its own count.
//  - 32-bit offsets inside a frame, one 64-bit frame base; fp32 accumulation
//    in the plain version's tap order, rounded once to x's type; one pass, so
//    reruns are bitwise equal. Where C is not a multiple of the vector width
//    (or a pointer is not 16-byte aligned) the same kernel stages and stores
//    element by element.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a kernel size, stride or tiling the kernel is not compiled for.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dw_vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileVecs = 8;                     // channel vectors per block
constexpr int kLanes = kThreads / kTileVecs;     // position lanes per block

// The launch geometry of fused_bn_silu_dw_kernel (ops/dw_kernels.py fused_launch_geometry).
struct FusedGeometry {
  int64_t frame_in, frame_out;  // elements of an x and a y frame
  int n, h, wd, c, oh, ow;
  int band;             // output rows per band
  int col_tile;         // output columns per block, a multiple of W
  int frames;           // frames walked by one block, one band each (1: the block stays in one frame)
  int bands_per_block;  // bands walked by one block in its frame (frames == 1)
  int groups;           // blocks per frame along the rows
  int units_per_row;    // col_tile / W
  int ring;             // x rows of a band, held by each ring: S*(band-1)+K
  int tile_cols;        // x columns per ring row: S*(col_tile-1)+K
  int vec;              // 1: 16-byte copies and stores; 0: element by element
};

// silu(x * a + b) in fp32, never rounded to T (bn_act.cuh's bn_silu rounds the
// BN output to T first, as the model's eval BN does); bf16 data: v * 1 / (1 +
// 2^(-v * log2(e))), where a subnormal 2^t flushed to 0 gives 1 + 0, as 1 + 2^t
// rounds to 1 anyway.
template <typename T> __device__ __forceinline__ float bn_silu_unrounded(float x, float a, float b);
template <> __device__ __forceinline__ float bn_silu_unrounded<float>(float x, float a, float b) {
  const float v = fmaf(x, a, b);
  return v / (1.0f + expf(-v));
}
template <> __device__ __forceinline__ float bn_silu_unrounded<__nv_bfloat16>(float x, float a, float b) {
  const float v = fmaf(x, a, b);
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return v * r;
}

// Block (frames and row group, channel tile, column tile); thread (channel
// vector v = tid % 8, position lane tid / 8). A unit is W adjacent outputs of
// one row; a band has band * col_tile / W units, taken by the lanes in turn.
// Shared memory: the activation ring [g.ring][g.tile_cols][kVec/4][8] float4s,
// the landing ring [g.ring][g.tile_cols][8] 16-byte vectors, the weights
// [K*K][kVec/4][8] float4s, then scale and shift [2][8 * kVec] floats.
// Registers are capped for 3 blocks an SM (80 a thread; a few bytes spill),
// whose warps overlap one another's prologue pass, copies and tap loops; for
// 2 (128) at k = 5, and for bf16 at stride 2, whose prologue pass is the
// longest and whose tiles would shrink to half a unit a lane. The wrapper
// sizes the tiles' shared memory by the same rule (ops/dw_kernels.py
// _fused_blocks_per_sm).
template <typename T, int K, int S, int W>
__global__ void __launch_bounds__(kThreads, (K == 5 || (sizeof(T) == 2 && S == 2)) ? 2 : 3)
fused_bn_silu_dw_kernel(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ shift,
                        const T* __restrict__ w, T* __restrict__ y, const FusedGeometry g) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kP = K / 2;
  constexpr int kQuads = kVec / 4;         // float4s per channel vector
  constexpr int kWindow = S * (W - 1) + K;  // x columns a unit reads per row
  extern __shared__ float4 smem[];
  float4* act = smem;
  uint4* landing = reinterpret_cast<uint4*>(act + g.ring * g.tile_cols * kQuads * kTileVecs);
  float4* wsm = reinterpret_cast<float4*>(landing + g.ring * g.tile_cols * kTileVecs);
  float* affine = reinterpret_cast<float*>(wsm + K * K * kQuads * kTileVecs);

  const int v = threadIdx.x % kTileVecs;
  const int lane = threadIdx.x / kTileVecs;
  const int group = blockIdx.x % g.groups;
  const int n0 = blockIdx.x / g.groups * g.frames;  // the block's first frame
  const int cv0 = blockIdx.y * kTileVecs;
  const int ch = (cv0 + v) * kVec;
  const int col0 = blockIdx.z * g.col_tile;
  const int xcol0 = col0 * S - kP;
  const bool walks = g.frames > 1;
  const int row0 = group * g.bands_per_block * g.band;
  const int row_end = min(row0 + g.bands_per_block * g.band, g.oh);
  // Whether the block has a band i: a frame left to walk, or rows left in its group.
  auto has_band = [&](int i) { return walks ? i < g.frames && n0 + i < g.n : row0 + i * g.band < row_end; };
  // Band i's first output row in its frame, and the x rows it adds to the
  // rings: all of them for the first band of a frame, the S*band new rows
  // below the last band's otherwise.
  auto band_row = [&](int i) { return walks ? 0 : row0 + i * g.band; };
  auto new_rows_begin = [&](int i) { return (walks || i == 0) ? band_row(i) * S - kP : (band_row(i) - 1) * S + K - kP; };
  auto rows_end = [&](int i) { return (band_row(i) + g.band - 1) * S + K - 1 - kP; };

  // The (row, column) cells of band i's new rows, dealt to the lanes in turn
  // in row-major order: fn(r, col, index) for each of this lane's, x row r
  // and column col in ring cell index (slot * tile_cols + column; the rings
  // are row-major, so it steps by kLanes and wraps at the end).
  const int cells = g.ring * g.tile_cols;
  const int step_r = kLanes / g.tile_cols;
  const int step_c = kLanes - step_r * g.tile_cols;
  const int rr0 = lane / g.tile_cols;
  const int cc0 = lane - rr0 * g.tile_cols;
  auto for_cells = [&](int i, auto&& fn) {
    const int r_begin = new_rows_begin(i);
    const int count = (rows_end(i) - r_begin + 1) * g.tile_cols;
    int index = ((r_begin + kP) % g.ring) * g.tile_cols + lane;
    index -= index >= cells ? cells : 0;
    int rr = rr0, cc = cc0;
#pragma unroll 1
    for (int j = lane; j < count; j += kLanes) {
      fn(r_begin + rr, xcol0 + cc, index);
      index += kLanes;
      index -= index >= cells ? cells : 0;
      rr += step_r;
      cc += step_c;
      if (cc >= g.tile_cols) {
        cc -= g.tile_cols;
        ++rr;
      }
    }
  };
  auto stage = [&](int i) {
    if (!has_band(i)) return;
    const T* xn = x + static_cast<int64_t>(n0 + (walks ? i : 0)) * g.frame_in;
    for_cells(i, [&](int r, int col, int index) {
      const bool inside = x_inside(g, r, col, ch);
      const T* src = inside ? xn + (r * g.wd + col) * g.c + ch : xn;
      uint4* dst = landing + index * kTileVecs + v;
      if (g.vec) {
        cp_async16(dst, src, inside ? 16 : 0);
      } else {
        *dst = inside ? V::load(src, g.c - ch) : make_uint4(0u, 0u, 0u, 0u);
      }
    });
  };
  stage(0);
  cp_async_commit();
  // The weights, scale and shift, while the first band's rows are in flight.
  for (int e = threadIdx.x; e < K * K * kTileVecs; e += kThreads) {
    const int t = e / kTileVecs;
    const int wv = e % kTileVecs;
    const int wch = (cv0 + wv) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (wch < g.c) {
      raw = g.vec ? *reinterpret_cast<const uint4*>(w + t * g.c + wch) : V::load(w + t * g.c + wch, g.c - wch);
    }
    float f[kVec];
    V::unpack(f, raw);
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      wsm[(t * kQuads + q) * kTileVecs + wv] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
    }
  }
  for (int e = threadIdx.x; e < 2 * kTileVecs * kVec; e += kThreads) {
    const int e_ch = cv0 * kVec + e % (kTileVecs * kVec);
    affine[e] = e_ch < g.c ? (e < kTileVecs * kVec ? scale : shift)[e_ch] : 0.0f;
  }

  for (int i = 0; has_band(i); ++i) {
    cp_async_wait_all();
    // Band i's rows have landed, and every thread is done with band i-1's
    // activations, whose slots the new rows take.
    __syncthreads();
    {
      float a[kVec], b[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        a[e] = affine[v * kVec + e];
        b[e] = affine[(kTileVecs + v) * kVec + e];
      }
      for_cells(i, [&](int r, int col, int index) {
        float f[kVec];
        if (x_inside(g, r, col, ch)) {
          V::unpack(f, landing[index * kTileVecs + v]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] = bn_silu_unrounded<T>(f[e], a[e], b[e]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] = 0.0f;
        }
        float4* dst = act + index * kQuads * kTileVecs + v;
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          dst[q * kTileVecs] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
        }
      });
    }
    // Band i's activations are complete and the landing ring is free.
    __syncthreads();
    stage(i + 1);
    cp_async_commit();

    const int s = band_row(i);
    const int frame = n0 + (walks ? i : 0);
    const int units = ch < g.c ? min(g.band, (walks ? g.oh : row_end) - s) * g.units_per_row : 0;
    for (int u = lane; u < units; u += kLanes) {
      const int rs = u / g.units_per_row;
      const int cu = u - rs * g.units_per_row;
      const int a = s + rs;          // output row
      const int b0 = col0 + cu * W;  // first output column of the unit
      if (b0 >= g.ow) continue;
      float acc[W][kVec];
#pragma unroll
      for (int o = 0; o < W; ++o) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[o][e] = 0.0f;
      }
      const int slot0 = (a * S) % g.ring;  // x row a*S - P + di is in slot slot0 + di
      // One tap row at a time, as in dw_spatial_fwd_kernel.
#pragma unroll 1
      for (int di = 0; di < K; ++di) {
        int slot = slot0 + di;
        slot -= slot >= g.ring ? g.ring : 0;
        const float4* row = act + (slot * g.tile_cols + cu * W * S) * kQuads * kTileVecs + v;
        float wf[K][kVec];
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
#pragma unroll
          for (int q = 0; q < kQuads; ++q) {
            const float4 f = wsm[((di * K + dj) * kQuads + q) * kTileVecs + v];
            wf[dj][4 * q] = f.x;
            wf[dj][4 * q + 1] = f.y;
            wf[dj][4 * q + 2] = f.z;
            wf[dj][4 * q + 3] = f.w;
          }
        }
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
          float xf[kVec];
#pragma unroll
          for (int q = 0; q < kQuads; ++q) {
            const float4 f = row[(j * kQuads + q) * kTileVecs];
            xf[4 * q] = f.x;
            xf[4 * q + 1] = f.y;
            xf[4 * q + 2] = f.z;
            xf[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int o = 0; o < W; ++o) {
            const int dj = j - S * o;  // decided at compile time
            if (dj < 0 || dj >= K) continue;
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[o][e] = fmaf(xf[e], wf[dj][e], acc[o][e]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < W; ++o) {
        if (b0 + o >= g.ow) break;
        T* out = y + static_cast<int64_t>(frame) * g.frame_out + (a * g.ow + b0 + o) * g.c + ch;
        if (g.vec) {
          *reinterpret_cast<uint4*>(out) = V::pack(acc[o]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            if (ch + e < g.c) out[e] = from_float<T>(acc[o][e]);
          }
        }
      }
    }
  }
}

template <typename T, int K, int S, int W>
int launch_kernel(const T* x, const float* scale, const float* shift, const T* w, T* y, const FusedGeometry& g,
                  dim3 grid, int smem, cudaStream_t stream) {
  auto* kernel = fused_bn_silu_dw_kernel<T, K, S, W>;
  if (smem > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<grid, kThreads, smem, stream>>>(x, scale, shift, w, y, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int dispatch(const T* x, const float* scale, const float* shift, const T* w, T* y, const FusedGeometry& g,
             int stride, int cols, dim3 grid, int smem, cudaStream_t stream) {
  if (stride == 2) return launch_kernel<T, K, 2, 2>(x, scale, shift, w, y, g, grid, smem, stream);
  return cols == 4 ? launch_kernel<T, K, 1, 4>(x, scale, shift, w, y, g, grid, smem, stream)
                   : launch_kernel<T, K, 1, 2>(x, scale, shift, w, y, g, grid, smem, stream);
}

// band, col_tile, cols (W), frames, bands_per_block and smem_bytes come from
// the wrapper; the rest of the geometry follows from them here.
template <typename T>
int launch(const void* x, const void* scale, const void* shift, const void* w, void* y, int64_t n, int64_t h,
           int64_t wd, int64_t c, int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols,
           int64_t frames, int64_t bands_per_block, int64_t smem_bytes, void* stream) {
  constexpr int kVec = Vec16<T>::kN;
  const bool cols_ok = stride == 1 ? (cols == 2 || cols == 4) : (stride == 2 && cols == 2);
  if ((k != 3 && k != 5) || !cols_ok || band < 1 || col_tile < 1 || col_tile % cols != 0 || frames < 1 ||
      bands_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pad = k / 2;
  FusedGeometry g;
  g.n = static_cast<int>(n);
  g.h = static_cast<int>(h);
  g.wd = static_cast<int>(wd);
  g.c = static_cast<int>(c);
  g.oh = static_cast<int>((h + 2 * pad - k) / stride + 1);
  g.ow = static_cast<int>((wd + 2 * pad - k) / stride + 1);
  g.frame_in = h * wd * c;
  g.frame_out = static_cast<int64_t>(g.oh) * g.ow * c;
  if (frames > 1 && (band < g.oh || bands_per_block != 1)) return static_cast<int>(cudaErrorInvalidValue);
  g.band = static_cast<int>(band);
  g.col_tile = static_cast<int>(col_tile);
  g.frames = static_cast<int>(frames);
  g.bands_per_block = static_cast<int>(bands_per_block);
  const int64_t bands = (g.oh + band - 1) / band;
  g.groups = static_cast<int>((bands + bands_per_block - 1) / bands_per_block);
  g.units_per_row = static_cast<int>(col_tile / cols);
  g.ring = static_cast<int>(stride * (band - 1) + k);
  g.tile_cols = static_cast<int>(stride * (col_tile - 1) + k);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec = c % kVec == 0 && aligned(x) && aligned(w) && aligned(y);
  // The two rings (fp32 activations and raw x), the weights, scale and shift.
  const int64_t ring_bytes = static_cast<int64_t>(g.ring) * g.tile_cols * kTileVecs * (kVec * 4 + 16);
  if (smem_bytes != ring_bytes + (k * k + 2) * kTileVecs * kVec * 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || h == 0 || wd == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const int64_t cvecs = (c + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned int>((n + frames - 1) / frames * g.groups),
                  static_cast<unsigned int>((cvecs + kTileVecs - 1) / kTileVecs),
                  static_cast<unsigned int>((g.ow + col_tile - 1) / col_tile));
  const auto* xp = static_cast<const T*>(x);
  const auto* sp = static_cast<const float*>(scale);
  const auto* hp = static_cast<const float*>(shift);
  const auto* wp = static_cast<const T*>(w);
  auto* yp = static_cast<T*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(smem_bytes);
  const int st = static_cast<int>(stride), cl = static_cast<int>(cols);
  return k == 3 ? dispatch<T, 3>(xp, sp, hp, wp, yp, g, st, cl, grid, smem, s)
                : dispatch<T, 5>(xp, sp, hp, wp, yp, g, st, cl, grid, smem, s);
}

}  // namespace

extern "C" {

int fused_bn_silu_dw_spatial_f32(const void* x, const void* scale, const void* shift, const void* w, void* y,
                                 int64_t n, int64_t h, int64_t wd, int64_t c, int64_t k, int64_t stride,
                                 int64_t band, int64_t col_tile, int64_t cols, int64_t frames,
                                 int64_t bands_per_block, int64_t smem_bytes, void* stream) {
  return launch<float>(x, scale, shift, w, y, n, h, wd, c, k, stride, band, col_tile, cols, frames,
                       bands_per_block, smem_bytes, stream);
}

int fused_bn_silu_dw_spatial_bf16(const void* x, const void* scale, const void* shift, const void* w, void* y,
                                  int64_t n, int64_t h, int64_t wd, int64_t c, int64_t k, int64_t stride,
                                  int64_t band, int64_t col_tile, int64_t cols, int64_t frames,
                                  int64_t bands_per_block, int64_t smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(x, scale, shift, w, y, n, h, wd, c, k, stride, band, col_tile, cols, frames,
                               bands_per_block, smem_bytes, stream);
}

}  // extern "C"
