// Depthwise convolutions of the DwiseNeuro core, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sensorium_tpu/ops/pallas_dw.py:
//   dw_spatial_fwd  <- _dw_spatial_fwd (stride 1: _dw_spatial_kernel; stride 2:
//                      _dw_spatial_s2_kernel on the _parity_split planes)
//   dw_temporal_fwd <- _dw_temporal_fwd (_dw_temporal_kernel); with the taps
//                      reversed it is also the temporal input gradient
//                      (_dw_temporal_vjp_bwd)
//
// Layout is channels-last, as in the JAX package:
//   spatial:  x (N = B*T, H, W, C), w (k, k, C)  -> y (N, OH, OW, C)
//             y[n,oh,ow,c] = sum_{di,dj} w[di,dj,c] * x[n, s*oh+di-p, s*ow+dj-p, c],
//             p = k/2, zero padding, OH = (H + 2p - k) / s + 1
//   temporal: x (B, T, HW = H*W, C), w (k, C)    -> y (B, T, HW, C)
//             y[b,t,p,c] = sum_dt w[dt,c] * x[b, t+dt-k/2, p, c], zero padding, odd k
//
// What bounds them: bytes. Each reads x once and writes y once; the work is
// k*k (spatial) or k (temporal) multiply-adds per output element, far below
// the card's ridge point of ~20 fp32 operations per byte. At the 3.35 TB/s of
// an H100 SXM data sheet (700 W limit), block 0's stride-2 spatial conv of one
// 32-window chunk moves 2.35 GB in bf16 and cannot take less than ~0.70 ms.
// To come near that, the spatial kernel must not spend more instructions or
// shared-memory bandwidth per output than the bytes allow: at stride 1 a
// naive thread issues k*k loads, k*k conversions of 8 bf16 and k*k weight
// conversions for every 8 outputs, which is more than the card can issue in
// the time the bytes take.
//
// Design of dw_spatial_fwd_kernel<T, K, S, W>:
//  - k, the stride and W (output columns per thread) are template parameters
//    (k in {3, 5}; stride 1 with W in {2, 4}, stride 2 with W = 2), so every
//    tap loop unrolls and no division or modulo is left in it.
//  - A thread owns one 16-byte vector of channels (8 bf16 or 4 fp32);
//    neighbouring threads own neighbouring vectors, so each quarter-warp
//    reads and writes 128 contiguous bytes of one pixel.
//  - A block owns one frame n (or a group of its output rows), a tile of 8
//    channel vectors and a tile of col_tile output columns. It walks its rows
//    in bands of `band` output rows and stages the x rows a band reads,
//    S*(band-1)+K of them with the halo, in a ring in shared memory with
//    cp.async; the next band adds S*band rows, copied while this band
//    computes (double-buffered). Out-of-frame rows and columns are copied as
//    zeros (a source size of 0), which is the zero padding, so the tap loops
//    carry no bounds checks. Each x element leaves L2 about once per block.
//    The staging (stage_x_rows) lives in dw_vec.cuh: dw_spatial_dw stages the
//    same x rows for the same bands of output rows.
//  - Where one band holds a whole frame (the 8x8 outputs of the deep
//    blocks), a block's life would be one copy and one short band of
//    arithmetic, with nothing to hide the copy behind. There a block walks
//    `frames` frames instead, one band each, the next frame's rows copied
//    while this frame computes, and loads its weights once for all of them.
//  - The block's weights are converted to fp32 once, into shared memory, not
//    held in registers (dw_spatial_dx's k*k weight vectors, unpacked, take 72
//    registers and leave room for 2 blocks an SM).
//  - A thread computes W adjacent outputs of one row from a register window:
//    for each tap row it loads the row's K weight vectors and then the
//    S*(W-1)+K x vectors its outputs read, each converted once and used by
//    up to ceil(K/S) outputs, so per output it loads and converts
//    (S*(W-1)+K)/W x vectors a row instead of K. W and the tiles keep at least
//    3 blocks of 256 threads on an SM (k = 3) in registers and shared memory.
//  - The tile arithmetic (band, column tile, W, frames or bands per block,
//    shared-memory bytes) comes from the wrapper (ops/dw_kernels.py
//    fwd_launch_geometry); the launcher derives the rest and refuses
//    shared-memory bytes that do not match its own count.
//  - 32-bit offsets inside a frame, one 64-bit frame base; fp32 accumulation
//    in the plain version's tap order, rounded once to x's type; one pass, so
//    reruns are bitwise equal. Where C is not a multiple of the vector width
//    (or a pointer is not 16-byte aligned) the same kernel stages and stores
//    element by element.
//
// Design of dw_temporal_fwd_walk<T, K, F>, a column walk:
//  - A thread owns one 16-byte vector of channels (8 bf16 or 4 fp32) of one
//    (b, hw) column and walks the column's T frames; neighbouring threads own
//    neighbouring vectors of one pixel, then neighbouring pixels, so a warp
//    reads and writes 512 contiguous bytes of each frame. The grid covers
//    B*HW*ceil(C/vec) threads, 256 a block.
//  - Each x vector is read from DRAM once: it enters a register window of the
//    K frames t-P .. t+P, converted to fp32 once, and leaves it K frames
//    later; each y vector is written once, with one 16-byte store. The K
//    weight vectors are converted to fp32 registers once.
//  - Loads in flight: the frames are taken in tiles of F (a template
//    parameter): the F loads of a tile are started together, then its F
//    outputs computed, so a warp has F loads in flight, not one dependent
//    load a frame.
//  - k is a template parameter (3 or 5), so the tap loop unrolls; it holds no
//    modulo and no bounds check. The column's ends are the walk's: the window
//    starts with zeros for the frames before 0, and frames from T on load as
//    zeros. Where C is not a multiple of the vector width (or a pointer is not
//    16-byte aligned) the same kernel loads and stores element by element.
//  - One 64-bit column base, 32-bit offsets along T; fp32 accumulation in the
//    plain version's tap order, rounded once to x's type; reruns are bitwise
//    equal. The frame tile comes from the wrapper (ops/dw_kernels.py
//    temporal_launch_geometry), which the launcher refuses unless compiled.
//  Bound: bytes. x and y are moved once (block 0-3's calls of a batch of 32 x
//  16 frames: 0.94 GB in bf16, >= 0.28 ms at 3.35 TB/s), with k
//  multiply-adds per output element.
//
// The eval BN prologue (dw_spatial_fwd_bn, dw_temporal_fwd_bn): in the
// served forward, an eval batch norm with its SiLU (pw_bn before the spatial
// conv, spatial_bn before the temporal one) runs inside the conv that reads
// its output, which is then never written to device memory. It replaces no
// TPU kernel: XLA fuses the JAX package's BN and SiLU into their neighbours.
// Both kernels take it as a compile-time parameter BN; without it they are
// the plain convs above. With it, every x element becomes
// round(silu(round(x*a + b))) once, as it is staged, by bn_act.cu's own
// arithmetic (bn_act.cuh: a and b derived per channel from the running
// statistics as bn_act_apply_kernel's eval branch derives them, bn_silu), so
// the output is bitwise dw_*_fwd(bn_act_eval(x)). The padding stays zero
// after the prologue (silu(b) != 0 in general). The prologue adds no device
// traffic but the four per-channel vectors: its cost is an exponential and a
// reciprocal per x element on the special function unit, where the eval BN
// pass it replaces read and wrote the tensor once more. dw_spatial_fwd_kernel
// turns a band's new rows in place in its ring, each thread the cells it
// copied itself, right after its copies complete, so no barrier is added per
// band; the band's cells are dealt to the lanes evenly for that (deal_cells);
// a and b of the block's channel tile wait in shared memory after the
// weights. dw_temporal_fwd_walk turns each frame as it enters its register
// window, with the column's a and b in registers.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a kernel size, stride or tiling the kernels are not compiled for.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bn_act.cuh"
#include "dw_vec.cuh"

namespace {

// ---------------------------------------------------------------- dw_spatial_fwd

constexpr int kFwdThreads = 256;
constexpr int kFwdTileVecs = 8;                        // channel vectors per block
constexpr int kFwdLanes = kFwdThreads / kFwdTileVecs;  // position lanes per block

// The launch geometry of dw_spatial_fwd_kernel (ops/dw_kernels.py fwd_launch_geometry).
struct FwdGeometry {
  int64_t frame_in, frame_out;  // elements of an x and a y frame
  int n, h, wd, c, oh, ow;
  int band;             // output rows per band
  int col_tile;         // output columns per block, a multiple of W
  int frames;           // frames walked by one block, one band each (1: the block stays in one frame)
  int bands_per_block;  // bands walked by one block in its frame (frames == 1)
  int groups;           // blocks per frame along the rows
  int band_rows;        // virtual ring rows between bands: S*(band-1)+K when the block walks frames, else 0
  int units_per_row;    // col_tile / W
  int ring;             // x rows held in the ring
  int tile_cols;        // x columns per ring row: S*(col_tile-1)+K
  int vec;              // 1: 16-byte copies and stores; 0: element by element
};

// Block (frames and row group, channel tile, column tile); thread (channel
// vector v = tid % 8, position lane tid / 8). The block walks a sequence of
// bands: the bands of its row group in one frame, or one band (the whole
// frame) in each of its `frames` frames. Band i's x rows sit at virtual rows
// i * band_rows + r + P when the block walks frames (0 + r + P otherwise, so
// neighbouring bands of a frame share their halo rows), in slot virtual % ring.
// A unit is W adjacent outputs of one row; a band has band * col_tile / W
// units, taken by the lanes in turn. Shared memory: the ring
// [g.ring][g.tile_cols][8] of 16-byte vectors, then the weights in fp32,
// [K*K][kVec/4][8] float4s, and with BN the tile's a and b, [2][8][kVec]
// floats. The frame sizes come from the geometry (constant
// memory), so that few block-level values hold registers through the tap
// loops, where ptxas would spill them. Registers are capped for 3 blocks an
// SM at k = 3 (80 a thread), for 4 with 2 outputs a thread at stride 1 (the
// small frames, whose blocks' copies hide behind each other's arithmetic),
// for 2 at k = 5.
template <typename T, int K, int S, int W, bool BN>
__global__ void __launch_bounds__(kFwdThreads, K == 3 ? (S == 1 && W == 2 ? 4 : 3) : 2)
dw_spatial_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, const FwdGeometry g,
                      const EvalBn bn) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kP = K / 2;
  constexpr int kQuads = kVec / 4;         // float4s per channel vector
  constexpr int kWindow = S * (W - 1) + K;  // x columns a unit reads per row
  extern __shared__ uint4 smem[];
  uint4* ring = smem;
  float4* wsm = reinterpret_cast<float4*>(smem + g.ring * g.tile_cols * kFwdTileVecs);
  // BN: the tile's a, then its b, [8][kVec] floats each.
  [[maybe_unused]] float* affine = reinterpret_cast<float*>(wsm + K * K * kQuads * kFwdTileVecs);

  const int v = threadIdx.x % kFwdTileVecs;
  const int lane = threadIdx.x / kFwdTileVecs;
  const int group = blockIdx.x % g.groups;
  const int n0 = blockIdx.x / g.groups * g.frames;  // the block's first frame
  const int cv0 = blockIdx.y * kFwdTileVecs;
  const int ch = (cv0 + v) * kVec;
  const int col0 = blockIdx.z * g.col_tile;
  const bool walks = g.frames > 1;
  const int row0 = group * g.bands_per_block * g.band;
  const int row_end = min(row0 + g.bands_per_block * g.band, g.oh);
  // Whether the block has a band i: a frame left to walk, or rows left in its group.
  auto has_band = [&](int i) { return walks ? i < g.frames && n0 + i < g.n : row0 + i * g.band < row_end; };

  // Band i's x rows that the ring does not hold yet, [new_rows(i), last_row(i)]:
  // all of them for the first band of a frame, the S*band new rows below the
  // last band's otherwise.
  auto new_rows = [&](int i) {
    const int s = walks ? 0 : row0 + i * g.band;
    return (walks || i == 0) ? s * S - kP : (s - 1) * S + K - kP;
  };
  auto last_row = [&](int i) { return ((walks ? 0 : row0 + i * g.band) + g.band - 1) * S + K - 1 - kP; };
  // With BN the cells of all the band's rows are dealt to the lanes in turn
  // (stage_x_cells), so that the prologue, which each thread runs on the
  // cells it copied, is spread evenly.
  auto stage = [&](int i) {
    if (!has_band(i)) return;
    const T* xn = x + static_cast<int64_t>(n0 + (walks ? i : 0)) * g.frame_in;
    if constexpr (BN) {
      stage_x_cells<T, kP, kFwdTileVecs, kFwdLanes>(ring, xn, g, new_rows(i), last_row(i), i * g.band_rows,
                                                    col0 * S - kP, ch);
    } else {
      stage_x_rows<T, kP, kFwdTileVecs, kFwdLanes>(ring, xn, g, new_rows(i), last_row(i), i * g.band_rows,
                                                   col0 * S - kP, ch);
    }
  };
  stage(0);
  cp_async_commit();
  // The weights, while the first band's rows are in flight.
  for (int e = threadIdx.x; e < K * K * kFwdTileVecs; e += kFwdThreads) {
    const int t = e / kFwdTileVecs;
    const int wv = e % kFwdTileVecs;
    const int wch = (cv0 + wv) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (wch < g.c) {
      raw = g.vec ? *reinterpret_cast<const uint4*>(w + t * g.c + wch) : V::load(w + t * g.c + wch, g.c - wch);
    }
    float f[kVec];
    V::unpack(f, raw);
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      wsm[(t * kQuads + q) * kFwdTileVecs + wv] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
    }
  }
  if constexpr (BN) {
    for (int e = threadIdx.x; e < kFwdTileVecs * kVec; e += kFwdThreads) {
      const int ech = cv0 * kVec + e;
      float a = 0.0f, b = 0.0f;
      if (ech < g.c) eval_affine(bn.mean[ech], bn.var[ech], bn.scale[ech], bn.bias[ech], bn.eps, a, b);
      affine[e] = a;
      affine[kFwdTileVecs * kVec + e] = b;
    }
    __syncthreads();  // a and b, before the first band's prologue
  }

  for (int i = 0; has_band(i); ++i) {
    // One group per band, empty past the last, so that waiting for all but
    // the newest group always means band i has landed.
    stage(i + 1);
    cp_async_commit();
    cp_async_wait_one();
    if constexpr (BN) {
      // This thread's copies of band i have landed: the prologue on them, in
      // place, once per in-frame cell (it reads only what it wrote itself);
      // the zero padding stays 0.
      float a[kVec], b[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        a[e] = affine[v * kVec + e];
        b[e] = affine[(kFwdTileVecs + v) * kVec + e];
      }
      const int xcol0 = col0 * S - kP;
      deal_cells<kP, kFwdLanes>(g, lane, new_rows(i), last_row(i), i * g.band_rows, [&](int r, int cc, int slot) {
        uint4* cell = ring + (slot * g.tile_cols + cc) * kFwdTileVecs + v;
        if (x_inside(g, r, xcol0 + cc, ch)) *cell = bn_silu_vec<T>(*cell, a, b);
      });
    }
    __syncthreads();

    const int s = walks ? 0 : row0 + i * g.band;
    const int frame = n0 + (walks ? i : 0);
    const int units = ch < g.c ? min(g.band, (walks ? g.oh : row_end) - s) * g.units_per_row : 0;
    for (int u = lane; u < units; u += kFwdLanes) {
      const int rs = u / g.units_per_row;
      const int cu = u - rs * g.units_per_row;
      const int a = s + rs;          // output row
      const int b0 = col0 + cu * W;  // first output column of the unit
      if (b0 >= g.ow) continue;
      float acc[W][kVec];
#pragma unroll
      for (int o = 0; o < W; ++o) {
#pragma unroll
        for (int i2 = 0; i2 < kVec; ++i2) acc[o][i2] = 0.0f;
      }
      const int slot0 = (i * g.band_rows + a * S) % g.ring;  // x row a*S - P + di is in slot slot0 + di
      // One tap row at a time: unrolled, the compiler hoists every row's
      // shared-memory loads and spills under the register cap.
#pragma unroll 1
      for (int di = 0; di < K; ++di) {
        int slot = slot0 + di;
        slot -= slot >= g.ring ? g.ring : 0;
        const uint4* row = ring + (slot * g.tile_cols + cu * W * S) * kFwdTileVecs + v;
        float wf[K][kVec];
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
#pragma unroll
          for (int q = 0; q < kQuads; ++q) {
            const float4 f = wsm[((di * K + dj) * kQuads + q) * kFwdTileVecs + v];
            wf[dj][4 * q] = f.x;
            wf[dj][4 * q + 1] = f.y;
            wf[dj][4 * q + 2] = f.z;
            wf[dj][4 * q + 3] = f.w;
          }
        }
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
          float xf[kVec];
          V::unpack(xf, row[j * kFwdTileVecs]);
#pragma unroll
          for (int o = 0; o < W; ++o) {
            const int dj = j - S * o;  // decided at compile time
            if (dj < 0 || dj >= K) continue;
#pragma unroll
            for (int i2 = 0; i2 < kVec; ++i2) acc[o][i2] = fmaf(xf[i2], wf[dj][i2], acc[o][i2]);
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
          for (int i2 = 0; i2 < kVec; ++i2) {
            if (ch + i2 < g.c) out[i2] = from_float<T>(acc[o][i2]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- dw_temporal_fwd

constexpr int kTemporalThreads = 256;  // one channel vector of one column a thread

// The launch geometry of dw_temporal_fwd_walk (ops/dw_kernels.py temporal_launch_geometry).
struct TemporalGeometry {
  int t_len;    // frames
  int hw;       // pixels a frame
  int c;
  int cvecs;    // channel vectors a pixel: ceil(c / vec)
  int frame;    // elements a frame: hw * c
  int threads;  // b * hw * cvecs
  int vec;      // 1: 16-byte loads and stores; 0: element by element
};

template <typename T, int K, int F, bool VEC, bool BN>
__device__ __forceinline__ void temporal_fwd_column(const T* __restrict__ xc, const T* __restrict__ wc,
                                                    T* __restrict__ yc, const TemporalGeometry& g, int valid,
                                                    const EvalBn& bn, int ch) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kP = K / 2;
  float wf[K][kVec];
#pragma unroll
  for (int dt = 0; dt < K; ++dt) V::unpack(wf[dt], load_vec<T, VEC>(wc + dt * g.c, valid));
  [[maybe_unused]] float a[kVec], b[kVec];
  if constexpr (BN) eval_channels(a, b, bn, ch, valid);
  float win[K - 1][kVec];  // frames t-P .. t+P-1 of output frame t
  start_window<T, K, VEC>(win, xc, g.t_len, g.frame, valid);
  if constexpr (BN) {
#pragma unroll
    for (int j = 0; j < kP; ++j) {  // frames past the column stay 0
      if (j < g.t_len) V::unpack(win[kP + j], bn_silu_vec<T>(V::pack(win[kP + j]), a, b));
    }
  }
  for (int t0 = 0; t0 < g.t_len; t0 += F) {
    uint4 raw[F];  // frames t0+P .. t0+P+F-1, loaded together
#pragma unroll
    for (int j = 0; j < F; ++j) raw[j] = load_frame<T, VEC>(xc, t0 + kP + j, g.t_len, g.frame, valid);
#pragma unroll
    for (int o = 0; o < F; ++o) {
      if (t0 + o >= g.t_len) break;
      if constexpr (BN) {
        if (t0 + o + kP < g.t_len) raw[o] = bn_silu_vec<T>(raw[o], a, b);
      }
      float xn[kVec];
      V::unpack(xn, raw[o]);
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int dt = 0; dt < K - 1; ++dt) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(win[dt][i], wf[dt][i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(xn[i], wf[K - 1][i], acc[i]);
      store_vec<T, VEC>(yc + (t0 + o) * g.frame, acc, valid);
      slide_window<K>(win, xn);
    }
  }
}

// Thread id = (b * hw + pixel) * cvecs + channel vector. Registers are capped
// for 2 blocks an SM: 16 warps, each with F 16-byte loads in flight.
template <typename T, int K, int F, bool BN>
__global__ void __launch_bounds__(kTemporalThreads, 2)
dw_temporal_fwd_walk(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, const TemporalGeometry g,
                     const EvalBn bn) {
  constexpr int kVec = Vec16<T>::kN;
  const int id = blockIdx.x * kTemporalThreads + threadIdx.x;
  if (id >= g.threads) return;
  const int column = id / g.cvecs;
  const int ch = (id - column * g.cvecs) * kVec;
  const int b = column / g.hw;
  const int64_t base = static_cast<int64_t>(b) * g.t_len * g.frame +
                       static_cast<int64_t>(column - b * g.hw) * g.c + ch;
  const int valid = min(kVec, g.c - ch);
  if (g.vec) {
    temporal_fwd_column<T, K, F, true, BN>(x + base, w + ch, y + base, g, valid, bn, ch);
  } else {
    temporal_fwd_column<T, K, F, false, BN>(x + base, w + ch, y + base, g, valid, bn, ch);
  }
}

template <typename T, int K, int S, int W, bool BN>
int launch_spatial_fwd_kernel(const T* x, const T* w, T* y, const FwdGeometry& g, const EvalBn& bn, dim3 grid,
                              int smem, cudaStream_t stream) {
  auto* kernel = dw_spatial_fwd_kernel<T, K, S, W, BN>;
  if (smem > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<grid, kFwdThreads, smem, stream>>>(x, w, y, g, bn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, bool BN>
int dispatch_spatial_fwd(const T* x, const T* w, T* y, const FwdGeometry& g, const EvalBn& bn, int stride, int cols,
                         dim3 grid, int smem, cudaStream_t stream) {
  if (stride == 2) return launch_spatial_fwd_kernel<T, K, 2, 2, BN>(x, w, y, g, bn, grid, smem, stream);
  return cols == 4 ? launch_spatial_fwd_kernel<T, K, 1, 4, BN>(x, w, y, g, bn, grid, smem, stream)
                   : launch_spatial_fwd_kernel<T, K, 1, 2, BN>(x, w, y, g, bn, grid, smem, stream);
}

// band, col_tile, cols (W), frames, bands_per_block and smem_bytes come from
// the wrapper; the rest of the geometry follows from them here. BN: bn's
// prologue on x (dw_spatial_fwd_bn).
template <typename T, bool BN>
int launch_spatial(const void* x, const void* w, void* y, const EvalBn& bn, int64_t n, int64_t h, int64_t wd,
                   int64_t c, int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols,
                   int64_t frames, int64_t bands_per_block, int64_t smem_bytes, void* stream) {
  constexpr int kVec = Vec16<T>::kN;
  const bool cols_ok = stride == 1 ? (cols == 2 || cols == 4) : (stride == 2 && cols == 2);
  if ((k != 3 && k != 5) || !cols_ok || band < 1 || col_tile < 1 || col_tile % cols != 0 || frames < 1 ||
      bands_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pad = k / 2;
  FwdGeometry g;
  g.frame_in = h * wd * c;
  g.frame_out = ((h + 2 * pad - k) / stride + 1) * ((wd + 2 * pad - k) / stride + 1) * c;
  g.n = static_cast<int>(n);
  g.h = static_cast<int>(h);
  g.wd = static_cast<int>(wd);
  g.c = static_cast<int>(c);
  g.oh = static_cast<int>((h + 2 * pad - k) / stride + 1);
  g.ow = static_cast<int>((wd + 2 * pad - k) / stride + 1);
  if (frames > 1 && (band < g.oh || bands_per_block != 1)) return static_cast<int>(cudaErrorInvalidValue);
  g.band = static_cast<int>(band);
  g.col_tile = static_cast<int>(col_tile);
  g.frames = static_cast<int>(frames);
  g.bands_per_block = static_cast<int>(bands_per_block);
  const int64_t bands = (g.oh + band - 1) / band;
  g.groups = static_cast<int>((bands + bands_per_block - 1) / bands_per_block);
  const int64_t frame_rows = stride * (band - 1) + k;  // the x rows of one band
  g.band_rows = static_cast<int>(frames > 1 ? frame_rows : 0);
  g.units_per_row = static_cast<int>(col_tile / cols);
  // The ring holds a band and, if the block walks more than one, the next.
  const int64_t held = (frames > 1 ? frames : bands_per_block) > 1 ? 2 : 1;
  g.ring = static_cast<int>(frames > 1 ? held * frame_rows : stride * (held * band - 1) + k);
  g.tile_cols = static_cast<int>(stride * (col_tile - 1) + k);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec = c % kVec == 0 && aligned(x) && aligned(w) && aligned(y);
  // The ring, the weights and, with BN, the tile's a and b.
  const int64_t fixed_floats = (k * k + (BN ? 2 : 0)) * kFwdTileVecs * kVec;
  if (smem_bytes != static_cast<int64_t>(g.ring) * g.tile_cols * kFwdTileVecs * 16 + fixed_floats * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || h == 0 || wd == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const int64_t cvecs = (c + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned int>((n + frames - 1) / frames * g.groups),
                  static_cast<unsigned int>((cvecs + kFwdTileVecs - 1) / kFwdTileVecs),
                  static_cast<unsigned int>((g.ow + col_tile - 1) / col_tile));
  const auto* xp = static_cast<const T*>(x);
  const auto* wp = static_cast<const T*>(w);
  auto* yp = static_cast<T*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(smem_bytes);
  const int st = static_cast<int>(stride), cl = static_cast<int>(cols);
  return k == 3 ? dispatch_spatial_fwd<T, 3, BN>(xp, wp, yp, g, bn, st, cl, grid, smem, s)
                : dispatch_spatial_fwd<T, 5, BN>(xp, wp, yp, g, bn, st, cl, grid, smem, s);
}

// frame_tile comes from the wrapper; the rest of the geometry follows here.
// BN: bn's prologue on x (dw_temporal_fwd_bn).
template <typename T, bool BN>
int launch_temporal(const void* x, const void* w, void* y, const EvalBn& bn, int64_t batch, int64_t t_len,
                    int64_t hw, int64_t c, int64_t k, int64_t frame_tile, void* stream) {
  constexpr int kVec = Vec16<T>::kN;
  if ((k != 3 && k != 5) || frame_tile != kTemporalFrameTile) return static_cast<int>(cudaErrorInvalidValue);
  TemporalGeometry g;
  g.t_len = static_cast<int>(t_len);
  g.hw = static_cast<int>(hw);
  g.c = static_cast<int>(c);
  g.cvecs = static_cast<int>((c + kVec - 1) / kVec);
  g.frame = static_cast<int>(hw * c);
  g.threads = static_cast<int>(batch * hw * g.cvecs);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec = c % kVec == 0 && aligned(x) && aligned(w) && aligned(y);
  if (g.threads == 0 || t_len == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned int>((g.threads + kTemporalThreads - 1) / kTemporalThreads));
  const auto* xp = static_cast<const T*>(x);
  const auto* wp = static_cast<const T*>(w);
  auto* yp = static_cast<T*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k == 3) {
    dw_temporal_fwd_walk<T, 3, kTemporalFrameTile, BN><<<grid, kTemporalThreads, 0, s>>>(xp, wp, yp, g, bn);
  } else {
    dw_temporal_fwd_walk<T, 5, kTemporalFrameTile, BN><<<grid, kTemporalThreads, 0, s>>>(xp, wp, yp, g, bn);
  }
  return static_cast<int>(cudaGetLastError());
}

// The eval BN of the prologue entry points: fp32 (C,) vectors and eps.
EvalBn eval_bn(const void* mean, const void* var, const void* scale, const void* bias, double eps) {
  return EvalBn{static_cast<const float*>(mean), static_cast<const float*>(var), static_cast<const float*>(scale),
                static_cast<const float*>(bias), static_cast<float>(eps)};
}

}  // namespace

extern "C" {

int dw_spatial_fwd_f32(const void* x, const void* w, void* y, int64_t n, int64_t h, int64_t wd, int64_t c,
                       int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols, int64_t frames,
                       int64_t bands_per_block, int64_t smem_bytes, void* stream) {
  return launch_spatial<float, false>(x, w, y, EvalBn{}, n, h, wd, c, k, stride, band, col_tile, cols, frames,
                                      bands_per_block, smem_bytes, stream);
}

int dw_spatial_fwd_bf16(const void* x, const void* w, void* y, int64_t n, int64_t h, int64_t wd, int64_t c,
                        int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols, int64_t frames,
                        int64_t bands_per_block, int64_t smem_bytes, void* stream) {
  return launch_spatial<__nv_bfloat16, false>(x, w, y, EvalBn{}, n, h, wd, c, k, stride, band, col_tile, cols,
                                              frames, bands_per_block, smem_bytes, stream);
}

int dw_spatial_fwd_bn_f32(const void* x, const void* w, void* y, const void* mean, const void* var,
                          const void* scale, const void* bias, double eps, int64_t n, int64_t h, int64_t wd,
                          int64_t c, int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols,
                          int64_t frames, int64_t bands_per_block, int64_t smem_bytes, void* stream) {
  return launch_spatial<float, true>(x, w, y, eval_bn(mean, var, scale, bias, eps), n, h, wd, c, k, stride, band,
                                     col_tile, cols, frames, bands_per_block, smem_bytes, stream);
}

int dw_spatial_fwd_bn_bf16(const void* x, const void* w, void* y, const void* mean, const void* var,
                           const void* scale, const void* bias, double eps, int64_t n, int64_t h, int64_t wd,
                           int64_t c, int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols,
                           int64_t frames, int64_t bands_per_block, int64_t smem_bytes, void* stream) {
  return launch_spatial<__nv_bfloat16, true>(x, w, y, eval_bn(mean, var, scale, bias, eps), n, h, wd, c, k, stride,
                                             band, col_tile, cols, frames, bands_per_block, smem_bytes, stream);
}

int dw_temporal_fwd_f32(const void* x, const void* w, void* y, int64_t batch, int64_t t_len, int64_t hw,
                        int64_t c, int64_t k, int64_t frame_tile, void* stream) {
  return launch_temporal<float, false>(x, w, y, EvalBn{}, batch, t_len, hw, c, k, frame_tile, stream);
}

int dw_temporal_fwd_bf16(const void* x, const void* w, void* y, int64_t batch, int64_t t_len, int64_t hw,
                         int64_t c, int64_t k, int64_t frame_tile, void* stream) {
  return launch_temporal<__nv_bfloat16, false>(x, w, y, EvalBn{}, batch, t_len, hw, c, k, frame_tile, stream);
}

int dw_temporal_fwd_bn_f32(const void* x, const void* w, void* y, const void* mean, const void* var,
                           const void* scale, const void* bias, double eps, int64_t batch, int64_t t_len,
                           int64_t hw, int64_t c, int64_t k, int64_t frame_tile, void* stream) {
  return launch_temporal<float, true>(x, w, y, eval_bn(mean, var, scale, bias, eps), batch, t_len, hw, c, k,
                                      frame_tile, stream);
}

int dw_temporal_fwd_bn_bf16(const void* x, const void* w, void* y, const void* mean, const void* var,
                            const void* scale, const void* bias, double eps, int64_t batch, int64_t t_len,
                            int64_t hw, int64_t c, int64_t k, int64_t frame_tile, void* stream) {
  return launch_temporal<__nv_bfloat16, true>(x, w, y, eval_bn(mean, var, scale, bias, eps), batch, t_len, hw, c,
                                              k, frame_tile, stream);
}

}  // extern "C"
