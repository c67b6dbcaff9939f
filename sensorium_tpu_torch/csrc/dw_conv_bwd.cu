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
// dw_spatial_dw replaces _dw_spatial_grad_w of sensorium_tpu/ops/pallas_dw.py
// (_dw_spatial_dw_kernel and, at stride 2, _dw_spatial_dw_s2_kernel on parity
// planes):
//   dw[di,dj,c] = sum over n, oh, ow of x_pad[n, s*oh+di, s*ow+dj, c] * dy[n,oh,ow,c]
// in fp32, (k, k, C). Bound: bytes. It reads x and dy once (block 0 of a batch
// of 32 x 16 frames: 2.35 GB in bf16, >= 0.70 ms at 3.35 TB/s; the 9 blocks of
// a step >= 2.419 ms) and writes k*k*C floats; its k*k multiply-adds per dy
// element are far below the card's ridge point. The TPU grid carries the sum
// from frame to frame in VMEM; Hopper's blocks run in parallel and cannot, so
// it is two deterministic passes: dw_spatial_dw_kernel writes one partial sum
// per block into a fp32 workspace (slabs, k*k, C), and sum_slabs adds the
// slabs in a fixed order. No atomics, so reruns are bitwise equal.
// Design of dw_spatial_dw_kernel<T, K, S, W>:
//  - k, the stride and W (adjacent outputs of one row per unit of work: 4 or
//    2 at stride 1, 2 at stride 2) are template parameters, so the tap loops
//    unroll and no division or modulo is left in them.
//  - A thread owns one 16-byte vector of channels (8 bf16 or 4 fp32);
//    neighbouring threads own neighbouring vectors. A block owns a tile of 8
//    channel vectors, a tile of col_tile output columns and a run of
//    per_block consecutive (frame, band) items, a band being `band` output
//    rows of one frame. The runs cover all frames, and the grid is one wave
//    of 2 blocks per SM where the channel and column tiles leave room, so a
//    block walks many bands, small frames included, and writes one partial
//    sum at its end.
//  - For each band it stages the x rows the band reads, with their halo,
//    into a ring in shared memory with cp.async, zeros outside the frame, and
//    the band's dy rows beside them; the next band's rows are copied while
//    this band computes. The next band of the same frame adds S*band new x
//    rows; a new frame stages all S*(band-1)+K. So the tap loops carry no
//    bounds checks, and every x and dy element leaves L2 about once. The
//    staging costs instructions too: measured alone it took most of the
//    kernel's time at the small frames, where ring rows are narrower than the
//    lanes. So rows at least twice as wide as the lanes are staged row by row
//    (stage_x_rows of dw_vec.cuh, the forward's staging), narrower ones cell
//    by cell (stage_x_cells), dy likewise, with no division per cell.
//  - Registers decide the tiling of the taps. At k = 3 a thread keeps all 9
//    taps' accumulators (72 fp32 registers in bf16) and is capped at 128
//    registers, for 2 blocks of 256 threads an SM. At k = 5 that would be
//    200, so the lanes form 5 groups, one tap row each, that read the same
//    staged dy (240 threads).
//  - A unit is W adjacent outputs of one row. For each of its tap rows a
//    thread converts the unit's W dy vectors and the S*(W-1)+K x vectors they
//    meet, each x vector once, and adds x[S*o+dj] * dy[o] into the tap
//    (row, dj) accumulators; the pairs (o, dj) are fixed at compile time.
//  - At the end the block adds its position lanes in a fixed order through
//    shared memory and writes its slab. The tiling (band, column tile, W,
//    items per block, slabs, shared-memory bytes) comes from the wrapper
//    (ops/dw_kernels.py dw_launch_geometry); the launcher derives the grid
//    and refuses shared-memory bytes or a slab count that differ from its own.
//  - 32-bit offsets inside a frame, one 64-bit frame base. Where C is not a
//    multiple of the vector width (or a pointer is not 16-byte aligned) the
//    same kernel stages element by element.
// dw_temporal_dw replaces _dw_temporal_grad_w (_dw_temporal_dw_kernel):
//   dw[dt,c] = sum over b, t, hw of x_pad[b, t+dt, hw, c] * dy[b,t,hw,c]
// in fp32, (k, C). Bound: bytes. It reads x and dy once (blocks 0-3 of a batch
// of 32 x 16 frames: 0.94 GB in bf16, >= 0.28 ms at 3.35 TB/s; the 9 blocks of
// a step >= 1.683 ms) and writes k*C floats, with k multiply-adds per dy
// element. Two deterministic passes, as dw_spatial_dw: dw_temporal_dw_walk
// writes one partial sum per block into a fp32 workspace (slabs, k, C), and
// sum_slabs adds the slabs in a fixed order.
// Design of dw_temporal_dw_walk<T, K, F>, the forward's column walk
// (dw_conv.cu dw_temporal_fwd_walk) with sums in registers:
//  - A thread owns one 16-byte vector of channels (8 bf16 or 4 fp32); a block
//    owns 8 channel vectors and a run of per_block consecutive (b, hw)
//    columns, which its 32 column lanes take in turn (lane l: columns l,
//    l + 32, ...), so a warp reads 4 neighbouring pixels' 128 contiguous
//    bytes of a frame. The runs are as many as fill 2 blocks on every SM in
//    one wave beside the channel tiles.
//  - A thread walks each of its columns' T frames: it reads each x and each dy
//    vector once, keeps a register window of K x vectors in fp32 (frames
//    t-P .. t+P), and adds x[t+dt-P] * dy[t] into K vectors of fp32 sums in
//    registers (40 in bf16 at k = 5). Frames come in tiles of F whose 2F loads
//    are started together. Zeros enter the window before frame 0 and from frame
//    T on, so the tap loop has no bounds check; k is a template parameter.
//  - At the end the block adds its 32 column lanes in a fixed order through
//    shared memory and writes one slab of (K, 8 channel vectors). The tiling
//    (frame tile, columns per run, slabs, shared-memory bytes) comes from the
//    wrapper (ops/dw_kernels.py temporal_launch_geometry); the launcher
//    derives the grid and refuses a slab count or shared-memory bytes that
//    differ from its own.
//  - One 64-bit column base, 32-bit offsets along T. Where C is not a multiple
//    of the vector width (or a pointer is not 16-byte aligned) the same kernel
//    loads element by element.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing (the caller passes dx, the workspace and dw) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a kernel size it was not
// compiled for (spatial and temporal k = 3 or 5) or a geometry it refuses.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dw_vec.cuh"

namespace {

constexpr int kThreads = 256;  // sum_slabs

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

// ---------------------------------------------------------------- dw_spatial_dw

constexpr int kDwTileVecs = 8;  // channel vectors per block

// How dw_spatial_dw_kernel splits the taps: at k = 3 one thread holds all
// k*k accumulator vectors; at k = 5 each of 5 groups of lanes holds one tap row.
template <int K>
struct DwTaps {
  static constexpr int kGroups = K == 3 ? 1 : K;
  static constexpr int kRows = K / kGroups;    // tap rows per thread
  static constexpr int kLanes = 32 / kGroups;  // position lanes per group
  static constexpr int kThreads = kDwTileVecs * kGroups * kLanes;
};

// The launch geometry of dw_spatial_dw_kernel (ops/dw_kernels.py dw_launch_geometry).
struct DwGeometry {
  int64_t frame_in, frame_out;  // elements of an x and a dy frame
  int h, wd, c, oh, ow;
  int band;           // output rows per band
  int col_tile;       // output columns per block, a multiple of W
  int bands;          // bands per frame
  int items;          // (frame, band) items: n * bands
  int per_block;      // consecutive items walked by one block
  int frame_rows;     // x rows of one band: S*(band-1)+K
  int units_per_row;  // col_tile / W
  int ring;           // x rows held in the ring: 2 * frame_rows
  int tile_cols;      // x columns per ring row: S*(col_tile-1)+K
  int vec;            // 1: 16-byte copies; 0: element by element
};

// Block (run of items, channel tile, column tile); thread (channel vector v =
// tid % 8, then tap-row group and position lane). Item j of the block's run
// has its x rows at virtual rows vfirst(j) .. vfirst(j) + frame_rows - 1, in
// slot virtual % ring: the next band of the same frame starts S*band rows
// later, so the rows they share stay where they are, and a new frame starts
// frame_rows later. Its dy rows sit in dy slot j % 2. Shared memory: the ring
// [g.ring][g.tile_cols][8] and the dy slots [2][g.band][g.col_tile][8] of
// 16-byte vectors; at the end, the lanes' partial sums [lanes][K*K][8][kVec]
// floats over them.
template <typename T, int K, int S, int W>
__global__ void __launch_bounds__(DwTaps<K>::kThreads, 2)
dw_spatial_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ ws, const DwGeometry g) {
  using V = Vec16<T>;
  using Taps = DwTaps<K>;
  constexpr int kVec = V::kN;
  constexpr int kP = K / 2;
  constexpr int kWindow = S * (W - 1) + K;  // x columns a unit reads per tap row
  constexpr int kStageLanes = Taps::kThreads / kDwTileVecs;
  extern __shared__ uint4 smem[];
  uint4* ring = smem;
  uint4* dy_slots = smem + g.ring * g.tile_cols * kDwTileVecs;

  const int v = threadIdx.x % kDwTileVecs;
  const int stage_lane = threadIdx.x / kDwTileVecs;
  const int group = stage_lane / Taps::kLanes;
  const int lane = stage_lane - group * Taps::kLanes;
  const int cv0 = blockIdx.y * kDwTileVecs;
  const int ch = (cv0 + v) * kVec;
  const int col0 = blockIdx.z * g.col_tile;
  const int item0 = blockIdx.x * g.per_block;
  const int count = min(g.per_block, g.items - item0);

  // Item j's x rows that the ring does not hold yet (all of them when fresh:
  // the first item, or the first band of a frame), virtual row vfirst
  // first, and its dy rows into dy slot j % 2.
  auto stage = [&](int j, int vfirst, bool fresh) {
    const int item = item0 + j;
    const int f = item / g.bands;
    const int s = (item - f * g.bands) * g.band;
    const int r0 = s * S - kP;  // the band's first x row
    const T* xn = x + static_cast<int64_t>(f) * g.frame_in;
    // Ring rows at least twice as wide as the lanes row by row, narrower ones
    // cell by cell, so that no lane idles at the small frames.
    if (g.tile_cols >= 2 * kStageLanes) {
      stage_x_rows<T, kP, kDwTileVecs, kStageLanes>(ring, xn, g, fresh ? r0 : r0 + g.frame_rows - S * g.band,
                                                  r0 + g.frame_rows - 1, vfirst - s * S, col0 * S - kP, ch);
    } else {
      stage_x_cells<T, kP, kDwTileVecs, kStageLanes>(ring, xn, g, fresh ? r0 : r0 + g.frame_rows - S * g.band,
                                                   r0 + g.frame_rows - 1, vfirst - s * S, col0 * S - kP, ch);
    }
    const T* dyn = dy + static_cast<int64_t>(f) * g.frame_out;
    uint4* slot = dy_slots + (j & 1) * g.band * g.col_tile * kDwTileVecs + v;
    const int step_r = kStageLanes / g.col_tile;
    const int step_c = kStageLanes - step_r * g.col_tile;
    int rr = stage_lane / g.col_tile;
    int cc = stage_lane - rr * g.col_tile;
#pragma unroll 1
    for (; rr < g.band;) {
      const int a = s + rr;
      const int b = col0 + cc;
      const bool inside = a < g.oh && b < g.ow && ch < g.c;
      const T* src = inside ? dyn + (a * g.ow + b) * g.c + ch : dyn;
      uint4* dst = slot + (rr * g.col_tile + cc) * kDwTileVecs;
      if (g.vec) {
        cp_async16(dst, src, inside ? 16 : 0);
      } else {
        *dst = inside ? V::load(src, g.c - ch) : make_uint4(0u, 0u, 0u, 0u);
      }
      rr += step_r;
      cc += step_c;
      if (cc >= g.col_tile) {
        cc -= g.col_tile;
        ++rr;
      }
    }
  };

  float acc[Taps::kRows][K][kVec];
#pragma unroll
  for (int r = 0; r < Taps::kRows; ++r) {
#pragma unroll
    for (int dj = 0; dj < K; ++dj) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[r][dj][i] = 0.0f;
    }
  }
  // One cp.async group per item, empty past the last, so that waiting for
  // all but the newest group always means item j has landed.
  if (count > 0) stage(0, 0, true);
  cp_async_commit();
  int vfirst = 0;  // of item j
  for (int j = 0; j < count; ++j) {
    const int item = item0 + j;
    const int s = item % g.bands * g.band;
    int vnext = vfirst;
    if (j + 1 < count) {
      const bool fresh = (item + 1) % g.bands == 0;
      vnext += fresh ? g.frame_rows : S * g.band;
      stage(j + 1, vnext, fresh);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const int units = ch < g.c ? min(g.band, g.oh - s) * g.units_per_row : 0;
    const int vmod = vfirst % g.ring;
    const uint4* dy_band = dy_slots + (j & 1) * g.band * g.col_tile * kDwTileVecs + v;
    for (int u = lane; u < units; u += Taps::kLanes) {
      const int rs = u / g.units_per_row;
      const int cu = u - rs * g.units_per_row;
      if (col0 + cu * W >= g.ow) continue;
      const uint4* dyu = dy_band + (rs * g.col_tile + cu * W) * kDwTileVecs;
#pragma unroll
      for (int r = 0; r < Taps::kRows; ++r) {
        int slot = vmod + rs * S + group * Taps::kRows + r;  // x row s*S - P + rs*S + di
        slot -= slot >= g.ring ? g.ring : 0;
        const uint4* row = ring + (slot * g.tile_cols + cu * W * S) * kDwTileVecs + v;
        float xf[kWindow][kVec];
#pragma unroll
        for (int o = 0; o < W; ++o) {
          float d[kVec];
          V::unpack(d, dyu[o * kDwTileVecs]);
#pragma unroll
          for (int dj = 0; dj < K; ++dj) {
            const int col = S * o + dj;  // decided at compile time
            if (o == 0 || dj >= K - S) V::unpack(xf[col], row[col * kDwTileVecs]);  // its first use
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[r][dj][i] = fmaf(xf[col][i], d[i], acc[r][dj][i]);
          }
        }
      }
    }
    __syncthreads();
    vfirst = vnext;
  }

  // The lanes' partial sums, added in lane order.
  constexpr int kTapFloats = kDwTileVecs * kVec;  // floats of one tap of the channel tile
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < Taps::kRows; ++r) {
#pragma unroll
    for (int dj = 0; dj < K; ++dj) {
      float* dst = part + (lane * K * K + (group * Taps::kRows + r) * K + dj) * kTapFloats + v * kVec;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[i] = acc[r][dj][i];
    }
  }
  __syncthreads();
  const int64_t slab = blockIdx.x + static_cast<int64_t>(gridDim.x) * blockIdx.z;
  for (int e = threadIdx.x; e < K * K * kTapFloats; e += Taps::kThreads) {
    const int tap = e / kTapFloats;
    const int rest = e - tap * kTapFloats;
    const int chan = cv0 * kVec + rest;
    if (chan >= g.c) continue;
    float sum = 0.0f;
    for (int l = 0; l < Taps::kLanes; ++l) sum += part[(l * K * K + tap) * kTapFloats + rest];
    ws[(slab * K * K + tap) * g.c + chan] = sum;
  }
}

// ---------------------------------------------------------------- dw_temporal_dw

constexpr int kTdwTileVecs = 8;                      // channel vectors per block
constexpr int kTdwLanes = 32;                        // column lanes per block
constexpr int kTdwThreads = kTdwTileVecs * kTdwLanes;

// The launch geometry of dw_temporal_dw_walk (ops/dw_kernels.py temporal_launch_geometry).
struct TemporalDwGeometry {
  int t_len;      // frames
  int hw;         // pixels a frame
  int c;
  int frame;      // elements a frame: hw * c
  int columns;    // b * hw
  int per_block;  // consecutive columns of one block's run
  int vec;        // 1: 16-byte loads; 0: element by element
};

// Adds x[t+dt-P] * dy[t] over the T frames of one column into acc[dt].
template <typename T, int K, int F, bool VEC>
__device__ __forceinline__ void temporal_dw_column(float (&acc)[K][Vec16<T>::kN], const T* __restrict__ xc,
                                                   const T* __restrict__ dyc, const TemporalDwGeometry& g,
                                                   int valid) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kP = K / 2;
  float win[K - 1][kVec];  // x frames t-P .. t+P-1 of dy frame t
  start_window<T, K, VEC>(win, xc, g.t_len, g.frame, valid);
  for (int t0 = 0; t0 < g.t_len; t0 += F) {
    uint4 rx[F], rd[F];  // x frames t0+P .., dy frames t0 .., loaded together
#pragma unroll
    for (int j = 0; j < F; ++j) {
      rx[j] = load_frame<T, VEC>(xc, t0 + kP + j, g.t_len, g.frame, valid);
      rd[j] = load_frame<T, VEC>(dyc, t0 + j, g.t_len, g.frame, valid);
    }
#pragma unroll
    for (int o = 0; o < F; ++o) {
      if (t0 + o >= g.t_len) break;
      float xn[kVec], d[kVec];
      V::unpack(xn, rx[o]);
      V::unpack(d, rd[o]);
#pragma unroll
      for (int dt = 0; dt < K - 1; ++dt) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[dt][i] = fmaf(win[dt][i], d[i], acc[dt][i]);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[K - 1][i] = fmaf(xn[i], d[i], acc[K - 1][i]);
      slide_window<K>(win, xn);
    }
  }
}

// Block (run of columns, channel tile); thread (channel vector v = tid % 8,
// column lane tid / 8). Shared memory: the lanes' sums [32][K][8 * kVec]
// floats. Registers are capped for 2 blocks an SM.
template <typename T, int K, int F>
__global__ void __launch_bounds__(kTdwThreads, 2)
dw_temporal_dw_walk(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ ws,
                    const TemporalDwGeometry g) {
  constexpr int kVec = Vec16<T>::kN;
  constexpr int kTileFloats = kTdwTileVecs * kVec;  // floats of one tap of the channel tile
  extern __shared__ float part[];
  const int v = threadIdx.x % kTdwTileVecs;
  const int lane = threadIdx.x / kTdwTileVecs;
  const int ch = (blockIdx.y * kTdwTileVecs + v) * kVec;
  const int col0 = blockIdx.x * g.per_block;
  const int col_end = min(col0 + g.per_block, g.columns);

  float acc[K][kVec];
#pragma unroll
  for (int dt = 0; dt < K; ++dt) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[dt][i] = 0.0f;
  }
  if (ch < g.c) {
    const int valid = min(kVec, g.c - ch);
    for (int column = col0 + lane; column < col_end; column += kTdwLanes) {
      const int b = column / g.hw;
      const int64_t base = static_cast<int64_t>(b) * g.t_len * g.frame +
                           static_cast<int64_t>(column - b * g.hw) * g.c + ch;
      if (g.vec) {
        temporal_dw_column<T, K, F, true>(acc, x + base, dy + base, g, valid);
      } else {
        temporal_dw_column<T, K, F, false>(acc, x + base, dy + base, g, valid);
      }
    }
  }

  // The lanes' sums, added in lane order.
#pragma unroll
  for (int dt = 0; dt < K; ++dt) {
    float* dst = part + (lane * K + dt) * kTileFloats + v * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = acc[dt][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < K * kTileFloats; e += kTdwThreads) {
    const int dt = e / kTileFloats;
    const int rest = e - dt * kTileFloats;
    const int chan = blockIdx.y * kTileFloats + rest;
    if (chan >= g.c) continue;
    float sum = 0.0f;
    for (int l = 0; l < kTdwLanes; ++l) sum += part[(l * K + dt) * kTileFloats + rest];
    ws[(static_cast<int64_t>(blockIdx.x) * K + dt) * g.c + chan] = sum;
  }
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

template <typename T, int K, int S, int W>
int launch_spatial_dw_kernel(const T* x, const T* dy, float* ws, const DwGeometry& g, dim3 grid, int smem,
                             cudaStream_t stream) {
  auto* kernel = dw_spatial_dw_kernel<T, K, S, W>;
  if (smem > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<grid, DwTaps<K>::kThreads, smem, stream>>>(x, dy, ws, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int dispatch_spatial_dw(const T* x, const T* dy, float* ws, const DwGeometry& g, int stride, int cols, dim3 grid,
                        int smem, cudaStream_t stream) {
  if (stride == 2) return launch_spatial_dw_kernel<T, K, 2, 2>(x, dy, ws, g, grid, smem, stream);
  return cols == 4 ? launch_spatial_dw_kernel<T, K, 1, 4>(x, dy, ws, g, grid, smem, stream)
                   : launch_spatial_dw_kernel<T, K, 1, 2>(x, dy, ws, g, grid, smem, stream);
}

// band, col_tile, cols (W), per_block, slabs and smem_bytes come from the
// wrapper; the rest of the geometry follows from them here. The workspace
// holds slabs * k*k * c floats, dw k*k * c.
template <typename T>
int launch_spatial_dw(const void* x, const void* dy, void* ws, void* out, int64_t n, int64_t h, int64_t wd,
                      int64_t c, int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols,
                      int64_t per_block, int64_t slabs, int64_t smem_bytes, void* stream) {
  constexpr int kVec = Vec16<T>::kN;
  const bool cols_ok = stride == 1 ? (cols == 2 || cols == 4) : (stride == 2 && cols == 2);
  if ((k != 3 && k != 5) || !cols_ok || band < 1 || col_tile < 1 || col_tile % cols != 0 || per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pad = k / 2;
  const int64_t oh = (h + 2 * pad - k) / stride + 1, ow = (wd + 2 * pad - k) / stride + 1;
  DwGeometry g;
  g.frame_in = h * wd * c;
  g.frame_out = oh * ow * c;
  g.h = static_cast<int>(h);
  g.wd = static_cast<int>(wd);
  g.c = static_cast<int>(c);
  g.oh = static_cast<int>(oh);
  g.ow = static_cast<int>(ow);
  g.band = static_cast<int>(band);
  g.col_tile = static_cast<int>(col_tile);
  g.bands = static_cast<int>((oh + band - 1) / band);
  g.items = static_cast<int>(n * g.bands);
  g.per_block = static_cast<int>(per_block);
  g.frame_rows = static_cast<int>(stride * (band - 1) + k);
  g.units_per_row = static_cast<int>(col_tile / cols);
  g.ring = 2 * g.frame_rows;
  g.tile_cols = static_cast<int>(stride * (col_tile - 1) + k);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec = c % kVec == 0 && aligned(x) && aligned(dy);
  const int64_t lanes = k == 3 ? DwTaps<3>::kLanes : DwTaps<5>::kLanes;
  const int64_t ring_bytes = (static_cast<int64_t>(g.ring) * g.tile_cols + 2 * band * col_tile) * kDwTileVecs * 16;
  const int64_t part_bytes = lanes * k * k * kDwTileVecs * kVec * 4;
  if (smem_bytes != (ring_bytes > part_bytes ? ring_bytes : part_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int len = static_cast<int>(k * k * c);
  if (c == 0) return static_cast<int>(cudaGetLastError());
  if (n == 0 || h == 0 || wd == 0) {  // no products: dw is 0
    const cudaError_t status = cudaMemsetAsync(out, 0, static_cast<size_t>(len) * sizeof(float), s);
    return static_cast<int>(status != cudaSuccess ? status : cudaGetLastError());
  }
  const int64_t cvecs = (c + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned int>((g.items + per_block - 1) / per_block),
                  static_cast<unsigned int>((cvecs + kDwTileVecs - 1) / kDwTileVecs),
                  static_cast<unsigned int>((ow + col_tile - 1) / col_tile));
  if (slabs != static_cast<int64_t>(grid.x) * grid.z) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const T*>(x);
  const auto* dyp = static_cast<const T*>(dy);
  auto* wsp = static_cast<float*>(ws);
  const int smem = static_cast<int>(smem_bytes);
  const int st = static_cast<int>(stride), cl = static_cast<int>(cols);
  const int status = k == 3 ? dispatch_spatial_dw<T, 3>(xp, dyp, wsp, g, st, cl, grid, smem, s)
                            : dispatch_spatial_dw<T, 5>(xp, dyp, wsp, g, st, cl, grid, smem, s);
  if (status != 0) return status;
  return finish_reduction(wsp, static_cast<float*>(out), static_cast<int>(slabs), len, s);
}

// frame_tile, per_block, slabs and smem_bytes come from the wrapper; the rest
// of the geometry follows from them here. The workspace holds slabs * k * c
// floats, dw k * c.
template <typename T>
int launch_temporal_dw(const void* x, const void* dy, void* ws, void* out, int64_t batch, int64_t t_len,
                       int64_t hw, int64_t c, int64_t k, int64_t frame_tile, int64_t per_block, int64_t slabs,
                       int64_t smem_bytes, void* stream) {
  constexpr int kVec = Vec16<T>::kN;
  if ((k != 3 && k != 5) || frame_tile != kTemporalFrameTile || per_block < 1 ||
      smem_bytes != kTdwLanes * k * kTdwTileVecs * kVec * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int len = static_cast<int>(k * c);
  if (c == 0) return static_cast<int>(cudaGetLastError());
  if (batch == 0 || t_len == 0 || hw == 0) {  // no products: dw is 0
    const cudaError_t status = cudaMemsetAsync(out, 0, static_cast<size_t>(len) * sizeof(float), s);
    return static_cast<int>(status != cudaSuccess ? status : cudaGetLastError());
  }
  TemporalDwGeometry g;
  g.t_len = static_cast<int>(t_len);
  g.hw = static_cast<int>(hw);
  g.c = static_cast<int>(c);
  g.frame = static_cast<int>(hw * c);
  g.columns = static_cast<int>(batch * hw);
  g.per_block = static_cast<int>(per_block);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec = c % kVec == 0 && aligned(x) && aligned(dy);
  const int64_t runs = (g.columns + per_block - 1) / per_block;
  if (slabs != runs) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cvecs = (c + kVec - 1) / kVec;
  const dim3 grid(static_cast<unsigned int>(runs), static_cast<unsigned int>((cvecs + kTdwTileVecs - 1) / kTdwTileVecs));
  const auto* xp = static_cast<const T*>(x);
  const auto* dyp = static_cast<const T*>(dy);
  auto* wsp = static_cast<float*>(ws);
  const int smem = static_cast<int>(smem_bytes);
  if (k == 3) {
    dw_temporal_dw_walk<T, 3, kTemporalFrameTile><<<grid, kTdwThreads, smem, s>>>(xp, dyp, wsp, g);
  } else {
    dw_temporal_dw_walk<T, 5, kTemporalFrameTile><<<grid, kTdwThreads, smem, s>>>(xp, dyp, wsp, g);
  }
  return finish_reduction(wsp, static_cast<float*>(out), static_cast<int>(slabs), len, s);
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
                      int64_t c, int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols,
                      int64_t per_block, int64_t slabs, int64_t smem_bytes, void* stream) {
  return launch_spatial_dw<float>(x, dy, ws, out, n, h, wd, c, k, stride, band, col_tile, cols, per_block, slabs,
                                  smem_bytes, stream);
}

int dw_spatial_dw_bf16(const void* x, const void* dy, void* ws, void* out, int64_t n, int64_t h, int64_t wd,
                       int64_t c, int64_t k, int64_t stride, int64_t band, int64_t col_tile, int64_t cols,
                       int64_t per_block, int64_t slabs, int64_t smem_bytes, void* stream) {
  return launch_spatial_dw<__nv_bfloat16>(x, dy, ws, out, n, h, wd, c, k, stride, band, col_tile, cols, per_block,
                                          slabs, smem_bytes, stream);
}

int dw_temporal_dw_f32(const void* x, const void* dy, void* ws, void* out, int64_t batch, int64_t t_len,
                       int64_t hw, int64_t c, int64_t k, int64_t frame_tile, int64_t per_block, int64_t slabs,
                       int64_t smem_bytes, void* stream) {
  return launch_temporal_dw<float>(x, dy, ws, out, batch, t_len, hw, c, k, frame_tile, per_block, slabs,
                                   smem_bytes, stream);
}

int dw_temporal_dw_bf16(const void* x, const void* dy, void* ws, void* out, int64_t batch, int64_t t_len,
                        int64_t hw, int64_t c, int64_t k, int64_t frame_tile, int64_t per_block, int64_t slabs,
                        int64_t smem_bytes, void* stream) {
  return launch_temporal_dw<__nv_bfloat16>(x, dy, ws, out, batch, t_len, hw, c, k, frame_tile, per_block,
                                           slabs, smem_bytes, stream);
}

}  // extern "C"
