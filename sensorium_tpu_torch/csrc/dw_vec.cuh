// Device helpers shared by dw_conv.cu, dw_conv_bwd.cu and fused_bn_silu_dw.cu:
// a scalar conversion, 16-byte channel vectors, asynchronous copies from
// global to shared memory (cp.async), the staging of x rows with their halo
// into a ring in shared memory that dw_spatial_fwd and dw_spatial_dw share,
// the in-frame predicate of a staged x element, and the column walk of the
// temporal kernels (dw_temporal_fwd and dw_temporal_dw). Each source
// includes this header into its own library, so everything here is internal
// to the including file.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One 16-byte vector of channels: 8 bf16 or 4 fp32, as 4 32-bit words.
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int kN = 4;
  // The first `valid` elements at p, zeros after them.
  static __device__ __forceinline__ uint4 load(const float* p, int valid) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = i < valid ? __float_as_uint(p[i]) : 0u;
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
  static __device__ __forceinline__ void unpack(float (&f)[4], uint4 a) {
    f[0] = __uint_as_float(a.x);
    f[1] = __uint_as_float(a.y);
    f[2] = __uint_as_float(a.z);
    f[3] = __uint_as_float(a.w);
  }
  static __device__ __forceinline__ void fma(float (&acc)[4], uint4 a, uint4 b) {
    acc[0] = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc[0]);
    acc[1] = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc[1]);
    acc[2] = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc[2]);
    acc[3] = fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc[3]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&acc)[4]) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]), __float_as_uint(acc[2]),
                      __float_as_uint(acc[3]));
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ uint4 load(const __nv_bfloat16* p, int valid) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < valid ? __bfloat16_as_ushort(p[2 * i]) : 0u;
      const uint32_t hi = 2 * i + 1 < valid ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
      u[i] = lo | (hi << 16);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
  // Element 2i is the low half of word i, 2i+1 the high half; a bf16 is the
  // high half of the fp32 of the same value.
  static __device__ __forceinline__ void unpack2(float& e0, float& e1, uint32_t a) {
    e0 = __uint_as_float(a << 16);
    e1 = __uint_as_float(a & 0xffff0000u);
  }
  static __device__ __forceinline__ void unpack(float (&f)[8], uint4 a) {
    unpack2(f[0], f[1], a.x);
    unpack2(f[2], f[3], a.y);
    unpack2(f[4], f[5], a.z);
    unpack2(f[6], f[7], a.w);
  }
  static __device__ __forceinline__ void fma2(float& e0, float& e1, uint32_t a, uint32_t b) {
    e0 = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), e0);
    e1 = fmaf(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u), e1);
  }
  static __device__ __forceinline__ void fma(float (&acc)[8], uint4 a, uint4 b) {
    fma2(acc[0], acc[1], a.x, b.x);
    fma2(acc[2], acc[3], a.y, b.y);
    fma2(acc[4], acc[5], a.z, b.z);
    fma2(acc[6], acc[7], a.w, b.w);
  }
  static __device__ __forceinline__ uint32_t pack2(float e0, float e1) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(e0))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(e1))) << 16);
  }
  static __device__ __forceinline__ uint4 pack(const float (&acc)[8]) {
    return make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]), pack2(acc[4], acc[5]), pack2(acc[6], acc[7]));
  }
};

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// x rows [r_begin, r_end] of frame xn, columns xcol0 .. xcol0 + g.tile_cols - 1,
// the channel vector from channel ch, into their ring slots: row r in slot
// (base + r + P) % g.ring of [g.ring][g.tile_cols][kVecs] 16-byte vectors;
// zeros outside x (rows, columns and channels), which is the zero padding.
// Thread tid copies channel vector tid % kVecs of the columns tid / kVecs,
// tid / kVecs + kLanes, ... The loops stay rolled: unrolled, their addresses
// take registers that the callers' tap loops need. Geo has the frame's h, wd
// and c, the ring's rows and columns, and vec (1: 16-byte cp.async copies;
// 0: element by element, for channel tails and unaligned pointers).
template <typename T, int P, int kVecs, int kLanes, typename Geo>
__device__ __forceinline__ void stage_x_rows(uint4* __restrict__ ring, const T* __restrict__ xn, const Geo& g,
                                             int r_begin, int r_end, int base, int xcol0, int ch) {
  const int v = threadIdx.x % kVecs;
  const int lane = threadIdx.x / kVecs;
#pragma unroll 1
  for (int r = r_begin; r <= r_end; ++r) {
    const bool row_inside = r >= 0 && r < g.h && ch < g.c;
    uint4* dst_row = ring + ((base + r + P) % g.ring) * g.tile_cols * kVecs + v;
    const T* src_row = xn + (row_inside ? r * g.wd * g.c + ch : 0);
#pragma unroll 1
    for (int cc = lane; cc < g.tile_cols; cc += kLanes) {
      const int col = xcol0 + cc;
      const bool inside = row_inside && col >= 0 && col < g.wd;
      const T* src = inside ? src_row + col * g.c : xn;
      uint4* dst = dst_row + cc * kVecs;
      if (g.vec) {
        cp_async16(dst, src, inside ? 16 : 0);
      } else {
        *dst = inside ? Vec16<T>::load(src, g.c - ch) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

}  // namespace

// Whether x element (row r, column col) of the channel vector from channel ch
// lies in the frame; everything else is the zero padding.
template <typename Geo>
__device__ __forceinline__ bool x_inside(const Geo& g, int r, int col, int ch) {
  return ch < g.c && r >= 0 && r < g.h && col >= 0 && col < g.wd;
}

// The (row, column) cells of x rows [r_begin, r_end], ring columns 0 ..
// g.tile_cols - 1, dealt to the lanes in turn, row-major: fn(r, cc, slot) for
// each of this lane's, with slot the row's ring slot ((base + r + P) %
// g.ring). Each lane steps its row, column and slot on without a division.
template <int P, int kLanes, typename Geo, typename Fn>
__device__ __forceinline__ void deal_cells(const Geo& g, int lane, int r_begin, int r_end, int base, Fn&& fn) {
  const int step_r = kLanes / g.tile_cols;
  const int step_c = kLanes - step_r * g.tile_cols;
  int rr = lane / g.tile_cols;
  int cc = lane - rr * g.tile_cols;
  int slot = (base + r_begin + P) % g.ring + rr;
  slot -= slot >= g.ring ? g.ring : 0;
#pragma unroll 1
  for (int r = r_begin + rr; r <= r_end;) {
    fn(r, cc, slot);
    r += step_r;
    slot += step_r;
    cc += step_c;
    if (cc >= g.tile_cols) {
      cc -= g.tile_cols;
      ++r;
      ++slot;
    }
    while (slot >= g.ring) slot -= g.ring;
  }
}

// stage_x_rows with the cells of all rows dealt to the lanes in turn
// (deal_cells), so that no lane idles where a ring row is narrower than the
// lanes (the small frames) and none takes two cells of a row where the others
// take one.
template <typename T, int P, int kVecs, int kLanes, typename Geo>
__device__ __forceinline__ void stage_x_cells(uint4* __restrict__ ring, const T* __restrict__ xn, const Geo& g,
                                              int r_begin, int r_end, int base, int xcol0, int ch) {
  const int v = threadIdx.x % kVecs;
  deal_cells<P, kLanes>(g, threadIdx.x / kVecs, r_begin, r_end, base, [&](int r, int cc, int slot) {
    const int col = xcol0 + cc;
    const bool inside = x_inside(g, r, col, ch);
    const T* src = inside ? xn + (r * g.wd + col) * g.c + ch : xn;
    uint4* dst = ring + (slot * g.tile_cols + cc) * kVecs + v;
    if (g.vec) {
      cp_async16(dst, src, inside ? 16 : 0);
    } else {
      *dst = inside ? Vec16<T>::load(src, g.c - ch) : make_uint4(0u, 0u, 0u, 0u);
    }
  });
}

namespace {

// ------------------------------------------------------ temporal column walk
// The temporal kernels walk columns: a thread owns one channel vector of one
// (b, hw) column of a (B, T, HW, C) tensor and reads the column's T frames,
// `frame` = HW*C elements apart, from a pointer to its frame 0. VEC: 16-byte
// loads and stores; otherwise element by element, the first `valid` channels
// (a channel tail, or a pointer that is not 16-byte aligned). A walk takes
// its frames in tiles of kTemporalFrameTile, whose loads it starts together.

constexpr int kTemporalFrameTile = 4;

template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ p, int valid) {
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    return Vec16<T>::load(p, valid);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&f)[Vec16<T>::kN], int valid) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(p) = Vec16<T>::pack(f);
  } else {
#pragma unroll
    for (int i = 0; i < Vec16<T>::kN; ++i) {
      if (i < valid) p[i] = from_float<T>(f[i]);
    }
  }
}

// Frame t >= 0 of a column, zeros from frame t_len on: the zero padding at
// the column's far end.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_frame(const T* __restrict__ col, int t, int t_len, int frame, int valid) {
  return t < t_len ? load_vec<T, VEC>(col + t * frame, valid) : make_uint4(0u, 0u, 0u, 0u);
}

// The window a walk starts with: frames -P .. P-1 of the column in fp32
// (P = K/2), zeros before frame 0, which is the zero padding at the near end.
// Frame t's output then reads the window and frame t + P.
template <typename T, int K, bool VEC>
__device__ __forceinline__ void start_window(float (&win)[K - 1][Vec16<T>::kN], const T* __restrict__ col,
                                             int t_len, int frame, int valid) {
  constexpr int kP = K / 2;
  uint4 raw[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) raw[j] = load_frame<T, VEC>(col, j, t_len, frame, valid);
#pragma unroll
  for (int j = 0; j < kP; ++j) {
#pragma unroll
    for (int i = 0; i < Vec16<T>::kN; ++i) win[j][i] = 0.0f;
    Vec16<T>::unpack(win[kP + j], raw[j]);
  }
}

// Slides the window one frame on: frame t + P (in fp32) enters it.
template <int K, int N>
__device__ __forceinline__ void slide_window(float (&win)[K - 1][N], const float (&entering)[N]) {
#pragma unroll
  for (int j = 0; j + 1 < K - 1; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) win[j][i] = win[j + 1][i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) win[K - 2][i] = entering[i];
}

}  // namespace
