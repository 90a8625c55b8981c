// remap_tile.cuh — what the remap kernels that stage their inputs in shared
// memory share: K12 (remap_k12.cu), K1 and K2 (remap_k1k2.cu).
//
//  * cp.async copies from device to shared memory, and stage_row, which
//    copies one category row of mm and tm on a tile plus a halo;
//  * TileSrc, the source of recon::reconstruct read from such a tile;
//  * the padded rows of the 90 geometric accumulators of a cell (GSH at its
//    donors for K12, GA at the cell for K2: the same values, GSH[off](c +
//    off) = GA[off](c)) and their 16-byte loads;
//  * contract_cell, the contraction of one cell of one row against them,
//    so that its formula exists once in CUDA;
//  * plan_tile, the host code that picks a kernel's tile.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_recon.cuh"

namespace tiled {

using recon::Args;
using recon::nb_of;
using recon::off_of;

constexpr int kTileW = 32;        // cells along i of a tile (one warp)
constexpr int kMaxTileRows = 8;
constexpr int kSplit = 2;         // threads per cell in the contraction
// a cell's accumulators, offset o's 10 at o * 12: 16-byte aligned vectors,
// and a row of 108 elements keeps a quarter-warp's 16-byte loads on
// distinct banks
constexpr int kGshOff = 12;
constexpr int kGshRow = 9 * kGshOff;
constexpr int kMaxSmem = 232448;  // bytes a block may use on Hopper

// an asynchronous copy of one element from device to shared memory
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the 12 elements from p (16-byte aligned) in 16-byte loads
__device__ __forceinline__ void load_vec(const float* p, float (&g)[kGshOff]) {
#pragma unroll
  for (int k = 0; k < kGshOff; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    g[k] = v.x;
    g[k + 1] = v.y;
    g[k + 2] = v.z;
    g[k + 3] = v.w;
  }
}

__device__ __forceinline__ void load_vec(const double* p,
                                         double (&g)[kGshOff]) {
#pragma unroll
  for (int k = 0; k < kGshOff; k += 2) {
    const double2 v = *reinterpret_cast<const double2*>(p + k);
    g[k] = v.x;
    g[k + 1] = v.y;
  }
}

// start copying row r's mm (and tm, when it carries tracers) on the tile at
// (j0, i0) plus a `halo`-cell halo into `in`, plane after plane of w x
// (rows + 2 halo) cells; a cell beyond an open edge stages 0
template <typename T>
__device__ __forceinline__ void stage_row(T* in, const T* mm, const T* tm,
                                          int r, int w, int plane, int halo,
                                          int j0, int i0, int tid,
                                          int nthreads, const Args& a) {
  const int64_t np = (int64_t)a.ny * a.nx;
  const int planes = r > 0 ? 1 + a.T : 1;
  for (int k = tid; k < plane; k += nthreads) {
    const int64_t x = a.idx(j0 - halo + k / w, i0 - halo + k % w);
    for (int q = 0; q < planes; ++q) {
      T* dst = in + q * plane + k;
      if (x < 0) {
        *dst = T(0);
      } else {
        copy_async(dst, q == 0 ? mm + r * np + x
                               : tm + ((int64_t)r * a.T + q - 1) * np + x);
      }
    }
  }
  commit_copies();
}

// the staged inputs of one cell (p, its index in planes of width w): hm,
// then the row's mass plane `in` and its tracer planes after it
template <typename T>
struct TileSrc {
  const T* hm_;
  const T* in;
  int w, plane, p;
  __device__ __forceinline__ T at(const T* f, int n) const {
    return n == 8 ? f[p] : f[p + nb_of(n, 1) * w + nb_of(n, 0)];
  }
  __device__ __forceinline__ T hm(int n) const { return at(hm_, n); }
  __device__ __forceinline__ T mass(int n) const { return at(in, n); }
  __device__ __forceinline__ T tracer(int t, int n) const {
    return at(in + (1 + t) * plane, n);
  }
};

// The deepest of the tiles of 8, 4, 2 and 1 rows of 32 cells whose shared
// memory (bytes(rows)) fits a block, the fewest halo cells staged twice: its
// rows, bytes a block and, unless blocks_per_sm is null (a launch), the
// blocks the runtime keeps resident on an SM, with `kernel` allowed that
// many bytes.  -1 when no tile fits.
template <class Kernel, class Bytes>
int plan_tile(Kernel kernel, int threads_per_row, Bytes bytes, int* rows,
              int* smem, int* blocks_per_sm) {
  for (int r = kMaxTileRows; r >= 1; r /= 2) {
    const size_t s = bytes(r);
    if (s > (size_t)kMaxSmem) continue;
    *rows = r;
    *smem = static_cast<int>(s);
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem));
    if (rc != 0 || blocks_per_sm == nullptr) return rc;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, threads_per_row * r, s));
  }
  return -1;
}

// Row r's divergences at the owned cell c by one of its kSplit threads: the
// mass (h = 0) and the tracers t = h, h + 2, ....  gc: the cell's
// accumulator row; rec: the row's reconstruction on the tile plus a 1-cell
// halo, planes of width w (mc, mx, my, then tc[T], tx[T], ty[T]), the cell
// at `base`; valid: bit o set where offset o's donor lies inside the grid.
// flip_north (MAY_FLIP, K12 on a tripole grid; a cell of its top row): the
// row above the cell holds the ghost row, the mirror cells in reversed
// order, so the donor (di, 1) lies at column -di of it.
// The tracers are looped at run time and the 9 offsets unrolled inside, so
// each sum is one register that adds its 9 offset terms, which overlap, in
// ALL_OFFSETS order, with the plain version's products in its order; a
// donor beyond an open or closed edge is skipped (the masked shift).
// Without tracers (open water) the tracer divergences are 0.  Type-1
// tracers take the polynomial of m*t without its terms that are exactly 0
// (parent planes (1, 0, 0)).
template <bool MAY_FLIP, typename T>
__device__ __forceinline__ void contract_cell(
    const T* gc, const T* rec, int P, int w, int base, unsigned valid,
    bool flip_north, int h, bool tracers, const Args& a, const int* parent,
    T* div, T* divt, int r, int64_t np, int64_t c) {
  // the donor of offset o in the reconstruction planes
  auto donor = [&](int o) {
    const int dj = off_of(o, 1), di = off_of(o, 0);
    return base + dj * w + (MAY_FLIP && flip_north && dj == 1 ? -di : di);
  };
  if (h == 0) {
    T d = T(0);
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      T g[kGshOff];
      load_vec(gc + o * kGshOff, g);
      const int x = donor(o);
      const T mc = rec[x], mx = rec[P + x], my = rec[2 * P + x];
      const T sum = d + (g[0] * mc + g[1] * mx + g[2] * my);
      d = ((valid >> o) & 1u) ? sum : d;  // the masked shift brings 0
    }
    div[r * np + c] = d;
  }
  if (!tracers) {
    for (int t = h; t < a.T; t += kSplit)
      divt[((int64_t)r * a.T + t) * np + c] = T(0);
    return;
  }
  const T* rc = rec + 3 * P;
  const T* rx = rc + a.T * P;
  const T* ry = rx + a.T * P;
  for (int t = h; t < a.T; t += kSplit) {
    T acc = T(0);
    if (t < a.n1) {
#pragma unroll
      for (int o = 0; o < 9; ++o) {
        T g[kGshOff];
        load_vec(gc + o * kGshOff, g);
        const int x = donor(o);
        const T mc = rec[x], mx = rec[P + x], my = rec[2 * P + x];
        const T c1 = rc[t * P + x], x1 = rx[t * P + x], y1 = ry[t * P + x];
        const T p1 = g[0] * (mc * c1) + g[1] * (mc * x1 + mx * c1) +
                     g[2] * (mc * y1 + my * c1) + g[3] * (mx * x1) +
                     g[4] * (mx * y1 + my * x1) + g[5] * (my * y1);
        const T sum = acc + p1;
        acc = ((valid >> o) & 1u) ? sum : acc;
      }
    } else {
      const int p = parent[t];
#pragma unroll
      for (int o = 0; o < 9; ++o) {
        T g[kGshOff];
        load_vec(gc + o * kGshOff, g);
        const int x = donor(o);
        const T mc = rec[x], mx = rec[P + x], my = rec[2 * P + x];
        const T pc = rc[p * P + x], px = rx[p * P + x], py = ry[p * P + x];
        const T c2 = rc[t * P + x], x2 = rx[t * P + x], y2 = ry[t * P + x];
        const T mpc = mc * pc, mpx = mc * px, mpy = mc * py;
        const T xpc = mx * pc, xpx = mx * px, xpy = mx * py;
        const T ypc = my * pc, ypx = my * px, ypy = my * py;
        const T p2 = g[0] * (mpc * c2) +
                     g[1] * (xpc * c2 + mpx * c2 + mpc * x2) +
                     g[2] * (ypc * c2 + mpy * c2 + mpc * y2) +
                     g[3] * (xpx * c2 + xpc * x2 + mpx * x2) +
                     g[4] * (xpy * c2 + ypx * c2 + xpc * y2 + ypc * x2 +
                             mpx * y2 + mpy * x2) +
                     g[5] * (ypy * c2 + ypc * y2 + mpy * y2) +
                     g[6] * (xpx * x2) +
                     g[7] * (xpx * y2 + xpy * x2 + ypx * x2) +
                     g[8] * (xpy * y2 + ypx * y2 + ypy * x2) +
                     g[9] * (ypy * y2);
        const T sum = acc + p2;
        acc = ((valid >> o) & 1u) ? sum : acc;
      }
    }
    divt[((int64_t)r * a.T + t) * np + c] = acc;
  }
}

}  // namespace tiled
