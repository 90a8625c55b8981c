// remap_k12.cu — van-Leer reconstruction and GA contraction of incremental
// remapping (the flux divergences of every category) on Hopper.
//
// Replaces the TPU kernel K12, cice4_tpu/ops/remap_pallas.py::_k12_kernel
// (:157-209; host code k12_divergence :212-248).  It computes what the plain
// version cice4_tpu_torch/ops/remap_cuda.py::k12_plain computes for every
// category row r of the extended batch (row 0 is open water, mass only):
// the van-Leer-limited reconstruction (mc, mx, my) of the mass and (tc, tx,
// ty) of each tracer (_construct_vmem, _grad_stream), contracted against the
// geometric accumulators GSH into
//   div(c)  = sum_off [g0 mc + g1 mx + g2 my](c + off),
//   divt(c) = sum_off [sum_k g_k U_k](c + off)            (_flux_divergence_ga)
// with GSH[off] and the reconstruction read at the donor cell c + off, and
// U_k the monomial coefficients of m*t (type-1 tracers) or m*t_parent*t
// (type-2 tracers).
//
// Design: one launch, no scratch tensor.  A block owns a tile of 32 x
// rows cells, two threads a cell, and keeps everything between the
// inputs and its outputs in shared memory:
//  * once per block, the 90 GSH values of each owned cell at its 9 donors
//    (each GSH plane read once per block, as the TPU's constant VMEM block),
//    a 108-element row per cell, and hm on the tile plus a 2-cell halo;
//  * per row r: mm[r] and tm[r] on the tile plus a 2-cell halo, copied with
//    cp.async into one of two buffers while the block works on row r - 1;
//    the reconstruction of the tile plus a 1-cell halo (recon::reconstruct,
//    the device code K1 shares), one cell a thread, into shared memory,
//    3 + 3T values a cell; after __syncthreads() the two threads of each
//    cell contract it from shared memory, one the mass and the even
//    tracers, the other the odd ones, and write div and divt
//    (tiled::contract_cell, remap_tile.cuh, the device code K2 shares).
// The contraction loops over a thread's tracers at run time and unrolls the
// 9 offsets inside, so one register accumulates a (row, tracer) sum and the
// 9 offset terms, which are independent, overlap; each accumulator adds its
// terms in remap.ALL_OFFSETS order (a donor beyond an open or closed edge
// is skipped: the masked shift), with the plain version's products in its
// order, and the source is built with -fmad=false, so sums and products
// round as in eager PyTorch.  Cyclic edges wrap, also when staging.  The
// halo cells are reconstructed by the neighbouring tiles again (a third
// more reconstruction at 32 x 8).
//
// The tile is 32 x rows cells, rows the largest of 8, 4, 2, 1 whose shared
// memory (Layout below) fits a block (plan): at gx1 (T = 9, n1 = 3) 8 rows
// and 206,112 bytes in f32, 4 rows in f64; one block, 16 warps, per SM.
//
// The tripole and tripoleT folds (the JAX package's XLA GA path,
// cice4_tpu/ops/remap.py:1139-1174, shifts p = GSH . U by +off, x then y):
// from the top row a donor (di, 1) lies across the fold, at the mirror cell
// (src, (nx-1-i) + di), src = ny-1 (tripole) or ny-2 (tripoleT), with that
// cell's GSH and its own reconstruction, copied as scalars, as the plain
// version does.  So, under a fold:
//  * the staged GSH of such a donor and its `valid` bit follow that index
//    (recon::Shape::nb_idx);
//  * the top row's own reconstruction reads its north neighbours across
//    the fold, and the row above it in the reconstruction tile holds the
//    ghost row: the mirror cells' reconstructions, in reversed order, each
//    from its own neighbourhood (reconstructing the halo from the staged
//    halo would give another value, since the fold swaps east and west);
//    both are computed from device memory (FoldSrc), by the tiles that
//    hold the top row in their tile or halo;
//  * the top row's contraction reads the donor (di, 1) at column -di of
//    the ghost row (tiled::contract_cell's flip_north).
//
// What bounds it on an H100: not bytes.  Per call it must read GSH (90
// planes), hm, mm (C planes) and tm (C*T planes) and write div and divt
// (C*(1+T) planes), ~104 MB at gx1 f32 (C = 6, T = 9), 0.031 ms; the
// reconstruction and contraction need 3.6 G operations, 0.053 ms at 67
// TFLOP/s, and without FMA (-fmad=false) each is an instruction of its own,
// issued by 16 warps an SM, which the shared memory of a block allows.

// C interface: remap_k12_f32 / remap_k12_f64 (gsh, hm, mm, tm, div, divt, C,
// T, n1, ny, nx, ew, ns, parent, stream); ew/ns 0 = cyclic, 1 = open or
// closed, ns 2 = tripole, 3 = tripoleT (with ny >= ns); parent[T] the
// parent row of each type-2 tracer.  They return the launch's error code
// (-1 for a tracer table or boundary code they do not take).
// remap_k12_tile_f32 / _f64 (T, n1, rows, smem, blocks_per_sm) give the
// tile such a call launches with and the blocks the runtime keeps on an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_tile.cuh"

namespace {

using recon::Args;
using recon::kMaxT;
using recon::off_of;
using tiled::copies_landed;
using tiled::copy_async;
using tiled::kGshOff;
using tiled::kGshRow;
using tiled::kMaxTileRows;
using tiled::kSplit;
using tiled::kTileW;
using tiled::stage_row;
using tiled::TileSrc;

// the shared-memory layout of a block, in elements
struct Layout {
  int tn;              // owned cells, 32 x rows
  int nthreads;        // kSplit x tn
  int w2, plane2;      // the reconstruction's tile plus a 1-cell halo
  int w4, plane4;      // the staged inputs' tile plus a 2-cell halo
  int gsh, rec, in, hm, cent;  // offsets of the arrays
  int total;
  __host__ __device__ Layout(int rows, int Tn, int n1) {
    tn = kTileW * rows;
    nthreads = kSplit * tn;
    w2 = kTileW + 2;
    plane2 = w2 * (rows + 2);
    w4 = kTileW + 4;
    plane4 = w4 * (rows + 4);
    gsh = 0;                           // tn x kGshRow: GSH at the donors
    rec = gsh + kGshRow * tn;          // (3 + 3T) x plane2: mc mx my tc tx ty
    in = rec + (3 + 3 * Tn) * plane2;  // 2 x (1 + T) x plane4: mm, tm[T]
    hm = in + 2 * (1 + Tn) * plane4;   // plane4
    cent = hm + plane4;                // 3 n1 x nthreads: type-1 centroids
    total = cent + 3 * n1 * nthreads;
  }
};

// the reconstruction of one cell (p, its index in the plane2 arrays):
// mc, mx, my, then tc[T], tx[T], ty[T]
template <typename T>
struct TileDst {
  T* rec;
  int plane, p, ntr;
  __device__ __forceinline__ void mass(int q, T v) const {
    rec[q * plane + p] = v;
  }
  __device__ __forceinline__ void trc(int t, int q, T v) const {
    rec[(3 + q * ntr + t) * plane + p] = v;
  }
};

// The inputs of one cell of row r read from device memory, for the cells
// whose neighbourhood crosses a tripole fold: neighbour n (recon::nb_of) at
// the flat index Args::nb_idx gives, 0 where the plain version's shift
// brings 0.
template <typename T>
struct FoldSrc {
  const T* hm_;
  const T* mm_;  // row r's mass plane
  const T* tm_;  // row r's first tracer plane
  recon::Shape g;
  int64_t np;
  int j, i;
  __device__ FoldSrc(const T* hm, const T* mm, const T* tm, int r,
                     const Args& a, int jc, int ic)
      : hm_(hm), g(a.shape()), np((int64_t)a.ny * a.nx), j(jc), i(ic) {
    mm_ = mm + r * np;
    tm_ = tm + (int64_t)r * a.T * np;
  }
  __device__ __forceinline__ T at(const T* f, int n) const {
    const int64_t x =
        n == 8 ? (int64_t)j * g.nx + i
               : g.nb_idx(j, i, recon::nb_of(n, 0), recon::nb_of(n, 1));
    return x < 0 ? T(0) : f[x];
  }
  __device__ __forceinline__ T hm(int n) const { return at(hm_, n); }
  __device__ __forceinline__ T mass(int n) const { return at(mm_, n); }
  __device__ __forceinline__ T tracer(int t, int n) const {
    return at(tm_ + t * np, n);
  }
};

// FOLD: the instance for a tripole grid; the other grids run the one without
template <typename T, bool FOLD>
__global__ void __launch_bounds__(kTileW * kMaxTileRows * kSplit)
    k12(const T* __restrict__ gsh, const T* __restrict__ hm,
        const T* __restrict__ mm, const T* __restrict__ tm,
        T* __restrict__ div, T* __restrict__ divt, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int parent[kMaxT];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int rows = blockDim.y;
  const Layout L(rows, a.T, a.n1);
  T* sg = smem + L.gsh;
  T* rec = smem + L.rec;
  T* shm = smem + L.hm;
  const int h = threadIdx.z;  // which half of the cell's tracers
  const int cell = threadIdx.y * kTileW + threadIdx.x;
  const int tid = h * L.tn + cell;
  T* cent = smem + L.cent + tid;
  const int j0 = blockIdx.y * rows, i0 = blockIdx.x * kTileW;
  const int j = j0 + threadIdx.y, i = i0 + threadIdx.x;
  const bool own = j < a.ny && i < a.nx;
  const int64_t np = (int64_t)a.ny * a.nx;
  const int64_t c = (int64_t)j * a.nx + i;
  if (tid < kMaxT) parent[tid] = a.parent[tid];

  // GSH at the owned cell's donors, each plane read once per block (the
  // two threads of a cell take alternate offsets), and hm
  unsigned valid = 0;
  if (own) {
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      const int64_t x = FOLD ? a.nb_idx(j, i, off_of(o, 0), off_of(o, 1))
                             : a.idx(j + off_of(o, 1), i + off_of(o, 0));
      if (x < 0) continue;  // the masked shift brings 0
      valid |= 1u << o;
      if (o % kSplit != h) continue;
#pragma unroll
      for (int k = 0; k < 10; ++k)
        copy_async(sg + cell * kGshRow + o * kGshOff + k,
                   gsh + ((int64_t)o * 10 + k) * np + x);
    }
  }
  for (int k = tid; k < L.plane4; k += L.nthreads) {
    const int64_t x = a.idx(j0 - 2 + k / L.w4, i0 - 2 + k % L.w4);
    if (x < 0) {
      shm[k] = T(0);
    } else {
      copy_async(shm + k, hm + x);
    }
  }
  const int inplanes = (1 + a.T) * L.plane4;
  stage_row(smem + L.in, mm, tm, 0, L.w4, L.plane4, 2, j0, i0, tid,
            L.nthreads, a);

  const int base = (threadIdx.y + 1) * L.w2 + threadIdx.x + 1;
  for (int r = 0; r < a.C; ++r) {
    const bool tracers = r > 0;  // open water (row 0) is mass only
    const T* in = smem + L.in + (r & 1) * inplanes;
    // row r's inputs have landed; the previous row's contraction is done
    // with rec, and its reconstruction with the other input buffer
    copies_landed();
    __syncthreads();
    if (r + 1 < a.C)
      stage_row(smem + L.in + ((r + 1) & 1) * inplanes, mm, tm, r + 1,
                L.w4, L.plane4, 2, j0, i0, tid, L.nthreads, a);
    for (int k = tid; k < L.plane2; k += L.nthreads) {
      const int y = k / L.w2, xx = k % L.w2;
      const int jy = j0 - 1 + y, ix = i0 - 1 + xx;
      const TileDst<T> dst{rec, L.plane2, k, a.T};
      if (FOLD && jy >= a.ny - 1) {
        // the top row reads its north neighbours across the fold, and the
        // row above it holds the ghost row: the mirror cells (src, nx-1-i)
        // with their own reconstruction, in reversed order
        int64_t x = a.idx(a.ny - 1, ix);
        if (x < 0 || jy > a.ny) continue;  // never a donor
        int jc = a.ny - 1, ic = (int)(x - (int64_t)jc * a.nx);
        if (jy == a.ny) {
          jc = a.fold == 2 ? a.ny - 1 : a.ny - 2;
          ic = a.nx - 1 - ic;
        }
        const FoldSrc<T> src(hm, mm, tm, r, a, jc, ic);
        recon::reconstruct<T>(src, dst, tracers, a, parent, cent,
                              L.nthreads);
        continue;
      }
      if (a.idx(jy, ix) < 0) continue;  // never a donor
      const TileSrc<T> src{shm, in, L.w4, L.plane4, (y + 1) * L.w4 + xx + 1};
      recon::reconstruct<T>(src, dst, tracers, a, parent, cent, L.nthreads);
    }
    __syncthreads();
    if (!own) continue;

    tiled::contract_cell<FOLD>(sg + cell * kGshRow, rec, L.plane2, L.w2,
                               base, valid, j == a.ny - 1, h, tracers, a,
                               parent, div, divt, r, np, c);
  }
}

// the tile of a call with Tn tracers, n1 of type 1 (tiled::plan_tile); the
// same for both instances
template <typename T, bool FOLD = false>
int plan(int Tn, int n1, int* rows, int* smem, int* blocks_per_sm) {
  if (!recon::table_ok(Tn, n1)) return -1;
  return tiled::plan_tile(
      k12<T, FOLD>, kTileW * kSplit,
      [=](int r) { return sizeof(T) * Layout(r, Tn, n1).total; }, rows, smem,
      blocks_per_sm);
}

template <typename T>
int run(const void* gsh, const void* hm, const void* mm, const void* tm,
        void* div, void* divt, int C, int Tn, int n1, int ny, int nx, int ew,
        int ns, const int* parent, cudaStream_t stream) {
  // a fold needs the rows its ghost row reads (src = ny-1 or ny-2)
  if (ew < 0 || ew > 1 || ns < 0 || ns > 3 || (ns >= 2 && ny < ns))
    return -1;
  int rows = 0, smem = 0;
  const bool fold = ns >= 2;
  const int rc = fold ? plan<T, true>(Tn, n1, &rows, &smem, nullptr)
                      : plan<T, false>(Tn, n1, &rows, &smem, nullptr);
  if (rc != 0) return rc;
  const Args a = recon::make_args(C, Tn, n1, ny, nx, ew, ns, parent);
  const dim3 block(kTileW, rows, kSplit);
  const dim3 grid((nx + kTileW - 1) / kTileW, (ny + rows - 1) / rows);
  const T* g = static_cast<const T*>(gsh);
  const T* h = static_cast<const T*>(hm);
  const T* m = static_cast<const T*>(mm);
  const T* t = static_cast<const T*>(tm);
  if (fold)
    k12<T, true><<<grid, block, smem, stream>>>(
        g, h, m, t, static_cast<T*>(div), static_cast<T*>(divt), a);
  else
    k12<T, false><<<grid, block, smem, stream>>>(
        g, h, m, t, static_cast<T*>(div), static_cast<T*>(divt), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int remap_k12_f32(const void* gsh, const void* hm, const void* mm,
                  const void* tm, void* div, void* divt, int C, int T, int n1,
                  int ny, int nx, int ew, int ns, const int* parent,
                  void* stream) {
  return run<float>(gsh, hm, mm, tm, div, divt, C, T, n1, ny, nx, ew, ns,
                    parent, static_cast<cudaStream_t>(stream));
}

int remap_k12_f64(const void* gsh, const void* hm, const void* mm,
                  const void* tm, void* div, void* divt, int C, int T, int n1,
                  int ny, int nx, int ew, int ns, const int* parent,
                  void* stream) {
  return run<double>(gsh, hm, mm, tm, div, divt, C, T, n1, ny, nx, ew, ns,
                     parent, static_cast<cudaStream_t>(stream));
}

int remap_k12_tile_f32(int T, int n1, int* rows, int* smem,
                       int* blocks_per_sm) {
  return plan<float>(T, n1, rows, smem, blocks_per_sm);
}

int remap_k12_tile_f64(int T, int n1, int* rows, int* smem,
                       int* blocks_per_sm) {
  return plan<double>(T, n1, rows, smem, blocks_per_sm);
}

}  // extern "C"
