// remap_k1k2.cu — the split route of incremental remapping on Hopper: the
// reconstruction (K1) and the scatter-form contraction (K2), which follow K0
// in GA mode (remap_gsh.cu with emit_shifted = 0).
//
// Replaces the TPU kernels K1, cice4_tpu/ops/remap_pallas.py::
// _construct_kernel (:373-388), and K2, ::_contract_kernel (:391-496), both
// called from remap_pallas_divergence (:542-653).  They compute what the
// plain versions cice4_tpu_torch/ops/remap_cuda.py::construct_plain and
// ::contract_plain compute:
//  * remap_construct (K1): for every row r of the extended category batch
//    (row 0 is open water, whose tracers are zero), the van-Leer-limited
//    reconstruction mass (C, 3, ny, nx) = (mc, mx, my) and trc (C, T, 3, ny,
//    nx) = (tc, tx, ty) per tracer (recon::reconstruct, remap_recon.cuh,
//    which K12 runs too);
//  * remap_contract (K2): for every row r and cell c,
//      div(c)  = sum_off GA[off](c) * [g0 mc + g1 mx + g2 my](c + off),
//      divt(c) = sum_off sum_k GA_k[off](c) * U_k(c + off),
//    the TPU's S_off(S_-off(GA[off]) * U) evaluated at c, with U_k the
//    monomial coefficients of m*p*t, whose parent planes p = (pc, px, py) are
//    (1, 0, 0) for a type-1 tracer and the parent's reconstruction, rows of
//    trc[r], for a type-2 tracer (tiled::contract_cell, remap_tile.cuh, which
//    K12 runs too).  A donor c + off beyond an open or closed edge
//    contributes 0 (the two masked shifts); cyclic edges wrap.
//
// Design: one launch each, no atomics.  A block owns a tile of 32 x rows
// cells and loops over the C rows inside, staging each row's inputs on the
// tile plus a 1-cell halo with cp.async into one of two buffers while it
// works on the row before (cyclic edges wrap while staging, a cell beyond an
// open or closed edge stages 0):
//  * K1, one thread a cell: hm once per block; per row mm[r] and, past row
//    0, tm[r]; each thread reconstructs its cell from shared memory and
//    writes its 3 + 3T values straight to device memory, a warp's stores 128
//    contiguous bytes.  Row 0 writes its tracer planes as zeros without
//    reconstructing them.
//  * K2, two threads a cell (the mass and the even tracers, the odd
//    tracers): the 90 GA values of each owned cell once per block, for all
//    rows, in K12's padded 16-byte rows (GA at the cell itself: no halo);
//    per row mass[r] and, past row 0, trc[r], in the plane order of K12's
//    reconstruction, so that the contraction is K12's: tracers looped at run
//    time outside, the 9 offsets unrolled inside, one register a (row,
//    tracer) sum, type-1 tracers without the polynomial's zero terms, row 0
//    writing zero tracer divergences, the parents' planes read from the
//    staged trc[r].
// The tile is the deepest of 8, 4, 2, 1 rows whose shared memory fits a
// block (plan_tile; the fewest halo cells staged twice), the blocks an SM
// keeps as the runtime's occupancy query gives them: at the box (T = 9, n1 =
// 3) in f32, K1 8 rows, 37,776 bytes, 4 blocks of 256 threads an SM (52
// registers); K2 8 rows, 192,192 bytes, one block of 512 threads (4 rows in
// f64).
// Each sum adds its terms in remap.ALL_OFFSETS order with the plain
// version's products in its order, and the source is built with
// -fmad=false, so sums and products round as in eager PyTorch.
//
// What bounds them on an H100: bytes.  At the doubly-periodic box (384 x
// 320, C = 6, T = 9, f32) K1 must read hm, mm and tm (61 planes) and write
// mass and trc (180 planes), 118.46 MB, 0.0354 ms at 3.35 TB/s; K2 must read
// GA, mass and trc (270 planes) and write div and divt (60 planes), 162.2
// MB, 0.0484 ms, against 2.86 G operations, 0.043 ms at 67 TFLOP/s (each an
// instruction of its own without FMA).
//
// C interface (ew/ns 0 = cyclic, 1 = open or closed; parent[T] the parent
// row of each type-2 tracer; they return the launch's error code, -1 for a
// tracer table they do not take or a tripole fold, ns 2 or 3, which the
// split route does not take):
//   remap_construct_f32/_f64(hm, mm, tm, mass, trc, C, T, n1, ny, nx, ew,
//                            ns, parent, stream);
//   remap_contract_f32/_f64(ga, mass, trc, div, divt, C, T, n1, ny, nx, ew,
//                           ns, parent, stream);
//   remap_construct_tile_f32/_f64 and remap_contract_tile_f32/_f64 (T, n1,
//   rows, smem, blocks_per_sm): the tile such a call launches with and the
//   blocks the runtime keeps resident on an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_tile.cuh"

namespace {

using recon::Args;
using recon::kMaxT;
using recon::off_of;
using tiled::copies_landed;
using tiled::copy_async;
using tiled::commit_copies;
using tiled::kGshOff;
using tiled::kGshRow;
using tiled::kMaxTileRows;
using tiled::kSplit;
using tiled::kTileW;
using tiled::stage_row;
using tiled::TileSrc;

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// K1's shared memory, in elements
struct ConstructLayout {
  int tn;           // owned cells, 32 x rows, one thread each
  int w, plane;     // the tile plus a 1-cell halo
  int hm, in, cent;
  int total;
  __host__ __device__ ConstructLayout(int rows, int Tn, int n1) {
    tn = kTileW * rows;
    w = kTileW + 2;
    plane = w * (rows + 2);
    hm = 0;                            // plane
    in = hm + plane;                   // 2 x (1 + T) x plane: mm, tm[T]
    cent = in + 2 * (1 + Tn) * plane;  // 3 n1 x tn: type-1 centroids
    total = cent + 3 * n1 * tn;
  }
};

// a cap on registers, 85 in f32, that keeps at least 3 blocks of 256
// threads an SM (it does not bind: ptxas gives K1 52); none in f64
template <typename T>
struct ConstructBlocks {
  static constexpr int value = sizeof(T) == 4 ? 3 : 1;
};

template <typename T>
__global__ void __launch_bounds__(kTileW * kMaxTileRows,
                                  ConstructBlocks<T>::value)
    construct(const T* __restrict__ hm, const T* __restrict__ mm,
              const T* __restrict__ tm, T* __restrict__ mass,
              T* __restrict__ trc, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int parent[kMaxT];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int rows = blockDim.y;
  const ConstructLayout L(rows, a.T, a.n1);
  T* shm = smem + L.hm;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  T* cent = smem + L.cent + tid;
  const int j0 = blockIdx.y * rows, i0 = blockIdx.x * kTileW;
  const int j = j0 + threadIdx.y, i = i0 + threadIdx.x;
  const bool own = j < a.ny && i < a.nx;
  const int64_t np = (int64_t)a.ny * a.nx;
  const int64_t c = (int64_t)j * a.nx + i;
  if (tid < kMaxT) parent[tid] = a.parent[tid];

  for (int k = tid; k < L.plane; k += L.tn) {
    const int64_t x = a.idx(j0 - 1 + k / L.w, i0 - 1 + k % L.w);
    if (x < 0) {
      shm[k] = T(0);
    } else {
      copy_async(shm + k, hm + x);
    }
  }
  const int inplanes = (1 + a.T) * L.plane;
  stage_row(smem + L.in, mm, tm, 0, L.w, L.plane, 1, j0, i0, tid, L.tn, a);

  const int p = (threadIdx.y + 1) * L.w + threadIdx.x + 1;
  for (int r = 0; r < a.C; ++r) {
    const T* in = smem + L.in + (r & 1) * inplanes;
    // row r's inputs have landed; row r - 1 is done with the other buffer
    copies_landed();
    __syncthreads();
    if (r + 1 < a.C)
      stage_row(smem + L.in + ((r + 1) & 1) * inplanes, mm, tm, r + 1, L.w,
                L.plane, 1, j0, i0, tid, L.tn, a);
    if (!own) continue;
    T* tr = trc + (int64_t)r * a.T * 3 * np;
    const TileSrc<T> src{shm, in, L.w, L.plane, p};
    const recon::GlobalDst<T> dst{mass + (int64_t)r * 3 * np, tr, np, c, 3,
                                  1};
    recon::reconstruct<T>(src, dst, r > 0, a, parent, cent, L.tn);
    if (r == 0) {  // open water carries no tracers
      for (int q = 0; q < 3 * a.T; ++q) tr[q * np + c] = T(0);
    }
  }
}

template <typename T>
int construct_plan(int Tn, int n1, int* rows, int* smem, int* blocks_per_sm) {
  if (!recon::table_ok(Tn, n1)) return -1;
  return tiled::plan_tile(
      construct<T>, kTileW,
      [=](int r) { return sizeof(T) * ConstructLayout(r, Tn, n1).total; },
      rows, smem, blocks_per_sm);
}

template <typename T>
int run_construct(const void* hm, const void* mm, const void* tm, void* mass,
                  void* trc, int C, int Tn, int n1, int ny, int nx, int ew,
                  int ns, const int* parent, cudaStream_t stream) {
  int rows = 0, smem = 0;
  if (ns > 1) return -1;  // the split route takes no tripole fold
  const int rc = construct_plan<T>(Tn, n1, &rows, &smem, nullptr);
  if (rc != 0) return rc;
  const Args a = recon::make_args(C, Tn, n1, ny, nx, ew, ns, parent);
  const dim3 block(kTileW, rows);
  const dim3 grid((nx + kTileW - 1) / kTileW, (ny + rows - 1) / rows);
  construct<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(hm), static_cast<const T*>(mm),
      static_cast<const T*>(tm), static_cast<T*>(mass), static_cast<T*>(trc),
      a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// K2's shared memory, in elements
struct ContractLayout {
  int tn;          // owned cells, 32 x rows
  int nthreads;    // kSplit x tn
  int w, plane;    // the tile plus a 1-cell halo
  int ga, rec;
  int total;
  __host__ __device__ ContractLayout(int rows, int Tn) {
    tn = kTileW * rows;
    nthreads = kSplit * tn;
    w = kTileW + 2;
    plane = w * (rows + 2);
    ga = 0;                    // tn x kGshRow: GA at the owned cells
    rec = ga + kGshRow * tn;   // 2 x (3 + 3T) x plane: mc mx my tc tx ty
    total = rec + 2 * (3 + 3 * Tn) * plane;
  }
};

// start copying row r's mass[r] and, past row 0, trc[r] on the tile plus a
// 1-cell halo into rec, in contract_cell's plane order (mc, mx, my, then
// tc[T], tx[T], ty[T]); a cell beyond an open edge stages 0
template <typename T>
__device__ __forceinline__ void stage_rec(T* rec, const T* mass,
                                          const T* trc, int r,
                                          const ContractLayout& L, int j0,
                                          int i0, int tid, const Args& a) {
  const int64_t np = (int64_t)a.ny * a.nx;
  const T* m = mass + (int64_t)r * 3 * np;
  const T* tr = trc + (int64_t)r * a.T * 3 * np;
  const int ntr = r > 0 ? a.T : 0;
  for (int k = tid; k < L.plane; k += L.nthreads) {
    const int64_t x = a.idx(j0 - 1 + k / L.w, i0 - 1 + k % L.w);
    for (int q = 0; q < 3; ++q) {
      T* dst = rec + q * L.plane + k;
      if (x < 0) {
        *dst = T(0);
      } else {
        copy_async(dst, m + q * np + x);
      }
    }
    for (int t = 0; t < ntr; ++t) {
      for (int q = 0; q < 3; ++q) {
        T* dst = rec + (3 + q * a.T + t) * L.plane + k;
        if (x < 0) {
          *dst = T(0);
        } else {
          copy_async(dst, tr + (int64_t)(t * 3 + q) * np + x);
        }
      }
    }
  }
  commit_copies();
}

template <typename T>
__global__ void __launch_bounds__(kTileW * kMaxTileRows * kSplit)
    contract(const T* __restrict__ ga, const T* __restrict__ mass,
             const T* __restrict__ trc, T* __restrict__ div,
             T* __restrict__ divt, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int parent[kMaxT];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int rows = blockDim.y;
  const ContractLayout L(rows, a.T);
  T* sg = smem + L.ga;
  const int h = threadIdx.z;  // which half of the cell's tracers
  const int cell = threadIdx.y * kTileW + threadIdx.x;
  const int tid = h * L.tn + cell;
  const int j0 = blockIdx.y * rows, i0 = blockIdx.x * kTileW;
  const int j = j0 + threadIdx.y, i = i0 + threadIdx.x;
  const bool own = j < a.ny && i < a.nx;
  const int64_t np = (int64_t)a.ny * a.nx;
  const int64_t c = (int64_t)j * a.nx + i;
  if (tid < kMaxT) parent[tid] = a.parent[tid];

  // GA at the owned cell for all rows, each plane read once per block (the
  // two threads of a cell take alternate planes)
  unsigned valid = 0;
  if (own) {
#pragma unroll
    for (int o = 0; o < 9; ++o)
      if (a.idx(j + off_of(o, 1), i + off_of(o, 0)) >= 0) valid |= 1u << o;
    for (int ok = h; ok < 90; ok += kSplit)
      copy_async(sg + cell * kGshRow + ok / 10 * kGshOff + ok % 10,
                 ga + ok * np + c);
  }
  const int recplanes = (3 + 3 * a.T) * L.plane;
  stage_rec(smem + L.rec, mass, trc, 0, L, j0, i0, tid, a);

  const int base = (threadIdx.y + 1) * L.w + threadIdx.x + 1;
  for (int r = 0; r < a.C; ++r) {
    const T* rec = smem + L.rec + (r & 1) * recplanes;
    // row r's inputs have landed; row r - 1 is done with the other buffer
    copies_landed();
    __syncthreads();
    if (r + 1 < a.C)
      stage_rec(smem + L.rec + ((r + 1) & 1) * recplanes, mass, trc, r + 1,
                L, j0, i0, tid, a);
    if (!own) continue;
    tiled::contract_cell<false>(sg + cell * kGshRow, rec, L.plane, L.w, base,
                                valid, false, h, r > 0, a, parent, div, divt,
                                r, np, c);
  }
}

template <typename T>
int contract_plan(int Tn, int n1, int* rows, int* smem, int* blocks_per_sm) {
  if (!recon::table_ok(Tn, n1)) return -1;
  return tiled::plan_tile(
      contract<T>, kTileW * kSplit,
      [=](int r) { return sizeof(T) * ContractLayout(r, Tn).total; }, rows,
      smem, blocks_per_sm);
}

template <typename T>
int run_contract(const void* ga, const void* mass, const void* trc,
                 void* div, void* divt, int C, int Tn, int n1, int ny, int nx,
                 int ew, int ns, const int* parent, cudaStream_t stream) {
  int rows = 0, smem = 0;
  if (ns > 1) return -1;  // the split route takes no tripole fold
  const int rc = contract_plan<T>(Tn, n1, &rows, &smem, nullptr);
  if (rc != 0) return rc;
  const Args a = recon::make_args(C, Tn, n1, ny, nx, ew, ns, parent);
  const dim3 block(kTileW, rows, kSplit);
  const dim3 grid((nx + kTileW - 1) / kTileW, (ny + rows - 1) / rows);
  contract<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(ga), static_cast<const T*>(mass),
      static_cast<const T*>(trc), static_cast<T*>(div),
      static_cast<T*>(divt), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int remap_construct_f32(const void* hm, const void* mm, const void* tm,
                        void* mass, void* trc, int C, int T, int n1, int ny,
                        int nx, int ew, int ns, const int* parent,
                        void* stream) {
  return run_construct<float>(hm, mm, tm, mass, trc, C, T, n1, ny, nx, ew, ns,
                              parent, static_cast<cudaStream_t>(stream));
}

int remap_construct_f64(const void* hm, const void* mm, const void* tm,
                        void* mass, void* trc, int C, int T, int n1, int ny,
                        int nx, int ew, int ns, const int* parent,
                        void* stream) {
  return run_construct<double>(hm, mm, tm, mass, trc, C, T, n1, ny, nx, ew,
                               ns, parent, static_cast<cudaStream_t>(stream));
}

int remap_contract_f32(const void* ga, const void* mass, const void* trc,
                       void* div, void* divt, int C, int T, int n1, int ny,
                       int nx, int ew, int ns, const int* parent,
                       void* stream) {
  return run_contract<float>(ga, mass, trc, div, divt, C, T, n1, ny, nx, ew,
                             ns, parent, static_cast<cudaStream_t>(stream));
}

int remap_contract_f64(const void* ga, const void* mass, const void* trc,
                       void* div, void* divt, int C, int T, int n1, int ny,
                       int nx, int ew, int ns, const int* parent,
                       void* stream) {
  return run_contract<double>(ga, mass, trc, div, divt, C, T, n1, ny, nx, ew,
                              ns, parent, static_cast<cudaStream_t>(stream));
}

int remap_construct_tile_f32(int T, int n1, int* rows, int* smem,
                             int* blocks_per_sm) {
  return construct_plan<float>(T, n1, rows, smem, blocks_per_sm);
}

int remap_construct_tile_f64(int T, int n1, int* rows, int* smem,
                             int* blocks_per_sm) {
  return construct_plan<double>(T, n1, rows, smem, blocks_per_sm);
}

int remap_contract_tile_f32(int T, int n1, int* rows, int* smem,
                            int* blocks_per_sm) {
  return contract_plan<float>(T, n1, rows, smem, blocks_per_sm);
}

int remap_contract_tile_f64(int T, int n1, int* rows, int* smem,
                            int* blocks_per_sm) {
  return contract_plan<double>(T, n1, rows, smem, blocks_per_sm);
}

}  // extern "C"
