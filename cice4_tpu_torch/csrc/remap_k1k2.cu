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
//    nx) = (tc, tx, ty) per tracer.  Its device code is
//    recon::reconstruct_cell (remap_recon.cuh), which K12's reconstruction
//    pass shares: the same function, another output layout.
//  * remap_contract (K2): for every row r and cell c,
//      div(c)  = sum_off GA[off](c) * [g0 mc + g1 mx + g2 my](c + off),
//      divt(c) = sum_off sum_k GA_k[off](c) * U_k(c + off),
//    the TPU's S_off(S_-off(GA[off]) * U) evaluated at c, with U_k the
//    monomial coefficients of m*p*t, whose parent planes p = (pc, px, py) are
//    (1, 0, 0) for a type-1 tracer and the parent's reconstruction (the
//    gathered `par` tensor) for a type-2 tracer: one formula for all rows, in
//    the operation order of _contract_kernel.  A donor c + off beyond an open
//    or closed edge contributes 0 (the two masked shifts); cyclic edges wrap.
//    Offsets are visited in remap.ALL_OFFSETS order, as the TPU's grid did.
//
// Design: one thread per (row, cell), no atomics: each thread owns its
// outputs and sums its 9 donors in order, so results are identical run to
// run.  The TPU's tracer chunks and lax.switch over offsets were devices of
// its VMEM; here every tracer of a row is one thread's loop.
//
// What bounds them on an H100: memory traffic.  K1 reads hm, mm (C planes)
// and tm (C*T) and writes C*(3 + 3T) planes; K2 reads GA (90 planes), mass,
// trc and par, and writes C*(1 + T).  Per (row, cell) K2 reads the 10 GA
// values at c and 3*(1 + 2T) reconstruction values at each of the 9 donors,
// which L1/L2 serve after the first neighbour.  The source is built with
// -fmad=false so that each product and sum rounds as in eager PyTorch.
//
// C interface (ew/ns 0 = cyclic, 1 = open or closed; they return
// cudaGetLastError() after the launch):
//   remap_construct_f32/_f64(hm, mm, tm, mass, trc, C, T, n1, ny, nx, ew, ns,
//                            parent, stream), parent[T] the parent row of
//                            each type-2 tracer;
//   remap_contract_f32/_f64(ga, mass, trc, par, div, divt, C, T, P, ny, nx,
//                           ew, ns, ppos, stream), ppos[T] the index into
//                           par's P rows of each tracer's parent, -1 for a
//                           type-1 tracer.

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_recon.cuh"

namespace {

using recon::Args;
using recon::kMaxT;
using recon::kMaxT1;
using recon::grid_of;
using recon::make_args;
using recon::off_of;

template <typename T>
__global__ void construct(const T* __restrict__ hm, const T* __restrict__ mm,
                          const T* __restrict__ tm, T* __restrict__ mass,
                          T* __restrict__ trc, Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int r = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int64_t np = (int64_t)a.ny * a.nx;
  recon::reconstruct_cell(hm, mm + r * np, tm + (int64_t)r * a.T * np,
                          mass + (int64_t)r * 3 * np,
                          trc + (int64_t)r * a.T * 3 * np, 3, 1, true, j, i,
                          a);
}

// Args.parent holds ppos here: the parent's index into par, -1 for type 1
template <typename T>
__global__ void contract(const T* __restrict__ ga, const T* __restrict__ mass,
                         const T* __restrict__ trc, const T* __restrict__ par,
                         T* __restrict__ div, T* __restrict__ divt, int P,
                         Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int r = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int64_t c = (int64_t)j * a.nx + i;
  const int64_t np = (int64_t)a.ny * a.nx;
  const T* m = mass + (int64_t)r * 3 * np;
  const T* tr = trc + (int64_t)r * a.T * 3 * np;
  const T* pr = par + (int64_t)r * P * 3 * np;

  T d = T(0);
  T dt[kMaxT];
  for (int t = 0; t < a.T; ++t) dt[t] = T(0);
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    const int64_t x = a.idx(j + off_of(o, 1), i + off_of(o, 0));
    if (x < 0) continue;  // the masked shift brings 0
    T g[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) g[k] = ga[((int64_t)o * 10 + k) * np + c];
    const T mc = m[x], mx = m[np + x], my = m[2 * np + x];
    d = d + (g[0] * mc + g[1] * mx + g[2] * my);
    for (int t = 0; t < a.T; ++t) {
      const int pp = a.parent[t];
      T pc = T(1), px = T(0), py = T(0);
      if (pp >= 0) {
        const T* q = pr + (int64_t)pp * 3 * np;
        pc = q[x];
        px = q[np + x];
        py = q[2 * np + x];
      }
      const T* q = tr + (int64_t)t * 3 * np;
      const T c2 = q[x], x2 = q[np + x], y2 = q[2 * np + x];
      const T mpc = mc * pc, mpx = mc * px, mpy = mc * py;
      const T xpc = mx * pc, xpx = mx * px, xpy = mx * py;
      const T ypc = my * pc, ypx = my * px, ypy = my * py;
      const T p = g[0] * (mpc * c2) +
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
      dt[t] = dt[t] + p;
    }
  }
  div[(int64_t)r * np + c] = d;
  T* out = divt + (int64_t)r * a.T * np;
  for (int t = 0; t < a.T; ++t) out[t * np + c] = dt[t];
}

template <typename T>
int run_construct(const void* hm, const void* mm, const void* tm, void* mass,
                  void* trc, int C, int Tn, int n1, int ny, int nx, int ew,
                  int ns, const int* parent, cudaStream_t stream) {
  if (Tn > kMaxT || n1 > kMaxT1 || n1 > Tn) return -1;
  const Args a = make_args(C, Tn, n1, ny, nx, ew, ns, parent);
  const dim3 block(32, 4);
  construct<T><<<grid_of(ny, nx, C, block), block, 0, stream>>>(
      static_cast<const T*>(hm), static_cast<const T*>(mm),
      static_cast<const T*>(tm), static_cast<T*>(mass), static_cast<T*>(trc),
      a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_contract(const void* ga, const void* mass, const void* trc,
                 const void* par, void* div, void* divt, int C, int Tn, int P,
                 int ny, int nx, int ew, int ns, const int* ppos,
                 cudaStream_t stream) {
  if (Tn > kMaxT) return -1;
  const Args a = make_args(C, Tn, 0, ny, nx, ew, ns, ppos);
  const dim3 block(32, 4);
  contract<T><<<grid_of(ny, nx, C, block), block, 0, stream>>>(
      static_cast<const T*>(ga), static_cast<const T*>(mass),
      static_cast<const T*>(trc), static_cast<const T*>(par),
      static_cast<T*>(div), static_cast<T*>(divt), P, a);
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
                       const void* par, void* div, void* divt, int C, int T,
                       int P, int ny, int nx, int ew, int ns, const int* ppos,
                       void* stream) {
  return run_contract<float>(ga, mass, trc, par, div, divt, C, T, P, ny, nx,
                             ew, ns, ppos, static_cast<cudaStream_t>(stream));
}

int remap_contract_f64(const void* ga, const void* mass, const void* trc,
                       const void* par, void* div, void* divt, int C, int T,
                       int P, int ny, int nx, int ew, int ns, const int* ppos,
                       void* stream) {
  return run_contract<double>(ga, mass, trc, par, div, divt, C, T, P, ny, nx,
                              ew, ns, ppos,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
