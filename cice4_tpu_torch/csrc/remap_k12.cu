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
// Design: the simple first version, two kernels per call, one thread per
// (row, cell):
//  * reconstruct: the 3x3 neighbourhood of mm, hm and the tracers gives the
//    limited gradients; writes mc, mx, my, tc[T], tx[T], ty[T] to a scratch
//    tensor recon (C, 3 + 3T, ny, nx).  Its device code is
//    recon::reconstruct_cell (remap_recon.cuh), which the K1 kernel of
//    remap_k1k2.cu shares;
//  * contract: for each of the 9 offsets reads GSH and the reconstruction at
//    c + off and accumulates div and divt in the offset order of the plain
//    version.  A donor beyond an open or closed edge contributes 0 (the
//    masked shift); cyclic edges wrap.
// The tracer table comes as the type-1 count n1 and the parent row of each
// type-2 tracer.  The source is built
// with -fmad=false, so sums and products round as in eager PyTorch; what
// differs is only the order of the tracer sums inside each offset term,
// which is the plain version's order too.
//
// What bounds it on an H100: memory traffic.  Per call it must read GSH
// (90 planes), hm, mm (C planes) and tm (C*T planes) and write div and divt
// (C*(1+T) planes); at gx1 f32 (C = 6, T = 9) that is ~91 MB.  The scratch
// adds C*(3+3T) planes written and read (~2 x 88 MB), and the contraction
// reads GSH once per row.  A fused version would stage a tile plus a 2-cell
// halo in shared memory and keep the reconstruction there.
//
// C interface: remap_k12_f32 / remap_k12_f64 (gsh, hm, mm, tm, scratch,
// div, divt, C, T, n1, ny, nx, ew, ns, parent, stream); ew/ns 0 = cyclic,
// 1 = open or closed; parent[T] the parent row of each type-2 tracer.  They
// return cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_recon.cuh"

namespace {

using recon::Args;
using recon::kMaxT;
using recon::kMaxT1;
using recon::off_of;

template <typename T>
__global__ void reconstruct(const T* __restrict__ hm, const T* __restrict__ mm,
                            const T* __restrict__ tm, T* __restrict__ rec,
                            Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int r = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int64_t np = (int64_t)a.ny * a.nx;
  // scratch layout per row: mc, mx, my, tc[T], tx[T], ty[T]
  T* out = rec + (int64_t)r * (3 + 3 * a.T) * np;
  // open water (row 0) is mass only
  recon::reconstruct_cell(hm, mm + r * np, tm + (int64_t)r * a.T * np, out,
                          out + 3 * np, 1, a.T, r > 0, j, i, a);
}

template <typename T>
__global__ void contract(const T* __restrict__ gsh,
                         const T* __restrict__ scratch, T* __restrict__ div,
                         T* __restrict__ divt, Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int r = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int64_t c = (int64_t)j * a.nx + i;
  const int64_t np = (int64_t)a.ny * a.nx;
  const T* rec = scratch + (int64_t)r * (3 + 3 * a.T) * np;
  const T* rc = rec + 3 * np;
  const T* rx = rc + a.T * np;
  const T* ry = rx + a.T * np;
  const bool tracers = r > 0;

  T d = T(0);
  T dt[kMaxT];
  for (int t = 0; t < a.T; ++t) dt[t] = T(0);
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    const int64_t x = a.idx(j + off_of(o, 1), i + off_of(o, 0));
    if (x < 0) continue;  // the masked shift brings 0
    T g[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) g[k] = gsh[((int64_t)o * 10 + k) * np + x];
    const T mc = rec[x], mx = rec[np + x], my = rec[2 * np + x];
    d = d + (g[0] * mc + g[1] * mx + g[2] * my);
    if (!tracers) continue;
    for (int t = 0; t < a.n1; ++t) {
      const T c1 = rc[t * np + x], x1 = rx[t * np + x], y1 = ry[t * np + x];
      const T p1 = g[0] * (mc * c1) + g[1] * (mc * x1 + mx * c1) +
                   g[2] * (mc * y1 + my * c1) + g[3] * (mx * x1) +
                   g[4] * (mx * y1 + my * x1) + g[5] * (my * y1);
      dt[t] = dt[t] + p1;
    }
    for (int t = a.n1; t < a.T; ++t) {
      const int p = a.parent[t];
      const T pc = rc[p * np + x], px = rx[p * np + x], py = ry[p * np + x];
      const T c2 = rc[t * np + x], x2 = rx[t * np + x], y2 = ry[t * np + x];
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
      dt[t] = dt[t] + p2;
    }
  }
  div[(int64_t)r * np + c] = d;
  T* o = divt + (int64_t)r * a.T * np;
  for (int t = 0; t < a.T; ++t) o[t * np + c] = dt[t];
}

template <typename T>
int run(const void* gsh, const void* hm, const void* mm, const void* tm,
        void* scratch, void* div, void* divt, int C, int Tn, int n1, int ny,
        int nx, int ew, int ns, const int* parent, cudaStream_t stream) {
  if (Tn > kMaxT || n1 > kMaxT1 || n1 > Tn) return -1;
  const Args a = recon::make_args(C, Tn, n1, ny, nx, ew, ns, parent);
  const dim3 block(32, 4);
  const dim3 grid = recon::grid_of(ny, nx, C, block);
  reconstruct<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(hm), static_cast<const T*>(mm),
      static_cast<const T*>(tm), static_cast<T*>(scratch), a);
  contract<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(gsh), static_cast<const T*>(scratch),
      static_cast<T*>(div), static_cast<T*>(divt), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int remap_k12_f32(const void* gsh, const void* hm, const void* mm,
                  const void* tm, void* scratch, void* div, void* divt, int C,
                  int T, int n1, int ny, int nx, int ew, int ns,
                  const int* parent, void* stream) {
  return run<float>(gsh, hm, mm, tm, scratch, div, divt, C, T, n1, ny, nx, ew,
                    ns, parent, static_cast<cudaStream_t>(stream));
}

int remap_k12_f64(const void* gsh, const void* hm, const void* mm,
                  const void* tm, void* scratch, void* div, void* divt, int C,
                  int T, int n1, int ny, int nx, int ew, int ns,
                  const int* parent, void* stream) {
  return run<double>(gsh, hm, mm, tm, scratch, div, divt, C, T, n1, ny, nx, ew,
                     ns, parent, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
