// remap_recon.cuh — the van-Leer-limited reconstruction of incremental
// remapping, one (category row, cell) at a time: the device code shared by
// the K12 kernel (remap_k12.cu, which stores it in a scratch tensor) and the
// K1 kernel (remap_k1k2.cu, which returns it), so both come from one source.
//
// It computes what cice4_tpu_torch/ops/remap_cuda.py::_construct_vmem (the
// port of cice4_tpu/ops/remap_pallas.py::_construct_vmem) computes for one
// row: the limited gradients (mx, my) of the mass about its centroid, then of
// each type-1 tracer (tc, tx, ty) about the mass centroid, then of each
// type-2 tracer about its parent's mass-weighted centroid (_grad_stream).
// The guarded divisions (where(q != 0, q, 1)) are kept, so no NaN of a branch
// not taken reaches a stored value.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace recon {

constexpr double kPuny = 1.0e-11;
constexpr int kMaxT = 32;   // tracers (remap_cuda.K12_MAX_T)
constexpr int kMaxT1 = 8;   // type-1 tracers (remap_cuda.K12_MAX_T1)

// remap.ALL_OFFSETS: (di, dj) for dj in (1, 0, -1) for di in (-1, 0, 1)
__device__ __forceinline__ int off_of(int o, int d) {
  constexpr int f[9][2] = {{-1, 1}, {0, 1}, {1, 1}, {-1, 0}, {0, 0},
                           {1, 0}, {-1, -1}, {0, -1}, {1, -1}};
  return f[o][d];
}
// the neighbour order of _grad_stream: AXES (E, W, N, S), then DIAGS
__device__ __forceinline__ int nb_of(int n, int d) {
  constexpr int f[8][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1},
                           {1, 1}, {-1, 1}, {1, -1}, {-1, -1}};
  return f[n][d];
}

// grid size, boundaries and the tracer table (n1 type-1 tracers first, then
// the type-2 tracers with the row of their parent)
struct Args {
  int C, T, n1, ny, nx, ew_cyclic, ns_cyclic;
  int parent[kMaxT];
  // flat index of (j, i), or -1 beyond an open or closed edge
  __device__ __forceinline__ int64_t idx(int j, int i) const {
    if (i < 0 || i >= nx) {
      if (!ew_cyclic) return -1;
      i = (i + nx) % nx;
    }
    if (j < 0 || j >= ny) {
      if (!ns_cyclic) return -1;
      j = (j + ny) % ny;
    }
    return (int64_t)j * nx + i;
  }
};

// Args from the C interfaces' arguments (ew/ns 0 = cyclic, 1 = open or
// closed); table[T] is each tracer's parent row (K12, K1) or its index into
// the gathered parents (K2)
inline Args make_args(int C, int Tn, int n1, int ny, int nx, int ew, int ns,
                      const int* table) {
  Args a;
  a.C = C; a.T = Tn; a.n1 = n1; a.ny = ny; a.nx = nx;
  a.ew_cyclic = ew == 0;
  a.ns_cyclic = ns == 0;
  for (int t = 0; t < kMaxT; ++t) a.parent[t] = t < Tn ? table[t] : 0;
  return a;
}

// one thread per (row, cell): x over i, y over j, z over the C rows
inline dim3 grid_of(int ny, int nx, int C, dim3 block) {
  return dim3((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y, C);
}

template <typename T>
__device__ __forceinline__ T ld(const T* f, int64_t k) {
  return k < 0 ? T(0) : f[k];
}

// _grad_stream: the limited gradient (gx, gy) of phi about (cnx, cny), from
// the neighbour values sv[8] and masks sm[8] in AXES + DIAGS order
template <typename T>
__device__ __forceinline__ void grad(T phi, T phimask, T cnx, T cny,
                                     const T* sv, const T* sm, T& ox, T& oy) {
  T nb[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) nb[n] = sm[n] * sv[n] + (T(1) - sm[n]) * phi;
  const T gx = T(0.5) * (nb[0] - nb[1]);
  const T gy = T(0.5) * (nb[2] - nb[3]);
  T pmn = fmin(fmin(nb[0], nb[1]), fmin(nb[2], nb[3]));
  T pmx = fmax(fmax(nb[0], nb[1]), fmax(nb[2], nb[3]));
  pmn = fmin(pmn, phi);
  pmx = fmax(pmx, phi);
#pragma unroll
  for (int n = 4; n < 8; ++n) {
    pmn = fmin(pmn, nb[n]);
    pmx = fmax(pmx, nb[n]);
  }
  pmn = pmn - phi;
  pmx = pmx - phi;

  const T w1 = (T(0.5) - cnx) * gx + (T(0.5) - cny) * gy;
  const T w2 = (T(0.5) - cnx) * gx - (T(0.5) + cny) * gy;
  const T w3 = -(T(0.5) + cnx) * gx - (T(0.5) + cny) * gy;
  const T w4 = (T(0.5) - cny) * gy - (T(0.5) + cnx) * gx;
  const T qmn = fmin(fmin(w1, w2), fmin(w3, w4));
  const T qmx = fmax(fmax(w1, w2), fmax(w3, w4));
  const T wa = (fabs(qmn) > T(0))
                   ? fmax(pmn / ((qmn != T(0)) ? qmn : T(1)), T(0)) : T(1);
  const T wb = (fabs(qmx) > T(0))
                   ? fmax(pmx / ((qmx != T(0)) ? qmx : T(1)), T(0)) : T(1);
  const T lim = fmin(fmin(wa, wb), T(1)) * phimask;
  ox = lim * gx;
  oy = lim * gy;
}

// The reconstruction of one row at cell (j, i).  m: the row's mass plane;
// t0: its first tracer plane (tracer t at t0 + t * np).  Writes mass
// component q (mc, mx, my) to mass[q * np + c] and, when `tracers`, tracer t
// component q (c, x, y) to trc[(t * ts + q * qs) * np + c]: the layout of
// each caller's output is its pair of strides (ts, qs).
template <typename T>
__device__ __forceinline__ void reconstruct_cell(
    const T* __restrict__ hm, const T* __restrict__ m,
    const T* __restrict__ t0, T* __restrict__ mass, T* __restrict__ trc,
    int64_t ts, int64_t qs, bool tracers, int j, int i, const Args& a) {
  const int64_t c = (int64_t)j * a.nx + i;
  const int64_t np = (int64_t)a.ny * a.nx;
  const T puny = T(kPuny);

  int64_t nbi[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) nbi[n] = a.idx(j + nb_of(n, 1), i + nb_of(n, 0));

  // mass
  const T mc = m[c];
  T msv[8], hsv[8], mmask_sh[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    msv[n] = ld(m, nbi[n]);
    hsv[n] = ld(hm, nbi[n]);
    mmask_sh[n] = (msv[n] > puny) ? T(1) : T(0);
  }
  T mx, my;
  grad(mc, hm[c], T(0), T(0), msv, hsv, mx, my);
  mass[c] = mc;
  mass[np + c] = mx;
  mass[2 * np + c] = my;
  if (!tracers || a.T == 0) return;

  const T mmask = (mc > puny) ? T(1) : T(0);
  const T safe_mm = fmax(mc, puny);
  const T mxav = (mmask > T(0)) ? mx / (T(12.0) * safe_mm) : T(0);
  const T myav = (mmask > T(0)) ? my / (T(12.0) * safe_mm) : T(0);

  T mtxav1[kMaxT1], mtyav1[kMaxT1], tmask1[kMaxT1];
  T sv[8];
  for (int t = 0; t < a.n1; ++t) {
    const T* f = t0 + t * np;
    const T phi = f[c];
#pragma unroll
    for (int n = 0; n < 8; ++n) sv[n] = ld(f, nbi[n]);
    T tx, ty;
    grad(phi, mmask, mxav, myav, sv, mmask_sh, tx, ty);
    const T tc = phi - tx * mxav - ty * myav;
    trc[(t * ts) * np + c] = tc;
    trc[(t * ts + qs) * np + c] = tx;
    trc[(t * ts + 2 * qs) * np + c] = ty;
    const T w2 = mc * tx + mx * tc;
    const T w3 = mc * ty + my * tc;
    const T denom = mc * phi;
    const bool good = (mmask > T(0)) && (fabs(phi) > puny);
    const T sd = (fabs(denom) > puny) ? denom : T(1);
    mtxav1[t] = good ? w2 / (T(12.0) * sd) : T(0);
    mtyav1[t] = good ? w3 / (T(12.0) * sd) : T(0);
    tmask1[t] = ((fabs(phi) > T(0)) ? T(1) : T(0)) * mmask;
  }
  T smk[8];
  for (int t = a.n1; t < a.T; ++t) {
    const int p = a.parent[t];
    const T* f = t0 + t * np;
    const T* fp = t0 + p * np;
    const T phi = f[c];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sv[n] = ld(f, nbi[n]);
      smk[n] = ((fabs(ld(fp, nbi[n])) > T(0)) ? T(1) : T(0)) * mmask_sh[n];
    }
    T tx, ty;
    grad(phi, tmask1[p], mtxav1[p], mtyav1[p], sv, smk, tx, ty);
    trc[(t * ts) * np + c] = phi - tx * mtxav1[p] - ty * mtyav1[p];
    trc[(t * ts + qs) * np + c] = tx;
    trc[(t * ts + 2 * qs) * np + c] = ty;
  }
}

}  // namespace recon
