// remap_recon.cuh — the van-Leer-limited reconstruction of incremental
// remapping, one (category row, cell) at a time: the device code shared by
// the K12 kernel (remap_k12.cu, which writes the reconstruction back to
// shared memory) and the K1 kernel (remap_k1k2.cu, which writes it to
// device memory), both reading a tile staged in shared memory
// (tiled::TileSrc, remap_tile.cuh), so both come from one source.
//
// It computes what cice4_tpu_torch/ops/remap_cuda.py::_construct_vmem (the
// port of cice4_tpu/ops/remap_pallas.py::_construct_vmem) computes for one
// row: the limited gradients (mx, my) of the mass about its centroid, then of
// each type-1 tracer (tc, tx, ty) about the mass centroid, then of each
// type-2 tracer about its parent's mass-weighted centroid (_grad_stream).
// The guarded divisions (where(q != 0, q, 1)) are kept, so no NaN of a branch
// not taken reaches a stored value.  The type-1 centroids that the type-2
// tracers read by their parent's index live in the caller's shared memory,
// so no per-thread array is indexed at run time.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace recon {

constexpr double kPuny = 1.0e-11;
constexpr int kMaxT = 32;   // tracers (remap_cuda.K12_MAX_T)
constexpr int kMaxT1 = 8;   // type-1 tracers (remap_cuda.K12_MAX_T1)

// remap.ALL_OFFSETS: (di, dj) for dj in (1, 0, -1) for di in (-1, 0, 1)
__device__ __forceinline__ int off_of(int o, int d) {
  return d == 0 ? o % 3 - 1 : 1 - o / 3;
}
// the neighbour order of _grad_stream: AXES (E, W, N, S), then DIAGS
__device__ __forceinline__ int nb_of(int n, int d) {
  constexpr int f[8][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1},
                           {1, 1}, {-1, 1}, {1, -1}, {-1, -1}};
  return f[n][d];
}

// whether the kernels take a table of Tn tracers, n1 of type 1
inline bool table_ok(int Tn, int n1) {
  return Tn >= 0 && Tn <= kMaxT && n1 >= 0 && n1 <= kMaxT1 && n1 <= Tn;
}

// grid size and boundaries
struct Shape {
  int ny, nx, ew_cyclic, ns_cyclic;
  int fold;  // 0, or the NS code of a fold: 2 tripole, 3 tripoleT
  // flat index of (j, i), or -1 beyond an open or closed edge (and beyond
  // the north edge of a fold)
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
  // flat index of what the plain version's composite shift by (di, dj), x
  // then y (remap._shift_by), brings to (j, i), or -1 where it brings 0.
  // Across a fold (dj = 1 from the top row) the ghost row is row src = ny-1
  // (tripole) or ny-2 (tripoleT) reversed, read after the x shift: column
  // (nx-1-i) + di, not the mirror of i + di.
  __device__ __forceinline__ int64_t nb_idx(int j, int i, int di,
                                            int dj) const {
    if (fold && j + dj == ny) {
      if (i < 0 || i >= nx) {
        if (!ew_cyclic) return -1;
        i = (i + nx) % nx;
      }
      return idx(fold == 2 ? ny - 1 : ny - 2, nx - 1 - i + di);
    }
    return idx(j + dj, i + di);
  }
};

// grid size, boundaries and the tracer table (n1 type-1 tracers first, then
// the type-2 tracers with the row of their parent)
struct Args {
  int C, T, n1, ny, nx, ew_cyclic, ns_cyclic;
  int fold;  // 0, or the NS code of a fold: 2 tripole, 3 tripoleT
  int parent[kMaxT];
  __device__ __forceinline__ Shape shape() const {
    return Shape{ny, nx, ew_cyclic, ns_cyclic, fold};
  }
  __device__ __forceinline__ int64_t idx(int j, int i) const {
    return shape().idx(j, i);
  }
  __device__ __forceinline__ int64_t nb_idx(int j, int i, int di,
                                            int dj) const {
    return shape().nb_idx(j, i, di, dj);
  }
};

// Args from the C interfaces' arguments (ew/ns 0 = cyclic, 1 = open or
// closed, ns 2 = tripole, 3 = tripoleT); table[T] is each tracer's parent
// row
inline Args make_args(int C, int Tn, int n1, int ny, int nx, int ew, int ns,
                      const int* table) {
  Args a;
  a.C = C; a.T = Tn; a.n1 = n1; a.ny = ny; a.nx = nx;
  a.ew_cyclic = ew == 0;
  a.ns_cyclic = ns == 0;
  a.fold = ns >= 2 ? ns : 0;
  for (int t = 0; t < kMaxT; ++t) a.parent[t] = t < Tn ? table[t] : 0;
  return a;
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

// The outputs of one cell to device memory (K1): mass component q (mc, mx,
// my) at mass[q * np + c], tracer t component q (c, x, y) at trc[(t * ts +
// q * qs) * np + c].
template <typename T>
struct GlobalDst {
  T* mass_;
  T* trc_;
  int64_t np, c, ts, qs;
  __device__ __forceinline__ void mass(int q, T v) const {
    mass_[q * np + c] = v;
  }
  __device__ __forceinline__ void trc(int t, int q, T v) const {
    trc_[(t * ts + q * qs) * np + c] = v;
  }
};

// The reconstruction of one row at one cell, from a source (hm(n), mass(n),
// tracer(t, n)) into a sink (mass(q, v), trc(t, q, v)); with `tracers`
// false (open water) the mass only.  parent[T]: a.parent, copied to shared
// memory.  cent: this thread's slots for the mass-weighted centroids and
// mask of each type-1 tracer, cent[(3 t + q) * cs] for q = x, y, mask, in
// shared memory, so that a type-2 tracer reads its parent's by a runtime
// index without a local-memory array.
template <typename T, class Src, class Dst>
__device__ __forceinline__ void reconstruct(const Src& s, const Dst& d,
                                            bool tracers, const Args& a,
                                            const int* parent, T* cent,
                                            int cs) {
  const T puny = T(kPuny);

  // mass
  const T mc = s.mass(8);
  T msv[8], hsv[8], mmask_sh[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    msv[n] = s.mass(n);
    hsv[n] = s.hm(n);
    mmask_sh[n] = (msv[n] > puny) ? T(1) : T(0);
  }
  T mx, my;
  grad(mc, s.hm(8), T(0), T(0), msv, hsv, mx, my);
  d.mass(0, mc);
  d.mass(1, mx);
  d.mass(2, my);
  if (!tracers || a.T == 0) return;

  const T mmask = (mc > puny) ? T(1) : T(0);
  const T safe_mm = fmax(mc, puny);
  const T mxav = (mmask > T(0)) ? mx / (T(12.0) * safe_mm) : T(0);
  const T myav = (mmask > T(0)) ? my / (T(12.0) * safe_mm) : T(0);

  T sv[8];
  for (int t = 0; t < a.n1; ++t) {
    const T phi = s.tracer(t, 8);
#pragma unroll
    for (int n = 0; n < 8; ++n) sv[n] = s.tracer(t, n);
    T tx, ty;
    grad(phi, mmask, mxav, myav, sv, mmask_sh, tx, ty);
    const T tc = phi - tx * mxav - ty * myav;
    d.trc(t, 0, tc);
    d.trc(t, 1, tx);
    d.trc(t, 2, ty);
    const T w2 = mc * tx + mx * tc;
    const T w3 = mc * ty + my * tc;
    const T denom = mc * phi;
    const bool good = (mmask > T(0)) && (fabs(phi) > puny);
    const T sd = (fabs(denom) > puny) ? denom : T(1);
    cent[(3 * t) * cs] = good ? w2 / (T(12.0) * sd) : T(0);
    cent[(3 * t + 1) * cs] = good ? w3 / (T(12.0) * sd) : T(0);
    cent[(3 * t + 2) * cs] = ((fabs(phi) > T(0)) ? T(1) : T(0)) * mmask;
  }
  T smk[8];
  for (int t = a.n1; t < a.T; ++t) {
    const int p = parent[t];
    const T pcx = cent[(3 * p) * cs], pcy = cent[(3 * p + 1) * cs],
            pmask = cent[(3 * p + 2) * cs];
    const T phi = s.tracer(t, 8);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sv[n] = s.tracer(t, n);
      smk[n] = ((fabs(s.tracer(p, n)) > T(0)) ? T(1) : T(0)) * mmask_sh[n];
    }
    T tx, ty;
    grad(phi, pmask, pcx, pcy, sv, smk, tx, ty);
    d.trc(t, 0, phi - tx * pcx - ty * pcy);
    d.trc(t, 1, tx);
    d.trc(t, 2, ty);
  }
}

}  // namespace recon
