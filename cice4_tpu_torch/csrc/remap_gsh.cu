// remap_gsh.cu — geometric divergence accumulators of incremental remapping
// (the GSH tensor) on Hopper: one fused tile kernel.
//
// Replaces the TPU kernel K0, cice4_tpu/ops/remap_pallas.py::_ga_kernel
// (:70-132), in both its modes: GSH mode (emit_shifted, host code
// ga_gsh_pallas :135-154) and GA mode (the K0 of the K0 -> K1 -> K2 route,
// remap_pallas_divergence :569-576).  In GSH mode it computes what the plain
// version cice4_tpu_torch/ops/remap_cuda.py::ga_gsh_plain computes: for the
// east and north edge of every cell, the up-to-6 departure triangles
// (remap._edge_geometry, free-area mode), the 10 monomial moments of each by
// quadrature of order 1-3 (remap._quad_points), summed per donor position
// (remap._geom_moments): the moment planes P[e][p]; the +/- scatter of those
// planes to the 9 donor offsets (remap._geom_accumulators) and the
// back-shift of each offset's planes by -offset: GSH (9, 10, ny, nx) in
// remap.ALL_OFFSETS order.  In GA mode (emit_shifted = 0) it skips the
// back-shift and writes the accumulators GA (9, 10, ny, nx) themselves
// (remap_cuda.ga_planes_plain).
//
// The identity that fuses the two steps.  With s(e, p) = shift_of(e, p) and
// back_e the west (east edge) or south (north edge) neighbour:
//   GA[o](x) = sum of  + P[e][p](x)          where s(e, p) = off_o,
//                      - P[e][p](x + back_e) where s(e, p) + back_e = off_o,
//   GSH[o](c) = GA[o](c - off_o),
// so every term of GSH[o](c) reads P[e][p] at c - s(e, p), inside the 3 x 3
// neighbourhood of c; in GA mode the terms read c and c + back_e.  A block
// that owns a tile of cells therefore needs the moments of its tile plus a
// one-cell halo, and nothing from device memory but dx, dy and afac.
//
// Design: one launch, no scratch in device memory, no atomics.  A block owns
// a tile of 32 x rows cells, two threads a cell (blockDim (32, rows, 2)):
//  1. stage dx, dy and afac on the tile plus a halo of 2 cells on the west
//     and south and 1 on the east and north (a halo cell's edges read its
//     west or south neighbour) with cp.async; cyclic edges wrap while
//     staging, a cell beyond an open or closed edge stages 0 (the plain
//     version's masked shift);
//  2. the edge geometry and moments of both edges of every cell of the tile
//     plus a one-cell halo, one thread an (edge, cell), into shared memory:
//     120 values a cell (2 edges x 6 positions x 10 monomials); the halo's
//     moments are computed again by the neighbouring block;
//  3. after a barrier, each thread assembles half of its cell's 9 offsets
//     (the even ones, or the odd ones: 12 terms of the 24 each) from the
//     shared planes and writes them: a warp's stores are 32 consecutive
//     cells of one plane.
// Each output adds its terms in the plain version's order (edge, then
// position), and a term is 0 where the reference's shifts bring 0: in GSH
// mode the reference shifts twice (back inside GA, then -off into GSH), so
// a term counts only where c - off lies inside the grid (or across a cyclic
// edge) and, for a back term, where c - off + back = c - s does as well;
// both tests are kept, not one combined shift.  The geometry keeps the
// sequence of conditional triangle selections of sel_tri exactly (a later
// case overwrites an earlier one).  The quadrature order is a template
// parameter, so its weights are constants and its point loops unroll; the
// edge is one too in the moment code, so the shift tables fold away and no
// per-thread array is indexed at run time.  The tile is the deepest of 8,
// 4, 2, 1 rows whose shared memory fits a block (tiled::plan_tile, as K12,
// K1 and K2 pick theirs): 32 x 8 in f32 (167,820 bytes, one block of 512
// threads an SM), 32 x 4 in f64.
// The case tests (xdl < xcl, yil > 0, |md| > puny, ...) compare computed
// values near zero, and an FMA could flip one: the source is built with
// -fmad=false, so each product and sum is rounded as in eager PyTorch.  With
// `codes` not null, the kernel also writes each owned cell's edge case codes
// (the bits of the 8 corner cases, then the index of the centre case), for
// comparison with remap_cuda.edge_cases_plain.
//
// The tripole and tripoleT folds (GSH mode; the JAX package runs them in its
// XLA GA path, cice4_tpu/ops/remap.py:1139-1174).  GA never folds: its back
// shifts are west and south.  GSH[O] = S_-off(GA[O]) reads north for the
// offsets with dj = -1, and from the top row that read crosses the fold:
// the ghost row is row src (ny-1 on the U-fold grid, ny-2 on the T-fold
// one) reversed, read after the x shift, so GSH[O](ny-1, i) = GSH[O](src-1,
// nx-1-i), an ordinary cell of the grid.  The identity above does not hold
// across the fold, so step 3 leaves those 3 offsets of the top row, and the
// blocks of the top tile row then compute them (step 4): a one-row tile of
// the mirror columns (src-1, nx-32-i0 ...) staged and its moments computed
// as in steps 1 and 2, in the same shared memory, and each top-row cell
// assembles offsets 6-8 of its mirror cell with the unfolded identity.  The
// other blocks never branch into it.
//
// What bounds it on an H100: its bytes, 3 (ny, nx) planes read and 90
// written (45.71 MB at gx1 in f32, 0.0136 ms at 3.35 TB/s), against ~1.9 k
// operations a cell at order 2, a third more with the halo's recompute at 32
// x 8, each an instruction of its own without FMA (0.24 G a call, ~0.01 ms
// at the card's non-FMA issue rate).  The 120 moment planes, 2.6 times the
// bytes the function must move, never leave shared memory.
//
// C interface (ew/ns 0 = cyclic, 1 = open or closed; ns 2 = tripole, 3 =
// tripoleT, in GSH mode only and with ny >= ns):
//   remap_gsh_f32 / remap_gsh_f64 (dx, dy, afac, gsh, codes, ny, nx, ew, ns,
//     order, emit_shifted, stream): one launch; they return the launch's
//     error code, -1 for an order other than 1, 2, 3 or no tile that fits,
//     cudaErrorInvalidValue for a boundary code they do not take;
//   remap_gsh_tile_f32 / remap_gsh_tile_f64 (order, rows, smem,
//     blocks_per_sm): the tile such a call launches with and the blocks the
//     runtime keeps resident on an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_tile.cuh"

namespace {

using tiled::commit_copies;
using tiled::copies_landed;
using tiled::copy_async;
using tiled::kSplit;
using tiled::kTileW;

constexpr double kPuny = 1.0e-11;
constexpr double kEps16 = 1.0e-16;
enum Pos { TL = 0, BL = 1, TR = 2, BR = 3, TC = 4, BC = 5 };

// The static tables, as arithmetic: no array, so nothing of them can land in
// a stack frame where a loop is not unrolled; with constant arguments they
// fold away.

// (ishift, jshift) of position p on edge e (0 = east, 1 = north):
// east  TL (1, 1), BL (0, 1), TR (1, -1), BR (0, -1), TC (1, 0), BC (0, 0);
// north TL (-1, 1), BL (-1, 0), TR (1, 1), BR (1, 0), TC (0, 1), BC (0, 0)
__host__ __device__ constexpr int shift_of(int e, int p, int d) {
  return (e == 0) == (d == 0) ? (p % 2 == 0 ? 1 : 0)
                              : (p < 2 ? (e == 0 ? 1 : -1)
                                       : (p < 4 ? (e == 0 ? -1 : 1) : 0));
}
// the back shift of each edge: east -> west neighbour, north -> south
__host__ __device__ constexpr int back_of(int e, int d) {
  return (e == 0) == (d == 0) ? -1 : 0;
}
// remap.ALL_OFFSETS: (di, dj) for dj in (1, 0, -1) for di in (-1, 0, 1)
__host__ __device__ constexpr int off_of(int o, int d) {
  return d == 0 ? o % 3 - 1 : 1 - o / 3;
}
// GROUP_POSITIONS as bit masks: (TL, BL), (TR, BR), (TL, BL, TR, BR), and
// (TC, BC) for the three centre groups
__host__ __device__ constexpr int group_positions(int g) {
  return g == 0 ? (1 << TL) | (1 << BL)
                : (g == 1 ? (1 << TR) | (1 << BR)
                          : (g == 2 ? (1 << TL) | (1 << BL) | (1 << TR) |
                                          (1 << BR)
                                    : (1 << TC) | (1 << BC)));
}
static_assert(shift_of(0, TL, 0) == 1 && shift_of(0, TL, 1) == 1 &&
                  shift_of(0, BL, 0) == 0 && shift_of(0, BL, 1) == 1 &&
                  shift_of(0, TR, 0) == 1 && shift_of(0, TR, 1) == -1 &&
                  shift_of(0, BR, 0) == 0 && shift_of(0, BR, 1) == -1 &&
                  shift_of(0, TC, 0) == 1 && shift_of(0, TC, 1) == 0 &&
                  shift_of(0, BC, 0) == 0 && shift_of(0, BC, 1) == 0,
              "east shifts");
static_assert(shift_of(1, TL, 0) == -1 && shift_of(1, TL, 1) == 1 &&
                  shift_of(1, BL, 0) == -1 && shift_of(1, BL, 1) == 0 &&
                  shift_of(1, TR, 0) == 1 && shift_of(1, TR, 1) == 1 &&
                  shift_of(1, BR, 0) == 1 && shift_of(1, BR, 1) == 0 &&
                  shift_of(1, TC, 0) == 0 && shift_of(1, TC, 1) == 1 &&
                  shift_of(1, BC, 0) == 0 && shift_of(1, BC, 1) == 0,
              "north shifts");
// the shift of a run-time position on a constant edge, as selections
template <int EDGE>
__device__ __forceinline__ int shift_at(int pos, int d) {
  int v = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p) v = pos == p ? shift_of(EDGE, p, d) : v;
  return v;
}

// quadrature of order 1-3 (remap._quad_points): points and weights
template <int ORDER>
struct Quad {
  static constexpr int n = ORDER == 1 ? 1 : (ORDER == 2 ? 3 : 4);
  __host__ __device__ static constexpr double w(int q) {
    return ORDER == 1 ? 1.0
                      : (ORDER == 2 ? 1.0 / 3.0
                                    : (q == 0 ? -0.5625 : 0.52083333333333333));
  }
  // the weight sum in the plain version's order, a double there (a Python
  // float)
  __host__ __device__ static constexpr double wsum() {
    double s = 0.0;
    for (int q = 0; q < n; ++q) s += w(q);
    return s;
  }
};

struct Grid2 {
  int ny, nx, ew_cyclic, ns_cyclic;
  int fold;  // 0, or the NS code of a fold: 2 tripole, 3 tripoleT
  // flat index of (j, i), or -1 beyond an open/closed edge
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
  // whether (j, i), unwrapped, lies inside the grid or across a cyclic edge
  __device__ __forceinline__ bool ok(int j, int i) const {
    return (ew_cyclic || (i >= 0 && i < nx)) &&
           (ns_cyclic || (j >= 0 && j < ny));
  }
};

// shared memory of a block, in elements
struct GshLayout {
  int wi, in_plane;  // inputs: (rows + 3) x (32 + 3) from (j0 - 2, i0 - 2)
  int wm, cells;     // moments: (rows + 2) x (32 + 2) from (j0 - 1, i0 - 1)
  int in, mom, total;
  __host__ __device__ explicit GshLayout(int rows) {
    wi = kTileW + 3;
    in_plane = wi * (rows + 3);
    wm = kTileW + 2;
    cells = wm * (rows + 2);
    in = 0;                   // dx, dy, afac planes
    mom = in + 3 * in_plane;  // 120 planes: ((edge * 6 + pos) * 10 + k)
    total = mom + 120 * cells;
  }
};

// the threads a block may have: 2 a cell of the deepest tile in f32; in f64
// at most 256, so that ptxas may give a thread up to 255 registers (no f64
// tile deeper than 4 rows fits the shared memory anyway)
template <typename T>
struct GshThreads {
  static constexpr int value = sizeof(T) == 4 ? kSplit * kTileW * 8 : 256;
};

template <typename T>
struct Tri {
  T x1, y1, x2, y2, x3, y3, fac;
  int pos;
};

template <typename T>
__device__ __forceinline__ void sel(bool cond, Tri<T>& t, T x1, T y1, T x2,
                                    T y2, T x3, T y3, int pos, T fac) {
  if (cond) {
    t.x1 = x1; t.y1 = y1; t.x2 = x2; t.y2 = y2; t.x3 = x3; t.y3 = y3;
    t.pos = pos;
    t.fac = fac;
  }
}

// The departure triangles of one edge (remap._edge_geometry, free-area
// mode) from the departure points of its left and right ends and their area
// factors: the 6 group triangles, the case code, and afc.
template <typename T>
__device__ __forceinline__ int edge_geometry(T xdl, T ydl, T xdr, T ydr,
                                             T afl, T afr, Tri<T> (&t)[6],
                                             T& afc) {
  const T puny = T(kPuny);
  afc = T(0.5) * (afl + afr);
  const T xcl = T(-0.5), xcr = T(0.5), zero = T(0);

  const T xdm = T(0.5) * (xdr + xdl);
  const T ydm = T(0.5) * (ydr + ydl);

  T dxseg = (fabs(xdm - xdl) > zero) ? xdm - xdl : puny;
  const T yil = (xcl * (ydm - ydl) + xdm * ydl - xdl * ydm) / dxseg;
  dxseg = (fabs(xdr - xdm) > zero) ? xdr - xdm : puny;
  const T yir = (xcr * (ydr - ydm) - xdm * ydr + xdr * ydm) / dxseg;

  const T md = (ydr - ydl) / ((fabs(xdr - xdl) > zero) ? xdr - xdl : puny);
  const T xic = (fabs(md) > puny) ? xdl - ydl / ((md != zero) ? md : T(1))
                                  : zero;
  const T yic = zero;
  const T xil = xcl, xir = xcr;
  const T CL = xcl, CR = xcr, Z = zero;

#pragma unroll
  for (int k = 0; k < 6; ++k) {
    t[k].x1 = t[k].y1 = t[k].x2 = t[k].y2 = t[k].x3 = t[k].y3 = zero;
    t[k].fac = zero;
    t[k].pos = BC;
  }

  // left corner triangles (groups 0 and 2)
  const bool left = xdl < xcl;
  const bool c_tl = left && (yil > zero) && (ydl >= zero);
  const bool c_bl = left && (yil < zero) && (ydl < zero);
  const bool c_tl1 = left && (yil < zero) && (ydl >= zero);
  const bool c_tl2 = left && (yil > zero) && (ydl < zero);
  sel(c_tl, t[0], CL, Z, xil, yil, xdl, ydl, TL, -afl);
  sel(c_bl, t[0], CL, Z, xdl, ydl, xil, yil, BL, afl);
  sel(c_tl1, t[0], CL, Z, xdl, ydl, xic, yic, TL, afl);
  sel(c_tl1, t[2], CL, Z, xic, yic, xil, yil, BL, afl);
  sel(c_tl2, t[2], CL, Z, xil, yil, xic, yic, TL, -afl);
  sel(c_tl2, t[0], CL, Z, xic, yic, xdl, ydl, BL, -afl);

  // right corner triangles (groups 1 and 2)
  const bool right = xdr >= xcr;
  const bool c_tr = right && (yir > zero) && (ydr >= zero);
  const bool c_br = right && (yir < zero) && (ydr < zero);
  const bool c_tr1 = right && (yir < zero) && (ydr >= zero);
  const bool c_tr2 = right && (yir > zero) && (ydr < zero);
  sel(c_tr, t[1], CR, Z, xdr, ydr, xir, yir, TR, -afr);
  sel(c_br, t[1], CR, Z, xir, yir, xdr, ydr, BR, afr);
  sel(c_tr1, t[1], CR, Z, xic, yic, xdr, ydr, TR, afr);
  sel(c_tr1, t[2], CR, Z, xir, yir, xic, yic, BR, afr);
  sel(c_tr2, t[2], CR, Z, xic, yic, xir, yir, TR, -afr);
  sel(c_tr2, t[1], CR, Z, xdr, ydr, xic, yic, BR, -afr);

  // DL/DR moved to the edge intersections if beyond the corners
  const T xdl2 = left ? xil : xdl, ydl2 = left ? yil : ydl;
  const T xdr2 = right ? xir : xdr, ydr2 = right ? yir : ydr;
  const T icl = xic, icr = xic;

  // centre triangles (groups 3, 4, 5): the 12 cases in sequence
  const bool dlp = ydl2 >= zero, drp = ydr2 >= zero, dmp = ydm >= zero,
             icp = xic >= zero;
  int center = 0;
#define TRI(ax, ay, bx, by, cx, cy) ax, ay, bx, by, cx, cy
#define CASE(n, cond, A, posA, facA, B, posB, facB, C, posC, facC) \
  if (cond) {                                                     \
    sel(true, t[3], A, posA, facA);                               \
    sel(true, t[4], B, posB, facB);                               \
    sel(true, t[5], C, posC, facC);                               \
    center = n;                                                   \
  }
  CASE(1, dlp && drp && dmp,
       TRI(CL, Z, CR, Z, xdl2, ydl2), TC, -afc,
       TRI(CR, Z, xdr2, ydr2, xdl2, ydl2), TC, -afc,
       TRI(xdl2, ydl2, xdr2, ydr2, xdm, ydm), TC, -afc)
  CASE(2, dlp && drp && !dmp,
       TRI(CL, Z, icl, yic, xdl2, ydl2), TC, -afc,
       TRI(CR, Z, xdr2, ydr2, icr, yic), TC, -afc,
       TRI(icr, yic, icl, yic, xdm, ydm), BC, afc)
  CASE(3, !dlp && !drp && !dmp,
       TRI(CL, Z, xdl2, ydl2, CR, Z), BC, afc,
       TRI(CR, Z, xdl2, ydl2, xdr2, ydr2), BC, afc,
       TRI(xdl2, ydl2, xdm, ydm, xdr2, ydr2), BC, afc)
  CASE(4, !dlp && !drp && dmp,
       TRI(CL, Z, xdl2, ydl2, icl, yic), BC, afc,
       TRI(CR, Z, icr, yic, xdr2, ydr2), BC, afc,
       TRI(icl, yic, icr, yic, xdm, ydm), TC, -afc)
  CASE(5, dlp && !drp && icp && dmp,
       TRI(CL, Z, icr, yic, xdl2, ydl2), TC, -afc,
       TRI(CR, Z, icr, yic, xdr2, ydr2), BC, afr,
       TRI(xdl2, ydl2, icr, yic, xdm, ydm), TC, -afc)
  CASE(6, dlp && !drp && icp && !dmp,
       TRI(CL, Z, icl, yic, xdl2, ydl2), TC, -afc,
       TRI(CR, Z, icr, yic, xdr2, ydr2), BC, afr,
       TRI(icr, yic, icl, yic, xdm, ydm), BC, afc)
  CASE(7, dlp && !drp && !icp && !dmp,
       TRI(CL, Z, icl, yic, xdl2, ydl2), TC, -afl,
       TRI(CR, Z, icl, yic, xdr2, ydr2), BC, afc,
       TRI(xdr2, ydr2, icl, yic, xdm, ydm), BC, afc)
  CASE(8, dlp && !drp && !icp && dmp,
       TRI(CL, Z, icl, yic, xdl2, ydl2), TC, -afl,
       TRI(CR, Z, icr, yic, xdr2, ydr2), BC, afc,
       TRI(icl, yic, icr, yic, xdm, ydm), TC, -afc)
  CASE(9, !dlp && drp && !icp && dmp,
       TRI(CL, Z, xdl2, ydl2, icl, yic), BC, afl,
       TRI(CR, Z, xdr2, ydr2, icl, yic), TC, -afc,
       TRI(icl, yic, xdr2, ydr2, xdm, ydm), TC, -afc)
  CASE(10, !dlp && drp && !icp && !dmp,
       TRI(CL, Z, xdl2, ydl2, icl, yic), BC, afl,
       TRI(CR, Z, xdr2, ydr2, icr, yic), TC, -afc,
       TRI(icr, yic, icl, yic, xdm, ydm), BC, afc)
  CASE(11, !dlp && drp && icp && !dmp,
       TRI(CL, Z, xdl2, ydl2, icr, yic), BC, afc,
       TRI(CR, Z, xdr2, ydr2, icr, yic), TC, -afr,
       TRI(icr, yic, xdl2, ydl2, xdm, ydm), BC, afc)
  CASE(12, !dlp && drp && icp && dmp,
       TRI(CL, Z, xdl2, ydl2, icl, yic), BC, afc,
       TRI(CR, Z, xdr2, ydr2, icr, yic), TC, -afr,
       TRI(icl, yic, icr, yic, xdm, ydm), TC, -afc)
#undef CASE
#undef TRI

  return (int)c_tl | ((int)c_bl << 1) | ((int)c_tl1 << 2) |
         ((int)c_tl2 << 3) | ((int)c_tr << 4) | ((int)c_br << 5) |
         ((int)c_tr1 << 6) | ((int)c_tr2 << 7) | (center << 8);
}

// The moment planes of edge EDGE of one cell (remap._geom_moments): for each
// position p, the sum over the groups that may take p, in group order, of
// area * the 10 quadrature moments of the group's triangle where it lies at
// p.  `in` is the cell in the staged input planes (width wi), `mom` the
// cell's plane (EDGE, 0, 0) in the moment planes of `cells` elements.
// Returns the edge's case code.
template <typename T, int ORDER, int EDGE>
__device__ __forceinline__ int edge_moments(const T* in, int in_plane, int wi,
                                            T* mom, int cells) {
  const T* sdx = in;
  const T* sdy = in + in_plane;
  const T* saf = in + 2 * in_plane;
  T xdl, ydl, xdr, ydr, afl, afr;
  if (EDGE == 1) {  // north: the west neighbour is the left end
    xdl = T(-0.5) + sdx[-1];
    ydl = sdy[-1];
    xdr = T(0.5) + sdx[0];
    ydr = sdy[0];
    afl = saf[-1];
    afr = saf[0];
  } else {  // east; trajectory rotated by pi/2, the south neighbour right
    xdl = T(-0.5) - sdy[0];
    ydl = sdx[0];
    xdr = T(0.5) - sdy[-wi];
    ydr = sdx[-wi];
    afl = saf[0];
    afr = saf[-wi];
  }
  Tri<T> t[6];
  T afc;
  const int code = edge_geometry(xdl, ydl, xdr, ydr, afl, afr, t, afc);

#pragma unroll
  for (int k = 0; k < 60; ++k) mom[k * cells] = T(0);

  using Q = Quad<ORDER>;
  const T zero = T(0);
#pragma unroll
  for (int gi = 0; gi < 6; ++gi) {
    const Tri<T>& tr = t[gi];
    T area = T(0.5) * ((tr.x2 - tr.x1) * (tr.y3 - tr.y1) -
                       (tr.y2 - tr.y1) * (tr.x3 - tr.x1)) * tr.fac;
    if (fabs(area) < T(kEps16) * afc) area = zero;
    if (!((group_positions(gi) >> tr.pos) & 1)) continue;

    // flux-cell coordinates
    const T isg = T(shift_at<EDGE>(tr.pos, 0));
    const T jsg = T(shift_at<EDGE>(tr.pos, 1));
    T lx[3], ly[3];
    if (EDGE == 1) {
      lx[0] = tr.x1 - isg; lx[1] = tr.x2 - isg; lx[2] = tr.x3 - isg;
      ly[0] = tr.y1 + T(0.5) - jsg; ly[1] = tr.y2 + T(0.5) - jsg;
      ly[2] = tr.y3 + T(0.5) - jsg;
    } else {
      lx[0] = tr.y1 + T(0.5) - isg; lx[1] = tr.y2 + T(0.5) - isg;
      lx[2] = tr.y3 + T(0.5) - isg;
      ly[0] = -tr.x1 - jsg; ly[1] = -tr.x2 - jsg; ly[2] = -tr.x3 - jsg;
    }
    const T x0 = (lx[0] + lx[1] + lx[2]) / T(3.0);
    const T y0 = (ly[0] + ly[1] + ly[2]) / T(3.0);
    T px[Q::n], py[Q::n];
    if constexpr (ORDER == 1) {
      px[0] = x0; py[0] = y0;
    } else if constexpr (ORDER == 2) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        px[q] = T(0.5) * lx[q] + T(0.5) * x0;
        py[q] = T(0.5) * ly[q] + T(0.5) * y0;
      }
    } else {
      px[0] = x0; py[0] = y0;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        px[q + 1] = T(0.4) * lx[q] + T(0.6) * x0;
        py[q + 1] = T(0.4) * ly[q] + T(0.6) * y0;
      }
    }
    T mono[10];
#pragma unroll
    for (int k = 1; k < 10; ++k) mono[k] = zero;
#pragma unroll
    for (int q = 0; q < Q::n; ++q) {
      const T w = T(Q::w(q));
      const T x = px[q], y = py[q];
      const T xx = x * x, xy = x * y, yy = y * y;
      mono[1] = mono[1] + w * x;
      mono[2] = mono[2] + w * y;
      mono[3] = mono[3] + w * xx;
      mono[4] = mono[4] + w * xy;
      mono[5] = mono[5] + w * yy;
      mono[6] = mono[6] + w * xx * x;
      mono[7] = mono[7] + w * xx * y;
      mono[8] = mono[8] + w * xy * y;
      mono[9] = mono[9] + w * yy * y;
    }
    mono[0] = T(Q::wsum());
    T* acc = mom + tr.pos * 10 * cells;
#pragma unroll
    for (int k = 0; k < 10; ++k)
      acc[k * cells] = acc[k * cells] + area * mono[k];
  }
  return code;
}

// One owned cell's 10 outputs of offset O: the terms of the plain version
// in its order (edge, then position) read from the shared moment planes,
// each counted only where the reference's shifts do not bring 0.  (r, q):
// the cell in the moment tile (width wm); (j, i): the cell in the grid.
template <typename T, int O>
__device__ __forceinline__ void assemble(const T* mom, int cells, int wm,
                                         int r, int q, int j, int i,
                                         const Grid2& g, bool emit_shifted,
                                         bool top_of_fold, T* out,
                                         int64_t np) {
  constexpr int di = off_of(O, 0), dj = off_of(O, 1);
  if (dj == -1 && top_of_fold) return;  // read across the fold: step 4
  // GSH mode: GSH[O](c) = GA[O](x), x = c - off, which is 0 beyond an open
  // or closed edge
  const bool x_ok = !emit_shifted || g.ok(j - dj, i - di);
  T acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = T(0);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int sdi = shift_of(e, p, 0), sdj = shift_of(e, p, 1);
      const int bi = back_of(e, 0), bj = back_of(e, 1);
      const bool direct = sdi == di && sdj == dj;
      const bool back = !direct && sdi + bi == di && sdj + bj == dj;
      if (!direct && !back) continue;
      int rr, qq;
      bool ok;
      if (emit_shifted) {  // every term reads c - s(e, p)
        rr = r - sdj;
        qq = q - sdi;
        // a back term reads x + back = c - s: both shifts must stay inside
        ok = x_ok && (direct || g.ok(j - sdj, i - sdi));
      } else if (direct) {  // GA mode: the cell itself
        rr = r;
        qq = q;
        ok = true;
      } else {  // GA mode: the back neighbour
        rr = r + bj;
        qq = q + bi;
        ok = g.ok(j + bj, i + bi);
      }
      if (!ok) continue;
      const T* pl = mom + (e * 6 + p) * 10 * cells + rr * wm + qq;
#pragma unroll
      for (int k = 0; k < 10; ++k)
        acc[k] = direct ? acc[k] + pl[k * cells] : acc[k] - pl[k * cells];
    }
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) out[(int64_t)(O * 10 + k) * np] = acc[k];
}

// 1. the inputs of the tile of L's rows at (j0, i0) plus its halo, into `in`
template <typename T>
__device__ __forceinline__ void stage_inputs(const T* dx, const T* dy,
                                             const T* afac, T* in,
                                             const GshLayout& L, int j0,
                                             int i0, const Grid2& g, int tid,
                                             int nthreads) {
  for (int k = tid; k < L.in_plane; k += nthreads) {
    const int64_t x = g.idx(j0 - 2 + k / L.wi, i0 - 2 + k % L.wi);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      T* dst = in + f * L.in_plane + k;
      if (x < 0) {
        *dst = T(0);
      } else {
        copy_async(dst, (f == 0 ? dx : (f == 1 ? dy : afac)) + x);
      }
    }
  }
  commit_copies();
  copies_landed();
  __syncthreads();
}

// 2. both edges' moments of that tile plus a one-cell halo, from `in` into
// `mom`; with `codes` not null the owned cells' case codes too
template <typename T, int ORDER>
__device__ __forceinline__ void tile_moments(const T* in, T* mom,
                                             const GshLayout& L, int rows,
                                             int j0, int i0, const Grid2& g,
                                             int* codes, int tid,
                                             int nthreads) {
  const int64_t np = (int64_t)g.ny * g.nx;
  for (int k = tid; k < 2 * L.cells; k += nthreads) {
    const int e = k >= L.cells;
    const int cell = k - e * L.cells;
    const int hr = cell / L.wm, hq = cell - hr * L.wm;
    const T* cin = in + (hr + 1) * L.wi + hq + 1;
    T* cm = mom + e * 60 * L.cells + cell;
    const int code =
        e == 0 ? edge_moments<T, ORDER, 0>(cin, L.in_plane, L.wi, cm, L.cells)
               : edge_moments<T, ORDER, 1>(cin, L.in_plane, L.wi, cm, L.cells);
    // only the owning block writes a cell's codes
    const int j = j0 - 1 + hr, i = i0 - 1 + hq;
    if (codes != nullptr && hr >= 1 && hr <= rows && hq >= 1 &&
        hq <= kTileW && j < g.ny && i < g.nx)
      codes[e * np + (int64_t)j * g.nx + i] = code;
  }
  __syncthreads();
}

// FOLD: the instance for a tripole grid; the other grids run the one without
template <typename T, int ORDER, bool FOLD>
__global__ void __launch_bounds__(GshThreads<T>::value)
    gsh_fused(const T* __restrict__ dx, const T* __restrict__ dy,
              const T* __restrict__ afac, T* __restrict__ gsh,
              int* __restrict__ codes, Grid2 g, int emit_shifted) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int rows = blockDim.y;
  const GshLayout L(rows);
  const int nthreads = kTileW * rows * kSplit;
  const int tid = (threadIdx.z * rows + threadIdx.y) * kTileW + threadIdx.x;
  const int j0 = blockIdx.y * rows, i0 = blockIdx.x * kTileW;
  const int64_t np = (int64_t)g.ny * g.nx;

  // 1. and 2.: the moments of the tile plus a one-cell halo
  stage_inputs(dx, dy, afac, smem + L.in, L, j0, i0, g, tid, nthreads);
  T* mom = smem + L.mom;
  tile_moments<T, ORDER>(smem + L.in, mom, L, rows, j0, i0, g, codes, tid,
                         nthreads);

  // 3. the 9 offsets of each owned cell, even ones by z = 0, odd by z = 1;
  // under a fold the top row's offsets with dj = -1 are left to step 4
  const int j = j0 + threadIdx.y, i = i0 + threadIdx.x;
  const bool emit = emit_shifted != 0;
  if (j < g.ny && i < g.nx) {
    T* out = gsh + (int64_t)j * g.nx + i;
    const int r = threadIdx.y + 1, q = threadIdx.x + 1;
    const bool top = FOLD && j == g.ny - 1;
    if (threadIdx.z == 0) {
      assemble<T, 0>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
      assemble<T, 2>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
      assemble<T, 4>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
      assemble<T, 6>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
      assemble<T, 8>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
    } else {
      assemble<T, 1>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
      assemble<T, 3>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
      assemble<T, 5>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
      assemble<T, 7>(mom, L.cells, L.wm, r, q, j, i, g, emit, top, out, np);
    }
  }
  if (!FOLD || blockIdx.y != gridDim.y - 1) return;

  // 4. the fold (GSH mode, the blocks of the top row): GSH[O] = S_-off(GA[O])
  // reads north for dj = -1, and the ghost row beyond the top row is row
  // src = ny-1 (tripole) or ny-2 (tripoleT) reversed, so GSH[O](ny-1, i) =
  // GSH[O](src-1, nx-1-i), an ordinary cell of the grid (the x shift comes
  // first and the fold reverses the row for every offset alike).  The block
  // computes those from a one-row tile of the mirror columns, 32 x 1 cells
  // at (src-1, nx-32-i0) plus its halo, in the same shared memory.
  __syncthreads();  // every thread is done with the tile's moments
  const GshLayout L1(1);
  const int jv = (g.fold == 2 ? g.ny - 1 : g.ny - 2) - 1;
  const int iv0 = g.nx - kTileW - i0;
  stage_inputs(dx, dy, afac, smem + L1.in, L1, jv, iv0, g, tid, nthreads);
  T* mom1 = smem + L1.mom;
  tile_moments<T, ORDER>(smem + L1.in, mom1, L1, 1, jv, iv0, g, nullptr, tid,
                         nthreads);
  if (threadIdx.y != 0 || i >= g.nx) return;
  // the mirror cell (jv, nx-1-i) sits at column 32 - x of the one-row tile
  T* out = gsh + (int64_t)(g.ny - 1) * g.nx + i;
  const int q1 = kTileW - threadIdx.x, im = g.nx - 1 - i;
  if (threadIdx.z == 0) {
    assemble<T, 6>(mom1, L1.cells, L1.wm, 1, q1, jv, im, g, true, false, out,
                   np);
    assemble<T, 8>(mom1, L1.cells, L1.wm, 1, q1, jv, im, g, true, false, out,
                   np);
  } else {
    assemble<T, 7>(mom1, L1.cells, L1.wm, 1, q1, jv, im, g, true, false, out,
                   np);
  }
}

// the tile of a call (the same for both instances)
template <typename T, int ORDER, bool FOLD = false>
int plan(int* rows, int* smem, int* blocks_per_sm) {
  return tiled::plan_tile(
      gsh_fused<T, ORDER, FOLD>, kSplit * kTileW,
      [](int r) -> size_t {
        if (kSplit * kTileW * r > GshThreads<T>::value) return SIZE_MAX;
        return sizeof(T) * GshLayout(r).total;
      },
      rows, smem, blocks_per_sm);
}

template <typename T, bool FOLD = false>
int plan_order(int order, int* rows, int* smem, int* blocks_per_sm) {
  switch (order) {
    case 1: return plan<T, 1, FOLD>(rows, smem, blocks_per_sm);
    case 2: return plan<T, 2, FOLD>(rows, smem, blocks_per_sm);
    case 3: return plan<T, 3, FOLD>(rows, smem, blocks_per_sm);
    default: return -1;
  }
}

template <typename T, int ORDER>
void launch_order(bool fold, dim3 grid, dim3 block, int smem,
                  cudaStream_t stream, const T* a, const T* b, const T* c,
                  T* o, int* k, const Grid2& g, int emit_shifted) {
  if (fold)
    gsh_fused<T, ORDER, true><<<grid, block, smem, stream>>>(a, b, c, o, k, g,
                                                            emit_shifted);
  else
    gsh_fused<T, ORDER, false><<<grid, block, smem, stream>>>(a, b, c, o, k,
                                                             g, emit_shifted);
}

template <typename T>
int run(const void* dx, const void* dy, const void* afac, void* gsh,
        void* codes, int ny, int nx, int ew, int ns, int order,
        int emit_shifted, cudaStream_t stream) {
  // a fold: GSH mode only, and a row src-1 to mirror (src = ny-1 or ny-2)
  if (ew < 0 || ew > 1 || ns < 0 || ns > 3 ||
      (ns >= 2 && (!emit_shifted || ny < ns)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fold = ns >= 2;
  int rows = 0, smem = 0;
  const int rc = fold ? plan_order<T, true>(order, &rows, &smem, nullptr)
                      : plan_order<T, false>(order, &rows, &smem, nullptr);
  if (rc != 0) return rc;
  const Grid2 g{ny, nx, ew == 0, ns == 0, fold ? ns : 0};
  const dim3 block(kTileW, rows, kSplit);
  const dim3 grid((nx + kTileW - 1) / kTileW, (ny + rows - 1) / rows);
  const T* a = static_cast<const T*>(dx);
  const T* b = static_cast<const T*>(dy);
  const T* c = static_cast<const T*>(afac);
  T* o = static_cast<T*>(gsh);
  int* k = static_cast<int*>(codes);
  if (order == 1)
    launch_order<T, 1>(fold, grid, block, smem, stream, a, b, c, o, k, g,
                       emit_shifted);
  else if (order == 2)
    launch_order<T, 2>(fold, grid, block, smem, stream, a, b, c, o, k, g,
                       emit_shifted);
  else
    launch_order<T, 3>(fold, grid, block, smem, stream, a, b, c, o, k, g,
                       emit_shifted);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int remap_gsh_f32(const void* dx, const void* dy, const void* afac, void* gsh,
                  void* codes, int ny, int nx, int ew, int ns, int order,
                  int emit_shifted, void* stream) {
  return run<float>(dx, dy, afac, gsh, codes, ny, nx, ew, ns, order,
                    emit_shifted, static_cast<cudaStream_t>(stream));
}

int remap_gsh_f64(const void* dx, const void* dy, const void* afac, void* gsh,
                  void* codes, int ny, int nx, int ew, int ns, int order,
                  int emit_shifted, void* stream) {
  return run<double>(dx, dy, afac, gsh, codes, ny, nx, ew, ns, order,
                     emit_shifted, static_cast<cudaStream_t>(stream));
}

int remap_gsh_tile_f32(int order, int* rows, int* smem, int* blocks_per_sm) {
  return plan_order<float>(order, rows, smem, blocks_per_sm);
}

int remap_gsh_tile_f64(int order, int* rows, int* smem, int* blocks_per_sm) {
  return plan_order<double>(order, rows, smem, blocks_per_sm);
}

}  // extern "C"
