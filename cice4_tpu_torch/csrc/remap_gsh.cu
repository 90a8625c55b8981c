// remap_gsh.cu — geometric divergence accumulators of incremental remapping
// (the GSH tensor) on Hopper.
//
// Replaces the TPU kernel K0, cice4_tpu/ops/remap_pallas.py::_ga_kernel
// (:70-132), in both its modes: GSH mode (emit_shifted, host code
// ga_gsh_pallas :135-154) and GA mode (the K0 of the K0 -> K1 -> K2 route,
// remap_pallas_divergence :569-576).  In GSH mode it computes what the plain
// version cice4_tpu_torch/ops/remap_cuda.py::ga_gsh_plain computes: for the
// east and north edge of every cell, the up-to-6 departure triangles
// (remap._edge_geometry, free-area mode), the 10 monomial moments of each by
// quadrature of order 1-3 (remap._quad_points), summed per donor position
// (remap._geom_moments); the +/- scatter of those moment planes to the 9
// donor offsets (remap._geom_accumulators) and the back-shift of each
// offset's planes by -offset: GSH (9, 10, ny, nx) in remap.ALL_OFFSETS order.
// In GA mode (emit_shifted = 0) it skips the back-shift and writes the
// accumulators GA (9, 10, ny, nx) themselves (remap_cuda.ga_planes_plain).
//
// Design.  Two kernels, no atomics:
//  * edge_moments, one thread per (edge direction, cell): the edge geometry,
//    with the sequence of conditional triangle selections of sel_tri kept
//    exactly (a later case overwrites an earlier one), the areas, the
//    flux-cell coordinates, the quadrature, and the moment sums per position,
//    written to a scratch tensor planes (2, 6, 10, ny, nx);
//  * gather_gsh, one thread per cell: GSH[off](c) = GA[off](c - off) (GA mode:
//    GA[off](c)), and
//    GA[off](x) gathers + planes[e][p](x) where SHIFTS[e][p] == off and
//    - planes[e][p](x + back_e) where SHIFTS[e][p] + back_e == off, in the
//    (edge, position) order of the plain version.  The TPU's scatter and
//    shifts become index offsets with the masked-shift rule: a source index
//    beyond an open or closed edge contributes 0, EW/NS cyclic wraps.
// The case tests (xdl < xcl, yil > 0, |md| > puny, ...) compare computed
// values near zero, and an FMA could flip one: the source is built with
// -fmad=false, so each product and sum is rounded as in eager PyTorch.  With
// `codes` not null, edge_moments also writes each edge's case code (the bits
// of the 8 corner cases, then the index of the centre case), for comparison
// with remap_cuda.edge_cases_plain.
//
// What bounds it on an H100: memory traffic.  It reads 3 (ny, nx) planes
// and writes the 90 GSH planes; the scratch adds 120 written and 120 read
// (~96 MB at gx1 f32).  Arithmetic is ~1.5 k flops per edge, well below the
// card's rate for that traffic.  A later version can keep the moment planes
// in shared memory (a tile plus a one-cell halo) and skip the scratch.
//
// C interface: remap_gsh_f32 / remap_gsh_f64 (dx, dy, afac, planes, gsh,
// codes, ny, nx, ew, ns, order, emit_shifted, stream), ew/ns 0 = cyclic,
// 1 = open or closed; they return cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr double kPuny = 1.0e-11;
constexpr double kEps16 = 1.0e-16;
enum Pos { TL = 0, BL = 1, TR = 2, BR = 3, TC = 4, BC = 5 };

// The static tables, as functions: a namespace-scope array cannot be read in
// device code.  After unrolling, the indices are constants and fold away.

// (ishift, jshift) per position, per edge (0 = east, 1 = north)
__device__ __forceinline__ int shift_of(int e, int p, int d) {
  constexpr int s[2][6][2] = {
      {{1, 1}, {0, 1}, {1, -1}, {0, -1}, {1, 0}, {0, 0}},
      {{-1, 1}, {-1, 0}, {1, 1}, {1, 0}, {0, 1}, {0, 0}}};
  return s[e][p][d];
}
// the back shift of each edge: east -> west neighbour, north -> south
__device__ __forceinline__ int back_of(int e, int d) {
  constexpr int b[2][2] = {{-1, 0}, {0, -1}};
  return b[e][d];
}
// remap.ALL_OFFSETS: (di, dj) for dj in (1, 0, -1) for di in (-1, 0, 1)
__device__ __forceinline__ int off_of(int o, int d) {
  constexpr int f[9][2] = {{-1, 1}, {0, 1}, {1, 1}, {-1, 0}, {0, 0},
                           {1, 0}, {-1, -1}, {0, -1}, {1, -1}};
  return f[o][d];
}
// GROUP_POSITIONS as bit masks
__device__ __forceinline__ int group_positions(int g) {
  constexpr int m[6] = {(1 << TL) | (1 << BL), (1 << TR) | (1 << BR),
                        (1 << TL) | (1 << BL) | (1 << TR) | (1 << BR),
                        (1 << TC) | (1 << BC), (1 << TC) | (1 << BC),
                        (1 << TC) | (1 << BC)};
  return m[g];
}

struct Grid2 {
  int ny, nx, ew_cyclic, ns_cyclic;
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
};

template <typename T>
__device__ __forceinline__ T ld(const T* f, int64_t k) {
  return k < 0 ? T(0) : f[k];
}

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

template <typename T>
__global__ void edge_moments(const T* __restrict__ dxp,
                             const T* __restrict__ dyp,
                             const T* __restrict__ afacp, T* __restrict__ planes,
                             int* __restrict__ codes, Grid2 g, int order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int edge = blockIdx.z;  // 0 = east, 1 = north
  if (i >= g.nx || j >= g.ny) return;
  const int64_t c = (int64_t)j * g.nx + i;
  const int64_t np = (int64_t)g.ny * g.nx;
  const T puny = T(kPuny);

  T xdl, ydl, xdr, ydr, afl, afr;
  if (edge == 1) {  // north
    const int64_t w = g.idx(j, i - 1);
    xdl = T(-0.5) + ld(dxp, w);
    ydl = ld(dyp, w);
    xdr = T(0.5) + dxp[c];
    ydr = dyp[c];
    afl = ld(afacp, w);
    afr = afacp[c];
  } else {  // east; trajectory rotated by pi/2
    const int64_t s = g.idx(j - 1, i);
    xdl = T(-0.5) - dyp[c];
    ydl = dxp[c];
    xdr = T(0.5) - ld(dyp, s);
    ydr = ld(dxp, s);
    afl = afacp[c];
    afr = ld(afacp, s);
  }
  const T afc = T(0.5) * (afl + afr);
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

  Tri<T> t[6];
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

  if (codes != nullptr) {
    codes[edge * np + c] =
        (int)c_tl | ((int)c_bl << 1) | ((int)c_tl1 << 2) | ((int)c_tl2 << 3) |
        ((int)c_tr << 4) | ((int)c_br << 5) | ((int)c_tr1 << 6) |
        ((int)c_tr2 << 7) | (center << 8);
  }

  // quadrature weights; the weight sum stays a double, as in the plain
  // version, where it is a Python float
  double wsum = 0.0;
  int npts;
  double wq[4];
  if (order == 1) {
    npts = 1; wq[0] = 1.0;
  } else if (order == 2) {
    npts = 3; wq[0] = wq[1] = wq[2] = 1.0 / 3.0;
  } else {
    npts = 4; wq[0] = -0.5625; wq[1] = wq[2] = wq[3] = 0.52083333333333333;
  }
  for (int q = 0; q < npts; ++q) wsum += wq[q];

  T acc[6][10];
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[p][k] = zero;

#pragma unroll
  for (int gi = 0; gi < 6; ++gi) {
    const Tri<T>& tr = t[gi];
    T area = T(0.5) * ((tr.x2 - tr.x1) * (tr.y3 - tr.y1) -
                       (tr.y2 - tr.y1) * (tr.x3 - tr.x1)) * tr.fac;
    if (fabs(area) < T(kEps16) * afc) area = zero;
    if (!((group_positions(gi) >> tr.pos) & 1)) continue;

    // flux-cell coordinates
    const T isg = T(shift_of(edge, tr.pos, 0));
    const T jsg = T(shift_of(edge, tr.pos, 1));
    T lx[3], ly[3];
    if (edge == 1) {
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
    T px[4], py[4];
    if (order == 1) {
      px[0] = x0; py[0] = y0;
    } else if (order == 2) {
      for (int q = 0; q < 3; ++q) {
        px[q] = T(0.5) * lx[q] + T(0.5) * x0;
        py[q] = T(0.5) * ly[q] + T(0.5) * y0;
      }
    } else {
      px[0] = x0; py[0] = y0;
      for (int q = 0; q < 3; ++q) {
        px[q + 1] = T(0.4) * lx[q] + T(0.6) * x0;
        py[q + 1] = T(0.4) * ly[q] + T(0.6) * y0;
      }
    }
    T mono[10];
#pragma unroll
    for (int k = 1; k < 10; ++k) mono[k] = zero;
    for (int q = 0; q < npts; ++q) {
      const T w = T(wq[q]);
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
    mono[0] = T(wsum);
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      if (((group_positions(gi) >> p) & 1) && tr.pos == p) {
#pragma unroll
        for (int k = 0; k < 10; ++k) acc[p][k] = acc[p][k] + area * mono[k];
      }
    }
  }

#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int k = 0; k < 10; ++k)
      planes[((int64_t)(edge * 6 + p) * 10 + k) * np + c] = acc[p][k];
}

template <typename T>
__global__ void gather_gsh(const T* __restrict__ planes, T* __restrict__ gsh,
                           Grid2 g, int emit_shifted) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= g.nx || j >= g.ny) return;
  const int64_t c = (int64_t)j * g.nx + i;
  const int64_t np = (int64_t)g.ny * g.nx;
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    const int di = off_of(o, 0), dj = off_of(o, 1);
    T acc[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[k] = T(0);
    // GSH[off](c) = GA[off](c - off); GA mode reads GA[off](c)
    const int64_t x = emit_shifted ? g.idx(j - dj, i - di) : c;
    if (x >= 0) {
      const int xj = (int)(x / g.nx), xi = (int)(x % g.nx);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          const int sdi = shift_of(e, p, 0), sdj = shift_of(e, p, 1);
          const T* pl = planes + (int64_t)(e * 6 + p) * 10 * np;
          if (sdi == di && sdj == dj) {
#pragma unroll
            for (int k = 0; k < 10; ++k) acc[k] = acc[k] + pl[k * np + x];
          } else if (sdi + back_of(e, 0) == di && sdj + back_of(e, 1) == dj) {
            const int64_t x2 = g.idx(xj + back_of(e, 1), xi + back_of(e, 0));
            if (x2 >= 0) {
#pragma unroll
              for (int k = 0; k < 10; ++k)
                acc[k] = acc[k] - pl[k * np + x2];
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) gsh[((int64_t)o * 10 + k) * np + c] = acc[k];
  }
}

template <typename T>
int run(const void* dx, const void* dy, const void* afac, void* planes,
        void* gsh, void* codes, int ny, int nx, int ew, int ns, int order,
        int emit_shifted, cudaStream_t stream) {
  const Grid2 g{ny, nx, ew == 0, ns == 0};
  const dim3 block(32, 4);
  const dim3 grid2((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                   2);
  edge_moments<T><<<grid2, block, 0, stream>>>(
      static_cast<const T*>(dx), static_cast<const T*>(dy),
      static_cast<const T*>(afac), static_cast<T*>(planes),
      static_cast<int*>(codes), g, order);
  const dim3 grid1(grid2.x, grid2.y);
  gather_gsh<T><<<grid1, block, 0, stream>>>(static_cast<const T*>(planes),
                                             static_cast<T*>(gsh), g,
                                             emit_shifted);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int remap_gsh_f32(const void* dx, const void* dy, const void* afac,
                  void* planes, void* gsh, void* codes, int ny, int nx, int ew,
                  int ns, int order, int emit_shifted, void* stream) {
  return run<float>(dx, dy, afac, planes, gsh, codes, ny, nx, ew, ns, order,
                    emit_shifted, static_cast<cudaStream_t>(stream));
}

int remap_gsh_f64(const void* dx, const void* dy, const void* afac,
                  void* planes, void* gsh, void* codes, int ny, int nx, int ew,
                  int ns, int order, int emit_shifted, void* stream) {
  return run<double>(dx, dy, afac, planes, gsh, codes, ny, nx, ew, ns, order,
                     emit_shifted, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
