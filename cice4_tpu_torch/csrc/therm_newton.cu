// therm_newton.cu — Newton temperature solve of the snow+ice column on Hopper.
//
// Replaces the TPU kernel cice4_tpu/ops/therm_vertical.py::_tc_kernel
// (:632-670, host code _temperature_changes_pallas :673-740).  It computes
// what the plain version cice4_tpu_torch/ops/therm_vertical.py::
// _temperature_changes_core computes: move over-warming shortwave into the
// surface, interface conductivities, then up to nitermax Newton iterations of
// the surface-flux linearization, a (nslyr+nilyr+1)-row Thomas solve, the
// Tmlt clamp with conductivity reduction, and the five convergence tests.
//
// Design.  The TPU kernel ran one whole-block loop per 32-row block and
// skipped blocks without ice.  Here each thread owns one (category, j, i)
// cell and runs its own Newton loop in registers until that cell converges or
// reaches nitermax; a cell without ice takes the no-loop branch (the TPU
// kernel's skipped block), so a warp with no ice finishes at once.  Per-cell
// loops give the whole-grid answer: the masked whole-grid loop freezes a
// converged cell, and every icy cell is active from iteration 0 until it
// converges, so its own iteration index equals the global `niter` that the
// oscillation test (condition 2) reads.  The scalar `niter` output becomes a
// per-cell count that the wrapper reduces with a max.
//
// What bounds it on an H100: per-thread latency of the serial Newton loop,
// with iteration counts that differ between the cells of a warp (a warp runs
// as long as its slowest cell), and memory traffic of about 59 planes (30 in,
// 29 out) x 5 categories x 122,880 cells x 4 bytes, ~145 MB per f32 launch at
// gx1.  The design keeps the whole iteration state in registers, so each input
// is read once and each output written once (coalesced: neighbouring threads
// own neighbouring cells of a plane), and idle ice-free warps retire at once.
// It is CUDA C++ and not Triton: the solve is a per-cell iterative loop with
// data-dependent trip counts, not a fused elementwise pass.
//
// Arithmetic follows the plain version expression by expression, including
// the dtype-adaptive ferrmax floor and the Tmlt-clamp energy dq_flux.  nvcc
// contracts a*b+c into FMA, so results may differ from the plain version in
// the last ulp and, rarely, a cell may converge one iteration earlier or later.
//
// C interface: therm_newton_f32 / therm_newton_f64 take a table of pointers,
// a table of strides, the sizes, a table of double parameters and the CUDA
// stream; they return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

// constants (cice4_tpu_torch/constants.py, therm_vertical.py)
constexpr double kPuny = 1.0e-11;
constexpr double kRhos = 330.0;
constexpr double kRhoi = 917.0;
constexpr double kCpIce = 2106.0;
constexpr double kLfresh = 2.835e6 - 2.501e6;
constexpr double kTffresh = 273.15;
constexpr double kEmissivity = 0.95;
constexpr double kStefan = 567.0e-10;
constexpr double kQqqice = 11637800.0;
constexpr double kTTTice = 5897.8;
constexpr double kKice = 2.03;
constexpr double kKsno = 0.30;
constexpr double kCpOcn = 4218.0;
constexpr double kHsMin = 1.0e-4;
constexpr double kBetak = 0.13;
constexpr double kKimin = 0.10;
constexpr double kFerrmax = 1.0e-3;
constexpr double kTsfErrmax = 5.0e-4;
constexpr int kNitermax = 100;
constexpr int kThreads = 128;

// pointer-table layout (cice4_tpu_torch/ops/therm_vertical.py _TC_*)
enum InPlane { RHOA, FLW, POTT, QA, SHCOEF, LHCOEF, FSWSFC, FSWINT, FSWTHRUN,
               HILYR, HSLYR, TSF, TBOT, EINIT, kInPlanes };
enum InLayer { SSWABS, ISWABS, QIN, TIN, QSN, TSN, kInLayers };
enum OutPlane { O_TSF, O_FSURFN, O_FCONDTOPN, O_FCONDBOT, O_FSENSN, O_FLATN,
                O_FLWOUTN, O_FSWABSN, O_FSWSFC, O_FSWINT, O_DQFLUX,
                kOutPlanes };
enum OutLayer { O_TSN, O_TIN, O_QSN, O_QIN, O_SSWABS, O_ISWABS, kOutLayers };

template <typename T, int NI>
struct Args {
  const uint8_t* has_ice;
  int64_t has_ice_cs;                 // category stride (0: broadcast)
  const T* in_plane[kInPlanes];
  int64_t plane_cs[kInPlanes];
  const T* in_layer[kInLayers];
  int64_t layer_cs[kInLayers];
  int64_t layer_ls[kInLayers];        // layer stride
  T* out_plane[kOutPlanes];
  uint8_t* converged;
  int32_t* why;
  int32_t* niter;
  T* out_layer[kOutLayers];
  int64_t ncat, ncell;                // ncell = ny * nx
  T dt;
  int l_brine, bubbly;
  T salin[NI], tmlt[NI];
};

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr double v = FLT_EPSILON; };
template <> struct Eps<double> { static constexpr double v = DBL_EPSILON; };

template <typename T> __device__ __forceinline__ T vmin(T a, T b) { return fmin(a, b); }
template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return fmax(a, b); }

template <typename T, int NI, int NS>
__global__ void __launch_bounds__(kThreads)
therm_newton_kernel(const Args<T, NI> a) {
  constexpr int NM = NS + NI + 1;     // rows of the system = interfaces
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= a.ncat * a.ncell) return;
  const int64_t c = idx / a.ncell;
  const int64_t p = idx - c * a.ncell;

  const T puny = T(kPuny);
  const T dt = a.dt;
  const bool l_brine = a.l_brine != 0;

  auto P = [&](int k) { return a.in_plane[k][c * a.plane_cs[k] + p]; };
  auto L = [&](int k, int l) {
    return a.in_layer[k][c * a.layer_cs[k] + l * a.layer_ls[k] + p];
  };

  const bool has_ice = a.has_ice[c * a.has_ice_cs + p] != 0;
  const T rhoa = P(RHOA), flw = P(FLW), potT = P(POTT), Qa = P(QA);
  const T shcoef = P(SHCOEF), lhcoef = P(LHCOEF);
  T fswsfc = P(FSWSFC), fswint = P(FSWINT);
  const T fswthrun = P(FSWTHRUN), hilyr = P(HILYR), hslyr = P(HSLYR);
  const T Tsf0 = P(TSF), Tbot = P(TBOT), einit = P(EINIT);

  T Sswabs[NS], Tsn_init[NS], qsn0[NS];
  T Iswabs[NI], Tin_init[NI], qin0[NI];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    Sswabs[k] = L(SSWABS, k); Tsn_init[k] = L(TSN, k); qsn0[k] = L(QSN, k);
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    Iswabs[k] = L(ISWABS, k); Tin_init[k] = L(TIN, k); qin0[k] = L(QIN, k);
  }

  const bool l_snow = has_ice && (hslyr > T(kHsMin / NS));
  const T dt_rhoi_hlyr = dt / (T(kRhoi) * vmax(hilyr, puny));
  const T etas = l_snow ? dt / (T(kRhos * kCpIce) * vmax(hslyr, puny)) : T(0);

  // --- conductivities (_conductivity) ---------------------------------------
  T kh[NM];
  {
    T kilyr[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const T tneg = vmin(Tin_init[k], -puny);
      T ki;
      if (a.bubbly)
        ki = (T(2.11) - T(0.011) * Tin_init[k] + T(0.09) * a.salin[k] / tneg)
             * T(kRhoi) / T(917.0);
      else
        ki = T(kKice) + T(kBetak) * a.salin[k] / tneg;
      kilyr[k] = vmax(ki, T(kKimin));
    }
    const T ks = T(kKsno);
    kh[0] = l_snow ? T(2.0 * kKsno) / vmax(hslyr, puny) : T(0);
#pragma unroll
    for (int k = 1; k < NS; ++k)
      kh[k] = l_snow ? T(2.0 * kKsno * kKsno)
                       / vmax(T(kKsno + kKsno) * hslyr, puny) : T(0);
    kh[NS] = l_snow ? T(2.0 * kKsno) * kilyr[0]
                      / vmax(ks * hilyr + kilyr[0] * hslyr, puny)
                    : T(2) * kilyr[0] / vmax(hilyr, puny);
#pragma unroll
    for (int k = 1; k < NI; ++k)
      kh[NS + k] = T(2) * kilyr[k - 1] * kilyr[k]
                   / vmax((kilyr[k - 1] + kilyr[k]) * hilyr, puny);
    kh[NS + NI] = T(2) * kilyr[NI - 1] / vmax(hilyr, puny);
  }

  // --- move excess absorbed SW into the surface (_move_sw_to_surface) -------
  {
    const T frac = T(0.9), dTemp = T(0.02);
    T tmp[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      T room;
      bool is_cold;
      if (l_brine) {
        const T m = vmin(Tin_init[k], -puny);
        const T ci0 = T(kCpIce) - T(kLfresh) * a.tmlt[k] / (m * m);
        room = frac * (a.tmlt[k] - Tin_init[k]) * ci0 / dt_rhoi_hlyr;
        is_cold = Tin_init[k] <= (a.tmlt[k] - dTemp);
      } else {
        room = frac * (-Tin_init[k]) * T(kCpIce) / dt_rhoi_hlyr;
        is_cold = Tin_init[k] <= -dTemp;
      }
      T t = is_cold ? vmin(Iswabs[k], room) : T(0);
      tmp[k] = (t < puny) ? T(0) : t;
    }
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const T dswabs = vmin(Iswabs[k] - tmp[k], fswint);
      fswsfc = fswsfc + dswabs;
      fswint = fswint - dswabs;
      Iswabs[k] = Iswabs[k] - dswabs;
    }
    T stmp[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      T t = (Tsn_init[k] <= -dTemp)
                ? vmin(Sswabs[k], -frac * Tsn_init[k] / vmax(etas, puny)) : T(0);
      stmp[k] = (Sswabs[k] < puny) ? T(0) : t;
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const T dswabs = l_snow ? vmin(Sswabs[k] - stmp[k], fswint) : T(0);
      fswsfc = fswsfc + dswabs;
      fswint = fswint - dswabs;
      Sswabs[k] = Sswabs[k] - dswabs;
    }
  }
  const T fswabsn = fswsfc + fswint + fswthrun;

  // --- iteration state ------------------------------------------------------
  T Tsf = Tsf0, Tsn[NS], Tin[NI], qsn[NS], qin[NI];
#pragma unroll
  for (int k = 0; k < NS; ++k) { Tsn[k] = Tsn_init[k]; qsn[k] = qsn0[k]; }
#pragma unroll
  for (int k = 0; k < NI; ++k) { Tin[k] = Tin_init[k]; qin[k] = qin0[k]; }
  T dTsf_prev = T(0), fsurfn = T(0), fcondtopn = T(0), fcondbot = T(0);
  T fsensn = T(0), flatn = T(0), flwoutn = T(0), dq_col = T(0);
  bool converged = false;
  int why = 0, niter = 0;

  if (has_ice) {
    const T eps32 = T(32.0 * Eps<T>::v);
    for (niter = 0; niter < kNitermax && !converged; ++niter) {
      // surface flux linearization (_surface_fluxes)
      const T TsfK = Tsf + T(kTffresh);
      const T inv = T(1) / TsfK;
      const T qsat = T(kQqqice) * exp(T(-kTTTice) * inv);
      const T Qsfc = qsat / rhoa;
      const T dQsfcdT = T(kTTTice) * inv * inv * Qsfc;
      const T TsfK2 = TsfK * TsfK;
      const T sf_flwoutn = T(-kEmissivity * kStefan) * (TsfK2 * TsfK2);
      const T sf_fsensn = shcoef * (potT - TsfK);
      const T sf_flatn = lhcoef * (Qa - Qsfc);
      const T dflwout_dT = T(-kEmissivity * kStefan * 4.0) * (TsfK * TsfK2);
      const T dfsens_dT = -shcoef;
      const T dflat_dT = -lhcoef * dQsfcdT;
      const T sf_fsurfn = fswsfc + T(kEmissivity) * flw + sf_flwoutn
                          + sf_fsensn + sf_flatn;
      const T dfsurf_dT = dflwout_dT + dfsens_dT + dflat_dT;

      const T fct = l_snow ? kh[0] * (Tsf - Tsn[0]) : kh[NS] * (Tsf - Tin[0]);
      T Tsf_c = (sf_fsurfn < fct) ? vmin(Tsf, -puny) : Tsf;
      const T Tsf_start = Tsf_c;
      const bool l_cold = Tsf_c <= -puny;

      // assemble the tridiagonal system
      T sb[NM], d[NM], sp[NM], rhs[NM];
      T etai[NI];
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        const T ci = l_brine
            ? T(kCpIce) - T(kLfresh) * a.tmlt[k]
                  / (vmin(Tin[k], -puny) * vmin(Tin_init[k], -puny))
            : T(kCpIce);
        etai[k] = dt_rhoi_hlyr / ci;
      }
      const bool cold_snow = l_cold && l_snow;
      sb[0] = T(0);
      d[0] = cold_snow ? dfsurf_dT - kh[0] : T(1);
      sp[0] = cold_snow ? kh[0] : T(0);
      rhs[0] = cold_snow ? dfsurf_dT * Tsf_c - sf_fsurfn : T(0);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int r = k + 1;
        T sbk = -etas * kh[k];
        T spk = -etas * kh[k + 1];
        T dk = T(1) + etas * (kh[k] + kh[k + 1]);
        T rhk = Tsn_init[k] + etas * Sswabs[k];
        if (k == 0) {
          sbk = l_cold ? sbk : T(0);
          rhk = rhk + (l_cold ? T(0) : etas * kh[0] * Tsf_c);
        }
        if (r == NS) {
          const bool cold_nosnow = l_cold && !l_snow;
          sbk = l_snow ? sbk : T(0);
          dk = l_snow ? dk : (cold_nosnow ? dfsurf_dT - kh[NS] : T(1));
          spk = l_snow ? spk : (cold_nosnow ? kh[NS] : T(0));
          rhk = l_snow ? rhk
                       : (cold_nosnow ? dfsurf_dT * Tsf_c - sf_fsurfn : T(0));
        } else {
          dk = l_snow ? dk : T(1);
          sbk = l_snow ? sbk : T(0);
          spk = l_snow ? spk : T(0);
          rhk = l_snow ? rhk : T(0);
        }
        sb[r] = sbk; d[r] = dk; sp[r] = spk; rhs[r] = rhk;
      }
#pragma unroll
      for (int ki = 0; ki < NI; ++ki) {
        const int k = ki + NS;
        T sbk = -etai[ki] * kh[k];
        T spk = -etai[ki] * kh[k + 1];
        const T dk = T(1) + etai[ki] * (kh[k] + kh[k + 1]);
        T rhk = Tin_init[ki] + etai[ki] * Iswabs[ki];
        if (ki == 0) {
          const bool warm_nosnow = !l_snow && !l_cold;
          rhk = rhk + (warm_nosnow ? etai[ki] * kh[k] * Tsf_c : T(0));
          sbk = warm_nosnow ? T(0) : sbk;
        }
        if (ki == NI - 1) {
          rhk = rhk + etai[ki] * kh[k + 1] * Tbot;
          spk = T(0);
        }
        sb[k + 1] = sbk; d[k + 1] = dk; sp[k + 1] = spk; rhs[k + 1] = rhk;
      }

      // Thomas solve (_tridiag)
      T x[NM];
#pragma unroll
      for (int k = 1; k < NM; ++k) {
        const T w = sb[k] / d[k - 1];
        d[k] = d[k] - w * sp[k - 1];
        rhs[k] = rhs[k] - w * rhs[k - 1];
      }
      x[NM - 1] = rhs[NM - 1] / d[NM - 1];
#pragma unroll
      for (int k = NM - 2; k >= 0; --k) x[k] = (rhs[k] - sp[k] * x[k + 1]) / d[k];

      // extract the solution and test convergence
      T Tsf_new = l_cold ? (l_snow ? x[0] : x[NS]) : T(0);
      T dTsf = Tsf_new - Tsf_start;
      T avg_Tsi = T(0), avg_Tsf = T(0);
      const bool c1v = Tsf_new > puny;                    // condition 1
      if (c1v) { Tsf_new = T(0); dTsf = -Tsf_start; }
      if (l_brine && c1v) avg_Tsi = T(1);
      const bool c2v = niter > 0 && Tsf_start <= -puny    // condition 2
                       && fabs(dTsf) > puny && fabs(dTsf_prev) > puny
                       && (-dTsf / (dTsf_prev + T(kPuny * kPuny)) > T(0.5));
      if (l_brine && c2v) { avg_Tsf = T(1); avg_Tsi = T(1); }
      if (c2v) dTsf = T(0.5) * dTsf;
      Tsf_new = Tsf_new + avg_Tsf * T(0.5) * (Tsf_start - Tsf_new);

      T Tsn_new[NS], qsn_new[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        T t = l_snow ? x[k + 1] : T(0);
        if (l_brine) t = vmin(t, T(0));
        t = t + avg_Tsi * T(0.5) * (Tsn[k] - t);
        Tsn_new[k] = t;
        qsn_new[k] = T(-kRhos) * (T(kLfresh) - T(kCpIce) * t);
      }
      T Tin_new[NI], qin_new[NI], dqmat[NI];
      bool reduce_kh[NI];
#pragma unroll
      for (int ki = 0; ki < NI; ++ki) {
        T t = x[NS + 1 + ki];
        const T tm = a.tmlt[ki];
        dqmat[ki] = T(0);
        reduce_kh[ki] = false;
        if (l_brine) {
          const bool over = t > (tm - puny);
          if (over) {
            const T dT = t - tm;
            const T m = vmin(t, -puny);
            dqmat[ki] = T(kRhoi) * dT * (T(kCpIce) - T(kLfresh) * tm / (m * m));
            t = tm;
          }
          reduce_kh[ki] = over;
        }
        t = t + avg_Tsi * T(0.5) * (Tin[ki] - t);
        Tin_new[ki] = t;
        if (l_brine) {
          const T ts = vmin(t, -puny);
          qin_new[ki] = T(-kRhoi) * (T(kCpIce) * (tm - ts)
                                     + T(kLfresh) * (T(1) - tm / ts)
                                     - T(kCpOcn) * tm);
        } else {
          qin_new[ki] = T(-kRhoi) * (T(-kCpIce) * t + T(kLfresh));
        }
      }

      T esn = T(0), ein = T(0), dq = T(0);
#pragma unroll
      for (int k = 0; k < NS; ++k) esn = esn + hslyr * qsn_new[k];
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        ein = ein + hilyr * (qin_new[k] - dqmat[k]);
        dq = dq + hilyr * dqmat[k];
      }
      const T enew = esn + ein;

      const T fsurfn_new = sf_fsurfn + dTsf * dfsurf_dT;
      const T fct_new = l_snow ? kh[0] * (Tsf_new - Tsn_new[0])
                               : kh[NS] * (Tsf_new - Tin_new[0]);
      const bool c3v = fabs(dTsf) > T(kTsfErrmax);                   // cond 3
      const bool c4v = (Tsf_new > -puny) && (fsurfn_new < fct_new);  // cond 4
      const T fcbot = kh[NS + NI] * (Tin_new[NI - 1] - Tbot);        // cond 5
      const T ferr = fabs((enew - einit) / dt - (fct_new - fcbot + fswint));
      const T noise = fabs(einit) / dt + fabs(fct_new) + fabs(fcbot) + fabs(fswint);
      const T ferrmax_eff = vmax(T(kFerrmax), eps32 * noise);
      const bool bad_e = ferr > T(0.9) * ferrmax_eff;

      // conductivity reduction for overshooting layers, chained
      const T denom = vmax(fabs(fct_new - fcbot), puny);
      const T fracr = vmax(T(0.5) * (T(1) - ferr / denom), T(0.1));
#pragma unroll
      for (int ki = 0; ki < NI; ++ki) {
        const bool sel = bad_e && reduce_kh[ki] && dqmat[ki] > T(0);
        if (sel) {
          const T below = kh[ki + NS + 1] * fracr;
          kh[ki + NS + 1] = below;
          kh[ki + NS] = below * fracr;
        }
      }

      // merge (this cell is active)
      Tsf = Tsf_new;
#pragma unroll
      for (int k = 0; k < NS; ++k) { Tsn[k] = Tsn_new[k]; qsn[k] = qsn_new[k]; }
#pragma unroll
      for (int k = 0; k < NI; ++k) { Tin[k] = Tin_new[k]; qin[k] = qin_new[k]; }
      dTsf_prev = dTsf;
      fsurfn = fsurfn_new;
      fcondtopn = fct_new;
      fcondbot = fcbot;
      fsensn = sf_fsensn + dTsf * dfsens_dT;
      flatn = sf_flatn + dTsf * dflat_dT;
      flwoutn = sf_flwoutn + dTsf * dflwout_dT;
      dq_col = dq;
      why = int(c1v) * 1 + int(c2v) * 2 + int(c3v) * 4 + int(c4v) * 8
            + int(bad_e) * 16;
      converged = !(c1v || c2v || c3v || c4v || bad_e);
    }
  }

  // --- store ----------------------------------------------------------------
  const int64_t o = c * a.ncell + p;
  a.out_plane[O_TSF][o] = Tsf;
  a.out_plane[O_FSURFN][o] = fsurfn;
  a.out_plane[O_FCONDTOPN][o] = fcondtopn;
  a.out_plane[O_FCONDBOT][o] = fcondbot;
  a.out_plane[O_FSENSN][o] = fsensn;
  a.out_plane[O_FLATN][o] = flatn;
  a.out_plane[O_FLWOUTN][o] = flwoutn;
  a.out_plane[O_FSWABSN][o] = fswabsn;
  a.out_plane[O_FSWSFC][o] = fswsfc;
  a.out_plane[O_FSWINT][o] = fswint;
  a.out_plane[O_DQFLUX][o] = dq_col / dt;
  a.converged[o] = converged ? 1 : 0;
  a.why[o] = why;
  a.niter[o] = niter;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int64_t ol = (c * NS + k) * a.ncell + p;
    a.out_layer[O_TSN][ol] = Tsn[k];
    a.out_layer[O_QSN][ol] = qsn[k];
    a.out_layer[O_SSWABS][ol] = Sswabs[k];
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int64_t ol = (c * NI + k) * a.ncell + p;
    a.out_layer[O_TIN][ol] = Tin[k];
    a.out_layer[O_QIN][ol] = qin[k];
    a.out_layer[O_ISWABS][ol] = Iswabs[k];
  }
}

template <typename T>
int launch(const int64_t* ptrs, const int64_t* strides, int64_t ncat,
           int64_t ny, int64_t nx, const double* params, void* stream) {
  constexpr int NI = 4, NS = 1;
  if (static_cast<int>(params[3]) != NI || static_cast<int>(params[4]) != NS)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T, NI> a;
  int ip = 0, is = 0;
  a.has_ice = reinterpret_cast<const uint8_t*>(ptrs[ip++]);
  a.has_ice_cs = strides[is++];
  for (int k = 0; k < kInPlanes; ++k) {
    a.in_plane[k] = reinterpret_cast<const T*>(ptrs[ip++]);
    a.plane_cs[k] = strides[is++];
  }
  for (int k = 0; k < kInLayers; ++k) {
    a.in_layer[k] = reinterpret_cast<const T*>(ptrs[ip++]);
    a.layer_cs[k] = strides[is++];
    a.layer_ls[k] = strides[is++];
  }
  for (int k = 0; k < kOutPlanes; ++k) a.out_plane[k] = reinterpret_cast<T*>(ptrs[ip++]);
  a.converged = reinterpret_cast<uint8_t*>(ptrs[ip++]);
  a.why = reinterpret_cast<int32_t*>(ptrs[ip++]);
  a.niter = reinterpret_cast<int32_t*>(ptrs[ip++]);
  for (int k = 0; k < kOutLayers; ++k) a.out_layer[k] = reinterpret_cast<T*>(ptrs[ip++]);
  a.ncat = ncat;
  a.ncell = ny * nx;
  a.dt = T(params[0]);
  a.l_brine = params[1] != 0.0;
  a.bubbly = params[2] != 0.0;
  for (int k = 0; k < NI; ++k) {
    a.salin[k] = T(params[5 + k]);
    a.tmlt[k] = T(params[5 + NI + k]);
  }
  const int64_t n = ncat * ny * nx;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  therm_newton_kernel<T, NI, NS><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int therm_newton_f32(const int64_t* ptrs, const int64_t* strides,
                                int64_t ncat, int64_t ny, int64_t nx,
                                const double* params, void* stream) {
  return launch<float>(ptrs, strides, ncat, ny, nx, params, stream);
}

extern "C" int therm_newton_f64(const int64_t* ptrs, const int64_t* strides,
                                int64_t ncat, int64_t ny, int64_t nx,
                                const double* params, void* stream) {
  return launch<double>(ptrs, strides, ncat, ny, nx, params, stream);
}
