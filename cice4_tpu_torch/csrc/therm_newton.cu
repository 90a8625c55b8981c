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
// Layer counts: the kernel is a template over (nilyr, nslyr), so that its
// per-layer arrays are unrolled into registers; it is built for nilyr 1..8
// and nslyr 1..3 (24 instances per type, picked at run time by launch).
// Instances, not a generic kernel with run-time counts: with run-time trip
// counts the arrays would be indexed dynamically and live in local memory.
//
// Every other count goes to therm_newton_generic, one instance per type whose
// layer counts are run-time arguments (the TPU kernel, _tc_kernel :632, is
// traced for any count).  Its per-layer arrays cannot stay in registers, and
// in local memory each thread's arrays would sit in its own stretch of
// memory, one line a thread; so they live in dynamic shared memory, laid out
// [array][layer][thread], where a warp's 32 threads read neighbouring words
// (conflict-free in f32; in f64 a warp's 256 bytes are two wavefronts, the
// least there is).  It carries across the Newton iterations only what lives
// across them: Iswabs, Tin_init and Tin (nilyr each), the ice interfaces'
// conductivities (nilyr + 1; the snow's are two scalars, never reduced),
// Sswabs, Tsn_init and Tsn (nslyr each); and, as the scratch of one
// iteration, the Thomas solve's sp, d and rhs (nslyr + nilyr + 1 each, the
// solution written over rhs).  The rest is recomputed: qin and qsn from the
// final temperatures (the inputs read again where no iteration ran), the
// conductivity reduction's over-warm test from the solution, the
// conductivity of each layer where its interfaces are built.  That is
// 7 nilyr + 6 nslyr + 4 words a thread, and the salinity and melting
// profiles (2 nilyr words) once a block.  The threads per block are the
// multiple of 32, at most 128, whose arrays fit in 227 KB.  One warp's
// arrays (with the profiles) fit up to nilyr 255 with nslyr 1 and 254 with
// nslyr 3 in f32, and up to 127 and 125 in f64; beyond, the launch returns
// kErrLayers and the wrapper raises with the count and the bytes.  Its
// bound is the bytes of the layer stacks, which grow linearly with
// nilyr + nslyr, over 3.35 TB/s; the shared-memory traffic of each
// iteration (about 3 words a row of the solve, a thread) is what it pays
// for the run-time counts, and warps in flight are what hide it.  So in
// f32 its per-layer loops inside the Newton iteration are not unrolled
// (each row of the solve depends on the last, so unrolling bought no
// overlap and cost registers: 157), and __launch_bounds__ asks for 4
// blocks of 128 threads an SM: 93 registers, no spill and no stack frame,
// so at (10, 1) shared memory (41 KB a block) and not registers caps it at
// 5 blocks, 20 warps, an SM (12 before).  In f64 the loops are unrolled by
// 4, the compiler's own choice (210 registers): not unrolled, ptxas fuses
// other multiplies and adds than in the register instance, and the two
// instances no longer agree bit for bit at (4, 1), as they do in both
// types with these loops (on an H100, PERF.md section 6).
//
// C interface: therm_newton_f32 / therm_newton_f64 take a table of pointers,
// a table of strides, the sizes, a table of double parameters (dt, l_brine,
// bubbly, nilyr, nslyr, salin[nilyr], tmlt[nilyr]), a device pointer to the
// profiles salin[nilyr], tmlt[nilyr] in the working type (read by the generic
// instance only) and the CUDA stream; they return cudaGetLastError() after
// the launch, or kErrLayers (-2) for a layer count below 1 or beyond what one
// warp's shared memory holds.  therm_newton_generic_{f32,f64}, with the same
// arguments, launch the generic instance whatever the count (to hold it
// against the templated one); therm_newton_generic_bytes gives its dynamic
// shared memory and threads per block at a layer count (threads 0, and one
// warp's bytes, beyond the largest).

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

// --- the generic instance: layer counts at run time --------------------------

// the pointer and stride tables of Args, without the profiles
template <typename T>
struct GenericArgs {
  const uint8_t* has_ice;
  int64_t has_ice_cs;
  const T* in_plane[kInPlanes];
  int64_t plane_cs[kInPlanes];
  const T* in_layer[kInLayers];
  int64_t layer_cs[kInLayers];
  int64_t layer_ls[kInLayers];
  T* out_plane[kOutPlanes];
  uint8_t* converged;
  int32_t* why;
  int32_t* niter;
  T* out_layer[kOutLayers];
  int64_t ncat, ncell;
  T dt;
  int l_brine, bubbly;
  const T* profile;                   // salin[ni], tmlt[ni]
  int ni, ns;
};

// words of shared memory a thread (see the note at the top) and a block
__host__ __device__ constexpr int generic_words(int ni, int ns) {
  return 7 * ni + 6 * ns + 4;
}
constexpr int64_t kSharedMax = 232448;  // 227 KB, a block's dynamic maximum

// the blocks an SM must hold at 128 threads, which bounds the generic
// instance's registers: in f32 four (16 warps, at most 128 registers a
// thread), in f64 one
template <typename T>
struct GenericBlocks {
  static constexpr int min = sizeof(T) == 4 ? 4 : 1;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, GenericBlocks<T>::min)
therm_newton_generic(const GenericArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int ni = a.ni, ns = a.ns, nm = ns + ni + 1;
  const int nt = blockDim.x, tid = threadIdx.x;
  // the profiles, once a block, behind the threads' arrays
  T* const salin = sm + static_cast<int64_t>(generic_words(ni, ns)) * nt;
  T* const tmlt = salin + ni;
  for (int k = tid; k < ni; k += nt) {
    salin[k] = a.profile[k];
    tmlt[k] = a.profile[ni + k];
  }
  __syncthreads();

  const int64_t idx = static_cast<int64_t>(blockIdx.x) * nt + tid;
  if (idx >= a.ncat * a.ncell) return;
  const int64_t c = idx / a.ncell;
  const int64_t p = idx - c * a.ncell;

  // this thread's rows: [array][layer][thread]
  const int rIsw = 0, rTin0 = ni, rTin = 2 * ni, rKh = 3 * ni;  // rKh: ni + 1
  const int rSsw = 4 * ni + 1, rTsn0 = rSsw + ns, rTsn = rTsn0 + ns;
  const int rSp = rTsn + ns, rD = rSp + nm, rRhs = rD + nm;
  auto at = [&](int row) -> T& { return sm[row * nt + tid]; };

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

  for (int k = 0; k < ns; ++k) {
    at(rSsw + k) = L(SSWABS, k);
    at(rTsn0 + k) = L(TSN, k);
  }
  for (int k = 0; k < ni; ++k) {
    at(rIsw + k) = L(ISWABS, k);
    at(rTin0 + k) = L(TIN, k);
  }

  const bool l_snow = has_ice && (hslyr > T(kHsMin / ns));
  const T dt_rhoi_hlyr = dt / (T(kRhoi) * vmax(hilyr, puny));
  const T etas = l_snow ? dt / (T(kRhos * kCpIce) * vmax(hslyr, puny)) : T(0);

  // --- conductivities (_conductivity): the snow's two values, the ice
  // interfaces' kh[ns + k] in rows rKh + k ------------------------------------
  const T kh0 = l_snow ? T(2.0 * kKsno) / vmax(hslyr, puny) : T(0);
  const T khs = l_snow ? T(2.0 * kKsno * kKsno)
                         / vmax(T(kKsno + kKsno) * hslyr, puny) : T(0);
  {
    auto kil = [&](int k) {
      const T tin0 = at(rTin0 + k);
      const T tneg = vmin(tin0, -puny);
      T ki;
      if (a.bubbly)
        ki = (T(2.11) - T(0.011) * tin0 + T(0.09) * salin[k] / tneg)
             * T(kRhoi) / T(917.0);
      else
        ki = T(kKice) + T(kBetak) * salin[k] / tneg;
      return vmax(ki, T(kKimin));
    };
    const T ks = T(kKsno);
    T kprev = kil(0);
    at(rKh) = l_snow ? T(2.0 * kKsno) * kprev
                      / vmax(ks * hilyr + kprev * hslyr, puny)
                    : T(2) * kprev / vmax(hilyr, puny);
    for (int k = 1; k < ni; ++k) {
      const T kcur = kil(k);
      at(rKh + k) = T(2) * kprev * kcur / vmax((kprev + kcur) * hilyr, puny);
      kprev = kcur;
    }
    at(rKh + ni) = T(2) * kprev / vmax(hilyr, puny);
  }
  // kh of interface k (0: the top surface, ns: snow over ice)
  auto kh = [&](int k) -> T { return k == 0 ? kh0 : (k < ns ? khs : at(rKh + k - ns)); };

  // --- move excess absorbed SW into the surface (_move_sw_to_surface) -------
  {
    const T frac = T(0.9), dTemp = T(0.02);
    for (int k = 0; k < ni; ++k) {
      const T tin0 = at(rTin0 + k), isw = at(rIsw + k), tm = tmlt[k];
      T room;
      bool is_cold;
      if (l_brine) {
        const T m = vmin(tin0, -puny);
        const T ci0 = T(kCpIce) - T(kLfresh) * tm / (m * m);
        room = frac * (tm - tin0) * ci0 / dt_rhoi_hlyr;
        is_cold = tin0 <= (tm - dTemp);
      } else {
        room = frac * (-tin0) * T(kCpIce) / dt_rhoi_hlyr;
        is_cold = tin0 <= -dTemp;
      }
      T t = is_cold ? vmin(isw, room) : T(0);
      t = (t < puny) ? T(0) : t;
      const T dswabs = vmin(isw - t, fswint);
      fswsfc = fswsfc + dswabs;
      fswint = fswint - dswabs;
      at(rIsw + k) = isw - dswabs;
    }
    for (int k = 0; k < ns; ++k) {
      const T tsn0 = at(rTsn0 + k), ssw = at(rSsw + k);
      T t = (tsn0 <= -dTemp)
                ? vmin(ssw, -frac * tsn0 / vmax(etas, puny)) : T(0);
      t = (ssw < puny) ? T(0) : t;
      const T dswabs = l_snow ? vmin(ssw - t, fswint) : T(0);
      fswsfc = fswsfc + dswabs;
      fswint = fswint - dswabs;
      at(rSsw + k) = ssw - dswabs;
    }
  }
  const T fswabsn = fswsfc + fswint + fswthrun;

  // --- iteration state ------------------------------------------------------
  T Tsf = Tsf0;
  for (int k = 0; k < ns; ++k) at(rTsn + k) = at(rTsn0 + k);
  for (int k = 0; k < ni; ++k) at(rTin + k) = at(rTin0 + k);
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

      const T fct = l_snow ? kh0 * (Tsf - at(rTsn)) : kh(ns) * (Tsf - at(rTin));
      T Tsf_c = (sf_fsurfn < fct) ? vmin(Tsf, -puny) : Tsf;
      const T Tsf_start = Tsf_c;
      const bool l_cold = Tsf_c <= -puny;

      // assemble the tridiagonal system row by row, eliminating as it goes
      // (the Thomas forward sweep of _tridiag): rows rSp, rD, rRhs keep each
      // row's sp and its eliminated d and rhs
      const bool cold_snow = l_cold && l_snow;
      T d_prev = cold_snow ? dfsurf_dT - kh0 : T(1);
      T sp_prev = cold_snow ? kh0 : T(0);
      T rhs_prev = cold_snow ? dfsurf_dT * Tsf_c - sf_fsurfn : T(0);
      at(rSp) = sp_prev; at(rD) = d_prev; at(rRhs) = rhs_prev;
      auto eliminate = [&](int r, T sbk, T dk, T spk, T rhk) {
        const T w = sbk / d_prev;
        dk = dk - w * sp_prev;
        rhk = rhk - w * rhs_prev;
        at(rSp + r) = spk; at(rD + r) = dk; at(rRhs + r) = rhk;
        d_prev = dk; sp_prev = spk; rhs_prev = rhk;
      };
#pragma unroll (sizeof(T) == 4 ? 1 : 4)
      for (int k = 0; k < ns; ++k) {
        const int r = k + 1;
        T sbk = -etas * kh(k);
        T spk = -etas * kh(k + 1);
        T dk = T(1) + etas * (kh(k) + kh(k + 1));
        T rhk = at(rTsn0 + k) + etas * at(rSsw + k);
        if (k == 0) {
          sbk = l_cold ? sbk : T(0);
          rhk = rhk + (l_cold ? T(0) : etas * kh0 * Tsf_c);
        }
        if (r == ns) {
          const bool cold_nosnow = l_cold && !l_snow;
          sbk = l_snow ? sbk : T(0);
          dk = l_snow ? dk : (cold_nosnow ? dfsurf_dT - kh(ns) : T(1));
          spk = l_snow ? spk : (cold_nosnow ? kh(ns) : T(0));
          rhk = l_snow ? rhk
                       : (cold_nosnow ? dfsurf_dT * Tsf_c - sf_fsurfn : T(0));
        } else {
          dk = l_snow ? dk : T(1);
          sbk = l_snow ? sbk : T(0);
          spk = l_snow ? spk : T(0);
          rhk = l_snow ? rhk : T(0);
        }
        eliminate(r, sbk, dk, spk, rhk);
      }
#pragma unroll (sizeof(T) == 4 ? 1 : 4)
      for (int ki = 0; ki < ni; ++ki) {
        const int k = ki + ns;
        const T tin = at(rTin + ki), tin0 = at(rTin0 + ki);
        const T ci = l_brine
            ? T(kCpIce) - T(kLfresh) * tmlt[ki]
                  / (vmin(tin, -puny) * vmin(tin0, -puny))
            : T(kCpIce);
        const T etai = dt_rhoi_hlyr / ci;
        const T kha = kh(k), khb = kh(k + 1);
        T sbk = -etai * kha;
        T spk = -etai * khb;
        const T dk = T(1) + etai * (kha + khb);
        T rhk = tin0 + etai * at(rIsw + ki);
        if (ki == 0) {
          const bool warm_nosnow = !l_snow && !l_cold;
          rhk = rhk + (warm_nosnow ? etai * kha * Tsf_c : T(0));
          sbk = warm_nosnow ? T(0) : sbk;
        }
        if (ki == ni - 1) {
          rhk = rhk + etai * khb * Tbot;
          spk = T(0);
        }
        eliminate(k + 1, sbk, dk, spk, rhk);
      }

      // back substitution, the solution x[k] written over rhs
      T x_next = at(rRhs + nm - 1) / at(rD + nm - 1);
      at(rRhs + nm - 1) = x_next;
#pragma unroll (sizeof(T) == 4 ? 1 : 4)
      for (int k = nm - 2; k >= 0; --k) {
        x_next = (at(rRhs + k) - at(rSp + k) * x_next) / at(rD + k);
        at(rRhs + k) = x_next;
      }
      auto x = [&](int k) -> T { return at(rRhs + k); };

      // extract the solution and test convergence
      T Tsf_new = l_cold ? (l_snow ? x(0) : x(ns)) : T(0);
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

      // the new temperatures, merged in place (this cell is active), and
      // the column's energy
      T esn = T(0), ein = T(0), dq = T(0), tsn_top = T(0);
#pragma unroll (sizeof(T) == 4 ? 1 : 4)
      for (int k = 0; k < ns; ++k) {
        T t = l_snow ? x(k + 1) : T(0);
        if (l_brine) t = vmin(t, T(0));
        t = t + avg_Tsi * T(0.5) * (at(rTsn + k) - t);
        at(rTsn + k) = t;
        if (k == 0) tsn_top = t;
        esn = esn + hslyr * (T(-kRhos) * (T(kLfresh) - T(kCpIce) * t));
      }
      // the Tmlt clamp of an over-warm layer: its energy dqmat
      auto clamp_energy = [&](int ki, T t, bool& over) {
        const T tm = tmlt[ki];
        over = l_brine && t > (tm - puny);
        if (!over) return T(0);
        const T dT = t - tm;
        const T m = vmin(t, -puny);
        return T(kRhoi) * dT * (T(kCpIce) - T(kLfresh) * tm / (m * m));
      };
      T tin_top = T(0), tin_bot = T(0);
#pragma unroll (sizeof(T) == 4 ? 1 : 4)
      for (int ki = 0; ki < ni; ++ki) {
        T t = x(ns + 1 + ki);
        const T tm = tmlt[ki];
        bool over;
        const T dqmat = clamp_energy(ki, t, over);
        if (over) t = tm;
        t = t + avg_Tsi * T(0.5) * (at(rTin + ki) - t);
        at(rTin + ki) = t;
        if (ki == 0) tin_top = t;
        if (ki == ni - 1) tin_bot = t;
        T qin_new;
        if (l_brine) {
          const T ts = vmin(t, -puny);
          qin_new = T(-kRhoi) * (T(kCpIce) * (tm - ts)
                                 + T(kLfresh) * (T(1) - tm / ts)
                                 - T(kCpOcn) * tm);
        } else {
          qin_new = T(-kRhoi) * (T(-kCpIce) * t + T(kLfresh));
        }
        ein = ein + hilyr * (qin_new - dqmat);
        dq = dq + hilyr * dqmat;
      }
      const T enew = esn + ein;

      const T fsurfn_new = sf_fsurfn + dTsf * dfsurf_dT;
      const T fct_new = l_snow ? kh0 * (Tsf_new - tsn_top)
                               : kh(ns) * (Tsf_new - tin_top);
      const bool c3v = fabs(dTsf) > T(kTsfErrmax);                   // cond 3
      const bool c4v = (Tsf_new > -puny) && (fsurfn_new < fct_new);  // cond 4
      const T fcbot = kh(ns + ni) * (tin_bot - Tbot);                // cond 5
      const T ferr = fabs((enew - einit) / dt - (fct_new - fcbot + fswint));
      const T noise = fabs(einit) / dt + fabs(fct_new) + fabs(fcbot) + fabs(fswint);
      const T ferrmax_eff = vmax(T(kFerrmax), eps32 * noise);
      const bool bad_e = ferr > T(0.9) * ferrmax_eff;

      // conductivity reduction for overshooting layers, chained; the
      // over-warm test and dqmat again from the solution
      if (bad_e) {
        const T denom = vmax(fabs(fct_new - fcbot), puny);
        const T fracr = vmax(T(0.5) * (T(1) - ferr / denom), T(0.1));
#pragma unroll (sizeof(T) == 4 ? 1 : 4)
        for (int ki = 0; ki < ni; ++ki) {
          bool over;
          const T dqmat = clamp_energy(ki, x(ns + 1 + ki), over);
          if (over && dqmat > T(0)) {
            const T below = at(rKh + ki + 1) * fracr;
            at(rKh + ki + 1) = below;
            at(rKh + ki) = below * fracr;
          }
        }
      }

      // merge (this cell is active)
      Tsf = Tsf_new;
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
  // an iteration leaves qsn, qin the enthalpies of the final temperatures;
  // without one they are the inputs
  for (int k = 0; k < ns; ++k) {
    const int64_t ol = (c * ns + k) * a.ncell + p;
    const T t = at(rTsn + k);
    a.out_layer[O_TSN][ol] = t;
    a.out_layer[O_QSN][ol] = niter > 0
        ? T(-kRhos) * (T(kLfresh) - T(kCpIce) * t) : L(QSN, k);
    a.out_layer[O_SSWABS][ol] = at(rSsw + k);
  }
  for (int k = 0; k < ni; ++k) {
    const int64_t ol = (c * ni + k) * a.ncell + p;
    const T t = at(rTin + k);
    T q;
    if (niter == 0) {
      q = L(QIN, k);
    } else if (l_brine) {
      const T tm = tmlt[k];
      const T ts = vmin(t, -puny);
      q = T(-kRhoi) * (T(kCpIce) * (tm - ts) + T(kLfresh) * (T(1) - tm / ts)
                       - T(kCpOcn) * tm);
    } else {
      q = T(-kRhoi) * (T(-kCpIce) * t + T(kLfresh));
    }
    a.out_layer[O_TIN][ol] = t;
    a.out_layer[O_QIN][ol] = q;
    a.out_layer[O_ISWABS][ol] = at(rIsw + k);
  }
}

// the layer counts built: nilyr 1..kMaxNI x nslyr 1..kMaxNS, one template
// instance each, so every per-layer array of the kernel stays in registers
constexpr int kMaxNI = 8, kMaxNS = 3;
// returned for a layer count below 1 or beyond what one warp's shared memory
// holds in the generic instance (cudaError_t values are >= 0)
constexpr int kErrLayers = -2;

// the pointer and stride tables and the scalars, common to Args and
// GenericArgs
template <typename T, typename A>
void fill_tables(A& a, const int64_t* ptrs, const int64_t* strides,
                 int64_t ncat, int64_t ny, int64_t nx, const double* params) {
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
}

template <typename T, int NI, int NS>
int launch_layers(const int64_t* ptrs, const int64_t* strides, int64_t ncat,
                  int64_t ny, int64_t nx, const double* params,
                  void* stream) {
  Args<T, NI> a;
  fill_tables<T>(a, ptrs, strides, ncat, ny, nx, params);
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

// (threads per block, dynamic shared bytes) of the generic instance: the
// most threads, a multiple of 32 and at most kThreads, whose arrays and the
// block's profiles fit in kSharedMax; threads 0 when one warp's do not
int64_t generic_plan(int ni, int ns, int64_t elem, int* threads) {
  const int64_t per_thread = generic_words(ni, ns) * elem;
  const int64_t profiles = 2 * static_cast<int64_t>(ni) * elem;
  int64_t warps = (kSharedMax - profiles) / (32 * per_thread);
  if (warps > kThreads / 32) warps = kThreads / 32;
  if (warps < 1) {
    *threads = 0;
    return 32 * per_thread + profiles;
  }
  *threads = static_cast<int>(32 * warps);
  return *threads * per_thread + profiles;
}

template <typename T>
int launch_generic(const int64_t* ptrs, const int64_t* strides, int64_t ncat,
                   int64_t ny, int64_t nx, const double* params,
                   const void* profile, void* stream) {
  GenericArgs<T> a;
  fill_tables<T>(a, ptrs, strides, ncat, ny, nx, params);
  a.ni = static_cast<int>(params[3]);
  a.ns = static_cast<int>(params[4]);
  a.profile = static_cast<const T*>(profile);
  if (a.ni < 1 || a.ns < 1) return kErrLayers;
  int threads = 0;
  const int64_t smem = generic_plan(a.ni, a.ns, sizeof(T), &threads);
  if (threads == 0) return kErrLayers;
  const int64_t n = ncat * ny * nx;
  if (n == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        therm_newton_generic<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + threads - 1) / threads;
  therm_newton_generic<T><<<static_cast<unsigned>(blocks), threads,
                            static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NI>
int launch_snow(int nslyr, const int64_t* ptrs, const int64_t* strides,
                int64_t ncat, int64_t ny, int64_t nx, const double* params,
                void* stream) {
  switch (nslyr) {
    case 1: return launch_layers<T, NI, 1>(ptrs, strides, ncat, ny, nx, params, stream);
    case 2: return launch_layers<T, NI, 2>(ptrs, strides, ncat, ny, nx, params, stream);
    case 3: return launch_layers<T, NI, 3>(ptrs, strides, ncat, ny, nx, params, stream);
    default: return kErrLayers;
  }
}

// the register instance for the counts built, the generic one otherwise
template <typename T>
int launch(const int64_t* ptrs, const int64_t* strides, int64_t ncat,
           int64_t ny, int64_t nx, const double* params, const void* profile,
           void* stream) {
  static_assert(kMaxNI == 8 && kMaxNS == 3, "the switches list the counts");
  const int ni = static_cast<int>(params[3]), ns = static_cast<int>(params[4]);
  if (ns < 1 || ns > kMaxNS)
    return launch_generic<T>(ptrs, strides, ncat, ny, nx, params, profile, stream);
#define THERM_NEWTON_ICE(NI) \
  case NI: return launch_snow<T, NI>(ns, ptrs, strides, ncat, ny, nx, params, stream);
  switch (ni) {
    THERM_NEWTON_ICE(1) THERM_NEWTON_ICE(2) THERM_NEWTON_ICE(3)
    THERM_NEWTON_ICE(4) THERM_NEWTON_ICE(5) THERM_NEWTON_ICE(6)
    THERM_NEWTON_ICE(7) THERM_NEWTON_ICE(8)
    default:
      return launch_generic<T>(ptrs, strides, ncat, ny, nx, params, profile, stream);
  }
#undef THERM_NEWTON_ICE
}

// therm_newton_generic_occupancy's work for one type
template <typename T>
int generic_occupancy(int ni, int ns, int* out) {
  int threads = 0;
  const int64_t smem = generic_plan(ni, ns, sizeof(T), &threads);
  if (threads == 0) return kErrLayers;
  cudaError_t e =
      smem > 48 * 1024
          ? cudaFuncSetAttribute(therm_newton_generic<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem))
          : cudaSuccess;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], therm_newton_generic<T>, threads, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, therm_newton_generic<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = threads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" int therm_newton_f32(const int64_t* ptrs, const int64_t* strides,
                                int64_t ncat, int64_t ny, int64_t nx,
                                const double* params, const void* profile,
                                void* stream) {
  return launch<float>(ptrs, strides, ncat, ny, nx, params, profile, stream);
}

extern "C" int therm_newton_f64(const int64_t* ptrs, const int64_t* strides,
                                int64_t ncat, int64_t ny, int64_t nx,
                                const double* params, const void* profile,
                                void* stream) {
  return launch<double>(ptrs, strides, ncat, ny, nx, params, profile, stream);
}

extern "C" int therm_newton_generic_f32(const int64_t* ptrs,
                                        const int64_t* strides, int64_t ncat,
                                        int64_t ny, int64_t nx,
                                        const double* params,
                                        const void* profile, void* stream) {
  return launch_generic<float>(ptrs, strides, ncat, ny, nx, params, profile,
                               stream);
}

extern "C" int therm_newton_generic_f64(const int64_t* ptrs,
                                        const int64_t* strides, int64_t ncat,
                                        int64_t ny, int64_t nx,
                                        const double* params,
                                        const void* profile, void* stream) {
  return launch_generic<double>(ptrs, strides, ncat, ny, nx, params, profile,
                                stream);
}

// the generic instance's dynamic shared memory for (nilyr, nslyr) and an
// element of `elem` bytes, and in *threads its threads per block (0 when
// one warp's arrays do not fit: the bytes are then one warp's)
extern "C" int64_t therm_newton_generic_bytes(int ni, int ns, int elem,
                                              int* threads) {
  return generic_plan(ni, ns, elem, threads);
}

// what the runtime reports of the generic instance of `elem` bytes at
// (nilyr, nslyr) on the current device: in out[0..3] its blocks resident an
// SM, threads per block, registers a thread and local (stack and spill)
// bytes a thread; returns the runtime's error code
extern "C" int therm_newton_generic_occupancy(int ni, int ns, int elem,
                                              int* out) {
  return elem == 4 ? generic_occupancy<float>(ni, ns, out)
                   : generic_occupancy<double>(ni, ns, out);
}
