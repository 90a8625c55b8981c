// gfdl_column.cu — the GFDL open-water fluxes of the ACCESS-OM coupler, one
// thread a cell, on Hopper.
//
// Replaces no TPU kernel: the JAX package leaves the GFDL surface-layer
// package to XLA (cice4_tpu/ops/gfdl_flux.py).  It was added because eager
// PyTorch spends about 3,800 launches an interval on one call of
// cice4_tpu_torch/ops/gfdl_flux.py::_gfdl_ocean_fluxes_plain (the zeta
// Newton alone runs 20 masked passes of ~170 operations each over the whole
// plane), so the coupled interval waits on the host's dispatch.  It computes
// what that plain version computes, in its order:
//
// - the SST shift (Celsius below 250 K), the air density and the pressure at
//   the reference height;
// - compute_ocean_roughness (beljaars, charnock or fixed) from the lagged
//   u_star;
// - surface_flux: escomp at the surface temperature, the saturated surface
//   humidity, the potential and virtual temperatures, the wind relative to
//   the surface current;
// - mo_drag with the Monin-Obukhov zeta Newton (the stable similarity
//   functions of option 1, which the coupler takes), or, under use_ncar,
//   ncar_ocean_fluxes in its place;
// - the rough_scale rescale of the momentum coefficient, the bulk fluxes,
//   and the signs flipped for the ocean.
//
// It writes the nine fields the caller keeps (sh, lh, lwo, taox, taoy,
// u_star and the three roughness lengths) and nothing else: surface_flux's
// derivatives, b_star and q_star are no output of gfdl_ocean_fluxes, so the
// work that feeds only them (the second escomp at t_surf + 0.1, dw_atmdu,
// dedt_surf) is not done; under use_ncar mo_drag's coefficients are
// replaced whole, so its Newton does not run either.  Land cells write what
// the plain version leaves there (zero fluxes, the sign-flipped ones as -0,
// ROUGHNESS_MIN) and skip the arithmetic.
//
// Per-cell exit.  The plain Newton runs MO_MAX_ITER passes over every cell
// and freezes a cell once it has converged or its zeta has collapsed below
// ZETA_MIN (live & ~conv): a frozen cell's zeta never moves again.  Here a
// cell leaves its loop at that point, so its iterates and its fixed point are
// the plain version's.  mo_passes: the most Newton passes of any cell (the
// pass in which a cell converges counts), each block's largest taken into a
// per-device 0-d accumulator by atomicMax; the launch never clears it, so
// it holds the most over every launch since its reader last zeroed it.
//
// Arithmetic follows the plain version as PyTorch runs it on the card,
// expression by expression: a division by a Python number is a
// multiplication by its reciprocal, taken in double and rounded to T
// (div_true_kernel_cuda with a CPU scalar; 1.0f / 273.15f is not it),
// a Python number divided by a tensor is the tensor's reciprocal times the
// number (Tensor.__rtruediv__), x ** 2 is x * x, x ** -0.5 is rsqrt, other
// powers are pow (PowKernel.cu), 10 ** x is pow(10, x), clamps, minima and
// maxima propagate NaN, sign(NaN) is 0, Python constants round to T, and the
// math functions are the ones ATen calls for a float or a double (logf,
// log10f, powf, atanf, sqrtf, rsqrtf).  Constants that Python computes with
// a transcendental function (log10(ESBASI), atan(1), sqrt(DRAG_MIN), ...)
// arrive computed in the launcher's par array.  Built with -fmad=false, so
// no multiply and add contract into an FMA that eager PyTorch does not do.
//
// Design: a grid-stride loop over the (ny, nx) plane, one cell a thread at a
// time, so a warp's loads and stores of each of the ten inputs and nine
// outputs touch neighbouring addresses (coalesced).  Everything else lives
// in registers.  What bounds it on an H100 is arithmetic and the Newton's
// divergence: a bytes bound of 73 bytes a cell in f32 (0.034 ms at 1440 x
// 1080 and 3.35 TB/s) against ~20 transcendental calls a Newton pass.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 8;

// the Python numbers of the plain version (gfdl_flux.py, constants.py), in
// the launcher's order
struct GfdlParams {
  double zlvl, tbasi, tbasw, tbasi_m20, log10_esbasi, log10_esbasw, gravit,
      rdgas, d608, d622, d378, kappa, puny, vonkar, cp_air, sigma, lvap,
      rough_min, charnock, rough_fixed, gnu, gnu2, zcom1, zcom2, zcoh1, zcoh2,
      zcoq1, zcoq2, rich_crit, r_crit, b_stab, five_m_bstab, mo_error,
      zeta_min, mo_small, big, sqrt_drag_min, atan1, inv0608;
};
constexpr int kParams = sizeof(GfdlParams) / sizeof(double);

enum RoughScheme { kBeljaars = 0, kCharnock = 1, kFixed = 2 };

template <typename T>
struct GfdlArgs {
  const T *tair, *qair, *uwnd, *vwnd, *press, *sst, *ssu, *ssv, *u_star_prev;
  const bool* tmask;
  T *sh, *lh, *lwo, *taox, *taoy, *u_star, *rough_mom, *rough_heat,
      *rough_moist;
  int32_t* mo_passes;  // 0-d, per device: the most passes since zeroed
  int64_t P;
  int rough_scheme, use_ncar, max_iter;
  GfdlParams p;
};

// ATen's math functions for a float and a double
__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
__device__ __forceinline__ float xlog10(float x) { return log10f(x); }
__device__ __forceinline__ double xlog10(double x) { return log10(x); }
__device__ __forceinline__ float xpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double xpow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float xatan(float x) { return atanf(x); }
__device__ __forceinline__ double xatan(double x) { return atan(x); }
__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xrsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double xrsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }
__device__ __forceinline__ float xmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double xmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float xmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double xmin(double a, double b) {
  return fmin(a, b);
}

// torch.clamp(x, min=lo) / (x, max=hi), torch.maximum / torch.minimum:
// NaN propagates
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) {
  return x != x ? x : xmax(x, lo);
}
template <typename T>
__device__ __forceinline__ T clamp_hi(T x, T hi) {
  return x != x ? x : xmin(x, hi);
}
template <typename T>
__device__ __forceinline__ T maxnan(T a, T b) {
  return a != a ? a : (b != b ? b : xmax(a, b));
}
template <typename T>
__device__ __forceinline__ T minnan(T a, T b) {
  return a != a ? a : (b != b ? b : xmin(a, b));
}
// torch.sign: 0 for 0 and NaN
template <typename T>
__device__ __forceinline__ T sgn(T a) {
  return T((T(0) < a) - (a < T(0)));
}
// x / c for a Python number c: x times c's reciprocal, taken in double and
// rounded to T (div_true_kernel_cuda reads the CPU scalar as a double)
template <typename T>
__device__ __forceinline__ T divc(T x, double c) {
  return x * T(1.0 / c);
}
// c / x for a Python number c: x's reciprocal times c
template <typename T>
__device__ __forceinline__ T cdiv(double c, T x) {
  return (T(1) / x) * T(c);
}

// escomp (gfdl_flux.py): Goff-Gratch over ice and water, blended in
// [-20 C, 0 C]; each branch computed only where it is taken
template <typename T>
__device__ T escomp(T t, const GfdlParams& p) {
  const T ts = clamp_lo(t, T(100.0));
  const bool ice_only = ts <= T(p.tbasi_m20);
  const bool water_only = ts >= T(p.tbasi);
  T esice = T(0), esh2o = T(0);
  if (!water_only) {
    const T a = cdiv(p.tbasi, ts);
    T xi = (a - T(1.0)) * T(-9.09718) - xlog10(cdiv(p.tbasi, ts)) *
                                            T(3.56654);
    xi = xi + (T(1.0) - divc(ts, p.tbasi)) * T(0.876793);
    xi = xi + T(p.log10_esbasi);
    esice = xpow(T(10.0), xi);
  }
  if (!ice_only) {
    const T aw = cdiv(p.tbasw, ts);
    T xw = (aw - T(1.0)) * T(-7.90298) + xlog10(cdiv(p.tbasw, ts)) *
                                             T(5.02808);
    xw = xw - (xpow(T(10.0), (T(1.0) - divc(ts, p.tbasw)) * T(11.344)) -
               T(1.0)) * T(1.3816e-7);
    xw = xw + (xpow(T(10.0), (cdiv(p.tbasw, ts) - T(1.0)) * T(-3.49149)) -
               T(1.0)) * T(8.1328e-3);
    xw = xw + T(p.log10_esbasw);
    esh2o = xpow(T(10.0), xw);
  }
  if (ice_only) return esice;
  if (water_only) return esh2o;
  return ((T(p.tbasi) - ts) * esice + (ts - T(p.tbasi) + T(20.0)) * esh2o) *
         T(0.05);
}

// the similarity functions (gfdl_flux.py _phi_stable, _phi, _phi_m,
// _psi_stable, _psi_m, _psi_t) under stable option 1, each branch only
// where torch.where takes it
template <typename T>
__device__ T phi_stable(T zeta, const GfdlParams& p) {
  const T zp = clamp_lo(zeta, T(0.0));
  return zp * (zp * T(p.b_stab) + T(5.0)) / (zp + T(1.0)) + T(1.0);
}

template <typename T>
__device__ T phi_t(T zeta, const GfdlParams& p) {
  if (zeta >= T(0.0)) return phi_stable(zeta, p);
  return xrsqrt(T(1.0) - clamp_hi(zeta, T(0.0)) * T(16.0));
}

template <typename T>
__device__ T phi_m(T zeta, const GfdlParams& p) {
  if (zeta >= T(0.0)) return phi_stable(zeta, p);
  return xpow(T(1.0) - clamp_hi(zeta, T(0.0)) * T(16.0), T(-0.25));
}

// zp >= puny, zp0 >= 0
template <typename T>
__device__ T psi_stable(T zp, T zp0, T ln, const GfdlParams& p) {
  return ln + xlog((zp + T(1.0)) / (zp0 + T(1.0))) * T(p.five_m_bstab) +
         (zp - zp0) * T(p.b_stab);
}

template <typename T>
__device__ T psi_m(T zeta, T zeta_0, T ln, const GfdlParams& p) {
  if (zeta >= T(0.0))
    return psi_stable(clamp_lo(zeta, T(p.puny)), clamp_lo(zeta_0, T(0.0)),
                      ln, p);
  const T zn = clamp_hi(zeta, T(0.0)), zn0 = clamp_hi(zeta_0, T(0.0));
  const T x = xsqrt(xsqrt(T(1.0) - zn * T(16.0)));
  const T x0 = xsqrt(xsqrt(T(1.0) - zn0 * T(16.0)));
  const T x1 = x + T(1.0), x1_0 = x0 + T(1.0);
  const T num = x1 * x1 * (x * x + T(1.0));
  const T den = x1_0 * x1_0 * (x0 * x0 + T(1.0));
  return ln - xlog(num / den) + (xatan(x) - xatan(x0)) * T(2.0);
}

template <typename T>
__device__ T psi_t(T zeta, T zeta_t, T ln, const GfdlParams& p) {
  if (zeta >= T(0.0))
    return psi_stable(clamp_lo(zeta, T(p.puny)), clamp_lo(zeta_t, T(0.0)),
                      ln, p);
  const T x = xsqrt(T(1.0) - clamp_hi(zeta, T(0.0)) * T(16.0));
  const T xt = xsqrt(T(1.0) - clamp_hi(zeta_t, T(0.0)) * T(16.0));
  return ln - xlog((x + T(1.0)) / (xt + T(1.0))) * T(2.0);
}

template <typename T>
__device__ __forceinline__ T nonzero(T a) {
  return a != T(0.0) ? a : T(1.0);
}

// _solve_zeta: the Newton for zeta from the bulk Richardson number, this
// cell leaving it where the plain version freezes it; f = (f_m, f_t, f_q);
// returns the passes made
template <typename T>
__device__ int solve_zeta(T rich, T z, T z0, T zt, T zq, bool live,
                          int max_iter, const GfdlParams& p, T* f) {
  const T z_z0 = z / z0, z_zt = z / zt, z_zq = z / zq;
  const T ln0 = xlog(z_z0), lnt = xlog(z_zt), lnq = xlog(z_zq);
  T zeta = rich * ln0 * ln0 / lnt;
  if (rich >= T(0.0))
    zeta = zeta / clamp_lo(T(1.0) - divc(rich, p.rich_crit), T(p.puny));
  live = live && xabs(zeta) >= T(0.0);
  int passes = 0;
  for (int it = 0; it < max_iter && live; ++it) {
    // a zeta collapsed to ~0 takes the neutral logs and stops
    if (xabs(zeta) < T(p.zeta_min)) break;
    const T zs = zeta;
    const T rzeta = T(1.0) / zs;
    const T zeta_0 = zs / z_z0, zeta_t = zs / z_zt;
    const T f_m = psi_m(zs, zeta_0, ln0, p);
    const T f_t = psi_t(zs, zeta_t, lnt, p);
    const T df_m = (phi_m(zs, p) - phi_m(zeta_0, p)) * rzeta;
    const T df_t = (phi_t(zs, p) - phi_t(zeta_t, p)) * rzeta;
    const T rich_1 = zs * f_t / clamp_lo(f_m * f_m, T(p.puny));
    const T d_rich = rich_1 * (rzeta + df_t / nonzero(f_t) -
                               df_m * T(2.0) / nonzero(f_m));
    const T corr = (rich - rich_1) /
                   (xabs(d_rich) > T(p.puny) ? d_rich : T(1.0));
    const T crit = minnan(xabs(corr), xabs(corr * rzeta));
    passes = it + 1;
    if (crit <= T(p.mo_error)) break;
    zeta = zeta + corr;
  }
  if (xabs(zeta) < T(p.zeta_min)) {
    f[0] = ln0;
    f[1] = lnt;
    f[2] = lnq;
  } else {
    f[0] = psi_m(zeta, zeta / z_z0, ln0, p);
    f[1] = psi_t(zeta, zeta / z_zt, lnt, p);
    f[2] = psi_t(zeta, zeta / z_zq, lnq, p);
  }
  return passes;
}

// ncar_ocean_fluxes' neutral 10 m coefficients: (cd, ch, ce, sqrt(cd))
template <typename T>
__device__ void ncar_n10(T u10, T stab, T* c) {
  const T cd = divc((cdiv(2.7, u10) + T(0.142)) + u10 * T(0.0764), 1e3);
  const T rt = xsqrt(cd);
  c[0] = cd;
  c[1] = divc((stab * T(18.0) + (T(1.0) - stab) * T(32.7)) * rt, 1e3);
  c[2] = divc(rt * T(34.6), 1e3);
  c[3] = rt;
}

// ncar_ocean_fluxes (the corrected branch): (cd, ch, ce, ustar) into out
template <typename T>
__device__ void ncar_fluxes(T u_del, T t, T ts, T q, T qs, T z,
                            const GfdlParams& p, T* out) {
  const T tv = t * (q * T(0.608) + T(1.0));
  const T u = clamp_lo(u_del, T(0.5));
  T c[4];
  ncar_n10(u, sgn(t - ts) * T(0.5) + T(0.5), c);
  T cd = c[0], ch = c[1], ce = c[2], cd_n10_rt = c[3];
  T ustar = T(0.0);
  for (int n = 0; n < 2; ++n) {
    const T cd_rt = xsqrt(cd);
    ustar = cd_rt * u;
    const T tstar = ch / cd_rt * (t - ts);
    const T qstar = ce / cd_rt * (q - qs);
    const T bstar =
        (tstar / tv + qstar / (q + T(p.inv0608))) * T(p.gravit);
    T zeta = bstar * T(p.vonkar) * z / (ustar * ustar);
    zeta = sgn(zeta) * clamp_hi(xabs(zeta), T(10.0));
    const T x2 = clamp_lo(xsqrt(xabs(T(1.0) - zeta * T(16.0))), T(1.0));
    const T x = xsqrt(x2);
    T psi_m, psi_h;
    if (zeta > T(0.0)) {
      psi_m = zeta * T(-5.0);
      psi_h = zeta * T(-5.0);
    } else {
      psi_m = xlog(divc((x * T(2.0) + T(1.0) + x2) * (x2 + T(1.0)), 8.0)) -
              (xatan(x) - T(p.atan1)) * T(2.0);
      psi_h = xlog(divc(x2 + T(1.0), 2.0)) * T(2.0);
    }
    const T lz = xlog(divc(z, 10.0));
    const T u10 =
        u / (divc(cd_n10_rt * (lz - psi_m), p.vonkar) + T(1.0));
    ncar_n10(u10, sgn(zeta) * T(0.5) + T(0.5), c);
    cd_n10_rt = c[3];
    const T xxm = divc(lz - psi_m, p.vonkar);
    const T xxh = divc(lz - psi_h, p.vonkar);
    const T a = cd_n10_rt * xxm + T(1.0);
    const T b = c[1] * xxh / cd_n10_rt + T(1.0);
    const T e = c[2] * xxh / cd_n10_rt + T(1.0);
    cd = c[0] / (a * a);
    ch = c[1] / (b * b);
    ce = c[2] / (e * e);
  }
  out[0] = cd;
  out[1] = ch;
  out[2] = ce;
  out[3] = ustar;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gfdl_column(const GfdlArgs<T> a) {
  const GfdlParams& p = a.p;
  const T rmin = T(p.rough_min);
  int most = 0;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < a.P;
       i += stride) {
    if (!a.tmask[i]) {
      a.sh[i] = T(-0.0);
      a.lh[i] = T(-0.0);
      a.lwo[i] = T(-0.0);
      a.taox[i] = T(-0.0);
      a.taoy[i] = T(-0.0);
      a.u_star[i] = T(0.0);
      a.rough_mom[i] = rmin;
      a.rough_heat[i] = rmin;
      a.rough_moist[i] = rmin;
      continue;
    }
    const T tair = a.tair[i], qair = a.qair[i], uwnd = a.uwnd[i],
            vwnd = a.vwnd[i], press = a.press[i], sst = a.sst[i],
            ssu = a.ssu[i], ssv = a.ssv[i];
    const T z = T(p.zlvl);

    // gfdl_ocean_fluxes: the SST in Kelvin, the air's density and the
    // pressure at zlvl
    const T t_surf = sst < T(250.0) ? sst + T(p.tbasi) : sst;
    const T tv_raw = tair * (qair * T(p.d608) + T(1.0));
    const T d_atm = press / (tv_raw * T(p.rdgas));
    const T p_atm = press - d_atm * T(p.gravit) * T(p.zlvl);

    // compute_ocean_roughness from the lagged u_star
    T rm, rh, rq;
    if (a.rough_scheme == kFixed) {
      rm = rh = rq = T(p.rough_fixed);
    } else {
      const T us = a.u_star_prev[i];
      const T ustar2 = clamp_lo(us * us, T(p.gnu2));
      const T xx1 = cdiv(p.gnu, xsqrt(ustar2));
      const T xx2 = divc(ustar2, p.gravit);
      if (a.rough_scheme == kCharnock) {
        rm = rh = rq = clamp_lo(xx2 * T(p.charnock), rmin);
      } else {
        rm = clamp_lo(xx2 * T(p.zcom1) + xx1 * T(p.zcom2), rmin);
        rh = clamp_lo(xx2 * T(p.zcoh1) + xx1 * T(p.zcoh2), rmin);
        rq = clamp_lo(xx2 * T(p.zcoq1) + xx1 * T(p.zcoq2), rmin);
      }
    }

    // surface_flux
    const T e_sat = escomp(t_surf, p);
    const T q_sat = e_sat * T(p.d622) / (press - e_sat * T(p.d378));
    const T q_atm = clamp_lo(qair, T(0.0));
    const T p_ratio = xpow(press / p_atm, T(p.kappa));
    const T tv_atm = tair * (q_atm * T(p.d608) + T(1.0));
    const T th_atm = tair * p_ratio;
    const T thv_atm = tv_atm * p_ratio;
    const T thv_surf = t_surf * (q_sat * T(p.d608) + T(1.0));
    const T u_dif = ssu - uwnd, v_dif = ssv - vwnd;
    const T w_atm = xsqrt(u_dif * u_dif + v_dif * v_dif + T(1.0) * T(1.0));

    T cd_m, cd_t, cd_q, ustar;
    if (a.use_ncar) {
      T c[4];
      ncar_fluxes(w_atm, th_atm, t_surf, q_atm, q_sat, z, p, c);
      cd_m = c[0];
      cd_t = c[1];
      cd_q = c[2];
      ustar = c[3];
    } else {
      // mo_drag
      const T delta_b = (thv_surf - thv_atm) * T(p.gravit) /
                        clamp_lo(thv_surf, T(p.puny));
      const T rich = -z * delta_b / (w_atm * w_atm + T(p.mo_small));
      T f[3];
      if (rich >= T(p.r_crit)) {
        f[0] = f[1] = f[2] = T(p.big);
      } else {
        const T zz = maxnan(maxnan(z, rm), maxnan(rh, rq));
        const int n = solve_zeta(rich, zz, rm, rh, rq, rich < T(p.r_crit),
                                 a.max_iter, p, f);
        most = n > most ? n : most;
      }
      const T us = clamp_lo(cdiv(p.vonkar, f[0]), T(p.sqrt_drag_min));
      const T bs = clamp_lo(cdiv(p.vonkar, f[1]), T(p.sqrt_drag_min));
      const T qs = clamp_lo(cdiv(p.vonkar, f[2]), T(p.sqrt_drag_min));
      cd_m = us * us;
      cd_t = us * bs;
      cd_q = us * qs;
      ustar = us * w_atm;
    }

    // the orographic rescale (rough_scale = 1)
    const T r = xlog(z / rm + T(1.0)) / xlog(z / (T(1.0) * rm) + T(1.0));
    cd_m = cd_m * (r * r);

    const T rho = p_atm / (tv_atm * T(p.rdgas));
    const T flux_t = cd_t * w_atm * T(p.cp_air) * rho * (t_surf - th_atm);
    const T flux_q = cd_q * w_atm * rho * (q_sat - q_atm);
    const T flux_r = xpow(t_surf, T(4.0)) * T(p.sigma);
    const T rho_drag_m = cd_m * w_atm * rho;
    a.sh[i] = -flux_t;
    a.lh[i] = -flux_q * T(p.lvap);
    a.lwo[i] = -flux_r;
    a.taox[i] = -(rho_drag_m * u_dif);
    a.taoy[i] = -(rho_drag_m * v_dif);
    a.u_star[i] = ustar;
    a.rough_mom[i] = rm;
    a.rough_heat[i] = rh;
    a.rough_moist[i] = rq;
  }

  // mo_passes: the block's most into the per-device accumulator
  __shared__ int block_most;
  if (threadIdx.x == 0) block_most = 0;
  __syncthreads();
  if (most > 0) atomicMax(&block_most, most);
  __syncthreads();
  if (threadIdx.x == 0 && block_most > 0)
    atomicMax(a.mo_passes, block_most);
}

template <typename T>
const T* cptr(const int64_t* ptrs, int i) {
  return reinterpret_cast<const T*>(ptrs[i]);
}
template <typename T>
T* mptr(const int64_t* ptrs, int i) {
  return reinterpret_cast<T*>(ptrs[i]);
}

// ptrs: tair qair uwnd vwnd press sst ssu ssv u_star_prev tmask | sh lh lwo
// taox taoy u_star rough_mom rough_heat rough_moist mo_passes; ints: P
// rough_scheme use_ncar max_iter blocks; par: GfdlParams in order
template <typename T>
int launch_gfdl(const int64_t* ptrs, const int64_t* ints, const double* par,
                cudaStream_t stream) {
  GfdlArgs<T> a{};
  a.tair = cptr<T>(ptrs, 0);
  a.qair = cptr<T>(ptrs, 1);
  a.uwnd = cptr<T>(ptrs, 2);
  a.vwnd = cptr<T>(ptrs, 3);
  a.press = cptr<T>(ptrs, 4);
  a.sst = cptr<T>(ptrs, 5);
  a.ssu = cptr<T>(ptrs, 6);
  a.ssv = cptr<T>(ptrs, 7);
  a.u_star_prev = cptr<T>(ptrs, 8);
  a.tmask = reinterpret_cast<const bool*>(ptrs[9]);
  a.sh = mptr<T>(ptrs, 10);
  a.lh = mptr<T>(ptrs, 11);
  a.lwo = mptr<T>(ptrs, 12);
  a.taox = mptr<T>(ptrs, 13);
  a.taoy = mptr<T>(ptrs, 14);
  a.u_star = mptr<T>(ptrs, 15);
  a.rough_mom = mptr<T>(ptrs, 16);
  a.rough_heat = mptr<T>(ptrs, 17);
  a.rough_moist = mptr<T>(ptrs, 18);
  a.mo_passes = reinterpret_cast<int32_t*>(ptrs[19]);
  a.P = ints[0];
  a.rough_scheme = int(ints[1]);
  a.use_ncar = int(ints[2]);
  a.max_iter = int(ints[3]);
  if (a.rough_scheme < kBeljaars || a.rough_scheme > kFixed)
    return int(cudaErrorInvalidValue);
  double* q = reinterpret_cast<double*>(&a.p);
  for (int k = 0; k < kParams; ++k) q[k] = par[k];
  // a block per kThreads cells up to kBlocksPerSm a multiprocessor
  const int64_t most_blocks = ints[4] > 0 ? ints[4] : 1;
  int64_t blocks = (a.P + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > most_blocks ? most_blocks : blocks);
  gfdl_column<T><<<unsigned(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gfdl_column_f32(const int64_t* ptrs, const int64_t* ints,
                    const double* par, void* stream) {
  return launch_gfdl<float>(ptrs, ints, par,
                            static_cast<cudaStream_t>(stream));
}

int gfdl_column_f64(const int64_t* ptrs, const int64_t* ints,
                    const double* par, void* stream) {
  return launch_gfdl<double>(ptrs, ints, par,
                             static_cast<cudaStream_t>(stream));
}

// the number of doubles par must hold
int gfdl_column_params() { return kParams; }

// the most blocks a launch takes on a device of `sms` multiprocessors
int64_t gfdl_column_blocks(int sms) { return int64_t(sms) * kBlocksPerSm; }

}  // extern "C"
