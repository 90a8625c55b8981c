"""GFDL ocean-surface flux physics (ACCESS-OM coupled driver).

Port of :mod:`cice4_tpu.ops.gfdl_flux`, the GFDL/FMS surface-layer package
the ACCESS-OM driver uses for the open-water atmosphere fluxes routed
through the ice model (``drivers/access-om/cpl_forcing_handler.F90
gfdl_ocean_fluxes:925-1056``):

* ``escomp``: Goff-Gratch saturation vapor pressure with the
  ice/supercooled-water blend (``sat_vapor_pres_k_mod.F90
  compute_es_k:131-192``), evaluated directly rather than from a table;
* ``compute_ocean_roughness``: charnock / beljaars / fixed schemes
  (``ocean_rough_mod.F90:63-199``);
* ``mo_drag``: Monin-Obukhov drag coefficients with the masked Newton
  iteration for zeta (``monin_obukhov_kernel.F90
  monin_obukhov_drag_1d:101-222, monin_obukhov_solve_zeta:224-400``),
  a fixed ``MO_MAX_ITER`` masked passes with no test on the host;
* ``surface_flux``: the bulk-flux assembly (``surface_flux_mod.F90
  surface_flux_1d:339-586``);
* ``ncar_ocean_fluxes``: the Large-Yeager alternative
  (``surface_flux_mod.F90:822-960``, corrected branch);
* ``gfdl_ocean_fluxes``: the driver-level wrapper: previous-interval
  u_star -> roughness -> MO drag -> fluxes, sign-flipped for MOM.

Every function works on dense (ny, nx) tensors with masks, on the device
of its inputs.  The JAX package leaves this code to XLA; here
``gfdl_ocean_fluxes`` on CUDA tensors is one launch of the column kernel
of ``csrc/gfdl_column.cu`` (:mod:`cice4_tpu_torch.ops.gfdl_cuda`), and
:func:`_gfdl_ocean_fluxes_plain`, which the CPU runs, is its oracle.
"""

from __future__ import annotations

import math

import torch

from cice4_tpu_torch import constants as cn

# GFDL gas constants (drivers/access-om/ice_constants.F90:254-255)
rdgas = 287.04
rvgas = 461.50
d622 = rdgas / rvgas
d378 = 1.0 - d622
d608 = d378 / d622
kappa = 2.0 / 7.0          # rdgas/cp_air, GFDL convention

# monin_obukhov_mod.F90 namelist defaults (:70-86)
RICH_CRIT = 2.0
DRAG_MIN = 1.0e-5
ZETA_TRANS = 0.5
MO_ERROR = 1.0e-4
ZETA_MIN = 1.0e-6
MO_MAX_ITER = 20
MO_SMALL = 1.0e-4

# ocean_rough_mod.F90 defaults (:19-31,55)
ROUGHNESS_MIN = 1.0e-6
CHARNOCK = 0.032
ROUGH_FIXED = 5.8e-5
GNU = 1.5e-5
# Beljaars scheme coefficients (ocean_rough_mod.F90:50-54)
ZCOM1 = 0.0110         # alpha (charnock-like term)
ZCOM2 = 0.11           # viscosity term
ZCOH1 = 0.0
ZCOH2 = 0.40
ZCOQ1 = 0.0
ZCOQ2 = 0.62


def escomp(T):
    """Saturation vapor pressure (Pa) at temperature T (K): Goff-Gratch
    over water/ice with linear blend in [-20C, 0C]
    (``compute_es_k:131-192``)."""
    TBASI = cn.Tffresh            # 273.15
    TBASW = cn.Tffresh + 100.0
    ESBASW = 101324.60
    ESBASI = 610.71
    Ts = torch.clamp(T, min=100.0)  # avoid 1/T blowup on masked points
    xi = (-9.09718 * (TBASI / Ts - 1.0)
          - 3.56654 * torch.log10(TBASI / Ts)
          + 0.876793 * (1.0 - Ts / TBASI) + math.log10(ESBASI))
    esice = 10.0 ** xi
    xw = (-7.90298 * (TBASW / Ts - 1.0)
          + 5.02808 * torch.log10(TBASW / Ts)
          - 1.3816e-7 * (10.0 ** ((1.0 - Ts / TBASW) * 11.344) - 1.0)
          + 8.1328e-3 * (10.0 ** ((TBASW / Ts - 1.0) * -3.49149) - 1.0)
          + math.log10(ESBASW))
    esh2o = 10.0 ** xw
    blend = 0.05 * ((TBASI - Ts) * esice + (Ts - TBASI + 20.0) * esh2o)
    return torch.where(Ts <= TBASI - 20.0, esice,
                       torch.where(Ts >= TBASI, esh2o, blend))


def compute_ocean_roughness(u_star, scheme: str = "beljaars"):
    """(rough_mom, rough_heat, rough_moist) from the previous-interval
    friction velocity (``ocean_rough_mod.F90
    compute_ocean_roughness:63-199``; highwind options off)."""
    if scheme == "fixed":
        r = torch.full_like(u_star, ROUGH_FIXED)
        return r, r, r
    ustar2 = torch.clamp(u_star * u_star, min=GNU * GNU)
    xx1 = GNU / torch.sqrt(ustar2)
    xx2 = ustar2 / cn.gravit
    if scheme == "charnock":
        rough_mom = torch.clamp(CHARNOCK * xx2, min=ROUGHNESS_MIN)
        return rough_mom, rough_mom, rough_mom
    if scheme != "beljaars":
        raise ValueError(f"unknown rough_scheme {scheme!r}")
    rough_mom = torch.clamp(ZCOM1 * xx2 + ZCOM2 * xx1, min=ROUGHNESS_MIN)
    rough_heat = torch.clamp(ZCOH1 * xx2 + ZCOH2 * xx1, min=ROUGHNESS_MIN)
    rough_moist = torch.clamp(ZCOQ1 * xx2 + ZCOQ2 * xx1, min=ROUGHNESS_MIN)
    return rough_mom, rough_heat, rough_moist


def _phi_stable(zeta, stable_option):
    b_stab = 1.0 / RICH_CRIT
    zp = torch.clamp(zeta, min=0.0)
    if stable_option == 1:
        return 1.0 + zp * (5.0 + b_stab * zp) / (1.0 + zp)
    lam = 1.0 + (5.0 - b_stab) * ZETA_TRANS
    return torch.where(zp < ZETA_TRANS, 1.0 + 5.0 * zp, lam + b_stab * zp)


def _phi(zeta, stable_option=1):
    """Differential similarity function for tracers
    (``monin_obukhov_derivative_t:402-450``)."""
    unstable = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** (-0.5)
    return torch.where(zeta >= 0.0, _phi_stable(zeta, stable_option),
                       unstable)


def _phi_m(zeta, stable_option=1):
    """``monin_obukhov_derivative_m:452-505`` (unstable exponent -1/4)."""
    unstable = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** (-0.25)
    return torch.where(zeta >= 0.0, _phi_stable(zeta, stable_option),
                       unstable)


def _psi_stable(zp, zp0, ln_z_z0, stable_option):
    """The stable branch shared by both integral functions; `zp` >= puny
    and `zp0` >= 0."""
    b_stab = 1.0 / RICH_CRIT
    if stable_option == 1:
        return ln_z_z0 + (5.0 - b_stab) * torch.log((1.0 + zp)
                                                    / (1.0 + zp0)) \
            + b_stab * (zp - zp0)
    lam = 1.0 + (5.0 - b_stab) * ZETA_TRANS
    weak = ln_z_z0 + 5.0 * (zp - zp0)
    xs = (lam - 1.0) * torch.log(zp / ZETA_TRANS) \
        + b_stab * (zp - ZETA_TRANS)
    strong = torch.where(zp0 <= ZETA_TRANS,
                         ln_z_z0 + xs + 5.0 * (ZETA_TRANS - zp0),
                         lam * ln_z_z0 + b_stab * (zp - zp0))
    return torch.where(zp <= ZETA_TRANS, weak, strong)


def _psi_m(zeta, zeta_0, ln_z_z0, stable_option=1):
    """Integral similarity function for momentum
    (``monin_obukhov_integral_m:619-697``)."""
    zn = torch.clamp(zeta, max=0.0)
    zn0 = torch.clamp(zeta_0, max=0.0)
    x = torch.sqrt(torch.sqrt(1.0 - 16.0 * zn))
    x0 = torch.sqrt(torch.sqrt(1.0 - 16.0 * zn0))
    x1, x1_0 = 1.0 + x, 1.0 + x0
    num = x1 * x1 * (1.0 + x * x)
    den = x1_0 * x1_0 * (1.0 + x0 * x0)
    unst = ln_z_z0 - torch.log(num / den) \
        + 2.0 * (torch.atan(x) - torch.atan(x0))
    st = _psi_stable(torch.clamp(zeta, min=cn.puny),
                     torch.clamp(zeta_0, min=0.0), ln_z_z0, stable_option)
    return torch.where(zeta >= 0.0, st, unst)


def _psi_t(zeta, zeta_t, ln_z_zt, stable_option=1):
    """Integral similarity function for tracers
    (``monin_obukhov_integral_tq:699-782``)."""
    zn = torch.clamp(zeta, max=0.0)
    znt = torch.clamp(zeta_t, max=0.0)
    x = torch.sqrt(1.0 - 16.0 * zn)
    xt = torch.sqrt(1.0 - 16.0 * znt)
    unst = ln_z_zt - 2.0 * torch.log((1.0 + x) / (1.0 + xt))
    st = _psi_stable(torch.clamp(zeta, min=cn.puny),
                     torch.clamp(zeta_t, min=0.0), ln_z_zt, stable_option)
    return torch.where(zeta >= 0.0, st, unst)


def _nonzero(a):
    return torch.where(a != 0.0, a, 1.0)


def _solve_zeta(rich, z, z0, zt, zq, mask, stable_option=1):
    """Newton iteration for the stability parameter zeta
    (``monin_obukhov_solve_zeta:224-400``).  Returns (f_m, f_t, f_q).

    The reference shrinks its active-point set as points converge; here
    every point iterates MO_MAX_ITER times, masked, and converged points
    stop moving: the same fixed point, and no test on the host.
    """
    z_z0, z_zt, z_zq = z / z0, z / zt, z / zq
    ln_z_z0, ln_z_zt, ln_z_zq = (torch.log(z_z0), torch.log(z_zt),
                                 torch.log(z_zq))

    zeta = rich * ln_z_z0 * ln_z_z0 / ln_z_zt
    zeta = torch.where(rich >= 0.0,
                       zeta / torch.clamp(1.0 - rich / RICH_CRIT,
                                          min=cn.puny),
                       zeta)
    live = mask & (zeta.abs() >= 0.0)
    for _ in range(MO_MAX_ITER):
        # points whose zeta collapsed to ~0 use neutral logs and stop
        live = live & ~(zeta.abs() < ZETA_MIN)
        zs = torch.where(live, zeta, torch.sign(zeta) * 1.0 + ZETA_MIN)
        rzeta = 1.0 / zs
        zeta_0 = zs / z_z0
        zeta_t = zs / z_zt
        f_m = _psi_m(zs, zeta_0, ln_z_z0, stable_option)
        f_t = _psi_t(zs, zeta_t, ln_z_zt, stable_option)
        df_m = (_phi_m(zs, stable_option)
                - _phi_m(zeta_0, stable_option)) * rzeta
        df_t = (_phi(zs, stable_option)
                - _phi(zeta_t, stable_option)) * rzeta
        rich_1 = zs * f_t / torch.clamp(f_m * f_m, min=cn.puny)
        d_rich = rich_1 * (rzeta + df_t / _nonzero(f_t)
                           - 2.0 * df_m / _nonzero(f_m))
        corr = (rich - rich_1) / torch.where(d_rich.abs() > cn.puny,
                                             d_rich, 1.0)
        crit = torch.minimum(corr.abs(), (corr * rzeta).abs())
        conv = crit <= MO_ERROR
        zeta = torch.where(live & ~conv, zeta + corr, zeta)
        live = live & ~conv

    tiny = zeta.abs() < ZETA_MIN
    zs = torch.where(tiny, 1.0, zeta)
    f_m = torch.where(tiny, ln_z_z0, _psi_m(zs, zs / z_z0, ln_z_z0,
                                            stable_option))
    f_t = torch.where(tiny, ln_z_zt, _psi_t(zs, zs / z_zt, ln_z_zt,
                                            stable_option))
    f_q = torch.where(tiny, ln_z_zq, _psi_t(zs, zs / z_zq, ln_z_zq,
                                            stable_option))
    return f_m, f_t, f_q


def mo_drag(thv_atm, thv_surf, z, rough_mom, rough_heat, rough_moist,
            speed, mask=None, neutral=False, stable_option=1):
    """Monin-Obukhov drag coefficients
    (``monin_obukhov_drag_1d:101-222``).

    Returns (cd_m, cd_t, cd_q, u_star, b_star)."""
    if mask is None:
        mask = torch.ones_like(speed, dtype=torch.bool)
    z0, zt, zq = rough_mom, rough_heat, rough_moist
    delta_b = cn.gravit * (thv_surf - thv_atm) \
        / torch.clamp(thv_surf, min=cn.puny)
    rich = -z * delta_b / (speed * speed + MO_SMALL)
    rich = torch.where(mask, rich, 0.0)
    zz = torch.maximum(torch.maximum(z, z0), torch.maximum(zt, zq))

    if neutral:
        fm = torch.log(zz / z0)
        ft = torch.log(zz / zt)
        fq = torch.log(zz / zq)
        sqrt_drag_min = 0.0
    else:
        r_crit = 0.95 * RICH_CRIT
        fm, ft, fq = _solve_zeta(rich, zz, z0, zt, zq,
                                 mask & (rich < r_crit), stable_option)
        big = math.sqrt(1.0 / DRAG_MIN) * cn.vonkar  # -> drag == DRAG_MIN
        crit = rich >= r_crit
        fm = torch.where(crit, big, fm)
        ft = torch.where(crit, big, ft)
        fq = torch.where(crit, big, fq)
        sqrt_drag_min = math.sqrt(DRAG_MIN)

    us = torch.clamp(cn.vonkar / fm, min=sqrt_drag_min)
    bs = torch.clamp(cn.vonkar / ft, min=sqrt_drag_min)
    qs = torch.clamp(cn.vonkar / fq, min=sqrt_drag_min)
    cd_m = us * us
    cd_t = us * bs
    cd_q = us * qs
    u_star = us * speed
    b_star = bs * delta_b
    return tuple(torch.where(mask, a, 0.0)
                 for a in (cd_m, cd_t, cd_q, u_star, b_star))


def ncar_ocean_fluxes(u_del, t, ts, q, qs, z, mask):
    """Large & Yeager (2004) neutral-10m coefficient scheme
    (``surface_flux_mod.F90 ncar_ocean_fluxes:822-960``, the corrected
    non-orig branch).  Returns (cd, ch, ce, ustar, bstar)."""
    tv = t * (1.0 + 0.608 * q)
    u = torch.clamp(u_del, min=0.5)
    u10 = u

    def n10(u10, stab):
        cd_n10 = (2.7 / u10 + 0.142 + 0.0764 * u10) / 1e3
        rt = torch.sqrt(cd_n10)
        ce_n10 = 34.6 * rt / 1e3
        ch_n10 = (18.0 * stab + 32.7 * (1.0 - stab)) * rt / 1e3
        return cd_n10, ch_n10, ce_n10, rt

    stab0 = 0.5 + 0.5 * torch.sign(t - ts)
    cd, ch, ce, cd_n10_rt = n10(u10, stab0)
    cd_n10 = cd
    ustar = torch.sqrt(cd) * u
    bstar = torch.zeros_like(u)
    for _ in range(2):  # n_itts = 2
        cd_rt = torch.sqrt(cd)
        ustar = cd_rt * u
        tstar = (ch / cd_rt) * (t - ts)
        qstar = (ce / cd_rt) * (q - qs)
        bstar = cn.gravit * (tstar / tv + qstar / (q + 1.0 / 0.608))
        zeta = cn.vonkar * bstar * z / (ustar * ustar)
        zeta = torch.sign(zeta) * torch.clamp(zeta.abs(), max=10.0)
        x2 = torch.clamp(torch.sqrt((1.0 - 16.0 * zeta).abs()), min=1.0)
        x = torch.sqrt(x2)
        psi_m = torch.where(
            zeta > 0.0, -5.0 * zeta,
            torch.log((1.0 + 2.0 * x + x2) * (1.0 + x2) / 8.0)
            - 2.0 * (torch.atan(x) - math.atan(1.0)))
        psi_h = torch.where(zeta > 0.0, -5.0 * zeta,
                            2.0 * torch.log((1.0 + x2) / 2.0))
        u10 = u / (1.0 + cd_n10_rt * (torch.log(z / 10.0) - psi_m)
                   / cn.vonkar)
        stab = 0.5 + 0.5 * torch.sign(zeta)
        cd_n10, ch_n10, ce_n10, cd_n10_rt = n10(u10, stab)
        xxm = (torch.log(z / 10.0) - psi_m) / cn.vonkar
        xxh = (torch.log(z / 10.0) - psi_h) / cn.vonkar
        cd = cd_n10 / (1.0 + cd_n10_rt * xxm) ** 2
        ch = ch_n10 / (1.0 + ch_n10 * xxh / cd_n10_rt) ** 2
        ce = ce_n10 / (1.0 + ce_n10 * xxh / cd_n10_rt) ** 2
    return tuple(torch.where(mask, a, 0.0)
                 for a in (cd, ch, ce, ustar, bstar))


def surface_flux(t_atm, q_atm_in, u_atm, v_atm, p_atm, z_atm,
                 p_surf, t_surf, u_surf, v_surf,
                 rough_mom, rough_heat, rough_moist, rough_scale,
                 gust, mask, *, use_ncar=False, gust_min=0.0,
                 stable_option=1):
    """Bulk surface fluxes over open water
    (``surface_flux_mod.F90 surface_flux_1d:339-586``; seawater only:
    the ACCESS driver sets avail = seawater, so the land branches are
    dead there).

    Returns a dict with flux_t/q/r/u/v, derivatives, transfer
    coefficients, w_atm, u_star, b_star, q_star.
    """
    del_temp = 0.1

    t_surf0 = torch.where(mask, t_surf, 200.0)
    e_sat = escomp(t_surf0)
    e_sat1 = escomp(t_surf0 + del_temp)
    # surface specific humidity at saturation (use_mixing_ratio=F)
    q_sat = d622 * e_sat / (p_surf - d378 * e_sat)
    q_sat1 = d622 * e_sat1 / (p_surf - d378 * e_sat1)
    q_surf0 = q_sat                          # saturated surface
    q_atm = torch.clamp(q_atm_in, min=0.0)   # no_neg_q

    p_ratio = (p_surf / p_atm) ** kappa
    tv_atm = t_atm * (1.0 + d608 * q_atm)
    th_atm = t_atm * p_ratio
    thv_atm = tv_atm * p_ratio
    thv_surf = t_surf0 * (1.0 + d608 * q_surf0)

    u_dif = u_surf - u_atm
    v_dif = v_surf - v_atm
    w_gust = torch.clamp(gust, min=gust_min) if gust_min > 0.0 else gust
    w_atm = torch.sqrt(u_dif * u_dif + v_dif * v_dif + w_gust * w_gust)
    dw_atmdu = u_dif / torch.clamp(w_atm, min=cn.puny)
    dw_atmdv = v_dif / torch.clamp(w_atm, min=cn.puny)

    cd_m, cd_t, cd_q, u_star, b_star = mo_drag(
        thv_atm, thv_surf, z_atm, rough_mom, rough_heat, rough_moist,
        w_atm, mask, stable_option=stable_option)
    if use_ncar:
        cd_m, cd_t, cd_q, u_star, b_star = ncar_ocean_fluxes(
            w_atm, th_atm, t_surf0, q_atm, q_surf0, z_atm, mask)

    # orographic roughness rescale (:508-513; rough_scale=1 in the ACCESS
    # driver, so a no-op there)
    cd_m = cd_m * (torch.log(z_atm / rough_mom + 1.0)
                   / torch.log(z_atm / (rough_scale * rough_mom)
                               + 1.0)) ** 2

    drag_t = cd_t * w_atm
    drag_q = cd_q * w_atm
    drag_m = cd_m * w_atm
    rho = p_atm / (rdgas * tv_atm)

    rho_drag_t = cn.cp_air * drag_t * rho
    flux_t = rho_drag_t * (t_surf0 - th_atm)
    dhdt_surf = rho_drag_t
    dhdt_atm = -rho_drag_t * p_ratio

    rho_drag_q = drag_q * rho
    flux_q = rho_drag_q * (q_surf0 - q_atm)
    dedt_surf = rho_drag_q * (q_sat1 - q_sat) / del_temp
    dedq_surf = torch.zeros_like(flux_q)
    dedq_atm = -rho_drag_q
    q_star = flux_q / torch.clamp(u_star * rho, min=cn.puny)

    flux_r = cn.stefan_boltzmann * t_surf0 ** 4
    drdt_surf = 4.0 * cn.stefan_boltzmann * t_surf0 ** 3

    rho_drag_m = drag_m * rho
    flux_u = rho_drag_m * u_dif
    flux_v = rho_drag_m * v_dif
    dtaudu_atm = -cd_m * rho * (dw_atmdu * u_dif + w_atm)
    dtaudv_atm = -cd_m * rho * (dw_atmdv * v_dif + w_atm)

    out = dict(flux_t=flux_t, flux_q=flux_q, flux_r=flux_r,
               flux_u=flux_u, flux_v=flux_v,
               dhdt_surf=dhdt_surf, dedt_surf=dedt_surf,
               dedq_surf=dedq_surf, drdt_surf=drdt_surf,
               dhdt_atm=dhdt_atm, dedq_atm=dedq_atm,
               dtaudu_atm=dtaudu_atm, dtaudv_atm=dtaudv_atm,
               w_atm=w_atm, u_star=u_star, b_star=b_star,
               q_star=q_star, cd_m=cd_m, cd_t=cd_t, cd_q=cd_q)
    return {k: torch.where(mask, v, 0.0) for k, v in out.items()}


def gfdl_ocean_fluxes(tair, qair, uwnd, vwnd, press, sst, ssu, ssv,
                      u_star_prev, tmask, *, zlvl=10.0,
                      rough_scheme="beljaars", use_ncar=False):
    """Open-water fluxes for the coupled OM configuration
    (``cpl_forcing_handler.F90 gfdl_ocean_fluxes:925-1056``).

    sst in Kelvin (values < 250 are treated as Celsius and shifted, as
    the reference does).  Returns the fluxes sign-flipped for the ocean
    (sh, lh, lwo, taox, taoy), zero on land, plus the new u_star and the
    roughness fields to carry to the next coupling interval.

    On CUDA tensors this launches the gfdl_column kernel (or raises); on
    CPU tensors it runs the plain version :func:`_gfdl_ocean_fluxes_plain`.
    `gfdl_ocean_fluxes.launches` counts the kernel's launches (on this
    function, whatever wraps it later), and ``gfdl_cuda.mo_passes(device)``
    keeps their most Newton passes of any cell.
    """
    args = (tair, qair, uwnd, vwnd, press, sst, ssu, ssv, u_star_prev,
            tmask)
    if tair.device.type == "cpu":
        return _gfdl_ocean_fluxes_plain(*args, zlvl=zlvl,
                                        rough_scheme=rough_scheme,
                                        use_ncar=use_ncar)
    if tair.device.type != "cuda":
        raise NotImplementedError(
            f"gfdl_ocean_fluxes has no path for device {tair.device}")
    from cice4_tpu_torch.ops import gfdl_cuda

    out = gfdl_cuda.gfdl_ocean_fluxes_cuda(
        *args, zlvl=zlvl, rough_scheme=rough_scheme, use_ncar=use_ncar)
    _counted.launches += 1
    return out


gfdl_ocean_fluxes.launches = 0
_counted = gfdl_ocean_fluxes


def _gfdl_ocean_fluxes_plain(tair, qair, uwnd, vwnd, press, sst, ssu, ssv,
                             u_star_prev, tmask, *, zlvl=10.0,
                             rough_scheme="beljaars", use_ncar=False):
    """:func:`gfdl_ocean_fluxes` in plain PyTorch, on any device; the
    kernel's oracle."""
    mask = tmask
    t_surf = torch.where(sst < 250.0, sst + cn.Tffresh, sst)
    tv_atm = tair * (1.0 + d608 * qair)
    d_atm = press / (rdgas * tv_atm)
    p_atm = press - d_atm * cn.gravit * zlvl

    rough_mom, rough_heat, rough_moist = compute_ocean_roughness(
        u_star_prev, rough_scheme)
    rough_mom = torch.where(mask, rough_mom, ROUGHNESS_MIN)
    rough_heat = torch.where(mask, rough_heat, ROUGHNESS_MIN)
    rough_moist = torch.where(mask, rough_moist, ROUGHNESS_MIN)

    z_atm = torch.full_like(tair, zlvl)
    gust = torch.ones_like(tair)            # gust0 = 1.0
    out = surface_flux(tair, qair, uwnd, vwnd, p_atm, z_atm,
                       press, t_surf, ssu, ssv,
                       rough_mom, rough_heat, rough_moist,
                       torch.ones_like(tair), gust, mask,
                       use_ncar=use_ncar)
    return dict(
        sh=-out["flux_t"],
        lh=-out["flux_q"] * cn.Lvap,
        lwo=-out["flux_r"],
        taox=-out["flux_u"],
        taoy=-out["flux_v"],
        u_star=out["u_star"],
        rough_mom=rough_mom, rough_heat=rough_heat,
        rough_moist=rough_moist,
    )
