"""Vertical thermodynamics: energy-conserving multilayer column physics.

Port of :mod:`cice4_tpu.ops.therm_vertical` (``source/ice_therm_vertical.F90``,
Bitz & Lipscomb 1999).  Planes are ``(..., ny, nx)`` and layer stacks
``(..., nlyr, ny, nx)``: the model passes all categories at once with a
leading ``ncat`` axis, where the JAX package vmaps over categories.

The Newton temperature solve has two implementations behind one
wrapper, :func:`temperature_changes`:

* on a CUDA tensor, the hand-written Hopper kernel
  ``csrc/therm_newton.cu`` (one thread per category cell, each with its
  own Newton loop) — it replaces the TPU kernel ``_tc_kernel``;
* on a CPU tensor, the plain PyTorch version
  :func:`_temperature_changes_core`, a masked whole-grid loop that is
  the kernel's oracle.

The zero-layer, prescribed-flux and explicit-surface variants wait for
ROADMAP queue 1 item 4 and raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from cice4_tpu_torch import constants as cn

# module parameters (ice_therm_vertical.F90:44-66)
hs_min = 1.0e-4      # min snow thickness for computing Tsno (m)
betak = 0.13         # conductivity salinity constant (W/m/ppt)
kimin = 0.10         # min conductivity of saline ice (W/m/K)
ferrmax = 1.0e-3     # max allowed energy flux error (W/m^2)
Tsf_errmax = 5.0e-4  # max allowed Tsf error (K)
nitermax = 100


@dataclasses.dataclass(frozen=True)
class ThermoParams:
    """Static thermo configuration + fixed vertical profiles."""

    nilyr: int
    nslyr: int
    salin: tuple        # (nilyr+1,) fixed salinity profile
    tmlt: tuple         # (nilyr+1,) melting temperatures (C)
    l_brine: bool
    heat_capacity: bool = True
    calc_Tsfc: bool = True
    conduct: str = "MU71"
    ustar_min: float = 0.05


def make_thermo_params(cfg, itd) -> ThermoParams:
    return ThermoParams(
        nilyr=itd.nilyr, nslyr=itd.nslyr,
        salin=tuple(float(s) for s in itd.salin),
        tmlt=tuple(float(t) for t in itd.tmlt),
        l_brine=bool(itd.salin[0] > 0.1) and cfg.thermo.heat_capacity,
        heat_capacity=cfg.thermo.heat_capacity,
        calc_Tsfc=cfg.thermo.calc_Tsfc,
        conduct=cfg.thermo.conduct,
        ustar_min=cfg.thermo.ustar_min,
    )


def _profile(vals, nilyr, like):
    """Fixed vertical profile as a (nilyr, 1, 1) tensor like `like`."""
    return torch.tensor([float(v) for v in vals[:nilyr]], dtype=like.dtype,
                        device=like.device).reshape(nilyr, 1, 1)


def _lay(a, k):
    """Layer k of a (..., nlyr, ny, nx) stack."""
    return a[..., k, :, :]


def _stack(planes):
    return torch.stack(planes, dim=-3)


def tin_from_qin(p: ThermoParams, qin, tmlt_k):
    """Invert layer enthalpy -> temperature (``calculate_Tin_from_qin``,
    ice_therm_vertical.F90:1227-1260)."""
    if p.l_brine:
        aa1 = cn.cp_ice
        bb1 = (cn.cp_ocn - cn.cp_ice) * tmlt_k - qin / cn.rhoi - cn.Lfresh
        cc1 = cn.Lfresh * tmlt_k
        disc = torch.clamp(bb1 * bb1 - 4.0 * aa1 * cc1, min=0.0)
        return (-bb1 - torch.sqrt(disc)) / (2.0 * aa1)
    return (cn.Lfresh + qin / cn.rhoi) / cn.cp_ice


def qin_of_tin(p: ThermoParams, tin, tmlt_k):
    """Layer temperature -> enthalpy (J/m^3, negative)."""
    if p.l_brine:
        tin_safe = torch.clamp(tin, max=-cn.puny)
        return -cn.rhoi * (cn.cp_ice * (tmlt_k - tin_safe)
                           + cn.Lfresh * (1.0 - tmlt_k / tin_safe)
                           - cn.cp_ocn * tmlt_k)
    return -cn.rhoi * (-cn.cp_ice * tin + cn.Lfresh)


def qsn_of_tsn(tsn):
    return -cn.rhos * (cn.Lfresh - cn.cp_ice * tsn)


def frzmlt_bottom_lateral(p: ThermoParams, dt, aice, frzmlt, eicen_all,
                          esnon_all, sst, Tf, strocnxT, strocnyT):
    """Ocean heat available for bottom/lateral melt
    (``ice_therm_vertical.F90 frzmlt_bottom_lateral:605-824``).

    eicen_all/esnon_all: (ncat, nlyr, ny, nx).  Returns (Tbot, fbot,
    rside).
    """
    floediam, alpha, m1, m2 = 300.0, 0.66, 1.6e-6, 1.36
    cpchr = -cn.cp_ocn * cn.rhow * 0.006

    Tbot = Tf
    melt = (aice > cn.puny) & (frzmlt < 0.0)
    deltaT = torch.clamp(sst - Tbot, min=0.0)
    ustar = torch.sqrt(torch.sqrt(strocnxT**2 + strocnyT**2) / cn.rhow)
    ustar = torch.clamp(ustar, min=p.ustar_min)
    fbot = cpchr * deltaT * ustar
    fbot = torch.maximum(fbot, frzmlt)
    fbot = torch.where(melt, fbot, 0.0)

    wlat = m1 * deltaT**m2
    rside = torch.clamp(wlat * dt * cn.pi / (alpha * floediam), 0.0, 1.0)
    rside = torch.where(melt, rside, 0.0)

    etot = eicen_all.sum((0, 1)) + esnon_all.sum((0, 1))
    fside = rside * etot / dt  # <= 0

    xtmp = frzmlt / (fbot + fside + cn.puny)
    xtmp = torch.clamp(xtmp, max=1.0)
    xtmp = torch.where(melt, xtmp, 1.0)
    return Tbot, fbot * xtmp, rside * xtmp


def _conductivity(p: ThermoParams, l_snow, hilyr, hslyr, Tin):
    """Interface conductivities kh, a list of nmat = nslyr+nilyr+1
    planes (0-based kh[i] == reference kh(i+1)) (``conductivity:2169-2295``)."""
    nilyr, nslyr = p.nilyr, p.nslyr
    salin = _profile(p.salin, nilyr, Tin)
    tneg = torch.clamp(Tin, max=-cn.puny)
    if p.conduct == "MU71":
        kilyr = cn.kice + betak * salin / tneg
    else:  # bubbly brine (Pringle et al 2007)
        kilyr = (2.11 - 0.011 * Tin + 0.09 * salin / tneg) \
            * cn.rhoi / 917.0
    kilyr = torch.clamp(kilyr, min=kimin)
    ki = [_lay(kilyr, k) for k in range(nilyr)]
    ks = cn.ksno

    kh = []
    # kh[0]: top of snow (0 without snow)
    kh.append(torch.where(l_snow, 2.0 * ks / torch.clamp(hslyr, min=cn.puny),
                          0.0))
    # interior snow interfaces
    for _ in range(1, nslyr):
        kh.append(torch.where(
            l_snow, 2.0 * ks * ks
            / torch.clamp((ks + ks) * hslyr, min=cn.puny), 0.0))
    # snow/ice interface (or top ice surface without snow)
    kh.append(torch.where(
        l_snow,
        2.0 * ks * ki[0]
        / torch.clamp(ks * hilyr + ki[0] * hslyr, min=cn.puny),
        2.0 * ki[0] / torch.clamp(hilyr, min=cn.puny)))
    # interior ice interfaces
    for k in range(1, nilyr):
        kh.append(2.0 * ki[k - 1] * ki[k]
                  / torch.clamp((ki[k - 1] + ki[k]) * hilyr, min=cn.puny))
    # bottom surface
    kh.append(2.0 * ki[nilyr - 1] / torch.clamp(hilyr, min=cn.puny))
    return kh


def _surface_fluxes(Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef):
    """Surface flux linearization (``surface_fluxes:2314-2423``)."""
    TsfK = Tsf + cn.Tffresh
    inv = 1.0 / TsfK
    qsat = cn.qqqice * torch.exp(-cn.TTTice * inv)
    Qsfc = qsat / rhoa
    dQsfcdT = cn.TTTice * inv * inv * Qsfc
    flwdabs = cn.emissivity * flw
    flwoutn = -cn.emissivity * cn.stefan_boltzmann * TsfK**4
    fsensn = shcoef * (potT - TsfK)
    flatn = lhcoef * (Qa - Qsfc)
    dflwout_dT = -cn.emissivity * cn.stefan_boltzmann * 4.0 * TsfK**3
    dfsens_dT = -shcoef
    dflat_dT = -lhcoef * dQsfcdT
    fsurfn = fswsfc + flwdabs + flwoutn + fsensn + flatn
    dfsurf_dT = dflwout_dT + dfsens_dT + dflat_dT
    return dict(flwoutn=flwoutn, fsensn=fsensn, flatn=flatn, fsurfn=fsurfn,
                dflwout_dT=dflwout_dT, dfsens_dT=dfsens_dT,
                dflat_dT=dflat_dT, dfsurf_dT=dfsurf_dT)


def _tridiag(sb, d, sp, rhs):
    """Thomas algorithm over a list of row planes."""
    n = len(d)
    d = list(d)
    rhs = list(rhs)
    for k in range(1, n):
        w = sb[k] / d[k - 1]
        d[k] = d[k] - w * sp[k - 1]
        rhs[k] = rhs[k] - w * rhs[k - 1]
    x = [None] * n
    x[n - 1] = rhs[n - 1] / d[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = (rhs[k] - sp[k] * x[k + 1]) / d[k]
    return x


def _move_sw_to_surface(p, dt_rhoi_hlyr, etas, l_snow, tmlt, Tin_init,
                        Tsn_init, fswsfc, fswint, Sswabs, Iswabs):
    """Move absorbed SW that would overheat a layer into the surface
    (``temperature_changes:1531-1599``)."""
    nilyr, nslyr = p.nilyr, p.nslyr
    frac, dTemp = 0.9, 0.02
    dtr = dt_rhoi_hlyr.unsqueeze(-3)
    if p.l_brine:
        ci0 = cn.cp_ice - cn.Lfresh * tmlt \
            / torch.clamp(Tin_init, max=-cn.puny) ** 2
        room = frac * (tmlt - Tin_init) * ci0 / dtr
        is_cold = Tin_init <= (tmlt - dTemp)
    else:
        room = frac * (-Tin_init) * cn.cp_ice / dtr
        is_cold = Tin_init <= -dTemp
    Iswabs_tmp = torch.where(is_cold, torch.minimum(Iswabs, room), 0.0)
    Iswabs_tmp = torch.where(Iswabs_tmp < cn.puny, 0.0, Iswabs_tmp)
    isw = [_lay(Iswabs, k) for k in range(nilyr)]
    for k in range(nilyr):
        dswabs = torch.minimum(isw[k] - _lay(Iswabs_tmp, k), fswint)
        fswsfc = fswsfc + dswabs
        fswint = fswint - dswabs
        isw[k] = isw[k] - dswabs
    Sswabs_tmp = torch.where(
        Tsn_init <= -dTemp,
        torch.minimum(Sswabs, -frac * Tsn_init
                      / torch.clamp(etas, min=cn.puny).unsqueeze(-3)), 0.0)
    Sswabs_tmp = torch.where(Sswabs < cn.puny, 0.0, Sswabs_tmp)
    ssw = [_lay(Sswabs, k) for k in range(nslyr)]
    for k in range(nslyr):
        dswabs = torch.where(
            l_snow, torch.minimum(ssw[k] - _lay(Sswabs_tmp, k), fswint), 0.0)
        fswsfc = fswsfc + dswabs
        fswint = fswint - dswabs
        ssw[k] = ssw[k] - dswabs
    return fswsfc, fswint, _stack(ssw), _stack(isw)


def _temperature_changes_core(p: ThermoParams, dt, has_ice,
                              rhoa, flw, potT, Qa, shcoef, lhcoef,
                              fswsfc, fswint, fswthrun, Sswabs, Iswabs,
                              hilyr, hslyr, qin, Tin, qsn, Tsn, Tsf,
                              Tbot, einit):
    """Newton-iterated implicit temperature solve, plain PyTorch
    (``temperature_changes:1288-2148``; the JAX package's
    `_temperature_changes_core`).

    A whole-grid loop that updates only active (unconverged, icy) cells
    through masks, until every icy cell satisfies the five convergence
    conditions or `nitermax` is reached.  The loop test reads one bool
    from the device per iteration; this version serves the CPU and is
    the oracle of the CUDA kernel.
    """
    nilyr, nslyr = p.nilyr, p.nslyr
    tmlt = _profile(p.tmlt, nilyr, Tsf)
    tm = [_lay(tmlt, k) for k in range(nilyr)]

    l_snow = has_ice & (hslyr > hs_min / nslyr)
    dt_rhoi_hlyr = dt / (cn.rhoi * torch.clamp(hilyr, min=cn.puny))
    etas = torch.where(
        l_snow, dt / (cn.rhos * cn.cp_ice * torch.clamp(hslyr, min=cn.puny)),
        0.0)

    Tsn_init = Tsn
    Tin_init = Tin
    tin0 = [_lay(Tin_init, k) for k in range(nilyr)]
    tsn0 = [_lay(Tsn_init, k) for k in range(nslyr)]

    kh = _conductivity(p, l_snow, hilyr, hslyr, Tin)
    fswsfc, fswint, Sswabs, Iswabs = _move_sw_to_surface(
        p, dt_rhoi_hlyr, etas, l_snow, tmlt, Tin_init, Tsn_init,
        fswsfc, fswint, Sswabs, Iswabs)
    fswabsn = fswsfc + fswint + fswthrun
    ssw = [_lay(Sswabs, k) for k in range(nslyr)]
    isw = [_lay(Iswabs, k) for k in range(nilyr)]

    def assemble_and_solve(Tsf_c, Tin_c, kh_c, l_cold, sf):
        """Build the nmat-row tridiagonal system and solve."""
        if p.l_brine:
            etai = [dt_rhoi_hlyr / (cn.cp_ice - cn.Lfresh * tm[k]
                                    / (torch.clamp(_lay(Tin_c, k), max=-cn.puny)
                                       * torch.clamp(tin0[k], max=-cn.puny)))
                    for k in range(nilyr)]
        else:
            etai = [dt_rhoi_hlyr / cn.cp_ice for _ in range(nilyr)]

        sb, d, sp, rhs = [], [], [], []
        # row 0: Tsf equation (cold, snow) or dummy
        cold_snow = l_cold & l_snow
        sb.append(torch.zeros_like(Tsf_c))
        d.append(torch.where(cold_snow, sf["dfsurf_dT"] - kh_c[0], 1.0))
        sp.append(torch.where(cold_snow, kh_c[0], 0.0))
        rhs.append(torch.where(cold_snow,
                               sf["dfsurf_dT"] * Tsf_c - sf["fsurfn"], 0.0))
        # snow rows 1..nslyr (row nslyr doubles as Tsf eq when no snow)
        for k in range(nslyr):
            r = k + 1
            sbk = -etas * kh_c[k]
            spk = -etas * kh_c[k + 1]
            dk = 1.0 + etas * (kh_c[k] + kh_c[k + 1])
            rhk = tsn0[k] + etas * ssw[k]
            if k == 0:
                # melting surface: no coupling above; Tsf=0 enters rhs
                sbk = torch.where(l_cold, sbk, 0.0)
                rhk = rhk + torch.where(l_cold, 0.0, etas * kh_c[0] * Tsf_c)
            if r == nslyr:
                # when no snow: row nslyr holds the Tsf equation (if cold)
                cold_nosnow = l_cold & ~l_snow
                sbk = torch.where(l_snow, sbk, 0.0)
                dk = torch.where(l_snow, dk,
                                 torch.where(cold_nosnow,
                                             sf["dfsurf_dT"] - kh_c[nslyr],
                                             1.0))
                spk = torch.where(l_snow, spk,
                                  torch.where(cold_nosnow, kh_c[nslyr], 0.0))
                rhk = torch.where(l_snow, rhk,
                                  torch.where(cold_nosnow,
                                              sf["dfsurf_dT"] * Tsf_c
                                              - sf["fsurfn"], 0.0))
            else:
                dk = torch.where(l_snow, dk, 1.0)
                sbk = torch.where(l_snow, sbk, 0.0)
                spk = torch.where(l_snow, spk, 0.0)
                rhk = torch.where(l_snow, rhk, 0.0)
            sb.append(sbk)
            d.append(dk)
            sp.append(spk)
            rhs.append(rhk)
        # ice rows
        for ki in range(nilyr):
            k = ki + nslyr  # kh interface index above this layer
            sbk = -etai[ki] * kh_c[k]
            spk = -etai[ki] * kh_c[k + 1]
            dk = 1.0 + etai[ki] * (kh_c[k] + kh_c[k + 1])
            rhk = tin0[ki] + etai[ki] * isw[ki]
            if ki == 0:
                # warm surface without snow: Tsf=0 in rhs, no coupling above
                warm_nosnow = ~l_snow & ~l_cold
                rhk = rhk + torch.where(warm_nosnow,
                                        etai[ki] * kh_c[k] * Tsf_c, 0.0)
                sbk = torch.where(warm_nosnow, 0.0, sbk)
            if ki == nilyr - 1:
                rhk = rhk + etai[ki] * kh_c[k + 1] * Tbot
                spk = torch.zeros_like(spk)
            sb.append(sbk)
            d.append(dk)
            sp.append(spk)
            rhs.append(rhk)
        return _tridiag(sb, d, sp, rhs)

    zero = torch.zeros_like(Tsf)
    c = dict(Tsf=Tsf, Tsn=Tsn, Tin=Tin, qsn=qsn, qin=qin, kh=kh,
             dTsf_prev=zero, converged=torch.zeros_like(has_ice),
             fsurfn=zero, fcondtopn=zero, fcondbot=zero,
             fsensn=zero, flatn=zero, flwoutn=zero, dq_col=zero,
             why=torch.zeros(has_ice.shape, dtype=torch.int32,
                             device=has_ice.device))
    eps = torch.finfo(Tsf.dtype).eps
    niter = 0
    niter_cells = torch.zeros_like(c["why"])  # iterations each cell ran
    all_conv = False
    while not all_conv and niter < nitermax:
        active = ~c["converged"] & has_ice
        niter_cells = niter_cells + active.to(torch.int32)
        Tsf_c, Tsn_c, Tin_c, kh_c = c["Tsf"], c["Tsn"], c["Tin"], c["kh"]

        sf = _surface_fluxes(Tsf_c, fswsfc, rhoa, flw, potT, Qa,
                             shcoef, lhcoef)
        # fcondtop with current temps
        fct = torch.where(l_snow, kh_c[0] * (Tsf_c - _lay(Tsn_c, 0)),
                          kh_c[nslyr] * (Tsf_c - _lay(Tin_c, 0)))
        Tsf_c = torch.where(active & (sf["fsurfn"] < fct),
                            torch.clamp(Tsf_c, max=-cn.puny), Tsf_c)
        Tsf_start = Tsf_c
        l_cold = Tsf_c <= -cn.puny

        x = assemble_and_solve(Tsf_c, Tin_c, kh_c, l_cold, sf)

        # extract solution
        Tsf_new = torch.where(l_cold, torch.where(l_snow, x[0], x[nslyr]),
                              0.0)
        dTsf = Tsf_new - Tsf_start
        avg_Tsi = zero
        avg_Tsf = zero
        # condition 1: Tsf > 0
        c1v = Tsf_new > cn.puny
        Tsf_new = torch.where(c1v, 0.0, Tsf_new)
        dTsf = torch.where(c1v, -Tsf_start, dTsf)
        if p.l_brine:
            avg_Tsi = torch.where(c1v, 1.0, avg_Tsi)
        # condition 2: oscillation
        c2v = ((Tsf_start <= -cn.puny)
               & (torch.abs(dTsf) > cn.puny)
               & (torch.abs(c["dTsf_prev"]) > cn.puny)
               & (-dTsf / (c["dTsf_prev"] + cn.puny**2) > 0.5)
               & (niter > 0))
        if p.l_brine:
            avg_Tsf = torch.where(c2v, 1.0, avg_Tsf)
            avg_Tsi = torch.where(c2v, 1.0, avg_Tsi)
        dTsf = torch.where(c2v, 0.5 * dTsf, dTsf)
        Tsf_new = Tsf_new + avg_Tsf * 0.5 * (Tsf_start - Tsf_new)

        # snow temps
        Tsn_new = []
        for k in range(nslyr):
            t = torch.where(l_snow, x[k + 1], 0.0)
            if p.l_brine:
                t = torch.clamp(t, max=0.0)
            t = t + avg_Tsi * 0.5 * (_lay(Tsn_c, k) - t)
            Tsn_new.append(t)
        Tsn_new = _stack(Tsn_new)
        qsn_new = qsn_of_tsn(Tsn_new)

        # ice temps with Tmlt limiting (+ conductivity reduction bookkeeping)
        Tin_new, dqmat, reduce_kh = [], [], []
        for ki in range(nilyr):
            t = x[nslyr + 1 + ki]
            if p.l_brine:
                over = t > (tm[ki] - cn.puny)
                dT = torch.where(over, t - tm[ki], 0.0)
                dq = torch.where(
                    over, cn.rhoi * dT * (cn.cp_ice - cn.Lfresh * tm[ki]
                                          / torch.clamp(t, max=-cn.puny)**2),
                    0.0)
                t = torch.where(over, tm[ki], t)
                reduce_kh.append(over)
                dqmat.append(dq)
            else:
                reduce_kh.append(torch.zeros_like(t, dtype=torch.bool))
                dqmat.append(zero)
            t = t + avg_Tsi * 0.5 * (_lay(Tin_c, ki) - t)
            Tin_new.append(t)
        Tin_new = _stack(Tin_new)
        qin_new = qin_of_tin(p, Tin_new, tmlt)

        enew = sum(hslyr * _lay(qsn_new, k) for k in range(nslyr)) \
            + sum(hilyr * (_lay(qin_new, k) - dqmat[k]) for k in range(nilyr))
        # energy removed by clamping over-warm layers back to Tmlt goes
        # to the ocean via fhocnn (see the JAX package's note)
        dq_col = sum(hilyr * dqmat[k] for k in range(nilyr))

        # update fluxes for dTsf
        fsurfn_new = sf["fsurfn"] + dTsf * sf["dfsurf_dT"]
        fct_new = torch.where(l_snow, kh_c[0] * (Tsf_new - _lay(Tsn_new, 0)),
                              kh_c[nslyr] * (Tsf_new - _lay(Tin_new, 0)))
        c3v = torch.abs(dTsf) > Tsf_errmax
        c4v = (Tsf_new > -cn.puny) & (fsurfn_new < fct_new)
        # condition 5: energy conservation, with the dtype-adaptive
        # ferrmax floor (never binds in f64; see the JAX package)
        fcondbot = kh_c[nslyr + nilyr] * (_lay(Tin_new, nilyr - 1) - Tbot)
        ferr = torch.abs((enew - einit) / dt
                         - (fct_new - fcondbot + fswint))
        noise_scale = (torch.abs(einit) / dt + torch.abs(fct_new)
                       + torch.abs(fcondbot) + torch.abs(fswint))
        ferrmax_eff = torch.clamp(32.0 * eps * noise_scale, min=ferrmax)
        bad_e = ferr > 0.9 * ferrmax_eff

        # conductivity reduction for overshooting layers (":2060-2072"),
        # chained: row ki+nslyr+1 is read back by the next ki
        khr = list(kh_c)
        denom = torch.clamp(torch.abs(fct_new - fcondbot), min=cn.puny)
        fracr = torch.clamp(0.5 * (1.0 - ferr / denom), min=0.1)
        for ki in range(nilyr):
            sel = bad_e & reduce_kh[ki] & (dqmat[ki] > 0.0)
            new_below = torch.where(sel, khr[ki + nslyr + 1] * fracr,
                                    khr[ki + nslyr + 1])
            new_above = torch.where(sel, new_below * fracr, khr[ki + nslyr])
            khr[ki + nslyr + 1] = new_below
            khr[ki + nslyr] = new_above

        conv_now = ~(c1v | c2v | c3v | c4v | bad_e)
        why = (c1v.to(torch.int32) * 1 + c2v.to(torch.int32) * 2
               + c3v.to(torch.int32) * 4 + c4v.to(torch.int32) * 8
               + bad_e.to(torch.int32) * 16)

        # merge: only active cells update
        a3 = active.unsqueeze(-3)

        def mrg(new, old, m=active):
            return torch.where(m, new, old)

        c = dict(
            Tsf=mrg(Tsf_new, c["Tsf"]), Tsn=mrg(Tsn_new, c["Tsn"], a3),
            Tin=mrg(Tin_new, c["Tin"], a3), qsn=mrg(qsn_new, c["qsn"], a3),
            qin=mrg(qin_new, c["qin"], a3),
            kh=[mrg(n, o) for n, o in zip(khr, c["kh"])],
            dTsf_prev=mrg(dTsf, c["dTsf_prev"]),
            converged=mrg(conv_now, c["converged"]),
            fsurfn=mrg(fsurfn_new, c["fsurfn"]),
            fcondtopn=mrg(fct_new, c["fcondtopn"]),
            fcondbot=mrg(fcondbot, c["fcondbot"]),
            fsensn=mrg(sf["fsensn"] + dTsf * sf["dfsens_dT"], c["fsensn"]),
            flatn=mrg(sf["flatn"] + dTsf * sf["dflat_dT"], c["flatn"]),
            flwoutn=mrg(sf["flwoutn"] + dTsf * sf["dflwout_dT"],
                        c["flwoutn"]),
            dq_col=mrg(dq_col, c["dq_col"]),
            why=mrg(why, c["why"]),
        )
        all_conv = bool((c["converged"] | ~has_ice).all())
        niter += 1

    return dict(
        Tsf=c["Tsf"], Tsn=c["Tsn"], Tin=c["Tin"], qsn=c["qsn"], qin=c["qin"],
        fsurfn=c["fsurfn"], fcondtopn=c["fcondtopn"],
        fcondbot=c["fcondbot"], fsensn=c["fsensn"],
        flatn=c["flatn"], flwoutn=c["flwoutn"], fswabsn=fswabsn,
        fswsfc=fswsfc, fswint=fswint, Sswabs=Sswabs, Iswabs=Iswabs,
        dq_flux=c["dq_col"] / dt, converged=c["converged"],
        niter=torch.tensor(niter, dtype=torch.int32), why=c["why"],
        niter_cells=niter_cells,
    )


# ---------------------------------------------------------------------------
# The Hopper kernel (csrc/therm_newton.cu) and its wrapper
# ---------------------------------------------------------------------------

# arguments of temperature_changes after (p, dt, has_ice)
_TC_ARGS = ("rhoa", "flw", "potT", "Qa", "shcoef", "lhcoef", "fswsfc",
            "fswint", "fswthrun", "Sswabs", "Iswabs", "hilyr", "hslyr",
            "qin", "Tin", "qsn", "Tsn", "Tsf", "Tbot", "einit")
# argument order of therm_newton_{f32,f64}; the C side has the same tables
_TC_IN_PLANES = ("rhoa", "flw", "potT", "Qa", "shcoef", "lhcoef", "fswsfc",
                 "fswint", "fswthrun", "hilyr", "hslyr", "Tsf", "Tbot",
                 "einit")
_TC_IN_LAYERS = ("Sswabs", "Iswabs", "qin", "Tin", "qsn", "Tsn")
_TC_OUT_PLANES = ("Tsf", "fsurfn", "fcondtopn", "fcondbot", "fsensn",
                  "flatn", "flwoutn", "fswabsn", "fswsfc", "fswint",
                  "dq_flux")
_TC_OUT_LAYERS = ("Tsn", "Tin", "qsn", "qin", "Sswabs", "Iswabs")
_TC_LAYERS = dict(Sswabs="s", Iswabs="i", qin="i", Tin="i", qsn="s",
                  Tsn="s")
# the layer counts the kernel is instantiated for (template arguments)
_TC_NILYR, _TC_NSLYR = 4, 1


def _therm_newton_fn(dtype):
    from cice4_tpu_torch import cuda_build

    lib = cuda_build.load("therm_newton").lib
    fn = lib.therm_newton_f32 if dtype == torch.float32 \
        else lib.therm_newton_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _temperature_changes_cuda(p: ThermoParams, dt, has_ice, *args):
    """Launch the therm_newton kernel: one thread per (category, j, i)
    cell, all categories in one launch.  Planes are (ny, nx) or
    (ncat, ny, nx) (broadcast along categories by a zero stride); layer
    stacks (..., nlyr, ny, nx).  Returns the dict of
    :func:`_temperature_changes_core`, with `niter` the maximum of the
    per-cell iteration counts (a 0-dim device tensor)."""
    if (p.nilyr, p.nslyr) != (_TC_NILYR, _TC_NSLYR):
        raise NotImplementedError(
            f"therm_newton is instantiated for nilyr={_TC_NILYR}, "
            f"nslyr={_TC_NSLYR}; got nilyr={p.nilyr}, nslyr={p.nslyr}")
    if p.conduct not in ("MU71", "bubbly"):
        raise ValueError(f"unknown conduct {p.conduct!r}")
    fields = dict(zip(_TC_ARGS, args))
    Tsf = fields["Tsf"]
    dtype, device = Tsf.dtype, Tsf.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"therm_newton takes float32 or float64, not {dtype}")
    ny, nx = Tsf.shape[-2:]
    nl = dict(i=p.nilyr, s=p.nslyr)
    lead = torch.broadcast_shapes(
        has_ice.shape[:-2], *(fields[k].shape[:-2] for k in _TC_IN_PLANES),
        *(fields[k].shape[:-3] for k in _TC_IN_LAYERS))
    if len(lead) > 1:
        raise ValueError(f"at most one leading (category) axis, got {lead}")
    ncat = lead[0] if lead else 1

    def fit(x, shape, dt_=dtype):
        if x.device != device or x.dtype != dt_:
            raise TypeError(f"therm_newton input on {x.device} as "
                            f"{x.dtype}; expected {device} as {dt_}")
        x = x.broadcast_to(shape)
        if x.stride(-1) != 1 or x.stride(-2) != nx:
            x = x.contiguous()
        return x

    hice = fit(has_ice, (ncat, ny, nx), torch.bool)
    planes = [fit(fields[k], (ncat, ny, nx)) for k in _TC_IN_PLANES]
    layers = [fit(fields[k], (ncat, nl[_TC_LAYERS[k]], ny, nx))
              for k in _TC_IN_LAYERS]

    def empty(*shape, dt_=dtype):
        return torch.empty(shape, dtype=dt_, device=device)

    out_planes = [empty(ncat, ny, nx) for _ in _TC_OUT_PLANES]
    converged = empty(ncat, ny, nx, dt_=torch.bool)
    why = empty(ncat, ny, nx, dt_=torch.int32)
    niter = empty(ncat, ny, nx, dt_=torch.int32)
    out_layers = [empty(ncat, nl[_TC_LAYERS[k]], ny, nx)
                  for k in _TC_OUT_LAYERS]

    ptrs = [hice.data_ptr()] + [x.data_ptr() for x in planes + layers] \
        + [x.data_ptr() for x in out_planes] \
        + [converged.data_ptr(), why.data_ptr(), niter.data_ptr()] \
        + [x.data_ptr() for x in out_layers]
    strides = [hice.stride(0)] + [x.stride(0) for x in planes] \
        + [s for x in layers for s in (x.stride(0), x.stride(1))]
    params = [float(dt), float(p.l_brine), float(p.conduct == "bubbly"),
              float(p.nilyr), float(p.nslyr),
              *p.salin[:p.nilyr], *p.tmlt[:p.nilyr]]
    ptr_arr = (ctypes.c_int64 * len(ptrs))(*ptrs)
    stride_arr = (ctypes.c_int64 * len(strides))(*strides)
    par_arr = (ctypes.c_double * len(params))(*params)

    fn = _therm_newton_fn(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.addressof(ptr_arr), ctypes.addressof(stride_arr),
                ncat, ny, nx, ctypes.addressof(par_arr), stream)
    if rc != 0:
        raise RuntimeError(f"therm_newton launch failed: cudaError {rc}")
    temperature_changes.launches += 1

    def shaped(x):
        return x if lead else x[0]

    res = {k: shaped(x) for k, x in zip(_TC_OUT_PLANES, out_planes)}
    res.update({k: shaped(x) for k, x in zip(_TC_OUT_LAYERS, out_layers)})
    res["converged"] = shaped(converged)
    res["why"] = shaped(why)
    res["niter_cells"] = shaped(niter)
    res["niter"] = niter.amax()
    return res


def temperature_changes(p: ThermoParams, dt, has_ice,
                        rhoa, flw, potT, Qa, shcoef, lhcoef,
                        fswsfc, fswint, fswthrun, Sswabs, Iswabs,
                        hilyr, hslyr, qin, Tin, qsn, Tsn, Tsf, Tbot,
                        einit):
    """Newton-iterated implicit temperature solve
    (``temperature_changes:1288-2148``).

    On CUDA tensors this launches the therm_newton kernel (or raises);
    on CPU tensors it runs the plain version
    :func:`_temperature_changes_core`.  `temperature_changes.launches`
    counts the kernel launches.
    """
    args = (rhoa, flw, potT, Qa, shcoef, lhcoef, fswsfc, fswint, fswthrun,
            Sswabs, Iswabs, hilyr, hslyr, qin, Tin, qsn, Tsn, Tsf, Tbot,
            einit)
    if Tsf.device.type == "cuda":
        return _temperature_changes_cuda(p, dt, has_ice, *args)
    if Tsf.device.type == "cpu":
        return _temperature_changes_core(p, dt, has_ice, *args)
    raise NotImplementedError(
        f"temperature_changes has no path for device {Tsf.device}")


temperature_changes.launches = 0


# ---------------------------------------------------------------------------
# Thickness changes and the per-category driver
# ---------------------------------------------------------------------------


def thickness_changes(p: ThermoParams, dt, has_ice, hilyr, hslyr,
                      qin, qsn, fbot, Tbot, flatn, fsurfn, fcondtopn,
                      fcondbot, fsnow):
    """Growth/melt at surfaces + snowfall + snow-ice + layer regridding
    (``thickness_changes:3622-4224``, ``freeboard:4244-4377``,
    ``adjust_enthalpy:4396-4492``).

    Returns dict with new hin/hsn/hilyr/hslyr/qin/qsn, fluxes and melt
    diagnostics (all per-unit-ice-area; caller multiplies by aicen).
    """
    nilyr, nslyr = p.nilyr, p.nslyr
    tmlt_bot = p.tmlt[nilyr]
    qbotmax = -0.5 * cn.rhoi * cn.Lfresh

    dzi = [hilyr] * nilyr
    dzs = [hslyr] * nslyr
    qi = [_lay(qin, k) for k in range(nilyr)]
    qs = [_lay(qsn, k) for k in range(nslyr)]
    hin = hilyr * nilyr
    hsn = hslyr * nslyr

    if not p.l_brine:
        for k in range(nslyr):
            Ts = (cn.Lfresh + qs[k] / cn.rhos) / cn.cp_ice
            dzs[k] = dzs[k] - torch.where(
                Ts > 0.0, cn.cp_ice * Ts * dzs[k] / cn.Lfresh, 0.0)
            qs[k] = torch.where(Ts > 0.0, -cn.rhos * cn.Lfresh, qs[k])
        for k in range(nilyr):
            Ti = (cn.Lfresh + qi[k] / cn.rhoi) / cn.cp_ice
            dzi[k] = dzi[k] - torch.where(
                Ti > 0.0, cn.cp_ice * Ti * dzi[k] / cn.Lfresh, 0.0)
            qi[k] = torch.where(Ti > 0.0, -cn.rhoi * cn.Lfresh, qi[k])

    wk1 = -flatn * dt
    esub = torch.clamp(wk1, min=0.0)
    econ = torch.clamp(wk1, max=0.0)
    etop_mlt = torch.clamp((fsurfn - fcondtopn) * dt, min=0.0)
    wk1 = (fcondbot - fbot) * dt
    ebot_mlt = torch.clamp(wk1, min=0.0)
    ebot_gro = torch.clamp(wk1, max=0.0)

    evapn = torch.zeros_like(hin)

    # condensation into top snow or ice layer
    snow_present = hsn > cn.puny
    dhs_c = torch.where(snow_present, econ / (qs[0] - cn.rhos * cn.Lvap), 0.0)
    dzs[0] = dzs[0] + dhs_c
    evapn = evapn + dhs_c * cn.rhos
    dhi_c = torch.where(snow_present, 0.0, econ / (qi[0] - cn.rhoi * cn.Lvap))
    dzi[0] = dzi[0] + dhi_c
    evapn = evapn + dhi_c * cn.rhoi

    # bottom growth
    if p.heat_capacity:
        if p.l_brine:
            tbot_safe = torch.clamp(Tbot, max=-cn.puny)
            qbot = -cn.rhoi * (cn.cp_ice * (tmlt_bot - tbot_safe)
                               + cn.Lfresh * (1.0 - tmlt_bot / tbot_safe)
                               - cn.cp_ocn * tmlt_bot)
            qbot = torch.clamp(qbot, max=qbotmax)
        else:
            qbot = -cn.rhoi * (cn.cp_ice * Tbot + cn.Lfresh)
    else:
        qbot = torch.full_like(Tbot, -cn.rhoi * cn.Lfresh)
    dhi_g = ebot_gro / qbot  # >= 0
    hqtot = dzi[nilyr - 1] * qi[nilyr - 1] + dhi_g * qbot
    dzb = dzi[nilyr - 1] + dhi_g
    qi[nilyr - 1] = torch.where(dzb > cn.puny,
                                hqtot / torch.clamp(dzb, min=cn.puny),
                                qi[nilyr - 1])
    dzi[nilyr - 1] = dzb
    congel = dhi_g

    # snow sublimation + top melt (top down)
    melts = torch.zeros_like(hin)
    meltt = torch.zeros_like(hin)
    meltb = torch.zeros_like(hin)
    for k in range(nslyr):
        qsub = qs[k] - cn.rhos * cn.Lvap
        dhs = torch.maximum(-dzs[k], esub / qsub)
        dzs[k] = dzs[k] + dhs
        esub = torch.clamp(esub - dhs * qsub, min=0.0)
        evapn = evapn + dhs * cn.rhos
        dhs = torch.maximum(-dzs[k], etop_mlt / qs[k])
        dzs[k] = dzs[k] + dhs
        etop_mlt = torch.clamp(etop_mlt - dhs * qs[k], min=0.0)
        melts = melts - dhs
    for k in range(nilyr):
        qsub = qi[k] - cn.rhoi * cn.Lvap
        dhi = torch.maximum(-dzi[k], esub / qsub)
        dzi[k] = dzi[k] + dhi
        esub = torch.clamp(esub - dhi * qsub, min=0.0)
        evapn = evapn + dhi * cn.rhoi
        dhi = torch.maximum(-dzi[k], etop_mlt / qi[k])
        dzi[k] = dzi[k] + dhi
        etop_mlt = torch.clamp(etop_mlt - dhi * qi[k], min=0.0)
        meltt = meltt - dhi
    # bottom melt (bottom up)
    for k in range(nilyr - 1, -1, -1):
        dhi = torch.maximum(-dzi[k], ebot_mlt / qi[k])
        dzi[k] = dzi[k] + dhi
        ebot_mlt = torch.clamp(ebot_mlt - dhi * qi[k], min=0.0)
        meltb = meltb - dhi
    for k in range(nslyr - 1, -1, -1):
        dhs = torch.maximum(-dzs[k], ebot_mlt / qs[k])
        dzs[k] = dzs[k] + dhs
        ebot_mlt = torch.clamp(ebot_mlt - dhs * qs[k], min=0.0)

    fhocnn = fbot + (esub + etop_mlt + ebot_mlt) / dt

    # new snowfall
    hsn_new = torch.where(fsnow > 0.0, fsnow / cn.rhos * dt, 0.0)
    qsnew = -cn.rhos * cn.Lfresh
    hstot = dzs[0] + hsn_new
    qs[0] = torch.where(hstot > 0.0,
                        torch.clamp((dzs[0] * qs[0] + hsn_new * qsnew)
                                    / torch.clamp(hstot, min=cn.puny),
                                    max=-cn.rhos * cn.Lfresh),
                        qs[0])
    dzs[0] = torch.where(hstot > 0.0, hstot, dzs[0])

    hin = sum(dzi)
    hsn = sum(dzs)

    # freeboard: snow-ice conversion
    wk1 = hsn - hin * (cn.rhow - cn.rhoi) / cn.rhos
    below = (wk1 > cn.puny) & (hsn > cn.puny)
    dhsn_tot = torch.where(below, torch.minimum(wk1 * cn.rhoi / cn.rhow, hsn),
                           0.0)
    dhin = dhsn_tot * cn.rhos / cn.rhoi
    dhsn = dhsn_tot
    hqs = torch.zeros_like(hin)
    for k in range(nslyr - 1, -1, -1):
        dhs = torch.where(dhin > cn.puny, torch.minimum(dhsn, dzs[k]), 0.0)
        hsn = hsn - dhs
        dzs[k] = dzs[k] - dhs
        dhsn = torch.clamp(dhsn - dhs, min=0.0)
        hqs = hqs + dhs * qs[k]
    active_fb = dhin > cn.puny
    wk2 = dzi[0] + dhin
    hin = torch.where(active_fb, hin + dhin, hin)
    qi[0] = torch.where(active_fb,
                        (dzi[0] * qi[0] + hqs) / torch.clamp(wk2, min=cn.puny),
                        qi[0])
    dzi[0] = torch.where(active_fb, wk2, dzi[0])
    snoice = torch.where(active_fb, dhin, 0.0)

    # repartition into equal layers, conserving energy
    hin = torch.clamp(hin, min=0.0)
    hsn = torch.clamp(hsn, min=0.0)
    hilyr_new = hin / nilyr
    hslyr_new = hsn / nslyr

    if p.heat_capacity:
        qin = _adjust_enthalpy(_stack(dzi), hilyr_new, hin, _stack(qi))
        qsn = _adjust_enthalpy(_stack(dzs), hslyr_new, hsn, _stack(qs)) \
            if nslyr > 1 else _stack(qs)
    else:
        qin = torch.full_like(_stack(qi), -cn.rhoi * cn.Lfresh)
        qsn = torch.full_like(_stack(qs), -cn.rhos * cn.Lfresh)

    efinal = -evapn * cn.Lvap \
        + (hslyr_new.unsqueeze(-3) * qsn).sum(-3) \
        + (hilyr_new.unsqueeze(-3) * qin).sum(-3)
    evapn = evapn / dt

    return dict(hin=hin, hsn=hsn, hilyr=hilyr_new, hslyr=hslyr_new,
                qin=qin, qsn=qsn, fhocnn=fhocnn, evapn=evapn,
                efinal=efinal, hsn_new=hsn_new,
                meltt=meltt, melts=melts, meltb=meltb,
                congel=congel, snoice=snoice)


def _adjust_enthalpy(dz, hlyr_new, hn, qn):
    """Conservative remap of layer enthalpy onto equal layers
    (``adjust_enthalpy:4396-4492``); layer axis third from last."""
    nlyr = dz.shape[-3]
    z1 = torch.cat([torch.zeros_like(dz[..., :1, :, :]),
                    torch.cumsum(dz, dim=-3)], dim=-3)
    k = torch.arange(nlyr + 1, dtype=dz.dtype,
                     device=dz.device).reshape(nlyr + 1, 1, 1)
    z2 = k * hlyr_new.unsqueeze(-3)
    rhlyr = torch.where(hn > cn.puny,
                        1.0 / torch.clamp(hlyr_new, min=cn.puny), 0.0)
    # overlap(k2, k1) = max(0, min(z1[k1+1], z2[k2+1]) - max(z1[k1], z2[k2]))
    lo = torch.maximum(z1[..., None, :-1, :, :], z2[..., :-1, None, :, :])
    hi = torch.minimum(z1[..., None, 1:, :, :], z2[..., 1:, None, :, :])
    ovl = torch.clamp(hi - lo, min=0.0)
    hq = (ovl * qn[..., None, :, :, :]).sum(-3)
    return hq * rhlyr.unsqueeze(-3)


def thermo_vertical_category(p: ThermoParams, dt, aicen, vicen, vsnon,
                             tsfcn, eicen, esnon,
                             flw, potT, Qa, rhoa, fsnow,
                             fbot, Tbot, Tf, lhcoef, shcoef,
                             fswsfc, fswint, fswthrun, Sswabs, Iswabs):
    """Full vertical thermo driver (``thermo_vertical:108-515``) for one
    category plane or for all categories at once (leading ``ncat``
    axis on the category fields; forcing planes broadcast).

    Returns (new category state dict, flux/diagnostic dict).  All
    fluxes are per unit ice area; the caller applies aicen weighting.
    """
    if not p.calc_Tsfc:
        raise NotImplementedError(
            "calc_Tsfc=False (prescribed surface fluxes) is not ported yet "
            "(ROADMAP queue 1 item 4)")
    if not p.heat_capacity:
        raise NotImplementedError(
            "heat_capacity=False (zero-layer thermo) is not ported yet "
            "(ROADMAP queue 1 item 4)")
    nilyr, nslyr = p.nilyr, p.nslyr
    has_ice = aicen > cn.a_negligible(aicen.dtype)
    a_safe = torch.clamp(aicen, min=cn.puny)
    tmlt = _profile(p.tmlt, nilyr, aicen)

    # --- init_vertical_profile (":844-1211") ------------------------------
    Tsf = tsfcn
    hin = torch.where(has_ice, vicen / a_safe, 0.0)
    hsn = torch.where(has_ice, vsnon / a_safe, 0.0)
    hilyr = torch.where(has_ice, hin / nilyr, 1.0)  # safe placeholder on land
    hslyr = hsn / nslyr

    v_safe = torch.clamp(vsnon, min=cn.puny)
    snow_ok = (hslyr > hs_min / nslyr) & has_ice
    qsn = torch.where(snow_ok.unsqueeze(-3),
                      esnon * nslyr / v_safe.unsqueeze(-3),
                      -cn.rhos * cn.Lfresh)
    Tsn = (cn.Lfresh + qsn / cn.rhos) / cn.cp_ice
    Tsn = torch.clamp(Tsn, max=0.0)
    qsn = torch.where(Tsn >= 0.0, -cn.rhos * cn.Lfresh, qsn)

    vi_safe = torch.clamp(vicen, min=cn.puny)
    qin = torch.where(has_ice.unsqueeze(-3),
                      eicen * nilyr / vi_safe.unsqueeze(-3),
                      -cn.rhoi * cn.Lfresh)
    Tin = tin_from_qin(p, qin, tmlt)
    fix = Tin > 0.0
    Tin = torch.where(fix, 0.0, Tin)
    qin = torch.where(fix, -cn.rhoi * cn.Lfresh, qin)

    einit = (hslyr.unsqueeze(-3) * qsn).sum(-3) \
        + (hilyr.unsqueeze(-3) * qin).sum(-3)
    hin0, hsn0 = hin, hsn

    # --- temperature solve -------------------------------------------------
    tc = temperature_changes(p, dt, has_ice, rhoa, flw, potT, Qa,
                             shcoef, lhcoef, fswsfc, fswint, fswthrun,
                             Sswabs, Iswabs, hilyr, hslyr, qin, Tin,
                             qsn, Tsn, Tsf, Tbot, einit)

    # --- thickness changes -------------------------------------------------
    th = thickness_changes(p, dt, has_ice, hilyr, hslyr,
                           tc["qin"], tc["qsn"], fbot, Tbot,
                           tc["flatn"], tc["fsurfn"], tc["fcondtopn"],
                           tc["fcondbot"], fsnow)
    # Tmlt-clamp energy removed by the temperature solve goes to the
    # ocean (keeps the column budget exact; see temperature_changes)
    th["fhocnn"] = th["fhocnn"] + tc["dq_flux"]

    # --- water/salt fluxes (":466-480") ------------------------------------
    dhi = th["hin"] - hin0
    dhs = th["hsn"] - hsn0
    freshn = tc["flatn"] * 0.0 + th["evapn"] \
        - (cn.rhoi * dhi + cn.rhos * (dhs - th["hsn_new"])) / dt
    fsaltn = -cn.rhoi * dhi * cn.ice_ref_salinity * 0.001 / dt

    # --- update_state_vthermo (":4634-4747") -------------------------------
    alive = has_ice & (th["hin"] > 0.0)
    alive3 = alive.unsqueeze(-3)
    has3 = has_ice.unsqueeze(-3)
    aicen_new = torch.where(alive, aicen, 0.0)
    vicen_new = torch.where(alive, aicen * th["hin"], 0.0)
    vsnon_new = torch.where(alive, aicen * th["hsn"], 0.0)
    tsfcn_new = torch.where(alive, tc["Tsf"], Tf)
    tsfcn_new = torch.where(has_ice, tsfcn_new, tsfcn)
    eicen_new = torch.where(alive3,
                            th["qin"] * vicen_new.unsqueeze(-3) / nilyr, 0.0)
    esnon_new = torch.where(alive3,
                            th["qsn"] * vsnon_new.unsqueeze(-3) / nslyr, 0.0)
    # untouched cells keep original state
    aicen_new = torch.where(has_ice, aicen_new, aicen)
    vicen_new = torch.where(has_ice, vicen_new, vicen)
    vsnon_new = torch.where(has_ice, vsnon_new, vsnon)
    eicen_new = torch.where(has3, eicen_new, eicen)
    esnon_new = torch.where(has3, esnon_new, esnon)

    def m(x):
        return torch.where(has_ice, x, 0.0)

    state_out = dict(aicen=aicen_new, vicen=vicen_new, vsnon=vsnon_new,
                     tsfcn=tsfcn_new, eicen=eicen_new, esnon=esnon_new)
    flux_out = dict(
        fsensn=m(tc["fsensn"]), flatn=m(tc["flatn"]),
        fswabsn=m(tc["fswabsn"]), flwoutn=m(tc["flwoutn"]),
        evapn=m(th["evapn"]), freshn=m(freshn), fsaltn=m(fsaltn),
        fhocnn=m(th["fhocnn"]), fsurfn=m(tc["fsurfn"]),
        fcondtopn=m(tc["fcondtopn"]),
        # the SW the solve actually absorbed in the interior (adjusted)
        fswint=m(tc["fswint"]),
        meltt=m(th["meltt"]), melts=m(th["melts"]), meltb=m(th["meltb"]),
        congel=m(th["congel"]), snoice=m(th["snoice"]),
        einit=m(einit), efinal=m(th["efinal"]),
        niter=tc["niter"],
    )
    return state_out, flux_out
