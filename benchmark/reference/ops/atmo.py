"""Atmospheric surface boundary layer over ice and ocean.

Port of :mod:`cice4_tpu.ops.atmo` (``source/ice_atmo.F90``):
Monin-Obukhov stability iteration (`atmo_boundary_layer:56-376`, fixed 5
iterations) and the constant-coefficient variant
(`atmo_boundary_const:386-509`, ``atmbndy='constant'``).  Elementwise
over any leading axes.
"""

from __future__ import annotations

import math

import torch

from reference import constants as cn

cpvir = cn.cp_wv / cn.cp_air - 1.0
zTrf = 2.0    # reference height for Tref/Qref (m)
umin = 1.0    # minimum wind speed (m/s)


def _psimhu(x):
    return (torch.log((1.0 + x * (2.0 + x)) * (1.0 + x * x) / 8.0)
            - 2.0 * torch.atan(x) + cn.pih)


def _psixhu(x):
    return 2.0 * torch.log((1.0 + x * x) / 2.0)


def atmo_boundary_layer(sfctype, Tsf, potT, uatm, vatm, wind, zlvl,
                        Qa, rhoa, calc_strair=True):
    """Monin-Obukhov turbulent transfer coefficients + wind stress +
    2 m reference diagnostics.

    Args:
      sfctype: 'ice' or 'ocn'.
      Tsf: surface temperature (C).
    Returns dict(strx, stry, Tref, Qref, delt, delq, shcoef, lhcoef).
    """
    vmag = torch.clamp(wind, min=umin)
    if sfctype == "ice":
        qqq, TTT, Lheat = cn.qqqice, cn.TTTice, cn.Lsub
        rdn = torch.full_like(wind, cn.vonkar / math.log(cn.zref / cn.iceruf))
    else:
        qqq, TTT, Lheat = cn.qqqocn, cn.TTTocn, cn.Lvap
        rdn = torch.sqrt(0.0027 / vmag + 0.000142 + 0.0000764 * vmag)

    TsfK = Tsf + cn.Tffresh
    qsat = qqq * torch.exp(-TTT / TsfK)
    ssq = qsat / rhoa
    thva = potT * (1.0 + cn.zvir * Qa)
    delt = potT - TsfK
    delq = Qa - ssq
    alz = torch.log(zlvl / cn.zref)
    cp = cn.cp_air * (1.0 + cpvir * ssq)

    rhn = rdn
    ren = rdn
    ustar = rdn * vmag
    tstar = rhn * delt
    qstar = ren * delq

    rd = rdn
    rh = rhn
    re = ren
    stable = torch.zeros_like(wind)
    psixh = torch.zeros_like(wind)
    hol = torch.zeros_like(wind)

    for _ in range(5):  # fixed MO iteration (ice_atmo.F90:271-307)
        hol = cn.vonkar * cn.gravit * zlvl \
            * (tstar / thva + qstar / (1.0 / cn.zvir + Qa)) / ustar**2
        hol = torch.sign(hol) * torch.clamp(torch.abs(hol), max=10.0)
        stable = 0.5 + torch.sign(hol) * 0.5
        xqq = torch.clamp(torch.sqrt(torch.abs(1.0 - 16.0 * hol)), min=1.0)
        xqq = torch.sqrt(xqq)
        psimhs = -(0.7 * hol + 0.75 * (hol - 14.3)
                   * torch.exp(-0.35 * hol) + 10.7)
        psimh = psimhs * stable + (1.0 - stable) * _psimhu(xqq)
        psixh = psimhs * stable + (1.0 - stable) * _psixhu(xqq)
        rd = rdn / (1.0 + rdn / cn.vonkar * (alz - psimh))
        rh = rhn / (1.0 + rhn / cn.vonkar * (alz - psixh))
        re = ren / (1.0 + ren / cn.vonkar * (alz - psixh))
        ustar = rd * vmag
        tstar = rh * delt
        qstar = re * delq

    if calc_strair:
        tau = rhoa * ustar * rd
        strx = tau * uatm
        stry = tau * vatm
    else:
        strx = torch.zeros_like(wind)
        stry = torch.zeros_like(wind)

    shcoef = rhoa * ustar * cp * rh + 1.0  # windless term, Jordan et al 1999
    lhcoef = rhoa * ustar * Lheat * re

    # 2 m reference diagnostics
    al2 = math.log(cn.zref / zTrf)
    hol2 = hol * zTrf / zlvl
    xqq = torch.clamp(torch.sqrt(torch.abs(1.0 - 16.0 * hol2)), min=1.0)
    xqq = torch.sqrt(xqq)
    psix2 = -5.0 * hol2 * stable + (1.0 - stable) * _psixhu(xqq)
    fac = (rh / cn.vonkar) * (alz + al2 - psixh + psix2)
    Tref = potT - delt * fac - 0.01 * zTrf
    fac = (re / cn.vonkar) * (alz + al2 - psixh + psix2)
    Qref = Qa - delq * fac

    return dict(strx=strx, stry=stry, Tref=Tref, Qref=Qref,
                delt=delt, delq=delq, shcoef=shcoef, lhcoef=lhcoef)


def atmo_boundary_const(sfctype, uatm, vatm, wind, rhoa,
                        calc_strair=True):
    """Constant-coefficient boundary layer (``atmo_boundary_const``)."""
    Lheat = cn.Lsub if sfctype == "ice" else cn.Lvap
    if calc_strair:
        tau = rhoa * 0.0012 * wind
        strx = tau * uatm
        stry = tau * vatm
    else:
        strx = torch.zeros_like(wind)
        stry = torch.zeros_like(wind)
    shcoef = 1.20e-3 * cn.cp_air * rhoa * wind
    lhcoef = 1.50e-3 * Lheat * rhoa * wind
    zero = torch.zeros_like(wind)
    return dict(strx=strx, stry=stry, shcoef=shcoef, lhcoef=lhcoef,
                Tref=zero, Qref=zero, delt=zero, delq=zero)
