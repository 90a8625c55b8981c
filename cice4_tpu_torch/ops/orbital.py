"""Solar geometry: declination and zenith angle.

Port of :mod:`cice4_tpu.ops.orbital` (``source/ice_orbital.F90`` +
``csm_share/shr_orb_mod.F90``) with the fixed modern orbital
parameters.  The declination depends on the calendar day only, so it is
computed on the host in double precision.
"""

from __future__ import annotations

import math

import torch

from cice4_tpu_torch import constants as cn

# modern (year ~2000) orbital parameters
eccen = 0.0167022
obliq_deg = 23.4392861
mvelp_deg = 102.9334796  # moving vernal equinox longitude of perihelion

obliqr = math.radians(obliq_deg)
_mvelp = math.radians(mvelp_deg)
mvelpp = _mvelp + math.pi  # longitude of perihelion + pi (from shr_orb)

# mean longitude at vernal equinox (shr_orb_params lambm0 expansion)
_beta = math.sqrt(1.0 - eccen**2)
lambm0 = 2.0 * ((eccen / 2.0 + eccen**3 / 8.0) * (1.0 + _beta)
                * math.sin(mvelpp)
                - (eccen**2 / 4.0) * (0.5 + _beta) * math.sin(2.0 * mvelpp)
                + (eccen**3 / 8.0) * (1.0 / 3.0 + _beta)
                * math.sin(3.0 * mvelpp))

ve_day = 80.5  # calendar day of the vernal equinox (March 21, 0Z)


def orb_decl(calday: float):
    """Solar declination (rad) and earth-sun distance factor for a
    calendar day (``shr_orb_mod.F90 shr_orb_decl``)."""
    lambm = lambm0 + (calday - ve_day) * 2.0 * math.pi / 365.0
    lmm = lambm - mvelpp
    sinl = math.sin(lmm)
    lamb = lambm + eccen * (2.0 * sinl
                            + eccen * (1.25 * math.sin(2.0 * lmm)
                                       + eccen * (13.0 / 12.0)
                                       * (3.0 * math.sin(3.0 * lmm) - sinl)))
    invrho = (1.0 + eccen * math.cos(lamb - mvelpp)) / (1.0 - eccen**2)
    delta = math.asin(math.sin(obliqr) * math.sin(lamb))
    eccf = invrho * invrho
    return delta, eccf


def compute_coszen(tlat, tlon, yday: float, sec: float, dt=0.0):
    """Cosine of the solar zenith angle
    (``ice_orbital.F90 compute_coszen:95-166``)."""
    ydayp1 = yday + sec / cn.secday
    delta, _eccf = orb_decl(ydayp1)
    coszen = (torch.sin(tlat) * math.sin(delta)
              - torch.cos(tlat) * math.cos(delta)
              * torch.cos(ydayp1 * 2.0 * math.pi + tlon))
    return coszen
