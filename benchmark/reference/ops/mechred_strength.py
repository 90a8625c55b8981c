"""Ice strength and the ridging ITD functions it shares with ridging.

Port of :mod:`cice4_tpu.ops.mechred_strength`: `ridge_itd`
(participation + ridged-ice ITD, ``source/ice_mechred.F90:773-1081``)
for both participation (`krdg_partic` 0/1) and redistribution
(`krdg_redist` 0/1) options, and `ice_strength` (``:1869-2036``) for
both the Hibler (1979) (`kstrength=0`) and Rothrock (1975)
(`kstrength=1`) formulations.
"""

from __future__ import annotations

import math

import torch

from reference import constants as cn
from reference.config import DynamicsConfig

# fixed ridging parameters (ice_mechred.F90:83-101)
Cs = 0.25        # fraction of shear energy contributing to ridging
fsnowrdg = 0.5   # snow fraction that survives ridging
Gstar = 0.15     # max G(h) participating (krdg_partic = 0)
astar = 0.05     # e-folding of G(h) participation (krdg_partic = 1)
maxraft = 1.0    # max thickness of rafting ice (m)
Hstar = 25.0     # mean ridge thickness parameter (krdg_redist = 0)


def ridge_itd_full(dyn: DynamicsConfig, aicen, vicen, aice0):
    """`ridge_itd` (``ice_mechred.F90:773-1081``).

    Returns dict with:
      apartic0: (ny, nx) open-water participation
      apartic: (ncat, ny, nx)
      hrmin, hrmax, hrexp, krdg: (ncat, ny, nx)
      aksum: (ny, nx) net area removed / area participating
    """
    # cumulative normalized thickness distribution G
    contrib0 = torch.where(aice0 > cn.puny, aice0, 0.0)
    contribn = torch.where(aicen > cn.puny, aicen, 0.0)
    gsum0 = contrib0
    gsum = gsum0[None] + torch.cumsum(contribn, dim=0)  # (ncat, ny, nx)
    total = gsum[-1]
    norm = 1.0 / torch.clamp(total, min=cn.puny)
    G0 = gsum0 * norm          # G after open water
    Gn = gsum * norm           # G after category n
    Gm1 = torch.cat([G0[None], Gn[:-1]], dim=0)  # G at cat n-1

    if dyn.krdg_partic == 0:
        # Thorndike et al. 1975: b(h) = (2/G*) (1 - G/G*), integrated
        Gstari = 1.0 / Gstar

        def partic(glo, ghi):
            full = Gstari * (ghi - glo) * (2.0 - (glo + ghi) * Gstari)
            part = Gstari * (Gstar - glo) * (2.0 - (glo + Gstar) * Gstari)
            return torch.where(ghi < Gstar, full,
                               torch.where(glo < Gstar, part, 0.0))

        apartic0 = partic(torch.zeros_like(G0), G0)
        apartic = partic(Gm1, Gn)
    else:
        # exponential b(h) = exp(-G/astar) (ice_mechred.F90:944-975)
        astari = 1.0 / astar
        xtmp = 1.0 / (1.0 - math.exp(-astari))

        def expg(g):
            return torch.exp(-g * astari) * xtmp

        apartic0 = expg(torch.zeros_like(G0)) - expg(G0)
        apartic = expg(Gm1) - expg(Gn)

    # ridged-ice ITD descriptors
    has = aicen > cn.puny
    hi = torch.where(has, vicen / torch.clamp(aicen, min=cn.puny), 0.0)
    hi = torch.clamp(hi, min=cn.puny)
    hrmin = torch.where(has, torch.minimum(2.0 * hi, hi + maxraft), 0.0)
    if dyn.krdg_redist == 0:
        hrmax = torch.where(has, torch.maximum(2.0 * torch.sqrt(Hstar * hi),
                                               hrmin + cn.puny), 0.0)
        hrmean = 0.5 * (hrmin + hrmax)
        krdg = torch.where(has, hrmean / hi, 1.0)
        hrexp = torch.zeros_like(hrmin)
    else:
        hrexp = torch.where(has, dyn.mu_rdg * torch.sqrt(hi), 0.0)
        krdg = torch.where(has, (hrmin + hrexp) / hi, 1.0)
        hrmax = torch.zeros_like(hrmin)

    aksum = apartic0 + (apartic * (1.0 - 1.0 / krdg)).sum(0)
    return dict(apartic0=apartic0, apartic=apartic, hrmin=hrmin,
                hrmax=hrmax, hrexp=hrexp, krdg=krdg, aksum=aksum, hi=hi)


def ice_strength(dyn: DynamicsConfig, aice, vice, aice0, aicen, vicen,
                 icetmask):
    """Ice strength P (N/m) (``ice_mechred.F90 ice_strength:1869-2036``)."""
    if dyn.kstrength == 1:  # Rothrock 1975 potential-energy strength
        r = ridge_itd_full(dyn, aicen, vicen, aice0)
        apartic, krdg = r["apartic"], r["krdg"]
        hi = r["hi"]
        active = (aicen > cn.puny) & (apartic > 0.0)
        if dyn.krdg_redist == 0:
            hrmin, hrmax = r["hrmin"], r["hrmax"]
            h2rdg = (1.0 / 3.0) * (hrmax**3 - hrmin**3) \
                / torch.clamp(hrmax - hrmin, min=cn.puny)
        else:
            hrmin, hrexp = r["hrmin"], r["hrexp"]
            h2rdg = hrmin * hrmin + 2.0 * hrmin * hrexp + 2.0 * hrexp * hrexp
        dh2rdg = -hi * hi + h2rdg / krdg
        strength = torch.where(active, apartic * dh2rdg, 0.0).sum(0)
        strength = dyn.Cf * dyn.Cp * strength \
            / torch.clamp(r["aksum"], min=cn.puny)
    else:  # Hibler 1979
        strength = dyn.Pstar * vice * torch.exp(-dyn.Cstar * (1.0 - aice))
    return torch.where(icetmask, strength, 0.0)
