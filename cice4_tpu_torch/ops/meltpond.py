"""Explicit melt-pond volume tracer (``source/ice_meltpond.F90``).

Port of :mod:`cice4_tpu.ops.meltpond` (`compute_ponds:88-230`): pond
volume grows from surface melt + rain runoff, contracts exponentially
under freezing conditions, and sets the pond area/depth geometry
consumed by the delta-Eddington albedo.  Elementwise over any leading
axes.
"""

from __future__ import annotations

import torch

from cice4_tpu_torch import constants as cn

hicemin = 0.1     # minimum ice thickness with ponds (m)
Td = 2.0          # freeze-up temperature difference (C)
rfrac = 0.1       # runoff fraction captured by ponds
rexp = 0.01       # pond contraction scaling
dpthhi = 0.9      # max pond depth / ice thickness
dpthfrac = 0.8    # pond depth / pond fraction ratio


def pond_geometry(volpn):
    """Pond fraction and depth of a pond volume per unit ice area, as the
    radiation reads them (``cice4_tpu/model.py:69-75``)."""
    apond = torch.clamp(torch.sqrt(torch.clamp(volpn, min=0.0) / dpthfrac),
                        max=1.0)
    return apond, dpthfrac * apond


def compute_ponds(dt, meltt, melts, frain, aicen, vicen, vsnon,
                  tsfcn, volpn):
    """Per-category pond update.  meltt/melts: melt this step (m, per
    unit ice area).  Returns (volpn, apondn, hpondn)."""
    has = aicen > cn.puny
    a_s = torch.clamp(aicen, min=cn.puny)
    hi = torch.where(has, vicen / a_s, 0.0)
    hs = torch.where(has, vsnon / a_s, 0.0)

    vol = volpn + rfrac * (meltt * cn.rhoi / cn.rhofresh
                           + melts * cn.rhos / cn.rhofresh
                           + frain * dt / cn.rhofresh)
    Tp = cn.Timelt - Td
    dTs = torch.clamp(Tp - tsfcn, min=0.0)
    vol = torch.clamp(vol * torch.exp(rexp * dTs / Tp), min=0.0)

    apondn, hpondn = pond_geometry(vol)
    hpondn = torch.minimum(hpondn, dpthhi * hi)
    vol = hpondn * apondn
    apondn = torch.where(hs > cn.puny, 0.0, apondn)

    thin = has & (hi < hicemin)
    gone = thin | ~has
    vol = torch.where(gone, 0.0, vol)
    apondn = torch.where(gone, 0.0, apondn)
    hpondn = torch.where(gone, 0.0, hpondn)
    volpn_new = torch.where(has, vol, volpn)
    return volpn_new, apondn, hpondn
