"""Slab ocean mixed layer (``source/ice_ocean.F90 ocean_mixed_layer:64-234``).

Port of :mod:`cice4_tpu.ops.ocean`: evolves SST from surface fluxes over
open water plus the heat the ice hands to the ocean, applies the deep
heat flux qdp, and computes the freezing/melting potential `frzmlt`
(capped at +-1000 W/m^2).
"""

from __future__ import annotations

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.ops.atmo import atmo_boundary_layer

frzmlt_max = 1000.0
cprho = cn.cp_ocn * cn.rhow


def ocean_mixed_layer(dt, tmask, aice, sst, Tf, qdp, hmix,
                      uatm, vatm, wind, zlvl, potT, Qa, rhoa, flw,
                      swvdr, swvdf, swidr, swidf, fhocn, fswthru,
                      atmbndy="default"):
    """One mixed-layer update.  Returns dict(sst, frzmlt, qdp, and the
    open-ocean fluxes for history)."""
    if atmbndy == "constant":
        raise NotImplementedError(
            "atmbndy='constant' is not ported yet (ROADMAP queue 1 item 4)")
    bl = atmo_boundary_layer("ocn", sst, potT, uatm, vatm, wind,
                             zlvl, Qa, rhoa)
    delt, delq = bl["delt"], bl["delq"]

    swabs = ((1.0 - cn.albocn) * (swvdr + swidr + swvdf + swidf))
    TsfK = sst + cn.Tffresh
    flwout_ocn = -cn.stefan_boltzmann * TsfK**4
    fsens_ocn = bl["shcoef"] * delt
    flat_ocn = bl["lhcoef"] * delq
    evap_ocn = -flat_ocn / cn.Lvap

    hmix_safe = torch.clamp(hmix, min=cn.puny)
    sst_new = sst + dt * (
        (fsens_ocn + flat_ocn + flwout_ocn + flw + swabs) * (1.0 - aice)
        + fhocn + fswthru) / (cprho * hmix_safe)

    qdp = torch.where((sst_new <= Tf) & (qdp > 0.0), 0.0, qdp)
    sst_new = sst_new - qdp * dt / (cprho * hmix_safe)

    frzmlt = (Tf - sst_new) * cprho * hmix_safe / dt
    frzmlt = torch.clamp(frzmlt, -frzmlt_max, frzmlt_max)
    sst_new = torch.maximum(sst_new, Tf)

    sst_new = torch.where(tmask, sst_new, 0.0)
    frzmlt = torch.where(tmask, frzmlt, 0.0)
    return dict(sst=sst_new, frzmlt=frzmlt, qdp=qdp,
                flwout_ocn=torch.where(tmask, flwout_ocn, 0.0),
                fsens_ocn=torch.where(tmask, fsens_ocn, 0.0),
                flat_ocn=torch.where(tmask, flat_ocn, 0.0),
                evap_ocn=torch.where(tmask, evap_ocn, 0.0),
                strairx_ocn=bl["strx"], strairy_ocn=bl["stry"],
                Tref_ocn=bl["Tref"], Qref_ocn=bl["Qref"])
