"""ACCESS-CM coupling adapter (full climate model: UM atmosphere + MOM
ocean via OASIS).

Port of :mod:`cice4_tpu.coupling_cm` (``drivers/access-cm/
cpl_interface.F90`` + ``cpl_forcing_handler.F90 set_sbc_ice:436-519``).
The ACCESS-CM ice runs with ``calc_Tsfc = F``: the UM supplies
per-category top/bottom melt fluxes (tmlt/bmlt) and a latent heat flux,
which map onto the prescribed-flux thermodynamics inputs (`fsurfn_f`,
`fcondtopn_f`, `flatn_f`, ``CICE_RunMod.F90 set_sfcflux:787-920``), plus
an aice-weighted wind stress that the dynamics take as it is
(``calc_strair = F``).

Field sets follow ``cpl_interface.F90:440-590`` (names truncated at 8
chars by OASIS convention); per-category fields are expanded
``tmlt01_i .. tmlt<ncat>_i`` etc.
"""

from __future__ import annotations

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.forcing import Forcing


def a2i_cm_fields(ncat: int = 5) -> tuple[str, ...]:
    """The UM -> ice receive set (``cpl_interface.F90:540-590``): 8 scalar
    fluxes + 2*ncat category melts + 8 more scalars = 26 fields at
    ncat=5."""
    per_cat = [f"tmlt{k:02d}_i" for k in range(1, ncat + 1)] \
        + [f"bmlt{k:02d}_i" for k in range(1, ncat + 1)]
    return tuple(["thflx_i", "pswflx_i", "runoff_i", "wme_i", "rain_i",
                  "snow_i", "evap_i", "lhflx_i"] + per_cat
                 + ["taux_i", "tauy_i", "swflx_i", "lwflx_i", "shflx_i",
                    "press_i", "co2_ai", "wnd_ai"])


def i2a_cm_fields(ncat: int = 5) -> tuple[str, ...]:
    """The ice -> UM send set (``cpl_interface.F90:445-470``)."""
    out = ["isst_ia"]
    out += [f"icecon{k:02d}" for k in range(1, ncat + 1)]
    out += [f"snwthk{k:02d}" for k in range(1, ncat + 1)]
    out += [f"icethk{k:02d}" for k in range(1, ncat + 1)]
    out += ["uvel_ia", "vvel_ia", "co2_i2", "co2fx_i2"]
    return tuple(out)


def from_atm_cm(forcing: Forcing, a2i: dict, aicen) -> Forcing:
    """Map the UM receive set into the model Forcing
    (``set_sbc_ice:436-519``, UM section).

    `aicen` is the current category area (for distributing the GBM latent
    heat flux over categories).
    """
    ncat = aicen.shape[0]
    aice = aicen.sum(0)
    tmlt = torch.stack([a2i[f"tmlt{k:02d}_i"] for k in range(1, ncat + 1)])
    bmlt = torch.stack([a2i[f"bmlt{k:02d}_i"] for k in range(1, ncat + 1)])

    # latent heat: distributed by category area fraction; all into
    # category 1 where there is no ice (conserved via sfcflux_to_ocn)
    lh = a2i["lhflx_i"]
    frac = torch.where(aice > 0.0,
                       aicen / torch.clamp(aice, min=cn.puny), 0.0)
    flatn_f = lh[None] * frac
    cat1 = torch.zeros_like(flatn_f)
    cat1[0] = torch.where(aice > 0.0, 0.0, lh)
    flatn_f = flatn_f + cat1

    snow = torch.clamp(aice * a2i["snow_i"], min=0.0)
    rain = torch.clamp(aice * a2i["rain_i"], min=0.0)
    return forcing.replace(
        strax=a2i["taux_i"] * aice,
        stray=a2i["tauy_i"] * aice,
        fsnow=snow, frain=rain,
        fsurfn_f=tmlt + bmlt, fcondtopn_f=bmlt, flatn_f=flatn_f,
    )


def from_ocn_cm(forcing: Forcing, o2i: dict,
                meltlimit: float | None = None):
    """Map the MOM receive set (``set_sbc_ice`` MOM section).  Returns
    (forcing, state_updates)."""
    frzmlt = o2i["pfmice_i"]
    if meltlimit is not None:
        frzmlt = torch.clamp(frzmlt, min=meltlimit)
    forcing = forcing.replace(
        sss=o2i["sss_i"], uocn=o2i["ssu_i"], vocn=o2i["ssv_i"],
        ss_tltx=o2i["sslx_i"], ss_tlty=o2i["ssly_i"])
    return forcing, dict(sst=o2i["sst_i"], frzmlt=frzmlt)


def into_atm_cm(state) -> dict:
    """Assemble the ice -> UM send set (``get_i2a_fields``): SST (K),
    per-category concentration / snow and ice thickness, ice velocity."""
    ncat = state.aicen.shape[0]
    safe_a = torch.clamp(state.aicen, min=cn.puny)
    has = state.aicen > cn.puny
    out = {"isst_ia": state.sst + cn.Tffresh}
    for k in range(ncat):
        out[f"icecon{k + 1:02d}"] = state.aicen[k]
        out[f"snwthk{k + 1:02d}"] = torch.where(
            has[k], state.vsnon[k] / safe_a[k], 0.0)
        out[f"icethk{k + 1:02d}"] = torch.where(
            has[k], state.vicen[k] / safe_a[k], 0.0)
    out["uvel_ia"] = state.uvel
    out["vvel_ia"] = state.vvel
    out["co2_i2"] = torch.zeros_like(state.sst)
    out["co2fx_i2"] = torch.zeros_like(state.sst)
    return out
