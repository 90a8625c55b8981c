"""Shortwave radiation: CCSM3 albedos and Beer's-law absorption.

Port of :mod:`cice4_tpu.ops.shortwave` (the CCSM3 path of
``source/ice_shortwave.F90``: `compute_albedos`, `constant_albedos` and
`absorbed_solar`).  Every function is elementwise over any leading axes,
so the model passes all categories at once as ``(ncat, ny, nx)``; layer
outputs put the layer axis third from last: ``(..., nilyr, ny, nx)``.
"""

from __future__ import annotations

import math

import torch

from reference import constants as cn
from reference.config import RadiationConfig

i0vis = 0.70   # fraction of visible SW penetrating the surface
# albedo temperature-dependence constants (ice_shortwave.F90:632-640)
dT_mlt = 1.0
dalb_mlt = -0.075
dalb_mltv = -0.1
dalb_mlti = -0.15


def compute_albedos(rad: RadiationConfig, aicen, vicen, vsnon, tsfcn):
    """CCSM3 thickness/temperature-dependent albedos
    (``compute_albedos:564-780``).

    Returns dict of per-band ice (…ni) / snow (…ns) / combined albedos
    plus broadband `albin`/`albsn` history diagnostics.
    """
    has = aicen > cn.puny
    a_safe = torch.clamp(aicen, min=cn.puny)
    hi = torch.where(has, vicen / a_safe, 0.0)
    hs = torch.where(has, vsnon / a_safe, 0.0)

    fhtan = math.atan(rad.ahmax * 4.0)
    fh = torch.clamp(torch.atan(hi * 4.0) / fhtan, max=1.0)
    albo = cn.albocn * (1.0 - fh)
    alvdfni = rad.albicev * fh + albo
    alidfni = rad.albicei * fh + albo

    dTs = cn.Timelt - tsfcn
    fT = torch.clamp(dTs / dT_mlt - 1.0, max=0.0)
    alvdfni = torch.clamp(alvdfni - dalb_mlt * fT, min=cn.albocn)
    alidfni = torch.clamp(alidfni - dalb_mlt * fT, min=cn.albocn)

    snow = hs > cn.puny
    alvdfns = torch.where(snow, rad.albsnowv - dalb_mltv * fT, cn.albocn)
    alidfns = torch.where(snow, rad.albsnowi - dalb_mlti * fT, cn.albocn)

    alvdfni = torch.where(has, alvdfni, cn.albocn)
    alidfni = torch.where(has, alidfni, cn.albocn)
    alvdfns = torch.where(has, alvdfns, cn.albocn)
    alidfns = torch.where(has, alidfns, cn.albocn)

    asnow = torch.where(snow & has, hs / (hs + cn.snowpatch), 0.0)

    out = dict(
        alvdrni=alvdfni, alidrni=alidfni, alvdfni=alvdfni, alidfni=alidfni,
        alvdrns=alvdfns, alidrns=alidfns, alvdfns=alvdfns, alidfns=alidfns,
        asnow=asnow,
    )
    for band_i, band_s, name in [("alvdfni", "alvdfns", "alvdfn"),
                                 ("alidfni", "alidfns", "alidfn"),
                                 ("alvdrni", "alvdrns", "alvdrn"),
                                 ("alidrni", "alidrns", "alidrn")]:
        out[name] = out[band_i] * (1.0 - asnow) + out[band_s] * asnow
    out["albin"] = torch.where(has, cn.awtvdr * out["alvdrni"]
                               + cn.awtidr * out["alidrni"]
                               + cn.awtvdf * out["alvdfni"]
                               + cn.awtidf * out["alidfni"], 0.0)
    out["albsn"] = torch.where(has, cn.awtvdr * out["alvdrns"]
                               + cn.awtidr * out["alidrns"]
                               + cn.awtvdf * out["alvdfns"]
                               + cn.awtidf * out["alidfns"], 0.0)
    return out


def constant_albedos(rad: RadiationConfig, aicen, vsnon, tsfcn):
    """`albedo_type = 'constant'` variant (``constant_albedos``)."""
    has = aicen > cn.puny
    hs = torch.where(has, vsnon / torch.clamp(aicen, min=cn.puny), 0.0)
    snow = hs > cn.puny
    awi = 0.44  # constant warm ice albedo (ice_shortwave.F90 constant path)
    aws = 0.75
    alb_i = torch.where(has, torch.full_like(aicen, awi), cn.albocn)
    alb_s = torch.where(has & snow, torch.full_like(aicen, aws), cn.albocn)
    asnow = torch.where(snow & has, hs / (hs + cn.snowpatch), 0.0)
    comb = alb_i * (1.0 - asnow) + alb_s * asnow
    return dict(alvdrni=alb_i, alidrni=alb_i, alvdfni=alb_i, alidfni=alb_i,
                alvdrns=alb_s, alidrns=alb_s, alvdfns=alb_s, alidfns=alb_s,
                alvdrn=comb, alidrn=comb, alvdfn=comb, alidfn=comb,
                albin=torch.where(has, alb_i, 0.0),
                albsn=torch.where(has, alb_s, 0.0), asnow=asnow)


def absorbed_solar(nilyr, heat_capacity, aicen, vicen, vsnon,
                   swvdr, swvdf, swidr, swidf, alb):
    """Partition absorbed SW between surface, interior layers and
    transmission to the ocean (``absorbed_solar:974-1185``).

    Returns dict(fswsfc, fswint, fswthru, Iswabs[(..., nilyr, ny, nx)]).
    """
    has = aicen > cn.puny
    a_safe = torch.clamp(aicen, min=cn.puny)
    hi = torch.where(has, vicen / a_safe, 0.0)
    hs = torch.where(has, vsnon / a_safe, 0.0)
    asnow = torch.where((hs > cn.puny) & has, hs / (hs + cn.snowpatch), 0.0)

    def blend(sw, alb_ice, alb_snow):
        return sw * ((1.0 - alb_ice) * (1.0 - asnow)
                     + (1.0 - alb_snow) * asnow)

    swabsv = blend(swvdr, alb["alvdrni"], alb["alvdrns"]) \
        + blend(swvdf, alb["alvdfni"], alb["alvdfns"])
    swabsi = blend(swidr, alb["alidrni"], alb["alidrns"]) \
        + blend(swidf, alb["alidfni"], alb["alidfns"])
    swabs = swabsv + swabsi

    fswpen = (swvdr * (1.0 - alb["alvdrni"]) * (1.0 - asnow)
              + swvdf * (1.0 - alb["alvdfni"]) * (1.0 - asnow)) * i0vis
    fswsfc = swabs - fswpen

    hilyr = (hi / nilyr).unsqueeze(-3)
    k = torch.arange(1, nilyr + 1, dtype=hi.dtype,
                     device=hi.device).reshape(nilyr, 1, 1)
    tranbot = torch.exp(-cn.kappav * hilyr * k)
    trantop = torch.cat([torch.ones_like(tranbot[..., :1, :, :]),
                         tranbot[..., :-1, :, :]], dim=-3)
    Iswabs = fswpen.unsqueeze(-3) * (trantop - tranbot)
    fswthru = fswpen * tranbot[..., -1, :, :]
    fswint = fswpen - fswthru

    fswsfc = torch.where(has, fswsfc, 0.0)
    fswint = torch.where(has, fswint, 0.0)
    fswthru = torch.where(has, fswthru, 0.0)
    Iswabs = torch.where(has.unsqueeze(-3), Iswabs, 0.0)

    if not heat_capacity:
        fswsfc = fswsfc + fswint
        fswint = torch.zeros_like(fswint)
        Iswabs = torch.zeros_like(Iswabs)

    return dict(fswsfc=fswsfc, fswint=fswint, fswthru=fswthru,
                Iswabs=Iswabs)


def shortwave_ccsm3(rad: RadiationConfig, nilyr, nslyr, heat_capacity,
                    aicen, vicen, vsnon, tsfcn,
                    swvdr, swvdf, swidr, swidf):
    """Full CCSM3 shortwave driver (``shortwave_ccsm3:377-541``).  CCSM3
    absorbs no SW inside snow, so Sswabs is zero (only dEdd populates
    it)."""
    if rad.albedo_type == "constant":
        alb = constant_albedos(rad, aicen, vsnon, tsfcn)
    else:
        alb = compute_albedos(rad, aicen, vicen, vsnon, tsfcn)
    absorbed = absorbed_solar(nilyr, heat_capacity, aicen, vicen, vsnon,
                              swvdr, swvdf, swidr, swidf, alb)
    shape = aicen.shape[:-2] + (nslyr,) + aicen.shape[-2:]
    return {**alb, **absorbed,
            "Sswabs": torch.zeros(shape, dtype=aicen.dtype,
                                  device=aicen.device)}
