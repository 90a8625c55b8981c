"""Atmosphere/ocean forcing passed to the model step.

Port of :mod:`cice4_tpu.forcing` (the coupler-input section of
``source/ice_flux.F90:38-80``).  How the fields are produced lives in
:mod:`cice4_tpu_torch.io.forcing_data`.
"""

from __future__ import annotations

import dataclasses

import torch

FORCING_FIELDS = (
    "zlvl", "uatm", "vatm", "wind", "potT", "Tair", "Qa", "rhoa",
    "flw", "swvdr", "swvdf", "swidr", "swidf", "frain", "fsnow",
    "sss", "uocn", "vocn", "ss_tltx", "ss_tlty", "qdp", "hmix",
    "fsurfn_f", "fcondtopn_f", "flatn_f", "strax", "stray",
)


@dataclasses.dataclass(frozen=True)
class Forcing:
    """All external forcing fields, (ny, nx) each; see
    :class:`cice4_tpu.forcing.Forcing` for units."""

    zlvl: torch.Tensor
    uatm: torch.Tensor
    vatm: torch.Tensor
    wind: torch.Tensor
    potT: torch.Tensor
    Tair: torch.Tensor
    Qa: torch.Tensor
    rhoa: torch.Tensor
    flw: torch.Tensor
    swvdr: torch.Tensor
    swvdf: torch.Tensor
    swidr: torch.Tensor
    swidf: torch.Tensor
    frain: torch.Tensor
    fsnow: torch.Tensor
    sss: torch.Tensor
    uocn: torch.Tensor
    vocn: torch.Tensor
    ss_tltx: torch.Tensor
    ss_tlty: torch.Tensor
    qdp: torch.Tensor
    hmix: torch.Tensor
    # coupled calc_Tsfc=F mode: prescribed per-category surface fluxes
    fsurfn_f: torch.Tensor | None = None
    fcondtopn_f: torch.Tensor | None = None
    flatn_f: torch.Tensor | None = None
    # prescribed wind stress for calc_strair=F datasets
    strax: torch.Tensor | None = None
    stray: torch.Tensor | None = None

    def replace(self, **kw) -> "Forcing":
        return dataclasses.replace(self, **kw)


def default_forcing(ny, nx, *, device, dtype=torch.float32) -> Forcing:
    """Quiescent default forcing (cold, calm, dark)."""
    def f(v):
        return torch.full((ny, nx), v, dtype=dtype, device=device)

    z = f(0.0)
    return Forcing(
        zlvl=f(10.0), uatm=z, vatm=z, wind=z, potT=f(253.0), Tair=f(253.0),
        Qa=f(0.0002), rhoa=f(1.3), flw=f(180.0),
        swvdr=z, swvdf=z, swidr=z, swidf=z, frain=z, fsnow=z,
        sss=f(34.0), uocn=z, vocn=z, ss_tltx=z, ss_tlty=z,
        qdp=z, hmix=f(20.0),
    )
