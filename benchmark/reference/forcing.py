"""Atmosphere/ocean forcing passed to the model step.

Port of :mod:`cice4_tpu.forcing` (the coupler-input section of
``source/ice_flux.F90:38-80``).  How the fields are produced lives in
:mod:`reference.forcing_data`.
"""

from __future__ import annotations

import dataclasses

import torch


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

    def replace(self, **kw) -> "Forcing":
        return dataclasses.replace(self, **kw)
