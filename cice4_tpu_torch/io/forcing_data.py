"""Forcing producers.

Port of the analytic part of :mod:`cice4_tpu.io.forcing_data`: the fixed
shortwave band split and :class:`AnalyticForcing`, the idealized
forcing the benchmark and the smoke run use.  The file-based datasets
(NCAR, LYq, ECMWF, monthly) wait for ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import math

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.forcing import Forcing
from cice4_tpu_torch.grid import Grid

# fixed shortwave band fractions (ice_forcing.F90 prepare_forcing)
frcvdr, frcvdf, frcidr, frcidf = 0.28, 0.24, 0.31, 0.17


def split_shortwave(fsw):
    """Fixed 4-band partition of total downward SW (prepare_forcing)."""
    return fsw * frcvdr, fsw * frcvdf, fsw * frcidr, fsw * frcidf


class AnalyticForcing:
    """Latitude/season idealized atmosphere + climatological ocean.

    Smooth, bounded fields that produce a realistic seasonal ice cycle:
    air temperature with latitude gradient + seasonal cycle, westerly/
    polar-easterly winds, humidity at fixed relative humidity, SW from
    zenith angle climatology, LW from air temperature.  The fields
    depend on `yday` only.
    """

    def __init__(self, cfg: Config, grid: Grid, *, device,
                 dtype=torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.lat = grid.tlat.to(device=device, dtype=dtype)
        self.lon = grid.tlon.to(device=device, dtype=dtype)
        self.ulat = grid.ulat.to(device=device, dtype=dtype)

    def __call__(self, yday: float, sec: float = 0.0) -> Forcing:
        lat = self.lat
        dtype = self.dtype
        # season phase: NH summer solstice ~ day 172
        phase = 2.0 * math.pi * (yday - 172.0) / 365.0
        seasonal = math.cos(phase)  # +1 at NH midsummer
        hemi = torch.sign(torch.sin(lat))

        # surface air temperature: warm equator, cold poles, +- seasonal
        Tair = (cn.Tffresh + 28.0 * torch.cos(lat) ** 2
                - 22.0 * torch.abs(torch.sin(lat)) ** 3
                + 12.0 * seasonal * hemi * torch.sin(lat) ** 2)
        # winds: polar easterlies (~7 m/s with slight rotation)
        uatm = -4.0 * torch.sin(lat) * torch.sign(torch.sin(lat))
        vatm = 2.0 * torch.sin(2.0 * lat) * seasonal
        wind = torch.sqrt(uatm**2 + vatm**2) + 1.0
        # humidity: 85% RH over saturation at Tair
        qsat = (cn.qqqice * torch.exp(-cn.TTTice / Tair)) / 1.3
        Qa = 0.85 * qsat
        # longwave: bulk emissivity formula
        flw = 0.7855 * 1.15 * cn.stefan_boltzmann * Tair**4
        # shortwave from daily-mean zenith angle
        decl = 0.409 * math.cos(2.0 * math.pi * (yday - 172.0) / 365.0) * -1.0
        cosz_noon = torch.clamp(
            torch.sin(lat) * math.sin(decl) + torch.cos(lat) * math.cos(decl),
            min=0.0)
        fsw = 900.0 * cosz_noon**1.4 * 0.45
        swvdr, swvdf, swidr, swidf = split_shortwave(fsw)
        # precipitation: snow when cold
        precip = 2.0e-5 * (0.8 + 0.5 * torch.cos(lat))  # kg/m^2/s
        snow = Tair < cn.Tffresh
        fsnow = torch.where(snow, precip, 0.0)
        frain = torch.where(snow, 0.0, precip)

        z = torch.zeros_like(lat)
        return Forcing(
            zlvl=z + 10.0, uatm=uatm.to(dtype), vatm=vatm.to(dtype),
            wind=wind.to(dtype), potT=Tair.to(dtype),
            Tair=Tair.to(dtype), Qa=Qa.to(dtype), rhoa=z + 1.3,
            flw=flw.to(dtype), swvdr=swvdr.to(dtype),
            swvdf=swvdf.to(dtype), swidr=swidr.to(dtype),
            swidf=swidf.to(dtype), frain=frain.to(dtype),
            fsnow=fsnow.to(dtype),
            sss=z + 34.0, uocn=z, vocn=z, ss_tltx=z, ss_tlty=z,
            qdp=z, hmix=z + 20.0,
        )
