"""Prognostic model state.

Port of :mod:`cice4_tpu.state` (``source/ice_state.F90:66-137`` plus the
persistent pieces of ``ice_flux.F90`` and the EVP stresses).  Layouts
are the JAX package's:

* ``aicen/vicen/vsnon/tsfcn``: ``(ncat, ny, nx)``
* ``eicen``: ``(ncat, nilyr, ny, nx)``; ``esnon``: ``(ncat, nslyr, ny, nx)``
* ``trcrn``: dict of optional tracers (iage, alvl, vlvl, volpn), each
  ``(ncat, ny, nx)``
* ``uvel/vvel``: ``(ny, nx)``; the three corner stress tensors
  ``(4, ny, nx)`` with corner order (ne, nw, sw, se)

The step replaces fields with new tensors (``State.replace``); no
function of the port writes into a tensor it was given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.grid import Grid

STATE_FIELDS = (
    "aicen", "vicen", "vsnon", "eicen", "esnon", "tsfcn", "trcrn",
    "uvel", "vvel", "stressp", "stressm", "stress12", "iceumask",
    "sst", "frzmlt", "scale_factor", "strocnxT", "strocnyT", "swn",
)


@dataclasses.dataclass(frozen=True)
class State:
    """Full prognostic state.  See the module docstring for shapes and
    :class:`cice4_tpu.state.State` for each field's meaning."""

    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    eicen: torch.Tensor
    esnon: torch.Tensor
    tsfcn: torch.Tensor
    trcrn: dict
    uvel: torch.Tensor
    vvel: torch.Tensor
    stressp: torch.Tensor
    stressm: torch.Tensor
    stress12: torch.Tensor
    iceumask: torch.Tensor
    sst: torch.Tensor
    frzmlt: torch.Tensor
    scale_factor: torch.Tensor
    strocnxT: torch.Tensor
    strocnyT: torch.Tensor
    swn: dict = dataclasses.field(default_factory=dict)

    @property
    def ncat(self):
        return self.aicen.shape[0]

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ItdParams:
    """Category bounds and fixed vertical profiles, as NumPy arrays
    (``ice_itd.F90 init_itd:97-270``, ``ice_therm_vertical.F90
    init_thermo_vertical:533-584``)."""

    hin_max: np.ndarray   # (ncat+1,) category thickness bounds (m)
    salin: np.ndarray     # (nilyr+1,) fixed salinity profile (ppt)
    tmlt: np.ndarray      # (nilyr+1,) melting temperature profile (C)
    ncat: int
    nilyr: int
    nslyr: int


def make_itd_params(cfg: Config) -> ItdParams:
    ncat = cfg.domain.ncat
    nilyr = cfg.domain.nilyr
    kcatbound = cfg.domain.kcatbound
    kitd = cfg.thermo.kitd
    hi_min = 0.01  # minimum ice thickness for delta-function ITD

    hin_max = np.zeros(ncat + 1)
    if kcatbound == 0:
        if kitd == 1:
            cc1 = 3.0 / ncat
            cc2 = 15.0 * cc1
            cc3 = 3.0
            hin_max[0] = 0.0
        else:
            cc1 = max(1.1 / ncat, hi_min)
            cc2 = 25.0 * cc1
            cc3 = 2.25
            hin_max[0] = hi_min
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            hin_max[n] = hin_max[n - 1] + cc1 + cc2 * (1.0 + np.tanh(cc3 * (x1 - 1.0)))
    elif kcatbound == 1:
        d1, d2 = 3.0 / ncat, 0.5 / ncat
        for n in range(1, ncat + 1):
            hin_max[n] = n * (d1 + (n - 1) * d2)
    elif kcatbound == 2:
        wmo = {5: [0.30, 0.70, 1.20, 2.00, 999.0],
               6: [0.15, 0.30, 0.70, 1.20, 2.00, 999.0],
               7: [0.10, 0.15, 0.30, 0.70, 1.20, 2.00, 999.0]}[ncat]
        hin_max[1:] = wmo
    else:
        raise ValueError(f"kcatbound={kcatbound}")

    saltmax = cfg.thermo.saltmax
    l_brine = saltmax > 0.1 and cfg.thermo.heat_capacity
    salin = np.zeros(nilyr + 1)
    if l_brine:
        k = np.arange(1, nilyr + 1)
        zn = (k - 0.5) / nilyr
        salin[:nilyr] = (saltmax / 2.0) * (1.0 - np.cos(np.pi * zn ** (0.407 / (0.573 + zn))))
        salin[nilyr] = saltmax
    tmlt = -salin * cn.depressT
    return ItdParams(hin_max=hin_max, salin=salin, tmlt=tmlt,
                     ncat=ncat, nilyr=nilyr, nslyr=cfg.domain.nslyr)


def zeros_state(cfg: Config, grid: Grid, *, device,
                dtype=torch.float32) -> State:
    ncat, nilyr, nslyr = cfg.domain.ncat, cfg.domain.nilyr, cfg.domain.nslyr
    ny, nx = grid.ny, grid.nx

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    trcrn = {}
    if cfg.tracers.tr_iage:
        trcrn["iage"] = z(ncat, ny, nx)
    if cfg.tracers.tr_lvl:
        trcrn["alvl"] = z(ncat, ny, nx)
        trcrn["vlvl"] = z(ncat, ny, nx)
    if cfg.tracers.tr_pond:
        trcrn["volpn"] = z(ncat, ny, nx)
    swn = {}
    if cfg.radiation.prep_radiation:
        swn = dict(fswsfcn=z(ncat, ny, nx), fswintn=z(ncat, ny, nx),
                   fswthrun=z(ncat, ny, nx),
                   Sswabsn=z(ncat, nslyr, ny, nx),
                   Iswabsn=z(ncat, nilyr, ny, nx),
                   alvdr_gbm=z(ny, nx), alvdf_gbm=z(ny, nx),
                   alidr_gbm=z(ny, nx), alidf_gbm=z(ny, nx))
    return State(
        aicen=z(ncat, ny, nx), vicen=z(ncat, ny, nx), vsnon=z(ncat, ny, nx),
        eicen=z(ncat, nilyr, ny, nx), esnon=z(ncat, nslyr, ny, nx),
        tsfcn=z(ncat, ny, nx), trcrn=trcrn,
        uvel=z(ny, nx), vvel=z(ny, nx),
        stressp=z(4, ny, nx), stressm=z(4, ny, nx), stress12=z(4, ny, nx),
        iceumask=z(ny, nx, dt=torch.bool),
        sst=z(ny, nx), frzmlt=z(ny, nx), scale_factor=z(ny, nx),
        strocnxT=z(ny, nx), strocnyT=z(ny, nx), swn=swn,
    )


def freezing_temperature(cfg: Config, sss):
    """Freezing temperature of seawater (C). `Tfrzpt` options of
    ``ice_nml`` (`linear_S`: Tf = -depressT * sss; `constant`: -1.8 C)."""
    if cfg.thermo.Tfrzpt == "linear_S":
        return -cn.depressT * sss
    return torch.full_like(sss, cn.Tocnfrz)


def init_state(cfg: Config, grid: Grid, itd: ItdParams,
               Tair=None, sst=None, sss=None, *, device,
               dtype=torch.float32) -> State:
    """Default cold-start state (``ice_init.F90 set_state_var:921-1195``).

    Ice is placed where the ocean surface is cold and poleward of the
    initial edges (70N / -60S), with a parabolic category-area profile
    peaked at hbar = 3 m, 0.20 m of snow, surface temperature
    min(Tsmelt, Tair - Tffresh), and linear-in-depth internal
    temperature profiles converted to enthalpy.
    """
    ncat, nilyr, nslyr = itd.ncat, itd.nilyr, itd.nslyr
    ny, nx = grid.ny, grid.nx
    s = zeros_state(cfg, grid, device=device, dtype=dtype)

    if sss is None:
        sss = torch.full((ny, nx), 34.0, dtype=dtype, device=device)
    Tf = freezing_temperature(cfg, sss).to(dtype)
    if sst is None:
        sst = Tf
    if Tair is None:
        Tair = torch.full((ny, nx), 253.0, dtype=dtype, device=device)
    s = s.replace(sst=sst, tsfcn=Tf.expand(ncat, ny, nx).clone())

    if cfg.run.ice_ic == "none":
        return s

    # category thickness/area profile
    hbar = 3.0
    hinit = np.zeros(ncat)
    for n in range(ncat):
        if n < ncat - 1:
            hinit[n] = 0.5 * (itd.hin_max[n] + itd.hin_max[n + 1])
        else:
            hinit[n] = itd.hin_max[n] + 1.0
    ainit = np.maximum(0.0, 2.0 * hbar * hinit - hinit**2)
    ainit = ainit / (ainit.sum() + cn.puny / ncat)

    # where to place ice
    if cfg.grid.grid_type == "rectangular":
        icemask = grid.tmask & (grid.ulon < np.deg2rad(-50.0))
    else:
        edge_nh = float(np.deg2rad(70.0))
        edge_sh = float(np.deg2rad(-60.0))
        cold = sst <= (Tf + 0.2)
        icemask = grid.tmask & cold & ((grid.ulat < edge_sh) | (grid.ulat > edge_nh))
    m = icemask.to(dtype)

    ainit_a = torch.as_tensor(ainit, dtype=dtype, device=device)[:, None, None]
    hinit_a = torch.as_tensor(hinit, dtype=dtype, device=device)[:, None, None]
    aicen = m * ainit_a
    vicen = hinit_a * aicen
    vsnon = torch.minimum(aicen * 0.20, 0.2 * vicen)

    tsfc_ice = torch.clamp(Tair - cn.Tffresh, max=cn.Tsmelt)
    tsfcn = torch.where(icemask, tsfc_ice, Tf)
    tsfcn = tsfcn.expand(ncat, ny, nx).clone()

    if cfg.thermo.heat_capacity:
        # linear temperature profile Tf..Tsfc -> enthalpy per layer
        k = torch.arange(1, nilyr + 1, dtype=dtype,
                         device=device)[None, :, None, None]
        slope = (Tf[None, None] - tsfcn[:, None])  # (ncat,1,ny,nx)
        Ti = tsfcn[:, None] + slope * (k - 0.5) / nilyr
        Ti = torch.clamp(Ti, max=-cn.puny)  # guard 1/Ti
        tmlt = torch.as_tensor(itd.tmlt[:nilyr], dtype=dtype,
                               device=device)[None, :, None, None]
        qin = -(cn.rhoi * (cn.cp_ice * (tmlt - Ti)
                           + cn.Lfresh * (1.0 - tmlt / Ti)
                           - cn.cp_ocn * tmlt))
        eicen = qin * vicen[:, None] / nilyr
        Ts = torch.clamp(tsfcn, max=0.0)[:, None]
        esnon = (-cn.rhos * (cn.Lfresh - cn.cp_ice * Ts)
                 * vsnon[:, None] / nslyr)
    else:
        eicen = (-cn.rhoi * cn.Lfresh * vicen[:, None] / nilyr
                 ).expand(ncat, nilyr, ny, nx).clone()
        esnon = (-cn.rhos * cn.Lfresh * vsnon[:, None] / nslyr
                 ).expand(ncat, nslyr, ny, nx).clone()

    # initial ice is all level ice (ice_lvl.F90 init: alvl = vlvl = 1)
    trcrn = dict(s.trcrn)
    if "alvl" in trcrn:
        ones = (aicen > 0.0).to(dtype)
        trcrn["alvl"] = ones
        trcrn["vlvl"] = ones
    return s.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, tsfcn=tsfcn,
                     eicen=eicen, esnon=esnon, trcrn=trcrn)
