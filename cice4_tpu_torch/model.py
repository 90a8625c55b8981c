"""The model: one time step composing the column physics.

Port of :mod:`cice4_tpu.model` (``source/ice_step_mod.F90`` +
``drivers/cice4/CICE_RunMod.F90 ice_step:164-242``) for the
thermodynamic slice: CCSM3 radiation, the Monin-Obukhov boundary layer,
the Newton column thermodynamics (the therm_newton kernel on the GPU),
linear ITD, new ice, lateral melt, ridging at zero convergence, cleanup,
the slab ocean and the in-step conservation guards.  Dynamics
(``kdyn=1``, ROADMAP queue 1 item 1) and transport (``advection`` other
than ``"none"``, items 2 and 4) raise ``NotImplementedError``.

Categories are an explicit leading ``ncat`` axis where the JAX package
vmaps.  Radiation runs at the start of the step from the current
forcing (the standalone ordering of the JAX package).
"""

from __future__ import annotations

import torch
from torch import nn

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.forcing import Forcing
from cice4_tpu_torch.grid import GRID_FIELDS, Grid, make_grid
from cice4_tpu_torch.ops import itd as itd_ops
from cice4_tpu_torch.ops import mechred, therm_itd
from cice4_tpu_torch.ops.atmo import atmo_boundary_layer
from cice4_tpu_torch.ops.ocean import ocean_mixed_layer
from cice4_tpu_torch.ops.orbital import compute_coszen
from cice4_tpu_torch.ops.shortwave import shortwave_ccsm3
from cice4_tpu_torch.ops.therm_vertical import (frzmlt_bottom_lateral,
                                                make_thermo_params,
                                                thermo_vertical_category)
from cice4_tpu_torch.state import State, freezing_temperature, make_itd_params


def _check_supported(cfg: Config):
    if cfg.dynamics.kdyn != 0:
        raise NotImplementedError(
            "kdyn=1 (EVP dynamics) is not ported yet (ROADMAP queue 1 "
            "item 1); use dynamics.kdyn=0")
    if cfg.transport.advection != "none":
        raise NotImplementedError(
            f"advection={cfg.transport.advection!r} is not ported yet "
            "(ROADMAP queue 1 items 2 and 4); use transport.advection='none'")
    if cfg.radiation.shortwave != "default":
        raise NotImplementedError(
            "dEdd shortwave is not ported yet (ROADMAP queue 1 item 4)")
    if cfg.radiation.prep_radiation:
        raise NotImplementedError(
            "the coupled prep_radiation ordering is not ported yet "
            "(ROADMAP queue 1 item 4)")
    if cfg.thermo.atmbndy != "default":
        raise NotImplementedError(
            "atmbndy='constant' is not ported yet (ROADMAP queue 1 item 4)")
    if cfg.thermo.kitd != 1:
        raise NotImplementedError(
            "kitd=0 (delta-function ITD) is not ported yet (ROADMAP queue 1 "
            "item 4)")


class Model(nn.Module):
    """Static configuration plus the grid, held as registered buffers so
    that ``model.to(device)`` moves them.  ``model(state, forcing, yday,
    sec)`` runs one step (the step function `make_step_fn` returns in the
    JAX package)."""

    def __init__(self, cfg: Config, grid: Grid):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.itd = make_itd_params(cfg)
        self.thermo = make_thermo_params(cfg, self.itd)
        self._bc, self._nx, self._ny = grid.bc, grid.nx, grid.ny
        for name in GRID_FIELDS:
            self.register_buffer(name, getattr(grid, name))

    @classmethod
    def create(cls, cfg: Config, *, device, dtype=torch.float32) -> "Model":
        """Build the config's grid on `device` and the model around it."""
        return cls(cfg, make_grid(cfg, device=device, dtype=dtype))

    @property
    def grid(self) -> Grid:
        return Grid(bc=self._bc, nx=self._nx, ny=self._ny,
                    **{k: getattr(self, k) for k in GRID_FIELDS})

    def forward(self, state: State, forcing: Forcing, yday: float = 80.0,
                sec: float = 0.0, dt: float | None = None):
        return ice_step(self, state, self.grid, forcing, yday, sec, dt)


def _step_radiation(model: Model, state: State, grid: Grid, f: Forcing,
                    yday, sec, dt):
    """Zenith angle + per-category CCSM3 shortwave
    (``ice_step_mod.F90 step_radiation:764-973``)."""
    cfg = model.cfg
    coszen = compute_coszen(grid.tlat, grid.tlon, yday, sec, dt)
    sw = shortwave_ccsm3(cfg.radiation, model.itd.nilyr, model.itd.nslyr,
                         cfg.thermo.heat_capacity, state.aicen, state.vicen,
                         state.vsnon, state.tsfcn,
                         f.swvdr, f.swvdf, f.swidr, f.swidf)
    sw["coszen"] = coszen
    return sw


_MERGED = [
    ("strairxT", "strairxn"), ("strairyT", "strairyn"),
    ("fsurf", "fsurfn"), ("fcondtop", "fcondtopn"),
    ("fsens", "fsensn"), ("flat", "flatn"), ("fswabs", "fswabsn"),
    ("flwout", "flwoutn"), ("evap", "evapn"),
    ("Tref", "Trefn"), ("Qref", "Qrefn"),
    ("fresh", "freshn"), ("fsalt", "fsaltn"), ("fhocn", "fhocnn"),
    ("fswthru", None), ("meltt", "meltt"), ("melts", "melts"),
    ("meltb", "meltb"), ("congel", "congel"), ("snoice", "snoice"),
]


def _step_therm1(model: Model, state: State, grid: Grid, f: Forcing,
                 sw, Tf, yday, dt):
    """Vertical thermo of all categories + flux merging
    (``CICE_RunMod.F90 step_therm1:260-598``)."""
    cfg = model.cfg
    # the pre-thermo weights; the step builds new tensors and never
    # writes into these
    aicen_init = state.aicen
    vicen_init = state.vicen

    agg = itd_ops.aggregate(state, grid.tmask)
    Tbot, fbot, rside = frzmlt_bottom_lateral(
        model.thermo, dt, agg["aice"], state.frzmlt, state.eicen,
        state.esnon, state.sst, Tf, state.strocnxT, state.strocnyT)

    bl = atmo_boundary_layer("ice", state.tsfcn, f.potT, f.uatm, f.vatm,
                             f.wind, f.zlvl, f.Qa, f.rhoa,
                             cfg.thermo.calc_strair)
    st, fx = thermo_vertical_category(
        model.thermo, dt, state.aicen, state.vicen, state.vsnon,
        state.tsfcn, state.eicen, state.esnon,
        f.flw, f.potT, f.Qa, f.rhoa, f.fsnow, fbot, Tbot, Tf,
        bl["lhcoef"], bl["shcoef"], sw["fswsfc"], sw["fswint"],
        sw["fswthru"], sw["Sswabs"], sw["Iswabs"])
    fx["strairxn"] = bl["strx"]
    fx["strairyn"] = bl["stry"]
    fx["Trefn"] = bl["Tref"]
    fx["Qrefn"] = bl["Qref"]

    guards = {}
    if cfg.run.guards:
        # conservation_check_vthermo (ice_therm_vertical.F90:4511-4613),
        # with the solve's adjusted interior absorption fx["fswint"]
        from cice4_tpu_torch.guards import check_vthermo
        guards["thermo energy conservation (W/m^2)"] = check_vthermo(
            dt, fx["fsurfn"], fx["flatn"], fx["fswint"],
            fx["fhocnn"], f.fsnow[None], fx["einit"], fx["efinal"],
            aicen_init > cn.a_negligible(aicen_init.dtype))

    trcrn = dict(state.trcrn)
    if "iage" in trcrn:
        # increment_age (ice_age.F90:87-123)
        trcrn["iage"] = torch.where(st["aicen"] > cn.puny,
                                    trcrn["iage"] + dt, 0.0)

    state = state.replace(aicen=st["aicen"], vicen=st["vicen"],
                          vsnon=st["vsnon"], tsfcn=st["tsfcn"],
                          eicen=st["eicen"], esnon=st["esnon"],
                          trcrn=trcrn)

    # merge_fluxes (ice_flux.F90:613-762): category -> cell means,
    # weighted by the *pre-thermo* areas
    w = aicen_init
    wsum = w.sum(0)
    merged = {}
    for name, per_ice in _MERGED:
        src = sw["fswthru"] if per_ice is None else fx[per_ice]
        merged[name] = (src * w).sum(0)
    # the coupler-facing flwout includes the REFLECTED downwelling LW
    # (ice_flux.F90 merge_fluxes:739-740)
    merged["flwout"] = merged["flwout"] - (1.0 - cn.emissivity) * f.flw * wsum
    # rain over ice passes through to the ocean (melt ponds are off)
    merged["fresh"] = merged["fresh"] + f.frain * wsum
    merged["rside"] = rside
    merged["fbot"] = fbot
    merged["frzmlt_init"] = state.frzmlt
    merged["aice_init"] = aicen_init.sum(0)
    for name, per_ice in [("fsurfn_ai", "fsurfn"),
                          ("fcondtopn_ai", "fcondtopn"),
                          ("flatn_ai", "flatn")]:
        merged[name] = fx[per_ice] * w
    merged["fmelttn_ai"] = torch.clamp(fx["fsurfn"] - fx["fcondtopn"],
                                       min=0.0) * w
    merged["vice_init"] = vicen_init.sum(0)
    merged["_guards"] = guards
    merged["_thermo_niter"] = fx["niter"]
    return state, merged, dict(aicen_init=aicen_init, vicen_init=vicen_init)


def _step_therm2(model: Model, state: State, grid: Grid, fluxes,
                 init, Tf, dt):
    """ITD conversions (``ice_step_mod.F90 step_therm2:239-516``)."""
    cfg, itd = model.cfg, model.itd
    vice_before = state.vicen.sum(0)
    state = therm_itd.linear_itd(state, itd, init["aicen_init"],
                                 init["vicen_init"])
    if cfg.run.guards:
        # column_conservation_check (ice_itd.F90:1409-1473) after linear_itd
        from cice4_tpu_torch.guards import check_column_conservation
        fluxes["_guards"]["column conservation: vice after "
                          "linear_itd"] = check_column_conservation(
            vice_before, state.vicen.sum(0), grid.tmask)
    state, dg = therm_itd.add_new_ice(state, itd, cfg, dt,
                                      state.frzmlt, Tf, grid.tmask)
    fluxes["frazil"] = dg["frazil"]
    if "dfresh" in dg:
        fluxes["fresh"] = fluxes["fresh"] + dg["dfresh"]
        fluxes["fsalt"] = fluxes["fsalt"] + dg["dfsalt"]

    state, lm = therm_itd.lateral_melt(state, itd, dt, fluxes["rside"])
    fluxes["fresh"] = fluxes["fresh"] + lm["fresh"]
    fluxes["fsalt"] = fluxes["fsalt"] + lm["fsalt"]
    fluxes["fhocn"] = fluxes["fhocn"] + lm["fhocn"]
    fluxes["meltl"] = lm["meltl"]

    state, zap = itd_ops.cleanup_itd(state, itd, grid.tmask, dt)
    fluxes["fresh"] = fluxes["fresh"] + zap["dfresh"]
    fluxes["fsalt"] = fluxes["fsalt"] + zap["dfsalt"]
    fluxes["fhocn"] = fluxes["fhocn"] + zap["dfhocn"]
    return state, fluxes


def _step_dynamics(model: Model, state: State, grid: Grid, f: Forcing,
                   fluxes, dt):
    """The kdyn=0 / advection='none' branch of
    ``ice_step_mod.F90 step_dynamics:538-745``: no EVP, no transport,
    ridging at zero convergence, cleanup."""
    cfg, itd = model.cfg, model.itd
    z = torch.zeros_like(state.sst)
    dyn_diag = dict(rdg_conv=z, rdg_shear=z, divu=z, shear=z,
                    strength=z, prs_sig=z)

    state, rdg = mechred.ridge_ice(state, itd, cfg.dynamics, dt,
                                   dyn_diag["rdg_conv"],
                                   dyn_diag["rdg_shear"], grid.tmask,
                                   aice0=None, guards=cfg.run.guards)
    if "_guard" in rdg:
        fluxes["_guards"]["ridging: area sum != 1"] = rdg.pop("_guard")
    fluxes["fresh"] = fluxes["fresh"] + rdg["fresh"]
    fluxes["fhocn"] = fluxes["fhocn"] + rdg["fhocn"]
    for k in ("dardg1dt", "dardg2dt", "dvirdgdt", "opening"):
        fluxes[k] = rdg[k]
    fluxes["_ridge_niter"] = rdg["niter"]

    state, zap = itd_ops.cleanup_itd(state, itd, grid.tmask, dt)
    fluxes["fresh"] = fluxes["fresh"] + zap["dfresh"]
    fluxes["fsalt"] = fluxes["fsalt"] + zap["dfsalt"]
    fluxes["fhocn"] = fluxes["fhocn"] + zap["dfhocn"]

    for k in ("divu", "shear", "strength", "prs_sig"):
        fluxes[k] = dyn_diag[k]
    return state, fluxes


def _coupling_prep(model: Model, state: State, grid: Grid, f: Forcing,
                   sw, fluxes, Tf, dt):
    """Albedo aggregation, slab ocean, SW scale factor
    (``CICE_RunMod.F90 coupling_prep:615-764``)."""
    cfg = model.cfg
    agg = itd_ops.aggregate(state, grid.tmask)
    aice = agg["aice"]

    albs = {}
    for name in ("alvdf", "alidf", "alvdr", "alidr"):
        albs[name] = (sw[name + "n"] * state.aicen).sum(0)
    scale_factor = (f.swvdr * (1.0 - albs["alvdr"])
                    + f.swvdf * (1.0 - albs["alvdf"])
                    + f.swidr * (1.0 - albs["alidr"])
                    + f.swidf * (1.0 - albs["alidf"]))

    sst, frzmlt = state.sst, state.frzmlt
    if cfg.thermo.oceanmixed_ice:
        ml = ocean_mixed_layer(
            dt, grid.tmask, aice, state.sst, Tf, f.qdp, f.hmix,
            f.uatm, f.vatm, f.wind, f.zlvl, f.potT, f.Qa, f.rhoa, f.flw,
            f.swvdr, f.swvdf, f.swidr, f.swidf,
            fluxes["fhocn"], fluxes["fswthru"],
            atmbndy=cfg.thermo.atmbndy)
        sst, frzmlt = ml["sst"], ml["frzmlt"]
        fluxes.update({k: v for k, v in ml.items()
                       if k not in ("sst", "frzmlt", "qdp")})

    state = state.replace(sst=sst, frzmlt=frzmlt, scale_factor=scale_factor)
    fluxes.update(albs)
    fluxes["coszen"] = sw["coszen"]
    fluxes["albice"] = (sw["albin"] * state.aicen).sum(0)
    fluxes["albsno"] = (sw["albsn"] * state.aicen).sum(0)

    # grid-box-mean copies kept for the budget diagnostics
    for name in ("fresh", "fsalt", "fhocn", "fswthru", "evap",
                 "fsens", "flwout", "fswabs", "flat", "fsurf"):
        fluxes[name + "_gbm"] = fluxes[name]
    fluxes["aice"] = aice

    # scale_fluxes (ice_flux.F90:776-888): per-unit-ice-area values;
    # zero (or the documented defaults) where there is no ice
    ice = grid.tmask & (aice > 0.0)
    ar = torch.where(ice, 1.0 / torch.clamp(aice, min=cn.puny), 0.0)
    for name in ("strairxT", "strairyT", "fsens", "flat", "fswabs",
                 "evap", "Tref", "Qref", "fresh", "fsalt", "fhocn",
                 "fswthru", "alvdr", "alidr", "alvdf", "alidf"):
        fluxes[name] = fluxes[name] * ar
    fluxes["flwout"] = torch.where(
        ice, fluxes["flwout"] * ar,
        -cn.stefan_boltzmann * (Tf + cn.Tffresh) ** 4)
    fluxes["Tref"] = torch.where(ice, fluxes["Tref"], f.Tair)
    fluxes["Qref"] = torch.where(ice, fluxes["Qref"], f.Qa)
    return state, fluxes


def ice_step(model: Model, state: State, grid: Grid, f: Forcing,
             yday=80.0, sec=0.0, dt=None):
    """One model step (``CICE_RunMod.F90 ice_step:164-242``).

    Returns (new_state, fluxes) where fluxes holds every merged
    coupler/diagnostic field of the step, the guard records under
    ``"_guards"``, and the thermo and ridging iteration counts under
    ``"_thermo_niter"`` (device tensor) and ``"_ridge_niter"`` (int).
    """
    cfg = model.cfg
    if dt is None:
        dt = cfg.run.dt
    Tf = freezing_temperature(cfg, f.sss)

    sw = _step_radiation(model, state, grid, f, yday, sec, dt)
    state, fluxes, init = _step_therm1(model, state, grid, f, sw, Tf,
                                       yday, dt)
    state, fluxes = _step_therm2(model, state, grid, fluxes, init, Tf, dt)
    # thermodynamic area/volume tendencies (init_history_therm)
    aice_mid = state.aicen.sum(0)
    vice_mid = state.vicen.sum(0)
    fluxes["daidtt"] = (aice_mid - fluxes["aice_init"]) / dt
    fluxes["dvidtt"] = (vice_mid - fluxes["vice_init"]) / dt
    state, fluxes = _step_dynamics(model, state, grid, f, fluxes, dt)
    # dynamic tendencies (init_history_dyn)
    fluxes["daidtd"] = (state.aicen.sum(0) - aice_mid) / dt
    fluxes["dvidtd"] = (state.vicen.sum(0) - vice_mid) / dt
    state, fluxes = _coupling_prep(model, state, grid, f, sw, fluxes,
                                   Tf, dt)
    return state, fluxes
