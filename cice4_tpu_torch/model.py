"""The model: one time step composing the column physics and dynamics.

Port of :mod:`cice4_tpu.model` (``source/ice_step_mod.F90`` +
``CICE_RunMod.F90 ice_step:164-242``): CCSM3 (default or constant
albedos) or delta-Eddington radiation with the explicit melt-pond
tracer, the Monin-Obukhov or constant-coefficient boundary layer, the
Newton column thermodynamics (the therm_newton kernel on the GPU),
linear ITD (or none, ``kitd=0``), new ice, lateral melt, EVP dynamics
(the evp_subcycle kernel), incremental remapping (the remap_gsh and
remap_k12 kernels; or first-order upwind transport), ridging, cleanup,
the slab ocean and the in-step conservation guards.  Dynamics may be off
(``kdyn=0``) and transport may be ``"none"``.  Without a heat capacity the
column runs the zero-layer solve; with ``calc_Tsfc=False`` the surface
fluxes are the coupler's (``Forcing.fsurfn_f`` and the rest) or, without
them, the explicit surface scheme's.

On a decomposed grid each block runs this step on its own state, forcing
and grid (a grid whose `bc` is a :class:`~cice4_tpu_torch.parallel.halo.
BlockBC`, from :func:`cice4_tpu_torch.convert.scatter_blocks`) inside
:meth:`cice4_tpu_torch.parallel.mesh.Mesh.run`: the column phases run on
the block as they are; the stencils exchange with the neighbouring
blocks; the EVP subcycles and the remap take their k-halo paths (or the
gathered ones); the loop exits and the guards reduce over the blocks.

Categories are an explicit leading ``ncat`` axis where the JAX package
vmaps.  Radiation runs at the start of the step from the current
forcing (the standalone ordering of the JAX package) or, with
``radiation.prep_radiation``, at its end, with last step's absorbed
shortwave rescaled at its start (the coupled ordering).
"""

from __future__ import annotations

import torch
from torch import nn

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch import timers
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.forcing import Forcing
from cice4_tpu_torch.grid import GRID_FIELDS, Grid, make_grid
from cice4_tpu_torch.ops import itd as itd_ops
from cice4_tpu_torch.ops import mechred, therm_itd
from cice4_tpu_torch.ops.atmo import atmo_boundary_const, atmo_boundary_layer
from cice4_tpu_torch.ops.evp import evp, principal_stress
from cice4_tpu_torch.ops.meltpond import compute_ponds, pond_geometry
from cice4_tpu_torch.ops.ocean import ocean_mixed_layer
from cice4_tpu_torch.ops.orbital import compute_coszen
from cice4_tpu_torch.ops.remap import (transport_remap,
                                      transport_remap_decomposed)
from cice4_tpu_torch.ops.shortwave import shortwave_ccsm3
from cice4_tpu_torch.ops.shortwave_dedd import shortwave_dEdd
from cice4_tpu_torch.ops.therm_vertical import (explicit_calc_tsfc,
                                                frzmlt_bottom_lateral,
                                                make_thermo_params,
                                                thermo_vertical_category)
from cice4_tpu_torch.ops.transport import transport_upwind
from cice4_tpu_torch.parallel.halo import BlockBC
from cice4_tpu_torch.state import State, freezing_temperature, make_itd_params


def _check_supported(cfg: Config):
    if cfg.dynamics.kdyn not in (0, 1):
        raise ValueError(f"unknown kdyn {cfg.dynamics.kdyn}")
    if cfg.transport.advection not in ("none", "remap", "upwind"):
        raise ValueError(f"unknown advection {cfg.transport.advection!r}")


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
    """Zenith angle + per-category shortwave
    (``ice_step_mod.F90 step_radiation:764-973``)."""
    cfg = model.cfg
    coszen = compute_coszen(grid.tlat, grid.tlon, yday, sec, dt)
    if cfg.radiation.shortwave == "dEdd":
        apond = hpond = None
        if "volpn" in state.trcrn:
            apond, hpond = pond_geometry(state.trcrn["volpn"])
        sw = shortwave_dEdd(cfg.radiation, model.itd.nilyr, model.itd.nslyr,
                            state.aicen, state.vicen, state.vsnon,
                            state.tsfcn, coszen,
                            f.swvdr, f.swvdf, f.swidr, f.swidf,
                            apond=apond, hpond=hpond)
    else:
        sw = shortwave_ccsm3(cfg.radiation, model.itd.nilyr,
                             model.itd.nslyr, cfg.thermo.heat_capacity,
                             state.aicen, state.vicen, state.vsnon,
                             state.tsfcn, f.swvdr, f.swvdf, f.swidr, f.swidf)
    sw["coszen"] = coszen
    return sw


def _prep_radiation(model: Model, state: State, f: Forcing):
    """Coupled-mode SW rescale at step start (``ice_step_mod.F90
    prep_radiation:84-218``): multiply last step's absorbed-SW
    components (carried in state.swn) by netsw_new / scale_factor."""
    swn = state.swn
    aice = state.aicen.sum(0)
    netsw = (f.swvdr * (1.0 - swn["alvdr_gbm"])
             + f.swvdf * (1.0 - swn["alvdf_gbm"])
             + f.swidr * (1.0 - swn["alidr_gbm"])
             + f.swidf * (1.0 - swn["alidf_gbm"]))
    ok = (aice > 0.0) & (state.scale_factor > cn.puny)
    scale = torch.where(ok, netsw / torch.clamp(state.scale_factor,
                                                min=cn.puny), 1.0)
    return dict(fswsfc=scale * swn["fswsfcn"], fswint=scale * swn["fswintn"],
                fswthru=scale * swn["fswthrun"],
                Sswabs=scale * swn["Sswabsn"], Iswabs=scale * swn["Iswabsn"],
                fswfac=scale)


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

    if cfg.thermo.atmbndy == "constant":
        bl = atmo_boundary_const("ice", f.uatm, f.vatm, f.wind, f.rhoa,
                                 cfg.thermo.calc_strair)
    else:
        bl = atmo_boundary_layer("ice", state.tsfcn, f.potT, f.uatm,
                                 f.vatm, f.wind, f.zlvl, f.Qa, f.rhoa,
                                 cfg.thermo.calc_strair)
    tsfcn = state.tsfcn
    pre = {}
    ex = None
    if not cfg.thermo.calc_Tsfc:
        if f.fsurfn_f is not None:
            # coupler-supplied per-category fluxes (set_sfcflux,
            # CICE_RunMod.F90:787-920; raicen=1 standalone)
            pre = dict(fsurfn_pre=f.fsurfn_f, fcondtopn_pre=f.fcondtopn_f,
                       flatn_pre=f.flatn_f)
        else:
            # ice-only testing mode: the explicit surface scheme
            # (CICE_RunMod.F90:465-499)
            ex = explicit_calc_tsfc(
                model.thermo, dt, state.aicen, state.vicen, state.vsnon,
                tsfcn, state.eicen, state.esnon, f.rhoa, f.flw, f.potT,
                f.Qa, bl["shcoef"], bl["lhcoef"], sw["fswsfc"])
            tsfcn = ex["Tsf"]
            pre = dict(fsurfn_pre=ex["fsurfn"], fcondtopn_pre=ex["fcondtopn"],
                       flatn_pre=ex["flatn"])
    st, fx = thermo_vertical_category(
        model.thermo, dt, state.aicen, state.vicen, state.vsnon,
        tsfcn, state.eicen, state.esnon,
        f.flw, f.potT, f.Qa, f.rhoa, f.fsnow, fbot, Tbot, Tf,
        bl["lhcoef"], bl["shcoef"], sw["fswsfc"], sw["fswint"],
        sw["fswthru"], sw["Sswabs"], sw["Iswabs"], **pre)
    if ex is not None:
        fx["fsensn"] = ex["fsensn"]
        fx["flwoutn"] = ex["flwoutn"]
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
    ponds_active = "volpn" in trcrn and cfg.radiation.shortwave == "dEdd"
    if ponds_active:
        # explicit melt ponds (ice_meltpond.F90 compute_ponds:88-230)
        trcrn["volpn"], _, _ = compute_ponds(
            dt, fx["meltt"], fx["melts"], f.frain, st["aicen"], st["vicen"],
            st["vsnon"], st["tsfcn"], trcrn["volpn"])

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
    if not ponds_active:
        # rain over ice passes through to the ocean; with the ponds on,
        # the reference stores part of it in the pond volume instead
        merged["fresh"] = merged["fresh"] + f.frain * wsum
    merged["rside"] = rside
    merged["fbot"] = fbot
    merged["frzmlt_init"] = state.frzmlt
    merged["aice_init"] = aicen_init.sum(0)
    if not cfg.thermo.calc_strair and f.strax is not None:
        # calc_strair=F with a prescribed stress (the monthly dataset,
        # ACCESS-CM): the boundary layer returned zero stress; the EVP
        # takes the forcing's, already rotated and aice-weighted
        # (ice_dyn_evp.F90:255-277)
        merged["strairxT"] = f.strax
        merged["strairyT"] = f.stray
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
    if cfg.thermo.kitd == 1:
        vice_before = state.vicen.sum(0)
        state = therm_itd.linear_itd(state, itd, init["aicen_init"],
                                     init["vicen_init"])
        if cfg.run.guards:
            # column_conservation_check (ice_itd.F90:1409-1473) after
            # linear_itd
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
    """EVP + transport + ridging
    (``ice_step_mod.F90 step_dynamics:538-745``)."""
    cfg, itd = model.cfg, model.itd
    agg = itd_ops.aggregate(state, grid.tmask)

    if cfg.dynamics.kdyn == 1:
        state, dyn_diag = evp(
            state, grid, cfg.dynamics, dt,
            agg["aice"], agg["vice"], agg["vsno"],
            state.aicen, state.vicen, agg["aice0"],
            f.uocn, f.vocn, f.ss_tltx, f.ss_tlty,
            fluxes["strairxT"], fluxes["strairyT"])
    else:
        z = torch.zeros_like(agg["aice"])
        dyn_diag = dict(rdg_conv=z, rdg_shear=z, divu=z, shear=z,
                        strength=z, prs_sig=z)

    tr = cfg.transport
    aice0_adv = None
    with timers.span("Advection"):
        if tr.advection == "remap" and isinstance(grid.bc, BlockBC):
            # a block of a decomposed grid: the k-halo remap, or the
            # gathered one where it is refused (cice4_tpu/model.py:354-368)
            out = transport_remap_decomposed(state, grid, dt, tr)
            state, aice0_adv = out[:2]
            if len(out) == 3:
                fluxes["_guards"].update(out[2])
        elif tr.advection == "remap":
            out = transport_remap(
                state, grid, dt, tr.integral_order, tr.l_dp_midpt,
                tr.l_fixed_area, conservation_check=tr.conservation_check,
                monotonicity_check=tr.monotonicity_check)
            state, aice0_adv = out[:2]
            if len(out) == 3:
                fluxes["_guards"].update(out[2])
        elif tr.advection == "upwind":
            state, aice0_adv = transport_upwind(state, grid, dt)

    # ridging and the cleanup after it: CICE's Ridging timer, inside its
    # Column timer (ice_step_mod.F90 step_dynamics)
    with timers.span("Ridging"):
        state, rdg = mechred.ridge_ice(state, itd, cfg.dynamics, dt,
                                       dyn_diag["rdg_conv"],
                                       dyn_diag["rdg_shear"], grid.tmask,
                                       aice0=aice0_adv,
                                       guards=cfg.run.guards)
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
    for k in ("strintx", "strinty", "strocnx", "strocny",
              "strtltx", "strtlty", "strcorx", "strcory"):
        if k in dyn_diag:
            fluxes[k] = dyn_diag[k]

    # principal stresses sig1/sig2 + stress trace for history
    # (``principal_stress``, ice_dyn_evp.F90:1558-1609)
    if cfg.dynamics.kdyn == 1:
        fluxes["sig1"], fluxes["sig2"] = principal_stress(
            state.stressp[0], state.stressm[0], state.stress12[0],
            dyn_diag["prs_sig"])
        fluxes["trsig"] = 0.25 * state.stressp.sum(0)
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

    swn = state.swn
    if cfg.radiation.prep_radiation:
        # carry the absorbed-SW components + gridbox albedos to the
        # next step's prep_radiation rescale
        swn = dict(fswsfcn=sw["fswsfc"], fswintn=sw["fswint"],
                   fswthrun=sw["fswthru"], Sswabsn=sw["Sswabs"],
                   Iswabsn=sw["Iswabs"],
                   alvdr_gbm=albs["alvdr"], alvdf_gbm=albs["alvdf"],
                   alidr_gbm=albs["alidr"], alidf_gbm=albs["alidf"])

    state = state.replace(sst=sst, frzmlt=frzmlt, scale_factor=scale_factor,
                          swn=swn)
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
    ``"_thermo_niter"`` (device tensor) and ``"_ridge_niter"`` (an int on
    the CPU, a 0-d device tensor on a card).
    """
    cfg = model.cfg
    if dt is None:
        dt = cfg.run.dt
    Tf = freezing_temperature(cfg, f.sss)

    prep = cfg.radiation.prep_radiation
    with timers.span("Shortwave"):
        if prep:
            # coupled ordering (CICE_RunMod.F90 ice_step:164-242): rescale
            # last step's absorbed SW now, run radiation at the end
            sw = _prep_radiation(model, state, f)
        else:
            sw = _step_radiation(model, state, grid, f, yday, sec, dt)
    with timers.span("Thermo"):
        state, fluxes, init = _step_therm1(model, state, grid, f, sw, Tf,
                                           yday, dt)
    with timers.span("CatConv"):
        state, fluxes = _step_therm2(model, state, grid, fluxes, init, Tf,
                                     dt)
    # thermodynamic area/volume tendencies (init_history_therm)
    aice_mid = state.aicen.sum(0)
    vice_mid = state.vicen.sum(0)
    fluxes["daidtt"] = (aice_mid - fluxes["aice_init"]) / dt
    fluxes["dvidtt"] = (vice_mid - fluxes["vice_init"]) / dt
    with timers.span("Dynamics"):
        state, fluxes = _step_dynamics(model, state, grid, f, fluxes, dt)
    # dynamic tendencies (init_history_dyn)
    fluxes["daidtd"] = (state.aicen.sum(0) - aice_mid) / dt
    fluxes["dvidtd"] = (state.vicen.sum(0) - vice_mid) / dt
    if prep:
        with timers.span("Shortwave"):
            sw = _step_radiation(model, state, grid, f, yday, sec, dt)
    with timers.span("Coupling"):
        state, fluxes = _coupling_prep(model, state, grid, f, sw, fluxes,
                                       Tf, dt)
    return state, fluxes
