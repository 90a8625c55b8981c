"""Coupled-model boundary interface (ACCESS-OM / ACCESS-CM field sets).

Port of :mod:`cice4_tpu.coupling`, the pure-function equivalent of the
OASIS/PRISM coupling layer (``drivers/access-om/cpl_interface.F90``):
`from_atm:433-511` / `from_ocn:514-576` map received coupler fields into
the model :class:`~reference.forcing.Forcing`; `into_ocn:579-675` /
`into_atm:678-730` assemble the outgoing field sets from the step's flux
output.  The transport itself (OASIS `prism_get/put`) belongs to the host:
a coupler exchanges plain (ny, nx) tensors through these adapters.

Field sets match ``cpl_parameters.F90:8-14``: 10 a2i + 7 o2i in,
1 i2a + 15 i2o out.  As in the JAX package, `Forcing` has no surface
pressure or runoff field, so `press_i` and `runof_i` are not taken in,
the GFDL fluxes use 1.013e5 Pa and `press_io`/`runof_io` go out as zeros.
"""

from __future__ import annotations

import torch

from reference import constants as cn
from reference.forcing import Forcing
from reference.forcing_data import split_shortwave

# symbolic field names (cpl_interface.F90:289-333)
A2I_FIELDS = ("swfld_i", "lwfld_i", "rain_i", "snow_i", "press_i",
              "runof_i", "tair_i", "qair_i", "uwnd_i", "vwnd_i")
O2I_FIELDS = ("sst_i", "sss_i", "ssu_i", "ssv_i", "sslx_i", "ssly_i",
              "pfmice_i")
I2A_FIELDS = ("isst_ia",)
I2O_FIELDS = ("strsu_io", "strsv_io", "rain_io", "snow_io", "stflx_io",
              "htflx_io", "swflx_io", "qflux_io", "shflx_io", "lwflx_io",
              "runof_io", "press_io", "aice_io", "melt_io", "form_io")


def from_atm(forcing: Forcing, a2i: dict) -> Forcing:
    """Fold received atmosphere fields into the Forcing
    (``from_atm:433-511`` + `prepare_forcing_from_oasis` derived
    fields)."""
    Tair = a2i["tair_i"]
    swvdr, swvdf, swidr, swidf = split_shortwave(a2i["swfld_i"])
    uatm = a2i["uwnd_i"]
    vatm = a2i["vwnd_i"]
    return forcing.replace(
        Tair=Tair, potT=Tair, Qa=a2i["qair_i"],
        flw=a2i["lwfld_i"], uatm=uatm, vatm=vatm,
        wind=torch.sqrt(uatm**2 + vatm**2),
        swvdr=swvdr, swvdf=swvdf, swidr=swidr, swidf=swidf,
        fsnow=a2i["snow_i"], frain=a2i["rain_i"],
    )


def from_ocn(forcing: Forcing, o2i: dict) -> tuple[Forcing, dict]:
    """Fold received ocean fields into the Forcing
    (``from_ocn:514-576``).  Returns (forcing, state_updates) where
    state_updates carries sst/frzmlt to place into the model state."""
    forcing = forcing.replace(
        sss=o2i["sss_i"], uocn=o2i["ssu_i"], vocn=o2i["ssv_i"],
        ss_tltx=o2i["sslx_i"], ss_tlty=o2i["ssly_i"],
    )
    return forcing, dict(sst=o2i["sst_i"], frzmlt=o2i["pfmice_i"])


def gfdl_open_water_fluxes(state, forcing: Forcing, tmask,
                           u_star_prev=None):
    """Open-water atmosphere fluxes via the GFDL Monin-Obukhov bulk
    package (``cpl_forcing_handler.F90 gfdl_ocean_fluxes:925-1056``;
    enabled by default in the reference, ``cpl_parameters.F90:54``).

    u_star_prev: previous coupling interval's friction velocity (the
    roughness inputs lag one interval, as the reference notes at
    ":984-989"; restart-carried there).  Returns the dict of sign-flipped
    ocean fluxes + the new u_star to carry forward.
    """
    from reference.ops.gfdl_flux import gfdl_ocean_fluxes
    if u_star_prev is None:
        u_star_prev = torch.full_like(state.sst, 0.1)
    press = getattr(forcing, "press", None)
    if press is None:
        press = torch.full_like(state.sst, 1.013e5)
    return gfdl_ocean_fluxes(
        tair=forcing.Tair, qair=forcing.Qa,
        uwnd=forcing.uatm, vwnd=forcing.vatm,
        press=press, sst=state.sst,
        ssu=forcing.uocn, ssv=forcing.vocn,
        u_star_prev=u_star_prev, tmask=tmask)


def into_ocn(fluxes: dict, state, forcing: Forcing,
             gfdl: dict | None = None) -> dict:
    """Assemble the ice->ocean field set (``get_i2o_fluxes``, the merge
    at ``cpl_forcing_handler.F90:689-780``): open-water atmosphere fluxes
    weighted by (1-aice) merged with under-ice fluxes (already
    category-weighted by merge_fluxes), stresses sign-flipped for the
    ocean (the ":724 BUG found here" sign), salt/heat/SW pass-through.

    gfdl: optional dict from :func:`gfdl_open_water_fluxes`; when given,
    the open-water sensible/latent/longwave/stress come from the GFDL bulk
    scheme as `gfdl_surface_flux=.true.` does.  Its fields are already in
    the merge's convention (``gfdl_ocean_fluxes`` overwrites fsens_ocn and
    the rest with the flipped values), so they are not negated again.
    """
    aice = fluxes.get("aice")
    if aice is None:
        aice = state.aicen.sum(0)
    ow = 1.0 - aice
    zero = torch.zeros_like(aice)
    if gfdl is not None:
        fsens_ocn, flat_ocn = gfdl["sh"], gfdl["lh"]
        flwout_ocn = gfdl["lwo"]
        strairx_ocn, strairy_ocn = gfdl["taox"], gfdl["taoy"]
    else:
        fsens_ocn = fluxes.get("fsens_ocn", zero)
        flat_ocn = fluxes.get("flat_ocn", zero)
        flwout_ocn = fluxes.get("flwout_ocn", zero)
        strairx_ocn = fluxes.get("strairx_ocn", zero)
        strairy_ocn = fluxes.get("strairy_ocn", zero)
    swabs_ocn = fluxes.get("swabs_ocn", zero)
    flw = forcing.flw if forcing.flw is not None else zero
    runof = getattr(forcing, "runof", None)
    press = getattr(forcing, "press", None)
    return {
        # 1/2) interface stress: open-water air stress + (sign-flipped)
        # ice-ocean stress (":722-726")
        "strsu_io": strairx_ocn * ow - state.strocnxT * aice,
        "strsv_io": strairy_ocn * ow - state.strocnyT * aice,
        "rain_io": forcing.frain * ow,
        "snow_io": forcing.fsnow * ow,
        "stflx_io": fluxes["fsalt"],
        "htflx_io": fluxes["fhocn"],
        # 7) SW: open-water absorbed + penetrating through ice (":744")
        "swflx_io": swabs_ocn * ow + fluxes["fswthru"],
        # 8/9) latent/sensible, positive OUT of ocean (":746-752")
        "qflux_io": -flat_ocn * ow,
        "shflx_io": -fsens_ocn * ow,
        # 10) net LW into ocean (":754")
        "lwflx_io": (flw + flwout_ocn) * ow,
        "runof_io": runof if runof is not None else zero,
        # 12) pressure anomaly: the reference sends tiopress = press -
        # 1.0e5 (cpl_forcing_handler.F90 get_i2o pressure block)
        "press_io": press - 1.0e5 if press is not None else zero,
        "aice_io": aice,
        "melt_io": fluxes["fresh"],
        "form_io": fluxes.get("frazil", zero),
    }


def into_atm(fluxes: dict, state) -> dict:
    """Assemble the ice->atm field set (``into_atm:678-730``)."""
    return {"isst_ia": state.sst + cn.Tffresh}


class CouplerBoundary:
    """Stateful wrapper for a coupled run: holds the latest received
    fields and exposes the 4 exchange calls with the reference call
    pattern (`CICE_RunMod.F90:106-340` coupled loop).

    gfdl_surface_flux mirrors ``cpl_parameters.F90:54`` (default True
    there): open-water sh/lh/lw/stress for the ocean come from the GFDL
    Monin-Obukhov package, with u_star carried between coupling intervals
    (the reference saves it to the restart)."""

    def __init__(self, forcing: Forcing, tmask=None,
                 gfdl_surface_flux: bool = False):
        self.forcing = forcing
        self.state_updates: dict = {}
        self.gfdl_surface_flux = gfdl_surface_flux
        self.tmask = tmask
        self.u_star = None

    def recv_atm(self, a2i: dict):
        self.forcing = from_atm(self.forcing, a2i)

    def recv_ocn(self, o2i: dict):
        self.forcing, self.state_updates = from_ocn(self.forcing, o2i)

    def apply_ocean_state(self, state):
        if self.state_updates:
            state = state.replace(**self.state_updates)
            self.state_updates = {}
        return state

    def send_ocn(self, fluxes, state):
        gfdl = None
        if self.gfdl_surface_flux:
            tmask = self.tmask if self.tmask is not None \
                else torch.ones_like(state.sst, dtype=torch.bool)
            gfdl = gfdl_open_water_fluxes(state, self.forcing, tmask,
                                          self.u_star)
            self.u_star = gfdl["u_star"]
        return into_ocn(fluxes, state, self.forcing, gfdl=gfdl)

    def send_atm(self, fluxes, state):
        return into_atm(fluxes, state)
