"""The reference's entry: its own grid, forcing, calendar and coupler
boundary from the benchmark's inputs, one model step of the standalone
driver and one coupling interval of the ACCESS component.

States cross this boundary as plain dicts of tensors with the port's
field names (``trcrn`` and ``swn`` dicts of their own), so that the
reference shares no type with the program it judges.
"""

from __future__ import annotations

import dataclasses

import torch

from reference import coupling
from reference.calendar import Calendar
from reference.config import Config, config_from_dict
from reference.forcing_data import make_forcing_provider
from reference.model import Model
from reference.ops.restoring import boundary_band_mask, restore_ice
from reference.state import State, init_state

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(State))


def to_state(fields: dict, *, device, dtype) -> State:
    """A reference State from a dict of tensors, floats cast to `dtype`."""
    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        v = v.to(device)
        return v.to(dtype) if v.is_floating_point() else v
    return State(**{k: cast(fields[k]) for k in STATE_FIELDS})


def to_fields(state: State) -> dict:
    return {k: getattr(state, k) for k in STATE_FIELDS}


class Reference:
    """One configuration's plain model on `device`, computed in `dtype`.

    `tree` is the configuration as a nested dict (the benchmark's
    configuration file with the cell's settings over it)."""

    def __init__(self, tree: dict, *, device, dtype=torch.float64):
        cfg: Config = config_from_dict(tree)
        # the in-step guards only raise; the reference's results are what
        # the comparison reads
        self.cfg = cfg.with_values(**{"run.guards": False})
        self.device = torch.device(device)
        self.dtype = dtype
        self.model = Model.create(self.cfg, device=self.device, dtype=dtype)
        self.grid = self.model.grid
        self.provider = make_forcing_provider(self.cfg, self.grid,
                                              device=self.device, dtype=dtype)

    @staticmethod
    def grid_only(tree: dict, *, device, dtype=torch.float64):
        """The configuration's grid alone."""
        from reference.grid import make_grid
        return make_grid(config_from_dict(tree), device=torch.device(device),
                         dtype=dtype)

    def calendar(self, istep: int) -> Calendar:
        run = self.cfg.run
        cal = Calendar(dt=run.dt, year_init=run.year_init,
                       days_per_year=run.days_per_year)
        cal.istep = istep
        cal.time = istep * float(run.dt)
        cal._recompute()
        return cal

    def cold_start(self) -> dict:
        """The driver's initial state: the cold start and, under an ocean
        climatology, its SST of the first month."""
        state = init_state(self.cfg, self.grid, self.model.itd,
                           device=self.device, dtype=self.dtype)
        ocn = getattr(self.provider, "ocn", None)
        if ocn is not None and ocn.available:
            sst0 = ocn.initial_fields(self.calendar(0).month)[2]
            if sst0 is not None:
                state = state.replace(sst=sst0)
        return to_fields(state)

    def steps(self, state: State, forcing, cal: Calendar, n_steps: int,
              bands=None):
        """`n_steps` model steps of `state` under `forcing` from the time
        of `cal`, which advances.  `bands`, where given, runs them in its
        own way (the harness's full-width bands): ``bands(self, state,
        forcing, times)`` with the steps' (yday, sec), returning the new
        state and the last step's fluxes as the whole grid's."""
        if bands is not None:
            times = []
            for _ in range(n_steps):
                times.append((cal.yday, cal.sec))
                cal.advance()
            return bands(self, state, forcing, times)
        fluxes = None
        for _ in range(n_steps):
            state, fluxes = self.model(state, forcing, cal.yday, cal.sec)
            cal.advance()
        return state, fluxes

    def step(self, fields: dict, istep: int, start: dict | None = None,
             bands=None):
        """The standalone driver's step `istep` (0-based) from `fields`:
        the forcing, the ocean update, the model step and the ice
        restoring toward `start`.  Returns (the new state's dict, {"fluxes":
        the step's fluxes, "forcing": its forcing}).  `bands`: see
        :meth:`steps`."""
        dt = float(self.cfg.run.dt)
        cal = self.calendar(istep)
        state = to_state(fields, device=self.device, dtype=self.dtype)
        f = self.provider(cal.yday, cal.sec, cal=cal, state=state)
        state = self.provider.ocean_update(state, cal, dt)
        state, fluxes = self.steps(state, f, cal, 1, bands)
        if self.cfg.forcing.restore_ice:
            ref = to_state(start, device=self.device, dtype=self.dtype)
            state = restore_ice(state, ref, boundary_band_mask(self.grid),
                                dt, float(self.cfg.forcing.trestore))
        return to_fields(state), {"fluxes": fluxes, "forcing": f}

    def interval(self, fields: dict, istep: int, imports: dict, *,
                 flavor: str, gfdl: bool, u_star=None, n_steps: int = 1,
                 start: dict | None = None, bands=None):
        """One coupling interval of the ACCESS component from `fields` at
        step `istep`: the initial boundary forcing, the imports folded in,
        `n_steps` model steps and the exports.  `u_star` is the friction
        velocity carried from the previous interval; `flavor` is ``om``,
        the ACCESS-OM2 exchange (the only one the cells drive).  Returns (state dict,
        exports {"i2o": {...}, "i2a": {...}}, u_star, {"fluxes": the last
        step's fluxes, "forcing": the boundary forcing}).  `bands`: see
        :meth:`steps`."""
        if flavor != "om":
            raise ValueError(f"the reference has no {flavor!r} exchange")
        cal0 = self.calendar(0)
        s0 = None if start is None else to_state(start, device=self.device,
                                                  dtype=self.dtype)
        f0 = self.provider(cal0.yday, cal0.sec, cal=cal0, state=s0)
        bnd = coupling.CouplerBoundary(f0, tmask=self.grid.tmask,
                                       gfdl_surface_flux=gfdl)
        if u_star is not None:
            bnd.u_star = u_star.to(device=self.device, dtype=self.dtype)
        state = to_state(fields, device=self.device, dtype=self.dtype)
        imports = {side: {k: v.to(device=self.device, dtype=self.dtype)
                          for k, v in d.items()}
                   for side, d in imports.items()}
        a2i, o2i = imports.get("a2i"), imports.get("o2i")
        if a2i:
            bnd.recv_atm(a2i)
        if o2i:
            bnd.recv_ocn(o2i)
            state = bnd.apply_ocean_state(state)
        state, fluxes = self.steps(state, bnd.forcing, self.calendar(istep),
                                   n_steps, bands)
        exports = {"i2o": bnd.send_ocn(fluxes, state),
                   "i2a": bnd.send_atm(fluxes, state)}
        return to_fields(state), exports, bnd.u_star, {
            "fluxes": fluxes, "forcing": bnd.forcing}
