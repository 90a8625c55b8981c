"""A test entry for a cell on several ranks: the port's `Model` stepped on
this rank's block of a `Mesh` (one block a rank), as
``cice4_tpu_torch.parallel.launch.run_decomposed`` steps it.  Under a
traffic without ``component`` it is the standalone driver's step under
the analytic forcing, one step a call; under one with ``component`` it
is the ACCESS component's coupling interval, as ``IceComponent.run``
runs it: the block's imports folded into the block's coupler boundary,
the model steps, and the block's exports with the GFDL open-water fluxes.

The benchmark's tests copy it to ``benchmark/entries/<name>.py`` of a
checkout, beside a traffic file that names it, to run a cell on two or
four ranks; see ``harness.cell.load_entry`` for what an entry defines.
"""

from __future__ import annotations

import time

import torch


def _mesh():
    from cice4_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    if len(mesh.local_blocks) != 1:
        raise ValueError(f"{mesh} holds more than one block in a rank")
    return mesh


def block(ny: int, nx: int) -> tuple[int, int, int, int]:
    """The rows and columns of the global grid that this rank holds."""
    mesh = _mesh()
    rows, cols = mesh.block_slices(mesh.local_blocks[0], ny, nx)
    return rows.start, rows.stop, cols.start, cols.stop


def Entry(cfg, traffic, **kw):
    """The driver's step, or the component's interval where the traffic
    has a ``component``."""
    return (Coupled if "component" in traffic else Standalone)(cfg, traffic,
                                                               **kw)


class Standalone:
    """The block's model, state and calendar; the forcing is the whole
    grid's, cut to the block each step, its host time (to the card's
    synchronisation) counted as the driver's "Forcing" timer counts it."""

    def __init__(self, cfg, traffic, *, dtype, device, quiet, bank):
        from cice4_tpu_torch.calendar import Calendar
        from cice4_tpu_torch.convert import scatter_blocks
        from cice4_tpu_torch.grid import make_grid
        from cice4_tpu_torch.io.forcing_data import make_forcing_provider
        from cice4_tpu_torch.model import Model
        from cice4_tpu_torch.state import init_state, make_itd_params

        self.mesh = _mesh()
        self.device = torch.device(device)
        grid = make_grid(cfg, device=device, dtype=dtype)
        self.provider = make_forcing_provider(cfg, grid, device=device,
                                              dtype=dtype)
        self.block_grid = scatter_blocks(grid, self.mesh)[0]
        self.model = Model(cfg, self.block_grid)
        self.state = scatter_blocks(init_state(
            cfg, grid, make_itd_params(cfg), device=device, dtype=dtype),
            self.mesh)[0]
        self.calendar = Calendar(dt=cfg.run.dt, year_init=cfg.run.year_init,
                                 days_per_year=cfg.run.days_per_year)
        self.runner = self
        self._forcing_s = 0.0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def model_step(self, forcing):
        """One model step of the block from the calendar's time; the
        step's fluxes."""
        cal = self.calendar
        self.state, fluxes = self.mesh.run(
            lambda b: self.model(self.state, forcing, cal.yday, cal.sec))[0]
        cal.advance()
        return fluxes

    def step(self, k: int):
        from cice4_tpu_torch.convert import scatter_blocks

        cal = self.calendar
        t = time.perf_counter()
        f = scatter_blocks(self.provider(cal.yday, cal.sec, cal=cal),
                           self.mesh)[0]
        self.sync()
        self._forcing_s += time.perf_counter() - t
        self.model_step(f)
        self.sync()

    def context(self):
        return {}

    def forcing_s(self):
        return self._forcing_s


class Coupled(Standalone):
    """The block's coupling interval: the initial boundary forcing is the
    whole grid's at the start, cut to the block; the bank holds the
    block's imports."""

    def __init__(self, cfg, traffic, *, dtype, device, quiet, bank):
        from cice4_tpu_torch.convert import scatter_blocks
        from cice4_tpu_torch.coupling import CouplerBoundary

        super().__init__(cfg, traffic, dtype=dtype, device=device,
                         quiet=quiet, bank=bank)
        c = traffic["component"]
        if c["flavor"] != "om":
            raise ValueError("the test entry couples as ACCESS-OM only")
        cal = self.calendar
        f0 = self.provider(cal.yday, cal.sec, cal=cal)
        self.boundary = CouplerBoundary(
            scatter_blocks(f0, self.mesh)[0], tmask=self.block_grid.tmask,
            gfdl_surface_flux=c["gfdl_surface_flux"])
        self.n_steps = int(c["steps_per_interval"])
        self.bank = bank
        self.exports = None

    def step(self, k: int):
        bnd = self.boundary
        imports = self.bank[k % len(self.bank)]
        bnd.recv_atm(imports["a2i"])
        bnd.recv_ocn(imports["o2i"])
        self.state = bnd.apply_ocean_state(self.state)
        for _ in range(self.n_steps):
            fluxes = self.model_step(bnd.forcing)
        self.exports = {"i2o": bnd.send_ocn(fluxes, self.state),
                        "i2a": bnd.send_atm(fluxes, self.state)}
        self.sync()

    def context(self):
        """The friction velocity of the previous interval, the block's."""
        u = self.boundary.u_star
        return {"u_star": None if u is None else u.detach().clone()}

    def forcing_s(self):
        return None
