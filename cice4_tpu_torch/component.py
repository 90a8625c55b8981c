"""ESMF-style gridded-component wrapper around the model lifecycle.

Port of :mod:`cice4_tpu.component` (``drivers/esmf/CICE_ComponentMod.F90:
58-214``, `CICE_SetServices` registering `CICE_Initialize` / `CICE_Run` /
`CICE_Finalize`, plus the coupled run loops of
``drivers/esmf/CICE_RunMod.F90`` and ``drivers/access-cm/CICE_RunMod.F90``).

The ESMF machinery maps onto plain Python: a component object with
`initialize / run / finalize` methods, import/export *states* as dicts of
named (ny, nx) tensors, and the host's own clock (the component advances
its calendar by `n_steps` model steps per `run` call).  The model runs in
the port's :class:`~cice4_tpu_torch.driver.IceModelRun` on its device
(``cuda`` unless the caller asks for another), and times its Receive,
Step, History and Send regions on the runner's `Timers`.

Two field-set flavors:

- ``flavor="om"``: ACCESS-OM (``drivers/access-om/cpl_interface.F90``):
  10 a2i + 7 o2i in, 15 i2o + 1 i2a out; the model computes its own
  surface fluxes (`calc_Tsfc=T`).
- ``flavor="cm"``: ACCESS-CM (``drivers/access-cm/cpl_interface.F90``):
  the UM supplies per-category top/bottom melt fluxes; the ice runs the
  prescribed-flux thermo (`calc_Tsfc=F`), see
  :mod:`cice4_tpu_torch.coupling_cm`.

On several processes (the ACCESS drivers' one MPI task a block) the
component holds one block of a :class:`~cice4_tpu_torch.parallel.mesh.
Mesh`: given one, or made (:func:`~cice4_tpu_torch.parallel.mesh.
make_mesh`, one block a process) when :func:`~cice4_tpu_torch.parallel.
mesh.init_distributed` finds the process group.  Its grid, state,
boundary forcing, imports and exports are then the block's (ny_b, nx_b)
fields, as the coupler exchanges each task's part; the only
communication of an interval is the model step's neighbour exchanges.
A process that holds several blocks of a mesh runs one component a block,
their intervals together inside ``mesh.run``.
"""

from __future__ import annotations

import torch

from cice4_tpu_torch import coupling, coupling_cm
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.driver import IceModelRun
from cice4_tpu_torch.parallel.mesh import init_distributed, make_mesh


class IceComponent:
    """One coupled ice component (ESMF GridComp equivalent).

    Lifecycle (``CICE_ComponentMod.F90 CICE_SetServices:58-214``)::

        comp = IceComponent(cfg, flavor="om")
        comp.initialize()
        export = comp.run({"a2i": {...}, "o2i": {...}}, n_steps=4)
        comp.finalize()
    """

    def __init__(self, cfg: Config, flavor: str = "om",
                 dtype=torch.float32, log=print,
                 gfdl_surface_flux: bool = False, *, device="cuda",
                 mesh=None, block: int | None = None):
        if flavor not in ("om", "cm"):
            raise ValueError(f"unknown coupling flavor {flavor!r}")
        if flavor == "cm" and cfg.thermo.calc_Tsfc:
            raise ValueError("ACCESS-CM coupling requires "
                             "thermo.calc_Tsfc=False (prescribed-flux "
                             "thermo; cpl_forcing_handler.F90 "
                             "set_sbc_ice:436-519)")
        self.cfg = cfg
        self.flavor = flavor
        self.dtype = dtype
        self.device = torch.device(device)
        # cpl_parameters.F90:54: open-water fluxes from the GFDL
        # Monin-Obukhov package (default .true. in the reference OM)
        self.gfdl_surface_flux = gfdl_surface_flux
        self.log = log
        if mesh is None and init_distributed(device=self.device):
            mesh = make_mesh()
        self.mesh = mesh
        self.block = block
        self.runner: IceModelRun | None = None
        self._boundary = None

    # -- ESMF_SETINIT / SETRUN / SETFINAL dispatch table ---------------------

    def set_services(self) -> dict:
        """Entry-point registry (`CICE_SetServices` analogue)."""
        return {"init": self.initialize, "run": self.run,
                "finalize": self.finalize}

    # -- entry points --------------------------------------------------------

    def initialize(self, state=None):
        """`CICE_Initialize` (``drivers/esmf/CICE_InitMod.F90``): build
        grid/state/model; the initial Forcing comes from the configured
        provider and is then overwritten by coupler imports."""
        self.runner = IceModelRun(self.cfg, dtype=self.dtype, log=self.log,
                                  device=self.device, mesh=self.mesh,
                                  block=self.block).initialize(state=state)
        cal = self.runner.calendar
        with self.runner.timers("Init"):
            f0 = self.runner.forcing_provider(cal.yday, cal.sec, cal=cal,
                                              state=self.runner.state)
            self._boundary = coupling.CouplerBoundary(
                f0, tmask=self.runner.grid.tmask,
                gfdl_surface_flux=self.gfdl_surface_flux)
        self._last_fluxes = None
        return self

    def receive(self, import_state: dict | None):
        """Fold one interval's import state into the boundary forcing and
        the model state (the from_atm/from_ocn half of ``cpl_interface``)."""
        r = self.runner
        bnd = self._boundary
        import_state = import_state or {}
        a2i = import_state.get("a2i")
        o2i = import_state.get("o2i")
        if self.flavor == "om":
            if a2i:
                bnd.recv_atm(a2i)
            if o2i:
                bnd.recv_ocn(o2i)
                r.state = bnd.apply_ocean_state(r.state)
        else:
            if a2i:
                bnd.forcing = coupling_cm.from_atm_cm(
                    bnd.forcing, a2i, r.state.aicen)
            if o2i:
                # iceform melt limit (cpl_forcing_handler.F90 set_sbc_ice
                # MOM section): cap the negative frzmlt
                bnd.forcing, upd = coupling_cm.from_ocn_cm(
                    bnd.forcing, o2i, meltlimit=-1000.0)
                r.state = r.state.replace(**upd)

    def send(self, fluxes) -> dict:
        """The export state of the last step's `fluxes` (the into_ocn /
        into_atm half of ``cpl_interface``)."""
        r, bnd = self.runner, self._boundary
        if self.flavor == "om":
            return {"i2o": bnd.send_ocn(fluxes, r.state),
                    "i2a": bnd.send_atm(fluxes, r.state)}
        return {"i2o": coupling.into_ocn(fluxes, r.state, bnd.forcing),
                "i2a": coupling_cm.into_atm_cm(r.state)}

    def run(self, import_state: dict | None = None,
            n_steps: int = 1) -> dict:
        """`CICE_Run` for one coupling interval: fold the import state
        into the forcing, advance `n_steps` model steps, and return the
        export state (``drivers/esmf/CICE_RunMod.F90 CICE_Run`` + the
        from_atm/from_ocn/into_ocn/into_atm exchange of
        ``cpl_interface.F90``).  On a mesh, the block's interval."""
        return self.runner.on_block(
            lambda: self._interval(import_state, n_steps))

    def _interval(self, import_state, n_steps):
        r = self.runner
        timer = r.timers
        with timer("Receive"):
            self.receive(import_state)
        cal = r.calendar
        fluxes = None
        for _ in range(n_steps):
            with timer("Step"):
                r.state, fluxes = r.model(r.state, self._boundary.forcing,
                                          cal.yday, cal.sec)
            cal.advance()
            with timer("History"):
                r.history.accumulate(r.state, fluxes)
                for p in r.history.write_due(cal):
                    self.log(f"wrote history {p}")
        self._last_fluxes = fluxes
        with timer("Send"):
            return self.send(fluxes)

    def finalize(self):
        """`CICE_Finalize` (``drivers/esmf/CICE_FinalMod.F90``)."""
        return self.runner.finalize()
