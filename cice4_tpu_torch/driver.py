"""Model lifecycle driver: initialize / run / finalize.

Port of :mod:`cice4_tpu.driver` (the standalone driver
``drivers/cice4/CICE.F90:64-94`` + ``CICE_InitMod.F90 cice_init:124-199``
+ ``CICE_RunMod.F90 CICE_Run:94-146``): builds the model (grid included),
state and forcing on a device, owns the model clock, steps `Model.forward`
eagerly (the JAX package jits its step), emits diagnostics every
`diagfreq` steps, accumulates history means, and writes restart dumps on
`dumpfreq`, each under CICE's timer of its name (:mod:`timers`: Init,
Forcing, Step, History, Diags, ReadWrite; the step's phases below Step).
A run with ``run.runtype="continue"`` resumes from the restart the
pointer file names, which may come from either package.  With an ocean
climatology the initial SST is the climatology's.

Given a `mesh` (:mod:`cice4_tpu_torch.parallel.mesh`) a run holds one
block of it: the block's grid (:func:`cice4_tpu_torch.convert.
block_grid`: no whole-grid field reaches the device), state and forcing,
stepped inside :meth:`~cice4_tpu_torch.parallel.mesh.Mesh.run` where the
calling thread is not running the block already (:meth:`IceModelRun.
on_block`).  Its guard records are the block's, so the block that holds a
violation raises.  Restarts and ice restoring are not written for a
block.
"""

from __future__ import annotations

import os
import time as _time

import torch

from cice4_tpu_torch.calendar import Calendar
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.diagnostics import (find_points, format_diags,
                                         format_points, init_mass_diags,
                                         point_diags, runtime_diags)
from cice4_tpu_torch.guards import raise_on_violation
from cice4_tpu_torch.io.forcing_data import make_forcing_provider
from cice4_tpu_torch.io.history import History
from cice4_tpu_torch.io.restart import dump_restart, load_restart, read_pointer
from cice4_tpu_torch.model import Model
from cice4_tpu_torch.parallel.mesh import current_block
from cice4_tpu_torch.state import State, init_state
from cice4_tpu_torch.timers import Timers


class IceModelRun:
    """One configured model run on one device (the
    `CICE_Initialize/Run/Finalize` 3-call lifecycle,
    ``drivers/cice4/CICE.F90:80-92``)."""

    def __init__(self, cfg: Config, dtype=torch.float32, log=print, *,
                 device="cuda", mesh=None, block: int | None = None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.mesh = mesh
        self.block = None
        if mesh is not None:
            if block is None:
                if len(mesh.local_blocks) != 1:
                    raise ValueError(f"{mesh} holds several blocks in this "
                                     f"process: give the run's block")
                block = mesh.local_blocks[0]
            if block not in mesh.local_blocks:
                raise ValueError(f"block {block} is not one of {mesh}'s")
            if cfg.forcing.restore_ice or cfg.run.runtype == "continue":
                raise NotImplementedError(
                    "ice restoring and restarts of a run on one block of a "
                    "mesh (parallel.launch writes sharded restarts)")
            self.block = block
        self.log = log
        self.timers = Timers(self.device)
        self.grid = None
        self.state: State | None = None
        self.model: Model | None = None
        self.calendar: Calendar | None = None
        self._restore = None
        self._pending_guards = None
        self.history = None

    # -- initialize ---------------------------------------------------------

    def initialize(self, state: State | None = None):
        cfg = self.cfg
        dev, dtype = self.device, self.dtype
        with self.timers("Init"):
            if self.mesh is None:
                self.model = Model.create(cfg, device=dev, dtype=dtype)
            else:
                from cice4_tpu_torch.convert import block_grid
                self.model = Model(cfg, block_grid(
                    cfg, self.mesh, self.block, device=dev, dtype=dtype))
            self.grid = self.model.grid
            self.calendar = Calendar(dt=cfg.run.dt,
                                     year_init=cfg.run.year_init,
                                     days_per_year=cfg.run.days_per_year)
            self.forcing_provider = make_forcing_provider(
                cfg, self.grid, device=dev, dtype=dtype)
            if state is not None:
                self.state = state
            elif cfg.run.runtype == "continue":
                path = read_pointer(cfg.run.pointer_file)
                template = init_state(cfg, self.grid, self.model.itd,
                                      device=dev, dtype=dtype)
                self.state, header = load_restart(path, template)
                self.calendar.istep = header["istep"]
                self.calendar.time = header["time"]
                self.calendar._recompute()
                self.log(f"restarted from {path} @ step {header['istep']}")
            else:
                self.state = init_state(cfg, self.grid, self.model.itd,
                                        device=dev, dtype=dtype)
            self._points = (find_points(self.grid, cfg.run.latpnt_lonpnt)
                            if cfg.run.print_points else None)
            # initial ocean fields from climatology (init_forcing_ocn)
            ocn = getattr(self.forcing_provider, "ocn", None)
            if ocn is not None and ocn.available \
                    and cfg.run.runtype != "continue" and state is None:
                _sss0, _tf0, sst0 = ocn.initial_fields(self.calendar.month)
                if sst0 is not None:
                    self.state = self.state.replace(sst=sst0)
            # regional ice restoring toward the initial state
            # (ice_restoring.F90; restore_ice flag)
            self._restore = None
            if cfg.forcing.restore_ice:
                from cice4_tpu_torch.ops.restoring import (boundary_band_mask,
                                                           restore_ice)
                band = boundary_band_mask(self.grid)
                ref_state = self.state
                trest = float(cfg.forcing.trestore)
                self._restore = lambda s: restore_ice(s, ref_state, band,
                                                      cfg.run.dt, trest)
            self.history = History(
                self.grid, histfreq=cfg.run.histfreq,
                histfreq_n=cfg.run.histfreq_n, avg=cfg.run.hist_avg,
                directory=cfg.run.history_dir, itd=self.model.itd,
                fmt=cfg.run.history_format)
        return self

    # -- run ----------------------------------------------------------------

    def on_block(self, fn):
        """`fn()` on this run's block of its mesh: inside `Mesh.run`, or
        directly where the calling thread runs the block already (a
        process of several blocks steps them together in `Mesh.run`);
        `fn()` itself without a mesh."""
        if self.mesh is None:
            return fn()
        cur = current_block()
        if cur is not None:
            if cur != (self.mesh, self.block):
                raise RuntimeError(f"block {self.block} of {self.mesh} "
                                   f"stepped from block {cur[1]}'s thread")
            return fn()
        if self.mesh.local_blocks != (self.block,):
            raise RuntimeError(f"{self.mesh} holds several blocks in this "
                               f"process: step them together in Mesh.run")
        return self.mesh.run(lambda _b: fn())[0]

    def step_model(self, state, forcing, yday, sec):
        """One model step of the run's state (of its block on a mesh)."""
        return self.on_block(lambda: self.model(state, forcing, yday, sec))

    def run(self, npt: int | None = None, on_diag=None):
        """Run npt steps (default cfg.run.npt).

        on_diag: optional callback ``(istep, diags: dict) -> None``
        invoked at every diagnostic interval with the structured
        runtime_diags values, the hook for harnesses that collect
        trajectories instead of re-implementing this loop.
        """
        cfg = self.cfg
        cal = self.calendar
        dt = float(cfg.run.dt)
        npt = npt if npt is not None else cfg.run.npt
        t_wall0 = _time.time()
        for _ in range(npt):
            diag_step = (cfg.run.diagfreq
                         and (cal.istep + 1) % cfg.run.diagfreq == 0)
            with self.timers("Forcing"):
                with self.timers("Read"):
                    f = self.forcing_provider(cal.yday, cal.sec, cal=cal,
                                              state=self.state)
                with self.timers("Ocean"):
                    self.state = self.forcing_provider.ocean_update(
                        self.state, cal, dt)
            if diag_step:
                # start-of-step totals for the budget-closure errors
                # (init_mass_diags, ice_diagnostics.F90:853-927)
                with self.timers("Diags"):
                    init_diag = self.on_block(
                        lambda: init_mass_diags(self.state, self.grid))
            with self.timers("Step"):
                self.state, fluxes = self.step_model(self.state, f,
                                                     cal.yday, cal.sec)
                # abort-with-coordinates (guards.py): inspect the PREVIOUS
                # step's violation records, then queue this step's
                if self._pending_guards:
                    raise_on_violation(self._pending_guards)
                self._pending_guards = fluxes.pop("_guards", None)
                if self._restore is not None:
                    self.state = self._restore(self.state)
            cal.advance()
            with self.timers("History"):
                self.history.accumulate(self.state, fluxes, forcing=f,
                                        yday=cal.yday, dt=dt)
                for p in self.history.write_due(cal):
                    self.log(f"wrote history {p}")
            if diag_step:
                with self.timers("Diags"):
                    d = self.on_block(lambda: runtime_diags(
                        self.state, self.grid, fluxes=fluxes, forcing=f,
                        init_diag=init_diag, dt=dt,
                        update_ocn_f=bool(cfg.thermo.update_ocn_f),
                        calc_Tsfc=bool(cfg.thermo.calc_Tsfc)))
                    self.log(format_diags(cal.istep, d))
                    if on_diag is not None:
                        on_diag(cal.istep,
                                {k: float(v) for k, v in d.items()})
                    if self._points:
                        pd = point_diags(self.state, self.grid, fluxes,
                                         f, dt, self._points)
                        self.log(format_points(pd))
            if cal.write_flag(cfg.run.dumpfreq, cfg.run.dumpfreq_n):
                with self.timers("ReadWrite"):
                    self.write_restart()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._pending_guards:
            raise_on_violation(self._pending_guards)
            self._pending_guards = None
        wall = _time.time() - t_wall0
        self.log(f"ran {npt} steps in {wall:.2f} s "
                 f"({npt * self.grid.nx * self.grid.ny / max(wall, 1e-9):.3e}"
                 " cell-steps/s)")
        return self.state

    # -- finalize -----------------------------------------------------------

    def write_restart(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "a restart of a run on one block of a mesh (parallel.launch "
                "writes sharded restarts)")
        cfg = self.cfg
        cal = self.calendar
        path = os.path.join(cfg.run.restart_dir,
                            f"iced.{cal.idate}.{int(cal.sec):05d}.npz")
        dump_restart(self.state, path, cal.istep, cal.time,
                     pointer_file=cfg.run.pointer_file)
        self.log(f"wrote restart {path}")
        return path

    def finalize(self):
        self.log(self.timers.report())
        return self.timers
