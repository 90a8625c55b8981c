"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths and checks its hand-written kernels, one for
each TPU kernel of the JAX package and three that replace none, against
their plain PyTorch versions:

* ``therm_newton`` (``csrc/therm_newton.cu``), the Newton temperature
  solve;
* ``evp_subcycle`` (``csrc/evp_subcycle.cu``), the EVP subcycle loop on
  grids closed or open north-south, and ``evp_wholegrid``, the same
  kernel with its NS-cyclic wrap (the TPU's whole-grid kernel);
* ``remap_gsh`` (``csrc/remap_gsh.cu``), the remap geometry, one fused
  tile kernel in GSH mode (back-shifted) and in GA mode (the split
  route's K0);
* ``remap_k12`` (``csrc/remap_k12.cu``), the reconstruction and
  contraction of the default route;
* ``remap_construct`` and ``remap_contract`` (``csrc/remap_k1k2.cu``),
  K1 and K2 of the split route;
* ``evp_rounds`` (``csrc/evp_rounds.cu``), the k-halo rounds of a
  decomposed grid: k gated subcycles and no final one on a padded block,
  doubly cyclic, tile by tile with k-wide aprons in shared memory (the
  whole-grid TPU kernel's function on the padded block);
* ``ridge_column`` and ``cleanup_column`` (``csrc/ridge_column.cu``), the
  whole ridging loop and the ITD cleanup, a thread a column (the JAX
  package keeps both in plain ``jnp``).  Every path runs ridging and both
  cleanups (after the thermodynamics and after ridging) each step, so
  every path's counts expect ridge_column once and cleanup_column twice a
  step (a block's on a decomposed grid);
* ``gfdl_column`` (``csrc/gfdl_column.cu``), the coupler's GFDL open-water
  fluxes, a thread a cell (the JAX package leaves them to XLA): once a
  coupling interval on the ACCESS-OM component's path (m), never on
  another path.

The paths: the default gx1 step (``gx1_config()`` on the spherical
lat-lon grid without a land-mask file, f32, 320x384, 5 categories, 4 ice
+ 1 snow layers, EVP with 120 subcycles, remap of order 2), the earlier
thermodynamics-only path, and the doubly-periodic box (``Config()`` on
the all-ocean 10 km grid, cyclic on both axes, 384x320, southern row at
55N, analytic forcing, the rest at its defaults) run through the driver
``IceModelRun`` on both remap routes and through the CLI, and ACCESS-OM2
on its tripole grid (``access_om_config``: the lat-lon grid folded at its
top row, at 0.25 degree, 1440x1080, and at 1 degree, 360x300), and gx1
under the column options of ROADMAP 1.4: delta-Eddington shortwave with
the melt-pond tracer (from ``kernel_check.ponded_state``: the analytic
forcing grows no pond), and the coupled radiation order with constant
albedos, ``atmbndy='constant'`` and ``kitd=0``; and gx1 under the rest of
ROADMAP 1.4: the transport options (the departure-point midpoint with the
conservation and monotonicity checks, the fixed-area remap, upwind
transport), the thermo options (no heat capacity, ``calc_Tsfc=False``,
both) and grids read from files (POP binary and netCDF, pan-Arctic); and
gx1 under forcing files (NCAR with the ocean climatology, the monthly
dataset's prescribed stress) through ``IceModelRun``, and the coupled
component ``IceComponent`` in its ACCESS-OM (with the GFDL open-water
fluxes, at 0.25 degree) and ACCESS-CM (``calc_Tsfc=False``, at 1 degree)
flavors.  On the
box the grid masks the top row of U points, so no velocity crosses the NS
seam: the EVP kernel's NS wrap reads only masked zeros there, and only
the kernel-vs-plain checks of phase 3 hold that wrap against nonzero
neighbours; remap's reconstruction does read across the seam.  The
ACCESS grid's top row is land, so its fold carries zeros; phase 3 and
the parity of phase 10 hold the folds on the all-ocean grid, where ice
and stresses reach the top row.

Phases, each of which ends the run with a non-zero exit on failure:

1. device: a CUDA device must be present (there is no CPU fallback);
2. build: compile the kernel libraries from the sources in the
   checkout, one nvcc each, all started together;
3. kernels vs plain versions on the card, f32 and f64, with the
   tolerances of ``kernel_check``: therm_newton at (5, 384, 320) and
   (5, 116, 100), and at the layer counts (7, 1), (2, 1) and (4, 2) of
   other register instances and (9, 1), (10, 1), (16, 2) and (32, 3) of
   its generic instance (layer counts at run time) on the smaller, where
   the generic instance is also held against the register one at
   (4, 1); the dynamics kernels at 384x320 and 116x100 with ice-free
   bands, EW cyclic and closed, NS closed, open and cyclic (the round
   kernel on the doubly cyclic grids, rounds of 10 and 9), and
   the tripole and tripoleT folds on the all-ocean grid (remap_gsh at
   quadrature orders 1-3), where the split route's kernels must refuse
   the fold;
4. gx1 main path: 12 one-hour steps with the analytic forcing; each of
   the four kernels of the default route launches once per step and no
   plain version runs; no conservation guard fires; the state is finite, 0 <= aice <= 1, with
   ice north of 70N and south of 60S and 0 < max|u| < 2 m/s;
5. earlier path: 4 thermodynamics-only steps, therm_newton once per step
   and no dynamics kernel;
6. box path: ``IceModelRun`` 24 steps from day 80 with a daily history
   stream, a daily restart and diagnostics every 24 steps: therm_newton,
   evp_subcycle on the NS-cyclic grid, remap_gsh and remap_k12 once per
   step; the history file is read back; a second run continues from the
   restart and its step 25 equals the first run's bit for bit;
7. split route: 4 box steps with ``CICE4_FORCE_PALLAS_REMAP=1``: K0 in GA
   mode, K1 and K2 once per step and neither GSH mode nor K12; the state
   agrees with the default route's within 1e-5 of each field's scale;
8. CLI: ``python -m cice4_tpu_torch run`` on a 48x64 box, 2 steps;
9. ACCESS-OM2 on its tripole grid, f32: at 1440x1080, 4 steps with each
   of the four kernels of the default route once a step and no plain
   version, physical state; the EVP launch's active cells and grid
   barriers, ms/step by CUDA events, device time by phase, and each
   kernel held against its plain version at this grid's inputs and timed;
   at 360x300 the same steps, ms/step and device time;
10. dEdd path: gx1 at 320x384, f32, delta-Eddington shortwave and melt
    ponds from the ponded state, 12 steps from day 80 (the analytic
    forcing's shortwave and the orbital sun agree near the equinoxes):
    each of the four kernels of the default route once a step and no
    plain version, physical state, pond volume >= 0 and > 0 somewhere,
    and at the last state per category albedos in [0, 1], the shortwave
    closing within ``CLOSURE_RTOL`` of the incoming over sunlit ice,
    snow-layer absorption and ponded cells; ms/step, device time and
    launches by phase (radiation apart), and each kernel held against its
    plain version at this path's inputs and timed;
11. coupled path: gx1, f32, the coupled order with constant albedos,
    ``atmbndy='constant'`` and ``kitd=0``, 4 steps with the counters;
12. transport options at gx1, f32, 8 steps a path, each with its launches
    and no plain version, physical state, ms/step and device time by
    phase: (a) ``l_dp_midpt`` with the conservation and monotonicity
    checks (the four kernels of the default route once a step, the
    transport guard records clean each step, the largest relative change
    of a global sum logged), remap_gsh and remap_k12 held against their
    plain versions at its inputs; (b) ``l_fixed_area`` (therm_newton,
    evp_subcycle and remap_k12 once a step, remap_gsh never: the
    area-matched geometry is plain PyTorch, as the JAX package computes
    it under XLA), the fixed-area property logged, remap_k12 held against
    its plain version at its inputs; (c) upwind transport (therm_newton
    and evp_subcycle, no remap kernel); (d) 2 box steps on the split
    route with ``l_dp_midpt`` (K0 in GA mode, K1 and K2 once a step);
13. thermo and grid variants at gx1, f32, 4 steps each with its launches
    and no plain version, ms/step and device time by phase: (e)
    ``heat_capacity=False``, (f) ``calc_Tsfc=False`` with the explicit
    surface scheme, (g) both (evp_subcycle, remap_gsh and remap_k12 once a
    step, therm_newton never; the solve's iterations, its host syncs,
    logged by step); (h) a POP binary grid and (i) the same as netCDF,
    written here from the gx1 lat-lon metrics with a KMT whose first and
    last rows and an Arctic block are land, each read back equal to the
    grid built in memory within 1e-12 (f64) and driven with the four
    kernels of the default route; (j) a pan-Arctic grid file (8 km cells
    from 60N, its land mask inside, open edges) through ``IceModelRun``
    with ice restoring, the four kernels once a step;
14. file forcing at gx1, f32, through ``IceModelRun`` from 1 January
    1997 under seeded files written into a temporary directory in the
    reference's layout (``kernel_check.write_forcing_files``), 8 steps a
    path with the counters (the four kernels of the default route once a
    step, no plain version), the files found (``available``), a physical
    state: (k) the NCAR bulk files with the ocean climatology and SST
    restoring (the initial SST the climatology's), (l) the monthly files
    with ``calc_strair=False`` (the stress the EVP reads is the file's,
    rotated, bit for bit, each step; the pack ice, covering half of its
    cell or more, below 2 m/s, as the unweighted stress lets marginal ice
    drift freely); each with ms/step by CUDA events, the synchronising
    operations of a step (``torch.cuda.set_sync_debug_mode``), device time
    by phase with the forcing beside it, and each kernel held against its
    plain version at its inputs;
15. the coupled component, f32, 3 coupling intervals of 2 steps from
    seeded imports (``kernel_check.coupler_fields``): (m) ACCESS-OM on its
    0.25 degree tripole grid (1440x1080, dt 1350 s) with the GFDL
    open-water fluxes (the four kernels once a step; every export finite,
    aice_io in [0, 1]; u_star > 0 on ocean cells and carried to the next
    interval; its sidecar read back equal; ``regrid_runoff`` on the
    tripole mask against its CPU result, f64), (n) ACCESS-CM at 1 degree
    with ``calc_Tsfc=False`` and the UM's stress (all kernels but
    therm_newton; the prescribed stress in the EVP each step); each with
    ms/step, synchronising operations, device time by phase with the
    coupler's exchange beside it, and each kernel held against its plain
    version at its inputs;
16. the decomposed model (``parallel/``, ``ops/evp_sharded.py``), f32:
    (o) gx1 at 320x384 on 2x2 blocks of 192x160 in one process (one
    thread a block), 3 steps with the counters (a block's step launches
    therm_newton, remap_gsh and remap_k12 once, the round kernel once in
    each of its 12 k-halo rounds and the EVP kernel once for the final
    subcycle, and no plain version; no phase is gathered), each step's
    state held against the one-device step's within
    ``kernel_check.DECOMP_RTOL`` (and whether it is bit-equal logged),
    then ms/step and the device time and launches of a step beside the
    one-device step's, the EVP's share apart (the rounds' and the final
    subcycle's, beside the 2.9223 ms in 52 launches the EVP took a step
    before the round kernel, PERF.md section 6), and the round
    kernel held against its plain version at (o)'s first round and timed
    there with its tile, recompute share, registers and launches; (p)
    ACCESS-OM2 at 360x300 on 2x2 blocks, 2 steps: the U-fold exchanged
    into the EVP rounds and the remap (the northern blocks remap the
    fold's 12-row strip once more), no phase gathered, against one device; (q) ``python -m
    cice4_tpu_torch.parallel.launch`` as 2 processes over gloo (1x2
    blocks, the strips staged through pinned host buffers), 2 gx1 steps,
    the gathered state against the one-device steps and the sharded
    restart read back, then as 1 process over nccl (one block), bit-equal
    to one device; (r) 24x32 f64 cuts (gx1, the all-ocean U-fold) on 2x2
    blocks, the card against the CPU after 3 steps;
17. small parity: 24x32 f64 cuts of the gx1 path, of the box, of the
   box with a U-fold (all with the damped EVP, as the tier-1 tests run
   it), of the two gx1 option paths of phases 10 and 11, of the three
   whole-step option sets of tier-1 (the four remap options; upwind
   without heat capacity; ``calc_Tsfc=False``) and of paths (k)-(n)
   (through ``IceModelRun`` or ``IceComponent``, the exports compared
   too) on the card agree with the CPU path (which the tier-1 tests hold
   against the JAX package) after 3 steps (2 intervals of 2);
18. deep column: gx1 at 320x384, f32, ``domain.nilyr=10`` (one snow
    layer: a deeper snow fails at the first step in both packages), 4
    steps: therm_newton's generic instance, evp_subcycle, remap_gsh and
    remap_k12 once a step, no plain version, the state physical as in
    phase 4; therm_newton against its plain version at this path's inputs
    and timed beside its bound; the generic instance's registers, local
    bytes and warps an SM as the runtime reports them at (10, 1) and
    (4, 1), and its time at (4, 1) beside the register instance's;
19. bench: ``python -m cice4_tpu_torch bench`` in a process of its own
    with ``BENCH_CONFIG=gx1`` and with ``BENCH_CONFIG=access025``: the
    last line of its stdout is one JSON object with the JAX bench's four
    keys, value > 0 and vs_baseline = value / 3.55e4; its stderr shows each
    of the four default-route kernels launched once in each timed step (a
    wrapper given a CUDA tensor launches its kernel or raises, so no plain
    version ran); both lines and the diagnostics are logged;
20. timing: ms/step and cell-steps/s of the gx1 and box paths, device
    time by phase (the box also on the split remap route), and each
    kernel against its plain version at the inputs its path gives it,
    beside the least time the card could take;
    each kernel's max |kernel - plain| there must lie within its
    ``kernel_check`` tolerance of the field's scale.  Logged: the EVP
    kernel's grid, grid barriers and active cells as its launch reports
    them, its time on the same grid without ice (ndte and 1), the tiles,
    shared memory and resident blocks of K0, K12, K1 and K2 as their
    libraries report them, K0's share of halo moments computed again,
    K2's bound with and without the gathered parents an earlier design
    read, what binds K0, K1 and K2 (a PyTorch copy of as many bytes, their
    operation rate, for K1 and K2 their time without tracers), the ptxas
    lines of the EVP kernel, K0 (f32 and f64), K12, K1 and K2, therm_newton
    at (7, 1) and its generic instance at (4, 1) beside the register (4, 1)
    on seeded inputs, and whether a CUDA graph can capture the EVP kernel's
    cooperative launch;
The column kernels are held against their plain versions
(``kernel_check.compare_columns``, which leaves out the volume tracers of
categories holding less than puny of ice, and counts those that differ) at
the gx1 path's inputs (phase 20) and ACCESS-OM2's (phase 9), each with its
bound by bytes (``kernel_check.column_bytes`` over 3.35 TB/s), ridging's
passes and its launch timed without the wrapper's reductions; phase 10
runs the dEdd path with the level-ice tracers on the column kernels and,
from the same state, on their plain versions, and logs by field how far
the two runs part after each step, and how many tracer elements the
kernel's ridging left apart from the plain version's within the step.

The last three lines of standard output are the kernels' JSON record,
the card's name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

NSTEPS = 24
MAIN_STEPS = 12
THERMO_STEPS = 4
SPLIT_STEPS = 4
CLI_STEPS = 2
DT = 3600.0
YDAY0 = 80.0
MAIN = {"grid.kmt_file": ""}
THERMO_ONLY = {"grid.kmt_file": "", "dynamics.kdyn": 0,
               "transport.advection": "none"}
SMALL = {"domain.ny_global": 24, "domain.nx_global": 32}
# the doubly-periodic box: Config() on the all-ocean uniform grid, cyclic
# on both axes, 10 km cells from 55N, analytic forcing, the rest at its
# defaults
BOX = {"domain.ny_global": 384, "domain.nx_global": 320,
       "domain.ew_boundary_type": "cyclic",
       "domain.ns_boundary_type": "cyclic", "grid.grid_type": "column",
       "grid.lat_origin": 55.0, "grid.dx_rect": 10.0e3,
       "grid.dy_rect": 10.0e3, "forcing.atm_data_type": "analytic"}
# the box cut for the card-vs-CPU parity, damped as in the tier-1 tests:
# undamped, one ulp of vicen moves the first step's velocities by 18% of
# their scale (tests/test_torch_box.py), so two implementations cannot agree
BOX_SMALL = {"domain.ny_global": 24, "domain.nx_global": 32,
             "grid.lat_origin": 69.0, "dynamics.evp_damping": True}
BOX_CLI = {"domain.ny_global": 48, "domain.nx_global": 64,
           "grid.lat_origin": 67.0}
# the all-ocean box cut and given a U-fold for the card-vs-CPU parity:
# ice, velocities and stresses reach the top row and cross the fold
TRIPOLE_SMALL = {**BOX_SMALL, "domain.ns_boundary_type": "tripole"}
# ACCESS-OM2 on its tripole grid (cice4_tpu/config.py access_om_config):
# 0.25 degree, 1440x1080, driven and timed step by step, and 1 degree,
# 360x300, timed beside it
ACCESS025 = (1080, 1440)
ACCESS1 = (300, 360)
ACCESS_STEPS = 4
ACCESS_TIMED = 4
# gx1 with delta-Eddington shortwave and the melt-pond tracer, from the
# ponded state of kernel_check.ponded_state (the analytic forcing grows no
# pond), and gx1 with the coupled ordering, constant albedos, the
# constant-coefficient boundary layer and no linear ITD; both from day 80,
# where the analytic forcing's shortwave and the orbital sun agree
DEDD = {"grid.kmt_file": "", "radiation.shortwave": "dEdd",
        "tracers.tr_pond": True}
COUPLED = {"grid.kmt_file": "", "radiation.prep_radiation": True,
           "radiation.albedo_type": "constant", "thermo.atmbndy": "constant",
           "thermo.kitd": 0}
DEDD_STEPS = 12
DEDD_TIMED = 4
# phase 10's two runs from one state, on the column kernels and on their
# plain versions, after as many steps on the kernels, with the level-ice
# tracers beside the ponds' and the ice age
COLUMN_SPLIT_STEPS = 4
DEDD_LEVEL = {**DEDD, "tracers.tr_lvl": True}
COUPLED_STEPS = 4
# the rest of ROADMAP 1.4 at gx1 (f32, 320x384, from day 80), OPT_STEPS
# steps a path, then OPT_TIMED timed: the transport options, (a) the
# departure-point midpoint with the conservation and monotonicity checks,
# (b) the fixed-area remap, (c) upwind transport, and (d) the split route
# with the midpoint on the box; the thermo options, (e) no heat capacity,
# (f) calc_Tsfc=False (the explicit surface scheme, no coupler), (g) both;
# the grid files, (h) and (i) a POP grid at gx1's size as binary and
# netCDF, and (j) a pan-Arctic grid, its land mask in the file
OPT_STEPS = 8
OPT_TIMED = 4
VARIANT_STEPS = 4
SPLIT_MIDPT_STEPS = 2
MIDPT_CHECKS = {"grid.kmt_file": "", "transport.l_dp_midpt": True,
                "transport.conservation_check": True,
                "transport.monotonicity_check": True}
FIXED_AREA = {"grid.kmt_file": "", "transport.l_fixed_area": True}
UPWIND = {"grid.kmt_file": "", "transport.advection": "upwind"}
ZERO_LAYER = {"grid.kmt_file": "", "thermo.heat_capacity": False}
EXPLICIT = {"grid.kmt_file": "", "thermo.calc_Tsfc": False}
PRESCRIBED_ZERO = {**EXPLICIT, "thermo.heat_capacity": False}
# the whole-step option sets of tier-1 (tests/test_torch_transport_options.py,
# tests/test_torch_thermo_options.py), for the card-vs-CPU parity
REMAP_OPTIONS = {**MIDPT_CHECKS, "transport.l_fixed_area": True}
UPWIND_ZERO_LAYER = {**UPWIND, "thermo.heat_capacity": False}
# a land block in the Arctic of the POP grid files' land mask (rows,
# columns), and the pan-Arctic grid: uniform 8 km cells from 60N, so that
# the top row (near 87.6N) stays south of the pole, an island
POP_LAND = (slice(350, 370), slice(40, 80))
PANARCTIC_DX = 8.0e3
PANARCTIC_LAT0, PANARCTIC_LON0 = 60.0, -150.0
PANARCTIC_LAND = (slice(100, 140), slice(150, 200))
GRID_RTOL = 1.0e-12   # a grid read from a file vs built in memory, f64
# the file forcing and the coupled component (phases 14-15), f32, from 1
# January 1997: (k) gx1 under the NCAR bulk files with the ocean
# climatology and SST restoring, (l) gx1 under the monthly files with their
# prescribed stress (calc_strair=False), FILE_STEPS steps of IceModelRun
# then FILE_TIMED timed, the 6-hourly files holding the first
# FILE_RECORDS_6H records (the run reads the first 3); (m) ACCESS-OM at
# 0.25 degree with the GFDL open-water fluxes and (n) ACCESS-CM at 1
# degree (calc_Tsfc=False, the UM's stress), COUPLED_INTERVALS coupling
# intervals of INTERVAL_STEPS steps from seeded imports
NCAR_CLIM = {"grid.kmt_file": "", "forcing.atm_data_type": "ncar",
             "forcing.sss_data_type": "clim", "forcing.sst_data_type": "clim",
             "forcing.restore_sst": True}
MONTHLY_STRESS = {"grid.kmt_file": "", "forcing.atm_data_type": "monthly",
                  "thermo.calc_strair": False}
ACCESS_CM = {"thermo.calc_Tsfc": False, "thermo.calc_strair": False}
# the synthetic lat-lon grid of access_om_config narrows to 640 m near its
# top row at 0.25 degree: an hour's step takes a drift of 0.18 m/s across a
# cell there (Courant number 1, beyond which the remap's departure regions
# leave the neighbours it reads), and the coupled winds drive the ice
# faster, so (m) steps 1350 s, where 0.47 m/s does
ACCESS_OM025 = {"run.dt": 1350.0}
FILE_STEPS = 8
FILE_TIMED = 4
FILE_RECORDS_6H = 4
COUPLED_INTERVALS = 3
INTERVAL_STEPS = 2
RUNOFF_RTOL = 1.0e-12  # regrid_runoff on the card vs the CPU, f64
FREE_DRIFT_LIMIT = 2.0  # m/s, ice covering half of its cell or more
# per category, |absorbed + reflected - incoming| shortwave over sunlit
# ice, relative to the incoming: the dEdd fluxes close by construction up
# to the rounding of about a dozen f32 operations on fluxes of the
# incoming's size (fixed before the first run on the card)
CLOSURE_RTOL = 1.0e-5
STEP_RTOL = 1.0e-9   # GPU f64 step vs CPU f64 step, relative to field max
SPLIT_RTOL = 1.0e-5  # split vs default remap route, f32, to field max
# the decomposed path (phase 16): (o) gx1 on a 2x2 mesh of blocks in one
# process (blocks of 192x160; the EVP rounds pad them to 214x182, the
# remap to 204x172), DECOMP_STEPS steps against the one-device steps, then
# DECOMP_TIMED timed; (p) ACCESS-OM2 at 1 degree on 2x2 blocks, the U-fold
# crossing the EVP rounds and the remap; (q) the multi-process
# entry as two processes over gloo (1x2 blocks, LAUNCH_STEPS steps, the
# sharded restart read back) and as one over nccl (one block); (r) 24x32
# f64 cuts on 2x2 blocks, the card against the CPU, 3 steps
DECOMP_MESH = (2, 2)
DECOMP_STEPS = 3
DECOMP_TIMED = 2
LAUNCH_STEPS = 2
LAUNCH_TIMEOUT_S = 300
# therm_newton's (nilyr, nslyr) held against the plain version beside the
# gx1 path's (4, 1): counts of other register instances, then of the
# generic instance; and the register instance timed beside (4, 1)
NEWTON_LAYERS = ((7, 1), (2, 1), (4, 2), (9, 1), (10, 1), (16, 2), (32, 3))
NEWTON_TIMED = (7, 1)
# the deep-column path (phase 18): gx1 with 10 ice layers, the generic
# instance's counts, DEEP_STEPS steps
DEEP = {"grid.kmt_file": "", "domain.nilyr": 10}
DEEP_STEPS = 4
# the bench (phase 19): its configurations, each in a process of its own
BENCH_CONFIGS = ("gx1", "access025")
BENCH_TIMEOUT_S = 300
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W; the
# f32 and f64 rates outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

# one entry per kernel of the port: (its source, the TPU kernel it replaces,
# None for the column kernels, which replace none)
KERNELS = {
    "therm_newton": ("cice4_tpu_torch/csrc/therm_newton.cu",
                     "cice4_tpu/ops/therm_vertical.py:632"),
    "evp_subcycle": ("cice4_tpu_torch/csrc/evp_subcycle.cu",
                     "cice4_tpu/ops/evp_pallas.py:210"),
    "evp_wholegrid": ("cice4_tpu_torch/csrc/evp_subcycle.cu",
                      "cice4_tpu/ops/evp_pallas.py:83"),
    "remap_gsh": ("cice4_tpu_torch/csrc/remap_gsh.cu",
                  "cice4_tpu/ops/remap_pallas.py:70"),
    "remap_k12": ("cice4_tpu_torch/csrc/remap_k12.cu",
                  "cice4_tpu/ops/remap_pallas.py:157"),
    "remap_construct": ("cice4_tpu_torch/csrc/remap_k1k2.cu",
                        "cice4_tpu/ops/remap_pallas.py:373"),
    "remap_contract": ("cice4_tpu_torch/csrc/remap_k1k2.cu",
                       "cice4_tpu/ops/remap_pallas.py:391"),
    # the k-halo rounds on the padded blocks of a decomposed grid, doubly
    # cyclic: the whole-grid TPU kernel's function on the padded block
    "evp_rounds": ("cice4_tpu_torch/csrc/evp_rounds.cu",
                   "cice4_tpu/ops/evp_pallas.py:83"),
    # ridging and the ITD cleanup, a thread a column
    "ridge_column": ("cice4_tpu_torch/csrc/ridge_column.cu", None),
    "cleanup_column": ("cice4_tpu_torch/csrc/ridge_column.cu", None),
    # the coupler's GFDL open-water fluxes, a thread a cell
    "gfdl_column": ("cice4_tpu_torch/csrc/gfdl_column.cu", None),
}
LIBRARIES = sorted({Path(src).stem for src, _ in KERNELS.values()})
COLUMN_KERNELS = ("ridge_column", "cleanup_column")
# the path whose run gives each kernel's launches and timing inputs
PATH_OF = {"therm_newton": "gx1", "evp_subcycle": "gx1",
           "evp_wholegrid": "box", "remap_gsh": "gx1", "remap_k12": "gx1",
           "remap_construct": "split", "remap_contract": "split",
           "evp_rounds": "decomposed", "ridge_column": "gx1",
           "cleanup_column": "gx1", "gfdl_column": "om025"}

# Operations each kernel's function does, counted from the CUDA sources
# (one per add, multiply, compare, min/max, division or square root):
# Newton solve: an upper estimate per iteration of an icy cell, a fixed
# part and one per row of the (nslyr + nilyr + 1)-row system (300 at the
# gx1 counts);
# EVP: per active T cell and subcycle (strain rates 84, relaxation 85,
# str8 188), per active U point (momentum 43), the final pass over all
# cells adds the 4 corner sums; GSH/GA: per cell, both edges' geometry,
# areas, quadrature and moment sums plus the gather, by quadrature order;
# K12 and K1: per (row, cell) the reconstruction of the mass (100), of
# each type-1 (111) and type-2 (113) tracer; K12 and K2: per donor offset
# the mass (6), type-1 (24) and type-2 (73) contraction terms, the open
# water row (0) as mass only (its tracer divergence is 0).
OPS_NEWTON_FIXED, OPS_NEWTON_ROW = 60, 40
OPS_EVP_STRESS, OPS_EVP_MOMENTUM, OPS_EVP_FINAL_SUMS = 357, 43, 12
OPS_GSH_CELL = {1: 1204, 2: 1948, 3: 2248}
OPS_K12_MASS, OPS_K12_T1, OPS_K12_T2 = 100, 111, 113
OPS_K12_OFF_MASS, OPS_K12_OFF_T1, OPS_K12_OFF_T2 = 6, 24, 73


T0 = time.perf_counter()


def log(*args):
    if args and str(args[0]).startswith("["):
        # a phase's header: the seconds since the start of the run
        args = (f"{args[0]} (at {time.perf_counter() - T0:.0f} s)",) + args[1:]
    print(*args, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


def make_config(over, **more):
    from cice4_tpu_torch.config import gx1_config
    return gx1_config().with_values(**{**over, **more})


def box_config(**more):
    from cice4_tpu_torch.config import Config
    return Config().with_values(**{**BOX, **more})


def make_run(cfg, device, dtype):
    """(model, state, forcing) of a configuration."""
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.state import init_state

    model = Model.create(cfg, device=device, dtype=dtype)
    state = init_state(cfg, model.grid, model.itd, device=device,
                       dtype=dtype)
    return model, state, AnalyticForcing(cfg, model.grid, device=device,
                                         dtype=dtype)


def run_steps(model, state, forcing, nsteps, first=0, check=True,
              on_step=None):
    """Advance `nsteps` steps; return (state, per-step ridge iterations,
    last fluxes).  `on_step(n, fluxes)` sees each step's fluxes."""
    from cice4_tpu_torch.guards import raise_on_violation

    ridge = []
    fluxes = None
    for n in range(first, first + nsteps):
        yday = YDAY0 + n * DT / 86400.0
        state, fluxes = model(state, forcing(yday, 0.0), yday, 0.0)
        ridge.append(fluxes["_ridge_niter"])
        if check:
            raise_on_violation(fluxes["_guards"])
        if on_step is not None:
            on_step(n, fluxes)
    # on the card each step's count is a device tensor, read once here
    return state, [int(r) for r in ridge], fluxes


def state_tensors(state):
    from cice4_tpu_torch.state import STATE_FIELDS
    for k in STATE_FIELDS:
        v = getattr(state, k)
        for name, t in (v.items() if isinstance(v, dict) else [(k, v)]):
            yield name, t


def check_physical(grid, state, moving, south=True):
    for name, t in state_tensors(state):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"state field {name} is not finite")
    aice = state.aicen.sum(0)
    amin, amax = float(aice.min()), float(aice.max())
    # the area normalisation of cleanup leaves sums within roundoff of 1
    if amin < 0.0 or amax > 1.0 + 4 * torch.finfo(aice.dtype).eps:
        raise AssertionError(f"aice outside [0, 1]: [{amin}, {amax}]")
    lat = torch.rad2deg(grid.tlat)
    n_north = int((aice[lat > 70.0] > 0).sum())
    n_south = int((aice[lat < -60.0] > 0).sum())
    if n_north == 0 or (south and n_south == 0):
        raise AssertionError(f"ice cells north of 70N: {n_north}, south "
                             f"of 60S: {n_south}")
    umax = float(torch.maximum(state.uvel.abs(), state.vvel.abs()).max())
    if moving and not 0.0 < umax < 2.0:
        raise AssertionError(f"max |u|, |v| = {umax} m/s outside (0, 2)")
    return amin, amax, n_north, n_south, umax


def compare_states(a, b, rtol, what):
    """Worst |a - b| over the state's fields relative to each field's
    scale in `b`; integer and boolean fields must be equal."""
    ref = dict(state_tensors(b))
    worst = 0.0
    for name, x in state_tensors(a):
        y = ref[name]
        if not x.is_floating_point():
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{what}: {name} differs")
            continue
        scale = max(float(y.abs().max()), 1e-300)
        err = float((x.cpu() - y.cpu()).abs().max()) / scale
        worst = max(worst, err)
        if err > rtol:
            raise AssertionError(f"{what}: {name} differs by {err:.3e} of "
                                 f"its scale (limit {rtol})")
    return worst


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------


def sites():
    """{name: (module, name of its wrapper there, plain version)}: the
    wrapper of each kernel, and of K0's GA mode (``remap_ga``)."""
    from cice4_tpu_torch.ops import evp as evp_ops
    from cice4_tpu_torch.ops import evp_cuda, gfdl_flux, itd, mechred
    from cice4_tpu_torch.ops import remap_cuda
    from cice4_tpu_torch.ops import therm_vertical as tv
    evp = (evp_cuda, "evp_subcycle", evp_ops._evp_subcycle_plain)
    return {"therm_newton": (tv, "temperature_changes",
                             tv._temperature_changes_core),
            "evp_subcycle": evp, "evp_wholegrid": evp,
            "remap_gsh": (remap_cuda, "ga_gsh", remap_cuda.ga_gsh_plain),
            "remap_ga": (remap_cuda, "ga_planes",
                         remap_cuda.ga_planes_plain),
            "remap_k12": (remap_cuda, "k12_divergence",
                          remap_cuda.k12_plain),
            "remap_construct": (remap_cuda, "construct",
                                remap_cuda.construct_plain),
            "remap_contract": (remap_cuda, "contract",
                               remap_cuda.contract_plain),
            "evp_rounds": (evp_cuda, "evp_rounds",
                           evp_ops._evp_rounds_plain),
            "ridge_column": (mechred, "ridge_ice", mechred._ridge_ice_plain),
            "cleanup_column": (itd, "cleanup_itd", itd._cleanup_itd_plain),
            "gfdl_column": (gfdl_flux, "gfdl_ocean_fluxes",
                            gfdl_flux._gfdl_ocean_fluxes_plain)}


def counter_attr(name):
    """The count each wrapper keeps: evp_subcycle counts every launch and,
    apart, those on an NS-cyclic grid (the whole-grid kernel's)."""
    return "ns_cyclic_launches" if name == "evp_wholegrid" else "launches"


def reset_counts():
    for name, (mod, attr, _) in sites().items():
        setattr(getattr(mod, attr), counter_attr(name), 0)


def read_counts():
    return {name: getattr(getattr(mod, attr), counter_attr(name))
            for name, (mod, attr, _) in sites().items()}


def expected(steps, **per_step):
    """Launch counts of a path of `steps` steps (on a decomposed grid, the
    blocks times the steps): ridge_column once and cleanup_column twice a
    step (every path ridges and cleans up after ridging and after the
    thermodynamics), `per_step` kernels at the given counts, every other
    kernel 0."""
    per_step = dict(per_step, ridge_column=steps, cleanup_column=2 * steps)
    return {name: per_step.get(name, 0) for name in sites()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def layer_params(p, nilyr, nslyr):
    """`p` (the gx1 model's thermo parameters) at other layer counts: the
    salinity and melting-temperature profiles of that many layers."""
    from cice4_tpu_torch.ops import therm_vertical as tv
    from cice4_tpu_torch.state import make_itd_params

    cfg = make_config(MAIN, **{"domain.nilyr": nilyr,
                               "domain.nslyr": nslyr})
    return dataclasses.replace(
        p, **{k: v for k, v in vars(tv.make_thermo_params(
            cfg, make_itd_params(cfg))).items()
            if k in ("nilyr", "nslyr", "salin", "tmlt")})


def check_newton(p, device):
    """therm_newton against its plain version at the gx1 layer counts on
    two shapes, and at the other counts NEWTON_LAYERS on the smaller (the
    generic instance past 8 ice or 3 snow layers); the generic instance
    against the register one at the gx1 counts."""
    from cice4_tpu_torch import kernel_check
    from cice4_tpu_torch.ops import therm_vertical as tv

    for dtype in (torch.float32, torch.float64):
        args = kernel_check.make_inputs(p, 5, 116, 100, seed=11,
                                        device=device, dtype=dtype)
        before = tv._temperature_changes_cuda.generic_launches
        gen = tv._temperature_changes_cuda(p, DT, *args, generic=True)
        reg = tv.temperature_changes(p, DT, *args)
        plain = tv._temperature_changes_core(p, DT, *args)
        torch.cuda.synchronize()
        if tv._temperature_changes_cuda.generic_launches != before + 1:
            raise AssertionError("therm_newton's generic instance was not "
                                 "counted")
        for ref_name, ref in (("register instance", reg),
                              ("plain version", plain)):
            rep = kernel_check.compare(gen, ref, args[0], dtype)
            worst = max(v["max_rel"] for v in rep["fields"].values())
            log(f"  therm_newton generic instance vs {ref_name} (5, 116, "
                f"100) nilyr {p.nilyr} nslyr {p.nslyr} {str(dtype)[6:]}: "
                f"ok={rep['ok']} icy cells {rep['n_ice']}, cells whose "
                f"convergence or iteration count differs {rep['n_flip']}, "
                f"worst {worst:.3e} of the field's scale")
            if not rep["ok"]:
                raise AssertionError(f"therm_newton's generic instance "
                                     f"disagrees with the {ref_name}")

    cases = [(p, shape) for shape in ((5, 384, 320), (5, 116, 100))]
    cases += [(layer_params(p, *nl), (5, 116, 100)) for nl in NEWTON_LAYERS]
    for q, shape in cases:
        for dtype in (torch.float32, torch.float64):
            args = kernel_check.make_inputs(q, *shape, seed=11,
                                            device=device, dtype=dtype)
            kern = tv.temperature_changes(q, DT, *args)
            plain = tv._temperature_changes_core(q, DT, *args)
            torch.cuda.synchronize()
            rep = kernel_check.compare(kern, plain, args[0], dtype)
            instance = "generic" if q.nilyr > tv.TC_REGISTER_NILYR or \
                q.nslyr > tv.TC_REGISTER_NSLYR else "register"
            log(f"  therm_newton {shape} nilyr {q.nilyr} nslyr {q.nslyr} "
                f"({instance} instance) {str(dtype)[6:]}: ok={rep['ok']} "
                f"icy cells {rep['n_ice']}, cells whose convergence or "
                f"iteration count differs {rep['n_flip']}, max niter kernel "
                f"{rep['niter_kernel']} plain {rep['niter_plain']}")
            for k, v in rep["fields"].items():
                log(f"    {k:10s} max|d| {v['max_abs']:.3e} (agreeing cells "
                    f"{v['max_abs_same']:.3e}) max rel {v['max_rel']:.3e} "
                    f"beyond tol {v['n_bad']}")
            if not rep["ok"]:
                raise AssertionError(f"therm_newton disagrees with its plain "
                                     f"version at {shape} {dtype}, nilyr "
                                     f"{q.nilyr} nslyr {q.nslyr}")


def _log_fields(rep):
    """Per output: max |kernel - plain|, the same relative to the field's
    scale, elements beyond the tolerance (four outputs to a line)."""
    items = [f"{k} {v['max_abs']:.2e}/{v['max_rel']:.2e}/{v['n_bad']}"
             + ("" if v["finite"] else " NOT FINITE")
             for k, v in rep.items()]
    for i in range(0, len(items), 4):
        log("    max|d|/rel/beyond tol: " + "; ".join(items[i:i + 4]))


def _check_geometry(name, tag, dx, dy, afac, grid, dtype, emit_shifted,
                    order):
    """remap_gsh in one mode against its plain version, with the case
    codes of every edge."""
    from cice4_tpu_torch import kernel_check as kc
    from cice4_tpu_torch.ops import remap_cuda

    out, codes = remap_cuda.edge_cases_cuda(dx, dy, afac, grid.bc, order,
                                            emit_shifted=emit_shifted)
    plain = (remap_cuda.ga_gsh_plain if emit_shifted
             else remap_cuda.ga_planes_plain)(dx, dy, afac, grid.bc, order)
    codes_p = remap_cuda.edge_cases_plain(dx, dy, afac, grid.bc)
    torch.cuda.synchronize()
    flips = int((codes != codes_p).sum())
    rep = kc.compare_fields({name: out}, {name: plain}, kc.GSH_RTOL[dtype])
    ok = (flips <= kc.GSH_MAX_FLIP_SHARE[dtype] * codes.numel()
          and kc.fields_ok(rep, allowed_bad=90 * 25 * flips))
    log(f"  remap_gsh ({name} mode) {tag}, order {order}: ok={ok}, edges "
        f"{codes.numel()}, "
        f"edges whose case differs {flips}, distinct cases "
        f"{len(set(codes_p.flatten().tolist()))}")
    _log_fields(rep)
    if not ok:
        raise AssertionError(f"remap_gsh ({name} mode) disagrees at {tag}, "
                             f"order {order}")


def _check_pair(name, tag, kern, plain, rtol):
    from cice4_tpu_torch import kernel_check as kc

    torch.cuda.synchronize()
    rep = kc.compare_fields(kern, plain, rtol)
    ok = kc.fields_ok(rep)
    log(f"  {name} {tag}: ok={ok}")
    _log_fields(rep)
    if not ok:
        raise AssertionError(f"{name} disagrees at {tag}")


def check_dynamics_kernels(device):
    """The dynamics kernels against their plain versions, f32 and f64,
    gx1 and a ragged shape, EW cyclic and closed, NS closed, open, cyclic
    and the tripole and tripoleT folds: evp_subcycle (the whole-grid
    kernel on NS-cyclic grids), the round kernel (on the doubly cyclic
    grids), remap_gsh in GSH and GA mode, remap_k12,
    remap_construct (K1) and remap_contract (K2); on a fold the split
    route's three (GA mode, K1, K2) must refuse it.  The NS-cyclic and
    fold cases run on the all-ocean box grid (ice, stresses and
    reconstructions reach the top row), the others on the gx1 grid; the
    synthetic inputs put ice and velocities on both sides of every seam."""
    from cice4_tpu_torch import kernel_check as kc
    from cice4_tpu_torch.config import DynamicsConfig
    from cice4_tpu_torch.grid import make_grid
    from cice4_tpu_torch.ops import evp as evp_ops
    from cice4_tpu_torch.ops import evp_cuda, remap_cuda
    from cice4_tpu_torch.ops.remap import _tracer_meta

    meta = _tracer_meta(["iage"], 4, 1)
    p = evp_ops.make_evp_params(DynamicsConfig(), DT)
    for (ny, nx) in ((384, 320), (116, 100)):
        for ew, ns in (("cyclic", "closed"), ("closed", "open"),
                       ("cyclic", "cyclic"), ("closed", "cyclic"),
                       ("cyclic", "tripole"), ("cyclic", "tripoleT")):
            size = {"domain.ny_global": ny, "domain.nx_global": nx,
                    "domain.ew_boundary_type": ew,
                    "domain.ns_boundary_type": ns}
            fold = ns in ("tripole", "tripoleT")
            cfg = box_config(**size) if ns == "cyclic" or fold else \
                make_config(MAIN, **size)
            for dtype in (torch.float32, torch.float64):
                grid = make_grid(cfg, device=device, dtype=dtype)
                tag = f"{ny}x{nx} EW {ew} NS {ns} {str(dtype)[6:]}"

                args = kc.evp_inputs(grid, seed=3, dtype=dtype)
                before = evp_cuda.evp_subcycle.ns_cyclic_launches
                kern = kc.evp_named(evp_cuda.evp_subcycle(p, grid, *args))
                if evp_cuda.evp_subcycle.ns_cyclic_launches - before != \
                        int(ns == "cyclic"):
                    raise AssertionError("evp_subcycle's NS-cyclic count")
                plain = kc.evp_named(evp_ops._evp_subcycle_plain(p, grid,
                                                                 *args))
                name = "evp_wholegrid" if ns == "cyclic" else "evp_subcycle"
                log(f"  {name}: icy T cells {int(args[1].sum())}, U points "
                    f"{int(args[2].sum())}")
                _check_pair(name, tag, kern, plain, kc.EVP_RTOL[dtype])
                if ew == ns == "cyclic":
                    # the round kernel on a doubly cyclic block: a round and
                    # the remainder round, tiles ragged at 116x100
                    for k in (10, 9):
                        q = dataclasses.replace(p, ndte=k)
                        got = evp_cuda.evp_rounds(q, grid, *args)
                        want = evp_ops._evp_rounds_plain(q, grid, *args)
                        same = all(map(torch.equal, got, want))
                        _check_pair("evp_rounds", f"{tag}, {k} subcycles "
                                    f"(bit-equal: {same})",
                                    dict(enumerate(got)),
                                    dict(enumerate(want)),
                                    kc.ROUNDS_RTOL[dtype])

                dx, dy, afac, mm, tm = kc.remap_inputs(grid, seed=5, ncat=5,
                                                       meta=meta, dtype=dtype)
                for order in (1, 2, 3):
                    _check_geometry("GSH", tag, dx, dy, afac, grid, dtype,
                                    True, order)
                    if not fold:
                        _check_geometry("GA", tag, dx, dy, afac, grid, dtype,
                                        False, order)
                gsh_p = remap_cuda.ga_gsh_plain(dx, dy, afac, grid.bc, 2)
                div, divt = remap_cuda.k12_divergence(gsh_p, grid.hm, mm, tm,
                                                      meta, grid.bc)
                div_p, divt_p = remap_cuda.k12_plain(gsh_p, grid.hm, mm, tm,
                                                     meta, grid.bc)
                _check_pair("remap_k12", f"{tag}, rows {mm.shape[0]}, "
                            f"tracers {len(meta)}",
                            {"div": div, "divt": divt},
                            {"div": div_p, "divt": divt_p},
                            kc.K12_RTOL[dtype])
                if fold:
                    _check_split_refuses(dx, dy, afac, grid, mm, tm, meta)
                    continue

                mass, trc = remap_cuda.construct(grid.hm, mm, tm, meta,
                                                 grid.bc)
                mass_p, trc_p = remap_cuda.construct_plain(grid.hm, mm, tm,
                                                           meta, grid.bc)
                _check_pair("remap_construct", tag,
                            {"mass": mass, "trc": trc},
                            {"mass": mass_p, "trc": trc_p}, kc.K1_RTOL[dtype])
                ga_p = remap_cuda.ga_planes_plain(dx, dy, afac, grid.bc, 2)
                par = remap_cuda.gather_parents(trc_p, meta)
                # the kernel reads the parents from trc, as on the path
                div, divt = remap_cuda.contract(ga_p, mass_p, trc_p, None,
                                                meta, grid.bc)
                div_p, divt_p = remap_cuda.contract_plain(ga_p, mass_p, trc_p,
                                                          par, meta, grid.bc)
                _check_pair("remap_contract", tag,
                            {"div": div, "divt": divt},
                            {"div": div_p, "divt": divt_p},
                            kc.K2_RTOL[dtype])


def _check_split_refuses(dx, dy, afac, grid, mm, tm, meta):
    """On a tripole grid the split route's kernels refuse, naming ROADMAP
    queue 2 item 5, and launch nothing."""
    from cice4_tpu_torch.ops import remap_cuda

    before = read_counts()
    for name, call in (
            ("remap_gsh in GA mode",
             lambda: remap_cuda.ga_planes(dx, dy, afac, grid.bc, 2)),
            ("remap_construct",
             lambda: remap_cuda.construct(grid.hm, mm, tm, meta, grid.bc)),
            ("remap_contract",
             lambda: remap_cuda.contract(torch.zeros((9, 10) + mm.shape[1:],
                                                     dtype=mm.dtype,
                                                     device=mm.device),
                                         None, None, None, meta, grid.bc))):
        try:
            call()
        except NotImplementedError as exc:
            if "ROADMAP queue 2 item 5" not in str(exc):
                raise
        else:
            raise AssertionError(f"{name} took a tripole grid")
    if read_counts() != before:
        raise AssertionError("a split-route kernel launched on a fold")
    log(f"  the split route (GA mode, K1, K2) refuses {grid.bc.ns}, naming "
        f"ROADMAP queue 2 item 5")


# ---------------------------------------------------------------------------
# phases 4-6: the paths
# ---------------------------------------------------------------------------


def plain_sites():
    """(module, name) of each plain version where its wrapper looks it up."""
    from cice4_tpu_torch.ops import evp_cuda, gfdl_flux, itd, mechred
    from cice4_tpu_torch.ops import remap_cuda
    from cice4_tpu_torch.ops import therm_vertical as tv
    return ((tv, "_temperature_changes_core"),
            (evp_cuda, "_evp_subcycle_plain"),
            (evp_cuda, "_evp_rounds_plain"),
            (remap_cuda, "ga_gsh_plain"), (remap_cuda, "k12_plain"),
            (remap_cuda, "ga_planes_plain"), (remap_cuda, "construct_plain"),
            (remap_cuda, "contract_plain"),
            (mechred, "_ridge_ice_plain"), (itd, "_cleanup_itd_plain"),
            (gfdl_flux, "_gfdl_ocean_fluxes_plain"))


@contextlib.contextmanager
def counting_plain_calls():
    """Counts, by name, the calls of the kernels' plain versions made
    through their wrappers' modules while the block runs."""
    calls, saved = {}, []
    for mod, attr in plain_sites():
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _name=attr, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        saved.append((mod, attr, fn))
        setattr(mod, attr, counted)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def drive_path(name, cfg, device, nsteps, expect, moving, prepare=None,
               south=True, on_step=None):
    """Counts to 0, `nsteps` steps, counts read; `expect` maps each kernel
    to its launches; `prepare` maps the initial state to the one to start
    from; `south`: whether ice must lie south of 60S; `on_step(n,
    fluxes)` sees each step's fluxes.  Returns (model, state, forcing,
    ridge, fluxes)."""
    model, state, forcing = make_run(cfg, device, torch.float32)
    if prepare is not None:
        state = prepare(state)
    a0 = float(state.aicen.sum())
    with counting_plain_calls() as plain_calls:
        reset_counts()
        state, ridge, fluxes = run_steps(model, state, forcing, nsteps,
                                         on_step=on_step)
        torch.cuda.synchronize()
        counts = read_counts()
    log(f"  {name}: launches {counts}; plain versions called "
        f"{plain_calls or 'none'}; ridge iterations per step {ridge}")
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts}, expected {expect}")
    if plain_calls:
        raise AssertionError(f"{name}: plain versions ran: {plain_calls}")
    amin, amax, n_north, n_south, umax = check_physical(model.grid, state,
                                                        moving, south)
    log(f"  guards clean; state finite; aice in [{amin:.3g}, {amax:.6g}]; "
        f"icy cells north of 70N {n_north}, south of 60S {n_south}; max "
        f"|u|,|v| {umax:.4g} m/s; sum aice {a0:.6g} -> "
        f"{float(state.aicen.sum()):.6g}; thermo max niter last step "
        f"{int(fluxes['_thermo_niter'])}")
    return model, state, forcing, ridge, fluxes


def phase_access(device, card, shape, detail):
    """ACCESS-OM2 on its tripole grid (`access_om_config`, f32, the
    analytic forcing from day 80): ACCESS_STEPS steps with the counters
    (each of the four kernels of the default route once a step, no plain
    version), the EVP launch's report, ms/step by CUDA events over
    ACCESS_TIMED more steps, the device time by phase; with `detail`, each
    kernel against its plain version at this grid's inputs and its device
    time per launch.  Returns {kernel: (launches, ms, bound_ms, max |d|)}
    (empty without `detail`)."""
    from cice4_tpu_torch.config import access_om_config
    from cice4_tpu_torch.ops import evp_cuda

    ny, nx = shape
    cfg = access_om_config(nx=nx, ny=ny)
    tag = f"ACCESS-OM2 {ny}x{nx}"
    model, state, forcing, _, _ = drive_path(
        tag, cfg, device, ACCESS_STEPS,
        expected(ACCESS_STEPS, therm_newton=ACCESS_STEPS,
                 evp_subcycle=ACCESS_STEPS,
                 remap_gsh=ACCESS_STEPS, remap_k12=ACCESS_STEPS),
        moving=True)
    launches = read_counts()
    ran = evp_cuda.last_launch()
    resident = ran["blocks"] * ran["threads_per_block"]
    log(f"  {tag}: grid {model.grid.bc}; the last step's EVP launch "
        f"reported {ran}: {max(0, ran['active_t_cells'] - resident)} active "
        f"T cells and {max(0, ran['active_u_points'] - resident)} U points "
        f"beyond its {resident} resident threads")
    time_and_profile(tag, model, state, forcing, card, first=ACCESS_STEPS,
                     nsteps=ACCESS_TIMED)
    if not detail:
        return {}
    return check_at_path_inputs(tag, model, state, forcing, launches, card,
                                names=DEFAULT_ROUTE + COLUMN_KERNELS)


DEFAULT_ROUTE = ("therm_newton", "evp_subcycle", "remap_gsh", "remap_k12")


def check_at_path_inputs(tag, model, state, forcing, launches, card,
                         names=DEFAULT_ROUTE, yday=None):
    """Each kernel `names` (by default those of the default route) against
    its plain version at the arguments one step of a path gives it (at day
    `yday`), within its ``kernel_check`` tolerance, and its device time per
    launch.  Returns {kernel: (launches, ms, bound_ms, max |kernel -
    plain|)}."""
    seen = capture_kernel_inputs(model, state, forcing, names, yday)
    return {name: hold_at_inputs(tag, name, seen[name], launches, card)
            for name in names}


def hold_at_inputs(tag, name, args, launches, card):
    """Kernel `name` against its plain version at `args`, a path's inputs,
    within its ``kernel_check`` tolerance, and its device time per launch:
    (launches, ms, bound_ms, max |kernel - plain|)."""
    kern_fn, plain_fn = kernel_and_plain(name, args)
    kern, plain = kern_fn(), plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(name, kern, plain)
    ok, worst = within_tolerance(name, args, kern, plain)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"at the {tag} inputs: worst {worst:.3e}")
    ms = min(device_ms(kern_fn, 20) for _ in range(2))
    bound_ms, bound_by, nbytes, ops = bound(name, args, kern)
    log(f"  {name} at the {tag} inputs: {ms:.4f} ms device time per "
        f"launch; bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f}"
        f" MB, {ops / 1e9:.4g} G operations), {100 * bound_ms / ms:.1f}% "
        f"of it; max |kernel - plain| {err:.3e}, {worst:.3e} of the "
        f"field's scale (within tolerance); card: {card}")
    if name == "therm_newton":
        sabs, iabs = args[12], args[13]
        log(f"    its inputs: Sswabs max {float(sabs.max()):.4g} W/m^2 on "
            f"{int((sabs > 0).sum())} category cells, Iswabs max "
            f"{float(iabs.max()):.4g} W/m^2")
    return (launches[name], ms, bound_ms, err)


def shortwave_closure(model, state, forcing, yday):
    """The path's radiation at `state`: per category, |absorbed + reflected
    - incoming| relative to the incoming over sunlit ice, and what shows
    that the scheme acts (albedo range, sunlit and ponded category cells,
    largest snow-layer absorption)."""
    import cice4_tpu_torch.model as M
    from cice4_tpu_torch import constants as cn

    f = forcing(yday, 0.0)
    sw = M._step_radiation(model, state, model.grid, f, yday, 0.0, DT)
    incoming = f.swvdr + f.swvdf + f.swidr + f.swidf
    absorbed = sw["fswsfc"] + sw["fswint"] + sw["fswthru"]
    reflected = (sw["alvdrn"] * f.swvdr + sw["alvdfn"] * f.swvdf
                 + sw["alidrn"] * f.swidr + sw["alidfn"] * f.swidf)
    lit = (state.aicen > cn.puny) & (sw["coszen"] > cn.puny) & (incoming > 0)
    err = (absorbed + reflected - incoming).abs()[lit] \
        / incoming.expand_as(absorbed)[lit]
    albs = torch.stack([sw[k] for k in ("alvdrn", "alvdfn", "alidrn",
                                        "alidfn", "albin", "albsn",
                                        "albpn")])
    return dict(worst=float(err.max()), alb_min=float(albs.min()),
                alb_max=float(albs.max()), lit=int(lit.sum()),
                ponded=int((sw["albpn"] > 0).sum()),
                sswabs=float(sw["Sswabs"].max()),
                fswint=float(sw["fswint"].max()))


def phase_dedd(device, card):
    """gx1 with delta-Eddington shortwave and melt ponds, f32, from the
    ponded state (`kernel_check.ponded_state`): DEDD_STEPS steps with the
    counters (each of the four kernels of the default route once a step,
    no plain version), a physical state that shows the options act (pond
    volume >= 0 and > 0 somewhere; per category albedos in [0, 1], the
    shortwave closing within CLOSURE_RTOL, snow-layer absorption and
    ponded cells at the last state), ms/step by CUDA events over
    DEDD_TIMED more steps, device time and launches by phase, and each
    kernel against its plain version at this path's inputs, timed; then
    `column_split`.  Returns {kernel: (launches, ms, bound_ms, max |d|)}."""
    from cice4_tpu_torch import kernel_check

    cfg = make_config(DEDD)
    ny, nx = cfg.domain.ny_global, cfg.domain.nx_global
    tag = f"dEdd path {ny}x{nx}"
    model, state, forcing, _, _ = drive_path(
        tag, cfg, device, DEDD_STEPS,
        expected(DEDD_STEPS, therm_newton=DEDD_STEPS,
                 evp_subcycle=DEDD_STEPS,
                 remap_gsh=DEDD_STEPS, remap_k12=DEDD_STEPS),
        moving=True, prepare=kernel_check.ponded_state)
    launches = read_counts()
    volpn = state.trcrn["volpn"]
    vmin, vmax = float(volpn.min()), float(volpn.max())
    if vmin < 0.0 or vmax <= 0.0:
        raise AssertionError(f"{tag}: pond volume in [{vmin}, {vmax}]")
    rad = shortwave_closure(model, state, forcing,
                            YDAY0 + DEDD_STEPS * DT / 86400.0)
    log(f"  {tag}: pond volume in [{vmin:.4g}, {vmax:.4g}] m on "
        f"{int((volpn > 0).sum())} category cells; the next step's radiation: "
        f"{rad['lit']} sunlit icy category cells, {rad['ponded']} ponded, "
        f"albedos in [{rad['alb_min']:.4g}, {rad['alb_max']:.4g}], Sswabs max "
        f"{rad['sswabs']:.4g} W/m^2, fswint max {rad['fswint']:.4g} W/m^2, "
        f"worst closure |absorbed + reflected - incoming| {rad['worst']:.3e} "
        f"of the incoming (limit {CLOSURE_RTOL})")
    if not 0.0 <= rad["alb_min"] <= rad["alb_max"] <= 1.0:
        raise AssertionError(f"{tag}: albedos outside [0, 1]: {rad}")
    if rad["worst"] > CLOSURE_RTOL:
        raise AssertionError(f"{tag}: shortwave closure {rad['worst']:.3e} "
                             f"beyond {CLOSURE_RTOL}")
    if rad["sswabs"] <= 0.0 or rad["ponded"] == 0 or rad["lit"] == 0:
        raise AssertionError(f"{tag}: dEdd does not act: {rad}")
    time_and_profile(tag, model, state, forcing, card, first=DEDD_STEPS,
                     nsteps=DEDD_TIMED)
    compare_dense_passes(tag, model, state, forcing, card)
    out = check_at_path_inputs(tag, model, state, forcing, launches, card)
    column_split(device)
    return out


@contextlib.contextmanager
def plain_columns():
    """Ridging and the ITD cleanup run their plain versions, on the card,
    while the block runs."""
    from cice4_tpu_torch.ops import itd, mechred

    saved = mechred.ridge_ice, itd.cleanup_itd
    mechred.ridge_ice = mechred._ridge_ice_plain
    itd.cleanup_itd = itd._cleanup_itd_plain
    try:
        yield
    finally:
        mechred.ridge_ice, itd.cleanup_itd = saved


def column_split(device):
    """How far a run on the column kernels parts from one on their plain
    versions: gx1, f32, dEdd with the pond, level-ice and age tracers, from
    the ponded state after COLUMN_SPLIT_STEPS steps on the kernels, then
    COLUMN_SPLIT_STEPS steps each way.  Each step logs how many tracer
    elements ridge_column leaves apart from its plain version at that
    step's inputs (under a parent below puny), then the fields that differ
    at the step's end (elements, worst |kernel - plain| of the field's
    scale) and, for the volume tracers, how many differing elements lie in
    categories holding less than puny of ice in the plain run, and the
    largest difference of their content (tracer times volume)."""
    from cice4_tpu_torch import constants as cn
    from cice4_tpu_torch import kernel_check
    from cice4_tpu_torch.ops.itd import TRACER_DEPEND

    cfg = make_config(DEDD_LEVEL)
    model, state, forcing = make_run(cfg, device, torch.float32)
    state = kernel_check.ponded_state(state)
    n = COLUMN_SPLIT_STEPS
    state, _, _ = run_steps(model, state, forcing, n)
    kern, plain = state, state
    log(f"  column kernels against their plain versions, gx1 with tracers "
        f"{sorted(state.trcrn)}, from step {n}:")
    for k in range(n, 2 * n):
        args = capture_kernel_inputs(model, kern, forcing, ["ridge_column"],
                                     YDAY0 + k * DT / 86400.0)["ridge_column"]
        kern_fn, plain_fn = kernel_and_plain("ridge_column", args)
        _, apart = compare_column_call(kern_fn(), plain_fn())
        kern, kridge, _ = run_steps(model, kern, forcing, 1, first=k)
        with plain_columns():
            plain, pridge, _ = run_steps(model, plain, forcing, 1, first=k)
        ref = dict(state_tensors(plain))
        parts = []
        for name, x in state_tensors(kern):
            y = ref[name]
            differ = x != y
            ndiff = int(differ.sum())
            if not ndiff:
                continue
            scale = max(float(y.abs().max()), 1e-30)
            part = (f"{name} {ndiff} ({float((x - y).abs().max()) / scale:.2e}"
                    f" of scale")
            parent = {1: plain.vicen, 2: plain.vsnon}.get(
                TRACER_DEPEND.get(name))
            if parent is not None and x.shape == parent.shape:
                tiny = (parent > 0.0) & (parent < cn.puny)
                content = float(((x - y) * parent).abs().max())
                part += (f"; {int((differ & tiny).sum())} under a volume "
                         f"below puny; content {content:.2e} m")
            parts.append(part + ")")
        log(f"    step {k + 1}: ridge passes {kridge[0]} / {pridge[0]}; "
            f"after ridging {apart} tracer elements apart; at the step's "
            f"end {'; '.join(parts) or 'every field bit-equal'}")


def compare_dense_passes(tag, model, state, forcing, card):
    """The radiation's surface-type passes on the gathered active cells
    (the port's) against dense passes over every category cell (the JAX
    package's layout, `_compute_dedd` in the gathered pass's place):
    ms/step by CUDA events over DEDD_TIMED steps each, in the order
    gathered, dense, dense, gathered, and the dense passes' device time
    and launches by phase (the gathered passes' are the path's own)."""
    from cice4_tpu_torch.ops import shortwave_dedd as td

    gathered = td._compute_dedd_gathered
    order = []
    for dense in (False, True, True, False):
        td._compute_dedd_gathered = td._compute_dedd if dense else gathered
        try:
            order.append((dense, time_path(model, state, forcing,
                                           DEDD_TIMED, first=DEDD_STEPS)[0]))
            if len(order) == 2:
                log_profile(f"{tag}, {'dense' if dense else 'gathered'} "
                            f"passes", phase_device_times(model, state,
                                                          forcing),
                            order[-1][1])
        finally:
            td._compute_dedd_gathered = gathered
    log(f"  {tag}: ms/step (CUDA events, {DEDD_TIMED} steps each) with the "
        + "; ".join(f"{'dense' if d else 'gathered'} passes {ms:.3f}"
                    for d, ms in order)
        + f" (in this order); card: {card}")


def start_at(calendar, yday):
    """Set a fresh calendar to 00:00 of day-of-year `yday`."""
    calendar.time = (yday - 1.0) * 86400.0
    calendar._recompute()


def phase_box_driver(device, workdir):
    """The box through the driver: 24 steps with history, restart and
    diagnostics, then the resumed step 25 against the continued one.
    Returns (run, launches of the 24 steps, ms per step of the driver's
    "Step" timer)."""
    from scipy.io import netcdf_file

    from cice4_tpu_torch.driver import IceModelRun

    cfg = box_config(**{"run.history_dir": str(workdir / "history"),
                        "run.restart_dir": str(workdir / "restart"),
                        "run.pointer_file": str(workdir / "restart" /
                                                "ice.restart_file"),
                        "run.histfreq": ("d",), "run.dumpfreq": "d",
                        "run.diagfreq": NSTEPS})
    lines = []
    run = IceModelRun(cfg, dtype=torch.float32, device=device,
                      log=lines.append)
    run.initialize()
    start_at(run.calendar, YDAY0)
    diags = {}
    reset_counts()
    run.run(NSTEPS, on_diag=lambda n, d: diags.setdefault(n, d))
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected(NSTEPS, therm_newton=NSTEPS, evp_subcycle=NSTEPS,
                    evp_wholegrid=NSTEPS, remap_gsh=NSTEPS,
                    remap_k12=NSTEPS)
    log(f"  box path (IceModelRun): launches {counts}")
    if counts != want:
        raise AssertionError(f"box path: launches {counts}, expected {want}")
    for line in lines:
        if not line.startswith(("wrote", "ran")):
            continue
        log("  driver: " + line)
    table = [ln for ln in lines if ln.startswith("istep = ")]
    if list(diags) != [NSTEPS] or len(table) != 1:
        raise AssertionError(f"diagnostics at steps {list(diags)}")
    for ln in table[0].splitlines():
        log("    " + ln)
    if not all(math.isfinite(v) for v in diags[NSTEPS].values()):
        raise AssertionError("a diagnostic is not finite")
    step_ms = 1e3 * run.timers.totals["Step"] / run.timers.counts["Step"]

    hist = sorted((workdir / "history").glob("*.nc"))
    if len(hist) != 1:
        raise AssertionError(f"history files: {hist}")
    with netcdf_file(str(hist[0]), "r", mmap=False) as nc:
        names = sorted(nc.variables)
        aice = nc.variables["aice"][:].copy()
        tdays = float(nc.variables["time"][0])
    if aice.shape != (1, run.grid.ny, run.grid.nx) or not (
            np.isfinite(aice).all() and aice.min() >= 0.0
            and aice.max() <= 1.0 + 1e-6):
        raise AssertionError(f"history aice {aice.shape} out of range")
    log(f"  history {hist[0].name}: {len(names)} variables, daily mean aice "
        f"in [{aice.min():.4g}, {aice.max():.4g}], time {tdays} days")
    restarts = sorted((workdir / "restart").glob("iced.*.npz"))
    if len(restarts) != 1:
        raise AssertionError(f"restart files: {restarts}")

    amin, amax, n_north, _, umax = check_physical(run.grid, run.state, True,
                                                  south=False)
    log(f"  guards clean; state finite; aice in [{amin:.3g}, {amax:.6g}]; "
        f"icy cells north of 70N {n_north}; max |u|,|v| {umax:.4g} m/s")

    run.run(1)
    cont = run.state
    again = IceModelRun(cfg.with_values(**{"run.runtype": "continue"}),
                        dtype=torch.float32, device=device,
                        log=lines.append).initialize()
    if again.calendar.istep != NSTEPS:
        raise AssertionError(f"resumed at step {again.calendar.istep}")
    again.run(1)
    differ = [name for (name, a), (_, b) in zip(state_tensors(cont),
                                                state_tensors(again.state))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"resumed step {NSTEPS + 1} differs from the "
                             f"continued one in {differ}")
    log(f"  restart {restarts[0].name}: the resumed step {NSTEPS + 1} equals "
        f"the continued one bit for bit in every state field")
    return run, counts, step_ms


def phase_split_route(device):
    """SPLIT_STEPS box steps on the split route against the default
    route.  Returns (launches, worst difference)."""
    model, state0, forcing = make_run(box_config(), device, torch.float32)
    os.environ["CICE4_FORCE_PALLAS_REMAP"] = "1"
    try:
        reset_counts()
        split, _, _ = run_steps(model, state0, forcing, SPLIT_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        del os.environ["CICE4_FORCE_PALLAS_REMAP"]
    want = expected(SPLIT_STEPS, therm_newton=SPLIT_STEPS,
                    evp_subcycle=SPLIT_STEPS,
                    evp_wholegrid=SPLIT_STEPS, remap_ga=SPLIT_STEPS,
                    remap_construct=SPLIT_STEPS,
                    remap_contract=SPLIT_STEPS)
    log(f"  split route: launches {counts}")
    if counts != want:
        raise AssertionError(f"split route: launches {counts}, expected "
                             f"{want}")
    default, _, _ = run_steps(model, state0, forcing, SPLIT_STEPS)
    worst = compare_states(split, default, SPLIT_RTOL,
                           "split vs default route")
    check_physical(model.grid, split, True, south=False)
    return counts, worst


def phase_cli(workdir):
    """``python -m cice4_tpu_torch run`` on a small box, in a process of
    its own."""
    sets = {**BOX, **BOX_CLI, "run.history_dir": str(workdir / "history"),
            "run.restart_dir": str(workdir / "restart"),
            "run.pointer_file": str(workdir / "restart" / "pointer"),
            "run.diagfreq": CLI_STEPS}
    cmd = [sys.executable, "-m", "cice4_tpu_torch", "run", "--steps",
           str(CLI_STEPS)] + [f"--set={k}={v!r}" for k, v in sets.items()]
    env = {**os.environ,
           "PYTHONPATH": str(Path(__file__).resolve().parent)}
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=workdir, env=env)
    tail = res.stdout.strip().splitlines()[-12:]
    if res.returncode != 0 or f"ran {CLI_STEPS} steps" not in res.stdout:
        raise AssertionError(f"CLI exited {res.returncode}:\n{res.stdout}"
                             f"\n{res.stderr}")
    ran = [ln for ln in res.stdout.splitlines() if ln.startswith("ran ")]
    log(f"  {' '.join(cmd[1:5])} ... ({len(sets)} --set): exit 0; {ran[0]}")
    return tail


def phase_small_parity(device, cfg, prepare=None):
    """A 24x32 cut in f64: the card (kernels) against the CPU (plain
    versions), 3 steps, from the initial state or `prepare` of it."""
    out = []
    for dev in (device, torch.device("cpu")):
        model, state, forcing = make_run(cfg, dev, torch.float64)
        if prepare is not None:
            state = prepare(state)
        state, _, _ = run_steps(model, state, forcing, 3)
        out.append(state)
    return compare_states(out[0], out[1], STEP_RTOL, "GPU vs CPU step")


def time_and_profile(tag, model, state, forcing, card, first=OPT_STEPS,
                     nsteps=OPT_TIMED):
    """ms/step by CUDA events over `nsteps` steps after step `first`, and
    device time and launches by phase of one step."""
    ms_ev, ms_host, ridge = time_path(model, state, forcing, nsteps,
                                      first=first)
    ny, nx = model.grid.ny, model.grid.nx
    log(f"  {tag}: {ms_ev:.3f} ms/step (CUDA events, {nsteps} steps "
        f"after {first}), {ms_host:.3f} ms/step (host clock), "
        f"{ny * nx / (ms_ev / 1e3):.4g} cell-steps/s; ridge iterations "
        f"{ridge}; card: {card}")
    log_profile(tag, phase_device_times(model, state, forcing), ms_ev)
    return ms_ev


def fixed_area_flux_error(model, state):
    """The ``l_fixed_area`` property (the JAX package's
    tests/test_transport_checks.py:81-100): the area divergence of a
    uniform unit mass (the contraction of the fixed-area GSH with a
    constant) equals the divergence of the prescribed edge areas.  At the
    velocities of `state` (those of its last step): (largest |difference|
    over ocean cells in m^2, largest |divergence of the edge areas|)."""
    from cice4_tpu_torch.ops import remap
    from cice4_tpu_torch.parallel.halo import Nbr

    grid = model.grid
    sh = Nbr(grid.bc)
    ea_e, ea_n = remap.edge_areas(state.uvel, state.vvel, grid, DT, sh)
    gsh = remap.geometry_gsh(-DT * state.uvel / grid.dxu,
                             -DT * state.vvel / grid.dyu, grid.dxu * grid.dyu,
                             grid.bc, model.cfg.transport.integral_order,
                             ea_e, ea_n)
    area_div = sum(remap._shift_by(sh, gsh[o, 0], off)
                   for o, off in enumerate(remap.ALL_OFFSETS))
    want = ea_e - sh.w(ea_e) + ea_n - sh.s(ea_n)
    ocean = grid.tmask
    return (float((area_div - want)[ocean].abs().max()),
            float(want[ocean].abs().max()))


def phase_transport_options(device, card):
    """Paths (a)-(d): the transport options, each with its launches and no
    plain version; (a) reads its transport guards clean each step and logs
    the largest relative change of a global sum, (b) the fixed-area
    property; (a)-(c) timed and profiled, and at (a)'s inputs remap_gsh
    and remap_k12, at (b)'s remap_k12, held against their plain versions
    and timed.  Returns {path: {kernel: (launches, ms, bound_ms, max
    |d|)}}."""
    cfg = make_config(MIDPT_CHECKS)
    ny, nx = cfg.domain.ny_global, cfg.domain.nx_global
    column = dict(therm_newton=OPT_STEPS, evp_subcycle=OPT_STEPS)
    out = {}

    tag = f"(a) l_dp_midpt with both transport checks, gx1 {ny}x{nx}"
    largest = []

    def conservation(n, fluxes):
        guards = fluxes["_guards"]
        if {"transport monotonicity",
                "transport global conservation"} - set(guards):
            raise AssertionError(f"{tag}: transport guards missing: "
                                 f"{sorted(guards)}")
        largest.append(float(guards["transport global conservation"]
                             ["largest"]))
    model, state, forcing, _, _ = drive_path(
        tag, cfg, device, OPT_STEPS,
        expected(OPT_STEPS, **column, remap_gsh=OPT_STEPS,
                 remap_k12=OPT_STEPS),
        moving=True, on_step=conservation)
    launches = read_counts()
    log(f"  {tag}: transport guard records clean at every step; the largest "
        f"relative change of a global sum of mass or mass*tracer, by step: "
        f"{', '.join(f'{v:.3e}' for v in largest)} (threshold 1e-4 in f32)")
    time_and_profile(tag, model, state, forcing, card)
    out["midpt"] = check_at_path_inputs(tag, model, state, forcing, launches,
                                        card, names=("remap_gsh",
                                                     "remap_k12"))

    tag = f"(b) l_fixed_area, gx1 {ny}x{nx}"
    model, state, forcing, _, _ = drive_path(
        tag, make_config(FIXED_AREA), device, OPT_STEPS,
        expected(OPT_STEPS, **column, remap_k12=OPT_STEPS), moving=True)
    launches = read_counts()
    err, scale = fixed_area_flux_error(model, state)
    if not math.isfinite(err):
        raise AssertionError(f"{tag}: fixed-area flux error {err}")
    log(f"  {tag}: at the last step's velocities, max |area divergence of a "
        f"uniform unit mass - divergence of the prescribed edge areas| "
        f"{err:.4e} m^2 over ocean cells, {err / scale:.3e} of the largest "
        f"edge-area divergence ({scale:.4e} m^2); card: {card}")
    time_and_profile(tag, model, state, forcing, card)
    out["fixed_area"] = check_at_path_inputs(tag, model, state, forcing,
                                             launches, card,
                                             names=("remap_k12",))

    tag = f"(c) upwind transport, gx1 {ny}x{nx}"
    model, state, forcing, _, _ = drive_path(
        tag, make_config(UPWIND), device, OPT_STEPS,
        expected(OPT_STEPS, **column),
        moving=True)
    time_and_profile(tag, model, state, forcing, card)

    tag = (f"(d) the split route with l_dp_midpt, the box, "
           f"{SPLIT_MIDPT_STEPS} steps")
    os.environ["CICE4_FORCE_PALLAS_REMAP"] = "1"
    try:
        n = SPLIT_MIDPT_STEPS
        drive_path(tag, box_config(**{"transport.l_dp_midpt": True}),
                   device, n,
                   expected(n, therm_newton=n, evp_subcycle=n,
                            evp_wholegrid=n, remap_ga=n, remap_construct=n,
                            remap_contract=n),
                   moving=True, south=False)
    finally:
        del os.environ["CICE4_FORCE_PALLAS_REMAP"]
    return out


def grid_field_error(got, want):
    """Worst |got - want| over the grid's fields relative to each float
    field's scale; masks must be equal."""
    from cice4_tpu_torch.grid import GRID_FIELDS

    worst = 0.0
    for k in GRID_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"grid field {k} differs")
            continue
        scale = max(float(b.abs().max()), 1e-300)
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def grid_from_records(src, kmt, bc):
    """The grid of `src`'s metrics and the land mask `kmt`, built in
    memory in f64 on the CPU."""
    from cice4_tpu_torch import grid as G

    def host(t):
        return t.numpy().astype(np.float64)

    fields = G._derive_metrics(host(src.htn), host(src.hte), host(src.ulat),
                               host(src.ulon), host(src.angle),
                               (kmt >= 1).astype(np.float64), bc)
    return G._make_grid(fields, bc, torch.device("cpu"), torch.float64)


def check_loaded(tag, cfg, built):
    """The grid `cfg` reads from its file(s), f64 on the CPU, against
    `built` within GRID_RTOL."""
    from cice4_tpu_torch.grid import make_grid

    worst = grid_field_error(make_grid(cfg, device=torch.device("cpu"),
                                       dtype=torch.float64), built)
    log(f"  {tag}: read from {Path(cfg.grid.grid_file).name}, every field "
        f"within {worst:.3e} of its scale of the grid built in memory "
        f"(limit {GRID_RTOL}), masks equal")
    if worst > GRID_RTOL:
        raise AssertionError(f"{tag}: the grid read differs by {worst:.3e}")


def phase_thermo_and_grids(device, card, workdir):
    """Paths (e)-(j), each with its launches and no plain version, timed
    and profiled: the thermo options (the solve's iterations, which are
    its host syncs, logged by step) and the grids read from files written
    here (each held against the grid built in memory first); (j) runs
    through ``IceModelRun`` with ice restoring at its open edges."""
    from cice4_tpu_torch import kernel_check
    from cice4_tpu_torch import grid as G
    from cice4_tpu_torch.driver import IceModelRun
    from cice4_tpu_torch.parallel.halo import BoundaryConditions

    cfg = make_config(MAIN)
    ny, nx = cfg.domain.ny_global, cfg.domain.nx_global
    dyn = dict(evp_subcycle=VARIANT_STEPS, remap_gsh=VARIANT_STEPS,
               remap_k12=VARIANT_STEPS)
    for tag, over in (("(e) heat_capacity=False", ZERO_LAYER),
                      ("(f) calc_Tsfc=False, the explicit surface scheme",
                       EXPLICIT),
                      ("(g) calc_Tsfc=False and heat_capacity=False",
                       PRESCRIBED_ZERO)):
        tag = f"{tag}, gx1 {ny}x{nx}"
        niter = []
        model, state, forcing, _, _ = drive_path(
            tag, make_config(over), device, VARIANT_STEPS,
            expected(VARIANT_STEPS, **dyn),
            moving=True,
            on_step=lambda n, fl: niter.append(int(fl["_thermo_niter"])))
        log(f"  {tag}: the temperature solve's iterations, each one host "
            f"sync, by step: {niter}")
        time_and_profile(tag, model, state, forcing, card,
                         first=VARIANT_STEPS)

    default = expected(VARIANT_STEPS, therm_newton=VARIANT_STEPS, **dyn)
    bc = BoundaryConditions(cfg.domain.ew_boundary_type,
                            cfg.domain.ns_boundary_type)
    src = G.make_latlon_grid(nx, ny, bc, device=torch.device("cpu"),
                             dtype=torch.float64)
    kmt = np.where(src.hm.numpy() > 0.5, 30, 0).astype(np.int32)
    kmt[0] = kmt[-1] = 0
    kmt[POP_LAND] = 0
    built = grid_from_records(src, kmt, bc)
    rec = kernel_check.grid_records(src)
    for fmt, tag in (("bin", "(h) a POP binary grid"),
                     ("nc", "(i) a POP netCDF grid")):
        tag = f"{tag}, {ny}x{nx}"
        (workdir / fmt).mkdir()
        grid_file, kmt_file = kernel_check.write_pop_grid(workdir / fmt, rec,
                                                          kmt, fmt)
        pcfg = make_config(MAIN, **{"grid.grid_type": "displaced_pole",
                                    "grid.grid_format": fmt,
                                    "grid.grid_file": grid_file,
                                    "grid.kmt_file": kmt_file})
        check_loaded(tag, pcfg, built)
        model, state, forcing, _, _ = drive_path(tag, pcfg, device,
                                                 VARIANT_STEPS, default,
                                                 moving=True)
        time_and_profile(tag, model, state, forcing, card,
                         first=VARIANT_STEPS)

    tag = (f"(j) a pan-Arctic grid, {ny}x{nx}, {PANARCTIC_DX / 1e3:.0f} km "
           f"cells from {PANARCTIC_LAT0:.0f}N, open edges, ice restoring, "
           f"IceModelRun")
    obc = BoundaryConditions("open", "open")
    src = G.make_rect_grid(nx, ny, obc, dx=PANARCTIC_DX, dy=PANARCTIC_DX,
                           lat_origin=PANARCTIC_LAT0,
                           lon_origin=PANARCTIC_LON0, land_edges=False,
                           device=torch.device("cpu"), dtype=torch.float64)
    kmt = np.ones((ny, nx), dtype=np.int32)
    kmt[PANARCTIC_LAND] = 0
    pcfg = make_config(MAIN, **{
        "domain.ew_boundary_type": "open", "domain.ns_boundary_type": "open",
        "grid.grid_type": "panarctic",
        "grid.grid_file": kernel_check.write_panarctic_grid(
            workdir / "panarctic.grid", kernel_check.grid_records(src), kmt),
        "forcing.restore_ice": True,
        "run.history_dir": str(workdir / "history"),
        "run.restart_dir": str(workdir / "restart"),
        "run.pointer_file": str(workdir / "restart" / "pointer"),
        "run.diagfreq": 0})
    check_loaded(tag, pcfg, grid_from_records(src, kmt, obc))
    run = IceModelRun(pcfg, dtype=torch.float32, device=device,
                      log=lambda line: None).initialize()
    start_at(run.calendar, YDAY0)
    top = float(torch.rad2deg(run.grid.tlat).max())
    with counting_plain_calls() as plain_calls:
        reset_counts()
        run.run(VARIANT_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
    log(f"  {tag}: top row at {top:.2f}N; launches {counts}; plain versions "
        f"called {plain_calls or 'none'}")
    if counts != default:
        raise AssertionError(f"{tag}: launches {counts}, expected {default}")
    if plain_calls:
        raise AssertionError(f"{tag}: plain versions ran: {plain_calls}")
    amin, amax, n_north, _, umax = check_physical(run.grid, run.state, True,
                                                  south=False)
    log(f"  guards clean; state finite; aice in [{amin:.3g}, {amax:.6g}]; "
        f"icy cells north of 70N {n_north}; max |u|,|v| {umax:.4g} m/s")
    time_and_profile(tag, run.model, run.state, run.forcing_provider, card,
                     first=VARIANT_STEPS)


# ---------------------------------------------------------------------------
# phases 14-15: the file forcing and the coupled component
# ---------------------------------------------------------------------------


def check_prescribed_stress(tag, reads):
    """Every step's EVP read the forcing's prescribed stress bit for bit."""
    if not reads or any(len(r) != 3 for r in reads):
        raise AssertionError(f"{tag}: the EVP's stress was not seen each "
                             f"step")
    for f, sx, sy in reads:
        if f.strax is None or not (torch.equal(sx, f.strax)
                                   and torch.equal(sy, f.stray)):
            raise AssertionError(f"{tag}: the EVP did not read the "
                                 f"prescribed stress")
    f = reads[-1][0]
    log(f"  {tag}: the stress the EVP read equals the forcing's prescribed "
        f"stress bit for bit at each of {len(reads)} steps (max |strax| "
        f"{float(f.strax.abs().max()):.4g} N/m^2)")


def check_free_drift(tag, state):
    """The ice velocity under the monthly dataset's prescribed stress.  The
    JAX package hands the file's stress to the EVP as it is, not weighted
    by the ice area as the coupler's stress is, while the ocean drag is
    weighted by it: marginal ice drifts freely, faster as its area is
    smaller.  Moving ice, and below FREE_DRIFT_LIMIT where the ice covers
    at least half of the cell (the plausibility bound of the other paths);
    the fastest speed and its cell's area logged."""
    speed = torch.maximum(state.uvel.abs(), state.vvel.abs())
    aice = state.aicen.sum(0)
    k = int(speed.argmax())
    pack = float(speed[aice >= 0.5].max())
    log(f"  {tag}: max |u|,|v| {float(speed.max()):.4g} m/s where aice is "
        f"{float(aice.flatten()[k]):.3g}; {pack:.4g} m/s where aice >= 0.5 "
        f"(limit {FREE_DRIFT_LIMIT})")
    if not 0.0 < pack < FREE_DRIFT_LIMIT:
        raise AssertionError(f"{tag}: pack ice speed {pack} m/s")


def write_path_files(directory, datasets, ny, nx):
    """The seeded files of `datasets` (`kernel_check.write_forcing_files`),
    the 6-hourly ones with only the records a run of FILE_STEPS +
    FILE_TIMED + 2 hours from 1 January reads.  Returns their bytes."""
    from cice4_tpu_torch import kernel_check

    return sum(os.path.getsize(p) for seed, ds in enumerate(datasets)
               for p in kernel_check.write_forcing_files(
                   directory, ds, ny, nx, seed=seed,
                   records_6h=FILE_RECORDS_6H))


def phase_file_forced(device, card, workdir):
    """Paths (k) and (l): gx1 through ``IceModelRun`` (the CLI's path)
    under seeded files written into `workdir` in the reference's layout,
    from 1 January 1997: FILE_STEPS steps with the counters (each of the
    four kernels of the default route once a step, no plain version), the
    provider's files found, a physical state; (k) the initial SST the
    climatology's, (l) the prescribed stress in the EVP each step;
    ms/step by CUDA events over FILE_TIMED more steps, host syncs of a
    step, device time by phase with the forcing beside it, and each kernel
    against its plain version at the path's inputs.  Returns {path:
    {kernel: (launches, ms, bound_ms, max |d|)}}."""
    from cice4_tpu_torch import kernel_check
    from cice4_tpu_torch.driver import IceModelRun

    cfg0 = make_config(MAIN)
    ny, nx = cfg0.domain.ny_global, cfg0.domain.nx_global
    out = {}
    for key, tag, over, datasets in (
            ("ncar_clim", f"(k) gx1 {ny}x{nx} under the NCAR files and the "
             f"ocean climatology with SST restoring", NCAR_CLIM,
             ("ncar", "ocean")),
            ("monthly", f"(l) gx1 {ny}x{nx} under the monthly files, "
             f"calc_strair=False", MONTHLY_STRESS, ("monthly",))):
        d = workdir / key
        t0 = time.perf_counter()
        nbytes = write_path_files(d, datasets, ny, nx)
        log(f"  {tag}: wrote {nbytes / 1e6:.1f} MB of files in "
            f"{time.perf_counter() - t0:.2f} s")
        cfg = make_config(over, **{
            "forcing.atm_data_dir": str(d), "forcing.ocn_data_dir": str(d),
            "run.history_dir": str(workdir / "history"),
            "run.restart_dir": str(workdir / "restart"),
            "run.pointer_file": str(workdir / "restart" / "pointer"),
            "run.diagfreq": 0})
        run = IceModelRun(cfg, dtype=torch.float32, device=device,
                          log=lambda line: None).initialize()
        prov = run.forcing_provider
        if not getattr(prov, "available", False):
            raise AssertionError(f"{tag}: the files were not found: "
                                 f"{type(prov).__name__} unavailable")
        if key == "ncar_clim":
            if type(prov).__name__ != "CombinedProvider" \
                    or not prov.ocn.available:
                raise AssertionError(f"{tag}: no ocean climatology")
            sst0 = prov.ocn.initial_fields(run.calendar.month)[2]
            if not torch.equal(run.state.sst, sst0):
                raise AssertionError(f"{tag}: the initial SST is not the "
                                     f"climatology's")
        with counting_plain_calls() as plain_calls, \
                kernel_check.evp_stress_reads() as reads:
            reset_counts()
            run.run(FILE_STEPS)
            torch.cuda.synchronize()
            counts = read_counts()
        want = expected(FILE_STEPS,
                        **{k: FILE_STEPS for k in DEFAULT_ROUTE})
        atm = getattr(prov, "atm", prov)
        log(f"  {tag}: {type(prov).__name__} ({type(atm).__name__}); "
            f"launches {counts}; plain versions called "
            f"{plain_calls or 'none'}")
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts}, expected {want}")
        if plain_calls:
            raise AssertionError(f"{tag}: plain versions ran: {plain_calls}")
        if key == "monthly":
            check_prescribed_stress(tag, reads)
            check_free_drift(tag, run.state)
        amin, amax, n_north, n_south, umax = check_physical(
            run.grid, run.state, key != "monthly")
        log(f"  guards clean; state finite; aice in [{amin:.3g}, "
            f"{amax:.6g}]; icy cells north of 70N {n_north}, south of 60S "
            f"{n_south}; max |u|,|v| {umax:.4g} m/s; SST in "
            f"[{float(run.state.sst.min()):.4g}, "
            f"{float(run.state.sst.max()):.4g}] C")
        launches = read_counts()

        start, end = _events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run.run(FILE_TIMED)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / FILE_TIMED
        host_ms = (time.perf_counter() - t0) * 1e3 / FILE_TIMED
        syncs, where = host_syncs(lambda: run.run(1))
        step_ms = 1e3 * run.timers.totals["Step"] / run.timers.counts["Step"]
        forcing_ms = (1e3 * run.timers.totals["Forcing"]
                      / run.timers.counts["Forcing"])
        log(f"  {tag}: {ms:.3f} ms/step (CUDA events, {FILE_TIMED} steps of "
            f"IceModelRun.run after {FILE_STEPS}), {host_ms:.3f} ms/step "
            f"(host clock); the driver's timers over its "
            f"{run.timers.counts['Step']} steps: Step {step_ms:.3f} ms, Forcing {forcing_ms:.3f} ms a "
            f"step; {syncs} synchronising operations in one step of the "
            f"driver (sync debug mode: {where}); card: {card}")
        cal = run.calendar
        f = prov(cal.yday, cal.sec, cal=cal, state=run.state)

        def forcing(yday, sec, f=f):
            return f
        region = region_device_time(
            lambda: (prov(cal.yday, cal.sec, cal=cal, state=run.state),
                     prov.ocean_update(run.state, cal, DT)))
        log_profile(tag, phase_device_times(run.model, run.state, forcing,
                                            yday=cal.yday), ms,
                    regions={"forcing": region})
        out[key] = check_at_path_inputs(tag, run.model, run.state, forcing,
                                        launches, card, yday=cal.yday)
    return out


def coupled_imports(flavor, ny, nx, n, device, dtype, ncat=5):
    """Interval `n`'s seeded import state of a component."""
    from cice4_tpu_torch import coupling, coupling_cm, kernel_check

    a2i = coupling.A2I_FIELDS if flavor == "om" \
        else coupling_cm.a2i_cm_fields(ncat)
    return {"a2i": kernel_check.coupler_fields(a2i, ny, nx, 100 + n,
                                               device=device, dtype=dtype),
            "o2i": kernel_check.coupler_fields(coupling.O2I_FIELDS, ny, nx,
                                               200 + n, device=device,
                                               dtype=dtype)}


def check_exports(tag, export):
    for side, fields in export.items():
        for name, v in fields.items():
            bad = ~torch.isfinite(v)
            if bool(bad.any()):
                cells = torch.nonzero(bad)[:4].tolist()
                raise AssertionError(f"{tag}: export {side} {name} is not "
                                     f"finite on {int(bad.sum())} cells, "
                                     f"e.g. {cells}")
    aice = export["i2o"]["aice_io"]
    lo, hi = float(aice.min()), float(aice.max())
    if lo < 0.0 or hi > 1.0 + 4 * torch.finfo(aice.dtype).eps:
        raise AssertionError(f"{tag}: aice_io outside [0, 1]: [{lo}, {hi}]")
    return lo, hi


def phase_coupled(device, card, workdir):
    """Paths (m) and (n): the coupled component (`IceComponent`), f32,
    COUPLED_INTERVALS intervals of INTERVAL_STEPS steps from seeded imports
    with the counters; the exports finite, aice_io in [0, 1], a physical
    state; (m) ACCESS-OM at 0.25 degree with the GFDL open-water fluxes:
    u_star > 0 on ocean cells and carried to the next interval, its
    sidecar read back equal, and `regrid_runoff` on the tripole mask held
    against its CPU result (f64); (n) ACCESS-CM at 1 degree: the
    prescribed stress in the EVP each step.  Then ms/step by CUDA events
    over one more interval, host syncs of a step, device time by phase
    with the coupler's exchange beside it, and each kernel against its
    plain version at the path's inputs; on (m) gfdl_column once an interval,
    held against its plain version at the inputs of one more interval.
    Returns {path: {kernel: ...}}, and under "gfdl_args" and
    "om025_launches" gfdl_column's inputs and (m)'s launch counts."""
    from cice4_tpu_torch import coupling, kernel_check
    from cice4_tpu_torch.component import IceComponent
    from cice4_tpu_torch.config import access_om_config
    from cice4_tpu_torch.ops.runoff_regrid import regrid_runoff

    out = {}
    n = COUPLED_INTERVALS * INTERVAL_STEPS
    for key, flavor, shape, over in (("om025", "om", ACCESS025,
                                      ACCESS_OM025),
                                     ("cm1", "cm", ACCESS1, ACCESS_CM)):
        ny, nx = shape
        cfg = access_om_config(nx=nx, ny=ny).with_values(
            **{**over, "run.history_dir": str(workdir / "history"),
               "run.diagfreq": 0})
        tag = (f"({'m' if flavor == 'om' else 'n'}) ACCESS-{flavor.upper()} "
               f"{ny}x{nx}")
        comp = IceComponent(cfg, flavor=flavor, gfdl_surface_flux=flavor
                            == "om", device=device,
                            log=lambda *a: None).initialize()
        r, bnd = comp.runner, comp._boundary
        ocean = r.grid.tmask
        carried = []
        gfdl = coupling.gfdl_open_water_fluxes

        def read_u_star(state, forcing, tmask, u_star_prev=None):
            carried.append(u_star_prev)
            return gfdl(state, forcing, tmask, u_star_prev)
        coupling.gfdl_open_water_fluxes = read_u_star
        try:
            with counting_plain_calls() as plain_calls, \
                    kernel_check.evp_stress_reads() as reads:
                reset_counts()
                for k in range(COUPLED_INTERVALS):
                    before = bnd.u_star
                    export = comp.run(coupled_imports(flavor, ny, nx, k,
                                                      device, torch.float32),
                                      n_steps=INTERVAL_STEPS)
                    lo, hi = check_exports(tag, export)
                    if flavor == "om":
                        if carried[-1] is not before or bnd.u_star is None:
                            raise AssertionError(f"{tag}: u_star not "
                                                 f"carried to interval {k}")
                        umin = float(bnd.u_star[ocean].min())
                        if not umin > 0.0:
                            raise AssertionError(f"{tag}: u_star {umin} on "
                                                 f"an ocean cell")
                torch.cuda.synchronize()
                counts = read_counts()
        finally:
            coupling.gfdl_open_water_fluxes = gfdl
        names = DEFAULT_ROUTE if flavor == "om" else DEFAULT_ROUTE[1:]
        want = expected(n, **{k: n for k in names})
        if flavor == "om":
            want["gfdl_column"] = COUPLED_INTERVALS
        log(f"  {tag}: launches {counts}; plain versions called "
            f"{plain_calls or 'none'}; last export aice_io in [{lo:.3g}, "
            f"{hi:.6g}], {sum(len(v) for v in export.values())} fields "
            f"finite")
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts}, expected {want}")
        if plain_calls:
            raise AssertionError(f"{tag}: plain versions ran: {plain_calls}")
        launches = read_counts()
        amin, amax, n_north, n_south, umax = check_physical(r.grid, r.state,
                                                            True)
        dt = cfg.run.dt
        cfl = float(torch.maximum(r.state.uvel.abs() * dt / r.grid.dxu,
                                  r.state.vvel.abs() * dt / r.grid.dyu).max())
        log(f"  guards clean; state finite; aice in [{amin:.3g}, "
            f"{amax:.6g}]; icy cells north of 70N {n_north}, south of 60S "
            f"{n_south}; max |u|,|v| {umax:.4g} m/s; largest Courant number "
            f"|u| dt/dx {cfl:.3g} (dt {dt:.0f} s)")
        if flavor == "om":
            path = workdir / "u_star.npz"
            bnd.dump(str(path))
            back = coupling.CouplerBoundary(bnd.forcing)
            back.load(str(path))
            if not torch.equal(back.u_star, bnd.u_star):
                raise AssertionError(f"{tag}: the u_star sidecar differs")
            log(f"  {tag}: u_star carried across {COUPLED_INTERVALS} "
                f"intervals, in [{float(bnd.u_star[ocean].min()):.4g}, "
                f"{float(bnd.u_star.max()):.4g}] m/s on ocean cells; its "
                f"sidecar read back equal")
            runof = coupled_imports("om", ny, nx, 0, device,
                                    torch.float64)["a2i"]["runof_i"]
            got = regrid_runoff(runof, ocean)
            want_cpu = regrid_runoff(runof.cpu(), ocean.cpu())
            err = float((got.cpu() - want_cpu).abs().max()) \
                / float(want_cpu.abs().max())
            ms_rr = device_ms(lambda: regrid_runoff(runof, ocean), 5)
            log(f"  {tag}: regrid_runoff (sigma 2, radius 8) on the tripole "
                f"mask, f64: card vs CPU {err:.3e} of the field's scale "
                f"(limit {RUNOFF_RTOL}), {ms_rr:.3f} ms device time a call; "
                f"card: {card}")
            if err > RUNOFF_RTOL:
                raise AssertionError(f"{tag}: regrid_runoff card vs CPU "
                                     f"{err:.3e}")
        else:
            check_prescribed_stress(tag, reads)

        imports = coupled_imports(flavor, ny, nx, COUPLED_INTERVALS, device,
                                  torch.float32)
        start, end = _events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        comp.run(imports, n_steps=INTERVAL_STEPS)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / INTERVAL_STEPS
        host_ms = (time.perf_counter() - t0) * 1e3 / INTERVAL_STEPS
        syncs, where = host_syncs(lambda: comp.run(imports, n_steps=1))
        log(f"  {tag}: {ms:.3f} ms/step (CUDA events over one interval of "
            f"{INTERVAL_STEPS} steps, the exchange included), {host_ms:.3f} "
            f"ms/step (host clock), {ny * nx / (ms / 1e3):.4g} cell-steps/s; "
            f"{syncs} synchronising operations in an interval of one step "
            f"(sync debug mode: {where}); card: {card}")
        fluxes = comp._last_fluxes
        region = region_device_time(lambda: (comp.receive(imports),
                                             comp.send(fluxes)))
        f = bnd.forcing

        def forcing(yday, sec, f=f):
            return f
        yday = r.calendar.yday
        log_profile(tag, phase_device_times(r.model, r.state, forcing,
                                            yday=yday), ms,
                    regions={"coupler": region})
        out[key] = check_at_path_inputs(tag, r.model, r.state, forcing,
                                        launches, card, names=names,
                                        yday=yday)
        if flavor == "om":
            with recording(["gfdl_column"]) as seen:
                comp.run(imports, n_steps=1)
            args = seen["gfdl_column"]
            out[key]["gfdl_column"] = hold_at_inputs(
                tag, "gfdl_column", args, launches, card)
            out["gfdl_args"], out["om025_launches"] = args, launches
    return out


def compare_dicts(a, b, rtol, what):
    """Worst |a - b| over two dicts of fields relative to each field's
    scale in `b`."""
    worst = 0.0
    for name, y in b.items():
        x = a[name]
        scale = max(float(y.abs().max()), 1e-300)
        err = float((x.cpu() - y.cpu()).abs().max()) / scale
        worst = max(worst, err)
        if err > rtol:
            raise AssertionError(f"{what}: {name} differs by {err:.3e} of "
                                 f"its scale (limit {rtol})")
    return worst


def phase_file_parity(device, over, datasets, workdir):
    """A 24x32 f64 cut of a file-forced path through ``IceModelRun``: the
    card against the CPU, 3 steps, on the same seeded files."""
    from cice4_tpu_torch.driver import IceModelRun

    ny, nx = SMALL["domain.ny_global"], SMALL["domain.nx_global"]
    write_path_files(workdir, datasets, ny, nx)
    cfg = make_config(over, **SMALL, **{
        "forcing.atm_data_dir": str(workdir),
        "forcing.ocn_data_dir": str(workdir),
        "run.history_dir": str(workdir / "history"), "run.diagfreq": 0})
    out = []
    for dev in (device, torch.device("cpu")):
        run = IceModelRun(cfg, dtype=torch.float64, device=dev,
                          log=lambda line: None).initialize()
        if not run.forcing_provider.available:
            raise AssertionError("the parity's files were not found")
        run.run(3)
        out.append(run.state)
    return compare_states(out[0], out[1], STEP_RTOL, "GPU vs CPU run")


def phase_coupled_parity(device, flavor, over, workdir):
    """A 24x32 f64 cut of a coupled path: the component on the card
    against the CPU, 2 intervals of 2 steps from the same seeded imports:
    the state and every export."""
    from cice4_tpu_torch.component import IceComponent
    from cice4_tpu_torch.config import access_om_config

    ny, nx = SMALL["domain.ny_global"], SMALL["domain.nx_global"]
    cfg = access_om_config(nx=nx, ny=ny).with_values(
        **{**over, "run.history_dir": str(workdir / "history"),
           "run.diagfreq": 0})
    runs = []
    for dev in (device, torch.device("cpu")):
        comp = IceComponent(cfg, flavor=flavor, dtype=torch.float64,
                            gfdl_surface_flux=flavor == "om", device=dev,
                            log=lambda *a: None).initialize()
        exports = [comp.run(coupled_imports(flavor, ny, nx, k, dev,
                                            torch.float64), n_steps=2)
                   for k in range(2)]
        runs.append((comp.runner.state, exports))
    worst = compare_states(runs[0][0], runs[1][0], STEP_RTOL,
                           "GPU vs CPU component")
    for ea, eb in zip(runs[0][1], runs[1][1]):
        for side in ("i2o", "i2a"):
            worst = max(worst, compare_dicts(ea[side], eb[side], STEP_RTOL,
                                             f"GPU vs CPU export {side}"))
    return worst


# ---------------------------------------------------------------------------
# phase 16: the decomposed path
# ---------------------------------------------------------------------------


def block_steps(models, states, forcing, mesh, first, nsteps, on_step=None):
    """`nsteps` steps of the blocks this process owns (one thread each)
    from step `first`; `on_step(n, states)` sees each step's block states.
    Returns (block states, each block's last fluxes)."""
    from cice4_tpu_torch.convert import scatter_blocks
    from cice4_tpu_torch.guards import raise_on_violation

    fluxes = None
    for n in range(first, first + nsteps):
        yday = YDAY0 + n * DT / 86400.0
        fb = scatter_blocks(forcing(yday, 0.0), mesh)

        def step(b, fb=fb, yday=yday, states=states):
            k = mesh.local_blocks.index(b)
            return models[k](states[k], fb[k], yday, 0.0)

        outs = mesh.run(step)
        states = [o[0] for o in outs]
        fluxes = [o[1] for o in outs]
        raise_on_violation(fluxes[0]["_guards"])   # the global records
        if on_step is not None:
            on_step(n, states)
    return states, fluxes


def decompose(model, state, shape):
    """(mesh, block models, block states) of a one-device model and
    state on a `shape` mesh in this process."""
    from cice4_tpu_torch.convert import scatter_blocks
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(*shape)
    models = [Model(model.cfg, g) for g in scatter_blocks(model.grid, mesh)]
    return mesh, models, scatter_blocks(state, mesh)


def one_device_states(model, state, forcing, nsteps):
    """The one-device states after each of `nsteps` steps."""
    out = []
    for n in range(nsteps):
        yday = YDAY0 + n * DT / 86400.0
        state, _ = model(state, forcing(yday, 0.0), yday, 0.0)
        out.append(state)
    return out


def drive_decomposed(tag, model, state, forcing, shape, nsteps, expect,
                     rtol):
    """Counts to 0, `nsteps` decomposed steps, counts read (against
    `expect`, no plain version, the gathered phases counted), each step's
    gathered state held against the one-device step's within `rtol` of
    the field's scale.  Returns (mesh, block models, block states, the
    counts, the worst difference, whether every step was bit-equal)."""
    from cice4_tpu_torch.convert import gather_blocks
    from cice4_tpu_torch.parallel import halo as h

    refs = one_device_states(model, state, forcing, nsteps)
    mesh, models, states = decompose(model, state, shape)
    worst, equal = [0.0], [True]

    def check(n, blocks):
        full = gather_blocks(blocks, mesh)
        worst[0] = max(worst[0], compare_states(
            full, refs[n], rtol, f"{tag}: decomposed vs one device, step "
            f"{n + 1}"))
        ref = dict(state_tensors(refs[n]))
        equal[0] &= all(torch.equal(x, ref[k])
                        for k, x in state_tensors(full))

    gathered0 = dict(h.gathered_phase.names)
    with counting_plain_calls() as plain_calls:
        reset_counts()
        states, fluxes = block_steps(models, states, forcing, mesh, 0, nsteps,
                                     on_step=check)
        torch.cuda.synchronize()
        counts = read_counts()
    gathered = {k: v - gathered0.get(k, 0)
                for k, v in h.gathered_phase.names.items()
                if v - gathered0.get(k, 0)}
    log(f"  {tag}: launches {counts}; plain versions called "
        f"{plain_calls or 'none'}; gathered phases {gathered or 'none'}; "
        f"ridge iterations of the last step {int(fluxes[0]['_ridge_niter'])}; "
        f"worst difference from one device "
        f"{worst[0]:.3e} of the field's scale (limit {rtol}); bit-equal "
        f"at every step: {equal[0]}")
    if counts != expect:
        raise AssertionError(f"{tag}: launches {counts}, expected {expect}")
    if plain_calls:
        raise AssertionError(f"{tag}: plain versions ran: {plain_calls}")
    full = gather_blocks(states, mesh)
    amin, amax, n_north, n_south, umax = check_physical(model.grid, full,
                                                        True)
    log(f"  guards clean; state finite; aice in [{amin:.3g}, {amax:.6g}]; "
        f"icy cells north of 70N {n_north}, south of 60S {n_south}; max "
        f"|u|,|v| {umax:.4g} m/s")
    return (mesh, models, states, counts, gathered, worst[0], equal[0],
            refs)


def time_decomposed(tag, model, state, forcing, mesh, models, states, first,
                    card):
    """ms/step by CUDA events of the one-device and the decomposed step
    over DECOMP_TIMED steps, and the device time and launches of one step
    of each (torch.profiler), with the EVP kernel's share."""
    start, end = _events()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    block_steps(models, states, forcing, mesh, first, DECOMP_TIMED)
    end.record()
    torch.cuda.synchronize()
    ms_dec = start.elapsed_time(end) / DECOMP_TIMED
    host_dec = (time.perf_counter() - t0) * 1e3 / DECOMP_TIMED
    ms_one, host_one, _ = time_path(model, state, forcing, DECOMP_TIMED,
                                    first=first)
    yday = YDAY0 + first * DT / 86400.0
    _, rows_one = profiled(lambda: model(state, forcing(yday, 0.0), yday,
                                         0.0))
    _, rows_dec = profiled(lambda: block_steps(models, states, forcing, mesh,
                                               first, 1))

    def evp(rows, key=("evp_persistent", "evp_round_tiles")):
        sel = [r for r in rows if any(k in r[0] for k in key)]
        return sum(r[1] for r in sel), sum(r[2] for r in sel)

    for name, rows, ms, host in (("one device", rows_one, ms_one, host_one),
                                 (f"{mesh.py}x{mesh.px} blocks", rows_dec,
                                  ms_dec, host_dec)):
        if not rows:
            log(f"  {tag}, {name}: {ms:.3f} ms/step (CUDA events), "
                f"{host:.3f} ms/step (host clock); profiler: no device time "
                f"(not measured); card: {card}")
            continue
        dev = sum(r[1] for r in rows)
        n = sum(r[2] for r in rows)
        evp_ms, evp_n = evp(rows)
        rounds_ms, rounds_n = evp(rows, ("evp_round_tiles",))
        log(f"  {tag}, {name}: {ms:.3f} ms/step (CUDA events, "
            f"{DECOMP_TIMED} steps after {first}), {host:.3f} ms/step (host "
            f"clock); one step: {dev:.3f} ms device time in {n} launches "
            f"({100 * dev / ms:.1f}% busy); the EVP {evp_ms:.4f} ms in "
            f"{evp_n} launches (the round kernel {rounds_ms:.4f} ms in "
            f"{rounds_n}, the final subcycle's evp_subcycle "
            f"{evp_ms - rounds_ms:.4f} in {evp_n - rounds_n}; before the "
            f"round kernel, 2.9223 ms in 52 at 2x2); card: {card}")
    return ms_one, ms_dec


def capture_rounds(models, states, forcing, mesh, first):
    """The arguments of the first round kernel call of one decomposed
    step (the step's results are discarded)."""
    from cice4_tpu_torch.ops import evp_cuda

    real = evp_cuda.evp_rounds
    seen = []

    def record(*args):
        if not seen:
            seen.append(args)
        return real(*args)

    record.launches = 0
    evp_cuda.evp_rounds = record
    try:
        block_steps(models, states, forcing, mesh, first, 1)
    finally:
        evp_cuda.evp_rounds = real
    return seen[0]


def launch_processes(tag, nprocs, args, workdir):
    """`python -m cice4_tpu_torch.parallel.launch` as `nprocs` processes
    of one group on this machine; returns their outputs (each must exit
    0)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "cice4_tpu_torch.parallel.launch", *args]
    procs, logs = [], []
    for i in range(nprocs):
        env = dict(os.environ, CICE4_DISTRIBUTED="1",
                   CICE4_COORDINATOR=f"127.0.0.1:{port}",
                   CICE4_NUM_PROCESSES=str(nprocs), CICE4_PROCESS_ID=str(i),
                   OMP_NUM_THREADS="1")
        out = open(workdir / f"{tag}{i}.log", "w")
        logs.append(out)
        procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                      stderr=subprocess.STDOUT,
                                      cwd=Path(__file__).resolve().parent))
    try:
        for proc in procs:
            proc.wait(timeout=LAUNCH_TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for out in logs:
            out.close()
    texts = [(workdir / f"{tag}{i}.log").read_text() for i in range(nprocs)]
    for i, (proc, text) in enumerate(zip(procs, texts)):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("MESH", "CHECKSUM", "RESTART", "DONE"))]
        log(f"    process {i}: exit {proc.returncode}; " + "; ".join(lines))
        if proc.returncode != 0:
            raise AssertionError(f"{tag}: process {i} failed:\n"
                                 f"{text[-3000:]}")
    return texts


def saved_state(path, like):
    """A state written by the launcher's --save, as tensors like `like`."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    out = {}
    for name, t in state_tensors(like):
        key = next(k for k in flat if k == name or k.endswith("." + name))
        out[name] = torch.as_tensor(flat[key]).to(t.device)
    return out


def compare_saved(tag, path, ref, rtol):
    """Worst difference of a saved state from `ref` (to the field's
    scale) and whether it is bit-equal."""
    got = saved_state(path, ref)
    worst, equal = 0.0, True
    for name, t in state_tensors(ref):
        x = got[name]
        if not t.is_floating_point():
            equal &= torch.equal(x, t)
            if not torch.equal(x, t):
                raise AssertionError(f"{tag}: {name} differs")
            continue
        err = float((x - t).abs().max()) / max(float(t.abs().max()), 1e-300)
        worst = max(worst, err)
        equal &= torch.equal(x, t)
        if err > rtol:
            raise AssertionError(f"{tag}: {name} differs by {err:.3e} of "
                                 f"its scale (limit {rtol})")
    return worst, equal


def rounds_a_step(ndte, H):
    """(rounds, round kernel launches) of a block's EVP a step: ndte - 1
    gated subcycles in rounds of H - 1 and the remainder, each round in
    the launches `evp_cuda.round_plan` gives it in f32."""
    from cice4_tpu_torch.ops import evp_cuda

    k = H - 1
    ks = [k] * ((ndte - 1) // k) + ([(ndte - 1) % k] if (ndte - 1) % k
                                    else [])
    return len(ks), sum(len(evp_cuda.round_plan(x, torch.float32)[2])
                        for x in ks)


def phase_decomposed(device, card, workdir):
    """Paths (o)-(r) of the decomposed model; returns the counts of (o)
    and the arguments of its first round kernel call."""
    from cice4_tpu_torch.config import access_om_config
    from cice4_tpu_torch.convert import gather_blocks
    from cice4_tpu_torch.kernel_check import DECOMP_RTOL
    from cice4_tpu_torch.ops import evp_sharded

    rtol = DECOMP_RTOL[torch.float32]
    nb = DECOMP_MESH[0] * DECOMP_MESH[1]

    # (o) gx1 at full width on 2x2 blocks in one process
    cfg = make_config(MAIN)
    ndte = cfg.dynamics.ndte
    model, state, forcing = make_run(cfg, device, torch.float32)
    by = cfg.domain.ny_global // DECOMP_MESH[0]
    bx = cfg.domain.nx_global // DECOMP_MESH[1]
    H = min(evp_sharded.DEFAULT_H, by, bx)
    rounds, round_calls = rounds_a_step(ndte, H)
    tag = (f"(o) gx1 {cfg.domain.ny_global}x{cfg.domain.nx_global} on "
           f"{DECOMP_MESH[0]}x{DECOMP_MESH[1]} blocks of {by}x{bx}")
    log(f"  {tag}: EVP halo {H}, {rounds} rounds ({round_calls} round "
        f"kernel launches) + the final subcycle's launch a block and step "
        f"(padded {by + 2 * H}x{bx + 2 * H}), remap halo 6 (padded "
        f"{by + 12}x{bx + 12})")
    n = DECOMP_STEPS
    # the final subcycle's launch on a padded block is the EVP kernel's
    # doubly cyclic (whole-grid) mode
    (mesh, models, states, counts, gathered, worst, equal,
     refs) = drive_decomposed(
        tag, model, state, forcing, DECOMP_MESH, n,
        expected(nb * n, therm_newton=nb * n, evp_subcycle=nb * n,
                 evp_wholegrid=nb * n, evp_rounds=nb * round_calls * n,
                 remap_gsh=nb * n, remap_k12=nb * n), rtol)
    if gathered:
        raise AssertionError(f"{tag}: gathered phases {gathered} where the "
                             f"k-halo paths should run")
    ms_one, ms_dec = time_decomposed(tag, model, refs[-1], forcing, mesh,
                                     models, states, n, card)
    rounds_args = capture_rounds(models, states, forcing, mesh, n)
    _, rounds_ms, _, _, _ = measure_kernel("evp_rounds", rounds_args, card,
                                           where="(o)'s first round's")
    log_design("evp_rounds", rounds_args, rounds_ms)

    # (p) ACCESS-OM2 at 1 degree: the U-fold into the EVP rounds and the
    # remap, whose northern blocks remap the fold's strip once more a step
    pcfg = access_om_config(nx=ACCESS1[1], ny=ACCESS1[0])
    pmodel, pstate, pforce = make_run(pcfg, device, torch.float32)
    pby, pbx = ACCESS1[0] // DECOMP_MESH[0], ACCESS1[1] // DECOMP_MESH[1]
    pH = min(evp_sharded.DEFAULT_H, pby - 1, pbx)
    prounds = rounds_a_step(pcfg.dynamics.ndte, pH)[1]
    ptag = (f"(p) ACCESS-OM2 {ACCESS1[0]}x{ACCESS1[1]} (tripole) on "
            f"{DECOMP_MESH[0]}x{DECOMP_MESH[1]} blocks")
    m = 2
    remaps = (nb + DECOMP_MESH[1]) * m
    pgathered = drive_decomposed(
        ptag, pmodel, pstate, pforce, DECOMP_MESH, m,
        expected(nb * m, therm_newton=nb * m, evp_subcycle=nb * m,
                 evp_wholegrid=nb * m, evp_rounds=nb * prounds * m,
                 remap_gsh=remaps, remap_k12=remaps), rtol)[4]
    if pgathered:
        raise AssertionError(f"{ptag}: gathered phases {pgathered} where the "
                             f"k-halo paths should run")

    # (q) the multi-process entry: two processes over gloo, then one over
    # nccl
    common = ["--preset", "gx1", "--set", "grid.kmt_file=''", "--steps",
              str(LAUNCH_STEPS), "--device", "cuda"]
    log(f"  (q) python -m cice4_tpu_torch.parallel.launch, gx1, "
        f"{LAUNCH_STEPS} steps: 2 processes over gloo (1x2 blocks; gloo "
        f"sends CPU tensors, so the strips go through pinned host buffers), "
        f"the sharded restart written and read back")
    texts = launch_processes(
        "gloo", 2, common + ["--backend", "gloo", "--mesh", "1x2",
                             "--save", str(workdir / "gloo.npz"),
                             "--restart-dir", str(workdir / "restart")],
        workdir)
    sums = [re.search(r"CHECKSUM \d (.+)", t).group(1) for t in texts]
    if sums[0] != sums[1] or "RESTART_OK" not in texts[0] \
            or "backend gloo" not in texts[0]:
        raise AssertionError(f"(q) gloo: checksums {sums}, restart "
                             f"{'RESTART_OK' in texts[0]}")
    ref_q = refs[LAUNCH_STEPS - 1]
    worst_q, equal_q = compare_saved("(q) gloo 1x2", workdir / "gloo.npz",
                                     ref_q, rtol)
    log(f"  (q) gloo, 2 processes: state against the one-device steps: "
        f"worst {worst_q:.3e} of the field's scale (limit {rtol}), "
        f"bit-equal {equal_q}")
    log("  (q) 1 process over nccl (world size 1, one block)")
    texts = launch_processes(
        "nccl", 1, common + ["--backend", "nccl",
                             "--save", str(workdir / "nccl.npz")], workdir)
    if "backend nccl" not in texts[0]:
        raise AssertionError("(q) nccl: the group is not nccl")
    _, equal_n = compare_saved("(q) nccl 1x1", workdir / "nccl.npz",
                               ref_q, 0.0)
    log(f"  (q) nccl, world size 1: bit-equal to the one-device steps "
        f"{equal_n}")
    if not equal_n:
        raise AssertionError("(q) nccl: the one-block run is not bit-equal "
                             "to one device")

    # (r) 24x32 f64 cuts on 2x2 blocks, the card against the CPU
    for name, scfg in (("gx1", make_config(MAIN, **SMALL)),
                       ("all-ocean tripole", box_config(**TRIPOLE_SMALL))):
        out = []
        for dev in (device, torch.device("cpu")):
            smodel, sstate, sforce = make_run(scfg, dev, torch.float64)
            smesh, smodels, sstates = decompose(smodel, sstate, DECOMP_MESH)
            sstates, _ = block_steps(smodels, sstates, sforce, smesh, 0, 3)
            out.append(gather_blocks(sstates, smesh))
        worst_r = compare_states(out[0], out[1], STEP_RTOL,
                                 f"(r) {name}: decomposed, card vs CPU")
        log(f"  (r) {name} 24x32 f64 on 2x2 blocks, card vs CPU, 3 steps: "
            f"worst difference {worst_r:.3e} of the field's scale (limit "
            f"{STEP_RTOL})")
    return dict(counts=counts, rounds_args=rounds_args, ms_one=ms_one,
                ms_dec=ms_dec, bit_equal=equal, worst=worst)


# ---------------------------------------------------------------------------
# phases 18-19: the deep column and the bench
# ---------------------------------------------------------------------------


def phase_deep(device, card):
    """gx1 with DEEP's 10 ice layers, DEEP_STEPS steps with the counters:
    the four kernels of the default route once a step, therm_newton by its
    generic instance, no plain version, a physical state; therm_newton
    against its plain version at this path's inputs, both timed.  Returns
    {"therm_newton": (launches, ms, bound_ms, max |d|)} and the plain
    version's ms."""
    from cice4_tpu_torch.ops import therm_vertical as tv

    cfg = make_config(DEEP)
    before = tv._temperature_changes_cuda.generic_launches
    model, state, forcing, _, _ = drive_path(
        "deep column", cfg, device, DEEP_STEPS,
        expected(DEEP_STEPS, therm_newton=DEEP_STEPS,
                 evp_subcycle=DEEP_STEPS,
                 remap_gsh=DEEP_STEPS, remap_k12=DEEP_STEPS), moving=True)
    launches = read_counts()
    generic = tv._temperature_changes_cuda.generic_launches - before
    log(f"  deep column: therm_newton's generic instance launched {generic} "
        f"times in {DEEP_STEPS} steps; eicen {tuple(state.eicen.shape)}")
    if generic != DEEP_STEPS:
        raise AssertionError(f"deep column: the generic instance launched "
                             f"{generic} times, expected {DEEP_STEPS}")
    args = capture_kernel_inputs(model, state, forcing, ["therm_newton"],
                                 yday=YDAY0 + DEEP_STEPS * DT / 86400.0)
    err, ms, plain_ms, bound_ms, _ = measure_kernel(
        "therm_newton", args["therm_newton"], card,
        where="the deep column's (nilyr 10)")
    for layers in ((10, 1), (4, 1)):
        occ = tv.therm_newton_generic_occupancy(*layers, torch.float32)
        log(f"  the generic instance at {layers}, f32, as the runtime "
            f"reports it: {occ['registers']} registers and "
            f"{occ['local_bytes']} local bytes a thread, {occ['threads']} "
            f"threads a block, {occ['blocks_per_sm']} blocks "
            f"({occ['warps_per_sm']} warps) an SM")
    p4 = layer_params(args["therm_newton"][0], 4, 1)
    time_newton_layers(p4, device, card)
    return {"therm_newton": (launches["therm_newton"], ms, bound_ms,
                             err)}, plain_ms


def phase_bench():
    """``python -m cice4_tpu_torch bench`` under each BENCH_CONFIGS, each in
    a process of its own: the JAX bench's one JSON line last on stdout,
    each default-route kernel launched once a timed step."""
    root = Path(__file__).resolve().parent
    for which in BENCH_CONFIGS:
        env = {**os.environ, "PYTHONPATH": str(root), "BENCH_CONFIG": which}
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "cice4_tpu_torch",
                              "bench"], capture_output=True, text=True,
                             timeout=BENCH_TIMEOUT_S, cwd=root, env=env)
        seconds = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or not lines:
            raise AssertionError(f"bench {which} exited {res.returncode}:\n"
                                 f"{res.stdout}\n{res.stderr}")
        for line in res.stderr.strip().splitlines():
            log(f"  bench {which} stderr: {line}")
        log(f"  bench {which} stdout ({len(lines)} line(s), exit 0, "
            f"{seconds:.1f} s with start-up): {lines[-1]}")
        got = json.loads(lines[-1])
        if list(got) != ["metric", "value", "unit", "vs_baseline"] or \
                got["metric"] != f"{which} full-model cell-steps/s (1 chip)" \
                or got["unit"] != "cell-steps/s":
            raise AssertionError(f"bench {which}: not the JAX bench's line: "
                                 f"{lines[-1]}")
        if not (got["value"] > 0.0
                and got["vs_baseline"] == got["value"] / 3.55e4):
            raise AssertionError(f"bench {which}: value {got['value']}, "
                                 f"vs_baseline {got['vs_baseline']}")
        counts = re.search(r"# launches in the timed steps: (.*)",
                           res.stderr)
        steps = re.search(r"# (\d+) steps in ", res.stderr)
        if counts is None or steps is None:
            raise AssertionError(f"bench {which}: no launch counts on "
                                 f"stderr")
        launched = {k: int(n) for k, n in (
            item.rsplit(" ", 1) for item in counts.group(1).split(", "))}
        want = dict.fromkeys(DEFAULT_ROUTE, int(steps.group(1)))
        if launched != want:
            raise AssertionError(f"bench {which}: launches {launched}, "
                                 f"expected {want}")
        log(f"  bench {which}: each default-route kernel launched once a "
            f"timed step ({launched}); a wrapper on a CUDA tensor launches "
            f"its kernel or raises, so no plain version ran")


# ---------------------------------------------------------------------------
# phase 20: timing
# ---------------------------------------------------------------------------


def time_path(model, state, forcing, nsteps, first=NSTEPS):
    """(ms per step by CUDA events, by the host clock, ridge iterations)
    of `nsteps` steps after step `first`."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    state, ridge, _ = run_steps(model, state, forcing, nsteps, first=first,
                                check=False)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / nsteps
    return start.elapsed_time(end) / nsteps, host_ms, ridge


def capture_kernel_inputs(model, state, forcing, names, yday=None):
    """The arguments one step of a path (at day `yday`, by default the
    one after the main path's steps) passes to the wrappers of the kernels
    `names` (the step's results are discarded)."""
    with recording(names) as seen:
        if yday is None:
            yday = YDAY0 + NSTEPS * DT / 86400.0
        model(state, forcing(yday, 0.0), yday, 0.0)
    return seen


@contextlib.contextmanager
def recording(names):
    """{kernel: the arguments of the first call of its wrapper} for the
    kernels `names`, filled while the block runs (those passed by keyword
    in their places)."""
    import inspect

    table = sites()
    by_site = {}
    for name in names:
        mod, attr, _ = table[name]
        by_site.setdefault((mod, attr), []).append(name)
    real = {site: getattr(*site) for site in by_site}
    seen = {}

    def recorder(site):
        sig = inspect.signature(real[site])

        def record(*args, **kwargs):
            for name in by_site[site]:
                seen.setdefault(name, sig.bind(*args, **kwargs).args)
            return real[site](*args, **kwargs)
        record.launches = record.ns_cyclic_launches = 0
        return record

    for site in by_site:
        setattr(*site, recorder(site))
    try:
        yield seen
    finally:
        for site, fn in real.items():
            setattr(*site, fn)


def kernel_and_plain(name, args):
    """(kernel call, plain call) on the captured arguments; ridging's
    guard, a check of its result that reads the device on the host, is
    left out of both."""
    mod, attr, plain = sites()[name]
    kern = getattr(mod, attr)
    if name == "ridge_column":
        args = tuple(args[:8]) + (False,)
    return (lambda: kern(*args)), (lambda: plain(*args))


def _events():
    return (torch.cuda.Event(enable_timing=True) for _ in range(2))


def device_ms(fn, reps):
    """Device time per call of `fn`: a sleep kernel keeps the card busy
    while the host enqueues the calls, so the events bracket only device
    work."""
    fn()
    torch.cuda.synchronize()
    start, end = _events()
    torch.cuda._sleep(200_000_000)      # ~0.1 s: outlasts the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kern, plain, reps_kernel=50, reps_plain=3):
    """Kernel and plain-version times, in the order plain, kernel, kernel,
    plain.  For the kernel, `device` is the device time per launch
    (`device_ms`); `call` is the wall time per call including the
    wrapper's host work.  The plain versions synchronise with the host or
    are host-bound, so only their wall time is meaningful."""
    def wall(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = _events()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    plain1 = wall(plain, reps_plain)
    k1 = (device_ms(kern, reps_kernel), wall(kern, reps_kernel))
    k2 = (device_ms(kern, reps_kernel), wall(kern, reps_kernel))
    plain2 = wall(plain, reps_plain)
    return (k1, k2), (plain1, plain2)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def unique_bytes(obj):
    """Bytes of the distinct elements of every tensor in `obj`: a
    broadcast (zero-stride) dimension counts once."""
    total = 0
    for t in _tensors(obj):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            if stride != 0:
                n *= size
        total += n * t.element_size()
    return total


def bound(name, args, out):
    """(bound_ms, bound_by, bytes, operations) of one call: the bytes its
    function must move (each input read once, each output written once)
    over the card's memory rate, against the operations this call's data
    needs over the card's peak rate for the type."""
    from cice4_tpu_torch.ops.remap import _n_type1

    def recon_ops(meta):
        n1 = _n_type1(meta)
        return OPS_K12_MASS + n1 * OPS_K12_T1 + (len(meta) - n1) * OPS_K12_T2

    def contract_ops(meta, rows):
        """Per cell, the 9 offsets' terms of `rows` rows, row 0 mass only."""
        n1 = _n_type1(meta)
        tracers = n1 * OPS_K12_OFF_T1 + (len(meta) - n1) * OPS_K12_OFF_T2
        return 9 * (rows * OPS_K12_OFF_MASS + (rows - 1) * tracers)

    if name == "therm_newton":
        nbytes = unique_bytes(args[2:]) + unique_bytes(out)
        p = args[0]
        ops = (OPS_NEWTON_FIXED + OPS_NEWTON_ROW * (p.nslyr + p.nilyr + 1)) \
            * float(out["niter_cells"].sum())
        dtype = args[-1].dtype
    elif name in ("evp_subcycle", "evp_wholegrid"):
        p, grid = args[0], args[1]
        nbytes = unique_bytes(args[2:]) + unique_bytes(
            [getattr(grid, k) for k in ("cyp", "cxp", "cym", "cxm", "dxt",
                                        "dyt", "dxhy", "dyhx", "tinyarea",
                                        "uarear")]) + unique_bytes(out)
        n_t, n_u = float(args[3].sum()), float(args[4].sum())
        ncell = grid.ny * grid.nx
        ops = ((p.ndte - 1) * (OPS_EVP_STRESS * n_t + OPS_EVP_MOMENTUM * n_u)
               + (OPS_EVP_STRESS + OPS_EVP_FINAL_SUMS) * ncell
               + OPS_EVP_MOMENTUM * n_u)
        dtype = args[-1].dtype
    elif name == "evp_rounds":
        # p.ndte gated subcycles over the padded block's active cells
        p, grid = args[0], args[1]
        nbytes = unique_bytes(args[2:]) + unique_bytes(
            [getattr(grid, k) for k in ("cyp", "cxp", "cym", "cxm", "dxt",
                                        "dyt", "dxhy", "dyhx", "tinyarea",
                                        "uarear")]) + unique_bytes(out)
        n_t, n_u = float(args[3].sum()), float(args[4].sum())
        ops = p.ndte * (OPS_EVP_STRESS * n_t + OPS_EVP_MOMENTUM * n_u)
        dtype = args[-1].dtype
    elif name in ("remap_gsh", "remap_ga"):
        dx, order = args[0], args[4]
        nbytes = unique_bytes(args[:3]) + unique_bytes(out)
        ops = OPS_GSH_CELL[order] * dx.numel()
        dtype = dx.dtype
    elif name == "remap_k12":
        gsh, hm, mm, tm, meta = args[:5]
        nbytes = unique_bytes(args[:4]) + unique_bytes(out)
        rows = mm.shape[0]
        ops = hm.numel() * (OPS_K12_MASS + (rows - 1) * recon_ops(meta)
                            + contract_ops(meta, rows))
        dtype = hm.dtype
    elif name == "remap_construct":
        hm, mm, tm, meta = args[:4]
        nbytes = unique_bytes(args[:3]) + unique_bytes(out)
        ops = hm.numel() * mm.shape[0] * recon_ops(meta)
        dtype = hm.dtype
    elif name == "gfdl_column":
        # the ten inputs read once, the nine outputs written once
        nbytes = unique_bytes(args) + unique_bytes(out)
        ops = 0.0
        dtype = args[0].dtype
    elif name in COLUMN_KERNELS:
        from cice4_tpu_torch.kernel_check import column_bytes

        # ridging's advected open water, aice0, may be None
        st = args[0]
        nbytes = column_bytes(st, name, aice0=name == "cleanup_column"
                              or args[7] is not None)
        ops = 0.0
        dtype = st.aicen.dtype
    else:  # remap_contract
        ga, mass, trc, par, meta = args[:5]
        nbytes = unique_bytes(args[:4]) + unique_bytes(out)
        ops = mass[0, 0].numel() * contract_ops(meta, mass.shape[0])
        dtype = mass.dtype
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def compare_column_call(kern, plain):
    """``kernel_check.compare_columns``' (report, tracer elements left out
    that differ) of a column kernel's wrapper's (state, diagnostics)
    against its plain version's."""
    from cice4_tpu_torch import kernel_check as kc

    (kst, kx), (pst, px) = kern, plain
    return kc.compare_columns(kst, kx, pst, px,
                              kc.COLUMN_RTOL[pst.aicen.dtype])


def max_abs_err(name, kern, plain):
    """Largest |kernel - plain| over the outputs of one call."""
    from cice4_tpu_torch import kernel_check as kc

    if name in COLUMN_KERNELS:
        rep, _ = compare_column_call(kern, plain)
        return max(v["max_abs"] for v in rep.values())
    if name == "gfdl_column":
        return max(float((kern[k] - plain[k]).abs().max()) for k in plain)
    if name == "therm_newton":
        return max(float((kern[k] - plain[k]).abs().max())
                   for k in ("Tsf", "Tsn", "Tin"))
    if name in ("evp_subcycle", "evp_wholegrid"):
        kern, plain = kc.evp_named(kern), kc.evp_named(plain)
        return max(float((kern[k] - plain[k]).abs().max()) for k in plain)
    if name in ("remap_gsh", "remap_ga"):
        return float((kern - plain).abs().max())
    return max(float((a - b).abs().max()) for a, b in zip(kern, plain))


def within_tolerance(name, args, kern, plain):
    """(ok, worst |kernel - plain| / (|plain| + max|plain|) over the
    outputs): the kernel against its plain version under its tolerance in
    ``kernel_check``, as phase 3 holds it."""
    from cice4_tpu_torch import kernel_check as kc

    if name == "therm_newton":
        rep = kc.compare(kern, plain, args[2], args[-1].dtype)
        return rep["ok"], max(v["max_rel"] for v in rep["fields"].values())
    if name in COLUMN_KERNELS:
        rep, _ = compare_column_call(kern, plain)
        return kc.fields_ok(rep), max(v["max_rel"] for v in rep.values())
    if name == "gfdl_column":
        rep = kc.compare_gfdl(kern, plain)
        return (kc.gfdl_ok(rep, args[0].dtype),
                max(v["point_gap"] for v in rep.values()))
    if name in ("evp_subcycle", "evp_wholegrid"):
        kern, plain, rtol = kc.evp_named(kern), kc.evp_named(plain), \
            kc.EVP_RTOL
    elif name in ("remap_gsh", "remap_ga"):
        kern, plain, rtol = {"gsh": kern}, {"gsh": plain}, kc.GSH_RTOL
    else:
        rtol = {"remap_k12": kc.K12_RTOL, "remap_construct": kc.K1_RTOL,
                "remap_contract": kc.K2_RTOL,
                "evp_rounds": kc.ROUNDS_RTOL}[name]
        kern, plain = dict(enumerate(kern)), dict(enumerate(plain))
    rep = kc.compare_fields(kern, plain, rtol[plain[next(iter(plain))].dtype])
    return kc.fields_ok(rep), max(v["max_rel"] for v in rep.values())


def log_columns(name, args, ms):
    """What a column kernel ran at a path's inputs: the tracer elements
    that differ from the plain version under a parent below puny (left out
    of its check); for ridging, the most passes of any column against the
    plain loop's, the columns of three or more, and the launch's device
    time without the wrapper's reductions (the pass count's maximum and
    the guard)."""
    from cice4_tpu_torch.ops import ridge_cuda

    kern_fn, plain_fn = kernel_and_plain(name, args)
    kern, plain = kern_fn(), plain_fn()
    _, left_out = compare_column_call(kern, plain)
    log(f"    {left_out} tracer elements under a parent below puny differ "
        f"from the plain version's (left out of the check)")
    if name == "ridge_column":
        def launch():
            return ridge_cuda.ridge_ice_cuda(*args[:8])
        niter = launch()[3]
        alone = device_ms(launch, 50)
        log(f"    passes: {int(niter.max())} (plain {plain[1]['niter']}), "
            f"columns of 3 or more {int((niter >= 3).sum())}; the launch "
            f"alone {alone:.4f} ms, the wrapper's reductions "
            f"{ms - alone:.4f} of the {ms:.4f} ms")


def ptxas_lines(library, entry):
    """ptxas's lines for the kernel whose mangled name holds `entry`."""
    from cice4_tpu_torch import cuda_build

    out, inside = [], False
    for line in cuda_build.load(library).log.splitlines():
        if "Compiling entry function" in line:
            inside = entry in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def what_binds(nbytes, ops, ms, dtype, device):
    """A line on what binds a kernel that took `ms` a call: a PyTorch copy
    of as many bytes, and its operation rate against the rate the card
    issues them without FMA (each operation an instruction)."""
    buf = torch.empty(nbytes // 8, dtype=torch.float32, device=device)
    copy = device_ms(buf.clone, 50)
    rate = ops / (ms * 1e-3)
    no_fma = PEAK_OPS_PER_S[dtype] / 2
    return (f"a PyTorch copy of as many bytes ({nbytes / 2e6:.2f} MB read, "
            f"as many written) {copy:.4f} ms, {100 * copy / ms:.1f}% of the "
            f"kernel's {ms:.4f}; {ops / 1e9:.4g} G operations at "
            f"{rate / 1e12:.2f} T/s, {100 * rate / no_fma:.1f}% of the "
            f"{no_fma / 1e12:.1f} T/s the card issues without FMA")


def log_design(name, args, ms):
    """Log what the EVP kernel, the round kernel and the remap kernels
    K0, K12, K1 and K2 ran at a path's inputs, as the kernels and the
    runtime report it; the EVP kernel's time without ice (its grid
    barriers, active lists and final full-grid subcycle alone); the round
    kernel's tiles, those with ice and its recompute share; K0's share of
    halo moments computed again; and what binds K0, K1 and K2 (a copy of
    their bytes, their operation rate, for K1 and K2 their time without
    tracers).  Call it
    right after `measure_kernel`, whose last kernel call was at `args` and
    took `ms`."""
    if name in COLUMN_KERNELS:
        log_columns(name, args, ms)
    elif name == "gfdl_column":
        from cice4_tpu_torch.ops import gfdl_cuda, gfdl_flux

        passes = gfdl_cuda.mo_passes(args[0].device)
        passes.zero_()
        gfdl_flux.gfdl_ocean_fluxes(*args)
        entry = "gfdl_columnIf" if args[0].dtype == torch.float32 \
            else "gfdl_columnId"
        log(f"    the most Newton passes of a cell {int(passes)} (cap "
            f"{gfdl_flux.MO_MAX_ITER}), {int(args[9].sum())} open-water "
            f"cells of {args[9].numel()}; ptxas: "
            f"{ptxas_lines('gfdl_column', entry)}")
    elif name in ("evp_subcycle", "evp_wholegrid"):
        from cice4_tpu_torch.ops import evp_cuda

        ran = evp_cuda.last_launch()
        resident = ran["blocks"] * ran["threads_per_block"]
        beyond = (max(0, ran["active_t_cells"] - resident)
                  + max(0, ran["active_u_points"] - resident))
        log(f"    the launch reported: {ran}; so {beyond} active entries "
            f"lay beyond its {resident} resident threads")
        p, dtype = args[0], args[-1].dtype
        ice_free = list(args)
        ice_free[3] = torch.zeros_like(args[3])
        ice_free[4] = torch.zeros_like(args[4])
        t_free = {}
        for ndte in (p.ndte, 1):
            q = dataclasses.replace(p, ndte=ndte)
            t_free[ndte] = device_ms(
                lambda q=q: evp_cuda.evp_subcycle(q, *ice_free[1:]), 50)
            log(f"    the same grid without ice, ndte {ndte}: "
                f"{t_free[ndte]:.4f} ms per call, "
                f"{evp_cuda.last_launch()['grid_barriers']} grid barriers")
        per_barrier = (t_free[p.ndte] - t_free[1]) / (2 * (p.ndte - 1))
        log(f"    so {1e3 * per_barrier:.3f} us a grid barrier (no ice), "
            f"{t_free[p.ndte]:.4f} of {ms:.4f} ms "
            f"({100 * t_free[p.ndte] / ms:.1f}%) outside the gated passes")
        entry = "evp_persistentIf" if dtype == torch.float32 \
            else "evp_persistentId"
        for fold, lb in (("", "Lb0E"), (", tripole instance", "Lb1E")):
            log(f"    ptxas{fold}: {ptxas_lines('evp_subcycle', entry + lb)}")
    elif name == "evp_rounds":
        from cice4_tpu_torch.ops import evp_cuda

        p, dtype, icet, iceu = args[0], args[-1].dtype, args[3], args[4]
        ny, nx = icet.shape
        rows, cols, launches = evp_cuda.round_plan(p.ndte, dtype)
        sms = torch.cuda.get_device_properties(
            icet.device).multi_processor_count
        tiles = -(-ny // rows) * -(-nx // cols)
        for k in sorted(set(launches)):
            # cells a tile stages, and computes a subcycle on average (the
            # stress pass's region, one ring wider than the momentum's),
            # over its core cells
            staged = (rows + 2 * k) * (cols + 2 * k) / (rows * cols)
            stress = sum((rows + 2 * m + 1) * (cols + 2 * m + 1)
                         for m in range(k)) / (k * rows * cols)
            momentum = sum((rows + 2 * m) * (cols + 2 * m)
                           for m in range(k)) / (k * rows * cols)
            # tiles whose core holds an active cell (the others write
            # zeros), and those whose k-wide apron (cyclic) does
            live = (icet | iceu).to(torch.float32)[None, None]
            cores = torch.nn.functional.max_pool2d(
                live, (rows, cols), stride=(rows, cols), ceil_mode=True)
            wrapped = live[0, 0].repeat(3, 3)[ny - k:2 * ny + k + rows,
                                              nx - k:2 * nx + k + cols]
            aprons = torch.nn.functional.max_pool2d(
                wrapped[None, None], (rows + 2 * k, cols + 2 * k),
                stride=(rows, cols))[0, 0, :-(-ny // rows), :-(-nx // cols)]
            occ = evp_cuda.round_occupancy(rows, cols, k, dtype)
            log(f"    {rows} x {cols} core tiles, apron {k}: "
                f"{occ['smem_bytes']} bytes of "
                f"shared memory a block, {occ['threads']} threads, "
                f"{occ['blocks_per_sm']} block(s) an SM, "
                f"{occ['registers']} registers and {occ['local_bytes']} "
                f"local bytes a thread (as the runtime reports them); "
                f"{tiles} tiles on {ny}x{nx}, {int(cores.sum())} with ice in "
                f"their core (computed), {int(aprons.sum())} in their apron "
                f"({sms} SMs); recompute share: {staged:.2f} "
                f"cells staged, {stress:.2f} stress and {momentum:.2f} "
                f"momentum cells computed a subcycle, a core cell")
        log(f"    a round of {p.ndte} subcycles in launches of {launches}")
        entry = "evp_round_tilesIf" if dtype == torch.float32 \
            else "evp_round_tilesId"
        log(f"    ptxas: {ptxas_lines('evp_rounds', entry)}")
    elif name in ("remap_gsh", "remap_ga"):
        from cice4_tpu_torch.ops import remap_cuda

        dx, order = args[0], args[4]
        dtype, device = dx.dtype, dx.device
        ny, nx = dx.shape
        tile = remap_cuda.gsh_tile(order, dtype, device)
        rows = tile["rows"]
        blocks = -(-nx // 32) * -(-ny // rows)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        # moments computed a call: the tile plus a one-cell halo per block
        halo = (34 * (rows + 2)) / (32 * rows) - 1.0
        log(f"    tile of 32 x {rows} cells, 2 threads a cell, "
            f"{tile['smem_bytes']} bytes of shared memory a block, "
            f"{tile['blocks_per_sm']} block(s) resident an SM (as the "
            f"library and the runtime report them); {blocks} blocks, "
            f"{blocks / (sms * tile['blocks_per_sm']):.2f} waves on {sms} "
            f"SMs; the halo's moments computed again: {100 * halo:.1f}% "
            f"more edges than cells")
        for t, tag in ((torch.float32, "If"), (torch.float64, "Id")):
            for fold, lb in (("", "Lb0E"), (", tripole instance", "Lb1E")):
                entry = f"gsh_fused{tag}Li{order}E{lb}"
                log(f"    ptxas, gsh_fused order {order} {str(t)[6:]}{fold}: "
                    f"{ptxas_lines('remap_gsh', entry)}")
        kern = getattr(remap_cuda, sites()[name][1])
        _, _, nbytes, ops = bound(name, args, kern(*args))
        log(f"    {what_binds(nbytes, ops * (1.0 + halo), ms, dtype, device)}"
            f" (the operations with the halo's)")
    elif name in ("remap_k12", "remap_construct", "remap_contract"):
        from cice4_tpu_torch.ops import remap_cuda
        from cice4_tpu_torch.ops.remap import _n_type1

        meta = args[3] if name == "remap_construct" else args[4]
        dtype, device = args[1].dtype, args[1].device
        tile_of, library, entry = {
            "remap_k12": (remap_cuda.k12_tile, "remap_k12", "k12"),
            "remap_construct": (remap_cuda.construct_tile, "remap_k1k2",
                                "construct"),
            "remap_contract": (remap_cuda.contract_tile, "remap_k1k2",
                               "contract")}[name]
        tile = tile_of(len(meta), _n_type1(meta), dtype, device)
        ny, nx = args[1].shape[-2:]
        blocks = -(-nx // 32) * -(-ny // tile["rows"])
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        log(f"    tile of 32 x {tile['rows']} cells, {tile['smem_bytes']} "
            f"bytes of shared memory a block, {tile['blocks_per_sm']} "
            f"block(s) resident an SM (as the library and the runtime "
            f"report them); {blocks} blocks, "
            f"{blocks / (sms * tile['blocks_per_sm']):.2f} waves on {sms} "
            f"SMs")
        entry += "If" if dtype == torch.float32 else "Id"
        if name == "remap_k12":   # the instances without and with the fold
            for fold, lb in (("", "Lb0E"), (", tripole instance", "Lb1E")):
                log(f"    ptxas{fold}: {ptxas_lines(library, entry + lb)}")
        else:
            log(f"    ptxas: {ptxas_lines(library, entry)}")
        if name == "remap_k12":
            return
        kern = getattr(remap_cuda, sites()[name][1])
        out = kern(*args)
        bound_ms, bound_by, nbytes, ops = bound(name, args, out)
        if name == "remap_contract":
            # the bound of a design that reads the gathered parents
            par = remap_cuda.gather_parents(args[2], meta)
            with_par = bound(name, (*args[:3], par, *args[4:]), out)
            log(f"    bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes / 1e6:.2f} MB: GA, mass, trc, div, divt); with the "
                f"gathered parents an earlier design read, "
                f"{with_par[0]:.4f} ms by {with_par[1]} "
                f"({with_par[2] / 1e6:.2f} MB)")
        # what binds it: the same bytes in a PyTorch copy, its operation
        # rate, and the kernel on the same grid without tracers
        no_tracers = ((*args[:2], args[2][:, :0], [], args[4])
                      if name == "remap_construct"
                      else (*args[:2], args[2][:, :0], None, [], args[5]))
        bare = device_ms(lambda: kern(*no_tracers), 50)
        log(f"    {what_binds(nbytes, ops, ms, dtype, device)}; without "
            f"tracers (mass only) {bare:.4f} ms, so the {len(meta)} tracers "
            f"take {ms - bare:.4f} ms")


def time_newton_layers(p, device, card):
    """Device ms per therm_newton launch on the seeded inputs of
    `kernel_check` at the gx1 shape (5, 384, 320), f32: the register
    instance at the gx1 path's layer counts, the generic instance at the
    same counts and the register instance at NEWTON_TIMED, in the order
    a, b, c, c, b, a; each call held against its plain version."""
    from cice4_tpu_torch import kernel_check
    from cice4_tpu_torch.ops import therm_vertical as tv

    calls = {}
    for q, generic in ((p, False), (p, True),
                       (layer_params(p, *NEWTON_TIMED), False)):
        args = kernel_check.make_inputs(q, 5, 384, 320, seed=11,
                                        device=device, dtype=torch.float32)

        def call(q=q, args=args, generic=generic):
            return tv._temperature_changes_cuda(q, DT, *args,
                                                generic=generic)
        kern = call()
        plain = tv._temperature_changes_core(q, DT, *args)
        torch.cuda.synchronize()
        if not kernel_check.compare(kern, plain, args[0],
                                    torch.float32)["ok"]:
            raise AssertionError(f"therm_newton disagrees at nilyr "
                                 f"{q.nilyr} nslyr {q.nslyr}, generic "
                                 f"{generic}")
        calls[f"{q.nilyr}x{q.nslyr}" + (" generic" if generic else "")] = call
    keys, order = list(calls), []
    for key in keys + keys[::-1]:
        order.append((key, device_ms(calls[key], 50)))
    out = {key: min(t for k, t in order if k == key) for key in calls}
    log(f"  therm_newton on the seeded inputs at (5, 384, 320), f32: "
        + "; ".join(f"nilyr x nslyr {k}: {t:.4f} ms" for k, t in order)
        + f" (device time per launch, in this order); card: {card}")
    return out


def time_generic_at(args, card):
    """therm_newton's generic instance at a path's captured arguments, held
    against the register instance and the plain version there, and both
    instances' device time per launch in the order register, generic,
    generic, register: {"generic_ms": ..., "register_ms": ...}."""
    from cice4_tpu_torch import kernel_check
    from cice4_tpu_torch.ops import therm_vertical as tv

    calls = {"register": lambda: tv._temperature_changes_cuda(*args),
             "generic": lambda: tv._temperature_changes_cuda(
                 *args, generic=True)}
    gen, reg = calls["generic"](), calls["register"]()
    plain = tv._temperature_changes_core(*args)
    torch.cuda.synchronize()
    for ref_name, ref in (("register instance", reg),
                          ("plain version", plain)):
        rep = kernel_check.compare(gen, ref, args[2], args[-1].dtype)
        if not rep["ok"]:
            raise AssertionError(f"therm_newton's generic instance disagrees "
                                 f"with the {ref_name} at the path's inputs")
    order = [(k, device_ms(calls[k], 50))
             for k in ("register", "generic", "generic", "register")]
    out = {f"{k}_ms": min(t for kk, t in order if kk == k) for k in calls}
    log(f"  therm_newton at the gx1 path's inputs, register vs generic "
        f"instance (both within tolerance of each other and of the plain "
        f"version): " + "; ".join(f"{k} {t:.4f} ms" for k, t in order)
        + f" (device time per launch, in this order); card: {card}")
    return out


def evp_graph_capture(args):
    """Whether a CUDA graph captures one evp_subcycle call (its
    cooperative launch) and replays it to the eager result."""
    from cice4_tpu_torch import kernel_check as kc

    kern_fn, _ = kernel_and_plain("evp_subcycle", args)
    eager = kc.evp_named(kern_fn())
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kern_fn()
        graph.replay()
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - the answer is logged
        return f"no ({type(exc).__name__}: {str(exc)[:200]})"
    same = all(torch.equal(eager[k], v)
               for k, v in kc.evp_named(out).items())
    return f"yes, replay {'equals' if same else 'DIFFERS FROM'} the eager call"


def measure_kernel(name, args, card, where=None):
    """Kernel against plain on a path's captured arguments: (max |kernel
    - plain|, kernel device ms per launch, plain ms, bound_ms, bound_by).
    Raises when they disagree beyond the kernel's tolerance.  `where`
    names the path (by default PATH_OF's)."""
    kern_fn, plain_fn = kernel_and_plain(name, args)
    kern, plain = kern_fn(), plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(name, kern, plain)
    ok, worst = within_tolerance(name, args, kern, plain)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"its path's inputs: worst {worst:.3e} of the "
                             f"field's scale")
    reps_plain = 2 if name.startswith("evp") else 3
    kern_ms, plain_ms = time_pair(kern_fn, plain_fn, reps_plain=reps_plain)
    bound_ms, bound_by, nbytes, ops = bound(name, args, kern)
    ms = min(k[0] for k in kern_ms)
    where = where or f"the {PATH_OF.get(name, 'split')} path's"
    log(f"  {name} at {where} inputs: "
        f"kernel device time {kern_ms[0][0]:.4f} / {kern_ms[1][0]:.4f} ms "
        f"per launch, wall {kern_ms[0][1]:.4f} / {kern_ms[1][1]:.4f} ms per "
        f"call with the wrapper; plain version {plain_ms[0]:.3f} / "
        f"{plain_ms[1]:.3f} ms (order plain, kernel, kernel, plain); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.4g} G operations), {100 * bound_ms / ms:.1f}% of it; "
        f"max |kernel - plain| {err:.3e}, {worst:.3e} of the field's scale "
        f"(within tolerance); card: {card}")
    return err, ms, min(plain_ms), bound_ms, bound_by


def profiled(fn):
    """(fn(), [(kernel, device ms, launches)]) of one call of `fn` between
    synchronisations (torch.profiler, device kernels only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [(e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if "CUDA" in str(getattr(e, "device_type", ""))
                 and getattr(e, "self_device_time_total", 0) > 0]


def region_device_time(fn):
    """(device ms, launches) of one call of `fn`, a region beside a step's
    phases (the forcing's reads, the coupler's exchange)."""
    _, rows = profiled(fn)
    return sum(r[1] for r in rows), sum(r[2] for r in rows)


def host_syncs(fn):
    """The synchronising operations PyTorch reports while `fn` runs
    (``torch.cuda.set_sync_debug_mode``: host reads of device values,
    device-to-host copies, stream synchronisations), from its warnings:
    (count, "file:line xN, ..." of the Python lines that made them)."""
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    at = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sum(at.values()), ", ".join(f"{k} x{n}"
                                       for k, n in at.most_common())


def phase_device_times(model, state, forcing, yday=None):
    """Device time and launches by phase of one step of a path (at day
    `yday`, by default the one after the main path's steps): each phase
    is profiled (torch.profiler, device kernels only) in a step of its
    own, between synchronisations, and the whole step once.  Returns ({phase:
    (ms, launches)}, step total ms, number of kernel kinds, top kernels,
    the step's launches) or None when the profiler saw no device time."""
    import cice4_tpu_torch.model as M

    from cice4_tpu_torch.ops import itd as itd_ops
    from cice4_tpu_torch.ops import mechred

    if yday is None:
        yday = YDAY0 + (NSTEPS + 1) * DT / 86400.0
    f = forcing(yday, 0.0)
    _, rows = profiled(lambda: model(state, f, yday, 0.0))
    if not rows:
        return None
    total = sum(r[1] for r in rows)

    phases = {"radiation": [(M, "_step_radiation")],
              "thermo": [(M, "_step_therm1"), (M, "_step_therm2")],
              "EVP": [(M, "evp")],
              "transport": [(M, "transport_remap"), (M, "transport_upwind")],
              "ridging": [(mechred, "ridge_ice")],
              "cleanup": [(itd_ops, "cleanup_itd")],
              "coupling": [(M, "_coupling_prep")]}
    by_phase = {}
    for phase, sites in phases.items():
        acc = [0.0, 0]
        in_dynamics = [False]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr in sites]
        saved.append((M, "_step_dynamics", M._step_dynamics))

        def wrap(orig):
            # functools.wraps copies the launch counter that ridge_ice and
            # cleanup_itd add to under their module's name
            @functools.wraps(orig)
            def run(*a, **k):
                # cleanup: only the dynamics' own call (ITD has another)
                if phase == "cleanup" and not in_dynamics[0]:
                    return orig(*a, **k)
                out, prow = profiled(lambda: orig(*a, **k))
                acc[0] += sum(r[1] for r in prow)
                acc[1] += sum(r[2] for r in prow)
                return out
            return run

        def dyn(*a, _orig=M._step_dynamics, **k):
            in_dynamics[0] = True
            try:
                return _orig(*a, **k)
            finally:
                in_dynamics[0] = False

        try:
            for mod, attr, orig in saved[:-1]:
                setattr(mod, attr, wrap(orig))
            M._step_dynamics = dyn
            model(state, f, yday, 0.0)
            torch.cuda.synchronize()
        finally:
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)
        by_phase[phase] = tuple(acc)
    launches = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return by_phase, total, len(rows), rows[:10], launches


def log_profile(name, prof, ms_step, regions=None):
    """The device time by phase of `phase_device_times`, and `regions`
    ({name: (ms, launches)}) measured outside the step beside them."""
    if prof is None:
        log(f"  {name} profiler: no device time recorded (not measured)")
        return
    by_phase, total, nkinds, top, launches = prof
    log(f"  {name} profiler, one step: {total:.3f} ms device time in "
        f"{launches} launches of {nkinds} kernel kinds "
        f"({100 * total / ms_step:.1f}% of the step's {ms_step:.3f} ms); by "
        f"phase (device ms, launches):")
    for phase, (ms, n) in by_phase.items():
        log(f"    {phase:10s} {ms:9.3f} ms ({100 * ms / total:.1f}%) {n:6d}")
    rest_ms = total - sum(v[0] for v in by_phase.values())
    rest_n = launches - sum(v[1] for v in by_phase.values())
    log(f"    {'other':10s} {rest_ms:9.3f} ms        {rest_n:6d}")
    for region, (ms, n) in (regions or {}).items():
        log(f"    {region:10s} {ms:9.3f} ms          {n:6d}  (outside the "
            f"step, beside it)")
    for key, ms, count in top:
        log(f"    {ms:9.3f} ms  x{count:5d}  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs only "
              "on the GPU", file=sys.stderr)
        return 1
    from cice4_tpu_torch import cuda_build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1/20 device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = cuda_build.load_all(LIBRARIES)
    log(f"[2/20 build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s wall, built in parallel")
    for name, lib in libs.items():
        log(f"  {name}: built={lib.built} nvcc {lib.seconds:.2f} s -> "
            f"{lib.path.name}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                log("    " + line.strip())

    cfg = make_config(MAIN)
    ny, nx = cfg.domain.ny_global, cfg.domain.nx_global
    log("[3/20 kernels vs plain versions on the card]")
    model, _, _ = make_run(cfg, device, torch.float32)
    check_newton(model.thermo, device)
    check_dynamics_kernels(device)

    log(f"[4/20 gx1 main path] gx1 default step {ny}x{nx}, ncat "
        f"{cfg.domain.ncat}, nilyr {cfg.domain.nilyr}, nslyr "
        f"{cfg.domain.nslyr}, ndte {cfg.dynamics.ndte}, advection "
        f"{cfg.transport.advection}, f32, {MAIN_STEPS} steps of {DT:.0f} s")
    model, state, forcing, ridge, _ = drive_path(
        "main path", cfg, device, MAIN_STEPS,
        expected(MAIN_STEPS, therm_newton=MAIN_STEPS,
                 evp_subcycle=MAIN_STEPS,
                 remap_gsh=MAIN_STEPS, remap_k12=MAIN_STEPS), moving=True)
    launches = {"gx1": read_counts()}
    log(f"  ridge iterations per step: {ridge} (cap 20; "
        f"{sum(r == 20 for r in ridge)} steps at the cap)")

    log(f"[5/20 earlier path] gx1 thermodynamics only, f32, {THERMO_STEPS} "
        f"steps")
    thermo_run = drive_path(
        "thermo-only path", make_config(THERMO_ONLY), device, THERMO_STEPS,
        expected(THERMO_STEPS, therm_newton=THERMO_STEPS), moving=False)

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        bcfg = box_config()
        log(f"[6/20 box path] IceModelRun, doubly-periodic box "
            f"{bcfg.domain.ny_global}x{bcfg.domain.nx_global} ("
            f"{bcfg.grid.dx_rect / 1e3:.0f} km cells from "
            f"{bcfg.grid.lat_origin}N), EW {bcfg.domain.ew_boundary_type} NS "
            f"{bcfg.domain.ns_boundary_type}, ndte {bcfg.dynamics.ndte} "
            f"(undamped, the default), f32, {NSTEPS} steps from day {YDAY0:.0f}, daily "
            f"history and restart, diagnostics every {NSTEPS} steps")
        box_run, launches["box"], driver_step_ms = phase_box_driver(
            device, workdir / "box")

        log(f"[7/20 split route] the box, {SPLIT_STEPS} steps with "
            f"CICE4_FORCE_PALLAS_REMAP=1 (K0 in GA mode, K1, K2)")
        launches["split"], worst_split = phase_split_route(device)
        log(f"  split vs default route after {SPLIT_STEPS} steps: worst "
            f"difference {worst_split:.3e} of the field's scale (limit "
            f"{SPLIT_RTOL})")

        log(f"[8/20 CLI] python -m cice4_tpu_torch run, the box cut to "
            f"{BOX_CLI['domain.ny_global']}x{BOX_CLI['domain.nx_global']}, "
            f"{CLI_STEPS} steps")
        (workdir / "cli").mkdir()
        phase_cli(workdir / "cli")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log(f"[9/20 ACCESS-OM2 tripole] {ACCESS025[0]}x{ACCESS025[1]} (0.25 "
        f"degree) and {ACCESS1[0]}x{ACCESS1[1]} (1 degree), f32, analytic "
        f"forcing from day {YDAY0:.0f}; card: {card}")
    access = phase_access(device, card, ACCESS025, detail=True)
    phase_access(device, card, ACCESS1, detail=False)

    log(f"[10/20 dEdd path] gx1 {ny}x{nx} with delta-Eddington shortwave "
        f"and melt ponds, f32, {DEDD_STEPS} steps from day {YDAY0:.0f} from "
        f"the ponded state; card: {card}")
    dedd = phase_dedd(device, card)

    log(f"[11/20 coupled path] gx1 {ny}x{nx} with the coupled radiation "
        f"order, constant albedos, atmbndy='constant' and kitd=0, f32, "
        f"{COUPLED_STEPS} steps")
    _, cstate, _, _, _ = drive_path(
        "coupled path", make_config(COUPLED), device, COUPLED_STEPS,
        expected(COUPLED_STEPS, therm_newton=COUPLED_STEPS,
                 evp_subcycle=COUPLED_STEPS,
                 remap_gsh=COUPLED_STEPS, remap_k12=COUPLED_STEPS),
        moving=True)
    carried = float(cstate.swn["fswsfcn"].max())
    if not carried > 0.0:
        raise AssertionError("coupled path: no shortwave carried to the "
                             "next step")
    log(f"  coupled path: shortwave carried to the next step, fswsfcn max "
        f"{carried:.4g} W/m^2")

    log(f"[12/20 transport options] gx1 {ny}x{nx}, f32, {OPT_STEPS} steps a "
        f"path from day {YDAY0:.0f}: (a) l_dp_midpt with the conservation "
        f"and monotonicity checks, (b) l_fixed_area, (c) upwind; (d) the "
        f"box on the split route with l_dp_midpt, {SPLIT_MIDPT_STEPS} steps; "
        f"card: {card}")
    options = phase_transport_options(device, card)

    log(f"[13/20 thermo and grid variants] gx1 {ny}x{nx}, f32, "
        f"{VARIANT_STEPS} steps a path: (e) heat_capacity=False, (f) calc_Tsfc=False, (g) "
        f"both; (h) a POP binary grid, (i) the same as netCDF, (j) a "
        f"pan-Arctic grid; card: {card}")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_grids_"))
    try:
        phase_thermo_and_grids(device, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log(f"[14/20 file forcing] gx1 {ny}x{nx}, f32, IceModelRun from 1 "
        f"January 1997 under seeded files in the reference's layout, "
        f"{FILE_STEPS} steps a path: (k) NCAR with the ocean climatology "
        f"and SST restoring, (l) monthly with calc_strair=False; card: "
        f"{card}")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_forcing_"))
    try:
        filed = phase_file_forced(device, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log(f"[15/20 coupled component] IceComponent, f32, "
        f"{COUPLED_INTERVALS} intervals of {INTERVAL_STEPS} steps from seeded "
        f"imports: (m) ACCESS-OM {ACCESS025[0]}x{ACCESS025[1]} with the GFDL "
        f"open-water fluxes, dt {ACCESS_OM025['run.dt']:.0f} s, (n) "
        f"ACCESS-CM {ACCESS1[0]}x{ACCESS1[1]} with calc_Tsfc=False; card: "
        f"{card}")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_coupled_"))
    try:
        coupled = phase_coupled(device, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log(f"[16/20 decomposed] the model on a mesh of blocks: (o) gx1 "
        f"{ny}x{nx} on {DECOMP_MESH[0]}x{DECOMP_MESH[1]} blocks in one "
        f"process, {DECOMP_STEPS} steps against one device, then timed; (p) "
        f"ACCESS-OM2 {ACCESS1[0]}x{ACCESS1[1]} on the same mesh, 2 steps; "
        f"(q) python -m cice4_tpu_torch.parallel.launch as 2 processes over "
        f"gloo and 1 over nccl; (r) 24x32 f64 on 2x2 blocks, card vs CPU; "
        f"card: {card}")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_decomposed_"))
    try:
        decomposed = phase_decomposed(device, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log("[17/20 small parity] 24x32 f64, card vs CPU, 3 steps")
    from cice4_tpu_torch.kernel_check import ponded_state
    for name, pcfg, prepare in (
            ("gx1 main path", make_config(MAIN, **SMALL), None),
            ("box", box_config(**BOX_SMALL), None),
            ("all-ocean tripole", box_config(**TRIPOLE_SMALL), None),
            ("gx1 dEdd and ponds", make_config(DEDD, **SMALL), ponded_state),
            ("gx1 coupled options", make_config(COUPLED, **SMALL), None),
            ("gx1 remap options (l_dp_midpt, l_fixed_area, both checks)",
             make_config(REMAP_OPTIONS, **SMALL), None),
            ("gx1 upwind, heat_capacity=False",
             make_config(UPWIND_ZERO_LAYER, **SMALL), None),
            ("gx1 calc_Tsfc=False", make_config(EXPLICIT, **SMALL), None)):
        worst = phase_small_parity(device, pcfg, prepare)
        log(f"  {name}: worst difference {worst:.3e} of the field's scale "
            f"(limit {STEP_RTOL})")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_parity_"))
    try:
        for name, fn in (
                ("(k) NCAR files, ocean climatology, IceModelRun",
                 lambda d: phase_file_parity(device, NCAR_CLIM,
                                             ("ncar", "ocean"), d)),
                ("(l) monthly files, calc_strair=False, IceModelRun",
                 lambda d: phase_file_parity(device, MONTHLY_STRESS,
                                             ("monthly",), d)),
                ("(m) ACCESS-OM component with GFDL, 2 intervals",
                 lambda d: phase_coupled_parity(device, "om", {}, d)),
                ("(n) ACCESS-CM component, 2 intervals",
                 lambda d: phase_coupled_parity(device, "cm", ACCESS_CM, d))):
            d = workdir / name[1]
            d.mkdir()
            worst = fn(d)
            log(f"  {name}: worst difference {worst:.3e} of the field's "
                f"scale (limit {STEP_RTOL})")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log(f"[18/20 deep column] gx1 {ny}x{nx}, nilyr "
        f"{DEEP['domain.nilyr']}, nslyr {cfg.domain.nslyr}, f32, "
        f"{DEEP_STEPS} steps from day {YDAY0:.0f}: therm_newton's generic "
        f"instance; card: {card}")
    deep, deep_plain_ms = phase_deep(device, card)

    log(f"[19/20 bench] python -m cice4_tpu_torch bench, BENCH_CONFIG "
        f"{' and '.join(BENCH_CONFIGS)}, each in a process of its own; "
        f"card: {card}")
    torch.cuda.empty_cache()
    phase_bench()

    log(f"[20/20 timing] card: {card}")
    ms_ev, ms_host, ridge_t = time_path(model, state, forcing, 8,
                                        first=MAIN_STEPS)
    log(f"  gx1 main path: {ms_ev:.3f} ms/step (CUDA events, 8 steps after "
        f"{MAIN_STEPS}), {ms_host:.3f} ms/step (host clock), "
        f"{ny * nx / (ms_ev / 1e3):.4g} cell-steps/s; ridge iterations "
        f"{ridge_t}; card: {card}")
    ms_thermo, _, _ = time_path(*thermo_run[:3], 8)
    log(f"  earlier path (thermodynamics only), same card: {ms_thermo:.3f} "
        f"ms/step (CUDA events, 8 steps)")
    log_profile("gx1 main path", phase_device_times(model, state, forcing),
                ms_ev)

    bmodel, bstate = box_run.model, box_run.state
    bforce = box_run.forcing_provider
    bcells = bmodel.grid.ny * bmodel.grid.nx
    bms_ev, bms_host, bridge = time_path(bmodel, bstate, bforce, 8)
    log(f"  box path: {bms_ev:.3f} ms/step (CUDA events, 8 steps after "
        f"{NSTEPS + 1}), {bms_host:.3f} ms/step (host clock), "
        f"{bcells / (bms_ev / 1e3):.4g} cell-steps/s; ridge iterations "
        f"{bridge}; the driver's Step timer over its {NSTEPS} steps "
        f"{driver_step_ms:.3f} ms/step; card: {card}")
    log_profile("box path", phase_device_times(bmodel, bstate, bforce),
                bms_ev)
    os.environ["CICE4_FORCE_PALLAS_REMAP"] = "1"
    try:
        sms_ev, sms_host, _ = time_path(bmodel, bstate, bforce, 8)
        sprof = phase_device_times(bmodel, bstate, bforce)
    finally:
        del os.environ["CICE4_FORCE_PALLAS_REMAP"]
    log(f"  box path on the split remap route (K0 in GA mode, K1, K2): "
        f"{sms_ev:.3f} ms/step (CUDA events, 8 steps after {NSTEPS + 1}), "
        f"{sms_host:.3f} ms/step (host clock); card: {card}")
    log_profile("box path, split route", sprof, sms_ev)

    seen = capture_kernel_inputs(model, state, forcing,
                                 [k for k, p in PATH_OF.items()
                                  if p == "gx1"])
    seen.update(capture_kernel_inputs(bmodel, bstate, bforce,
                                      ["evp_wholegrid"]))
    os.environ["CICE4_FORCE_PALLAS_REMAP"] = "1"
    try:
        seen.update(capture_kernel_inputs(
            bmodel, bstate, bforce,
            ["remap_ga", "remap_construct", "remap_contract"]))
    finally:
        del os.environ["CICE4_FORCE_PALLAS_REMAP"]

    seen["evp_rounds"] = decomposed["rounds_args"]
    launches["decomposed"] = decomposed["counts"]
    seen["gfdl_column"] = coupled["gfdl_args"]
    launches["om025"] = coupled["om025_launches"]

    record = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        path = PATH_OF[name]
        err, ms, plain_ms, bound_ms, bound_by = measure_kernel(
            name, seen[name], card)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[path][name],
                 "decomposed_launches": launches["decomposed"][name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None, "path": path}
        for key, at in (("access025", access), ("dedd", dedd),
                        ("nilyr10", deep),
                        ("midpt", options["midpt"]),
                        ("fixed_area", options["fixed_area"]),
                        ("ncar_clim", filed["ncar_clim"]),
                        ("monthly", filed["monthly"]),
                        ("om025", coupled["om025"]),
                        ("cm1", coupled["cm1"])):
            if name in at:
                (entry[f"{key}_launches"], entry[f"{key}_ms"],
                 entry[f"{key}_bound_ms"], entry[f"{key}_max_abs_err"]) = \
                    at[name]
        log_design(name, seen[name], ms)
        if name == "therm_newton":
            entry["ms_at_layers"] = time_newton_layers(
                seen[name][0], device, card)
            entry["generic_ms"] = time_generic_at(seen[name],
                                                  card)["generic_ms"]
            entry["nilyr10_plain_ms"] = deep_plain_ms
        if name == "remap_gsh":
            # the same kernel in GA mode, on the split route's inputs
            ga = measure_kernel("remap_ga", seen["remap_ga"], card)
            log_design("remap_ga", seen["remap_ga"], ga[1])
            entry.update({"ga_mode_launches": launches["split"]["remap_ga"],
                          "ga_mode_max_abs_err": ga[0], "ga_mode_ms": ga[1],
                          "ga_mode_plain_ms": ga[2],
                          "ga_mode_bound_ms": ga[3],
                          "ga_mode_bound_by": ga[4]})
        record["kernels"].append(entry)
    log(f"  CUDA graph capture of evp_subcycle at the gx1 inputs: "
        f"{evp_graph_capture(seen['evp_subcycle'])}")
    for entry in record["kernels"]:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} never launched on its "
                                 f"path")
        for v in entry.values():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"non-finite number in {entry}")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
