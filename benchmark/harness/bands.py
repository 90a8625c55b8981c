"""The reference's model steps in full-width bands of whole rows, for a
grid whose reference does not fit on one card, spread over the ranks of
a run.

A band is a run of whole rows of the global grid: its core, whose
results it answers for, and an apron of rows on each side of the core.
Every band spans the grid's full width, so the east-west wrap and the
tripole fold (which maps column i to nx-1-i within the top rows) stay
inside one band, and the band runs the reference's own boundary
conditions: the global one at a real edge of the domain, a zero ghost
(``closed``) at an artificial one.  What the zero ghost gets wrong moves
inward by at most one ring of cells for each stencil that a step applies
in turn, so an apron as wide as a step's stencils reach keeps it out of
the core, and the core reads what the whole grid reads.

The apron is computed from the configuration, never configured: a model
step applies the EVP's stencil once a subcycle, `ndte` times, then the
remap's and a few single-ring stencils.  Everything else in a step is a
column's own work, but for one exit: the reference's ridging loop
(``reference/ops/mechred.py``) runs until every column of the grid it is
given has closed its area, so a band may make fewer passes than the
whole grid.  A further pass leaves a closed column's area, volumes and
enthalpies as they are; it rescales the volume tracers (``iage``,
``vlvl``) of a category that holds less than ``puny`` of ice, which the
step's cleanup then zaps, and may move the surface temperature and other
tracers by a few ulps.  The cells' checks read the same whole and in
bands; a cell whose step may keep such categories past its cleanup
(ponds, level ice) has to be checked whole against bands again.  The
forcing, the coupler's boundary, the restoring
and the exports are the whole grid's, computed once by the reference
around the banded steps (``reference.step.Reference.steps``).
"""

from __future__ import annotations

import dataclasses
import time

import torch

# the rings of cells that one model step's stencils reach, besides the
# EVP's one ring a subcycle: the incremental remap's six (the port's
# REMAP_HALO: departure points, the edge geometry, the shifts of the 9
# offsets and the limiter's neighbours), and one each for the EVP's
# ice-mask dilation, its T-to-U interpolation, the strain rates of its
# last subcycle and its ocean stress back on the T grid
REMAP_RINGS = 6
STENCIL_RINGS = 4


def apron(cfg, n_steps: int) -> int:
    """Rows of apron a band needs on each side for `n_steps` steps of the
    reference configuration `cfg`."""
    evp = cfg.dynamics.ndte if cfg.dynamics.kdyn == 1 else 0
    return n_steps * (evp + REMAP_RINGS + STENCIL_RINGS)


def plan(ny: int, n: int, width: int) -> list[tuple[int, int, int, int]]:
    """(core start, core end, band start, band end) rows of `n` bands of
    a grid of `ny` rows, each band's apron `width` rows wide on each side
    (cut at the domain's edges)."""
    if not 1 <= n <= ny:
        raise ValueError(f"{n} bands of a grid of {ny} rows")
    edges = [k * ny // n for k in range(n + 1)]
    return [(a, b, max(0, a - width), min(ny, b + width))
            for a, b in zip(edges, edges[1:])]


def band_bc(bc, hi: int, ny: int):
    """The boundary conditions of a band that ends at row `hi`: the
    global ones, with a zero ghost north of a band below the top row (a
    band's south edge is the global one or gets a zero ghost under every
    condition but ``cyclic``)."""
    from reference.halo import BoundaryConditions

    if bc.ns == "cyclic":
        raise ValueError("bands of whole rows need a grid that does not "
                         "wrap north to south")
    return BoundaryConditions(ew=bc.ew, ns=bc.ns if hi == ny else "closed")


def _rows(obj, lo: int, hi: int, ny: int, nx: int):
    """`obj` with every tensor of trailing (ny, nx) axes cut to rows
    lo:hi, on the host."""
    from harness.cell import block_of, to_host

    return to_host(block_of(obj, (lo, hi, 0, nx), ny, nx))


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def package(ref, state, forcing, times, band) -> dict:
    """What one band's steps need, on the host: the grid's, state's and
    forcing's rows of the band, its boundary conditions, the steps'
    times, the core's rows within it and the type it is computed in."""
    from reference.grid import GRID_FIELDS
    from reference.step import to_fields

    c0, c1, lo, hi = band
    grid = ref.grid
    ny, nx = grid.ny, grid.nx
    bc = band_bc(grid.bc, hi, ny)
    return {"grid": _rows({k: getattr(grid, k) for k in GRID_FIELDS},
                          lo, hi, ny, nx),
            "bc": (bc.ew, bc.ns), "rows": (lo, hi), "core": (c0 - lo, c1 - lo),
            "state": _rows(to_fields(state), lo, hi, ny, nx),
            "forcing": _rows(_fields(forcing), lo, hi, ny, nx),
            "times": list(times), "dtype": str(ref.dtype).split(".")[-1]}


def compute(pkg: dict, cfg, device) -> dict:
    """One band's steps on `device`: its core's state and last fluxes on
    the host, with the steps' time, the band's cells and, on a card, the
    memory the steps took beyond what the process held before them."""
    from reference.forcing import Forcing
    from reference.grid import Grid
    from reference.halo import BoundaryConditions
    from reference.model import Model
    from reference.step import to_fields, to_state

    device = torch.device(device)
    dtype = getattr(torch, pkg["dtype"])
    lo, hi = pkg["rows"]
    grid_f = {k: v.to(device) for k, v in pkg["grid"].items()}
    nx = grid_f["tmask"].shape[-1]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    grid = Grid(bc=BoundaryConditions(*pkg["bc"]), nx=nx, ny=hi - lo,
                **grid_f)
    model = Model(cfg, grid)
    state = to_state(pkg["state"], device=device, dtype=dtype)
    forcing = Forcing(**{k: v.to(device) for k, v in pkg["forcing"].items()})
    fluxes = None
    for yday, sec in pkg["times"]:
        state, fluxes = model(state, forcing, yday, sec)
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) - base) if cuda else 0
    c0, c1 = pkg["core"]
    rows = hi - lo
    return {"state": _rows(to_fields(state), c0, c1, rows, nx),
            "fluxes": _rows(fluxes, c0, c1, rows, nx),
            "seconds": seconds, "peak_bytes": int(peak),
            "cells": rows * nx, "rows": (lo, hi)}


def _join(parts, device):
    """The whole grid's value from the bands' cores, in band order: row
    blocks joined, a count the largest of the bands'."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _join([p[k] for p in parts], device) for k in first}
    if isinstance(first, torch.Tensor):
        if first.dim() >= 2:
            return torch.cat(parts, dim=-2).to(device)
        return torch.stack(parts).max().to(device)
    if isinstance(first, (int, float)):
        return max(parts)
    return first


class Banded:
    """The reference's model steps in `n` bands: the stepper that
    ``Reference.steps`` takes.  On a run of several ranks, rank 0 deals
    the bands out, one to each rank in turn, and the other ranks compute
    theirs in :func:`serve`; rank 0 joins the cores.  `log` takes each
    band's lines; `records` keeps, per call, each band's rows, cells,
    seconds and memory."""

    def __init__(self, n: int, group, log):
        self.n, self.group, self.log = n, group, log
        self.records = []

    def __call__(self, ref, state, forcing, times):
        from reference.state import State

        width = apron(ref.cfg, len(times))
        bands = plan(ref.grid.ny, self.n, width)
        size = self.group.size
        results = []
        for r0 in range(0, len(bands), size):
            chunk = bands[r0:r0 + size]
            pkgs = [package(ref, state, forcing, times, b) for b in chunk]
            pkgs += [{"idle": True}] * (size - len(chunk))
            mine = self.group.scatter(pkgs)
            got = self.group.gather(compute(mine, ref.cfg, ref.device))
            results += got[:len(chunk)]
        record = [{k: r[k] for k in ("rows", "cells", "seconds",
                                     "peak_bytes")} for r in results]
        self.records.append({"bands": self.n, "apron": width,
                             "bands_run": record})
        for k, r in enumerate(record):
            self.log(f"reference band {k} of {self.n}: rows {r['rows']}, "
                     f"apron {width}, {r['cells']} cells, {r['seconds']:.3f}"
                     f" s, {r['peak_bytes']} bytes "
                     f"({r['peak_bytes'] / r['cells']:.1f} a cell)")
        fields = _join([r["state"] for r in results], ref.device)
        fluxes = _join([r["fluxes"] for r in results], ref.device)
        return State(**fields), fluxes


def serve(group, cfg, device):
    """A rank other than 0: compute the bands rank 0 deals out until it
    sends None."""
    while True:
        pkg = group.scatter(None)
        if pkg is None:
            return
        group.gather(None if pkg.get("idle") else compute(pkg, cfg, device))


def stop(group):
    """Rank 0: the other ranks leave :func:`serve`."""
    if group.size > 1:
        group.scatter([None] * group.size)
