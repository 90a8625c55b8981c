"""Operations and bytes of the port's four hand-written kernels on the
default route, and of a whole model step, counted from a cell's shapes
and its initial state; the card's published peaks.

The operation counts per cell are those the port's measurements count
from its CUDA sources (``chip_smoke.py``: one per add, multiply,
compare, min/max, division or square root); the bytes count each input
plane read once and each output plane written once, as the kernels'
argument lists lay them out (``ops/therm_vertical.py``,
``ops/evp_cuda.py``, ``ops/remap_cuda.py``).  Where the work depends on
the data, the count is of what the cell's initial state needs: the
Newton solve at one iteration of every icy category cell, the EVP over
the initial state's icy T cells (its U points taken as many).
"""

from __future__ import annotations

import dataclasses
import re

import torch

# NVIDIA H100 SXM data sheet, at 700 W: HBM bandwidth, and the float32
# and float64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {4: 67e12, 8: 34e12}

OPS_NEWTON_FIXED, OPS_NEWTON_ROW = 60, 40
OPS_EVP_STRESS, OPS_EVP_MOMENTUM, OPS_EVP_FINAL_SUMS = 357, 43, 12
OPS_GSH_CELL = {1: 1204, 2: 1948, 3: 2248}
OPS_K12_MASS, OPS_K12_T1, OPS_K12_T2 = 100, 111, 113
OPS_K12_OFF_MASS, OPS_K12_OFF_T1, OPS_K12_OFF_T2 = 6, 24, 73

# each kernel's rows in a profiler trace, by the CUDA function's name
KERNEL_NAMES = {
    "therm_newton": re.compile(r"therm_newton_(kernel|generic)"),
    "evp_subcycle": re.compile(r"evp_persistent"),
    "remap_gsh": re.compile(r"gsh_fused"),
    "remap_k12": re.compile(r"(^|[^A-Za-z0-9_])k12\s*[<(]"),
}


def kernel_of(name: str) -> str | None:
    """The kernel a profiler row belongs to, or None."""
    for kernel, pat in KERNEL_NAMES.items():
        if pat.search(name):
            return kernel
    return None


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the counts need of a cell: its sizes, its tracers, the
    remap's quadrature order, the EVP's subcycles, and the icy cells of
    its initial state."""

    ncat: int
    nilyr: int
    nslyr: int
    ny: int
    nx: int
    itemsize: int
    tracers: tuple          # (name, type 1 or 2) of the remap, in order
    integral_order: int
    ndte: int
    icy_category_cells: int
    icy_t_cells: int

    @property
    def cells(self) -> int:
        return self.ny * self.nx


def _bound_ms(nbytes, ops, itemsize):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[itemsize] * 1e3
    return max(t_bytes, t_ops)


def therm_newton(s: Shapes) -> dict:
    """One launch over every category: 5 planes shared by the
    categories, 9 per category, the 6 layer stacks (two of them snow) and
    the ice flags in; 11 planes, the converged flags, two int32 planes,
    the 6 layer stacks and the largest iteration count out."""
    plane = s.cells * s.itemsize
    cat = s.ncat * plane
    stacks = 3 * (s.nilyr + s.nslyr) * cat
    nbytes = (5 * plane + 9 * cat + stacks + s.ncat * s.cells
              + 11 * cat + s.ncat * s.cells + 2 * s.ncat * s.cells * 4
              + stacks + 4)
    ops = (OPS_NEWTON_FIXED + OPS_NEWTON_ROW * (s.nslyr + s.nilyr + 1)) \
        * s.icy_category_cells
    return {"bytes": nbytes, "ops": ops}


def evp_subcycle(s: Shapes) -> dict:
    """All ndte subcycles in one launch: 24 planes and two masks in, the
    10 grid planes, 23 planes out."""
    plane = s.cells * s.itemsize
    nbytes = (24 + 10 + 23) * plane + 2 * s.cells
    n_t = n_u = s.icy_t_cells
    ops = ((s.ndte - 1) * (OPS_EVP_STRESS * n_t + OPS_EVP_MOMENTUM * n_u)
           + (OPS_EVP_STRESS + OPS_EVP_FINAL_SUMS) * s.cells
           + OPS_EVP_MOMENTUM * n_u)
    return {"bytes": nbytes, "ops": ops}


def remap_gsh(s: Shapes) -> dict:
    """The departure displacements and the corner area factor in, the 9
    offsets' 10 geometry planes out."""
    nbytes = (3 + 90) * s.cells * s.itemsize
    return {"bytes": nbytes, "ops": OPS_GSH_CELL[s.integral_order] * s.cells}


def remap_k12(s: Shapes) -> dict:
    """GSH, the land mask and every row's mass and tracers in (row 0 the
    open water), every row's divergences out."""
    T = len(s.tracers)
    rows = s.ncat + 1
    n1 = sum(1 for _n, t in s.tracers if t == 1)
    recon = OPS_K12_MASS + n1 * OPS_K12_T1 + (T - n1) * OPS_K12_T2
    contract = 9 * (rows * OPS_K12_OFF_MASS
                    + (rows - 1) * (n1 * OPS_K12_OFF_T1
                                    + (T - n1) * OPS_K12_OFF_T2))
    nbytes = (90 + 1 + rows * (1 + T) + rows * (1 + T)) * s.cells \
        * s.itemsize
    ops = s.cells * (OPS_K12_MASS + (rows - 1) * recon + contract)
    return {"bytes": nbytes, "ops": ops}


KERNELS = {"therm_newton": therm_newton, "evp_subcycle": evp_subcycle,
           "remap_gsh": remap_gsh, "remap_k12": remap_k12}


def kernel_bound_ms(kernel: str, s: Shapes) -> float:
    c = KERNELS[kernel](s)
    return _bound_ms(c["bytes"], c["ops"], s.itemsize)


def step_bound_ms(s: Shapes, state_planes: int, grid_planes: int,
                  forcing_planes: int, flux_planes: int) -> float:
    """The least time of a whole step: the state read and written once,
    the grid and the forcing read once, the fluxes written once, against
    the four kernels' operations (the step's other work is not counted,
    so this bounds it from below)."""
    nbytes = (2 * state_planes + grid_planes + forcing_planes
              + flux_planes) * s.cells * s.itemsize
    ops = sum(KERNELS[k](s)["ops"] for k in KERNELS)
    return _bound_ms(nbytes, ops, s.itemsize)


def planes(obj) -> int:
    """(ny, nx) planes in a tensor or a nested dict or tuple of them."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() // (obj.shape[-1] * obj.shape[-2]) \
            if obj.dim() >= 2 else 0
    if isinstance(obj, dict):
        return sum(planes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(planes(v) for v in obj)
    return 0
