"""Launchers of the column kernels of ``csrc/ridge_column.cu``.

`ridge_ice_cuda` runs the whole ridging loop of
:func:`cice4_tpu_torch.ops.mechred.ridge_ice` and `cleanup_itd_cuda` the
rebin and zap of :func:`cice4_tpu_torch.ops.itd.cleanup_itd`, each as one
launch with one thread a (j, i) column.  Neither reads the device on the
host: the ridging pass count comes back as a 0-d device tensor.

The tracers travel as a table of their ``(ncat, ny, nx)`` arrays, each
with a code (:func:`tracer_table`): the dependency of
``itd.TRACER_DEPEND`` (0 area, 1 ice volume, 2 snow volume), plus 4 for the
level-ice tracers, whose ridged share leaves before the weighted
subtraction (``ice_mechred.F90 ridge_shift:1474-1482``).  The kernels read
and write each tracer's own array, so no tracer is copied.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.ops.itd import TRACER_DEPEND
from cice4_tpu_torch.ops.mechred_strength import (Cs, Gstar, Hstar, astar,
                                                  fsnowrdg, maxraft)

LEVEL_TRACERS = ("alvl", "vlvl")
LEVEL_CODE = 4
# the tracers the kernels' argument struct holds (csrc/ridge_column.cu
# kMaxTracers; itd.TRACER_DEPEND names four)
MAX_TRACERS = 8


def tracer_table(trcrn: dict):
    """(names, arrays, codes): the tracers in dict order, each one's array
    (contiguous, so a contiguous one is not copied) and its code for the
    kernels: its dependency, plus LEVEL_CODE for the level-ice tracers."""
    names = list(trcrn)
    if len(names) > MAX_TRACERS:
        raise NotImplementedError(
            f"the column kernels take at most {MAX_TRACERS} tracers, "
            f"got {len(names)}")
    codes = [TRACER_DEPEND[k] | (LEVEL_CODE if k in LEVEL_TRACERS else 0)
             for k in names]
    return names, [trcrn[k].contiguous() for k in names], codes


@functools.lru_cache(maxsize=None)
def _hin_max(bounds: tuple, device) -> torch.Tensor:
    """The category bounds, the top one 1e8 as ridging sets it, as float64
    on `device` (made once: a copy to the device synchronises)."""
    return torch.tensor(bounds[:-1] + (1.0e8,), dtype=torch.float64,
                        device=device)


def _lib():
    from cice4_tpu_torch import cuda_build

    return cuda_build.load("ridge_column").lib


@functools.lru_cache(maxsize=None)
def _fn(name, dtype):
    fn = getattr(_lib(), f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _scratch_slots(kernel, ncat, ntrcr, elem):
    fn = _lib().column_scratch_slots
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int64
    return fn(("ridge_column", "cleanup_column").index(kernel), ncat, ntrcr,
              elem)


def _scratch(kernel, like, ntrcr):
    """The global scratch tensor of a launch of `kernel`, or None where a
    block's work slots fit in shared memory (csrc/ridge_column.cu
    column_scratch_slots)."""
    ncat, ny, nx = like.shape
    slots = _scratch_slots(kernel, ncat, ntrcr, like.element_size())
    return like.new_empty((slots, ny, nx)) if slots else None


def _check(x, dtype, device, name):
    if x.dtype != dtype or x.device != device:
        raise TypeError(f"{name} on {x.device} as {x.dtype}; expected "
                        f"{device} as {dtype}")
    return x.contiguous()


def _launch(name, dtype, device, ptrs, ints, par):
    ptr_arr = (ctypes.c_int64 * len(ptrs))(*ptrs)
    int_arr = (ctypes.c_int64 * len(ints))(*ints)
    par_arr = (ctypes.c_double * len(par))(*par)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(name, dtype)(ctypes.addressof(ptr_arr),
                              ctypes.addressof(int_arr),
                              ctypes.addressof(par_arr), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _inputs(state):
    dtype, device = state.aicen.dtype, state.aicen.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the column kernels take float32 or float64, "
                        f"not {dtype}")
    fields = [_check(getattr(state, k), dtype, device, k)
              for k in ("aicen", "vicen", "vsnon", "tsfcn", "eicen",
                        "esnon")]
    names, trc, codes = tracer_table(state.trcrn)
    trc = [_check(x, dtype, device, f"trcrn[{k!r}]")
           for k, x in zip(names, trc)]
    return dtype, device, fields, names, trc, codes


def ridge_ice_cuda(state, itd, dyn, dt, rdg_conv, rdg_shear, tmask,
                   aice0=None, nitermax=20):
    """The ridging loop as one launch of ``ridge_column``.

    Returns (new state fields, diag, asum, niter_cells, converged): the
    fields aicen, vicen, vsnon, eicen, esnon, tsfcn and the tracer dict;
    diag's dardg1dt, dardg2dt, dvirdgdt, opening, fresh and fhocn; the
    final area sum, each column's pass count and whether it converged."""
    dtype, device, fields, names, trc, codes = _inputs(state)
    ncat, ny, nx = state.aicen.shape
    nilyr, nslyr = state.eicen.shape[1], state.esnon.shape[1]
    planes = [_check(x, dtype, device, k) for k, x in
              (("rdg_conv", rdg_conv), ("rdg_shear", rdg_shear))]
    tmask = _check(tmask, torch.bool, device, "tmask")
    a0 = None if aice0 is None else _check(aice0, dtype, device, "aice0")
    hin = _hin_max(tuple(float(h) for h in itd.hin_max), device)

    outs = [torch.empty_like(x) for x in fields]
    otrc = [torch.empty_like(x) for x in trc]
    diag = [torch.empty((ny, nx), dtype=dtype, device=device)
            for _ in range(7)]
    niter = torch.empty((ny, nx), dtype=torch.int32, device=device)
    converged = torch.empty((ny, nx), dtype=torch.bool, device=device)
    scratch = _scratch("ridge_column", fields[0], len(names))
    ptrs = ([x.data_ptr() for x in fields]
            + [0 if a0 is None else a0.data_ptr()]
            + [x.data_ptr() for x in planes]
            + [tmask.data_ptr(), hin.data_ptr()]
            + [x.data_ptr() for x in outs]
            + [x.data_ptr() for x in diag]
            + [niter.data_ptr(), converged.data_ptr(),
               0 if scratch is None else scratch.data_ptr()]
            + [x.data_ptr() for x in trc + otrc])
    ints = [ny * nx, ncat, nilyr, nslyr, len(names), dyn.krdg_partic,
            dyn.krdg_redist, nitermax] + codes
    # the Python numbers of the plain version, rounded to the run's type in
    # the kernel as PyTorch rounds a Python number
    astari = 1.0 / astar
    par = [float(dt), 1.0 / dt, cn.puny, Cs, Gstar, 1.0 / Gstar, astari,
           1.0 / (1.0 - math.exp(-astari)), maxraft, Hstar, dyn.mu_rdg,
           fsnowrdg, 1.0 - fsnowrdg, cn.rhos, cn.Tocnfrz]
    _launch("ridge_column", dtype, device, ptrs, ints, par)
    new = dict(zip(("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon"),
                   outs))
    new["trcrn"] = dict(zip(names, otrc))
    d = dict(zip(("dardg1dt", "dardg2dt", "dvirdgdt", "opening", "fresh",
                  "fhocn"), diag[:6]))
    return new, d, diag[6], niter, converged


def cleanup_itd_cuda(state, itd, tmask, dt, limit_aice=True):
    """Rebin and zap as one launch of ``cleanup_column``.  Returns (new
    state fields as in `ridge_ice_cuda`, dict of dfresh, dfsalt and
    dfhocn)."""
    dtype, device, fields, names, trc, codes = _inputs(state)
    ncat, ny, nx = state.aicen.shape
    nilyr, nslyr = state.eicen.shape[1], state.esnon.shape[1]
    tmask = _check(tmask, torch.bool, device, "tmask")
    hin = _hin_max(tuple(float(h) for h in itd.hin_max), device)

    outs = [torch.empty_like(x) for x in fields]
    otrc = [torch.empty_like(x) for x in trc]
    fluxes = [torch.empty((ny, nx), dtype=dtype, device=device)
              for _ in range(3)]
    scratch = _scratch("cleanup_column", fields[0], len(names))
    ptrs = ([x.data_ptr() for x in fields]
            + [tmask.data_ptr(), hin.data_ptr()]
            + [x.data_ptr() for x in outs]
            + [x.data_ptr() for x in fluxes]
            + [0 if scratch is None else scratch.data_ptr()]
            + [x.data_ptr() for x in trc + otrc])
    ints = [ny * nx, ncat, nilyr, nslyr, len(names), int(limit_aice)] + codes
    par = [float(dt), cn.puny, 1.0 - cn.puny, cn.Tocnfrz,
           cn.a_negligible(dtype), cn.rhoi, cn.rhos, cn.ice_ref_salinity]
    _launch("cleanup_column", dtype, device, ptrs, ints, par)
    new = dict(zip(("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon"),
                   outs))
    new["trcrn"] = dict(zip(names, otrc))
    return new, dict(zip(("dfresh", "dfsalt", "dfhocn"), fluxes))
