"""Launcher of the GFDL column kernel of ``csrc/gfdl_column.cu``.

`gfdl_ocean_fluxes_cuda` computes what
:func:`cice4_tpu_torch.ops.gfdl_flux._gfdl_ocean_fluxes_plain` computes, as
one launch with one thread a (j, i) cell, the zeta Newton leaving each cell
where the plain version freezes it.  It reads nothing back on the host:
each launch takes the most Newton passes of any of its cells into the
device's 0-d accumulator `mo_passes`, which a reader zeroes at its window's
start and reads at its end.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.ops import gfdl_flux as gf

ROUGH_SCHEMES = ("beljaars", "charnock", "fixed")
INPUTS = ("tair", "qair", "uwnd", "vwnd", "press", "sst", "ssu", "ssv",
          "u_star_prev")
OUTPUTS = ("sh", "lh", "lwo", "taox", "taoy", "u_star", "rough_mom",
           "rough_heat", "rough_moist")


def _params(zlvl: float) -> list:
    """The Python numbers of the plain version in the order of
    ``GfdlParams``; those Python computes (a product, a logarithm, a root)
    are computed here, so the kernel rounds each to its type as PyTorch
    rounds a Python number."""
    b_stab = 1.0 / gf.RICH_CRIT
    tbasi = cn.Tffresh
    return [float(zlvl), tbasi, cn.Tffresh + 100.0, tbasi - 20.0,
            math.log10(610.71), math.log10(101324.60), cn.gravit, gf.rdgas,
            gf.d608, gf.d622, gf.d378, gf.kappa, cn.puny, cn.vonkar,
            cn.cp_air, cn.stefan_boltzmann, cn.Lvap, gf.ROUGHNESS_MIN,
            gf.CHARNOCK, gf.ROUGH_FIXED, gf.GNU, gf.GNU * gf.GNU, gf.ZCOM1,
            gf.ZCOM2, gf.ZCOH1, gf.ZCOH2, gf.ZCOQ1, gf.ZCOQ2, gf.RICH_CRIT,
            0.95 * gf.RICH_CRIT, b_stab, 5.0 - b_stab, gf.MO_ERROR,
            gf.ZETA_MIN, gf.MO_SMALL,
            math.sqrt(1.0 / gf.DRAG_MIN) * cn.vonkar,
            math.sqrt(gf.DRAG_MIN), math.atan(1.0), 1.0 / 0.608]


def _lib():
    from cice4_tpu_torch import cuda_build

    return cuda_build.load("gfdl_column").lib


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    lib = _lib()
    n = lib.gfdl_column_params
    n.restype = ctypes.c_int
    if n() != len(_params(10.0)):
        raise RuntimeError(f"gfdl_column takes {n()} parameters, the "
                           f"launcher passes {len(_params(10.0))}")
    fn = getattr(lib, f"gfdl_column_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _most_blocks(device) -> int:
    """The most blocks a launch takes on `device`."""
    fn = _lib().gfdl_column_blocks
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int64
    return fn(torch.cuda.get_device_properties(device).multi_processor_count)


@functools.lru_cache(maxsize=None)
def mo_passes(device) -> torch.Tensor:
    """The most Newton passes of any cell over the launches on `device`
    since the tensor was last zeroed: a 0-d int32 tensor on the device, 0
    where only use_ncar launches ran (no Newton runs there)."""
    return torch.zeros((), dtype=torch.int32, device=device)


def _check(x, dtype, device, shape, name):
    if x.dtype != dtype or x.device != device:
        raise TypeError(f"{name} on {x.device} as {x.dtype}; expected "
                        f"{device} as {dtype}")
    return x.expand(shape).contiguous()


def gfdl_ocean_fluxes_cuda(tair, qair, uwnd, vwnd, press, sst, ssu, ssv,
                           u_star_prev, tmask, *, zlvl=10.0,
                           rough_scheme="beljaars", use_ncar=False):
    """The open-water fluxes as one launch of ``gfdl_column``: the plain
    version's dict of sh, lh, lwo, taox, taoy, u_star, rough_mom,
    rough_heat and rough_moist."""
    if rough_scheme not in ROUGH_SCHEMES:
        raise ValueError(f"unknown rough_scheme {rough_scheme!r}")
    dtype, device = tair.dtype, tair.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gfdl_column takes float32 or float64, not {dtype}")
    args = (tair, qair, uwnd, vwnd, press, sst, ssu, ssv, u_star_prev)
    shape = torch.broadcast_shapes(*(x.shape for x in args), tmask.shape)
    ins = [_check(x, dtype, device, shape, k) for k, x in zip(INPUTS, args)]
    mask = _check(tmask, torch.bool, device, shape, "tmask")
    outs = [torch.empty(shape, dtype=dtype, device=device) for _ in OUTPUTS]
    ptrs = ([x.data_ptr() for x in ins] + [mask.data_ptr()]
            + [x.data_ptr() for x in outs] + [mo_passes(device).data_ptr()])
    ints = [math.prod(shape), ROUGH_SCHEMES.index(rough_scheme),
            int(bool(use_ncar)), gf.MO_MAX_ITER, _most_blocks(device)]
    par = _params(zlvl)
    ptr_arr = (ctypes.c_int64 * len(ptrs))(*ptrs)
    int_arr = (ctypes.c_int64 * len(ints))(*ints)
    par_arr = (ctypes.c_double * len(par))(*par)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(dtype)(ctypes.addressof(ptr_arr), ctypes.addressof(int_arr),
                        ctypes.addressof(par_arr), stream)
    if rc != 0:
        raise RuntimeError(f"gfdl_column launch failed: cudaError {rc}")
    return dict(zip(OUTPUTS, outs))
