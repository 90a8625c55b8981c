"""The EVP subcycle kernel and its wrapper.

``evp_subcycle`` (kernel ``csrc/evp_subcycle.cu``, replaces the TPU
kernels ``cice4_tpu/ops/evp_pallas.py::_kernel_blocked`` and, on grids
that are cyclic north-south, the whole-grid ``_kernel``) runs all ndte
subcycles of the stress relaxation and the momentum solve on the card:
one C call makes one persistent cooperative launch on PyTorch's current
stream, whose grid barriers separate the passes.  It
computes what the plain version :func:`_evp_subcycle_plain` computes:
the Jacobi update of `evp._evp_subcycle_jnp`, which the TPU kernel's
north-to-south block order also realises.

For CUDA tensors the wrapper launches the kernel (or raises); for CPU
tensors it runs the plain version.  ``evp_subcycle.launches`` counts the
wrapper's kernel calls (one per dynamics step), and
``evp_subcycle.ns_cyclic_launches`` those on an NS-cyclic grid, the
whole-grid TPU kernel's counterpart; :func:`last_launch` reads what the
last launch reported.  The kernel works on
new tensors made from uvel, vvel and the stresses, with velocities set
to zero off iceumask and stresses off icetmask (the masked-zero
invariant its activity gating relies on; `evp` always satisfies it), so
the caller's tensors are never written.  Boundaries: cyclic, open or
closed on both axes, and the tripole and tripoleT folds north-south (the
kernel folds the str8 reads of the momentum pass; `evp` makes the top
row of U points symmetric before the call).

:func:`evp_rounds` is the kernel in round mode, for the k-halo rounds of
a decomposed grid (:mod:`cice4_tpu_torch.ops.evp_sharded`): on a padded
block, doubly cyclic to the kernel, it runs p.ndte gated subcycles and
no final one, and returns the velocities and stresses.  Its launches
count in ``evp_rounds.launches``; its plain version is
:func:`_evp_rounds_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.ops.evp import (EvpParams, _evp_rounds_plain,
                                    _evp_subcycle_plain)
from cice4_tpu_torch.parallel.halo import KERNEL_BC_CODE

_GEOM = ("cyp", "cxp", "cym", "cxm", "dxt", "dyt", "dxhy", "dyhx",
         "tinyarea", "uarear")
_OUT = ("strintx", "strinty", "strocnx", "strocny",
        "div_sum", "delta_sum", "ten_sum", "shr_sum", "prs_sig")
# what a launch reports (evp_subcycle.cu kStats)
_STATS = ("active_t_cells", "active_u_points", "grid_barriers", "blocks",
          "threads_per_block")


def _evp_fn(dtype):
    from cice4_tpu_torch import cuda_build

    lib = cuda_build.load("evp_subcycle").lib
    fn = lib.evp_subcycle_f32 if dtype == torch.float32 \
        else lib.evp_subcycle_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def resident_grid(dtype, device_index: int):
    """(blocks, threads per block) of the kernel's cooperative grid on the
    card `device_index`: as many blocks as can be resident together."""
    from cice4_tpu_torch import cuda_build

    lib = cuda_build.load("evp_subcycle").lib
    fn = lib.evp_subcycle_resident_f32 if dtype == torch.float32 \
        else lib.evp_subcycle_resident_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = fn(ctypes.addressof(blocks), ctypes.addressof(threads))
    if rc != 0:
        raise RuntimeError(f"evp_subcycle cannot size its cooperative grid: "
                           f"cudaError {rc}")
    return blocks.value, threads.value


def _evp_subcycle_cuda(p: EvpParams, grid, strength, icetmask, iceumask,
                       aiu, uocn, vocn, waterx, watery, forcex, forcey,
                       umassdtei, fm, uvel, vvel, stressp, stressm,
                       stress12, rounds: bool = False):
    bc = grid.bc
    if bc.ns not in KERNEL_BC_CODE or bc.ew not in ("cyclic", "open",
                                                    "closed"):
        raise ValueError(f"unknown boundary conditions {bc}")
    dtype, device = uvel.dtype, uvel.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"evp_subcycle takes float32 or float64, not {dtype}")
    if p.ndte < 1:
        raise ValueError(f"ndte must be >= 1, got {p.ndte}")
    ny, nx = uvel.shape

    def fit(x, shape, dt_=dtype):
        if x.device != device or x.dtype != dt_:
            raise TypeError(f"evp_subcycle input on {x.device} as "
                            f"{x.dtype}; expected {device} as {dt_}")
        if tuple(x.shape) != shape:
            raise ValueError(f"evp_subcycle input of shape "
                             f"{tuple(x.shape)}; expected {shape}")
        return x.contiguous()

    plane = (ny, nx)
    geom = [fit(getattr(grid, k), plane) for k in _GEOM]
    const = [fit(strength, plane), fit(icetmask, plane, torch.bool),
             fit(iceumask, plane, torch.bool)] + [
        fit(x, plane) for x in (aiu, uocn, vocn, waterx, watery, forcex,
                                forcey, umassdtei, fm)]
    # the kernel updates its state in place: work on new tensors, which
    # also carry the masked-zero invariant its activity gating needs
    # (velocities zero off iceumask, stresses zero off icetmask; evp()
    # guarantees it, as evp_pallas.py:383-390 enforces it on the TPU)
    icet, iceu = const[1], const[2]
    state = [torch.where(iceu, fit(x, plane), 0.0) for x in (uvel, vvel)] + [
        torch.where(icet, fit(s, (4, ny, nx)), 0.0).contiguous()
        for s in (stressp, stressm, stress12)]
    str8 = torch.empty((8, ny, nx), dtype=dtype, device=device)
    outs = [torch.empty(plane, dtype=dtype, device=device) for _ in _OUT]
    # per-block counts, what the launch reports, and the active T-cell and
    # U-point lists
    blocks, _ = resident_grid(dtype, device.index)
    scratch = torch.empty(2 * blocks + len(_STATS) + 2 * ny * nx,
                          dtype=torch.int32, device=device)

    ptrs = [x.data_ptr() for x in geom + const + state + [str8] + outs
            + [scratch]]
    ptr_arr = (ctypes.c_int64 * len(ptrs))(*ptrs)
    params = [p.dte2T, p.denom1, p.denom2, p.rcon, p.ecci, p.cosw, p.sinw,
              p.dragw, cn.puny]
    par_arr = (ctypes.c_double * len(params))(*params)
    # bit 2: round mode, p.ndte gated subcycles and no final one
    flags = (int(p.evp_damping) | (int(p.hemi_turning) << 1)
             | (int(rounds) << 2))
    fn = _evp_fn(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.addressof(ptr_arr), ny, nx, int(bc.ew == "cyclic"),
                KERNEL_BC_CODE[bc.ns], ctypes.addressof(par_arr), p.ndte,
                flags, stream)
    if rc != 0:
        raise RuntimeError(f"evp_subcycle launch failed: cudaError {rc}")
    evp_subcycle.stats = scratch[2 * blocks:2 * blocks + len(_STATS)]
    if rounds:
        evp_rounds.launches += 1
        return tuple(state)
    evp_subcycle.launches += 1
    if bc.ns == "cyclic":
        evp_subcycle.ns_cyclic_launches += 1
    o = dict(zip(_OUT, outs))
    diag = {k: o[k] for k in ("div_sum", "delta_sum", "ten_sum", "shr_sum",
                              "prs_sig")}
    return (*state, diag, o["strintx"], o["strinty"], o["strocnx"],
            o["strocny"])


def evp_subcycle(p: EvpParams, grid, strength, icetmask, iceumask, aiu,
                 uocn, vocn, waterx, watery, forcex, forcey, umassdtei, fm,
                 uvel, vvel, stressp, stressm, stress12):
    """All ndte EVP subcycles (``ice_dyn_evp.F90:347-408``), with the
    signature and results of :func:`_evp_subcycle_plain`: (uvel, vvel,
    stressp, stressm, stress12, diag, strintx, strinty, strocnx,
    strocny)."""
    args = (p, grid, strength, icetmask, iceumask, aiu, uocn, vocn, waterx,
            watery, forcex, forcey, umassdtei, fm, uvel, vvel, stressp,
            stressm, stress12)
    if uvel.device.type == "cuda":
        return _evp_subcycle_cuda(*args)
    if uvel.device.type == "cpu":
        return _evp_subcycle_plain(*args)
    raise NotImplementedError(
        f"evp_subcycle has no path for device {uvel.device}")


def evp_rounds(p: EvpParams, grid, strength, icetmask, iceumask, aiu,
               uocn, vocn, waterx, watery, forcex, forcey, umassdtei, fm,
               uvel, vvel, stressp, stressm, stress12):
    """p.ndte gated EVP subcycles and no final one (a k-halo round):
    returns (uvel, vvel, stressp, stressm, stress12).  The kernel in
    round mode for CUDA tensors, :func:`_evp_rounds_plain` for CPU
    ones."""
    args = (p, grid, strength, icetmask, iceumask, aiu, uocn, vocn, waterx,
            watery, forcex, forcey, umassdtei, fm, uvel, vvel, stressp,
            stressm, stress12)
    if uvel.device.type == "cuda":
        return _evp_subcycle_cuda(*args, rounds=True)
    if uvel.device.type == "cpu":
        return _evp_rounds_plain(*args)
    raise NotImplementedError(
        f"evp_rounds has no path for device {uvel.device}")


def last_launch() -> dict:
    """What the kernel's last launch reported it ran: its active T cells
    and U points, the grid barriers it passed, its blocks and threads per
    block (a device-to-host copy, so a sync)."""
    if evp_subcycle.stats is None:
        raise RuntimeError("evp_subcycle has not launched its kernel")
    return dict(zip(_STATS, evp_subcycle.stats.tolist()))


evp_subcycle.launches = 0
evp_subcycle.ns_cyclic_launches = 0
evp_rounds.launches = 0
evp_subcycle.stats = None
