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

:func:`evp_rounds` runs the k-halo rounds of a decomposed grid
(:mod:`cice4_tpu_torch.ops.evp_sharded`) through a kernel of their own,
``csrc/evp_rounds.cu``: on a padded block, doubly cyclic, p.ndte gated
subcycles and no final one, tile by tile with k-wide aprons in shared
memory, returning the velocities and stresses in new tensors.  A round
whose apron does not fit a block's shared memory runs as launches of
fewer subcycles (:func:`round_plan`; the arithmetic is the same), each
one :func:`round_launch`.  Its launches count in ``evp_rounds.launches``;
its plain version is :func:`_evp_rounds_plain`.
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


def _fit(x, shape, dtype, device):
    """`x` contiguous, after checking its device, type and shape."""
    if x.device != device or x.dtype != dtype:
        raise TypeError(f"EVP kernel input on {x.device} as {x.dtype}; "
                        f"expected {device} as {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"EVP kernel input of shape {tuple(x.shape)}; "
                         f"expected {shape}")
    return x.contiguous()


def _params(p: EvpParams):
    """The kernels' table of 9 double parameters and their flags."""
    params = [p.dte2T, p.denom1, p.denom2, p.rcon, p.ecci, p.cosw, p.sinw,
              p.dragw, cn.puny]
    return ((ctypes.c_double * len(params))(*params),
            int(p.evp_damping) | (int(p.hemi_turning) << 1))


def _evp_subcycle_cuda(p: EvpParams, grid, strength, icetmask, iceumask,
                       aiu, uocn, vocn, waterx, watery, forcex, forcey,
                       umassdtei, fm, uvel, vvel, stressp, stressm,
                       stress12):
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
        return _fit(x, shape, dt_, device)

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
    par_arr, flags = _params(p)
    fn = _evp_fn(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.addressof(ptr_arr), ny, nx, int(bc.ew == "cyclic"),
                KERNEL_BC_CODE[bc.ns], ctypes.addressof(par_arr), p.ndte,
                flags, stream)
    if rc != 0:
        raise RuntimeError(f"evp_subcycle launch failed: cudaError {rc}")
    evp_subcycle.stats = scratch[2 * blocks:2 * blocks + len(_STATS)]
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


# the round kernel's tile (rows, columns of its core) and the subcycles a
# launch runs at most, by type; a round of more subcycles runs as several
# launches.  8 x 16 is the fastest one-launch tile that
# tools/time_round_tiles.py times at gx1's rounds on an H100 (PERF.md
# section 6); two launches of 5 take 13% less device time but add a
# launch's host time to each round of a host-bound path.  In f64 the apron
# of 10 does not fit a block's shared memory, that of 7 does (the kernel
# refuses a tile that does not fit).
ROUND_TILE = {torch.float32: (8, 16, 10), torch.float64: (8, 16, 7)}


def round_launches(k: int, most: int) -> list[int]:
    """The subcycles of each launch of a round of `k` subcycles, at most
    `most` a launch, as even as they divide: 10 at most 5 is [5, 5], 9 is
    [5, 4]."""
    n = -(-k // most)
    return [k // n + 1] * (k % n) + [k // n] * (n - k % n)


def round_plan(k: int, dtype) -> tuple[int, int, list[int]]:
    """(rows, columns, subcycles of each launch) of a round of `k`
    subcycles: ROUND_TILE's."""
    rows, cols, most = ROUND_TILE[dtype]
    return rows, cols, round_launches(k, most)


def round_occupancy(rows: int, cols: int, k: int, dtype) -> dict:
    """What the runtime reports of the round kernel with a rows x cols
    tile and k subcycles on the current card: blocks resident an SM,
    threads per block, registers and local (stack and spill) bytes a
    thread, and the shared-memory bytes of a block."""
    from cice4_tpu_torch import cuda_build

    fn = cuda_build.load("evp_rounds").lib.evp_rounds_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(rows, cols, k, torch.empty((), dtype=dtype).element_size(),
            ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"evp_rounds_occupancy: cudaError {rc}")
    return dict(zip(("blocks_per_sm", "threads", "registers", "local_bytes",
                     "smem_bytes"), out))


def _rounds_fn(dtype):
    from cice4_tpu_torch import cuda_build

    lib = cuda_build.load("evp_rounds").lib
    fn = lib.evp_rounds_f32 if dtype == torch.float32 else lib.evp_rounds_f64
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def round_launch(p: EvpParams, grid, strength, icetmask, iceumask, aiu,
                 uocn, vocn, waterx, watery, forcex, forcey, umassdtei, fm,
                 uvel, vvel, stressp, stressm, stress12, rows, cols, k):
    """One launch of the round kernel: `k` subcycles with a rows x cols
    core tile, into new tensors (uvel, vvel, stressp, stressm, stress12).
    Counted in ``evp_rounds.launches``."""
    dtype, device = uvel.dtype, uvel.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"evp_rounds takes float32 or float64, not {dtype}")
    ny, nx = uvel.shape
    plane = (ny, nx)
    const = [_fit(getattr(grid, n), plane, dtype, device) for n in _GEOM] + [
        _fit(strength, plane, dtype, device),
        _fit(icetmask, plane, torch.bool, device),
        _fit(iceumask, plane, torch.bool, device)] + [
        _fit(x, plane, dtype, device) for x in (aiu, uocn, vocn, waterx,
                                                watery, forcex, forcey,
                                                umassdtei, fm)]
    state = [_fit(x, plane, dtype, device) for x in (uvel, vvel)] + [
        _fit(s, (4, ny, nx), dtype, device)
        for s in (stressp, stressm, stress12)]
    out = [torch.empty_like(x) for x in state]
    ptrs = [x.data_ptr() for x in const + state + out]
    ptr_arr = (ctypes.c_int64 * len(ptrs))(*ptrs)
    par_arr, flags = _params(p)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _rounds_fn(dtype)(ctypes.addressof(ptr_arr), ny, nx, rows, cols,
                               k, ctypes.addressof(par_arr), flags, stream)
    if rc != 0:
        raise RuntimeError(f"evp_rounds launch failed: cudaError {rc}")
    evp_rounds.launches += 1
    return tuple(out)


def _evp_rounds_cuda(p: EvpParams, *args):
    """The round on the card: `round_plan`'s launches of the round
    kernel."""
    if p.ndte < 1:
        raise ValueError(f"ndte must be >= 1, got {p.ndte}")
    *const, uvel, vvel, stressp, stressm, stress12 = args
    state = (uvel, vvel, stressp, stressm, stress12)
    rows, cols, launches = round_plan(p.ndte, uvel.dtype)
    for k in launches:
        state = round_launch(p, *const, *state, rows, cols, k)
    return state


def evp_rounds(p: EvpParams, grid, strength, icetmask, iceumask, aiu,
               uocn, vocn, waterx, watery, forcex, forcey, umassdtei, fm,
               uvel, vvel, stressp, stressm, stress12):
    """p.ndte gated EVP subcycles and no final one (a k-halo round) on a
    doubly cyclic padded block: returns (uvel, vvel, stressp, stressm,
    stress12).  The round kernel for CUDA tensors, :func:`_evp_rounds_plain`
    for CPU ones."""
    args = (p, grid, strength, icetmask, iceumask, aiu, uocn, vocn, waterx,
            watery, forcex, forcey, umassdtei, fm, uvel, vvel, stressp,
            stressm, stress12)
    if uvel.device.type == "cuda":
        return _evp_rounds_cuda(*args)
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
