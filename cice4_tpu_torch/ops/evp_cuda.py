"""The EVP subcycle kernel and its wrapper.

``evp_subcycle`` (kernel ``csrc/evp_subcycle.cu``, replaces the TPU
kernels ``cice4_tpu/ops/evp_pallas.py::_kernel_blocked`` and, on grids
that are cyclic north-south, the whole-grid ``_kernel``) runs all ndte
subcycles of the stress relaxation and the momentum solve on the card:
one C call makes 2*ndte launches on PyTorch's current stream.  It
computes what the plain version :func:`_evp_subcycle_plain` computes:
the Jacobi update of `evp._evp_subcycle_jnp`, which the TPU kernel's
north-to-south block order also realises.

For CUDA tensors the wrapper launches the kernel (or raises); for CPU
tensors it runs the plain version.  ``evp_subcycle.launches`` counts the
wrapper's kernel calls (one per dynamics step), and
``evp_subcycle.ns_cyclic_launches`` those on an NS-cyclic grid, the
whole-grid TPU kernel's counterpart.  The kernel works on
new tensors made from uvel, vvel and the stresses, with velocities set
to zero off iceumask and stresses off icetmask (the masked-zero
invariant its activity gating relies on; `evp` always satisfies it), so
the caller's tensors are never written.  Boundaries: cyclic, open or
closed on both axes; tripole folds (ROADMAP queue 2 item 5) raise
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.ops.evp import EvpParams, _evp_subcycle_plain

_GEOM = ("cyp", "cxp", "cym", "cxm", "dxt", "dyt", "dxhy", "dyhx",
         "tinyarea", "uarear")
_OUT = ("strintx", "strinty", "strocnx", "strocny",
        "div_sum", "delta_sum", "ten_sum", "shr_sum", "prs_sig")


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


def _evp_subcycle_cuda(p: EvpParams, grid, strength, icetmask, iceumask,
                       aiu, uocn, vocn, waterx, watery, forcex, forcey,
                       umassdtei, fm, uvel, vvel, stressp, stressm,
                       stress12):
    bc = grid.bc
    if bc.ns in ("tripole", "tripoleT"):
        raise NotImplementedError(
            "evp_subcycle on a tripole grid is not ported yet (ROADMAP "
            "queue 2 item 5)")
    edges = ("cyclic", "open", "closed")
    if bc.ns not in edges or bc.ew not in edges:
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

    ptrs = [x.data_ptr() for x in geom + const + state + [str8] + outs]
    ptr_arr = (ctypes.c_int64 * len(ptrs))(*ptrs)
    params = [p.dte2T, p.denom1, p.denom2, p.rcon, p.ecci, p.cosw, p.sinw,
              p.dragw, cn.puny]
    par_arr = (ctypes.c_double * len(params))(*params)
    flags = int(p.evp_damping) | (int(p.hemi_turning) << 1)
    fn = _evp_fn(dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.addressof(ptr_arr), ny, nx, int(bc.ew == "cyclic"),
                int(bc.ns == "cyclic"), ctypes.addressof(par_arr), p.ndte,
                flags, stream)
    if rc != 0:
        raise RuntimeError(f"evp_subcycle launch failed: cudaError {rc}")
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


evp_subcycle.launches = 0
evp_subcycle.ns_cyclic_launches = 0
