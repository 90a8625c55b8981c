"""The remap kernels and their plain versions.

The default route (K0 in GSH mode, then K12):

* ``ga_gsh`` (kernel ``csrc/remap_gsh.cu``, replaces the TPU kernel K0,
  ``cice4_tpu/ops/remap_pallas.py::_ga_kernel``, in its GSH mode):
  departure-triangle geometry of every east and north edge, the 10
  monomial moments of each triangle by quadrature, the +/- scatter to the
  9 donor offsets and the back-shift by -offset: GSH (9, 10, ny, nx) in
  `remap.ALL_OFFSETS` order, in one launch that keeps the moments in
  shared memory (no scratch tensor).  Plain version :func:`ga_gsh_plain`
  (`remap._geom_accumulators` plus the back-shift).
* ``k12_divergence`` (kernel ``csrc/remap_k12.cu``, replaces K12,
  ``remap_pallas.py::_k12_kernel``): van-Leer-limited reconstruction of
  mass and tracers (:func:`_construct_vmem`) contracted against GSH into
  the flux divergences of all ncat+1 category rows (row 0 is open water,
  mass only).  Plain version :func:`k12_plain` (`_construct_vmem` plus
  `remap._flux_divergence_ga`).

The split route (K0 in GA mode, then K1 and K2; the JAX package's
``remap_pallas_divergence``):

* ``ga_planes`` (kernel ``csrc/remap_gsh.cu`` with ``emit_shifted=0``,
  replaces K0 in its GA mode): the accumulators GA (9, 10, ny, nx)
  without the back-shift.  Plain version :func:`ga_planes_plain`
  (`remap._geom_accumulators`).
* ``construct`` (kernel ``csrc/remap_k1k2.cu`` ``remap_construct``,
  replaces K1, ``remap_pallas.py::_construct_kernel``): the
  reconstruction of every row, mass (C, 3, ny, nx) and trc (C, T, 3, ny,
  nx).  Plain version :func:`construct_plain`.
* ``contract`` (kernel ``csrc/remap_k1k2.cu`` ``remap_contract``,
  replaces K2, ``remap_pallas.py::_contract_kernel``): the scatter-form
  contraction against GA, the parents' reconstructions read from the
  reconstruction itself (the plain version takes them gathered).  Plain
  version :func:`contract_plain`.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors; ``<wrapper>.launches`` counts its
kernel launches.  Boundaries: cyclic, open or closed on both axes, and
on the default route the tripole and tripoleT folds north-south, which
the plain versions take through `Nbr`.  The split route refuses a
tripole grid, as the JAX package never takes it there (ROADMAP queue 2
item 5).
"""

from __future__ import annotations

import ctypes

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.ops.remap import (ALL_OFFSETS, _flux_divergence_ga,
                                       _geom_accumulators, _n_type1,
                                       _shift_by, geometry_gsh)
from cice4_tpu_torch.parallel.halo import FOLDS, KERNEL_BC_CODE, Nbr

AXES = ((1, 0), (-1, 0), (0, 1), (0, -1))
DIAGS = ((1, 1), (-1, 1), (1, -1), (-1, -1))


def _check_bc(bc, fold_ok=True):
    """Raise on a boundary pair the remap kernels do not take: an unknown
    one, a fold east-west, and (``fold_ok`` False: the split route) a
    fold north-south."""
    for edge in (bc.ew, bc.ns):
        if edge not in KERNEL_BC_CODE:
            raise ValueError(f"unknown boundary {edge!r}")
    if bc.ew in FOLDS:
        raise ValueError(f"a tripole fold is a north-south boundary, not "
                         f"east-west ({bc})")
    if bc.ns in FOLDS and not fold_ok:
        raise NotImplementedError(
            "the split remap route (K0 in GA mode, K1, K2) on a tripole grid "
            "is not ported (ROADMAP queue 2 item 5); the default route takes "
            "it")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _grad_stream(sh, phi, phimask, cnx, cny, sval, smask):
    """Van-Leer limited gradient (``limited_gradient:1392-1556`` with
    unit cell widths), neighbour planes produced one offset at a time by
    `sval`/`smask` (port of `remap_pallas._grad_stream`)."""
    def nb(off):
        m = smask(off)
        return m * sval(off) + (1.0 - m) * phi

    phi_e, phi_w, phi_n, phi_s = (nb(off) for off in AXES)

    gx = 0.5 * (phi_e - phi_w)
    gy = 0.5 * (phi_n - phi_s)

    pmn = torch.minimum(torch.minimum(phi_e, phi_w),
                        torch.minimum(phi_n, phi_s))
    pmx = torch.maximum(torch.maximum(phi_e, phi_w),
                        torch.maximum(phi_n, phi_s))
    pmn = torch.minimum(pmn, phi)
    pmx = torch.maximum(pmx, phi)
    for off in DIAGS:
        v = nb(off)
        pmn = torch.minimum(pmn, v)
        pmx = torch.maximum(pmx, v)
    pmn = pmn - phi
    pmx = pmx - phi

    w1 = (0.5 - cnx) * gx + (0.5 - cny) * gy
    w2 = (0.5 - cnx) * gx - (0.5 + cny) * gy
    w3 = -(0.5 + cnx) * gx - (0.5 + cny) * gy
    w4 = (0.5 - cny) * gy - (0.5 + cnx) * gx

    qmn = torch.minimum(torch.minimum(w1, w2), torch.minimum(w3, w4))
    qmx = torch.maximum(torch.maximum(w1, w2), torch.maximum(w3, w4))

    # the guarded divisions keep NaN out of the branch not taken
    wa = torch.where(torch.abs(qmn) > 0.0,
                     torch.clamp(pmn / torch.where(qmn != 0.0, qmn, 1.0),
                                 min=0.0), 1.0)
    wb = torch.where(torch.abs(qmx) > 0.0,
                     torch.clamp(pmx / torch.where(qmx != 0.0, qmx, 1.0),
                                 min=0.0), 1.0)
    lim = torch.clamp(torch.minimum(wa, wb), max=1.0) * phimask
    return lim * gx, lim * gy


def _construct_vmem(mm, hm_real, tm, meta, sh):
    """Reconstruction of a batch of categories (``construct_fields:
    1069-1382``; port of `remap_pallas._construct_vmem`, the form K12
    runs): mm (C, ny, nx), hm_real (ny, nx), tm (C, T, ny, nx) ordered
    type-1 first.  Returns (mc, mx, my, tc, tx, ty)."""
    n1 = _n_type1(meta)
    T = len(meta)
    par2 = [meta[k][2] for k in range(n1, T)]

    def shift(f, off):
        return _shift_by(sh, f, off)

    mmask = (mm > cn.puny).to(mm.dtype)
    zero = torch.zeros_like(mm)
    mx, my = _grad_stream(sh, mm, hm_real, zero, zero,
                          lambda off: shift(mm, off),
                          lambda off: shift(hm_real, off))
    mc = mm
    safe_mm = torch.clamp(mm, min=cn.puny)
    mxav = torch.where(mmask > 0, mx / (12.0 * safe_mm), 0.0)
    myav = torch.where(mmask > 0, my / (12.0 * safe_mm), 0.0)

    def mmask_sh(off):
        return (shift(mm, off) > cn.puny).to(mm.dtype).unsqueeze(-3)

    def c(a):  # a per-category plane against the tracer axis
        return a.unsqueeze(-3)

    # type-1 tracers
    tm1 = tm[..., :n1, :, :]
    tx1, ty1 = _grad_stream(sh, tm1, c(mmask), c(mxav), c(myav),
                            lambda off: shift(tm1, off), mmask_sh)
    tc1 = tm1 - tx1 * c(mxav) - ty1 * c(myav)

    w2 = c(mc) * tx1 + c(mx) * tc1
    w3 = c(mc) * ty1 + c(my) * tc1
    denom = c(mm) * tm1
    good = (c(mmask) > 0) & (torch.abs(tm1) > cn.puny)
    safe_den = torch.where(torch.abs(denom) > cn.puny, denom, 1.0)
    mtxav1 = torch.where(good, w2 / (12.0 * safe_den), 0.0)
    mtyav1 = torch.where(good, w3 / (12.0 * safe_den), 0.0)

    if not par2:
        return mc, mx, my, tc1, tx1, ty1
    tm2 = tm[..., n1:, :, :]
    tmask1 = (torch.abs(tm1) > 0.0).to(mm.dtype) * c(mmask)

    def pick(s):
        return s[..., par2, :, :]

    pmask = pick(tmask1)
    parstack = pick(tm1)
    pmx_, pmy_ = pick(mtxav1), pick(mtyav1)
    tx2, ty2 = _grad_stream(
        sh, tm2, pmask, pmx_, pmy_,
        lambda off: shift(tm2, off),
        lambda off: ((torch.abs(shift(parstack, off)) > 0.0).to(mm.dtype)
                     * mmask_sh(off)))
    tc2 = tm2 - tx2 * pmx_ - ty2 * pmy_
    return (mc, mx, my, torch.cat([tc1, tc2], dim=-3),
            torch.cat([tx1, tx2], dim=-3), torch.cat([ty1, ty2], dim=-3))


def ga_gsh_plain(dx, dy, afac, bc, order=2):
    """GSH (9, 10, ny, nx): `remap._geom_accumulators` followed by the
    back-shift of each offset's planes by -offset (`remap.geometry_gsh`
    of the free-area geometry)."""
    return geometry_gsh(dx, dy, afac, bc, order)


def k12_plain(gsh, hm, mm_ext, tm_ext, meta, bc):
    """(div (C, ny, nx), divt (C, T, ny, nx)) of the C = ncat+1 category
    rows: `_construct_vmem` plus `remap._flux_divergence_ga`."""
    sh = Nbr(bc)
    GSH = {off: [gsh[o, k] for k in range(10)]
           for o, off in enumerate(ALL_OFFSETS)}
    mc, mx, my, tc, tx, ty = _construct_vmem(mm_ext, hm, tm_ext, list(meta),
                                             sh)
    return _flux_divergence_ga(GSH, mc, mx, my, tc, tx, ty, meta, sh)


def ga_planes_plain(dx, dy, afac, bc, order=2):
    """GA (9, 10, ny, nx): `remap._geom_accumulators` stacked in
    `remap.ALL_OFFSETS` order, without the back-shift (what K0 writes in
    its GA mode)."""
    GA = _geom_accumulators(afac, dx, dy, order, Nbr(bc))
    zero = torch.zeros_like(afac)
    return torch.stack([torch.stack([GA[off][k] + zero for k in range(10)])
                        for off in ALL_OFFSETS])


def construct_plain(hm, mm_ext, tm_ext, meta, bc):
    """(mass (C, 3, ny, nx), trc (C, T, 3, ny, nx)): the reconstruction
    (mc, mx, my) and per tracer (tc, tx, ty) of every row, row 0
    included (what K1 writes)."""
    mc, mx, my, tc, tx, ty = _construct_vmem(mm_ext, hm, tm_ext, list(meta),
                                             Nbr(bc))
    return torch.stack([mc, mx, my], dim=1), torch.stack([tc, tx, ty], dim=2)


def parent_set(meta):
    """The rows that type-2 tracers take as parents, sorted: the rows of
    `trc` that :func:`gather_parents` gathers (`parset` of K2)."""
    return tuple(sorted({p for (_n, tt, p) in meta if tt == 2}))


def parent_positions(meta):
    """Per tracer, the index of its parent in :func:`parent_set`, or -1
    for a type-1 tracer."""
    parset = parent_set(meta)
    return [parset.index(p) if tt == 2 else -1 for (_n, tt, p) in meta]


def gather_parents(trc, meta):
    """par (C, P, 3, ny, nx): the parents' reconstructions, gathered from
    trc once (a plain index, as the JAX route leaves it to XLA); one zero
    row when no tracer has a parent."""
    parset = parent_set(meta)
    if not parset:
        return trc.new_zeros(trc.shape[:1] + (1, 3) + trc.shape[-2:])
    return trc[:, list(parset)]


def contract_plain(ga, mass, trc, par, meta, bc):
    """(div (C, ny, nx), divt (C, T, ny, nx)): the scatter-form
    contraction ``div(c) = sum_off S_off(S_-off(GA[off]) * U)(c)`` of
    `remap_pallas._contract_kernel`, for all rows and tracers at once.
    U are the monomial coefficients of m*p*t with parent planes p = (1, 0,
    0) for a type-1 tracer and the parent's reconstruction from `par` for
    a type-2 tracer (gathered here when `par` is None)."""
    sh = Nbr(bc)
    T = len(meta)
    if par is None:
        par = gather_parents(trc, meta)
    mc, mx, my = mass[:, 0], mass[:, 1], mass[:, 2]
    if T:
        c2, x2, y2 = trc[:, :, 0], trc[:, :, 1], trc[:, :, 2]
        one, zer = torch.ones_like(mc), torch.zeros_like(mc)
        planes = [(one, zer, zer) if pp < 0 else
                  (par[:, pp, 0], par[:, pp, 1], par[:, pp, 2])
                  for pp in parent_positions(meta)]
        pc, px, py = (torch.stack([pl[q] for pl in planes], dim=1)
                      for q in range(3))
        mc1, mx1, my1 = (a.unsqueeze(1) for a in (mc, mx, my))
        mpc, mpx, mpy = mc1 * pc, mc1 * px, mc1 * py
        xpc, xpx, xpy = mx1 * pc, mx1 * px, mx1 * py
        ypc, ypx, ypy = my1 * pc, my1 * px, my1 * py
    div = divt = None
    for o, off in enumerate(ALL_OFFSETS):
        neg = (-off[0], -off[1])
        g0, g1, g2, g3, g4, g5, g6, g7, g8, g9 = (
            _shift_by(sh, ga[o, k], neg) for k in range(10))
        dm = _shift_by(sh, g0 * mc + g1 * mx + g2 * my, off)
        div = dm if div is None else div + dm
        if not T:
            continue
        p = (g0 * (mpc * c2)
             + g1 * (xpc * c2 + mpx * c2 + mpc * x2)
             + g2 * (ypc * c2 + mpy * c2 + mpc * y2)
             + g3 * (xpx * c2 + xpc * x2 + mpx * x2)
             + g4 * (xpy * c2 + ypx * c2 + xpc * y2
                     + ypc * x2 + mpx * y2 + mpy * x2)
             + g5 * (ypy * c2 + ypc * y2 + mpy * y2)
             + g6 * (xpx * x2)
             + g7 * (xpx * y2 + xpy * x2 + ypx * x2)
             + g8 * (xpy * y2 + ypx * y2 + ypy * x2)
             + g9 * (ypy * y2))
        dp = _shift_by(sh, p, off)
        divt = dp if divt is None else divt + dp
    if not T:
        divt = mc.new_zeros(mc.shape[:1] + (0,) + mc.shape[1:])
    return div, divt


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
# the tracer table the kernel is built for (remap_k12.cu kMaxT, kMaxT1)
K12_MAX_T, K12_MAX_T1 = 32, 8


def _fn(lib_name, sym, dtype, argtypes):
    from cice4_tpu_torch import cuda_build

    lib = cuda_build.load(lib_name).lib
    fn = getattr(lib, f"{sym}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _plane(x, device, dtype, shape):
    if x.device != device or x.dtype != dtype:
        raise TypeError(f"remap kernel input on {x.device} as {x.dtype}; "
                        f"expected {device} as {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"remap kernel input of shape {tuple(x.shape)}; "
                         f"expected {tuple(shape)}")
    return x.contiguous()


def _dtype_device(x, name):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {x.dtype}")
    return x.dtype, x.device


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _ga_gsh_cuda(dx, dy, afac, bc, order, case_codes=None,
                 emit_shifted=True):
    _check_bc(bc, fold_ok=emit_shifted)
    if order not in (1, 2, 3):
        raise ValueError(f"integral_order must be 1, 2 or 3, not {order}")
    dtype, device = _dtype_device(dx, "remap_gsh")
    ny, nx = dx.shape
    dx, dy, afac = (_plane(a, device, dtype, (ny, nx)) for a in (dx, dy, afac))
    # the output only: the kernel keeps the edges' moment planes in shared
    # memory
    gsh = torch.empty((9, 10, ny, nx), dtype=dtype, device=device)
    codes = 0
    if case_codes is not None:
        if (case_codes.shape != (2, ny, nx) or case_codes.dtype != torch.int32
                or case_codes.device != device):
            raise ValueError("case_codes must be int32 (2, ny, nx) on the "
                             "inputs' device")
        codes = case_codes.data_ptr()
    fn = _fn("remap_gsh", "remap_gsh", dtype,
             [_VOIDP] * 5 + [_INT] * 6 + [_VOIDP])
    rc = fn(dx.data_ptr(), dy.data_ptr(), afac.data_ptr(), gsh.data_ptr(),
            codes, ny, nx, KERNEL_BC_CODE[bc.ew], KERNEL_BC_CODE[bc.ns], order,
            int(emit_shifted), _stream(device))
    if rc != 0:
        raise RuntimeError(f"remap_gsh launch failed: cudaError {rc}")
    if emit_shifted:
        ga_gsh.launches += 1
    else:
        ga_planes.launches += 1
    return gsh


def ga_gsh(dx, dy, afac, bc, order=2):
    """Back-shifted GA divergence accumulators GSH (9, 10, ny, nx) from
    the scaled departure displacements dx, dy and the corner area factor
    afac (all (ny, nx) at U points).  Kernel ``remap_gsh`` on CUDA
    tensors, :func:`ga_gsh_plain` on CPU tensors."""
    if dx.device.type == "cuda":
        return _ga_gsh_cuda(dx, dy, afac, bc, order)
    if dx.device.type == "cpu":
        return ga_gsh_plain(dx, dy, afac, bc, order)
    raise NotImplementedError(f"ga_gsh has no path for device {dx.device}")


ga_gsh.launches = 0


def ga_planes(dx, dy, afac, bc, order=2):
    """The GA divergence accumulators (9, 10, ny, nx), not back-shifted:
    kernel ``remap_gsh`` in GA mode on CUDA tensors, :func:`ga_planes_plain`
    on CPU tensors.  Not on a tripole grid (the split route)."""
    _check_bc(bc, fold_ok=False)
    if dx.device.type == "cuda":
        return _ga_gsh_cuda(dx, dy, afac, bc, order, emit_shifted=False)
    if dx.device.type == "cpu":
        return ga_planes_plain(dx, dy, afac, bc, order)
    raise NotImplementedError(f"ga_planes has no path for device {dx.device}")


ga_planes.launches = 0


def edge_cases_plain(dx, dy, afac, bc):
    """The case code of every east and north edge (`remap._edge_geometry`
    ``case``), int32 (2, ny, nx): what ``remap_gsh`` writes when asked."""
    from cice4_tpu_torch.ops.remap import _edge_geometry

    sh = Nbr(bc)
    return torch.stack([_edge_geometry(edge, afac, dx, dy, sh)["case"]
                        for edge in ("east", "north")])


def edge_cases_cuda(dx, dy, afac, bc, order=2, emit_shifted=True):
    """(GSH, or GA with ``emit_shifted=False``, and the case codes (2, ny,
    nx)) from one ``remap_gsh`` launch: the comparison of the kernel's
    geometric case selection with :func:`edge_cases_plain`.  Counts as a
    launch of `ga_gsh` (or `ga_planes`)."""
    codes = torch.empty((2,) + tuple(dx.shape), dtype=torch.int32,
                        device=dx.device)
    out = _ga_gsh_cuda(dx, dy, afac, bc, order, case_codes=codes,
                       emit_shifted=emit_shifted)
    return out, codes


def gsh_tile(order: int, dtype, device) -> dict:
    """The tile a ``remap_gsh`` call of quadrature order `order` launches
    with on the card `device`, as the kernel's library picks it: ``rows``
    (of 32 cells, two threads a cell), ``smem_bytes`` a block and
    ``blocks_per_sm`` the runtime keeps resident.  The same in both
    modes."""
    fn = _fn("remap_gsh", "remap_gsh_tile", dtype, [_INT] + [_VOIDP] * 3)
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        rc = fn(order, *(ctypes.addressof(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"remap_gsh has no tile for order {order}: "
                           f"error {rc}")
    return dict(zip(("rows", "smem_bytes", "blocks_per_sm"),
                    (x.value for x in out)))


def _tracer_table(name, meta, T):
    """(n1, the parent row of each tracer) as the reconstruction kernels
    take them, after checking the table fits them."""
    n1 = _n_type1(meta)
    if len(meta) != T or T > K12_MAX_T or n1 > K12_MAX_T1:
        raise NotImplementedError(
            f"{name} takes at most {K12_MAX_T} tracers of which "
            f"{K12_MAX_T1} of type 1; got {T} ({n1}), meta of {len(meta)}")
    par = [max(p, 0) for (_n, _t, p) in meta]
    if any(p >= n1 for p in par):
        raise ValueError("a type-2 tracer's parent must be a type-1 row")
    return n1, par


def _int_table(values):
    return (ctypes.c_int * max(len(values), 1))(*(values or [0]))


def _tile(lib, sym, T, n1, dtype, device) -> dict:
    fn = _fn(lib, sym, dtype, [_INT, _INT] + [_VOIDP] * 3)
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        rc = fn(T, n1, *(ctypes.addressof(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"{sym} has no tile for {T} tracers ({n1} of "
                           f"type 1): error {rc}")
    return dict(zip(("rows", "smem_bytes", "blocks_per_sm"),
                    (x.value for x in out)))


def k12_tile(T: int, n1: int, dtype, device) -> dict:
    """The tile a K12 call with T tracers, n1 of type 1, launches with on
    the card `device`, as the kernel's library picks it: ``rows`` (of 32
    cells), ``smem_bytes`` a block and ``blocks_per_sm`` the runtime keeps
    resident."""
    return _tile("remap_k12", "remap_k12_tile", T, n1, dtype, device)


def construct_tile(T: int, n1: int, dtype, device) -> dict:
    """The tile of a K1 call, as :func:`k12_tile` gives K12's."""
    return _tile("remap_k1k2", "remap_construct_tile", T, n1, dtype, device)


def contract_tile(T: int, n1: int, dtype, device) -> dict:
    """The tile of a K2 call, as :func:`k12_tile` gives K12's."""
    return _tile("remap_k1k2", "remap_contract_tile", T, n1, dtype, device)


def _k12_cuda(gsh, hm, mm_ext, tm_ext, meta, bc):
    _check_bc(bc)
    dtype, device = _dtype_device(hm, "remap_k12")
    C, T = tm_ext.shape[:2]
    ny, nx = hm.shape
    n1, par = _tracer_table("remap_k12", meta, T)
    gsh = _plane(gsh, device, dtype, (9, 10, ny, nx))
    hm = _plane(hm, device, dtype, (ny, nx))
    mm_ext = _plane(mm_ext, device, dtype, (C, ny, nx))
    tm_ext = _plane(tm_ext, device, dtype, (C, T, ny, nx))
    div = torch.empty((C, ny, nx), dtype=dtype, device=device)
    divt = torch.empty((C, T, ny, nx), dtype=dtype, device=device)
    par_arr = _int_table(par)
    fn = _fn("remap_k12", "remap_k12", dtype,
             [_VOIDP] * 6 + [_INT] * 7 + [_VOIDP] * 2)
    rc = fn(gsh.data_ptr(), hm.data_ptr(), mm_ext.data_ptr(),
            tm_ext.data_ptr(), div.data_ptr(), divt.data_ptr(), C, T, n1, ny,
            nx, KERNEL_BC_CODE[bc.ew], KERNEL_BC_CODE[bc.ns], ctypes.addressof(par_arr),
            _stream(device))
    if rc != 0:
        raise RuntimeError(f"remap_k12 launch failed: cudaError {rc}")
    k12_divergence.launches += 1
    return div, divt


def k12_divergence(gsh, hm, mm_ext, tm_ext, meta, bc):
    """(div_ext (C, ny, nx), divt_ext (C, T, ny, nx)) of the extended
    category batch (row 0 open water) against GSH.  Kernel ``remap_k12``
    on CUDA tensors, :func:`k12_plain` on CPU tensors."""
    if hm.device.type == "cuda":
        return _k12_cuda(gsh, hm, mm_ext, tm_ext, meta, bc)
    if hm.device.type == "cpu":
        return k12_plain(gsh, hm, mm_ext, tm_ext, meta, bc)
    raise NotImplementedError(
        f"k12_divergence has no path for device {hm.device}")


k12_divergence.launches = 0


def _construct_cuda(hm, mm_ext, tm_ext, meta, bc):
    _check_bc(bc)
    dtype, device = _dtype_device(hm, "remap_construct")
    C, T = tm_ext.shape[:2]
    ny, nx = hm.shape
    n1, par = _tracer_table("remap_construct", meta, T)
    hm = _plane(hm, device, dtype, (ny, nx))
    mm_ext = _plane(mm_ext, device, dtype, (C, ny, nx))
    tm_ext = _plane(tm_ext, device, dtype, (C, T, ny, nx))
    mass = torch.empty((C, 3, ny, nx), dtype=dtype, device=device)
    trc = torch.empty((C, T, 3, ny, nx), dtype=dtype, device=device)
    par_arr = _int_table(par)
    fn = _fn("remap_k1k2", "remap_construct", dtype,
             [_VOIDP] * 5 + [_INT] * 7 + [_VOIDP] * 2)
    rc = fn(hm.data_ptr(), mm_ext.data_ptr(), tm_ext.data_ptr(),
            mass.data_ptr(), trc.data_ptr(), C, T, n1, ny, nx,
            KERNEL_BC_CODE[bc.ew], KERNEL_BC_CODE[bc.ns], ctypes.addressof(par_arr),
            _stream(device))
    if rc != 0:
        raise RuntimeError(f"remap_construct launch failed: cudaError {rc}")
    construct.launches += 1
    return mass, trc


def construct(hm, mm_ext, tm_ext, meta, bc):
    """(mass (C, 3, ny, nx), trc (C, T, 3, ny, nx)): the reconstruction of
    every row of the extended category batch.  Kernel ``remap_construct``
    (K1) on CUDA tensors, :func:`construct_plain` on CPU tensors.  Not on
    a tripole grid (the split route)."""
    _check_bc(bc, fold_ok=False)
    if hm.device.type == "cuda":
        return _construct_cuda(hm, mm_ext, tm_ext, meta, bc)
    if hm.device.type == "cpu":
        return construct_plain(hm, mm_ext, tm_ext, meta, bc)
    raise NotImplementedError(f"construct has no path for device {hm.device}")


construct.launches = 0


def _contract_cuda(ga, mass, trc, meta, bc):
    _check_bc(bc)
    dtype, device = _dtype_device(mass, "remap_contract")
    C, _three, ny, nx = mass.shape
    T = len(meta)
    n1, par = _tracer_table("remap_contract", meta, T)
    ga = _plane(ga, device, dtype, (9, 10, ny, nx))
    mass = _plane(mass, device, dtype, (C, 3, ny, nx))
    trc = _plane(trc, device, dtype, (C, T, 3, ny, nx))
    div = torch.empty((C, ny, nx), dtype=dtype, device=device)
    divt = torch.empty((C, T, ny, nx), dtype=dtype, device=device)
    par_arr = _int_table(par)
    fn = _fn("remap_k1k2", "remap_contract", dtype,
             [_VOIDP] * 5 + [_INT] * 7 + [_VOIDP] * 2)
    rc = fn(ga.data_ptr(), mass.data_ptr(), trc.data_ptr(), div.data_ptr(),
            divt.data_ptr(), C, T, n1, ny, nx, KERNEL_BC_CODE[bc.ew],
            KERNEL_BC_CODE[bc.ns], ctypes.addressof(par_arr), _stream(device))
    if rc != 0:
        raise RuntimeError(f"remap_contract launch failed: cudaError {rc}")
    contract.launches += 1
    return div, divt


def contract(ga, mass, trc, par, meta, bc):
    """(div (C, ny, nx), divt (C, T, ny, nx)) of the extended category
    batch (row 0 open water, whose tracers are zero) from GA and the
    reconstruction.  `par` is ``gather_parents(trc, meta)`` or None: the
    kernel reads the parents' planes from `trc` and ignores it.  Kernel
    ``remap_contract`` (K2) on CUDA tensors, :func:`contract_plain` on CPU
    tensors.  Not on a tripole grid (the split route)."""
    _check_bc(bc, fold_ok=False)
    if mass.device.type == "cuda":
        return _contract_cuda(ga, mass, trc, meta, bc)
    if mass.device.type == "cpu":
        return contract_plain(ga, mass, trc, par, meta, bc)
    raise NotImplementedError(f"contract has no path for device {mass.device}")


contract.launches = 0
