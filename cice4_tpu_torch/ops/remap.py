"""Incremental remapping transport (Dukowicz & Baumgardner 2000;
Lipscomb & Hunke 2004).

Port of the GA branch of :mod:`cice4_tpu.ops.remap` (``source/
ice_transport_remap.F90`` and the reference's ``transport_remap:
179-663``): second-order, monotone (van-Leer-limited linear
reconstruction), conservative.

Every edge of the grid carries a dense set of up to 6 departure
triangles (`_edge_geometry`).  Their monomial moments, scattered to the
9 donor offsets and back-shifted, form the category-independent GSH
tensor (`_geom_accumulators` + `_shift_by`): kernel ``remap_gsh`` on
the card (:func:`cice4_tpu_torch.ops.remap_cuda.ga_gsh`).  Each
category's van-Leer reconstruction is then contracted against GSH into
the flux divergences (`remap_cuda._construct_vmem` +
`_flux_divergence_ga`): kernel ``remap_k12`` on the card
(:func:`cice4_tpu_torch.ops.remap_cuda.k12_divergence`).

The split route (``split_kernels=True``, or ``CICE4_FORCE_PALLAS_REMAP``
set on a CUDA device; the JAX package's ``use_pallas`` route
``remap_pallas.remap_pallas_divergence``) computes the same divergences
in three kernels: the GA accumulators without the back-shift (K0 in GA
mode, `remap_cuda.ga_planes`), the reconstruction of every row (K1,
`remap_cuda.construct`) and the scatter-form contraction (K2,
`remap_cuda.contract`).  The two routes agree to roundoff.

On a tripole grid every north shift folds (`parallel.halo`), as in the
JAX package's XLA GA path, and both kernels of the default route fold
too; the split route, which the JAX package never takes there, refuses
it (ROADMAP queue 2 item 5).

As in the reference, all local geometry is computed on the *scaled*
grid (cell = unit square); physical areas enter only through the corner
area factors dxu*dyu and the final 1/tarea.

The options of the JAX package's transport: the departure-point
midpoint correction (``l_dp_midpt``, `_departure_midpoint`, on either
route); the fixed-area mode (``l_fixed_area``), whose area-matched
geometry is plain PyTorch (`geometry_gsh`, as the JAX package computes
it under XLA) and is contracted by K12; and the global conservation and
monotonicity checks, whose guard records stay on the device.  The JAX
package's legacy non-GA contraction is not ported: it computes the same
divergences as the GA branch.

On a decomposed grid (:func:`transport_remap_decomposed`) a block runs
the k-halo remap of :func:`transport_remap_sharded`: one batched 6-ring
exchange of every input plane, the whole remap on the padded block (its
kernels included, as on the doubly periodic box) and the core kept;
under the U-fold the top row of blocks also remaps the full-width strip
of the fold's top rows, whose folded intermediate planes a ghost ring
does not reproduce, and keeps its top rows.  Where
:func:`remap_sharded_eligible` refuses (the T-fold, the global checks,
small blocks, a one-block mesh) the block takes the gathered path: it
gathers the inputs and runs the one-device remap.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.constants import FieldLoc, FieldType
from cice4_tpu_torch.grid import Grid
from cice4_tpu_torch.guards import _is_f64, record
from cice4_tpu_torch.ops.itd import TRACER_DEPEND
from cice4_tpu_torch.parallel.halo import FOLDS, Nbr
from cice4_tpu_torch.state import State

NGROUPS = 6

# neighbor-position codes for flux cells
TL, BL, TR, BR, TC, BC = 0, 1, 2, 3, 4, 5

# which positions each triangle group can flux into (static)
GROUP_POSITIONS = ((TL, BL), (TR, BR), (TL, BL, TR, BR),
                   (TC, BC), (TC, BC), (TC, BC))

# (ishift, jshift) per position, per edge (ice_transport_remap.F90:1990-2030)
SHIFTS = {
    "north": {TL: (-1, 1), BL: (-1, 0), TR: (1, 1), BR: (1, 0),
              TC: (0, 1), BC: (0, 0)},
    "east": {TL: (1, 1), BL: (0, 1), TR: (1, -1), BR: (0, -1),
             TC: (1, 0), BC: (0, 0)},
}

# all 9 donor offsets a flux divergence can draw from
ALL_OFFSETS = tuple((di, dj) for dj in (1, 0, -1) for di in (-1, 0, 1))

# bits of the per-edge case code `_edge_geometry` returns: the 8 corner
# cases, then the index (1-12) of the centre case that was selected last
_CORNER_CASES = ("c_tl", "c_bl", "c_tl1", "c_tl2",
                 "c_tr", "c_br", "c_tr1", "c_tr2")
CENTER_CASE_SHIFT = len(_CORNER_CASES)


def _shift_by(sh, f, off):
    """Composite masked shift by offset (di, dj), x then y:
    ``out(c) = f(c + off)``."""
    di, dj = off
    if di == 1:
        f = sh.e(f)
    elif di == -1:
        f = sh.w(f)
    if dj == 1:
        f = sh.n(f)
    elif dj == -1:
        f = sh.s(f)
    return f


def _edge_geometry(edge, afac, dx, dy, sh, edgearea=None):
    """Departure-triangle geometry for all edges of one direction
    (``locate_triangles:1763-3146``, 0-based groups).

    dx/dy: scaled departure displacements at U corners (= -dt*u/dxu).
    edgearea: prescribed signed area flux per edge (m^2) for the
    ``l_fixed_area`` mode (``:2352-2487``): the trajectory midpoint is
    shifted so that the departure region has exactly this area.  None is
    the default free-area mode.
    Returns per group g: verts[g] = ((x1,x2,x3), (y1,y2,y3)) in
    flux-cell coordinates, pos[g] (int code), triarea[g] (signed
    physical area), and `case`, an int code of the geometric cases
    selected at each edge (bit k for corner case k of `_CORNER_CASES`,
    then the index of the last centre case that applied).  All tensors
    (ny, nx), indexed by the cell whose north/east edge this is.
    """
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)
    zero = torch.zeros_like(dx)

    if edge == "north":
        dxl = sh.w(dx, **kw)
        dyl = sh.w(dy, **kw)
        xdl = -0.5 + dxl
        ydl = dyl
        xdr = 0.5 + dx
        ydr = dy
        afl = sh.w(afac)
        afr = afac
    else:  # east edge; rotate trajectory by pi/2
        xdl = -0.5 - dy
        ydl = dx
        xdr = 0.5 - sh.s(dy, **kw)
        ydr = sh.s(dx, **kw)
        afl = afac
        afr = sh.s(afac)
    afc = 0.5 * (afl + afr)

    xcl, ycl = -0.5, 0.0
    xcr, ycr = 0.5, 0.0

    xdm = 0.5 * (xdr + xdl)
    ydm = 0.5 * (ydr + ydl)

    dxseg = torch.where(torch.abs(xdm - xdl) > 0.0, xdm - xdl, cn.puny)
    yil = (xcl * (ydm - ydl) + xdm * ydl - xdl * ydm) / dxseg
    dxseg = torch.where(torch.abs(xdr - xdm) > 0.0, xdr - xdm, cn.puny)
    yir = (xcr * (ydr - ydm) - xdm * ydr + xdr * ydm) / dxseg

    md = (ydr - ydl) / torch.where(torch.abs(xdr - xdl) > 0.0,
                                   xdr - xdl, cn.puny)
    xic = torch.where(torch.abs(md) > cn.puny,
                      xdl - ydl / torch.where(md != 0.0, md, 1.0), 0.0)
    yic = zero
    xil = torch.full_like(dx, xcl)
    xir = torch.full_like(dx, xcr)

    def tri(x1, y1, x2, y2, x3, y3):
        return (x1, y1, x2, y2, x3, y3)

    ZTRI = tri(zero, zero, zero, zero, zero, zero)
    iZ = torch.full_like(dx, BC, dtype=torch.int32)

    verts = [ZTRI] * NGROUPS
    pos = [iZ] * NGROUPS
    fac = [zero] * NGROUPS

    def sel_tri(cond, newtri, newpos, newfac, g):
        verts[g] = tuple(torch.where(cond, nv, ov)
                         for nv, ov in zip(newtri, verts[g]))
        pos[g] = torch.where(cond, newpos, pos[g])
        fac[g] = torch.where(cond, newfac, fac[g])

    CL = torch.full_like(dx, xcl)
    CR = torch.full_like(dx, xcr)
    Z = zero

    # ---- left corner triangles (groups 0 and 2) ---------------------------
    left = xdl < xcl
    c_tl = left & (yil > 0.0) & (ydl >= 0.0)
    c_bl = left & (yil < 0.0) & (ydl < 0.0)
    c_tl1 = left & (yil < 0.0) & (ydl >= 0.0)
    c_tl2 = left & (yil > 0.0) & (ydl < 0.0)

    sel_tri(c_tl, tri(CL, Z, xil, yil, xdl, ydl), TL, -afl, 0)
    sel_tri(c_bl, tri(CL, Z, xdl, ydl, xil, yil), BL, afl, 0)
    sel_tri(c_tl1, tri(CL, Z, xdl, ydl, xic, yic), TL, afl, 0)
    sel_tri(c_tl1, tri(CL, Z, xic, yic, xil, yil), BL, afl, 2)
    sel_tri(c_tl2, tri(CL, Z, xil, yil, xic, yic), TL, -afl, 2)
    sel_tri(c_tl2, tri(CL, Z, xic, yic, xdl, ydl), BL, -afl, 0)

    # ---- right corner triangles (groups 1 and 2) --------------------------
    right = xdr >= xcr
    c_tr = right & (yir > 0.0) & (ydr >= 0.0)
    c_br = right & (yir < 0.0) & (ydr < 0.0)
    c_tr1 = right & (yir < 0.0) & (ydr >= 0.0)
    c_tr2 = right & (yir > 0.0) & (ydr < 0.0)

    sel_tri(c_tr, tri(CR, Z, xdr, ydr, xir, yir), TR, -afr, 1)
    sel_tri(c_br, tri(CR, Z, xir, yir, xdr, ydr), BR, afr, 1)
    sel_tri(c_tr1, tri(CR, Z, xic, yic, xdr, ydr), TR, afr, 1)
    sel_tri(c_tr1, tri(CR, Z, xir, yir, xic, yic), BR, afr, 2)
    sel_tri(c_tr2, tri(CR, Z, xic, yic, xir, yir), TR, -afr, 2)
    sel_tri(c_tr2, tri(CR, Z, xdr, ydr, xic, yic), BR, -afr, 1)

    # ---- redefine DL/DR to the edge intersections if beyond corners -------
    xdl2 = torch.where(left, xil, xdl)
    ydl2 = torch.where(left, yil, ydl)
    xdr2 = torch.where(right, xir, xdr)
    ydr2 = torch.where(right, yir, ydr)
    icl = xic
    icr = xic

    if edgearea is not None:
        xdm, ydm, icl, icr = _fixed_area_midpoint(
            edgearea, verts, fac, afl, afr, afc, xdm, ydm, xic,
            xdl2, ydl2, xdr2, ydr2, xcl, xcr)

    # ---- center triangles (groups 3, 4, 5) --------------------------------
    dlp = ydl2 >= 0.0
    drp = ydr2 >= 0.0
    dmp = ydm >= 0.0
    icp = xic >= 0.0

    DL = (xdl2, ydl2)
    DR = (xdr2, ydr2)
    DM = (xdm, ydm)
    ICL = (icl, yic)
    ICR = (icr, yic)
    CLt = (CL, Z)
    CRt = (CR, Z)

    def T(a, b, c):
        return tri(a[0], a[1], b[0], b[1], c[0], c[1])

    cases = [
        # (condition, [(tri, pos, fac) for groups 3,4,5])
        (dlp & drp & dmp,
         [(T(CLt, CRt, DL), TC, -afc), (T(CRt, DR, DL), TC, -afc),
          (T(DL, DR, DM), TC, -afc)]),
        (dlp & drp & ~dmp,
         [(T(CLt, ICL, DL), TC, -afc), (T(CRt, DR, ICR), TC, -afc),
          (T(ICR, ICL, DM), BC, afc)]),
        (~dlp & ~drp & ~dmp,
         [(T(CLt, DL, CRt), BC, afc), (T(CRt, DL, DR), BC, afc),
          (T(DL, DM, DR), BC, afc)]),
        (~dlp & ~drp & dmp,
         [(T(CLt, DL, ICL), BC, afc), (T(CRt, ICR, DR), BC, afc),
          (T(ICL, ICR, DM), TC, -afc)]),
        (dlp & ~drp & icp & dmp,
         [(T(CLt, ICR, DL), TC, -afc), (T(CRt, ICR, DR), BC, afr),
          (T(DL, ICR, DM), TC, -afc)]),
        (dlp & ~drp & icp & ~dmp,
         [(T(CLt, ICL, DL), TC, -afc), (T(CRt, ICR, DR), BC, afr),
          (T(ICR, ICL, DM), BC, afc)]),
        (dlp & ~drp & ~icp & ~dmp,
         [(T(CLt, ICL, DL), TC, -afl), (T(CRt, ICL, DR), BC, afc),
          (T(DR, ICL, DM), BC, afc)]),
        (dlp & ~drp & ~icp & dmp,
         [(T(CLt, ICL, DL), TC, -afl), (T(CRt, ICR, DR), BC, afc),
          (T(ICL, ICR, DM), TC, -afc)]),
        (~dlp & drp & ~icp & dmp,
         [(T(CLt, DL, ICL), BC, afl), (T(CRt, DR, ICL), TC, -afc),
          (T(ICL, DR, DM), TC, -afc)]),
        (~dlp & drp & ~icp & ~dmp,
         [(T(CLt, DL, ICL), BC, afl), (T(CRt, DR, ICR), TC, -afc),
          (T(ICR, ICL, DM), BC, afc)]),
        (~dlp & drp & icp & ~dmp,
         [(T(CLt, DL, ICR), BC, afc), (T(CRt, DR, ICR), TC, -afr),
          (T(ICR, DL, DM), BC, afc)]),
        (~dlp & drp & icp & dmp,
         [(T(CLt, DL, ICL), BC, afc), (T(CRt, DR, ICR), TC, -afr),
          (T(ICL, ICR, DM), TC, -afc)]),
    ]
    case = torch.zeros_like(iZ)
    for bit, c in enumerate((c_tl, c_bl, c_tl1, c_tl2,
                             c_tr, c_br, c_tr1, c_tr2)):
        case = case | (c.to(torch.int32) << bit)
    center = torch.zeros_like(iZ)
    for idx, (cond, tris) in enumerate(cases):
        for k, (tv, tp, tf) in enumerate(tris):
            sel_tri(cond, tv, tp, tf, 3 + k)
        center = torch.where(cond, idx + 1, center)
    case = case | (center << CENTER_CASE_SHIFT)

    # ---- triangle areas ----------------------------------------------------
    triarea = []
    for g in range(NGROUPS):
        x1, y1, x2, y2, x3, y3 = verts[g]
        a = 0.5 * ((x2 - x1) * (y3 - y1) - (y2 - y1) * (x3 - x1)) * fac[g]
        a = torch.where(torch.abs(a) < cn.eps16 * afc, 0.0, a)
        triarea.append(a)

    # ---- transform vertices to flux-cell coordinates ----------------------
    ish = {p: SHIFTS[edge][p][0] for p in range(6)}
    jsh = {p: SHIFTS[edge][p][1] for p in range(6)}
    local = []
    for g in range(NGROUPS):
        x1, y1, x2, y2, x3, y3 = verts[g]
        isg = sum(torch.where(pos[g] == p, ish[p], 0) for p in range(6))
        jsg = sum(torch.where(pos[g] == p, jsh[p], 0) for p in range(6))
        if edge == "north":
            lx = tuple(x - isg for x in (x1, x2, x3))
            ly = tuple(y + 0.5 - jsg for y in (y1, y2, y3))
        else:
            lx = tuple(y + 0.5 - isg for y in (y1, y2, y3))
            ly = tuple(-x - jsg for x in (x1, x2, x3))
        local.append((lx, ly))

    return dict(verts=local, pos=pos, triarea=triarea, case=case)


def _fixed_area_midpoint(edgearea, verts, fac, afl, afr, afc, xdm, ydm, xic,
                         xdl2, ydl2, xdr2, ydr2, xcl, xcr):
    """``l_fixed_area`` (``:2352-2487``): shift the trajectory midpoint so
    that the total departure-region area equals the prescribed `edgearea`;
    the corner triangles stay put.  Returns (xdm, ydm, icl, icr): the
    shifted midpoint and the x-axis crossings of the two centre segments.
    """
    def area(g):
        x1, y1, x2, y2, x3, y3 = verts[g]
        return 0.5 * ((x2 - x1) * (y3 - y1) - (y2 - y1) * (x3 - x1)) * fac[g]

    area123 = area(0) + area(1) + area(2)

    def safe(x):
        return torch.where(torch.abs(x) > cn.puny, x,
                           torch.where(x >= 0, cn.puny, -cn.puny))

    def intersect(x_a, y_a, x_b, y_b):
        """x-axis crossing of segment a->b (0 where ~horizontal)."""
        m = (y_b - y_a) / safe(x_b - x_a)
        return torch.where(torch.abs(m) > cn.puny, x_a - y_a / m, 0.0)

    # branch 1: both departure points on the same side of the x-axis
    area_c = edgearea - area123
    w1 = (2.0 * area_c / afc + (xdr2 - xcl) * ydl2 + (xcr - xdl2) * ydr2)
    w1 = w1 / safe((xdr2 - xdl2) ** 2 + (ydr2 - ydl2) ** 2)
    xdm_1 = xdm + (ydr2 - ydl2) * w1
    ydm_1 = ydm - (xdr2 - xdl2) * w1
    xicl_1 = intersect(xdl2, ydl2, xdm_1, ydm_1)
    xicr_1 = intersect(xdm_1, ydm_1, xdr2, ydr2)

    # branch 2 (xic < 0): fix ICL at IC, adjust the right part
    area4_2 = 0.5 * (xcl - xic) * ydl2 * afl
    area_c = edgearea - area123 - area4_2
    w1 = (2.0 * area_c / afc + (xcr - xic) * ydr2)
    w1 = w1 / safe((xdr2 - xic) ** 2 + ydr2 ** 2)
    xdm_2 = 0.5 * (xdr2 + xic) + ydr2 * w1
    ydm_2 = 0.5 * ydr2 - (xdr2 - xic) * w1
    xicr_2 = intersect(xdm_2, ydm_2, xdr2, ydr2)

    # branch 3 (xic >= 0): fix ICR at IC, adjust the left part
    area4_3 = 0.5 * (xic - xcr) * ydr2 * afr
    area_c = edgearea - area123 - area4_3
    w1 = (2.0 * area_c / afc + (xic - xcl) * ydl2)
    w1 = w1 / safe((xic - xdl2) ** 2 + ydl2 ** 2)
    xdm_3 = 0.5 * (xic + xdl2) - ydl2 * w1
    ydm_3 = 0.5 * ydl2 - (xic - xdl2) * w1
    xicl_3 = intersect(xdl2, ydl2, xdm_3, ydm_3)

    same = ydl2 * ydr2 >= 0.0
    neg = xic < 0.0
    xdm = torch.where(same, xdm_1, torch.where(neg, xdm_2, xdm_3))
    ydm = torch.where(same, ydm_1, torch.where(neg, ydm_2, ydm_3))
    icl = torch.where(same, xicl_1, torch.where(neg, xic, xicl_3))
    icr = torch.where(same, xicr_1, torch.where(neg, xicr_2, xic))
    return xdm, ydm, icl, icr


def _quad_points(lx, ly, order):
    """Quadrature points + weights from triangle vertices
    (``triangle_coordinates:3155-3297``)."""
    x0 = (lx[0] + lx[1] + lx[2]) / 3.0
    y0 = (ly[0] + ly[1] + ly[2]) / 3.0
    if order == 1:
        return [(x0, y0, 1.0)]
    if order == 2:
        return [(0.5 * lx[k] + 0.5 * x0, 0.5 * ly[k] + 0.5 * y0, 1.0 / 3.0)
                for k in range(3)]
    if order != 3:
        raise ValueError(f"integral_order must be 1, 2 or 3, not {order}")
    # cubic 4-point
    pts = [(x0, y0, -0.5625)]
    for k in range(3):
        pts.append((0.4 * lx[k] + 0.6 * x0, 0.4 * ly[k] + 0.6 * y0,
                    0.52083333333333333))
    return pts


def _tracer_meta(tracer_names, nilyr, nslyr):
    """Static transported-tracer table (``init_transport:81-170``):
    (name, tracer_type, parent_row), ordered type-1 first: hi, hs, Tsfc,
    area tracers | volume/snow tracers, qice layers (depend on hi), qsno
    layers (depend on hs)."""
    meta = [("hi", 1, -1), ("hs", 1, -1), ("Tsfc", 1, -1)]
    for name in tracer_names:
        if TRACER_DEPEND[name] == 0:
            meta.append((name, 1, -1))
    for name in tracer_names:
        dep = TRACER_DEPEND[name]
        if dep != 0:
            meta.append((name, 2, 0 if dep == 1 else 1))
    for k in range(nilyr):
        meta.append((f"qi{k}", 2, 0))
    for k in range(nslyr):
        meta.append((f"qs{k}", 2, 1))
    return meta


def _n_type1(meta):
    """Length of the type-1 prefix (meta is ordered type-1 first)."""
    n1 = sum(1 for (_n, tt, _p) in meta if tt == 1)
    if not (all(tt == 1 for (_n, tt, _p) in meta[:n1])
            and all(tt == 2 for (_n, tt, _p) in meta[n1:])):
        raise ValueError("tracer meta must be ordered type-1 first")
    return n1


def _geom_moments(edge, afac, dx, dy, order, sh, edgearea=None):
    """Category-independent quadrature moments per donor position
    (``transport_integrals:3307-3632``, factored): the pure geometric
    moments ``sum_tri area*w*x^a y^b`` of the 10 monomials up to cubic.

    Returns {pos: [S1, Sx, Sy, Sxx, Sxy, Syy, Sxxx, Sxxy, Sxyy, Syyy]}.
    """
    geom = _edge_geometry(edge, afac, dx, dy, sh, edgearea)
    used = sorted({p for ps in GROUP_POSITIONS for p in ps})
    G = {p: [0.0] * 10 for p in used}
    for g in range(NGROUPS):
        lx, ly = geom["verts"][g]
        pos = geom["pos"][g]
        area = geom["triarea"][g]
        mono = [0.0] * 10
        for (px, py, w) in _quad_points(lx, ly, order):
            pxx, pxy, pyy = px * px, px * py, py * py
            for k, v in enumerate((w, w * px, w * py, w * pxx, w * pxy,
                                   w * pyy, w * pxx * px, w * pxx * py,
                                   w * pxy * py, w * pyy * py)):
                mono[k] = mono[k] + v
        for p in GROUP_POSITIONS[g]:
            ag = torch.where(pos == p, area, 0.0)
            acc = G[p]
            for k in range(10):
                acc[k] = acc[k] + ag * mono[k]
    return G


def _geom_accumulators(afac, dx, dy, order, sh, ea_e=None, ea_n=None):
    """Category-independent divergence accumulators in geometric space:
    GA[off][k] for the 10 monomial moments, such that for any donor
    polynomial field f with monomial coefficients U_k,
    ``divergence(c) = sum_off sum_k GA_k[off](c) * U_k(c + off)``.
    ea_e/ea_n: the prescribed edge areas of ``l_fixed_area`` (or None)."""
    GA = {off: [0.0] * 10 for off in ALL_OFFSETS}
    for edge, ea in (("east", ea_e), ("north", ea_n)):
        G = _geom_moments(edge, afac, dx, dy, order, sh, ea)
        back, bo = (sh.w, (-1, 0)) if edge == "east" else (sh.s, (0, -1))
        for p, g10 in G.items():
            d = SHIFTS[edge][p]
            g2 = (d[0] + bo[0], d[1] + bo[1])
            for k in range(10):
                GA[d][k] = GA[d][k] + g10[k]
                GA[g2][k] = GA[g2][k] - back(g10[k])
    return GA


def _flux_divergence_ga(GSH, mc, mx, my, tc, tx, ty, meta, sh):
    """GA-factored flux divergence of a batch of categories.

    ``div(c) = sum_off S_off( sum_k GSH_k[off] * U_k )(c)`` where GSH
    are the back-shifted, category-independent geometric divergence
    accumulators and U_k the monomial coefficients of the donor-cell
    product polynomial (m*t for type-1 tracers, m*t_parent*t for
    type-2).  mc/mx/my: (..., ny, nx); tc/tx/ty: (..., T, ny, nx);
    GSH[off]: 10 planes (ny, nx).  Returns (div, divt).
    """
    T = len(meta)
    n1 = _n_type1(meta)
    par2 = [meta[k][2] for k in range(n1, T)]
    mc1, mx1, my1 = (a.unsqueeze(-3) for a in (mc, mx, my))
    c1_, x1_, y1_ = tc[..., :n1, :, :], tx[..., :n1, :, :], ty[..., :n1, :, :]
    if par2:
        pc, px_, py_ = (s[..., par2, :, :] for s in (tc, tx, ty))
        c2, x2, y2 = tc[..., n1:, :, :], tx[..., n1:, :, :], ty[..., n1:, :, :]
        mpc, mpx, mpy = mc1 * pc, mc1 * px_, mc1 * py_
        xpc, xpx, xpy = mx1 * pc, mx1 * px_, mx1 * py_
        ypc, ypx, ypy = my1 * pc, my1 * px_, my1 * py_

    div = 0.0
    divt = 0.0
    for off in ALL_OFFSETS:
        g0, g1, g2, g3, g4, g5, g6, g7, g8, g9 = GSH[off]
        p_mass = g0 * mc + g1 * mx + g2 * my
        div = div + _shift_by(sh, p_mass, off)
        if not T:
            continue
        p1 = (g0 * (mc1 * c1_) + g1 * (mc1 * x1_ + mx1 * c1_)
              + g2 * (mc1 * y1_ + my1 * c1_) + g3 * (mx1 * x1_)
              + g4 * (mx1 * y1_ + my1 * x1_) + g5 * (my1 * y1_))
        if par2:
            p2 = (g0 * (mpc * c2)
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
            p = torch.cat([p1, p2], dim=-3)
        else:
            p = p1
        divt = divt + _shift_by(sh, p, off)
    if not T:
        divt = torch.zeros(mc.shape[:-2] + (0,) + mc.shape[-2:],
                           dtype=mc.dtype, device=mc.device)
    return div, divt


def _parents(meta, device):
    """(par, is2): per tracer row the row of its parent (0 for a type-1
    tracer), and a (T, 1, 1) mask of the type-2 rows."""
    par = [max(p, 0) for (_n, _t, p) in meta]
    is2 = torch.tensor([t == 2 for (_n, t, _p) in meta],
                       device=device)[:, None, None]
    return par, is2


def _local_max_min(mm, tm, meta, sh):
    """Quasilocal tracer bounds before transport
    (``ice_transport_driver.F90 local_max_min:1230-1345`` +
    ``quasilocal_max_min:1360-1410``): per tracer, the min/max over the
    3x3 neighbourhood (masked cells contribute the home value: the area
    mask for type-1 tracers, the parent's tracer mask for type-2), then
    extended one more ring.  mm (ncat, ny, nx), tm (ncat, T, ny, nx)."""
    aimask = (mm > cn.puny).to(mm.dtype).unsqueeze(1)
    tmask = (torch.abs(tm) > 0.0).to(mm.dtype) * aimask
    par, is2 = _parents(meta, tm.device)
    phimask = torch.where(is2, tmask[:, par], aimask)

    tmin = tm
    tmax = tm
    for off in ALL_OFFSETS:
        if off == (0, 0):
            continue
        m = _shift_by(sh, phimask, off)
        v = m * _shift_by(sh, tm, off) + (1.0 - m) * tm
        tmin = torch.minimum(tmin, v)
        tmax = torch.maximum(tmax, v)
    lo, hi = tmin, tmax
    for off in ALL_OFFSETS:
        tmin = torch.minimum(tmin, _shift_by(sh, lo, off))
        tmax = torch.maximum(tmax, _shift_by(sh, hi, off))
    return tmin, tmax


def _check_monotonicity(tmin, tmax, mm_new, tm_new, meta):
    """``check_monotonicity:1416-1559``: new tracer values must lie within
    the pre-transport quasilocal bounds; the reference's f64 `puny` is
    lifted to 1e-4 for f32 state, as in the JAX package.  Returns a guard
    record (:func:`cice4_tpu_torch.guards.record`)."""
    par, is2 = _parents(meta, tm_new.device)
    l_check = torch.where(is2, torch.abs(tm_new[:, par]) > cn.puny,
                          (mm_new > cn.puny).unsqueeze(1))
    eps = cn.puny if _is_f64(tm_new.dtype) else 1.0e-4
    w1 = torch.clamp(torch.abs(tmin), min=1.0)
    w2 = torch.clamp(torch.abs(tmax), min=1.0)
    err = torch.maximum(tmin - tm_new, tm_new - tmax)
    bad = l_check & ((tm_new < tmin - w1 * eps) | (tm_new > tmax + w2 * eps))
    return record(bad, torch.where(bad, err, 0.0))


def _check_global_conservation(masum0, masum1, mtsum0, mtsum1):
    """``global_conservation:1147-1218``: the global sums of mass (per
    category and open water) and of mass*tracer (per category and tracer)
    must be unchanged by transport, to a relative `puny` (1e-4 for f32
    state, as in the JAX package).  Returns a guard record whose j and i
    are 0 (the check is global), with ``largest``, the largest relative
    change of any sum compared."""
    eps = cn.puny if _is_f64(masum0.dtype) else 1.0e-4
    rel_m = torch.abs(masum1 - masum0) / torch.clamp(masum0, min=cn.puny)
    bad_m = (masum0 > cn.puny) & (rel_m > eps)
    rel = torch.abs(mtsum1 - mtsum0) / torch.clamp(torch.abs(mtsum0),
                                                   min=cn.puny)
    bad_t = (torch.abs(mtsum0) > cn.puny) & (rel > eps)
    worst = torch.maximum(torch.where(bad_t, rel, 0.0).amax(),
                          torch.where(bad_m, rel_m, 0.0).amax())
    zero = torch.zeros((), dtype=torch.int32, device=masum0.device)
    count = (bad_t.sum() + bad_m.sum()).to(torch.int32)
    # beside the JAX package's record: the largest relative change of any
    # compared sum, whether or not it crosses the threshold
    largest = torch.maximum(
        torch.where(masum0 > cn.puny, rel_m, 0.0).amax(),
        torch.where(torch.abs(mtsum0) > cn.puny, rel, 0.0).amax())
    return dict(count=count, j=zero, i=zero, worst=worst, largest=largest)


def _departure_midpoint(uvel, vvel, dx, dy, dt, grid: Grid, sh):
    """Second-order departure points from the corrected midpoint velocity
    (``departure_points:1673-1751``, ``l_dp_midpt``).

    dx/dy are the scaled first-order displacements (-dt u / dxu); the
    returned ones are scaled the same way.  The quadrant that holds the
    trajectory midpoint picks 4 of the 8 neighbouring U corners for a
    bilinear velocity; the corners are vector fields at NE corners, so on
    a tripole grid their north shifts fold and flip sign.
    """
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)

    def nbrs(f):
        e, w = sh.e(f, **kw), sh.w(f, **kw)
        return dict(c=f, e=e, w=w, n=sh.n(f, **kw), s=sh.s(f, **kw),
                    ne=sh.n(e, **kw), nw=sh.n(w, **kw),
                    se=sh.s(e, **kw), sw=sh.s(w, **kw))

    u, v = nbrs(uvel), nbrs(vvel)
    mpx, mpy = 0.5 * dx, 0.5 * dy
    px, py = mpx >= 0.0, mpy >= 0.0

    def bilin(f, c00, c10, c11, c01, mpxt, mpyt):
        return (f[c00] * (mpxt - 0.5) * (mpyt - 0.5)
                - f[c10] * (mpxt + 0.5) * (mpyt - 0.5)
                + f[c11] * (mpxt + 0.5) * (mpyt + 0.5)
                - f[c01] * (mpxt - 0.5) * (mpyt + 0.5))

    # corners (i2-1,j2-1), (i2,j2-1), (i2,j2), (i2-1,j2) of the quadrant
    quads = [
        (px & py, ("c", "e", "ne", "n"), mpx - 0.5, mpy - 0.5),    # NE
        (~px & ~py, ("sw", "s", "c", "w"), mpx + 0.5, mpy + 0.5),  # SW
        (px & ~py, ("s", "se", "e", "c"), mpx - 0.5, mpy + 0.5),   # SE
        (~px & py, ("w", "c", "n", "nw"), mpx + 0.5, mpy - 0.5),   # NW
    ]
    ump = torch.zeros_like(uvel)
    vmp = torch.zeros_like(vvel)
    for sel, corners, mpxt, mpyt in quads:
        ump = torch.where(sel, bilin(u, *corners, mpxt, mpyt), ump)
        vmp = torch.where(sel, bilin(v, *corners, mpxt, mpyt), vmp)

    moving = (uvel != 0.0) | (vvel != 0.0)
    return (torch.where(moving, -dt * ump / grid.dxu, dx),
            torch.where(moving, -dt * vmp / grid.dyu, dy))


def edge_areas(uvel, vvel, grid: Grid, dt, sh):
    """The signed area fluxes that ``l_fixed_area`` prescribes across
    each east and north edge, from the edge-mean normal velocity
    (``ice_transport_driver.F90:474-509``).  Returns (ea_e, ea_n)."""
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)
    return ((uvel + sh.s(uvel, **kw)) * 0.5 * grid.hte * dt,
            (vvel + sh.w(vvel, **kw)) * 0.5 * grid.htn * dt)


def geometry_gsh(dx, dy, afac, bc, order=2, ea_e=None, ea_n=None):
    """GSH (9, 10, ny, nx): `_geom_accumulators` back-shifted by -offset
    into the layout the K12 kernel takes, in plain PyTorch.  With the
    edge areas of ``l_fixed_area`` (`edge_areas`) the departure regions
    are area-matched: the model's fixed-area geometry on every device, as
    the JAX package computes it under XLA, not in a TPU kernel.  Without
    them it is the plain version of kernel ``remap_gsh``
    (`remap_cuda.ga_gsh_plain`)."""
    sh = Nbr(bc)
    GA = _geom_accumulators(afac, dx, dy, order, sh, ea_e, ea_n)
    zero = torch.zeros_like(afac)
    return torch.stack([
        _shift_by(sh, torch.stack([GA[off][k] + zero for k in range(10)]),
                  (-off[0], -off[1]))
        for off in ALL_OFFSETS])


_INDEX = {}


def _index_on(rows: tuple, device):
    """`rows` as an index tensor on `device`, made once: an index list
    copied to the card at each use would wait for the card each time."""
    key = (rows, str(device))
    if key not in _INDEX:
        _INDEX[key] = torch.tensor(rows, dtype=torch.long, device=device)
    return _INDEX[key]


def _update_category(mm, tm, div, divt, tmask_land, tarear, meta):
    """``update_fields:3642-3868`` for a batch of categories given the
    flux divergences: new mass/tracers + the unclamped mid-transport
    fields.  mm, div: (ncat, ny, nx); tm, divt: (ncat, T, ny, nx)."""
    n1 = _n_type1(meta)
    par2 = _index_on(tuple(meta[k][2] for k in range(n1, len(meta))),
                     mm.device)

    def pick(s):
        return s.index_select(1, par2)

    mmT = mm.unsqueeze(1)
    mtold1 = mmT * tm[:, :n1]
    mtold2 = mmT * tm[:, n1:] * pick(tm)
    mtold = torch.cat([mtold1, mtold2], dim=1)

    div = div * tarear
    mm_mid = mm - div
    mm_new = torch.clamp(mm_mid, min=0.0)
    mm_new = torch.where(tmask_land, mm_new, 0.0)
    pos_m = (mm_new > 0.0).unsqueeze(1)
    safe = torch.clamp(mm_new, min=cn.puny).unsqueeze(1)

    divt = divt * tarear
    mt = mtold - divt
    t1 = torch.where(pos_m, mt / safe, 0.0)
    # type-2: divide by (mm * parent); parents (hi, hs) are nonnegative
    pv = pick(t1)
    t2 = torch.where(pos_m & (pv > 0.0),
                     mt[:, n1:] / torch.clamp(mm_new.unsqueeze(1) * pv,
                                              min=cn.puny), 0.0)
    tm_new = torch.cat([t1[:, :n1], t2], dim=1)
    return mm_new, tm_new, (mm_mid, mt)


def use_split_kernels(device, bc) -> bool:
    """Whether `transport_remap` takes the split route by default: on a
    CUDA device when ``CICE4_FORCE_PALLAS_REMAP`` is set and the grid has
    no tripole fold, as the JAX package takes its K0 -> K1 -> K2 route on
    its accelerator (``cice4_tpu/ops/remap.py:992-1018``)."""
    return (torch.device(device).type == "cuda"
            and bc.ns not in FOLDS
            and bool(os.environ.get("CICE4_FORCE_PALLAS_REMAP")))


def transport_remap(state: State, grid: Grid, dt,
                    integral_order: int = 2, dp_midpt: bool = False,
                    fixed_area: bool = False,
                    conservation_check: bool = False,
                    monotonicity_check: bool = False,
                    split_kernels: bool | None = None):
    """Incremental-remapping advection of the ice state (the GA branch
    of ``cice4_tpu.ops.remap.transport_remap``).

    `split_kernels` selects the route of the divergences: True the split
    route (K0 in GA mode, K1, K2), False the K0/K12 route, None the split
    route only where :func:`use_split_kernels` says so.  `fixed_area`
    never takes the split route (nor does the JAX package): its geometry
    is :func:`geometry_gsh` of the prescribed edge areas, contracted by
    K12.

    Returns (state, aice0): the advected open-water fraction feeds the
    ridging opening/closing rates; with `conservation_check` or
    `monotonicity_check`, a third element, {name: guard record}
    (``ice_transport_driver.F90:596-648``).  The records stay on the
    device.
    """
    from cice4_tpu_torch.ops import remap_cuda

    bc = grid.bc
    sh = Nbr(bc)
    nilyr = state.eicen.shape[1]
    nslyr = state.esnon.shape[1]
    tracer_names = list(state.trcrn.keys())
    meta = _tracer_meta(tracer_names, nilyr, nslyr)

    # scaled departure displacements at U corners (departure_points)
    dx = -dt * state.uvel / grid.dxu
    dy = -dt * state.vvel / grid.dyu
    if dp_midpt:
        dx, dy = _departure_midpoint(state.uvel, state.vvel, dx, dy, dt,
                                     grid, sh)
    afac = grid.dxu * grid.dyu

    # --- state_to_tracers (":847-1003") ------------------------------------
    aice0 = torch.clamp(1.0 - state.aicen.sum(0), min=0.0)
    has = state.aicen > cn.puny
    a_s = torch.clamp(state.aicen, min=cn.puny)
    v_s = torch.clamp(state.vicen, min=cn.puny)
    vs_s = torch.clamp(state.vsnon, min=cn.puny)
    hi = torch.where(has, state.vicen / a_s, 0.0)
    hs = torch.where(has, state.vsnon / a_s, 0.0)

    src = {"hi": hi, "hs": hs, "Tsfc": torch.where(has, state.tsfcn, 0.0)}
    for name in tracer_names:
        src[name] = torch.where(has, state.trcrn[name], 0.0)
    for k in range(nilyr):
        src[f"qi{k}"] = torch.where(has, state.eicen[:, k] / v_s, 0.0)
    for k in range(nslyr):
        qs = state.esnon[:, k] / vs_s + cn.rhos * cn.Lfresh
        src[f"qs{k}"] = torch.where(has & (hs > cn.puny), qs, 0.0)
    tm = torch.stack([src[name] for (name, _t, _p) in meta],
                     dim=1)               # (ncat, T, ny, nx)

    # open water rides as an extra mass-only category (row 0)
    mm_ext = torch.cat([aice0[None], state.aicen], dim=0)
    tm_ext = torch.cat([torch.zeros_like(tm[:1]), tm], dim=0)
    if fixed_area:
        # the area-matched geometry (plain PyTorch), contracted by K12
        ea_e, ea_n = edge_areas(state.uvel, state.vvel, grid, dt, sh)
        gsh = geometry_gsh(dx, dy, afac, bc, integral_order, ea_e, ea_n)
        div_ext, divt_ext = remap_cuda.k12_divergence(gsh, grid.hm, mm_ext,
                                                      tm_ext, meta, bc)
    else:
        if split_kernels is None:
            split_kernels = use_split_kernels(dx.device, bc)
        if split_kernels:
            # K0 in GA mode, K1 (reconstruction of every row), K2
            # (scatter-form contraction; the parents' planes are rows of
            # trc)
            ga = remap_cuda.ga_planes(dx, dy, afac, bc, integral_order)
            mass, trc = remap_cuda.construct(grid.hm, mm_ext, tm_ext, meta,
                                             bc)
            div_ext, divt_ext = remap_cuda.contract(ga, mass, trc, None,
                                                    meta, bc)
        else:
            # K0: category-independent back-shifted geometry
            # accumulators; K12: reconstruction + contraction of every row
            gsh = remap_cuda.ga_gsh(dx, dy, afac, bc, integral_order)
            div_ext, divt_ext = remap_cuda.k12_divergence(
                gsh, grid.hm, mm_ext, tm_ext, meta, bc)
    mm_new, tm_new, (mm_mid, mt_mid) = _update_category(
        state.aicen, tm, div_ext[1:], divt_ext[1:], grid.tmask,
        grid.tarear, meta)

    aice0_mid = aice0 - div_ext[0] * grid.tarear
    aice0_new = torch.where(grid.tmask, torch.clamp(aice0_mid, min=0.0), 0.0)

    guards = {}
    if monotonicity_check:
        tmin, tmax = _local_max_min(state.aicen, tm, meta, sh)
        guards["transport monotonicity"] = _check_monotonicity(
            tmin, tmax, mm_new, tm_new, meta)
    if conservation_check:
        # per-category mass (open water first) and per-(category, tracer)
        # mass*tracer sums; the final sums mid-transport, before the
        # clamps (driver ":563-610")
        ta = grid.tarea
        masum0 = torch.cat([(aice0 * ta).sum()[None],
                            (state.aicen * ta).sum((1, 2))])
        masum1 = torch.cat([(aice0_mid * ta).sum()[None],
                            (mm_mid * ta).sum((1, 2))])
        par, is2 = _parents(meta, tm.device)
        mt0 = state.aicen.unsqueeze(1) * tm * torch.where(is2, tm[:, par],
                                                          1.0)
        guards["transport global conservation"] = \
            _check_global_conservation(masum0, masum1,
                                       (mt0 * ta).sum((2, 3)),
                                       (mt_mid * ta).sum((2, 3)))

    # --- tracers_to_state (":1012-1137") -----------------------------------
    a = mm_new
    pos_m = a > 0.0
    row = {name: i for i, (name, _t, _p) in enumerate(meta)}
    hi_n = torch.clamp(tm_new[:, row["hi"]], min=0.0)
    hs_n = torch.clamp(tm_new[:, row["hs"]], min=0.0)
    tsfcn = torch.where(pos_m, tm_new[:, row["Tsfc"]], cn.Tocnfrz)
    trcrn = {name: tm_new[:, row[name]] for name in tracer_names}
    eicen = torch.stack(
        [torch.clamp(tm_new[:, row[f"qi{k}"]], max=0.0) * a * hi_n
         for k in range(nilyr)], dim=1)
    esnon = torch.stack(
        [torch.clamp(tm_new[:, row[f"qs{k}"]] - cn.rhos * cn.Lfresh, max=0.0)
         * a * hs_n for k in range(nslyr)], dim=1)

    state = state.replace(aicen=a, vicen=a * hi_n, vsnon=a * hs_n,
                          tsfcn=tsfcn, eicen=eicen, esnon=esnon,
                          trcrn=trcrn)
    if conservation_check or monotonicity_check:
        return state, aice0_new, guards
    return state, aice0_new


# ---------------------------------------------------------------------------
# decomposed grids (port of cice4_tpu/ops/remap.py:1243-1383)
# ---------------------------------------------------------------------------

REMAP_HALO = 6
# the rows of the full-width strip a top block remaps under the U-fold:
# the REMAP_HALO rows it keeps and as many below them, so that nothing
# of the strip's southern edge reaches a kept row
FOLD_STRIP = 2 * REMAP_HALO
_REMAPPED = ("aicen", "vicen", "vsnon", "eicen", "esnon", "tsfcn")


def remap_sharded_eligible(grid, mesh, transport_cfg=None) -> bool:
    """Whether the k-halo remap takes a grid (global `ny`, `nx`, `bc`) on
    `mesh`: more than one block, blocks that divide the grid and hold the
    6-ring halo, no global check (with the ``CICE4_NO_SHARDED_REMAP``
    switch of the JAX package); under the U-fold (``tripole``) an east-west
    cyclic grid whose blocks hold the fold's strip of `FOLD_STRIP` rows.
    The T-fold (``tripoleT``) is refused."""
    if os.environ.get("CICE4_NO_SHARDED_REMAP"):
        return False
    if mesh is None:
        return False
    py, px = mesh.shape
    if py * px <= 1:
        return False
    if grid.bc.ns == "tripoleT":
        return False
    if grid.bc.ns == "tripole" and (grid.bc.ew != "cyclic"
                                    or grid.ny // py < FOLD_STRIP):
        return False
    if transport_cfg is not None and (transport_cfg.conservation_check
                                      or transport_cfg.monotonicity_check):
        return False
    H = REMAP_HALO
    return (grid.ny % py == 0 and grid.nx % px == 0
            and grid.ny // py >= H and grid.nx // px >= H)


def transport_remap_decomposed(state: State, grid: Grid, dt, tr):
    """`transport_remap` of a block grid under the transport config `tr`:
    the k-halo remap where :func:`remap_sharded_eligible` takes the grid,
    else the gathered path.  Returns what `transport_remap` returns, on
    the block."""
    from cice4_tpu_torch.parallel.mesh import get_active_mesh

    bcb = grid.bc
    view = SimpleNamespace(ny=bcb.ny, nx=bcb.nx, bc=bcb.bc)
    if remap_sharded_eligible(view, get_active_mesh(), tr):
        return transport_remap_sharded(state, grid, dt, tr.integral_order,
                                       tr.l_dp_midpt, tr.l_fixed_area)
    return transport_remap_gathered(
        state, grid, dt, tr.integral_order, tr.l_dp_midpt, tr.l_fixed_area,
        conservation_check=tr.conservation_check,
        monotonicity_check=tr.monotonicity_check)


def transport_remap_gathered(state: State, grid: Grid, dt, *args, **kw):
    """The gathered remap of a block grid: the block gathers the remap's
    inputs, runs the one-device `transport_remap` (kernels and fold
    included) on the global grid and keeps its core.  Exact by
    construction; the guard records are the global ones."""
    from cice4_tpu_torch.parallel import halo as h

    bcb = grid.bc
    full = {n: h.gather_field(getattr(state, n), bcb.mesh)
            for n in _REMAPPED + ("uvel", "vvel")}
    trc = {k: h.gather_field(v, bcb.mesh) for k, v in state.trcrn.items()}
    with h.gathered_phase("remap"):
        out = transport_remap(state.replace(trcrn=trc, **full),
                              bcb.global_grid, dt, *args, **kw)
    new = out[0]
    state = state.replace(
        trcrn={k: bcb.core(v) for k, v in new.trcrn.items()},
        **{n: bcb.core(getattr(new, n)) for n in _REMAPPED})
    return (state, bcb.core(out[1])) + tuple(out[2:])


def transport_remap_sharded(state: State, grid: Grid, dt,
                            integral_order: int = 2, dp_midpt: bool = False,
                            fixed_area: bool = False):
    """The k-halo remap of a block grid (port of
    ``cice4_tpu/ops/remap.py:1268-1383``): one batched exchange of every
    remap input (about 70 planes as one stack), then the whole
    `transport_remap` on the 6-ring padded block with a local doubly
    cyclic boundary, and the core kept.  Bit-equal to the one-device
    remap: every ghost value is the global neighbour's, so every core
    cell sees the same arithmetic.  At a global edge that does not wrap
    the block takes no ring and keeps the edge's boundary, zeros beyond
    it, on that axis.  The ring budget is 4 (geometry 2,
    GSH 1, the divergence's shift 1) plus 1 each for the midpoint
    correction and the fixed-area edge velocities.

    Under the U-fold the one-device remap folds every north shift of
    every intermediate plane with the scalar row map (the JAX package's
    XLA path, which the fold kernels follow), which a ghost ring of
    folded inputs does not reproduce: a gradient computed in a folded
    ghost cell is the mirror cell's with its directions swapped.  So the
    top row of blocks also swaps the top `FOLD_STRIP` rows of its inputs
    with one another (the fold pairs column i with nx-1-i: on 2x2 blocks
    the north-west block's partner is the north-east one), remaps that
    full-width strip under the global boundary, fold included, and takes
    its top `REMAP_HALO` rows: the rows within the ring budget of the
    fold.  Below them the padded block's rows are the one-device ones."""
    from cice4_tpu_torch.parallel import halo as h

    H = REMAP_HALO
    bcb = grid.bc
    dtype = state.aicen.dtype
    tracer_names = list(state.trcrn.keys())
    fields = dict(
        aicen=state.aicen, vicen=state.vicen, vsnon=state.vsnon,
        eicen=state.eicen, esnon=state.esnon, tsfcn=state.tsfcn,
        uvel=state.uvel[None], vvel=state.vvel[None],
        dxu=grid.dxu[None], dyu=grid.dyu[None], hm=grid.hm[None],
        tmask=grid.tmask.to(dtype)[None], tarear=grid.tarear[None],
        tarea=grid.tarea[None], hte=grid.hte[None], htn=grid.htn[None],
        **{f"trc_{n}": state.trcrn[n] for n in tracer_names})
    flat = [v.reshape((-1,) + v.shape[-2:]).to(dtype)
            for v in fields.values()]
    sizes = [f.shape[0] for f in flat]
    stack = torch.cat(flat, dim=0)
    a = h.exchange_padded(torch.nn.functional.pad(stack, (H, H, H, H)), H,
                          bcb)
    strip = _fold_strip(stack, bcb) if bcb.ns == "tripole" else None
    # at an edge of the global grid that does not wrap, the ring beyond
    # it is cut off and the edge's own boundary (zeros beyond it) stands,
    # as on one device: a ghost ring of zero inputs would make 0/0 of the
    # departure displacements there
    py, px = bcb.mesh.shape
    ew_edge = bcb.ew != "cyclic"
    ns_edge = bcb.ns != "cyclic"
    cut = (H if ew_edge and bcb.xi == 0 else 0,
           H if ew_edge and bcb.xi == px - 1 else 0,
           H if ns_edge and bcb.yi == 0 else 0,
           H if ns_edge and bcb.yi == py - 1 else 0)
    a = a[..., cut[2]:a.shape[-2] - cut[3], cut[0]:a.shape[-1] - cut[1]]
    local_bc = h.BoundaryConditions(
        ew="closed" if cut[0] or cut[1] else "cyclic",
        ns="open" if cut[2] or cut[3] else "cyclic")

    def remap_planes(planes, bc):
        """`transport_remap` of the stacked input `planes` under `bc`:
        the new state's remapped fields and aice0."""
        parts = dict(zip(fields, torch.split(planes, sizes, dim=0)))

        def take(name):
            v = parts[name]
            lead = fields[name].shape[:-2]
            return v[0] if lead == (1,) else v.reshape(lead + v.shape[-2:])

        hm = take("hm")
        zero = torch.zeros_like(hm)
        z4 = torch.zeros((4,) + hm.shape, dtype=dtype, device=hm.device)
        local = SimpleNamespace(
            bc=bc, dxu=take("dxu"), dyu=take("dyu"), hm=hm,
            tmask=take("tmask") > 0.5, tarear=take("tarear"),
            tarea=take("tarea"), hte=take("hte"), htn=take("htn"),
            ny=hm.shape[-2], nx=hm.shape[-1])
        # the fields the remap does not read are stand-ins
        st = State(
            aicen=take("aicen"), vicen=take("vicen"), vsnon=take("vsnon"),
            eicen=take("eicen"), esnon=take("esnon"), tsfcn=take("tsfcn"),
            trcrn={n: take(f"trc_{n}") for n in tracer_names},
            uvel=take("uvel"), vvel=take("vvel"),
            stressp=z4, stressm=z4, stress12=z4, iceumask=hm > 2.0,
            sst=zero, frzmlt=zero, scale_factor=zero, strocnxT=zero,
            strocnyT=zero)
        out, aice0 = transport_remap(st, local, dt, integral_order,
                                     dp_midpt, fixed_area)
        return dict(aice0=aice0, **{f"trc_{n}": out.trcrn[n]
                                    for n in tracer_names},
                    **{n: getattr(out, n) for n in _REMAPPED})

    new = {k: v[..., H - cut[2]:v.shape[-2] - H + cut[3],
                H - cut[0]:v.shape[-1] - H + cut[1]]
           for k, v in remap_planes(a, local_bc).items()}
    if strip is not None:
        # the strip's top H rows, in this block's columns, over the
        # padded block's
        top = remap_planes(strip, bcb.bc)
        cols = slice(bcb.x0, bcb.x0 + bcb.bx)
        new = {k: torch.cat([v[..., :-H, :], top[k][..., -H:, cols]],
                            dim=-2) for k, v in new.items()}
    state = state.replace(
        trcrn={n: new[f"trc_{n}"] for n in tracer_names},
        **{n: new[n] for n in _REMAPPED})
    return state, new["aice0"]


def _fold_strip(stack, bcb):
    """The global top `FOLD_STRIP` rows of the stacked planes `stack`
    (P, by, bx), the grid's full width, on each block of the top mesh
    row, from the top rows of every block of that row; None elsewhere.
    Every block of the mesh calls it together."""
    mesh = bcb.mesh
    py, px = mesh.shape
    top = bcb.yi == py - 1
    row = [mesh.block_at(py - 1, k) for k in range(px)] if top else []
    slab = stack[..., -FOLD_STRIP:, :]
    got = mesh.transfer([(b, "strip", slab) for b in row],
                        [(b, "strip", slab.shape) for b in row], stack)
    return torch.cat(got, dim=-1) if top else None
