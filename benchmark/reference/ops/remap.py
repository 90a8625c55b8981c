"""Incremental remapping transport (Dukowicz & Baumgardner 2000;
Lipscomb & Hunke 2004).

Port of the GA branch of :mod:`cice4_tpu.ops.remap` (``source/
ice_transport_remap.F90`` and the reference's ``transport_remap:
179-663``): second-order, monotone (van-Leer-limited linear
reconstruction), conservative.

Every edge of the grid carries a dense set of up to 6 departure
triangles (`_edge_geometry`).  Their monomial moments, scattered to the
9 donor offsets and back-shifted, form the category-independent GSH
tensor (`geometry_gsh`).  Each category's van-Leer reconstruction is
then contracted against GSH into the flux divergences
(`remap_plain.k12_plain`).  On a tripole grid every north shift folds.

As in the reference, all local geometry is computed on the *scaled*
grid (cell = unit square); physical areas enter only through the corner
area factors dxu*dyu and the final 1/tarea.

The options of the JAX package's transport: the departure-point
midpoint correction (``l_dp_midpt``, `_departure_midpoint`, on either
route); the fixed-area mode (``l_fixed_area``), whose geometry is
area-matched; and the global conservation and
monotonicity checks, whose guard records stay on the device.  The JAX
package's legacy non-GA contraction is not ported: it computes the same
divergences as the GA branch.
"""

from __future__ import annotations

import torch

from reference import constants as cn
from reference.constants import FieldLoc, FieldType
from reference.grid import Grid
from reference.guards import _is_f64, record
from reference.ops.itd import TRACER_DEPEND
from reference.halo import Nbr
from reference.state import State

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
    record (:func:`reference.guards.record`)."""
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
    """GSH (9, 10, ny, nx): `_geom_accumulators` back-shifted by -offset.
    With the edge areas of ``l_fixed_area`` (`edge_areas`) the departure
    regions are area-matched."""
    sh = Nbr(bc)
    GA = _geom_accumulators(afac, dx, dy, order, sh, ea_e, ea_n)
    zero = torch.zeros_like(afac)
    return torch.stack([
        _shift_by(sh, torch.stack([GA[off][k] + zero for k in range(10)]),
                  (-off[0], -off[1]))
        for off in ALL_OFFSETS])


def _update_category(mm, tm, div, divt, tmask_land, tarear, meta):
    """``update_fields:3642-3868`` for a batch of categories given the
    flux divergences: new mass/tracers + the unclamped mid-transport
    fields.  mm, div: (ncat, ny, nx); tm, divt: (ncat, T, ny, nx)."""
    n1 = _n_type1(meta)
    par2 = [meta[k][2] for k in range(n1, len(meta))]

    def pick(s):
        return s[:, par2]

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


def transport_remap(state: State, grid: Grid, dt,
                    integral_order: int = 2, dp_midpt: bool = False,
                    fixed_area: bool = False,
                    conservation_check: bool = False,
                    monotonicity_check: bool = False):
    """Incremental-remapping advection of the ice state (the GA branch
    of ``cice4_tpu.ops.remap.transport_remap``).

    Returns (state, aice0): the advected open-water fraction feeds the
    ridging opening/closing rates; with `conservation_check` or
    `monotonicity_check`, a third element, {name: guard record}
    (``ice_transport_driver.F90:596-648``).  The records stay on the
    device.
    """
    from reference.ops.remap_plain import k12_plain

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
    ea_e = ea_n = None
    if fixed_area:
        # the area-matched geometry
        ea_e, ea_n = edge_areas(state.uvel, state.vvel, grid, dt, sh)
    gsh = geometry_gsh(dx, dy, afac, bc, integral_order, ea_e, ea_n)
    div_ext, divt_ext = k12_plain(gsh, grid.hm, mm_ext, tm_ext, meta, bc)
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
