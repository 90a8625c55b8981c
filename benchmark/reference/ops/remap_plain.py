"""The remap's flux divergences in plain PyTorch (frozen copy of the
plain version beside the port's K12 kernel): the reconstruction of every
category row contracted against the GSH geometry (:func:`k12_plain`)."""

from __future__ import annotations

import torch

from reference import constants as cn
from reference.halo import Nbr
from reference.ops.remap import (ALL_OFFSETS, _flux_divergence_ga, _n_type1,
                                 _shift_by)

AXES = ((1, 0), (-1, 0), (0, 1), (0, -1))
DIAGS = ((1, 1), (-1, 1), (1, -1), (-1, -1))


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


def k12_plain(gsh, hm, mm_ext, tm_ext, meta, bc):
    """(div (C, ny, nx), divt (C, T, ny, nx)) of the C = ncat+1 category
    rows: `_construct_vmem` plus `remap._flux_divergence_ga`."""
    sh = Nbr(bc)
    GSH = {off: [gsh[o, k] for k in range(10)]
           for o, off in enumerate(ALL_OFFSETS)}
    mc, mx, my, tc, tx, ty = _construct_vmem(mm_ext, hm, tm_ext, list(meta),
                                             sh)
    return _flux_divergence_ga(GSH, mc, mx, my, tc, tx, ty, meta, sh)
