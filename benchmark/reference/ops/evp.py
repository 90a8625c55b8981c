"""Elastic-viscous-plastic (EVP) sea-ice dynamics.

Port of :mod:`cice4_tpu.ops.evp` (``source/ice_dyn_evp.F90``, Hunke &
Dukowicz 1997): `ndte` subcycles of `stress` (corner strain rates and
stress relaxation, ``:947-1293``) and `stepu` (the closed-form 2x2
implicit momentum solve, ``:1302-1443``) on dense global tensors.

The subcycle loop is :func:`_evp_subcycle_plain`, a Python loop over
the functions below.

Grid staggering (B-grid): T cell (j, i) has U corners
NE = U(j, i), NW = U(j, i-1), SW = U(j-1, i-1), SE = U(j-1, i).
Corner order in the stress tensors: index 0 = ne, 1 = nw, 2 = sw, 3 = se.

On a tripole grid the str8 pieces cross the fold through the shift
provider's `n_str`/`ne_str` (the mirror cell's paired piece, negated),
and on the U-fold grid (``tripole``) `evp` first makes the inputs on the
top row of U points, which lie on the fold, symmetric.
"""

from __future__ import annotations

import dataclasses

import torch

from reference import constants as cn
from reference.config import DynamicsConfig
from reference.constants import FieldLoc, FieldType
from reference.grid import Grid, to_tgrid, to_ugrid
from reference.ops.mechred_strength import ice_strength
from reference import halo as h
from reference.state import State

# ice-presence thresholds (ice_dyn_evp.F90:87-88)
a_min = 0.001   # minimum ice area fraction
m_min = 0.01    # minimum ice mass (kg/m^2)

# bilinear quadrature weights (ice_constants.F90:166-172)
p055 = 1.0 / 18.0
p111 = 1.0 / 9.0
p166 = 1.0 / 6.0
p222 = 2.0 / 9.0
p25 = 0.25
p333 = 1.0 / 3.0
p5 = 0.5


@dataclasses.dataclass(frozen=True)
class EvpParams:
    """Derived EVP constants (``ice_dyn_evp.F90 set_evp_parameters:535-577``)."""

    ndte: int
    dtei: float      # 1/dte
    dte2T: float     # dte / (2 eyc dt)
    denom1: float
    denom2: float
    rcon: float      # damping bound (kg/s)
    ecci: float      # 1/e^2
    cosw: float
    sinw: float
    dragw: float     # dragio * rhow
    evp_damping: bool
    hemi_turning: bool  # flip turning-angle sign in S hemisphere (AusCOM)


def make_evp_params(dyn: DynamicsConfig, dt: float) -> EvpParams:
    dte = dt / dyn.ndte
    dtei = 1.0 / dte
    tdamp2 = 2.0 * dyn.eyc * dt
    dte2T = dte / tdamp2
    return EvpParams(
        ndte=dyn.ndte, dtei=dtei, dte2T=dte2T,
        denom1=1.0 / (1.0 + dte2T),
        denom2=1.0 / (1.0 + dte2T * dyn.ecc),
        rcon=1230.0 * dyn.eyc * dt * dtei**2,
        ecci=1.0 / dyn.ecc,
        cosw=dyn.cosw, sinw=dyn.sinw,
        dragw=dyn.dragio * cn.rhow,
        evp_damping=dyn.evp_damping,
        hemi_turning=(dyn.sinw != 0.0),
    )


def _corner_velocities(nbr, uvel, vvel):
    """Velocities at the 4 U corners of every T cell."""
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)
    u_w = nbr.w(uvel, **kw)
    u_s = nbr.s(uvel, **kw)
    u_sw = nbr.s(u_w, **kw)
    v_w = nbr.w(vvel, **kw)
    v_s = nbr.s(vvel, **kw)
    v_sw = nbr.s(v_w, **kw)
    return (uvel, u_w, u_s, u_sw, vvel, v_w, v_s, v_sw)


def _strain_rates(geom, nbr, uvel, vvel):
    """Corner strain rates * area (m^2/s) (``ice_dyn_evp.F90:1065-1092``).

    Returns (div, ten, shr) each of shape (4, ny, nx), corners (ne, nw,
    sw, se)."""
    u, u_w, u_s, u_sw, v, v_w, v_s, v_sw = _corner_velocities(nbr, uvel, vvel)
    cyp, cxp, cym, cxm = geom.cyp, geom.cxp, geom.cym, geom.cxm
    dxt, dyt = geom.dxt, geom.dyt

    divne = cyp * u - dyt * u_w + cxp * v - dxt * v_s
    divnw = cym * u_w + dyt * u + cxp * v_w - dxt * v_sw
    divsw = cym * u_sw + dyt * u_s + cxm * v_sw + dxt * v_w
    divse = cyp * u_s - dyt * u_sw + cxm * v_s + dxt * v

    tenne = -cym * u - dyt * u_w + cxm * v + dxt * v_s
    tennw = -cyp * u_w + dyt * u + cxm * v_w + dxt * v_sw
    tensw = -cyp * u_sw + dyt * u_s + cxp * v_sw - dxt * v_w
    tense = -cym * u_s - dyt * u_sw + cxp * v_s - dxt * v

    shrne = -cym * v - dyt * v_w - cxm * u - dxt * u_s
    shrnw = -cyp * v_w + dyt * v - cxm * u_w - dxt * u_sw
    shrsw = -cyp * v_sw + dyt * v_s - cxp * u_sw + dxt * u_w
    shrse = -cym * v_s - dyt * v_sw - cxp * u_s + dxt * u

    div = torch.stack([divne, divnw, divsw, divse])
    ten = torch.stack([tenne, tennw, tensw, tense])
    shr = torch.stack([shrne, shrnw, shrsw, shrse])
    return div, ten, shr


def _stress_relax(p: EvpParams, geom, nbr, strength, tmask_ice,
                  uvel, vvel, stressp, stressm, stress12):
    """Strain rates + stress relaxation (``ice_dyn_evp.F90:1065-1190``).
    Returns (stressp, stressm, stress12, diag)."""
    div, ten, shr = _strain_rates(geom, nbr, uvel, vvel)
    delta = torch.sqrt(div**2 + p.ecci * (ten**2 + shr**2))

    if p.evp_damping:
        floor = 4.0 * geom.tinyarea
        c0 = torch.clamp(strength / torch.maximum(delta, floor), max=p.rcon)
        prs_sig = strength * delta[0] / torch.maximum(delta[0], floor)
    else:
        c0 = strength / torch.maximum(delta, geom.tinyarea)
        prs_sig = c0[0] * delta[0]
    c1 = c0 * p.dte2T

    stressp = torch.where(tmask_ice,
                          (stressp + c1 * (div - delta)) * p.denom1, 0.0)
    stressm = torch.where(tmask_ice, (stressm + c1 * ten) * p.denom2, 0.0)
    stress12 = torch.where(tmask_ice,
                           (stress12 + c1 * shr * p5) * p.denom2, 0.0)
    diag = dict(div=div, delta=delta, ten=ten, shr=shr, prs_sig=prs_sig)
    return stressp, stressm, stress12, diag


def _str8_from_stress(geom, tmask_ice, stressp, stressm, stress12):
    """Pointwise assembly of the 8 momentum flux combinations from the
    (already updated) corner stresses (``ice_dyn_evp.F90:1196-1289``)."""
    sp1, sp2, sp3, sp4 = stressp
    sm1, sm2, sm3, sm4 = stressm
    s121, s122, s123, s124 = stress12
    dxt, dyt, dxhy, dyhx = geom.dxt, geom.dyt, geom.dxhy, geom.dyhx

    ssigpn = sp1 + sp2
    ssigps = sp3 + sp4
    ssigpe = sp1 + sp4
    ssigpw = sp2 + sp3
    ssigp1 = (sp1 + sp3) * p055
    ssigp2 = (sp2 + sp4) * p055

    ssigmn = sm1 + sm2
    ssigms = sm3 + sm4
    ssigme = sm1 + sm4
    ssigmw = sm2 + sm3
    ssigm1 = (sm1 + sm3) * p055
    ssigm2 = (sm2 + sm4) * p055

    ssig12n = s121 + s122
    ssig12s = s123 + s124
    ssig12e = s121 + s124
    ssig12w = s122 + s123
    ssig121 = (s121 + s123) * p111
    ssig122 = (s122 + s124) * p111

    csigpne = p111 * sp1 + ssigp2 + (p055 * p5) * sp3
    csigpnw = p111 * sp2 + ssigp1 + (p055 * p5) * sp4
    csigpsw = p111 * sp3 + ssigp2 + (p055 * p5) * sp1
    csigpse = p111 * sp4 + ssigp1 + (p055 * p5) * sp2

    csigmne = p111 * sm1 + ssigm2 + (p055 * p5) * sm3
    csigmnw = p111 * sm2 + ssigm1 + (p055 * p5) * sm4
    csigmsw = p111 * sm3 + ssigm2 + (p055 * p5) * sm1
    csigmse = p111 * sm4 + ssigm1 + (p055 * p5) * sm2

    csig12ne = p222 * s121 + ssig122 + p055 * s123
    csig12nw = p222 * s122 + ssig121 + p055 * s124
    csig12sw = p222 * s123 + ssig122 + p055 * s121
    csig12se = p222 * s124 + ssig121 + p055 * s122

    str12ew = p5 * dxt * (p333 * ssig12e + p166 * ssig12w)
    str12we = p5 * dxt * (p333 * ssig12w + p166 * ssig12e)
    str12ns = p5 * dyt * (p333 * ssig12n + p166 * ssig12s)
    str12sn = p5 * dyt * (p333 * ssig12s + p166 * ssig12n)

    # u momentum flux pieces
    strp = p25 * dyt * (p333 * ssigpn + p166 * ssigps)
    strm = p25 * dyt * (p333 * ssigmn + p166 * ssigms)
    str0 = -strp - strm - str12ew + dxhy * (-csigpne + csigmne) + dyhx * csig12ne
    str1 = strp + strm - str12we + dxhy * (-csigpnw + csigmnw) + dyhx * csig12nw
    strp = p25 * dyt * (p333 * ssigps + p166 * ssigpn)
    strm = p25 * dyt * (p333 * ssigms + p166 * ssigmn)
    str2 = -strp - strm + str12ew + dxhy * (-csigpse + csigmse) + dyhx * csig12se
    str3 = strp + strm + str12we + dxhy * (-csigpsw + csigmsw) + dyhx * csig12sw

    # v momentum flux pieces
    strp = p25 * dxt * (p333 * ssigpe + p166 * ssigpw)
    strm = p25 * dxt * (p333 * ssigme + p166 * ssigmw)
    str4 = -strp + strm - str12ns - dyhx * (csigpne + csigmne) + dxhy * csig12ne
    str5 = strp - strm - str12sn - dyhx * (csigpse + csigmse) + dxhy * csig12se
    strp = p25 * dxt * (p333 * ssigpw + p166 * ssigpe)
    strm = p25 * dxt * (p333 * ssigmw + p166 * ssigme)
    str6 = -strp + strm + str12ns - dyhx * (csigpnw + csigmnw) + dxhy * csig12nw
    str7 = strp - strm + str12sn - dyhx * (csigpsw + csigmsw) + dxhy * csig12sw

    str8 = torch.stack([str0, str1, str2, str3, str4, str5, str6, str7])
    return torch.where(tmask_ice[None], str8, 0.0)


def _stress_update(p: EvpParams, geom, nbr, strength, tmask_ice,
                   uvel, vvel, stressp, stressm, stress12):
    """One `stress` call (``ice_dyn_evp.F90:947-1293``): the 12 corner
    stresses and the 8 momentum flux combinations.

    Returns (stressp, stressm, stress12, str8, diag)."""
    stressp, stressm, stress12, diag = _stress_relax(
        p, geom, nbr, strength, tmask_ice, uvel, vvel,
        stressp, stressm, stress12)
    str8 = _str8_from_stress(geom, tmask_ice, stressp, stressm, stress12)
    return stressp, stressm, stress12, str8, diag


def _stepu(p: EvpParams, geom, nbr, iceumask, aiu, str8,
           uocn, vocn, waterx, watery, forcex, forcey,
           umassdtei, fm, uvel, vvel):
    """Momentum solve (``ice_dyn_evp.F90 stepu:1302-1443``)."""
    vrel = aiu * p.dragw * torch.sqrt((uocn - uvel) ** 2 + (vocn - vvel) ** 2)
    taux = vrel * waterx
    tauy = vrel * watery

    cca = umassdtei + vrel * p.cosw
    if p.hemi_turning:
        sgn = torch.where(fm < 0.0, -1.0, 1.0).to(fm.dtype)
    else:
        sgn = 1.0
    ccb = fm + sgn * vrel * p.sinw
    ab2 = cca**2 + ccb**2

    n2, ne3 = nbr.n_str(str8, 2), nbr.ne_str(str8, 3)
    n5, ne7 = nbr.n_str(str8, 5), nbr.ne_str(str8, 7)
    strintx = geom.uarear * (str8[0] + nbr.e(str8[1]) + n2 + ne3)
    strinty = geom.uarear * (str8[4] + n5 + nbr.e(str8[6]) + ne7)

    cc1 = strintx + forcex + taux + umassdtei * uvel
    cc2 = strinty + forcey + tauy + umassdtei * vvel

    unew = (cca * cc1 + ccb * cc2) / torch.clamp(ab2, min=cn.puny)
    vnew = (cca * cc2 - ccb * cc1) / torch.clamp(ab2, min=cn.puny)
    unew = torch.where(iceumask, unew, 0.0)
    vnew = torch.where(iceumask, vnew, 0.0)
    strintx = torch.where(iceumask, strintx, 0.0)
    strinty = torch.where(iceumask, strinty, 0.0)
    strocnx = torch.where(iceumask, taux, 0.0)
    strocny = torch.where(iceumask, tauy, 0.0)
    return unew, vnew, strintx, strinty, strocnx, strocny


def _evp_rounds_plain(p: EvpParams, grid: Grid, strength, icetmask,
                      iceumask, aiu, uocn, vocn, waterx, watery,
                      forcex, forcey, umassdtei, fm,
                      uvel, vvel, stressp, stressm, stress12):
    """p.ndte subcycles of stress+stepu, without the final subcycle's
    diagnostics: the plain version of a round of the ``evp_subcycle``
    kernel.  Returns (uvel, vvel, stressp, stressm, stress12)."""
    nbr = h.Nbr(grid.bc)
    args = (uocn, vocn, waterx, watery, forcex, forcey, umassdtei, fm)
    for _ in range(p.ndte):
        stressp, stressm, stress12, str8, _d = _stress_update(
            p, grid, nbr, strength, icetmask, uvel, vvel,
            stressp, stressm, stress12)
        uvel, vvel, *_rest = _stepu(p, grid, nbr, iceumask, aiu, str8,
                                    *args, uvel, vvel)
    return uvel, vvel, stressp, stressm, stress12


def _evp_subcycle_plain(p: EvpParams, grid: Grid, strength, icetmask,
                        iceumask, aiu, uocn, vocn, waterx, watery,
                        forcex, forcey, umassdtei, fm,
                        uvel, vvel, stressp, stressm, stress12):
    """ndte subcycles of stress+stepu as a Python loop over global
    tensors (``ice_dyn_evp.F90:347-408``): the plain version of the
    ``evp_subcycle`` kernel (port of `evp._evp_subcycle_jnp`).  Returns
    (uvel, vvel, stressp, stressm, stress12, diag, strintx, strinty,
    strocnx, strocny) with the last subcycle's strain sums in diag."""
    nbr = h.Nbr(grid.bc)
    args = (uocn, vocn, waterx, watery, forcex, forcey, umassdtei, fm)
    uvel, vvel, stressp, stressm, stress12 = _evp_rounds_plain(
        dataclasses.replace(p, ndte=p.ndte - 1), grid, strength, icetmask,
        iceumask, aiu, *args, uvel, vvel, stressp, stressm, stress12)

    # final subcycle, with ridging diagnostics (":1103-1115")
    stressp, stressm, stress12, str8, d = _stress_update(
        p, grid, nbr, strength, icetmask, uvel, vvel,
        stressp, stressm, stress12)
    uvel, vvel, strintx, strinty, strocnx, strocny = _stepu(
        p, grid, nbr, iceumask, aiu, str8, *args, uvel, vvel)
    diag = dict(div_sum=d["div"].sum(0), delta_sum=d["delta"].sum(0),
                ten_sum=d["ten"].sum(0), shr_sum=d["shr"].sum(0),
                prs_sig=d["prs_sig"])
    return (uvel, vvel, stressp, stressm, stress12, diag,
            strintx, strinty, strocnx, strocny)


def evp(state: State, grid: Grid, dyn: DynamicsConfig, dt: float,
        aice, vice, vsno, aicen, vicen, aice0,
        uocn, vocn, ss_tltx, ss_tlty, strairxT, strairyT,
        tilt_from_currents: bool = True):
    """EVP dynamics (``ice_dyn_evp.F90 evp:119-432``).

    Args:
      aice..aice0: aggregates (up to date with category state).
      uocn/vocn: ocean surface current at U points (m/s).
      ss_tltx/y: sea surface slope at U points (used when
        `tilt_from_currents` is False: the coupled configuration).
      strairxT/yT: wind stress on the T grid (incl. aice factor).

    Returns (state, diag) with updated velocity/stress/iceumask/ocean
    stress in a new state (the caller's state tensors are not written)
    and ridging inputs + history fields in diag.
    """
    bc = grid.bc
    p = make_evp_params(dyn, dt)

    # --- evp_prep1 (":586-694") -------------------------------------------
    tmass = torch.where(grid.tmask, cn.rhoi * vice + cn.rhos * vsno, 0.0)
    tmphm = grid.tmask & (aice > a_min) & (tmass > m_min)
    # 9-point dilation of the ice mask
    f = tmphm.to(tmass.dtype)
    dil = (f + h.nbr_e(f, bc) + h.nbr_w(f, bc) + h.nbr_n(f, bc)
           + h.nbr_s(f, bc) + h.nbr_ne(f, bc) + h.nbr_nw(f, bc)
           + h.nbr_se(f, bc) + h.nbr_sw(f, bc))
    icetmask = (dil > 0.0) & grid.tmask

    # --- T -> U interpolation ---------------------------------------------
    umass = to_ugrid(grid, tmass)
    aiu = to_ugrid(grid, aice)
    strairx = to_ugrid(grid, strairxT)
    strairy = to_ugrid(grid, strairyT)

    # --- evp_prep2 (":703-938"); torch.where builds new tensors, so the
    # subcycle never aliases the caller's state ----------------------------
    stressp = torch.where(icetmask[None], state.stressp, 0.0)
    stressm = torch.where(icetmask[None], state.stressm, 0.0)
    stress12 = torch.where(icetmask[None], state.stress12, 0.0)

    iceumask_old = state.iceumask
    iceumask = grid.umask & (aiu > a_min) & (umass > m_min)
    new_pts = iceumask & ~iceumask_old
    uvel = torch.where(new_pts, uocn, torch.where(iceumask, state.uvel, 0.0))
    vvel = torch.where(new_pts, vocn, torch.where(iceumask, state.vvel, 0.0))

    umassdtei = torch.where(iceumask, umass * p.dtei, 0.0)
    fm = torch.where(iceumask, grid.fcor * umass, 0.0)
    if p.hemi_turning:
        sgn = torch.where(fm < 0.0, -1.0, 1.0).to(fm.dtype)
    else:
        sgn = 1.0
    waterx = torch.where(iceumask, uocn * p.cosw - vocn * p.sinw * sgn, 0.0)
    watery = torch.where(iceumask, vocn * p.cosw + uocn * p.sinw * sgn, 0.0)
    if tilt_from_currents:
        strtltx = -fm * vocn
        strtlty = fm * uocn
    else:
        strtltx = -cn.gravit * umass * ss_tltx
        strtlty = -cn.gravit * umass * ss_tlty
    forcex = torch.where(iceumask, strairx + strtltx, 0.0)
    forcey = torch.where(iceumask, strairy + strtlty, 0.0)

    # --- ice strength ------------------------------------------------------
    strength = ice_strength(dyn, aice, vice, aice0, aicen, vicen, icetmask)

    if bc.ns == "tripole":
        # The top row of U points lies ON the U-fold: (ny-1, i) and
        # (ny-1, (nx-2-i) mod nx) are the same physical point stored twice.
        # Make every U-point input consistent with that (scalars equal,
        # vector components negated), as the reference's tripole halo does
        # for NE_CORNER fields.  The mirror point's value is the E-face
        # fold ghost of the top row, so that a block of a decomposed grid
        # takes it by exchange; only the top row of blocks holds the fold.
        def _mirror(f):
            return h.nbr_n(f, bc, FieldLoc.E_FACE)[..., -1, :]

        on_fold = True
        top_u = iceumask[..., -1, :] & _mirror(iceumask)
        if on_fold:
            iceumask = torch.cat([iceumask[..., :-1, :],
                                  top_u[..., None, :]], dim=-2)
        uvel = torch.where(iceumask, uvel, 0.0)
        vvel = torch.where(iceumask, vvel, 0.0)
        umassdtei = torch.where(iceumask, umassdtei, 0.0)
        fm = torch.where(iceumask, fm, 0.0)
        waterx = torch.where(iceumask, waterx, 0.0)
        watery = torch.where(iceumask, watery, 0.0)
        forcex = torch.where(iceumask, forcex, 0.0)
        forcey = torch.where(iceumask, forcey, 0.0)
        # one exchange for the eleven fields: (field, sign)
        sym = (uvel, vvel, uocn, vocn, waterx, watery, forcex, forcey,
               aiu, umassdtei, fm)
        signs = torch.tensor([-1.0] * 8 + [1.0] * 3, dtype=aiu.dtype,
                             device=aiu.device)[:, None]
        stack = torch.stack(sym)
        top = stack[:, -1, :]
        top = 0.5 * (top + signs * _mirror(stack))
        if on_fold:
            stack = torch.cat([stack[:, :-1, :], top[:, None, :]], dim=-2)
        (uvel, vvel, uocn, vocn, waterx, watery, forcex, forcey, aiu,
         umassdtei, fm) = stack.unbind(0)

    # --- subcycling (":347-408") ------------------------------------------
    (uvel, vvel, stressp, stressm, stress12, d, strintx, strinty,
     strocnx, strocny) = _evp_subcycle_plain(
        p, grid, strength, icetmask, iceumask, aiu, uocn, vocn,
        waterx, watery, forcex, forcey, umassdtei, fm,
        uvel, vvel, stressp, stressm, stress12)

    divu = p25 * d["div_sum"] * grid.tarear
    delta_mean = p25 * d["delta_sum"] * grid.tarear
    rdg_conv = -torch.clamp(divu, max=0.0)
    rdg_shear = p5 * (delta_mean - torch.abs(divu))
    shear = p25 * grid.tarear * torch.sqrt(
        d["ten_sum"] ** 2 + d["shr_sum"] ** 2)

    # --- evp_finish (":1452-1549") ----------------------------------------
    vrel = p.dragw * torch.sqrt((uocn - uvel) ** 2 + (vocn - vvel) ** 2)
    if p.hemi_turning:   # from fm as the fold left it
        sgn = torch.where(fm < 0.0, -1.0, 1.0).to(fm.dtype)
    strocnx = strocnx - vrel * (uvel * p.cosw - sgn * vvel * p.sinw) * aiu
    strocny = strocny - vrel * (vvel * p.cosw + sgn * uvel * p.sinw) * aiu
    strocnxT_u = torch.where(iceumask,
                             strocnx / torch.clamp(aiu, min=cn.puny), 0.0)
    strocnyT_u = torch.where(iceumask,
                             strocny / torch.clamp(aiu, min=cn.puny), 0.0)
    strocnxT = to_tgrid(grid, strocnxT_u)
    strocnyT = to_tgrid(grid, strocnyT_u)

    state = state.replace(uvel=uvel, vvel=vvel, stressp=stressp,
                          stressm=stressm, stress12=stress12,
                          iceumask=iceumask,
                          strocnxT=strocnxT, strocnyT=strocnyT)
    diag = dict(divu=torch.where(icetmask, divu, 0.0),
                shear=torch.where(icetmask, shear, 0.0),
                rdg_conv=torch.where(icetmask, rdg_conv, 0.0),
                rdg_shear=torch.where(icetmask, rdg_shear, 0.0),
                prs_sig=torch.where(icetmask, d["prs_sig"], 0.0),
                strength=strength, strintx=strintx, strinty=strinty,
                strocnx=strocnx, strocny=strocny,
                strairx=strairx, strairy=strairy, fm=fm,
                strtltx=torch.where(iceumask, strtltx, 0.0),
                strtlty=torch.where(iceumask, strtlty, 0.0),
                strcorx=fm * vvel, strcory=-fm * uvel,
                icetmask=icetmask)
    return state, diag


def principal_stress(stressp1, stressm1, stress121, prs_sig):
    """Principal stresses sig1/sig2 normalized by the replacement
    pressure (``ice_dyn_evp.F90 principal_stress:1558-1609``)."""
    root = torch.sqrt(stressm1**2 + 4.0 * stress121**2)
    ok = prs_sig > cn.puny
    denom = torch.clamp(prs_sig, min=cn.puny)
    sig1 = torch.where(ok, 0.5 * (stressp1 + root) / denom, cn.spval)
    sig2 = torch.where(ok, 0.5 * (stressp1 - root) / denom, cn.spval)
    return sig1, sig2
