"""Thermodynamic ITD evolution: linear remapping between categories,
frazil ice formation, lateral melt.

Port of :mod:`cice4_tpu.ops.therm_itd` (``source/ice_therm_itd.F90``):
`linear_itd:58-705` (Lipscomb 2001), `fit_line:715-818`,
`add_new_ice:843-1247` and `lateral_melt:1266-1420`.
"""

from __future__ import annotations

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.ops.itd import aggregate_area, shift_ice
from cice4_tpu_torch.state import ItdParams, State

hi_min = 0.01  # minimum ice thickness of thinnest category (m)


def _fit_line(aicen, hice, hbL, hbR):
    """Fit g(h) linear between adjusted bounds (``fit_line:715-818``).

    Returns (g0, g1, hL, hR); zero where no ice or empty range.
    """
    ok = (aicen > cn.puny) & (hbR - hbL > cn.puny)
    hL = hbL
    hR = hbR
    h13 = (2.0 * hL + hR) / 3.0
    h23 = (hL + 2.0 * hR) / 3.0
    hR = torch.where(hice < h13, 3.0 * hice - 2.0 * hL, hR)
    hL = torch.where(hice > h23, 3.0 * hice - 2.0 * hR, hL)
    dhr = 1.0 / torch.clamp(hR - hL, min=cn.puny)
    wk1 = 6.0 * aicen * dhr
    wk2 = (hice - hL) * dhr
    g0 = torch.where(ok, wk1 * (2.0 / 3.0 - wk2), 0.0)
    g1 = torch.where(ok, 2.0 * dhr * wk1 * (wk2 - 0.5), 0.0)
    hL = torch.where(ok, hL, 0.0)
    hR = torch.where(ok, hR, 0.0)
    return g0, g1, hL, hR


def linear_itd(state: State, itd: ItdParams, aicen_init, vicen_init):
    """Linear remapping of ice between categories after thermo growth
    (``linear_itd:58-705``).

    aicen_init/vicen_init: pre-thermo category state (the reference's
    `aicen_init` saved in `ice_state.F90:143-149`).
    """
    ncat = itd.ncat
    hin_max = [float(h) for h in itd.hin_max]
    hin_max[ncat] = 999.9  # reference overrides top bound (":151")
    aicen, vicen = state.aicen, state.vicen

    def safe_h(v, a):
        return torch.where(a > cn.puny, v / torch.clamp(a, min=cn.puny), 0.0)

    def full(v):
        return torch.full_like(hicen[0], v)

    hicen_init = safe_h(vicen_init, aicen_init)
    hicen = safe_h(vicen, aicen)
    dhicen = torch.where(aicen > cn.puny, hicen - hicen_init, 0.0)

    # new displaced boundaries hbnew (":203-260")
    hbnew = [None] * (ncat + 1)
    hbnew[0] = full(hin_max[0])
    remap = torch.ones_like(hicen[0], dtype=torch.bool)
    for n in range(ncat - 1):
        both = (hicen_init[n] > cn.puny) & (hicen_init[n + 1] > cn.puny)
        only_n = (hicen_init[n] > cn.puny) & ~both
        only_np1 = (hicen_init[n + 1] > cn.puny) & ~both
        slope = (dhicen[n + 1] - dhicen[n]) \
            / torch.where(both, hicen_init[n + 1] - hicen_init[n], 1.0)
        hb = torch.where(
            both,
            hin_max[n + 1] + dhicen[n]
            + slope * (hin_max[n + 1] - hicen_init[n]),
            torch.where(only_n, hin_max[n + 1] + dhicen[n],
                        torch.where(only_np1, hin_max[n + 1] + dhicen[n + 1],
                                    full(hin_max[n + 1]))))
        hbnew[n + 1] = hb
        # disable remap where boundaries crossed category thicknesses
        remap = remap & ~((aicen[n] > cn.puny) & (hicen[n] >= hb))
        remap = remap & ~((aicen[n + 1] > cn.puny) & (hicen[n + 1] <= hb))
        remap = remap & ~(hb > hin_max[n + 2])
        remap = remap & ~(hb < hin_max[n])
    hbnew[ncat] = torch.clamp(full(hin_max[ncat]), min=hin_max[ncat - 1])

    # category-1 area adjustment for melting at h -> 0 (":437-470")
    g0_1, g1_1, hL_1, hR_1 = _fit_line(
        aicen[0], hicen_init[0], hbnew[0], full(hin_max[1]))
    dh0 = dhicen[0]
    melting = remap & (aicen[0] > cn.puny) & (dh0 < 0.0)
    dh0m = torch.clamp(-dh0, max=hin_max[1])
    etamax = torch.minimum(dh0m, hR_1) - hL_1
    x1 = etamax
    x2 = 0.5 * etamax * etamax
    da0 = g1_1 * x2 + g0_1 * x1
    damax = aicen[0] * (1.0 - hicen[0]
                        / torch.clamp(hicen_init[0], min=cn.puny))
    da0 = torch.minimum(da0, damax)
    apply0 = melting & (etamax > 0.0)
    new_a0 = torch.where(apply0, aicen[0] - da0, aicen[0])
    hicen0 = torch.where(apply0,
                         hicen[0] * aicen[0] / torch.clamp(new_a0, min=cn.puny),
                         hicen[0])
    aicen = torch.cat([new_a0[None], aicen[1:]])
    hicen = torch.cat([hicen0[None], hicen[1:]])
    # growing: shift hbnew[0] right
    growing = remap & (aicen[0] > cn.puny) & (dh0 >= 0.0)
    hbnew[0] = torch.where(growing, torch.clamp(dh0, max=hin_max[1]),
                           hbnew[0])

    state = state.replace(aicen=aicen)

    # fit g(h) in each category against the new boundaries
    fits = [_fit_line(aicen[n], hicen[n], hbnew[n], hbnew[n + 1])
            for n in range(ncat)]
    g0, g1, hL, hR = (list(x) for x in zip(*fits))

    # transfers across each boundary (":497-566")
    zero = torch.zeros_like(hicen[0])
    donor = []
    daice = []
    dvice = []
    for n in range(ncat - 1):
        up = hbnew[n + 1] > hin_max[n + 1]  # transfer n -> n+1
        etamin_u = torch.clamp(hL[n], min=hin_max[n + 1]) - hL[n]
        etamax_u = torch.minimum(hbnew[n + 1], hR[n]) - hL[n]
        etamin_d = zero
        etamax_d = torch.clamp(hR[n + 1], max=hin_max[n + 1]) - hL[n + 1]
        etamin = torch.where(up, etamin_u, etamin_d)
        etamax = torch.where(up, etamax_u, etamax_d)
        g0d = torch.where(up, g0[n], g0[n + 1])
        g1d = torch.where(up, g1[n], g1[n + 1])
        hLd = torch.where(up, hL[n], hL[n + 1])
        a_d = torch.where(up, aicen[n], aicen[n + 1])
        v_d = torch.where(up, state.vicen[n], state.vicen[n + 1])

        ok = remap & (etamax > etamin)
        x1 = etamax - etamin
        x2 = 0.5 * (etamax**2 - etamin**2)
        x3 = (etamax**3 - etamin**3) / 3.0
        da = torch.where(ok, g1d * x2 + g0d * x1, 0.0)
        dv = torch.where(ok, g1d * x3 + g0d * x2 + da * hLd, 0.0)
        # clamp (":549-566")
        small = (da < a_d * cn.puny) | (dv < v_d * cn.puny)
        da = torch.where(small, 0.0, da)
        dv = torch.where(small, 0.0, dv)
        full_t = (da > a_d * (1.0 - cn.puny)) | (dv > v_d * (1.0 - cn.puny))
        da = torch.where(full_t & ~small, a_d, da)
        dv = torch.where(full_t & ~small, v_d, dv)
        active = ok & ~small & (da > 0.0)
        donor.append(torch.where(active, torch.where(up, 1, -1), 0)
                     .to(torch.int32))
        daice.append(da)
        dvice.append(dv)

    state = shift_ice(state, torch.stack(donor), torch.stack(daice),
                      torch.stack(dvice))

    # enforce hi_min on category 1 (":583-592")
    a0 = state.aicen[0]
    h1 = torch.where(a0 > cn.puny,
                     state.vicen[0] / torch.clamp(a0, min=cn.puny), 0.0)
    thin = remap & (a0 > cn.puny) & (h1 < hi_min)
    a1 = torch.where(thin, a0 * h1 / hi_min, a0)
    return state.replace(aicen=torch.cat([a1[None], state.aicen[1:]]))


def add_new_ice(state: State, itd: ItdParams, cfg: Config, dt,
                frzmlt, Tf, tmask):
    """Frazil ice growth (``add_new_ice:843-1247``).

    Returns (state, diag) where diag has frazil (m), fresh/fsalt deltas
    (only when update_ocn_f).
    """
    ncat, nilyr = itd.ncat, itd.nilyr
    aicen, vicen = state.aicen, state.vicen
    eicen = state.eicen
    tsfcn = state.tsfcn
    trcrn = dict(state.trcrn)

    aice, aice0 = aggregate_area(aicen)
    hi0max = itd.hin_max[1] * 0.9 if ncat > 1 else cn.bignum

    qi0 = -cn.rhoi * cn.Lfresh      # frazil enthalpy, all layers
    qi0av = qi0

    fnew = torch.clamp(frzmlt, min=0.0) * tmask
    vi0new = -fnew * dt / qi0av
    frazil = vi0new

    growing = vi0new > 0.0
    open_w = aice0 > cn.puny
    hi0new = torch.clamp(vi0new / torch.clamp(aice0, min=cn.puny),
                         min=cfg.thermo.hfrazilmin)
    too_thick = (hi0new > hi0max) & (aice0 + cn.puny < 1.0)
    # case A: open water, fits
    ai0_A = vi0new / torch.clamp(hi0new, min=cn.puny)
    # case B: open water but too thick -> fill open water + surplus
    ai0_B = aice0
    vsurp_B = vi0new - ai0_B * hi0max
    hsurp_B = vsurp_B / torch.clamp(aice, min=cn.puny)
    vi0_B = ai0_B * hi0max
    # case C: no open water -> all surplus
    hsurp_C = vi0new / torch.clamp(aice, min=cn.puny)

    ai0new = torch.where(growing & open_w,
                         torch.where(too_thick, ai0_B, ai0_A), 0.0)
    vi0new_f = torch.where(growing & open_w,
                           torch.where(too_thick, vi0_B, vi0new), 0.0)
    hsurp = torch.where(growing,
                        torch.where(open_w,
                                    torch.where(too_thick, hsurp_B, 0.0),
                                    hsurp_C), 0.0)
    hsurp = torch.where(aice > cn.puny, hsurp, 0.0)

    # add surplus ice of thickness hsurp to every category (":1076-1118")
    surp = hsurp > 0.0
    vsurp_n = torch.where(surp[None], hsurp[None] * aicen, 0.0)
    vtmp = vicen + vsurp_n
    if "iage" in trcrn:
        upd = surp[None] & (vtmp > cn.puny)
        trcrn["iage"] = torch.where(
            upd, (trcrn["iage"] * vicen + dt * vsurp_n)
            / torch.clamp(vtmp, min=cn.puny), trcrn["iage"])
    if "vlvl" in trcrn:
        upd = surp[None] & (vicen > cn.puny)
        trcrn["vlvl"] = torch.where(
            upd, (trcrn["vlvl"] * vicen + trcrn["alvl"] * vsurp_n)
            / torch.clamp(vtmp, min=cn.puny), trcrn["vlvl"])
    vicen = vtmp
    eicen = eicen + qi0 * (vsurp_n / nilyr)[:, None]

    # add new ice to category 1 (":1124-1171")
    grow1 = vi0new_f > 0.0
    area1 = aicen[0]
    vice1 = vicen[0]
    a1 = area1 + torch.where(grow1, ai0new, 0.0)
    v1 = vice1 + torch.where(grow1, vi0new_f, 0.0)
    t1 = torch.where(grow1,
                     torch.clamp((tsfcn[0] * area1 + Tf * ai0new)
                                 / torch.clamp(a1, min=cn.puny), max=0.0),
                     tsfcn[0])

    def set0(arr, v):
        return torch.cat([v[None], arr[1:]])

    if "iage" in trcrn:
        upd = grow1 & (v1 > cn.puny)
        trcrn["iage"] = set0(trcrn["iage"], torch.where(
            upd, (trcrn["iage"][0] * vice1 + dt * vi0new_f)
            / torch.clamp(v1, min=cn.puny), trcrn["iage"][0]))
    if "alvl" in trcrn:
        upd = grow1 & (a1 > cn.puny)
        trcrn["alvl"] = set0(trcrn["alvl"], torch.where(
            upd, (trcrn["alvl"][0] * area1 + ai0new)
            / torch.clamp(a1, min=cn.puny), trcrn["alvl"][0]))
        trcrn["vlvl"] = set0(trcrn["vlvl"], torch.where(
            upd, (trcrn["vlvl"][0] * vice1 + vi0new_f)
            / torch.clamp(v1, min=cn.puny), trcrn["vlvl"][0]))
    aicen = set0(aicen, a1)
    vicen = set0(vicen, v1)
    tsfcn = set0(tsfcn, t1)
    eicen = set0(eicen, eicen[0] + qi0 * torch.where(grow1, vi0new_f, 0.0)[None]
                 / nilyr)

    state = state.replace(aicen=aicen, vicen=vicen, eicen=eicen,
                          tsfcn=tsfcn, trcrn=trcrn)
    diag = dict(frazil=frazil)
    if cfg.thermo.update_ocn_f:
        diag["dfresh"] = -cn.rhoi * vi0new / dt
        diag["dfsalt"] = cn.ice_ref_salinity * 0.001 * diag["dfresh"]
    return state, diag


def lateral_melt(state: State, itd: ItdParams, dt, rside):
    """Lateral melt of all categories by fraction rside
    (``lateral_melt:1266-1420``).  Returns (state, flux dict)."""
    shrink = 1.0 - rside
    dfresh = (cn.rhos * state.vsnon + cn.rhoi * state.vicen).sum(0) \
        * rside / dt
    dfsalt = (cn.rhoi * state.vicen).sum(0) \
        * cn.ice_ref_salinity * 0.001 * rside / dt
    dfhocn = (state.eicen.sum((0, 1)) + state.esnon.sum((0, 1))) \
        * rside / dt
    meltl = state.vicen.sum(0) * rside
    state = state.replace(
        aicen=state.aicen * shrink[None],
        vicen=state.vicen * shrink[None],
        vsnon=state.vsnon * shrink[None],
        eicen=state.eicen * shrink[None, None],
        esnon=state.esnon * shrink[None, None],
    )
    return state, dict(fresh=dfresh, fsalt=dfsalt, fhocn=dfhocn, meltl=meltl)
