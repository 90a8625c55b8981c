"""Ice thickness distribution utilities.

Port of :mod:`cice4_tpu.ops.itd` (``source/ice_itd.F90``): category
aggregation, rebinning into thickness bounds, conservative transfers
between categories, small-area elimination.  Dense and masked over the
``(ny, nx)`` plane, as in the JAX package.

Tracer dependency (``ice_init.F90:848-852``): area tracers (Tsfc, alvl,
volpn) are carried as ``aicen * t``; volume tracers (iage, vlvl) as
``vicen * t``.
"""

from __future__ import annotations

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.state import ItdParams, State

# tracer name -> dependency (0: aicen-weighted, 1: vicen, 2: vsnon)
TRACER_DEPEND = {"iage": 1, "alvl": 0, "vlvl": 1, "volpn": 0}


def aggregate(state: State, tmask):
    """Category sums -> cell means (``ice_itd.F90 aggregate:279-485``).

    Returns dict with aice, vice, vsno, eice, esno, aice0, tsfc, trcr.
    """
    m = tmask
    aice = torch.where(m, state.aicen.sum(0), 0.0)
    vice = torch.where(m, state.vicen.sum(0), 0.0)
    vsno = torch.where(m, state.vsnon.sum(0), 0.0)
    eice = torch.where(m, state.eicen.sum((0, 1)), 0.0)
    esno = torch.where(m, state.esnon.sum((0, 1)), 0.0)
    aice0 = torch.where(m, torch.clamp(1.0 - aice, min=0.0), 1.0)

    def mean_tracer(t, weight, denom):
        num = (t * weight).sum(0)
        return torch.where(denom > cn.puny,
                           num / torch.clamp(denom, min=cn.puny), 0.0)

    tsfc_num = (state.tsfcn * state.aicen).sum(0)
    tsfc = torch.where(aice > cn.puny,
                       tsfc_num / torch.clamp(aice, min=cn.puny), cn.Tocnfrz)
    trcr = {}
    for name, t in state.trcrn.items():
        dep = TRACER_DEPEND[name]
        w, d = {0: (state.aicen, aice), 1: (state.vicen, vice),
                2: (state.vsnon, vsno)}[dep]
        trcr[name] = mean_tracer(t, w, d)
    return dict(aice=aice, vice=vice, vsno=vsno, eice=eice, esno=esno,
                aice0=aice0, tsfc=tsfc, trcr=trcr)


def aggregate_area(aicen):
    """(``ice_itd.F90 aggregate_area:494-548``)"""
    aice = aicen.sum(0)
    aice0 = torch.clamp(1.0 - aice, min=0.0)
    return aice, aice0


def _compute_tracers(atrcrn, tsfc_a, aicen, vicen, vsnon, tracer_names):
    """atrcrn (weighted) -> tracer values (``ice_itd.F90
    compute_tracers:1482-1590``).  Open-water Tsfc resets to Tocnfrz."""
    tsfcn = torch.where(aicen > cn.puny,
                        tsfc_a / torch.clamp(aicen, min=cn.puny), cn.Tocnfrz)
    trcrn = {}
    for name in tracer_names:
        dep = TRACER_DEPEND[name]
        denom = {0: aicen, 1: vicen, 2: vsnon}[dep]
        thresh = cn.puny if dep == 0 else 0.0
        trcrn[name] = torch.where(
            denom > thresh,
            atrcrn[name] / torch.clamp(denom, min=cn.puny), 0.0)
    return tsfcn, trcrn


def _move(arr, b, d):
    """Subtract `d` from category b and add it to category b+1, in place
    on `arr`, which the caller owns."""
    arr[b] -= d
    arr[b + 1] += d


def shift_ice(state: State, donor, daice, dvice) -> State:
    """Conservatively move ice between adjacent categories.

    Dense version of ``ice_itd.F90 shift_ice:892-1340``.

    Args:
      donor: int tensor ``(ncat-1, ny, nx)``; per boundary b: 0 = no
        transfer, +1 = donor is category b (moves up to b+1), -1 = donor
        is category b+1 (moves down to b).
      daice, dvice: area/volume transferred across each boundary (>= 0).

    Out-of-range transfers are clamped as in the reference.
    """
    ncat = state.ncat
    # fresh working copies: the updates below are in place
    aicen = state.aicen.clone()
    vicen = state.vicen.clone()
    vsnon = state.vsnon.clone()
    eicen = state.eicen.clone()
    esnon = state.esnon.clone()

    # weighted working tracers
    tsfc_a = state.tsfcn * aicen
    atrcrn = {}
    for name, t in state.trcrn.items():
        w = {0: aicen, 1: vicen, 2: vsnon}[TRACER_DEPEND[name]]
        atrcrn[name] = t * w

    for b in range(ncat - 1):
        up = donor[b] == 1
        dn = donor[b] == -1
        active = up | dn
        # donor-category values
        a_d = torch.where(up, aicen[b], aicen[b + 1])
        v_d = torch.where(up, vicen[b], vicen[b + 1])

        # clamp roundoff (ice_itd.F90:1043-1092)
        da = torch.clamp(daice[b], min=0.0)
        dv = torch.clamp(dvice[b], min=0.0)
        full = (da > a_d * (1.0 - cn.puny)) | (dv > v_d * (1.0 - cn.puny))
        da = torch.where(full, a_d, da)
        dv = torch.where(full, v_d, dv)
        active = active & (da > 0.0)
        da = torch.where(active, da, 0.0)
        dv = torch.where(active, dv, 0.0)

        frac_v = torch.where(v_d > 0.0,
                             dv / torch.clamp(v_d, min=cn.puny), 0.0)

        # signed delta: +1 means subtract from b, add to b+1
        sgn = torch.where(up, 1.0, -1.0).to(aicen.dtype)

        _move(aicen, b, sgn * da)
        _move(vicen, b, sgn * dv)
        vs_d = torch.where(up, vsnon[b], vsnon[b + 1])
        _move(vsnon, b, sgn * (vs_d * frac_v))

        e_d = torch.where(up, eicen[b], eicen[b + 1])   # (nilyr, ny, nx)
        _move(eicen, b, sgn * (e_d * frac_v))
        es_d = torch.where(up, esnon[b], esnon[b + 1])
        _move(esnon, b, sgn * (es_d * frac_v))

        frac_a = torch.where(a_d > 0.0,
                             da / torch.clamp(a_d, min=cn.puny), 0.0)
        t_d = torch.where(up, tsfc_a[b], tsfc_a[b + 1])
        _move(tsfc_a, b, sgn * (t_d * frac_a))

        for name in atrcrn:
            dep = TRACER_DEPEND[name]
            t_dn = torch.where(up, atrcrn[name][b], atrcrn[name][b + 1])
            frac = frac_a if dep == 0 else frac_v
            _move(atrcrn[name], b, sgn * (t_dn * frac))

    tsfcn, trcrn = _compute_tracers(atrcrn, tsfc_a, aicen, vicen, vsnon,
                                    list(state.trcrn.keys()))
    return state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon,
                         eicen=eicen, esnon=esnon, tsfcn=tsfcn, trcrn=trcrn)


def _one_boundary(ncat, b, move, amount_a, amount_v, sign):
    """donor/daice/dvice arrays that move `amount_*` across boundary b
    only (rebin's single-boundary transfers)."""
    shape = (ncat - 1,) + move.shape
    donor = torch.zeros(shape, dtype=torch.int32, device=move.device)
    daice = torch.zeros(shape, dtype=amount_a.dtype, device=move.device)
    dvice = torch.zeros_like(daice)
    donor[b] = torch.where(move, sign, 0).to(torch.int32)
    daice[b] = torch.where(move, amount_a, 0.0)
    dvice[b] = torch.where(move, amount_v, 0.0)
    return donor, daice, dvice


def rebin(state: State, itd: ItdParams) -> State:
    """Force every category thickness into its bounds (``ice_itd.F90
    rebin:557-793``): sweep boundaries upward moving too-thick
    categories up, then downward moving too-thin categories down.  Each
    active transfer moves the *entire* donor category."""
    ncat = itd.ncat
    hin_max = itd.hin_max

    def hicen_of(aicen, vicen):
        return torch.where(aicen > cn.puny,
                           vicen / torch.clamp(aicen, min=cn.puny), 0.0)

    # category 1 minimum thickness (delta-function ITD only)
    if hin_max[0] > 0.0:
        h0 = hicen_of(state.aicen[0], state.vicen[0])
        fix = (state.aicen[0] > cn.puny) & (h0 <= hin_max[0])
        aicen = state.aicen.clone()
        aicen[0] = torch.where(fix, state.vicen[0] / hin_max[0],
                               state.aicen[0])
        state = state.replace(aicen=aicen)

    # upward sweep; boundary b separates cat b and b+1, bound hin_max[b+1]
    for b in range(ncat - 1):
        h = hicen_of(state.aicen[b], state.vicen[b])
        move = (state.aicen[b] > cn.puny) & (h > hin_max[b + 1])
        state = shift_ice(state, *_one_boundary(
            ncat, b, move, state.aicen[b], state.vicen[b], 1))

    # downward sweep
    for b in range(ncat - 2, -1, -1):
        h = hicen_of(state.aicen[b + 1], state.vicen[b + 1])
        move = (state.aicen[b + 1] > cn.puny) & (h <= hin_max[b + 1])
        state = shift_ice(state, *_one_boundary(
            ncat, b, move, state.aicen[b + 1], state.vicen[b + 1], -1))

    return state


def zap_small_areas(state: State, tmask, dt) -> tuple[State, dict]:
    """Remove categories with area <= puny, melting them into the ocean,
    and normalize total area to <= 1 (``ice_itd.F90
    zap_small_areas:1844-2160``).  Returns (state, fluxes) where fluxes
    carries dfresh (kg/m^2/s), dfsalt, dfhocn (W/m^2) for strict
    conservation with the ocean."""
    aicen, vicen, vsnon = state.aicen, state.vicen, state.vsnon
    eicen, esnon, tsfcn = state.eicen, state.esnon, state.tsfcn
    trcrn = dict(state.trcrn)

    # dtype-aware threshold (see cn.a_negligible)
    a_zap = cn.a_negligible(aicen.dtype)
    zap = (torch.abs(aicen) > 0.0) & (torch.abs(aicen) <= a_zap) & tmask[None]
    zap_l = zap[:, None]
    dfhocn = torch.where(zap_l, eicen, 0.0).sum((0, 1)) / dt
    dfhocn = dfhocn + torch.where(zap_l, esnon, 0.0).sum((0, 1)) / dt
    dfresh = torch.where(zap, cn.rhoi * vicen + cn.rhos * vsnon,
                         0.0).sum(0) / dt
    dfsalt = torch.where(zap, cn.rhoi * vicen, 0.0).sum(0) \
        * cn.ice_ref_salinity * 0.001 / dt

    aicen = torch.where(zap, 0.0, aicen)
    vicen = torch.where(zap, 0.0, vicen)
    vsnon = torch.where(zap, 0.0, vsnon)
    eicen = torch.where(zap_l, 0.0, eicen)
    esnon = torch.where(zap_l, 0.0, esnon)
    tsfcn = torch.where(zap, cn.Tocnfrz, tsfcn)
    for name in trcrn:
        trcrn[name] = torch.where(zap, 0.0, trcrn[name])

    # normalize excess total area from roundoff (reference condition is
    # simply aice > c1, ice_itd.F90:2040; f32 roundoff excess is ~1e-7)
    aice = aicen.sum(0)
    excess = aice > 1.0
    scale = torch.where(excess, 1.0 / torch.clamp(aice, min=cn.puny), 1.0)
    zapfrac = torch.where(excess,
                          (aice - 1.0) / torch.clamp(aice, min=cn.puny), 0.0)
    dfhocn = dfhocn + (eicen.sum((0, 1)) + esnon.sum((0, 1))) \
        * zapfrac / dt
    dfresh = dfresh + (cn.rhoi * vicen + cn.rhos * vsnon).sum(0) \
        * zapfrac / dt
    dfsalt = dfsalt + (cn.rhoi * vicen).sum(0) \
        * cn.ice_ref_salinity * 0.001 * zapfrac / dt

    aicen = aicen * scale[None]
    vicen = vicen * scale[None]
    vsnon = vsnon * scale[None]
    eicen = eicen * scale[None, None]
    esnon = esnon * scale[None, None]

    state = state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon,
                          eicen=eicen, esnon=esnon, tsfcn=tsfcn, trcrn=trcrn)
    return state, dict(dfresh=dfresh, dfsalt=dfsalt, dfhocn=dfhocn)


def cleanup_itd(state: State, itd: ItdParams, tmask, dt,
                limit_aice: bool = True) -> tuple[State, dict]:
    """Rebin + zap small areas (``ice_itd.F90 cleanup_itd:1600-1835``).
    Returns (state, ocean-flux corrections).

    On CUDA tensors this launches the cleanup_column kernel
    (``csrc/ridge_column.cu``, or raises); on CPU tensors it runs the
    plain version :func:`_cleanup_itd_plain`.  `cleanup_itd.launches`
    counts the kernel's launches."""
    if state.aicen.device.type == "cpu":
        return _cleanup_itd_plain(state, itd, tmask, dt, limit_aice)
    if state.aicen.device.type != "cuda":
        raise NotImplementedError(
            f"cleanup_itd has no path for device {state.aicen.device}")
    from cice4_tpu_torch.ops import ridge_cuda

    new, fluxes = ridge_cuda.cleanup_itd_cuda(state, itd, tmask, dt,
                                              limit_aice)
    cleanup_itd.launches += 1
    return state.replace(**new), fluxes


cleanup_itd.launches = 0


def _cleanup_itd_plain(state: State, itd: ItdParams, tmask, dt,
                       limit_aice: bool = True) -> tuple[State, dict]:
    """:func:`cleanup_itd` as eager PyTorch operations."""
    state = rebin(state, itd)
    if limit_aice:
        return zap_small_areas(state, tmask, dt)
    zero = torch.zeros_like(state.sst)
    return state, dict(dfresh=zero, dfsalt=zero, dfhocn=zero)


def column_sums(state: State):
    """Per-cell conservation sums (``ice_itd.F90 column_sum:1349-1400``)."""
    return dict(
        vice=state.vicen.sum(0),
        vsno=state.vsnon.sum(0),
        eice=state.eicen.sum((0, 1)),
        esno=state.esnon.sum((0, 1)),
    )


def reduce_area(tmask, hin_max0, aicen1, vicen1, aicen1_init, vicen1_init):
    """Open-water adjustment when melting with ncat = 1
    (``ice_itd.F90 reduce_area:802-883``): reduce the single category's
    area as it thins so open water can form.  Returns new aicen1."""
    hi0 = torch.where(aicen1_init > 0.0,
                      vicen1_init / torch.clamp(aicen1_init, min=cn.puny), 0.0)
    hi1 = torch.where(aicen1 > 0.0,
                      vicen1 / torch.clamp(aicen1, min=cn.puny), 0.0)
    thin = (hi1 <= hin_max0) & (hin_max0 > 0.0)
    aicen1 = torch.where(thin, vicen1 / max(hin_max0, cn.puny), aicen1)
    hi1 = torch.where(thin, torch.full_like(hi1, hin_max0), hi1)
    melting = (aicen1 > 0.0) & (hi1 - hi0 < 0.0)
    hi1m = torch.where(aicen1 > 0.0,
                       vicen1 / torch.clamp(aicen1, min=cn.puny), hi1)
    aicen1 = torch.where(melting,
                         2.0 * vicen1 / torch.clamp(hi1m + hi0, min=cn.puny),
                         aicen1)
    return torch.where(tmask, aicen1, 0.0)
