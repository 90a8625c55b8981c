"""Mechanical redistribution (ridging/rafting).

Port of :mod:`cice4_tpu.ops.mechred` (``source/ice_mechred.F90``
`ridge_ice:133-552`): iterate opening/closing (`ridge_prep:647-745`,
`ridge_check:1788-1842`) with the participation/redistribution ITD of
`ridge_itd` and the conservative category transfer of
`ridge_shift:1099-1773`, until the total area sums to 1 (at most 20
iterations).

On CUDA tensors the whole loop is one launch of the column kernel
``csrc/ridge_column.cu`` (:mod:`cice4_tpu_torch.ops.ridge_cuda`), whose
columns each leave the loop when their own area sums to 1, with no host
synchronisation.  On CPU tensors the plain version runs: the loop leaves
when every column (of every block) is done, and its test reads one
boolean from the device a pass.
"""

from __future__ import annotations

import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch import timers
from cice4_tpu_torch.config import DynamicsConfig
from cice4_tpu_torch.ops.itd import TRACER_DEPEND, _compute_tracers
from cice4_tpu_torch.ops.mechred_strength import Cs, fsnowrdg, ridge_itd_full
from cice4_tpu_torch.parallel.halo import global_all
from cice4_tpu_torch.state import ItdParams, State

nitermax_ridge = 20


def _ridge_prep(dt, rdg_conv, rdg_shear, asum):
    """(``ridge_prep:647-745``)"""
    closing_net = Cs * rdg_shear + rdg_conv
    divu_adv = (1.0 - asum) / dt
    closing_net = torch.where(divu_adv < 0.0,
                              torch.maximum(closing_net, -divu_adv),
                              closing_net)
    opning = closing_net + divu_adv
    return closing_net, divu_adv, opning


def _ridge_shift(dyn: DynamicsConfig, itd: ItdParams, dt, carry,
                 closing_net, opning):
    """One `ridge_shift` pass (``:1099-1773``) on the dense carry."""
    ncat = itd.ncat
    hin_max = [float(h) for h in itd.hin_max]
    hin_max[ncat] = 1.0e8  # ridge_prep sets top bound to big

    aicen_init = carry["aicen"]
    vicen_init = carry["vicen"]
    vsnon_init = carry["vsnon"]
    eicen_init = carry["eicen"]
    esnon_init = carry["esnon"]
    aice0 = carry["aice0"]
    # fresh working copies: the updates below are in place
    aicen = aicen_init.clone()
    vicen = vicen_init.clone()
    vsnon = vsnon_init.clone()
    eicen = eicen_init.clone()
    esnon = esnon_init.clone()
    tsfc_a = carry["tsfc_a"].clone()
    atrcrn = {k: v.clone() for k, v in carry["atrcrn"].items()}

    r = ridge_itd_full(dyn, aicen_init, vicen_init, aice0)
    apartic0, apartic = r["apartic0"], r["apartic"]
    hrmin, hrmax, hrexp, krdg = r["hrmin"], r["hrmax"], r["hrexp"], r["krdg"]
    aksum = r["aksum"]

    closing_gross = closing_net / torch.clamp(aksum, min=cn.puny)

    # reduce rates if they would remove more area than exists (":1240-1282")
    wk1 = apartic0 * closing_gross * dt
    fac = torch.where((apartic0 > 0.0) & (wk1 > aice0),
                      aice0 / torch.clamp(wk1, min=cn.puny), 1.0)
    closing_gross = closing_gross * fac
    opning = opning * fac
    for n in range(ncat):
        wk1 = apartic[n] * closing_gross * dt
        fac = torch.where((aicen_init[n] > cn.puny) & (apartic[n] > 0.0)
                          & (wk1 > aicen_init[n]),
                          aicen_init[n] / torch.clamp(wk1, min=cn.puny), 1.0)
        closing_gross = closing_gross * fac
        opning = opning * fac

    aice0 = torch.clamp(aice0 - apartic0 * closing_gross * dt
                        + opning * dt, min=0.0)
    aopen = opning * dt

    msnow_mlt = carry["msnow_mlt"]
    esnow_mlt = carry["esnow_mlt"]
    ardg1 = carry["ardg1"]
    ardg2 = carry["ardg2"]
    virdg = carry["virdg"]
    tsfcn0 = carry["tsfcn"]
    trcrn0 = carry["trcrn"]

    for n in range(ncat):
        active = (aicen_init[n] > cn.puny) & (apartic[n] > 0.0) \
            & (closing_gross > 0.0)
        ardg1n = torch.where(active,
                             torch.minimum(apartic[n] * closing_gross * dt,
                                           aicen_init[n]), 0.0)
        ardg2n = ardg1n / torch.clamp(krdg[n], min=cn.puny)
        afrac = ardg1n / torch.clamp(aicen_init[n], min=cn.puny)
        virdgn = vicen_init[n] * afrac
        vsrdgn = vsnon_init[n] * afrac

        aicen[n] -= ardg1n
        vicen[n] -= virdgn
        vsnon[n] -= vsrdgn
        ardg1 = ardg1 + ardg1n
        ardg2 = ardg2 + ardg2n
        virdg = virdg + virdgn
        msnow_mlt = msnow_mlt + cn.rhos * vsrdgn * (1.0 - fsnowrdg)

        eirdgn = eicen_init[n] * afrac[None]           # (nilyr, ny, nx)
        eicen[n] -= eirdgn
        esrdgn = esnon_init[n] * afrac[None]
        esnon[n] -= esrdgn
        esnow_mlt = esnow_mlt + esrdgn.sum(0) * (1.0 - fsnowrdg)

        # weighted tracers leave the donor (tracer values unchanged)
        tsfc_a[n] -= ardg1n * tsfcn0[n]
        # level-ice tracers: the level portion of the ridging ice leaves
        # the level tracers before the general weighted subtraction
        # (ice_mechred.F90 ridge_shift:1474-1482)
        for name in ("alvl", "vlvl"):
            if name in atrcrn:
                atrcrn[name][n] *= 1.0 - afrac
        for name in atrcrn:
            dep = TRACER_DEPEND[name]
            amt = {0: ardg1n, 1: virdgn, 2: vsrdgn}[dep]
            atrcrn[name][n] -= amt * trcrn0[name][n]
        dhr = torch.clamp(hrmax[n] - hrmin[n], min=cn.puny)
        dhr2 = torch.clamp(hrmax[n] ** 2 - hrmin[n] ** 2, min=cn.puny)

        for nr in range(ncat):
            if dyn.krdg_redist == 0:  # Hibler 1980 uniform
                empty = (hrmin[n] >= hin_max[nr + 1]) \
                    | (hrmax[n] <= hin_max[nr])
                hLr = torch.clamp(hrmin[n], min=hin_max[nr])
                hRr = torch.clamp(hrmax[n], max=hin_max[nr + 1])
                farea = torch.where(empty, 0.0, (hRr - hLr) / dhr)
                fvol = torch.where(empty, 0.0, (hRr**2 - hLr**2) / dhr2)
            else:                     # exponential
                hi1 = hrmin[n]
                hexp = torch.clamp(hrexp[n], min=cn.puny)
                if nr < ncat - 1:
                    empty = hi1 >= hin_max[nr + 1]
                    hLr = torch.clamp(hi1, min=hin_max[nr])
                    hRr = hin_max[nr + 1]
                    expL = torch.exp(-(hLr - hi1) / hexp)
                    expR = torch.exp(-(hRr - hi1) / hexp)
                    farea = torch.where(empty, 0.0, expL - expR)
                    fvol = torch.where(
                        empty, 0.0,
                        ((hLr + hexp) * expL - (hRr + hexp) * expR)
                        / torch.clamp(hi1 + hexp, min=cn.puny))
                else:
                    hLr = torch.clamp(hi1, min=hin_max[nr])
                    expL = torch.exp(-(hLr - hi1) / hexp)
                    farea = expL
                    fvol = (hLr + hexp) * expL \
                        / torch.clamp(hi1 + hexp, min=cn.puny)

            aicen[nr] += farea * ardg2n
            vicen[nr] += fvol * virdgn
            vsnon[nr] += fvol * vsrdgn * fsnowrdg
            eicen[nr] += fvol[None] * eirdgn
            esnon[nr] += fvol[None] * esrdgn * fsnowrdg
            tsfc_a[nr] += farea * ardg2n * tsfcn0[n]
            # the deposit acts on ALL tracers; the area-tracer deposit is
            # weighted by the RIDGED area ardg2n (":1726-1729")
            for name in atrcrn:
                dep = TRACER_DEPEND[name]
                amt = {0: farea * ardg2n, 1: fvol * virdgn,
                       2: fvol * vsrdgn * fsnowrdg}[dep]
                atrcrn[name][nr] += amt * trcrn0[name][n]

    tsfcn, trcrn = _compute_tracers(atrcrn, tsfc_a, aicen, vicen, vsnon,
                                    list(atrcrn.keys()))

    return dict(carry, aicen=aicen, vicen=vicen, vsnon=vsnon,
                eicen=eicen, esnon=esnon, aice0=aice0,
                tsfcn=tsfcn, trcrn=trcrn, tsfc_a=tsfcn * aicen,
                atrcrn={k: trcrn[k]
                        * {0: aicen, 1: vicen, 2: vsnon}[TRACER_DEPEND[k]]
                        for k in trcrn},
                msnow_mlt=msnow_mlt, esnow_mlt=esnow_mlt,
                ardg1=ardg1, ardg2=ardg2, virdg=virdg,
                aopen=carry["aopen"] + aopen)


def ridge_ice(state: State, itd: ItdParams, dyn: DynamicsConfig, dt,
              rdg_conv, rdg_shear, tmask, aice0=None, guards=False):
    """Ridging driver (``ridge_ice:133-552``).

    aice0: advected open-water fraction from the transport step; defaults
    to the in-bounds complement when no transport ran.

    Returns (state, diag) where diag carries dardg1dt, dardg2dt,
    dvirdgdt, opening (1/s or m/s), fresh/fhocn corrections from snow
    lost to the ocean during ridging, and `niter`, the number of ridging
    passes: a Python int on the CPU, a 0-d device tensor (the most passes
    of any column, of the block on a decomposed grid) on a card.

    On CUDA tensors this launches the ridge_column kernel (or raises); on
    CPU tensors it runs the plain version :func:`_ridge_ice_plain`.
    `ridge_ice.launches` counts the kernel's launches.
    """
    if state.aicen.device.type == "cpu":
        return _ridge_ice_plain(state, itd, dyn, dt, rdg_conv, rdg_shear,
                                tmask, aice0, guards)
    if state.aicen.device.type != "cuda":
        raise NotImplementedError(
            f"ridge_ice has no path for device {state.aicen.device}")
    from cice4_tpu_torch.ops import ridge_cuda

    new, diag, asum, niter_cells, converged = ridge_cuda.ridge_ice_cuda(
        state, itd, dyn, dt, rdg_conv, rdg_shear, tmask, aice0,
        nitermax_ridge)
    ridge_ice.launches += 1
    # the most passes of this block's columns: on a decomposed grid the
    # block's own count, which no other block waits for
    niter = niter_cells.amax()
    timers.count("ridge_passes", niter)
    if guards:
        from cice4_tpu_torch.guards import check_ridge
        diag["_guard"] = check_ridge(asum, tmask, converged)
    diag["niter"] = niter
    return state.replace(**new), diag


ridge_ice.launches = 0


def _initial_carry(state: State, aice0):
    """The ridging loop's carry before its first pass."""
    zero = torch.zeros_like(state.sst)
    if aice0 is None:
        aice0 = torch.clamp(1.0 - state.aicen.sum(0), min=0.0)
    return dict(
        aicen=state.aicen, vicen=state.vicen, vsnon=state.vsnon,
        eicen=state.eicen, esnon=state.esnon, aice0=aice0,
        tsfcn=state.tsfcn, trcrn=dict(state.trcrn),
        tsfc_a=state.tsfcn * state.aicen,
        atrcrn={k: state.trcrn[k] * {0: state.aicen, 1: state.vicen,
                                     2: state.vsnon}[TRACER_DEPEND[k]]
                for k in state.trcrn},
        msnow_mlt=zero, esnow_mlt=zero,
        ardg1=zero, ardg2=zero, virdg=zero, aopen=zero,
    )


def _ridge_ice_plain(state: State, itd: ItdParams, dyn: DynamicsConfig, dt,
                     rdg_conv, rdg_shear, tmask, aice0=None, guards=False):
    """:func:`ridge_ice` as eager PyTorch operations, the loop's exit a
    host decision taken when every column of every block is done."""
    carry = _initial_carry(state, aice0)
    aice0 = carry["aice0"]

    asum = aice0 + state.aicen.sum(0)
    closing_net, _divu_adv, opning = _ridge_prep(dt, rdg_conv, rdg_shear,
                                                 asum)
    closing_net = torch.where(tmask, closing_net, 0.0)
    opning = torch.where(tmask, opning, 0.0)

    niter = 0
    done = False
    while not done and niter < nitermax_ridge:
        carry = _ridge_shift(dyn, itd, dt, carry, closing_net, opning)
        # ridge_check (":1788-1842")
        asum = carry["aice0"] + carry["aicen"].sum(0)
        ok = (torch.abs(asum - 1.0) < cn.puny) | ~tmask
        divu_adv = (1.0 - asum) / dt
        closing_net = torch.where(ok, 0.0, torch.clamp(-divu_adv, min=0.0))
        opning = torch.where(ok, 0.0, torch.clamp(divu_adv, min=0.0))
        # on a decomposed grid every block leaves the loop together
        done = global_all(ok)
        niter += 1
    timers.count("ridge_passes", niter)

    guard_rec = None
    if guards:
        # ridge_check (ice_mechred.F90:1788-1842): abort with the
        # failing cell if the iteration did not close the area sum
        from cice4_tpu_torch.guards import check_ridge
        asum_final = carry["aice0"] + carry["aicen"].sum(0)
        guard_rec = check_ridge(asum_final, tmask, done)

    state = state.replace(aicen=carry["aicen"], vicen=carry["vicen"],
                          vsnon=carry["vsnon"], eicen=carry["eicen"],
                          esnon=carry["esnon"], tsfcn=carry["tsfcn"],
                          trcrn=carry["trcrn"])
    dti = 1.0 / dt
    diag = dict(
        dardg1dt=carry["ardg1"] * dti, dardg2dt=carry["ardg2"] * dti,
        dvirdgdt=carry["virdg"] * dti, opening=carry["aopen"] * dti,
        fresh=carry["msnow_mlt"] * dti, fhocn=carry["esnow_mlt"] * dti,
        niter=niter,
    )
    if guard_rec is not None:
        diag["_guard"] = guard_rec
    return state, diag
