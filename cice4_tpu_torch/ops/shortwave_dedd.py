"""Delta-Eddington multiple-scattering shortwave radiation.

Port of :mod:`cice4_tpu.ops.shortwave_dedd`, the dEdd path of
``source/ice_shortwave.F90`` (Briegleb & Light 2007, NCAR/TN-472+STR):
snow grain/pond geometry (`shortwave_dEdd_set_snow:3467-3587`,
`set_pond:3597-3650`), per-band inherent optical property profiles
(`compute_dEdd:1796-2903`), and the two-stream layer-combination solution
(`solution_dEdd:2912-3457`).

Each surface type (bare, snow-covered, ponded) is a pass weighted by its
fractional coverage and summed. `_compute_dedd` is the JAX package's
masked dense pass; the driver gives it only the cells where the surface
type is present and the sun is up, gathered (the reference's compressed
cell lists), and scatters the results back: at gx1 about 12% of the
category cells are sunlit ice, and the dense pass took 63 ms of an
H100's time a step (PERF.md §6). Categories are a leading ``ncat`` axis
where the JAX package vmaps; layer outputs put the layer axis third from
last, ``(..., nlyr, ny, nx)``. Where the JAX package unrolls the 3
spectral bands and the 8 Gauss angles into separate vector code, the
port stacks them into tensor axes (bands first, then angles, before the
plane's axes), so each layer of the solution is one set of launches for
all of them; the layer recurrences stay sequential. Band constants are
Python floats and tensors of the input's dtype, so an f32 path stays
f32.
"""

from __future__ import annotations

import numpy as np
import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.config import RadiationConfig
from cice4_tpu_torch.ops._dedd_tables import Qs_tab, gs_tab, rsnw_tab, ws_tab

nspint = 3

# band-mean IOPs (compute_dEdd data blocks, ice_shortwave.F90:2240-2322)
ki_ssl_mn = (1000.1, 1003.7, 7042.0)
wi_ssl_mn = (0.9999, 0.9963, 0.9088)
gi_ssl_mn = (0.94, 0.94, 0.94)
ki_dl_mn = (100.2, 107.7, 1309.0)
wi_dl_mn = (0.998, 0.9287, 0.0305)
gi_dl_mn = (0.94, 0.94, 0.94)
ki_int_mn = (20.2, 27.7, 1445.0)
wi_int_mn = (0.9901, 0.7223, 0.0277)
gi_int_mn = (0.94, 0.94, 0.94)
ki_p_ssl_mn = (70.2, 77.7, 1309.0)
wi_p_ssl_mn = (0.9972, 0.9009, 0.0305)
gi_p_ssl_mn = (0.94, 0.94, 0.94)
ki_p_int_mn = (20.2, 27.7, 1445.0)
wi_p_int_mn = (0.9901, 0.7223, 0.0277)
gi_p_int_mn = (0.94, 0.94, 0.94)
kw = (0.2, 12.0, 729.0)
ww = (0.0, 0.0, 0.0)
gw = (0.0, 0.0, 0.0)

# tuning / geometry parameters
fp_ice, fm_ice = 0.15, 0.15
fp_pnd, fm_pnd = 2.00, 0.50
fr_max, fr_min = 1.00, 0.80
hs_ssl = 0.040
hi_ssl = 0.050
kalg = 0.60
hpmin, hp0 = 0.005, 0.200
refindx = 1.310
cp063, cp455 = 0.063, 0.455
trmin = 0.001
exp_min = float(np.exp(-10.0))
cp67, cp33, cp78, cp22, cp01 = 0.67, 0.33, 0.78, 0.22, 0.01

gauspt = (0.9894009, 0.9445750, 0.8656312, 0.7554044,
          0.6178762, 0.4580168, 0.2816036, 0.0950125)
gauswt = (0.0271525, 0.0622535, 0.0951585, 0.1246290,
          0.1495960, 0.1691565, 0.1826034, 0.1894506)

# snow grain / pond geometry (set_snow/set_pond)
hsmin, hs0 = 0.0001, 0.0300
rsnw_fresh, rsnw_nonmelt = 100.0, 500.0
rsnw_sig, rsnw_melt = 250.0, 1000.0


def _tuned_iops(R, fp, fm, k_mn, w_mn):
    """Scattering-coefficient tuning (``:2354-2424``) of one band."""
    f = fp if R >= 0 else fm
    sigp = max(k_mn * w_mn * (1.0 + f * R), 0.0)
    k = sigp + k_mn * (1.0 - w_mn)
    w = sigp / k
    return k, w


def _tuned_bands(R, fp, fm, k_mn, w_mn):
    """(k, w) of the 3 bands, each a tuple of Python floats."""
    kw_ = [_tuned_iops(R, fp, fm, k_mn[b], w_mn[b]) for b in range(nspint)]
    return tuple(k for k, _ in kw_), tuple(w for _, w in kw_)


def _bands(vals, like):
    """Per-band constants as a (3, 1, ..., 1) tensor like `like`."""
    return torch.tensor([float(v) for v in vals], dtype=like.dtype,
                        device=like.device).reshape((nspint,)
                                                    + (1,) * like.dim())


def _band_planes(planes, shape):
    """Per-band planes (each broadcastable to `shape`) stacked into a
    (3,) + shape tensor."""
    return torch.stack([p.expand(shape) for p in planes])


def set_snow(rad: RadiationConfig, aice, vsno, tsfcn):
    """Snow fraction, density, grain radius (``set_snow:3467-3587``)."""
    has = aice > cn.puny
    hs = torch.where(has, vsno / torch.clamp(aice, min=cn.puny), 0.0)
    fs = torch.where(hs < hsmin, 0.0,
                     torch.where(hs <= hs0, hs / hs0, 1.0))
    fs = torch.where(has, fs, 0.0)
    dTs = cn.Timelt - tsfcn
    fT = -torch.clamp(dTs / 1.0 - 1.0, max=0.0)
    rsnw_nm = min(max(rsnw_nonmelt - rad.R_snw * rsnw_sig, rsnw_fresh),
                  rsnw_melt)
    rsnw = torch.clamp(rsnw_nm + (rsnw_melt - rsnw_nm) * fT,
                       rsnw_fresh, rsnw_melt)
    rsnw = torch.where(has, rsnw, 0.0)
    rhosnw = torch.where(has, torch.full_like(aice, cn.rhos), 0.0)
    return fs, rhosnw, rsnw


def set_pond(aice, tsfcn, fs):
    """Parameterized melt-pond fraction/depth (``set_pond:3597-3650``)."""
    has = aice > cn.puny
    dTs = cn.Timelt - tsfcn
    fT = -torch.clamp(dTs / 1.0 - 1.0, max=0.0)
    fp = torch.where(has, 0.3 * fT * (1.0 - fs), 0.0)
    hp = torch.where(has, 0.3 * fT * (1.0 - fs), 0.0)
    return fp, hp


def _snow_iops(rsnw_eff, rhosnw):
    """Table interpolation of snow IOPs in grain radius (``:2455-2484``).
    Returns (ks, ws, gs), each (3,) + rsnw_eff.shape: one row a band."""
    dtype, device = rsnw_eff.dtype, rsnw_eff.device
    tab = torch.tensor(rsnw_tab, dtype=dtype, device=device)
    r = torch.clamp(rsnw_eff, float(rsnw_tab[0]), float(rsnw_tab[-1]))
    idx = torch.searchsorted(tab, r.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, len(rsnw_tab) - 2)
    r0 = tab[idx]
    r1 = tab[idx + 1]
    delr = torch.clamp((r - r0) / (r1 - r0), 0.0, 1.0)

    def interp(table):
        t = torch.tensor(table, dtype=dtype, device=device)
        return t[:, idx] * (1.0 - delr) + t[:, idx + 1] * delr

    Qs = interp(Qs_tab)
    ws = interp(ws_tab)
    gs = interp(gs_tab)
    ks = Qs * ((rhosnw / 917.0) * 3.0
               / (4.0 * torch.clamp(rsnw_eff, min=1.0) * 1.0e-6))
    return ks, ws, gs


def _dedd_layer(ts, ws, gs, mu):
    """Single-layer delta-Eddington solution.  `mu` carries a leading
    angle axis over the shape of `ts`.  Returns, at each cosine, the
    direct beam's transmission, reflectance and total transmittance."""
    lm = torch.sqrt(3.0 * (1.0 - ws) * (1.0 - ws * gs))
    ue = 1.5 * (1.0 - ws * gs) / torch.clamp(lm, min=cn.puny)
    extins = torch.clamp(torch.exp(-lm * ts), min=exp_min)
    ne = ((ue + 1.0) ** 2 / extins) - ((ue - 1.0) ** 2 * extins)
    rdif = (ue + 1.0) * (ue - 1.0) * (1.0 / extins - extins) / ne
    tdif = 4.0 * ue / ne
    trn = torch.clamp(torch.exp(-ts / mu), min=exp_min)
    denom = 1.0 - lm * lm * mu * mu
    tiny = torch.full_like(denom, cn.puny)
    denom = torch.where(denom.abs() < cn.puny,
                        torch.where(denom < 0.0, -tiny, tiny), denom)
    alp = 0.75 * ws * mu * (1.0 + gs * (1.0 - ws)) / denom
    gam = 0.5 * ws * ((1.0 + 3.0 * gs * (1.0 - ws) * mu * mu) / denom)
    apg = alp + gam
    amg = alp - gam
    rdr = amg * (tdif * trn - 1.0) + apg * rdif
    tdr = apg * tdif + (amg * rdif - (apg - 1.0)) * trn
    return trn, rdr, tdr


def _solution_dedd(tau, w0, g, albodr, albodf, mu0, kfrsnl):
    """Two-stream layer combination (``solution_dEdd:2912-3457``).

    tau/w0/g: (klev+1, ...), the layers first; `mu0` broadcasts against
    the trailing axes from the right.  kfrsnl: static int layer index of
    the Fresnel layer.  Returns interface arrays (klev+2, ...).
    """
    klev = tau.shape[0] - 1
    shape = tau.shape[1:]
    one = torch.ones(shape, dtype=tau.dtype, device=tau.device)
    zero = torch.zeros(shape, dtype=tau.dtype, device=tau.device)

    mu0 = torch.clamp(mu0, min=0.01)
    mu0n_refr = torch.sqrt(1.0 - (1.0 - mu0 * mu0) / (refindx * refindx))

    # the direct-beam cosine and the 8 Gauss points on a leading angle
    # axis, broadcasting against (angle,) + shape
    pad = (1,) * (len(shape) - mu0.dim())
    gpt = torch.tensor(gauspt, dtype=tau.dtype, device=tau.device)
    gpt = gpt.reshape((8,) + (1,) * mu0.dim()).expand((8,) + mu0.shape)
    gwt = torch.tensor(gauswt, dtype=tau.dtype, device=tau.device)
    gwt = gwt.reshape((8,) + (1,) * len(shape))

    def angles(mu):
        return torch.cat([mu.unsqueeze(0), gpt]).reshape(
            (9,) + pad + tuple(mu0.shape))

    angles_mu0, angles_refr = angles(mu0), angles(mu0n_refr)
    swt = sum(mu * wt for mu, wt in zip(gauspt, gauswt))

    trndir = [one]
    trntdr = [one]
    trndif = [one]
    rdndif = [zero]

    rdir_l = []
    rdif_a_l = []
    rdif_b_l = []
    tdir_l = []
    tdif_a_l = []
    tdif_b_l = []
    trnlay_l = []

    def down(k):
        """The interface k's downward terms from the layers above it."""
        refkm1 = 1.0 / (1.0 - rdndif[k - 1] * rdif_a_l[k - 1])
        tdrrdir = trndir[k - 1] * rdir_l[k - 1]
        tdndif = trntdr[k - 1] - trndir[k - 1]
        trndir.append(trndir[k - 1] * trnlay_l[k - 1])
        trntdr.append(trndir[k - 1] * tdir_l[k - 1]
                      + (tdndif + tdrrdir * rdndif[k - 1])
                      * refkm1 * tdif_a_l[k - 1])
        rdndif.append(rdif_b_l[k - 1]
                      + tdif_b_l[k - 1] * rdndif[k - 1]
                      * refkm1 * tdif_a_l[k - 1])
        trndif.append(trndif[k - 1] * refkm1 * tdif_a_l[k - 1])

    for k in range(klev + 1):
        if k > 0:
            down(k)

        active = trntdr[k] > trmin

        wtot = w0[k]
        gtot = g[k]
        ftot = gtot * gtot
        ts = (1.0 - wtot * ftot) * tau[k]
        ws_ = (1.0 - ftot) * wtot / torch.clamp(1.0 - wtot * ftot,
                                                 min=cn.puny)
        gs_ = (gtot - ftot) / torch.clamp(1.0 - ftot, min=cn.puny)
        ws_ = torch.clamp(ws_, max=1.0 - cn.puny)

        mus = angles_refr if k >= kfrsnl else angles_mu0
        trn, rdr, tdr = _dedd_layer(ts, ws_, gs_, mus)
        trnlay, rdir, tdir = trn[0], rdr[0], tdr[0]

        # angular re-integration of the diffuse terms (":3303-3320")
        rdif_a = (mus[1:] * rdr[1:] * gwt).sum(0) / swt
        tdif_a = (mus[1:] * tdr[1:] * gwt).sum(0) / swt
        rdif_b = rdif_a
        tdif_b = tdif_a

        if k == kfrsnl:
            # insert the Fresnel (refractive) interface (":3345-3393")
            R1 = (mu0 - refindx * mu0n_refr) / (mu0 + refindx * mu0n_refr)
            R2 = (refindx * mu0 - mu0n_refr) / (refindx * mu0 + mu0n_refr)
            T1 = 2.0 * mu0 / (mu0 + refindx * mu0n_refr)
            T2 = 2.0 * mu0 / (refindx * mu0 + mu0n_refr)
            Rf_dir_a = 0.5 * (R1 * R1 + R2 * R2)
            Tf_dir_a = 0.5 * (T1 * T1 + T2 * T2) * refindx * mu0n_refr / mu0
            Rf_dif_a, Tf_dif_a = cp063, 1.0 - cp063
            Rf_dif_b, Tf_dif_b = cp455, 1.0 - cp455

            rintfc = 1.0 / (1.0 - Rf_dif_b * rdif_a)
            tdir = Tf_dir_a * tdir \
                + Tf_dir_a * rdir * Rf_dif_b * rintfc * tdif_a
            rdir = Rf_dir_a + Tf_dir_a * rdir * rintfc * Tf_dif_b
            rdif_b = rdif_b + tdif_b * Rf_dif_b * rintfc * tdif_a
            rdif_a = Rf_dif_a + Tf_dif_a * rdif_a * rintfc * Tf_dif_b
            tdif_a_new = Tf_dif_a * rintfc * tdif_a
            tdif_b = tdif_b * rintfc * Tf_dif_b
            tdif_a = tdif_a_new
            trnlay = Tf_dir_a * trnlay

        # layers with no penetrating radiation stay opaque-zero
        rdir_l.append(torch.where(active, rdir, 0.0))
        rdif_a_l.append(torch.where(active, rdif_a, 0.0))
        rdif_b_l.append(torch.where(active, rdif_b, 0.0))
        tdir_l.append(torch.where(active, tdir, 0.0))
        tdif_a_l.append(torch.where(active, tdif_a, 0.0))
        tdif_b_l.append(torch.where(active, tdif_b, 0.0))
        trnlay_l.append(torch.where(active, trnlay, 0.0))

    # bottom interface (k = klevp)
    down(klev + 1)

    # combine upwards from the ocean (":3418-3443")
    rupdir = [None] * (klev + 2)
    rupdif = [None] * (klev + 2)
    rupdir[klev + 1] = albodr
    rupdif[klev + 1] = albodf
    for k in range(klev, -1, -1):
        refkp1 = 1.0 / (1.0 - rdif_b_l[k] * rupdif[k + 1])
        rupdir[k] = rdir_l[k] + (trnlay_l[k] * rupdir[k + 1]
                                 + (tdir_l[k] - trnlay_l[k])
                                 * rupdif[k + 1]) * refkp1 * tdif_b_l[k]
        rupdif[k] = rdif_a_l[k] + tdif_a_l[k] * rupdif[k + 1] \
            * refkp1 * tdif_b_l[k]

    return (torch.stack(trndir), torch.stack(trntdr), torch.stack(trndif),
            torch.stack(rupdir), torch.stack(rupdif), torch.stack(rdndif))


def _compute_dedd(rad: RadiationConfig, nilyr, nslyr, srftyp, active,
                  fnidr, coszen, swvdr, swvdf, swidr, swidf,
                  hs, rhosnw, rsnw, hi, hp):
    """One surface-type pass of ``compute_dEdd:1796-2903``, all bands at
    once.

    srftyp: static int (0 bare, 1 snow, 2 pond); active: the plane's
    mask; rhosnw/rsnw: one plane per snow layer.  The forcing planes
    (coszen, sw*, fnidr) broadcast against the plane from the right.
    Returns per-unit-area albedos and absorbed fluxes.
    """
    klev = nslyr + nilyr + 1
    shape = np.broadcast_shapes(tuple(hi.shape), tuple(coszen.shape))
    like = torch.zeros(shape, dtype=hi.dtype, device=hi.device)
    bshape = (nspint,) + tuple(shape)

    def B(vals):
        return _bands(vals, like)

    def full(vals):
        return B(vals).expand(bshape)

    wghtns2 = cp67 + (cp78 - cp67) * (1.0 - fnidr)
    wghtns3 = cp33 + (cp22 - cp33) * (1.0 - fnidr)

    kfrsnl = 0 if srftyp == 2 else nslyr + 2

    ki_ssl, wi_ssl = _tuned_bands(rad.R_ice, fp_ice, fm_ice, ki_ssl_mn,
                                  wi_ssl_mn)
    ki_dl, wi_dl = _tuned_bands(rad.R_ice, fp_ice, fm_ice, ki_dl_mn,
                                wi_dl_mn)
    ki_int, wi_int = _tuned_bands(rad.R_ice, fp_ice, fm_ice, ki_int_mn,
                                  wi_int_mn)
    ki_p_ssl, wi_p_ssl = _tuned_bands(rad.R_pnd, fp_pnd, fm_pnd,
                                      ki_p_ssl_mn, wi_p_ssl_mn)
    ki_p_int, wi_p_int = _tuned_bands(rad.R_pnd, fp_pnd, fm_pnd,
                                      ki_p_int_mn, wi_p_int_mn)

    taus = []
    w0s = []
    gs = []

    # --- layers above the sea ice (0 .. nslyr) ----------------------------
    if srftyp == 0:       # air
        for k in range(nslyr + 1):
            taus.append(like.expand(bshape))
            w0s.append(like.expand(bshape))
            gs.append(like.expand(bshape))
    elif srftyp == 1:     # snow
        dz = hs / nslyr
        dz_ssl = torch.clamp(dz / 2.0, max=hs_ssl)
        fr = fr_max * fnidr + fr_min * (1.0 - fnidr)
        for k in range(nslyr + 1):
            ksnow = 0 if k <= 1 else k - 1
            ks_, ws_, gs_ = _snow_iops(fr * rsnw[ksnow], rhosnw[ksnow])
            if k == 0:
                taus.append(ks_ * dz_ssl)
            elif k == 1:
                taus.append(ks_ * (dz - dz_ssl))
            else:
                taus.append(ks_ * dz)
            w0s.append(ws_ * torch.ones(bshape, dtype=like.dtype,
                                        device=like.device))
            gs.append(gs_ * torch.ones(bshape, dtype=like.dtype,
                                       device=like.device))
    else:                 # pond
        dz = hp / (nslyr + 1)
        for k in range(nslyr + 1):
            taus.append(B(kw) * dz)
            w0s.append(full(ww))
            gs.append(full(gw))

    # --- sea ice layers (kii .. klev) -------------------------------------
    dz = hi / nilyr
    dz_ssl = torch.where(hi < 1.5, hi / 30.0, hi_ssl)
    dz_ssl = torch.minimum(dz_ssl, dz / 2.0)
    fs_scale = nilyr / 4.0
    if srftyp <= 1:
        taus.append(B(ki_ssl) * dz_ssl)
        w0s.append(full(wi_ssl))
        gs.append(full(gi_ssl_mn))
        taus.append(B(ki_dl) * (dz - dz_ssl) * fs_scale)
        w0s.append(full(wi_dl))
        gs.append(full(gi_dl_mn))
        for k in range(nslyr + 3, klev):
            taus.append(B(ki_int) * dz)
            w0s.append(full(wi_int))
            gs.append(full(gi_int_mn))
        # lowest layer with algae absorption in the visible: the
        # visible band's coefficient adds it, the others add 0
        kabs = B([k * (1.0 - w) for k, w in zip(ki_int, wi_int)]) \
            + B((1.0, 0.0, 0.0)) * (kalg * (0.50 / torch.clamp(dz,
                                                               min=cn.puny)))
        sig = B([k * w for k, w in zip(ki_int, wi_int)])
        taus.append((kabs + sig) * dz)
        w0s.append(sig / (sig + kabs) * torch.ones(
            bshape, dtype=like.dtype, device=like.device))
        gs.append(full(gi_int_mn))
    else:                 # ponded ice column
        taus.append(B(ki_p_ssl) * dz_ssl)
        w0s.append(full(wi_p_ssl))
        gs.append(full(gi_p_ssl_mn))
        taus.append(B(ki_p_int) * (dz - dz_ssl))
        w0s.append(full(wi_p_int))
        gs.append(full(gi_p_int_mn))
        for k in range(nslyr + 3, klev + 1):
            taus.append(B(ki_p_int) * dz)
            w0s.append(full(wi_p_int))
            gs.append(full(gi_p_int_mn))
        # shallow-pond transition back toward bare-ice optics
        trans = (hp >= hpmin) & (hp <= hp0)
        frac = hp / hp0
        kii = nslyr + 1
        sig_i = B([k * w for k, w in zip(ki_ssl, wi_ssl)])
        sig_p = B([k * w for k, w in zip(ki_p_ssl, wi_p_ssl)])
        sig = sig_i + (sig_p - sig_i) * frac
        kext = sig + B([k * (1.0 - w) for k, w in zip(ki_p_ssl, wi_p_ssl)])
        taus[kii] = torch.where(trans, kext * dz_ssl, taus[kii])
        w0s[kii] = torch.where(trans, sig / kext, w0s[kii])
        sig_i = B([k * w * fs_scale for k, w in zip(ki_dl, wi_dl)])
        sig_p = B([k * w for k, w in zip(ki_p_int, wi_p_int)])
        sig = sig_i + (sig_p - sig_i) * frac
        kext_int = B([k * (1.0 - w) for k, w in zip(ki_p_int, wi_p_int)])
        kext = sig + kext_int
        taus[kii + 1] = torch.where(trans, kext * (dz - dz_ssl),
                                    taus[kii + 1])
        w0s[kii + 1] = torch.where(trans, sig / kext, w0s[kii + 1])
        sig_i = B([k * w for k, w in zip(ki_int, wi_int)])
        sig = sig_i + (sig_p - sig_i) * frac
        kext = sig + kext_int
        for k in range(kii + 2, klev + 1):
            taus[k] = torch.where(trans, kext * dz, taus[k])
            w0s[k] = torch.where(trans, sig / kext, w0s[k])

    tau = torch.stack(taus)
    w0 = torch.stack(w0s)
    g = torch.stack(gs)

    albodr = full((cp01, 0.0, 0.0))
    albodf = albodr

    trndir, trntdr, trndif, rupdir, rupdif, rdndif = _solution_dedd(
        tau, w0, g, albodr, albodf, coszen, kfrsnl)

    # interface fluxes (":2656-2680"), (klev+2, band) + shape
    refk = 1.0 / (1.0 - rdndif * rupdif)
    fdirup = (trndir * rupdir + (trntdr - trndir) * rupdif) * refk
    fdirdn = trndir + (trntdr - trndir
                       + trndir * rupdir * rdndif) * refk
    fdifup = trndif * rupdif * refk
    fdifdn = trndif * refk

    ksrf = 1 if srftyp == 1 else nslyr + 2
    klevp = klev + 1

    swdr = _band_planes((swvdr, swidr, swidr), shape)
    swdf = _band_planes((swvdf, swidf, swidf), shape)
    net = (fdirdn - fdirup) * swdr + (fdifdn - fdifup) * swdf

    def bandsum(x, dim=0):
        """The bands' sum weighted 1 (visible), wghtns2, wghtns3."""
        return x.select(dim, 0) + x.select(dim, 1) * wghtns2 \
            + x.select(dim, 2) * wghtns3

    avdr = rupdir[0, 0]
    avdf = rupdif[0, 0]
    aidr = rupdir[0, 1] * wghtns2 + rupdir[0, 2] * wghtns3
    aidf = rupdif[0, 1] * wghtns2 + rupdif[0, 2] * wghtns3

    fsfc = bandsum(net[0] - net[ksrf])
    fint = bandsum(net[ksrf] - net[klevp])
    fthru = bandsum(net[klevp])

    lshape = tuple(shape[:-2]) + (nslyr,) + tuple(shape[-2:])
    if srftyp == 1:
        Sabs = bandsum(net[1:nslyr + 1] - net[2:nslyr + 2], 1)
        Sabs = Sabs.movedim(0, -3)
    else:
        Sabs = torch.zeros(lshape, dtype=like.dtype, device=like.device)
    km = [nslyr + 2 + k for k in range(nilyr)]
    kp = [k + 1 for k in km]
    if srftyp == 1:
        km[0] -= 1
    Iabs = bandsum(net[km] - net[kp], 1).movedim(0, -3)

    m = active
    ml = m.unsqueeze(-3)
    return dict(
        avdr=torch.where(m, avdr, 0.0), avdf=torch.where(m, avdf, 0.0),
        aidr=torch.where(m, aidr, 0.0), aidf=torch.where(m, aidf, 0.0),
        fsfc=torch.where(m, fsfc, 0.0), fint=torch.where(m, fint, 0.0),
        fthru=torch.where(m, fthru, 0.0),
        Sabs=torch.where(ml, Sabs, 0.0), Iabs=torch.where(ml, Iabs, 0.0),
    )


def _compute_dedd_gathered(rad: RadiationConfig, nilyr, nslyr, srftyp,
                           active, fnidr, coszen, swvdr, swvdf, swidr, swidf,
                           hs, rhosnw, rsnw, hi, hp):
    """`_compute_dedd` on the active cells alone, as the reference's
    compressed cell lists have it: they are gathered into a (1, n) plane,
    and the results are scattered back with zeros elsewhere, which is what
    the dense pass's mask leaves there.  Each cell's arithmetic is the
    dense pass's.  Counting the cells waits for the device."""
    shape = active.shape
    idx = active.reshape(-1).nonzero().squeeze(1)
    n = idx.numel()

    def take(x):
        return x.expand(shape).reshape(-1)[idx].reshape(1, n)

    r = _compute_dedd(rad, nilyr, nslyr, srftyp, take(active), take(fnidr),
                      take(coszen), take(swvdr), take(swvdf), take(swidr),
                      take(swidf), take(hs), [take(v) for v in rhosnw],
                      [take(v) for v in rsnw], take(hi), take(hp))

    def put(v):
        lead = v.shape[:-2]         # the layer axis of Sabs and Iabs
        out = torch.zeros(lead + (active.numel(),), dtype=v.dtype,
                          device=v.device)
        out[..., idx] = v.reshape(lead + (n,))
        return out.reshape(lead + shape).movedim(0, -3) if lead \
            else out.reshape(shape)

    return {k: put(v) for k, v in r.items()}


def shortwave_dEdd(rad: RadiationConfig, nilyr, nslyr,
                   aicen, vicen, vsnon, tsfcn, coszen,
                   swvdr, swvdf, swidr, swidf,
                   apond=None, hpond=None):
    """Full dEdd driver (``shortwave_dEdd:1372-1787``), for one category
    plane or for all categories at once (leading ``ncat`` axis; the
    forcing planes and coszen broadcast).

    apond/hpond: explicit pond tracer fields (when tr_pond); otherwise
    the parameterized pond of `set_pond` is used.

    Returns the same dict keys as shortwave_ccsm3.
    """
    has = (aicen > cn.puny) & (coszen > cn.puny)
    a_s = torch.clamp(aicen, min=cn.puny)
    hi = torch.where(has, vicen / a_s, 0.0)
    hs = torch.where(has, vsnon / a_s, 0.0)

    fnidr = torch.where(swidr + swidf > cn.puny,
                        swidr / torch.clamp(swidr + swidf, min=cn.puny), 0.0)

    fs, rhosnw_v, rsnw_v = set_snow(rad, aicen, vsnon, tsfcn)
    if apond is not None and hpond is not None:
        fp_, hp_ = apond, hpond
        fp_ = torch.minimum(fp_, 1.0 - fs)
    else:
        fp_, hp_ = set_pond(aicen, tsfcn, fs)
    fp_ = torch.where(hp_ > hpmin, fp_, 0.0)
    fi = torch.clamp(1.0 - fs - fp_, min=0.0)

    rhosnw_l = [rhosnw_v] * nslyr
    rsnw_l = [rsnw_v] * nslyr

    zero = torch.zeros_like(aicen)
    lead = aicen.shape[:-2]

    def layers(n):
        return torch.zeros(lead + (n,) + aicen.shape[-2:], dtype=aicen.dtype,
                           device=aicen.device)

    tot = dict(alvdrn=zero, alvdfn=zero, alidrn=zero, alidfn=zero,
               fswsfc=zero, fswint=zero, fswthru=zero,
               Sswabs=layers(nslyr), Iswabs=layers(nilyr),
               albin=zero, albsn=zero, albpn=zero)

    for srftyp, frac in ((0, fi), (1, fs), (2, fp_)):
        active = has & (frac > 0.0)
        r = _compute_dedd_gathered(rad, nilyr, nslyr, srftyp, active,
                                   fnidr, coszen, swvdr, swvdf, swidr, swidf,
                                   hs, rhosnw_l, rsnw_l, hi, hp_)
        tot["alvdrn"] = tot["alvdrn"] + r["avdr"] * frac
        tot["alvdfn"] = tot["alvdfn"] + r["avdf"] * frac
        tot["alidrn"] = tot["alidrn"] + r["aidr"] * frac
        tot["alidfn"] = tot["alidfn"] + r["aidf"] * frac
        tot["fswsfc"] = tot["fswsfc"] + r["fsfc"] * frac
        tot["fswint"] = tot["fswint"] + r["fint"] * frac
        tot["fswthru"] = tot["fswthru"] + r["fthru"] * frac
        tot["Sswabs"] = tot["Sswabs"] + r["Sabs"] * frac.unsqueeze(-3)
        tot["Iswabs"] = tot["Iswabs"] + r["Iabs"] * frac.unsqueeze(-3)
        broadband = (cn.awtvdr * r["avdr"] + cn.awtidr * r["aidr"]
                     + cn.awtvdf * r["avdf"] + cn.awtidf * r["aidf"])
        key = {0: "albin", 1: "albsn", 2: "albpn"}[srftyp]
        tot[key] = tot[key] + broadband

    # aliases matching the ccsm3 interface
    for band in ("vdr", "idr", "vdf", "idf"):
        tot[f"al{band}ni"] = tot[f"al{band}n"]
        tot[f"al{band}ns"] = tot[f"al{band}n"]
    tot["asnow"] = fs
    return tot
