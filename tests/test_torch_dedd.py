"""The port's delta-Eddington shortwave, melt ponds and the small column
options against the JAX package, in f64 on the CPU.

The dEdd inputs are seeded (ncat, ny, nx) = (5, 24, 32) planes that cover
night, ice-free cells, thin ice, snow below `hsmin`, between `hsmin` and
`hs0` and above `hs0`, melting surfaces and ponds below, inside and above
the shallow-pond transition.  The JAX driver runs eagerly, one category
at a time (its model vmaps); recorders around its `_compute_dedd` and
`_solution_dedd` keep each call's inputs and outputs, so the port's
functions are held against the JAX functions on the very inputs the JAX
driver gave them, with the categories stacked on a leading axis.

Tolerance: |torch - jax| <= 1e-12 of each field's largest magnitude; the
two packages' `exp` and `sqrt` and the port's sum over the Gauss angles
may differ in the last bits.  `_solution_dedd`'s interface arrays are
held against the JAX values and against the JAX code run in extended
precision, beyond 1e-12 only by the f64 reference's own error
(`_close_conditioned`).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import model as jm
from cice4_tpu.config import RadiationConfig as JRad
from cice4_tpu.ops import _dedd_tables as jtab
from cice4_tpu.ops import atmo as jatmo
from cice4_tpu.ops import meltpond as jpond
from cice4_tpu.ops import ocean as jocean
from cice4_tpu.ops import shortwave as jsw
from cice4_tpu.ops import shortwave_dedd as jd
from cice4_tpu_torch import model as tm
from cice4_tpu_torch.config import RadiationConfig as TRad
from cice4_tpu_torch.ops import _dedd_tables as ttab
from cice4_tpu_torch.ops import atmo as tatmo
from cice4_tpu_torch.ops import meltpond as tpond
from cice4_tpu_torch.ops import ocean as tocean
from cice4_tpu_torch.ops import shortwave as tsw
from cice4_tpu_torch.ops import shortwave_dedd as td

torch.set_num_threads(1)
NCAT, NY, NX = 5, 24, 32
DT = 3600.0
LAYERS = [(4, 1), (7, 1), (4, 2)]
RTOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, name="", dtype=torch.float64):
    if isinstance(want, dict):
        assert set(want) == set(got), name
        for k in want:
            _close(got[k], want[k], f"{name}.{k}", dtype)
        return
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor), name
    if want.dtype == bool:
        assert got.dtype == torch.bool, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        return
    assert got.dtype == dtype, (name, got.dtype)
    got = got.numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(want).all() and np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_array_less(np.abs(got - want), RTOL * scale + 1e-300,
                                 err_msg=name)


def _solution_extended(args, mu0, kfrsnl, monkeypatch):
    """The JAX package's own `_solution_dedd` evaluated by numpy in
    extended precision (64-bit significands): its code calls nothing but
    elementwise `jnp` functions that numpy has too."""
    with monkeypatch.context() as m:
        m.setattr(jd, "jnp", np)
        out = jd._solution_dedd(*(np.asarray(a, np.longdouble)
                                  for a in args),
                                np.asarray(mu0, np.longdouble), kfrsnl)
    return [np.asarray(o, np.longdouble) for o in out]


def _close_conditioned(got, want, exact, name):
    """`got` within RTOL of the field's scale of the f64 reference `want`
    and of the extended-precision value `exact` of the same formula, but
    for the f64 reference's own rounding error |want - exact|.  Near the
    removable pole of the direct-beam solution (1 - (lm mu)^2 -> 0 at a
    Gauss angle) the formula amplifies last-bit differences of `exp` and
    `sqrt` beyond 1e-12 of scale at a few seeded cells (trntdr, snow,
    near-IR band), for the JAX f64 value as for the port's.  Elsewhere
    `own` is at roundoff and this is the plain 1e-12 test."""
    assert got.dtype == torch.float64, name
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == exact.shape, name
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    scale = max(float(np.abs(want).max()), 1e-300)
    own = np.abs(want - exact).astype(np.float64)
    limit = RTOL * scale + own + 1e-300
    np.testing.assert_array_less(np.abs(got - want), limit, err_msg=name)
    np.testing.assert_array_less(np.abs(got - exact).astype(np.float64),
                                 limit, err_msg=name)


def _inputs(seed=7):
    """Seeded planes of every case the dEdd branches tell apart."""
    rng = np.random.RandomState(seed)
    sh = (NCAT, NY, NX)
    aice = rng.uniform(0.05, 0.6, sh)
    aice[:, :3] = 0.0                                      # ice free
    aice[:, 3, :8] = 1e-12                                 # below puny
    hi = rng.choice([0.05, 0.3, 1.2, 2.0, 4.5], sh)        # thin to thick
    hs = rng.choice([0.0, 5e-5, 0.01, 0.025, 0.1, 0.4], sh)
    tsfc = rng.uniform(-25.0, -1.5, sh)
    melt = rng.rand(*sh) < 0.35
    tsfc[melt] = rng.choice([0.0, -0.2, -0.8], int(melt.sum()))
    coszen = rng.uniform(0.02, 0.9, (NY, NX))
    coszen[:, :5] = rng.uniform(-0.3, 0.0, (NY, 5))        # night
    sw = [rng.uniform(20.0, 250.0, (NY, NX)) for _ in range(4)]
    sw[3][0, :4] = 0.0                                     # no near-IR
    sw[2][0, :4] = 0.0
    apond = rng.uniform(0.0, 0.9, sh)
    hpond = rng.choice([0.0, 0.003, 0.05, 0.15, 0.3], sh)  # hpmin, hp0
    return dict(aicen=aice, vicen=aice * hi, vsnon=aice * hs, tsfcn=tsfc,
                coszen=coszen, swvdr=sw[0], swvdf=sw[1], swidr=sw[2],
                swidf=sw[3], apond=apond, hpond=hpond)


def _jax_dedd(nilyr, nslyr, x, ponds, monkeypatch):
    """JAX shortwave_dEdd one category at a time, eagerly; returns the
    categories' outputs stacked and the recorded calls of _compute_dedd
    and _solution_dedd, each {key: [per category]}."""
    calls = {"compute": {}, "solution": {}}

    def record(kind, fn, key):
        def run(*args):
            out = fn(*args)
            calls[kind].setdefault(key(args), []).append((args, out))
            return out
        return run

    monkeypatch.setattr(jd, "_compute_dedd", record(
        "compute", jd._compute_dedd, lambda a: a[3]))
    count = [0]

    def solution_key(args):
        # each category calls it for srftyp 0, 1, 2, each for 3 bands
        n = count[0]
        count[0] += 1
        return (n // 3) % 3, n % 3

    monkeypatch.setattr(jd, "_solution_dedd", record(
        "solution", jd._solution_dedd, solution_key))
    outs = []
    for c in range(NCAT):
        cat = {k: jnp.asarray(x[k][c]) for k in
               ("aicen", "vicen", "vsnon", "tsfcn", "apond", "hpond")}
        outs.append(jd.shortwave_dEdd(
            JRad(), nilyr, nslyr, cat["aicen"], cat["vicen"], cat["vsnon"],
            cat["tsfcn"], jnp.asarray(x["coszen"]),
            *(jnp.asarray(x[k]) for k in ("swvdr", "swvdf", "swidr",
                                          "swidf")),
            apond=cat["apond"] if ponds else None,
            hpond=cat["hpond"] if ponds else None))
    monkeypatch.undo()
    stacked = {k: np.stack([np.asarray(o[k]) for o in outs])
               for k in outs[0]}
    return stacked, calls


def _stack(per_cat):
    """[per category] of arrays, lists of arrays or scalars -> stacked."""
    first = per_cat[0]
    if isinstance(first, (list, tuple)):
        return [_stack([p[i] for p in per_cat]) for i in range(len(first))]
    if np.ndim(first) == 0:
        return first
    return np.stack([np.asarray(p) for p in per_cat])


def test_tables_are_a_copy():
    for name in ("rsnw_tab", "Qs_tab", "ws_tab", "gs_tab"):
        a, b = getattr(ttab, name), getattr(jtab, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_band_constants_are_a_copy():
    for name in ("ki_ssl_mn", "wi_ssl_mn", "gi_ssl_mn", "ki_dl_mn",
                 "wi_dl_mn", "gi_dl_mn", "ki_int_mn", "wi_int_mn",
                 "gi_int_mn", "ki_p_ssl_mn", "wi_p_ssl_mn", "gi_p_ssl_mn",
                 "ki_p_int_mn", "wi_p_int_mn", "gi_p_int_mn", "kw", "ww",
                 "gw", "gauspt", "gauswt"):
        assert tuple(getattr(jd, name)) == getattr(td, name), name
    for name in ("fp_ice", "fm_ice", "fp_pnd", "fm_pnd", "fr_max", "fr_min",
                 "hs_ssl", "hi_ssl", "kalg", "hpmin", "hp0", "refindx",
                 "cp063", "cp455", "trmin", "exp_min", "cp67", "cp33",
                 "cp78", "cp22", "cp01", "hsmin", "hs0", "rsnw_fresh",
                 "rsnw_nonmelt", "rsnw_sig", "rsnw_melt"):
        assert getattr(jd, name) == getattr(td, name), name
    for name in ("hicemin", "Td", "rfrac", "rexp", "dpthhi", "dpthfrac"):
        assert getattr(jpond, name) == getattr(tpond, name), name


@pytest.mark.parametrize("R_snw", [0.0, 1.5, -2.0])
def test_set_snow_and_pond(R_snw):
    x = _inputs()
    want = jd.set_snow(JRad(R_snw=R_snw), jnp.asarray(x["aicen"]),
                       jnp.asarray(x["vsnon"]), jnp.asarray(x["tsfcn"]))
    got = td.set_snow(TRad(R_snw=R_snw), _t(x["aicen"]), _t(x["vsnon"]),
                      _t(x["tsfcn"]))
    for name, g, w in zip(("fs", "rhosnw", "rsnw"), got, want):
        _close(g, w, name)
    fs = np.asarray(want[0])
    assert 0.0 < fs.mean() < 1.0 and ((fs > 0) & (fs < 1)).any()
    want = jd.set_pond(jnp.asarray(x["aicen"]), jnp.asarray(x["tsfcn"]),
                       want[0])
    got = td.set_pond(_t(x["aicen"]), _t(x["tsfcn"]), got[0])
    for name, g, w in zip(("fp", "hp"), got, want):
        _close(g, w, name)


def test_snow_iops():
    rng = np.random.RandomState(3)
    r = rng.uniform(-10.0, 3000.0, (NCAT, NY, NX))
    r[0, 0, :32] = ttab.rsnw_tab                 # every table radius
    rho = rng.choice([0.0, 330.0], (NCAT, NY, NX))
    got = td._snow_iops(_t(r), _t(rho))
    for ns in range(td.nspint):
        want = jd._snow_iops(ns, jnp.asarray(r), jnp.asarray(rho))
        for name, g, w in zip(("ks", "ws", "gs"), got, want):
            _close(g[ns], w, f"{name}[{ns}]")


@pytest.mark.parametrize("ponds", [True, False], ids=["ponds", "no_ponds"])
@pytest.mark.parametrize("layers", LAYERS, ids=lambda v: f"{v[0]}x{v[1]}")
def test_dedd_matches_jax(layers, ponds, monkeypatch):
    """_solution_dedd and _compute_dedd of each surface type on the inputs
    the JAX driver gave its own, and the whole driver."""
    nilyr, nslyr = layers
    x = _inputs()
    want, calls = _jax_dedd(nilyr, nslyr, x, ponds, monkeypatch)

    assert len(calls["solution"]) == 3 * 3      # surface types x bands
    for (srftyp, band), recs in calls["solution"].items():
        assert len(recs) == NCAT
        mu0, kfrsnl = recs[0][0][5:]
        # the layer stacks take the categories second, the ocean
        # albedos first
        args = [np.stack([np.asarray(r[0][i]) for r in recs],
                         axis=1 if i < 3 else 0) for i in range(5)]
        got = td._solution_dedd(*(_t(a) for a in args), _t(mu0), kfrsnl)
        exact = _solution_extended(args, mu0, kfrsnl, monkeypatch)
        for i, name in enumerate(("trndir", "trntdr", "trndif", "rupdir",
                                  "rupdif", "rdndif")):
            w = np.stack([np.asarray(r[1][i]) for r in recs], axis=1)
            _close_conditioned(got[i], w, exact[i],
                               f"solution srftyp {srftyp} band {band} "
                               f"{name}")

    assert sorted(calls["compute"]) == [0, 1, 2]
    for srftyp, recs in calls["compute"].items():
        a = _stack([r[0] for r in recs])
        (rad, nl, ns, st, active, fnidr, coszen, swvdr, swvdf, swidr,
         swidf, hs, rhosnw, rsnw, hi, hp) = a
        got = td._compute_dedd(
            TRad(), nl, ns, st, _t(active), _t(fnidr[0]), _t(coszen[0]),
            _t(swvdr[0]), _t(swvdf[0]), _t(swidr[0]), _t(swidf[0]), _t(hs),
            [_t(v) for v in rhosnw], [_t(v) for v in rsnw], _t(hi), _t(hp))
        w = {k: np.stack([np.asarray(r[1][k]) for r in recs])
             for k in recs[0][1]}
        _close(got, w, f"compute srftyp {srftyp}")
        assert w["fsfc"].max() > 0.0 and active.any(), srftyp

    got = td.shortwave_dEdd(
        TRad(), nilyr, nslyr, *(_t(x[k]) for k in (
            "aicen", "vicen", "vsnon", "tsfcn", "coszen", "swvdr", "swvdf",
            "swidr", "swidf")),
        apond=_t(x["apond"]) if ponds else None,
        hpond=_t(x["hpond"]) if ponds else None)
    _close(got, want, "shortwave_dEdd")
    assert want["Sswabs"].max() > 0.0 and want["albpn"].max() > 0.0


@pytest.mark.parametrize("ponds", [True, False], ids=["ponds", "no_ponds"])
def test_energy_closure(ponds):
    """Per category, absorbed + reflected shortwave equals the incoming
    where the sun is up over ice, as `tests/test_dedd.py` holds it for
    JAX; the interior absorption holds the layers' absorption."""
    x = _inputs()
    t = {k: _t(v) for k, v in x.items()}
    o = td.shortwave_dEdd(TRad(), 4, 1, t["aicen"], t["vicen"], t["vsnon"],
                          t["tsfcn"], t["coszen"], t["swvdr"], t["swvdf"],
                          t["swidr"], t["swidf"],
                          apond=t["apond"] if ponds else None,
                          hpond=t["hpond"] if ponds else None)
    absorbed = o["fswsfc"] + o["fswint"] + o["fswthru"]
    reflected = (o["alvdrn"] * t["swvdr"] + o["alvdfn"] * t["swvdf"]
                 + o["alidrn"] * t["swidr"] + o["alidfn"] * t["swidf"])
    incoming = t["swvdr"] + t["swvdf"] + t["swidr"] + t["swidf"]
    lit = (t["aicen"] > 1e-11) & (t["coszen"] > 1e-11)
    assert int(lit.sum()) > 1000
    for n in range(NCAT):
        m = lit[n]
        err = (absorbed[n] + reflected[n] - incoming)[m].abs().max()
        assert float(err) < 1e-9, n
    assert float(absorbed[~lit].abs().max()) == 0.0
    layers = o["Sswabs"].sum(-3) + o["Iswabs"].sum(-3)
    assert float(layers.min()) >= 0.0
    assert float((layers - o["fswint"]).abs().max()) <= 1e-9


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dedd_keeps_dtype(dtype):
    x = _inputs()
    t = {k: _t(v).to(dtype) for k, v in x.items()}
    o = td.shortwave_dEdd(TRad(), 4, 1, t["aicen"], t["vicen"], t["vsnon"],
                          t["tsfcn"], t["coszen"], t["swvdr"], t["swvdf"],
                          t["swidr"], t["swidf"], apond=t["apond"],
                          hpond=t["hpond"])
    for k, v in o.items():
        assert v.dtype == dtype, k
        assert bool(torch.isfinite(v).all()), k
    alb = torch.stack([o[k] for k in ("alvdrn", "alvdfn", "alidrn",
                                      "alidfn")])
    assert float(alb.min()) >= 0.0 and float(alb.max()) <= 1.0


def test_dedd_at_night_is_zero():
    """No sunlit cell: every pass gathers no cell, every flux and albedo
    is zero, as the JAX package's masks leave them."""
    x = _inputs()
    t = {k: _t(v) for k, v in x.items()}
    o = td.shortwave_dEdd(TRad(), 4, 1, t["aicen"], t["vicen"], t["vsnon"],
                          t["tsfcn"], -t["coszen"].abs(), t["swvdr"],
                          t["swvdf"], t["swidr"], t["swidf"],
                          apond=t["apond"], hpond=t["hpond"])
    for k, v in o.items():
        if k != "asnow":
            assert float(v.abs().max()) == 0.0, k


def test_compute_ponds():
    rng = np.random.RandomState(5)
    sh = (NCAT, NY, NX)
    aice = rng.uniform(0.0, 0.9, sh)
    aice[:, :2] = 0.0
    hi = rng.choice([0.05, 0.5, 2.0], sh)
    hs = rng.choice([0.0, 0.0, 0.1], sh)
    args = (rng.uniform(0.0, 0.02, sh), rng.uniform(0.0, 0.01, sh),
            rng.uniform(0.0, 1e-4, (NY, NX)), aice, aice * hi, aice * hs,
            rng.uniform(-10.0, 0.0, sh), rng.uniform(0.0, 0.2, sh))
    want = jpond.compute_ponds(DT, *(jnp.asarray(a) for a in args))
    got = tpond.compute_ponds(DT, *(_t(a) for a in args))
    for name, g, w in zip(("volpn", "apondn", "hpondn"), got, want):
        _close(g, w, name)
    assert float(got[1].max()) > 0.0 and float(got[0].max()) > 0.0
    # the radiation's pond geometry (cice4_tpu/model.py _step_radiation)
    vol = jnp.asarray(args[-1])
    ap = jnp.minimum(jnp.sqrt(jnp.maximum(vol, 0.0) / jpond.dpthfrac), 1.0)
    ga, gh = tpond.pond_geometry(_t(args[-1]))
    _close(ga, ap, "apond")
    _close(gh, jpond.dpthfrac * ap, "hpond")


def test_constant_albedos_and_ccsm3():
    x = _inputs()
    rad = JRad(albedo_type="constant")
    want = jsw.constant_albedos(rad, *(jnp.asarray(x[k]) for k in
                                       ("aicen", "vsnon", "tsfcn")))
    got = tsw.constant_albedos(TRad(albedo_type="constant"),
                               *(_t(x[k]) for k in ("aicen", "vsnon",
                                                    "tsfcn")))
    _close(got, want, "constant_albedos")
    sw = ("swvdr", "swvdf", "swidr", "swidf")
    want = [jsw.shortwave_ccsm3(rad, 4, 1, True,
                                *(jnp.asarray(x[k][c]) for k in
                                  ("aicen", "vicen", "vsnon", "tsfcn")),
                                *(jnp.asarray(x[k]) for k in sw))
            for c in range(NCAT)]
    got = tsw.shortwave_ccsm3(TRad(albedo_type="constant"), 4, 1, True,
                              *(_t(x[k]) for k in ("aicen", "vicen",
                                                   "vsnon", "tsfcn")),
                              *(_t(x[k]) for k in sw))
    _close(got, {k: np.stack([np.asarray(w[k]) for w in want])
                 for k in want[0]}, "shortwave_ccsm3 constant")


@pytest.mark.parametrize("calc_strair", [True, False])
@pytest.mark.parametrize("sfctype", ["ice", "ocn"])
def test_atmo_boundary_const(sfctype, calc_strair):
    rng = np.random.RandomState(9)
    args = [rng.uniform(-10.0, 10.0, (NY, NX)),
            rng.uniform(-10.0, 10.0, (NY, NX)),
            rng.uniform(0.0, 15.0, (NY, NX)),
            rng.uniform(1.2, 1.4, (NY, NX))]
    want = jatmo.atmo_boundary_const(sfctype, *(jnp.asarray(a) for a in args),
                                     calc_strair)
    got = tatmo.atmo_boundary_const(sfctype, *(_t(a) for a in args),
                                    calc_strair)
    _close(got, want, f"atmo_boundary_const {sfctype}")


def test_ocean_mixed_layer_constant_boundary():
    rng = np.random.RandomState(4)
    sh = (NY, NX)
    tmask = rng.rand(*sh) > 0.1
    args = [rng.uniform(0.0, 1.0, sh), rng.uniform(-1.8, 2.0, sh),
            np.full(sh, -1.836), rng.uniform(-5.0, 5.0, sh),
            rng.uniform(10.0, 30.0, sh), rng.uniform(-8.0, 8.0, sh),
            rng.uniform(-8.0, 8.0, sh), rng.uniform(0.0, 12.0, sh),
            np.full(sh, 10.0), rng.uniform(250.0, 275.0, sh),
            rng.uniform(1e-4, 4e-3, sh), rng.uniform(1.2, 1.4, sh),
            rng.uniform(150.0, 300.0, sh)] \
        + [rng.uniform(0.0, 200.0, sh) for _ in range(4)] \
        + [rng.uniform(-20.0, 5.0, sh), rng.uniform(0.0, 5.0, sh)]
    want = jocean.ocean_mixed_layer(DT, jnp.asarray(tmask),
                                    *(jnp.asarray(a) for a in args),
                                    atmbndy="constant")
    got = tocean.ocean_mixed_layer(DT, _t(tmask), *(_t(a) for a in args),
                                   atmbndy="constant")
    _close(got, want, "ocean_mixed_layer constant")


def test_prep_radiation():
    rng = np.random.RandomState(6)
    sh, nslyr, nilyr = (NCAT, NY, NX), 1, 4
    aice = rng.uniform(0.0, 0.2, sh)
    aice[:, :2] = 0.0
    scale = rng.uniform(0.0, 300.0, (NY, NX))
    scale[3, :5] = 0.0
    swn = dict(fswsfcn=rng.uniform(0, 50, sh), fswintn=rng.uniform(0, 9, sh),
               fswthrun=rng.uniform(0, 5, sh),
               Sswabsn=rng.uniform(0, 3, (NCAT, nslyr, NY, NX)),
               Iswabsn=rng.uniform(0, 3, (NCAT, nilyr, NY, NX)),
               **{k: rng.uniform(0.05, 0.9, (NY, NX))
                  for k in ("alvdr_gbm", "alvdf_gbm", "alidr_gbm",
                            "alidf_gbm")})
    f = {k: rng.uniform(0.0, 250.0, (NY, NX))
         for k in ("swvdr", "swvdf", "swidr", "swidf")}

    def ns(conv, **kw):
        return types.SimpleNamespace(**{k: conv(v) if not isinstance(v, dict)
                                        else {kk: conv(vv)
                                              for kk, vv in v.items()}
                                        for k, v in kw.items()})

    want = jm._prep_radiation(None, ns(jnp.asarray, aicen=aice,
                                       scale_factor=scale, swn=swn),
                              ns(jnp.asarray, **f))
    got = tm._prep_radiation(None, ns(_t, aicen=aice, scale_factor=scale,
                                      swn=swn), ns(_t, **f))
    _close(got, want, "prep_radiation")
    assert float(got["fswfac"].max()) > 1.0
