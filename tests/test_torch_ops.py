"""Column operators of the port against the JAX package, one by one, in
f64 on the CPU, on a perturbed 24x32 slice state whose category
thicknesses straddle the category bounds (so rebinning, shifting and
remapping all move ice).  Ridging runs with nonzero convergence and
shear, which the thermo-only step never drives.

Tolerance: rtol 1e-12 against each field's largest magnitude; the two
packages' `exp`, `pow`, `cumsum` and sums may differ in the last bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import grid as jg
from cice4_tpu import guards as jguards
from cice4_tpu import state as js
from cice4_tpu.config import gx1_config
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu.ops import atmo as jatmo
from cice4_tpu.ops import itd as jitd
from cice4_tpu.ops import mechred as jmech
from cice4_tpu.ops import ocean as jocean
from cice4_tpu.ops import orbital as jorb
from cice4_tpu.ops import shortwave as jsw
from cice4_tpu.ops import therm_itd as jtitd
from cice4_tpu.ops import therm_vertical as jtv
from cice4_tpu_torch import config as tcfg
from cice4_tpu_torch import convert
from cice4_tpu_torch import guards as tguards
from cice4_tpu_torch import state as ts
from cice4_tpu_torch.ops import atmo as tatmo
from cice4_tpu_torch.ops import itd as titd
from cice4_tpu_torch.ops import mechred as tmech
from cice4_tpu_torch.ops import ocean as tocean
from cice4_tpu_torch.ops import orbital as torb
from cice4_tpu_torch.ops import shortwave as tsw
from cice4_tpu_torch.ops import therm_itd as ttitd
from cice4_tpu_torch.ops import therm_vertical as ttv

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
SLICE = {"grid.kmt_file": "", "dynamics.kdyn": 0,
         "transport.advection": "none",
         "domain.ny_global": 24, "domain.nx_global": 32}
DT = 3600.0


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, name=""):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), name
        for k in want:
            _close(got[k], want[k], f"{name}.{k}")
        return
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool or want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale,
                               err_msg=name)


def _close_state(tst, jst):
    for f in dataclasses.fields(jst):
        _close(getattr(tst, f.name), getattr(jst, f.name), f.name)


def _to_torch_state(jst):
    arrays = {f.name: (getattr(jst, f.name) if not isinstance(
        getattr(jst, f.name), dict) else dict(getattr(jst, f.name)))
        for f in dataclasses.fields(jst)}
    arrays = jax.tree_util.tree_map(np.asarray, arrays)
    return convert.state_from_arrays(arrays, device=CPU, dtype=F64)


@pytest.fixture(scope="module")
def case():
    """JAX config/grid/itd, a perturbed JAX state and its torch twin, the
    port's config/itd, and a JAX forcing."""
    jcfg = gx1_config().with_values(**SLICE, **{"tracers.tr_lvl": True})
    tcf = tcfg.gx1_config().with_values(**SLICE, **{"tracers.tr_lvl": True})
    grid = jg.make_grid(jcfg, dtype=jnp.float64)
    itd = js.make_itd_params(jcfg)
    st = js.init_state(jcfg, grid, itd, dtype=jnp.float64)
    rng = np.random.RandomState(5)
    ncat, ny, nx = st.aicen.shape
    ice = np.asarray(st.aicen) > 0
    a = np.where(ice, rng.uniform(0.02, 0.2, (ncat, ny, nx)), 0.0)
    a[0] = np.where(ice[0] & (rng.rand(ny, nx) < 0.1), 5e-12, a[0])
    h = rng.uniform(0.0, 1.4, (ncat, ny, nx)) * (itd.hin_max[1:, None, None]
                                                  + 0.5)
    scale = np.where(a > 0, h * a / np.maximum(np.asarray(st.vicen), 1e-30),
                     0.0)
    st = st.replace(
        aicen=jnp.asarray(a), vicen=jnp.asarray(h * a),
        vsnon=st.vsnon * scale,
        eicen=st.eicen * scale[:, None], esnon=st.esnon * scale[:, None],
        trcrn={k: jnp.asarray(np.where(a > 0, rng.uniform(0.2, 1.0, a.shape),
                                       0.0)) for k in st.trcrn},
        frzmlt=jnp.asarray(rng.uniform(-50.0, 50.0, (ny, nx))),
        sst=st.sst + jnp.asarray(rng.uniform(0.0, 0.5, (ny, nx))),
        strocnxT=jnp.asarray(rng.uniform(-0.1, 0.1, (ny, nx))),
        strocnyT=jnp.asarray(rng.uniform(-0.1, 0.1, (ny, nx))))
    f = JAnalytic(jcfg, grid, jnp.float64)(172.0, 0.0)
    return dict(jcfg=jcfg, tcfg=tcf, grid=grid, itd=itd,
                titd=ts.make_itd_params(tcf), jst=st, tst=_to_torch_state(st),
                f=f, tmask=np.asarray(grid.tmask))


def test_aggregate(case):
    _close(titd.aggregate(case["tst"], _t(case["tmask"])),
           jitd.aggregate(case["jst"], case["grid"].tmask))
    _close(titd.column_sums(case["tst"]), jitd.column_sums(case["jst"]))


def test_rebin_and_cleanup(case):
    _close_state(titd.rebin(case["tst"], case["titd"]),
                 jitd.rebin(case["jst"], case["itd"]))
    tst, tz = titd.cleanup_itd(case["tst"], case["titd"], _t(case["tmask"]),
                               DT)
    jst, jz = jitd.cleanup_itd(case["jst"], case["itd"], case["grid"].tmask,
                               DT)
    _close_state(tst, jst)
    _close(tz, jz)


def test_shift_ice_random_donors(case):
    rng = np.random.RandomState(9)
    ncat, ny, nx = case["jst"].aicen.shape
    donor = rng.randint(-1, 2, (ncat - 1, ny, nx)).astype(np.int32)
    da = rng.uniform(0.0, 0.1, donor.shape)
    dv = rng.uniform(0.0, 0.2, donor.shape)
    _close_state(titd.shift_ice(case["tst"], _t(donor), _t(da), _t(dv)),
                 jitd.shift_ice(case["jst"], jnp.asarray(donor),
                                jnp.asarray(da), jnp.asarray(dv)))


def test_linear_itd(case):
    rng = np.random.RandomState(2)
    jst = case["jst"]
    grow = rng.uniform(0.9, 1.1, jst.vicen.shape)
    jst2 = jst.replace(vicen=jst.vicen * grow)
    tst2 = _to_torch_state(jst2)
    _close_state(
        ttitd.linear_itd(tst2, case["titd"], case["tst"].aicen,
                         case["tst"].vicen),
        jtitd.linear_itd(jst2, case["itd"], jst.aicen, jst.vicen))


def test_add_new_ice_and_lateral_melt(case):
    jst, tst = case["jst"], case["tst"]
    tmask = case["tmask"]
    Tf = -1.836 * np.ones(tmask.shape)
    for cfg_over in ({}, {"thermo.update_ocn_f": True}):
        jcfg = case["jcfg"].with_values(**cfg_over)
        tcf = case["tcfg"].with_values(**cfg_over)
        jout = jtitd.add_new_ice(jst, case["itd"], jcfg, DT, jst.frzmlt,
                                 jnp.asarray(Tf), jnp.asarray(tmask))
        tout = ttitd.add_new_ice(tst, case["titd"], tcf, DT, tst.frzmlt,
                                 _t(Tf), _t(tmask))
        _close_state(tout[0], jout[0])
        _close(tout[1], jout[1])
    rside = np.random.RandomState(3).uniform(0.0, 0.3, tmask.shape)
    jout = jtitd.lateral_melt(jst, case["itd"], DT, jnp.asarray(rside))
    tout = ttitd.lateral_melt(tst, case["titd"], DT, _t(rside))
    _close_state(tout[0], jout[0])
    _close(tout[1], jout[1])


@pytest.mark.parametrize("partic,redist", [(1, 1), (0, 0), (1, 0)])
def test_ridge_ice_with_convergence(case, partic, redist):
    over = {"dynamics.krdg_partic": partic, "dynamics.krdg_redist": redist}
    jdyn = case["jcfg"].with_values(**over).dynamics
    tdyn = case["tcfg"].with_values(**over).dynamics
    rng = np.random.RandomState(4)
    shape = case["tmask"].shape
    conv = rng.uniform(0.0, 2e-6, shape)
    shear = rng.uniform(0.0, 2e-6, shape)
    jst, jd = jmech.ridge_ice(case["jst"], case["itd"], jdyn, DT,
                              jnp.asarray(conv), jnp.asarray(shear),
                              case["grid"].tmask, guards=True)
    tst, td = tmech.ridge_ice(case["tst"], case["titd"], tdyn, DT,
                              _t(conv), _t(shear), _t(case["tmask"]),
                              guards=True)
    _close_state(tst, jst)
    assert td["niter"] == int(jd["niter"])
    for k in ("dardg1dt", "dardg2dt", "dvirdgdt", "opening", "fresh",
              "fhocn"):
        _close(td[k], jd[k], k)
    if partic == 1:  # Thorndike's G* = 0.15 leaves open water unridged
        assert float(td["dardg1dt"].max()) > 0.0
    assert int(td["_guard"]["count"]) == int(jd["_guard"]["count"])


def test_radiation_and_boundary_layer(case):
    jst, tst, f = case["jst"], case["tst"], case["f"]
    rad = case["jcfg"].radiation
    want = jax.vmap(lambda a, v, vs, t: jsw.shortwave_ccsm3(
        rad, 4, 1, True, a, v, vs, t, f.swvdr, f.swvdf, f.swidr, f.swidf))(
        jst.aicen, jst.vicen, jst.vsnon, jst.tsfcn)
    got = tsw.shortwave_ccsm3(case["tcfg"].radiation, 4, 1, True, tst.aicen,
                              tst.vicen, tst.vsnon, tst.tsfcn, _t(f.swvdr),
                              _t(f.swvdf), _t(f.swidr), _t(f.swidf))
    _close(got, want)
    grid = case["grid"]
    for yday, sec in ((80.0, 0.0), (172.0, 43200.0)):
        _close(torb.compute_coszen(_t(grid.tlat), _t(grid.tlon), yday, sec),
               jorb.compute_coszen(grid.tlat, grid.tlon, yday, sec))
    fa = {k: _t(getattr(f, k)) for k in ("potT", "uatm", "vatm", "wind",
                                         "zlvl", "Qa", "rhoa")}
    want = jax.vmap(lambda t: jatmo.atmo_boundary_layer(
        "ice", t, f.potT, f.uatm, f.vatm, f.wind, f.zlvl, f.Qa, f.rhoa))(
        jst.tsfcn)
    _close(tatmo.atmo_boundary_layer(
        "ice", tst.tsfcn, fa["potT"], fa["uatm"], fa["vatm"], fa["wind"],
        fa["zlvl"], fa["Qa"], fa["rhoa"]), want)
    _close(tatmo.atmo_boundary_layer(
        "ocn", tst.sst, fa["potT"], fa["uatm"], fa["vatm"], fa["wind"],
        fa["zlvl"], fa["Qa"], fa["rhoa"]),
        jatmo.atmo_boundary_layer("ocn", jst.sst, f.potT, f.uatm, f.vatm,
                                  f.wind, f.zlvl, f.Qa, f.rhoa))


def test_ocean_and_bottom_heat(case):
    jst, tst, f = case["jst"], case["tst"], case["f"]
    rng = np.random.RandomState(8)
    shape = case["tmask"].shape
    aice = np.asarray(jst.aicen.sum(0))
    fhocn = rng.uniform(-20.0, 5.0, shape)
    fswthru = rng.uniform(0.0, 5.0, shape)
    qdp = rng.uniform(-5.0, 5.0, shape)
    Tf = -1.836 * np.ones(shape)
    names = ("uatm", "vatm", "wind", "zlvl", "potT", "Qa", "rhoa", "flw",
             "swvdr", "swvdf", "swidr", "swidf")
    want = jocean.ocean_mixed_layer(
        DT, case["grid"].tmask, jnp.asarray(aice), jst.sst, jnp.asarray(Tf),
        jnp.asarray(qdp), f.hmix, *(getattr(f, k) for k in names),
        jnp.asarray(fhocn), jnp.asarray(fswthru))
    got = tocean.ocean_mixed_layer(
        DT, _t(case["tmask"]), _t(aice), tst.sst, _t(Tf), _t(qdp),
        _t(f.hmix), *(_t(getattr(f, k)) for k in names), _t(fhocn),
        _t(fswthru))
    _close(got, want)
    jp = jtv.make_thermo_params(case["jcfg"], case["itd"])
    tp = ttv.make_thermo_params(case["tcfg"], case["titd"])
    want = jtv.frzmlt_bottom_lateral(
        jp, DT, jnp.asarray(aice), jst.frzmlt, jst.eicen, jst.esnon,
        jst.sst, jnp.asarray(Tf), jst.strocnxT, jst.strocnyT)
    got = ttv.frzmlt_bottom_lateral(
        tp, DT, _t(aice), tst.frzmlt, tst.eicen, tst.esnon, tst.sst, _t(Tf),
        tst.strocnxT, tst.strocnyT)
    for g, w in zip(got, want):
        _close(g, w)


def test_reduce_area_and_guards(case):
    rng = np.random.RandomState(6)
    shape = case["tmask"].shape
    a, v, a0, v0 = (rng.uniform(0.0, 1.0, shape) for _ in range(4))
    _close(titd.reduce_area(_t(case["tmask"]), 0.1, _t(a), _t(v), _t(a0),
                            _t(v0)),
           jitd.reduce_area(jnp.asarray(case["tmask"]), 0.1, jnp.asarray(a),
                            jnp.asarray(v), jnp.asarray(a0),
                            jnp.asarray(v0)))
    before = rng.uniform(0.0, 2.0, shape)
    after = before * (1.0 + np.where(rng.rand(*shape) < 0.05, 1e-6, 0.0))
    jrec = jguards.check_column_conservation(
        jnp.asarray(before), jnp.asarray(after), jnp.asarray(case["tmask"]))
    trec = tguards.check_column_conservation(_t(before), _t(after),
                                             _t(case["tmask"]))
    assert int(trec["count"]) == int(jrec["count"]) > 0
    assert (int(trec["j"]), int(trec["i"])) == (int(jrec["j"]),
                                                int(jrec["i"]))
    _close(trec["worst"], jrec["worst"])
