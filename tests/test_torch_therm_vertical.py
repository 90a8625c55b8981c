"""The port's Newton temperature solve and column thermo against the JAX
package, in f64 on the CPU (the kernel's own test on the card is in
test_torch_gpu.py).

Tolerance: rtol = atol = 1e-12 for the solve, the bound the JAX package
holds its own Pallas kernel to.  The column driver is held to 1e-11
relative to each field's largest magnitude: the enthalpies are O(1e8)
and their layer sums reach 1e-16 relative differences from the order of
reduction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import constants as jcn
from cice4_tpu import grid as jg
from cice4_tpu import state as js
from cice4_tpu.config import gx1_config
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu.ops import atmo as jatmo
from cice4_tpu.ops import shortwave as jsw
from cice4_tpu.ops import therm_vertical as jtv
from cice4_tpu_torch import config as tcfg
from cice4_tpu_torch import state as ts
from cice4_tpu_torch.ops import therm_vertical as ttv

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
SOLVE_KEYS = ("Tsf", "Tsn", "Tin", "qsn", "qin", "fsurfn", "fcondtopn",
              "fcondbot", "fsensn", "flatn", "flwoutn", "fswabsn", "fswsfc",
              "fswint", "Sswabs", "Iswabs", "dq_flux")


def _cfg():
    return gx1_config().with_values(**{
        "grid.kmt_file": "", "dynamics.kdyn": 0,
        "transport.advection": "none",
        "domain.ny_global": 24, "domain.nx_global": 32})


@pytest.fixture(scope="module")
def params():
    cfg = _cfg()
    jp = jtv.make_thermo_params(cfg, js.make_itd_params(cfg))
    tp = ttv.make_thermo_params(tcfg.gx1_config().with_values(
        **{"grid.kmt_file": ""}), ts.make_itd_params(cfg))
    assert vars(jp) == vars(tp)
    return jp, tp


@pytest.fixture(scope="module")
def solve_case(params):
    """The JAX package's kernel-test fixture (tests/test_thermo.py
    :227-256): ice only in two row bands, so the ice-free branch runs."""
    jp, tp = params
    ny, nx = 64, 128
    rng = np.random.RandomState(3)

    def f(lo, hi, shape=(ny, nx)):
        return rng.uniform(lo, hi, shape)

    row = np.arange(ny)[:, None] * np.ones((1, nx))
    has_ice = ((row < 12) | (row >= 52)) & (rng.rand(ny, nx) > 0.2)
    hilyr = np.where(has_ice, f(0.1, 0.8), 0.0)
    hslyr = np.where(has_ice, f(0.0, 0.3), 0.0)
    Tsf = np.where(has_ice, f(-30.0, -0.5), 0.0)
    Tf = -jcn.depressT * 34.0
    k = np.arange(1, jp.nilyr + 1, dtype=np.float64)[:, None, None]
    Ti = Tsf[None] + (Tf - Tsf[None]) * (k - 0.5) / jp.nilyr
    tmlt = np.asarray(jp.tmlt)[:jp.nilyr, None, None]
    qin = np.asarray(jtv.qin_of_tin(jp, jnp.asarray(Ti), jnp.asarray(tmlt)))
    Tsn = np.broadcast_to(np.minimum(Tsf, 0.0), (jp.nslyr, ny, nx)).copy()
    qsn = np.asarray(jtv.qsn_of_tsn(jnp.asarray(Tsn)))
    fswsfc, fswint = f(0.0, 60.0), f(0.0, 30.0)
    arrays = [f(1.1, 1.4), f(150.0, 300.0), f(240.0, 275.0), f(1e-4, 4e-3),
              f(5.0, 25.0), f(2.0, 15.0), fswsfc, fswint, f(0.0, 10.0),
              np.zeros((jp.nslyr, ny, nx)) + 1.0,
              np.broadcast_to(f(0.0, 5.0)[None], (jp.nilyr, ny, nx)).copy(),
              hilyr, hslyr, qin, Ti, qsn, Tsn, Tsf, np.full((ny, nx), Tf),
              (qsn * hslyr[None]).sum(0) + (qin * hilyr[None]).sum(0)]
    out = ttv._temperature_changes_core(
        tp, 3600.0, torch.from_numpy(has_ice),
        *(torch.tensor(a) for a in arrays))
    return has_ice, arrays, out


@pytest.mark.parametrize("ref", ["core", "pallas_interpret"])
def test_solve_matches_jax(params, solve_case, ref):
    jp, _ = params
    has_ice, arrays, out = solve_case
    jargs = (jp, 3600.0, jnp.asarray(has_ice)) \
        + tuple(jnp.asarray(a) for a in arrays)
    if ref == "core":
        want = jtv._temperature_changes_core(*jargs)
    else:
        want = jtv._temperature_changes_pallas(*jargs, interpret=True)
    for key in SOLVE_KEYS:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-12, atol=1e-12, err_msg=key)
    np.testing.assert_array_equal(out["converged"].numpy(),
                                  np.asarray(want["converged"]))
    np.testing.assert_array_equal(out["why"].numpy(),
                                  np.asarray(want["why"]))
    if ref == "core":
        assert int(out["niter"]) == int(want["niter"])


def test_solve_skips_ice_free_cells(solve_case):
    has_ice, arrays, out = solve_case
    free = ~has_ice
    assert free.any() and has_ice.any()
    assert (out["niter_cells"].numpy()[free] == 0).all()
    assert not out["converged"].numpy()[free].any()
    np.testing.assert_array_equal(out["Tsf"].numpy()[free], arrays[17][free])
    assert (out["niter_cells"].numpy()[has_ice] >= 1).all()
    assert int(out["niter"]) == int(out["niter_cells"].max())


def _column_inputs(yday):
    """Inputs of thermo_vertical_category for all 5 categories, taken
    from the thermo-only step's own state, radiation and boundary layer
    (JAX package, f64)."""
    cfg = _cfg()
    grid = jg.make_grid(cfg, dtype=jnp.float64)
    itd = js.make_itd_params(cfg)
    st = js.init_state(cfg, grid, itd, dtype=jnp.float64)
    f = JAnalytic(cfg, grid, jnp.float64)(yday, 0.0)
    sw = jax.vmap(lambda a, v, vs, t: jsw.shortwave_ccsm3(
        cfg.radiation, itd.nilyr, itd.nslyr, True, a, v, vs, t,
        f.swvdr, f.swvdf, f.swidr, f.swidf))(st.aicen, st.vicen, st.vsnon,
                                             st.tsfcn)
    bl = jax.vmap(lambda t: jatmo.atmo_boundary_layer(
        "ice", t, f.potT, f.uatm, f.vatm, f.wind, f.zlvl, f.Qa, f.rhoa))(
        st.tsfcn)
    Tf = -jcn.depressT * f.sss
    fbot = jnp.full_like(Tf, -2.0)
    cat = dict(aicen=st.aicen, vicen=st.vicen, vsnon=st.vsnon,
               tsfcn=st.tsfcn, eicen=st.eicen, esnon=st.esnon,
               lhcoef=bl["lhcoef"], shcoef=bl["shcoef"],
               fswsfc=sw["fswsfc"], fswint=sw["fswint"],
               fswthrun=sw["fswthru"], Sswabs=sw["Sswabs"],
               Iswabs=sw["Iswabs"])
    planes = dict(flw=f.flw, potT=f.potT, Qa=f.Qa, rhoa=f.rhoa,
                  fsnow=f.fsnow, fbot=fbot, Tbot=Tf, Tf=Tf)
    return cat, planes


_TVC_ORDER = ("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon", "flw",
              "potT", "Qa", "rhoa", "fsnow", "fbot", "Tbot", "Tf", "lhcoef",
              "shcoef", "fswsfc", "fswint", "fswthrun", "Sswabs", "Iswabs")


@pytest.mark.parametrize("yday", [80.0, 172.0])
def test_thermo_vertical_category_all_categories(params, yday):
    jp, tp = params
    cat, planes = _column_inputs(yday)
    allargs = {**cat, **planes}
    want_st, want_fx = jax.vmap(
        lambda c: jtv.thermo_vertical_category(
            jp, 3600.0, *(c[k] if k in c else planes[k]
                          for k in _TVC_ORDER)))(cat)
    got_st, got_fx = ttv.thermo_vertical_category(
        tp, 3600.0, *(torch.from_numpy(np.array(allargs[k]))
                      for k in _TVC_ORDER))
    assert int(jnp.sum(cat["aicen"] > 0)) > 0
    for key, want in list(want_st.items()) + list(want_fx.items()):
        if key == "niter":
            continue
        got = (got_st if key in got_st else got_fx)[key].numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, key
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11 * scale,
                                   err_msg=key)


def test_unported_thermo_options_raise(params):
    _, tp = params
    cat, planes = _column_inputs(80.0)
    allargs = {**cat, **planes}
    args = [torch.from_numpy(np.array(allargs[k])) for k in _TVC_ORDER]
    for over in ({"calc_Tsfc": False}, {"heat_capacity": False}):
        p = ttv.ThermoParams(**{**vars(tp), **over})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttv.thermo_vertical_category(p, 3600.0, *args)
