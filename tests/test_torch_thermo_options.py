"""The port's other surface options of the column thermodynamics against
the JAX package, in f64 on the CPU: the zero-layer solve without heat
capacity (``heat_capacity=False``), the solve under a prescribed top flux
and the explicit surface scheme (``calc_Tsfc=False``).

* `zerolayer_temperature`, `temperature_changes_know_tsfc` and
  `explicit_calc_tsfc` on seeded columns (`kernel_check.make_inputs`: ice
  in two row bands, thicknesses, temperatures and fluxes drawn from a
  fixed seed, a linear temperature profile);
* `thermo_vertical_category` in the three variants (zero layer; prescribed
  fluxes with and without heat capacity), on the 5 categories of the gx1
  cut's own state, radiation and boundary layer, the prescribed fluxes
  those of the JAX package's explicit scheme;
* two gx1 steps at 24x32 for each of the option sets {upwind transport,
  no heat capacity} and {``calc_Tsfc=False``}, against the JAX step (one
  JAX compile each).

Tolerance: ``|torch - jax| <= rtol * (|jax| + max|jax|)`` per field, rtol
1e-12 for the solves (as `tests/test_torch_therm_vertical.py` holds the
Newton solve), 1e-11 for the column driver with the scale at least 1 (as
that file holds it: its enthalpies are O(1e8), their layer sums round in
another order, and a melt of zero comes out as roundoff of 1e-29) and
1e-10 for the whole step; the iteration counts and convergence flags
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import state as js
from cice4_tpu.config import gx1_config as j_gx1_config
from cice4_tpu.ops import therm_vertical as jtv
from cice4_tpu_torch import config as tcfg
from cice4_tpu_torch import kernel_check
from cice4_tpu_torch import state as ts
from cice4_tpu_torch.guards import raise_on_violation
from cice4_tpu_torch.ops import therm_vertical as ttv
from tests.test_torch_therm_vertical import _TVC_ORDER, _column_inputs
from tests.test_torch_transport_options import check_step, run_steps_both

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
DT = 3600.0
NCAT, NY, NX = 2, 32, 24
CUT = {"grid.kmt_file": "", "domain.ny_global": 24, "domain.nx_global": 32}


def _close(got, want, name, rtol=1e-12, floor=0.0):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(float(np.abs(want).max()) if want.size else 0.0, floor)
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300,
                                 err_msg=name)


def _params(nilyr=4, nslyr=1, **thermo):
    """(JAX, port) thermo parameters of the gx1 cut with these layer
    counts and `thermo` options."""
    over = {**CUT, "domain.nilyr": nilyr, "domain.nslyr": nslyr,
            **{f"thermo.{k}": v for k, v in thermo.items()}}
    jc = j_gx1_config().with_values(**over)
    tc = tcfg.gx1_config().with_values(**over)
    jp = jtv.make_thermo_params(jc, js.make_itd_params(jc))
    tp = ttv.make_thermo_params(tc, ts.make_itd_params(tc))
    assert vars(jp) == vars(tp)
    return jp, tp


def _columns(p, seed=4):
    """Seeded columns: `kernel_check.make_inputs` by name, and the
    category state they stand for, (NCAT, NY, NX) with forcing planes
    (NY, NX)."""
    names = ("has_ice", "rhoa", "flw", "potT", "Qa", "shcoef", "lhcoef",
             "fswsfc", "fswint", "fswthrun", "Sswabs", "Iswabs", "hilyr",
             "hslyr", "qin", "Tin", "qsn", "Tsn", "Tsf", "Tbot", "einit")
    c = dict(zip(names, kernel_check.make_inputs(p, NCAT, NY, NX, seed,
                                                 device=CPU, dtype=F64)))
    rng = np.random.RandomState(seed + 1)
    aicen = torch.where(c["has_ice"],
                        torch.tensor(rng.uniform(0.1, 1.0, (NCAT, NY, NX))),
                        0.0)
    vicen = aicen * c["hilyr"] * p.nilyr
    vsnon = aicen * c["hslyr"] * p.nslyr
    # the interior absorption consistent with the layers' (as radiation
    # gives it), so that the solves can conserve energy
    c["Sswabs"] = torch.zeros_like(c["Sswabs"])
    c["fswint"] = c["Iswabs"].sum(1)
    c.update(aicen=aicen, vicen=vicen, vsnon=vsnon, tsfcn=c["Tsf"],
             eicen=c["qin"] * vicen.unsqueeze(1) / p.nilyr,
             esnon=c["qsn"] * vsnon.unsqueeze(1) / p.nslyr,
             fcondtopn=torch.tensor(rng.uniform(-40.0, 10.0,
                                                (NCAT, NY, NX))))
    return c


PLANES = ("rhoa", "flw", "potT", "Qa", "Tbot")


def _jax_vmapped(fn, c, names):
    """`fn` of the JAX package over the category axis, forcing planes
    shared."""
    args = [jnp.asarray(c[k].numpy()) for k in names]
    axes = tuple(None if k in PLANES else 0 for k in names)
    return jax.vmap(fn, in_axes=axes)(*args)


ZL_ARGS = ("has_ice", "rhoa", "flw", "potT", "Qa", "shcoef", "lhcoef",
           "fswsfc", "fswthrun", "hilyr", "hslyr", "Tsf", "Tbot")
KT_ARGS = ("has_ice", "fcondtopn", "fswsfc", "fswint", "fswthrun", "Sswabs",
           "Iswabs", "hilyr", "hslyr", "qin", "Tin", "qsn", "Tsn", "Tbot",
           "einit")
EX_ARGS = ("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon", "rhoa",
           "flw", "potT", "Qa", "shcoef", "lhcoef", "fswsfc")


def test_zerolayer_temperature_matches_jax():
    jp, tp = _params(heat_capacity=False)
    c = _columns(tp)
    want = _jax_vmapped(lambda *a: jtv.zerolayer_temperature(jp, DT, *a),
                        c, ZL_ARGS)
    got = ttv.zerolayer_temperature(tp, DT, *(c[k] for k in ZL_ARGS))
    for key in ("Tsf", "fsurfn", "fcondtopn", "fcondbot", "fsensn", "flatn",
                "flwoutn", "fswabsn"):
        _close(got[key], want[key], key)
    assert int(got["niter"]) == int(np.asarray(want["niter"]).max()) > 1
    ice = c["has_ice"]
    assert float((got["Tsf"] - c["Tsf"])[ice].abs().max()) > 0.1


@pytest.mark.parametrize("layers", [(4, 1), (7, 2)])
def test_know_tsfc_matches_jax(layers):
    jp, tp = _params(*layers, calc_Tsfc=False)
    c = _columns(tp, seed=6)
    want = _jax_vmapped(
        lambda *a: jtv.temperature_changes_know_tsfc(jp, DT, *a), c, KT_ARGS)
    got = ttv.temperature_changes_know_tsfc(tp, DT, *(c[k] for k in KT_ARGS))
    for key in ("Tsn", "Tin", "qsn", "qin", "fcondbot", "fswabsn",
                "dq_flux", "converged"):
        _close(got[key], want[key], key)
    assert int(got["niter"]) == int(np.asarray(want["niter"]).max()) > 1
    assert float(got["converged"][c["has_ice"]].double().mean()) > 0.99
    assert float((got["Tin"] - c["Tin"])[c["has_ice"].unsqueeze(1)
                                         .expand_as(c["Tin"])]
                 .abs().max()) > 0.1


@pytest.mark.parametrize("heat_capacity", [True, False])
def test_explicit_calc_tsfc_matches_jax(heat_capacity):
    jp, tp = _params(calc_Tsfc=False, heat_capacity=heat_capacity)
    c = _columns(tp, seed=8)
    want = _jax_vmapped(
        lambda *a: jtv.explicit_calc_tsfc(jp, DT, *a), c, EX_ARGS)
    got = ttv.explicit_calc_tsfc(tp, DT, *(c[k] for k in EX_ARGS))
    assert got.keys() == want.keys()
    for key in got:
        _close(got[key], want[key], key)


# (calc_Tsfc, heat_capacity) of each variant of the column driver
VARIANTS = {"zero_layer": (True, False), "prescribed": (False, True),
            "prescribed_zero_layer": (False, False)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_thermo_vertical_category_variants(variant):
    calc_Tsfc, heat_capacity = VARIANTS[variant]
    jp, tp = _params(calc_Tsfc=calc_Tsfc, heat_capacity=heat_capacity)
    cat, planes = _column_inputs(80.0)
    pre = {}
    if not calc_Tsfc:
        ex = jax.vmap(lambda c: jtv.explicit_calc_tsfc(
            jp, DT, c["aicen"], c["vicen"], c["vsnon"], c["tsfcn"],
            c["eicen"], c["esnon"], planes["rhoa"], planes["flw"],
            planes["potT"], planes["Qa"], c["shcoef"], c["lhcoef"],
            c["fswsfc"]))(cat)
        pre = dict(fsurfn_pre=ex["fsurfn"], fcondtopn_pre=ex["fcondtopn"],
                   flatn_pre=ex["flatn"])
        assert float(jnp.abs(ex["fcondtopn"]).max()) > 1.0
    want_st, want_fx = jax.vmap(
        lambda c, q: jtv.thermo_vertical_category(
            jp, DT, *(c[k] if k in c else planes[k] for k in _TVC_ORDER),
            **q))(cat, pre)
    allargs = {**cat, **planes}
    got_st, got_fx = ttv.thermo_vertical_category(
        tp, DT, *(torch.from_numpy(np.array(allargs[k])) for k in _TVC_ORDER),
        **{k: torch.from_numpy(np.array(v)) for k, v in pre.items()})
    assert int(jnp.sum(cat["aicen"] > 0)) > 0
    for key, want in list(want_st.items()) + list(want_fx.items()):
        got = (got_st if key in got_st else got_fx)[key]
        if key == "niter":
            assert int(got) == int(np.asarray(want).max()), key
            continue
        _close(got, want, key, rtol=1e-11, floor=1.0)
    if calc_Tsfc:   # the zero-layer solve moves the surface temperature
        assert float((got_st["tsfcn"] - torch.from_numpy(
            np.array(cat["tsfcn"]))).abs().max()) > 0.01


# the whole step: two option sets, one JAX compile each
STEP_SETS = {
    "upwind_zero_layer": {"transport.advection": "upwind",
                          "thermo.heat_capacity": False},
    "calc_tsfc_false": {"thermo.calc_Tsfc": False},
}


@pytest.mark.parametrize("name", list(STEP_SETS))
def test_step_with_thermo_options_matches_jax(name):
    for n, jst, jfl, tst, tfl in run_steps_both({**CUT, **STEP_SETS[name]}):
        check_step(n, jst, jfl, tst, tfl)
        raise_on_violation(tfl["_guards"])
    assert 0.0 < float(tst.uvel.abs().max()) < 2.0
    assert float(tst.aicen.sum()) > 0.0
