"""The port's gx1 `ice_step` against the JAX package's under the column
options of ROADMAP 1.4, in f64 on the CPU, on the 24x32 cut of the gx1
lat-lon grid without a land-mask file that
`tests/test_torch_step_dynamics.py` runs, for 3 steps from the spring
equinox (day 80).  The analytic forcing takes its shortwave from a
declination of the opposite sign to the orbital one that sets `coszen`
(its day 172 lights the southern ice in polar night and leaves the
sunlit Arctic dark), and the delta-Eddington scheme absorbs only where
`coszen` is positive: near the equinoxes both agree, so sunlit ice
absorbs shortwave in both hemispheres.

* set R: delta-Eddington shortwave with the explicit melt-pond tracer
  (``radiation.shortwave="dEdd"``, ``tracers.tr_pond=True``), from a
  ponded state, `kernel_check.ponded_state`: the cold start with the
  snow taken off half of the icy category cells and a seeded pond volume
  on the ice (the analytic forcing keeps the Arctic below freezing, so a
  cold start would grow no pond and keep every cell snow-covered);
* set C: the coupled ordering with constant albedos, the constant-
  coefficient boundary layer and no linear ITD
  (``radiation.prep_radiation``, ``radiation.albedo_type="constant"``,
  ``thermo.atmbndy="constant"``, ``thermo.kitd=0``), from the cold start.

Each set compiles the JAX step once, in one test, so that no two test
workers compile it; the test also holds the history fields these options
feed (apondn, albpnd, fswfac, volpn) against the JAX package's.
Tolerance, as in `tests/test_torch_options.py`: every state field and every flux must agree to
``|torch - jax| <= 1e-10 * (|jax| + max|jax|)`` after each step, with
roundoff-sized melt fields measured against the scale of the terms they
come from, and the frazil of the step's freezing potential, a small
positive part of a field whose roundoff is that of the ocean temperature
it differences, measured against that potential's scale in metres of ice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import grid as jg
from cice4_tpu import model as jm
from cice4_tpu import state as js
from cice4_tpu.config import gx1_config as j_gx1_config
from cice4_tpu.io import history as jhist
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu.ops import itd as jitd
from cice4_tpu_torch import constants as cn
from cice4_tpu_torch import convert, kernel_check
from cice4_tpu_torch import model as tm
from cice4_tpu_torch.config import gx1_config as t_gx1_config
from cice4_tpu_torch.guards import raise_on_violation
from cice4_tpu_torch.io import history as thist
from cice4_tpu_torch.io.forcing_data import AnalyticForcing as TAnalytic
from cice4_tpu_torch.ops import itd as titd
from cice4_tpu_torch.state import STATE_FIELDS

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
NSTEPS = 3
DT = 3600.0
YDAY0 = 80.0
CUT = {"grid.kmt_file": "", "domain.ny_global": 24, "domain.nx_global": 32}
SETS = {
    "R": {"radiation.shortwave": "dEdd", "tracers.tr_pond": True},
    "C": {"radiation.prep_radiation": True,
          "radiation.albedo_type": "constant",
          "thermo.atmbndy": "constant", "thermo.kitd": 0},
}

# roundoff-sized differences take the scale of the terms they come from
_SCALE_OF = {"fmelttn_ai": "fsurfn_ai", "melts": "congel",
             "meltt": "congel", "meltb": "congel", "snoice": "congel"}
# the area and volume tendencies difference the state over the step
_TENDENCY_OF = {"daidtt": "aicen", "daidtd": "aicen", "dvidtt": "vicen",
                "dvidtd": "vicen"}


def _yday(n):
    return YDAY0 + n * DT / 86400.0


def _arrays(jst):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k in STATE_FIELDS for v in [getattr(jst, k)]}


def _close(got, want, name, scale_of=None):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    ref = want if scale_of is None else np.asarray(scale_of)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-10 * (np.abs(want) + scale) + 1e-30,
                                 err_msg=name)


def _check_step(n, jst, jfl, tst, tfl):
    for k in STATE_FIELDS:
        a, b = getattr(jst, k), getattr(tst, k)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), k
            for kk in a:
                _close(b[kk], a[kk], f"step {n} {k}.{kk}")
        else:
            _close(b, a, f"step {n} {k}")
    names = [k for k in jfl if not k.startswith("_")]
    assert set(names) <= set(tfl), set(names) - set(tfl)
    for k in names:
        scale_of = jfl.get(_SCALE_OF.get(k))
        if k in _TENDENCY_OF:
            scale_of = np.asarray(getattr(jst, _TENDENCY_OF[k])).sum(0) / DT
        if k == "frazil":
            scale_of = np.asarray(jfl["frzmlt_init"]) * DT \
                / (cn.rhoi * cn.Lfresh)
        _close(tfl[k], jfl[k], f"step {n} {k}", scale_of=scale_of)
    assert jfl["_guards"].keys() == tfl["_guards"].keys()
    for name, rec in jfl["_guards"].items():
        assert int(rec["count"]) == int(tfl["_guards"][name]["count"]), name


@pytest.mark.parametrize("name", list(SETS))
def test_option_set_matches_jax(name, monkeypatch):
    over = {**CUT, **SETS[name]}
    jcfg = j_gx1_config().with_values(**over)
    jgrid = jg.make_grid(jcfg, dtype=jnp.float64)
    jmodel = jm.Model.create(jcfg)
    jstate = js.init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    jforce = JAnalytic(jcfg, jgrid, jnp.float64)
    step = jm.make_step_fn(jmodel)

    tcfg = t_gx1_config().with_values(**over)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=jgrid.bc.ew, ns=jgrid.bc.ns),
        device=CPU, dtype=F64)
    tmodel = tm.Model(tcfg, tgrid)
    tstate = convert.state_from_arrays(_arrays(jstate), device=CPU,
                                       dtype=F64)
    if name == "R":
        tstate = kernel_check.ponded_state(tstate)
        jstate = jstate.replace(
            vsnon=jnp.asarray(tstate.vsnon.numpy()),
            esnon=jnp.asarray(tstate.esnon.numpy()),
            trcrn={k: jnp.asarray(v.numpy()) for k, v in tstate.trcrn.items()})
    tforce = TAnalytic(tcfg, tgrid, device=CPU, dtype=F64)

    radiation = []

    def recorded(*a, **k):
        radiation.append(real_radiation(*a, **k))
        return radiation[-1]

    real_radiation = tm._step_radiation
    monkeypatch.setattr(tm, "_step_radiation", recorded)
    for n in range(NSTEPS):
        yday = _yday(n)
        jstate, jfl = step(jstate, jgrid, jforce(yday, 0.0), yday, 0.0)
        tstate, tfl = tmodel(tstate, tforce(yday, 0.0), yday, 0.0)
        jax.block_until_ready(jstate.aicen)
        _check_step(n + 1, jstate, jfl, tstate, tfl)
        raise_on_violation(tfl["_guards"])
        if n > 0:
            continue
        # the options act, so the comparison cannot pass vacuously
        sw = radiation[0]
        if name == "R":
            assert float(tstate.trcrn["volpn"].min()) >= 0.0
            assert float(tstate.trcrn["volpn"].max()) > 0.0
            assert float(sw["albpn"].max()) > 0.0     # the ponded pass
            assert float(sw["Sswabs"].max()) > 0.0
        else:
            # coupled: nothing is carried into step 1, so no SW is
            # absorbed; the end-of-step radiation is carried to step 2
            assert float(tfl["fswabs"].abs().max()) == 0.0
            assert float(sw["fswsfc"].max()) > 0.0
            assert torch.equal(tstate.swn["fswsfcn"], sw["fswsfc"])
            assert float(sw["alvdrni"].max()) == 0.44   # constant albedo
            ice = tfl["aice"] > 0.0
            assert bool(ice.any()) and float(tfl["Tref"][ice].abs().max()) \
                == 0.0                                  # constant bndy
            assert "column conservation: vice after linear_itd" \
                not in tfl["_guards"]
    # the history fields these options feed read what the JAX files read
    jagg = jitd.aggregate(jstate, jgrid.tmask)
    tagg = titd.aggregate(tstate, tgrid.tmask)
    jfields, tfields = jhist.default_fields(), thist.default_fields()
    for k in ("apondn", "albpnd", "fswfac", "volpn"):
        want = jfields[k].extract(jstate, jfl, jagg)
        got = tfields[k].extract(tstate, tfl, tagg)
        assert (want is None) == (got is None), k
        if want is not None:
            _close(got, want, f"history {k}")
    assert (jfields["apondn"].extract(jstate, jfl, jagg) is None) \
        == (name == "C")
