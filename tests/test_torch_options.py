"""The port's gx1 `ice_step` against the JAX package's with an option set
off the default path, in f64 on the CPU: 7 ice layers (the Newton solve,
the enthalpy tracers and the ITD at that depth), Hibler79 strength
(``kstrength=0``), Thorndike participation and Hibler80 uniform
redistribution in ridging (``krdg_partic=0``, ``krdg_redist=0``) and the
cubic 4-point quadrature of the remap triangles (``integral_order=3``),
on the 24x32 cut of the gx1 lat-lon grid without a land-mask file that
`tests/test_torch_step_dynamics.py` runs, for 2 steps.

Tolerance, as there: every state field and every flux must agree to
``|torch - jax| <= 1e-10 * (|jax| + max|jax|)`` after each step, with
roundoff-sized melt fields measured against the scale of the terms they
come from (the area and volume tendencies: the state over the step).
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
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu_torch import convert
from cice4_tpu_torch import model as tm
from cice4_tpu_torch.config import gx1_config as t_gx1_config
from cice4_tpu_torch.guards import raise_on_violation
from cice4_tpu_torch.io.forcing_data import AnalyticForcing as TAnalytic
from cice4_tpu_torch.state import STATE_FIELDS, init_state

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
NSTEPS = 2
DT = 3600.0
OPTIONS = {"grid.kmt_file": "", "domain.ny_global": 24,
           "domain.nx_global": 32, "domain.nilyr": 7,
           "dynamics.kstrength": 0, "dynamics.krdg_partic": 0,
           "dynamics.krdg_redist": 0, "transport.integral_order": 3}

# roundoff-sized differences take the scale of the terms they come from
_SCALE_OF = {"fmelttn_ai": "fsurfn_ai", "melts": "congel",
             "meltt": "congel", "meltb": "congel", "snoice": "congel"}
# the area and volume tendencies are differences of the state over the
# step: after the first step the thermodynamic area tendency is roundoff
# of zero (one ulp of aice over dt, 6.2e-20), so they take the scale of
# the state they difference, over dt
_TENDENCY_OF = {"daidtt": "aicen", "daidtd": "aicen", "dvidtt": "vicen",
                "dvidtd": "vicen"}


def _yday(n):
    return 80.0 + n * DT / 86400.0


@pytest.fixture(scope="module")
def runs():
    """(jax, torch) (state, fluxes) after each of NSTEPS steps; one JAX
    compile of the step."""
    jcfg = j_gx1_config().with_values(**OPTIONS)
    jgrid = jg.make_grid(jcfg, dtype=jnp.float64)
    jmodel = jm.Model.create(jcfg)
    jstate = js.init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    jforce = JAnalytic(jcfg, jgrid, jnp.float64)
    step = jm.make_step_fn(jmodel)

    tcfg = t_gx1_config().with_values(**OPTIONS)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=jgrid.bc.ew, ns=jgrid.bc.ns),
        device=CPU, dtype=F64)
    tmodel = tm.Model(tcfg, tgrid)
    tstate = init_state(tcfg, tgrid, tmodel.itd, device=CPU, dtype=F64)
    tforce = TAnalytic(tcfg, tgrid, device=CPU, dtype=F64)

    out = []
    for n in range(NSTEPS):
        yday = _yday(n)
        jstate, jfl = step(jstate, jgrid, jforce(yday, 0.0), yday, 0.0)
        tstate, tfl = tmodel(tstate, tforce(yday, 0.0), yday, 0.0)
        jax.block_until_ready(jstate.aicen)
        out.append(((jstate, jfl), (tstate, tfl)))
    return out


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


@pytest.mark.parametrize("after", [1, NSTEPS])
def test_option_state_matches_jax(runs, after):
    (jst, _), (tst, _) = runs[after - 1]
    for k in STATE_FIELDS:
        a, b = getattr(jst, k), getattr(tst, k)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), k
            for kk in a:
                _close(b[kk], a[kk], f"{k}.{kk}")
        else:
            _close(b, a, k)


@pytest.mark.parametrize("after", [1, NSTEPS])
def test_option_fluxes_match_jax(runs, after):
    (jst, jfl), (_, tfl) = runs[after - 1]
    names = [k for k in jfl if not k.startswith("_")]
    assert set(names) <= set(tfl), set(names) - set(tfl)
    for k in names:
        scale_of = jfl.get(_SCALE_OF.get(k))
        if k in _TENDENCY_OF:
            scale_of = np.asarray(getattr(jst, _TENDENCY_OF[k])).sum(0) / DT
        _close(tfl[k], jfl[k], k, scale_of=scale_of)
    assert jfl["_guards"].keys() == tfl["_guards"].keys()
    for name, rec in jfl["_guards"].items():
        assert int(rec["count"]) == int(tfl["_guards"][name]["count"]), name


def test_options_act(runs):
    """The options are in force: 7 ice layers in the state, the ice
    moves and ridges, and no guard fires."""
    (_, _), (tst, tfl) = runs[-1]
    raise_on_violation(tfl["_guards"])
    assert tst.eicen.shape == (5, 7, 24, 32)
    assert 0.0 < float(tst.uvel.abs().max()) < 2.0
    assert float(tfl["dardg1dt"].abs().max()) > 0.0
