"""The port's default gx1 `ice_step` (EVP dynamics, incremental
remapping, ridging driven by the EVP convergence and shear) against the
JAX package's, in f64 on the CPU, on a 24x32 cut of the gx1 lat-lon grid
without a land-mask file.  Over 3 steps 128-192 of the 768 cells hold
ice, the ice starts moving (max |u| ~0.07 m/s) and converges, so EVP,
remap and ridging all act.

Tolerance, as in `tests/test_torch_step.py`: every state field and every
flux must agree to ``|torch - jax| <= 1e-10 * (|jax| + max|jax|)`` after
1 and after 3 steps, with roundoff-sized melt fields measured against the
scale of the terms they come from.  The worst fields (the bottom and
lateral melt fluxes, which divide by small temperature differences) stay
near 2e-11 of their scale.
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
NSTEPS = 3
SLICE = {"grid.kmt_file": "", "domain.ny_global": 24, "domain.nx_global": 32}
DYNAMICS_FLUXES = ("divu", "shear", "strength", "prs_sig", "strintx",
                   "strinty", "strocnx", "strocny", "strtltx", "strtlty",
                   "strcorx", "strcory", "sig1", "sig2", "trsig",
                   "dardg1dt", "dardg2dt", "dvirdgdt", "opening")

# roundoff-sized differences take the scale of the terms they come from
_SCALE_OF = {"fmelttn_ai": "fsurfn_ai", "melts": "congel",
             "meltt": "congel", "meltb": "congel", "snoice": "congel"}


def _yday(n):
    return 80.0 + n * 3600.0 / 86400.0


@pytest.fixture(scope="module")
def runs():
    """(jax, torch) (state, fluxes) after each of NSTEPS steps."""
    jcfg = j_gx1_config().with_values(**SLICE)
    jgrid = jg.make_grid(jcfg, dtype=jnp.float64)
    jmodel = jm.Model.create(jcfg)
    jstate = js.init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    jforce = JAnalytic(jcfg, jgrid, jnp.float64)
    step = jm.make_step_fn(jmodel)

    tcfg = t_gx1_config().with_values(**SLICE)
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
def test_state_matches_jax(runs, after):
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
def test_fluxes_match_jax(runs, after):
    (_, jfl), (_, tfl) = runs[after - 1]
    names = [k for k in jfl if not k.startswith("_")]
    assert set(DYNAMICS_FLUXES) <= set(names)
    assert set(names) <= set(tfl), set(names) - set(tfl)
    for k in names:
        _close(tfl[k], jfl[k], k, scale_of=jfl.get(_SCALE_OF.get(k)))
    assert jfl["_guards"].keys() == tfl["_guards"].keys()
    for name, rec in jfl["_guards"].items():
        assert int(rec["count"]) == int(tfl["_guards"][name]["count"]), name


def test_dynamics_act(runs):
    """EVP moves the ice, remap carries it and ridging closes the area."""
    (jst0, _), (tst0, _) = runs[0]
    (_, _), (tst, tfl) = runs[-1]
    raise_on_violation(tfl["_guards"])
    for k in STATE_FIELDS:
        v = getattr(tst, k)
        for t in (v.values() if isinstance(v, dict) else [v]):
            if t.is_floating_point():
                assert torch.isfinite(t).all(), k
    assert 0.01 < float(tst.uvel.abs().max()) < 2.0
    assert bool(tst.iceumask.any())
    assert float(tfl["divu"].abs().max()) > 0.0
    aice = tst.aicen.sum(0)
    assert float(aice.min()) >= 0.0 and float(aice.max()) <= 1.0 + 1e-12
    assert 1 <= tfl["_ridge_niter"] <= 20


def test_dynamics_state_round_trips(runs):
    """Every field the dynamics writes survives convert.to_arrays and
    state_from_arrays, bool iceumask included."""
    (_, _), (tst, _) = runs[-1]
    back = convert.state_from_arrays(convert.to_arrays(tst), device=CPU,
                                     dtype=F64)
    for k in ("uvel", "vvel", "stressp", "stressm", "stress12", "iceumask",
              "strocnxT", "strocnyT"):
        a, b = getattr(tst, k), getattr(back, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k
    assert back.stressp.shape == (4, 24, 32)
    assert back.iceumask.dtype == torch.bool
