"""The port's thermo-only `ice_step` against the JAX package's, in f64 on
the CPU, on a 24x32 cut of the gx1 lat-lon slice (about a fifth of the
cells hold ice, so both branches of the column solve run).

Tolerance: every state field and every flux must agree to
``|torch - jax| <= 1e-10 * (|jax| + max|jax|)`` after 1 and after 3
steps.  The two packages evaluate `exp`, `pow` and the layer and category
sums with different CPU kernels, which differ in the last bits; the
Newton solve, the linear ITD remap and the ridging loop carry those
differences.  They stay near 1e-13 relative; the bound leaves room for
growth over steps but would catch any change of physics.
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
from cice4_tpu_torch.guards import ConservationError, raise_on_violation
from cice4_tpu_torch.io.forcing_data import AnalyticForcing as TAnalytic
from cice4_tpu_torch.state import STATE_FIELDS, init_state

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
NSTEPS = 3
SLICE = {"grid.kmt_file": "", "dynamics.kdyn": 0,
         "transport.advection": "none",
         "domain.ny_global": 24, "domain.nx_global": 32}


# Fields that are roundoff-sized differences take the scale of the terms
# they come from: fmelttn_ai = max(fsurfn - fcondtopn, 0) * aicen cancels
# where the surface is at the melting point, and the melt thicknesses
# (m per step) share the scale of the step's growth, congel; in March
# the melts are 1e-19 m of roundoff that the packages round differently.
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
    """`scale_of`: the array whose magnitude sets the field's scale, for a
    field that is a cancelling difference of larger terms."""
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
    assert set(names) <= set(tfl), set(names) - set(tfl)
    for k in names:
        _close(tfl[k], jfl[k], k, scale_of=jfl.get(_SCALE_OF.get(k)))
    assert jfl["_guards"].keys() == tfl["_guards"].keys()
    for name, rec in jfl["_guards"].items():
        assert int(rec["count"]) == int(tfl["_guards"][name]["count"]), name


def test_step_is_physical(runs):
    (_, _), (tst, tfl) = runs[-1]
    raise_on_violation(tfl["_guards"])
    for k in STATE_FIELDS:
        v = getattr(tst, k)
        for t in (v.values() if isinstance(v, dict) else [v]):
            if t.is_floating_point():
                assert torch.isfinite(t).all(), k
    aice = tst.aicen.sum(0)
    assert float(aice.min()) >= 0.0 and float(aice.max()) <= 1.0 + 1e-12
    assert 0 < float((aice > 0).double().mean()) < 1
    assert 1 <= tfl["_ridge_niter"] <= 20
    assert int(tfl["_thermo_niter"]) >= 1


def test_guard_raises_on_violation():
    rec = {"x": dict(count=torch.tensor(2), j=torch.tensor(1),
                     i=torch.tensor(3), worst=torch.tensor(0.5))}
    with pytest.raises(ConservationError, match="j=1, i=3"):
        raise_on_violation(rec)


def test_model_holds_grid_as_buffers():
    cfg = t_gx1_config().with_values(**{**SLICE, "domain.ny_global": 6,
                                        "domain.nx_global": 8})
    model = tm.Model.create(cfg, device=CPU, dtype=torch.float32)
    names = {n for n, _ in model.named_buffers()}
    assert set(convert.GRID_FIELDS) <= names
    moved = model.to(F64)
    assert moved.grid.tlat.dtype == F64
    assert moved.grid.tmask.dtype == torch.bool
    assert (moved.grid.ny, moved.grid.nx) == (6, 8)


@pytest.mark.parametrize("over", [{"dynamics.kdyn": 1},
                                  {"transport.advection": "remap"},
                                  {"radiation.shortwave": "dEdd"}])
def test_unported_step_options_raise(over):
    cfg = t_gx1_config().with_values(**{**SLICE, **over})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.Model.create(cfg, device=CPU)
