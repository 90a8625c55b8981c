"""The doubly-periodic box of the slice, stepped by the port and by the
JAX package in f64 on the CPU.

The box is the JAX package's `Config()` on the all-ocean uniform grid
(`grid_type="column"`, 10 km cells) cyclic east-west and north-south,
with analytic forcing, the damped EVP (`dynamics.evp_damping=True`) and
the other defaults (5 categories, 4 + 1 layers, 120 subcycles, remap of
order 2, the iage tracer), cut here to 24x32 with its southern row at 69N
so that the ice edge (70N) lies inside it.

Why damped: with 10 km cells an undamped EVP that starts from rest has a
viscosity strength / max(Delta, tinyarea) some 100 times that of a gx1
cell, and its subcycles amplify a last-bit difference: one ulp more
ice volume moves the velocities of the first step by about 18% of their
scale (`test_one_ulp_moves_only_the_undamped_box`, which measures it in
the port alone).  No two implementations can then agree to 1e-10.  With
damping the viscosity is capped (`rcon`) and the same change moves the
velocities by a few ulps.  The full-size box on the card runs undamped.

Tolerance, as in `tests/test_torch_step_dynamics.py`: every state field
and every flux within ``1e-10 * (|jax| + max|jax|)`` after 1 and after 3
steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import grid as jg
from cice4_tpu import model as jm
from cice4_tpu import state as js
from cice4_tpu.config import Config as JConfig
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu_torch import model as tm
from cice4_tpu_torch.config import Config as TConfig
from cice4_tpu_torch.guards import raise_on_violation
from cice4_tpu_torch.io.forcing_data import AnalyticForcing as TAnalytic
from cice4_tpu_torch.ops import evp_cuda
from cice4_tpu_torch.state import STATE_FIELDS, init_state

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
NSTEPS = 3
BOX = {"domain.nx_global": 32, "domain.ny_global": 24,
       "domain.ew_boundary_type": "cyclic",
       "domain.ns_boundary_type": "cyclic", "grid.grid_type": "column",
       "grid.lat_origin": 69.0, "grid.dx_rect": 10.0e3,
       "grid.dy_rect": 10.0e3, "forcing.atm_data_type": "analytic",
       "dynamics.evp_damping": True}
_SCALE_OF = {"fmelttn_ai": "fsurfn_ai", "melts": "congel",
             "meltt": "congel", "meltb": "congel", "snoice": "congel"}


def _yday(n):
    return 80.0 + n * 3600.0 / 86400.0


@pytest.fixture(scope="module")
def runs():
    """(jax, torch) (state, fluxes) after each of NSTEPS steps."""
    jcfg = JConfig().with_values(**BOX)
    jgrid = jg.make_grid(jcfg, dtype=jnp.float64)
    jmodel = jm.Model.create(jcfg)
    jstate = js.init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    jforce = JAnalytic(jcfg, jgrid, jnp.float64)
    step = jm.make_step_fn(jmodel)

    tcfg = TConfig().with_values(**BOX)
    tmodel = tm.Model.create(tcfg, device=CPU, dtype=F64)
    tstate = init_state(tcfg, tmodel.grid, tmodel.itd, device=CPU,
                        dtype=F64)
    tforce = TAnalytic(tcfg, tmodel.grid, device=CPU, dtype=F64)
    out = [((jstate, None), (tstate, None))]
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


def test_initial_state_matches_jax(runs):
    (jst, _), (tst, _) = runs[0]
    for k in STATE_FIELDS:
        a, b = getattr(jst, k), getattr(tst, k)
        for kk in (a if isinstance(a, dict) else [None]):
            _close(b if kk is None else b[kk], a if kk is None else a[kk], k)
    aice = tst.aicen.sum(0)
    assert 0 < int((aice > 0).sum()) < aice.numel()   # the edge is inside


@pytest.mark.parametrize("after", [1, NSTEPS])
def test_state_matches_jax(runs, after):
    (jst, _), (tst, _) = runs[after]
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
    (_, jfl), (_, tfl) = runs[after]
    names = [k for k in jfl if not k.startswith("_")]
    assert set(names) <= set(tfl), set(names) - set(tfl)
    for k in names:
        _close(tfl[k], jfl[k], k, scale_of=jfl.get(_SCALE_OF.get(k)))
    for name, rec in jfl["_guards"].items():
        assert int(rec["count"]) == int(tfl["_guards"][name]["count"]), name


def test_box_dynamics_act_on_the_periodic_grid(runs):
    """The ice moves and converges, no guard fires, no kernel is launched
    on the CPU, and the NS wrap changes the result: the same step closed
    north-south differs."""
    (_, _), (tst, tfl) = runs[-1]
    raise_on_violation(tfl["_guards"])
    assert 0.001 < float(tst.uvel.abs().max()) < 2.0
    assert float(tfl["divu"].abs().max()) > 0.0
    aice = tst.aicen.sum(0)
    assert float(aice.min()) >= 0.0 and float(aice.max()) <= 1.0 + 1e-12
    assert float(aice[-1].mean()) > float(aice[0].mean()) > 0.0  # new ice
    assert evp_cuda.evp_subcycle.ns_cyclic_launches == 0

    # the NS wrap: the top row of U points is masked by the grid's
    # construction, so nothing crosses the seam, but the reconstruction
    # and the stress gating read across it
    cfg = TConfig().with_values(**{**BOX, "domain.ns_boundary_type":
                                   "closed"})
    model = tm.Model.create(cfg, device=CPU, dtype=F64)
    force = TAnalytic(cfg, model.grid, device=CPU, dtype=F64)
    (_, _), (closed, _) = runs[0]
    for n in range(NSTEPS):
        closed, _ = model(closed, force(_yday(n), 0.0), _yday(n), 0.0)
    assert float((tst.aicen - closed.aicen).abs().max()) > 1e-9


@pytest.mark.parametrize("damping", [False, True])
def test_one_ulp_moves_only_the_undamped_box(damping):
    """One step of the port from the initial state and from the same state
    with every nonzero vicen one ulp larger: undamped, the velocities move
    by about 18% of their scale (measured 1.8e-1); damped, by a few ulps
    (measured 2.6e-15)."""
    cfg = TConfig().with_values(**{**BOX, "dynamics.evp_damping": damping})
    model = tm.Model.create(cfg, device=CPU, dtype=F64)
    force = TAnalytic(cfg, model.grid, device=CPU, dtype=F64)
    state = init_state(cfg, model.grid, model.itd, device=CPU, dtype=F64)
    up = torch.nextafter(state.vicen, torch.full_like(state.vicen, 1.0e30))
    bumped = dataclasses.replace(
        state, vicen=torch.where(state.vicen > 0, up, state.vicen))
    f = force(_yday(0), 0.0)
    u0 = model(state, f, _yday(0), 0.0)[0].uvel
    u1 = model(bumped, f, _yday(0), 0.0)[0].uvel
    moved = float((u1 - u0).abs().max() / u0.abs().max())
    print(f"one ulp of vicen, evp_damping={damping}: the velocities moved "
          f"by {moved:.3e} of their scale")
    if damping:
        assert moved < 1e-13
    else:
        assert moved > 1e-2
