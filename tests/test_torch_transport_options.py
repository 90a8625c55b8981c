"""The port's transport options against the JAX package, in f64 on the
CPU: the departure-point midpoint correction (``l_dp_midpt``), the
fixed-area remap (``l_fixed_area``), the global conservation and
monotonicity checks, first-order upwind transport, and one whole gx1 step
with the four remap options at once.

* `_departure_midpoint` on the rectangular grid of
  `tests/test_torch_remap.py` (cyclic east-west, closed north-south) and
  on the all-ocean grid with a tripole or tripoleT fold, where the U
  corners' north shifts fold and flip the sign of the velocities;
* the fixed-area geometry (`edge_areas`, `geometry_gsh` with them) against the
  JAX package's prescribed edge areas and `_geom_accumulators(..., ea_e,
  ea_n)` back-shifted, on seeded velocities with a zero and a sign change
  along every row and column;
* `transport_remap` with each option and with all four against the JAX
  package's jitted `transport_remap`, 3 steps on the 48x24 grid of
  `tests/test_transport_checks.py`, guard counts equal; the monotonicity
  check fires at CFL > 1 as the JAX package's does;
* `transport_upwind` against the JAX package's;
* two gx1 steps at 24x32 with the four remap options, against the JAX
  step (one JAX compile).

Tolerance: ``|torch - jax| <= rtol * (|jax| + max|jax|)`` per field,
rtol 1e-12 for the functions and 1e-10 for the whole step (as
`tests/test_torch_options.py` holds its step).
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
from cice4_tpu.config import gx1_config as j_gx1_config
from cice4_tpu.config import gx3_config
from cice4_tpu.constants import FieldLoc, FieldType
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu.ops import remap as jremap
from cice4_tpu.ops import transport as jtransport
from cice4_tpu.parallel import halo as jhalo
from cice4_tpu.parallel.halo import BoundaryConditions as JBC
from cice4_tpu.state import make_itd_params
from cice4_tpu_torch import convert
from cice4_tpu_torch import model as tm
from cice4_tpu_torch.config import gx1_config as t_gx1_config
from cice4_tpu_torch.guards import raise_on_violation
from cice4_tpu_torch.io.forcing_data import AnalyticForcing as TAnalytic
from cice4_tpu_torch.ops import remap as tremap
from cice4_tpu_torch.ops import transport as ttransport
from cice4_tpu_torch.parallel.halo import Nbr
from cice4_tpu_torch.state import STATE_FIELDS
from tests.test_remap import blob_state

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
DT = 3600.0
NY, NX = 24, 32
# the JAX package's transport_remap keywords of each option set
FLAG_SETS = {
    "dp_midpt": {"dp_midpt": True},
    "fixed_area": {"fixed_area": True},
    "conservation_check": {"conservation_check": True},
    "monotonicity_check": {"monotonicity_check": True},
    "all_four": {"dp_midpt": True, "fixed_area": True,
                 "conservation_check": True, "monotonicity_check": True},
}


def _close(got, want, name, rtol=1e-12, scale_of=None):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    ref = want if scale_of is None else np.asarray(scale_of)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300,
                                 err_msg=name)


def _arrays(obj):
    return {k: (np.asarray(v) if not isinstance(v, dict)
                else {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in vars(obj).items()}


def _port_grid(jgrid):
    return convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=jgrid.bc.ew, ns=jgrid.bc.ns),
        device=CPU, dtype=F64)


def _grids(kind):
    """(jax grid, port grid): ``rect``, the rectangular 24x32 grid of
    tests/test_torch_remap.py; ``tripole``/``tripoleT``, the all-ocean 10
    km grid of tests/test_torch_tripole.py with that fold, its top row of
    U points ocean so that velocities reach the fold."""
    if kind == "rect":
        over = {"domain.ny_global": NY, "domain.nx_global": NX,
                "domain.ew_boundary_type": "cyclic",
                "domain.ns_boundary_type": "closed",
                "grid.grid_type": "rectangular", "grid.lat_origin": 62.0}
    else:
        over = {"domain.ny_global": NY, "domain.nx_global": NX,
                "domain.ew_boundary_type": "cyclic",
                "domain.ns_boundary_type": kind, "grid.grid_type": "column",
                "grid.lat_origin": 69.0, "grid.dx_rect": 10.0e3,
                "grid.dy_rect": 10.0e3}
    jgrid = jg.make_grid(JConfig().with_values(**over), dtype=jnp.float64)
    if kind != "rect":
        umask = np.asarray(jgrid.umask).copy()
        umask[-1] = True
        jgrid = dataclasses.replace(jgrid, umask=jnp.asarray(umask))
    return jgrid, _port_grid(jgrid)


def _velocities(ny, nx, seed, vmax=0.5):
    """Seeded (u, v) of up to `vmax` m/s, with a zero and a sign change in
    every row and every column."""
    rng = np.random.RandomState(seed)
    u, v = (rng.uniform(-vmax, vmax, (ny, nx)) for _ in range(2))
    for f in (u, v):
        f[np.arange(ny), rng.randint(0, nx, ny)] = 0.0
        f[rng.randint(0, ny, nx), np.arange(nx)] = 0.0
        f[:, ::2] = np.abs(f[:, ::2])
        f[:, 1::2] = -np.abs(f[:, 1::2])
    return u, v


def _displacements(grid, u, v):
    return -DT * u / grid.dxu, -DT * v / grid.dyu, grid.dxu * grid.dyu


@pytest.mark.parametrize("kind", ["rect", "tripole", "tripoleT"])
def test_departure_midpoint_matches_jax(kind):
    jgrid, tgrid = _grids(kind)
    u, v = _velocities(NY, NX, seed=11)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.tensor(u), torch.tensor(v)
    jdx, jdy, _ = _displacements(jgrid, ju, jv)
    tdx, tdy, _ = _displacements(tgrid, tu, tv)
    want = jremap._departure_midpoint(ju, jv, jdx, jdy, DT, jgrid, jgrid.bc)
    got = tremap._departure_midpoint(tu, tv, tdx, tdy, DT, tgrid,
                                     Nbr(tgrid.bc))
    for name, g, w, first in zip(("dx", "dy"), got, want, (jdx, jdy)):
        _close(g, w, name)
        # the correction acts, and leaves the resting corners alone
        moved = np.asarray(w) != np.asarray(first)
        assert moved.sum() > NY * NX // 2, name
        rest = (u == 0.0) & (v == 0.0)
        np.testing.assert_array_equal(g.numpy()[rest],
                                      np.asarray(first)[rest])
    if kind != "rect":
        # the top row reads its north corners across the fold
        assert float(np.abs(np.asarray(want[0])[-1]).max()) > 0.0


def _jax_edge_areas(jgrid, ju, jv):
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)
    return ((ju + jhalo.nbr_s(ju, jgrid.bc, **kw)) * 0.5 * jgrid.hte * DT,
            (jv + jhalo.nbr_w(jv, jgrid.bc, **kw)) * 0.5 * jgrid.htn * DT)


@pytest.mark.parametrize("kind,order", [("rect", 1), ("rect", 2),
                                        ("rect", 3), ("tripole", 2),
                                        ("tripoleT", 2)])
def test_fixed_area_gsh_matches_jax(kind, order):
    jgrid, tgrid = _grids(kind)
    u, v = _velocities(NY, NX, seed=5)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.tensor(u), torch.tensor(v)
    jea = _jax_edge_areas(jgrid, ju, jv)
    tea = tremap.edge_areas(tu, tv, tgrid, DT, Nbr(tgrid.bc))
    for name, g, w in zip(("ea_e", "ea_n"), tea, jea):
        _close(g, w, name)
    jdx, jdy, jafac = _displacements(jgrid, ju, jv)
    tdx, tdy, tafac = _displacements(tgrid, tu, tv)
    sh = jremap.JnpShift(jgrid.bc)
    GA = jremap._geom_accumulators(jafac, jdx, jdy, order, sh, *jea)
    zero = jnp.zeros_like(jafac)
    want = np.stack([np.asarray(jremap._shift_by_jnp(
        sh, jnp.stack([GA[off][k] + zero for k in range(10)]),
        (-off[0], -off[1]))) for off in jremap.ALL_OFFSETS])
    got = tremap.geometry_gsh(tdx, tdy, tafac, tgrid.bc, order, *tea)
    _close(got, want, "gsh")
    # the area matching moves the geometry away from the free-area one
    free = tremap.geometry_gsh(tdx, tdy, tafac, tgrid.bc, order)
    assert float((got - free).abs().max()) > 1e-6 * float(got.abs().max())


@pytest.fixture(scope="module")
def checks_setup():
    """The 48x24 grid of tests/test_transport_checks.py (cyclic east-west,
    open north-south, 20 km cells) with its Gaussian blob of ice, moved by
    a swirl that changes sign across the grid, in both packages."""
    cfg = gx3_config()
    bc = JBC(ew="cyclic", ns="open")
    jgrid = jg.make_rect_grid(48, 24, bc, dx=20.0e3, dy=20.0e3,
                              land_edges=False, dtype=jnp.float64)
    itd = make_itd_params(cfg)
    s = blob_state(cfg, jgrid, itd)
    x = jnp.arange(jgrid.nx)[None, :] / jgrid.nx
    y = jnp.arange(jgrid.ny)[:, None] / jgrid.ny
    uvel = 0.3 + 0.25 * jnp.sin(6.28 * y) * jnp.cos(6.28 * x)
    vvel = 0.2 * jnp.sin(6.28 * x) * jnp.sin(3.14 * y)
    s = s.replace(uvel=uvel.at[0].set(0.0).at[-1].set(0.0),
                  vvel=vvel.at[0].set(0.0).at[-1].set(0.0))
    return jgrid, s


def _run_remap(jgrid, jstate, tgrid, tstate, flags, nsteps):
    """`nsteps` transport steps of both packages; returns [(jax out, port
    out)] per step."""
    jstep = jax.jit(lambda st: jremap.transport_remap(
        st, jgrid, DT, 2, use_pallas=False, **flags))
    out = []
    for _ in range(nsteps):
        jo = jstep(jstate)
        to = tremap.transport_remap(tstate, tgrid, DT, 2, **flags)
        jstate, tstate = jo[0], to[0]
        out.append((jo, to))
    return out


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_transport_remap_options_match_jax(checks_setup, name):
    jgrid, jstate = checks_setup
    tgrid = _port_grid(jgrid)
    tstate = convert.state_from_arrays(_arrays(jstate), device=CPU,
                                       dtype=F64)
    flags = FLAG_SETS[name]
    checks = flags.get("conservation_check") or flags.get(
        "monotonicity_check")
    for n, (jo, to) in enumerate(_run_remap(jgrid, jstate, tgrid, tstate,
                                            flags, 3)):
        assert len(to) == len(jo) == (3 if checks else 2)
        (jst, ja0), (tst, ta0) = jo[:2], to[:2]
        _close(ta0, ja0, f"step {n} aice0")
        for k in ("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon"):
            _close(getattr(tst, k), getattr(jst, k), f"step {n} {k}")
        for k in jst.trcrn:
            _close(tst.trcrn[k], jst.trcrn[k], f"step {n} {k}")
        if checks:
            assert to[2].keys() == jo[2].keys()
            for g, rec in jo[2].items():
                assert int(to[2][g]["count"]) == int(rec["count"]) == 0, g
                assert isinstance(to[2][g]["count"], torch.Tensor)
    if flags.get("conservation_check"):
        largest = float(to[2]["transport global conservation"]["largest"])
        assert 0.0 <= largest < 1e-12


def test_monotonicity_check_fires_at_cfl_above_one(checks_setup):
    """As tests/test_transport_checks.py: a velocity of CFL > 1 breaks the
    scheme's monotonicity premise, and both packages count the same
    violations."""
    jgrid, jstate = checks_setup
    jstate = jstate.replace(uvel=jnp.full_like(jstate.uvel, 9.0),
                            vvel=jnp.zeros_like(jstate.vvel))
    tgrid = _port_grid(jgrid)
    tstate = convert.state_from_arrays(_arrays(jstate), device=CPU,
                                       dtype=F64)
    (jo, to), = _run_remap(jgrid, jstate, tgrid, tstate,
                           {"monotonicity_check": True}, 1)
    want = jo[2]["transport monotonicity"]
    got = to[2]["transport monotonicity"]
    assert int(got["count"]) == int(want["count"]) > 0
    assert (int(got["j"]), int(got["i"])) == (int(want["j"]), int(want["i"]))
    _close(got["worst"], want["worst"], "worst")


@pytest.mark.parametrize("kind", ["rect", "open"])
def test_transport_upwind_matches_jax(checks_setup, kind):
    if kind == "open":
        jgrid, jstate = checks_setup
    else:
        jgrid, _ = _grids("rect")
        jcfg = JConfig().with_values(**{
            "domain.ny_global": NY, "domain.nx_global": NX,
            "domain.ns_boundary_type": "closed",
            "grid.grid_type": "rectangular", "grid.lat_origin": 62.0})
        jstate = js.init_state(jcfg, jgrid, make_itd_params(jcfg),
                               dtype=jnp.float64)
        u, v = _velocities(NY, NX, seed=2, vmax=0.3)
        jstate = jstate.replace(uvel=jnp.asarray(u) * jgrid.umask,
                                vvel=jnp.asarray(v) * jgrid.umask)
    tgrid = _port_grid(jgrid)
    tstate = convert.state_from_arrays(_arrays(jstate), device=CPU,
                                       dtype=F64)
    for a, b in zip(ttransport.edge_velocities(tgrid, tstate.uvel,
                                               tstate.vvel),
                    jtransport.edge_velocities(jgrid, jstate.uvel,
                                               jstate.vvel)):
        _close(a, b, "edge velocity")
    jstep = jax.jit(lambda st: jtransport.transport_upwind(st, jgrid, DT))
    for n in range(2):
        jstate, ja0 = jstep(jstate)
        tst, ta0 = ttransport.transport_upwind(tstate, tgrid, DT)
        _close(ta0, ja0, f"step {n} aice0")
        for k in ("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon"):
            _close(getattr(tst, k), getattr(jstate, k), f"step {n} {k}")
        for k in jstate.trcrn:
            _close(tst.trcrn[k], jstate.trcrn[k], f"step {n} {k}")
        assert float((tst.aicen - tstate.aicen).abs().max()) > 1e-6
        tstate = tst


# the whole step: the four remap options at once
STEP_OPTIONS = {"grid.kmt_file": "", "domain.ny_global": NY,
                "domain.nx_global": NX, "transport.l_dp_midpt": True,
                "transport.l_fixed_area": True,
                "transport.conservation_check": True,
                "transport.monotonicity_check": True}
# roundoff-sized differences take the scale of the terms they come from
_SCALE_OF = {"fmelttn_ai": "fsurfn_ai", "melts": "congel",
             "meltt": "congel", "meltb": "congel", "snoice": "congel"}
_TENDENCY_OF = {"daidtt": "aicen", "daidtd": "aicen", "dvidtt": "vicen",
                "dvidtd": "vicen"}


def check_step(n, jst, jfl, tst, tfl, rtol=1e-10):
    """Every state field and flux of step `n` of both packages within
    `rtol` of its scale (as tests/test_torch_options.py), and the same
    guard records with the same counts."""
    for k in STATE_FIELDS:
        a, b = getattr(jst, k), getattr(tst, k)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), k
            for kk in a:
                _close(b[kk], a[kk], f"step {n} {k}.{kk}", rtol)
        else:
            _close(b, a, f"step {n} {k}", rtol)
    names = [k for k in jfl if not k.startswith("_")]
    assert set(names) <= set(tfl), set(names) - set(tfl)
    for k in names:
        scale_of = jfl.get(_SCALE_OF.get(k))
        if k in _TENDENCY_OF:
            scale_of = np.asarray(getattr(jst, _TENDENCY_OF[k])).sum(0) / DT
        _close(tfl[k], jfl[k], f"step {n} {k}", rtol, scale_of=scale_of)
    assert jfl["_guards"].keys() == tfl["_guards"].keys()
    for name, rec in jfl["_guards"].items():
        assert int(rec["count"]) == int(tfl["_guards"][name]["count"]), name


def run_steps_both(over, nsteps=2, yday0=80.0):
    """`nsteps` gx1 steps of both packages under the config overrides
    `over` from the same initial state; yields (n, jax state, jax fluxes,
    port state, port fluxes).  One JAX compile of the step."""
    jcfg = j_gx1_config().with_values(**over)
    jgrid = jg.make_grid(jcfg, dtype=jnp.float64)
    jmodel = jm.Model.create(jcfg)
    jstate = js.init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    jforce = JAnalytic(jcfg, jgrid, jnp.float64)
    step = jm.make_step_fn(jmodel)

    tmodel = tm.Model(t_gx1_config().with_values(**over), _port_grid(jgrid))
    tstate = convert.state_from_arrays(_arrays(jstate), device=CPU,
                                       dtype=F64)
    tforce = TAnalytic(tmodel.cfg, tmodel.grid, device=CPU, dtype=F64)
    for n in range(nsteps):
        yday = yday0 + n * DT / 86400.0
        jstate, jfl = step(jstate, jgrid, jforce(yday, 0.0), yday, 0.0)
        tstate, tfl = tmodel(tstate, tforce(yday, 0.0), yday, 0.0)
        jax.block_until_ready(jstate.aicen)
        yield n, jstate, jfl, tstate, tfl


def test_step_with_remap_options_matches_jax():
    for n, jst, jfl, tst, tfl in run_steps_both(STEP_OPTIONS):
        check_step(n, jst, jfl, tst, tfl)
        assert {"transport monotonicity",
                "transport global conservation"} <= set(tfl["_guards"])
        raise_on_violation(tfl["_guards"])
    assert 0.0 < float(tst.uvel.abs().max()) < 2.0
