"""The tripole and tripoleT north folds of the port against the JAX
package, in f64 on the CPU.

The folds' values are held on an all-ocean grid (`grid.grid_type =
"column"`, 10 km cells from 69N, cyclic east-west), where ice, velocity
and stress reach the top row; on the ACCESS lat-lon grid the top row is
land and the fold carries only zeros.  Cross-fold wind as in
`tests/test_sharded_tripole.py`, and the damped EVP (`evp_damping`), as
every comparison of two implementations on the 10 km grid runs it
(`tests/test_torch_box.py` says why).

* the str8 north shifts `Nbr.n_str` / `ne_str` bit-equal to
  `JnpNbr.n_str` / `ne_str`;
* the plain subcycle loop `_evp_subcycle_plain`, the whole of `evp()`,
  the plain K0 and K12 (`ga_gsh_plain`, `k12_plain`) and
  `transport_remap` against JAX's (`use_pallas=False`), and two whole
  `ice_step`s, on the all-ocean grid and on `access_om_config(40, 32)`
  with ndte 8 (the setup of `tests/test_sharded_tripole.py`, on one
  device).  Tolerance: ``|torch - jax| <= 1e-10 * (|jax| + max|jax|)``
  of each field (the EVP subcycles and the steps carry the last bits the
  two packages' `sqrt` and sums round differently);
* the values read across the fold are nonzero where it is held.
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
from cice4_tpu.config import DynamicsConfig as JDyn
from cice4_tpu.config import access_om_config as j_access_om_config
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu.ops import evp as jevp
from cice4_tpu.ops import remap as jremap
from cice4_tpu.ops.remap_pallas import _construct_vmem as j_construct_vmem
from cice4_tpu_torch import convert, kernel_check
from cice4_tpu_torch import model as tm
from cice4_tpu_torch.config import Config as TConfig
from cice4_tpu_torch.config import DynamicsConfig as TDyn
from cice4_tpu_torch.config import access_om_config as t_access_om_config
from cice4_tpu_torch.io.forcing_data import AnalyticForcing as TAnalytic
from cice4_tpu_torch.ops import evp as tevp
from cice4_tpu_torch.ops import evp_cuda, remap_cuda
from cice4_tpu_torch.ops import remap as tremap
from cice4_tpu_torch.parallel import halo as thalo
from cice4_tpu_torch.state import STATE_FIELDS, init_state

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
RTOL = 1.0e-10
FOLDS = ["tripole", "tripoleT"]
NY, NX = 24, 32


def all_ocean(ns):
    """The all-ocean 10 km grid with a fold, as config overrides."""
    return {"domain.ny_global": NY, "domain.nx_global": NX,
            "domain.ew_boundary_type": "cyclic",
            "domain.ns_boundary_type": ns, "grid.grid_type": "column",
            "grid.lat_origin": 69.0, "grid.dx_rect": 10.0e3,
            "grid.dy_rect": 10.0e3, "forcing.atm_data_type": "analytic",
            "dynamics.evp_damping": True}


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, name, rtol=RTOL, scale_of=None):
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


def _grids(ns, umask_top=False):
    """(jax grid, port grid) of the all-ocean fold grid; with `umask_top`
    the top row of U points, which the grid's construction masks (it sees
    no ocean north of it), is ocean too, so that velocities and the U-fold
    reach it."""
    jgrid = jg.make_grid(JConfig().with_values(**all_ocean(ns)),
                         dtype=jnp.float64)
    if umask_top:
        umask = np.asarray(jgrid.umask).copy()
        umask[-1] = True
        jgrid = dataclasses.replace(jgrid, umask=jnp.asarray(umask))
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew="cyclic", ns=ns), device=CPU, dtype=F64)
    return jgrid, tgrid


def _src_row(ns):
    """The row the ghost row beyond the top row reads (CENTER scalars)."""
    return -1 if ns == "tripole" else -2


@pytest.mark.parametrize("ns", FOLDS)
@pytest.mark.parametrize("k", range(8))
def test_str8_shifts_equal(ns, k):
    f = np.random.RandomState(k).standard_normal((8, 5, 6))
    jn = jevp.JnpNbr(jevp.h.BoundaryConditions(ew="cyclic", ns=ns))
    tn = thalo.Nbr(thalo.BoundaryConditions(ew="cyclic", ns=ns))
    for name in ("n_str", "ne_str"):
        want = np.asarray(getattr(jn, name)(jnp.asarray(f), k))
        got = getattr(tn, name)(torch.from_numpy(f), k).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert np.abs(got[-1]).min() > 0.0   # the ghost row: the mirror's


@pytest.mark.parametrize("ns", FOLDS)
@pytest.mark.parametrize("ice", ["bands", "all"])
def test_plain_subcycle_matches_jnp(ns, ice):
    """`_evp_subcycle_plain` against `_evp_subcycle_jnp` on the kernel's
    own inputs (`kernel_check.evp_inputs`: ice and velocities on the top
    row), 12 damped subcycles; the top row's north str8 reads are the
    mirror row's pieces, and they are nonzero."""
    jgrid, tgrid = _grids(ns)
    args = kernel_check.evp_inputs(tgrid, seed=4, dtype=F64, ice=ice)
    jp = jevp.make_evp_params(JDyn(ndte=12, evp_damping=True), 3600.0)
    tp = tevp.make_evp_params(TDyn(ndte=12, evp_damping=True), 3600.0)
    want = jevp._evp_subcycle_jnp(jp, jgrid,
                                  *(jnp.asarray(a.numpy()) for a in args))
    before = evp_cuda.evp_subcycle.launches
    got = evp_cuda.evp_subcycle(tp, tgrid, *args)
    assert evp_cuda.evp_subcycle.launches == before
    w, g = kernel_check.evp_named(want), kernel_check.evp_named(got)
    for name in w:
        _close(g[name], w[name], name)
    assert float(np.abs(np.asarray(w["strintx"])[-1]).max()) > 0.0

    # the str8 pieces the top row reads across the fold, after a subcycle
    icet = args[1]
    nbr = thalo.Nbr(tgrid.bc)
    *_, str8, _ = tevp._stress_update(tp, tgrid, nbr, args[0], icet,
                                      *args[12:14], *args[14:17])
    for k in (2, 3, 5, 7):
        ghost = (nbr.n_str if k in (2, 5) else nbr.ne_str)(str8, k)[-1]
        assert float(ghost.abs().max()) > 0.0, k


def _evp_state(ny, nx, seed):
    """Ice on the northern half up to the top row, currents and a
    convergent wind across the fold."""
    rng = np.random.RandomState(seed)
    ncat = 5
    band = (np.arange(ny)[:, None] >= ny // 2) * np.ones((1, nx))
    aicen = rng.uniform(0.05, 0.2, (ncat, ny, nx)) * band
    vicen = aicen * rng.uniform(0.5, 3.0, (ncat, ny, nx))
    vsnon = aicen * rng.uniform(0.0, 0.3, (ncat, ny, nx))
    x = (np.arange(nx) - nx / 2) / nx
    st = dict(
        aicen=aicen, vicen=vicen, vsnon=vsnon,
        uvel=rng.uniform(-0.1, 0.1, (ny, nx)),
        vvel=rng.uniform(-0.1, 0.1, (ny, nx)),
        stressp=rng.uniform(-1e3, 1e3, (4, ny, nx)),
        stressm=rng.uniform(-1e3, 1e3, (4, ny, nx)),
        stress12=rng.uniform(-1e3, 1e3, (4, ny, nx)),
        iceumask=rng.rand(ny, nx) > 0.5)
    forcing = dict(
        uocn=rng.uniform(-0.1, 0.1, (ny, nx)),
        vocn=rng.uniform(-0.1, 0.1, (ny, nx)),
        ss_tltx=rng.uniform(-1e-6, 1e-6, (ny, nx)),
        ss_tlty=rng.uniform(-1e-6, 1e-6, (ny, nx)),
        strairxT=np.broadcast_to(-0.2 * np.sin(2 * np.pi * x)[None, :],
                                 (ny, nx)) * aicen.sum(0),
        strairyT=np.broadcast_to(0.1 * np.cos(4 * np.pi * x)[None, :],
                                 (ny, nx)) * aicen.sum(0))
    return st, forcing


@pytest.mark.parametrize("ns", FOLDS)
@pytest.mark.parametrize("sinw", [0.0, 0.3])
def test_evp_matches_jax(ns, sinw):
    """The whole of `evp()` (prep with the U-fold symmetrization on the
    tripole grid, 40 damped subcycles, finish) on the all-ocean grid with
    its top row of U points ocean; the caller's state is not written, and
    on the U-fold grid the top row's velocities come out symmetric."""
    jgrid, tgrid = _grids(ns, umask_top=True)
    st, fo = _evp_state(NY, NX, seed=5)
    kw = dict(ndte=40, evp_damping=True, sinw=sinw,
              cosw=float(np.sqrt(1.0 - sinw**2)))
    aice = st["aicen"].sum(0)
    aggs = (aice, st["vicen"].sum(0), st["vsnon"].sum(0), st["aicen"],
            st["vicen"], np.maximum(1.0 - aice, 0.0))
    forc = tuple(fo[k] for k in ("uocn", "vocn", "ss_tltx", "ss_tlty",
                                 "strairxT", "strairyT"))
    jcfg = JConfig().with_values(**all_ocean(ns))
    jst0 = js.zeros_state(jcfg, jgrid, dtype=jnp.float64)
    jst0 = jst0.replace(**{k: jnp.asarray(v) for k, v in st.items()})
    jst, jd = jevp.evp(jst0, jgrid, JDyn(**kw), 3600.0,
                       *(jnp.asarray(a) for a in aggs + forc))

    arrays = {k: (np.asarray(v) if not isinstance(v, dict)
                  else {kk: np.asarray(vv) for kk, vv in v.items()})
              for k, v in vars(jst0).items()}
    ts = convert.state_from_arrays(arrays, device=CPU, dtype=F64)
    before = {k: getattr(ts, k).clone()
              for k in ("uvel", "vvel", "stressp", "iceumask")}
    tst, td = tevp.evp(ts, tgrid, TDyn(**kw), 3600.0,
                       *(_t(a) for a in aggs + forc))
    for k, v in before.items():
        assert torch.equal(getattr(ts, k), v), k
    for k in ("uvel", "vvel", "stressp", "stressm", "stress12", "iceumask",
              "strocnxT", "strocnyT"):
        _close(getattr(tst, k), getattr(jst, k), k)
    assert set(jd) == set(td)
    for k in jd:
        _close(td[k], jd[k], k)
    top = tst.uvel[-1]
    assert float(top.abs().max()) > 0.0
    if ns == "tripole":
        mirror = torch.remainder(NX - 2 - torch.arange(NX), NX)
        # the same physical point stored twice, to roundoff
        assert float((top + top[mirror]).abs().max()) \
            <= 1e-12 * float(top.abs().max())


def _remap_state(ns, seed=3):
    """(jax state, port state, grids) with ice from the model's initial
    state and random velocities of up to 0.5 m/s everywhere, the top row
    included."""
    jgrid, tgrid = _grids(ns, umask_top=True)
    jcfg = JConfig().with_values(**all_ocean(ns))
    jmodel = jm.Model.create(jcfg)
    jstate = js.init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    rng = np.random.RandomState(seed)
    uv = {k: jnp.asarray(rng.uniform(-0.5, 0.5, (NY, NX)))
          for k in ("uvel", "vvel")}
    jstate = jstate.replace(**uv)
    arrays = {k: (np.asarray(v) if not isinstance(v, dict)
                  else {kk: np.asarray(vv) for kk, vv in v.items()})
              for k, v in vars(jstate).items()}
    return jgrid, tgrid, jstate, convert.state_from_arrays(
        arrays, device=CPU, dtype=F64)


@pytest.mark.parametrize("ns", FOLDS)
def test_ga_gsh_and_k12_plain_match_jnp(ns):
    """The plain K0 and K12 against the JAX package's XLA GA path
    (`_geom_accumulators` with the back-shift, `_construct_vmem`,
    `_flux_divergence_ga`), bit for bit or nearly; the GSH planes the top
    row reads across the fold (offsets with dj = -1) and the donors K12
    reads across it are nonzero."""
    jgrid, tgrid, jstate, tstate = _remap_state(ns)
    dt = 3600.0
    dx = -dt * tstate.uvel / tgrid.dxu
    dy = -dt * tstate.vvel / tgrid.dyu
    afac = tgrid.dxu * tgrid.dyu
    sh = jremap.JnpShift(jgrid.bc)
    GA = jremap._geom_accumulators(*(jnp.asarray(a.numpy())
                                     for a in (afac, dx, dy)), 2, sh)
    want = np.stack([np.asarray(jremap._shift_by_jnp(
        sh, jnp.stack([GA[off][k] + jnp.zeros((NY, NX)) for k in range(10)]),
        (-off[0], -off[1]))) for off in jremap.ALL_OFFSETS])
    gsh = remap_cuda.ga_gsh(dx, dy, afac, tgrid.bc, 2)
    _close(gsh, want, "gsh", rtol=1e-13)
    for o, off in enumerate(jremap.ALL_OFFSETS):
        if off[1] == -1:
            assert float(gsh[o, :, -1].abs().max()) > 0.0, off

    tracer_names = list(tstate.trcrn)
    meta = tremap._tracer_meta(tracer_names, tstate.eicen.shape[1],
                               tstate.esnon.shape[1])
    *_, mm, tm_ = kernel_check.remap_inputs(tgrid, seed=8, ncat=5,
                                            meta=meta, dtype=F64, ice="all")
    div, divt = remap_cuda.k12_divergence(gsh, tgrid.hm, mm, tm_, meta,
                                          tgrid.bc)
    GSH = {off: [jnp.asarray(want[o, k]) for k in range(10)]
           for o, off in enumerate(jremap.ALL_OFFSETS)}
    hm = jnp.asarray(tgrid.hm.numpy())
    for r in range(mm.shape[0]):   # the JAX path takes one row at a time
        rec = j_construct_vmem(jnp.asarray(mm[r].numpy()), hm,
                               jnp.asarray(tm_[r].numpy()), list(meta), sh)
        wdiv, wdivt = jremap._flux_divergence_ga(GSH, *rec, meta, sh)
        _close(div[r], wdiv, f"div[{r}]", rtol=1e-12)
        _close(divt[r], wdivt, f"divt[{r}]", rtol=1e-12)
    # the donors across the fold: the mirror row's mass
    assert float(mm[:, _src_row(ns)].abs().min()) > 0.0


@pytest.mark.parametrize("ns", FOLDS)
@pytest.mark.parametrize("order", [1, 2])
def test_transport_remap_matches_jax(ns, order):
    """`transport_remap` on the default route against the JAX package's
    XLA GA path; the split route refuses the fold and names the ROADMAP
    item."""
    jgrid, tgrid, jstate, tstate = _remap_state(ns)
    jst, ja0 = jremap.transport_remap(jstate, jgrid, 3600.0, order,
                                      use_pallas=False)
    tst, ta0 = tremap.transport_remap(tstate, tgrid, 3600.0, order)
    _close(ta0, ja0, "aice0")
    for k in ("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon"):
        _close(getattr(tst, k), getattr(jst, k), k)
    for k in jst.trcrn:
        _close(tst.trcrn[k], jst.trcrn[k], k)
    # mass moved across the fold: the top row changed
    moved = (tst.aicen - tstate.aicen)[:, -1].abs().max()
    assert float(moved) > 1e-6
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 item 5"):
        tremap.transport_remap(tstate, tgrid, 3600.0, order,
                               split_kernels=True)


def _cross_fold_wind(f, ny, nx, xp):
    """The spatially varying wind of tests/test_sharded_tripole.py."""
    x = xp.arange(nx, dtype=xp.float64)[None, :]
    y = xp.arange(ny, dtype=xp.float64)[:, None]
    uatm = 5.0 * xp.sin(2 * np.pi * x / nx) + 0.0 * y
    vatm = 3.0 * xp.cos(4 * np.pi * x / nx) + 0.02 * y
    return f.replace(uatm=uatm, vatm=vatm, wind=xp.sqrt(uatm**2 + vatm**2))


_SCALE_OF = {"fmelttn_ai": "fsurfn_ai", "melts": "congel",
             "meltt": "congel", "meltb": "congel", "snoice": "congel"}


def _step_configs(case):
    if case == "access-om-40x32":
        over = {"dynamics.ndte": 8}
        return (j_access_om_config(nx=40, ny=32).with_values(**over),
                t_access_om_config(nx=40, ny=32).with_values(**over))
    return (JConfig().with_values(**all_ocean("tripole")),
            TConfig().with_values(**all_ocean("tripole")))


@pytest.mark.parametrize("case", ["all-ocean-tripole", "access-om-40x32"])
def test_ice_step_matches_jax(case):
    """Two whole steps (`ice_step`: thermodynamics, EVP with the folds,
    remap across the fold, ridging) of the port against the JAX package,
    every state field and flux within 1e-10 of its scale; no kernel is
    launched on the CPU.  On the all-ocean grid the ice at the top row
    moves."""
    jcfg, tcfg = _step_configs(case)
    jgrid = jg.make_grid(jcfg, dtype=jnp.float64)
    assert jgrid.bc.ns == "tripole"
    jmodel = jm.Model.create(jcfg)
    jstate = js.init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    jforce = JAnalytic(jcfg, jgrid, jnp.float64)
    step = jm.make_step_fn(jmodel)

    tmodel = tm.Model.create(tcfg, device=CPU, dtype=F64)
    tstate = init_state(tcfg, tmodel.grid, tmodel.itd, device=CPU,
                        dtype=F64)
    tforce = TAnalytic(tcfg, tmodel.grid, device=CPU, dtype=F64)
    ny, nx = jgrid.ny, jgrid.nx
    launches = evp_cuda.evp_subcycle.launches, remap_cuda.ga_gsh.launches
    t0 = tstate
    for n in range(2):
        yday = 80.0 + n * 3600.0 / 86400.0
        jf = _cross_fold_wind(jforce(yday, 0.0), ny, nx, jnp)
        tf = _cross_fold_wind(tforce(yday, 0.0), ny, nx, torch)
        jstate, jfl = step(jstate, jgrid, jf, yday, 0.0)
        tstate, tfl = tmodel(tstate, tf, yday, 0.0)
        jax.block_until_ready(jstate.aicen)
    assert (evp_cuda.evp_subcycle.launches,
            remap_cuda.ga_gsh.launches) == launches

    for k in STATE_FIELDS:
        a, b = getattr(jstate, k), getattr(tstate, k)
        if isinstance(a, dict):
            for kk in a:
                _close(b[kk], a[kk], f"{k}.{kk}")
        else:
            _close(b, a, k)
    names = [k for k in jfl if not k.startswith("_")]
    assert set(names) <= set(tfl), set(names) - set(tfl)
    for k in names:
        _close(tfl[k], jfl[k], k, scale_of=jfl.get(_SCALE_OF.get(k)))
    assert float(tstate.uvel.abs().max()) > 0.0
    if case == "all-ocean-tripole":
        assert float((tstate.aicen - t0.aicen)[:, -1].abs().max()) > 0.0
