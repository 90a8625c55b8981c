"""The decomposed model step (`ice_step` on the blocks of a mesh, in one
process) on the CPU, in f64.

* Against the JAX package's step on its 8-device mesh, on the setup of
  ``tests/test_sharding.py`` (the 32x16 rectangular grid, ndte 20, the
  spatially varying wind), within that file's tolerances
  (``:121-148``): 1e-7 on the area, volume, snow and velocity, 1e-5 on
  the surface temperature, 1e-4 on the SST, 1e-7 of the scale on the
  energies, the stresses bounded.
* Against the port's one-device step: the tripole U-fold of
  ``access_om_config(40, 32)`` (``tests/test_sharded_tripole.py``, within
  1e-11 of ``max(|x|, 1)``, with the k-halo EVP engaged and the remap
  k-halo), the gx1 lat-lon cut with the guards on, and the upwind
  transport (the block shifts): within 1e-11 with the ridging and thermo
  iteration counts equal (the loop exits are reductions over the
  blocks).  The state is not bit-equal on the CPU only because PyTorch's
  vectorised `exp`/`pow` round the body and the tail of a loop
  differently, and the tails fall elsewhere in a smaller block.
* The guard records of a block are its own, its worst cell at its
  global (j, i); the runtime diagnostics of a block are the global ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu_torch import convert
from cice4_tpu_torch import model as tm
from cice4_tpu_torch.config import Config, access_om_config, gx1_config
from cice4_tpu_torch.io.forcing_data import AnalyticForcing
from cice4_tpu_torch.parallel import halo as h
from cice4_tpu_torch.parallel.mesh import Mesh
from cice4_tpu_torch.state import STATE_FIELDS, init_state

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")


def _arrays(obj):
    def arr(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: np.asarray(x) for k, x in v.items()}
        return np.asarray(v)

    return {k: arr(v) for k, v in vars(obj).items()}


def _blocks_run(cfg, grid, state, forcings, shape, ydays):
    """Steps of `ice_step` on the blocks of a `shape` mesh; returns the
    global state and each block's last flux dict."""
    mesh = Mesh(*shape)
    grids = convert.scatter_blocks(grid, mesh)
    models = [tm.Model(cfg, g) for g in grids]
    states = convert.scatter_blocks(state, mesh)
    fluxes = None
    for f, yday in zip(forcings, ydays):
        fb = convert.scatter_blocks(f, mesh)
        outs = mesh.run(lambda b: models[b](states[b], fb[b], yday, 0.0))
        states = [o[0] for o in outs]
        fluxes = [o[1] for o in outs]
    return convert.gather_blocks(states, mesh), fluxes


def test_decomposed_step_matches_jax_eight_devices():
    from cice4_tpu.config import Config as JConfig
    from cice4_tpu.forcing import default_forcing as j_default_forcing
    from cice4_tpu.grid import make_grid as j_make_grid
    from cice4_tpu.model import Model as JModel
    from cice4_tpu.model import ice_step as j_ice_step
    from cice4_tpu.parallel.mesh import make_mesh, shard_pytree
    from cice4_tpu.state import init_state as j_init_state

    over = {"domain.nx_global": 32, "domain.ny_global": 16,
            "grid.grid_type": "rectangular", "grid.lat_origin": 66.0,
            "dynamics.ndte": 20, "transport.advection": "remap"}
    jcfg = JConfig().with_values(**over)
    jgrid = j_make_grid(jcfg, dtype=jnp.float64)
    jmodel = JModel.create(jcfg)
    jstate = j_init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    f = j_default_forcing(jgrid.ny, jgrid.nx, jnp.float64)
    x = jnp.arange(jgrid.nx, dtype=jnp.float64)[None, :]
    y = jnp.arange(jgrid.ny, dtype=jnp.float64)[:, None]
    uatm = 4.0 + 3.0 * jnp.sin(2 * jnp.pi * x / jgrid.nx) + 0.0 * y
    vatm = 1.0 + 2.0 * jnp.cos(2 * jnp.pi * y / jgrid.ny) + 0.0 * x
    f = f.replace(uatm=uatm, vatm=vatm, wind=jnp.sqrt(uatm**2 + vatm**2),
                  swvdr=f.swvdr + 40.0, swvdf=f.swvdf + 40.0)
    mesh = make_mesh(8)

    # the program of tests/test_sharding.py's full-step test, so that the
    # persistent compilation cache can serve it
    def step(state, grid, forcing):
        return j_ice_step(jmodel, state, grid, forcing, 80.0, 0.0)

    s8, _ = jax.jit(step)(shard_pytree(jstate, mesh),
                          shard_pytree(jgrid, mesh), shard_pytree(f, mesh))
    jax.block_until_ready(s8.aicen)

    cfg = Config().with_values(**over)
    grid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=jgrid.bc.ew, ns=jgrid.bc.ns),
        device=CPU, dtype=F64)
    state = convert.state_from_arrays(_arrays(jstate), device=CPU,
                                      dtype=F64)
    tf = convert.forcing_from_arrays(_arrays(f), device=CPU, dtype=F64)
    got, _ = _blocks_run(cfg, grid, state, [tf], (2, 2), [80.0])

    tols = dict(aicen=1e-7, vicen=1e-7, vsnon=1e-7, tsfcn=1e-5,
                uvel=1e-7, vvel=1e-7, sst=1e-4)
    for name, atol in tols.items():
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(s8, name)), rtol=0,
                                   atol=atol, err_msg=name)
    for name in ("eicen", "esnon"):
        a = np.asarray(getattr(s8, name))
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(getattr(got, name).numpy(), a, rtol=0,
                                   atol=1e-7 * scale, err_msg=name)
    assert float(got.stressp.abs().max()) < 1.0e6


def _cross_fold_wind(f, ny, nx):
    x = torch.arange(nx, dtype=F64)[None, :]
    y = torch.arange(ny, dtype=F64)[:, None]
    uatm = 5.0 * torch.sin(2 * np.pi * x / nx) + 0.0 * y
    vatm = 3.0 * torch.cos(4 * np.pi * x / nx) + 0.02 * y
    return f.replace(uatm=uatm, vatm=vatm, wind=torch.sqrt(uatm**2
                                                           + vatm**2))


CASES = {
    # (config, mesh, the EVP and remap paths' gathered counts per step)
    "access-om-40x32": (access_om_config(nx=40, ny=32).with_values(
        **{"dynamics.ndte": 8}), (2, 2), {"evp": 0, "remap": 0}),
    "gx1-24x32-guards": (gx1_config().with_values(**{
        "grid.kmt_file": "", "domain.ny_global": 24,
        "domain.nx_global": 32, "dynamics.ndte": 24,
        "run.guards": True}), (2, 2), {"evp": 0, "remap": 0}),
    "access-om-upwind": (access_om_config(nx=40, ny=32).with_values(
        **{"dynamics.ndte": 8, "transport.advection": "upwind"}), (2, 2),
        {"evp": 0, "remap": 0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decomposed_steps_match_one_device(case):
    cfg, shape, gathered = CASES[case]
    model = tm.Model.create(cfg, device=CPU, dtype=F64)
    grid = model.grid
    state = init_state(cfg, grid, model.itd, device=CPU, dtype=F64)
    forcing = AnalyticForcing(cfg, grid, device=CPU, dtype=F64)
    ydays = [80.0 + n * cfg.run.dt / 86400.0 for n in range(2)]
    forcings = [_cross_fold_wind(forcing(d, 0.0), grid.ny, grid.nx)
                for d in ydays]
    ref = state
    for f, d in zip(forcings, ydays):
        ref, ref_fl = model(ref, f, d, 0.0)
    before = dict(h.gathered_phase.names)
    got, fluxes = _blocks_run(cfg, grid, state, forcings, shape, ydays)
    for k, n in gathered.items():
        assert h.gathered_phase.names.get(k, 0) - before.get(k, 0) \
            == 2 * n, k

    for fl in fluxes:
        assert fl["_ridge_niter"] == ref_fl["_ridge_niter"]
        assert int(fl["_thermo_niter"]) == int(ref_fl["_thermo_niter"])
    # each block's guard records are its own: their counts sum to one
    # device's
    for name, rec in ref_fl["_guards"].items():
        assert sum(int(fl["_guards"][name]["count"]) for fl in fluxes) \
            == int(rec["count"]), name
    for k in STATE_FIELDS:
        a, b = getattr(ref, k), getattr(got, k)
        pairs = ([(f"{k}.{kk}", a[kk], b[kk]) for kk in a]
                 if isinstance(a, dict) else [(k, a, b)])
        for name, x, y in pairs:
            assert torch.isfinite(y.to(F64)).all(), name
            if x.dtype == torch.bool:
                assert torch.equal(x, y), name
                continue
            err = float(((x - y).abs() / x.abs().clamp(min=1.0)).max())
            assert err < 1e-11, (name, err)
    assert float(got.uvel.abs().max()) > 0.0


def test_guard_records_and_diagnostics_are_global():
    from cice4_tpu_torch.diagnostics import runtime_diags
    from cice4_tpu_torch.guards import record

    cfg = gx1_config().with_values(**{"grid.kmt_file": "",
                                      "domain.ny_global": 24,
                                      "domain.nx_global": 32})
    model = tm.Model.create(cfg, device=CPU, dtype=F64)
    grid = model.grid
    state = init_state(cfg, grid, model.itd, device=CPU, dtype=F64)
    g = torch.Generator().manual_seed(2)
    err = torch.rand(3, grid.ny, grid.nx, generator=g, dtype=F64)
    bad = err > 0.9
    want = record(bad, err)
    want_d = runtime_diags(state, grid)
    mesh = Mesh(2, 2)
    grids = convert.scatter_blocks(grid, mesh)
    states = convert.scatter_blocks(state, mesh)

    def work(b):
        return (record(mesh.scatter(bad, b), mesh.scatter(err, b)),
                runtime_diags(states[b], grids[b]))

    got = mesh.run(work)
    # each block's record is its own, its worst cell at its global (j, i):
    # the counts sum to the global one and the worst block's record is
    # the global record
    assert sum(int(rec["count"]) for rec, _d in got) == int(want["count"])
    worst = max((rec for rec, _d in got), key=lambda r: float(r["worst"]))
    for k in ("j", "i", "worst"):
        assert float(worst[k]) == float(want[k]), k
    for _rec, diags in got:
        for k, v in want_d.items():
            assert abs(float(diags[k]) - float(v)) <= 1e-12 * max(
                abs(float(v)), 1e-300), k
