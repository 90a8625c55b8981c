"""The ACCESS component on the blocks of a mesh, on the CPU in float64.

* The component on a 2x2 `Mesh` in one process (one component a block,
  their intervals together in ``mesh.run``), on the 48x40 tripole grid of
  ``access_om_config`` over three coupling intervals, against the
  one-device component: every state field and export within 1e-11 of
  ``max(|x|, 1)``.  The decomposed step is not bit-equal on the CPU only
  because PyTorch's vectorised `exp`/`pow` round the body and the tail of
  a loop apart (``tests/test_torch_sharding.py``); that moves the fields
  by ~1e-13, where a step in bfloat16 moves them by ~1e-2.  Its
  exchanges are counted and timed as the span ``Exchange`` under the
  phase that calls them.
* The k-halo remap across the U-fold (the top row of blocks remaps the
  fold's full-width strip) equals the gathered remap of the same blocks
  bit for bit, on the all-ocean fold grid, where a ring of folded inputs
  alone does not (its folded gradients swap east and west), and on the
  ACCESS lat-lon grid.
* A planted guard violation raises `ConservationError` on its block
  alone, naming the cell's global (j, i), and no block gathers.
* The decomposed coupled interval against the benchmark's plain float64
  reference (``benchmark/reference``, which imports nothing of the port)
  on the seeded initial state and imports of ``access-om2-01.coupled`` at
  a 48x40 cut, the reference whole and in 8 full-width bands: every
  number of the cell's check within 1e-12 (the port's plain path in
  float64 is the reference's arithmetic; the cell's own limits are
  1e-3 and up, and a bfloat16 step reads ~1e-2).
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from cice4_tpu_torch import convert
from cice4_tpu_torch import coupling as tcpl
from cice4_tpu_torch.component import IceComponent
from cice4_tpu_torch.config import access_om_config, config_from_dict
from cice4_tpu_torch.guards import ConservationError, raise_on_violation, \
    record
from cice4_tpu_torch.kernel_check import coupler_fields
from cice4_tpu_torch.ops.remap import (transport_remap_gathered,
                                       transport_remap_sharded)
from cice4_tpu_torch.parallel.mesh import Mesh
from cice4_tpu_torch.state import STATE_FIELDS

torch.set_num_threads(1)
F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
NY, NX = 40, 48


def _quiet(*_a, **_k):
    return None


def _components(cfg, mesh):
    kw = dict(flavor="om", dtype=F64, log=_quiet, gfdl_surface_flux=True,
              device="cpu")
    one = IceComponent(cfg, **kw).initialize()
    blocks = [IceComponent(cfg, mesh=mesh, block=b, **kw).initialize()
              for b in range(mesh.nblocks)]
    return one, blocks


def _block_imports(imports, mesh, b):
    return {side: {k: mesh.scatter(v, b) for k, v in d.items()}
            for side, d in imports.items()}


def _close(x, y, name, tol=1e-11):
    if x.dtype == torch.bool:
        assert torch.equal(x, y), name
        return
    assert torch.isfinite(y).all(), name
    err = float(((x - y).abs() / x.abs().clamp(min=1.0)).max())
    assert err <= tol, (name, err)


def test_component_on_a_mesh_matches_one_device():
    cfg = access_om_config(NX, NY).with_values(**{
        "dynamics.ndte": 12, "run.dt": 3600.0, "run.diagfreq": 0})
    mesh = Mesh(2, 2)
    one, blocks = _components(cfg, mesh)
    assert blocks[3].runner.grid.tmask.shape == (NY // 2, NX // 2)
    for n in range(3):
        imports = {"a2i": coupler_fields(tcpl.A2I_FIELDS, NY, NX, 20 + n,
                                         device="cpu"),
                   "o2i": coupler_fields(tcpl.O2I_FIELDS, NY, NX, 30 + n,
                                         device="cpu")}
        want = one.run(imports, n_steps=1)
        got = mesh.run(lambda b: blocks[b].run(
            _block_imports(imports, mesh, b), n_steps=1))
        for side in ("i2o", "i2a"):
            for k, v in want[side].items():
                _close(v, mesh.assemble([g[side][k] for g in got]),
                       f"interval {n} {side}.{k}")
    for k in STATE_FIELDS:
        a = getattr(one.runner.state, k)
        parts = [getattr(c.runner.state, k) for c in blocks]
        if isinstance(a, dict):
            for kk in a:
                _close(a[kk], mesh.assemble([p[kk] for p in parts]),
                       f"{k}.{kk}")
        else:
            _close(a, mesh.assemble(parts), k)
    assert float(one.runner.state.uvel.abs().max()) > 0.0
    timers = blocks[0].runner.timers
    assert timers.counters["exchanges"] > 0
    spans = [p for p in timers.host_ns if p.endswith("/Exchange")]
    assert "Step/Dynamics/Exchange" in spans
    assert "Step/Dynamics/Advection/Exchange" in spans


def test_component_needs_one_block_of_its_mesh():
    cfg = access_om_config(NX, NY)
    with pytest.raises(ValueError, match="several blocks"):
        IceComponent(cfg, device="cpu", mesh=Mesh(2, 2)).initialize()


@pytest.mark.parametrize("grid_type", ["column", "latlon"])
def test_fold_remap_equals_the_gathered_remap(grid_type):
    cfg = access_om_config(NX, NY).with_values(**{
        "grid.grid_type": grid_type})
    from cice4_tpu_torch.grid import make_grid
    from cice4_tpu_torch.state import init_state, make_itd_params

    grid = make_grid(cfg, device="cpu", dtype=F64)
    state = init_state(cfg, grid, make_itd_params(cfg), device="cpu",
                       dtype=F64)
    g = torch.Generator().manual_seed(5)
    u, v = (0.3 * torch.randn(NY, NX, generator=g, dtype=F64)
            for _ in range(2))
    # ice everywhere on the ocean, uneven, so that the fold moves some
    r = 0.5 + 0.5 * torch.rand(NY, NX, generator=g, dtype=F64)
    a = torch.where(grid.tmask, 0.15 * r, 0.0).expand_as(state.aicen)
    state = state.replace(uvel=torch.where(grid.umask, u, 0.0),
                          vvel=torch.where(grid.umask, v, 0.0),
                          aicen=a.clone(), vicen=2.0 * a)
    mesh = Mesh(2, 2)
    gb, sb = convert.scatter_blocks(grid, mesh), \
        convert.scatter_blocks(state, mesh)
    dt = cfg.run.dt
    halo = mesh.run(lambda b: transport_remap_sharded(sb[b], gb[b], dt))
    gathered = mesh.run(lambda b: transport_remap_gathered(sb[b], gb[b],
                                                           dt))
    for (hs, ha), (gs, ga) in zip(halo, gathered):
        for k in ("aicen", "vicen", "vsnon", "eicen", "esnon", "tsfcn"):
            assert torch.equal(getattr(hs, k), getattr(gs, k)), k
        for k in gs.trcrn:
            assert torch.equal(hs.trcrn[k], gs.trcrn[k]), k
        assert torch.equal(ha, ga)
    moved = convert.gather_blocks([h[0] for h in halo], mesh).aicen
    assert float((moved - state.aicen).abs()[:, -6:].max()) > 0.0


def test_a_guard_violation_raises_on_its_block(monkeypatch):
    monkeypatch.setattr(Mesh, "allgather_blocks", lambda *a: pytest.fail(
        "a guard record gathered the blocks"))
    mesh = Mesh(2, 2)
    err = torch.zeros(3, NY, NX, dtype=F64)
    err[1, 27, 31] = 2.5                    # on block 3, the north-east
    err[2, 26, 30] = 1.5

    def check(b):
        e = mesh.scatter(err, b)
        try:
            raise_on_violation({"planted": record(e > 1.0, e)})
        except ConservationError as x:
            return str(x)
        return None

    said = mesh.run(check)
    assert said[:3] == [None, None, None]
    assert "planted: 2 cells violate; worst at (j=27, i=31)" in said[3]


def _cell_pieces():
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    from harness import cell, check, inputs
    from reference import step as ref_step
    from reference.state import make_itd_params

    traffic = json.loads((BENCH / "traffic" / "access-om2-01.coupled.json")
                         .read_text())
    config = json.loads((BENCH / "configs" / "access-om2-01.json")
                        .read_text())
    tree = cell.merged_tree(config["config"], traffic["settings"], {
        "domain.nx_global": NX, "domain.ny_global": NY,
        "dynamics.ndte": 3, "run.diagfreq": 0})
    return cell, check, inputs, ref_step, make_itd_params, traffic, tree


def test_decomposed_coupled_step_matches_the_reference():
    (cell, check, inputs, ref_step, make_itd_params, traffic,
     tree) = _cell_pieces()
    from harness.bands import Banded
    from harness.ranks import SOLO

    seed = 3_000_000_201
    cfg = config_from_dict(tree)
    c = traffic["component"]
    mesh = Mesh(2, 2)
    blocks = [IceComponent(cfg, flavor=c["flavor"], dtype=F64, log=_quiet,
                           gfdl_surface_flux=c["gfdl_surface_flux"],
                           device="cpu", mesh=mesh, block=b).initialize()
              for b in range(mesh.nblocks)]
    ref = ref_step.Reference(tree, device="cpu")
    factors = inputs.perturbation(seed, traffic["initial_state"],
                                  make_itd_params(ref.cfg).hin_max,
                                  cfg.domain.ncat, NY, NX, device="cpu")
    for b, comp in enumerate(blocks):
        r = comp.runner
        new = inputs.perturb_state(cell.fields_of(r.state),
                                   {k: mesh.scatter(v, b)
                                    for k, v in factors.items()})
        r.state = r.state.replace(**{k: new[k] for k in (
            "aicen", "vicen", "vsnon", "eicen", "esnon")})
    start = {k: (mesh.assemble([getattr(p.runner.state, k) for p in blocks])
                 if not isinstance(getattr(blocks[0].runner.state, k), dict)
                 else {kk: mesh.assemble([getattr(p.runner.state, k)[kk]
                                          for p in blocks])
                       for kk in getattr(blocks[0].runner.state, k)})
             for k in cell.STATE_FIELDS}
    imports = inputs.ImportBank(seed, traffic["imports"], ref.grid.tlat,
                                device="cpu").interval(0)
    got = mesh.run(lambda b: blocks[b].run(_block_imports(imports, mesh, b),
                                           n_steps=1))
    exports = {side: {k: mesh.assemble([g[side][k] for g in got])
                      for k in got[0][side]} for side in got[0]}
    post = {k: (mesh.assemble([getattr(p.runner.state, k) for p in blocks])
                if not isinstance(getattr(blocks[0].runner.state, k), dict)
                else {kk: mesh.assemble([getattr(p.runner.state, k)[kk]
                                         for p in blocks])
                      for kk in getattr(blocks[0].runner.state, k)})
            for k in cell.STATE_FIELDS}
    ref_start = inputs.perturb_state(ref.cold_start(), factors)
    assert check.widest(check.gaps(start, ref_start))[0] <= 1e-12
    for bands in (None, Banded(8, SOLO, _quiet)):
        rstate, rexports, _u, _aux = ref.interval(
            start, 0, imports, flavor=c["flavor"],
            gfdl=c["gfdl_surface_flux"], u_star=None, n_steps=1,
            start=ref_start, bands=bands)
        numbers = check.state_numbers(post, rstate)
        numbers.update(check.export_numbers(exports, rexports,
                                            ref.grid.tarea))
        for k, (v, field) in numbers.items():
            assert v <= 1e-12, (bands is not None, k, field, v)
    assert float(post["uvel"].abs().max()) > 0.0
