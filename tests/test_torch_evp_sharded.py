"""The k-halo EVP and remap of a decomposed grid (`ops/evp_sharded.py`,
`ops/remap.py` `transport_remap_sharded`) on the CPU, in f64.

* The port's EVP on 2x2 blocks in one process against the JAX package's
  `evp_subcycle_sharded` on its 8-device mesh (the setup of
  ``tests/test_evp_sharded.py``): velocities, ocean stress, the internal
  stress and the ridging diagnostics within 1e-10 of their scale
  (``max(max|x|, 1)``, as ``tests/test_sharding.py`` scales), stresses
  within 1e-9, or within twice the JAX package's own difference between
  its one-device and 8-device EVP where that is larger: on this grid's
  zero-strain interior the replacement pressure divides by `tinyarea`
  and amplifies last-bit differences (``tests/test_sharding.py``'s
  docstring), and JAX's two compilations differ by up to 1.0e-8 of the
  stress scale and 6.9e-10 of `strinty`'s.  Against the port's own
  one-device EVP bit for bit (the blocks run the same per-cell
  arithmetic on padded blocks).
* The eligibility gates against the JAX package's, and the gathered path
  taken and counted where they refuse, bit-equal to one device.
* `transport_remap_sharded` against the one-device `transport_remap`,
  bit for bit (JAX's ``cice4_tpu/ops/remap.py:1277-1279`` claims the
  same), for each transport option.
* On the card (`gpu`): the round kernel against its plain version, and
  the k-halo EVP against the one-device launch.  The file
  imports JAX only inside the tests that use it, so that these run where
  JAX is absent: ``python -m pytest --noconftest -m gpu
  tests/test_torch_evp_sharded.py``.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cice4_tpu_torch import convert, kernel_check
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.forcing import default_forcing
from cice4_tpu_torch.grid import make_grid
from cice4_tpu_torch.ops import evp_sharded, itd as itd_ops
from cice4_tpu_torch.ops.evp import _evp_rounds_plain, evp, make_evp_params
from cice4_tpu_torch.ops.remap import (FOLD_STRIP, remap_sharded_eligible,
                                       transport_remap,
                                       transport_remap_sharded)
from cice4_tpu_torch.parallel import halo as h
from cice4_tpu_torch.parallel.mesh import Mesh
from cice4_tpu_torch.state import init_state, make_itd_params

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
SETUP = {"domain.nx_global": 32, "domain.ny_global": 16,
         "domain.ew_boundary_type": "cyclic",
         "domain.ns_boundary_type": "open",
         "grid.grid_type": "rectangular", "grid.lat_origin": 66.0,
         "dynamics.ndte": 24, "transport.advection": "remap"}


def _wind(f, ny, nx, xp):
    if xp is torch:
        kw = dict(dtype=f.uatm.dtype, device=f.uatm.device)
    else:
        kw = dict(dtype=xp.float64)
    x = xp.arange(nx, **kw)[None, :]
    y = xp.arange(ny, **kw)[:, None]
    uatm = 4.0 + 3.0 * xp.sin(2 * np.pi * x / nx) + 0.0 * y
    vatm = 1.0 + 2.0 * xp.cos(2 * np.pi * y / ny) + 0.0 * x
    return f.replace(uatm=uatm, vatm=vatm, wind=xp.sqrt(uatm**2 + vatm**2))


def _arrays(obj):
    """A JAX State or Forcing as the dict of numpy arrays `convert` takes."""
    def arr(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: np.asarray(x) for k, x in v.items()}
        return np.asarray(v)

    return {k: arr(v) for k, v in vars(obj).items()}


def _evp_args(state, grid, f):
    agg = itd_ops.aggregate(state, grid.tmask)
    return (agg["aice"], agg["vice"], agg["vsno"], state.aicen, state.vicen,
            torch.clamp(1.0 - agg["aice"], min=0.0), f.uocn, f.vocn,
            f.ss_tltx, f.ss_tlty,
            0.0012 * 1.3 * f.wind * f.uatm * agg["aice"],
            0.0012 * 1.3 * f.wind * f.vatm * agg["aice"])


def _port_setup(over=None):
    cfg = Config().with_values(**{**SETUP, **(over or {})})
    grid = make_grid(cfg, device=CPU, dtype=F64)
    state = init_state(cfg, grid, make_itd_params(cfg), device=CPU,
                       dtype=F64)
    f = _wind(default_forcing(grid.ny, grid.nx, device=CPU, dtype=F64),
              grid.ny, grid.nx, torch)
    return cfg, grid, state, f


def _evp_blocks(cfg, grid, state, f, shape):
    """The port's `evp` on the blocks of a `shape` mesh, put back
    together: (state, diag) as global tensors."""
    mesh = Mesh(*shape)
    gb, sb, fb = (convert.scatter_blocks(x, mesh) for x in (grid, state, f))

    def work(b):
        return evp(sb[b], gb[b], cfg.dynamics, cfg.run.dt,
                   *_evp_args(sb[b], gb[b], fb[b]))

    outs = mesh.run(work)
    st = convert.gather_blocks([o[0] for o in outs], mesh)
    diag = {k: mesh.assemble([o[1][k] for o in outs])
            for k in outs[0][1] if outs[0][1][k].ndim >= 2}
    return st, diag


def _equal(a, b, name):
    assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.fixture(scope="module")
def evp_runs():
    """The JAX package's sharded EVP on 8 devices, the port's on 2x2
    blocks and on one device, from the same inputs."""
    import jax
    import jax.numpy as jnp

    from cice4_tpu import grid as jg
    from cice4_tpu import state as js
    from cice4_tpu.config import Config as JConfig
    from cice4_tpu.forcing import default_forcing as j_default_forcing
    from cice4_tpu.model import Model as JModel
    from cice4_tpu.ops import evp as j_evp
    from cice4_tpu.ops import itd as j_itd
    from cice4_tpu.parallel.mesh import (make_mesh, set_active_mesh,
                                         shard_pytree)

    jcfg = JConfig().with_values(**SETUP)
    jgrid = jg.make_grid(jcfg, dtype=jnp.float64)
    jmodel = JModel.create(jcfg)
    jstate = js.init_state(jcfg, jgrid, jmodel.itd, dtype=jnp.float64)
    jf = _wind(j_default_forcing(jgrid.ny, jgrid.nx, jnp.float64),
               jgrid.ny, jgrid.nx, jnp)
    agg = j_itd.aggregate(jstate, jgrid.tmask)
    args = (jstate, jgrid, agg["aice"], agg["vice"], agg["vsno"],
            jstate.aicen, jstate.vicen, jnp.maximum(1.0 - agg["aice"], 0.0),
            jf.uocn, jf.vocn, jf.ss_tltx, jf.ss_tlty,
            0.0012 * 1.3 * jf.wind * jf.uatm * agg["aice"],
            0.0012 * 1.3 * jf.wind * jf.vatm * agg["aice"])
    mesh = make_mesh(8)
    from cice4_tpu.ops.evp_sharded import sharded_eligible
    assert sharded_eligible(jgrid, mesh)
    fn = jax.jit(lambda s, g, *a: j_evp.evp(s, g, jcfg.dynamics,
                                            jcfg.run.dt, *a))
    j_one = fn(*args)
    set_active_mesh(mesh)
    try:
        j_out = fn(*shard_pytree(args, mesh))
        jax.block_until_ready(j_out[0].uvel)
    finally:
        set_active_mesh(None)

    cfg = Config().with_values(**SETUP)
    grid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=jgrid.bc.ew, ns=jgrid.bc.ns),
        device=CPU, dtype=F64)
    state = convert.state_from_arrays(_arrays(jstate), device=CPU,
                                      dtype=F64)
    f = convert.forcing_from_arrays(_arrays(jf), device=CPU, dtype=F64)
    one = evp(state, grid, cfg.dynamics, cfg.run.dt,
              *_evp_args(state, grid, f))
    blocks = _evp_blocks(cfg, grid, state, f, (2, 2))
    return (j_out, j_one), one, blocks


def test_sharded_evp_matches_jax(evp_runs):
    ((j_state, j_diag), (j1_state, j1_diag)), _one, (t_state, t_diag) = \
        evp_runs

    def err(got, want):
        want = np.asarray(want)
        return np.abs(np.asarray(got) - want).max() / max(
            np.abs(want).max(), 1.0)

    def close(got, want, jax_one, rtol, name):
        bound = max(rtol, 2.0 * err(jax_one, want))
        assert err(got.numpy(), want) <= bound, (name, err(got, want))

    for k in ("uvel", "vvel", "strocnxT", "strocnyT"):
        close(getattr(t_state, k), getattr(j_state, k),
              getattr(j1_state, k), 1e-10, k)
    for k in ("rdg_conv", "rdg_shear", "divu", "shear", "strintx",
              "strinty", "strocnx", "strocny"):
        close(t_diag[k], j_diag[k], j1_diag[k], 1e-10, k)
    for k in ("stressp", "stressm", "stress12"):
        close(getattr(t_state, k), getattr(j_state, k),
              getattr(j1_state, k), 1e-9, k)


def test_sharded_evp_equals_one_device(evp_runs):
    _j, (o_state, o_diag), (t_state, t_diag) = evp_runs
    for k in ("uvel", "vvel", "stressp", "stressm", "stress12",
              "strocnxT", "strocnyT", "iceumask"):
        _equal(getattr(t_state, k), getattr(o_state, k), k)
    for k, v in t_diag.items():
        _equal(v, o_diag[k], k)


@pytest.mark.parametrize("case", [
    ("cyclic", "tripole", (2, 2), "sharded"),
    ("closed", "tripole", (2, 2), "gathered"),
    ("cyclic", "tripoleT", (2, 2), "gathered"),
    ("open", "cyclic", (1, 4), "sharded"),
    ("cyclic", "open", (1, 1), "gathered")])
def test_block_evp_paths_equal_one_device(case):
    """Each boundary on its path: the k-halo rounds (the U-fold among
    them) or, where `sharded_eligible` refuses, the gathered path,
    counted; bit-equal to one device on the all-ocean grid."""
    ew, ns, shape, path = case
    cfg, grid, state, f = _port_setup({
        "domain.ew_boundary_type": ew, "domain.ns_boundary_type": ns,
        "grid.grid_type": "column", "dynamics.ndte": 13})
    state = state.replace(aicen=torch.clamp(state.aicen + 0.15, max=0.9),
                          vicen=state.vicen + 0.3)
    view = SimpleNamespace(ny=grid.ny, nx=grid.nx, bc=grid.bc)
    assert evp_sharded.sharded_eligible(view, Mesh(*shape)) == (
        path == "sharded")
    before = h.gathered_phase.names.get("evp", 0)
    o_state, o_diag = evp(state, grid, cfg.dynamics, cfg.run.dt,
                          *_evp_args(state, grid, f))
    t_state, t_diag = _evp_blocks(cfg, grid, state, f, shape)
    gathered = h.gathered_phase.names.get("evp", 0) - before
    assert gathered == (shape[0] * shape[1] if path == "gathered" else 0)
    for k in ("uvel", "vvel", "stressp", "stressm", "stress12",
              "strocnxT", "strocnyT", "iceumask"):
        _equal(getattr(t_state, k), getattr(o_state, k), k)
    for k, v in t_diag.items():
        _equal(v, o_diag[k], k)
    assert float(o_state.uvel.abs().max()) > 0.0


def test_closed_edge_fold_is_refused_where_the_rounds_differ(monkeypatch):
    """The one case where the port's gate is stricter than the JAX
    package's: a U-fold with a closed EW edge.  The one-device fold's NE
    shift wraps east-west there, the rounds zero the closed edge's
    ghosts, so the k-halo EVP, forced through, moves the velocities by a
    share of their scale; JAX's gate takes the case."""
    from cice4_tpu.ops.evp_sharded import sharded_eligible as j_evp_ok

    cfg, grid, state, f = _port_setup({
        "domain.ew_boundary_type": "closed",
        "domain.ns_boundary_type": "tripole", "grid.grid_type": "column",
        "dynamics.ndte": 13})
    state = state.replace(aicen=torch.clamp(state.aicen + 0.15, max=0.9),
                          vicen=state.vicen + 0.3)
    view = SimpleNamespace(ny=grid.ny, nx=grid.nx, bc=grid.bc)
    assert not evp_sharded.sharded_eligible(view, Mesh(2, 2))
    assert j_evp_ok(view, SimpleNamespace(devices=np.zeros((2, 2))))
    o_state, _ = evp(state, grid, cfg.dynamics, cfg.run.dt,
                     *_evp_args(state, grid, f))
    monkeypatch.setattr(evp_sharded, "sharded_eligible", lambda g, m: True)
    t_state, _ = _evp_blocks(cfg, grid, state, f, (2, 2))
    err = float((t_state.uvel - o_state.uvel).abs().max())
    assert err > 0.5 * float(o_state.uvel.abs().max()), err


def test_eligibility_gates_match_jax():
    from cice4_tpu.ops.evp_sharded import sharded_eligible as j_evp_ok
    from cice4_tpu.ops.remap import remap_sharded_eligible as j_remap_ok
    from cice4_tpu.parallel.mesh import make_mesh as j_make_mesh

    tr = SimpleNamespace(conservation_check=False, monotonicity_check=False)
    trc = SimpleNamespace(conservation_check=True, monotonicity_check=False)
    for n in (1, 2, 4, 8):
        jmesh, tmesh = j_make_mesh(n), Mesh(*j_make_mesh(n).devices.shape)
        for ny, nx in ((30, 32), (16, 32), (4, 8), (24, 36)):
            for ns in ("open", "cyclic", "tripole", "tripoleT"):
                g = SimpleNamespace(ny=ny, nx=nx,
                                    bc=SimpleNamespace(ns=ns, ew="cyclic"))
                assert (evp_sharded.sharded_eligible(g, tmesh)
                        == j_evp_ok(g, jmesh)), (n, ny, nx, ns)
                for t in (None, tr, trc):
                    want = j_remap_ok(g, jmesh, t)
                    if ns == "tripole":
                        # the port also takes the U-fold, with its fold
                        # strip: JAX's answer for the grid without the
                        # fold, given blocks of the strip's rows
                        flat = SimpleNamespace(
                            ny=ny, nx=nx,
                            bc=SimpleNamespace(ns="open", ew="cyclic"))
                        want = (j_remap_ok(flat, jmesh, t) and ny
                                // jmesh.devices.shape[0] >= FOLD_STRIP)
                    assert (remap_sharded_eligible(g, tmesh, t)
                            == want), (n, ny, nx, ns)
    g = SimpleNamespace(ny=16, nx=32, bc=SimpleNamespace(ns="open",
                                                         ew="cyclic"))
    assert not evp_sharded.sharded_eligible(g, None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CICE4_NO_SHARDED_EVP", "1")
        mp.setenv("CICE4_NO_SHARDED_REMAP", "1")
        assert not evp_sharded.sharded_eligible(g, Mesh(2, 2))
        assert not remap_sharded_eligible(g, Mesh(2, 2), tr)


def _remap_inputs(over=None, seed=4):
    cfg, grid, state, _f = _port_setup(over)
    g = torch.Generator().manual_seed(seed)
    u = 0.3 * torch.randn(grid.ny, grid.nx, generator=g, dtype=F64)
    v = 0.3 * torch.randn(grid.ny, grid.nx, generator=g, dtype=F64)
    state = state.replace(uvel=torch.where(grid.umask, u, 0.0),
                          vvel=torch.where(grid.umask, v, 0.0))
    return cfg, grid, state


@pytest.mark.parametrize("opts", [
    dict(integral_order=2), dict(integral_order=1), dict(integral_order=3),
    dict(integral_order=2, dp_midpt=True),
    dict(integral_order=2, fixed_area=True)], ids=str)
def test_sharded_remap_equals_one_device(opts):
    cfg, grid, state = _remap_inputs(
        {"domain.nx_global": 36, "domain.ny_global": 24})
    dt = cfg.run.dt
    o_state, o_aice0 = transport_remap(state, grid, dt, **opts)
    mesh = Mesh(2, 3)
    view = SimpleNamespace(ny=grid.ny, nx=grid.nx, bc=grid.bc)
    assert remap_sharded_eligible(view, mesh, cfg.transport)
    gb, sb = convert.scatter_blocks(grid, mesh), \
        convert.scatter_blocks(state, mesh)
    outs = mesh.run(lambda b: transport_remap_sharded(sb[b], gb[b], dt,
                                                      **opts))
    t_state = convert.gather_blocks([o[0] for o in outs], mesh)
    for k in ("aicen", "vicen", "vsnon", "eicen", "esnon", "tsfcn"):
        _equal(getattr(t_state, k), getattr(o_state, k), k)
    for k in o_state.trcrn:
        _equal(t_state.trcrn[k], o_state.trcrn[k], k)
    _equal(mesh.assemble([o[1] for o in outs]), o_aice0, "aice0")


def test_gathered_remap_is_counted_and_exact():
    """The tripole remap with the conservation check takes the gathered
    path on every block; the state and the (global) guard record equal
    one device's."""
    from cice4_tpu_torch.ops.remap import transport_remap_decomposed

    cfg, grid, state = _remap_inputs({
        "domain.ns_boundary_type": "tripole", "grid.grid_type": "column",
        "transport.conservation_check": True})
    dt = cfg.run.dt
    o_state, o_aice0, o_guards = transport_remap(
        state, grid, dt, conservation_check=True)
    mesh = Mesh(2, 2)
    gb, sb = convert.scatter_blocks(grid, mesh), \
        convert.scatter_blocks(state, mesh)
    before = h.gathered_phase.names.get("remap", 0)
    outs = mesh.run(lambda b: transport_remap_decomposed(
        sb[b], gb[b], dt, cfg.transport))
    assert h.gathered_phase.names["remap"] - before == 4
    t_state = convert.gather_blocks([o[0] for o in outs], mesh)
    for k in ("aicen", "vicen", "eicen", "tsfcn"):
        _equal(getattr(t_state, k), getattr(o_state, k), k)
    for o in outs:
        rec = o[2]["transport global conservation"]
        assert int(rec["count"]) == int(
            o_guards["transport global conservation"]["count"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,k", [((34, 40), 1), ((34, 40), 10),
                                     ((214, 182), 10), ((214, 182), 9),
                                     ((37, 45), 10)],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_round_mode_matches_plain(cuda_device, dtype, shape, k):
    """The round kernel (csrc/evp_rounds.cu) against `_evp_rounds_plain`
    on the whole doubly cyclic block: (o)'s padded 214x182 block at a
    round of 10 and the remainder round of 9, and blocks that the 8 x 16
    tiles do not divide; one launch a round in f32, launches of at most 7
    subcycles in f64."""
    from cice4_tpu_torch.ops.evp_cuda import evp_rounds, round_plan

    cfg = Config().with_values(**{
        "domain.ny_global": shape[0], "domain.nx_global": shape[1],
        "domain.ew_boundary_type": "cyclic",
        "domain.ns_boundary_type": "cyclic", "grid.grid_type": "column"})
    grid = make_grid(cfg, device=CPU, dtype=dtype)
    inputs = kernel_check.evp_inputs(grid, 5, dtype=dtype)
    p = dataclasses.replace(make_evp_params(cfg.dynamics, cfg.run.dt),
                            ndte=k)
    want = _evp_rounds_plain(p, grid, *inputs)
    ggrid = make_grid(cfg, device=cuda_device, dtype=dtype)
    launches = evp_rounds.launches
    got = evp_rounds(p, ggrid, *(x.to(cuda_device) for x in inputs))
    assert evp_rounds.launches == launches + len(round_plan(k, dtype)[2])
    rtol = kernel_check.ROUNDS_RTOL[dtype]
    for name, a, b in zip(("uvel", "vvel", "stressp", "stressm",
                           "stress12"), got, want):
        a = a.cpu()
        assert (a - b).abs().max() <= rtol * (b.abs().max() + 1e-30), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,smem", [(torch.float32, 171360),
                                        (torch.float64, 223080)])
def test_round_tile_fits_a_blocks_shared_memory(cuda_device, dtype, smem):
    """ROUND_TILE's apron fits a block's shared memory with no spill, and
    one more subcycle a launch in f64 is refused."""
    from cice4_tpu_torch.ops.evp_cuda import ROUND_TILE, round_occupancy

    occ = round_occupancy(*ROUND_TILE[dtype], dtype)
    assert occ["smem_bytes"] == smem
    assert occ["blocks_per_sm"] >= 1 and occ["local_bytes"] == 0
    if dtype == torch.float64:
        rows, cols, most = ROUND_TILE[dtype]
        with pytest.raises(RuntimeError, match="cudaError"):
            round_occupancy(rows, cols, most + 1, dtype)


@pytest.mark.gpu
def test_k_halo_evp_on_card_matches_one_launch(cuda_device):
    cfg, grid, state, f = _port_setup({"dynamics.ndte": 120})
    cfg = cfg.with_values(**{"domain.ny_global": 64,
                             "domain.nx_global": 96})
    grid = make_grid(cfg, device=cuda_device, dtype=torch.float32)
    state = init_state(cfg, grid, make_itd_params(cfg), device=cuda_device,
                       dtype=torch.float32)
    f = _wind(default_forcing(grid.ny, grid.nx, device=cuda_device,
                              dtype=torch.float32), grid.ny, grid.nx, torch)
    o_state, _ = evp(state, grid, cfg.dynamics, cfg.run.dt,
                     *_evp_args(state, grid, f))
    t_state, _ = _evp_blocks(cfg, grid, state, f, (2, 2))
    rtol = kernel_check.ROUNDS_RTOL[torch.float32]
    for k in ("uvel", "vvel", "stressp"):
        a, b = getattr(t_state, k), getattr(o_state, k)
        assert (a - b).abs().max() <= rtol * (b.abs().max() + 1e-30), k
