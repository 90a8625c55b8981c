"""The port's incremental remapping against the JAX package, in f64 on
the CPU, on the setup of `tests/test_remap_pallas.py` (a 24x32
rectangular grid, cyclic east-west and closed north-south, with a
swirling velocity field that moves ice across cell corners).

* `ga_gsh_plain` (the plain version of kernel ``remap_gsh``) against the
  jnp GA path (`_geom_accumulators` plus the back-shift) for quadrature
  orders 1-3, and against the TPU kernel K0 (`ga_gsh_pallas`, interpret
  mode) once;
* `k12_plain` (the plain version of kernel ``remap_k12``) against
  `_construct_vmem` plus `_flux_divergence_ga` row by row, and against
  the TPU kernel K12 (`k12_divergence`, interpret mode) once;
* `transport_remap` against the JAX GA path (`use_pallas=False`) for
  orders 1-3, and its conservation of ice area, volume and snow.

Tolerance: ``|torch - jax| <= 1e-12 * (|jax| + max|jax|)`` per field;
the packages' divisions and sums round differently in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu.config import Config, DomainConfig, DynamicsConfig, \
    GridConfig, TransportConfig
from cice4_tpu.grid import make_grid, make_rect_grid
from cice4_tpu.model import Model
from cice4_tpu.ops import remap as jremap
from cice4_tpu.ops import remap_pallas as jrp
from cice4_tpu.parallel.halo import BoundaryConditions as JBC
from cice4_tpu.state import init_state
from cice4_tpu_torch import convert, kernel_check
from cice4_tpu_torch.ops import remap as tremap
from cice4_tpu_torch.ops import remap_cuda

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")


def _close(got, want, name, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300,
                                 err_msg=name)


def _t(a):
    return torch.tensor(np.asarray(a))


def _state_arrays(s):
    return {k: (np.asarray(v) if not isinstance(v, dict)
                else {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in vars(s).items()}


@pytest.fixture(scope="module")
def setup():
    """(jax grid, jax state, torch grid, torch state): the setup of
    tests/test_remap_pallas.py."""
    ny, nx = 24, 32
    cfg = Config(
        domain=DomainConfig(nx_global=nx, ny_global=ny,
                            ew_boundary_type="cyclic",
                            ns_boundary_type="closed"),
        grid=GridConfig(grid_type="rectangular", lat_origin=62.0),
        dynamics=DynamicsConfig(ndte=10),
        transport=TransportConfig(advection="remap"),
    )
    jgrid = make_grid(cfg, dtype=jnp.float64)
    jstate = init_state(cfg, jgrid, Model.create(cfg).itd, dtype=jnp.float64)
    x = jnp.arange(nx)[None, :] / nx
    y = jnp.arange(ny)[:, None] / ny
    jstate = jstate.replace(
        uvel=0.3 * jnp.sin(6.28 * x) * jnp.cos(3.14 * y) * jgrid.umask,
        vvel=0.2 * jnp.cos(6.28 * x) * jnp.sin(3.14 * y) * jgrid.umask)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew="cyclic", ns="closed"), device=CPU,
        dtype=F64)
    tstate = convert.state_from_arrays(_state_arrays(jstate), device=CPU,
                                       dtype=F64)
    return jgrid, jstate, tgrid, tstate


def _geometry_inputs(jgrid, jstate, dt=3600.0):
    dx = -dt * jstate.uvel / jgrid.dxu
    dy = -dt * jstate.vvel / jgrid.dyu
    return dx, dy, jgrid.dxu * jgrid.dyu


def _jnp_gsh(jgrid, dx, dy, afac, order):
    sh = jremap.JnpShift(jgrid.bc)
    GA = jremap._geom_accumulators(afac, dx, dy, order, sh)
    zero = jnp.zeros_like(afac)
    return jnp.stack([
        jremap._shift_by_jnp(sh, jnp.stack([GA[off][k] + zero
                                            for k in range(10)]),
                             (-off[0], -off[1]))
        for off in jremap.ALL_OFFSETS])


def _extended_batch(jstate):
    """(mm_ext, tm_ext, meta) as transport_remap builds them: open water
    as row 0, then each category's area and tracer stack."""
    meta = jremap._tracer_meta(list(jstate.trcrn), jstate.eicen.shape[1],
                               jstate.esnon.shape[1])
    rng = np.random.RandomState(5)
    ncat, ny, nx = jstate.aicen.shape
    aicen = np.asarray(jstate.aicen)
    mm = np.concatenate([np.maximum(1.0 - aicen.sum(0), 0.0)[None], aicen])
    tm = rng.uniform(-2.0, 3.0, (ncat, len(meta), ny, nx)) \
        * (aicen[:, None] > 0)
    tm[:, :2] = np.abs(tm[:, :2])          # hi, hs are nonnegative
    tm = np.concatenate([np.zeros_like(tm[:1]), tm])
    return mm, tm, meta


@pytest.fixture(scope="module")
def pallas(setup):
    """K0 and K12 of the TPU package in interpret mode (slow: run once)."""
    jgrid, jstate, _, _ = setup
    dx, dy, afac = _geometry_inputs(jgrid, jstate)
    bc = jgrid.bc
    gsh_pad = jrp.ga_gsh_pallas(dx, dy, afac, bc.ew, bc.ns, 2,
                                interpret=True, keep_pad=True)
    mm, tm, meta = _extended_batch(jstate)
    div, divt = jrp.k12_divergence(gsh_pad, jgrid.hm, jnp.asarray(mm),
                                   jnp.asarray(tm), meta, bc.ew, bc.ns,
                                   interpret=True)
    return gsh_pad[..., :jgrid.nx], div, divt


@pytest.mark.parametrize("order", [1, 2, 3])
def test_ga_gsh_plain_matches_jnp(setup, order):
    jgrid, jstate, tgrid, _ = setup
    dx, dy, afac = _geometry_inputs(jgrid, jstate)
    want = _jnp_gsh(jgrid, dx, dy, afac, order)
    before = remap_cuda.ga_gsh.launches
    got = remap_cuda.ga_gsh(_t(dx), _t(dy), _t(afac), tgrid.bc, order)
    assert remap_cuda.ga_gsh.launches == before
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    _close(got, want, f"GSH order {order}")


def test_ga_gsh_plain_matches_pallas_k0(setup, pallas):
    jgrid, jstate, tgrid, _ = setup
    dx, dy, afac = _geometry_inputs(jgrid, jstate)
    got = remap_cuda.ga_gsh_plain(_t(dx), _t(dy), _t(afac), tgrid.bc, 2)
    _close(got, pallas[0], "GSH vs K0")


def test_edge_cases_cover_the_geometry(setup):
    """The case codes the kernel is compared with on the card: every edge
    gets a centre case, and the swirl drives several corner cases."""
    jgrid, jstate, tgrid, _ = setup
    dx, dy, afac = _geometry_inputs(jgrid, jstate)
    codes = remap_cuda.edge_cases_plain(_t(dx) * 40.0, _t(dy) * 40.0,
                                        _t(afac), tgrid.bc)
    assert codes.shape == (2, jgrid.ny, jgrid.nx)
    centre = codes >> tremap.CENTER_CASE_SHIFT
    assert bool(((centre >= 1) & (centre <= 12)).all())
    corners = codes & ((1 << tremap.CENTER_CASE_SHIFT) - 1)
    assert len(set(corners.flatten().tolist())) >= 4
    assert len(set(centre.flatten().tolist())) >= 4


def test_k12_plain_matches_jnp(setup):
    jgrid, jstate, tgrid, _ = setup
    dx, dy, afac = _geometry_inputs(jgrid, jstate)
    gsh = _jnp_gsh(jgrid, dx, dy, afac, 2)
    mm, tm, meta = _extended_batch(jstate)
    sh = jremap.JnpShift(jgrid.bc)
    GSH = {off: [gsh[o, k] for k in range(10)]
           for o, off in enumerate(jremap.ALL_OFFSETS)}
    before = remap_cuda.k12_divergence.launches
    div, divt = remap_cuda.k12_divergence(_t(gsh), tgrid.hm, _t(mm), _t(tm),
                                          meta, tgrid.bc)
    assert remap_cuda.k12_divergence.launches == before
    for r in range(mm.shape[0]):
        rmeta = meta if r else []
        rtm = jnp.asarray(tm[r]) if r else jnp.zeros((0,) + mm.shape[1:])
        recon = jrp._construct_vmem(jnp.asarray(mm[r]), jgrid.hm, rtm,
                                    rmeta, sh)
        want_div, want_divt = jremap._flux_divergence_ga(GSH, *recon, rmeta,
                                                         sh)
        _close(div[r], want_div, f"div row {r}")
        if r:
            _close(divt[r], want_divt, f"divt row {r}")
        else:
            assert float(divt[0].abs().max()) == 0.0


@pytest.mark.parametrize("ice", ["none", "seams", "all"])
@pytest.mark.parametrize("ew,ns", [("cyclic", "cyclic"), ("open", "closed"),
                                   ("closed", "cyclic"), ("cyclic", "open")])
def test_k12_plain_matches_jnp_on_ice_patterns(ice, ew, ns):
    """The plain version, K12's oracle on the card, on the inputs of its
    GPU cases (kernel_check.remap_inputs: no ice, one icy cell at each
    seam, ice everywhere) on a ragged grid, against the JAX reconstruction
    and contraction, row by row."""
    ny, nx = 11, 17
    jgrid = make_rect_grid(nx, ny, JBC(ew=ew, ns=ns), dx=20.0e3, dy=20.0e3,
                           land_edges=False, dtype=jnp.float64)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=ew, ns=ns), device=CPU, dtype=F64)
    meta = jremap._tracer_meta(["iage"], 4, 1)
    dx, dy, afac, mm, tm = kernel_check.remap_inputs(
        tgrid, seed=8, ncat=5, meta=meta, dtype=F64, ice=ice)
    assert int((mm[1:] > 0).sum()) == {"none": 0, "seams": 40,
                                        "all": 5 * ny * nx}[ice]
    gsh = remap_cuda.ga_gsh_plain(dx, dy, afac, tgrid.bc, 2)
    div, divt = remap_cuda.k12_divergence(gsh, tgrid.hm, mm, tm, meta,
                                          tgrid.bc)
    sh = jremap.JnpShift(jgrid.bc)
    GSH = {off: [jnp.asarray(gsh[o, k].numpy()) for k in range(10)]
           for o, off in enumerate(jremap.ALL_OFFSETS)}
    for r in range(mm.shape[0]):
        rmeta = meta if r else []
        rtm = jnp.asarray(tm[r].numpy()) if r else \
            jnp.zeros((0,) + tuple(mm.shape[1:]))
        recon = jrp._construct_vmem(jnp.asarray(mm[r].numpy()), jgrid.hm,
                                    rtm, rmeta, sh)
        want_div, want_divt = jremap._flux_divergence_ga(GSH, *recon, rmeta,
                                                         sh)
        _close(div[r], want_div, f"div row {r}")
        if r:
            _close(divt[r], want_divt, f"divt row {r}")


def test_k12_plain_matches_pallas_k12(setup, pallas):
    jgrid, jstate, tgrid, _ = setup
    gsh, want_div, want_divt = pallas
    mm, tm, meta = _extended_batch(jstate)
    div, divt = remap_cuda.k12_plain(_t(gsh), tgrid.hm, _t(mm), _t(tm), meta,
                                     tgrid.bc)
    _close(div, want_div, "div vs K12")
    _close(divt[1:], np.asarray(want_divt)[1:], "divt vs K12")


@pytest.mark.parametrize("order", [1, 2, 3])
def test_transport_remap_matches_jax(setup, order):
    jgrid, jstate, tgrid, tstate = setup
    jst, ja0 = jremap.transport_remap(jstate, jgrid, 3600.0, order,
                                      use_pallas=False)
    tst, ta0 = tremap.transport_remap(tstate, tgrid, 3600.0, order)
    _close(ta0, ja0, "aice0")
    for name in ("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon"):
        _close(getattr(tst, name), getattr(jst, name), name)
    assert jst.trcrn.keys() == tst.trcrn.keys()
    for name in jst.trcrn:
        _close(tst.trcrn[name], jst.trcrn[name], name)
    moved = np.abs(np.asarray(jst.aicen) - np.asarray(jstate.aicen)).max()
    assert moved > 1e-3


def test_transport_remap_conserves(setup):
    _, _, tgrid, tstate = setup
    tst, _ = tremap.transport_remap(tstate, tgrid, 3600.0, 2)
    for f in ("aicen", "vicen", "vsnon"):
        before = float((getattr(tstate, f) * tgrid.tarea).sum())
        after = float((getattr(tst, f) * tgrid.tarea).sum())
        assert abs(after - before) <= 1e-12 * max(abs(before), 1.0), f
