"""The split route of the port's incremental remapping (K0 in GA mode,
K1, K2) against the JAX package, in f64 on the CPU.

Two 24x32 grids: the doubly-periodic box of the slice (all ocean, cyclic
east-west and north-south, ice north of 70N) and a rectangular grid
closed north-south (the setup of `tests/test_remap_pallas.py`), each with
a swirling velocity field that moves ice across cell corners.

* `ga_planes_plain` (plain version of ``remap_gsh`` in GA mode) against
  the jnp `_geom_accumulators`;
* `construct_plain` (plain version of K1) against `_construct_vmem` with
  `remap.JnpShift`, row by row;
* `contract_plain` (plain version of K2) and the port's whole split route
  against one call of the TPU route `remap_pallas_divergence` (K0 -> K1 ->
  K2 in interpret mode, ~1 min) on the box;
* `construct_plain` and `contract_plain` on the inputs of the kernels' GPU
  cases (`kernel_check.remap_inputs`: no ice, one icy cell at each seam,
  ice everywhere; the widest tracer table) on a ragged grid against the
  jnp reconstruction and GA contraction, row by row;
* the port's `transport_remap` on the split route against its K0/K12
  route.

Tolerance: ``|torch - jax| <= 1e-12 * (|jax| + max|jax|)`` per field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu.config import Config, DomainConfig, GridConfig, \
    TransportConfig
from cice4_tpu.grid import make_grid, make_rect_grid
from cice4_tpu.model import Model
from cice4_tpu.ops import remap as jremap
from cice4_tpu.ops import remap_pallas as jrp
from cice4_tpu.parallel.halo import BoundaryConditions as JBC
from cice4_tpu.state import init_state
from cice4_tpu_torch import convert, kernel_check
from cice4_tpu_torch.ops import remap as tremap
from cice4_tpu_torch.ops import remap_cuda
from cice4_tpu_torch.parallel import halo as thalo

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
GRIDS = {
    "box": (("cyclic", "cyclic"),
            GridConfig(grid_type="column", lat_origin=69.0, dx_rect=10.0e3,
                       dy_rect=10.0e3)),
    "closed": (("cyclic", "closed"),
               GridConfig(grid_type="rectangular", lat_origin=62.0)),
}


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


def _setup(name):
    """(jax grid, jax state, torch grid, torch state) with a swirl."""
    (ew, ns), gcfg = GRIDS[name]
    ny, nx = 24, 32
    cfg = Config(domain=DomainConfig(nx_global=nx, ny_global=ny,
                                     ew_boundary_type=ew,
                                     ns_boundary_type=ns),
                 grid=gcfg, transport=TransportConfig(advection="remap"))
    jgrid = make_grid(cfg, dtype=jnp.float64)
    jstate = init_state(cfg, jgrid, Model.create(cfg).itd, dtype=jnp.float64)
    x = jnp.arange(nx)[None, :] / nx
    y = jnp.arange(ny)[:, None] / ny
    scale = jgrid.dxu / 30.0e3
    jstate = jstate.replace(
        uvel=0.3 * scale * jnp.sin(6.28 * x) * jnp.cos(6.28 * y)
        * jgrid.umask,
        vvel=0.2 * scale * jnp.cos(6.28 * x) * jnp.sin(6.28 * y)
        * jgrid.umask)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=ew, ns=ns), device=CPU, dtype=F64)
    tstate = convert.state_from_arrays(_state_arrays(jstate), device=CPU,
                                       dtype=F64)
    return jgrid, jstate, tgrid, tstate


@pytest.fixture(scope="module", params=list(GRIDS))
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def box():
    return _setup("box")


def _inputs(jgrid, jstate, dt=3600.0):
    """(dx, dy, afac, mm_ext, tm_ext, meta) as transport_remap builds
    them, with a random tracer stack on the icy cells."""
    dx = -dt * jstate.uvel / jgrid.dxu
    dy = -dt * jstate.vvel / jgrid.dyu
    meta = jremap._tracer_meta(list(jstate.trcrn), jstate.eicen.shape[1],
                               jstate.esnon.shape[1])
    rng = np.random.RandomState(5)
    aicen = np.asarray(jstate.aicen)
    ncat, ny, nx = aicen.shape
    assert (aicen > 0).any() and (aicen.sum(0) == 0).any()
    mm = np.concatenate([np.maximum(1.0 - aicen.sum(0), 0.0)[None], aicen])
    tm = rng.uniform(-2.0, 3.0, (ncat, len(meta), ny, nx)) \
        * (aicen[:, None] > 0)
    tm[:, :2] = np.abs(tm[:, :2])          # hi, hs are nonnegative
    tm = np.concatenate([np.zeros_like(tm[:1]), tm])
    return dx, dy, jgrid.dxu * jgrid.dyu, mm, tm, meta


def test_ga_planes_plain_matches_jnp(setup):
    jgrid, jstate, tgrid, _ = setup
    dx, dy, afac, _, _, _ = _inputs(jgrid, jstate)
    GA = jremap._geom_accumulators(afac, dx, dy, 2, jremap.JnpShift(jgrid.bc))
    zero = jnp.zeros_like(afac)
    want = jnp.stack([jnp.stack([GA[off][k] + zero for k in range(10)])
                      for off in jremap.ALL_OFFSETS])
    before = remap_cuda.ga_planes.launches
    got = remap_cuda.ga_planes(_t(dx), _t(dy), _t(afac), tgrid.bc, 2)
    assert remap_cuda.ga_planes.launches == before
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    _close(got, want, "GA")


def test_construct_plain_matches_jnp(setup):
    jgrid, jstate, tgrid, _ = setup
    _, _, _, mm, tm, meta = _inputs(jgrid, jstate)
    before = remap_cuda.construct.launches
    mass, trc = remap_cuda.construct(tgrid.hm, _t(mm), _t(tm), meta,
                                     tgrid.bc)
    assert remap_cuda.construct.launches == before
    assert mass.shape == (mm.shape[0], 3) + mm.shape[1:]
    assert trc.shape == (mm.shape[0], len(meta), 3) + mm.shape[1:]
    sh = jremap.JnpShift(jgrid.bc)
    for r in range(mm.shape[0]):
        mc, mx, my, tc, tx, ty = jrp._construct_vmem(
            jnp.asarray(mm[r]), jgrid.hm, jnp.asarray(tm[r]), list(meta), sh)
        _close(mass[r], jnp.stack([mc, mx, my]), f"mass row {r}")
        _close(trc[r], jnp.stack([tc, tx, ty], axis=1), f"trc row {r}")
    assert float(trc[0].abs().max()) == 0.0   # open water has no tracers


@pytest.fixture(scope="module")
def split_run(box):
    """The arguments and results of the split route's three wrappers in
    one `transport_remap(split_kernels=True)` of the box."""
    _, _, tgrid, tstate = box
    seen = {}
    names = ("ga_planes", "construct", "contract")
    real = {n: getattr(remap_cuda, n) for n in names}

    def spy(name):
        def call(*args):
            out = real[name](*args)
            seen[name] = (args, out)
            return out
        return call

    for n in names:
        setattr(remap_cuda, n, spy(n))
    try:
        tremap.transport_remap(tstate, tgrid, 3600.0, 2, split_kernels=True)
    finally:
        for n in names:
            setattr(remap_cuda, n, real[n])
    return seen


@pytest.fixture(scope="module")
def pallas_route(box, split_run):
    """The TPU route K0 -> K1 -> K2 in interpret mode on the inputs the
    port's split route was given (slow: run once)."""
    jgrid = box[0]
    dx, dy, afac, _bc, order = split_run["ga_planes"][0]
    hm, mm, tm, meta, _bc = split_run["construct"][0]
    bc = jgrid.bc
    return jrp.remap_pallas_divergence(
        *(jnp.asarray(a.numpy()) for a in (dx, dy, afac, mm, tm)),
        jgrid.hm, meta, bc.ew, bc.ns, order, interpret=True)


def test_contract_plain_matches_pallas_route(box, split_run, pallas_route):
    """K2's plain version on GA and reconstructions the JAX package
    computes (jnp `_geom_accumulators`, `_construct_vmem`)."""
    jgrid, _, tgrid, _ = box
    dx, dy, afac, _bc, order = (a.numpy() if isinstance(a, torch.Tensor)
                                else a for a in split_run["ga_planes"][0])
    _hm, mm, tm, meta, _bc = split_run["construct"][0]
    sh = jremap.JnpShift(jgrid.bc)
    GA = jremap._geom_accumulators(jnp.asarray(afac), jnp.asarray(dx),
                                   jnp.asarray(dy), order, sh)
    zero = jnp.zeros_like(jnp.asarray(afac))
    ga = np.stack([np.stack([np.asarray(GA[off][k] + zero)
                             for k in range(10)])
                   for off in jremap.ALL_OFFSETS])
    rows = [jrp._construct_vmem(jnp.asarray(mm[r].numpy()), jgrid.hm,
                                jnp.asarray(tm[r].numpy()), list(meta), sh)
            for r in range(mm.shape[0])]
    mass = _t(np.stack([np.stack([np.asarray(a) for a in rec[:3]])
                        for rec in rows]))
    trc = _t(np.stack([np.stack([np.asarray(a) for a in rec[3:]], axis=1)
                       for rec in rows]))
    par = remap_cuda.gather_parents(trc, meta)
    assert par.shape[1] == len(remap_cuda.parent_set(meta)) == 2
    before = remap_cuda.contract.launches
    div, divt = remap_cuda.contract(_t(ga), mass, trc, par, meta, tgrid.bc)
    assert remap_cuda.contract.launches == before
    want_div, want_divt = pallas_route
    assert float(np.abs(np.asarray(want_divt)).max()) > 0.0
    _close(div, want_div, "div vs K2")
    _close(divt, want_divt, "divt vs K2")


# the widest tracer table the kernels take: 8 type-1 tracers, 24 type-2
WIDE_META = ([(f"a{k}", 1, -1) for k in range(8)]
             + [(f"b{k}", 2, k % 8) for k in range(24)])


# (ice pattern of kernel_check.ice_mask, tracer table, boundaries)
PATTERN_CASES = ([(ice, "gx1", ew, ns) for ice in ("none", "seams", "all")
                  for ew, ns in (("cyclic", "cyclic"), ("open", "closed"),
                                 ("closed", "cyclic"), ("cyclic", "open"))]
                 + [("bands", "wide", ew, ns)
                    for ew, ns in (("cyclic", "cyclic"), ("open", "closed"))])


@pytest.mark.parametrize("ice,table,ew,ns", PATTERN_CASES)
def test_split_plain_matches_jnp_on_ice_patterns(ice, table, ew, ns):
    """The plain versions of K1 and K2, the kernels' oracles on the card,
    against the JAX reconstruction (`_construct_vmem`) and, on the JAX
    package's GA accumulators and reconstruction, its GA contraction
    (`_flux_divergence_ga` on the back-shifted GA), row by row."""
    ny, nx = 11, 17
    jgrid = make_rect_grid(nx, ny, JBC(ew=ew, ns=ns), dx=20.0e3, dy=20.0e3,
                           land_edges=False, dtype=jnp.float64)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=ew, ns=ns), device=CPU, dtype=F64)
    meta = jremap._tracer_meta(["iage"], 4, 1) if table == "gx1" \
        else WIDE_META
    dx, dy, afac, mm, tm = kernel_check.remap_inputs(
        tgrid, seed=8, ncat=5, meta=meta, dtype=F64, ice=ice)
    mass, trc = remap_cuda.construct_plain(tgrid.hm, mm, tm, meta, tgrid.bc)
    sh = jremap.JnpShift(jgrid.bc)
    rows = [jrp._construct_vmem(jnp.asarray(mm[r].numpy()), jgrid.hm,
                                jnp.asarray(tm[r].numpy()), meta, sh)
            for r in range(mm.shape[0])]
    for r, rec in enumerate(rows):
        _close(mass[r], jnp.stack(rec[:3]), f"mass row {r}")
        _close(trc[r], jnp.stack(rec[3:], axis=1), f"trc row {r}")

    GA = jremap._geom_accumulators(*(jnp.asarray(a.numpy())
                                     for a in (afac, dx, dy)), 2, sh)
    zero = jnp.zeros_like(jnp.asarray(afac.numpy()))
    ga = np.stack([np.stack([np.asarray(GA[off][k] + zero)
                             for k in range(10)])
                   for off in jremap.ALL_OFFSETS])
    GSH = {off: [jremap._shift_by_jnp(sh, jnp.asarray(ga[o, k]),
                                      (-off[0], -off[1])) for k in range(10)]
           for o, off in enumerate(jremap.ALL_OFFSETS)}
    jmass = _t(np.stack([np.stack([np.asarray(a) for a in rec[:3]])
                         for rec in rows]))
    jtrc = _t(np.stack([np.stack([np.asarray(a) for a in rec[3:]], axis=1)
                        for rec in rows]))
    div, divt = remap_cuda.contract_plain(_t(ga), jmass, jtrc, None, meta,
                                          tgrid.bc)
    for r, rec in enumerate(rows):
        want_div, want_divt = jremap._flux_divergence_ga(GSH, *rec, meta, sh)
        _close(div[r], want_div, f"div row {r}")
        _close(divt[r], want_divt, f"divt row {r}")
    assert float(divt[0].abs().max()) == 0.0   # open water has no tracers


def test_split_route_matches_pallas_route(split_run, pallas_route):
    """The port's whole split route inside `transport_remap`: K0 in GA
    mode, K1 and K2."""
    div, divt = split_run["contract"][1]
    want_div, want_divt = pallas_route
    _close(div, want_div, "div, split route vs K0 -> K1 -> K2")
    _close(divt, want_divt, "divt, split route vs K0 -> K1 -> K2")


@pytest.mark.parametrize("order", [1, 2])
def test_split_route_matches_k12_route(setup, order):
    _, _, tgrid, tstate = setup
    split, a_split = tremap.transport_remap(tstate, tgrid, 3600.0, order,
                                            split_kernels=True)
    k12, a_k12 = tremap.transport_remap(tstate, tgrid, 3600.0, order,
                                        split_kernels=False)
    _close(a_split, a_k12.numpy(), "aice0")
    for name in ("aicen", "vicen", "vsnon", "tsfcn", "eicen", "esnon"):
        _close(getattr(split, name), getattr(k12, name).numpy(), name)
    for name in tstate.trcrn:
        _close(split.trcrn[name], k12.trcrn[name].numpy(), name)
    moved = float((split.aicen - tstate.aicen).abs().max())
    assert moved > 1e-3


def test_split_route_is_chosen_on_cuda_only(monkeypatch):
    """... and, as the JAX package's `_use_pallas_remap`, never on a
    tripole grid."""
    bc = thalo.BoundaryConditions(ew="cyclic", ns="closed")
    monkeypatch.delenv("CICE4_FORCE_PALLAS_REMAP", raising=False)
    assert not tremap.use_split_kernels("cuda", bc)
    monkeypatch.setenv("CICE4_FORCE_PALLAS_REMAP", "1")
    assert tremap.use_split_kernels(torch.device("cuda", 0), bc)
    assert not tremap.use_split_kernels("cpu", bc)
    for ns in ("tripole", "tripoleT"):
        fold = thalo.BoundaryConditions(ew="cyclic", ns=ns)
        assert not tremap.use_split_kernels("cuda", fold)
