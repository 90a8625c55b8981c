"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked `gpu` and skipped without a CUDA device.  The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances are those of `cice4_tpu_torch.kernel_check`.
"""

import pytest
import torch

from cice4_tpu_torch import kernel_check
from cice4_tpu_torch.config import gx1_config
from cice4_tpu_torch.ops import therm_vertical as tv
from cice4_tpu_torch.ops.remap import _tracer_meta
from cice4_tpu_torch.state import make_itd_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels run only "
                    "on the card")
    return torch.device("cuda")


def _thermo_params(nilyr=4, nslyr=1):
    cfg = gx1_config().with_values(**{"domain.nilyr": nilyr,
                                      "domain.nslyr": nslyr})
    return tv.make_thermo_params(cfg, make_itd_params(cfg))


# (nilyr, nslyr): the default, then counts of other register instances of
# the kernel, then counts of its generic instance (layer counts at run time)
LAYERS = [(4, 1), (7, 1), (2, 1), (4, 2), (9, 1), (10, 1), (16, 2), (32, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(5, 64, 128), (5, 116, 100), (1, 7, 33)])
@pytest.mark.parametrize("layers", LAYERS, ids=lambda v: f"{v[0]}x{v[1]}")
def test_therm_newton_matches_plain(cuda_device, dtype, shape, layers):
    p = _thermo_params(*layers)
    args = kernel_check.make_inputs(p, *shape, seed=7, device=cuda_device,
                                    dtype=dtype)
    before = tv.temperature_changes.launches
    kern = tv.temperature_changes(p, 3600.0, *args)
    assert tv.temperature_changes.launches == before + 1
    plain = tv._temperature_changes_core(p, 3600.0, *args)
    torch.cuda.synchronize()
    report = kernel_check.compare(kern, plain, args[0], dtype)
    assert report["ok"], report


@pytest.mark.gpu
def test_therm_newton_on_a_plane_and_rejects_bad_input(cuda_device):
    """A (ny, nx) call (no category axis) equals category 0 of a batched
    call; a wrong dtype raises; a layer count of another instance (3 ice
    layers) agrees with the plain version."""
    p = _thermo_params()
    args = kernel_check.make_inputs(p, 2, 40, 24, seed=3,
                                    device=cuda_device, dtype=torch.float64)
    both = tv.temperature_changes(p, 3600.0, *args)
    one = tv.temperature_changes(
        p, 3600.0, *(a[0] if a.dim() >= 3 and a.shape[0] == 2 else a
                     for a in args))
    for k in kernel_check.FIELDS:
        torch.testing.assert_close(one[k], both[k][0], rtol=0, atol=0)
    with pytest.raises(TypeError):
        tv.temperature_changes(p, 3600.0, args[0],
                               *(a.to(torch.float16) for a in args[1:]))
    p3 = tv.ThermoParams(**{**vars(p), "nilyr": 3})
    args3 = kernel_check.make_inputs(p3, 2, 40, 24, seed=3,
                                     device=cuda_device, dtype=torch.float64)
    kern = tv.temperature_changes(p3, 3600.0, *args3)
    plain = tv._temperature_changes_core(p3, 3600.0, *args3)
    torch.cuda.synchronize()
    report = kernel_check.compare(kern, plain, args3[0], torch.float64)
    assert report["ok"], report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layers", [(9, 1), (4, 4)],
                         ids=lambda v: f"{v[0]}x{v[1]}")
def test_therm_newton_runs_counts_beyond_its_register_instances(
        cuda_device, dtype, layers):
    """A layer count past the register instances (8 ice, 3 snow layers)
    launches the generic instance, which agrees with the plain version."""
    p = _thermo_params(*layers)
    args = kernel_check.make_inputs(p, 2, 40, 24, seed=3,
                                    device=cuda_device, dtype=dtype)
    before = (tv.temperature_changes.launches,
              tv._temperature_changes_cuda.generic_launches)
    kern = tv.temperature_changes(p, 3600.0, *args)
    assert (tv.temperature_changes.launches,
            tv._temperature_changes_cuda.generic_launches) == \
        (before[0] + 1, before[1] + 1)
    plain = tv._temperature_changes_core(p, 3600.0, *args)
    torch.cuda.synchronize()
    report = kernel_check.compare(kern, plain, args[0], dtype)
    assert report["ok"], report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_therm_newton_generic_instance_matches_the_register_one(cuda_device,
                                                                 dtype):
    """The generic instance at the gx1 counts (4, 1) against the register
    instance, and both against the plain version."""
    p = _thermo_params()
    args = kernel_check.make_inputs(p, 5, 64, 128, seed=7,
                                    device=cuda_device, dtype=dtype)
    reg = tv.temperature_changes(p, 3600.0, *args)
    gen = tv._temperature_changes_cuda(p, 3600.0, *args, generic=True)
    plain = tv._temperature_changes_core(p, 3600.0, *args)
    torch.cuda.synchronize()
    for ref in (reg, plain):
        report = kernel_check.compare(gen, ref, args[0], dtype)
        assert report["ok"], report
    # the same expressions in the same order, fused alike by ptxas
    # (csrc/therm_newton.cu): bit for bit
    for name, x in reg.items():
        assert torch.equal(gen[name], x), name


@pytest.mark.gpu
def test_therm_newton_generic_instance_holds_16_warps_an_sm(cuda_device):
    """At (10, 1) in f32 the generic instance keeps its registers within
    what 4 blocks of 128 threads an SM allow (16 warps), with no local
    memory (stack or spill)."""
    occ = tv.therm_newton_generic_occupancy(10, 1, torch.float32)
    assert occ["warps_per_sm"] >= 16, occ
    assert occ["registers"] <= 128 and occ["local_bytes"] == 0, occ


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,layers", [
    (torch.float64, (0, 1)), (torch.float64, (4, 0)),
    (torch.float64, (128, 1)), (torch.float64, (126, 3)),
    (torch.float32, (256, 1)), (torch.float32, (255, 3))],
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)[6:])
def test_therm_newton_refuses_counts_beyond_its_instances(cuda_device,
                                                          dtype, layers):
    """No layer, or one more than the generic instance's stated largest
    count (csrc/therm_newton.cu: 127 x 1 and 125 x 3 in f64, 255 x 1 and
    254 x 3 in f32), raises without a launch; past the largest count the
    error gives the count and the bytes and names the ROADMAP item."""
    p = _thermo_params()
    if min(layers) < 1:
        p2 = tv.ThermoParams(**{**vars(p), "nilyr": layers[0],
                                "nslyr": layers[1]})
    else:
        p = p2 = _thermo_params(*layers)
    args = kernel_check.make_inputs(p, 2, 40, 24, seed=3, device=cuda_device,
                                    dtype=dtype)
    before = tv.temperature_changes.launches
    if min(layers) < 1:
        with pytest.raises(ValueError, match="at least one"):
            tv.temperature_changes(p2, 3600.0, *args)
    else:
        nbytes, threads = tv.therm_newton_generic_bytes(*layers, dtype)
        assert threads == 0 and nbytes > 232448
        with pytest.raises(NotImplementedError,
                           match=f"nilyr={layers[0]}, nslyr={layers[1]}.*"
                                 f"{nbytes} bytes.*ROADMAP queue 2 item 10"):
            tv.temperature_changes(p2, 3600.0, *args)
        one_less = tv.therm_newton_generic_bytes(layers[0] - 1, layers[1],
                                                 dtype)
        assert one_less[1] >= 32 and one_less[0] <= 232448
    assert tv.temperature_changes.launches == before


# ---------------------------------------------------------------------------
# the dynamics kernels: evp_subcycle, remap_gsh, remap_k12, remap_construct
# and remap_contract
# ---------------------------------------------------------------------------

FOLDS = ("tripole", "tripoleT")
# the tripole folds, which the default route's kernels take (the last three
# cases) and the split route's refuse
DYN_CASES = [((64, 128), ("cyclic", "closed")),
             ((116, 100), ("closed", "open")), ((7, 33), ("cyclic", "open")),
             ((64, 128), ("cyclic", "cyclic")),
             ((116, 100), ("closed", "cyclic")), ((7, 33), ("cyclic", "cyclic")),
             ((64, 128), ("cyclic", "tripole")),
             ((116, 100), ("cyclic", "tripoleT")),
             ((7, 33), ("closed", "tripole"))]
SPLIT_DYN_CASES = [c for c in DYN_CASES if c[1][1] not in FOLDS]


def _dyn_grid(shape, bcs, device, dtype):
    """The gx1 lat-lon grid cut to `shape`; with a fold the all-ocean
    10 km grid, on which ice and stresses reach the top row."""
    from cice4_tpu_torch.config import Config
    from cice4_tpu_torch.grid import make_grid

    size = {"domain.ny_global": shape[0], "domain.nx_global": shape[1],
            "domain.ew_boundary_type": bcs[0],
            "domain.ns_boundary_type": bcs[1]}
    if bcs[1] in FOLDS:
        cfg = Config().with_values(**size, **{
            "grid.grid_type": "column", "grid.lat_origin": 55.0,
            "grid.dx_rect": 10.0e3, "grid.dy_rect": 10.0e3})
    else:
        cfg = gx1_config().with_values(**{"grid.kmt_file": "", **size})
    return make_grid(cfg, device=device, dtype=dtype)


# every boundary pair the kernels take (the folds only on the default route)
ALL_BCS = [(ew, ns) for ew in ("cyclic", "open", "closed")
           for ns in ("cyclic", "open", "closed")]
FOLD_BCS = [(ew, ns) for ew in ("cyclic", "closed") for ns in FOLDS]
# (shape, boundaries, ice pattern of kernel_check.ice_mask, ndte): the
# shapes above with ice in bands, then a ragged shape with no ice, one
# icy cell at each seam and ice everywhere, on every boundary pair, at 1
# and 120 subcycles; "overflow" sizes an all-icy grid with more active
# cells than the persistent kernel has resident threads
EVP_CASES = ([(shape, bcs, "bands", 40) for shape, bcs in DYN_CASES]
             + [((37, 61), bcs, ice, ndte) for bcs in ALL_BCS + FOLD_BCS
                for ice, ndte in (("none", 40), ("seams", 120),
                                  ("all", 1))]
             + [("overflow", ("cyclic", "closed"), "all", 3),
                ("overflow", ("closed", "cyclic"), "all", 3),
                ("overflow", ("cyclic", "tripole"), "all", 3)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,bcs,ice,ndte", EVP_CASES)
@pytest.mark.parametrize("damping,sinw", [(False, 0.0), (True, 0.3)])
def test_evp_subcycle_matches_plain(cuda_device, dtype, shape, bcs, ice,
                                    ndte, damping, sinw):
    """Ice-free cells are gated off in the kernel, and cells beyond its
    resident threads keep their state in device memory; the result is the
    plain version's all the same."""
    from cice4_tpu_torch.config import DynamicsConfig
    from cice4_tpu_torch.ops import evp as evp_ops
    from cice4_tpu_torch.ops import evp_cuda

    if shape == "overflow":
        blocks, threads = evp_cuda.resident_grid(dtype,
                                                 torch.cuda.current_device())
        nx = 256
        shape = (-(-5 * blocks * threads // 2) // nx, nx)
        assert shape[0] * shape[1] > 2 * blocks * threads
    grid = _dyn_grid(shape, bcs, cuda_device, dtype)
    p = evp_ops.make_evp_params(
        DynamicsConfig(ndte=ndte, evp_damping=damping, sinw=sinw), 3600.0)
    args = kernel_check.evp_inputs(grid, seed=4, dtype=dtype, ice=ice)
    before = (evp_cuda.evp_subcycle.launches,
              evp_cuda.evp_subcycle.ns_cyclic_launches)
    kern = kernel_check.evp_named(evp_cuda.evp_subcycle(p, grid, *args))
    cyclic = int(bcs[1] == "cyclic")
    assert (evp_cuda.evp_subcycle.launches,
            evp_cuda.evp_subcycle.ns_cyclic_launches) == (
        before[0] + 1, before[1] + cyclic)
    # what the launch reports it ran: the active lists, 2 ndte + 1 grid
    # barriers, the resident grid
    assert evp_cuda.last_launch() == {
        "active_t_cells": int(args[1].sum()),
        "active_u_points": int(args[2].sum()),
        "grid_barriers": 2 * ndte + 1,
        **dict(zip(("blocks", "threads_per_block"),
                   evp_cuda.resident_grid(dtype,
                                          torch.cuda.current_device())))}
    plain = kernel_check.evp_named(evp_ops._evp_subcycle_plain(p, grid,
                                                               *args))
    torch.cuda.synchronize()
    report = kernel_check.compare_fields(kern, plain,
                                         kernel_check.EVP_RTOL[dtype])
    assert kernel_check.fields_ok(report), report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,bcs", DYN_CASES)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_remap_gsh_matches_plain(cuda_device, dtype, shape, bcs, order):
    from cice4_tpu_torch.ops import remap_cuda

    grid = _dyn_grid(shape, bcs, cuda_device, dtype)
    dx, dy, afac, _, _ = kernel_check.remap_inputs(
        grid, seed=6, ncat=5, meta=_tracer_meta([], 4, 1), dtype=dtype)
    before = remap_cuda.ga_gsh.launches
    gsh = remap_cuda.ga_gsh(dx, dy, afac, grid.bc, order)
    assert remap_cuda.ga_gsh.launches == before + 1
    _, codes = remap_cuda.edge_cases_cuda(dx, dy, afac, grid.bc, order)
    plain = remap_cuda.ga_gsh_plain(dx, dy, afac, grid.bc, order)
    codes_plain = remap_cuda.edge_cases_plain(dx, dy, afac, grid.bc)
    torch.cuda.synchronize()
    flips = int((codes != codes_plain).sum())
    assert flips <= kernel_check.GSH_MAX_FLIP_SHARE[dtype] * codes.numel()
    report = kernel_check.compare_fields({"gsh": gsh}, {"gsh": plain},
                                         kernel_check.GSH_RTOL[dtype])
    assert kernel_check.fields_ok(report, allowed_bad=90 * 25 * flips), \
        report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,bcs", SPLIT_DYN_CASES)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_remap_ga_mode_matches_plain(cuda_device, dtype, shape, bcs, order):
    """K0 in GA mode (no back-shift), with its case codes."""
    from cice4_tpu_torch.ops import remap_cuda

    grid = _dyn_grid(shape, bcs, cuda_device, dtype)
    dx, dy, afac, _, _ = kernel_check.remap_inputs(
        grid, seed=6, ncat=5, meta=_tracer_meta([], 4, 1), dtype=dtype)
    before = remap_cuda.ga_planes.launches
    ga = remap_cuda.ga_planes(dx, dy, afac, grid.bc, order)
    assert remap_cuda.ga_planes.launches == before + 1
    ga2, codes = remap_cuda.edge_cases_cuda(dx, dy, afac, grid.bc, order,
                                            emit_shifted=False)
    plain = remap_cuda.ga_planes_plain(dx, dy, afac, grid.bc, order)
    codes_plain = remap_cuda.edge_cases_plain(dx, dy, afac, grid.bc)
    torch.cuda.synchronize()
    assert torch.equal(ga, ga2)
    flips = int((codes != codes_plain).sum())
    assert flips <= kernel_check.GSH_MAX_FLIP_SHARE[dtype] * codes.numel()
    report = kernel_check.compare_fields({"ga": ga}, {"ga": plain},
                                         kernel_check.GSH_RTOL[dtype])
    assert kernel_check.fields_ok(report, allowed_bad=90 * 25 * flips), \
        report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("emit_shifted", [True, False], ids=["GSH", "GA"])
def test_remap_gsh_is_one_launch_without_scratch(cuda_device, dtype,
                                                 emit_shifted):
    """Each call of K0, in either mode, is one kernel launch on the card
    (as the profiler sees it) and allocates its output and nothing else,
    not even for a moment."""
    from torch.profiler import ProfilerActivity, profile

    from cice4_tpu_torch.ops import remap_cuda

    grid = _dyn_grid((64, 128), ("cyclic", "closed"), cuda_device, dtype)
    dx, dy, afac, _, _ = kernel_check.remap_inputs(
        grid, seed=6, ncat=5, meta=_tracer_meta([], 4, 1), dtype=dtype)
    fn = remap_cuda.ga_gsh if emit_shifted else remap_cuda.ga_planes
    fn(dx, dy, afac, grid.bc, 2)            # builds and loads the library
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn(dx, dy, afac, grid.bc, 2)
        torch.cuda.synchronize()
    nbytes = out.numel() * out.element_size()
    assert torch.cuda.memory_allocated() - before == nbytes
    assert torch.cuda.max_memory_allocated() - before == nbytes
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))
               and getattr(e, "self_device_time_total", 0) > 0]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "gsh_fused" in kernels[0][0], kernels


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_remap_gsh_tile_fits(cuda_device, dtype, order):
    """The tile K0's library picks: the deepest that fits, 8 rows in f32
    and 4 in f64, with at least one block resident an SM."""
    from cice4_tpu_torch.ops import remap_cuda

    tile = remap_cuda.gsh_tile(order, dtype, cuda_device)
    assert tile["rows"] == (8 if dtype == torch.float32 else 4), tile
    assert 0 < tile["smem_bytes"] <= 232448 and tile["blocks_per_sm"] >= 1


# the largest tracer table the reconstruction kernels take: 8 type-1
# tracers, 24 type-2 with parents 0..7
WIDE_META = ([(f"a{k}", 1, -1) for k in range(8)]
             + [(f"b{k}", 2, k % 8) for k in range(24)])
# (shape, boundaries, ice pattern, tracer table): the shapes above with
# ice in bands, then ragged shapes (neither a multiple of the 32-wide tile
# nor of its rows) with no ice, one icy cell at each seam and ice
# everywhere on every boundary pair, and the widest table
K12_CASES = ([(shape, bcs, "bands", "gx1") for shape, bcs in DYN_CASES]
             + [((37, 61), bcs, ice, "gx1") for bcs in ALL_BCS + FOLD_BCS
                for ice in ("none", "seams", "all")]
             + [((45, 70), bcs, "bands", "wide")
                for bcs in (("cyclic", "cyclic"), ("open", "closed"))]
             + [((37, 61), bcs, "bands", "ponds")
                for bcs in (("cyclic", "closed"), ("cyclic", "tripole"))])
# the tracer tables by name: the model's (gx1: 9 tracers, 3 of type 1), the
# model's with the melt-pond volume (10, 4 of type 1), the widest, one
# without type-2 tracers (its gathered parents are one zero row) and none
# at all
TABLES = {"gx1": _tracer_meta(["iage"], 4, 1), "wide": WIDE_META,
          "ponds": _tracer_meta(["iage", "volpn"], 4, 1),
          "type1": [("hi", 1, -1), ("hs", 1, -1), ("Tsfc", 1, -1)],
          "none": []}
# K12's cases, and the tables without type-2 tracers or without tracers
SPLIT_CASES = [c for c in K12_CASES if c[1][1] not in FOLDS] + [
    ((37, 61), bcs, "bands", table)
    for bcs in (("cyclic", "cyclic"), ("open", "closed"))
    for table in ("type1", "none")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,bcs,ice,table", K12_CASES)
def test_remap_k12_matches_plain(cuda_device, dtype, shape, bcs, ice, table):
    from cice4_tpu_torch.ops import remap_cuda

    grid = _dyn_grid(shape, bcs, cuda_device, dtype)
    meta = TABLES[table]
    dx, dy, afac, mm, tm = kernel_check.remap_inputs(
        grid, seed=8, ncat=5, meta=meta, dtype=dtype, ice=ice)
    gsh = remap_cuda.ga_gsh_plain(dx, dy, afac, grid.bc, 2)
    before = remap_cuda.k12_divergence.launches
    div, divt = remap_cuda.k12_divergence(gsh, grid.hm, mm, tm, meta, grid.bc)
    assert remap_cuda.k12_divergence.launches == before + 1
    div_p, divt_p = remap_cuda.k12_plain(gsh, grid.hm, mm, tm, meta, grid.bc)
    torch.cuda.synchronize()
    report = kernel_check.compare_fields({"div": div, "divt": divt},
                                         {"div": div_p, "divt": divt_p},
                                         kernel_check.K12_RTOL[dtype])
    assert kernel_check.fields_ok(report), report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ntracers,n1", [(0, 0), (1, 1), (9, 3), (17, 8),
                                         (32, 8)])
def test_remap_k12_tile_fits_every_table(cuda_device, dtype, ntracers, n1):
    """Every tracer table `_tracer_table` accepts gets a K12 tile whose
    block the card keeps resident; the gx1 table (9 tracers, 3 of type 1)
    takes 8 rows in f32 and 4 in f64."""
    from cice4_tpu_torch.ops import remap_cuda

    tile = remap_cuda.k12_tile(ntracers, n1, dtype, cuda_device)
    assert tile["rows"] in (8, 4, 2, 1)
    assert tile["blocks_per_sm"] >= 1
    assert 0 < tile["smem_bytes"] <= 227 * 1024  # a Hopper block's most
    if (ntracers, n1) == (9, 3):
        assert tile["rows"] == (8 if dtype == torch.float32 else 4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,bcs,ice,table", SPLIT_CASES)
def test_remap_construct_and_contract_match_plain(cuda_device, dtype, shape,
                                                  bcs, ice, table):
    """K1 and K2 of the split route, each on the other's plain inputs; K2
    reads the parents from trc, its plain version takes them gathered."""
    from cice4_tpu_torch.ops import remap_cuda

    grid = _dyn_grid(shape, bcs, cuda_device, dtype)
    meta = TABLES[table]
    dx, dy, afac, mm, tm = kernel_check.remap_inputs(
        grid, seed=9, ncat=5, meta=meta, dtype=dtype, ice=ice)
    before = remap_cuda.construct.launches
    mass, trc = remap_cuda.construct(grid.hm, mm, tm, meta, grid.bc)
    assert remap_cuda.construct.launches == before + 1
    mass_p, trc_p = remap_cuda.construct_plain(grid.hm, mm, tm, meta,
                                               grid.bc)
    torch.cuda.synchronize()
    report = kernel_check.compare_fields({"mass": mass, "trc": trc},
                                         {"mass": mass_p, "trc": trc_p},
                                         kernel_check.K1_RTOL[dtype])
    assert kernel_check.fields_ok(report), report
    assert not bool(trc[0].any())     # open water carries no tracers

    ga = remap_cuda.ga_planes_plain(dx, dy, afac, grid.bc, 2)
    par = remap_cuda.gather_parents(trc_p, meta)
    before = remap_cuda.contract.launches
    div, divt = remap_cuda.contract(ga, mass_p, trc_p, None, meta, grid.bc)
    assert remap_cuda.contract.launches == before + 1
    div_p, divt_p = remap_cuda.contract_plain(ga, mass_p, trc_p, par, meta,
                                              grid.bc)
    torch.cuda.synchronize()
    report = kernel_check.compare_fields({"div": div, "divt": divt},
                                         {"div": div_p, "divt": divt_p},
                                         kernel_check.K2_RTOL[dtype])
    assert kernel_check.fields_ok(report), report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ntracers,n1", [(0, 0), (1, 1), (3, 3), (9, 3),
                                         (17, 8), (32, 8)])
@pytest.mark.parametrize("kernel", ["construct", "contract"])
def test_remap_split_tiles_fit_every_table(cuda_device, dtype, ntracers, n1,
                                           kernel):
    """Every tracer table `_tracer_table` accepts gets a K1 and a K2 tile
    whose block the card keeps resident; K2 at the gx1 table (9 tracers, 3
    of type 1) takes 8 rows in f32 and 4 in f64."""
    from cice4_tpu_torch.ops import remap_cuda

    tile = getattr(remap_cuda, f"{kernel}_tile")(ntracers, n1, dtype,
                                                 cuda_device)
    assert tile["rows"] in (8, 4, 2, 1)
    assert tile["blocks_per_sm"] >= 1
    assert 0 < tile["smem_bytes"] <= 227 * 1024  # a Hopper block's most
    if kernel == "contract" and (ntracers, n1) == (9, 3):
        assert tile["rows"] == (8 if dtype == torch.float32 else 4)


@pytest.mark.gpu
def test_default_step_launches_every_kernel(cuda_device):
    """Two default steps at 24x32 on the card: each of the four kernels
    once per step, ridge_column once and cleanup_column twice (the
    thermodynamics' cleanup and the ridging's), the ridging passes a
    device count, finite state, moving ice."""
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.ops import evp_cuda, itd, mechred, remap_cuda
    from cice4_tpu_torch.state import init_state

    cfg = gx1_config().with_values(**{"grid.kmt_file": "",
                                      "domain.ny_global": 24,
                                      "domain.nx_global": 32})
    model = Model.create(cfg, device=cuda_device, dtype=torch.float32)
    state = init_state(cfg, model.grid, model.itd, device=cuda_device,
                       dtype=torch.float32)
    forcing = AnalyticForcing(cfg, model.grid, device=cuda_device,
                              dtype=torch.float32)
    wrappers = (tv.temperature_changes, evp_cuda.evp_subcycle,
                remap_cuda.ga_gsh, remap_cuda.k12_divergence,
                mechred.ridge_ice, itd.cleanup_itd)
    before = [w.launches for w in wrappers]
    for n in range(2):
        yday = 80.0 + n / 24.0
        state, fluxes = model(state, forcing(yday, 0.0), yday, 0.0)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [2] * 5 + [4]
    niter = fluxes["_ridge_niter"]
    assert niter.device.type == "cuda" and niter.dim() == 0
    assert 1 <= int(niter) <= mechred.nitermax_ridge
    assert bool(torch.isfinite(state.aicen).all())
    assert 0.0 < float(state.uvel.abs().max()) < 2.0


BOX_SMALL = {"domain.nx_global": 32, "domain.ny_global": 24,
             "domain.ew_boundary_type": "cyclic",
             "domain.ns_boundary_type": "cyclic", "grid.grid_type": "column",
             "grid.lat_origin": 69.0, "grid.dx_rect": 10.0e3,
             "grid.dy_rect": 10.0e3, "forcing.atm_data_type": "analytic"}


@pytest.mark.gpu
def test_box_split_route_launches_its_kernels(cuda_device, monkeypatch):
    """Two steps of the doubly-periodic box at 24x32 on the split route:
    the NS-cyclic EVP, K0 in GA mode, K1 and K2 once per step each, and
    neither GSH mode nor K12."""
    from cice4_tpu_torch.config import Config
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.ops import evp_cuda, remap_cuda
    from cice4_tpu_torch.state import init_state

    monkeypatch.setenv("CICE4_FORCE_PALLAS_REMAP", "1")
    cfg = Config().with_values(**BOX_SMALL)
    model = Model.create(cfg, device=cuda_device, dtype=torch.float32)
    state = init_state(cfg, model.grid, model.itd, device=cuda_device,
                       dtype=torch.float32)
    forcing = AnalyticForcing(cfg, model.grid, device=cuda_device,
                              dtype=torch.float32)
    counts = ((evp_cuda.evp_subcycle, "ns_cyclic_launches"),
              (remap_cuda.ga_planes, "launches"),
              (remap_cuda.construct, "launches"),
              (remap_cuda.contract, "launches"),
              (remap_cuda.ga_gsh, "launches"),
              (remap_cuda.k12_divergence, "launches"))
    before = [getattr(w, a) for w, a in counts]
    for n in range(2):
        yday = 80.0 + n / 24.0
        state, _ = model(state, forcing(yday, 0.0), yday, 0.0)
    torch.cuda.synchronize()
    assert [getattr(w, a) - b for (w, a), b in zip(counts, before)] == \
        [2, 2, 2, 2, 0, 0]
    assert bool(torch.isfinite(state.aicen).all())


@pytest.mark.gpu
@pytest.mark.parametrize("ns", FOLDS)
def test_split_route_refuses_the_fold(cuda_device, ns):
    """K0 in GA mode, K1 and K2 refuse a tripole grid on the card, naming
    the ROADMAP item, without a launch; `transport_remap` takes the default
    route there even with CICE4_FORCE_PALLAS_REMAP set."""
    from cice4_tpu_torch.ops import remap as remap_ops
    from cice4_tpu_torch.ops import remap_cuda

    grid = _dyn_grid((24, 32), ("cyclic", ns), cuda_device, torch.float32)
    meta = TABLES["gx1"]
    dx, dy, afac, mm, tm = kernel_check.remap_inputs(
        grid, seed=9, ncat=5, meta=meta, dtype=torch.float32)
    wrappers = (remap_cuda.ga_planes, remap_cuda.construct,
                remap_cuda.contract)
    before = [w.launches for w in wrappers]
    ga = torch.zeros((9, 10, 24, 32), device=cuda_device)
    for call in (lambda: remap_cuda.ga_planes(dx, dy, afac, grid.bc, 2),
                 lambda: remap_cuda.construct(grid.hm, mm, tm, meta, grid.bc),
                 lambda: remap_cuda.contract(ga, None, None, None, meta,
                                             grid.bc)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 2 item 5"):
            call()
    assert [w.launches for w in wrappers] == before
    assert not remap_ops.use_split_kernels(cuda_device, grid.bc)


TRIPOLE_SMALL = {**BOX_SMALL, "domain.ns_boundary_type": "tripole",
                 "dynamics.evp_damping": True}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["all-ocean-tripole", "access-om-40x32"])
def test_tripole_step_launches_every_kernel(cuda_device, case):
    """Two steps on a tripole grid at 24x32 (all ocean) or 40x32 (ACCESS-OM2's
    lat-lon grid) on the card: each of the four kernels of the default
    route once per step, the column kernels once and twice, finite state,
    moving ice."""
    from cice4_tpu_torch.config import Config, access_om_config
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.ops import evp_cuda, itd, mechred, remap_cuda
    from cice4_tpu_torch.state import init_state

    cfg = (Config().with_values(**TRIPOLE_SMALL)
           if case == "all-ocean-tripole"
           else access_om_config(nx=40, ny=32))
    model = Model.create(cfg, device=cuda_device, dtype=torch.float32)
    assert model.grid.bc.ns == "tripole"
    state = init_state(cfg, model.grid, model.itd, device=cuda_device,
                       dtype=torch.float32)
    forcing = AnalyticForcing(cfg, model.grid, device=cuda_device,
                              dtype=torch.float32)
    wrappers = (tv.temperature_changes, evp_cuda.evp_subcycle,
                remap_cuda.ga_gsh, remap_cuda.k12_divergence,
                mechred.ridge_ice, itd.cleanup_itd)
    before = [w.launches for w in wrappers]
    for n in range(2):
        yday = 80.0 + n / 24.0
        state, fluxes = model(state, forcing(yday, 0.0), yday, 0.0)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [2] * 5 + [4]
    niter = fluxes["_ridge_niter"]
    assert niter.device.type == "cuda" and niter.dim() == 0
    assert 1 <= int(niter) <= mechred.nitermax_ridge
    assert bool(torch.isfinite(state.aicen).all())
    assert 0.0 < float(state.uvel.abs().max()) < 2.0


DEDD_SMALL = {"grid.kmt_file": "", "domain.ny_global": 24,
              "domain.nx_global": 32, "radiation.shortwave": "dEdd",
              "tracers.tr_pond": True}


def _dedd_run(device, dtype):
    """(model, ponded state, forcing) of the 24x32 gx1 cut with dEdd
    shortwave and melt ponds."""
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.state import init_state

    cfg = gx1_config().with_values(**DEDD_SMALL)
    model = Model.create(cfg, device=device, dtype=dtype)
    state = init_state(cfg, model.grid, model.itd, device=device,
                       dtype=dtype)
    return model, kernel_check.ponded_state(state), \
        AnalyticForcing(cfg, model.grid, device=device, dtype=dtype)


@pytest.mark.gpu
def test_dedd_step_launches_every_kernel(cuda_device, monkeypatch):
    """Two dEdd steps with melt ponds at 24x32 on the card: each of the
    four kernels of the default route once per step and no plain version;
    the pond volume stays nonnegative and nonzero, the albedos physical."""
    from cice4_tpu_torch.ops import evp_cuda, remap_cuda

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card's path")

    for mod, name in ((tv, "_temperature_changes_core"),
                      (evp_cuda, "_evp_subcycle_plain"),
                      (remap_cuda, "ga_gsh_plain"),
                      (remap_cuda, "k12_plain")):
        monkeypatch.setattr(mod, name, refuse)
    model, state, forcing = _dedd_run(cuda_device, torch.float32)
    wrappers = (tv.temperature_changes, evp_cuda.evp_subcycle,
                remap_cuda.ga_gsh, remap_cuda.k12_divergence)
    before = [w.launches for w in wrappers]
    for n in range(2):
        yday = 80.0 + n / 24.0
        state, fluxes = model(state, forcing(yday, 0.0), yday, 0.0)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2] * 4
    assert bool(torch.isfinite(state.aicen).all())
    volpn = state.trcrn["volpn"]
    assert float(volpn.min()) >= 0.0 and float(volpn.max()) > 0.0
    for k in ("alvdr", "alidr", "alvdf", "alidf"):
        assert 0.0 <= float(fluxes[k].min()) and float(fluxes[k].max()) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_therm_newton_matches_plain_at_dedd_inputs(cuda_device, dtype,
                                                   monkeypatch):
    """therm_newton against its plain version at the arguments a dEdd step
    with ponds gives it: snow-layer absorption (Sswabs) nonzero."""
    model, state, forcing = _dedd_run(cuda_device, dtype)
    seen = []
    real = tv.temperature_changes

    def record(*args):
        seen.append(args)
        return real(*args)

    record.launches = 0     # the kernel's wrapper counts on its own name
    monkeypatch.setattr(tv, "temperature_changes", record)
    model(state, forcing(80.0, 0.0), 80.0, 0.0)
    monkeypatch.undo()
    p, dt, *args = seen[0]
    assert float(args[10].max()) > 0.0          # Sswabs
    kern = tv.temperature_changes(p, dt, *args)
    plain = tv._temperature_changes_core(p, dt, *args)
    torch.cuda.synchronize()
    report = kernel_check.compare(kern, plain, args[0], dtype)
    assert report["ok"], report


# the options of ROADMAP 1.4 that change which kernels a step launches:
# (config overrides, {wrapper: launches per step})
OPTION_LAUNCHES = {
    "l_dp_midpt_and_checks": (
        {"transport.l_dp_midpt": True, "transport.conservation_check": True,
         "transport.monotonicity_check": True},
        {"therm_newton": 1, "evp": 1, "gsh": 1, "k12": 1}),
    "l_fixed_area": ({"transport.l_fixed_area": True},
                     {"therm_newton": 1, "evp": 1, "gsh": 0, "k12": 1}),
    "upwind": ({"transport.advection": "upwind"},
               {"therm_newton": 1, "evp": 1, "gsh": 0, "k12": 0}),
    "zero_layer": ({"thermo.heat_capacity": False},
                   {"therm_newton": 0, "evp": 1, "gsh": 1, "k12": 1}),
    "calc_tsfc_false": ({"thermo.calc_Tsfc": False},
                        {"therm_newton": 0, "evp": 1, "gsh": 1, "k12": 1}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(OPTION_LAUNCHES))
def test_option_step_launches_its_kernels(cuda_device, name, monkeypatch):
    """Two steps of the 24x32 gx1 cut under an option of ROADMAP 1.4 on
    the card: each kernel its option runs once per step, the others never,
    and no kernel's plain version; the transport guards read clean."""
    from cice4_tpu_torch.guards import raise_on_violation
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.ops import evp_cuda, remap_cuda
    from cice4_tpu_torch.state import init_state

    _refuse_plain_versions(monkeypatch)
    over, per_step = OPTION_LAUNCHES[name]
    cfg = gx1_config().with_values(**{"grid.kmt_file": "",
                                      "domain.ny_global": 24,
                                      "domain.nx_global": 32, **over})
    model = Model.create(cfg, device=cuda_device, dtype=torch.float32)
    state = init_state(cfg, model.grid, model.itd, device=cuda_device,
                       dtype=torch.float32)
    forcing = AnalyticForcing(cfg, model.grid, device=cuda_device,
                              dtype=torch.float32)
    wrappers = {"therm_newton": tv.temperature_changes,
                "evp": evp_cuda.evp_subcycle, "gsh": remap_cuda.ga_gsh,
                "k12": remap_cuda.k12_divergence}
    before = {k: w.launches for k, w in wrappers.items()}
    for n in range(2):
        yday = 80.0 + n / 24.0
        state, fluxes = model(state, forcing(yday, 0.0), yday, 0.0)
        raise_on_violation(fluxes["_guards"])
    torch.cuda.synchronize()
    assert {k: w.launches - before[k] for k, w in wrappers.items()} == \
        {k: 2 * v for k, v in per_step.items()}
    assert bool(torch.isfinite(state.aicen).all())
    assert 0.0 < float(state.uvel.abs().max()) < 2.0


def _refuse_plain_versions(monkeypatch):
    from cice4_tpu_torch.ops import evp_cuda, gfdl_flux, itd, mechred
    from cice4_tpu_torch.ops import remap_cuda

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card's path")

    for mod, attr in ((tv, "_temperature_changes_core"),
                      (evp_cuda, "_evp_subcycle_plain"),
                      (remap_cuda, "ga_gsh_plain"),
                      (remap_cuda, "k12_plain"),
                      (mechred, "_ridge_ice_plain"),
                      (itd, "_cleanup_itd_plain"),
                      (gfdl_flux, "_gfdl_ocean_fluxes_plain")):
        monkeypatch.setattr(mod, attr, refuse)


def _wrappers():
    from cice4_tpu_torch.ops import evp_cuda, remap_cuda
    return {"therm_newton": tv.temperature_changes,
            "evp": evp_cuda.evp_subcycle, "gsh": remap_cuda.ga_gsh,
            "k12": remap_cuda.k12_divergence}


# the file-forced runs of chip_smoke.py's paths (k) and (l) at 24x32:
# (config overrides, the datasets whose files they read)
FILE_PATHS = {
    "ncar_ocean_climatology": (
        {"forcing.atm_data_type": "ncar", "forcing.sss_data_type": "clim",
         "forcing.sst_data_type": "clim", "forcing.restore_sst": True},
        ("ncar", "ocean")),
    "monthly_calc_strair_false": (
        {"forcing.atm_data_type": "monthly", "thermo.calc_strair": False},
        ("monthly",)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FILE_PATHS))
def test_file_forced_run_launches_every_kernel(cuda_device, name,
                                               monkeypatch, tmp_path):
    """Two steps of `IceModelRun` on the 24x32 gx1 cut under seeded files:
    the files found, each of the four kernels of the default route once a
    step and no plain version; under the monthly dataset the EVP reads
    its prescribed stress bit for bit."""
    from cice4_tpu_torch.driver import IceModelRun

    _refuse_plain_versions(monkeypatch)
    over, datasets = FILE_PATHS[name]
    for seed, ds in enumerate(datasets):
        kernel_check.write_forcing_files(tmp_path, ds, 24, 32, seed=seed,
                                         records_6h=4)
    cfg = gx1_config().with_values(**{
        "grid.kmt_file": "", "domain.ny_global": 24, "domain.nx_global": 32,
        "forcing.atm_data_dir": str(tmp_path),
        "forcing.ocn_data_dir": str(tmp_path),
        "run.history_dir": str(tmp_path / "history"), "run.diagfreq": 0,
        **over})
    run = IceModelRun(cfg, device=cuda_device, log=lambda line: None)
    run.initialize()
    assert run.forcing_provider.available
    wrappers = _wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    with kernel_check.evp_stress_reads() as reads:
        run.run(2)
    torch.cuda.synchronize()
    assert {k: w.launches - before[k] for k, w in wrappers.items()} == \
        {k: 2 for k in wrappers}
    assert bool(torch.isfinite(run.state.aicen).all())
    assert bool(torch.isfinite(run.state.sst).all())
    # the monthly stress is not weighted by the ice area (chip_smoke.py
    # check_free_drift): marginal ice drifts freely, so bound the pack's
    pack = run.state.aicen.sum(0) >= 0.5
    assert 0.0 < float(run.state.uvel[pack].abs().max()) < 2.0
    if "calc_strair" in name:
        assert len(reads) == 2
        for f, sx, sy in reads:
            assert torch.equal(sx, f.strax) and torch.equal(sy, f.stray)


@pytest.mark.gpu
@pytest.mark.parametrize("flavor", ["om", "cm"])
def test_component_launches_its_kernels(cuda_device, flavor, monkeypatch):
    """Two coupling intervals of one step of `IceComponent` on the 24x32
    ACCESS grid from seeded imports: ACCESS-OM (GFDL open-water fluxes)
    launches the four kernels of the default route once a step and the
    GFDL column kernel once an interval, ACCESS-CM (calc_Tsfc=False) all
    but therm_newton and gfdl_column; no plain version; the exports
    finite; under ACCESS-CM the EVP reads the UM's stress."""
    from cice4_tpu_torch import coupling, coupling_cm
    from cice4_tpu_torch.component import IceComponent
    from cice4_tpu_torch.config import access_om_config
    from cice4_tpu_torch.ops import gfdl_flux

    _refuse_plain_versions(monkeypatch)
    over = {} if flavor == "om" else {"thermo.calc_Tsfc": False,
                                      "thermo.calc_strair": False}
    cfg = access_om_config(nx=32, ny=24).with_values(**over)
    comp = IceComponent(cfg, flavor=flavor, gfdl_surface_flux=flavor == "om",
                        device=cuda_device, log=lambda *a: None).initialize()
    a2i = coupling.A2I_FIELDS if flavor == "om" \
        else coupling_cm.a2i_cm_fields(comp.runner.state.aicen.shape[0])
    wrappers = dict(_wrappers(), gfdl=gfdl_flux.gfdl_ocean_fluxes)
    before = {k: w.launches for k, w in wrappers.items()}
    with kernel_check.evp_stress_reads() as reads:
        for n in range(2):
            imports = {
                "a2i": kernel_check.coupler_fields(
                    a2i, 24, 32, n, device=cuda_device, dtype=torch.float32),
                "o2i": kernel_check.coupler_fields(
                    coupling.O2I_FIELDS, 24, 32, 10 + n, device=cuda_device,
                    dtype=torch.float32)}
            export = comp.run(imports, n_steps=1)
            for side in export.values():
                for k, v in side.items():
                    assert bool(torch.isfinite(v).all()), k
    torch.cuda.synchronize()
    want = {k: 2 for k in wrappers}
    if flavor == "cm":
        want["therm_newton"] = want["gfdl"] = 0
        for f, sx, sy in reads:
            assert torch.equal(sx, f.strax) and torch.equal(sy, f.stray)
    else:
        assert float(comp._boundary.u_star[comp.runner.grid.tmask].min()) > 0
    assert {k: w.launches - before[k] for k, w in wrappers.items()} == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_regrid_runoff_matches_the_cpu(cuda_device, dtype, rtol):
    """The masked runoff filter (one conv2d per sum, no TF32) on the card
    against the CPU, on a 120x144 field whose edges differ: in f64 to
    1e-12 of the field's scale, in f32 to 1e-5 (sums of 289 terms in
    another order)."""
    import numpy as np

    from cice4_tpu_torch.ops.runoff_regrid import regrid_runoff

    rng = np.random.default_rng(3)
    runof = torch.from_numpy(rng.uniform(0.0, 1e-4, (120, 144))).to(dtype)
    runof[0] += 5e-3
    runof[:, -1] += 2e-3
    mask = torch.from_numpy(rng.random((120, 144)) > 0.3)
    want = regrid_runoff(runof, mask)
    got = regrid_runoff(runof.to(cuda_device), mask.to(cuda_device)).cpu()
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


# ---------------------------------------------------------------------------
# the GFDL column kernel (csrc/gfdl_column.cu) against
# gfdl_flux._gfdl_ocean_fluxes_plain with kernel_check.GFDL_RTOL, on
# kernel_check.gfdl_inputs: at ACCESS-OM2-025's plane and at an odd one
# ---------------------------------------------------------------------------

GFDL_SHAPES = {"1080x1440": (1080, 1440), "37x53": (37, 53)}


def _gfdl_pair(x, **kw):
    """(kernel's outputs, its mo_passes, the plain version's outputs) on
    the same inputs."""
    from cice4_tpu_torch.ops import gfdl_cuda
    from cice4_tpu_torch.ops import gfdl_flux as gf

    passes = gfdl_cuda.mo_passes(x["tair"].device)
    passes.zero_()
    got = gfdl_cuda.gfdl_ocean_fluxes_cuda(**x, **kw)
    want = gf._gfdl_ocean_fluxes_plain(**x, **kw)
    return got, int(passes), want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", list(GFDL_SHAPES))
@pytest.mark.parametrize("celsius", [True, False], ids=["C", "K"])
@pytest.mark.parametrize("use_ncar", [False, True], ids=["mo", "ncar"])
@pytest.mark.parametrize("rough_scheme", ["beljaars", "charnock", "fixed"])
def test_gfdl_column_matches_plain(cuda_device, dtype, shape, celsius,
                                   use_ncar, rough_scheme):
    """Each output within GFDL_RTOL of the plain version by its 2-norm and
    no point beyond GFDL_POINT_RTOL; land cells exactly the plain
    version's (zero fluxes, ROUGHNESS_MIN); the Newton's passes in [1,
    MO_MAX_ITER], or 0 under use_ncar."""
    from cice4_tpu_torch.ops import gfdl_flux as gf

    x = kernel_check.gfdl_inputs(*GFDL_SHAPES[shape], seed=9,
                                 device=cuda_device, dtype=dtype,
                                 celsius=celsius)
    before = gf.gfdl_ocean_fluxes.launches
    got = gf.gfdl_ocean_fluxes(**x, rough_scheme=rough_scheme,
                               use_ncar=use_ncar)
    assert gf.gfdl_ocean_fluxes.launches == before + 1
    kern, passes, want = _gfdl_pair(x, rough_scheme=rough_scheme,
                                    use_ncar=use_ncar)
    for k in want:
        assert torch.equal(got[k], kern[k]), k
    report = kernel_check.compare_gfdl(kern, want)
    assert kernel_check.gfdl_ok(report, dtype), report
    land = ~x["tmask"]
    for k in want:
        assert torch.equal(kern[k][land], want[k][land]), k
        fill = gf.ROUGHNESS_MIN if k.startswith("rough") else 0.0
        assert bool((kern[k][land] == fill).all()), k
    if use_ncar:
        assert passes == 0
    else:
        assert 1 <= passes <= gf.MO_MAX_ITER


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gfdl_column_carries_u_star(cuda_device, dtype):
    """Three coupling intervals at 1080x1440, each taking the last one's
    u_star as the coupler does, on the kernel and on the plain version:
    within the tolerances at every interval."""
    from cice4_tpu_torch.ops import gfdl_flux as gf

    x = kernel_check.gfdl_inputs(1080, 1440, seed=21, device=cuda_device,
                                 dtype=dtype)
    x["u_star_prev"] = torch.full_like(x["tair"], 0.1)
    ku = pu = x["u_star_prev"]
    for n in range(3):
        kern = gf.gfdl_ocean_fluxes(**dict(x, u_star_prev=ku))
        want = gf._gfdl_ocean_fluxes_plain(**dict(x, u_star_prev=pu))
        report = kernel_check.compare_gfdl(kern, want)
        assert kernel_check.gfdl_ok(report, dtype), (n, report)
        ku, pu = kern["u_star"], want["u_star"]
        x["tair"] = x["tair"] + 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gfdl_column_is_one_launch_without_sync(cuda_device, dtype):
    """A call is one kernel launch as the profiler sees it, with no host
    synchronisation (`set_sync_debug_mode("error")`), and counts on the
    function even while a wrapper stands in the module's name; the
    device's mo_passes holds the most passes of the calls since it was
    zeroed, in [1, MO_MAX_ITER]."""
    from torch.profiler import ProfilerActivity, profile

    from cice4_tpu_torch.ops import gfdl_cuda
    from cice4_tpu_torch.ops import gfdl_flux as gf

    x = kernel_check.gfdl_inputs(300, 360, seed=2, device=cuda_device,
                                 dtype=dtype)
    gf.gfdl_ocean_fluxes(**x)         # builds the library and the counter
    torch.cuda.synchronize()
    real = gf.gfdl_ocean_fluxes
    passes = gfdl_cuda.mo_passes(x["tair"].device)
    passes.zero_()
    before = real.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            gf.gfdl_ocean_fluxes(**x)
            gf.gfdl_ocean_fluxes = lambda **kw: real(**kw)
            gf.gfdl_ocean_fluxes(**x)
        finally:
            gf.gfdl_ocean_fluxes = real
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    # the device's operations as the benchmark's tracer reads them (a
    # ctypes launch has no CPU operator for key_averages to put it under)
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA")]
    assert len(ops) == 2 and all("gfdl_column" in n for n in ops), ops
    assert real.launches == before + 2
    assert passes.device.type == "cuda" and passes.dim() == 0
    assert 1 <= int(passes) <= gf.MO_MAX_ITER


# ---------------------------------------------------------------------------
# the column kernels: ridge_column and cleanup_column
# (csrc/ridge_column.cu), against ridge_ice's and cleanup_itd's plain
# versions with kernel_check.COLUMN_RTOL; on the card they agree bit for
# bit but where a plain pass without closing rescales a tracer whose parent
# lies below puny (kernel_check.compare_columns leaves those out)
# ---------------------------------------------------------------------------

RIDGE_OPTIONS = [(0, 0), (0, 1), (1, 0), (1, 1)]
CLEANUP_CASES = {
    "iage": {},
    "iage+lvl+pond": {"tracers.tr_lvl": True, "tracers.tr_pond": True},
    "nilyr10": {"tracers.tr_lvl": True, "tracers.tr_pond": True,
                "domain.nilyr": 10},
    # the delta-function ITD: the category-1 minimum thickness
    "kitd0": {"thermo.kitd": 0},
}


def _column_case(size, over, device, dtype, seed=11):
    """(cfg, itd, tmask, state): the seeded state of
    `kernel_check.column_state` on a cut of gx1, six ocean columns
    masked."""
    from cice4_tpu_torch.grid import make_grid

    cfg = gx1_config().with_values(**{
        "grid.kmt_file": "", "domain.ny_global": size[0],
        "domain.nx_global": size[1], **over})
    grid = make_grid(cfg, device=device, dtype=dtype)
    tmask = grid.tmask.clone()
    tmask[5, 3:9] = False
    return (cfg, make_itd_params(cfg), tmask,
            kernel_check.column_state(cfg, grid, seed))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size", [(24, 32), (384, 320)],
                         ids=["24x32", "gx1"])
@pytest.mark.parametrize("partic,redist", RIDGE_OPTIONS)
def test_ridge_column_matches_plain(cuda_device, dtype, size, partic,
                                    redist):
    """The whole ridging loop in one launch, on compacted columns (three
    passes and more in some): the state, the ridging rates and the snow's
    fluxes as the plain loop gives them, the most passes of any column the
    plain loop's count, as a device tensor, and the same guard record."""
    from cice4_tpu_torch.ops import mechred

    cfg, itd, tmask, st = _column_case(
        size, {"dynamics.krdg_partic": partic,
               "dynamics.krdg_redist": redist}, cuda_device, dtype)
    st = kernel_check.compacted(st, seed=13)
    conv, shear, aice0 = kernel_check.ridge_forcing(st, seed=12)
    before = mechred.ridge_ice.launches
    kst, kd = mechred.ridge_ice(st, itd, cfg.dynamics, 3600.0, conv, shear,
                                tmask, aice0, guards=True)
    assert mechred.ridge_ice.launches == before + 1
    pst, pd = mechred._ridge_ice_plain(st, itd, cfg.dynamics, 3600.0, conv,
                                       shear, tmask, aice0, guards=True)
    report, _ = kernel_check.compare_columns(
        kst, kd, pst, pd, kernel_check.COLUMN_RTOL[dtype])
    assert kernel_check.fields_ok(report), report
    assert kd["niter"].device.type == "cuda"
    assert int(kd["niter"]) == pd["niter"] >= 3
    assert int(kd["_guard"]["count"]) == int(pd["_guard"]["count"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CLEANUP_CASES))
@pytest.mark.parametrize("limit_aice", [True, False])
def test_cleanup_column_matches_plain(cuda_device, dtype, case, limit_aice):
    """Rebin and zap in one launch, on states that move ice up and down
    the categories, zap small areas, hold total areas over 1 and (kitd 0)
    fix category 1's thickness: as the plain version, with the tracer
    sets and layer counts of CLEANUP_CASES."""
    from cice4_tpu_torch.ops import itd as itd_ops

    cfg, itd, tmask, st = _column_case((24, 32), CLEANUP_CASES[case],
                                       cuda_device, dtype)
    took = kernel_check.cleanup_triggers(st, itd, tmask)
    assert took["up"] and took["down"] and took["zap"] and took["excess"]
    assert bool(took["cat1"]) == (case == "kitd0")
    before = itd_ops.cleanup_itd.launches
    kst, kf = itd_ops.cleanup_itd(st, itd, tmask, 3600.0, limit_aice)
    assert itd_ops.cleanup_itd.launches == before + 1
    pst, pf = itd_ops._cleanup_itd_plain(st, itd, tmask, 3600.0, limit_aice)
    report, _ = kernel_check.compare_columns(
        kst, kf, pst, pf, kernel_check.COLUMN_RTOL[dtype])
    assert kernel_check.fields_ok(report), report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_column_kernels_at_twelve_categories(cuda_device, dtype):
    """ncat 12: in f32 a block's work slots fill 210 KB of shared memory,
    in f64 they would not fit and live in the global scratch tensor; both
    as the plain versions."""
    from cice4_tpu_torch.ops import itd as itd_ops
    from cice4_tpu_torch.ops import mechred, ridge_cuda

    cfg, itd, tmask, st = _column_case((24, 32), {"domain.ncat": 12},
                                       cuda_device, dtype)
    st = kernel_check.compacted(st, seed=13)
    in_shared = ridge_cuda._scratch("ridge_column", st.aicen, 1) is None
    assert in_shared == (dtype == torch.float32)
    conv, shear, aice0 = kernel_check.ridge_forcing(st, seed=12)
    kst, kd = mechred.ridge_ice(st, itd, cfg.dynamics, 3600.0, conv, shear,
                                tmask, aice0)
    pst, pd = mechred._ridge_ice_plain(st, itd, cfg.dynamics, 3600.0, conv,
                                       shear, tmask, aice0)
    rtol = kernel_check.COLUMN_RTOL[dtype]
    report, _ = kernel_check.compare_columns(kst, kd, pst, pd, rtol)
    assert kernel_check.fields_ok(report), report
    kst, kf = itd_ops.cleanup_itd(st, itd, tmask, 3600.0)
    pst, pf = itd_ops._cleanup_itd_plain(st, itd, tmask, 3600.0)
    report, _ = kernel_check.compare_columns(kst, kf, pst, pf, rtol)
    assert kernel_check.fields_ok(report), report


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_column_kernels_on_the_blocks_of_a_decomposed_grid(cuda_device,
                                                           dtype):
    """On a 2x2 mesh of blocks of a 48x64 cut, each block's launches give
    its columns what the whole grid's give, bit for bit; each block
    reports its own most passes and guard count, whose largest and whose
    sum are the whole grid's; a masked column ridges nothing and keeps
    its area."""
    from cice4_tpu_torch import convert
    from cice4_tpu_torch.ops import itd as itd_ops
    from cice4_tpu_torch.ops import mechred
    from cice4_tpu_torch.parallel.mesh import Mesh

    cfg, itd, tmask, st = _column_case((48, 64), {}, cuda_device, dtype)
    st = kernel_check.compacted(st, seed=13)
    conv, shear, aice0 = kernel_check.ridge_forcing(st, seed=12)

    def both(state, cut):
        rs, rd = mechred.ridge_ice(state, itd, cfg.dynamics, 3600.0,
                                   cut(conv), cut(shear), cut(tmask),
                                   cut(aice0), guards=True)
        cs, cf = itd_ops.cleanup_itd(rs, itd, cut(tmask), 3600.0)
        return rs, rd, cs, cf

    whole = both(st, lambda t: t)
    mesh = Mesh(2, 2)
    parts = convert.scatter_blocks(st, mesh)
    blocks = mesh.run(lambda b: both(parts[b],
                                     lambda t: mesh.scatter(t, b)))
    for k in (0, 2):
        got = kernel_check.column_outputs(
            convert.gather_blocks([o[k] for o in blocks], mesh), {})
        want = kernel_check.column_outputs(whole[k], {})
        for name in want:
            assert torch.equal(got[name], want[name]), (k, name)
    for k, names in ((1, kernel_check.RIDGE_DIAG),
                     (3, kernel_check.CLEANUP_FLUXES)):
        for name in names:
            got = mesh.assemble([o[k][name] for o in blocks])
            assert torch.equal(got, whole[k][name]), name
    # each block counts its own columns: the most passes of the blocks is
    # the whole grid's, their guard counts sum to its count
    niter = [int(o[1]["niter"]) for o in blocks]
    assert max(niter) == int(whole[1]["niter"]) >= 3, niter
    assert sum(int(o[1]["_guard"]["count"]) for o in blocks) == \
        int(whole[1]["_guard"]["count"])
    # the masked columns: one pass without closing or opening
    rs, rd = whole[0], whole[1]
    assert torch.equal(rs.aicen[:, 5, 3:9], st.aicen[:, 5, 3:9])
    assert not bool(rd["dardg1dt"][5, 3:9].any())
    assert not bool(rd["opening"][5, 3:9].any())


@pytest.mark.gpu
def test_gx1_cut_in_f64_on_the_card_matches_the_cpu(cuda_device):
    """Three default steps of the 24x32 gx1 cut with the level-ice tracers
    in f64: the card (the kernels) against the CPU (the plain versions),
    every state field within 1e-9 of its scale, as chip_smoke.py's phase
    16 holds its parities."""
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.state import STATE_FIELDS, init_state

    cfg = gx1_config().with_values(**{"grid.kmt_file": "",
                                      "domain.ny_global": 24,
                                      "domain.nx_global": 32,
                                      "tracers.tr_lvl": True})
    out = []
    for device in (cuda_device, torch.device("cpu")):
        model = Model.create(cfg, device=device, dtype=torch.float64)
        state = init_state(cfg, model.grid, model.itd, device=device,
                           dtype=torch.float64)
        forcing = AnalyticForcing(cfg, model.grid, device=device,
                                  dtype=torch.float64)
        for n in range(3):
            yday = 80.0 + n / 24.0
            state, _ = model(state, forcing(yday, 0.0), yday, 0.0)
        out.append(state)
    for name in STATE_FIELDS:
        got, want = getattr(out[0], name), getattr(out[1], name)
        pairs = ([(f"{name}.{k}", got[k], want[k]) for k in want]
                 if isinstance(want, dict) else [(name, got, want)])
        for tag, a, b in pairs:
            a = a.cpu()
            if not b.is_floating_point():
                assert torch.equal(a, b), tag
                continue
            scale = max(float(b.abs().max()), 1e-300)
            assert float((a - b).abs().max()) <= 1e-9 * scale, tag
