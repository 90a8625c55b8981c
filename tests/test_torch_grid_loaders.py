"""The port's grid-file loaders against the JAX package's, in f64 on the
CPU: a POP binary grid and KMT (``grid_format="bin"``, displaced-pole and
tripole), the same as netCDF (``grid_format="nc"``) and a pan-Arctic file
with its land mask inside, each written by the test into `tmp_path` with
`kernel_check`'s writers; both packages' `make_grid` must agree field by
field.

The files carry the metrics of the gx1 lat-lon grid cut to 24x32 (HTN and
HTE in cm) and a KMT with its first and last rows land plus a land block,
or for the pan-Arctic file uniform 8 km cells from 60N, open on every
side.  The loaded grid must also equal the grid built in memory from the
same records (the cm -> m round trip aside).

Tolerance: ``|torch - jax| <= 1e-12 * (|jax| + max|jax|)`` per field,
masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import grid as jg
from cice4_tpu.config import gx1_config as j_gx1_config
from cice4_tpu_torch import grid as tg
from cice4_tpu_torch import kernel_check
from cice4_tpu_torch.config import gx1_config as t_gx1_config
from cice4_tpu_torch.grid import GRID_FIELDS
from cice4_tpu_torch.parallel.halo import BoundaryConditions

F64 = torch.float64
CPU = torch.device("cpu")
NY, NX = 24, 32
# (grid_type, grid_format, ew, ns) of each case
CASES = {
    "pop_bin": ("displaced_pole", "bin", "cyclic", "closed"),
    "pop_bin_tripole": ("tripole", "bin", "cyclic", "tripole"),
    "pop_nc": ("displaced_pole", "nc", "cyclic", "closed"),
    "panarctic": ("panarctic", "bin", "open", "open"),
}


def _close(got, want, name, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300,
                                 err_msg=name)


def _records(case):
    """(records, kmt) the case's file holds."""
    if case == "panarctic":
        src = tg.make_rect_grid(NX, NY, BoundaryConditions("open", "open"),
                                dx=8.0e3, dy=8.0e3, lat_origin=60.0,
                                lon_origin=-150.0, land_edges=False,
                                device=CPU, dtype=F64)
    else:
        src = tg.make_latlon_grid(NX, NY, BoundaryConditions("cyclic",
                                                             "closed"),
                                  device=CPU, dtype=F64)
    kmt = np.where(src.hm.numpy() > 0.5, 30, 0).astype(np.int32)
    kmt[0] = kmt[-1] = 0
    kmt[8:13, 5:11] = 0                     # a land block
    return kernel_check.grid_records(src), kmt


def _write(case, directory):
    """The case's file(s) in `directory`; returns the config overrides
    that load them."""
    gtype, fmt, ew, ns = CASES[case]
    rec, kmt = _records(case)
    over = {"domain.ny_global": NY, "domain.nx_global": NX,
            "domain.ew_boundary_type": ew, "domain.ns_boundary_type": ns,
            "grid.grid_type": gtype, "grid.grid_format": fmt}
    if case == "panarctic":
        over["grid.grid_file"] = kernel_check.write_panarctic_grid(
            directory / "panarctic.grid", rec, kmt)
    else:
        over["grid.grid_file"], over["grid.kmt_file"] = \
            kernel_check.write_pop_grid(directory, rec, kmt, fmt)
    return over, rec, kmt


@pytest.mark.parametrize("case", list(CASES))
def test_loader_matches_jax(case, tmp_path):
    over, rec, kmt = _write(case, tmp_path)
    jgrid = jg.make_grid(j_gx1_config().with_values(**over),
                         dtype=jnp.float64)
    tgrid = tg.make_grid(t_gx1_config().with_values(**over), device=CPU,
                         dtype=F64)
    assert (tgrid.bc.ew, tgrid.bc.ns) == (jgrid.bc.ew, jgrid.bc.ns)
    assert (tgrid.ny, tgrid.nx) == (jgrid.ny, jgrid.nx) == (NY, NX)
    for k in GRID_FIELDS:
        _close(getattr(tgrid, k), getattr(jgrid, k), k)
    # the file's land mask is the grid's
    np.testing.assert_array_equal(tgrid.tmask.numpy(), kmt >= 1)
    assert 0 < int(tgrid.tmask.sum()) < NY * NX


@pytest.mark.parametrize("case", ["pop_bin", "panarctic"])
def test_loader_matches_the_grid_built_in_memory(case, tmp_path):
    over, rec, kmt = _write(case, tmp_path)
    cfg = t_gx1_config().with_values(**over)
    loaded = tg.make_grid(cfg, device=CPU, dtype=F64)
    bc = loaded.bc
    fields = tg._derive_metrics(rec["htn"] * 0.01, rec["hte"] * 0.01,
                                rec["ulat"], rec["ulon"], rec["angle"],
                                (kmt >= 1).astype(np.float64), bc)
    built = tg._make_grid(fields, bc, CPU, F64)
    for k in GRID_FIELDS:
        _close(getattr(loaded, k), getattr(built, k), k)
