"""Grid, state and forcing of the port against the JAX package, in f64.

The grid metrics are derived in NumPy f64 by the same code in both
packages and must be bitwise equal.  Fields that pass through a
transcendental function on the tensor side (AnalyticForcing, the
staggered transforms) are held to rtol 1e-13: XLA's and ATen's CPU
`exp`/`sin`/`pow` may differ in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import forcing as jforcing
from cice4_tpu import grid as jg
from cice4_tpu import state as js
from cice4_tpu.config import col_config, gx1_config
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu.parallel import halo as jhalo
from cice4_tpu_torch import convert
from cice4_tpu_torch import forcing as tforcing
from cice4_tpu_torch import grid as tg
from cice4_tpu_torch import state as ts
from cice4_tpu_torch.io.forcing_data import AnalyticForcing as TAnalytic
from cice4_tpu_torch.parallel import halo as thalo

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")


def _slice_cfg(ny=24, nx=32):
    return gx1_config().with_values(**{
        "grid.kmt_file": "", "dynamics.kdyn": 0,
        "transport.advection": "none",
        "domain.ny_global": ny, "domain.nx_global": nx})


def _tbc(bc):
    return thalo.BoundaryConditions(ew=bc.ew, ns=bc.ns)


def _assert_grid_equal(jgrid, tgrid):
    assert (jgrid.nx, jgrid.ny) == (tgrid.nx, tgrid.ny)
    assert (jgrid.bc.ew, jgrid.bc.ns) == (tgrid.bc.ew, tgrid.bc.ns)
    for k in tg.GRID_FIELDS:
        a, b = np.asarray(getattr(jgrid, k)), getattr(tgrid, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("ny,nx,ew,ns", [(24, 32, "cyclic", "closed"),
                                         (17, 20, "cyclic", "open")])
def test_latlon_grid_equal(ny, nx, ew, ns):
    jbc = jhalo.BoundaryConditions(ew=ew, ns=ns)
    _assert_grid_equal(
        jg.make_latlon_grid(nx, ny, jbc, dtype=jnp.float64),
        tg.make_latlon_grid(nx, ny, _tbc(jbc), device=CPU, dtype=F64))


@pytest.mark.parametrize("land_edges", [True, False])
def test_rect_grid_equal(land_edges):
    jbc = jhalo.BoundaryConditions(ew="cyclic", ns="open")
    _assert_grid_equal(
        jg.make_rect_grid(12, 10, jbc, land_edges=land_edges,
                          dtype=jnp.float64),
        tg.make_rect_grid(12, 10, _tbc(jbc), land_edges=land_edges,
                          device=CPU, dtype=F64))


@pytest.mark.parametrize("cfg", [_slice_cfg(), col_config()],
                         ids=["gx1-latlon-small", "col"])
def test_make_grid_equal(cfg):
    _assert_grid_equal(jg.make_grid(cfg, dtype=jnp.float64),
                       tg.make_grid(cfg, device=CPU, dtype=F64))


def _state_arrays(s):
    return {k: (np.asarray(v) if not isinstance(v, dict)
                else {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in vars(s).items()}


def _assert_state_equal(jst, tst):
    for k in ts.STATE_FIELDS:
        a, b = getattr(jst, k), getattr(tst, k)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), k
            for kk in a:
                np.testing.assert_array_equal(b[kk].numpy(),
                                              np.asarray(a[kk]), err_msg=kk)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=k)


@pytest.mark.parametrize("cfg", [
    _slice_cfg(),
    _slice_cfg().with_values(**{"tracers.tr_lvl": True}),
    col_config().with_values(**{"domain.nx_global": 8,
                                "domain.ny_global": 6,
                                "grid.grid_type": "rectangular"}),
    _slice_cfg().with_values(**{"thermo.kitd": 0, "tracers.tr_pond": True,
                                "radiation.prep_radiation": True}),
], ids=["latlon", "latlon-lvl", "rect", "latlon-kitd0-ponds-coupled"])
def test_init_state_equal(cfg):
    jgrid = jg.make_grid(cfg, dtype=jnp.float64)
    tgrid = tg.make_grid(cfg, device=CPU, dtype=F64)
    jst = js.init_state(cfg, jgrid, js.make_itd_params(cfg),
                        dtype=jnp.float64)
    tst = ts.init_state(cfg, tgrid, ts.make_itd_params(cfg), device=CPU,
                        dtype=F64)
    _assert_state_equal(jst, tst)
    assert float(tst.aicen.sum()) > 0.0


def test_itd_params_equal():
    for kitd in (1, 0):   # linear ITD, and the delta-function bounds
        cfg = _slice_cfg().with_values(**{"thermo.kitd": kitd})
        j, t = js.make_itd_params(cfg), ts.make_itd_params(cfg)
        for k in ("hin_max", "salin", "tmlt"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
        assert (j.ncat, j.nilyr, j.nslyr) == (t.ncat, t.nilyr, t.nslyr)
    assert j.hin_max[0] == 0.01


@pytest.mark.parametrize("yday", [1.0, 80.0, 172.5, 300.25])
def test_analytic_forcing_equal(yday):
    cfg = _slice_cfg()
    jf = JAnalytic(cfg, jg.make_grid(cfg, dtype=jnp.float64),
                   jnp.float64)(yday, 0.0)
    tf = TAnalytic(cfg, tg.make_grid(cfg, device=CPU, dtype=F64),
                   device=CPU, dtype=F64)(yday, 0.0)
    for k in tforcing.FORCING_FIELDS:
        a, b = getattr(jf, k), getattr(tf, k)
        if a is None:
            assert b is None, k
            continue
        assert b.dtype == F64, k
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13,
                                   atol=1e-300, err_msg=k)


def test_default_forcing_equal():
    jf = jforcing.default_forcing(5, 7, jnp.float64)
    tf = tforcing.default_forcing(5, 7, device=CPU, dtype=F64)
    for k in tforcing.FORCING_FIELDS:
        a = getattr(jf, k)
        if a is not None:
            np.testing.assert_array_equal(getattr(tf, k).numpy(),
                                          np.asarray(a), err_msg=k)


# the location and type of a field, by kind: the first two are the
# shifts' defaults and the EVP's corner velocities; the fold reads another
# row, another index map and another sign for each
HALO_KINDS = {"center scalar": ("CENTER", "SCALAR"),
              "corner vector": ("NE_CORNER", "VECTOR"),
              "center vector": ("CENTER", "VECTOR"),
              "corner scalar": ("NE_CORNER", "SCALAR"),
              "n_face scalar": ("N_FACE", "SCALAR"),
              "n_face vector": ("N_FACE", "VECTOR"),
              "e_face scalar": ("E_FACE", "SCALAR"),
              "e_face angle": ("E_FACE", "ANGLE")}


@pytest.mark.parametrize("ew,ns", [("cyclic", "closed"), ("closed", "open"),
                                   ("cyclic", "cyclic"), ("open", "open"),
                                   ("cyclic", "tripole"),
                                   ("cyclic", "tripoleT")])
@pytest.mark.parametrize("fn", ["nbr_e", "nbr_w", "nbr_n", "nbr_s",
                                "nbr_ne", "nbr_nw", "nbr_se", "nbr_sw"])
@pytest.mark.parametrize("kind", list(HALO_KINDS))
def test_halo_neighbours_equal(fn, ew, ns, kind):
    """Bit-equal to the JAX package's shifts at every field location and
    type, which on the tripole and tripoleT folds pick the ghost row's
    source row, index map and sign."""
    f = np.random.RandomState(0).standard_normal((2, 5, 6))
    loc, ftype = HALO_KINDS[kind]
    kw_j = dict(loc=getattr(jhalo.FieldLoc, loc),
                ftype=getattr(jhalo.FieldType, ftype))
    kw_t = dict(loc=getattr(thalo.FieldLoc, loc),
                ftype=getattr(thalo.FieldType, ftype))
    out_j = getattr(jhalo, fn)(jnp.asarray(f),
                               jhalo.BoundaryConditions(ew=ew, ns=ns), **kw_j)
    out_t = getattr(thalo, fn)(torch.from_numpy(f),
                               thalo.BoundaryConditions(ew=ew, ns=ns), **kw_t)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("name", ["to_ugrid", "to_tgrid"])
def test_staggered_transforms_equal(name):
    cfg = _slice_cfg()
    jgrid = jg.make_grid(cfg, dtype=jnp.float64)
    tgrid = tg.make_grid(cfg, device=CPU, dtype=F64)
    f = np.random.RandomState(1).standard_normal((cfg.domain.ny_global,
                                                  cfg.domain.nx_global))
    a = getattr(jg, name)(jgrid, jnp.asarray(f))
    b = getattr(tg, name)(tgrid, torch.from_numpy(f))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13,
                               atol=1e-300)


def test_convert_roundtrip():
    cfg = _slice_cfg()
    jgrid = jg.make_grid(cfg, dtype=jnp.float64)
    jst = js.init_state(cfg, jgrid, js.make_itd_params(cfg),
                        dtype=jnp.float64)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in tg.GRID_FIELDS},
        _tbc(jgrid.bc), device=CPU, dtype=F64)
    _assert_grid_equal(jgrid, tgrid)
    tst = convert.state_from_arrays(_state_arrays(jst), device=CPU,
                                    dtype=F64)
    _assert_state_equal(jst, tst)
    back = convert.to_arrays(tst)
    np.testing.assert_array_equal(back["eicen"], np.asarray(jst.eicen))
    assert back["trcrn"].keys() == jst.trcrn.keys()
    jf = JAnalytic(cfg, jgrid, jnp.float64)(80.0, 0.0)
    tf = convert.forcing_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in vars(jf).items()}, device=CPU, dtype=F64)
    assert tf.strax is None
    np.testing.assert_array_equal(convert.to_arrays(tf)["flw"],
                                  np.asarray(jf.flw))
    f32 = convert.state_from_arrays(_state_arrays(jst), device=CPU,
                                    dtype=torch.float32)
    assert f32.aicen.dtype == torch.float32
    assert f32.iceumask.dtype == torch.bool


def test_convert_carries_swn():
    """The coupled order's carried shortwave (`swn`) goes both ways."""
    cfg = _slice_cfg().with_values(**{"radiation.prep_radiation": True})
    jgrid = jg.make_grid(cfg, dtype=jnp.float64)
    jst = js.init_state(cfg, jgrid, js.make_itd_params(cfg),
                        dtype=jnp.float64)
    rng = np.random.RandomState(2)
    jst = jst.replace(swn={k: jnp.asarray(rng.rand(*np.shape(v)))
                           for k, v in jst.swn.items()})
    tst = convert.state_from_arrays(_state_arrays(jst), device=CPU,
                                    dtype=F64)
    assert set(tst.swn) == set(jst.swn) == {
        "fswsfcn", "fswintn", "fswthrun", "Sswabsn", "Iswabsn",
        "alvdr_gbm", "alvdf_gbm", "alidr_gbm", "alidf_gbm"}
    back = convert.to_arrays(tst)["swn"]
    for k, v in jst.swn.items():
        np.testing.assert_array_equal(tst.swn[k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(back[k], np.asarray(v))


def test_restart_carries_swn_across_packages(tmp_path):
    """Both packages' restarts write the coupled order's `swn` (as
    ``swn.*`` entries) and each reads the other's."""
    from cice4_tpu.io import restart as jrestart
    from cice4_tpu_torch.io import restart as trestart

    cfg = _slice_cfg().with_values(**{"radiation.prep_radiation": True})
    jgrid = jg.make_grid(cfg, dtype=jnp.float64)
    jst = js.init_state(cfg, jgrid, js.make_itd_params(cfg),
                        dtype=jnp.float64)
    rng = np.random.RandomState(4)
    jst = jst.replace(swn={k: jnp.asarray(rng.rand(*np.shape(v)))
                           for k, v in jst.swn.items()})
    template = ts.init_state(cfg, tg.make_grid(cfg, device=CPU, dtype=F64),
                             ts.make_itd_params(cfg), device=CPU, dtype=F64)
    jpath = jrestart.dump_restart(jst, str(tmp_path / "j.npz"), 1, 0.0)
    tst, _ = trestart.load_restart(jpath, template)
    _assert_state_equal(jst, tst)
    tpath = trestart.dump_restart(tst, str(tmp_path / "t.npz"), 1, 0.0)
    back, _ = jrestart.load_restart(tpath, jst)
    for k, v in jst.swn.items():
        np.testing.assert_array_equal(np.asarray(back.swn[k]), np.asarray(v))
