"""The port's forcing readers against the JAX package's, in f64 on the CPU,
on the same files: the seven atmosphere datasets of `_ATM_DATASETS` and
the ocean climatology (written by `kernel_check.write_forcing_files` in
the reference's layouts, seeded), the record bracketing and its
persistence and periodicity rules, the provider factory and the fallback
to the analytic forcing; and one run of both packages' `IceModelRun`
under the `monthly` dataset with ``calc_strair=False`` and the ocean
climatology with SST restoring (one JAX compile of the step).

Tolerances: the forcing fields within ``1e-12 * (|jax| + max|jax|)``; the
record reads and the interpolation weights, which are the same NumPy
float64 code in both packages, exactly; the whole run within 1e-10 of
each field's scale, as the other step tests.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import grid as jg
from cice4_tpu import state as js
from cice4_tpu.calendar import Calendar as JCal
from cice4_tpu.config import Config as JConfig
from cice4_tpu.config import gx1_config as j_gx1_config
from cice4_tpu.driver import IceModelRun as JRun
from cice4_tpu.io import forcing_data as jfd
from cice4_tpu.parallel.halo import BoundaryConditions as JBC
from cice4_tpu_torch import convert, kernel_check
from cice4_tpu_torch import model as tm
from cice4_tpu_torch.calendar import Calendar as TCal
from cice4_tpu_torch.config import Config as TConfig
from cice4_tpu_torch.config import gx1_config as t_gx1_config
from cice4_tpu_torch.driver import IceModelRun as TRun
from cice4_tpu_torch.forcing import FORCING_FIELDS
from cice4_tpu_torch.io import forcing_data as tfd
from cice4_tpu_torch.state import STATE_FIELDS

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
NY, NX = 12, 16
DATASETS = ("ncar", "bin", "LYq", "monthly", "ecmwf", "hadgem", "rct")
YEARS = (1997, 1998)
# (year, day of year, seconds into the day, step index): the cycle's
# first record (persistence), mid-month exactly, a general time, the last
# 6-hourly interval of the first year, the next year, a year that cycles
# back (ycycle 2) and the end of the cycle's last year
TIMES = ((1997, 1, 0.0, 0), (1997, 15, 0.0, 3), (1997, 45, 25200.0, 5),
         (1997, 365, 64800.0, 7), (1998, 1, 3600.0, 2),
         (1999, 200, 43200.0, 9), (1998, 365, 82800.0, 1))


def _close(got, want, name, rtol=1e-12):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300,
                                 err_msg=name)


def _arrays(obj):
    return {k: (np.asarray(v) if not isinstance(v, dict)
                else {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in vars(obj).items()}


@pytest.fixture(scope="module")
def grids():
    """The rectangular grid with land edges, its ANGLET seeded so that the
    winds and stresses rotate, in both packages."""
    jgrid = jg.make_rect_grid(NX, NY, JBC("cyclic", "open"), dx=20.0e3,
                              dy=20.0e3, land_edges=True, dtype=jnp.float64)
    ang = np.random.default_rng(3).uniform(-1.0, 1.0, (NY, NX))
    jgrid = dataclasses.replace(jgrid, anglet=jnp.asarray(ang))
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew="cyclic", ns="open"), device=CPU,
        dtype=F64)
    return jgrid, tgrid


def _configs(tmp, **forcing):
    over = {"domain.nx_global": NX, "domain.ny_global": NY,
            "forcing.atm_data_dir": str(tmp), "forcing.ocn_data_dir": str(tmp),
            "forcing.ycycle": 2,
            **{f"forcing.{k}": v for k, v in forcing.items()}}
    return JConfig().with_values(**over), TConfig().with_values(**over)


def _calendars(year, yday, sec, istep):
    jcal = JCal(dt=3600.0, year_init=1997)
    jcal.time = ((year - 1997) * 365 + yday - 1) * 86400.0 + sec
    jcal._recompute()
    tcal = TCal(dt=3600.0, year_init=1997)
    tcal.time = jcal.time
    tcal._recompute()
    jcal.istep = tcal.istep = istep
    return jcal, tcal


def _states(jcfg, jgrid, seed=7):
    """A JAX state with seeded SST and surface temperatures (which the
    Rosati-Miyakoda longwave reads) and the same state in the port."""
    rng = np.random.default_rng(seed)
    jst = js.init_state(jcfg, jgrid, js.make_itd_params(jcfg),
                        dtype=jnp.float64)
    jst = jst.replace(
        sst=jnp.asarray(rng.uniform(-2.0, 3.0, (NY, NX))),
        tsfcn=jnp.asarray(rng.uniform(-20.0, 0.0, jst.tsfcn.shape)))
    return jst, convert.state_from_arrays(_arrays(jst), device=CPU,
                                          dtype=F64)


def _forcing_close(jf, tf, what):
    for k in FORCING_FIELDS:
        a, b = getattr(jf, k), getattr(tf, k)
        assert (a is None) == (b is None), (what, k)
        if a is not None:
            _close(b, a, f"{what} {k}")


@pytest.mark.parametrize("dataset", DATASETS + ("ocean",))
def test_reader_matches_jax(dataset, grids, tmp_path):
    """Each dataset's provider on the same files at the TIMES, with a
    state: every Forcing field, and for the ocean climatology its initial
    fields and the SST restoring too."""
    jgrid, tgrid = grids
    atm = "ncar" if dataset == "ocean" else dataset
    kernel_check.write_forcing_files(tmp_path, atm, NY, NX, years=YEARS,
                                     seed=5)
    clim = {}
    if dataset == "ocean":
        kernel_check.write_forcing_files(tmp_path, "ocean", NY, NX, seed=6)
        clim = dict(sss_data_type="clim", sst_data_type="clim",
                    restore_sst=True, trestore=30)
    jcfg, tcfg = _configs(tmp_path, atm_data_type=atm, **clim)
    jp = jfd.make_forcing_provider(jcfg, jgrid, jnp.float64)
    tp = tfd.make_forcing_provider(tcfg, tgrid, device=CPU, dtype=F64)
    assert type(tp).__name__ == type(jp).__name__
    assert jp.available and tp.available
    jst, tst = _states(jcfg, jgrid)
    for year, yday, sec, istep in TIMES:
        jcal, tcal = _calendars(year, yday, sec, istep)
        what = f"{dataset} {year}/{yday} {sec}"
        _forcing_close(jp(jcal.yday, jcal.sec, cal=jcal, state=jst),
                       tp(tcal.yday, tcal.sec, cal=tcal, state=tst), what)
        _close(tp.ocean_update(tst, tcal, 3600.0).sst,
               jp.ocean_update(jst, jcal, 3600.0).sst, f"{what} sst")
    if dataset == "ocean":
        for j, t in zip(jp.ocn.initial_fields(2), tp.ocn.initial_fields(2)):
            _close(t, j, "initial ocean fields")
    else:
        # without a state or a calendar (the reader builds its own clock)
        _forcing_close(jp(40.25, 21600.0), tp(40.25, 21600.0),
                       f"{dataset} without state")


def test_brackets_and_weights_equal_jax():
    """The bracketing records and weights over two years of hourly
    times, at a 365-day and a 360-day year."""
    for days in (365, 360):
        for step in range(0, 2 * days * 24, 5):
            jcal = JCal(dt=3600.0, year_init=1997, days_per_year=days)
            tcal = TCal(dt=3600.0, year_init=1997, days_per_year=days)
            jcal.time = tcal.time = step * 3600.0
            jcal._recompute()
            tcal._recompute()
            assert tfd.monthly_bracket(tcal) == jfd.monthly_bracket(jcal)
            assert tfd.sixhourly_bracket(tcal) == jfd.sixhourly_bracket(jcal)
            for cyc in (1, 3):
                assert tfd.forcing_year(tcal, 1990, cyc) == \
                    jfd.forcing_year(jcal, 1990, cyc)
    for recslot in (1, 2):
        for dataloc in (1, 2):
            for ftime in (0.0, 1234.5, 86400.0 * 200.3):
                assert tfd.interp_coeff(7, recslot, 21600.0, dataloc,
                                        ftime) == \
                    jfd.interp_coeff(7, recslot, 21600.0, dataloc, ftime)
        for month in range(1, 13):
            ftime = (month * 30.4 - 10.0) * 86400.0
            assert tfd.interp_coeff_monthly(recslot, month, ftime) == \
                jfd.interp_coeff_monthly(recslot, month, ftime)


@pytest.mark.parametrize("cadence", ["6h", "daily", "monthly", "clim"])
def test_record_reads_equal_jax(cadence, grids, tmp_path):
    """`read_6hourly`, `read_daily` and `read_monthly` (yearly files and a
    climatology) over ycycle 2 on records that hold their own number plus
    1000 times the year's index: the persistence at the cycle's start and
    end, the daily year boundary, the year cycling and the periodic
    monthly wrap, bit for bit; and the values of the reference's rules at
    a few of them."""
    jgrid, tgrid = grids
    nrec = {"6h": 1460, "daily": 365}.get(cadence, 12)
    for k, year in enumerate(YEARS):
        vals = 1000.0 * (k + 1) + np.arange(1, nrec + 1, dtype=np.float64)
        np.asarray(vals[:, None, None] * np.ones((1, NY, NX)),
                   ">f8").tofile(tmp_path / f"v_{year}.r")
    jcfg, tcfg = _configs(tmp_path)
    jds, tds = jfd._FileDataset(jcfg, jgrid), tfd._FileDataset(tcfg, tgrid)
    if cadence == "clim":
        path = str(tmp_path / "v_1997.r")
        pathfn = path
    else:
        def pathfn(y):
            return str(tmp_path / f"v_{y}.r")
    read = {"6h": "read_6hourly", "daily": "read_daily"}.get(cadence,
                                                            "read_monthly")
    kw = {"climatology": True} if cadence == "clim" else {}
    for step in range(0, 3 * 365 * 24, 7):
        jcal, tcal = _calendars(1997, 1, step * 3600.0, 0)
        np.testing.assert_array_equal(getattr(tds, read)(pathfn, tcal, **kw),
                                      getattr(jds, read)(pathfn, jcal, **kw))

    def at(year, yday, sec):
        return float(getattr(tds, read)(pathfn, _calendars(year, yday, sec,
                                                           0)[1], **kw)[0, 0])
    if cadence == "daily":
        # midnight Jan 1 of the second year: halfway between 1997's last
        # record and 1998's first; the end of the cycle persists its last
        # record; Dec 31 18:00 of the first year weighs 1998's first by 1/4
        assert at(1998, 1, 0.0) == pytest.approx(0.5 * (1365.0 + 2001.0))
        assert at(1998, 365, 64800.0) == pytest.approx(2365.0)
        assert at(1997, 365, 64800.0) == pytest.approx(0.75 * 1365.0
                                                       + 0.25 * 2001.0)
    if cadence == "6h":
        # 01:00 Jan 1 of the first year: the first record, persisted; the
        # second year looks back into the first
        assert at(1997, 1, 3600.0) == 1001.0
        assert at(1998, 1, 3600.0) == pytest.approx(
            5.0 / 6.0 * 1460.0 + 1.0 / 6.0 * 2001.0 + 5.0 / 6.0 * 1000.0)
    if cadence == "monthly":
        # mid-January exactly: January's record; the cycle wraps, so the
        # first year's 1 January is 14/31 of the way back to the last
        # year's December
        assert at(1997, 15, 0.0) == pytest.approx(1001.0)
        assert at(1997, 1, 0.0) == pytest.approx(14.0 / 31.0 * 2012.0
                                                 + 17.0 / 31.0 * 1001.0)


def test_make_forcing_provider_class_equals_jax(grids, tmp_path):
    """The factory returns the class JAX's returns for every
    `atm_data_type` (and for the analytic and an unknown one), with and
    without the ocean climatology's files."""
    jgrid, tgrid = grids
    kernel_check.write_forcing_files(tmp_path, "ocean", NY, NX, seed=1)
    for kind in tuple(jfd._ATM_DATASETS) + ("analytic", "none"):
        for clim in ("default", "clim"):
            jcfg, tcfg = _configs(tmp_path, atm_data_type=kind,
                                  sss_data_type=clim)
            jp = jfd.make_forcing_provider(jcfg, jgrid, jnp.float64)
            tp = tfd.make_forcing_provider(tcfg, tgrid, device=CPU,
                                           dtype=F64)
            assert type(tp).__name__ == type(jp).__name__, (kind, clim)
            assert getattr(tp, "available", None) == \
                getattr(jp, "available", None), (kind, clim)
            if clim == "clim":
                assert type(tp.atm).__name__ == type(jp.atm).__name__


@pytest.mark.parametrize("dataset", DATASETS)
def test_absent_files_fall_back_to_analytic(dataset, grids, tmp_path):
    """Without its files (no directory, or one without them) a dataset
    is unavailable and gives the analytic forcing, as JAX's does."""
    jgrid, tgrid = grids
    (tmp_path / "empty").mkdir()
    for d in ("", str(tmp_path / "absent"), str(tmp_path / "empty")):
        jcfg, tcfg = _configs(tmp_path, atm_data_type=dataset,
                              atm_data_dir=d)
        jp = jfd.make_forcing_provider(jcfg, jgrid, jnp.float64)
        tp = tfd.make_forcing_provider(tcfg, tgrid, device=CPU, dtype=F64)
        assert not tp.available and not jp.available
        jcal, tcal = _calendars(1997, 80, 0.0, 4)
        want = tfd.AnalyticForcing(tcfg, tgrid, device=CPU,
                                   dtype=F64)(80.0, 0.0)
        got = tp(tcal.yday, tcal.sec, cal=tcal)
        _forcing_close(want, got, f"{dataset} fallback")
        _forcing_close(jp(jcal.yday, jcal.sec, cal=jcal), got,
                       f"{dataset} fallback vs jax")


def test_monthly_stress_and_ocean_climatology_run_matches_jax(tmp_path):
    """Three gx1 steps at 24x32 through both packages' `IceModelRun` under
    the `monthly` dataset with ``calc_strair=False`` (its prescribed
    stress, rotated by ANGLET, drives the EVP) and the ocean climatology
    with SST restoring (the initial SST is the climatology's): every state
    field within 1e-10 of its scale.  In the port the air stress the EVP
    reads is the provider's bit for bit."""
    ny, nx = 24, 32
    kernel_check.write_forcing_files(tmp_path, "monthly", ny, nx, seed=11)
    kernel_check.write_forcing_files(tmp_path, "ocean", ny, nx, seed=12)
    over = {"grid.kmt_file": "", "domain.ny_global": ny,
            "domain.nx_global": nx, "thermo.calc_strair": False,
            "forcing.atm_data_type": "monthly",
            "forcing.atm_data_dir": str(tmp_path),
            "forcing.sss_data_type": "clim", "forcing.sst_data_type": "clim",
            "forcing.ocn_data_dir": str(tmp_path),
            "forcing.restore_sst": True, "forcing.trestore": 10,
            "run.histfreq": ("x",) * 5, "run.diagfreq": 0,
            "run.history_dir": str(tmp_path / "history")}
    jrun = JRun(j_gx1_config().with_values(**over), dtype=jnp.float64,
                log=lambda *a: None).initialize()
    trun = TRun(t_gx1_config().with_values(**over), dtype=F64,
                log=lambda *a: None, device=CPU).initialize()
    assert type(trun.forcing_provider).__name__ == "CombinedProvider"
    assert trun.forcing_provider.available
    _close(trun.state.sst, jrun.state.sst, "initial sst")
    jrun.run(3)
    trun.run(3)
    for k in STATE_FIELDS:
        a, b = getattr(jrun.state, k), getattr(trun.state, k)
        if isinstance(a, dict):
            for kk in a:
                _close(b[kk], a[kk], f"{k}.{kk}", rtol=1e-10)
        else:
            _close(b, a, k, rtol=1e-10)
    assert float(trun.state.uvel.abs().max()) > 0.0

    cal = trun.calendar
    f = trun.forcing_provider(cal.yday, cal.sec, cal=cal, state=trun.state)
    assert float(f.strax.abs().max()) > 0.01
    read = []

    def evp(*args, **kw):
        read.append(args[-2:])
        return evp_of_step(*args, **kw)
    evp_of_step = tm.evp
    try:
        tm.evp = evp
        trun.model(trun.state, f, cal.yday, cal.sec)
    finally:
        tm.evp = evp_of_step
    assert torch.equal(read[0][0], f.strax)
    assert torch.equal(read[0][1], f.stray)


def test_qa_fix_stays_finite_in_float32(grids, tmp_path):
    """The monthly dataset applies Qa_fixLY to the land-masked air
    temperature: at 0 K the JAX package's saturation pressure overflows
    float32 and leaves NaN on land.  The port bounds its exponent, so its
    float32 forcing is finite everywhere and its float64 results are
    JAX's (`test_reader_matches_jax`)."""
    jgrid, tgrid = grids
    zero = np.zeros(3, np.float32)
    qa = np.full(3, 1e-3, np.float32)
    assert np.isnan(np.asarray(jfd._qa_fix_ly(jnp.asarray(zero),
                                              jnp.asarray(qa)))).all()
    for dtype in (torch.float32, F64):
        got = tfd._qa_fix_ly(torch.zeros(3, dtype=dtype),
                             torch.full((3,), 1e-3, dtype=dtype))
        assert bool(torch.isfinite(got).all())
    # at 0 K both float64 values are -0.622/0.378 to the last bit or so,
    # and the land mask zeroes them
    _close(tfd._qa_fix_ly(torch.zeros(3, dtype=F64),
                          torch.full((3,), 1e-3, dtype=F64)),
           jfd._qa_fix_ly(jnp.zeros(3), jnp.full(3, 1e-3)), "Qa at 0 K",
           rtol=1e-15)
    kernel_check.write_forcing_files(tmp_path, "monthly", NY, NX, seed=2)
    _, tcfg = _configs(tmp_path, atm_data_type="monthly")
    f32grid = convert.grid_from_arrays(convert.to_arrays(tgrid), tgrid.bc,
                                       device=CPU, dtype=torch.float32)
    assert not bool(f32grid.hm.all())
    prov = tfd.make_forcing_provider(tcfg, f32grid, device=CPU,
                                     dtype=torch.float32)
    jcal, tcal = _calendars(1997, 20, 0.0, 0)
    f = prov(tcal.yday, tcal.sec, cal=tcal)
    for k in FORCING_FIELDS:
        v = getattr(f, k)
        assert v is None or bool(torch.isfinite(v).all()), k
