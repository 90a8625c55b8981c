"""The port's run-time shell against the JAX package's, in f64 on the CPU:
the calendar, the driver `IceModelRun` with its diagnostics, history and
restart, the CLI, the forcing-provider factory, restoring and the grid's
cell corners.

The runs are the doubly-periodic box of `tests/test_torch_box.py` at
24x32 (damped EVP; see that file for why).  One module fixture runs the
JAX driver for 3 steps (its jitted step compiles once, ~1 min) and the
port's driver beside it.

Tolerances: model values within ``1e-10 * (|jax| + max|jax|)``, as the
step tests; the history files store float32, so their values agree to
the float32 rounding of numbers that agree to 1e-10 (2 ulp); restarts
and calendars exactly where they are exact.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from cice4_tpu import calendar as jcal
from cice4_tpu import diagnostics as jdiag
from cice4_tpu.config import Config as JConfig
from cice4_tpu.driver import IceModelRun as JRun
from cice4_tpu.grid import gridbox_corners as j_corners
from cice4_tpu.io import history as jhist
from cice4_tpu.io import restart as jrestart
from cice4_tpu.ops import restoring as jrestoring
from cice4_tpu_torch import calendar as tcal
from cice4_tpu_torch import convert
from cice4_tpu_torch import diagnostics as tdiag
from cice4_tpu_torch.config import Config as TConfig
from cice4_tpu_torch.driver import IceModelRun as TRun
from cice4_tpu_torch.grid import gridbox_corners as t_corners
from cice4_tpu_torch.io import forcing_data as tforcing
from cice4_tpu_torch.io import history as thist
from cice4_tpu_torch.ops import restoring as trestoring
from cice4_tpu_torch.state import STATE_FIELDS

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent
BOX = {"domain.nx_global": 32, "domain.ny_global": 24,
       "domain.ew_boundary_type": "cyclic",
       "domain.ns_boundary_type": "cyclic", "grid.grid_type": "column",
       "grid.lat_origin": 69.0, "grid.dx_rect": 10.0e3,
       "grid.dy_rect": 10.0e3, "forcing.atm_data_type": "analytic",
       "dynamics.evp_damping": True}
# roundoff-sized fields take the scale of the terms they come from
_SCALE_OF = {"fmelttn_ai": "fsurfn_ai", "melts": "congel", "meltt": "congel",
             "meltb": "congel", "snoice": "congel", "fmeltt_ai": "fsurf_ai"}


def _close(got, want, name, rtol=1e-10, scale_of=None):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    ref = want if scale_of is None else np.asarray(scale_of)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-30,
                                 err_msg=name)


def _box(tmp, pkg, **more):
    over = {**BOX, "run.history_dir": str(tmp / "history"),
            "run.restart_dir": str(tmp / "restart"),
            "run.pointer_file": str(tmp / "restart" / "ice.restart_file"),
            "run.histfreq": ("h",), "run.histfreq_n": (2,),
            "run.dumpfreq": "1", "run.dumpfreq_n": 2, "run.diagfreq": 2,
            "run.print_points": True, **more}
    return (JConfig if pkg == "jax" else TConfig)().with_values(**over)


def _state_close(tst, jst, rtol=1e-10):
    for k in STATE_FIELDS:
        a, b = getattr(jst, k), getattr(tst, k)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), k
            for kk in a:
                _close(b[kk], a[kk], f"{k}.{kk}", rtol)
        else:
            _close(b, a, k, rtol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers, 2 steps each (history at step 2, a restart at step
    2, diagnostics at step 2), then the JAX run's step 3."""
    base = tmp_path_factory.mktemp("shell")
    out = {"dirs": {p: base / p for p in ("jax", "torch")}, "diags": {},
           "logs": {"jax": [], "torch": []}}
    jrun = JRun(_box(out["dirs"]["jax"], "jax"), dtype=jnp.float64,
                log=out["logs"]["jax"].append)
    jrun.initialize()
    jrun.run(2, on_diag=lambda n, d: out["diags"].setdefault("jax", d))
    trun = TRun(_box(out["dirs"]["torch"], "torch"), dtype=F64,
                log=out["logs"]["torch"].append, device=CPU)
    trun.initialize()
    trun.run(2, on_diag=lambda n, d: out["diags"].setdefault("torch", d))
    out["jstate2"], out["tstate2"] = jrun.state, trun.state
    jrun.run(1)
    out["jrun"], out["trun"] = jrun, trun
    return out


def test_calendar_matches_jax_over_a_year():
    codes = [("1", 1), ("1", 5), ("h", 1), ("h", 6), ("d", 1), ("d", 2),
             ("m", 1), ("y", 1), ("x", 1)]
    for kw in ({}, {"year_init": 2000, "use_leap_years": True}):
        j, t = jcal.Calendar(dt=3600.0, **kw), tcal.Calendar(dt=3600.0, **kw)
        for _ in range(366 * 24 + 5):
            j.advance()
            t.advance()
            assert (t.istep, t.yday, t.sec, t.month, t.mday, t.idate,
                    t.new_day, t.new_month, t.new_year) == \
                (j.istep, j.yday, j.sec, j.month, j.mday, j.idate,
                 j.new_day, j.new_month, j.new_year)
            assert [t.write_flag(*c) for c in codes] == \
                [j.write_flag(*c) for c in codes]
    assert tcal.is_leap(2000) and not tcal.is_leap(1900)


def test_driver_diagnostics_match_jax(runs):
    jd, td = runs["diags"]["jax"], runs["diags"]["torch"]
    assert jd.keys() == td.keys() and "herr_n" in jd
    for k in jd:
        # the budget errors are differences of near-equal totals: they
        # take the scale of the terms they close
        ref = {"werr": "wflux", "herr": "hnet", "serr": "fsalt"}.get(
            k[:4].rstrip("_"))
        scale = abs(jd[ref + k[-2:]]) if ref else None
        _close(np.float64(td[k]), np.float64(jd[k]), k, scale_of=scale)
    line = [m for m in runs["logs"]["torch"] if m.startswith("istep = 2")]
    assert line and "heat error" in line[0]
    assert any(m.startswith("point 1:") for m in runs["logs"]["torch"])


def test_point_and_runtime_diags_match_jax(runs):
    """runtime_diags and point_diags of both packages on the state and
    fluxes of one step from the same state."""
    jrun, trun = runs["jrun"], runs["trun"]
    jstate = runs["jstate2"]
    tstate = runs["tstate2"]
    yday, sec = 1.0 + 7200.0 / 86400.0, 7200.0
    jf = jrun.forcing_provider(yday, sec)
    tf = trun.forcing_provider(yday, sec)
    js, jfl = jrun._step(jstate, jf, jnp.asarray(yday), jnp.asarray(sec))
    ts, tfl = trun.model(tstate, tf, yday, sec)
    ji = jdiag.init_mass_diags(jstate, jrun.grid)
    ti = tdiag.init_mass_diags(tstate, trun.grid)
    jd = jdiag.runtime_diags(js, jrun.grid, fluxes=jfl, forcing=jf,
                             init_diag=ji, dt=3600.0)
    td = tdiag.runtime_diags(ts, trun.grid, fluxes=tfl, forcing=tf,
                             init_diag=ti, dt=3600.0)
    assert jd.keys() == td.keys()
    for k in jd:
        if k[:4] in ("werr", "herr", "serr"):
            continue        # closure errors: see test_driver_diagnostics
        _close(td[k], jd[k], k)
    points = tdiag.find_points(trun.grid, [(70.5, -150.0), (69.2, 40.0)])
    assert points == jdiag.find_points(jrun.grid, [(70.5, -150.0),
                                                    (69.2, 40.0)])
    jp = jdiag.point_diags(js, jrun.grid, jfl, jf, 3600.0, points)
    tp = tdiag.point_diags(ts, trun.grid, tfl, tf, 3600.0, points)
    for a, b in zip(jp, tp):
        assert a.keys() == b.keys()
        for k in a:
            _close(np.float64(b[k]), np.float64(a[k]), k,
                   scale_of=abs(a.get(_SCALE_OF.get(k, k), a[k])))
    assert tdiag.format_points(tp).startswith("point 1: lat=")


def _restart(runs, pkg):
    d = runs["dirs"][pkg] / "restart"
    (path,) = sorted(d.glob("iced.*.npz"))
    return path


def test_restarts_match_jax(runs):
    jp, tp = _restart(runs, "jax"), _restart(runs, "torch")
    assert jp.name == tp.name == "iced.19970101.07200.npz"
    with np.load(jp) as jz, np.load(tp) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        assert str(jz["__header__"]) == str(tz["__header__"])
        for k in jz.files:
            if k != "__header__":
                assert jz[k].dtype == tz[k].dtype, k
                _close(tz[k], jz[k], k)


def test_jax_restart_resumed_by_the_port(runs, tmp_path):
    """The port continues from the JAX package's restart: its next step
    is the JAX run's step 3."""
    cfg = _box(tmp_path, "torch", **{
        "run.runtype": "continue",
        "run.pointer_file": str(runs["dirs"]["jax"] / "restart" /
                                "ice.restart_file")})
    run = TRun(cfg, dtype=F64, log=lambda m: None, device=CPU).initialize()
    assert run.calendar.istep == 2
    run.run(1)
    _state_close(run.state, runs["jrun"].state)


def test_port_restart_loaded_by_jax(runs):
    """The JAX package reads the port's restart, and its step from it is
    its own step 3."""
    jrun = runs["jrun"]
    loaded, header = jrestart.load_restart(str(_restart(runs, "torch")),
                                           jrun.state)
    assert header["istep"] == 2 and header["tracers"] == ["iage"]
    yday, sec = 1.0 + 7200.0 / 86400.0, 7200.0
    js, _ = jrun._step(loaded, jrun.forcing_provider(yday, sec),
                       jnp.asarray(yday), jnp.asarray(sec))
    for k in ("aicen", "vicen", "uvel", "vvel", "stressp", "eicen"):
        _close(np.asarray(getattr(js, k)),
               np.asarray(getattr(jrun.state, k)), k)


def _nc(path):
    with netcdf_file(str(path), "r", mmap=False) as f:
        return ({k: v for k, v in f.dimensions.items()},
                {k: (v.dimensions, dict(v._attributes), np.array(v[:]))
                 for k, v in f.variables.items()})


def test_history_files_match_jax(runs):
    (jp,) = sorted((runs["dirs"]["jax"] / "history").glob("*.nc"))
    (tp,) = sorted((runs["dirs"]["torch"] / "history").glob("*.nc"))
    assert jp.name == tp.name
    jdims, jvars = _nc(jp)
    tdims, tvars = _nc(tp)
    assert jdims == tdims
    assert jvars.keys() == tvars.keys() and len(jvars) > 90
    for k, (dims, attrs, want) in jvars.items():
        tdims_k, tattrs, got = tvars[k]
        assert dims == tdims_k and attrs.keys() == tattrs.keys(), k
        for a in attrs:
            np.testing.assert_array_equal(tattrs[a], attrs[a], err_msg=k)
        assert got.dtype == want.dtype, k
        if want.dtype.kind == "f":
            ref = np.asarray(jvars[_SCALE_OF[k]][2] if k in _SCALE_OF
                             else want, np.float64)
            ok = np.abs(ref) < 1e29
            scale = float(np.abs(ref[ok]).max()) if ok.any() else 0.0
            bound = 2 * np.spacing(np.abs(want).astype(np.float32)) \
                + 1e-10 * scale
            assert (np.abs(got.astype(np.float64) - want) <= bound).all(), k


def test_history_means_match_jax(runs, tmp_path):
    """The accumulated means before the float32 cast, and the binary
    stream, of one step from the same state."""
    jrun, trun = runs["jrun"], runs["trun"]
    yday, sec = 1.0 + 7200.0 / 86400.0, 7200.0
    jf = jrun.forcing_provider(yday, sec)
    tf = trun.forcing_provider(yday, sec)
    js, jfl = jrun._step(runs["jstate2"], jf, jnp.asarray(yday),
                         jnp.asarray(sec))
    ts, tfl = trun.model(runs["tstate2"], tf, yday, sec)
    jh = jhist.History(jrun.grid, histfreq=("1",), itd=jrun.model.itd,
                       directory=str(tmp_path / "j"), fmt="bin")
    th = thist.History(trun.grid, histfreq=("1",), itd=trun.model.itd,
                       directory=str(tmp_path / "t"), fmt="bin")
    jh.accumulate(js, jfl, forcing=jf, yday=yday, dt=3600.0)
    th.accumulate(ts, tfl, forcing=tf, yday=yday, dt=3600.0)
    jsums, tsums = jh.streams[0].sums, th.streams[0].sums
    assert jsums.keys() == tsums.keys()
    for k in jsums:
        ref = jsums.get(_SCALE_OF.get(k))
        _close(tsums[k], jsums[k], k, scale_of=ref)
    cal = tcal.Calendar(dt=3600.0)
    (jpath,), (tpath,) = jh.write_due(cal), th.write_due(cal)
    jb = np.fromfile(jpath, ">f8")
    tb = np.fromfile(tpath, ">f8")
    assert jb.shape == tb.shape
    assert Path(jpath).with_suffix(".hdr").read_text() == \
        Path(tpath).with_suffix(".hdr").read_text()


def test_dump_and_resume_is_bit_exact(tmp_path):
    """4 steps straight against 2 steps, a restart, and 2 more steps in a
    new run that continues from it."""
    cont = TRun(_box(tmp_path / "a", "torch"), dtype=F64,
                log=lambda m: None, device=CPU).initialize()
    cont.run(4)
    first = TRun(_box(tmp_path / "b", "torch"), dtype=F64,
                 log=lambda m: None, device=CPU).initialize()
    first.run(2)
    cfg = _box(tmp_path / "b", "torch", **{"run.runtype": "continue"})
    second = TRun(cfg, dtype=F64, log=lambda m: None, device=CPU)
    second.initialize()
    second.run(2)
    for k in STATE_FIELDS:
        a, b = getattr(cont.state, k), getattr(second.state, k)
        for kk in (a if isinstance(a, dict) else [None]):
            x = a if kk is None else a[kk]
            y = b if kk is None else b[kk]
            assert x.dtype == y.dtype and torch.equal(x, y), (k, kk)
    assert second.calendar.istep == cont.calendar.istep == 4


def _cli(args, tmp):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-m", "cice4_tpu_torch", "run",
                           *args], capture_output=True, text=True,
                          timeout=300, cwd=tmp, env=env)


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    sets = [f"--set={k}={v!r}" for k, v in BOX.items()]
    res = _cli(["--device", "cpu", "--steps", "2", "--f64",
                "--set=run.diagfreq=2", *sets], tmp_path)
    assert res.returncode == 0, res.stderr
    assert "istep = 2" in res.stdout and "Timing information" in res.stdout


def test_cli_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = _cli(["--steps", "1"], tmp_path)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and res.stdout == ""


def test_forcing_provider_falls_back_or_raises(tmp_path):
    from cice4_tpu_torch import kernel_check
    from cice4_tpu_torch.grid import make_grid

    cfg = TConfig().with_values(**BOX)
    grid = make_grid(cfg, device=CPU, dtype=F64)
    analytic = tforcing.AnalyticForcing(cfg, grid, device=CPU,
                                        dtype=F64)(80.0, 0.0)
    # no data directory, one that does not exist, or one without the
    # dataset's files: the dataset's reader, unavailable, gives the
    # analytic forcing (the JAX package's fallback)
    for kind in ("ncar", "LYq", "monthly", "ecmwf", "hadgem", "rct"):
        for d in ("", str(tmp_path / "absent"), str(tmp_path)):
            c = cfg.with_values(**{"forcing.atm_data_type": kind,
                                   "forcing.atm_data_dir": d})
            prov = tforcing.make_forcing_provider(c, grid, device=CPU,
                                                  dtype=F64)
            assert type(prov) is tforcing._ATM_DATASETS[kind], (kind, d)
            assert not prov.available
            f = prov(80.0, 0.0)
            assert torch.equal(f.Tair, analytic.Tair), (kind, d)
    # the analytic forcing ignores a data directory
    c = cfg.with_values(**{"forcing.atm_data_dir": str(tmp_path)})
    assert isinstance(tforcing.make_forcing_provider(c, grid, device=CPU,
                                                     dtype=F64),
                      tforcing.AnalyticForcing)
    # an ocean climatology's directory without its files: no climatology
    c = cfg.with_values(**{"forcing.sss_data_type": "clim",
                           "forcing.ocn_data_dir": str(tmp_path)})
    assert isinstance(tforcing.make_forcing_provider(c, grid, device=CPU,
                                                     dtype=F64),
                      tforcing.AnalyticForcing)
    # a dataset whose record is cut short raises
    kernel_check.write_forcing_files(tmp_path / "ncar", "ncar", 24, 32,
                                     records_6h=1)
    c = cfg.with_values(**{"forcing.atm_data_type": "ncar",
                           "forcing.atm_data_dir": str(tmp_path / "ncar")})
    prov = tforcing.make_forcing_provider(c, grid, device=CPU, dtype=F64)
    assert prov.available
    with pytest.raises(EOFError, match="truncated"):
        prov(2.0, 0.0)


def test_restoring_and_corners_match_jax(runs):
    jrun, trun = runs["jrun"], runs["trun"]
    jg = dataclasses.replace(jrun.grid, bc=dataclasses.replace(
        jrun.grid.bc, ns="open"))
    tg = dataclasses.replace(trun.grid, bc=dataclasses.replace(
        trun.grid.bc, ns="open"))
    jband = jrestoring.boundary_band_mask(jg)
    tband = trestoring.boundary_band_mask(tg)
    _close(tband, jband, "band")
    assert float(tband.sum()) == 2 * 32
    for trest in (0.0, 2.0):
        jr = jrestoring.restore_ice(runs["jrun"].state, runs["jstate2"],
                                    jband, 3600.0, trest)
        arrays = {k: (np.asarray(v) if not isinstance(v, dict) else
                      {kk: np.asarray(vv) for kk, vv in v.items()})
                  for k, v in vars(runs["jrun"].state).items()}
        tnow = convert.state_from_arrays(arrays, device=CPU, dtype=F64)
        tr = trestoring.restore_ice(tnow, runs["tstate2"], tband, 3600.0,
                                    trest)
        for k in ("aicen", "vicen", "eicen", "tsfcn"):
            _close(getattr(tr, k), getattr(jr, k), k)
    jc, tc = j_corners(jrun.grid), t_corners(trun.grid)
    assert jc.keys() == tc.keys()
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
