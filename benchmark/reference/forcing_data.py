"""Forcing engine: dataset readers, time interpolation, derived fields.

Port of :mod:`cice4_tpu.io.forcing_data` (``source/ice_forcing.F90``):

* bracketing record reads with year cycling and the reference's
  beginning/end-of-cycle rules (``read_data:869-1021``: persistence for
  sub-monthly data, periodicity for monthly data) and linear time
  interpolation (``interp_coeff:1362-1423``,
  ``interp_coeff_monthly:1302-1352``), on the host in NumPy float64, as
  the JAX package does them; the interpolated fields are cast to the
  run's dtype only then and copied to its device;
* the atmosphere dataset `ncar` (and `bin`), falling back to
  :class:`AnalyticForcing` when its files are absent, as the reference's
  model does, and the analytic forcing itself: the datasets the
  benchmark's cells read (a cell with another brings its reader);
* the derived-field pipeline ``prepare_forcing:1530-1809`` as plain
  functions on tensors on the run's device: clamps, bias corrections,
  Parkinson & Washington longwave, precipitation units, the rain/snow
  split at 0 C, the 4-band shortwave split and the rotation of
  geographic winds onto the grid axes by ANGLET;
* the ocean climatology with SST restoring (``init_forcing_ocn:228-446``,
  ``ocn_data_clim:3564-...``), and :func:`make_forcing_provider`, the
  driver's factory.

The files are the reference's 'rda8' (direct-access big-endian real*8
records of the whole grid, ``ice_read_write.F90:357-451``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from reference import constants as cn
from reference.calendar import Calendar, daycal_365
from reference.config import Config
from reference.forcing import Forcing
from reference.grid import Grid

daymo_365 = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]

# fixed shortwave band fractions (ice_forcing.F90 prepare_forcing)
frcvdr, frcvdf, frcidr, frcidf = 0.28, 0.24, 0.31, 0.17


# ---------------------------------------------------------------------------
# time interpolation machinery
# ---------------------------------------------------------------------------


def interp_coeff(recnum, recslot, secint, dataloc, ftime, dayyr=365.0):
    """Linear interpolation weights for evenly spaced records
    (``interp_coeff:1362-1423``).  `ftime` = forcing-clock seconds."""
    secyr = dayyr * 86400.0
    tt = ftime % secyr
    if recslot == 2:
        t2 = (recnum - 0.5) * secint if dataloc == 1 else recnum * secint
        t1 = t2 - secint
    else:
        t1 = (recnum - 0.5) * secint if dataloc == 1 else recnum * secint
        t2 = t1 + secint
    c1 = abs((t2 - tt) / (t2 - t1))
    return c1, 1.0 - c1


def interp_coeff_monthly(recslot, month, ftime, dayyr=365.0):
    """Weights for mid-month-centered monthly data
    (``interp_coeff_monthly:1302-1352``)."""
    daymid = [14.0] * 14          # time frame ends 0 sec into day 15
    daymid0 = 14.0 - daymo_365[11]  # Dec 15 relative to Jan 1
    tt = (ftime / 86400.0) % dayyr
    if recslot == 2:              # first half of month
        t2 = daycal_365[month - 1] + daymid[month]
        t1 = daymid0 if month == 1 else (daycal_365[month - 2]
                                         + daymid[month - 1])
    else:                         # second half of month
        t1 = daycal_365[month - 1] + daymid[month]
        t2 = daycal_365[month] + daymid[month + 1] if month < 12 \
            else dayyr + daymid0 + daymo_365[11]
    c1 = (t2 - tt) / (t2 - t1)
    return c1, 1.0 - c1


def monthly_bracket(cal: Calendar):
    """Bracketing months around `now` (mid-month convention, ``ncar_data``
    monthly section): 1-based months m1, m2 and their weights."""
    midmonth = 15
    month, mday = cal.month, cal.mday
    if mday >= midmonth:
        recslot = 1
        m1, m2 = month, month % 12 + 1
    else:
        recslot = 2
        m1, m2 = (month + 10) % 12 + 1, month
    c1, c2 = interp_coeff_monthly(recslot, month, cal.time,
                                  float(cal.days_per_year))
    return m1, m2, c1, c2


def sixhourly_bracket(cal: Calendar):
    """Record numbers + weights for 6-hourly data located at interval
    end (NCEP convention, ``ncar_data`` 6-hourly section)."""
    sec6hr = 86400.0 / 4.0
    maxrec = 1460
    recnum = 4 * int(cal.yday) - 3 + int(cal.sec / sec6hr)
    ixm = (recnum + maxrec - 2) % maxrec + 1
    ixx = (recnum - 1) % maxrec + 1
    c1, c2 = interp_coeff(recnum, 2, sec6hr, 2, cal.time,
                          float(cal.days_per_year))
    return ixm, ixx, c1, c2, maxrec


# ---------------------------------------------------------------------------
# rda8 record files + year cycling (host, NumPy float64)
# ---------------------------------------------------------------------------


class RecordReader:
    """Cached reader of direct-access big-endian real*8 records."""

    def __init__(self, ny, nx, cache_records=128):
        self.ny, self.nx = ny, nx
        self._cache: dict = {}
        self._max = cache_records

    def read(self, path, rec1):
        """Read 1-based record `rec1` as (ny, nx) float64."""
        key = (path, rec1)
        if key not in self._cache:
            n = self.nx * self.ny
            with open(path, "rb") as f:
                f.seek((rec1 - 1) * n * 8)
                arr = np.fromfile(f, dtype=">f8", count=n)
            if arr.size != n:
                raise EOFError(f"{path}: record {rec1} truncated")
            self._cache[key] = arr.reshape(self.ny, self.nx)
            while len(self._cache) > self._max:
                self._cache.pop(next(iter(self._cache)))
        return self._cache[key]


def forcing_year(cal: Calendar, fyear_init: int, ycycle: int) -> int:
    """Cycled forcing year (``init_forcing_atmo:174-219``):
    fyear = fyear_init + mod(year - year_init, ycycle)."""
    return fyear_init + (cal.year - cal.year_init) % max(ycycle, 1)


class _FileDataset:
    """Shared record-bracketing logic over yearly rda8 files.

    `paths[name]` is either a static path (climatology) or a callable
    `year -> path` (yearly files, the reference's `file_year`).
    """

    def __init__(self, cfg: Config, grid: Grid):
        fc = cfg.forcing
        self.cfg = cfg
        self.reader = RecordReader(grid.ny, grid.nx)
        self.fyear_init = fc.fyear_init
        self.ycycle = max(fc.ycycle, 1)
        self.fyear_final = fc.fyear_init + self.ycycle - 1

    def _path(self, p, year):
        return p(year) if callable(p) else p

    def read_6hourly(self, pathfn, cal: Calendar):
        """Two bracketing 6-hourly records + weights, with the
        reference's persistence rule at cycle boundaries."""
        fyear = forcing_year(cal, self.fyear_init, self.ycycle)
        ixm, ixx, c1, c2, maxrec = sixhourly_bracket(cal)
        if ixx <= 1:  # first record of the year: look back
            if fyear > self.fyear_init:
                pm, rm = self._path(pathfn, fyear - 1), ixm
            else:  # persistence: duplicate the first record
                pm, rm = self._path(pathfn, fyear), ixx
        else:
            pm, rm = self._path(pathfn, fyear), ixm
        a = self.reader.read(pm, rm)
        b = self.reader.read(self._path(pathfn, fyear), ixx)
        return c1 * a + c2 * b

    def read_monthly(self, pathfn, cal: Calendar, climatology=False):
        """Two bracketing mid-month records + weights; monthly data wraps
        periodically across the forcing cycle."""
        fyear = forcing_year(cal, self.fyear_init, self.ycycle)
        m1, m2, c1, c2 = monthly_bracket(cal)
        y1 = y2 = fyear  # a climatology is a single file, its path static
        if not climatology:
            if m1 > m2 and cal.month == 1:      # m1 = December record
                y1 = fyear - 1 if fyear > self.fyear_init \
                    else self.fyear_final
            if m1 > m2 and cal.month == 12:     # m2 = January record
                y2 = fyear + 1 if fyear < self.fyear_final \
                    else self.fyear_init
        a = self.reader.read(self._path(pathfn, y1), m1)
        b = self.reader.read(self._path(pathfn, y2), m2)
        return c1 * a + c2 * b


def _to_device(arr, device, dtype):
    """A host float64 array as a tensor of `dtype` on `device`, cast on
    the host."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype).to(device)


# ---------------------------------------------------------------------------
# derived-field pipeline (prepare_forcing:1530-1809)
# ---------------------------------------------------------------------------


def _precip_factor(precip_units: str) -> float:
    if precip_units == "mm_per_month":
        return 12.0 / (86400.0 * 365.0)
    if precip_units == "mm_per_day":
        return 1.0 / 86400.0
    if precip_units in ("mm_per_sec", "mks"):
        return 1.0
    raise ValueError(f"unknown precip_units {precip_units!r}")


def _flw_parkinson_washington(Tair, cldf):
    """Downward longwave, Parkinson & Washington (1979)
    (``prepare_forcing:1628-1641``)."""
    return (cn.stefan_boltzmann * Tair**4
            * (1.0 - 0.261 * torch.exp(-7.77e-4 * (cn.Tffresh - Tair)**2))
            * (1.0 + 0.275 * cldf))


def rotate_to_grid(uatm, vatm, anglet):
    """Rotate geographic E/N vectors onto grid x/y using ANGLET on the T
    grid (``prepare_forcing:1770-1788``)."""
    ca, sa = torch.cos(anglet), torch.sin(anglet)
    return uatm * ca + vatm * sa, vatm * ca - uatm * sa


def split_shortwave(fsw):
    """Fixed 4-band partition of total downward SW (prepare_forcing)."""
    return fsw * frcvdr, fsw * frcvdf, fsw * frcidr, fsw * frcidf


# ---------------------------------------------------------------------------
# analytic idealized forcing
# ---------------------------------------------------------------------------


class AnalyticForcing:
    """Latitude/season idealized atmosphere + climatological ocean.

    Smooth, bounded fields that produce a realistic seasonal ice cycle:
    air temperature with latitude gradient + seasonal cycle, westerly/
    polar-easterly winds, humidity at fixed relative humidity, SW from
    zenith angle climatology, LW from air temperature.  The fields
    depend on `yday` only.
    """

    def __init__(self, cfg: Config, grid: Grid, *, device,
                 dtype=torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.lat = grid.tlat.to(device=device, dtype=dtype)
        self.lon = grid.tlon.to(device=device, dtype=dtype)
        self.ulat = grid.ulat.to(device=device, dtype=dtype)

    def ocean_update(self, state, cal, dt):
        return state

    def __call__(self, yday: float, sec: float = 0.0, cal=None,
                 state=None) -> Forcing:
        lat = self.lat
        dtype = self.dtype
        # season phase: NH summer solstice ~ day 172
        phase = 2.0 * math.pi * (yday - 172.0) / 365.0
        seasonal = math.cos(phase)  # +1 at NH midsummer
        hemi = torch.sign(torch.sin(lat))

        # surface air temperature: warm equator, cold poles, +- seasonal
        Tair = (cn.Tffresh + 28.0 * torch.cos(lat) ** 2
                - 22.0 * torch.abs(torch.sin(lat)) ** 3
                + 12.0 * seasonal * hemi * torch.sin(lat) ** 2)
        # winds: polar easterlies (~7 m/s with slight rotation)
        uatm = -4.0 * torch.sin(lat) * torch.sign(torch.sin(lat))
        vatm = 2.0 * torch.sin(2.0 * lat) * seasonal
        wind = torch.sqrt(uatm**2 + vatm**2) + 1.0
        # humidity: 85% RH over saturation at Tair
        qsat = (cn.qqqice * torch.exp(-cn.TTTice / Tair)) / 1.3
        Qa = 0.85 * qsat
        # longwave: bulk emissivity formula
        flw = 0.7855 * 1.15 * cn.stefan_boltzmann * Tair**4
        # shortwave from daily-mean zenith angle
        decl = 0.409 * math.cos(2.0 * math.pi * (yday - 172.0) / 365.0) * -1.0
        cosz_noon = torch.clamp(
            torch.sin(lat) * math.sin(decl) + torch.cos(lat) * math.cos(decl),
            min=0.0)
        fsw = 900.0 * cosz_noon**1.4 * 0.45
        swvdr, swvdf, swidr, swidf = split_shortwave(fsw)
        # precipitation: snow when cold
        precip = 2.0e-5 * (0.8 + 0.5 * torch.cos(lat))  # kg/m^2/s
        snow = Tair < cn.Tffresh
        fsnow = torch.where(snow, precip, 0.0)
        frain = torch.where(snow, 0.0, precip)

        z = torch.zeros_like(lat)
        return Forcing(
            zlvl=z + 10.0, uatm=uatm.to(dtype), vatm=vatm.to(dtype),
            wind=wind.to(dtype), potT=Tair.to(dtype),
            Tair=Tair.to(dtype), Qa=Qa.to(dtype), rhoa=z + 1.3,
            flw=flw.to(dtype), swvdr=swvdr.to(dtype),
            swvdf=swvdf.to(dtype), swidr=swidr.to(dtype),
            swidf=swidf.to(dtype), frain=frain.to(dtype),
            fsnow=fsnow.to(dtype),
            sss=z + 34.0, uocn=z, vocn=z, ss_tltx=z, ss_tlty=z,
            qdp=z, hmix=z + 20.0,
        )


# ---------------------------------------------------------------------------
# file-based atmosphere datasets
# ---------------------------------------------------------------------------


class _AtmFileForcing(_FileDataset):
    """Shared machinery for the file-based atmosphere datasets."""

    #: name -> (cadence, path template); template gets .format(year=)
    LAYOUT: dict = {}

    def __init__(self, cfg: Config, grid: Grid, *, device,
                 dtype=torch.float32):
        super().__init__(cfg, grid)
        self.grid = grid
        self.device = torch.device(device)
        self.dtype = dtype
        self.dir = cfg.forcing.atm_data_dir
        self.analytic = AnalyticForcing(cfg, grid, device=device,
                                        dtype=dtype)
        self.available = self._probe()

    def _pathfn(self, name):
        """The reference layout's path of a year's file, else the flat
        layout's ``{name}.{year}.dat``."""
        tmpl = self.LAYOUT[name][1]
        ref = os.path.join(self.dir, tmpl)
        flat = os.path.join(self.dir, f"{name}.{{year}}.dat")

        def fn(year):
            p = ref.format(year=year)
            if os.path.exists(p):
                return p
            return flat.format(year=year)
        return fn

    def _probe(self):
        if not self.dir or not os.path.isdir(self.dir):
            return False
        for name in self.LAYOUT:
            if not os.path.exists(self._pathfn(name)(self.fyear_init)):
                return False
        return True

    def _read_all(self, cal: Calendar) -> dict:
        out = {}
        for name, (cadence, _t) in self.LAYOUT.items():
            fn = self._pathfn(name)
            if cadence == "6h":
                out[name] = self.read_6hourly(fn, cal)
            elif cadence == "mon":
                out[name] = self.read_monthly(fn, cal)
            else:  # climatology: single 12-record file
                out[name] = self.read_monthly(fn, cal, climatology=True)
        return out

    def ocean_update(self, state, cal, dt):
        return state

    def __call__(self, yday, sec, cal=None, state=None) -> Forcing:
        if not self.available:
            return self.analytic(yday, sec, cal=cal, state=state)
        if cal is None:
            cal = Calendar(dt=self.cfg.run.dt,
                           year_init=self.cfg.run.year_init)
            cal.time = (float(yday) - 1.0) * 86400.0 + float(sec)
            cal._recompute()
        raw = {k: _to_device(v, self.device, self.dtype)
               for k, v in self._read_all(cal).items()}
        base = self.analytic(yday, sec)   # ocean fields baseline
        if state is not None:
            sst = state.sst
            aice = state.aicen.sum(0)
            Tsfc = torch.where(aice > cn.puny,
                               (state.aicen * state.tsfcn).sum(0)
                               / torch.clamp(aice, min=cn.puny), 0.0)
        else:
            z = torch.zeros((self.grid.ny, self.grid.nx), dtype=self.dtype,
                            device=self.device)
            Tsfc, sst, aice = z, z - 1.8, z
        # each dataset's `_prepare`: the raw records -> Forcing (the JAX
        # package's jitted `_prepare_impl`)
        return self._prepare(raw, base, float(yday), float(sec), Tsfc, sst,
                             aice)


def _finish_forcing(self, base, Tair, Qa, rhoa, uatm, vatm, fsw, flw,
                    precip, precip_units):
    """Common tail of prepare_forcing: clamps, precip conversion,
    rain/snow split, SW bands, wind rotation, potT/zlvl."""
    g = self.grid
    fsw = torch.clamp(fsw, min=0.0)
    Qa = torch.clamp(Qa, min=0.0)
    rhoa = torch.clamp(rhoa, min=0.0)
    precip = torch.clamp(precip, min=0.0) * _precip_factor(precip_units)
    # rain/snow partition at freezing (":1747-1760")
    snow = Tair < cn.Tffresh
    fsnow = torch.where(snow, precip, 0.0)
    frain = torch.where(snow, 0.0, precip)
    # rotate geographic winds onto grid axes (":1770-1788")
    uatm, vatm = rotate_to_grid(uatm, vatm, g.anglet)
    wind = torch.sqrt(uatm**2 + vatm**2)
    swvdr, swvdf, swidr, swidf = split_shortwave(fsw)
    z10 = torch.full_like(Tair, 10.0)
    return base.replace(
        zlvl=z10, uatm=uatm, vatm=vatm, wind=wind, potT=Tair, Tair=Tair,
        Qa=Qa, rhoa=rhoa, flw=flw, swvdr=swvdr, swvdf=swvdf,
        swidr=swidr, swidf=swidf, frain=frain, fsnow=fsnow)


class NcarBulkForcing(_AtmFileForcing):
    """NCAR bulk dataset: monthly fsw/cldf/prec + 6-hourly NCEP states
    (``ncar_files/ncar_data:1821-2056``); gx3's standard forcing."""

    LAYOUT = {
        "swdn": ("mon", "ISCCPM/MONTHLY/RADFLX/swdn.{year}.dat"),
        "cldf": ("mon", "ISCCPM/MONTHLY/RADFLX/cldf.{year}.dat"),
        "prec": ("mon", "MXA/MONTHLY/PRECIP/prec.{year}.dat"),
        "u_10": ("6h", "NCEP/4XDAILY/STATES/u_10.{year}.dat"),
        "v_10": ("6h", "NCEP/4XDAILY/STATES/v_10.{year}.dat"),
        "t_10": ("6h", "NCEP/4XDAILY/STATES/t_10.{year}.dat"),
        "q_10": ("6h", "NCEP/4XDAILY/STATES/q_10.{year}.dat"),
        "dn10": ("6h", "NCEP/4XDAILY/STATES/dn10.{year}.dat"),
    }

    def _prepare(self, raw, base, yday, sec, Tsfc, sst, aice):
        cldf = torch.clamp(raw["cldf"], 0.0, 1.0)
        Tair = raw["t_10"]
        # NCAR bias corrections (":1619-1626")
        Qa = raw["q_10"] * 0.94
        fsw = raw["swdn"] * 0.92
        flw = _flw_parkinson_washington(Tair, cldf)
        return _finish_forcing(self, base, Tair, Qa, raw["dn10"],
                               raw["u_10"], raw["v_10"], fsw, flw,
                               raw["prec"], self.cfg.forcing.precip_units)


class OceanClimForcing(_FileDataset):
    """Monthly SSS/SST climatology with optional SST restoring
    (``init_forcing_ocn:228-446``, ``ocn_data_clim:3564+``).

    `sss.mm.*.da` / `sst.mm.*.da`: 12 monthly rda8 records.  SSS is
    restored instantaneously (interpolated each step); prognostic SST
    (oceanmixed_ice) is nudged toward the interpolated climatology with
    timescale `trestore` days (`trestore = 0`: instantaneous).
    """

    def __init__(self, cfg: Config, grid: Grid, *, device,
                 dtype=torch.float32):
        super().__init__(cfg, grid)
        self.grid = grid
        self.device = torch.device(device)
        self.dtype = dtype
        fc = cfg.forcing
        d = fc.ocn_data_dir
        self.sss_path = self._find(d, "sss")
        self.sst_path = self._find(d, "sst")
        self.restore_sst = fc.restore_sst
        self.trest = (cfg.run.dt if fc.trestore == 0
                      else fc.trestore * 86400.0)
        self.linear_S = cfg.thermo.Tfrzpt == "linear_S"

    @staticmethod
    def _find(d, stem):
        if not d or not os.path.isdir(d):
            return None
        for name in sorted(os.listdir(d)):
            if name.startswith(stem + ".") or name.startswith(stem + "_"):
                return os.path.join(d, name)
        return None

    @property
    def available(self):
        return self.sss_path is not None

    def initial_fields(self, month: int):
        """Annual-mean SSS + current-month SST (init_forcing_ocn)."""
        sss = np.mean([self.reader.read(self.sss_path, k)
                       for k in range(1, 13)], axis=0)
        sss = np.maximum(sss, 0.0)
        Tf = -cn.depressT * sss if self.linear_S \
            else np.full_like(sss, cn.Tocnfrz)
        sst = None
        if self.sst_path:
            sst = np.maximum(self.reader.read(self.sst_path, month), Tf)
        dev, dt = self.device, self.dtype
        return (_to_device(sss, dev, dt), _to_device(Tf, dev, dt),
                None if sst is None else _to_device(sst, dev, dt))

    def interp_month(self, path, cal: Calendar):
        return self.read_monthly(path, cal, climatology=True)

    def sss_now(self, cal: Calendar):
        sss = np.maximum(self.interp_month(self.sss_path, cal), 0.0)
        return _to_device(sss, self.device, self.dtype)

    def ocean_update(self, state, cal: Calendar, dt):
        """Per-step get_forcing_ocn: restore prognostic SST toward the
        interpolated climatology (``ocn_data_clim`` restore section)."""
        if not (self.restore_sst and self.sst_path):
            return state
        sstdat = _to_device(self.interp_month(self.sst_path, cal),
                            self.device, self.dtype)
        sst = state.sst + (sstdat - state.sst) * (dt / self.trest)
        return state.replace(sst=sst)


# ---------------------------------------------------------------------------
# provider factory
# ---------------------------------------------------------------------------


_ATM_DATASETS = {
    "ncar": NcarBulkForcing,
    "bin": NcarBulkForcing,
}


def make_forcing_provider(cfg: Config, grid: Grid, *, device,
                          dtype=torch.float32):
    """The forcing provider of a run (``cice4_tpu/io/forcing_data.py:
    886-896``): the dataset of ``atm_data_type`` (which falls back to the
    analytic forcing while its files are absent) or the analytic forcing,
    joined with the ocean climatology when one is asked for and found."""
    kind = cfg.forcing.atm_data_type
    if kind not in _ATM_DATASETS and kind != "analytic":
        raise ValueError(f"the reference has no {kind!r} dataset")
    cls = _ATM_DATASETS.get(kind, AnalyticForcing)
    atm = cls(cfg, grid, device=device, dtype=dtype)
    if cfg.forcing.sss_data_type == "clim" \
            or cfg.forcing.sst_data_type == "clim":
        ocn = OceanClimForcing(cfg, grid, device=device, dtype=dtype)
        if ocn.available:
            return CombinedProvider(atm, ocn, cfg)
    return atm


class CombinedProvider:
    """Atmosphere dataset + ocean climatology, one provider object."""

    def __init__(self, atm, ocn: OceanClimForcing, cfg: Config):
        self.atm = atm
        self.ocn = ocn
        self.cfg = cfg
        self.available = getattr(atm, "available", True)

    def __call__(self, yday, sec, cal=None, state=None) -> Forcing:
        f = self.atm(yday, sec, cal=cal, state=state)
        if cal is not None and self.ocn.available:
            f = f.replace(sss=self.ocn.sss_now(cal))
        return f

    def ocean_update(self, state, cal, dt):
        return self.ocn.ocean_update(state, cal, dt)
