"""History output: field registry, time averaging, multi-stream netCDF.

Port of :mod:`cice4_tpu.io.history` (``source/ice_history.F90``): the
`ice_hist_field` registry + `define_hist_field:3561-3659`, per-step
accumulation (`accum_hist_field*:3663-3870`), up to `max_nstrm = 5`
simultaneous streams at different frequencies, and CF-metadata netCDF
output (`icecdf:2093-3231`, netCDF3-classic via scipy) or the binary
stream (`icebin:3244-3474`).  Variable names, dimensions and attributes
are the JAX package's.

Each registered field maps a name to an extractor over
``(state, fluxes, agg)``; the sums stay on the state's device until a
file is written.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.grid import Grid
from cice4_tpu_torch.ops.itd import aggregate
from cice4_tpu_torch.state import State

max_nstrm = 5


@dataclasses.dataclass
class HistField:
    name: str
    units: str
    long_name: str
    extract: Callable          # (state, fluxes, agg) -> array
    cell_measure: str = "area: tarea"
    frequency: str = "m"       # y/m/d/h/1/x per stream
    # field class (ice_history.F90:87-115): "2D" (ny, nx), "3Dc"
    # (ncat, ny, nx), "4Di" (nilyr, ncat, ny, nx), "4Ds" (nslyr, ...)
    dims: str = "2D"
    # False = snapshot field (hisnap/aisnap/mlt_onset...): the stream
    # keeps the latest value instead of a time mean
    avg: bool = True


def _flux(name, scale=1.0):
    return lambda s, fx, agg: fx[name] * scale if name in fx else None


def _trcr(name):
    """Cell-mean tracer from the aggregate (iage/alvl/vlvl/volpn)."""
    return lambda s, fx, agg: agg["trcr"].get(name)


def default_fields(itd=None) -> dict[str, HistField]:
    """The standard field set (cf. `init_hist:417-1367`): 2D fields
    plus per-category (3Dc) and vertical-profile (4Di/4Ds) classes.

    itd: optional ItdParams; provides the fixed salinity profile's
    melting temperatures for the Tinz enthalpy inversion (fresh-ice
    inversion when absent).
    """
    F = HistField
    mps_to_cmpdy = cn.mps_to_cmpdy
    tmlt = tuple(itd.tmlt) if itd is not None else None
    fields = [
        F("aice", "1", "ice area (aggregate)",
          lambda s, fx, agg: agg["aice"]),
        F("hi", "m", "grid cell mean ice thickness",
          lambda s, fx, agg: agg["vice"]),
        F("hs", "m", "grid cell mean snow thickness",
          lambda s, fx, agg: agg["vsno"]),
        F("Tsfc", "C", "snow/ice surface temperature",
          lambda s, fx, agg: agg["tsfc"]),
        F("uvel", "m/s", "ice velocity (x)",
          lambda s, fx, agg: s.uvel),
        F("vvel", "m/s", "ice velocity (y)",
          lambda s, fx, agg: s.vvel),
        F("sst", "C", "sea surface temperature",
          lambda s, fx, agg: s.sst),
        F("frzmlt", "W/m^2", "freeze/melt potential",
          lambda s, fx, agg: s.frzmlt),
        F("sig1", "1", "norm. principal stress 1", _flux("sig1")),
        F("strength", "N/m", "compressive ice strength", _flux("strength")),
        F("divu", "%/day", "strain rate (divergence)",
          _flux("divu", 100.0 * 86400.0)),
        F("shear", "%/day", "strain rate (shear)",
          _flux("shear", 100.0 * 86400.0)),
        F("fswabs", "W/m^2", "snow/ice/ocn absorbed solar flux",
          _flux("fswabs")),
        F("fswthru", "W/m^2", "SW thru ice to ocean", _flux("fswthru")),
        F("flwout", "W/m^2", "upward longwave flux", _flux("flwout")),
        F("fsens", "W/m^2", "sensible heat flux", _flux("fsens")),
        F("flat", "W/m^2", "latent heat flux", _flux("flat")),
        F("evap", "cm/day", "evaporative water flux",
          _flux("evap", mps_to_cmpdy / cn.rhofresh)),
        F("Tref", "K", "2m reference temperature", _flux("Tref")),
        F("Qref", "kg/kg", "2m reference humidity", _flux("Qref")),
        F("congel", "cm/day", "congelation ice growth",
          _flux("congel", mps_to_cmpdy / 3600.0)),
        F("frazil", "cm/day", "frazil ice growth",
          _flux("frazil", mps_to_cmpdy / 3600.0)),
        F("snoice", "cm/day", "snow-ice formation",
          _flux("snoice", mps_to_cmpdy / 3600.0)),
        F("meltt", "cm/day", "top ice melt",
          _flux("meltt", mps_to_cmpdy / 3600.0)),
        F("meltb", "cm/day", "basal ice melt",
          _flux("meltb", mps_to_cmpdy / 3600.0)),
        F("meltl", "cm/day", "lateral ice melt",
          _flux("meltl", mps_to_cmpdy / 3600.0)),
        F("melts", "cm/day", "snow melt",
          _flux("melts", mps_to_cmpdy / 3600.0)),
        F("fresh", "cm/day", "freshwater flux ice to ocean",
          _flux("fresh", mps_to_cmpdy / cn.rhofresh)),
        F("fsalt", "kg/m^2/day", "salt flux ice to ocean",
          _flux("fsalt", 86400.0)),
        F("fhocn", "W/m^2", "heat flux ice to ocean", _flux("fhocn")),
        F("strairx", "N/m^2", "atm/ice stress (x)", _flux("strairxT")),
        F("strairy", "N/m^2", "atm/ice stress (y)", _flux("strairyT")),
        F("strocnx", "N/m^2", "ocean/ice stress (x)",
          lambda s, fx, agg: s.strocnxT),
        F("strocny", "N/m^2", "ocean/ice stress (y)",
          lambda s, fx, agg: s.strocnyT),
        F("dardg1dt", "%/day", "ice area ridging rate",
          _flux("dardg1dt", 100.0 * 86400.0)),
        F("dardg2dt", "%/day", "ridge area formation rate",
          _flux("dardg2dt", 100.0 * 86400.0)),
        F("dvirdgdt", "cm/day", "ice volume ridging rate",
          _flux("dvirdgdt", mps_to_cmpdy)),
        F("opening", "%/day", "lead area opening rate",
          _flux("opening", 100.0 * 86400.0)),
        F("alvdr", "1", "visible direct albedo", _flux("alvdr")),
        F("alidr", "1", "near IR direct albedo", _flux("alidr")),
        F("alvdf", "1", "visible diffuse albedo", _flux("alvdf")),
        F("alidf", "1", "near IR diffuse albedo", _flux("alidf")),
        F("albice", "1", "bare ice albedo", _flux("albice")),
        F("albsno", "1", "snow albedo", _flux("albsno")),
        F("coszen", "radian", "cosine of solar zenith angle",
          _flux("coszen")),
        F("fsurf_ai", "W/m^2", "net surface heat flux", _flux("fsurf")),
        F("fcondtop_ai", "W/m^2", "top surface conductive flux",
          _flux("fcondtop")),
        F("fmeltt_ai", "W/m^2", "top melt heat flux",
          lambda s, fx, agg: (fx["fmelttn_ai"].sum(0)
                              if "fmelttn_ai" in fx else None)),
        F("icepresent", "1", "fraction of time-avg with ice",
          lambda s, fx, agg: (agg["aice"] > cn.puny).to(s.sst.dtype)),
        # --- forcing echoes (driver injects them into `fluxes`) ------------
        F("fswdn", "W/m^2", "down solar flux", _flux("fswdn")),
        F("flwdn", "W/m^2", "down longwave flux", _flux("flwdn")),
        F("snow", "cm/day", "snowfall rate",
          _flux("snow", cn.mps_to_cmpdy / cn.rhofresh)),
        F("snow_ai", "cm/day", "snowfall rate (x aice)",
          lambda s, fx, agg: (fx["snow"] * agg["aice"]
                              * cn.mps_to_cmpdy / cn.rhofresh
                              if "snow" in fx else None)),
        F("rain", "cm/day", "rainfall rate",
          _flux("rain", cn.mps_to_cmpdy / cn.rhofresh)),
        F("rain_ai", "cm/day", "rainfall rate (x aice)",
          lambda s, fx, agg: (fx["rain"] * agg["aice"]
                              * cn.mps_to_cmpdy / cn.rhofresh
                              if "rain" in fx else None)),
        F("sss", "ppt", "sea surface salinity", _flux("sss")),
        F("uocn", "m/s", "ocean current (x)", _flux("uocn")),
        F("vocn", "m/s", "ocean current (y)", _flux("vocn")),
        F("Tair", "K", "air temperature", _flux("Tair")),
        F("fswfac", "1", "shortwave scaling factor",
          lambda s, fx, agg: s.scale_factor),
        # --- "_ai" grid-box-mean variants (flux x ice area; the merged
        # fluxes are grid-box means until scale_fluxes divides by aice,
        # so the _gbm copies are exactly the reference's _ai fields) ---
        F("fswabs_ai", "W/m^2", "snow/ice/ocn absorbed solar flux (x aice)",
          _flux("fswabs_gbm")),
        F("flwup_ai", "W/m^2", "upward longwave flux (x aice)",
          _flux("flwout_gbm")),
        F("fsens_ai", "W/m^2", "sensible heat flux (x aice)",
          _flux("fsens_gbm")),
        F("flat_ai", "W/m^2", "latent heat flux (x aice)",
          _flux("flat_gbm")),
        F("evap_ai", "cm/day", "evaporative water flux (x aice)",
          _flux("evap_gbm", cn.mps_to_cmpdy / cn.rhofresh)),
        F("fresh_ai", "cm/day", "freshwater flux ice-ocean (x aice)",
          _flux("fresh_gbm", cn.mps_to_cmpdy / cn.rhofresh)),
        F("fsalt_ai", "kg/m^2/day", "salt flux ice-ocean (x aice)",
          _flux("fsalt_gbm", 86400.0)),
        F("fhocn_ai", "W/m^2", "heat flux ice-ocean (x aice)",
          _flux("fhocn_gbm")),
        F("fswthru_ai", "W/m^2", "SW thru ice to ocean (x aice)",
          _flux("fswthru_gbm")),
        # --- dynamics stress decomposition (U grid) ------------------------
        F("strtltx", "N/m^2", "sea-surface-tilt stress (x)",
          _flux("strtltx")),
        F("strtlty", "N/m^2", "sea-surface-tilt stress (y)",
          _flux("strtlty")),
        F("strcorx", "N/m^2", "Coriolis stress (x)", _flux("strcorx")),
        F("strcory", "N/m^2", "Coriolis stress (y)", _flux("strcory")),
        F("strintx", "N/m^2", "internal stress divergence (x)",
          _flux("strintx")),
        F("strinty", "N/m^2", "internal stress divergence (y)",
          _flux("strinty")),
        F("sig2", "1", "norm. principal stress 2", _flux("sig2")),
        F("trsig", "N/m^2", "internal stress tensor trace",
          _flux("trsig")),
        # --- tendencies ----------------------------------------------------
        F("daidtt", "%/day", "area tendency, thermo",
          _flux("daidtt", 100.0 * 86400.0)),
        F("daidtd", "%/day", "area tendency, dynamics",
          _flux("daidtd", 100.0 * 86400.0)),
        F("dvidtt", "cm/day", "volume tendency, thermo",
          _flux("dvidtt", cn.mps_to_cmpdy)),
        F("dvidtd", "cm/day", "volume tendency, dynamics",
          _flux("dvidtd", cn.mps_to_cmpdy)),
        # --- snapshots + onsets (not time-averaged) ------------------------
        F("hisnap", "m", "ice volume snapshot",
          lambda s, fx, agg: agg["vice"], avg=False),
        F("aisnap", "1", "ice area snapshot",
          lambda s, fx, agg: agg["aice"], avg=False),
        F("mlt_onset", "day of year", "melt onset date",
          _flux("mlt_onset"), avg=False),
        F("frz_onset", "day of year", "freeze onset date",
          _flux("frz_onset"), avg=False),
        # --- albedo composites ---------------------------------------------
        F("albsni", "%", "snow/ice broadband albedo",
          lambda s, fx, agg: (100.0 * (cn.awtvdr * fx["alvdr"]
                                       + cn.awtidr * fx["alidr"]
                                       + cn.awtvdf * fx["alvdf"]
                                       + cn.awtidf * fx["alidf"])
                              if "alvdr" in fx else None)),
        F("albpnd", "1", "melt pond albedo", _flux("albpnd")),
        # --- tracer means --------------------------------------------------
        F("iage", "years", "ice age",
          lambda s, fx, agg: (agg["trcr"]["iage"] / (86400.0 * 365.0)
                              if "iage" in agg["trcr"] else None)),
        F("alvl", "1", "level ice area fraction", _trcr("alvl")),
        F("vlvl", "m", "level ice volume", _trcr("vlvl")),
        F("volpn", "m", "melt pond volume", _trcr("volpn")),
        F("ardg", "1", "ridged ice area fraction",
          lambda s, fx, agg: (torch.clamp(
              agg["aice"] - (s.aicen * s.trcrn["alvl"]).sum(0), min=0.0)
              if "alvl" in s.trcrn else None)),
        F("vrdg", "m", "ridged ice volume",
          lambda s, fx, agg: (torch.clamp(
              agg["vice"] - (s.vicen * s.trcrn["vlvl"]).sum(0), min=0.0)
              if "vlvl" in s.trcrn else None)),
        # --- per-category (3Dc) fields (`init_hist` icefields_nml
        # f_aicen/f_vicen/f_fsurfn_ai/... toggles) --------------------------
        F("aicen", "1", "ice area, categories",
          lambda s, fx, agg: s.aicen, dims="3Dc"),
        F("vicen", "m", "ice volume, categories",
          lambda s, fx, agg: s.vicen, dims="3Dc"),
        F("vsnon", "m", "snow volume, categories",
          lambda s, fx, agg: s.vsnon, dims="3Dc"),
        F("Tsfcn", "C", "surface temperature, categories",
          lambda s, fx, agg: s.tsfcn, dims="3Dc"),
        F("fsurfn_ai", "W/m^2", "net surface heat flux, categories",
          _flux("fsurfn_ai"), dims="3Dc"),
        F("fcondtopn_ai", "W/m^2", "top conductive flux, categories",
          _flux("fcondtopn_ai"), dims="3Dc"),
        F("flatn_ai", "W/m^2", "latent heat flux, categories",
          _flux("flatn_ai"), dims="3Dc"),
        F("fmelttn_ai", "W/m^2", "top melt heat flux, categories",
          _flux("fmelttn_ai"), dims="3Dc"),
        F("apondn", "1", "melt pond fraction, categories",
          lambda s, fx, agg: (torch.clamp(torch.sqrt(torch.clamp(
              s.trcrn["volpn"], min=0.0) / 0.8), max=1.0)
              if "volpn" in s.trcrn else None), dims="3Dc"),
        # --- vertical profiles (4Di/4Ds): internal temperatures ------------
        F("Tinz", "C", "internal ice temperature, layers x categories",
          lambda s, fx, agg: _extract_tinz(s, tmlt), dims="4Di"),
        F("Tsnz", "C", "internal snow temperature, layers x categories",
          lambda s, fx, agg: _extract_tsnz(s), dims="4Ds"),
    ]
    return {f.name: f for f in fields}


def _extract_tinz(s, tmlt):
    """Layer ice temperature from enthalpy (cf. `ice_history` Tinz via
    `calculate_Tin_from_qin`); spval where no ice.  Shape
    (nilyr, ncat, ny, nx)."""
    from cice4_tpu_torch.ops.therm_vertical import tin_from_qin
    nilyr = s.eicen.shape[1]
    v = torch.clamp(s.vicen, min=cn.puny)[:, None]
    qin = s.eicen * nilyr / v                  # (ncat, nilyr, ny, nx)
    has = (s.vicen > cn.puny)[:, None]
    if tmlt is not None:
        tmlt_k = torch.as_tensor(np.asarray(tmlt[:nilyr]), dtype=qin.dtype,
                                 device=qin.device)[None, :, None, None]

        class _P:
            l_brine = True
        tin = tin_from_qin(_P, qin, tmlt_k)
    else:

        class _P:
            l_brine = False
        tin = tin_from_qin(_P, qin, 0.0)
    tin = torch.where(has, tin, cn.spval)
    return tin.transpose(0, 1)                 # (nilyr, ncat, ny, nx)


def _extract_tsnz(s):
    nslyr = s.esnon.shape[1]
    v = torch.clamp(s.vsnon, min=cn.puny)[:, None]
    qsn = s.esnon * nslyr / v
    tsn = (cn.Lfresh + qsn / cn.rhos) / cn.cp_ice
    has = (s.vsnon > cn.puny)[:, None]
    return torch.where(has, torch.clamp(tsn, max=0.0),
                       cn.spval).transpose(0, 1)


def _host(t) -> np.ndarray:
    """A tensor as a numpy array on the host."""
    return t.detach().cpu().numpy()


class HistoryStream:
    """One output stream: accumulates means, writes files."""

    def __init__(self, grid: Grid, fields: dict[str, HistField],
                 freq: str = "m", freq_n: int = 1, avg: bool = True,
                 directory: str = "./history", prefix: str = "iceh",
                 fmt: str = "nc"):
        self.grid = grid
        self.fields = fields
        self.freq = freq
        self.freq_n = freq_n
        self.avg = avg
        self.dir = directory
        self.prefix = prefix
        self.fmt = fmt          # "nc" (icecdf) or "bin" (icebin)
        self.sums: dict[str, torch.Tensor] = {}
        self.count = 0
        self._corners = None    # gridbox corner metadata, built once

    def accumulate(self, state: State, fluxes: dict, agg=None):
        if agg is None:
            agg = aggregate(state, self.grid.tmask)
        for name, f in self.fields.items():
            val = f.extract(state, fluxes, agg)
            if val is None:
                continue
            if not f.avg:
                self.sums[name] = val          # snapshot: keep latest
            elif name in self.sums:
                self.sums[name] = self.sums[name] + val
            else:
                self.sums[name] = val
        self.count += 1

    def write(self, idate: int, time_days: float) -> str | None:
        if self.count == 0:
            return None
        if self.fmt == "bin":
            return self._write_bin(idate, time_days)
        from scipy.io import netcdf_file

        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"{self.prefix}.{idate}.nc")
        g = self.grid
        # extra dimensions needed by registered 3Dc/4D fields
        ncat = nkice = nksnow = None
        for name, total in self.sums.items():
            d = self.fields[name].dims
            if d == "3Dc":
                ncat = total.shape[0]
            elif d == "4Di":
                nkice, ncat = total.shape[0], total.shape[1]
            elif d == "4Ds":
                nksnow, ncat = total.shape[0], total.shape[1]
        with netcdf_file(path, "w") as nc:
            nc.createDimension("time", 1)
            nc.createDimension("nj", g.ny)
            nc.createDimension("ni", g.nx)
            if ncat is not None:
                nc.createDimension("nc", ncat)
            if nkice is not None:
                nc.createDimension("nkice", nkice)
            if nksnow is not None:
                nc.createDimension("nksnow", nksnow)
            tvar = nc.createVariable("time", "d", ("time",))
            tvar[:] = [time_days]
            tvar.units = b"days since 0001-01-01 00:00:00"
            for nm, arr, units, lname in [
                ("TLON", np.rad2deg(_host(g.tlon)), "degrees_east",
                 "T grid center longitude"),
                ("TLAT", np.rad2deg(_host(g.tlat)), "degrees_north",
                 "T grid center latitude"),
                ("tarea", _host(g.tarea), "m^2", "T cell area"),
                ("tmask", _host(g.hm), "1", "ocean mask"),
            ]:
                v = nc.createVariable(nm, "f", ("nj", "ni"))
                v[:] = arr.astype(np.float32)
                v.units = units.encode()
                v.long_name = lname.encode()
            # gridbox-corner metadata (ice_grid.F90 gridbox_corners:
            # 1948-2122; CF "bounds" attributes for cell geometry)
            if self._corners is None:
                from cice4_tpu_torch.grid import gridbox_corners
                self._corners = gridbox_corners(g)
            nc.createDimension("nvertices", 4)
            for nm, units in (("lont_bounds", "degrees_east"),
                              ("latt_bounds", "degrees_north"),
                              ("lonu_bounds", "degrees_east"),
                              ("latu_bounds", "degrees_north")):
                v = nc.createVariable(nm, "f", ("nvertices", "nj", "ni"))
                v[:] = self._corners[nm].astype(np.float32)
                v.units = units.encode()
                v.long_name = (nm[:3] + " bounds, corners "
                               "SW SE NE NW").encode()
            count = self.count
            land = ~_host(g.tmask)
            dims_of = {"2D": ("time", "nj", "ni"),
                       "3Dc": ("time", "nc", "nj", "ni"),
                       "4Di": ("time", "nkice", "nc", "nj", "ni"),
                       "4Ds": ("time", "nksnow", "nc", "nj", "ni")}
            for name, total in self.sums.items():
                f = self.fields[name]
                norm = 1.0 / count if (self.avg and f.avg) else 1.0
                v = nc.createVariable(name, "f", dims_of[f.dims])
                data = _host(total) * norm
                data = np.where(land, cn.spval, data).astype(np.float32)
                v[:] = data[None]
                v.units = f.units.encode()
                v.long_name = f.long_name.encode()
                v.missing_value = np.float32(cn.spval)
                v.cell_measures = f.cell_measure.encode()
        self.sums = {}
        self.count = 0
        return path

    def _write_bin(self, idate: int, time_days: float) -> str:
        """Binary history stream (``ice_history.F90 icebin:3244-3474``):
        a flat big-endian float64 record per field plus an ASCII
        header file describing the records — the reference's
        ``histfreq`` binary alternative to netCDF."""
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"{self.prefix}.{idate}.da")
        hdr = os.path.join(self.dir, f"{self.prefix}.{idate}.hdr")
        g = self.grid
        count = self.count
        land = ~_host(g.tmask)
        lines = [f"{'record':>6s}  {'levels':>6s}  name  units  "
                 f"long_name",
                 f"# grid ni={g.nx} nj={g.ny} time_days={time_days}"]
        rec = 0
        with open(path, "wb") as fh:
            for nm, arr, units, lname in [
                ("TLON", np.rad2deg(_host(g.tlon)), "degrees_east",
                 "T grid center longitude"),
                ("TLAT", np.rad2deg(_host(g.tlat)),
                 "degrees_north", "T grid center latitude"),
                ("tarea", _host(g.tarea), "m^2", "T cell area"),
            ]:
                fh.write(arr.astype(">f8").tobytes())
                rec += 1
                lines.append(f"{rec:6d}  {1:6d}  {nm}  {units}  {lname}")
            for name, total in self.sums.items():
                f = self.fields[name]
                norm = 1.0 / count if (self.avg and f.avg) else 1.0
                data = _host(total) * norm
                data = np.where(land, cn.spval, data)
                flat = data.reshape(-1, g.ny, g.nx)
                fh.write(flat.astype(">f8").tobytes())
                rec += flat.shape[0]
                lines.append(f"{rec:6d}  {flat.shape[0]:6d}  {name}  "
                             f"{f.units}  {f.long_name}")
        with open(hdr, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        self.sums = {}
        self.count = 0
        return path


class History:
    """Multi-stream history manager (`histfreq` tuple of codes)."""

    def __init__(self, grid: Grid, histfreq=("m",), histfreq_n=(1,),
                 avg=True, directory="./history", prefix="iceh",
                 fields=None, itd=None, fmt="nc"):
        fields = fields or default_fields(itd)
        self.streams = []
        for k, freq in enumerate(histfreq):
            if freq == "x":
                continue
            n = histfreq_n[k] if k < len(histfreq_n) else 1
            suffix = prefix if k == 0 else f"{prefix}{k + 1}"
            self.streams.append(
                HistoryStream(grid, fields, freq, n, avg, directory,
                              suffix, fmt=fmt))

        self._mlt_onset = None
        self._frz_onset = None

    def accumulate(self, state, fluxes, forcing=None, yday=None, dt=None):
        """Accumulate one step into every stream.

        forcing/yday/dt are optional; when given, the forcing-echo
        fields (fswdn/flwdn/rain/snow/Tair/sss/uocn/vocn) and the
        melt/freeze onset-date fields are filled
        (`ice_history.F90:1393-1452` accumulation region).
        """
        if not self.streams:
            return
        fluxes = dict(fluxes)
        if dt is not None:
            fluxes["_dt"] = float(dt)
        if forcing is not None:
            f = forcing
            fluxes.setdefault(
                "fswdn", f.swvdr + f.swvdf + f.swidr + f.swidf)
            fluxes.setdefault("flwdn", f.flw)
            fluxes.setdefault("snow", f.fsnow)
            fluxes.setdefault("rain", f.frain)
            fluxes.setdefault("Tair", f.Tair)
            fluxes.setdefault("sss", f.sss)
            fluxes.setdefault("uocn", f.uocn)
            fluxes.setdefault("vocn", f.vocn)
        if yday is not None and "meltt" in fluxes:
            z = torch.zeros_like(fluxes["meltt"])
            if self._mlt_onset is None:
                self._mlt_onset = z
                self._frz_onset = z
            melting = fluxes["meltt"] > cn.puny
            freezing = (fluxes.get("congel", z)
                        + fluxes.get("frazil", z)) > cn.puny
            self._mlt_onset = torch.where(
                melting & (self._mlt_onset <= 0.0), yday, self._mlt_onset)
            self._frz_onset = torch.where(
                freezing & (self._frz_onset <= 0.0), yday,
                self._frz_onset)
            fluxes["mlt_onset"] = self._mlt_onset
            fluxes["frz_onset"] = self._frz_onset
        agg = aggregate(state, self.streams[0].grid.tmask)
        for s in self.streams:
            s.accumulate(state, fluxes, agg)

    def write_due(self, calendar) -> list[str]:
        out = []
        for s in self.streams:
            if calendar.write_flag(s.freq, s.freq_n):
                p = s.write(calendar.idate, calendar.time / 86400.0)
                if p:
                    out.append(p)
        return out
