"""The benchmark's inputs, made from the seed: the initial ice state's
perturbation, the NCAR bulk forcing files with the ocean climatology, and
the coupler's bank of import states.

Every generator is one function of the seed and the traffic file's
parameters; the same seed gives the same inputs.  Large fields are made
on the device in float64, in a few calls with a ``torch.Generator``
there; the program gets them cast to its own type and the reference gets
them as they are.  The field ranges and the plane-wave form follow the
port's seeded test inputs (``kernel_check._smooth``,
``kernel_check.coupler_fields``), with winter ranges at the start date.
"""

from __future__ import annotations

import math
import os

import torch

TWO_PI = 2.0 * math.pi


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named stream of the seed: streams
    keep the inputs independent of the order in which they are made."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def smooth_unit(g, n: int, ny: int, nx: int, *, waves: int = 3,
                noise: float = 0.0, device, periods=(1, 4)):
    """(n, ny, nx) float64 fields in [0, 1]: per field, `waves` plane
    waves of `periods` cycles across the grid with random phases, plus
    `noise` of white noise."""
    lo, hi = periods
    k = torch.randint(lo, hi, (2, n, waves, 1, 1), generator=g, device=device,
                      dtype=torch.int64).to(torch.float64)
    phase = TWO_PI * torch.rand((n, waves, 1, 1), generator=g, device=device,
                                dtype=torch.float64)
    y = torch.arange(ny, device=device, dtype=torch.float64)[:, None] / ny
    x = torch.arange(nx, device=device, dtype=torch.float64)[None, :] / nx
    w = torch.sin(TWO_PI * (k[0] * x + k[1] * y) + phase).sum(1)
    unit = (w + waves) / (2.0 * waves)
    if noise:
        unit = (1.0 - noise) * unit + noise * torch.rand(
            (n, ny, nx), generator=g, device=device, dtype=torch.float64)
    return unit


# ---------------------------------------------------------------------------
# the initial ice state
# ---------------------------------------------------------------------------


def perturbation(seed: int, spec: dict, hin_max, ncat: int, ny: int, nx: int,
                 *, device) -> dict:
    """Factors of the cold start's concentration (`ra`) and thickness
    (`rh`), (ncat, ny, nx) float64 each, smooth in space.  `ra` lies in
    [1 - area_drop, 1]; `rh` keeps each category's thickness inside its
    bounds `hin_max` (the cold start puts it at the category's middle):
    it moves it by at most `thickness_share` of the way to the nearer
    bound."""
    g = generator(seed, 1, device)
    u = smooth_unit(g, 2 * ncat, ny, nx, waves=int(spec.get("waves", 3)),
                    device=device)
    p = 2.0 * u - 1.0
    drop = float(spec["area_drop"])
    share = float(spec["thickness_share"])
    ra = 1.0 - drop * u[:ncat]
    hin = [float(h) for h in hin_max]
    amp = []
    for n in range(ncat):
        mid = 0.5 * (hin[n] + hin[n + 1]) if n < ncat - 1 else hin[n] + 1.0
        lo = 1.0 - hin[n] / mid
        hi = hin[n + 1] / mid - 1.0 if n < ncat - 1 else lo
        amp.append(share * min(lo, hi))
    amp = torch.tensor(amp, dtype=torch.float64, device=device)[:, None, None]
    rh = 1.0 + amp * p[ncat:]
    return {"ra": ra, "rh": rh}


def perturb_state(fields: dict, factors: dict) -> dict:
    """The state dict `fields` with its ice scaled by the factors: area
    by `ra`, volume and ice enthalpy by `ra * rh`; the snow laid down as
    the cold start lays it (0.2 m, at most a fifth of the ice volume) and
    its enthalpy scaled with it.  Returns a new dict in the fields'
    type."""
    dtype = fields["aicen"].dtype
    ra = factors["ra"].to(fields["aicen"].device, dtype)
    rv = (factors["ra"] * factors["rh"]).to(fields["aicen"].device, dtype)
    aicen = fields["aicen"] * ra
    vicen = fields["vicen"] * rv
    vsnon = torch.minimum(aicen * 0.20, 0.2 * vicen)
    old = fields["vsnon"]
    snow = torch.where(old > 0.0, vsnon / torch.where(old > 0.0, old, 1.0),
                       0.0)
    out = dict(fields)
    out.update(aicen=aicen, vicen=vicen, vsnon=vsnon,
               eicen=fields["eicen"] * rv[:, None],
               esnon=fields["esnon"] * snow[:, None])
    return out


# ---------------------------------------------------------------------------
# NCAR bulk files and the ocean climatology
# ---------------------------------------------------------------------------

# the NCAR dataset's files, as the port's reader lays them out
# (io/forcing_data.NcarBulkForcing.LAYOUT)
NCAR_LAYOUT = {
    "swdn": ("mon", "ISCCPM/MONTHLY/RADFLX/swdn.{year}.dat"),
    "cldf": ("mon", "ISCCPM/MONTHLY/RADFLX/cldf.{year}.dat"),
    "prec": ("mon", "MXA/MONTHLY/PRECIP/prec.{year}.dat"),
    "u_10": ("6h", "NCEP/4XDAILY/STATES/u_10.{year}.dat"),
    "v_10": ("6h", "NCEP/4XDAILY/STATES/v_10.{year}.dat"),
    "t_10": ("6h", "NCEP/4XDAILY/STATES/t_10.{year}.dat"),
    "q_10": ("6h", "NCEP/4XDAILY/STATES/q_10.{year}.dat"),
    "dn10": ("6h", "NCEP/4XDAILY/STATES/dn10.{year}.dat"),
}
RECORDS_PER_DAY_6H = 4
SECONDS_6H = 21600.0


def write_ncar_files(directory: str, seed: int, spec: dict, ny: int, nx: int,
                     *, year: int, device) -> dict:
    """The NCAR bulk files of `year` (the first `days` days of the
    6-hourly fields, 12 monthly records) and the ocean climatology
    (``sss``/``sst``, 12 records) under `directory`, as big-endian float64
    records of the whole grid.  Each field spans its range in `spec`
    with large-scale weather and `noise` of white noise.  Returns
    {"bytes": written, "last_time_s": the model time of the last
    6-hourly record}."""
    ranges = spec["ranges"]
    noise = float(spec.get("noise", 0.1))
    n6 = int(spec["days"]) * RECORDS_PER_DAY_6H
    chunk = 16
    written = 0
    for s, (name, (cadence, tmpl)) in enumerate(NCAR_LAYOUT.items()):
        path = os.path.join(directory, tmpl.format(year=year))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        g = generator(seed, 100 + s, device)
        lo, hi = ranges[name]
        nrec = n6 if cadence == "6h" else 12
        with open(path, "wb") as f:
            for r0 in range(0, nrec, chunk):
                n = min(chunk, nrec - r0)
                u = smooth_unit(g, n, ny, nx, noise=noise, device=device)
                rec = (lo + (hi - lo) * u).cpu().numpy().astype(">f8")
                rec.tofile(f)
                written += rec.nbytes
    for s, stem in enumerate(("sss", "sst")):
        g = generator(seed, 200 + s, device)
        lo, hi = ranges[stem]
        u = smooth_unit(g, 12, ny, nx, noise=noise, device=device)
        rec = (lo + (hi - lo) * u).cpu().numpy().astype(">f8")
        rec.tofile(os.path.join(directory, f"{stem}.mm.{nx}x{ny}.da"))
        written += rec.nbytes
    return {"bytes": written, "last_time_s": (n6 - 1) * SECONDS_6H}


# ---------------------------------------------------------------------------
# the coupler's import bank
# ---------------------------------------------------------------------------

# ACCESS-OM's import fields (coupling.A2I_FIELDS, coupling.O2I_FIELDS)
A2I = ("swfld_i", "lwfld_i", "rain_i", "snow_i", "press_i", "runof_i",
       "tair_i", "qair_i", "uwnd_i", "vwnd_i")
O2I = ("sst_i", "sss_i", "ssu_i", "ssv_i", "sslx_i", "ssly_i", "pfmice_i")


class ImportBank:
    """The import states of `size` coupling intervals, periodic in the
    interval index.  Each field is its base plus its amplitude times a
    smooth pattern that turns through one or two whole cycles over the
    bank, both from `spec["fields"]`; a base given by name is that field
    of the analytic atmosphere at the start date and the grid's latitudes.
    The ocean sits at the freezing point of its salinity, `sst_i` being
    the offset from it.  Interval `k` is recomputed from the pattern
    parameters on demand, in float64.  With `block` = (j0, j1, i0, i1)
    every interval is that block of the whole grid's, and nothing of the
    rest of the grid is computed."""

    def __init__(self, seed: int, spec: dict, tlat, *, device, block=None):
        self.spec = spec
        self.size = int(spec["size"])
        ny, nx = tlat.shape
        j0, j1, i0, i1 = block or (0, ny, 0, nx)
        names = A2I + O2I
        g = generator(seed, 300, device)
        waves = 3
        self.k = torch.randint(1, 4, (2, len(names), waves, 1, 1),
                               generator=g, device=device,
                               dtype=torch.int64).to(torch.float64)
        self.phase = TWO_PI * torch.rand((len(names), waves, 1, 1),
                                         generator=g, device=device,
                                         dtype=torch.float64)
        self.turns = torch.randint(1, 3, (len(names), waves, 1, 1),
                                   generator=g, device=device,
                                   dtype=torch.int64).to(torch.float64)
        self.names = names
        self.y = torch.arange(j0, j1, device=device,
                              dtype=torch.float64)[:, None] / ny
        self.x = torch.arange(i0, i1, device=device,
                              dtype=torch.float64)[None, :] / nx
        self.base = analytic_atmosphere(tlat[j0:j1, i0:i1],
                                        spec["start_yday"])

    def pattern(self, i: int, k: int):
        """Field `i`'s pattern at interval `k`, in [-1, 1]."""
        t = TWO_PI * k / self.size
        w = torch.sin(TWO_PI * (self.k[0, i] * self.x + self.k[1, i] * self.y)
                      + self.phase[i] + self.turns[i] * t).sum(0)
        return w / self.k.shape[2]

    def interval(self, k: int, dtype=torch.float64) -> dict:
        k = k % self.size
        spec = self.spec["fields"]
        out = {}
        for i, name in enumerate(self.names):
            base, amp = spec[name]
            if isinstance(base, str):
                base = self.base[base]
            v = base + amp * self.pattern(i, k)
            out[name] = v
        for name in ("swfld_i", "rain_i", "snow_i", "qair_i", "runof_i"):
            out[name] = torch.clamp(out[name], min=0.0)
        # the ocean at the freezing point of its salinity (linear_S)
        out["sst_i"] = -0.054 * out["sss_i"] + out["sst_i"]
        return {"a2i": {n: out[n].to(dtype) for n in A2I},
                "o2i": {n: out[n].to(dtype) for n in O2I}}


def analytic_atmosphere(tlat, yday: float) -> dict:
    """The analytic atmosphere of the port's `AnalyticForcing` at day
    `yday` (``io/forcing_data.py``): air temperature, humidity, longwave,
    shortwave, precipitation split at 0 C, and the polar winds, at the
    latitudes `tlat` (radians)."""
    lat = tlat.to(torch.float64)
    phase = TWO_PI * (yday - 172.0) / 365.0
    seasonal = math.cos(phase)
    hemi = torch.sign(torch.sin(lat))
    tair = (273.15 + 28.0 * torch.cos(lat) ** 2
            - 22.0 * torch.abs(torch.sin(lat)) ** 3
            + 12.0 * seasonal * hemi * torch.sin(lat) ** 2)
    uatm = -4.0 * torch.sin(lat) * torch.sign(torch.sin(lat))
    vatm = 2.0 * torch.sin(2.0 * lat) * seasonal
    qsat = 11637800.0 * torch.exp(-5897.8 / tair) / 1.3
    flw = 0.7855 * 1.15 * 567.0e-10 * tair ** 4
    decl = -0.409 * math.cos(phase)
    cosz = torch.clamp(torch.sin(lat) * math.sin(decl)
                       + torch.cos(lat) * math.cos(decl), min=0.0)
    fsw = 900.0 * cosz ** 1.4 * 0.45
    precip = 2.0e-5 * (0.8 + 0.5 * torch.cos(lat))
    snow = tair < 273.15
    return {"tair": tair, "qair": 0.85 * qsat, "lwfld": flw, "swfld": fsw,
            "rain": torch.where(snow, 0.0, precip),
            "snow": torch.where(snow, precip, 0.0),
            "uwnd": uatm, "vwnd": vatm}
