"""Runtime configuration tree of the reference.

A copy of the port's configuration tree (the port's own copy of
:mod:`cice4_tpu.config`), without the presets: the benchmark's
configuration files give every cell's tree.  One frozen dataclass
hierarchy replaces both tiers of the reference's config system — the compile-time ``-DNXGLOB/...``
macros (``comp_ice:118-122``) and the runtime Fortran namelists read by
``ice_init.F90:127-170``.  Fields that select TPU execution strategies
(``DynamicsConfig.use_pallas``) are kept for equality with the JAX
package and have no effect in the port.

The defaults reproduce the reference defaults for the canonical gx3 run
(``input_templates/gx3/ice_in``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class DomainConfig:
    """Grid dimensions and category/layer counts.

    Replaces ``source/ice_domain_size.F90:34-64``.  There is no block
    decomposition: the spatial domain is a dense ``(ny, nx)`` array.
    """

    nx_global: int = 100          # global grid size, x
    ny_global: int = 116          # global grid size, y
    ncat: int = 5                 # number of ice thickness categories
    nilyr: int = 4                # vertical ice layers per category
    nslyr: int = 1                # vertical snow layers per category
    kcatbound: int = 0            # category boundary formula (0 or 1)
    ew_boundary_type: str = "cyclic"   # cyclic | open | closed
    ns_boundary_type: str = "open"     # cyclic | open | closed | tripole | tripoleT


@dataclass(frozen=True)
class GridConfig:
    """Grid source selection (``ice_grid.F90`` grid_nml)."""

    grid_type: str = "displaced_pole"  # displaced_pole | tripole | rectangular | column
    grid_format: str = "bin"           # bin | nc
    grid_file: str = ""                # POP grid file (7 f64 records)
    kmt_file: str = ""                 # land-mask file (i4 records)
    # rectangular-grid parameters (ice_grid.F90 rectgrid)
    dx_rect: float = 30.0e3            # uniform cell size x (m)
    dy_rect: float = 30.0e3            # uniform cell size y (m)
    lat_origin: float = 40.0           # southern row latitude (deg)
    lon_origin: float = -180.0


@dataclass(frozen=True)
class DynamicsConfig:
    """EVP rheology parameters (``ice_dyn_evp.F90:62-97``)."""

    kdyn: int = 1                 # 0 = off, 1 = EVP
    ndte: int = 120               # EVP subcycles per dynamics step
    evp_damping: bool = False
    # only the elliptical yield curve is implemented, as in the
    # reference (``ice_dyn_evp.F90:441-533`` aborts on anything else);
    # validated in __post_init__ rather than silently ignored
    yield_curve: str = "ellipse"
    ecc: float = 4.0              # yield-curve axis ratio squared (e^2)
    eyc: float = 0.36             # elastic damping timescale coefficient
    cosw: float = 1.0             # cos(ocean turning angle)
    sinw: float = 0.0             # sin(ocean turning angle)
    dragio: float = 0.00536       # ice-ocean drag (AusCOM makes it a namelist)
    # strength / ridging (ice_mechred.F90)
    kstrength: int = 1            # 0 = Hibler79, 1 = Rothrock75
    krdg_partic: int = 1          # 0 = Thorndike b(h), 1 = exponential
    krdg_redist: int = 1          # 0 = Hibler80 uniform, 1 = exponential
    mu_rdg: float = 4.0           # e-folding scale of ridged ice (m^0.5)
    Pstar: float = 2.75e4         # Hibler79 strength coefficient (N/m^2)
    Cstar: float = 20.0           # Hibler79 strength decay constant
    Cf: float = 17.0              # ratio of ridging work to PE change
    Cp: float = 0.5 * 9.80616 * (1026.0 - 917.0) * 917.0 / 1026.0  # PE coefficient
    # TPU execution strategy: fuse the whole ndte-subcycle loop into one
    # Pallas kernel with the working set resident in VMEM (single-chip,
    # non-tripole only; jnp fallback otherwise)
    use_pallas: bool = True

    def __post_init__(self):
        if self.yield_curve != "ellipse":
            raise ValueError(
                f"yield_curve={self.yield_curve!r}: only 'ellipse' is "
                "implemented (ice_dyn_evp.F90 init_evp)")


@dataclass(frozen=True)
class TransportConfig:
    """Advection scheme (``ice_transport_driver.F90``)."""

    advection: str = "remap"      # remap | upwind | none
    integral_order: int = 2       # quadrature order for remap triangles
    l_dp_midpt: bool = False      # midpoint correction of departure points
    l_fixed_area: bool = False
    conservation_check: bool = False
    monotonicity_check: bool = False


@dataclass(frozen=True)
class ThermoConfig:
    """Column physics options (``ice_nml`` thermodynamics entries)."""

    kitd: int = 1                 # 0 = delta-function ITD, 1 = linear remap
    heat_capacity: bool = True
    conduct: str = "MU71"         # MU71 | bubbly
    calc_Tsfc: bool = True
    ustar_min: float = 0.05       # minimum ocean friction velocity (m/s)
    Tfrzpt: str = "linear_S"      # linear_S | constant
    atmbndy: str = "default"      # default (Monin-Obukhov) | constant
    calc_strair: bool = True
    oceanmixed_ice: bool = True   # slab ocean mixed layer
    update_ocn_f: bool = False    # include frazil water/salt fluxes in ocn fluxes
    hfrazilmin: float = 0.05      # minimum new-frazil thickness (m)
    saltmax: float = 3.2          # max salinity, at ice base (ppt)
    phi_init: float = 0.75        # initial liquid fraction of frazil


@dataclass(frozen=True)
class RadiationConfig:
    """Shortwave options (``ice_shortwave.F90``)."""

    shortwave: str = "default"    # default (CCSM3) | dEdd
    albedo_type: str = "default"  # default | constant
    # coupled-mode ordering: compute shortwave at the END of the step
    # and rescale last step's absorbed SW by the new net shortwave at
    # the START (``ice_step_mod.F90 prep_radiation:84-218``).  Default
    # False = standalone ordering (radiation at step start, no rescale).
    prep_radiation: bool = False
    albicev: float = 0.78         # visible ice albedo (thick ice)
    albicei: float = 0.36         # near-IR ice albedo
    albsnowv: float = 0.98        # visible snow albedo (cold snow)
    albsnowi: float = 0.70        # near-IR snow albedo
    ahmax: float = 0.5            # thickness above which albedo is constant (m)
    R_ice: float = 0.0            # dEdd sea-ice tuning
    R_pnd: float = 0.0            # dEdd pond tuning
    R_snw: float = 0.0            # dEdd snow tuning
    dT_mlt_in: float = 1.5        # dEdd: melt onset temperature band (C)
    rsnw_mlt_in: float = 1500.0   # dEdd: melted snow grain radius (1e-6 m)


@dataclass(frozen=True)
class TracerConfig:
    """Optional tracers (``tracer_nml``)."""

    tr_iage: bool = True          # ice age
    tr_lvl: bool = False          # level-ice area/volume
    tr_pond: bool = False         # melt ponds


@dataclass(frozen=True)
class ForcingConfig:
    """Forcing dataset selection (``ice_forcing.F90:206-427``)."""

    atm_data_type: str = "ncar"   # ncar | LYq | ecmwf | monthly | analytic | none
    atm_data_format: str = "bin"
    atm_data_dir: str = ""
    sss_data_type: str = "default"
    sst_data_type: str = "default"
    ocn_data_dir: str = ""
    fyear_init: int = 1997
    ycycle: int = 1
    precip_units: str = "mm_per_month"
    restore_sst: bool = False
    trestore: int = 180           # SST restoring timescale (days)
    restore_ice: bool = False


@dataclass(frozen=True)
class RunConfig:
    """Run control (``setup_nml``)."""

    dt: float = 3600.0            # thermodynamic time step (s)
    npt: int = 744                # number of steps
    ndyn_dt: int = 1              # dynamics substeps per thermo step
    days_per_year: int = 365
    year_init: int = 1997
    istep0: int = 0
    runtype: str = "initial"      # initial | continue
    ice_ic: str = "default"       # default | none | <restart path>
    restart: bool = False
    restart_dir: str = "./restart/"
    pointer_file: str = "./restart/ice.restart_file"
    dumpfreq: str = "y"
    dumpfreq_n: int = 1
    diagfreq: int = 24            # diagnostics every N steps
    print_points: bool = False    # per-point probes (print_points nml)
    guards: bool = True           # in-graph abort-with-coordinates checks
    # the reference's default diagnostic points (ice_diagnostics.F90
    # latpnt/lonpnt defaults): central Arctic + Weddell Sea
    latpnt_lonpnt: tuple = ((90.0, 0.0), (-65.0, -45.0))
    histfreq: tuple = ("m", "x", "x", "x", "x")
    histfreq_n: tuple = (1, 1, 1, 1, 1)
    hist_avg: bool = True
    history_dir: str = "./history/"
    # "nc" (icecdf) or "bin" (icebin flat records + .hdr,
    # ice_history.F90:3244-3474)
    history_format: str = "nc"


@dataclass(frozen=True)
class Config:
    """Top-level configuration tree."""

    domain: DomainConfig = field(default_factory=DomainConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    dynamics: DynamicsConfig = field(default_factory=DynamicsConfig)
    transport: TransportConfig = field(default_factory=TransportConfig)
    thermo: ThermoConfig = field(default_factory=ThermoConfig)
    radiation: RadiationConfig = field(default_factory=RadiationConfig)
    tracers: TracerConfig = field(default_factory=TracerConfig)
    forcing: ForcingConfig = field(default_factory=ForcingConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def replace(self, **sections: Any) -> "Config":
        """Return a new Config with whole sections replaced."""
        return dataclasses.replace(self, **sections)

    def with_values(self, **dotted: Any) -> "Config":
        """Return a new Config with dotted-path overrides.

        ``cfg.with_values(**{"dynamics.ndte": 240, "run.npt": 24})``
        """
        sections: dict[str, dict[str, Any]] = {}
        for key, val in dotted.items():
            sec, name = key.split(".", 1)
            sections.setdefault(sec, {})[name] = val
        out = self
        for sec, over in sections.items():
            out = dataclasses.replace(
                out, **{sec: dataclasses.replace(getattr(out, sec), **over)}
            )
        return out


def _coerce(section_cls, values: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(section_cls)}
    return section_cls(**{k: v for k, v in values.items() if k in names})


def config_from_dict(tree: Mapping[str, Mapping[str, Any]]) -> Config:
    """Build a Config from a nested dict (e.g. parsed TOML/JSON)."""
    sections = {}
    for f in dataclasses.fields(Config):
        if f.name in tree:
            sections[f.name] = _coerce(f.type if isinstance(f.type, type) else
                                       _SECTION_TYPES[f.name], tree[f.name])
    return Config(**sections)


_SECTION_TYPES = {
    "domain": DomainConfig,
    "grid": GridConfig,
    "dynamics": DynamicsConfig,
    "transport": TransportConfig,
    "thermo": ThermoConfig,
    "radiation": RadiationConfig,
    "tracers": TracerConfig,
    "forcing": ForcingConfig,
    "run": RunConfig,
}
