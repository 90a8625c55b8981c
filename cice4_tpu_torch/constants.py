"""Physical and numerical constants of the PyTorch port.

A copy of :mod:`cice4_tpu.constants` (the reference model's
``drivers/cice4/ice_constants.F90:35-217``), kept as plain Python
floats: PyTorch combines them with tensors at the tensor's dtype.  A
test holds every value equal to the JAX package's.

Staggering and tripole-sign metadata live in
:mod:`cice4_tpu_torch.parallel.halo` as typed enums.
"""

from __future__ import annotations

import enum
import math

# ---------------------------------------------------------------------------
# physical constants (CICE default set, ice_constants.F90:49-126)
# ---------------------------------------------------------------------------

rhos = 330.0          # density of snow (kg/m^3)
rhoi = 917.0          # density of ice (kg/m^3)
rhow = 1026.0         # density of seawater (kg/m^3)
cp_air = 1005.0       # specific heat of air (J/kg/K)
emissivity = 0.95     # emissivity of snow and ice
cp_ice = 2106.0       # specific heat of fresh ice (J/kg/K)
cp_ocn = 4218.0       # specific heat of sea water (J/kg/K)
depressT = 0.054      # freezing-point:brine-salinity ratio (C/ppt)
dragio = 0.00536      # ice-ocean drag coefficient
albocn = 0.06         # ocean albedo

gravit = 9.80616      # gravitational acceleration (m/s^2)
omega = 7.292e-5      # angular velocity of earth (rad/s)
radius = 6.37e6       # earth radius (m)

pi = math.pi
pih = 0.5 * pi
pi2 = 2.0 * pi
secday = 86400.0      # seconds in a calendar day
Tocnfrz = -1.8        # freezing temp of seawater (C); Tsfc for open water
rhofresh = 1000.0     # density of fresh water (kg/m^3)
zvir = 0.606          # rh2o/rair - 1.0
vonkar = 0.4          # von Karman constant
cp_wv = 1.81e3        # specific heat of water vapor (J/kg/K)
stefan_boltzmann = 567.0e-10  # W/m^2/K^4
Tffresh = 273.15      # freezing temp of fresh water (K)
Lsub = 2.835e6        # latent heat of sublimation, freshwater (J/kg)
Lvap = 2.501e6        # latent heat of vaporization, freshwater (J/kg)
Lfresh = Lsub - Lvap  # latent heat of melting of fresh ice (J/kg)
Timelt = 0.0          # melting temperature, ice top surface (C)
Tsmelt = 0.0          # melting temperature, snow top surface (C)
ice_ref_salinity = 4.0  # reference salinity of sea ice (ppt)

iceruf = 0.0005       # ice surface roughness (m)
kappav = 1.4          # visible extinction coefficient in ice (1/m)
kappan = 17.6         # near-IR extinction coefficient in ice (1/m)
kice = 2.03           # thermal conductivity of fresh ice (W/m/K)
kseaice = 2.00        # thermal conductivity, zero-layer option (W/m/K)
ksno = 0.30           # thermal conductivity of snow (W/m/K)
zref = 10.0           # reference height for stability (m)
snowpatch = 0.02      # fractional snow coverage length scale (m)

# spectral weights for broadband albedo diagnostics (ice_constants.F90:111-115)
awtvdr = 0.00318      # visible, direct
awtidr = 0.00182      # near IR, direct
awtvdf = 0.63282      # visible, diffuse
awtidf = 0.36218      # near IR, diffuse

# saturation humidity coefficients (ice_constants.F90:117-121)
qqqice = 11637800.0
TTTice = 5897.8
qqqocn = 627572.4
TTTocn = 5107.4

shlat = 30.0          # artificial masking edge, southern hemisphere (deg)
nhlat = -30.0         # artificial masking edge, northern hemisphere (deg)

# ---------------------------------------------------------------------------
# numerical constants
# ---------------------------------------------------------------------------

eps11 = 1.0e-11
eps13 = 1.0e-13
eps16 = 1.0e-16
puny = eps11
bignum = 1.0e30
spval = 1.0e30        # missing-data marker for output


def a_negligible(dtype) -> float:
    """Area fraction below which a category is numerically meaningless.

    The reference (all float64) uses ``puny`` = 1e-11 everywhere
    (``ice_itd.F90 zap_small_areas:1844``).  In float32 a category with
    aicen ~ 1e-11 carries volume/energy ratios that are pure roundoff
    noise (7 significant digits cannot keep eicen/vicen/aicen mutually
    consistent at that scale), which makes the energy-conserving Newton
    solve in `temperature_changes` unconvergeable.  Physically such a
    cell holds < 1 mm^2 of ice per km^2 — zapping it to open water is
    exact to within f32 roundoff.  f64 keeps the reference threshold.

    `dtype` may be a ``torch.dtype`` or anything numpy accepts.
    """
    itemsize = getattr(dtype, "itemsize", None)
    if not isinstance(itemsize, int):
        import numpy as _np
        itemsize = _np.dtype(dtype).itemsize
    return puny if itemsize >= 8 else 1.0e-8

# ---------------------------------------------------------------------------
# conversion factors
# ---------------------------------------------------------------------------

cm_to_m = 0.01
m_to_cm = 100.0
m2_to_km2 = 1.0e-6
kg_to_g = 1000.0
mps_to_cmpdy = 8.64e6
rad_to_deg = 180.0 / pi
deg_to_rad = pi / 180.0


class FieldLoc(enum.Enum):
    """Staggering location of a field on the B-grid.

    Equivalent of the reference ``field_loc_*`` ids
    (``ice_constants.F90:185-192``); consumed by the halo/boundary
    machinery to pick the correct tripole fold indexing.
    """

    CENTER = "center"      # T point (cell center)
    NE_CORNER = "ne"       # U point (NE cell corner)
    N_FACE = "n"           # N cell face midpoint
    E_FACE = "e"           # E cell face midpoint


class FieldType(enum.Enum):
    """Tripole-fold sign behavior (``ice_constants.F90:200-205``)."""

    SCALAR = "scalar"      # no sign change across the fold
    VECTOR = "vector"      # sign flips across the fold
    ANGLE = "angle"        # angle-like: sign flips
