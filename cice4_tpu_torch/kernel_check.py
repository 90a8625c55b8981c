"""Seeded inputs and the kernel-versus-plain comparisons of the port's
CUDA kernels, shared by ``chip_smoke.py`` and the GPU tests: the Newton
temperature solve first, the dynamics kernels (EVP, remap K0 in both
modes, K12, K1 and K2) after it, and at the end of the module writers of
grid and forcing files in the reference's layouts, which the grid loaders
and the forcing readers read, the coupler's seeded import fields and the
GFDL open-water fluxes' seeded inputs.

The inputs follow the JAX package's own kernel test
(``tests/test_thermo.py::test_pallas_thermo_matches_jnp``): ice only in
two row bands (so whole warps and whole rows carry no ice), snow and ice
thicknesses, surface temperatures and fluxes drawn with numpy from a
fixed seed, and a linear temperature profile converted to enthalpy.

Tolerances, fixed before the first run on the card:

* Cells whose converged flag and iteration count agree between kernel
  and plain version must agree to ``|k - p| <= rtol * (|p| + max|p|)``
  with rtol 1e-4 in float32 and 1e-10 in float64 (``max|p|`` over the
  field).  nvcc contracts ``a*b+c`` into FMA where eager PyTorch rounds
  twice, and the Newton iteration carries those last-ulp differences.
* A last-ulp difference can flip a convergence test, so a cell may
  stop one iteration earlier or later; such cells are counted, and
  their share of icy cells must stay within 1% (float32) or 0.1%
  (float64).
* Every output must be finite.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from cice4_tpu_torch import constants as cn
from cice4_tpu_torch.ops import therm_vertical as tv

FIELDS = ("Tsf", "Tsn", "Tin", "qsn", "qin", "fsurfn", "fcondtopn",
          "fcondbot", "fsensn", "flatn", "flwoutn", "fswabsn", "fswsfc",
          "fswint", "Sswabs", "Iswabs", "dq_flux")
RTOL = {torch.float32: 1.0e-4, torch.float64: 1.0e-10}
MAX_FLIP_SHARE = {torch.float32: 1.0e-2, torch.float64: 1.0e-3}


def make_inputs(p: tv.ThermoParams, ncat: int, ny: int, nx: int, seed: int,
                *, device, dtype):
    """Arguments of `temperature_changes` after `p` and `dt`, as a tuple
    of tensors on `device`; planes are (ncat, ny, nx) except the forcing
    planes rhoa, flw, potT, Qa and Tbot, which are (ny, nx)."""
    rng = np.random.RandomState(seed)
    sh = (ncat, ny, nx)

    def f(lo, hi, shape=sh):
        return rng.uniform(lo, hi, shape)

    row = np.arange(ny)[:, None] * np.ones((1, nx))
    band = (row < ny * 3 // 16) | (row >= ny * 13 // 16)
    has_ice = band[None] & (rng.rand(*sh) > 0.2)
    hilyr = np.where(has_ice, f(0.1, 0.8), 0.0)
    hslyr = np.where(has_ice, f(0.0, 0.3), 0.0)
    Tsf = np.where(has_ice, f(-30.0, -0.5), 0.0)
    Tf = -cn.depressT * 34.0
    k = np.arange(1, p.nilyr + 1)[None, :, None, None]
    Ti = Tsf[:, None] + (Tf - Tsf[:, None]) * (k - 0.5) / p.nilyr
    tmlt = np.asarray(p.tmlt[:p.nilyr])[None, :, None, None]
    Tis = np.minimum(Ti, -cn.puny)
    qin = -cn.rhoi * (cn.cp_ice * (tmlt - Tis)
                      + cn.Lfresh * (1.0 - tmlt / Tis) - cn.cp_ocn * tmlt)
    Tsn = np.broadcast_to(np.minimum(Tsf, 0.0)[:, None],
                          (ncat, p.nslyr, ny, nx)).copy()
    qsn = -cn.rhos * (cn.Lfresh - cn.cp_ice * Tsn)
    einit = (qsn * hslyr[:, None]).sum(1) + (qin * hilyr[:, None]).sum(1)
    arrays = (
        f(1.1, 1.4, (ny, nx)), f(150.0, 300.0, (ny, nx)),      # rhoa, flw
        f(240.0, 275.0, (ny, nx)), f(1e-4, 4e-3, (ny, nx)),    # potT, Qa
        f(5.0, 25.0), f(2.0, 15.0),                            # shcoef, lhcoef
        f(0.0, 60.0), f(0.0, 30.0), f(0.0, 10.0),  # fswsfc, fswint, fswthrun
        np.ones((ncat, p.nslyr, ny, nx)),                      # Sswabs
        np.broadcast_to(f(0.0, 5.0)[:, None],
                        (ncat, p.nilyr, ny, nx)).copy(),       # Iswabs
        hilyr, hslyr, qin, Ti, qsn, Tsn, Tsf,
        np.full((ny, nx), Tf), einit)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return (torch.as_tensor(has_ice, device=device),) \
        + tuple(t(a) for a in arrays)


def ponded_state(state, seed: int = 1):
    """`state` (a cold start) with the snow taken off about half of its
    icy category cells and a pond volume (m per unit ice area: none, and
    ponds below, inside and above the shallow-pond transition of the
    delta-Eddington scheme) on each icy one, drawn with numpy from
    `seed`.  From it the dEdd ponded pass and the snow-layer absorption
    both act, and the pond tracer is nonzero: the analytic forcing keeps
    the Arctic below freezing, so a cold start grows no pond."""
    rng = np.random.RandomState(seed)
    icy = (state.aicen > 0.0).cpu().numpy()
    bare = icy & (rng.rand(*icy.shape) < 0.5)
    volpn = np.where(icy, rng.choice([0.0, 1e-3, 0.02, 0.06, 0.12],
                                     icy.shape), 0.0)
    device, dtype = state.aicen.device, state.aicen.dtype
    bare = torch.as_tensor(bare, device=device)
    return state.replace(
        vsnon=torch.where(bare, 0.0, state.vsnon),
        esnon=torch.where(bare.unsqueeze(-3), 0.0, state.esnon),
        trcrn={**state.trcrn,
               "volpn": torch.as_tensor(volpn, dtype=dtype, device=device)})


def compare(kern: dict, plain: dict, has_ice, dtype) -> dict:
    """Hold the kernel's outputs against the plain version's.  Returns a
    report dict; ``report["ok"]`` says whether the tolerances hold."""
    flips = (kern["converged"] != plain["converged"]) \
        | (kern["niter_cells"] != plain["niter_cells"])
    n_ice = int(has_ice.sum())
    n_flip = int(flips.sum())
    same = ~flips
    rtol = RTOL[dtype]
    report = dict(n_ice=n_ice, n_flip=n_flip, fields={}, ok=True,
                  niter_kernel=int(kern["niter"]),
                  niter_plain=int(plain["niter_cells"].max()))
    if n_flip > MAX_FLIP_SHARE[dtype] * max(n_ice, 1):
        report["ok"] = False
    for k in FIELDS:
        a, b = kern[k], plain[k]
        m = same if a.dim() == same.dim() else same.unsqueeze(-3)
        m = m.expand_as(a)
        diff = (a - b).abs()
        scale = float(b.abs().max())
        bound = rtol * (b.abs() + scale)
        finite = bool(torch.isfinite(a).all())
        bad = int((diff > bound)[m].sum())
        report["fields"][k] = dict(
            max_abs=float(diff.max()),
            max_abs_same=float(diff[m].max()) if bool(m.any()) else 0.0,
            max_rel=float((diff / (b.abs() + scale).clamp(
                min=torch.finfo(b.dtype).tiny)).max()),
            n_bad=bad, finite=finite)
        if bad or not finite:
            report["ok"] = False
    return report


# ---------------------------------------------------------------------------
# the dynamics kernels: evp_subcycle, remap_gsh (ga_gsh, ga_planes),
# remap_k12, remap_construct and remap_contract
# ---------------------------------------------------------------------------
#
# Tolerances, fixed before the first run on the card.  The three kernels are
# built with -fmad=false and follow their plain versions operation by
# operation, so they should agree to the last bit or nearly; what may differ:
#
# * EVP: the plain version's 4-corner sums (`.sum(0)`) may be reduced in
#   another order, and 120 subcycles carry any last-bit difference:
#   |k - p| <= rtol * (|p| + max|p|), rtol 1e-4 (f32) / 1e-10 (f64).
# * GSH: PyTorch's CUDA division by a Python scalar multiplies by its
#   reciprocal (the triangle centroids' / 3), so the quadrature points may
#   differ in the last bit: rtol 1e-5 (f32) / 1e-12 (f64).  An edge may
#   select another geometric case where a case test compares a value
#   within roundoff of zero; at most 0.1% of edges (f32) or 0.01% (f64) may
#   differ, and only GSH values within two cells of such an edge (the
#   90 planes at 25 cells per flipped edge) may exceed the tolerance.
# * K12: same operations in the same order on the same GSH:
#   rtol 1e-5 (f32) / 1e-12 (f64).
#
# Fixed before the first run on the card of the kernels of the split route
# and of the NS-cyclic EVP:
#
# * EVP on an NS-cyclic grid: the same kernel with the NS wrap of its
#   neighbour reads, the same reasons: EVP_RTOL.
# * K0 in GA mode: the same geometry and sums as GSH mode without the
#   back-shift, the same reasons: GSH_RTOL and GSH_MAX_FLIP_SHARE, with the
#   same allowance of GA values near an edge whose case differs.
# * K1 (`construct`): the reconstruction device code K12 runs, the same
#   operations in the same order as `construct_plain`: rtol 1e-5 (f32) /
#   1e-12 (f64).
# * K2 (`contract`): the plain version's operations in its order, with the
#   9 offsets summed in `remap.ALL_OFFSETS` order: rtol 1e-5 (f32) / 1e-12
#   (f64).  Since K2 runs K12's contraction, a type-1 tracer's polynomial
#   drops the terms whose parent planes are exactly 0, which changes at
#   most the sign of a zero.

EVP_RTOL = {torch.float32: 1.0e-4, torch.float64: 1.0e-10}
GSH_RTOL = {torch.float32: 1.0e-5, torch.float64: 1.0e-12}
GSH_MAX_FLIP_SHARE = {torch.float32: 1.0e-3, torch.float64: 1.0e-4}
K12_RTOL = {torch.float32: 1.0e-5, torch.float64: 1.0e-12}
K1_RTOL = {torch.float32: 1.0e-5, torch.float64: 1.0e-12}
K2_RTOL = {torch.float32: 1.0e-5, torch.float64: 1.0e-12}

# Fixed before the first run on the card of the decomposed path
# (parallel/, ops/evp_sharded.py; chip_smoke.py phases (o)-(r)):
#
# * Round-mode EVP (k-halo rounds of H-1 subcycles on padded blocks, each
#   a launch of the kernel) against its plain version and against the
#   one-device launch: the same per-cell arithmetic in the same order
#   (-fmad=false), only the gating lists and the grid barriers differ, so
#   bit-equal is expected; the EVP kernel's reasons bound it: EVP_RTOL.
# * The decomposed step against the one-device step on the same card: each
#   block runs the one-device arithmetic cell by cell (the same kernels;
#   the stencils read exchanged neighbours, which are the global values),
#   so bit-equal is expected.  What may differ is a PyTorch reduction
#   whose order the tensor's shape picks (a category sum, a vectorised
#   loop's tail), roundoff that the step's Newton solve, ridging loop and
#   EVP subcycles carry, as in the kernel-against-plain comparisons:
#   |d - o| <= rtol * (|o| + max|o|), rtol 1e-4 (f32) / 1e-10 (f64), per
#   state field after each step.  (On the CPU, elementwise `exp`/`pow`
#   round the vectorised body and the scalar tail of a loop differently,
#   so blocks of other sizes differ from one device in the last bits.)

ROUNDS_RTOL = EVP_RTOL
DECOMP_RTOL = {torch.float32: 1.0e-4, torch.float64: 1.0e-10}


def compare_fields(kern: dict, plain: dict, rtol: float) -> dict:
    """Per output: max |k - p|, max relative to (|p| + max|p|), the number
    of elements beyond ``rtol * (|p| + max|p|)`` and finiteness."""
    out = {}
    for k, b in plain.items():
        a = kern[k]
        diff = (a - b).abs()
        scale = float(b.abs().max()) if b.numel() else 0.0
        den = (b.abs() + scale).clamp(min=torch.finfo(b.dtype).tiny)
        out[k] = dict(max_abs=float(diff.max()) if b.numel() else 0.0,
                      max_rel=float((diff / den).max()) if b.numel() else 0.0,
                      n_bad=int((diff > rtol * (b.abs() + scale)).sum()),
                      finite=bool(torch.isfinite(a).all()))
    return out


def fields_ok(report: dict, allowed_bad: int = 0) -> bool:
    return (all(v["finite"] for v in report.values())
            and sum(v["n_bad"] for v in report.values()) <= allowed_bad)


# The column kernels (csrc/ridge_column.cu) against ridge_ice's and
# cleanup_itd's plain versions, on the card: relative to (|p| + max|p|),
# as compare_fields reads it.  In float64 the kernels follow the plain
# operations and their order, so only the skipped zero-closing passes
# differ (their tracer round trips, a few ulps).  In float32 the same,
# and a column's test |asum - 1| < puny holds only at asum == 1 exactly, so
# an ulp of difference can give one column another pass.  One more
# difference is no rounding: the plain tracer rebuild divides a volume
# tracer by max(vicen, puny), so each zero-closing pass that the plain loop
# gives a converged column scales the tracer of a category whose volume
# lies in (0, puny) by vicen / puny.  Those categories (below 1e-11 m of
# ice) are left out of the tracers' check and counted.
COLUMN_RTOL = {torch.float32: 1.0e-5, torch.float64: 1.0e-12}
COLUMN_STATE = ("aicen", "vicen", "vsnon", "eicen", "esnon", "tsfcn")
RIDGE_DIAG = ("dardg1dt", "dardg2dt", "dvirdgdt", "opening", "fresh",
              "fhocn")
CLEANUP_FLUXES = ("dfresh", "dfsalt", "dfhocn")


def column_state(cfg, grid, seed: int):
    """A seeded state for the column kernels on `grid` (its device and
    type): in each ocean
    column 80% of the categories icy, total areas from 0.3 to 1.08 (the
    cleanup normalises those over 1), thicknesses drawn across and beyond
    each category's bounds (both rebin sweeps move ice), 3% of the icy
    categories at half the zap threshold of `dtype`, snow, enthalpies
    proportional to the volumes, surface temperatures and tracers."""
    from cice4_tpu_torch.state import init_state, make_itd_params

    itd = make_itd_params(cfg)
    dtype, device = grid.tarea.dtype, grid.tarea.device
    st = init_state(cfg, grid, itd, device=device, dtype=dtype)
    rng = np.random.RandomState(seed)
    ncat, ny, nx = st.aicen.shape
    nilyr, nslyr = itd.nilyr, itd.nslyr
    shape = (ncat, ny, nx)
    ocean = grid.tmask.cpu().numpy()
    icy = ocean[None] & (rng.rand(*shape) < 0.8)
    a = np.where(icy, rng.uniform(0.02, 0.3, shape), 0.0)
    total = rng.uniform(0.3, 1.08, (ny, nx))
    a = a * (total / np.maximum(a.sum(0), 1e-3))[None]
    tiny = icy & (rng.rand(*shape) < 0.03)
    a = np.where(tiny, 0.5 * cn.a_negligible(dtype), a)
    h = rng.uniform(0.0, 1.4, shape) * (itd.hin_max[1:, None, None] + 0.5)
    v = h * a
    vs = rng.uniform(0.0, 0.4, shape) * a
    q_ice = rng.uniform(-3.3e8, -2.6e8, (ncat, nilyr, ny, nx))
    q_snow = rng.uniform(-1.2e8, -1.0e8, (ncat, nslyr, ny, nx))
    e = q_ice * (v / nilyr)[:, None]
    es = q_snow * (vs / nslyr)[:, None]
    tsf = np.where(a > 0, rng.uniform(-25.0, -1.8, shape), cn.Tocnfrz)
    trc = {k: np.where(a > 0, rng.uniform(0.2, 1.0, shape), 0.0)
           for k in st.trcrn}

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return st.replace(aicen=t(a), vicen=t(v), vsnon=t(vs), eicen=t(e),
                      esnon=t(es), tsfcn=t(tsf),
                      trcrn={k: t(x) for k, x in trc.items()})


def compacted(state, seed: int, most: float = 2.0):
    """`state` with each column's ice (areas, volumes, enthalpies) scaled
    by a factor drawn from 1 to `most`, as transport's convergence piles
    area above 1: ridging then takes several passes in many columns, and in
    a few hits its rate reductions pass after pass."""
    rng = np.random.RandomState(seed)
    f = torch.as_tensor(rng.uniform(1.0, most, state.aicen.shape[1:]),
                        dtype=state.aicen.dtype, device=state.aicen.device)
    return state.replace(aicen=state.aicen * f, vicen=state.vicen * f,
                         vsnon=state.vsnon * f, eicen=state.eicen * f,
                         esnon=state.esnon * f)


def ridge_forcing(state, seed: int, strength: float = 1.0):
    """(rdg_conv, rdg_shear, aice0) for `ridge_ice` on `state`: closing
    rates up to `strength` x 4e-5 /s (a share of 0.14 an hour), and an
    advected open water that leaves the area sum off 1 by -0.1 to 0.05,
    so that many columns take several passes."""
    rng = np.random.RandomState(seed)
    ny, nx = state.aicen.shape[1:]
    dtype, device = state.aicen.dtype, state.aicen.device

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    aice = state.aicen.sum(0).cpu().double().numpy()
    conv = rng.uniform(0.0, 4e-5 * strength, (ny, nx))
    shear = rng.uniform(0.0, 4e-5 * strength, (ny, nx))
    aice0 = np.maximum(1.0 - aice + rng.uniform(-0.1, 0.05, (ny, nx)), 0.0)
    return t(conv), t(shear), t(aice0)


def column_outputs(state, extra: dict) -> dict:
    """The fields the column kernels write, by name, the tracers as
    ``trcrn.<name>``."""
    out = {k: getattr(state, k) for k in COLUMN_STATE}
    out.update({f"trcrn.{k}": x for k, x in state.trcrn.items()})
    out.update({k: extra[k] for k in RIDGE_DIAG + CLEANUP_FLUXES
                if k in extra})
    return out


def column_bytes(state, kernel: str, aice0: bool = True) -> int:
    """The bytes `kernel` ("ridge_column" or "cleanup_column") moves at
    `state`'s shapes, each input read once and each output written once:
    the state (area, volumes, surface temperature, enthalpy layers,
    tracers) in and out; ridging also reads the convergence, the shear,
    the advected open water (`aice0`) and the mask, and writes six rates,
    the area sum, the pass count (int32) and the converged flag; the
    cleanup reads the mask and writes three fluxes."""
    ny, nx = state.aicen.shape[-2:]
    cells = ny * nx
    planes = sum(getattr(state, k).numel() for k in COLUMN_STATE) // cells
    planes += sum(t.numel() for t in state.trcrn.values()) // cells
    word = state.aicen.element_size()
    if kernel == "ridge_column":
        words = 2 * planes + 2 + int(aice0) + len(RIDGE_DIAG) + 1
        return words * cells * word + cells * (1 + 4 + 1)
    if kernel == "cleanup_column":
        return (2 * planes + len(CLEANUP_FLUXES)) * cells * word + cells
    raise ValueError(f"unknown column kernel {kernel!r}")


def cleanup_triggers(state, itd, tmask) -> dict:
    """How many category cells of `state` take each branch of the
    cleanup: the category-1 minimum thickness (delta-function ITD only),
    an upward and a downward rebin move, a zap, and columns whose total
    area exceeds 1."""
    a, v = state.aicen, state.vicen
    icy = a > cn.puny
    h = torch.where(icy, v / a.clamp(min=cn.puny), 0.0)
    hin = torch.as_tensor(itd.hin_max, dtype=a.dtype,
                          device=a.device)[:, None, None]
    small = (a.abs() > 0.0) & (a.abs() <= cn.a_negligible(a.dtype)) & tmask
    return dict(
        cat1=int((icy[0] & (h[0] <= hin[0])).sum())
        if itd.hin_max[0] > 0.0 else 0,
        up=int((icy[:-1] & (h[:-1] > hin[1:-1])).sum()),
        down=int((icy[1:] & (h[1:] <= hin[1:-1])).sum()),
        zap=int(small.sum()), excess=int((a.sum(0) > 1.0).sum()))


def compare_columns(kstate, kextra: dict, pstate, pextra: dict,
                    rtol: float):
    """(compare_fields' report, tracer elements left out that differ):
    the column kernels' outputs against the plain versions', each tracer
    checked where its parent field is 0 or at least puny in both
    results."""
    from cice4_tpu_torch.ops.itd import TRACER_DEPEND

    kern = column_outputs(kstate, kextra)
    plain = column_outputs(pstate, pextra)
    left_out = 0
    for name in pstate.trcrn:
        parent = ("aicen", "vicen", "vsnon")[TRACER_DEPEND[name]]
        tiny = torch.zeros_like(pstate.aicen, dtype=torch.bool)
        for st in (kstate, pstate):
            w = getattr(st, parent)
            tiny |= (w > 0.0) & (w < cn.puny)
        key = f"trcrn.{name}"
        left_out += int((tiny & (kern[key] != plain[key])).sum())
        for out in (kern, plain):
            out[key] = torch.where(tiny, 0.0, out[key])
    return compare_fields(kern, plain, rtol), left_out


ICE_PATTERNS = ("bands", "none", "seams", "all")


def ice_mask(ny: int, nx: int, ice: str):
    """Where the synthetic inputs may hold ice: "bands", two polar row
    bands (thinned at random by the callers); "none"; "seams", one cell at
    each corner and at the middle of each edge, next to every seam; "all"."""
    if ice == "bands":
        row = np.arange(ny)[:, None] * np.ones((1, nx))
        return (row < ny // 4) | (row >= ny - ny // 5)
    if ice not in ICE_PATTERNS:
        raise ValueError(f"unknown ice pattern {ice!r}")
    m = np.full((ny, nx), ice == "all")
    if ice == "seams":
        for j in (0, ny // 2, ny - 1):
            for i in (0, nx // 2, nx - 1):
                m[j, i] = (j, i) != (ny // 2, nx // 2)
    return m


def evp_inputs(grid, seed: int, *, dtype, ice: str = "bands"):
    """Arguments of `evp_subcycle` after `p` and `grid`: ice as `ice`
    says (by default in two polar bands, so the middle rows carry no ice
    and whole warps are gated off), the masked-zero invariant, random
    forcing, on the grid's device."""
    ny, nx = grid.ny, grid.nx
    device = grid.tmask.device
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def r(lo, hi, shape=(ny, nx)):
        return rng.uniform(lo, hi, shape)

    thin_t, thin_u = rng.rand(ny, nx) > 0.3, rng.rand(ny, nx) > 0.1
    icet = ice_mask(ny, nx, ice)
    iceu = icet.copy()
    if ice == "bands":
        icet = icet & thin_t
        iceu = icet & thin_u
    arrays = (r(0.0, 2.0e4) * icet, icet, iceu, r(0.5, 1.0),
              r(-0.2, 0.2), r(-0.2, 0.2), r(-0.2, 0.2), r(-0.2, 0.2),
              r(-0.2, 0.2) * iceu, r(-0.2, 0.2) * iceu, r(1.0, 60.0),
              r(-2.0, 2.0), r(-0.3, 0.3) * iceu,
              r(-0.3, 0.3) * iceu, r(-1e3, 1e3, (4, ny, nx)) * icet,
              r(-1e3, 1e3, (4, ny, nx)) * icet,
              r(-1e3, 1e3, (4, ny, nx)) * icet)
    return tuple(torch.as_tensor(a, device=device) if a.dtype == bool
                 else t(a) for a in arrays)


EVP_OUTPUTS = ("uvel", "vvel", "stressp", "stressm", "stress12", "strintx",
               "strinty", "strocnx", "strocny", "div_sum", "delta_sum",
               "ten_sum", "shr_sum", "prs_sig")


def evp_named(out) -> dict:
    """The result tuple of `evp_subcycle` as a dict over EVP_OUTPUTS."""
    named = dict(zip(EVP_OUTPUTS[:5], out[:5]))
    named.update(zip(EVP_OUTPUTS[5:9], out[6:]))
    named.update(out[5])
    return named


def remap_inputs(grid, seed: int, ncat: int, meta, *, dtype,
                 ice: str = "bands"):
    """(dx, dy, afac, mm_ext, tm_ext): departure displacements of a random
    velocity field of up to 1 m/s over a one-hour step, and an
    extended category batch (open water in row 0) with ice as `ice` says
    (by default in two polar bands) and a random tracer stack."""
    ny, nx = grid.ny, grid.nx
    device = grid.tmask.device
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    u = t(rng.uniform(-1.0, 1.0, (ny, nx))) * grid.umask
    v = t(rng.uniform(-1.0, 1.0, (ny, nx))) * grid.umask
    dx = -3600.0 * u / grid.dxu
    dy = -3600.0 * v / grid.dyu
    aicen = rng.uniform(0.0, 0.2, (ncat, ny, nx)) * ice_mask(ny, nx, ice) \
        * ((rng.rand(ncat, ny, nx) > 0.2) | (ice != "bands"))
    mm = np.concatenate([np.maximum(1.0 - aicen.sum(0), 0.0)[None], aicen])
    tm = rng.uniform(-2.0, 3.0, (ncat, len(meta), ny, nx)) \
        * (aicen[:, None] > 0)
    tm[:, :2] = np.abs(tm[:, :2])
    tm = np.concatenate([np.zeros_like(tm[:1]), tm])
    return dx, dy, grid.dxu * grid.dyu, t(mm), t(tm)


# ---------------------------------------------------------------------------
# grid files in the reference's layouts (for the loaders)
# ---------------------------------------------------------------------------


def grid_records(grid) -> dict:
    """The records a POP grid file holds, from a port Grid, as float64
    numpy arrays: ULAT and ULON (rad), HTN and HTE (cm), ANGLE (rad)."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    return dict(ulat=host(grid.ulat), ulon=host(grid.ulon),
                htn=host(grid.htn) / cn.cm_to_m,
                hte=host(grid.hte) / cn.cm_to_m, angle=host(grid.angle))


def _pop_records(rec):
    """The 7 records of a POP binary grid: HUS and HUW (not read by the
    loaders) stand in as HTE and HTN."""
    return [rec["ulat"], rec["ulon"], rec["htn"], rec["hte"], rec["hte"],
            rec["htn"], rec["angle"]]


def write_pop_grid(directory, rec: dict, kmt, fmt: str = "bin"):
    """Write `rec` (:func:`grid_records`) and the land mask `kmt` (ny, nx
    ints) as a POP grid: ``bin``, 7 big-endian float64 records and a
    big-endian int32 KMT file (``popgrid``), or ``nc``, netCDF variables
    ulat, ulon, htn, hte, angle and kmt (``popgrid_nc``).  Returns
    (grid_file, kmt_file)."""
    from pathlib import Path

    directory = Path(directory)
    if fmt == "bin":
        grid_file, kmt_file = directory / "pop.grid", directory / "pop.kmt"
        np.stack(_pop_records(rec)).astype(">f8").tofile(grid_file)
        np.asarray(kmt).astype(">i4").tofile(kmt_file)
        return str(grid_file), str(kmt_file)
    from scipy.io import netcdf_file

    grid_file, kmt_file = directory / "pop_grid.nc", directory / "pop_kmt.nc"
    ny, nx = rec["ulat"].shape
    with netcdf_file(str(grid_file), "w") as f:
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        for name in ("ulat", "ulon", "htn", "hte", "angle"):
            f.createVariable(name, "d", ("nj", "ni"))[:] = rec[name]
    with netcdf_file(str(kmt_file), "w") as f:
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        f.createVariable("kmt", "i", ("nj", "ni"))[:] = np.asarray(kmt)
    return str(grid_file), str(kmt_file)


def write_panarctic_grid(path, rec: dict, kmt) -> str:
    """Write `rec` and `kmt` as a pan-Arctic grid file (``panarctic_grid``):
    8 big-endian float64 records, KMT first.  Returns the path."""
    np.stack([np.asarray(kmt, dtype=np.float64)]
             + _pop_records(rec)).astype(">f8").tofile(path)
    return str(path)


# ---------------------------------------------------------------------------
# forcing files and coupler fields
# ---------------------------------------------------------------------------

# (low, high) of the seeded values of each file field (`_smooth`); they cover
# the clamps of prepare_forcing (cloud fraction outside [0, 1], negative
# precipitation and shortwave), humidities above saturation (Qa_fixLY)
# and air temperatures on both sides of freezing (the rain/snow split)
FORCING_RANGES = {
    "swdn": (-20.0, 300.0), "cldf": (-0.1, 1.1), "prec": (-5.0, 100.0),
    "u_10": (-8.0, 8.0), "v_10": (-8.0, 8.0), "t_10": (240.0, 280.0),
    "q_10": (1.0e-4, 4.0e-3), "dn10": (1.2, 1.4), "tair": (240.0, 280.0),
    "qa": (1.0e-4, 4.0e-3), "strax": (-0.1, 0.1), "stray": (-0.1, 0.1),
    "wind": (0.0, 12.0), "sol": (-20.0, 300.0), "flo": (150.0, 320.0),
    "ucmp": (-8.0, 8.0), "vcmp": (-8.0, 8.0), "rhoa": (1.2, 1.4),
    "rain": (-1.0e-6, 5.0e-5), "snow": (-1.0e-6, 5.0e-5),
    "fsw": (-20.0, 300.0), "flw": (150.0, 320.0),
    "sss": (30.0, 36.0), "sst": (-2.0, 5.0),
}
# precipitation of the datasets that read it in mm/s
PREC_MM_PER_SEC = (-1.0e-6, 5.0e-5)
# the columns of the rct dataset (hourly Barrow met, one point)
RCT_RANGES = {"Tair": (240.0, 280.0), "Uatm": (-10.0, 10.0),
              "Vatm": (-10.0, 10.0), "fsw": (-20.0, 300.0),
              "rh": (60.0, 100.0)}


def _uniform(rng, name, shape, ranges=FORCING_RANGES):
    lo, hi = ranges[name]
    return lo + (hi - lo) * rng.random(shape)


def _smooth(rng, name, shape, ranges=FORCING_RANGES):
    """Seeded (nrec, ny, nx) records over the field's range: per record,
    three plane waves of 1-3 periods across the grid with random phases
    (large-scale weather, so that winds and stresses drive a plausible
    drift), plus 10% of white noise."""
    nrec, ny, nx = shape
    lo, hi = ranges[name]
    k = rng.integers(1, 4, size=(2, nrec, 3, 1, 1))
    phase = rng.uniform(0.0, 2.0 * np.pi, (nrec, 3, 1, 1))
    y = np.arange(ny)[:, None] / ny
    x = np.arange(nx)[None, :] / nx
    waves = np.sin(2.0 * np.pi * (k[0] * x + k[1] * y) + phase).sum(1)
    unit = 0.9 * (waves + 3.0) / 6.0 + 0.1 * rng.random(shape)
    return lo + (hi - lo) * unit


def write_forcing_files(directory, dataset: str, ny: int, nx: int, *,
                        years=(1997,), seed: int = 0, records_6h: int = 1460,
                        records_hour: int = 48) -> list:
    """Seeded files of an atmosphere dataset of
    ``io.forcing_data._ATM_DATASETS`` (``"bin"`` is ``"ncar"``), or of the
    ocean climatology (``"ocean"``: ``sss``/``sst`` with 12 records), in
    the reference's layout (each dataset's ``LAYOUT``) under `directory`,
    as the readers read them: big-endian float64 records of the whole
    grid, or netCDF (hadgem; rct's columns).  Yearly files for each of
    `years`; the 6-hourly ones hold the first `records_6h` records (1460
    a year).  Returns the paths written."""
    import os

    from cice4_tpu_torch.io import forcing_data as fd

    rng = np.random.default_rng(seed)
    out = []

    def rda8(path, records):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.asarray(records, ">f8").tofile(path)
        out.append(path)

    def nc(path, dims, variables):
        from scipy.io import netcdf_file
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with netcdf_file(path, "w") as f:
            for name, size in dims:
                f.createDimension(name, size)
            for var, data in variables.items():
                f.createVariable(var, "d", tuple(n for n, _ in dims))[:] = \
                    data
        out.append(path)

    if dataset == "ocean":
        for stem in ("sss", "sst"):
            rda8(os.path.join(directory, f"{stem}.mm.{nx}x{ny}.da"),
                 _smooth(rng, stem, (12, ny, nx)))
        return out
    if dataset == "rct":
        for fname, names in ((fd.RctForcing.MET_FILE, ("Tair", "Uatm",
                                                       "Vatm")),
                             (fd.RctForcing.SOLAR_FILE, ("fsw",)),
                             (fd.RctForcing.RH_FILE, ("rh",))):
            nc(os.path.join(directory, fname),
               (("time", records_hour), ("ni", 1)),
               {n: _uniform(rng, n, (records_hour, 1), RCT_RANGES)
                for n in names})
        return out
    cls = fd._ATM_DATASETS[dataset]
    if dataset == "hadgem":
        for name, (var, _stem) in cls.NC_FIELDS.items():
            for year in years:
                nc(os.path.join(directory,
                                cls.LAYOUT[name][1].format(year=year)),
                   (("time", 12), ("nj", ny), ("ni", nx)),
                   {var: _smooth(rng, name, (12, ny, nx))})
        return out
    mm_per_sec = dataset in ("LYq", "monthly")
    for name, (cadence, tmpl) in cls.LAYOUT.items():
        nrec = {"6h": records_6h, "day": 365}.get(cadence, 12)
        ranges = {**FORCING_RANGES, "prec": PREC_MM_PER_SEC} if mm_per_sec \
            else FORCING_RANGES
        for year in (years if "{year}" in tmpl else years[:1]):
            rda8(os.path.join(directory, tmpl.format(year=year)),
                 _smooth(rng, name, (nrec, ny, nx), ranges))
    return out


def coupler_fields(names, ny: int, nx: int, seed: int, *, device,
                   dtype=torch.float64) -> dict:
    """Seeded import fields of the ACCESS coupling (`names` from
    ``coupling.A2I_FIELDS``/``O2I_FIELDS`` or
    ``coupling_cm.a2i_cm_fields``): large-scale patterns (`_smooth`) over
    ranges around the values of the JAX package's coupled tests
    (``tests/test_coupling.py:144-270``: warm moist air, a 6 m/s wind, a
    resting ocean at 1 C).  The ocean currents stay within 0.05 m/s: the
    synthetic lat-lon grid of ``access_om_config`` narrows to 640 m near
    its top row at 0.25 degree, which 0.2 m/s crosses in an hour (the
    remap's CFL limit).  Unknown names are 0."""
    rng = np.random.default_rng(seed)
    ranges = {
        "tair_i": (262.0, 282.0), "qair_i": (1.0e-3, 4.0e-3),
        "lwfld_i": (250.0, 320.0), "swfld_i": (50.0, 150.0),
        "uwnd_i": (2.0, 10.0), "vwnd_i": (-6.0, 2.0),
        "press_i": (1.0e5, 1.026e5), "rain_i": (0.0, 2.0e-5),
        "snow_i": (0.0, 2.0e-5), "runof_i": (0.0, 1.0e-4),
        "sst_i": (-1.8, 2.0), "sss_i": (33.0, 35.0),
        "ssu_i": (-0.05, 0.05), "ssv_i": (-0.05, 0.05),
        "sslx_i": (-1.0e-7, 1.0e-7), "ssly_i": (-1.0e-7, 1.0e-7),
        "pfmice_i": (-20.0, 5.0), "lhflx_i": (-20.0, 0.0),
        "taux_i": (-0.1, 0.2), "tauy_i": (-0.15, 0.15),
    }
    out = {}
    for name in names:
        if name.startswith("tmlt"):
            lo, hi = -5.0, 5.0
        elif name.startswith("bmlt"):
            lo, hi = -3.0, 1.0
        else:
            lo, hi = ranges.get(name, (0.0, 0.0))
        v = _smooth(rng, "field", (1, ny, nx), {"field": (lo, hi)})[0]
        out[name] = torch.from_numpy(v).to(device=device, dtype=dtype)
    return out


# The GFDL column kernel (csrc/gfdl_column.cu) against
# gfdl_flux._gfdl_ocean_fluxes_plain, per output: the relative 2-norm gap
# ||k - p|| / ||p|| within GFDL_RTOL, and no point beyond GFDL_POINT_RTOL
# of (|p| + 1e-6 max|p|).  On the card the kernel follows the plain
# operations, so the gaps are rounding; a Newton exit flipped by an ulp
# moves a point by at most MO_ERROR's share.
GFDL_RTOL = {torch.float32: 1.0e-5, torch.float64: 1.0e-12}
GFDL_POINT_RTOL = 1.0e-3


def gfdl_inputs(ny: int, nx: int, seed: int, *, device, dtype=torch.float64,
                celsius: bool = True) -> dict:
    """Seeded winter inputs of `gfdl_ocean_fluxes` over an (ny, nx) plane
    with continents (30% of the cells, and 2% of the rest at random):
    cold air over open water, and warm air over cold
    water in calm spells (the stable branch, and Richardson numbers past
    the critical one); large-scale patterns (`_smooth`) with 5% of the
    cells near calm and 5% with a zero lagged u_star.  The SST in Celsius
    (shifted by the wrapper) or in Kelvin."""
    rng = np.random.default_rng(seed)
    ranges = {"tair": (235.0, 290.0), "qair": (2.0e-4, 6.0e-3),
              "uwnd": (-14.0, 14.0), "vwnd": (-14.0, 14.0),
              "press": (0.97e5, 1.04e5), "sst": (-1.8, 4.0),
              "ssu": (-0.3, 0.3), "ssv": (-0.3, 0.3),
              "u_star_prev": (0.0, 0.8), "land": (0.0, 1.0)}
    f = {k: _smooth(rng, k, (1, ny, nx), ranges)[0] for k in ranges}
    calm = rng.random((ny, nx)) < 0.05
    f["uwnd"] = np.where(calm, 0.02 * f["uwnd"], f["uwnd"])
    f["vwnd"] = np.where(calm, 0.02 * f["vwnd"], f["vwnd"])
    f["u_star_prev"] = np.where(rng.random((ny, nx)) < 0.05, 0.0,
                                f["u_star_prev"])
    if not celsius:
        f["sst"] = f["sst"] + cn.Tffresh
    land = f.pop("land")
    tmask = (land < np.quantile(land, 0.7)) & (rng.random((ny, nx)) > 0.02)
    out = {k: torch.from_numpy(v).to(device=device, dtype=dtype)
           for k, v in f.items()}
    out["tmask"] = torch.from_numpy(tmask).to(device=device)
    return out


def compare_gfdl(kern: dict, plain: dict) -> dict:
    """Per output: the relative 2-norm gap, the largest point gap relative
    to (|p| + 1e-6 max|p|), and finiteness."""
    out = {}
    for k, b in plain.items():
        a = kern[k]
        diff = (a - b).abs()
        norm = float(torch.linalg.vector_norm(b))
        scale = float(b.abs().max()) if b.numel() else 0.0
        den = (b.abs() + 1.0e-6 * scale).clamp(min=torch.finfo(b.dtype).tiny)
        out[k] = dict(
            norm_gap=float(torch.linalg.vector_norm(diff)) / norm
            if norm > 0 else float(diff.max()) if b.numel() else 0.0,
            point_gap=float((diff / den).max()) if b.numel() else 0.0,
            finite=bool(torch.isfinite(a).all()))
    return out


def gfdl_ok(report: dict, dtype) -> bool:
    return all(v["finite"] and v["norm_gap"] <= GFDL_RTOL[dtype]
               and v["point_gap"] <= GFDL_POINT_RTOL
               for v in report.values())


@contextlib.contextmanager
def evp_stress_reads():
    """[forcing, stress x, stress y] of each model step while the block
    runs: the step's forcing and the air stress its EVP reads, to show
    that under ``calc_strair=False`` the EVP takes the forcing's
    prescribed stress."""
    from cice4_tpu_torch import model as M

    seen = []
    step, evp = M.ice_step, M.evp

    def ice_step(model, state, grid, f, *a, **k):
        seen.append([f])
        return step(model, state, grid, f, *a, **k)

    def read_evp(*a, **k):
        seen[-1].extend(a[-2:])
        return evp(*a, **k)
    M.ice_step, M.evp = ice_step, read_evp
    try:
        yield seen
    finally:
        M.ice_step, M.evp = step, evp
