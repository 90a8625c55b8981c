"""Seeded inputs and the kernel-versus-plain comparison of the Newton
temperature solve, shared by ``chip_smoke.py`` and the GPU tests.

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
