"""In-step conservation guards: abort-with-coordinates.

Port of :mod:`cice4_tpu.guards` (the reference's
``conservation_check_vthermo``, ``column_conservation_check`` and
``ridge_check`` aborts).  Each check computes, on the device, the
violation count and the worst cell's (j, i), and packs them into a
small record that rides the step's flux dict (``fluxes["_guards"]``).
Building a record does not synchronise with the device;
:func:`raise_on_violation` reads the records on the host and raises
:class:`ConservationError` with the cell coordinates.
"""

from __future__ import annotations

import torch

from cice4_tpu_torch import constants as cn


class ConservationError(RuntimeError):
    """An always-on model invariant was violated (abort_ice)."""


def _is_f64(dtype) -> bool:
    return torch.finfo(dtype).bits >= 64


def record(bad, err=None):
    """Pack a violation record: (count, j, i, worst-error).

    bad: boolean field with trailing (ny, nx) axes (leading axes are
    reduced with `any`); err: optional same-shape magnitude used to
    pick and report the worst cell.
    """
    if err is None:
        err = bad.to(torch.float32)
    while bad.ndim > 2:
        bad = bad.any(dim=0)
        err = err.amax(dim=0)
    nx = bad.shape[-1]
    masked = torch.where(bad, err, -torch.inf)
    flat = torch.argmax(masked)
    return dict(count=bad.sum(), j=flat // nx, i=flat % nx,
                worst=masked.reshape(-1)[flat])


def raise_on_violation(guards: dict):
    """Host-side: raise ConservationError if any packed record fired.

    `guards` is the `fluxes["_guards"]` dict of name -> record; reading
    it synchronises with the device.
    """
    for name, rec in guards.items():
        if int(rec["count"]) > 0:
            raise ConservationError(
                f"{name}: {int(rec['count'])} cells violate; worst at "
                f"(j={int(rec['j'])}, i={int(rec['i'])}) "
                f"err={float(rec['worst']):.6e}")


def vthermo_tolerance(dtype) -> float:
    """Energy-flux error tolerance (W/m^2).  The reference's ferrmax
    (1e-3, ``ice_therm_vertical.F90:86``) assumes float64; in float32
    the einit/efinal difference alone carries O(eps * h * qi / dt)
    ~ 0.03 W/m^2 of representation noise, so the abort threshold is
    lifted well above it (real conservation bugs are O(10+))."""
    return 1.0e-3 if _is_f64(dtype) else 0.5


def check_vthermo(dt, fsurfn, flatn, fswint, fhocnn, fsnow,
                  einit, efinal, has_ice):
    """``conservation_check_vthermo:4511-4613``: the per-category
    column energy change must equal the net flux into the column.
    (fsurf - flat excludes latent heat: the energy lost by the ice is
    gained by the vapor.)  Returns a violation record."""
    einp = (fsurfn - flatn + fswint - fhocnn - fsnow * cn.Lfresh) * dt
    ferr = torch.abs(efinal - einit - einp) / dt
    bad = has_ice & (ferr > vthermo_tolerance(ferr.dtype))
    return record(bad, ferr)


def check_column_conservation(before, after, tmask):
    """``column_conservation_check:1409-1473``: a column total (e.g.
    sum of vicen over categories) must be unchanged by an ITD
    operation, to relative puny.  Returns a violation record."""
    eps = 1.0e-11 if _is_f64(before.dtype) else 1.0e-6
    err = torch.abs(after - before)
    bad = tmask & (err > eps * torch.maximum(torch.abs(before),
                                             torch.abs(after)))
    return record(bad, err)


def check_ridge(asum, tmask, done: bool):
    """``ridge_check:1788-1842``: after the ridging iteration the
    area fractions must sum to 1.  Returns a violation record."""
    eps = 1.0e-10 if _is_f64(asum.dtype) else 1.0e-5
    err = torch.abs(asum - 1.0)
    bad = tmask & (err > eps) & (not done)
    return record(bad, err)
