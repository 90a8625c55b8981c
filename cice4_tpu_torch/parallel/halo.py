"""Neighbor access with boundary conditions (the halo-exchange equivalent).

Port of :mod:`cice4_tpu.parallel.halo`.  Fields are dense global
``(..., ny, nx)`` tensors, so "halo logic" is the physical boundary
condition of the global domain edges:

* ``cyclic``   — wraparound (roll is already correct)
* ``closed``   — ghost value 0 (land beyond the edge)
* ``open``     — ghost value 0 at run time, same as closed (only grid
  fields are extrapolated, when the grid is made)
* ``tripole`` / ``tripoleT`` — the Arctic fold; not ported yet
  (ROADMAP queue 2 item 5) and rejected with ``NotImplementedError``.

All functions operate on tensors whose last two axes are ``(y, x)`` and
are shape-preserving.
"""

from __future__ import annotations

import dataclasses

import torch

from cice4_tpu_torch.constants import FieldLoc, FieldType


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Physical boundary condition of the global domain edges."""

    ew: str = "cyclic"   # cyclic | open | closed
    ns: str = "open"     # cyclic | open | closed | tripole | tripoleT


def _zeros_row(f):
    return torch.zeros_like(f[..., -1:, :])


def _zeros_col(f):
    return torch.zeros_like(f[..., :, -1:])


def nbr_e(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j, i+1] with the EW boundary condition applied."""
    s = torch.roll(f, -1, dims=-1)
    if bc.ew == "cyclic":
        return s
    if bc.ew in ("closed", "open"):
        return torch.cat([s[..., :, :-1], _zeros_col(f)], dim=-1)
    raise ValueError(f"unknown ew boundary {bc.ew!r}")


def nbr_w(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j, i-1]."""
    s = torch.roll(f, 1, dims=-1)
    if bc.ew == "cyclic":
        return s
    if bc.ew in ("closed", "open"):
        return torch.cat([_zeros_col(f), s[..., :, 1:]], dim=-1)
    raise ValueError(f"unknown ew boundary {bc.ew!r}")


def nbr_n(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j+1, i] with the NS boundary condition applied."""
    s = torch.roll(f, -1, dims=-2)
    if bc.ns == "cyclic":
        return s
    if bc.ns in ("closed", "open"):
        return torch.cat([s[..., :-1, :], _zeros_row(f)], dim=-2)
    if bc.ns in ("tripole", "tripoleT"):
        raise NotImplementedError(
            "tripole fold ghost rows are not ported yet "
            "(ROADMAP queue 2 item 5)")
    raise ValueError(f"unknown ns boundary {bc.ns!r}")


def nbr_s(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j-1, i].  The southern edge of every supported grid
    is effectively closed (Antarctica for global grids): ghost is 0 for
    `closed`/`open`/`tripole*`, wrapped for `cyclic`."""
    s = torch.roll(f, 1, dims=-2)
    if bc.ns == "cyclic":
        return s
    if bc.ns not in ("closed", "open", "tripole", "tripoleT"):
        raise ValueError(f"unknown ns boundary {bc.ns!r}")
    return torch.cat([_zeros_row(f), s[..., 1:, :]], dim=-2)


def nbr_ne(f, bc, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    return nbr_n(nbr_e(f, bc, loc, ftype), bc, loc, ftype)


def nbr_nw(f, bc, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    return nbr_n(nbr_w(f, bc, loc, ftype), bc, loc, ftype)


def nbr_se(f, bc, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    return nbr_s(nbr_e(f, bc, loc, ftype), bc, loc, ftype)


def nbr_sw(f, bc, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    return nbr_s(nbr_w(f, bc, loc, ftype), bc, loc, ftype)
