"""Neighbor access with boundary conditions (the halo-exchange equivalent).

Frozen copy of the port's halo module, for one domain.  Fields are dense global
``(..., ny, nx)`` tensors, so "halo logic" is the physical boundary
condition of the global domain edges:

* ``cyclic``   — wraparound (roll is already correct)
* ``closed``   — ghost value 0 (land beyond the edge)
* ``open``     — ghost value 0 at run time, same as closed (only grid
  fields are extrapolated, when the grid is made)
* ``tripole``  — the Arctic fold across the top row (U-fold), with index
  reversal and a sign flip for vector/angle fields
* ``tripoleT`` — the T-fold variant

All functions operate on tensors whose last two axes are ``(y, x)`` and
are shape-preserving.

One domain, no blocks: :func:`global_sum` and :func:`global_all` are the
identity and ``bool(x.all())``.
"""

from __future__ import annotations

import dataclasses

import torch

from reference.constants import FieldLoc, FieldType


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Physical boundary condition of the global domain edges."""

    ew: str = "cyclic"   # cyclic | open | closed
    ns: str = "open"     # cyclic | open | closed | tripole | tripoleT


FOLDS = ("tripole", "tripoleT")


def _zeros_row(f):
    return torch.zeros_like(f[..., -1:, :])


def _tripole_ghost_north(f, bc_ns, loc, ftype):
    """Ghost row north of the top physical row for a tripole fold.

    For the U-fold grid (``tripole``) the top row of U points lies on
    the fold; the grid point north of T cell (ny-1, i) is T cell
    (ny-1, nx-1-i) viewed upside-down.  Vector components flip sign.
    Index maps (``mpi/ice_boundary.F90`` tripole unpacking):

    * center:    ghost(i) = s * f[ny-1, nx-1-i]
    * NE corner: ghost(i) = s * f[ny-2, (nx-2-i) mod nx]   (U-fold)
    * N face:    ghost(i) = s * f[ny-2, nx-1-i]
    * E face:    ghost(i) = s * f[ny-1, (nx-2-i) mod nx]

    For the T-fold grid (``tripoleT``) the rows swap: center and E face
    read row ny-2, NE corner and N face row ny-1.
    """
    nx = f.shape[-1]
    rev = torch.arange(nx - 1, -1, -1, device=f.device)   # nx-1-i
    rev_u = torch.remainder(rev - 1, nx)                   # (nx-2-i) mod nx
    top_row = {FieldLoc.CENTER: -1, FieldLoc.NE_CORNER: -2,
               FieldLoc.N_FACE: -2, FieldLoc.E_FACE: -1}[loc]
    if bc_ns == "tripoleT":
        top_row = -3 - top_row       # -1 <-> -2
    cols = rev_u if loc in (FieldLoc.NE_CORNER, FieldLoc.E_FACE) else rev
    row = f[..., top_row, :][..., cols]
    if ftype in (FieldType.VECTOR, FieldType.ANGLE):
        row = -row
    return row[..., None, :]


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
    if bc.ns in FOLDS:
        ghost = _tripole_ghost_north(f, bc.ns, loc, ftype)
        return torch.cat([s[..., :-1, :], ghost], dim=-2)
    raise ValueError(f"unknown ns boundary {bc.ns!r}")


def nbr_s(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j-1, i].  The southern edge of every supported grid
    is effectively closed (Antarctica for global grids): ghost is 0 for
    `closed`/`open`/`tripole*`, wrapped for `cyclic`."""
    s = torch.roll(f, 1, dims=-2)
    if bc.ns == "cyclic":
        return s
    if bc.ns not in ("closed", "open") + FOLDS:
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


# 180-degree corner pairing of the str8 flux pieces under the tripole
# fold: u pieces (ne, nw, se, sw) -> (sw, se, nw, ne), same for v
_STR8_PAIR = (3, 2, 1, 0, 7, 6, 5, 4)


class Nbr:
    """The shifts of one boundary condition as methods: the interface the
    EVP and remap operators are written against (port of the JAX
    package's `evp.JnpNbr`, with its str8 north shifts `n_str` and
    `ne_str`, and `remap.JnpShift`)."""

    __slots__ = ("bc",)

    def __init__(self, bc: BoundaryConditions):
        self.bc = bc

    def e(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return nbr_e(f, self.bc, loc, ftype)

    def w(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return nbr_w(f, self.bc, loc, ftype)

    def n(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return nbr_n(f, self.bc, loc, ftype)

    def s(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return nbr_s(f, self.bc, loc, ftype)

    def ne(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return nbr_ne(f, self.bc, loc, ftype)

    # -- north shifts of the str8 momentum-flux planes ------------------
    # Under the tripole fold the 8 flux combinations are not scalars: the
    # cell beyond the fold is the 180-degree-rotated physical cell, so its
    # ne/nw/se/sw corner pieces are the sw/se/nw/ne pieces of the mirror
    # cell with the sign flipped.  Other boundaries take the plain shifts.

    def _str8_ghost(self, str8, k, ne_shift):
        nx = str8.shape[-1]
        idx = torch.arange(nx - 1, -1, -1, device=str8.device)  # nx-1-i
        if ne_shift:     # ghost(i) = -pair[src_row, (nx-2-i) mod nx]
            idx = torch.remainder(idx - 1, nx)
        src_row = -1 if self.bc.ns == "tripole" else -2
        row = -str8[_STR8_PAIR[k]][..., src_row, :][..., idx]
        return row[..., None, :]

    def n_str(self, str8, k):
        """str8[k] shifted north: out[j, i] = str8[k][j+1, i]."""
        if self.bc.ns not in FOLDS:
            return self.n(str8[k])
        s = torch.roll(str8[k], -1, dims=-2)
        return torch.cat([s[..., :-1, :], self._str8_ghost(str8, k, False)],
                         dim=-2)

    def ne_str(self, str8, k):
        """str8[k] shifted north-east; under a fold the east shift wraps
        whatever the EW boundary, as the JAX package's does."""
        if self.bc.ns not in FOLDS:
            return self.ne(str8[k])
        s = torch.roll(torch.roll(str8[k], -1, dims=-1), -1, dims=-2)
        return torch.cat([s[..., :-1, :], self._str8_ghost(str8, k, True)],
                         dim=-2)


# ---------------------------------------------------------------------------
# reductions (one domain)
# ---------------------------------------------------------------------------


def global_sum(t):
    """The sum of `t` over the domain's one block: `t` itself."""
    return t


def global_all(t) -> bool:
    """Whether `t` holds everywhere."""
    return bool(t.all())
