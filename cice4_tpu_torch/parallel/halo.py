"""Neighbor access with boundary conditions (the halo-exchange equivalent).

Port of :mod:`cice4_tpu.parallel.halo`.  Fields are dense global
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

On a decomposed grid (:mod:`cice4_tpu_torch.parallel.mesh`) a block's
grid carries a :class:`BlockBC` in place of the global
:class:`BoundaryConditions`, and the same functions fill the strip a
shift needs from the neighbouring block by exchange (the tripole fold
from the top rows of the top mesh row), so that every stencil written
against them runs unchanged on a block, with the global result (and
``Nbr(block_bc)`` is the block's shift provider): the torch counterpart
of what GSPMD does to each ``jnp.roll``.  The k-halo
paths exchange H-wide ghost rings of padded blocks at once
(:func:`exchange_padded`, port of ``cice4_tpu/ops/evp_sharded.py``
`_exchange` and `_exchange_batch`).  :func:`global_sum` and
:func:`global_all` reduce over the blocks; outside a decomposed run
they are the identity and ``bool(x.all())``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from cice4_tpu_torch.constants import FieldLoc, FieldType
from cice4_tpu_torch.parallel import mesh as _mesh


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Physical boundary condition of the global domain edges."""

    ew: str = "cyclic"   # cyclic | open | closed
    ns: str = "open"     # cyclic | open | closed | tripole | tripoleT


# a boundary as the CUDA kernels take it (the folds only north-south)
KERNEL_BC_CODE = {"cyclic": 0, "open": 1, "closed": 1, "tripole": 2,
                  "tripoleT": 3}
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
    if isinstance(bc, BlockBC):
        return _block_shift(f, bc, "e", loc, ftype)
    s = torch.roll(f, -1, dims=-1)
    if bc.ew == "cyclic":
        return s
    if bc.ew in ("closed", "open"):
        return torch.cat([s[..., :, :-1], _zeros_col(f)], dim=-1)
    raise ValueError(f"unknown ew boundary {bc.ew!r}")


def nbr_w(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j, i-1]."""
    if isinstance(bc, BlockBC):
        return _block_shift(f, bc, "w", loc, ftype)
    s = torch.roll(f, 1, dims=-1)
    if bc.ew == "cyclic":
        return s
    if bc.ew in ("closed", "open"):
        return torch.cat([_zeros_col(f), s[..., :, 1:]], dim=-1)
    raise ValueError(f"unknown ew boundary {bc.ew!r}")


def nbr_n(f, bc: BoundaryConditions, loc=FieldLoc.CENTER,
          ftype=FieldType.SCALAR):
    """out[j, i] = f[j+1, i] with the NS boundary condition applied."""
    if isinstance(bc, BlockBC):
        return _block_shift(f, bc, "n", loc, ftype)
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
    if isinstance(bc, BlockBC):
        return _block_shift(f, bc, "s", loc, ftype)
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
        if isinstance(self.bc, BlockBC):
            raise NotImplementedError(
                "the str8 fold of a block: the EVP subcycle of a decomposed "
                "grid runs on padded blocks (ops/evp_sharded.py)")
        if self.bc.ns not in FOLDS:
            return self.n(str8[k])
        s = torch.roll(str8[k], -1, dims=-2)
        return torch.cat([s[..., :-1, :], self._str8_ghost(str8, k, False)],
                         dim=-2)

    def ne_str(self, str8, k):
        """str8[k] shifted north-east; under a fold the east shift wraps
        whatever the EW boundary, as the JAX package's does."""
        if isinstance(self.bc, BlockBC):
            raise NotImplementedError(
                "the str8 fold of a block: the EVP subcycle of a decomposed "
                "grid runs on padded blocks (ops/evp_sharded.py)")
        if self.bc.ns not in FOLDS:
            return self.ne(str8[k])
        s = torch.roll(torch.roll(str8[k], -1, dims=-1), -1, dims=-2)
        return torch.cat([s[..., :-1, :], self._str8_ghost(str8, k, True)],
                         dim=-2)


# ---------------------------------------------------------------------------
# decomposed grids: the boundary of a block, its shifts, the k-halo exchange
# ---------------------------------------------------------------------------


class BlockBC:
    """The boundary of one block of a decomposed grid: the global domain's
    boundary conditions (`ew`, `ns`, as :class:`BoundaryConditions`) and
    where the block lies.  A grid holding one in place of its `bc` is a
    block grid: its shifts exchange with the neighbouring blocks.
    `global_grid` is the undecomposed grid, for the gathered phases, or a
    function that makes it when a gathered phase first asks for it."""

    def __init__(self, bc: BoundaryConditions, mesh, block: int, ny: int,
                 nx: int, global_grid=None):
        self.bc, self.ew, self.ns = bc, bc.ew, bc.ns
        self.mesh, self.block = mesh, block
        self.ny, self.nx = ny, nx                      # the global grid's
        sy, sx = mesh.block_slices(block, ny, nx)
        self.y0, self.x0 = sy.start, sx.start
        self.by, self.bx = sy.stop - sy.start, sx.stop - sx.start
        self.yi, self.xi = mesh.coords(block)
        self._global_grid = global_grid

    @property
    def global_grid(self):
        if callable(self._global_grid):
            self._global_grid = self._global_grid()
        return self._global_grid

    @property
    def north_edge(self) -> bool:
        return self.yi == self.mesh.py - 1

    def core(self, t):
        """The block's part of a global tensor."""
        return t[..., self.y0:self.y0 + self.by, self.x0:self.x0 + self.bx]

    def __repr__(self):
        return (f"BlockBC(ew={self.ew!r}, ns={self.ns!r}, block {self.block}"
                f" at ({self.yi}, {self.xi}) of {self.mesh.shape})")


def _wire(f):
    return f.to(torch.uint8) if f.dtype == torch.bool else f


def _unwire(f, dtype):
    return f.to(torch.bool) if dtype == torch.bool else f


def _block_shift(f, bcb: BlockBC, d: str, loc, ftype):
    """The shift `d` (e, w, n, s) of a block's field: the strip beyond the
    block's edge comes from the neighbouring block (or is the global
    boundary's: a wrap, zeros, or the tripole fold of the global top
    row).  Every block of the mesh calls it together."""
    mesh = bcb.mesh
    py, px = mesh.shape
    yi, xi = bcb.yi, bcb.xi
    dtype = f.dtype
    g = _wire(f)
    if d in ("e", "w"):
        cyc = bcb.ew == "cyclic"
        east = mesh.block_at(yi, (xi + 1) % px)
        west = mesh.block_at(yi, (xi - 1) % px)
        has_e, has_w = cyc or xi < px - 1, cyc or xi > 0
        col = g[..., :, :1] if d == "e" else g[..., :, -1:]
        to, frm, has_to, has_frm = ((west, east, has_w, has_e) if d == "e"
                                    else (east, west, has_e, has_w))
        got = mesh.transfer([(to, d, col)] if has_to else [],
                            [(frm, d, col.shape)] if has_frm else [], g)
        ghost = got[0] if has_frm else torch.zeros_like(col)
        out = (torch.cat([g[..., :, 1:], ghost], dim=-1) if d == "e"
               else torch.cat([ghost, g[..., :, :-1]], dim=-1))
        return _unwire(out, dtype)
    cyc = bcb.ns == "cyclic"
    north = mesh.block_at((yi + 1) % py, xi)
    south = mesh.block_at((yi - 1) % py, xi)
    has_n, has_s = cyc or yi < py - 1, cyc or yi > 0
    row = g[..., :1, :] if d == "n" else g[..., -1:, :]
    to, frm, has_to, has_frm = ((south, north, has_s, has_n) if d == "n"
                                else (north, south, has_n, has_s))
    sends = [(to, d, row)] if has_to else []
    recvs = [(frm, d, row.shape)] if has_frm else []
    fold = d == "n" and bcb.ns in FOLDS and yi == py - 1
    if fold:
        # the fold's ghost row is made from the global top two rows, put
        # together from the top row of blocks
        if bcb.by < 2:
            raise ValueError("the tripole fold needs blocks of two rows")
        top = [mesh.block_at(py - 1, k) for k in range(px)]
        sends += [(b, "fold", g[..., -2:, :]) for b in top]
        recvs += [(b, "fold", g[..., -2:, :].shape) for b in top]
    got = mesh.transfer(sends, recvs, g)
    if fold:
        rows = torch.cat(got[-px:], dim=-1)
        ghost = _tripole_ghost_north(rows, bcb.ns, loc, ftype)[
            ..., bcb.x0:bcb.x0 + bcb.bx]
    elif has_frm:
        ghost = got[0]
    else:
        ghost = torch.zeros_like(row)
    out = (torch.cat([g[..., 1:, :], ghost], dim=-2) if d == "n"
           else torch.cat([ghost, g[..., :-1, :]], dim=-2))
    return _unwire(out, dtype)


def exchange_padded(a, H: int, bcb: BlockBC, fold_specs=None):
    """Refresh the four H-wide ghost bands of the padded block stack `a`
    (P, by + 2H, bx + 2H) from the neighbouring blocks; returns a new
    tensor (port of `_exchange` and `_exchange_batch`,
    ``cice4_tpu/ops/evp_sharded.py:75-180``).

    Two phases: x-strips of the core rows, then full-width y-strips
    (corners ride the second).  Non-cyclic global edges zero their
    ghosts.  `fold_specs` = (src, is_center, sign), one entry per plane,
    fills the north ghosts of the top mesh row with the tripole U-fold
    from the x-mirrored block: ghost plane p is source plane src[p] with
    the centre (T) or NE-corner (U) row map and the sign.  The NE-corner
    map's one wrapped column lands in the outermost ghost ring, which the
    shrinking-halo schedules never read."""
    mesh = bcb.mesh
    py, px = mesh.shape
    yi, xi = bcb.yi, bcb.xi
    a = a.clone()
    # -- x phase -----------------------------------------------------------
    cyc = bcb.ew == "cyclic"
    east = mesh.block_at(yi, (xi + 1) % px)
    west = mesh.block_at(yi, (xi - 1) % px)
    has_e, has_w = cyc or xi < px - 1, cyc or xi > 0
    strip = a[..., H:-H, H:2 * H].shape
    sends, recvs = [], []
    if has_e:
        sends.append((east, "x+", a[..., H:-H, -2 * H:-H]))
        recvs.append((east, "x-", strip))
    if has_w:
        sends.append((west, "x-", a[..., H:-H, H:2 * H]))
        recvs.append((west, "x+", strip))
    got = mesh.transfer(sends, recvs, a)
    if has_e:
        a[..., H:-H, -H:] = got[0]
    if has_w:
        a[..., H:-H, :H] = got[-1]
    if not cyc and xi == 0:
        a[..., :, :H] = 0.0
    if not cyc and xi == px - 1:
        a[..., :, -H:] = 0.0
    # -- y phase -----------------------------------------------------------
    cyc = bcb.ns == "cyclic"
    north = mesh.block_at((yi + 1) % py, xi)
    south = mesh.block_at((yi - 1) % py, xi)
    has_n, has_s = cyc or yi < py - 1, cyc or yi > 0
    strip = a[..., H:2 * H, :].shape
    sends, recvs = [], []
    if has_n:
        sends.append((north, "y+", a[..., -2 * H:-H, :]))
        recvs.append((north, "y-", strip))
    if has_s:
        sends.append((south, "y-", a[..., H:2 * H, :]))
        recvs.append((south, "y+", strip))
    got = mesh.transfer(sends, recvs, a)
    if has_n:
        a[..., -H:, :] = got[0]
    if has_s:
        a[..., :H, :] = got[-1]
    if not cyc and yi == 0:
        a[..., :H, :] = 0.0
    if not cyc and yi == py - 1:
        a[..., -H:, :] = 0.0
    if fold_specs is None:
        return a
    # -- the tripole fold: the top mesh row swaps slabs with its mirror ---
    top = yi == py - 1
    by = a.shape[-2] - 2 * H
    mirror = mesh.block_at(py - 1, px - 1 - xi)
    slab = a[..., by - 1:by + H, :]        # the top H + 1 core rows
    got = mesh.transfer([(mirror, "fold", slab)] if top else [],
                        [(mirror, "fold", slab.shape)] if top else [], a)
    if not top:
        return a
    slab = got[0]
    g = torch.arange(H, device=a.device)
    center_rows = torch.flip(slab[..., H - g, :], dims=(-1,))
    nec_rows = torch.roll(torch.flip(slab[..., H - 1 - g, :], dims=(-1,)),
                          -1, dims=-1)
    srci, isc, sgn = _fold_laws(fold_specs, a.device, a.dtype)
    a[..., -H:, :] = sgn * torch.where(isc, center_rows[srci],
                                       nec_rows[srci])
    return a


_FOLD_LAWS = {}


def _fold_laws(fold_specs, device, dtype):
    """The per-plane fold laws of `fold_specs` as tensors on `device`,
    made once: lists copied to the card at each exchange would wait for
    the card each time."""
    src, is_center, sign = fold_specs
    key = (tuple(src), tuple(is_center), tuple(sign), str(device), dtype)
    if key not in _FOLD_LAWS:
        _FOLD_LAWS[key] = (
            torch.as_tensor(src, device=device),
            torch.as_tensor(is_center, device=device)[:, None, None],
            torch.as_tensor(sign, dtype=dtype, device=device)[:, None, None])
    return _FOLD_LAWS[key]


# ---------------------------------------------------------------------------
# reductions over the blocks, and the gathered phases
# ---------------------------------------------------------------------------


def global_sum(t):
    """The sum of `t` over the blocks of the running decomposition, in
    block order (`t` itself outside one)."""
    cur = _mesh.current_block()
    if cur is None:
        return t
    parts = cur[0].allgather_blocks(t)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def global_max(t):
    """The maximum of the 0-d `t` over the blocks of the running
    decomposition (`t` itself outside one)."""
    cur = _mesh.current_block()
    if cur is None:
        return t
    return torch.stack(cur[0].allgather_blocks(t)).amax(0)


def global_all(t) -> bool:
    """Whether `t` holds everywhere on every block (a host decision that
    every block of a decomposition takes alike)."""
    cur = _mesh.current_block()
    if cur is None:
        return bool(t.all())
    parts = cur[0].allgather_blocks(t.all().reshape(1).to(torch.uint8))
    return bool(torch.stack(parts).all())


def gather_field(t, mesh):
    """The global field from every block's `t` (bool kept bool), on every
    block of `mesh`."""
    return _unwire(mesh.allgather_field(_wire(t)), t.dtype)


_count_lock = threading.Lock()


@contextlib.contextmanager
def gathered_phase(name: str):
    """A phase that a block runs on the global inputs (the gathered
    path, where a redundant ghost computation is not exact or not
    written): the block's thread leaves its decomposition meanwhile, so
    the reductions inside are the one-device ones.  Counted per block
    and phase in ``gathered_phase.count`` and ``gathered_phase.names``."""
    with _count_lock:
        gathered_phase.count += 1
        gathered_phase.names[name] = gathered_phase.names.get(name, 0) + 1
    ctx = getattr(_mesh._tls, "ctx", None)
    _mesh._tls.ctx = None
    try:
        yield
    finally:
        _mesh._tls.ctx = ctx


gathered_phase.count = 0
gathered_phase.names = {}
