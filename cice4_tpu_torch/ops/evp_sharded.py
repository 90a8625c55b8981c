"""The EVP subcycles of a decomposed grid: k-wide halos, one exchange per
k subcycles.

Port of :mod:`cice4_tpu.ops.evp_sharded`.  The reference exchanges the
velocity halos after every one of the ndte subcycles
(``ice_dyn_evp.F90:397-402``).  Here each block pads its fields with an
H-wide ghost ring, one exchange refreshes the ring, and H-1 subcycles
run back to back: each subcycle's 3x3 stencil consumes one ring, so the
core stays exact.  The rounds are ``(ndte-1)//(H-1)`` full ones and the
remainder, then an exchange and the final subcycle with the ridging
diagnostics.  The per-subcycle arithmetic is the one-device path's, on
the padded block with plain rolls (JAX's `PadNbr`: here the `Nbr` of the
doubly cyclic boundary that the padded geometry carries; the roll's
wrap only reaches the outermost ring, which the shrinking schedule
never reads).

On the card each round goes through the round kernel
(:func:`cice4_tpu_torch.ops.evp_cuda.evp_rounds`, ``csrc/evp_rounds.cu``):
tiles of the padded block with k-wide aprons in shared memory, k gated
subcycles and no final one, no grid barrier; the final subcycle is a
launch of the ``evp_subcycle`` kernel with ``ndte = 1`` in its doubly
cyclic mode (the mode of the whole-grid TPU kernel,
``cice4_tpu/ops/evp_pallas.py:468``).  On the CPU the body is the plain
`_stress_update`/`_stepu` loop.

Boundaries: cyclic/open/closed on both axes and the production U-fold
(``tripole``): the top mesh row fills its north ghosts from the
x-mirrored block with per-plane source, row-map and sign laws, then
computes stress redundantly in the fold's ghost zone, which reproduces
the one-device fold.  The T-fold (``tripoleT``), blocks too small for
the ring and a one-block mesh take the gathered path: the block gathers
the subcycle's inputs, runs the one-device subcycle (its kernel
included) and keeps its core.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import torch

from cice4_tpu_torch.parallel import halo as h
from cice4_tpu_torch.parallel.halo import BoundaryConditions

DEFAULT_H = 11          # ghost width -> H-1 subcycles per exchange

GEOM_NAMES = ("cyp", "cxp", "cym", "cxm", "dxt", "dyt", "dxhy", "dyhx",
              "tinyarea", "uarear")
_CYCLIC = BoundaryConditions(ew="cyclic", ns="cyclic")

# per-plane fold laws (source plane, centre row map, sign) of the
# 14-plane round stack [u, v, sp(4), sm(4), s12(4)]: velocities are
# NE-corner vectors, stress corners swap under the 180-degree fold
ROUND_SPECS = (
    [0, 1, 4, 5, 2, 3, 8, 9, 6, 7, 12, 13, 10, 11],
    [False, False] + [True] * 12,
    [-1.0, -1.0] + [1.0] * 12,
)
# the 22-plane constant stack: geometry (cyp<-cym, cxp<-cxm, cym<-cyp,
# cxm<-cxp negated; dxt, dyt even; dxhy, dyhx odd; tinyarea even T;
# uarear a U scalar), then strength, icetmask (T), iceumask, aiu (U
# scalars) and the eight U constants (six vector components, then
# umassdtei and fm)
CONST_SPECS = (
    [2, 3, 0, 1, 4, 5, 6, 7, 8, 9,
     10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
    [True] * 9 + [False] + [True, True, False, False] + [False] * 8,
    [-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0]
    + [1.0, 1.0, 1.0, 1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, 1.0, 1.0],
)


def sharded_eligible(grid, mesh) -> bool:
    """Whether the k-halo path takes a grid (global `ny`, `nx` and `bc`)
    on `mesh`: a mesh of more than one block whose blocks divide the
    grid; the U-fold needs blocks of three rows or more and a cyclic EW
    boundary, the T-fold is refused (port of
    ``cice4_tpu/ops/evp_sharded.py:341-358``, with its
    ``CICE4_NO_SHARDED_EVP`` switch; the JAX gate also takes the U-fold
    with a closed EW boundary)."""
    if os.environ.get("CICE4_NO_SHARDED_EVP"):
        return False
    if mesh is None:
        return False
    py, px = mesh.shape
    if py * px <= 1:
        return False
    if grid.bc.ns == "tripoleT":
        return False
    if grid.bc.ns == "tripole" and grid.ny // py < 3:
        return False
    if grid.bc.ns == "tripole" and grid.bc.ew != "cyclic":
        # the one-device fold's NE shift wraps east-west whatever the EW
        # boundary, where the k-halo zeroes the x-ghosts of a closed edge
        return False
    return grid.ny % py == 0 and grid.nx % px == 0


def _global_view(bcb: h.BlockBC):
    return SimpleNamespace(ny=bcb.ny, nx=bcb.nx, bc=bcb.bc)


def evp_subcycle_block(p, grid, *args):
    """The EVP subcycles of a block grid: the k-halo rounds where
    :func:`sharded_eligible` takes the grid, else the gathered path.
    Signature and results of :func:`cice4_tpu_torch.ops.evp_cuda.
    evp_subcycle`, on the block."""
    from cice4_tpu_torch.parallel.mesh import get_active_mesh

    if sharded_eligible(_global_view(grid.bc), get_active_mesh()):
        return evp_subcycle_sharded(p, grid, *args)
    return evp_subcycle_gathered(p, grid, *args)


def evp_subcycle_gathered(p, grid, *args):
    """The gathered path: every block gathers the subcycle's inputs, runs
    the one-device subcycle on the global grid and keeps its core."""
    from cice4_tpu_torch.ops.evp_cuda import evp_subcycle

    bcb = grid.bc
    full = [h.gather_field(a, bcb.mesh) for a in args]
    with h.gathered_phase("evp"):
        out = evp_subcycle(p, bcb.global_grid, *full)
    (uvel, vvel, sp, sm, s12, diag, strintx, strinty, strocnx,
     strocny) = out
    return (bcb.core(uvel), bcb.core(vvel), bcb.core(sp), bcb.core(sm),
            bcb.core(s12), {k: bcb.core(v) for k, v in diag.items()},
            bcb.core(strintx), bcb.core(strinty), bcb.core(strocnx),
            bcb.core(strocny))


def halo_width(bcb: h.BlockBC, H: int = DEFAULT_H) -> int:
    """The ring width a block takes: H capped by the block (the exchange
    copies H-wide strips of the core), and on a fold by the rows the
    mirror slab needs below the top (port of
    ``cice4_tpu/ops/evp_sharded.py:204-206``)."""
    H = min(H, bcb.by, bcb.bx)
    if bcb.ns in h.FOLDS:
        H = min(H, bcb.by - (2 if bcb.ns == "tripoleT" else 1))
    return H


def evp_subcycle_sharded(p, grid, strength, icetmask, iceumask, aiu,
                         uocn, vocn, waterx, watery, forcex, forcey,
                         umassdtei, fm, uvel, vvel, stressp, stressm,
                         stress12, H: int = DEFAULT_H):
    """ndte subcycles of a block grid with k-halo exchanges (port of
    `evp_subcycle_sharded`, ``cice4_tpu/ops/evp_sharded.py:183-338``).

    Same arguments and results as `evp_subcycle`, on the block's core."""
    from cice4_tpu_torch.ops.evp_cuda import evp_rounds, evp_subcycle

    bcb = grid.bc
    tripole = bcb.ns in h.FOLDS
    H = halo_width(bcb, H)
    ksub = H - 1
    nfull = (p.ndte - 1) // ksub
    rem = (p.ndte - 1) - nfull * ksub
    dtype = uvel.dtype

    def pad(a):
        a = a.to(dtype) if a.dtype == torch.bool else a
        return torch.nn.functional.pad(a, (H, H, H, H))

    # the constants: padded, their ghosts filled by one batched exchange
    consts = [getattr(grid, n) for n in GEOM_NAMES] + [
        strength, icetmask, iceumask, aiu, uocn, vocn, waterx, watery,
        forcex, forcey, umassdtei, fm]
    cstack = h.exchange_padded(torch.stack([pad(a) for a in consts]), H,
                               bcb, CONST_SPECS if tripole else None)
    geom = SimpleNamespace(bc=_CYCLIC, **{n: cstack[i]
                                          for i, n in enumerate(GEOM_NAMES)})
    c = cstack[len(GEOM_NAMES):].unbind(0)
    strength_p, aiu_p = c[0], c[3]
    icet_p, iceu_p = c[1] > 0.5, c[2] > 0.5
    rest = c[4:]
    const_args = (strength_p, icet_p, iceu_p, aiu_p, *rest)

    def ex_round(carry):
        u, v, sp, sm, s12 = carry
        stack = torch.cat([u[None], v[None], sp, sm, s12], dim=0)
        stack = h.exchange_padded(stack, H, bcb,
                                  ROUND_SPECS if tripole else None)
        return stack[0], stack[1], stack[2:6], stack[6:10], stack[10:14]

    carry = (pad(uvel), pad(vvel), pad(stressp), pad(stressm),
             pad(stress12))
    for k in [ksub] * nfull + ([rem] if rem else []):
        carry = ex_round(carry)
        carry = evp_rounds(dataclasses.replace(p, ndte=k), geom,
                           *const_args, *carry)
    carry = ex_round(carry)
    out = evp_subcycle(dataclasses.replace(p, ndte=1), geom, *const_args,
                       *carry)
    (u, v, sp, sm, s12, diag, strintx, strinty, strocnx, strocny) = out

    def core(a):
        return a[..., H:-H, H:-H]

    return (core(u), core(v), core(sp), core(sm), core(s12),
            {k: core(t) for k, t in diag.items()}, core(strintx),
            core(strinty), core(strocnx), core(strocny))
