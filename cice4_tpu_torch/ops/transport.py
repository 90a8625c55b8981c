"""First-order upwind (donor-cell) transport.

Port of :mod:`cice4_tpu.ops.transport` (``source/ice_transport_driver.F90
transport_upwind:672-834``, ``upwind_field:1790-1878``), selected by
``transport.advection = "upwind"``; the second-order incremental remap is
:mod:`cice4_tpu_torch.ops.remap`.  Plain PyTorch, as the JAX package
leaves it to XLA.

The transported set matches ``state_to_work`` (``:1223-1363``): open
water, per-category area, volume and snow, the depend-weighted tracers
and the layer energies, all conserved quantities.
"""

from __future__ import annotations

import torch

from cice4_tpu_torch.constants import FieldLoc, FieldType
from cice4_tpu_torch.grid import Grid
from cice4_tpu_torch.ops.itd import TRACER_DEPEND, _compute_tracers
from cice4_tpu_torch.parallel import halo as h
from cice4_tpu_torch.state import State


def edge_velocities(grid: Grid, uvel, vvel):
    """E-face and N-face velocities from the U-corner velocities
    (``transport_upwind:755-760``): uee(j,i) = (u(j,i)+u(j-1,i))/2,
    vnn(j,i) = (v(j,i)+v(j,i-1))/2."""
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)
    uee = 0.5 * (uvel + h.nbr_s(uvel, grid.bc, **kw))
    vnn = 0.5 * (vvel + h.nbr_w(vvel, grid.bc, **kw))
    return uee, vnn


def _upwind_tend(grid: Grid, phi, uee, vnn, dt):
    """Donor-cell flux divergence (``upwind_field:1851-1875``): `phi`
    after one step."""
    bc = grid.bc
    phi_e = h.nbr_e(phi, bc)
    phi_n = h.nbr_n(phi, bc)
    fe = 0.5 * dt * grid.hte * ((uee + torch.abs(uee)) * phi
                                + (uee - torch.abs(uee)) * phi_e)
    fn = 0.5 * dt * grid.htn * ((vnn + torch.abs(vnn)) * phi
                                + (vnn - torch.abs(vnn)) * phi_n)
    div = (fe - h.nbr_w(fe, bc) + fn - h.nbr_s(fn, bc)) * grid.tarear
    return phi - div


def transport_upwind(state: State, grid: Grid, dt):
    """First-order upwind advection of the whole ice state.

    Returns (state, aice0): the advected open-water fraction feeds the
    ridging opening/closing rates."""
    uee, vnn = edge_velocities(grid, state.uvel, state.vvel)
    aice0 = torch.clamp(1.0 - state.aicen.sum(0), min=0.0)

    def adv(f):
        return _upwind_tend(grid, f, uee, vnn, dt)

    aicen = adv(state.aicen)
    vicen = adv(state.vicen)
    vsnon = adv(state.vsnon)
    eicen = adv(state.eicen)
    esnon = adv(state.esnon)
    aice0 = torch.where(grid.tmask, torch.clamp(adv(aice0), min=0.0), 0.0)

    tsfc_a = adv(state.tsfcn * state.aicen)
    weight = {0: state.aicen, 1: state.vicen, 2: state.vsnon}
    atrcrn = {name: adv(t * weight[TRACER_DEPEND[name]])
              for name, t in state.trcrn.items()}
    tsfcn, trcrn = _compute_tracers(atrcrn, tsfc_a, aicen, vicen, vsnon,
                                    list(state.trcrn.keys()))
    m = grid.tmask
    state = state.replace(aicen=torch.where(m, aicen, 0.0),
                          vicen=torch.where(m, vicen, 0.0),
                          vsnon=torch.where(m, vsnon, 0.0),
                          eicen=torch.where(m, eicen, 0.0),
                          esnon=torch.where(m, esnon, 0.0),
                          tsfcn=tsfcn, trcrn=trcrn)
    return state, aice0
