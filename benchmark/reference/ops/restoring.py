"""Ice-state restoring near open boundaries (``source/ice_restoring.F90``).

Port of :mod:`cice4_tpu.ops.restoring`.  For regional configurations:
relaxes the category state toward a stored reference state in a band of
cells adjacent to open domain boundaries (`ice_HaloRestore_init:66-103`
builds the band; `ice_HaloRestore:111-351` applies the restore each step
with timescale `trestore`).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.grid import Grid
from reference.state import State


def boundary_band_mask(grid: Grid, width: int = 1):
    """1.0 in the `width`-cell band adjacent to non-cyclic domain
    edges, 0.0 elsewhere (the reference restores exactly the halo-width
    band), on the grid's device and dtype."""
    ny, nx = grid.ny, grid.nx
    m = np.zeros((ny, nx))
    if grid.bc.ns in ("open", "closed"):
        m[:width, :] = 1.0
        m[-width:, :] = 1.0
    if grid.bc.ew in ("open", "closed"):
        m[:, :width] = 1.0
        m[:, -width:] = 1.0
    return torch.as_tensor(m, dtype=grid.hm.dtype,
                           device=grid.hm.device) * grid.hm


def restore_ice(state: State, ref_state: State, band, dt,
                trestore_days: float) -> State:
    """Relax toward `ref_state` inside the band with timescale
    `trestore` (days); trestore = 0 restores instantaneously
    (``ice_HaloRestore:111-351``)."""
    if trestore_days <= 0.0:
        w = band
    else:
        w = band * min(dt / (trestore_days * 86400.0), 1.0)

    def mix(new, old):
        return old + w * (new - old)

    return state.replace(
        aicen=mix(ref_state.aicen, state.aicen),
        vicen=mix(ref_state.vicen, state.vicen),
        vsnon=mix(ref_state.vsnon, state.vsnon),
        eicen=mix(ref_state.eicen, state.eicen),
        esnon=mix(ref_state.esnon, state.esnon),
        tsfcn=mix(ref_state.tsfcn, state.tsfcn),
        trcrn={k: mix(ref_state.trcrn[k], v)
               for k, v in state.trcrn.items()},
    )
