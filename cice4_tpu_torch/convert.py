"""Carry grids, states and forcing between the JAX package and the port.

The port never touches JAX types: the caller flattens a JAX `Grid`,
`State` or `Forcing` into a dict of numpy arrays (e.g. with
``jax.tree_util`` and ``np.asarray``) and these functions turn such a
dict into the port's dataclass of tensors on a given device and dtype,
and back.  Nested dicts (``trcrn``, ``swn``) stay nested; ``None``
fields stay ``None``.
"""

from __future__ import annotations

import numpy as np
import torch

from cice4_tpu_torch.forcing import FORCING_FIELDS, Forcing
from cice4_tpu_torch.grid import GRID_FIELDS, Grid
from cice4_tpu_torch.parallel.halo import BoundaryConditions
from cice4_tpu_torch.state import STATE_FIELDS, State


def _to_tensor(a, device, dtype):
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _to_tensor(v, device, dtype) for k, v in a.items()}
    arr = np.array(a)  # a writable copy: JAX exports read-only buffers
    t = torch.from_numpy(arr)
    if arr.dtype.kind == "f":
        t = t.to(dtype)
    return t.to(device)


def _to_numpy(t):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _to_numpy(v) for k, v in t.items()}
    return t.detach().cpu().numpy()


def grid_from_arrays(arrays: dict, bc: BoundaryConditions, *, device,
                     dtype=torch.float32) -> Grid:
    """`arrays` holds every name of GRID_FIELDS; (ny, nx) from `htn`."""
    ny, nx = np.shape(arrays["htn"])
    return Grid(bc=bc, nx=nx, ny=ny,
                **{k: _to_tensor(arrays[k], device, dtype)
                   for k in GRID_FIELDS})


def state_from_arrays(arrays: dict, *, device, dtype=torch.float32) -> State:
    return State(**{k: _to_tensor(arrays.get(k, {} if k in ("trcrn", "swn")
                                             else None), device, dtype)
                    for k in STATE_FIELDS})


def forcing_from_arrays(arrays: dict, *, device,
                        dtype=torch.float32) -> Forcing:
    return Forcing(**{k: _to_tensor(arrays.get(k), device, dtype)
                      for k in FORCING_FIELDS})


def to_arrays(obj) -> dict:
    """A port Grid, State or Forcing as a dict of numpy arrays."""
    names = {Grid: GRID_FIELDS, State: STATE_FIELDS,
             Forcing: FORCING_FIELDS}[type(obj)]
    return {k: _to_numpy(getattr(obj, k)) for k in names}
