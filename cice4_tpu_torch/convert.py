"""Carry grids, states and forcing between the JAX package and the port.

The port never touches JAX types: the caller flattens a JAX `Grid`,
`State` or `Forcing` into a dict of numpy arrays (e.g. with
``jax.tree_util`` and ``np.asarray``) and these functions turn such a
dict into the port's dataclass of tensors on a given device and dtype,
and back.  Nested dicts (``trcrn``, ``swn``) stay nested; ``None``
fields stay ``None``.

:func:`scatter_blocks` cuts a port grid, state or forcing into the blocks
of a mesh (:mod:`cice4_tpu_torch.parallel.mesh`; a grid's blocks carry a
:class:`~cice4_tpu_torch.parallel.halo.BlockBC`), :func:`block_grid`
makes one block's grid with no whole-grid field on the device,
:func:`gather_blocks` puts every block's pieces back together, and
:func:`allgather_blocks` does so inside a decomposed run, where each
process holds only its own blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cice4_tpu_torch.forcing import FORCING_FIELDS, Forcing
from cice4_tpu_torch.grid import GRID_FIELDS, Grid
from cice4_tpu_torch.parallel.halo import BlockBC, BoundaryConditions
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


def _map(obj, fn):
    """`fn` on every tensor of a Grid, State, Forcing, dict or tensor."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    names = {Grid: GRID_FIELDS, State: STATE_FIELDS,
             Forcing: FORCING_FIELDS}[type(obj)]
    return dataclasses.replace(obj, **{k: _map(getattr(obj, k), fn)
                                       for k in names})


def scatter_blocks(obj, mesh, blocks=None) -> list:
    """The pieces of a global Grid, State or Forcing for `blocks` of
    `mesh` (default: the blocks this process owns): every tensor with
    trailing (ny, nx) axes cut to the block (JAX's `shard_pytree`).  A
    grid's pieces are block grids: their `bc` is a BlockBC that keeps
    the global grid for the gathered phases."""
    if blocks is None:
        blocks = mesh.local_blocks
    out = []
    for b in blocks:
        piece = _map(obj, lambda t, b=b: mesh.scatter(t, b))
        if isinstance(obj, Grid):
            bcb = BlockBC(obj.bc, mesh, b, obj.ny, obj.nx, global_grid=obj)
            piece = dataclasses.replace(piece, bc=bcb, ny=bcb.by, nx=bcb.bx)
        out.append(piece)
    return out


def block_grid(cfg, mesh, block: int, *, device,
               dtype=torch.float32) -> Grid:
    """The grid of `block` of `mesh` on `device`: the config's grid made
    on the host, where its metrics are derived, cut to the block, and
    the block alone moved.  Its BlockBC makes the global grid on `device`
    only if a gathered phase asks for it."""
    from cice4_tpu_torch.grid import make_grid

    host = make_grid(cfg, device="cpu", dtype=dtype)
    piece = _map(scatter_blocks(host, mesh, [block])[0],
                 lambda t: t.to(device))
    del host
    bcb = BlockBC(piece.bc.bc, mesh, block, piece.bc.ny, piece.bc.nx,
                  global_grid=lambda: make_grid(cfg, device=device,
                                                dtype=dtype))
    return dataclasses.replace(piece, bc=bcb)


def _gather(parts, join):
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], join) for k in first}
    if isinstance(first, torch.Tensor):
        return join(parts) if first.ndim >= 2 else first
    names = {State: STATE_FIELDS, Forcing: FORCING_FIELDS}[type(first)]
    return dataclasses.replace(first, **{
        k: _gather([getattr(p, k) for p in parts], join) for k in names})


def gather_blocks(parts, mesh):
    """The global State or Forcing from every block's piece, in block
    order (all blocks in this process)."""
    return _gather(list(parts), mesh.assemble)


def allgather_blocks(piece, mesh):
    """The global State or Forcing from this block's piece, on every
    block: inside :meth:`Mesh.run`, every block calling it."""
    from cice4_tpu_torch.parallel.halo import gather_field

    def join(t):
        return gather_field(t, mesh) if t.ndim >= 2 else t

    return _map(piece, join)
