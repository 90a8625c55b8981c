"""The entry of ``access-om2-01.coupled``: the port's ACCESS-OM component
(``cice4_tpu_torch.component.IceComponent``) on this rank's block of the
mesh, one block a rank, as the ACCESS drivers run one ice task a block.
The component builds its mesh from the process group that the harness
creates (``parallel.mesh.init_distributed``, ``make_mesh``), and its
grid, state, imports and exports are the block's.  One
``run(imports, n_steps)`` a coupling interval, then a synchronisation of
the rank's card, as a coupler that passes the exports on waits for them.

See ``harness.cell.load_entry`` for what an entry defines.
"""

from __future__ import annotations

import torch


def _mesh():
    from cice4_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    if len(mesh.local_blocks) != 1:
        raise ValueError(f"{mesh} holds more than one block in a rank")
    return mesh


def block(ny: int, nx: int) -> tuple[int, int, int, int]:
    """The rows and columns of the global grid that this rank holds: the
    component's block (``make_mesh``, one block a process)."""
    mesh = _mesh()
    rows, cols = mesh.block_slices(mesh.local_blocks[0], ny, nx)
    return rows.start, rows.stop, cols.start, cols.stop


class Entry:
    """The component on this rank's block, initialised; one coupling
    interval a call, from the bank of the block's import states."""

    def __init__(self, cfg, traffic, *, dtype, device, quiet, bank):
        from cice4_tpu_torch.component import IceComponent

        c = traffic["component"]
        comp = IceComponent(cfg, flavor=c["flavor"], dtype=dtype, log=quiet,
                            gfdl_surface_flux=c["gfdl_surface_flux"],
                            device=device)
        if getattr(comp, "mesh", None) is None:
            # before its set-up: a component that knows no mesh would hold
            # the whole grid on every card
            raise ValueError("this IceComponent holds no block of a mesh")
        self.comp = comp.initialize()
        self.runner = self.comp.runner
        self.device = torch.device(device)
        self.n_steps = int(c["steps_per_interval"])
        self.bank = bank
        self.exports = None

    def step(self, k: int):
        self.exports = self.comp.run(self.bank[k % len(self.bank)],
                                     n_steps=self.n_steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def context(self):
        """The friction velocity of the previous interval, the block's."""
        u = self.comp._boundary.u_star
        return {"u_star": None if u is None else u.detach().clone()}

    def forcing_s(self):
        return None
