"""The port's block decomposition (`parallel/mesh.py`, `parallel/halo.py`)
against the JAX package's mesh and the port's global shifts, on the CPU.

* `make_mesh`'s near-square (py, px) is the JAX package's for 1, 2, 4
  and 8 devices;
* on a block grid (a `BlockBC`) every shift of `parallel.halo` fills the
  strip beyond the block from its neighbour, the global boundary or the
  tripole fold, and the blocks put back together are the global shift
  bit for bit: each boundary pair, each field location and type;
* the padded k-halo exchange fills each H-wide ring with the global
  neighbours (or the global edge's zeros) bit for bit;
* the reductions over blocks, and the failure of one block, which must
  reach the caller instead of leaving the others waiting, and blocks
  whose communication calls differ in number, which raise instead of
  waiting for one another;
* the new modules import neither JAX nor the JAX package.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from cice4_tpu_torch.constants import FieldLoc, FieldType
from cice4_tpu_torch.parallel import halo as h
from cice4_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape

torch.set_num_threads(1)
F64 = torch.float64
NY, NX = 12, 16
SHIFTS = ("nbr_e", "nbr_w", "nbr_n", "nbr_s", "nbr_ne", "nbr_nw",
          "nbr_se", "nbr_sw")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_match_jax(n):
    from cice4_tpu.parallel.mesh import make_mesh as j_make_mesh

    assert mesh_shape(n) == j_make_mesh(n).devices.shape
    assert make_mesh(n).shape == mesh_shape(n)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (3, 2)])
@pytest.mark.parametrize("ns", ["cyclic", "closed", "open", "tripole",
                                "tripoleT"])
@pytest.mark.parametrize("ew", ["cyclic", "closed", "open"])
def test_block_shifts_equal_global(ew, ns, shape):
    """Every shift of every location and type on the blocks, put back
    together, is the global `Nbr`'s bit for bit (the fold included)."""
    bc = h.BoundaryConditions(ew=ew, ns=ns)
    mesh = Mesh(*shape)
    f = torch.randn(3, NY, NX, dtype=F64,
                    generator=torch.Generator().manual_seed(7))
    mask = f[0] > 0.0
    cases = [(loc, ft) for loc in FieldLoc
             for ft in (FieldType.SCALAR, FieldType.VECTOR)]

    def work(b):
        bcb = h.BlockBC(bc, mesh, b, NY, NX)
        fb, mb = mesh.scatter(f, b), mesh.scatter(mask, b)
        out = [getattr(h, name)(fb, bcb, loc, ft)
               for loc, ft in cases for name in SHIFTS]
        return out + [h.nbr_ne(mb, bcb, FieldLoc.E_FACE)]

    parts = mesh.run(work)
    want = [getattr(h, name)(f, bc, loc, ft)
            for loc, ft in cases for name in SHIFTS]
    want.append(h.nbr_ne(mask, bc, FieldLoc.E_FACE))
    for k, w in enumerate(want):
        got = mesh.assemble([p[k] for p in parts])
        assert got.dtype == w.dtype
        assert torch.equal(got, w), k


@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("bcs", [("cyclic", "cyclic"), ("cyclic", "open"),
                                 ("closed", "closed"), ("open", "cyclic")])
def test_exchange_padded_fills_global_neighbours(bcs, H):
    bc = h.BoundaryConditions(*bcs)
    mesh = Mesh(2, 2)
    f = torch.randn(2, NY, NX, dtype=F64,
                    generator=torch.Generator().manual_seed(3))

    def reference(b):
        sy, sx = mesh.block_slices(b, NY, NX)
        js = torch.arange(sy.start - H, sy.stop + H)
        is_ = torch.arange(sx.start - H, sx.stop + H)
        out = f[:, js % NY][:, :, is_ % NX].clone()
        if bc.ns != "cyclic":
            out[:, (js < 0) | (js >= NY)] = 0.0
        if bc.ew != "cyclic":
            out[:, :, (is_ < 0) | (is_ >= NX)] = 0.0
        return out

    def work(b):
        bcb = h.BlockBC(bc, mesh, b, NY, NX)
        a = torch.nn.functional.pad(mesh.scatter(f, b), (H, H, H, H))
        return h.exchange_padded(a, H, bcb)

    for b, got in enumerate(mesh.run(work)):
        assert torch.equal(got, reference(b)), b


def test_reductions_over_blocks():
    mesh = Mesh(2, 2)
    f = torch.rand(NY, NX, dtype=F64,
                   generator=torch.Generator().manual_seed(5))

    def work(b):
        fb = mesh.scatter(f, b)
        return (h.global_sum(fb.sum()), h.global_max(fb.max()),
                h.global_all(fb < 2.0), h.global_all(fb < 0.99),
                h.gather_field(fb > 0.5, mesh))

    for s, m, all_small, all_below, mask in mesh.run(work):
        assert abs(float(s) - float(f.sum())) <= 1e-12 * float(f.sum())
        assert float(m) == float(f.max())
        assert all_small is True
        assert all_below is bool((f < 0.99).all())
        assert torch.equal(mask, f > 0.5)
    # outside a decomposed run they are the one-device operations
    assert h.global_all(f < 2.0) is True
    assert h.global_sum(f.sum()) is not None


def test_block_failure_reaches_the_caller():
    """One block's exception breaks the others' waits and is raised."""
    mesh = Mesh(2, 2)
    bc = h.BoundaryConditions()

    def work(b):
        if b == 2:
            raise ValueError("block 2 failed")
        bcb = h.BlockBC(bc, mesh, b, NY, NX)
        return h.nbr_e(torch.zeros(NY // 2, NX // 2), bcb)

    with pytest.raises(ValueError, match="block 2 failed"):
        mesh.run(work)
    with pytest.raises(ValueError, match="equal blocks"):
        mesh.block_slices(0, 13, 16)


@pytest.mark.parametrize("extra", [0, 1])
def test_uneven_communication_calls_raise(extra):
    """Block `extra` makes one exchange more than the other: once the
    other has finished, the turn comes back to it and its exchange finds
    no message, so Mesh.run raises instead of waiting."""
    mesh = Mesh(1, 2)
    bc = h.BoundaryConditions()

    def work(b):
        bcb = h.BlockBC(bc, mesh, b, NY, NX)
        x = torch.zeros(NY, NX // 2)
        for _ in range(2 if b == extra else 1):
            x = h.nbr_e(x, bcb)
        return x

    with pytest.raises(KeyError):
        mesh.run(work)


def test_new_modules_import_no_jax():
    code = textwrap.dedent("""
        import sys
        import cice4_tpu_torch.parallel.mesh, cice4_tpu_torch.parallel.halo
        import cice4_tpu_torch.parallel.launch, cice4_tpu_torch.ops.evp_sharded
        import cice4_tpu_torch.ops.evp, cice4_tpu_torch.ops.remap
        import cice4_tpu_torch.convert, cice4_tpu_torch.io.restart
        import cice4_tpu_torch.diagnostics, cice4_tpu_torch.guards
        import cice4_tpu_torch.model
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "cice4_tpu."))
               or m == "cice4_tpu"]
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr
