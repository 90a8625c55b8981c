"""The port's EVP subcycle loop on grids that are cyclic north-south (the
case the JAX package hands to its whole-grid TPU kernel
`evp_pallas._kernel`) against the JAX package, in f64 on the CPU.

On a 24x32 grid cyclic on both axes (and one cyclic north-south only),
with ice bands that cross the periodic seam, `_evp_subcycle_plain` (the
plain version of the ``evp_subcycle`` kernel, which runs NS-cyclic grids
with its ``ns_cyclic`` wrap) is held against `_evp_subcycle_jnp` and
against the whole-grid TPU kernel `_evp_pallas_wholegrid(interpret=True)`
at the tolerance of `tests/test_torch_evp.py`: ``|torch - jax| <= 1e-12 *
(|jax| + max|jax|)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu.config import DynamicsConfig as JDyn
from cice4_tpu.grid import make_rect_grid
from cice4_tpu.ops import evp as jevp
from cice4_tpu.ops.evp_pallas import _evp_pallas_wholegrid
from cice4_tpu.parallel.halo import BoundaryConditions as JBC
from cice4_tpu_torch import convert
from cice4_tpu_torch.config import DynamicsConfig as TDyn
from cice4_tpu_torch.ops import evp as tevp
from cice4_tpu_torch.ops import evp_cuda

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
NAMES = ("uvel", "vvel", "stressp", "stressm", "stress12", "div_sum",
         "delta_sum", "ten_sum", "shr_sum", "prs_sig", "strintx", "strinty",
         "strocnx", "strocny")


def _close(got, want, name, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300,
                                 err_msg=name)


def _named(out):
    named = dict(zip(NAMES[:5], out[:5]))
    named.update(out[5])
    named.update(zip(NAMES[10:], out[6:]))
    return named


def _args(ny, nx, seed):
    """Subcycle inputs with the masked-zero invariant: ice in a band over
    the first and last rows (across the NS seam) and a patch at the EW
    edges, none in the middle rows."""
    rng = np.random.RandomState(seed)

    def rand(lo, hi, shape=(ny, nx)):
        return rng.uniform(lo, hi, shape)

    row = np.arange(ny)[:, None] * np.ones((1, nx))
    col = np.ones((ny, 1)) * np.arange(nx)[None, :]
    band = (row < ny // 4) | (row >= ny - ny // 4) \
        | ((row < ny // 2) & ((col < 3) | (col >= nx - 3)))
    icet = band & (rng.rand(ny, nx) > 0.2)
    iceu = icet & (rng.rand(ny, nx) > 0.1)
    return (rand(0.0, 2.0e4) * icet, icet, iceu, rand(0.5, 1.0),
            rand(-0.2, 0.2), rand(-0.2, 0.2), rand(-0.2, 0.2),
            rand(-0.2, 0.2), rand(-0.2, 0.2) * iceu, rand(-0.2, 0.2) * iceu,
            rand(1.0, 60.0), rand(-2.0, 2.0), rand(-0.3, 0.3) * iceu,
            rand(-0.3, 0.3) * iceu, rand(-1e3, 1e3, (4, ny, nx)) * icet,
            rand(-1e3, 1e3, (4, ny, nx)) * icet,
            rand(-1e3, 1e3, (4, ny, nx)) * icet)


@pytest.mark.parametrize("ew,ndte,damping", [("cyclic", 20, False),
                                             ("cyclic", 12, True),
                                             ("closed", 10, False)])
def test_ns_cyclic_subcycle_matches_jnp_and_wholegrid(ew, ndte, damping):
    ny, nx = 24, 32
    jgrid = make_rect_grid(nx, ny, JBC(ew=ew, ns="cyclic"), dx=20.0e3,
                           dy=20.0e3, land_edges=False, dtype=jnp.float64)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=ew, ns="cyclic"), device=CPU,
        dtype=F64)
    args = _args(ny, nx, seed=13)
    kw = dict(ndte=ndte, evp_damping=damping)
    jp = jevp.make_evp_params(JDyn(**kw), 3600.0)
    tp = tevp.make_evp_params(TDyn(**kw), 3600.0)
    jargs = tuple(jnp.asarray(a) for a in args)
    ref = _named(jevp._evp_subcycle_jnp(jp, jgrid, *jargs))
    whole = _named(_evp_pallas_wholegrid(jp, jgrid, *jargs, interpret=True))
    before = (evp_cuda.evp_subcycle.launches,
              evp_cuda.evp_subcycle.ns_cyclic_launches)
    got = _named(evp_cuda.evp_subcycle(
        tp, tgrid, *(torch.tensor(np.asarray(a)) for a in args)))
    assert (evp_cuda.evp_subcycle.launches,
            evp_cuda.evp_subcycle.ns_cyclic_launches) == before
    # the seam carries stress: the wrap matters to the result
    assert float(np.abs(np.asarray(ref["strintx"])[0]).max()) > 0.0
    for name, want in ref.items():
        _close(got[name], want, name)
        _close(got[name], whole[name], name)
