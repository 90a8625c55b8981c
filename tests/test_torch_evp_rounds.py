"""The tile schedule of the EVP round kernel (``csrc/evp_rounds.cu``) on
the CPU, in f64.

The kernel cuts a padded block of a decomposed grid into core tiles,
stages each with an apron k cells wide read with the cyclic wrap, and runs
the round's k subcycles on the apron tile alone.  Here the same schedule
runs in plain PyTorch: `_evp_rounds_plain` on each apron tile (doubly
cyclic on its own, as the tile's region is to the kernel), the cores
stitched together, against `_evp_rounds_plain` on the whole block, bit for
bit; an apron of k - 1 is not enough.  A tile whose apron holds no ice
gets zeros (the kernel writes them without running the subcycles).  Also:
a round split into launches of fewer subcycles (`evp_cuda.round_launches`)
equals the round, bit for bit; the wrapper's plan fits a block's shared
memory; and the port's round agrees with the JAX package's subcycles
(``cice4_tpu/ops/evp.py::_evp_subcycle_jnp``, whose velocities and
stresses after ndte subcycles are those of a round of ndte) on the same
block within 1e-12 of each field's scale: the same f64 operations in the
same order, which XLA may fuse and round apart in the last bit.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu_torch import kernel_check
from cice4_tpu_torch.config import Config
from cice4_tpu_torch.grid import make_grid
from cice4_tpu_torch.ops import evp_cuda
from cice4_tpu_torch.ops.evp import _evp_rounds_plain, make_evp_params
from cice4_tpu_torch.parallel.halo import BoundaryConditions

torch.set_num_threads(1)
F64 = torch.float64
NY, NX = 40, 36          # a padded block: 2 ghost rings of 2 on 36 x 32
GEOM = ("cyp", "cxp", "cym", "cxm", "dxt", "dyt", "dxhy", "dyhx",
        "tinyarea", "uarear")
STATE = ("uvel", "vvel", "stressp", "stressm", "stress12")
JAX_RTOL = 1.0e-12


def _block(seed=3):
    """(geometry, inputs) of a doubly cyclic 40 x 36 block: the all-ocean
    grid's geometry varied cell by cell; ice in two solid bands of T cells
    (the middle rows ice-free), one U point in ten of them without; the
    masked-zero invariant."""
    cfg = Config().with_values(**{
        "domain.ny_global": NY, "domain.nx_global": NX,
        "domain.ew_boundary_type": "cyclic",
        "domain.ns_boundary_type": "cyclic", "grid.grid_type": "column"})
    grid = make_grid(cfg, device="cpu", dtype=F64)
    rng = np.random.RandomState(seed)
    geom = SimpleNamespace(bc=BoundaryConditions(ew="cyclic", ns="cyclic"),
                           **{k: getattr(grid, k) * torch.as_tensor(
                               rng.uniform(0.9, 1.1, (NY, NX)))
                              for k in GEOM})
    x = list(kernel_check.evp_inputs(grid, seed, dtype=F64, ice="all"))
    icet = torch.as_tensor(kernel_check.ice_mask(NY, NX, "bands"))
    iceu = icet & torch.as_tensor(rng.rand(NY, NX) > 0.1)
    x[1], x[2] = icet, iceu
    for i, mask in ((0, icet), (8, iceu), (9, iceu), (12, iceu), (13, iceu),
                    (14, icet), (15, icet), (16, icet)):
        x[i] = x[i] * mask     # strength, forcex, forcey, u, v, stresses
    return cfg, geom, tuple(x)


def _params(cfg, k):
    """The EVP parameters of the configuration's ndte (damped), told to
    run k subcycles: a round's, as `evp_subcycle_sharded` makes them."""
    p = make_evp_params(dataclasses.replace(cfg.dynamics, evp_damping=True),
                        cfg.run.dt)
    return dataclasses.replace(p, ndte=k)


def _window(x, y0, x0, h, w):
    """The (h, w) window of x's trailing axes from (y0, x0), wrapped."""
    rows = torch.arange(y0, y0 + h) % NY
    cols = torch.arange(x0, x0 + w) % NX
    return x[..., rows[:, None], cols[None, :]].contiguous()


def _tiled_round(p, geom, inputs, tile, apron):
    """The kernel's schedule in plain PyTorch: each core tile's round run
    on the tile and its `apron`-wide cyclic apron alone, the cores put
    together.  Beyond the apron lies one ring of NaN in every float input,
    so a core cell that needs more than the apron is NaN.  Returns (the
    state, the (y0, x0) of tiles whose apron holds no ice)."""
    rows, cols = tile
    out = [torch.full_like(x, float("nan")) for x in inputs[12:]]
    ice_free = []

    def window(x, y0, x0):
        w = _window(x, y0 - apron - 1, x0 - apron - 1, rows + 2 * apron + 2,
                    cols + 2 * apron + 2)
        if w.is_floating_point():
            w[..., [0, -1], :] = float("nan")
            w[..., :, [0, -1]] = float("nan")
        return w

    for y0 in range(0, NY, rows):
        for x0 in range(0, NX, cols):
            h = min(rows, NY - y0)
            w = min(cols, NX - x0)
            win = [window(x, y0, x0) for x in inputs]
            inner = (win[1] | win[2])[1:-1, 1:-1]    # the apron tile's
            if not bool(inner.any()):
                ice_free.append((y0, x0))
            g = SimpleNamespace(bc=geom.bc, **{
                k: window(getattr(geom, k), y0, x0) for k in GEOM})
            res = _evp_rounds_plain(p, g, *win)
            a = apron + 1
            for o, r in zip(out, res):
                o[..., y0:y0 + h, x0:x0 + w] = r[..., a:a + h, a:a + w]
    return out, ice_free


@pytest.mark.parametrize("tile", [(16, 16), (6, 12), (NY, NX)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("k", [1, 4, 9, 10])
def test_tiles_with_k_aprons_equal_the_whole_block(tile, k):
    """Tiles with k-wide aprons stitched: bit-equal to the whole block's
    round (9 is the remainder round of gx1's 119 gated subcycles in
    rounds of 10; 16 x 16 and 6 x 12 leave ragged tiles at the block's
    edges); with (k - 1)-wide aprons, not: the ring beyond reaches the
    cores (in exact arithmetic the round's influence falls off so fast
    that values from that far could round away, so the ring is NaN)."""
    cfg, geom, inputs = _block()
    p = _params(cfg, k)
    want = _evp_rounds_plain(p, geom, *inputs)
    got, _ = _tiled_round(p, geom, inputs, tile, k)
    for name, a, b in zip(STATE, got, want):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
    short, _ = _tiled_round(p, geom, inputs, tile, k - 1)
    assert bool(torch.isnan(short[0]).any())
    assert not all(torch.equal(a, b) for a, b in zip(short, want))


def test_a_tile_without_ice_in_its_apron_gets_zeros():
    """The 6 x 12 tiles of the middle rows hold no ice in their 8-wide
    aprons: their cores' state is zero, as the kernel writes it without
    running the subcycles, and the round leaves icy tiles nonzero."""
    cfg, geom, inputs = _block()
    p = _params(cfg, 8)
    want = _evp_rounds_plain(p, geom, *inputs)
    _, ice_free = _tiled_round(p, geom, inputs, (6, 12), 8)
    assert ice_free and len(ice_free) < len(range(0, NY, 6)) * 3
    for y0, x0 in ice_free:
        for name, x in zip(STATE, want):
            core = x[..., y0:y0 + 6, x0:x0 + 12]
            assert torch.equal(core, torch.zeros_like(core)), name
    assert all(bool(x.abs().max() > 0) for x in want)


@pytest.mark.parametrize("k,most,launches", [
    (10, 10, [10]), (10, 5, [5, 5]), (9, 5, [5, 4]), (7, 3, [3, 2, 2]),
    (1, 5, [1])])
def test_round_split_into_launches_equals_the_round(k, most, launches):
    """`round_launches` splits a round as evenly as it divides, and the
    launches in turn give the round bit for bit."""
    assert evp_cuda.round_launches(k, most) == launches
    cfg, geom, inputs = _block()
    want = _evp_rounds_plain(_params(cfg, k), geom, *inputs)
    state = inputs[12:]
    for n in launches:
        state = _evp_rounds_plain(_params(cfg, n), geom, *inputs[:12],
                                  *state)
    for name, a, b in zip(STATE, state, want):
        assert torch.equal(a, b), name


def test_round_plan_fits_a_blocks_shared_memory():
    """The wrapper's plan: f32 rounds of 10 in one launch of the 8 x 16
    tile, f64 in launches of at most 7, the most whose apron fits a
    block's shared memory (the kernel refuses a larger one; the bytes are
    held on the card by
    tests/test_torch_evp_sharded.py::test_round_tile_fits_a_blocks_shared_memory)."""
    assert evp_cuda.ROUND_TILE[torch.float32] == (8, 16, 10)
    assert evp_cuda.ROUND_TILE[torch.float64] == (8, 16, 7)
    assert evp_cuda.round_plan(10, torch.float32) == (8, 16, [10])
    assert evp_cuda.round_plan(10, torch.float64) == (8, 16, [5, 5])
    assert evp_cuda.round_plan(9, torch.float64) == (8, 16, [5, 4])
    assert evp_cuda.round_plan(3, torch.float64) == (8, 16, [3])


@pytest.mark.parametrize("k", [1, 9])
def test_round_matches_jax_subcycles(k):
    from cice4_tpu.config import Config as JConfig
    from cice4_tpu.parallel.halo import BoundaryConditions as JBC
    from cice4_tpu.ops import evp as jevp

    cfg, geom, inputs = _block()
    want = _evp_rounds_plain(_params(cfg, k), geom, *inputs)
    jcfg = JConfig()
    jp = dataclasses.replace(jevp.make_evp_params(dataclasses.replace(
        jcfg.dynamics, evp_damping=True), jcfg.run.dt), ndte=k)
    jgeom = SimpleNamespace(bc=JBC(ew="cyclic", ns="cyclic"),
                            **{n: jnp.asarray(getattr(geom, n).numpy())
                               for n in GEOM})
    got = jevp._evp_subcycle_jnp(jp, jgeom, *(jnp.asarray(x.numpy())
                                              for x in inputs))
    for name, a, b in zip(STATE, got[:5], want):
        b = b.numpy()
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(np.asarray(a) - b).max()) <= JAX_RTOL * scale, \
            name
