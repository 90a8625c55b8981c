"""The port's EVP dynamics against the JAX package, in f64 on the CPU.

* `ice_strength` (both `kstrength` formulations) and `principal_stress`
  at rtol 1e-12 of each field's largest magnitude;
* the plain subcycle loop `_evp_subcycle_plain` against
  `_evp_subcycle_jnp` and against the TPU kernel
  `evp_subcycle_pallas(..., interpret=True)` on the fixtures of
  `tests/test_evp.py` (random fields with the masked-zero invariant, ice
  bands with ice-free blocks, ragged ny, ndte=20) at 1e-12 of each
  field's scale (``|torch - jax| <= 1e-12 * (|jax| + max|jax|)``): XLA
  and PyTorch round `sqrt` and the stress sums differently in the last
  bit, and where a stress nearly cancels that bit is up to 6e-12 of the
  element itself after 20 subcycles;
* the whole of `evp()` with `evp_damping` and `hemi_turning` on and
  off, at rtol 1e-11 of each field's scale: 120 subcycles carry the last
  bits the two packages' `sqrt` and sums round differently.

The wrapper `evp_subcycle` runs the plain version on CPU tensors and
counts no kernel launch there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu.config import DynamicsConfig as JDyn
from cice4_tpu.config import gx3_config
from cice4_tpu.grid import make_rect_grid
from cice4_tpu.ops import evp as jevp
from cice4_tpu.ops.evp_pallas import evp_subcycle_pallas
from cice4_tpu.ops.mechred_strength import ice_strength as j_ice_strength
from cice4_tpu.parallel.halo import BoundaryConditions as JBC
from cice4_tpu.state import zeros_state
from cice4_tpu_torch import convert, kernel_check
from cice4_tpu_torch.config import DynamicsConfig as TDyn
from cice4_tpu_torch.ops import evp as tevp
from cice4_tpu_torch.ops import evp_cuda, remap_cuda
from cice4_tpu_torch.ops.mechred_strength import ice_strength as t_ice_strength

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
SUB_NAMES = ("uvel", "vvel", "stressp", "stressm", "stress12")
DIAG_NAMES = ("div_sum", "delta_sum", "ten_sum", "shr_sum", "prs_sig")
OUT_NAMES = ("strintx", "strinty", "strocnx", "strocny")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, name, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300,
                                 err_msg=name)


def _grids(ny, nx, ew="cyclic", ns="open"):
    jgrid = make_rect_grid(nx, ny, JBC(ew=ew, ns=ns), dx=20.0e3, dy=20.0e3,
                           land_edges=False, dtype=jnp.float64)
    tgrid = convert.grid_from_arrays(
        {k: np.asarray(getattr(jgrid, k)) for k in convert.GRID_FIELDS},
        convert.BoundaryConditions(ew=ew, ns=ns), device=CPU, dtype=F64)
    return jgrid, tgrid


def _subcycle_args(ny, nx, seed, bands):
    """The inputs of tests/test_evp.py's kernel tests, as numpy arrays."""
    rng = np.random.RandomState(seed)

    def rand(lo, hi, shape=(ny, nx)):
        return rng.uniform(lo, hi, shape)

    if bands:
        row = np.arange(ny)[:, None] * np.ones((1, nx))
        band = (row < ny // 4) | (row >= ny - ny // 5)
        icet = band & (rng.rand(ny, nx) > 0.3)
        iceu = icet & (rng.rand(ny, nx) > 0.1)
        strength = rand(0.0, 2.0e4) * icet
    else:
        strength = rand(0.0, 2.0e4)
        icet = rng.rand(ny, nx) > 0.3
        iceu = icet & (rng.rand(ny, nx) > 0.1)
        strength = strength * icet
    aiu = rand(0.5, 1.0)
    uocn, vocn = rand(-0.2, 0.2), rand(-0.2, 0.2)
    waterx, watery = rand(-0.2, 0.2), rand(-0.2, 0.2)
    forcex, forcey = rand(-0.2, 0.2), rand(-0.2, 0.2)
    if bands:
        forcex, forcey = forcex * iceu, forcey * iceu
    umassdtei = rand(1.0, 60.0)
    fm = rand(-2.0, 2.0)
    uvel, vvel = rand(-0.3, 0.3) * iceu, rand(-0.3, 0.3) * iceu
    sp = rand(-1e3, 1e3, (4, ny, nx)) * icet
    sm = rand(-1e3, 1e3, (4, ny, nx)) * icet
    s12 = rand(-1e3, 1e3, (4, ny, nx)) * icet
    return (strength, icet, iceu, aiu, uocn, vocn, waterx, watery,
            forcex, forcey, umassdtei, fm, uvel, vvel, sp, sm, s12)


def _unpack(out):
    named = dict(zip(SUB_NAMES, out[:5]))
    named.update(out[5])
    named.update(zip(OUT_NAMES, out[6:]))
    return named


# (ny, nx, seed, ice bands, TPU kernel block rows): the fixtures of
# tests/test_evp.py:135-240
SUBCYCLE_CASES = [(16, 128, 0, False, 32), (64, 128, 7, True, 16),
                  (56, 128, 7, True, 16), (48, 128, 7, True, 32)]


@pytest.mark.parametrize("ny,nx,seed,bands,bh", SUBCYCLE_CASES)
def test_plain_subcycle_matches_jnp_and_pallas(ny, nx, seed, bands, bh):
    jgrid, tgrid = _grids(ny, nx)
    args = _subcycle_args(ny, nx, seed, bands)
    jp = jevp.make_evp_params(JDyn(ndte=20), 3600.0)
    tp = tevp.make_evp_params(TDyn(ndte=20), 3600.0)
    jargs = tuple(jnp.asarray(a) for a in args)
    ref = _unpack(jevp._evp_subcycle_jnp(jp, jgrid, *jargs))
    pal = _unpack(evp_subcycle_pallas(jp, jgrid, *jargs, interpret=True,
                                      block_rows=bh))
    before = evp_cuda.evp_subcycle.launches
    got = _unpack(evp_cuda.evp_subcycle(tp, tgrid, *(_t(a) for a in args)))
    assert evp_cuda.evp_subcycle.launches == before
    for name, want in ref.items():
        _close(got[name], want, name)
        _close(got[name], pal[name], name)


# every boundary pair the kernel takes
ALL_BCS = [(ew, ns) for ew in ("cyclic", "open", "closed")
           for ns in ("cyclic", "open", "closed")]


@pytest.mark.parametrize("ice", ["none", "seams", "all"])
@pytest.mark.parametrize("ew,ns", ALL_BCS)
def test_plain_subcycle_matches_jnp_on_ice_patterns(ice, ew, ns):
    """The plain version, the kernel's oracle on the card, on the inputs
    of its GPU cases: no ice, one icy cell at each seam (its neighbours
    across the seam ice-free) and ice everywhere, on every boundary
    pair."""
    ny, nx = 13, 19
    jgrid, tgrid = _grids(ny, nx, ew=ew, ns=ns)
    args = kernel_check.evp_inputs(tgrid, seed=4, dtype=F64, ice=ice)
    want_t = {"none": 0, "seams": 8, "all": ny * nx}[ice]
    assert int(args[1].sum()) == int(args[2].sum()) == want_t
    jp = jevp.make_evp_params(JDyn(ndte=4), 3600.0)
    tp = tevp.make_evp_params(TDyn(ndte=4), 3600.0)
    ref = _unpack(jevp._evp_subcycle_jnp(
        jp, jgrid, *(jnp.asarray(a.numpy()) for a in args)))
    got = _unpack(evp_cuda.evp_subcycle(tp, tgrid, *args))
    for name, want in ref.items():
        _close(got[name], want, name)
    if ice != "none":
        assert float(np.abs(np.asarray(ref["uvel"])).max()) > 0.0


@pytest.mark.parametrize("kstrength,krdg", [(0, 1), (1, 0), (1, 1)])
def test_ice_strength_matches_jax(kstrength, krdg):
    rng = np.random.RandomState(3)
    ncat, ny, nx = 5, 6, 8
    aicen = rng.uniform(0.0, 0.25, (ncat, ny, nx))
    aicen[:, 0, :2] = 0.0
    vicen = aicen * np.array([0.3, 1.0, 1.9, 3.4, 6.0])[:, None, None] \
        * rng.uniform(0.8, 1.2, (ncat, ny, nx))
    aice, vice = aicen.sum(0), vicen.sum(0)
    aice0 = 1.0 - aice
    mask = rng.rand(ny, nx) > 0.2
    kw = dict(kstrength=kstrength, krdg_partic=krdg, krdg_redist=krdg)
    want = j_ice_strength(JDyn(**kw), *(jnp.asarray(a) for a in (
        aice, vice, aice0, aicen, vicen, mask)))
    got = t_ice_strength(TDyn(**kw), *(_t(a) for a in (
        aice, vice, aice0, aicen, vicen, mask)))
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    _close(got, want, "strength")


def _evp_inputs(ny, nx, seed):
    """A state with ice in a band, currents, slope and a convergent wind."""
    rng = np.random.RandomState(seed)
    ncat = 5
    row = np.arange(ny)[:, None] * np.ones((1, nx))
    band = (row >= ny // 4) & (row < ny - ny // 4)
    aicen = rng.uniform(0.05, 0.2, (ncat, ny, nx)) * band
    vicen = aicen * rng.uniform(0.5, 3.0, (ncat, ny, nx))
    vsnon = aicen * rng.uniform(0.0, 0.3, (ncat, ny, nx))
    x = (np.arange(nx) - nx / 2) / nx
    st = dict(
        aicen=aicen, vicen=vicen, vsnon=vsnon,
        uvel=rng.uniform(-0.1, 0.1, (ny, nx)),
        vvel=rng.uniform(-0.1, 0.1, (ny, nx)),
        stressp=rng.uniform(-1e3, 1e3, (4, ny, nx)),
        stressm=rng.uniform(-1e3, 1e3, (4, ny, nx)),
        stress12=rng.uniform(-1e3, 1e3, (4, ny, nx)),
        iceumask=rng.rand(ny, nx) > 0.5)
    forcing = dict(
        uocn=rng.uniform(-0.1, 0.1, (ny, nx)),
        vocn=rng.uniform(-0.1, 0.1, (ny, nx)),
        ss_tltx=rng.uniform(-1e-6, 1e-6, (ny, nx)),
        ss_tlty=rng.uniform(-1e-6, 1e-6, (ny, nx)),
        strairxT=np.broadcast_to(-0.2 * np.tanh(4 * x)[None, :],
                                 (ny, nx)) * aicen.sum(0),
        strairyT=rng.uniform(-0.05, 0.05, (ny, nx)) * aicen.sum(0))
    return st, forcing


@pytest.mark.parametrize("damping,sinw,tilt", [
    (False, 0.0, True), (True, 0.0, True), (False, 0.3, True),
    (True, 0.3, False)])
def test_evp_matches_jax(damping, sinw, tilt):
    """The whole of `evp`: prep (masks, T->U, strength), the subcycles and
    finish (ridging inputs, ocean stress on the T grid)."""
    ny, nx = 20, 24
    jgrid, tgrid = _grids(ny, nx, ew="cyclic", ns="closed")
    st, fo = _evp_inputs(ny, nx, seed=5)
    kw = dict(ndte=30, evp_damping=damping, sinw=sinw,
              cosw=float(np.sqrt(1.0 - sinw**2)))
    dt = 3600.0
    aice = st["aicen"].sum(0)
    aggs = (aice, st["vicen"].sum(0), st["vsnon"].sum(0), st["aicen"],
            st["vicen"], np.maximum(1.0 - aice, 0.0))
    forc = tuple(fo[k] for k in ("uocn", "vocn", "ss_tltx", "ss_tlty",
                                 "strairxT", "strairyT"))

    js = zeros_state(gx3_config().with_values(
        **{"domain.ny_global": ny, "domain.nx_global": nx}), jgrid,
        dtype=jnp.float64)
    js = js.replace(**{k: jnp.asarray(v) for k, v in st.items()})
    jst, jd = jevp.evp(js, jgrid, JDyn(**kw), dt,
                       *(jnp.asarray(a) for a in aggs + forc),
                       tilt_from_currents=tilt)

    arrays = {k: (np.asarray(v) if not isinstance(v, dict)
                  else {kk: np.asarray(vv) for kk, vv in v.items()})
              for k, v in vars(js).items()}
    ts = convert.state_from_arrays(arrays, device=CPU, dtype=F64)
    before = {k: getattr(ts, k).clone() for k in SUB_NAMES}
    tst, td = tevp.evp(ts, tgrid, TDyn(**kw), dt,
                       *(_t(a) for a in aggs + forc),
                       tilt_from_currents=tilt)
    for k, v in before.items():   # the caller's state is not written
        assert torch.equal(getattr(ts, k), v), k

    for k in SUB_NAMES + ("iceumask", "strocnxT", "strocnyT"):
        _close(getattr(tst, k), getattr(jst, k), k, rtol=1e-11)
    assert set(jd) == set(td)
    for k in jd:
        _close(td[k], jd[k], k, rtol=1e-11)
    assert float(np.abs(np.asarray(jd["rdg_conv"])).max()) > 0.0


def test_principal_stress_matches_jax():
    rng = np.random.RandomState(11)
    sp, sm, s12 = (rng.uniform(-1e3, 1e3, (6, 8)) for _ in range(3))
    prs = rng.uniform(-1.0, 1e3, (6, 8))
    prs[0, :3] = 0.0
    want = jevp.principal_stress(*(jnp.asarray(a) for a in (sp, sm, s12,
                                                             prs)))
    got = tevp.principal_stress(*(_t(a) for a in (sp, sm, s12, prs)))
    for w, g, name in zip(want, got, ("sig1", "sig2")):
        _close(g, w, name)


def test_unported_boundaries_raise():
    """An unknown boundary is refused before any launch, and the split
    remap route refuses the tripole fold, which the JAX package never
    takes there, naming its ROADMAP item (the EVP kernel and the default
    remap route take the fold: tests/test_torch_tripole.py)."""
    _, tgrid = _grids(8, 8, ew="cyclic", ns="closed")
    bad = dataclasses.replace(
        tgrid, bc=convert.BoundaryConditions(ew="cyclic", ns="mirror"))
    tp = tevp.make_evp_params(TDyn(ndte=2), 3600.0)
    args = [_t(a) for a in _subcycle_args(8, 8, 0, False)]
    with pytest.raises(ValueError, match="boundary"):
        evp_cuda._evp_subcycle_cuda(tp, bad, *args)

    _, fold = _grids(8, 8, ew="cyclic", ns="tripole")
    zeros = torch.zeros(8, 8, dtype=F64)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 item 5"):
        remap_cuda.ga_planes(zeros, zeros, zeros + 1.0, fold.bc, 2)
