"""The port's coupling layer against the JAX package's, in f64 on the CPU:
the GFDL open-water flux package (`ops/gfdl_flux.py`), the runoff filter
(`ops/runoff_regrid.py`), the ACCESS-OM and ACCESS-CM adapters
(`coupling.py`, `coupling_cm.py`) on seeded fields, the files either
package writes for the other (the `u_star` sidecar, `FieldDumper`), and
the component (`component.py`) over two coupling intervals in each flavor
against JAX's (one JAX compile of the step each).

Tolerances: the GFDL functions and the filter within
``1e-12 * (|jax| + max|jax|)``; the adapters, which only move, scale and
stack fields, within 1e-14 of that; the components within 1e-10, as the
other step tests.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import component as jcomp
from cice4_tpu import coupling as jcpl
from cice4_tpu import coupling_cm as jcm
from cice4_tpu import grid as jg
from cice4_tpu import state as js
from cice4_tpu.config import access_om_config as j_access_om_config
from cice4_tpu.forcing import default_forcing as j_default_forcing
from cice4_tpu.io.dump_field import FieldDumper as JDumper
from cice4_tpu.ops import gfdl_flux as jgf
from cice4_tpu.ops import runoff_regrid as jrr
from cice4_tpu_torch import component as tcomp
from cice4_tpu_torch import convert, kernel_check
from cice4_tpu_torch import coupling as tcpl
from cice4_tpu_torch import coupling_cm as tcm
from cice4_tpu_torch.config import access_om_config as t_access_om_config
from cice4_tpu_torch.forcing import default_forcing as t_default_forcing
from cice4_tpu_torch.io.dump_field import FieldDumper as TDumper
from cice4_tpu_torch.ops import gfdl_flux as tgf
from cice4_tpu_torch.ops import runoff_regrid as trr
from cice4_tpu_torch.state import STATE_FIELDS

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
NY, NX = 24, 32


def _close(got, want, name, rtol=1e-12):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300,
                                 err_msg=name)


def _pair(a):
    """A numpy array as (jax array, port tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _uniform(rng, lo, hi, shape=(NY, NX)):
    return _pair(rng.uniform(lo, hi, shape))


def _dict_close(got, want, what, rtol=1e-12):
    assert set(got) == set(want), what
    for k in want:
        _close(got[k], want[k], f"{what} {k}", rtol)


# ---------------------------------------------------------------------------
# GFDL open-water fluxes
# ---------------------------------------------------------------------------


def test_escomp_and_roughness_match_jax():
    """Saturation vapor pressure over 150-330 K (both blends and the
    clamp at 100 K) and the three roughness schemes."""
    rng = np.random.default_rng(0)
    jT, tT = _pair(np.concatenate([rng.uniform(150.0, 330.0, 500),
                                   [50.0, 253.15, 273.15, 273.16]]))
    _close(tgf.escomp(tT), jgf.escomp(jT), "escomp")
    ju, tu = _pair(np.concatenate([rng.uniform(0.0, 1.0, 300), [0.0]]))
    for scheme in ("beljaars", "charnock", "fixed"):
        for j, t in zip(jgf.compute_ocean_roughness(ju, scheme),
                        tgf.compute_ocean_roughness(tu, scheme)):
            _close(t, j, f"roughness {scheme}")
    with pytest.raises(ValueError):
        tgf.compute_ocean_roughness(tu, "other")


@pytest.mark.parametrize("stable_option", [1, 2])
def test_similarity_functions_match_jax(stable_option):
    """The differential and integral similarity functions on both sides of
    neutral and across ZETA_TRANS."""
    rng = np.random.default_rng(1)
    jz, tz = _pair(np.concatenate([rng.uniform(-5.0, 5.0, 400),
                                   [0.0, 0.5, 1e-7, -1e-7]]))
    jz0, tz0 = _pair(rng.uniform(-1e-3, 1e-3, 404))
    jl, tl = _pair(rng.uniform(5.0, 15.0, 404))
    for name in ("_phi", "_phi_m"):
        _close(getattr(tgf, name)(tz, stable_option),
               getattr(jgf, name)(jz, stable_option), name)
    for name in ("_psi_m", "_psi_t"):
        _close(getattr(tgf, name)(tz, tz0, tl, stable_option),
               getattr(jgf, name)(jz, jz0, jl, stable_option), name)


def _drag_inputs(rng, n=600):
    """Stable and unstable air over water, weak and strong winds, some
    points beyond the critical Richardson number."""
    thv_atm = rng.uniform(260.0, 295.0, n)
    thv_surf = thv_atm + rng.uniform(-8.0, 8.0, n)
    speed = rng.uniform(0.3, 15.0, n)
    z = np.full(n, 10.0)
    z0 = 10.0 ** rng.uniform(-6.0, -3.0, n)
    zt = 10.0 ** rng.uniform(-6.0, -3.0, n)
    zq = 10.0 ** rng.uniform(-6.0, -3.0, n)
    mask = rng.random(n) > 0.1
    return [_pair(a) for a in (thv_atm, thv_surf, z, z0, zt, zq, speed,
                               mask)]


@pytest.mark.parametrize("stable_option,neutral", [(1, False), (2, False),
                                                   (1, True)])
def test_mo_drag_matches_jax(stable_option, neutral):
    """`mo_drag` (the masked Newton solve for zeta, MO_MAX_ITER passes)
    and `_solve_zeta` on its own."""
    args = _drag_inputs(np.random.default_rng(2))
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    jo = jgf.mo_drag(*jargs[:7], mask=jargs[7], neutral=neutral,
                     stable_option=stable_option)
    to = tgf.mo_drag(*targs[:7], mask=targs[7], neutral=neutral,
                     stable_option=stable_option)
    for name, j, t in zip(("cd_m", "cd_t", "cd_q", "u_star", "b_star"),
                          jo, to):
        _close(t, j, name)
    rng = np.random.default_rng(3)
    jr, tr = _pair(rng.uniform(-3.0, 1.8, 600))
    for j, t in zip(jgf._solve_zeta(jr, *jargs[2:6], jargs[7],
                                    stable_option),
                    tgf._solve_zeta(tr, *targs[2:6], targs[7],
                                    stable_option)):
        _close(t, j, "solve_zeta")


def test_ncar_ocean_fluxes_match_jax():
    rng = np.random.default_rng(4)
    n = 500
    arrays = (rng.uniform(0.0, 20.0, n), rng.uniform(250.0, 300.0, n),
              rng.uniform(260.0, 300.0, n), rng.uniform(1e-4, 2e-2, n),
              rng.uniform(1e-4, 2e-2, n), np.full(n, 10.0),
              rng.random(n) > 0.1)
    pairs = [_pair(a) for a in arrays]
    for j, t in zip(jgf.ncar_ocean_fluxes(*[p[0] for p in pairs]),
                    tgf.ncar_ocean_fluxes(*[p[1] for p in pairs])):
        _close(t, j, "ncar_ocean_fluxes")


def _surface_inputs(rng):
    shape = (NY, NX)
    return [_uniform(rng, 250.0, 295.0),       # t_atm
            _uniform(rng, -1e-4, 1.5e-2),      # q_atm (some negative)
            _uniform(rng, -12.0, 12.0),        # u_atm
            _uniform(rng, -12.0, 12.0),        # v_atm
            _uniform(rng, 0.99e5, 1.02e5),     # p_atm
            _pair(np.full(shape, 10.0)),       # z_atm
            _uniform(rng, 0.995e5, 1.025e5),   # p_surf
            _uniform(rng, 268.0, 300.0),       # t_surf
            _uniform(rng, -0.5, 0.5),          # u_surf
            _uniform(rng, -0.5, 0.5),          # v_surf
            _pair(10.0 ** rng.uniform(-6, -3, shape)),
            _pair(10.0 ** rng.uniform(-6, -3, shape)),
            _pair(10.0 ** rng.uniform(-6, -3, shape)),
            _pair(np.ones(shape)),             # rough_scale
            _uniform(rng, 0.0, 2.0),           # gust
            _pair(rng.random(shape) > 0.15)]   # mask


@pytest.mark.parametrize("use_ncar,gust_min", [(False, 0.0), (True, 0.0),
                                               (False, 1.0)])
def test_surface_flux_matches_jax(use_ncar, gust_min):
    args = _surface_inputs(np.random.default_rng(5))
    jo = jgf.surface_flux(*[a[0] for a in args], use_ncar=use_ncar,
                          gust_min=gust_min)
    to = tgf.surface_flux(*[a[1] for a in args], use_ncar=use_ncar,
                          gust_min=gust_min)
    _dict_close(to, jo, "surface_flux")


@pytest.mark.parametrize("rough_scheme,use_ncar,celsius",
                         [("beljaars", False, True),
                          ("beljaars", False, False),
                          ("charnock", False, True), ("fixed", True, True)])
def test_gfdl_ocean_fluxes_match_jax(rough_scheme, use_ncar, celsius):
    """The driver-level wrapper: SST in Celsius (shifted, `sst < 250`) or
    Kelvin, masked outputs zero on land."""
    rng = np.random.default_rng(6)
    sst = rng.uniform(-1.8, 25.0, (NY, NX))
    if not celsius:
        sst = sst + 273.15
    args = dict(tair=_uniform(rng, 255.0, 295.0),
                qair=_uniform(rng, 5e-4, 1.5e-2),
                uwnd=_uniform(rng, -12.0, 12.0),
                vwnd=_uniform(rng, -12.0, 12.0),
                press=_uniform(rng, 0.99e5, 1.03e5), sst=_pair(sst),
                ssu=_uniform(rng, -0.5, 0.5), ssv=_uniform(rng, -0.5, 0.5),
                u_star_prev=_uniform(rng, 0.0, 0.6),
                tmask=_pair(rng.random((NY, NX)) > 0.2))
    jo = jgf.gfdl_ocean_fluxes(**{k: v[0] for k, v in args.items()},
                               rough_scheme=rough_scheme, use_ncar=use_ncar)
    to = tgf.gfdl_ocean_fluxes(**{k: v[1] for k, v in args.items()},
                               rough_scheme=rough_scheme, use_ncar=use_ncar)
    _dict_close(to, jo, "gfdl_ocean_fluxes")
    land = ~args["tmask"][1]
    for k in ("sh", "lh", "lwo", "taox", "taoy", "u_star"):
        assert float(to[k][land].abs().max()) == 0.0, k


@pytest.mark.parametrize("rough_scheme,use_ncar,celsius",
                         [("beljaars", False, True), ("charnock", True, False),
                          ("fixed", False, False)])
def test_gfdl_ocean_fluxes_on_the_cpu_run_the_plain_path(
        monkeypatch, rough_scheme, use_ncar, celsius):
    """On CPU tensors the dispatcher runs the plain version, bit for bit,
    and never loads a CUDA library or counts a kernel launch."""
    from cice4_tpu_torch import cuda_build

    def refuse(name):
        raise AssertionError(f"a CUDA library ({name}) was loaded on the CPU")

    monkeypatch.setattr(cuda_build, "load", refuse)
    x = kernel_check.gfdl_inputs(13, 21, seed=4, device=CPU, dtype=F64,
                                 celsius=celsius)
    kw = dict(rough_scheme=rough_scheme, use_ncar=use_ncar)
    before = tgf.gfdl_ocean_fluxes.launches
    got = tgf.gfdl_ocean_fluxes(**x, **kw)
    want = tgf._gfdl_ocean_fluxes_plain(**x, **kw)
    assert tgf.gfdl_ocean_fluxes.launches == before
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_gfdl_ocean_fluxes_refuse_a_device_without_a_path():
    """A device that is neither the CPU nor CUDA raises, before any work."""
    x = kernel_check.gfdl_inputs(4, 5, seed=4, device="meta", dtype=F64)
    with pytest.raises(NotImplementedError, match="meta"):
        tgf.gfdl_ocean_fluxes(**x)


def test_gfdl_column_parameters_follow_the_kernel():
    """The launcher's parameter list has one number for each field of the
    kernel's ``GfdlParams`` struct, and the plain version's roughness
    schemes in the kernel's order, so that a field added to one side only
    is caught without a card."""
    import re

    from cice4_tpu_torch.cuda_build import CSRC, EXTRA_FLAGS
    from cice4_tpu_torch.ops import gfdl_cuda

    src = (CSRC / "gfdl_column.cu").read_text()
    body = re.search(r"struct GfdlParams \{\s*double(.*?);\s*\};", src,
                     re.S).group(1)
    fields = [f.strip() for f in body.split(",")]
    assert len(fields) == len(gfdl_cuda._params(10.0))
    assert gfdl_cuda._params(10.0)[0] == 10.0 and fields[0] == "zlvl"
    assert re.search(r"kBeljaars = 0, kCharnock = 1, kFixed = 2", src)
    assert gfdl_cuda.ROUGH_SCHEMES == ("beljaars", "charnock", "fixed")
    assert EXTRA_FLAGS["gfdl_column"] == ("-fmad=false",)


# ---------------------------------------------------------------------------
# runoff filter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,sigma,masked", [
    ((NY, NX), 2.0, True), ((NY, NX), 2.0, False), ((NY, NX), 1.0, True),
    ((6, 5), 2.0, True)])
def test_regrid_runoff_matches_jax(shape, sigma, masked):
    """The masked filter and the plain one on a field whose edge rows and
    columns differ from their neighbours (the symmetric padding: a reflect
    pad that dropped the edge would differ there), on a grid larger and
    one smaller than the kernel's radius."""
    rng = np.random.default_rng(7)
    runof = rng.uniform(0.0, 1e-4, shape)
    runof[0] += 5e-3
    runof[-1] += 3e-3
    runof[:, 0] += 2e-3
    runof[:, -1] += 1e-3
    mask = rng.random(shape) > 0.3
    jk = jrr.gaussian_kernel(sigma)
    _close(trr.gaussian_kernel(sigma), jk, "gaussian_kernel", rtol=0.0)
    jr, tr = _pair(runof)
    jm, tm = _pair(mask)
    if masked:
        want = jrr.regrid_runoff(jr, jm, sigma)
        got = trr.regrid_runoff(tr, tm, sigma)
        # the masked weights are redistributed: a uniform field stays so
        flat = trr.regrid_runoff(torch.full(shape, 3e-5, dtype=F64), tm,
                                 sigma)
        np.testing.assert_allclose(flat.numpy(), 3e-5, rtol=1e-12)
    else:
        want = jrr.convolve(jr, jk)
        got = trr.convolve(tr, trr.gaussian_kernel(sigma))
    _close(got, want, "runoff")


def test_symmetric_padding_keeps_the_edge():
    """The padding reflects including the edge row, as numpy's
    "symmetric" mode, at any radius."""
    a = np.arange(30.0).reshape(5, 6) ** 2
    for r in (1, 4, 8):
        ny, nx = a.shape
        got = torch.from_numpy(a).index_select(
            0, trr._symmetric_index(ny, r, CPU)).index_select(
            1, trr._symmetric_index(nx, r, CPU))
        np.testing.assert_array_equal(got.numpy(),
                                      np.pad(a, r, mode="symmetric"))


# ---------------------------------------------------------------------------
# the adapters
# ---------------------------------------------------------------------------


def _states(cfg_pair, seed=8):
    """A JAX state of the 24x32 ACCESS grid with seeded ice, SST,
    velocities and ocean stress, and the same state in the port."""
    jcfg, _ = cfg_pair
    jgrid = jg.make_grid(jcfg, dtype=jnp.float64)
    jst = js.init_state(jcfg, jgrid, js.make_itd_params(jcfg),
                        dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    ncat = jst.aicen.shape[0]
    aicen = rng.uniform(0.0, 0.2, (ncat, NY, NX))
    aicen[:, rng.random((NY, NX)) > 0.7] = 0.0
    jst = jst.replace(
        aicen=jnp.asarray(aicen),
        vicen=jnp.asarray(aicen * rng.uniform(0.5, 3.0, aicen.shape)),
        vsnon=jnp.asarray(aicen * rng.uniform(0.0, 0.4, aicen.shape)),
        sst=jnp.asarray(rng.uniform(-1.8, 2.0, (NY, NX))),
        uvel=jnp.asarray(rng.uniform(-0.3, 0.3, (NY, NX))),
        vvel=jnp.asarray(rng.uniform(-0.3, 0.3, (NY, NX))),
        strocnxT=jnp.asarray(rng.uniform(-0.1, 0.1, (NY, NX))),
        strocnyT=jnp.asarray(rng.uniform(-0.1, 0.1, (NY, NX))))
    arrays = {k: (np.asarray(v) if not isinstance(v, dict)
                  else {kk: np.asarray(vv) for kk, vv in v.items()})
              for k, v in vars(jst).items()}
    return jgrid, jst, convert.state_from_arrays(arrays, device=CPU,
                                                 dtype=F64)


def _configs(**over):
    return (j_access_om_config(nx=NX, ny=NY).with_values(**over),
            t_access_om_config(nx=NX, ny=NY).with_values(**over))


def _imports(names, seed):
    """Seeded import fields (`kernel_check.coupler_fields`) in both
    packages."""
    t = kernel_check.coupler_fields(names, NY, NX, seed, device=CPU)
    return {k: jnp.asarray(v.numpy()) for k, v in t.items()}, t


def _forcing_close(jf, tf, what, rtol=1e-14):
    for k in convert.FORCING_FIELDS:
        a, b = getattr(jf, k), getattr(tf, k)
        assert (a is None) == (b is None), (what, k)
        if a is not None:
            _close(b, a, f"{what} {k}", rtol)


def test_om_adapters_match_jax():
    """from_atm, from_ocn, into_ocn (with the step's fluxes, with and
    without the GFDL fluxes, and with a forcing that carries press and
    runof) and into_atm."""
    jgrid, jst, tst = _states(_configs())
    jf = j_default_forcing(NY, NX, jnp.float64)
    tf = t_default_forcing(NY, NX, device=CPU, dtype=F64)
    ja2i, ta2i = _imports(tcpl.A2I_FIELDS, 9)
    jo2i, to2i = _imports(tcpl.O2I_FIELDS, 10)
    jf, tf = jcpl.from_atm(jf, ja2i), tcpl.from_atm(tf, ta2i)
    _forcing_close(jf, tf, "from_atm")
    (jf, jup), (tf, tup) = jcpl.from_ocn(jf, jo2i), tcpl.from_ocn(tf, to2i)
    _forcing_close(jf, tf, "from_ocn")
    _dict_close(tup, jup, "from_ocn updates", 0.0)

    rng = np.random.default_rng(11)
    names = ("fsalt", "fhocn", "fswthru", "fresh", "frazil", "fsens_ocn",
             "flat_ocn", "flwout_ocn", "strairx_ocn", "strairy_ocn",
             "swabs_ocn")
    jfl, tfl = {}, {}
    for k in names:
        jfl[k], tfl[k] = _uniform(rng, -50.0, 50.0)
    jtm, ttm = _pair(np.asarray(jgrid.tmask))
    jg_ = jcpl.gfdl_open_water_fluxes(jst, jf, jtm)
    tg_ = tcpl.gfdl_open_water_fluxes(tst, tf, ttm)
    _dict_close(tg_, jg_, "gfdl_open_water_fluxes")
    for gf in (None, "gfdl"):
        _dict_close(tcpl.into_ocn(tfl, tst, tf, gfdl=gf and tg_),
                    jcpl.into_ocn(jfl, jst, jf, gfdl=gf and jg_),
                    f"into_ocn {gf}", 1e-14)
    # a forcing that carries surface pressure and runoff (the JAX
    # package's `Forcing` has neither, so the component never sends them)
    jns = SimpleNamespace(**vars(jf), press=ja2i["press_i"],
                          runof=ja2i["runof_i"])
    tns = SimpleNamespace(**vars(tf), press=ta2i["press_i"],
                          runof=ta2i["runof_i"])
    _dict_close(tcpl.into_ocn(tfl, tst, tns, gfdl=tcpl.gfdl_open_water_fluxes(
        tst, tns, ttm, tg_["u_star"])),
        jcpl.into_ocn(jfl, jst, jns, gfdl=jcpl.gfdl_open_water_fluxes(
            jst, jns, jtm, jg_["u_star"])), "into_ocn with press", 1e-12)
    _dict_close(tcpl.into_atm(tfl, tst), jcpl.into_atm(jfl, jst), "into_atm",
                1e-14)


def test_cm_adapters_match_jax():
    """from_atm_cm (per-category melts, the latent heat spread over the
    categories, into category 1 where there is no ice, the aice-weighted
    stress), from_ocn_cm with and without the melt limit, into_atm_cm and
    the field sets."""
    jgrid, jst, tst = _states(_configs(**{"thermo.calc_Tsfc": False}))
    ncat = tst.aicen.shape[0]
    assert tcm.a2i_cm_fields(ncat) == jcm.a2i_cm_fields(ncat)
    assert tcm.i2a_cm_fields(ncat) == jcm.i2a_cm_fields(ncat)
    ja2i, ta2i = _imports(tcm.a2i_cm_fields(ncat), 12)
    jo2i, to2i = _imports(tcpl.O2I_FIELDS, 13)
    jf = jcm.from_atm_cm(j_default_forcing(NY, NX, jnp.float64), ja2i,
                         jst.aicen)
    tf = tcm.from_atm_cm(t_default_forcing(NY, NX, device=CPU, dtype=F64),
                         ta2i, tst.aicen)
    _forcing_close(jf, tf, "from_atm_cm")
    for limit in (None, -1000.0, -10.0):
        (jf2, jup), (tf2, tup) = (jcm.from_ocn_cm(jf, jo2i, limit),
                                  tcm.from_ocn_cm(tf, to2i, limit))
        _forcing_close(jf2, tf2, f"from_ocn_cm {limit}")
        _dict_close(tup, jup, f"from_ocn_cm updates {limit}", 0.0)
    _dict_close(tcm.into_atm_cm(tst), jcm.into_atm_cm(jst), "into_atm_cm",
                1e-14)


def test_u_star_sidecar_reads_across_packages(tmp_path):
    """The CouplerBoundary's u_star sidecar written by one package is read
    by the other; an empty one reads back as None."""
    u = np.random.default_rng(14).uniform(0.0, 0.5, (NY, NX))
    jb = jcpl.CouplerBoundary.__new__(jcpl.CouplerBoundary)
    jb.u_star = jnp.asarray(u)
    jb.dump(str(tmp_path / "jax.npz"))
    tb = tcpl.CouplerBoundary(t_default_forcing(NY, NX, device=CPU,
                                                dtype=F64))
    tb.load(str(tmp_path / "jax.npz"))
    assert tb.u_star.dtype == F64
    np.testing.assert_array_equal(tb.u_star.numpy(), u)
    tb.dump(str(tmp_path / "torch.npz"))
    jb2 = jcpl.CouplerBoundary.__new__(jcpl.CouplerBoundary)
    jb2.load(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(np.asarray(jb2.u_star), u)
    tb.u_star = None
    tb.dump(str(tmp_path / "empty.npz"))
    jb2.load(str(tmp_path / "empty.npz"))
    tb.load(str(tmp_path / "empty.npz"))
    assert jb2.u_star is None and tb.u_star is None


def test_field_dumps_read_across_packages(tmp_path):
    """FieldDumper files of either package: the same names, fields and
    metadata, compared by either package's `compare`."""
    field = np.random.default_rng(15).normal(size=(NY, NX))
    jd, td = JDumper(str(tmp_path / "jax")), TDumper(str(tmp_path / "torch"))
    for k in range(2):
        jp = jd.dump("aice", jnp.asarray(field + k))
        tp = td.dump("aice", torch.from_numpy(field + k))
        assert jp.split("/")[-1] == tp.split("/")[-1]
        with np.load(jp) as zj, np.load(tp) as zt:
            np.testing.assert_array_equal(zt["field"], zj["field"])
            assert str(zt["__meta__"]) == str(zj["__meta__"])
        for cmp in (JDumper.compare, TDumper.compare):
            assert cmp(jp, tp) == (True, 0.0)
    assert td.dump("x", torch.zeros(2), istep=7).endswith("x.000007.npz")
    assert TDumper(str(tmp_path), enabled=False).dump("x", field) is None


# ---------------------------------------------------------------------------
# the component
# ---------------------------------------------------------------------------


def test_component_flavors_and_device():
    """The CM flavor requires the prescribed-flux thermo, as JAX's; an
    unknown flavor is refused; the component runs on the card unless the
    caller asks for another device."""
    jcfg, tcfg = _configs()
    for mod, cfg in ((jcomp, jcfg), (tcomp, tcfg)):
        with pytest.raises(ValueError, match="calc_Tsfc=False"):
            mod.IceComponent(cfg, flavor="cm")
        with pytest.raises(ValueError, match="flavor"):
            mod.IceComponent(cfg, flavor="esmf")
    assert tcomp.IceComponent(tcfg).device == torch.device("cuda")
    comp = tcomp.IceComponent(tcfg, device="cpu")
    assert set(comp.set_services()) == {"init", "run", "finalize"}


def _components(flavor, tmp_path, **over):
    """Both packages' components on the 24x32 ACCESS grid, initialized."""
    over = {"run.history_dir": str(tmp_path / "history"),
            "run.diagfreq": 0, **over}
    jcfg, tcfg = _configs(**over)
    gfdl = flavor == "om"
    jc = jcomp.IceComponent(jcfg, flavor=flavor, dtype=jnp.float64,
                            log=lambda *a: None,
                            gfdl_surface_flux=gfdl).initialize()
    tc = tcomp.IceComponent(tcfg, flavor=flavor, dtype=F64,
                            log=lambda *a: None, gfdl_surface_flux=gfdl,
                            device="cpu").initialize()
    return jc, tc


def _check_intervals(jc, tc, imports, intervals=2, n_steps=2):
    for n in range(intervals):
        jin, tin = imports(n)
        jex = jc.run(jin, n_steps=n_steps)
        tex = tc.run(tin, n_steps=n_steps)
        for side in ("i2o", "i2a"):
            _dict_close(tex[side], jex[side], f"interval {n} {side}", 1e-10)
    for k in STATE_FIELDS:
        a, b = getattr(jc.runner.state, k), getattr(tc.runner.state, k)
        if isinstance(a, dict):
            for kk in a:
                _close(b[kk], a[kk], f"{k}.{kk}", 1e-10)
        else:
            _close(b, a, k, 1e-10)
    assert tc.runner.calendar.istep == intervals * n_steps
    assert float(tc.runner.state.uvel.abs().max()) > 0.0
    tc.finalize()


def test_om_component_matches_jax(tmp_path):
    """ACCESS-OM with the GFDL open-water fluxes: two coupling intervals
    of two steps from seeded imports, the export fields, the carried
    u_star and the state against JAX's."""
    jc, tc = _components("om", tmp_path)

    def imports(n):
        ja2i, ta2i = _imports(tcpl.A2I_FIELDS, 20 + n)
        jo2i, to2i = _imports(tcpl.O2I_FIELDS, 30 + n)
        return {"a2i": ja2i, "o2i": jo2i}, {"a2i": ta2i, "o2i": to2i}
    _check_intervals(jc, tc, imports)
    _close(tc._boundary.u_star, jc._boundary.u_star, "u_star", 1e-10)
    ocean = tc.runner.grid.tmask
    assert float(tc._boundary.u_star[ocean].min()) > 0.0


def test_cm_component_matches_jax(tmp_path):
    """ACCESS-CM (``calc_Tsfc=False``, and the UM's stress, so
    ``calc_strair=False``): two coupling intervals of two steps from
    seeded per-category melts and stresses against JAX's."""
    jc, tc = _components("cm", tmp_path, **{"thermo.calc_Tsfc": False,
                                            "thermo.calc_strair": False})
    ncat = tc.runner.state.aicen.shape[0]

    def imports(n):
        ja2i, ta2i = _imports(tcm.a2i_cm_fields(ncat), 40 + n)
        jo2i, to2i = _imports(tcpl.O2I_FIELDS, 50 + n)
        return {"a2i": ja2i, "o2i": jo2i}, {"a2i": ta2i, "o2i": to2i}
    _check_intervals(jc, tc, imports)
    assert float(tc._boundary.forcing.strax.abs().max()) > 0.0
