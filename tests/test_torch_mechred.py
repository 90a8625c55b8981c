"""What lets the ridging loop end column by column on the card, held on
the CPU: one `_ridge_shift` pass with zero closing and zero opening leaves
the carry as it was (the area, volumes, enthalpies, open water and the
ridging sums bit for bit; the surface temperature and the tracers, which
the pass rebuilds by a multiply and a divide, within 4 ulps), on the 24x32
gx1 cut after 3 steps of the port's default dynamics.  So a column whose
area sums to 1 may leave the loop while others ridge on, as the column
kernel's columns do (``csrc/ridge_column.cu``), where the plain loop gives
it further passes until every column is done.

Also the column kernels' tracer packing, the ridge guard's converged
flags as a device tensor, and the dispatch of `ridge_ice` and
`cleanup_itd` to their plain versions on the CPU.  No JAX.
"""

import pytest
import torch

from cice4_tpu_torch.config import gx1_config
from cice4_tpu_torch.guards import check_ridge
from cice4_tpu_torch.io.forcing_data import AnalyticForcing
from cice4_tpu_torch.model import Model
from cice4_tpu_torch.ops import itd as itd_ops
from cice4_tpu_torch.ops import mechred, ridge_cuda
from cice4_tpu_torch.state import init_state

NY, NX = 24, 32
EXACT = ("aicen", "vicen", "vsnon", "eicen", "esnon", "aice0", "ardg1",
         "ardg2", "virdg", "aopen", "msnow_mlt", "esnow_mlt")
ULPS = 4


def _cfg(**over):
    return gx1_config().with_values(**{
        "grid.kmt_file": "", "domain.ny_global": NY, "domain.nx_global": NX,
        **over})


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def stepped(request):
    """(model, state) after 3 default steps of the 24x32 cut, with the
    level-ice and pond tracers beside the ice age."""
    dtype = request.param
    cfg = _cfg(**{"tracers.tr_lvl": True, "tracers.tr_pond": True})
    model = Model.create(cfg, device="cpu", dtype=dtype)
    state = init_state(cfg, model.grid, model.itd, device="cpu", dtype=dtype)
    forcing = AnalyticForcing(cfg, model.grid, device="cpu", dtype=dtype)
    for n in range(3):
        yday = 80.0 + n / 24.0
        state, _ = model(state, forcing(yday, 0.0), yday, 0.0)
    return model, state


def _within_ulps(got, want, n):
    """|got - want| <= n ulps of want, elementwise."""
    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) \
        - want.abs()
    return bool(((got - want).abs() <= n * ulp).all())


@pytest.mark.parametrize("partic,redist", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_a_pass_without_closing_leaves_the_column(stepped, partic, redist):
    model, state = stepped
    dyn = model.cfg.with_values(**{"dynamics.krdg_partic": partic,
                                   "dynamics.krdg_redist": redist}).dynamics
    carry = mechred._initial_carry(state, None)
    # the carry after a ridging pass, as the loop hands it on
    zero = torch.zeros_like(state.sst)
    carry = mechred._ridge_shift(dyn, model.itd, 3600.0, carry,
                                 zero + 2e-7, zero)
    assert float(carry["ardg1"].max()) > 0.0
    after = mechred._ridge_shift(dyn, model.itd, 3600.0, carry, zero, zero)
    for k in EXACT:
        assert torch.equal(after[k], carry[k]), k
    assert _within_ulps(after["tsfcn"], carry["tsfcn"], ULPS)
    assert set(after["trcrn"]) == {"iage", "alvl", "vlvl", "volpn"}
    for k, t in after["trcrn"].items():
        assert _within_ulps(t, carry["trcrn"][k], ULPS), k


@pytest.mark.parametrize("tracers", [{}, {"tracers.tr_lvl": True},
                                     {"tracers.tr_lvl": True,
                                      "tracers.tr_pond": True,
                                      "tracers.tr_iage": False}],
                         ids=["iage", "iage+lvl", "lvl+pond"])
def test_tracers_pack_and_unpack(tracers):
    """The wrappers' tracer table: the tracers in dict order, each its own
    array (a contiguous one passed without a copy), each with its code."""
    cfg = _cfg(**tracers)
    model = Model.create(cfg, device="cpu", dtype=torch.float64)
    state = init_state(cfg, model.grid, model.itd, device="cpu",
                       dtype=torch.float64)
    trcrn = {k: torch.rand_like(v) for k, v in state.trcrn.items()}
    names, arrays, codes = ridge_cuda.tracer_table(trcrn)
    assert names == list(trcrn)
    want = {"iage": 1, "alvl": 0 | ridge_cuda.LEVEL_CODE,
            "vlvl": 1 | ridge_cuda.LEVEL_CODE, "volpn": 0}
    assert codes == [want[k] for k in names]
    back = dict(zip(names, arrays))
    assert list(back) == names
    for k in names:
        assert torch.equal(back[k], trcrn[k])
        assert back[k].data_ptr() == trcrn[k].data_ptr()
    # a strided tracer comes back contiguous, with the same values
    strided = {k: v.transpose(1, 2) for k, v in trcrn.items()}
    for k, x in zip(*ridge_cuda.tracer_table(strided)[:2]):
        assert x.is_contiguous() and torch.equal(x, strided[k])


def test_no_tracers_pack_to_an_empty_tensor():
    """Without tracers the table is empty: the kernels take no tracer
    address."""
    names, arrays, codes = ridge_cuda.tracer_table({})
    assert names == [] and arrays == [] and codes == []


def test_ridge_guard_takes_converged_flags_on_the_device():
    asum = torch.tensor([[1.0, 1.5], [0.5, 1.0]], dtype=torch.float64)
    tmask = torch.tensor([[True, True], [True, False]])
    flags = torch.tensor([[True, False], [True, False]])
    # the plain loop's flag: every column, a Python bool
    assert int(check_ridge(asum, tmask, True)["count"]) == 0
    assert int(check_ridge(asum, tmask, False)["count"]) == 2
    # the kernel's: each column's
    rec = check_ridge(asum, tmask, flags)
    assert int(rec["count"]) == 1
    assert (int(rec["j"]), int(rec["i"])) == (0, 1)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU ridge_ice and cleanup_itd run their plain versions and
    launch nothing."""
    cfg = _cfg()
    model = Model.create(cfg, device="cpu", dtype=torch.float64)
    state = init_state(cfg, model.grid, model.itd, device="cpu",
                       dtype=torch.float64)
    calls = []
    for mod, attr in ((mechred, "_ridge_ice_plain"),
                      (itd_ops, "_cleanup_itd_plain")):
        fn = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _fn=fn, _n=attr, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    launches = (mechred.ridge_ice.launches, itd_ops.cleanup_itd.launches)
    zero = torch.zeros_like(state.sst)
    state, diag = mechred.ridge_ice(state, model.itd, cfg.dynamics, 3600.0,
                                    zero, zero, model.grid.tmask)
    assert isinstance(diag["niter"], int) and diag["niter"] == 1
    itd_ops.cleanup_itd(state, model.itd, model.grid.tmask, 3600.0)
    assert calls == ["_ridge_ice_plain", "_cleanup_itd_plain"]
    assert (mechred.ridge_ice.launches,
            itd_ops.cleanup_itd.launches) == launches
    with pytest.raises(NotImplementedError):
        mechred.ridge_ice(state.replace(aicen=state.aicen.to("meta")),
                          model.itd, cfg.dynamics, 3600.0, zero, zero,
                          model.grid.tmask)
