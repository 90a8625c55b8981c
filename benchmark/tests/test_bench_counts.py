"""The benchmark's copy of the kernels' operation and byte counts
against the port's own arithmetic (``chip_smoke.bound``) at the
arguments one small gx1 step passes to the kernels' wrappers on the
CPU."""

import json
from pathlib import Path

import pytest
import torch

from counts import kernels as kc
from harness import cell

BENCH = Path(__file__).resolve().parents[1]
NAMES = ("therm_newton", "evp_subcycle", "remap_gsh", "remap_k12")


@pytest.fixture(scope="module")
def captured():
    import chip_smoke as cs
    from cice4_tpu_torch.config import config_from_dict
    from cice4_tpu_torch.driver import IceModelRun

    cfg_file = json.loads((BENCH / "configs" / "gx1.json").read_text())
    tree = cell.merged_tree(cfg_file["config"], {
        "forcing.atm_data_type": "analytic", "domain.nx_global": 32,
        "domain.ny_global": 24})
    cfg = config_from_dict(tree)
    run = IceModelRun(cfg, dtype=torch.float32, device="cpu",
                      log=lambda *a: None).initialize()
    run.run(npt=2)
    seen = cs.capture_kernel_inputs(
        run.model, run.state, lambda y, s: run.forcing_provider(y, s),
        list(NAMES), yday=1.1)
    from reference.config import config_from_dict as ref_config
    return cs, ref_config(tree), seen, run.state


def shapes(rcfg, state, n_icy_cat, n_t):
    from reference.ops.remap import _tracer_meta

    d = rcfg.domain
    meta = _tracer_meta(list(state.trcrn), d.nilyr, d.nslyr)
    return kc.Shapes(ncat=d.ncat, nilyr=d.nilyr, nslyr=d.nslyr,
                     ny=d.ny_global, nx=d.nx_global, itemsize=4,
                     tracers=tuple((n, t) for n, t, _p in meta),
                     integral_order=rcfg.transport.integral_order,
                     ndte=rcfg.dynamics.ndte, icy_category_cells=n_icy_cat,
                     icy_t_cells=n_t)


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_ports_bounds(captured, name):
    cs, rcfg, seen, state = captured
    args = seen[name]
    if name == "evp_subcycle":
        # the copy counts the U points as the T cells
        args = args[:4] + (args[3],) + args[5:]
    plain = cs.sites()[name][2]
    _, _, nbytes, ops = cs.bound(name, args, plain(*args))
    n_icy = int(args[2].sum()) if name == "therm_newton" else 0
    n_t = int(args[3].sum()) if name == "evp_subcycle" else 0
    mine = kc.KERNELS[name](shapes(rcfg, state, n_icy, n_t))
    assert mine["bytes"] == nbytes
    if name == "therm_newton":
        # one Newton iteration of every icy cell: at most what ran
        assert 0 < mine["ops"] <= ops
    else:
        assert mine["ops"] == ops


def test_kernel_names_match_the_sources():
    src = BENCH.parent / "cice4_tpu_torch" / "csrc"
    text = {p.stem: p.read_text() for p in src.glob("*.cu")}
    assert "therm_newton_kernel(" in text["therm_newton"]
    assert "evp_persistent(" in text["evp_subcycle"]
    assert "gsh_fused(" in text["remap_gsh"]
    assert "    k12(" in text["remap_k12"]
    assert kc.kernel_of("void k12<float, true>(float const*, int)") \
        == "remap_k12"
    assert kc.kernel_of("void remap_k12_helper") is None
