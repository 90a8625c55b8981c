"""The reference's step in full-width bands against the whole grid's, on
the CPU in float64: a driver step of gx1 (analytic and NCAR forcing) and
a coupled interval of ACCESS-OM2-025 with its tripole fold, at small
cuts with 3 EVP subcycles, in bands that each leave artificial edges to
an apron.  With the apron the harness derives, every number agrees with
the whole grid's to rounding; without one, the bands' edges show."""

import math

import pytest
import torch

from harness import bands, cell, check, inputs
from harness.ranks import SOLO

SEED = 3_000_000_017
CUTS = {"gx1": {"domain.nx_global": 32, "domain.ny_global": 24,
                "dynamics.ndte": 3},
        "access-om2-025": {"domain.nx_global": 40, "domain.ny_global": 32,
                           "dynamics.ndte": 3}}
CASES = [("gx1.analytic", 12), ("gx1.ncar", 12),
         ("access-om2-025.coupled", 4)]


def reference_pair(name, n, tmp_path):
    """The second step (or interval) from the seeded cold start, whole
    and in `n` bands: (whole numbers against themselves' banded copy)."""
    from reference.state import make_itd_params
    from reference.step import Reference

    wl, cfg, traffic = cell.cell_pieces(name)
    over = {"forcing.atm_data_dir": str(tmp_path),
            "forcing.ocn_data_dir": str(tmp_path)}
    tree = cell.merged_tree(cfg["config"], traffic.get("settings"), over,
                            CUTS[wl["config"]])
    ref = Reference(tree, device="cpu")
    ny, nx = ref.grid.ny, ref.grid.nx
    files = traffic.get("forcing_files")
    if files:
        inputs.write_ncar_files(str(tmp_path), SEED, files, ny, nx,
                                year=ref.cfg.forcing.fyear_init, device="cpu")
        ref = Reference(tree, device="cpu")
        assert ref.provider.available
    factors = inputs.perturbation(
        SEED, traffic["initial_state"], make_itd_params(ref.cfg).hin_max,
        ref.cfg.domain.ncat, ny, nx, device="cpu")
    start = inputs.perturb_state(ref.cold_start(), factors)
    stepper = bands.Banded(n, SOLO, lambda *a: None)
    if "component" in traffic:
        bank = inputs.ImportBank(SEED, traffic["imports"], ref.grid.tlat,
                                 device="cpu")
        c = traffic["component"]
        kw = dict(flavor=c["flavor"], gfdl=c["gfdl_surface_flux"],
                  n_steps=int(c["steps_per_interval"]), start=start)
        first, _x, u_star, _a = ref.interval(start, 0, bank.interval(0), **kw)
        whole = ref.interval(first, 1, bank.interval(1), u_star=u_star, **kw)
        banded = ref.interval(first, 1, bank.interval(1), u_star=u_star,
                              bands=stepper, **kw)
        numbers = check.state_numbers(banded[0], whole[0])
        numbers.update(check.export_numbers(banded[1], whole[1],
                                            ref.grid.tarea))
    else:
        first, _a = ref.step(start, 0, start=start)
        whole = ref.step(first, 1, start=start)
        banded = ref.step(first, 1, start=start, bands=stepper)
        numbers = check.state_numbers(banded[0], whole[0])
    numbers["flux_gap"] = check.widest(check.gaps(
        {k: v for k, v in banded[-1]["fluxes"].items()
         if isinstance(v, torch.Tensor) and v.dim() >= 2},
        {k: v for k, v in whole[-1]["fluxes"].items()
         if isinstance(v, torch.Tensor) and v.dim() >= 2}))
    return numbers, stepper, ny


@pytest.mark.parametrize("name,n", CASES)
def test_banded_reference_is_the_whole_grids(name, n, tmp_path):
    numbers, stepper, ny = reference_pair(name, n, tmp_path)
    for k, (v, field) in numbers.items():
        assert math.isfinite(v) and v <= 1e-12, (k, v, field)
    rec = stepper.records[-1]
    width = 3 + bands.REMAP_RINGS + bands.STENCIL_RINGS
    assert rec["apron"] == width
    # every core touches an apron, and some bands end at an artificial
    # edge, north or south
    plan = bands.plan(ny, n, width)
    assert [tuple(r["rows"]) for r in rec["bands_run"]] == \
        [(lo, hi) for _a, _b, lo, hi in plan]
    assert all(lo < a or hi > b for a, b, lo, hi in plan)
    assert sum((lo, hi) != (0, ny) for _a, _b, lo, hi in plan) >= 2


@pytest.mark.parametrize("name,n", CASES)
def test_a_band_without_an_apron_is_not_the_whole_grids(name, n, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(bands, "apron", lambda cfg, n_steps: 0)
    numbers, _stepper, _ny = reference_pair(name, n, tmp_path)
    assert max(v for v, _f in numbers.values()) > 1e-6


def test_the_apron_follows_the_configuration():
    from reference.config import config_from_dict

    _wl, cfg, _t = cell.cell_pieces("access-om2-025.coupled")
    rcfg = config_from_dict(cfg["config"])
    assert bands.apron(rcfg, 1) == 120 + 6 + 4
    assert bands.apron(rcfg, 2) == 2 * 130
    assert bands.apron(rcfg.with_values(**{"dynamics.kdyn": 0}), 1) == 10


def test_the_plan_covers_every_row_once():
    for ny, n, w in ((24, 4, 13), (1080, 8, 130), (7, 7, 0)):
        plan = bands.plan(ny, n, w)
        assert [a for a, _b, _lo, _hi in plan][0] == 0
        assert all(p[1] == q[0] for p, q in zip(plan, plan[1:]))
        assert plan[-1][1] == ny
        assert all(max(0, a - w) == lo and min(ny, b + w) == hi
                   for a, b, lo, hi in plan)
