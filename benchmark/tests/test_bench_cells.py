"""Whole runs of each cell on the CPU at a small cut of its grid: the
reference against the port's CPU path, faults planted under the timed
path, the bfloat16 control, a cell added as a new file, and the modules
a run loads."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from harness import cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SMALL = {"gx1": {"domain.nx_global": 32, "domain.ny_global": 24},
         "access-om2-025": {"domain.nx_global": 40, "domain.ny_global": 32}}
CELLS = ("gx1.analytic", "access-om2-025.coupled", "gx1.ncar")
SEED = 3_000_000_017


def small(name):
    return SMALL[cell.cell_pieces(name)[0]["config"]]


def run(name, **kw):
    kw.setdefault("dtype", torch.float64)
    return cell.run_cell(name, SEED, 0.1, False, device="cpu",
                         overrides=small(name), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_ports_cpu_path(name, tmpdir_runs):
    """In float64 the reference is the port's CPU path operation for
    operation: every number reads 0 but for rounding."""
    out = run(name)
    assert out["correct"]
    for k, c in out["checks"].items():
        assert c["value"] <= 1e-12, (k, c)


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
@pytest.mark.parametrize("name", ["gx1.analytic", "access-om2-025.coupled"])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault,
                                                     tmpdir_runs):
    out = run(name, fault=fault)
    assert not out["correct"]
    assert out["failed"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_fails_a_limit(name, tmpdir_runs):
    """The reference computed in bfloat16 in the program's place, as the
    calibration runs it on the card, exceeds one of the cell's limits;
    the float32 program does not."""
    out = run(name, dtype=torch.float32, control=True)
    assert out["correct"]
    limits = cell.cell_pieces(name)[2]["limits"]
    ctl = out["controls"]
    assert "error" not in ctl
    assert any(not (isinstance(ctl[k], float) and ctl[k] <= limits[k])
               for k in limits)


def test_a_cell_added_as_a_new_file_is_found(tmp_path, tmpdir_runs):
    """A later cell is a new traffic file and a new entry of
    BENCHMARK.json; no file of the benchmark changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    t = json.loads((BENCH / "traffic" / "gx1.analytic.json").read_text())
    t["why"] = "gx1 under the analytic forcing, in a cell of its own"
    (copy / "benchmark" / "traffic" / "gx1.july.json").write_text(
        json.dumps(t))
    m["workloads"].append({"name": "gx1.july", "config": "gx1",
                           "traffic": "gx1.july", "chips": 1,
                           "why": t["why"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    before = {p: p.read_bytes() for p in BENCH.rglob("*.json")}
    out = cell.run_cell("gx1.july", SEED, 0.1, False, root=copy,
                        device="cpu", dtype=torch.float64,
                        overrides=SMALL["gx1"])
    assert out["correct"]
    assert set(out["metrics"]) == {"sypd", "step_ms_p90", "setup_s"}
    assert before == {p: p.read_bytes() for p in BENCH.rglob("*.json")}


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = f"""
import sys, tempfile, torch
tempfile.tempdir = {str(tmp_path)!r}
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
from harness import cell
cell.run_cell("gx1.ncar", {SEED}, 0.1, False, device="cpu",
              dtype=torch.float64, overrides={SMALL['gx1']!r})
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "cice4_tpu"}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        text = path.read_text()
        for name in ("cice4_tpu", "jax"):
            assert f"import {name}" not in text and \
                f"from {name}" not in text, (path, name)


def test_the_benchmark_refuses_to_run_without_a_card():
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "gx1.analytic", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("over", [
    {"radiation.shortwave": "dEdd"}, {"transport.advection": "upwind"},
    {"thermo.calc_Tsfc": False}, {"thermo.heat_capacity": False},
    {"tracers.tr_pond": True}, {"forcing.atm_data_type": "LYq"}])
def test_the_reference_refuses_options_no_cell_runs(over):
    """The reference holds only the branches the cells drive; another
    option raises rather than run something that was never copied."""
    from reference.step import Reference

    _wl, cfg, traffic = cell.cell_pieces("gx1.analytic")
    tree = cell.merged_tree(cfg["config"], traffic["settings"],
                            SMALL["gx1"], over)
    with pytest.raises(ValueError, match="the reference has no"):
        Reference(tree, device="cpu")


def test_the_reference_refuses_another_exchange():
    from reference.step import Reference

    _wl, cfg, traffic = cell.cell_pieces("access-om2-025.coupled")
    tree = cell.merged_tree(cfg["config"], traffic["settings"],
                            SMALL["access-om2-025"])
    ref = Reference(tree, device="cpu")
    with pytest.raises(ValueError, match="the reference has no"):
        ref.interval(ref.cold_start(), 0, {}, flavor="cm", gfdl=False)
