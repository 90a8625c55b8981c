"""A cell on several ranks, on the CPU over gloo: a test cell added to a
copy of the benchmark by files alone (its entry, ``blocks_entry.py``,
steps the port's Model on this rank's block of a Mesh), run on 2 ranks
(a 1x2 mesh) and 4 (2x2) with the reference in bands dealt over the
ranks; faults planted under the timed path; and a cell that asks for
more cards than the machine has."""

import ast
import json
import re
import shutil
import sys
from pathlib import Path

import pytest
import torch

from harness import cell, inputs, ranks

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 3_000_000_029
NAME = "gx1.blocks"
COUPLED = "access-om2-025.blocks"
# each test cell: (the accepted cell it copies, its CPU cut)
CELLS = {NAME: ("gx1.analytic", {"domain.nx_global": 32,
                                 "domain.ny_global": 24,
                                 "dynamics.ndte": 3}),
         COUPLED: ("access-om2-025.coupled", {"domain.nx_global": 40,
                                              "domain.ny_global": 32,
                                              "dynamics.ndte": 3})}


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark with the test cells added as new files:
    their entry, their traffic files and their entries in BENCHMARK.json,
    every per-layer metric read in them."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "benchmark" / "entries").mkdir(exist_ok=True)
    shutil.copy(BENCH / "tests" / "blocks_entry.py",
                copy / "benchmark" / "entries" / "mesh_blocks.py")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (base, _cut) in CELLS.items():
        t = json.loads((BENCH / "traffic" / f"{base}.json").read_text())
        t.update(entry="mesh_blocks",
                 why=f"{base} on the blocks of a mesh, one a rank")
        t["check"]["bands"] = 4
        (copy / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
        config = {w["name"]: w for w in m["workloads"]}[base]["config"]
        m["workloads"].append({"name": name, "config": config,
                               "traffic": name, "chips": 4,
                               "why": t["why"]})
    for p in m["per_layer"]:
        p["workloads"] = p.get("workloads", []) + list(CELLS)
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    return copy


def run(checkout, tmp_path, n, name=NAME, **spec):
    """Run a test cell on `n` ranks, each with its files under the test's
    own temporary directory; (exit code, standard output's lines,
    standard error)."""
    spec = {"name": name, "seed": SEED, "seconds": 0.1, "trace": False,
            "root": str(checkout), "device": "cpu", "dtype": "float64",
            "overrides": CELLS[name][1], **spec}
    out, err = tmp_path / "out.txt", tmp_path / "err.txt"
    with open(out, "w") as fo, open(err, "w") as fe:
        rc = ranks.launch(spec, n, stdout=fo, stderr=fe)
    return rc, out.read_text().splitlines(), err.read_text()


@pytest.fixture
def tmpdir_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))


@pytest.mark.parametrize("n", [2, 4])
def test_a_cell_on_ranks_is_correct(checkout, tmp_path, tmpdir_ranks, n):
    rc, lines, err = run(checkout, tmp_path, n)
    assert rc == 0, err[-3000:]
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert out["correct"], err[-3000:]
    assert list(out)[-1] == "checks"
    for k, c in out["checks"].items():
        assert c["value"] <= 1e-12, (k, c)
    # each rank's count of steps (the ranks' lines may interleave)
    steps = {int(r): int(k)
             for r, k in re.findall(r"rank (\d+): (\d+) steps,", err)}
    assert sorted(steps) == list(range(n))
    assert set(steps.values()) == {out["attempted"]}
    assert err.count("reference band ") == 4


def test_a_traced_cell_on_ranks_reads_each_rank(checkout, tmp_path,
                                                tmpdir_ranks):
    """Each rank reads its own trace against its own block, and the line
    gives the mean over the ranks of every metric read (on the CPU the
    entry's forcing time; the device metrics find no device rows)."""
    rc, lines, err = run(checkout, tmp_path, 2, trace=True)
    assert rc == 0, err[-3000:]
    out = json.loads(lines[-1])
    assert out["correct"]
    assert "busy_s" in out["device"] and "breakdown" in out
    # every rank's bounds were taken against its 24x16 block
    assert sorted(re.findall(r"rank (\d+): bounds against (\d+)x(\d+)",
                             err)) == [("0", "24", "16"), ("1", "24", "16")]
    every = {int(r): ast.literal_eval(v) for r, v in
             re.findall(r"rank (\d+): busy_s \S+, window_s \S+, metrics "
                        r"(\{.*\})", err)}
    assert sorted(every) == [0, 1]
    assert "driver.forcing_ms" in out["metrics"]
    for k, v in out["metrics"].items():
        assert all(k in every[r] for r in every), (k, every)
        assert v["value"] == pytest.approx(
            sum(every[r][k] for r in every) / 2, rel=1e-12)
        assert v["value"] > 0


def test_the_launcher_prints_the_result_last(checkout, tmpdir_ranks,
                                             capfd):
    """As run.py launches a cell on several cards: the line is the last
    of standard output, the checks the last lines of standard error,
    after every rank's own."""
    spec = {"name": NAME, "seed": SEED, "seconds": 0.1, "trace": False,
            "root": str(checkout), "device": "cpu", "dtype": "float64",
            "overrides": CELLS[NAME][1]}
    assert ranks.launch(spec, 2) == 0
    out, err = capfd.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert tail == [f"check {k}: {c['value']} (limit {c['limit']})"
                    for k, c in line["checks"].items()]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_fault_on_ranks_is_not_correct(checkout, tmp_path, tmpdir_ranks,
                                         fault):
    rc, lines, err = run(checkout, tmp_path, 2, fault=fault)
    assert rc == 0, err[-3000:]
    out = json.loads(lines[-1])
    assert not out["correct"] and out["failed"] == 1


def test_a_coupled_cell_on_ranks_is_correct(checkout, tmp_path,
                                            tmpdir_ranks):
    """ACCESS-OM2-025 cut to 40x32, its blocks' intervals on two ranks
    (the tripole fold between them): each rank's imports cut to its
    block, its exports and friction velocity gathered to rank 0."""
    rc, lines, err = run(checkout, tmp_path, 2, name=COUPLED)
    assert rc == 0, err[-3000:]
    out = json.loads(lines[-1])
    assert out["correct"], err[-3000:]
    assert {"export_gap", "heat_gap", "heat_block_gap"} <= set(out["checks"])
    for k, c in out["checks"].items():
        assert c["value"] <= 1e-12, (k, c)
    assert "rows 0:32, columns 20:40" in err


def test_a_coupled_fault_on_ranks_is_not_correct(checkout, tmp_path,
                                                 tmpdir_ranks):
    rc, lines, err = run(checkout, tmp_path, 2, name=COUPLED,
                         fault="unchanged")
    assert rc == 0, err[-3000:]
    out = json.loads(lines[-1])
    assert not out["correct"] and out["failed"] == 1


def test_a_blocks_imports_are_the_whole_grids_cut():
    """A rank makes its block's imports alone, equal to the whole grid's
    cut to the block."""
    _wl, _cfg, traffic = cell.cell_pieces("access-om2-025.coupled")
    tlat = torch.linspace(-1.4, 1.5, 32 * 40,
                          dtype=torch.float64).reshape(32, 40)
    whole = inputs.ImportBank(SEED, traffic["imports"], tlat, device="cpu")
    blk = (8, 32, 20, 40)
    part = inputs.ImportBank(SEED, traffic["imports"], tlat, device="cpu",
                             block=blk)
    for k in (0, 5, 23):
        want = cell.block_of(whole.interval(k), blk, 32, 40)
        got = part.interval(k)
        for side in want:
            for name, v in want[side].items():
                assert torch.equal(got[side][name], v), (k, name)


def test_a_failing_rank_ends_the_run(checkout, tmp_path, tmpdir_ranks):
    """A rank that raises ends the others, and no line is printed."""
    rc, lines, _err = run(checkout, tmp_path, 2, fault="no-such-fault")
    assert rc != 0 and lines == []


def test_more_cards_than_the_machine_has(monkeypatch, capsys):
    import os

    import run as bench_run

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    m = cell.manifest()
    m["workloads"].append({"name": "gx1.four", "config": "gx1",
                           "traffic": "gx1.analytic", "chips": 4,
                           "why": "gx1 on four cards"})
    monkeypatch.setattr(cell, "manifest", lambda root=ROOT: m)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = bench_run.main(["--workload", "gx1.four", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name,trace", [(NAME, 0), (NAME, 1), (COUPLED, 0)])
def test_the_test_cell_on_the_cards(checkout, tmpdir_ranks, card, name,
                                    trace):
    """A test cell at full size through run.py, on four cards (the cell's
    chips), one rank a card over NCCL: gx1 untraced and traced (each
    rank's per-layer metrics against its block, and their mean), and
    ACCESS-OM2-025 coupled; the result line and each rank's readings
    (set-up, peak memory, wait in the all-reduce) go to standard
    output."""
    import subprocess

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    (checkout / "cice4_tpu_torch").symlink_to(ROOT / "cice4_tpu_torch")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "10", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1500, cwd=checkout)
    print("\n".join(line for line in res.stderr.splitlines()
                    if line.startswith(("rank", "ranks", "reference",
                                        "window", "step ms", "check",
                                        "traced", "peak"))))
    print(res.stdout.strip().splitlines()[-1:] or "(no line)")
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["count"] == 4
    if trace:
        metrics = {k: v["value"] for k, v in result["metrics"].items()}
        assert {"step.launches", "kernels.roofline_pct",
                "device.mfu_step_pct"} <= set(metrics), metrics
        for k in ("kernels.roofline_pct", "device.mfu_step_pct"):
            assert 0 < metrics[k] <= 100, (k, metrics[k])
