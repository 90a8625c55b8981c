"""On the card: a short run of each cell, and a run from a directory
that holds only BENCHMARK.json and the benchmark's files, which has no
program to run and must fail without a result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gx1.analytic", "access-om2-025.coupled",
                                  "gx1.ncar"])
def test_a_short_run_on_the_card(name, card):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "3000000123", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_without_the_program_there_is_no_result(card, tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gx1.analytic",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
