"""The port's bench (``python -m cice4_tpu_torch bench``) against the JAX
package's ``bench.py``: the same steps from the same start, the same
output line, the same configurations; on a machine without a CUDA device
the subcommand refuses to run.

The loop runs on the 24x32 cut of gx1 without a land-mask file in f64 on
the CPU, 2 steps of the bench's schedule after its warm-up step, held
against JAX's jitted `ice_step` on the same schedule from the same
`init_state` and `AnalyticForcing(1.0, 0.0)`: every state field within
``1e-10 * (|jax| + max|jax|)``, the tolerance of
`tests/test_torch_step_dynamics.py`.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu import grid as jg
from cice4_tpu import model as jm
from cice4_tpu import state as js
from cice4_tpu.config import gx1_config as j_gx1_config
from cice4_tpu.io.forcing_data import AnalyticForcing as JAnalytic
from cice4_tpu_torch import bench
from cice4_tpu_torch.config import gx1_config as t_gx1_config
from cice4_tpu_torch.state import STATE_FIELDS

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
NSTEPS = 2
SLICE = {"grid.kmt_file": "", "domain.ny_global": 24, "domain.nx_global": 32}
KEYS = ("metric", "value", "unit", "vs_baseline")


@pytest.fixture(scope="module")
def port_run():
    """The port's bench loop on the cut, f64 on the CPU, and its stderr."""
    lines = []
    res = bench.run_bench(t_gx1_config().with_values(**SLICE), "gx1",
                          device="cpu", dtype=torch.float64, nsteps=NSTEPS,
                          log=lines.append)
    return res, lines


def _close(got, want, name):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-10 * (np.abs(want) + scale) + 1e-30,
                                 err_msg=name)


def test_bench_loop_matches_jax(port_run):
    """One test function: one JAX compile (the step program of
    `tests/test_torch_step_dynamics.py`)."""
    cfg = j_gx1_config().with_values(**SLICE)
    grid = jg.make_grid(cfg, dtype=jnp.float64)
    model = jm.Model.create(cfg)
    state = js.init_state(cfg, grid, model.itd, dtype=jnp.float64)
    forcing = JAnalytic(cfg, grid, jnp.float64)(1.0, 0.0)
    step = jm.make_step_fn(model)
    state, _ = step(state, grid, forcing, 1.0, 0.0)           # warm-up
    for k in range(NSTEPS):
        state, _ = step(state, grid, forcing, 1.0 + k / 24.0,
                        (k % 24) * 3600.0)
    jax.block_until_ready(state.aicen)

    got = port_run[0].state
    assert float(np.asarray(state.aicen).sum()) > 0.0
    for k in STATE_FIELDS:
        a, b = getattr(state, k), getattr(got, k)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), k
            for kk in a:
                _close(b[kk], a[kk], f"{k}.{kk}")
        else:
            _close(b, a, k)


def test_bench_line_is_the_jax_bench_line(port_run):
    res, lines = port_run
    assert "\n" not in res.line
    out = json.loads(res.line)
    assert tuple(out) == KEYS
    assert out["metric"] == "gx1 full-model cell-steps/s (1 chip)"
    assert out["unit"] == "cell-steps/s"
    assert out["value"] == res.value > 0.0
    assert out["vs_baseline"] == out["value"] / 3.55e4
    assert bench.SERIAL_BASELINE == 1.42e5 / 4.0
    assert out["value"] == 24 * 32 * NSTEPS / res.wall
    # the clock is named; the CPU run launches no kernel
    assert any("time.perf_counter" in line for line in lines)
    assert res.launches == dict.fromkeys(bench.KERNELS, 0)


def test_bench_configs_are_the_jax_bench_configs(tmp_path, monkeypatch,
                                                 capsys):
    """gx1 without its land-mask file runs the all-ocean grid and says
    so; access025 is ACCESS-OM at 0.25 degree; anything else is gx3,
    which fails naming its missing grid file."""
    monkeypatch.chdir(tmp_path)
    cfg = bench.bench_config("gx1")
    assert cfg == t_gx1_config().with_values(**{"grid.kmt_file": ""})
    err = capsys.readouterr().err
    assert "input_templates/gx1/global_gx1.kmt not found" in err
    assert "grid.kmt_file=''" in err

    (tmp_path / "input_templates" / "gx1").mkdir(parents=True)
    (tmp_path / "input_templates" / "gx1" / "global_gx1.kmt").touch()
    assert bench.bench_config("gx1") == t_gx1_config()
    assert capsys.readouterr().err == ""

    acc = bench.bench_config("access025")
    assert (acc.domain.nx_global, acc.domain.ny_global) == (1440, 1080)
    assert acc.domain.ns_boundary_type == "tripole"
    with pytest.raises(FileNotFoundError, match="global_gx3.grid"):
        bench.run_bench(bench.bench_config("gx3"), "gx3", device="cpu",
                        nsteps=1, log=lambda m: None)


def test_bench_without_a_card_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    env = {**os.environ, "PYTHONPATH": str(REPO), "BENCH_CONFIG": "gx1"}
    res = subprocess.run([sys.executable, "-m", "cice4_tpu_torch", "bench"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert res.returncode == 2
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""


def test_bench_imports_no_jax():
    """The port's bench, unlike the JAX package's `bench.py`, imports
    neither JAX nor the JAX package."""
    code = textwrap.dedent("""
        import sys
        import cice4_tpu_torch.bench
        bad = [m for m in sys.modules
               if m in ("jax", "cice4_tpu", "bench")
               or m.startswith(("jax.", "cice4_tpu."))]
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
