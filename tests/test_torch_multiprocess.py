"""The decomposed port across processes, and its sharded restarts, on the
CPU in f64.

* Two processes joined by ``gloo`` through ``python -m
  cice4_tpu_torch.parallel.launch`` (one torch thread each, a free
  port), each owning one block of a 1x2 mesh or two of a 2x2 mesh: their
  checksums equal, to the last digit, those of the same mesh run in one
  process (the same per-block arithmetic and the same reduction order),
  and process 0 reads the 2-process sharded restart back
  (``RESTART_OK``).
* The sharded restart layouts of the two packages read each other:
  JAX's ``dump_restart_sharded`` of an 8-device state is read by the
  port's ``load_restart_sharded``, and the port's 2-process dump by
  JAX's ``load_restart_sharded``, bit for bit.
"""

import dataclasses
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cice4_tpu_torch import convert
from cice4_tpu_torch.cli import _load_config
from cice4_tpu_torch.grid import make_grid
from cice4_tpu_torch.io.restart import (dump_restart_sharded,
                                        load_restart_sharded)
from cice4_tpu_torch.parallel.launch import run_decomposed
from cice4_tpu_torch.parallel.mesh import Mesh
from cice4_tpu_torch.state import STATE_FIELDS, init_state, make_itd_params

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
OVERRIDES = ["domain.nx_global=32", "domain.ny_global=16",
             "grid.grid_type='rectangular'", "grid.lat_origin=66.0",
             "dynamics.ndte=8", "transport.advection='remap'"]
# the two processes of a launch together (about 6 s each on the CPU)
LAUNCH_TIMEOUT_S = 300.0


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_all(procs, timeout):
    """Wait for every process until one deadline, `timeout` seconds away;
    kill those still running then.  Returns their indices."""
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            break
    hung = [i for i, p in enumerate(procs) if p.poll() is None]
    for i in hung:
        procs[i].kill()
        procs[i].wait()
    return hung


def _cfg():
    import argparse

    return _load_config(argparse.Namespace(preset=None, config=None,
                                           set=OVERRIDES))


def _flat(state) -> dict:
    out = {}
    for k in STATE_FIELDS:
        v = getattr(state, k)
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_two_gloo_processes_match_in_process_run(tmp_path, shape):
    """One block a process (1x2), or two (2x2: each process runs its two
    blocks in turn and its first block's thread moves the messages)."""
    from cice4_tpu.config import Config as JConfig
    from cice4_tpu.grid import make_grid as j_make_grid
    from cice4_tpu.io.restart import load_restart_sharded as j_load
    from cice4_tpu.model import Model as JModel
    from cice4_tpu.state import init_state as j_init_state

    port = _free_port()
    dump = tmp_path / "dump"
    cmd = [sys.executable, "-m", "cice4_tpu_torch.parallel.launch",
           "--device", "cpu", "--f64", "--steps", "2",
           "--mesh", f"{shape[0]}x{shape[1]}", "--restart-dir", str(dump)]
    for kv in OVERRIDES:
        cmd += ["--set", kv]
    procs, logs = [], []
    for i in range(2):
        env = dict(os.environ, CICE4_DISTRIBUTED="1",
                   CICE4_COORDINATOR=f"127.0.0.1:{port}",
                   CICE4_NUM_PROCESSES="2", CICE4_PROCESS_ID=str(i),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        env.pop("PYTEST_CURRENT_TEST", None)
        log = open(tmp_path / f"worker{i}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=log,
                                      stderr=subprocess.STDOUT))
    try:
        hung = _wait_all(procs, LAUNCH_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    outs = [(tmp_path / f"worker{i}.log").read_text() for i in range(2)]
    assert not hung, (
        f"processes {hung} still ran after {LAUNCH_TIMEOUT_S:.0f} s and were "
        f"killed:\n" + "\n".join(outs[i][-2000:] for i in hung))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"
    assert "backend gloo" in outs[0]

    sums = {}
    for o in outs:
        m = re.search(r"CHECKSUM (\d) (.+)", o)
        assert m, o[-500:]
        sums[m.group(1)] = dict(kv.split("=") for kv in m.group(2).split())
    assert sums["0"] == sums["1"]
    assert "RESTART_OK" in outs[0]

    # the same mesh in one process, the two blocks in threads
    states, _models, expect = run_decomposed(_cfg(), 2, Mesh(*shape),
                                             device=CPU, dtype=F64)
    for k, v in expect.items():
        assert float(sums["0"][k]) == v, (k, sums["0"][k], v)

    # JAX reads the port's 2-process dump: the in-process run's state
    full = convert.gather_blocks(states, Mesh(*shape))
    jcfg = JConfig().with_values(**{
        "domain.nx_global": 32, "domain.ny_global": 16,
        "grid.grid_type": "rectangular", "grid.lat_origin": 66.0})
    jgrid = j_make_grid(jcfg, dtype=jnp.float64)
    template = j_init_state(jcfg, jgrid, JModel.create(jcfg).itd,
                            dtype=jnp.float64)
    loaded, manifest = j_load(str(dump), template)
    assert manifest["nprocs"] == 2 and manifest["istep"] == 2
    want = _flat(full)
    for k, v in _flat(loaded).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_jax_sharded_restart_read_by_port(tmp_path):
    from cice4_tpu.config import (Config as JConfig, DomainConfig,
                                  DynamicsConfig, GridConfig)
    from cice4_tpu.grid import make_grid as j_make_grid
    from cice4_tpu.io.restart import dump_restart_sharded as j_dump
    from cice4_tpu.model import Model as JModel
    from cice4_tpu.parallel.mesh import make_mesh, shard_pytree
    from cice4_tpu.state import init_state as j_init_state

    jcfg = JConfig(domain=DomainConfig(nx_global=32, ny_global=16),
                   grid=GridConfig(grid_type="rectangular",
                                   lat_origin=66.0),
                   dynamics=DynamicsConfig(ndte=5))
    jgrid = j_make_grid(jcfg, dtype=jnp.float64)
    jstate = j_init_state(jcfg, jgrid, JModel.create(jcfg).itd,
                          dtype=jnp.float64)
    rng = np.random.default_rng(4)
    jstate = jstate.replace(uvel=jnp.asarray(rng.normal(size=(16, 32))),
                            stressp=jnp.asarray(rng.normal(
                                size=(4, 16, 32))))
    d = str(tmp_path / "jax_dump")
    ptr = str(tmp_path / "ice.restart_file")
    j_dump(shard_pytree(jstate, make_mesh(8)), d, istep=7,
           time=7 * 3600.0, pointer_file=ptr)

    cfg = _cfg()
    grid = make_grid(cfg, device=CPU, dtype=F64)
    template = init_state(cfg, grid, make_itd_params(cfg), device=CPU,
                          dtype=F64)
    loaded, manifest = load_restart_sharded(d, template)
    assert manifest["istep"] == 7 and manifest["nprocs"] == 1
    want = _flat(jstate)
    for k, v in _flat(loaded).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_port_sharded_restart_in_one_process(tmp_path):
    """Four blocks owned by one process: shards d0-d3 of process 0,
    the pointer file, and the state read back bit for bit."""
    cfg = _cfg()
    grid = make_grid(cfg, device=CPU, dtype=F64)
    state = init_state(cfg, grid, make_itd_params(cfg), device=CPU,
                       dtype=F64)
    state = dataclasses.replace(state, uvel=torch.randn(
        16, 32, dtype=F64, generator=torch.Generator().manual_seed(1)))
    mesh = Mesh(2, 2)
    d = str(tmp_path / "dump")
    ptr = tmp_path / "ptr"
    dump_restart_sharded(convert.scatter_blocks(state, mesh), mesh, d,
                         istep=3, time=3.0, pointer_file=str(ptr))
    assert ptr.read_text().strip() == d
    with np.load(os.path.join(d, "shards_p0.npz")) as z:
        assert {k.split("__")[1] for k in z.files} == {
            f"p0_d{k}" for k in range(4)}
    loaded, _ = load_restart_sharded(d, state)
    want = _flat(state)
    for k, v in _flat(loaded).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
