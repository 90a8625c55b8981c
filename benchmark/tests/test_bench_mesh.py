"""The cell on four cards, ``access-om2-01.coupled``: its mesh metrics'
readers on a trace with NCCL's rows, and the cell itself on four ranks on
the CPU over gloo at a 48x40 cut of its grid (its entry, the port's
component on one block a rank; its reference in 8 bands), traced and
untraced."""

import json
import re

import pytest

from harness import cell, ranks
from harness.trace import TraceRecord

NAME = "access-om2-01.coupled"
CUT = {"domain.nx_global": 48, "domain.ny_global": 40, "dynamics.ndte": 3}


def record(**kw):
    base = dict(steps=4, wall_s=1.2, step_s=0.3, device_rows=[], busy_s=0.0,
                syncs=0, sync_sites=[], forcing_s=None, kernel_bound_ms={},
                step_bound_ms=0.0, breakdown={})
    base.update(kw)
    return TraceRecord(**base)


def read(name, r):
    return cell.metric_reader(name).read(r)


def test_mesh_readers():
    rows = [("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
             0.02, 320),
            ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage"
             "<4096ul>)", 0.004, 8),
            ("void at::native::vectorized_elementwise_kernel<4>", 0.5, 4000)]
    r = record(device_rows=rows, busy_s=0.6, wait_s=0.0031)
    assert read("mesh.exchange_ms", r) == pytest.approx(5.0)
    assert read("mesh.gathers", r) == pytest.approx(2.0)
    assert read("mesh.wait_ms", r) == pytest.approx(3.1)
    quiet = record(device_rows=rows[2:], busy_s=0.5)
    assert read("mesh.gathers", quiet) == 0.0
    assert read("mesh.exchange_ms", quiet) is None
    assert read("mesh.wait_ms", quiet) is None


def run(tmp_path, **spec):
    spec = {"name": NAME, "seed": 3_000_000_211, "seconds": 0.1,
            "trace": False, "device": "cpu", "dtype": "float64",
            "overrides": CUT, **spec}
    out, err = tmp_path / "out.txt", tmp_path / "err.txt"
    with open(out, "w") as fo, open(err, "w") as fe:
        rc = ranks.launch(spec, 4, stdout=fo, stderr=fe)
    return rc, out.read_text().splitlines(), err.read_text()


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_on_four_ranks(tmp_path, monkeypatch, trace):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    rc, lines, err = run(tmp_path, trace=trace)
    assert rc == 0, err[-3000:]
    out = json.loads(lines[-1])
    assert out["correct"], err[-3000:]
    for k, c in out["checks"].items():
        assert c["value"] <= 1e-12, (k, c)
    # each rank held its 20x24 block of the 40x48 grid
    blocks = re.findall(r"rank (\d) of 4 on cpu: rows (\d+):(\d+), columns "
                        r"(\d+):(\d+)", err)
    assert sorted(blocks) == [("0", "0", "20", "0", "24"),
                              ("1", "0", "20", "24", "48"),
                              ("2", "20", "40", "0", "24"),
                              ("3", "20", "40", "24", "48")]
    assert err.count("reference band ") == 8
    if trace:
        assert set(out["metrics"]) == {"mesh.wait_ms"}
    else:
        assert set(out["metrics"]) == {"sypd", "step_ms_p90", "setup_s"}
