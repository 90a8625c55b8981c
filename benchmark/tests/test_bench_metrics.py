"""Each per-layer metric's reader, found by its name: its layer, unit and
the end-to-end metric it moves as BENCHMARK.json has them, and what it
reads from a trace record."""

import json
from pathlib import Path

import pytest

from harness import cell
from harness.trace import TraceRecord

BENCH = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
PER_LAYER = MANIFEST["per_layer"]


@pytest.mark.parametrize("entry", PER_LAYER, ids=lambda e: e["name"])
def test_reader_found_by_name(entry):
    mod = cell.metric_reader(entry["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"],
                                                entry["unit"],
                                                entry["moves"])
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for e in MANIFEST["end_to_end"]:
        if e["name"] == entry["moves"]:
            reported = set(e.get("workloads", cells))
    assert set(entry.get("workloads", cells)) <= reported


def record(**kw):
    base = dict(steps=4, wall_s=0.8, step_s=0.25, device_rows=[], busy_s=0.0, syncs=0,
                sync_sites=[], forcing_s=None, kernel_bound_ms={},
                step_bound_ms=0.0, breakdown={})
    base.update(kw)
    return TraceRecord(**base)


@pytest.mark.parametrize("entry", PER_LAYER, ids=lambda e: e["name"])
def test_reader_finds_nothing_in_an_empty_trace(entry):
    assert cell.metric_reader(entry["name"]).read(record()) is None


def test_readers_on_a_trace():
    rows = [("void therm_newton_kernel<float, 4, 1>(Args<float, 4>)", 0.004, 4),
            ("gsh_fused<float, 2, false>", 0.002, 4),
            ("void k12<float, false>(float const*)", 0.008, 4),
            ("void evp_persistent<float>(Args<float>)", 0.02, 4),
            ("void at::native::vectorized_elementwise_kernel<4>", 0.05, 400),
            ("Memcpy DtoH (Device -> Pinned)", 0.001, 8)]
    r = record(device_rows=rows, busy_s=0.08, syncs=12, forcing_s=0.02,
               kernel_bound_ms={"therm_newton": 0.1, "remap_gsh": 0.05,
                                "remap_k12": 0.2, "evp_subcycle": 1.0},
               step_bound_ms=0.4)

    def read(name):
        return cell.metric_reader(name).read(r)

    assert read("driver.forcing_ms") == pytest.approx(5.0)
    assert read("step.launches") == pytest.approx(106.0)
    assert read("step.host_syncs") == pytest.approx(3.0)
    assert read("phases.device_ms") == pytest.approx(12.75)
    # bounds 4 launches each: (0.1 + 0.05 + 0.2 + 1.0) * 4 ms over 34 ms
    assert read("kernels.roofline_pct") == pytest.approx(100 * 5.4 / 34.0)
    # against the untraced step of 250 ms, not the traced 200 ms a step
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 20 / 250))
    assert read("device.mfu_step_pct") == pytest.approx(100 * 0.4 / 250)
