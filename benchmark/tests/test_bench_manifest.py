"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the configuration and traffic files each entry names, and the
length of a full check."""

import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(m["command"]) <= 32 and all(line(w) for w in m["command"])
    for w in m["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_and_units():
    m = manifest()
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics():
    m = manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert 1 <= len(m["per_layer"]) <= 128
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert p["moves"] in e2e and line(p["layer"])
        if p["name"].endswith("_roofline") or "mfu" in p["name"]:
            assert p["unit"] == "%"


def test_every_cell_reports_enough():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    for cell in cells:
        e2e = [e["name"] for e in m["end_to_end"]
               if cell in e.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in p.get("workloads", cells) for p in m["per_layer"])


def test_files_of_each_entry():
    m = manifest()
    files = set()
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert cfg["dtype"] in ("float32", "float64")
        assert any(w["config"] == c["name"] for w in m["workloads"])
    for w in m["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        assert t["why"] == w["why"]
        assert t["entry"] in ("driver", "component")
        assert all(v > 0 for v in t["limits"].values())


def test_a_full_check_fits():
    """2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to
    compile and 1200 s spare, with the full 24 cells."""
    rs = manifest()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
