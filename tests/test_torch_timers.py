"""`timers.Timers`, the port's one span system: nested regions named by
their path, counters, the report, no synchronisation while regions run,
the spans a driver step and a coupling interval open, and the spans on a
``torch.profiler`` trace.  CPU only, no JAX."""

import threading

import pytest
import torch

from cice4_tpu_torch import kernel_check, timers
from cice4_tpu_torch.component import IceComponent
from cice4_tpu_torch.config import access_om_config, gx1_config
from cice4_tpu_torch.coupling import A2I_FIELDS, O2I_FIELDS
from cice4_tpu_torch.driver import IceModelRun
from cice4_tpu_torch.timers import Timers

NY, NX = 24, 32
MODEL_SPANS = {"Step/Shortwave", "Step/Thermo", "Step/CatConv",
               "Step/Dynamics", "Step/Dynamics/Advection",
               "Step/Dynamics/Ridging", "Step/Coupling"}


def test_regions_nest_and_count():
    t = Timers()
    with t("Step"):
        with timers.span("Dynamics"):
            with timers.span("Advection"):
                pass
            timers.count("ridge_passes", 3)
        with t("Thermo"):
            pass
    with t("Step"):
        t.count("ridge_passes")
    assert set(t.host_ns) == {"Step", "Step/Dynamics",
                              "Step/Dynamics/Advection", "Step/Thermo"}
    assert t.counts == {"Step": 2, "Step/Dynamics": 1,
                        "Step/Dynamics/Advection": 1, "Step/Thermo": 1}
    assert t.counters == {"ridge_passes": 4}
    assert t.host_ns["Step"] >= t.host_ns["Step/Dynamics"] \
        >= t.host_ns["Step/Dynamics/Advection"] > 0
    totals = t.totals
    assert totals["Step"] == pytest.approx(1e-9 * t.host_ns["Step"])
    assert totals["Forcing"] == 0.0
    report = t.report().splitlines()
    assert report[0] == "Timing information:"
    assert report[1].split()[0] == "Total"
    names = [line.split()[0] for line in report[2:]]
    assert names == ["Step", "Step/Dynamics", "Step/Dynamics/Advection",
                     "Step/Thermo", "Counters:", "ridge_passes"] or \
        names == ["Step", "Step/Thermo", "Step/Dynamics",
                  "Step/Dynamics/Advection", "Counters:", "ridge_passes"]
    assert "(2x)" in report[2]
    # the spans left no Timers active behind them
    assert timers.span("Step") is timers.span("Other")


def test_device_counts_are_read_when_the_counters_are():
    """A count given as a 0-d tensor (the ridging passes on a card) stays
    a tensor until `counters` or the report is read; past `FOLD` of them
    they are summed into one."""
    t = Timers()
    with t("Step"):
        timers.count("ridge_passes", torch.tensor(3, dtype=torch.int32))
        timers.count("ridge_passes", 2)
    assert len(t._device_counts["ridge_passes"]) == 1
    for _ in range(Timers.FOLD - 1):
        t.count("ridge_passes", torch.tensor(1, dtype=torch.int32))
    assert len(t._device_counts["ridge_passes"]) == 1
    assert t.counters == {"ridge_passes": 4 + Timers.FOLD}
    assert not t._device_counts["ridge_passes"]
    t.count("ridge_passes", torch.tensor(4))
    assert t.report().splitlines()[-1].split() == [
        "ridge_passes", str(8 + Timers.FOLD)]


def test_span_without_active_timers_does_nothing():
    null = timers.span("Thermo")
    assert null is timers.span("Dynamics")
    with null:
        timers.count("ridge_passes", 2)
    # a thread other than the one whose region is open sees no Timers
    t = Timers()
    seen = []
    with t("Step"):
        thread = threading.Thread(
            target=lambda: seen.append(timers.span("Thermo")))
        thread.start()
        thread.join(timeout=10)
    assert not thread.is_alive() and seen == [null]
    assert set(t.host_ns) == {"Step"} and not t.counters


class _Event:
    """A stand-in CUDA event: completes when the test says so; waiting
    on it or timing it before it completes fails."""

    done = False
    synchronised = 0

    def __init__(self):
        self.t = None

    def record(self):
        self.t = len(_Event.log)
        _Event.log.append(self)

    def query(self):
        return _Event.done

    def synchronize(self):
        if not _Event.waits_allowed:
            raise AssertionError("a region waited for the device")
        _Event.synchronised += 1

    def elapsed_time(self, end):
        assert _Event.done or _Event.waits_allowed, \
            "timed a pair the device has not finished"
        return 1000.0 * (end.t - self.t)      # ms: a second a recording


def test_region_exit_never_synchronises(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("torch.cuda.synchronize in a region")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(Timers, "_new_event", staticmethod(_Event))
    monkeypatch.setattr(_Event, "log", [], raising=False)
    monkeypatch.setattr(_Event, "waits_allowed", False, raising=False)
    monkeypatch.setattr(_Event, "done", False)
    t = Timers(device="cuda")
    for _ in range(3):
        with t("Step"):
            with timers.span("Thermo"):      # inner: host time only
                pass
    assert len(_Event.log) == 6 and len(t._pending) == 3
    # the device has finished: the next region's exit resolves every
    # pair, its own included, without waiting
    _Event.done = True
    with t("History"):
        pass
    assert not t._pending and len(t._free) == 8
    _Event.done = False
    with t("Step"):
        pass
    assert len(t._pending) == 1 and len(_Event.log) == 10
    # reading the totals waits for the last pair, and only then
    _Event.waits_allowed = True
    totals = t.totals
    assert _Event.synchronised == 1 and not t._pending
    # each pair one recording apart: one second of device time, more
    # than the host's
    assert totals["Step"] == pytest.approx(4.0)
    assert totals["History"] == pytest.approx(1.0)
    assert totals["Step/Thermo"] == pytest.approx(
        1e-9 * t.host_ns["Step/Thermo"])


def _gx1_run(tmp_path, **over):
    cfg = gx1_config().with_values(**{
        "grid.kmt_file": "", "domain.ny_global": NY, "domain.nx_global": NX,
        "run.diagfreq": 1, "run.history_dir": str(tmp_path / "history"),
        "run.restart_dir": str(tmp_path / "restart"),
        "run.pointer_file": str(tmp_path / "restart" / "pointer"),
        "run.dumpfreq": "1", **over})
    return IceModelRun(cfg, device="cpu", log=lambda *a: None).initialize()


@pytest.mark.parametrize("advection", ["remap", "upwind"])
def test_a_driver_step_opens_every_span(tmp_path, advection):
    run = _gx1_run(tmp_path, **{"transport.advection": advection})
    model = run.model
    seen = []

    def spy(*args):
        state, fluxes = model(*args)
        seen.append(fluxes["_ridge_niter"])
        return state, fluxes

    run.model = spy
    run.run(1)
    t = run.timers
    assert set(t.counts) == {"Init", "Forcing", "Forcing/Read",
                             "Forcing/Ocean", "Step", "History", "Diags",
                             "ReadWrite"} | MODEL_SPANS
    # Diags: the budget's start totals and the diagnostics after the step
    assert t.counts["Diags"] == 2
    assert all(n == 1 for k, n in t.counts.items() if k != "Diags")
    assert t.counters == {"ridge_passes": seen[0]} and seen[0] >= 1
    report = run.finalize().report()
    for name in ("Init", "Forcing", "Step", "History", "Diags",
                 "ReadWrite", "Step/Dynamics/Ridging", "ridge_passes"):
        assert f" {name} " in report, name


def test_a_coupling_interval_opens_every_span():
    cfg = access_om_config(nx=NX, ny=NY).with_values(**{
        "run.diagfreq": 0})
    comp = IceComponent(cfg, flavor="om", dtype=torch.float64,
                        log=lambda *a: None, gfdl_surface_flux=True,
                        device="cpu").initialize()
    comp.run({"a2i": kernel_check.coupler_fields(A2I_FIELDS, NY, NX, 3,
                                                 device="cpu"),
              "o2i": kernel_check.coupler_fields(O2I_FIELDS, NY, NX, 4,
                                                 device="cpu")}, n_steps=2)
    t = comp.runner.timers
    assert set(t.counts) == {"Init", "Receive", "Step", "History",
                             "Send"} | MODEL_SPANS
    assert t.counts["Init"] == 2          # the runner's and the coupler's
    assert t.counts["Step"] == t.counts["History"] == 2
    assert t.counts["Receive"] == t.counts["Send"] == 1
    assert t.counters["ridge_passes"] >= 2


def test_spans_sit_on_the_profiler_trace(tmp_path, monkeypatch):
    run = _gx1_run(tmp_path, **{"run.diagfreq": 0, "run.dumpfreq": "x"})
    # without a profiler no span is made
    monkeypatch.setattr(torch.profiler, "record_function", None)
    run.run(1)
    monkeypatch.undo()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.run(1)
    events = prof.profiler.kineto_results.events()
    spans = {}
    ops = []
    for e in events:
        if e.is_user_annotation():
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        else:
            ops.append((e.start_ns(), e.name()))
    assert set(spans) == {"Forcing", "Forcing/Read", "Forcing/Ocean",
                          "Step", "History"} | MODEL_SPANS
    (s0, s1), = spans["Step"]
    (t0, t1), = spans["Step/Thermo"]
    (d0, d1), = spans["Step/Dynamics"]
    (r0, r1), = spans["Step/Dynamics/Ridging"]
    assert s0 <= t0 < t1 <= d0 <= r0 < r1 <= d1 <= s1
    # the operations of the phase lie inside its span on the same clock
    assert any(t0 <= at <= t1 and name.startswith("aten::")
               for at, name in ops)
    assert min(at for at, _n in ops) < t0
