"""The span readers (``metrics/tick.host_ms``, ``kernels.wrapper_us``,
``driver.build_ms``, ``driver.masked_tick_share``) and the joins of
``spantrace.py`` on a synthetic trace: device operations with their
correlation ids, the runtime calls that launched them, and nested spans,
with one idle gap ended by an operation launched in ``tick.faults`` and
one in ``driver.collect``. Then the harness on the tiny cells: the
traced sweep carries the program's spans to the readers, and the six
older readers read what they read with the spans off."""
import json

import pytest
import torch

from conftest import ROOT

from portbench import harness, spantrace

METRICS = ROOT / "portbench" / "metrics"
SPAN_READERS = ("tick.host_ms", "kernels.wrapper_us", "driver.build_ms",
                "driver.masked_tick_share")
OLD_READERS = ("driver.frozen_share", "tick.device_ms", "tick.device_ops",
               "kernels.roofline_share", "kernels.launches_per_tick",
               "device.idle_share")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py")


#: (name, id, parent, sweep, start ns, end ns): one sweep, its build, one
#: chunk of two ticks, its collect and the results
SPANS = [
    ("driver.build", 2, 1, 7, 100, 300),
    ("kernels.sack_fused_own", 6, 5, 7, 1100, 1200),
    ("tick.1_control", 5, 4, 7, 1000, 1500),
    ("tick.faults", 8, 7, 7, 1600, 1700),
    ("tick.7_enqueue", 7, 4, 7, 1500, 1900),
    ("tick", 4, 3, 7, 1000, 2000),
    ("kernels.ecmp_route", 10, 9, 7, 2100, 2150),
    ("tick", 9, 3, 7, 2000, 2400),
    ("driver.issue", 3, 1, 7, 900, 2500),
    ("driver.collect", 11, 1, 7, 2500, 3000),
    ("driver.results", 12, 1, 7, 3000, 3040),
    ("sweep", 1, 0, 7, 0, 3100),
]
#: {correlation id: host ns of the launch}
LAUNCHES = {1: 150, 2: 1150, 3: 1650, 4: 2120, 5: 2700, 6: 2200}
#: (name, start ns, end ns, correlation id): the device runs behind the
#: host; gaps before ops 3 (in tick.faults) and 5 (in driver.collect);
#: op 9's launch was not traced
DEVICE = [
    ("copy", 200, 1200, 1),
    ("void (anonymous namespace)::sack_kernel<true, true, 4>(Args)",
     1200, 2000, 2),
    ("hash", 2500, 3000, 3),
    ("ecmp_route_kernel", 3000, 3400, 4),
    ("quiet", 4000, 4100, 5),
    ("where", 4100, 4300, 6),
    ("lost", 4300, 4400, 9),
]


def test_self_times_and_paths():
    st = spantrace.self_times(SPANS)
    assert st["tick"] == pytest.approx((1000 - 500 - 400 + 400 - 50) / 1e9)
    assert st["tick.7_enqueue"] == pytest.approx(300 / 1e9)
    assert st["sweep"] == pytest.approx((3100 - 200 - 1600 - 500 - 40)
                                        / 1e9)
    p = spantrace.paths(SPANS)
    assert p[8] == "sweep/driver.issue/tick/tick.7_enqueue/tick.faults"
    assert p[0] == ""


def test_attribution_by_launch():
    got = spantrace.attribute(SPANS, LAUNCHES, DEVICE)
    assert got == ["driver.build",
                   "driver.issue/tick/tick.1_control/kernels.sack_fused_own",
                   "driver.issue/tick/tick.7_enqueue/tick.faults",
                   "driver.issue/tick/kernels.ecmp_route",
                   "driver.collect", "driver.issue/tick",
                   spantrace.NO_LAUNCH]
    # a launch outside the sweep, at a span's bounds
    assert spantrace.attribute(SPANS, {1: 5000, 2: 1000}, DEVICE[:2]) == [
        spantrace.NO_SPAN, "driver.issue/tick/tick.1_control"]


def test_span_breakdown_and_coverage():
    b = spantrace.span_breakdown(SPANS, LAUNCHES, DEVICE)
    dev = dict(b["device_by_span"])
    assert dev["driver.build"] == pytest.approx(1000e-9)
    assert dev[spantrace.NO_LAUNCH] == pytest.approx(100e-9)
    idle = dict(b["idle_by_span"])
    assert idle == {"driver.issue/tick/tick.7_enqueue/tick.faults":
                    pytest.approx(500e-9),
                    "driver.collect": pytest.approx(600e-9)}
    host = dict(b["host_by_span"])
    assert host["driver.collect"] == pytest.approx(500e-9)
    # the ten largest of eleven names: the results' 40 ns left out
    assert len(host) == 10 and "driver.results" not in host
    assert b["coverage"]["busy"] == pytest.approx(3000 / 3100)
    assert b["coverage"]["idle"] == 1.0


def test_runtime_calls_by_span():
    calls = [("cudaLaunchKernel", t, t + 10, c) for c, t in LAUNCHES.items()]
    calls += [("cudaStreamSynchronize", 1620, 1690, 0),
              ("cudaStreamSynchronize", 2600, 2990, 0)]
    assert spantrace.launch_times(calls) == LAUNCHES
    got = dict(spantrace.runtime_by_span(SPANS, calls))
    assert got["cudaStreamSynchronize @ driver.issue/tick/tick.7_enqueue/"
               "tick.faults"] == pytest.approx(70e-9)
    assert got["cudaStreamSynchronize @ driver.collect"] == \
        pytest.approx(390e-9)
    assert got["cudaLaunchKernel @ driver.build"] == pytest.approx(10e-9)
    assert sum(got.values()) == pytest.approx((6 * 10 + 70 + 390) / 1e9)


def test_faults_device_time_per_tick():
    assert spantrace.faults_device_ms(SPANS, LAUNCHES, DEVICE) == \
        pytest.approx(500e-6 / 2)
    healthy = [r for r in SPANS if r[0] != "tick.faults"]
    assert spantrace.faults_device_ms(healthy, LAUNCHES, DEVICE) is None


def test_clock_check():
    sites = reader("kernels.roofline_share").SITES
    c = spantrace.clock_check(SPANS, LAUNCHES, DEVICE, sites)
    assert c == {"launches": 2, "inside": 1.0}
    # a clock 1 us late puts both launches outside their spans
    late = {k: t + 1000 for k, t in LAUNCHES.items()}
    assert spantrace.clock_check(SPANS, late, DEVICE, sites) == {
        "launches": 2, "inside": 0.0}
    assert spantrace.clock_check(SPANS, {}, DEVICE, sites) == {"launches": 0}


def test_span_readers_on_the_synthetic_spans():
    ctx = {"spans": SPANS}
    assert reader("tick.host_ms").read(ctx) == pytest.approx(
        (1000 + 400) / 2 / 1e6)
    assert reader("kernels.wrapper_us").read(ctx) == pytest.approx(
        (100 + 50) / 2 / 1e3)
    assert reader("driver.build_ms").read(ctx) == pytest.approx(200 / 1e6)
    for name in ("tick.host_ms", "kernels.wrapper_us", "driver.build_ms"):
        assert reader(name).read({"spans": None}) is None
        assert reader(name).read({"spans": []}) is None


def test_records_are_the_last_sweeps_and_taken_once(monkeypatch):
    other = [("tick", 99, 98, 3, 0, 10), ("stray", 97, 0, 0, 0, 1)]
    calls = []
    monkeypatch.setattr(spantrace, "_take",
                        lambda: calls.append(1) or other + SPANS)
    ctx = {}
    assert spantrace.records(ctx) == SPANS
    assert spantrace.records(ctx) == SPANS and calls == [1]
    # a program without spans: every span reader gives None
    monkeypatch.setattr(spantrace, "_take", lambda: None)
    for name in SPAN_READERS[:3]:
        assert reader(name).read({}) is None


def test_masked_share_reads_the_driver_counts(monkeypatch):
    from repro_torch.network import fabric
    r = reader("driver.masked_tick_share")
    monkeypatch.setattr(fabric, "DRIVER_COUNTS",
                        {"ticks": 3072, "masked_ticks": 768})
    assert r.read({}) == pytest.approx(25.0)
    monkeypatch.setattr(fabric, "DRIVER_COUNTS",
                        {"ticks": 0, "masked_ticks": 0})
    assert r.read({}) is None
    monkeypatch.delattr(fabric, "DRIVER_COUNTS")
    assert r.read({}) is None


def test_the_manifest_names_the_span_readers():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = {x["name"]: x for x in m["per_layer"]}
    for name in SPAN_READERS:
        assert got[name]["moves"] == "scenario_ticks_per_s"
        assert got[name]["source"] == ("program_counter" if name.startswith(
            "driver.masked") else "program_span")
    assert [x["name"] for x in m["per_layer"]][:6] == list(OLD_READERS)


@pytest.mark.parametrize("cell", ["tiny-ai_full.tiny-perm2-b2",
                                  "tiny-resilient.tiny-faults-b4"])
def test_the_traced_sweep_carries_spans_and_moves_no_older_reading(
        tiny, cell):
    from repro_torch import spans
    cpu = torch.device("cpu")
    try:
        spans.disable()
        off = harness.run_cell(tiny, cell, 5, 0.1, True, cpu, 0.0)
    finally:
        spans.follow_profiler()
    on = harness.run_cell(tiny, cell, 5, 0.1, True, cpu, 0.0)
    assert on["correct"] and off["correct"]
    for name in SPAN_READERS[:3]:
        assert name not in off["metrics"]
        assert on["metrics"][name]["value"] > 0, name
    assert on["metrics"]["tick.host_ms"]["unit"] == "ms"
    share = on["metrics"]["driver.masked_tick_share"]["value"]
    assert 0 <= share <= 100
    for name in OLD_READERS:
        assert on["metrics"].get(name) == off["metrics"].get(name), name
    assert on["breakdown"] == off["breakdown"]
    assert spans.take() == []          # the readers took the spans
