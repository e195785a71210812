"""The span recorder (``repro_torch.spans``) and the chunk loop's counters
(``fabric.DRIVER_COUNTS``) on the CPU: a small sweep with the recorder
on gives well-formed spans (each closes inside its parent, one sweep id a
call, one ``tick`` a group tick, the nine tick kernels' spans a tick,
``tick.faults`` only with a fault class on), changes no lane of the
results and no count of the tick's operations, and off records nothing;
the counters match the ticks the loop issued and those it masked."""
import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.network import fabric
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import fat_tree3

torch.set_num_threads(1)

OPCOUNT = (Path(__file__).resolve().parents[1] / "scripts"
           / "torch_port_opcount.py")
KERNELS = ("sack_fused_own", "sack_advance_own", "nack_mark_lanes",
           "set_own_bit", "clear_own_bit", "nscc_ack", "nscc_epoch",
           "ecmp_inject", "ecmp_route")
G = fat_tree3(k=6, pods=3)
P = fabric.SimParams(chunk_ticks=64, timeout_ticks=64)


@pytest.fixture(autouse=True)
def _default_recorder():
    spans.take()
    yield
    spans.follow_profiler()
    spans.take()


def _workloads(sizes=(16, 16)):
    h = np.arange(27, dtype=np.int32)
    return fabric.Workload.stack([fabric.Workload.of(
        np.concatenate([h, h]), np.concatenate([(h + 9) % 27, (h + 3) % 27]),
        n, device="cpu") for n in sizes])


def _gray(B=2):
    """Lane 0 healthy, lane 1 with 5 % gray loss on edge 0's uplinks."""
    ok = FaultSchedule.healthy(G.num_queues, num_hosts=G.num_hosts)
    bad = ok.lossy([int(q) for q in G.up1_table[0, :]], 0.05)
    return FaultSchedule.stack([ok, bad][:B])


CASES = {"ai_full": (TransportProfile.ai_full, None),
         "resilient_gray": (TransportProfile.resilient, _gray)}


def _sweep(case, max_ticks=192, sizes=(16, 16)):
    prof, faults = CASES[case]
    return fabric.simulate_batch(
        G, _workloads(sizes), prof(), P,
        faults=None if faults is None else faults(), seeds=[3, 4],
        max_ticks=max_ticks, device="cpu")


def _lanes(rs):
    out = []
    for r in rs:
        lane = {"horizon": r.horizon,
                "comp": r.stat_completion, "src": r.stat_src_completion}
        for f in fabric.SimState.__dataclass_fields__:
            v = getattr(r.state, f)
            if isinstance(v, torch.Tensor):
                lane[f] = v.numpy()
        out.append(lane)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_sweep_records_well_formed_spans(case):
    spans.enable()
    fabric.reset_driver_counts()
    rs = _sweep(case)
    recs = spans.take()
    ticks = max(r.horizon for r in rs)
    assert fabric.DRIVER_COUNTS["ticks"] == ticks
    by_id = {r[1]: r for r in recs}
    assert len(by_id) == len(recs)
    # one sweep id, and one root: the sweep
    assert {r[3] for r in recs} == {recs[-1][3]} and recs[-1][3] > 0
    roots = [r for r in recs if r[2] == 0]
    assert [r[0] for r in roots] == ["sweep"]
    for name, _, parent, _, t0, t1 in recs:
        assert t0 <= t1, name
        if parent:
            p = by_id[parent]
            assert p[4] <= t0 and t1 <= p[5], (name, p[0])
    n = Counter(r[0] for r in recs)
    assert n["tick"] == ticks and n["driver.stats"] == ticks
    for k in KERNELS:
        assert n[f"kernels.{k}"] == ticks, k
    assert sum(v for k, v in n.items() if k.startswith("kernels.")) \
        == 9 * ticks
    for section in ("1_control", "2_grants", "3_injection", "4_forwarding",
                    "5_delivery", "6_ooo", "7_enqueue", "8_control_tc",
                    "9_timeouts", "10_recovery"):
        assert n[f"tick.{section}"] == ticks, section
    assert n["tick.6b_inc"] == 0
    # the phases sit directly under their tick, each tick's in order
    tick_ids = {r[1] for r in recs if r[0] == "tick"}
    assert all(by_id[r[2]][0] == "tick" for r in recs
               if r[0].startswith("tick.") and r[0][5].isdigit())
    assert all(by_id[r[2]][0] == "driver.issue" for r in recs
               if r[1] in tick_ids)
    assert n["driver.build"] == n["driver.results"] == 1
    assert n["driver.issue"] == n["driver.collect"] == ticks // 64
    assert n["policy.cc"] > 0 and n["policy.lb"] > 0
    if case == "ai_full":
        assert n["tick.faults"] == 0
    else:
        # the gray-link draw, once a tick, in the enqueue section
        assert n["tick.faults"] == ticks
        assert {by_id[r[2]][0] for r in recs if r[0] == "tick.faults"} \
            == {"tick.7_enqueue"}


def test_every_call_has_its_own_sweep_id():
    spans.enable()
    _sweep("ai_full", max_ticks=64)
    _sweep("ai_full", max_ticks=64)
    recs = spans.take()
    ids = sorted({r[3] for r in recs})
    assert len(ids) == 2 and 0 not in ids
    assert Counter(r[0] for r in recs)["sweep"] == 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_recorder_changes_no_lane(case):
    spans.disable()
    off = _lanes(_sweep(case))
    spans.enable()
    on = _lanes(_sweep(case))
    assert spans.take()
    for a, b in zip(off, on, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_off_the_recorder_holds_nothing():
    spans.disable()
    _sweep("resilient_gray", max_ticks=64)
    assert spans.take() == []
    spans.follow_profiler()            # the default: no profiler, no spans
    _sweep("ai_full", max_ticks=64)
    assert spans.take() == []
    assert spans.span("x") is spans.span("y")     # the shared no-op


def test_the_default_follows_the_profiler_on_its_clock():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            with torch.profiler.record_function("inside"):
                torch.ones(8).sum()
    recs = spans.take()
    assert [r[0] for r in recs] == ["outer"]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "inside"]
    assert len(ev) == 1
    _, _, _, _, t0, t1 = recs[0]
    # the profiler's events and the spans share the Unix-epoch clock
    assert t0 <= ev[0].start_ns() <= ev[0].start_ns() + \
        ev[0].duration_ns() <= t1


def test_phases_close_each_other_and_with_their_span():
    spans.enable()
    with spans.sweep():
        with spans.span("a"):
            spans.phase("p1")
            with spans.span("c"):
                pass
            spans.phase("p2")
        spans.phase("q")
        spans.phase(None)
    spans.phase("stray")
    spans.phase(None)
    recs = spans.take()
    by_id = {r[1]: r for r in recs}
    parent = {r[0]: by_id[r[2]][0] if r[2] else None for r in recs}
    assert parent == {"sweep": None, "a": "sweep", "p1": "a", "c": "p1",
                      "p2": "a", "q": "sweep", "stray": None}
    p1, p2 = (next(r for r in recs if r[0] == n) for n in ("p1", "p2"))
    assert p1[5] <= p2[4]
    # p2 was still open when its span closed: both end at once
    a = next(r for r in recs if r[0] == "a")
    assert p2[5] == a[5]
    # an open span is forgotten by take()
    with spans.span("open"):
        assert spans.take() == []
    assert spans.take() == []


def test_driver_counts_match_the_ticks_and_the_masked_ticks():
    """Lane 0's short messages drain chunks before lane 1's: the chunks
    after it stopped run the masked body."""
    fabric.reset_driver_counts()
    rs = _sweep("ai_full", max_ticks=1024, sizes=(4, 48))
    h = sorted(r.horizon for r in rs)
    assert h[0] < h[1], h
    assert fabric.DRIVER_COUNTS == {"ticks": h[1],
                                    "masked_ticks": h[1] - h[0]}
    fabric.reset_driver_counts()
    assert fabric.DRIVER_COUNTS == {"ticks": 0, "masked_ticks": 0}


def _opcount():
    spec = importlib.util.spec_from_file_location("torch_port_opcount",
                                                  OPCOUNT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("profile,ops", [("ai_full", 416), ("hpc", 431),
                                         ("ai_base", 437)])
def test_the_recorder_adds_no_tick_operation(profile, ops):
    oc = _opcount()
    args = (G, oc.healthy_workload(1), getattr(TransportProfile, profile)(),
            fabric.SimParams(), FaultSchedule.healthy(G.num_queues, batch=1,
                                                      device="cpu"), 4)
    spans.enable()
    on = oc.tick_op_counts(*args)
    assert Counter(r[0] for r in spans.take())["tick.1_control"] == 8
    spans.disable()
    off = oc.tick_op_counts(*args)
    assert on == off == {t: ops for t in range(4, 8)}
