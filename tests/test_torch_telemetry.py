"""The port's telemetry plane (``repro_torch.network.telemetry`` and the
tick's probe) against the reference package on the CPU, bitwise: the
twins of ``tests/test_telemetry.py`` (its channel-gating, idle-lane and
shared-scenario tests are in ``test_torch_telemetry_lanes.py`` with the
link layer's telemetry test and the pieces on their own; the batched and
sharded trace tests in ``test_torch_shard_lanes.py``).

Every run goes through both packages with the same inputs; the port's
probe carry (``FabricTrace.lanes``: every ring slot, stale ones
included, and every accumulator) is held bitwise against the
reference's raw carry, the f32 occupancy EWMA, RTT and cwnd rings
included, then the reference test's own assertions are repeated on the
port's result. The reference has no compile cache key here to share:
its off-spec test becomes "the off spec builds the pre-telemetry tick,
operation for operation".
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.network import fabric as jf
from repro.network import faults as jfl
from repro.network import telemetry as jtel
from repro.network import workloads as jw
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network import fabric as tf
from repro_torch.network import workloads as tw
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.telemetry import FabricTrace, TelemetrySpec
from repro_torch.network.topology import leaf_spine
from test_torch_batch import _same_state, assert_same_results
from test_torch_faults import jprofile

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fabric_golden.npz")
TRACE_FIELDS = ("ticks", "occ", "ecn", "trim", "drop", "llr", "stall",
                "peak_q", "rtt", "cwnd", "inflight", "degraded", "delivered")


def jspec(spec: TelemetrySpec) -> jtel.TelemetrySpec:
    return jtel.TelemetrySpec(**dataclasses.asdict(spec))


def _capture(monkeypatch) -> list:
    """Collect the raw probe carry the reference hands to
    ``FabricTrace.from_lanes`` (every slot of every ring), per lane."""
    carries: list = []
    orig = jf.telem.FabricTrace.from_lanes

    def capture(spec, tel, horizon):
        carries.append({k: np.asarray(v) for k, v in tel.items()})
        return orig(spec, tel, horizon)

    monkeypatch.setattr(jf.telem.FabricTrace, "from_lanes",
                        staticmethod(capture))
    return carries


def assert_same_lanes(port: dict, ref: dict, label=""):
    """The port's probe carry (``telemetry.lanes``) equals the
    reference's raw carry key for key, bitwise."""
    assert set(port) == set(ref), (label, set(port) ^ set(ref))
    for k, w in ref.items():
        g = np.asarray(port[k])
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (label, k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8),
                                      err_msg=f"{label} {k}")


def assert_traces_equal(a: FabricTrace, b, label=""):
    assert a.stride == b.stride and a.horizon == b.horizon, label
    for f in TRACE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f"{label} {f}"
            continue
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{label} {f}")


def _small_flap(fail_at=200, heal_at=700):
    """The reference test's compile-cheap victim-share flap, for both
    packages: 4 cross-leaf pairs through 2 uplinks, one uplink flapping
    mid-run, a budget the scenario does not complete in (960 ticks, the
    reference test's chunk-size budget, for all)."""
    (g, wl, exp), (jg, jwl, _) = (
        tw.victim_sweep(pairs=4, uplinks=2, size=2500),
        jw.victim_sweep(pairs=4, uplinks=2, size=2500))
    q = exp["uplinks"][0]
    sched = FaultSchedule.healthy(g.num_queues).flap(q, fail_at, heal_at)
    jsched = jfl.FaultSchedule.healthy(jg.num_queues).flap(q, fail_at,
                                                           heal_at)
    prof = TransportProfile.ai_full(lb=LBScheme.REPS)
    params = dict(ticks=960, timeout_ticks=64, ooo_threshold=24)
    return (g, wl, sched), (jg, jwl, jsched), prof, params


def run_both(monkeypatch, spec, *, chunk_ticks=None, ticks=None,
             telemetry_off_too=False):
    """The small flap through both packages' ``simulate`` with ``spec``;
    holds the results and the probe carries bitwise and returns the
    port's result (and the port's telemetry-off result)."""
    (g, wl, sched), (jg, jwl, jsched), prof, params = _small_flap()
    if chunk_ticks:
        params["chunk_ticks"] = chunk_ticks
    if ticks:
        params["ticks"] = ticks
    carries = _capture(monkeypatch)
    r = tf.simulate(g, wl, prof, tf.SimParams(**params), faults=sched,
                    telemetry=spec, device="cpu")
    j = jf.simulate(jg, jwl, jprofile(prof), jf.SimParams(**params),
                    faults=jsched, telemetry=jspec(spec))
    assert_same_results([r], [j])
    assert_same_lanes(r.telemetry.lanes, carries[0])
    assert_traces_equal(r.telemetry, j.telemetry)
    if not telemetry_off_too:
        return r
    off = tf.simulate(g, wl, prof, tf.SimParams(**params), faults=sched,
                      device="cpu")
    return r, off


# ------------------------------------------------------------------------
# spec validation + off-gating
# ------------------------------------------------------------------------

def test_spec_validation():
    assert not TelemetrySpec.off().enabled
    assert TelemetrySpec.on(probe_every=8, slots=32).enabled
    with pytest.raises(ValueError, match="probe_every"):
        TelemetrySpec(probe_every=0)
    with pytest.raises(ValueError, match="slots"):
        TelemetrySpec(slots=7)
    with pytest.raises(ValueError, match="slots"):
        TelemetrySpec(slots=0)
    with pytest.raises(ValueError, match="ewma_shift"):
        TelemetrySpec(ewma_shift=17)
    # the copy has the reference's fields and defaults
    for spec in (TelemetrySpec.off(), TelemetrySpec.on(),
                 TelemetrySpec.on(8, 32, flows=False, ewma_shift=5)):
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec(spec))
    assert dataclasses.asdict(TelemetrySpec.on()) == dataclasses.asdict(
        jtel.TelemetrySpec.on())


def test_off_spec_builds_the_pre_telemetry_tick():
    """None and TelemetrySpec.off() build the pre-telemetry tick: the
    same ATen operations in the same order and no probe lane; an enabled
    spec adds the probe."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    g = leaf_spine(leaves=2, spines=2, hosts_per_leaf=2)
    wl = tf.Workload.stack([tf.Workload.of([0, 1], [2, 3], 30)])
    prof, p = TransportProfile.ai_full(), tf.SimParams()
    fault = FaultSchedule.healthy(g.num_queues, batch=1)
    s = tf.init_state(g, wl, prof, p, device="cpu")
    seen = []
    for tel in (None, TelemetrySpec.off(), TelemetrySpec.on()):
        step = tf.make_step(g, prof, p, 2, tel=tel, device="cpu")
        with Ops() as ops:
            _, out = step(s, 0, wl, fault)
        seen.append((ops.names, sorted(out)))
    assert seen[0] == seen[1]
    assert "probe" not in seen[0][1] and "probe" in seen[2][1]
    assert len(seen[2][0]) > len(seen[0][0])


def test_telemetry_off_keeps_golden_full_trace_bitwise():
    gold = np.load(GOLDEN)
    g = leaf_spine(leaves=2, spines=4, hosts_per_leaf=4)
    wl = tf.Workload.of([0, 1, 2], [4, 5, 6], 200)
    r = tf.simulate(g, wl, TransportProfile.ai_full(), tf.SimParams(ticks=300),
                    trace="full", telemetry=TelemetrySpec.off(), device="cpu")
    assert r.telemetry is None
    h = r.horizon
    np.testing.assert_array_equal(r.delivered_per_tick,
                                  gold["a_delivered"][:h])
    np.testing.assert_array_equal(r.cwnd_per_tick, gold["a_cwnd"][:h])
    np.testing.assert_array_equal(r.state.delivered.numpy(),
                                  gold["a_state_delivered"])


@pytest.mark.parametrize("entry", ["simulate", "simulate_batch"])
def test_enabled_spec_rejects_full_trace_and_wrong_types(entry):
    (g, wl, _), _, prof, params = _small_flap()
    call = getattr(tf, entry)
    wl = wl if entry == "simulate" else [wl, wl]
    p = tf.SimParams(**params)
    with pytest.raises(ValueError, match="stats"):
        call(g, wl, prof, p, trace="full", telemetry=TelemetrySpec.on(),
             device="cpu")
    for bad in (True, object()):
        with pytest.raises(TypeError, match="TelemetrySpec"):
            call(g, wl, prof, p, telemetry=bad, device="cpu")


# ------------------------------------------------------------------------
# probes observe, never perturb
# ------------------------------------------------------------------------

def test_probes_do_not_perturb_and_counters_mirror_state(monkeypatch):
    r_on, r_off = run_both(monkeypatch, TelemetrySpec.on(),
                           telemetry_off_too=True)
    assert r_on.horizon == r_off.horizon
    _same_state(r_on.state, r_off.state)
    assert r_off.telemetry is None
    tr = r_on.telemetry
    assert isinstance(tr, FabricTrace) and tr.spec.enabled
    assert tr.num_samples > 0 and tr.horizon == r_on.horizon
    for r in (r_on, r_off):
        assert r.trims == int(r.state.trims)
        assert r.drops == int(r.state.drops)
        assert r.dups == int(r.state.dups)
    assert r_on.drops > 0, "the flap must actually drop packets"
    assert int(tr.drop[-1].sum()) == int(tr.final["drop_q"].sum())


def test_chunk_size_is_invisible_in_the_probe_lanes(monkeypatch):
    """64 / 96 / 128-tick chunks (the last with a partial final chunk)
    give the identical carry, the first bitwise the reference's."""
    lanes = [run_both(monkeypatch, TelemetrySpec.on(), chunk_ticks=64,
                      ticks=960).telemetry]
    (g, wl, sched), _, prof, params = _small_flap()
    for ck in (96, 128):
        r = tf.simulate(g, wl, prof, tf.SimParams(**{
            **params, "ticks": 960, "chunk_ticks": ck}), faults=sched,
            telemetry=TelemetrySpec.on(), device="cpu")
        assert r.horizon == 960, f"chunk {ck}: scenario must not complete"
        lanes.append(r.telemetry)
    assert_traces_equal(lanes[0], lanes[1], "chunk 64 vs 96")
    assert_traces_equal(lanes[0], lanes[2], "chunk 64 vs 128")
    assert_same_lanes(lanes[0].lanes, lanes[2].lanes)


# ------------------------------------------------------------------------
# adaptive decimation
# ------------------------------------------------------------------------

def test_decimation_keeps_the_ring_uniform_at_any_horizon(monkeypatch):
    tr = run_both(monkeypatch, TelemetrySpec.on(probe_every=16,
                                                slots=8)).telemetry
    assert tr.stride > 1, "the ring must have decimated"
    assert 0 < tr.num_samples <= 8
    assert tr.ticks[0] == 0
    assert (np.diff(tr.ticks) == tr.sample_spacing).all()
    assert tr.sample_spacing == tr.stride * 16


def test_finer_probe_every_agrees_at_common_sample_ticks(monkeypatch):
    fine = run_both(monkeypatch, TelemetrySpec.on(probe_every=8)).telemetry
    (g, wl, sched), _, prof, params = _small_flap()
    coarse = tf.simulate(g, wl, prof, tf.SimParams(**params), faults=sched,
                         telemetry=TelemetrySpec.on(probe_every=16),
                         device="cpu").telemetry
    common, fi, ci = np.intersect1d(fine.ticks, coarse.ticks,
                                    return_indices=True)
    assert common.size >= 16, "grids must overlap substantially"
    for f in ("occ", "ecn", "trim", "drop", "rtt", "cwnd", "inflight",
              "degraded", "delivered"):
        np.testing.assert_array_equal(getattr(fine, f)[fi],
                                      getattr(coarse, f)[ci], err_msg=f)
    np.testing.assert_array_equal(fine.peak_q, coarse.peak_q)


def test_window_rates_are_exact_across_decimation(monkeypatch):
    tr = run_both(monkeypatch, TelemetrySpec.on(slots=16)).telemetry
    assert tr.stride > 1
    last = int(tr.ticks[-1])
    r = tr.window_rates(0, last + 1)
    assert float(r["drop"].sum()) * (last + 1) == pytest.approx(
        float(tr.drop[-1].sum()))
