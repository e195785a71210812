"""Probe rings, link lanes and host lanes on the split scenario axis,
against the reference package on the CPU, bitwise (helpers:
``test_torch_shard.py``, ``test_torch_telemetry.py``): the batched and
sharded trace tests of ``tests/test_telemetry.py``, the sharded test of
``tests/test_link_layer.py`` and that of ``tests/test_resilience.py``.
The port splits over a repeated CPU device, the reference over the 4
virtual devices of ``conftest.py``.
"""
from dataclasses import replace

import jax
import numpy as np
import torch

from repro.network import fabric as jf
from repro.network import faults as jfl
from repro.network import workloads as jw
from repro_torch.network import fabric as tf
from repro_torch.network import shard
from repro_torch.network import workloads as tw
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.telemetry import TelemetrySpec
from test_torch_batch import _same_state, assert_same_results
from test_torch_faults import jprofile
from test_torch_shard import CPU, _sharded, multi_device
from test_torch_telemetry import (_capture, _small_flap, assert_same_lanes,
                                  assert_traces_equal, jspec)

torch.set_num_threads(1)


# ------------------------------------------------------------------------
# probe rings across serial / batched / sharded runs
# ------------------------------------------------------------------------

def _flap_batch():
    """The reference's ragged 3-lane flap batch for both packages: one
    lane completes mid-run, two run to the budget; per-lane fault
    windows and seeds."""
    (g, wl, _), (jg, jwl, _), prof, params = _small_flap()
    sizes = (300, 2500, 900)
    wls = [replace(wl, size=torch.full_like(wl.size, s)) for s in sizes]
    jwls = jf.Workload.stack([replace(jwl, size=jax.numpy.full_like(
        jwl.size, s)) for s in sizes])
    q = int(g.up1_table[0, 0])
    wins = ((200, 500), (300, 800), (100, 1100))

    def scheds(FS):
        return FS.stack([FS.healthy(g.num_queues).flap(q, *w) for w in wins])

    seeds = np.arange(3, dtype=np.uint32) + 0x5EED
    return (g, wls), (jg, jwls), scheds, prof, params, seeds


def test_batched_traces_match_serial_bitwise(monkeypatch):
    (g, wls), (jg, jwls), scheds, prof, params, seeds = _flap_batch()
    spec = TelemetrySpec.on()
    p = tf.SimParams(**params)
    carries = _capture(monkeypatch)
    rs = tf.simulate_batch(g, wls, prof, p, faults=scheds(FaultSchedule),
                           seeds=seeds, telemetry=spec, device="cpu")
    js = jf.simulate_batch(jg, jwls, jprofile(prof), jf.SimParams(**params),
                           faults=scheds(jfl.FaultSchedule), seeds=seeds,
                           telemetry=jspec(spec))
    assert_same_results(rs, js)
    assert len({r.horizon for r in rs}) > 1, "batch must be ragged"
    for i, r in enumerate(rs):
        assert_same_lanes(r.telemetry.lanes, carries[i], f"lane {i}")
    # the lane that stops mid-run against the port's own serial run
    # (the reference holds its serial runs to its batch)
    for i in (0,):
        r = rs[i]
        solo = tf.simulate(g, wls[i], prof, p,
                           faults=tf.take_lane(scheds(FaultSchedule), i),
                           seed=int(seeds[i]), telemetry=spec, device="cpu")
        assert solo.horizon == r.horizon, f"lane {i}"
        _same_state(solo.state, r.state)
        assert_traces_equal(solo.telemetry, r.telemetry, f"lane {i}")
        assert_same_lanes(solo.telemetry.lanes, r.telemetry.lanes)


@multi_device
def test_sharded_traces_match_batched_bitwise(monkeypatch):
    """B = 3 through ``run_sharded`` over (cpu, cpu) (one padding lane)
    with per-lane schedules: the probe carries equal the reference's
    sharded ones."""
    (g, wls), (jg, jwls), scheds, prof, params, seeds = _flap_batch()
    spec = TelemetrySpec.on()
    carries = _capture(monkeypatch)
    shd = shard.run_sharded(g, tf.Workload.stack(wls), prof,
                            tf.SimParams(**params), scheds(FaultSchedule),
                            seeds, "stats", params["ticks"], None,
                            (CPU, CPU), tel=spec)
    ref = jf.simulate_batch(jg, jwls, jprofile(prof), jf.SimParams(**params),
                            faults=scheds(jfl.FaultSchedule), seeds=seeds,
                            telemetry=jspec(spec), shard=True)
    assert len(shd) == len(ref) == 3
    assert_same_results(shd, ref)
    for i, r in enumerate(shd):
        assert_same_lanes(r.telemetry.lanes, carries[i], f"lane {i}")
        assert_traces_equal(r.telemetry, ref[i].telemetry, f"lane {i}")


# ------------------------------------------------------------------------
# the link layer and host faults on the split axis
# ------------------------------------------------------------------------

@multi_device
def test_sharded_link_lanes_match_batched_bitwise():
    """B = 3 corruption lanes under LLR + CBFC over 2 shards (one padding
    lane, whose ``corrupt_p`` is healthy zeros)."""
    g, wls, scheds, exp = tw.corruption_sweep(bers=(0.0, 0.02, 0.08),
                                              size=120, budget=600)
    jg, jwls, jscheds, jexp = jw.corruption_sweep(bers=(0.0, 0.02, 0.08),
                                                  size=120, budget=600)
    shd = _sharded(2, g, wls, exp["profile"], exp["params"], faults=scheds,
                   link=exp["cbfc"])
    ref = jf.simulate_batch(jg, jwls, jexp["profile"], jexp["params"],
                            faults=jscheds, link=jexp["cbfc"], shard=True)
    assert len(shd) == 3
    assert_same_results(shd, ref)
    for a, b in zip(shd, ref):
        assert a.llr_replays == b.llr_replays
        assert a.credit_stall_ticks == b.credit_stall_ticks


@multi_device
def test_sharded_host_faults_match_batched_lanes():
    """The host-fault grid (B = 4) over 3 shards: two padding lanes whose
    host lanes are all-healthy at the batch's width. A 1280-tick budget
    (the reference's 4000 runs the healing lane to the end): lane 1
    quarantines at 1152."""
    from test_torch_resilience_batch import _host_builds
    from test_torch_resilience import _small
    g2, wl, _ = _small()
    g, jg = g2
    builds = _host_builds(g.num_queues, g.num_hosts)
    prof = TransportProfile.resilient()
    p = dict(ticks=1280, timeout_ticks=64)
    shd = _sharded(3, g, [tf.Workload.of(*wl)] * 4, prof, tf.SimParams(**p),
                   faults=FaultSchedule.stack([b(FaultSchedule)
                                               for b in builds]))
    ref = jf.simulate_batch(jg, jf.Workload.stack([jf.Workload.of(*wl)] * 4),
                            jprofile(prof), jf.SimParams(**p),
                            faults=jfl.FaultSchedule.stack(
                                [b(jfl.FaultSchedule) for b in builds]),
                            shard=True)
    assert_same_results(shd, ref)
    assert shd[1].flows_abandoned > 0 and shd[0].flows_abandoned == 0
