"""The split scenario axis against the reference's ``shard_map`` engine
on the CPU, bitwise (helpers: ``test_torch_shard.py``): the serial,
per-profile and fault-schedule twins of ``tests/test_shard.py``. The
port splits over a repeated CPU device, through ``shard.run_sharded`` or
``simulate_batch(devices=(cpu,) * n)``; the reference over the 4 virtual
devices of ``conftest.py``.
"""
from dataclasses import replace

import numpy as np
import torch

from repro.network import fabric as jf
from repro.network import faults as jfl
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network import fabric as tf
from repro_torch.network import shard
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from test_torch_batch import _same_state, assert_same_results
from test_torch_faults import graphs, jprofile
from test_torch_shard import CPU, _mixed_batch, _sharded, multi_device

torch.set_num_threads(1)


@multi_device
def test_sharded_serial_cross_parity():
    """Sharded lanes (``run_sharded`` over (cpu, cpu), B = 3: one
    padding lane) equal the reference's and the port's serial runs."""
    (g, jg), wls, jwls, masks, seeds = _mixed_batch(b=3)
    p = tf.SimParams(ticks=600)
    prof = TransportProfile.ai_full()
    shd = shard.run_sharded(
        g, tf.Workload.stack(wls), prof, p,
        FaultSchedule.from_mask(masks[:3]), seeds, "stats", 600, None,
        (CPU, CPU))
    ref = jf.simulate_batch(jg, jwls, jprofile(prof), jf.SimParams(ticks=600),
                            failed=masks[:3], seeds=seeds, devices=2)
    assert_same_results(shd, ref)
    for i, r in enumerate(shd):
        solo = tf.simulate(g, wls[i], prof, p, failed=masks[i],
                           seed=int(seeds[i]), device="cpu")
        assert solo.horizon == r.horizon, f"scenario {i}"
        np.testing.assert_array_equal(solo.completion_ticks(),
                                      r.completion_ticks())
        _same_state(solo.state, r.state)


@multi_device
def test_sharded_per_profile_groups_parity():
    """Per-scenario profiles: each group (B = 2) is split over 2 shards,
    the results come back in scenario order."""
    (g, jg), wls, jwls, masks, seeds = _mixed_batch()
    p = dict(ticks=500)
    profs = [TransportProfile.ai_full(), TransportProfile.ai_base(),
             TransportProfile.hpc()] * 2
    shd = _sharded(2, g, wls, profs, tf.SimParams(**p), failed=masks,
                   seeds=seeds)
    ref = jf.simulate_batch(jg, jwls, [jprofile(q) for q in profs],
                            jf.SimParams(**p), failed=masks, seeds=seeds,
                            shard=True)
    assert_same_results(shd, ref)


@multi_device
def test_sharded_fault_schedule_parity():
    """Per-scenario schedules (flap / gray / permanent + recovery knobs)
    ride the split bitwise; the ragged B = 5 run's padding lanes are
    healthy and inert. A 1200-tick budget (the reference's 3000 runs the
    permanent flap's lane to the end on the port's CPU tick)."""
    g2 = graphs(2, 2, 4)
    (g, jg) = g2
    sizes = (150, 90, 150, 150, 60)
    wls = [tf.Workload.of([0, 1, 2, 3], [4, 5, 6, 7], s) for s in sizes]
    jwls = jf.Workload.stack([jf.Workload.of([0, 1, 2, 3], [4, 5, 6, 7], s)
                              for s in sizes])
    ups = [int(g.up1_table[0, i]) for i in range(2)]

    def scheds(FS):
        ok = FS.healthy(g.num_queues)
        return FS.stack([ok, ok.flap(ups, 120, 420),
                         ok.lossy(ups, 0.05).with_seed(3), ok.flap(ups[0], 120),
                         ok.lossy(ups[1], 0.2)])

    prof = replace(TransportProfile.ai_full(lb=LBScheme.REPS),
                   ev_eviction=True, rto_backoff=2.0, name="sweep")
    p = dict(ticks=1200, timeout_ticks=64, ooo_threshold=24)
    shd = _sharded(4, g, wls, prof, tf.SimParams(**p),
                   faults=scheds(FaultSchedule))
    ref = jf.simulate_batch(jg, jwls, jprofile(prof), jf.SimParams(**p),
                            faults=scheds(jfl.FaultSchedule), shard=True)
    assert len(shd) == 5
    assert_same_results(shd, ref)
    assert shd[1].ticks_degraded == 300
    assert shd[3].ev_evictions > 0
