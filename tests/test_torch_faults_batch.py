"""Fault schedules on the scenario axis: the port's ``simulate_batch``
against the reference's, on the CPU, bitwise.

* The twin of ``tests/test_faults.py``'s last test: a [B, Q] schedule
  (healthy / flap / gray / permanent death under REPS with eviction and
  backoff) rides the scenario axis, each lane equal to its serial twin.
* B = 4 lanes with a different fault class in each (gray links with a
  per-lane draw seed, a host death with a NIC stall, PHY corruption
  with a flap, and all of them with a permanent uplink death) under the
  whole recovery loop (``resilient``, a short RTO), with a flow that
  depends on a flow whose source dies, so quarantine collapses the
  dependency chain: both trace tiers, budgets on and off the chunk
  grid, chunks of 32 to 128 ticks, queues of 4 packets so that trims
  drive NACK evictions in every lane. Lanes quarantine and stop at
  different chunks; the stopped ones stay frozen (no
  ``ticks_unreachable`` past their boundary). A lost scenario offset in
  a per-scenario gather (the loss threshold, the host lanes, the dead
  source of a NACK lane) shows only at B > 1 with different faults per
  lane, which is what these are for.
* The same batch against B serial port runs.
"""
from dataclasses import replace

import numpy as np
import pytest

from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network import fabric as tf
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from test_torch_batch import _same_state
from test_torch_faults import graphs, run_batch, small

SRC, DST = [0, 1, 2, 6, 3], [4, 5, 3, 0, 7]
SIZE = 60
DEP = [-1, -1, -1, -1, 0]          # flow 4 waits for flow 0 (host 0 dies)
SEEDS = [0x5EED, 0xFFFFFFF0, 7, 0x80000001]


def test_batched_schedules_match_serial_lanes():
    g2, wl, ups = small()
    p = dict(ticks=4000, timeout_ticks=64, ooo_threshold=24)
    builds = [
        lambda FS: FS.healthy(g2[0].num_queues),
        lambda FS: FS.healthy(g2[0].num_queues).flap(ups, 120, 420),
        lambda FS: FS.healthy(g2[0].num_queues).lossy(ups, 0.05),
        lambda FS: FS.healthy(g2[0].num_queues).flap(ups[0], 120),
    ]
    prof = replace(TransportProfile.ai_full(lb=LBScheme.REPS),
                   ev_eviction=True, rto_backoff=2.0, name="sweep")
    batch = run_batch(g2, [wl] * 4, prof, p,
                      faults=lambda FS: FS.stack([b(FS) for b in builds]))
    assert all(r.completion_tick() != -1 for r in batch)
    assert batch[1].ticks_degraded == 300
    for i, (build, r) in enumerate(zip(builds, batch)):
        # the batch is held against the reference's above; each lane
        # against the port's own serial run here
        solo = tf.simulate(g2[0], tf.Workload.of(*wl), prof,
                           tf.SimParams(**p), faults=build(FaultSchedule),
                           device="cpu")
        assert solo.horizon == r.horizon, f"scenario {i}"
        np.testing.assert_array_equal(solo.completion_ticks(),
                                      r.completion_ticks())
        _same_state(solo.state, r.state)


def _lanes(FS):
    g = graphs(2, 2, 4)[0]
    ups = [int(g.up1_table[0, i]) for i in range(2)]
    ok = FS.healthy(g.num_queues, num_hosts=g.num_hosts)
    return FS.stack([
        ok.lossy(ups, 0.08).with_seed(5),
        ok.host_fail(0, 60).nic_stall(1, 50, 300),
        ok.corrupt(ups[1], 0.05).flap(ups[0], 100, 260).with_seed(9),
        ok.host_fail(5, 80, 400).lossy(ups[0], 0.03).corrupt(ups[1], 0.02)
        .flap(ups[1], 0).host_fail(0, 200).with_seed(0xFFFFFFFF),
    ])


@pytest.mark.parametrize("trace,chunk,budget", [
    ("stats", 64, 1000), ("full", 64, 1000), ("stats", 32, 1500),
    ("full", 128, 777)])
def test_faulted_batch_matches_reference(trace, chunk, budget):
    g2 = graphs(2, 2, 4)
    rs = run_batch(g2, [(SRC, DST, SIZE, 0, DEP)] * 4,
                   TransportProfile.resilient(),
                   dict(ticks=1500, chunk_ticks=chunk, timeout_ticks=16,
                        queue_capacity=4),
                   faults=_lanes, seeds=SEEDS, trace=trace,
                   max_ticks=budget)
    horizons = [r.horizon for r in rs]
    assert len(set(horizons)) > 1, horizons     # lanes stop apart
    assert rs[1].state.quarantined[[0, 3, 4]].all()   # 4: by dependency
    assert rs[1].flows_abandoned >= 3 and rs[1].horizon < budget
    assert all(r.trims for r in rs) and all(r.ev_evictions for r in rs)
    assert all(r.drops for r in rs)


def test_faulted_batch_equals_serial_runs():
    g = graphs(2, 2, 4)[0]
    sched = _lanes(FaultSchedule)
    p = tf.SimParams(ticks=900, chunk_ticks=64, timeout_ticks=16)
    wl = tf.Workload.of(SRC, DST, SIZE, dep=DEP)
    batch = tf.simulate_batch(g, [wl] * 4, TransportProfile.resilient(), p,
                              faults=sched, seeds=SEEDS, trace="full",
                              device="cpu")
    for b, r in enumerate(batch):
        solo = tf.simulate(g, wl, TransportProfile.resilient(), p,
                           faults=sched.lanes(b), seed=SEEDS[b],
                           trace="full", device="cpu")
        assert solo.horizon == r.horizon, b
        np.testing.assert_array_equal(solo.delivered_per_tick,
                                      r.delivered_per_tick)
        np.testing.assert_array_equal(solo.cwnd_per_tick.view(np.int32),
                                      r.cwnd_per_tick.view(np.int32))
        _same_state(solo.state, r.state)
