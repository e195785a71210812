"""Endpoint faults on the scenario axis, on the CPU, bitwise: the twin of
``tests/test_resilience.py``'s serial-vs-batched host-fault test. A
[B, Q] / [B, H] schedule (all-healthy widened lanes, a permanent host
death, a death that heals, an ACK-live NIC stall) under ``resilient()``
runs through both packages' ``simulate_batch`` and is held bitwise on
every lane and counter (``flows_abandoned``, ``ticks_unreachable``,
``abandon_tick`` included); each lane then equals the port's own serial
run. Helpers: ``test_torch_faults.py``, ``test_torch_resilience.py``.
"""
import numpy as np

from repro_torch.network import fabric as tf
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from test_torch_batch import _same_state
from test_torch_faults import run_batch
from test_torch_resilience import _small


# ------------------------------------------------------------------------
# stat-lane parity: serial == batched with host lanes riding
# ------------------------------------------------------------------------

def _host_builds(q, h):
    return [
        lambda FS: FS.healthy(q, num_hosts=h),
        lambda FS: FS.healthy(q, num_hosts=h).host_fail(0, 100),
        lambda FS: FS.healthy(q, num_hosts=h).host_fail(5, 100, 400),
        lambda FS: FS.healthy(q, num_hosts=h).nic_stall(1, 100, 500),
    ]


def test_batched_host_faults_match_serial_lanes():
    g2, wl, _ = _small()
    builds = _host_builds(g2[0].num_queues, g2[0].num_hosts)
    prof = TransportProfile.resilient()
    p = dict(ticks=4000, timeout_ticks=64)
    batch = run_batch(g2, [wl] * 4, prof, p,
                      faults=lambda FS: FS.stack([b(FS) for b in builds]))
    assert batch[1].flows_abandoned > 0
    assert batch[0].flows_abandoned == 0
    for i, (build, r) in enumerate(zip(builds, batch)):
        # the batch is held against the reference's above; each lane
        # against the port's own serial run here
        solo = tf.simulate(g2[0], tf.Workload.of(*wl), prof,
                           tf.SimParams(**p), faults=build(FaultSchedule),
                           device="cpu")
        assert solo.horizon == r.horizon, f"scenario {i}"
        assert solo.flows_abandoned == r.flows_abandoned
        assert solo.ticks_unreachable == r.ticks_unreachable
        assert solo.abandon_tick == r.abandon_tick
        np.testing.assert_array_equal(solo.completion_ticks(),
                                      r.completion_ticks())
        _same_state(solo.state, r.state)
