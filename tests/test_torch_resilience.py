"""Endpoint-failure resilience on the port against the reference, on the
CPU, bitwise: the twins of the fabric-level tests of
``tests/test_resilience.py`` (host-lane validation and composition, the
inertness of all-healthy host lanes, ``pdc.unreachable``, quarantine
liveness for dead uplinks and dead hosts, a NIC stall that is not death,
and batched host faults against serial lanes). Each scenario runs
through both packages, is held bitwise on every state lane and counter
(``flows_abandoned``, ``ticks_unreachable``, ``abandon_tick``, the
quarantine and strike lanes included), then meets the reference test's
own assertions (the batched host faults are in
``test_torch_resilience_batch.py``, the sharded ones in
``test_torch_shard.py``). The PDC state machine (item 12) is not
ported and has no twin here; the checkpoint economics, the replan and
the priced recovery have theirs in ``test_torch_plan.py`` and
``test_torch_traffic.py``.
Helpers: ``test_torch_faults.py``.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core import pdc as jpdc
from repro.network import faults as jfl
from repro_torch.core import pdc
from repro_torch.network import fabric as tf
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from test_torch_batch import _same_state
from test_torch_faults import delivered, graphs, run


def _small():
    """Flows 0/1 cross leaves on leaf-0 uplinks, flow 2 stays in leaf 0,
    flow 3 crosses from leaf 1 (``tests/test_resilience.py``)."""
    g2 = graphs(2, 2, 4)
    ups = [int(g2[0].up1_table[0, i]) for i in range(2)]
    return g2, ([0, 1, 2, 6], [4, 5, 3, 0], 150), ups


def _both_raise(exc, match, build):
    """``build`` raises the same error in both packages."""
    for FS in (FaultSchedule, jfl.FaultSchedule):
        with pytest.raises(exc, match=match):
            build(FS)


# ------------------------------------------------------------------------
# host-lane API validation + composition
# ------------------------------------------------------------------------

def test_host_builders_require_host_lanes():
    q = graphs(2, 2, 4)[0].num_queues
    _both_raise(ValueError, "needs host lanes",
                lambda FS: FS.healthy(q).host_fail(0, 100))
    _both_raise(ValueError, "needs host lanes",
                lambda FS: FS.healthy(q).nic_stall(0, 100))
    s2 = FaultSchedule.healthy(q).with_hosts(8).host_fail(1, 100)
    assert s2.num_hosts == 8 and s2.has_host_faults


def test_host_ids_are_range_checked():
    q = graphs(2, 2, 4)[0].num_queues
    _both_raise(ValueError, "host ids",
                lambda FS: FS.healthy(q, num_hosts=8).host_fail(8, 100))
    _both_raise(ValueError, "host ids",
                lambda FS: FS.healthy(q, num_hosts=8).nic_stall(-1, 100))


def test_with_hosts_rewiden_is_an_error():
    s = FaultSchedule.healthy(16, num_hosts=8)
    assert s.with_hosts(8) is s
    _both_raise(ValueError, "re-widen",
                lambda FS: FS.healthy(16, num_hosts=8).with_hosts(4))


def test_stack_normalizes_mixed_host_widths():
    q, h = 16, 8
    st = FaultSchedule.stack([
        FaultSchedule.healthy(q),
        FaultSchedule.healthy(q, num_hosts=h).host_fail(1, 100)])
    assert st.num_hosts == h and st.host_fail_at.shape == (2, h)
    dead = st.host_dead_at(100)
    assert not dead[0].any() and bool(dead[1, 1])
    _both_raise(ValueError, "different host counts", lambda FS: FS.stack([
        FS.healthy(q, num_hosts=h).host_fail(1, 100),
        FS.healthy(q, num_hosts=4)]))


def test_with_seed_composes_with_host_lanes():
    ups = _small()[2]
    s = (FaultSchedule.healthy(16, num_hosts=8)
         .host_fail(2, 50, 90).nic_stall(3, 60)
         .lossy(ups[0], 0.1).with_seed(7))
    assert int(s.seed) == 7
    assert bool(s.host_dead_at(50)[2])
    assert not s.host_dead_at(90)[2]
    assert bool(s.nic_stalled_at(1000)[3])
    assert s.has_host_faults


def test_schedule_host_count_validated_against_topology():
    g2, wl, _ = _small()
    g = g2[0]
    with pytest.raises(ValueError, match="hosts"):
        tf.simulate(g, tf.Workload.of(*wl), TransportProfile.resilient(),
                    tf.SimParams(ticks=10), device="cpu",
                    faults=FaultSchedule.healthy(g.num_queues,
                                                 num_hosts=g.num_hosts + 1))


def test_all_healthy_host_lanes_are_bitwise_inert():
    g2, wl, _ = _small()
    p = dict(ticks=700)
    prof = TransportProfile.ai_full()
    idle = FaultSchedule.healthy(g2[0].num_queues,
                                 num_hosts=g2[0].num_hosts)
    assert not idle.has_host_faults
    a = run(g2, wl, prof, p)
    b = run(g2, wl, prof, p, faults=lambda FS: FS.healthy(
        g2[0].num_queues, num_hosts=g2[0].num_hosts))
    assert a.horizon == b.horizon
    _same_state(a.state, b.state)


# ------------------------------------------------------------------------
# profile knob + liveness predicate
# ------------------------------------------------------------------------

def test_pdc_dead_after_validation_and_resilient_profile():
    with pytest.raises(ValueError, match="pdc_dead_after"):
        replace(TransportProfile.ai_full(), pdc_dead_after=-1)
    prof = TransportProfile.resilient()
    assert prof.pdc_dead_after > 0
    assert "pdc_dead_after" in prof.describe()
    assert TransportProfile.ai_full().pdc_dead_after == 0


@pytest.mark.parametrize("dead_after", [0, 1, 4, -2])
def test_unreachable_mirrors_strike_threshold(dead_after):
    strikes = np.asarray([0, 3, 4, 9, 1, 2 ** 31 - 1], np.int32)
    got = pdc.unreachable(torch.as_tensor(strikes), dead_after).numpy()
    want = np.asarray(jpdc.unreachable(strikes, dead_after))
    np.testing.assert_array_equal(got, want)
    if dead_after == 4:
        np.testing.assert_array_equal(got[:4], [False, False, True, True])
    if dead_after <= 0:
        assert not got.any()


# ------------------------------------------------------------------------
# quarantine liveness
# ------------------------------------------------------------------------

def test_dead_uplinks_quiesce_early_with_survivors_intact():
    g2, wl, ups = _small()
    budget = 4000
    p = dict(ticks=budget, timeout_ticks=64)

    def dead(FS):
        return FS.healthy(g2[0].num_queues).flap(ups, 120)   # forever
    on = TransportProfile.resilient()
    off = replace(on, pdc_dead_after=0, name="resilient-pdc_off")
    r_off = run(g2, wl, off, p, faults=dead)
    assert r_off.horizon == budget
    assert r_off.flows_abandoned == 0 and r_off.completion_tick() == -1
    r_on = run(g2, wl, on, p, faults=dead)
    assert r_on.horizon < budget
    assert r_on.flows_abandoned == 2
    assert r_on.abandon_tick > 120 and r_on.ticks_unreachable > 0
    ct = r_on.completion_ticks()
    assert ct[0] == -1 and ct[1] == -1
    assert ct[2] > 0 and ct[3] > 0
    np.testing.assert_array_equal(delivered(r_on)[2:], delivered(r_off)[2:])
    np.testing.assert_array_equal(delivered(r_on)[2:], [150, 150])


def test_dead_host_zero_traffic_flow_still_quarantines():
    g2, wl, _ = _small()
    budget = 4000
    r = run(g2, wl, TransportProfile.resilient(),
            dict(ticks=budget, timeout_ticks=64),
            faults=lambda FS: FS.healthy(
                g2[0].num_queues, num_hosts=g2[0].num_hosts).host_fail(0, 0))
    assert r.flows_abandoned == 2 and r.horizon < budget
    ct = r.completion_ticks()
    assert ct[0] == -1 and ct[3] == -1
    assert ct[1] > 0 and ct[2] > 0


def test_nic_stall_is_not_death():
    g2, wl, _ = _small()
    r = run(g2, wl, TransportProfile.resilient(),
            dict(ticks=6000, timeout_ticks=64),
            faults=lambda FS: FS.healthy(
                g2[0].num_queues, num_hosts=g2[0].num_hosts)
            .nic_stall(0, 100, 900))
    assert r.flows_abandoned == 0
    assert r.completion_tick() > 0
    np.testing.assert_array_equal(delivered(r), np.full(4, 150))
