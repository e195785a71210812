"""Trajectory parity of the port's fabric engine with the reference for
the CC compositions of the paper's profile table, on the CPU.

The k=6 fat-tree scenario of ``test_torch_fabric.py`` (27 hosts,
Q = 135, a cross-pod permutation under a 6:1 incast, queue capacity 8,
so trims, NACKs and retransmits all run) under ``ai_base()`` (RCCC),
``hpc()`` (the NSCC + RCCC hybrid, all-ROD go-back-N, LB pinned to
STATIC), the three profiles of ``cc_ablation()`` and the open loop
(``ai_full(cc=NONE)``): every ``trace="full"`` out lane, every final
state lane (the CC state in each of its forms included) and the stats
scalars bitwise. The LB schemes and mixed delivery are in
``test_torch_profiles_lb.py``.
"""
import numpy as np
import pytest

from repro.network import fabric as jf
from repro.network import profile as jprof
from repro.network import topology as jt
from repro_torch.network import fabric as tf
from repro_torch.network import profile as tprof
from repro_torch.network.topology import fat_tree3
from test_torch_fabric import (K6_DST, K6_PARAMS, K6_SIZE, K6_SRC,
                               _assert_lanes, _assert_state_matches)

STATS = ("trims", "drops", "dups", "timeouts", "rtx_packets")


def run_pair(jp, tp, **params):
    """The k=6 scenario under matching profiles in both packages."""
    p = {**K6_PARAMS, **params}
    ref = jf.simulate(jt.fat_tree3(k=6, pods=3),
                      jf.Workload.of(K6_SRC, K6_DST, K6_SIZE), jp,
                      jf.SimParams(**p), trace="full")
    port = tf.simulate(fat_tree3(k=6, pods=3),
                       tf.Workload.of(K6_SRC, K6_DST, K6_SIZE), tp,
                       tf.SimParams(**p), trace="full", device="cpu")
    return ref, port


def assert_parity(ref, port):
    assert port.horizon == ref.horizon
    assert port.completion_tick() == ref.completion_tick()
    _assert_lanes(port, ref)
    _assert_state_matches(port.state, ref.state)
    for stat in STATS:
        assert getattr(port, stat) == getattr(ref, stat), stat
    assert int(port.state.rod_rejects) == int(ref.state.rod_rejects)


def test_ai_base_rccc_trajectory():
    ref, port = run_pair(jprof.TransportProfile.ai_base(),
                         tprof.TransportProfile.ai_base())
    assert_parity(ref, port)
    assert port.completion_tick() > 0 and port.trims > 0
    # RCCC reports the static cap; the live signal is the credit balance
    assert (port.cwnd_per_tick == 48.0).all()
    assert not np.array_equal(port.state.cc.balance.numpy(),
                              np.full(len(K6_SRC), 48.0, np.float32))


def test_hpc_hybrid_all_rod_trajectory():
    ref, port = run_pair(jprof.TransportProfile.hpc(),
                         tprof.TransportProfile.hpc())
    assert_parity(ref, port)
    s = port.state
    assert set(s.cc) == {"nscc", "rccc"}
    assert int(s.rod_rejects) > 0, "congested ROD must reject OOO"
    assert port.rtx_packets == 0, "all-ROD recovers by go-back-N only"
    # all-ROD pins LB to STATIC: REPS never recycles an EV
    assert not bool(s.lb.reps_size.any())
    assert port.completion_tick() > 0


@pytest.mark.parametrize("i", [0, 1, 2], ids=["nscc_only", "rccc_only",
                                               "hybrid"])
def test_cc_ablation_trajectories(i):
    jps, tps = jprof.cc_ablation(), tprof.cc_ablation()
    assert [q.name for q in tps] == [q.name for q in jps]
    assert tps[i].describe() == jps[i].describe()
    ref, port = run_pair(jps[i], tps[i])
    assert_parity(ref, port)


def test_open_loop_trajectory():
    jp = jprof.TransportProfile.ai_full(cc=jprof.CCAlgo.NONE)
    tp = tprof.TransportProfile.ai_full(cc=tprof.CCAlgo.NONE)
    ref, port = run_pair(jp, tp)
    assert_parity(ref, port)
    assert tuple(port.state.cc.shape) == (0,)
    assert (port.cwnd_per_tick == 48.0).all() and port.trims > 0
