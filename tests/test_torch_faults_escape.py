"""The port's closed recovery loop against the reference's, on the CPU,
bitwise — part 3 of the twins of ``tests/test_faults.py``: sprayed
transports escaping a permanent path failure without eviction (and
NACK-only eviction not breaking that), the STATIC twin that cannot
escape without eviction, and payload conservation under faults that
heal. Helpers: ``test_torch_faults.py``.
"""
from dataclasses import replace

import numpy as np

from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network.profile import TransportProfile
from test_torch_faults import delivered, run, small


def test_permanent_failure_escaped_by_spraying():
    """Sprayed transports escape without eviction, and NACK-only
    eviction does not break the escape."""
    g2, wl, ups = small()

    def dead(FS):
        return FS.healthy(g2[0].num_queues).flap(ups[0], 120)
    p = dict(ticks=8000, timeout_ticks=64, ooo_threshold=24)
    reps = run(g2, wl, TransportProfile.ai_full(lb=LBScheme.REPS), p,
               faults=dead)
    assert reps.completion_tick() != -1
    obl = run(g2, wl, TransportProfile.ai_full(), p, faults=dead)
    assert obl.completion_tick() != -1
    reps_ev = run(g2, wl, replace(TransportProfile.ai_full(lb=LBScheme.REPS),
                                  ev_eviction=True, name="reps+evict"),
                  p, faults=dead)
    assert reps_ev.completion_tick() != -1


def test_eviction_beats_no_eviction_on_static_path():
    g2, wl, ups = small()
    p = dict(ticks=4000, timeout_ticks=64)

    def dead(FS):
        return FS.healthy(g2[0].num_queues).flap(ups[0], 120)
    off = TransportProfile.ai_full(lb=LBScheme.STATIC, name="static")
    r_off = run(g2, wl, off, p, faults=dead)
    r_on = run(g2, wl, replace(off, ev_eviction=True, name="static+evict"),
               p, faults=dead)
    ct_on, ct_off = r_on.completion_tick(), r_off.completion_tick()
    assert ct_on != -1
    assert ct_off == -1 or ct_on < ct_off
    assert r_off.ev_evictions == 0


def test_healing_faults_conserve_payload():
    g2, wl, ups = small()
    p = dict(ticks=8000, timeout_ticks=64, ooo_threshold=24)
    prof = TransportProfile.ai_full(lb=LBScheme.REPS)
    healthy = run(g2, wl, prof, p)
    faulty = run(g2, wl, prof, p,
                 faults=lambda FS: FS.healthy(g2[0].num_queues)
                 .flap(ups[0], 150, 500).lossy(ups[1], 0.05))
    assert faulty.completion_tick() != -1
    np.testing.assert_array_equal(delivered(faulty), delivered(healthy))
    np.testing.assert_array_equal(delivered(faulty), np.full(4, wl[2]))
    assert faulty.completion_tick() >= healthy.completion_tick()
