"""The port's RTO backoff and loss inference against the reference's, on
the CPU, bitwise — part 4 of the twins of ``tests/test_faults.py``:
backoff spacing the expiries of a dead window and its cap restoring
them, the reset on progress, the backoff lane itself at factors 1.5, 2
and 3 with a short base RTO, so the cap binds, against the reference's
jitted tick (its f32 multiply and int32 truncation). Helpers:
``test_torch_faults.py``.
"""
from dataclasses import replace

import pytest

from repro_torch.network.profile import TransportProfile
from test_torch_faults import run, small


def test_rto_backoff_spaces_timeouts_and_cap_restores_them():
    g2, wl, ups = small()
    p = dict(ticks=2000, timeout_ticks=32)

    def dead(FS):
        return FS.healthy(g2[0].num_queues).flap(ups, 100)   # forever
    prof = TransportProfile.ai_full()
    fixed = run(g2, wl, prof, p, faults=dead)
    backed = run(g2, wl, replace(prof, rto_backoff=2.0), p, faults=dead)
    capped = run(g2, wl, replace(prof, rto_backoff=2.0, rto_max_scale=1), p,
                 faults=dead)
    assert fixed.completion_tick() == -1
    assert fixed.timeouts > 0
    assert backed.timeouts < fixed.timeouts
    assert capped.timeouts == fixed.timeouts


def test_rto_backoff_resets_on_progress():
    g2, wl, ups = small()
    p = dict(ticks=6000, timeout_ticks=64)

    def flap(FS):
        return FS.healthy(g2[0].num_queues).flap(ups, 120, 420)
    prof = TransportProfile.ai_full()
    base = run(g2, wl, prof, p, faults=flap)
    backed = run(g2, wl, replace(prof, rto_backoff=2.0, rto_max_scale=4), p,
                 faults=flap)
    assert backed.completion_tick() != -1
    assert backed.timeouts <= base.timeouts
    assert backed.completion_tick() <= base.completion_tick() \
        + 4 * p["timeout_ticks"]


@pytest.mark.parametrize("factor", [1.5, 2.0, 3.0])
def test_rto_backoff_lane_matches_jitted_reference(factor):
    """The per-flow RTO lane under a permanent outage: each expiry
    multiplies it in f32 and truncates (5 -> 7 -> 10 -> 15 -> 22 ...
    at 1.5), until the cap (``rto_max_scale`` x 5) binds; the final
    ``rto`` lane and the timeout count equal the reference's."""
    g2, wl, ups = small()
    prof = replace(TransportProfile.ai_full(), rto_backoff=factor,
                   rto_max_scale=6)
    r = run(g2, wl, prof, dict(ticks=700, timeout_ticks=5),
            faults=lambda FS: FS.healthy(g2[0].num_queues).flap(ups, 50))
    rto = r.state.rto.numpy()
    assert (rto == 30).any(), rto       # the cap was reached
    assert r.timeouts > 0 and r.completion_tick() == -1
