"""The port's closed recovery loop against the reference's, on the CPU,
bitwise — part 2 of the twins of ``tests/test_faults.py``: liveness
under a healing flap for every named profile, and the escape from a
permanent path failure by EV eviction on pinned paths (hpc's all-ROD
pin, STATIC RUD). Helpers: ``test_torch_faults.py``; the sprayed escape
and conservation are in ``test_torch_faults_escape.py``, RTO backoff in
``test_torch_faults_backoff.py``.
"""
from dataclasses import replace

import numpy as np
import pytest

from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network.profile import TransportProfile
from test_torch_faults import NAMED_PROFILES, delivered, run, small


@pytest.mark.parametrize("name", NAMED_PROFILES)
def test_flap_recovery_all_named_profiles(name):
    """Both uplinks die mid-run and heal 300 ticks later: progress
    stalls, then fully recovers on default knobs."""
    g2, wl, ups = small()
    r = run(g2, wl, getattr(TransportProfile, name)(),
            dict(ticks=6000, timeout_ticks=64),
            faults=lambda FS: FS.healthy(g2[0].num_queues).flap(ups, 120,
                                                                 420))
    ct = r.completion_tick()
    assert ct > 420, f"{name}: finished {ct}, inside the outage?"
    assert r.timeouts > 0
    if name != "hpc":
        assert r.rtx_packets > 0
    assert r.ticks_degraded == 300
    np.testing.assert_array_equal(delivered(r), np.full(4, wl[2]))


@pytest.mark.parametrize(
    "prof",
    [replace(TransportProfile.hpc(), ev_eviction=True, name="hpc+evict"),
     replace(TransportProfile.ai_full(lb=LBScheme.STATIC),
             ev_eviction=True, name="static+evict")],
    ids=["hpc", "static_rud"])
def test_permanent_failure_escaped_by_eviction(prof):
    """One of two uplinks dies for good mid-run; pinned-path transports
    escape only by blacklisting the dead path's EV."""
    g2, wl, ups = small()
    r = run(g2, wl, prof, dict(ticks=6000, timeout_ticks=64),
            faults=lambda FS: FS.healthy(g2[0].num_queues).flap(ups[0], 120))
    assert r.completion_tick() != -1, f"{prof.name}: stuck on dead path"
    assert r.ev_evictions > 0
    np.testing.assert_array_equal(delivered(r), np.full(4, wl[2]))
