"""The port against the reference on random fault schedules, on the CPU,
bitwise — part 5 of the twins of ``tests/test_faults.py``: random flap
windows (all healed by 1500) and gray lanes on the uplinks of a 3-spine
fabric with one spine left pristine. Each draw runs through both
packages, is held bitwise, and must keep liveness and conservation. A
seeded sweep always runs; the hypothesis twin runs where hypothesis is
installed. Both keep the reference's ``slow`` marks. And OOO-gap loss
inference beating pure RTO recovery on a gray link. Helpers:
``test_torch_faults.py``.
"""
import numpy as np
import pytest

from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from test_torch_faults import delivered, graphs, run, small


def _check_random_schedule(rng: np.random.Generator) -> None:
    g2 = graphs(2, 3, 4)
    g = g2[0]
    wl = ([0, 1, 2], [4, 5, 6], 120)
    ops = []
    survivor = int(rng.integers(3))
    for leaf in range(2):
        for s in range(3):
            if s == survivor:
                continue
            q = int(g.up1_table[leaf, s])
            if rng.random() < 0.7:
                start = int(rng.integers(0, 900))
                ops.append(("flap", q, start,
                            start + int(rng.integers(50, 600))))
            if rng.random() < 0.5:
                ops.append(("lossy", q, float(rng.uniform(0.01, 0.3))))
    seed = int(rng.integers(2 ** 32))

    def build(FS):
        sched = FS.healthy(g.num_queues)
        for op, *args in ops:
            sched = getattr(sched, op)(*args)
        return sched.with_seed(np.uint32(seed))
    r = run(g2, wl, TransportProfile.ai_full(),
            dict(ticks=6000, timeout_ticks=64, ooo_threshold=24),
            faults=build)
    assert r.completion_tick() != -1, "guaranteed-survivor run stalled"
    np.testing.assert_array_equal(delivered(r), np.full(3, 120))
    assert not build(FaultSchedule).dead_at(0)[int(g.up1_table[0,
                                                                survivor])]


@pytest.mark.slow
def test_random_fault_schedules_never_violate_liveness():
    for seed in range(4):
        _check_random_schedule(np.random.default_rng(seed))


@pytest.mark.slow
def test_random_fault_schedules_property_hypothesis():
    pytest.importorskip(
        "hypothesis",
        reason="property twin needs hypothesis (the seeded fallback above "
               "covers the contract without it)")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=8, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(min_value=0, max_value=2**32 - 1))
    def prop(seed):
        _check_random_schedule(np.random.default_rng(seed))

    prop()


def test_ooo_inference_beats_pure_rto_on_gray_link():
    g2, wl, ups = small()

    def gray(FS):
        return FS.healthy(g2[0].num_queues).lossy(ups, 0.04)
    rto_only = run(g2, wl, TransportProfile.ai_full(), dict(ticks=8000),
                   faults=gray)
    inferred = run(g2, wl, TransportProfile.ai_full(),
                   dict(ticks=8000, ooo_threshold=24), faults=gray)
    ct_rto, ct_inf = rto_only.completion_tick(), inferred.completion_tick()
    assert ct_inf != -1
    assert ct_rto == -1 or ct_inf < ct_rto, (ct_inf, ct_rto)
