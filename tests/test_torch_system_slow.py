"""The paper's quantitative claims on the port, part 2: the twins of the
four ``slow``-marked end-to-end tests of ``tests/test_system.py``
(outcast, spraying against static ECMP, trimming against timeout
recovery, REPS failure mitigation), each run through the port on the CPU
and held bitwise against the reference's run of the same call, then
asserted as the reference asserts. The ``slow`` marks are kept.
Helpers: ``test_torch_system.py``.
"""
import pytest

from repro.network import fabric as jf
from repro.network import topology as jt
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network import fabric as tf
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import leaf_spine
from test_torch_batch import assert_same_results
from test_torch_faults import jprofile
from test_torch_system import _run


@pytest.mark.slow
def test_outcast_rccc_blind_vs_nscc():
    r, _, exp = _run("outcast", (4, 100000), TransportProfile.ai_base(),
                     dict(ticks=2500), goodput_window=(800, 2500))
    w_share_rccc = r.goodput((800, 2500))[4]
    assert abs(w_share_rccc - exp["rccc_w_share"]) < 0.03
    r2, _, _ = _run("outcast", (4, 100000), TransportProfile.ai_full(),
                    dict(ticks=2500), goodput_window=(1200, 2500))
    w_share_nscc = r2.goodput((1200, 2500))[4]
    assert w_share_nscc > 0.65
    assert w_share_nscc > w_share_rccc + 0.1


@pytest.mark.slow
def test_spraying_beats_static_ecmp():
    res = {}
    for scheme in (LBScheme.STATIC, LBScheme.OBLIVIOUS, LBScheme.REPS):
        r, _, _ = _run("permutation", (8, 4, 17, 100000),
                       TransportProfile.ai_full(lb=scheme), dict(ticks=1500),
                       goodput_window=(700, 1500))
        res[scheme] = r.goodput((700, 1500)).mean()
    assert res[LBScheme.OBLIVIOUS] > res[LBScheme.STATIC] + 0.2
    assert res[LBScheme.REPS] >= res[LBScheme.OBLIVIOUS] - 0.02
    assert res[LBScheme.REPS] > 0.9


@pytest.mark.slow
def test_trimming_recovers_faster_than_timeout():
    prof = TransportProfile.ai_full()
    base = dict(ticks=1500, timeout_ticks=300)
    r_trim, _, _ = _run("incast", (8, 48), prof, dict(trimming=True, **base))
    r_drop, _, _ = _run("incast", (8, 48), prof, dict(trimming=False, **base))
    ct_trim = r_trim.completion_ticks()
    ct_drop = r_drop.completion_ticks()
    assert (ct_trim >= 0).all()
    assert (ct_drop < 0).any() or ct_drop.mean() > ct_trim.mean() + 50
    assert r_trim.trims > 0
    assert r_drop.drops > 0


@pytest.mark.slow
def test_reps_failure_mitigation():
    """One of 4 uplinks dead: 8 flows share 3 live uplinks (optimum
    0.375 each); REPS approaches it, oblivious spraying does not."""
    g, jg = leaf_spine(2, 4, 8), jt.leaf_spine(2, 4, 8)
    src, dst = list(range(8)), [8 + i for i in range(8)]
    dead = (int(g.up1_table[0, 0]),)
    p = dict(ticks=3000, timeout_ticks=64, ooo_threshold=24)
    res = {}
    for scheme in (LBScheme.OBLIVIOUS, LBScheme.REPS):
        prof = TransportProfile.ai_full(lb=scheme)
        r = tf.simulate(g, tf.Workload.of(src, dst, 100000), prof,
                        tf.SimParams(**p), failed=dead,
                        goodput_window=(1500, 3000), device="cpu")
        j = jf.simulate(jg, jf.Workload.of(src, dst, 100000),
                        jprofile(prof), jf.SimParams(**p), failed=dead,
                        goodput_window=(1500, 3000))
        assert_same_results([r], [j])
        res[scheme] = float(r.goodput((1500, 3000)).mean())
    optimum = 3.0 / 8.0
    assert res[LBScheme.REPS] > 0.9 * optimum
    assert res[LBScheme.REPS] > res[LBScheme.OBLIVIOUS] * 1.3
