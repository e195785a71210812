"""The paper's quantitative claims on the port: the twins of the four
fast end-to-end tests of ``tests/test_system.py`` (the four ``slow``
ones are in ``test_torch_system_slow.py``), each run through the port
on the CPU and held bitwise against the reference's run of the same call
(stats lanes, every state lane, counters), then asserted as the
reference asserts. The deprecated call form ``simulate(g, wl, SimParams(...))`` (the twin of
``tests/test_profiles.py``'s legacy-signature test), through both entry
points. And telemetry (ROADMAP.md item 9), which raised before it was
ported, alone and beside the link layer, INC and ``resilient()``: each
run's final state is bitwise the telemetry-off run's.
"""
import warnings

import numpy as np
import pytest

from repro.network import fabric as jf
from repro.network import topology as jt
from repro.network import workloads as jw
from repro_torch.core.link import LinkConfig
from repro_torch.network import fabric as tf
from repro_torch.network import workloads as tw
from repro_torch.network.profile import CCAlgo, DeliveryMode, TransportProfile
from repro_torch.network.telemetry import TelemetrySpec
from repro_torch.network.topology import leaf_spine
from test_torch_batch import _same_state, assert_same_results
from test_torch_faults import jprofile


def _run(builder, args, prof, params, **kw):
    """The builder's scenario through both packages' ``simulate``; held
    bitwise; the port's result and the builder's expectations."""
    g, wl, exp = getattr(tw, builder)(*args)
    jg, jwl, _ = getattr(jw, builder)(*args)
    r = tf.simulate(g, wl, prof, tf.SimParams(**params), device="cpu", **kw)
    j = jf.simulate(jg, jwl, jprofile(prof), jf.SimParams(**params), **kw)
    assert_same_results([r], [j])
    return r, wl, exp


def test_incast_rccc_optimal_shares():
    r, _, exp = _run("incast", (4, 100000), TransportProfile.ai_base(),
                     dict(ticks=1200), goodput_window=(300, 1200))
    np.testing.assert_allclose(r.goodput((300, 1200)), exp["share"],
                               atol=0.02)


def test_in_network_rccc_grant():
    r, _, exp = _run("in_network", (12, 4, 100000), TransportProfile.ai_base(),
                     dict(ticks=2500), goodput_window=(800, 2500))
    gp = r.goodput((800, 2500))
    assert abs(gp[:12].mean() - exp["cross_share"]) < 0.04
    assert abs(gp[12] - exp["rccc_local_share"]) < 0.04


def test_rod_single_path_and_delivery():
    prof = TransportProfile(cc=CCAlgo.NSCC, delivery=DeliveryMode.ROD,
                            name="rod")
    r, _, _ = _run("incast", (2, 400), prof, dict(ticks=3000))
    assert r.completion_tick() >= 0
    assert int(r.state.delivered.sum()) == 2 * 400


def test_reliability_all_flows_complete_under_losses():
    r, wl, _ = _run("in_network", (12, 4, 300), TransportProfile.ai_full(),
                    dict(ticks=6000))
    assert (r.completion_ticks() >= 0).all()
    np.testing.assert_array_equal(r.state.delivered.numpy(),
                                  wl.size.numpy())


# ------------------------------------------------------------------------
# the deprecated call form
# ------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["simulate", "simulate_batch"])
def test_legacy_simparams_signature_warns_and_matches(entry):
    """SimParams in the profile slot warns and runs ``ai_full()``, as the
    explicit form does and as the reference does, bitwise."""
    src, dst = [0, 1, 2], [4, 5, 6]
    g, jg = leaf_spine(2, 4, 4), jt.leaf_spine(2, 4, 4)
    p, jp = tf.SimParams(ticks=300), jf.SimParams(ticks=300)
    if entry == "simulate":
        wl, jwl = tf.Workload.of(src, dst, 200), jf.Workload.of(src, dst,
                                                                200)
    else:
        wl = [tf.Workload.of(src, dst, 200), tf.Workload.of(src, dst, 90)]
        jwl = jf.Workload.stack([jf.Workload.of(src, dst, 200),
                                 jf.Workload.of(src, dst, 90)])
    run, jrun = getattr(tf, entry), getattr(jf, entry)
    r_new = run(g, wl, TransportProfile.ai_full(), p, trace="full",
                device="cpu")
    with pytest.warns(DeprecationWarning, match="TransportProfile"):
        r_old = run(g, wl, p, trace="full", device="cpu")
    with pytest.warns(DeprecationWarning, match="TransportProfile"):
        j_old = jrun(jg, jwl, jp, trace="full")
    if entry == "simulate":
        r_new, r_old, j_old = [r_new], [r_old], [j_old]
    assert_same_results(r_old, j_old)
    for a, b in zip(r_old, r_new):
        np.testing.assert_array_equal(a.delivered_per_tick,
                                      b.delivered_per_tick)
        np.testing.assert_array_equal(a.cwnd_per_tick.view(np.int32),
                                      b.cwnd_per_tick.view(np.int32))
    with pytest.raises(TypeError, match="profile position"):
        run(g, wl, p, p, device="cpu")


def test_legacy_call_form_completes_as_the_reference():
    """The call that raised before the call form was mirrored."""
    g = leaf_spine(2, 2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r = tf.simulate(g, tf.Workload.of([0, 1], [3, 2], [20, 20]),
                        tf.SimParams(ticks=256), device="cpu")
        j = jf.simulate(jt.leaf_spine(2, 2, 2),
                        jf.Workload.of([0, 1], [3, 2], [20, 20]),
                        jf.SimParams(ticks=256))
    assert_same_results([r], [j])
    np.testing.assert_array_equal(r.completion_ticks(), [24, 24])


# ------------------------------------------------------------------------
# telemetry (ROADMAP.md item 9, which raised here before it was ported)
# beside the statics it composes with
# ------------------------------------------------------------------------

@pytest.mark.parametrize("kw,item", [
    (dict(), "item 9"),
    (dict(link=LinkConfig.on(llr=True)), "item 8"),
    (dict(profile=TransportProfile.ai_full(inc=True)), "item 7"),
    (dict(profile=TransportProfile.resilient(inc=True)), "item 6")],
    ids=["telemetry", "link", "inc", "inc_resilient"])
@pytest.mark.parametrize("entry", ["simulate", "simulate_batch"])
def test_unported_features_raise_naming_their_item(entry, kw, item):
    """Telemetry alone and beside the link layer (``item`` names the
    ROADMAP.md item each composes with), INC and ``resilient()`` runs,
    and the final state is bitwise the telemetry-off run's."""
    g, wl, _ = tw.incast(2, 10)
    kw = dict(kw)
    prof = kw.pop("profile", TransportProfile.ai_full())
    args = (g, wl if entry == "simulate" else [wl, wl], prof,
            tf.SimParams(ticks=16, chunk_ticks=8))
    on = getattr(tf, entry)(*args, device="cpu", telemetry=TelemetrySpec.on(
        probe_every=2, slots=4), **kw)
    off = getattr(tf, entry)(*args, device="cpu", **kw)
    on, off = (on, off) if entry == "simulate_batch" else ([on], [off])
    for a, b in zip(on, off):
        assert a.horizon == b.horizon == 16, item
        _same_state(a.state, b.state)
        assert b.telemetry is None and a.telemetry.stride == 2
        assert a.telemetry.num_samples == 4
