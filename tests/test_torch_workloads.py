"""The port's workload grids (``repro_torch.network.workloads``) against
the reference builders they copy, on the CPU: each builder's graph
tables, workload lanes and expectation dicts, at the builders' defaults
and at small sizes; and three sweeps end to end through both packages'
``simulate_batch`` (the profile ablation's seven profiles, the failure
sweep's [B, Q] masks, the size sweep), bitwise, plus the padding lanes
staying inert. And the three fault grids (``fault_sweep``,
``host_fault_sweep``, ``corruption_sweep``: schedules, profiles and
expectations, the copied ``LinkConfig`` included) against the
reference's, each run end to end through both packages, bitwise — the
corruption grid's LLR-off arm (the link layer is ROADMAP.md item 8)."""
import dataclasses

import numpy as np
import pytest

from repro.core import link as jlink
from repro.network import fabric as jf
from repro.network import workloads as jw
from repro_torch import convert
from repro_torch.core import link
from repro_torch.network import fabric as tf
from repro_torch.network import workloads as tw
from test_torch_batch import assert_same_results

BUILDERS = [
    ("incast", (), {}), ("incast", (3, 50), {}),
    ("outcast", (), {}), ("outcast", (3, 20), {}),
    ("in_network", (), {}), ("in_network", (4, 2, 30), {}),
    ("permutation", (), {}), ("permutation", (4, 2, 3, 10), {}),
    ("two_flow_collision", (), {}),
    ("victim_sweep", (), {}), ("victim_sweep", (4, 2, 40), {}),
]


def _same_graph(a, b):
    for name in a.__dataclass_fields__:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


def _same_workload(wl, jwl):
    d = convert.workload_to_numpy(wl)
    for f in dataclasses.fields(jf.Workload):
        want = np.asarray(getattr(jwl, f.name))
        assert d[f.name].dtype == want.dtype, f.name
        np.testing.assert_array_equal(d[f.name], want, err_msg=f.name)


def _same_profiles(ps, jps):
    assert [q.describe() for q in ps] == [q.describe() for q in jps]


@pytest.mark.parametrize("name,args,kw", BUILDERS,
                         ids=[f"{n}{a}" for n, a, _ in BUILDERS])
def test_builder_matches_reference(name, args, kw):
    g, wl, exp = getattr(tw, name)(*args, **kw)
    jg, jwl, jexp = getattr(jw, name)(*args, **kw)
    _same_graph(g, jg)
    _same_workload(wl, jwl)
    assert exp == jexp


@pytest.mark.parametrize("args", [(), (4, 2, 40)])
def test_profile_ablation_sweep_matches_reference(args):
    g, wls, profs, names, exp = tw.profile_ablation_sweep(*args)
    jg, jwls, jprofs, jnames, jexp = jw.profile_ablation_sweep(*args)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    _same_profiles(profs, jprofs)
    assert names == jnames and exp == jexp and len(profs) == 7


@pytest.mark.parametrize("args", [(), (2, 4, 50)])
def test_failure_sweep_matches_reference(args):
    g, wls, masks, exp = tw.failure_sweep(*args)
    jg, jwls, jmasks, jexp = jw.failure_sweep(*args)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    np.testing.assert_array_equal(masks, jmasks)
    assert exp == jexp


@pytest.mark.parametrize("sizes", [(100, 400), (7,)])
def test_size_sweep_matches_reference(sizes):
    g, wls, exp = tw.size_sweep(sizes)
    jg, jwls, jexp = jw.size_sweep(sizes)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    assert exp == jexp


@pytest.mark.parametrize("f,b,multiple", [(5, 3, 4), (2, 4, 2), (3, 1, 1)])
def test_noop_and_pad_scenarios_match_reference(f, b, multiple):
    _same_workload(tw.noop_scenarios(f, b), jw.noop_scenarios(f, b))
    g, wl, _ = tw.incast(3, 20)
    _, jwl, _ = jw.incast(3, 20)
    wls = tf.Workload.stack([wl] * b)
    padded, pad = tw.pad_scenarios(wls, multiple)
    jpadded, jpad = jw.pad_scenarios(jf.Workload.stack([jwl] * b), multiple)
    assert pad == jpad
    _same_workload(padded, jpadded)
    with pytest.raises(ValueError, match="multiple"):
        tw.pad_scenarios(wls, 0)


# --------------------------------------------- sweeps through the engine --

def test_profile_ablation_sweep_runs_bitwise():
    """The seven profiles as one call in both packages, bitwise."""
    g, wls, profs, _, exp = tw.profile_ablation_sweep(4, 2, 40)
    jg, jwls, jprofs, _, _ = jw.profile_ablation_sweep(4, 2, 40)
    p = dict(ticks=256, chunk_ticks=64)
    port = tf.simulate_batch(g, wls, profs, tf.SimParams(**p), device="cpu")
    ref = jf.simulate_batch(jg, jwls, jprofs, jf.SimParams(**p))
    assert_same_results(port, ref)
    assert exp["victim_flow"] == 4


def test_failure_sweep_runs_bitwise():
    g, wls, masks, _ = tw.failure_sweep(2, 4, 50)
    jg, jwls, jmasks, _ = jw.failure_sweep(2, 4, 50)
    p = dict(ticks=256, chunk_ticks=64, timeout_ticks=64)
    port = tf.simulate_batch(g, wls, None, tf.SimParams(**p), failed=masks,
                             trace="full", device="cpu")
    ref = jf.simulate_batch(jg, jwls, None, jf.SimParams(**p),
                            failed=jmasks, trace="full")
    assert_same_results(port, ref)
    assert port[0].drops == 0 and all(r.drops for r in port[1:])


def test_size_sweep_with_padding_runs_bitwise():
    """Padded no-op lanes quiesce at the first boundary and leave the
    real lanes' bits alone."""
    g, wls, _ = tw.size_sweep((20, 60, 40))
    jg, jwls, _ = jw.size_sweep((20, 60, 40))
    padded, pad = tw.pad_scenarios(wls, 4)
    p = dict(ticks=256, chunk_ticks=32)
    port = tf.simulate_batch(g, padded, None, tf.SimParams(**p),
                             device="cpu")
    ref = jf.simulate_batch(jg, jwls, None, jf.SimParams(**p))
    assert pad == 1 and len(port) == 4
    assert_same_results(port[:3], ref)
    assert port[3].horizon == 32 and not port[3].state.delivered.any()


# ------------------------------------------------------------ fault grids --

def _same_schedule(f, jf_):
    d = convert.faults_to_numpy(f)
    for fl in dataclasses.fields(type(jf_)):
        want = np.asarray(getattr(jf_, fl.name))
        assert d[fl.name].dtype == want.dtype, fl.name
        np.testing.assert_array_equal(d[fl.name], want, err_msg=fl.name)


def _same_dataclass(a, b):
    for fl in dataclasses.fields(b):
        va, vb = getattr(a, fl.name), getattr(b, fl.name)
        assert (int(va) if hasattr(va, "value") else va) == \
            (int(vb) if hasattr(vb, "value") else vb), fl.name


@pytest.mark.parametrize("kw", [dict(), dict(llr=True, cbfc=True,
                                           llr_rtt=3,
                                           credit_return_ticks=9)])
def test_link_config_copy_builds_the_same_spec(kw):
    """``core/link.py`` is a copy: the same fields, defaults, validation
    and derived values as the reference's."""
    a, b = link.LinkConfig(**kw), jlink.LinkConfig(**kw)
    _same_dataclass(a, b)
    assert a.enabled == b.enabled
    _same_dataclass(link.LinkConfig.on(), jlink.LinkConfig.on())
    _same_dataclass(link.LinkConfig.off(), jlink.LinkConfig.off())
    for bad in (dict(llr_rtt=0), dict(credit_return_ticks=0)):
        with pytest.raises(ValueError):
            link.LinkConfig(**bad)
    assert link.fabric_buffer_pricing(135) == jlink.fabric_buffer_pricing(135)
    st, jst = link.CBFCState(1000).send(700).drain(300), \
        jlink.CBFCState(1000).send(700).drain(300)
    assert (st.available(), st.can_send(600)) == \
        (jst.available(), jst.can_send(600))
    assert link.LINK_STATE_LANES == jlink.LINK_STATE_LANES


@pytest.mark.parametrize("args", [(), (2, 4, 60, 50, 300, 0.1)])
def test_fault_sweep_matches_reference(args):
    g, wls, faults, exp = tw.fault_sweep(*args)
    jg, jwls, jfaults, jexp = jw.fault_sweep(*args)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    _same_schedule(faults, jfaults)
    assert exp == jexp


@pytest.mark.parametrize("args", [(), (2, 3, 40, 20, 200, 900)])
def test_host_fault_sweep_matches_reference(args):
    g, wls, faults, exp = tw.host_fault_sweep(*args)
    jg, jwls, jfaults, jexp = jw.host_fault_sweep(*args)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    _same_schedule(faults, jfaults)
    _same_profiles(exp.pop("profile"), jexp.pop("profile"))
    assert exp == jexp


@pytest.mark.parametrize("args", [(), ((0.0, 0.05), 4, 2, 40, 900)])
def test_corruption_sweep_matches_reference(args):
    g, wls, faults, exp = tw.corruption_sweep(*args)
    jg, jwls, jfaults, jexp = jw.corruption_sweep(*args)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    _same_schedule(faults, jfaults)
    for k in ("link", "cbfc", "params"):
        _same_dataclass(exp.pop(k), jexp.pop(k))
    _same_profiles([exp.pop("profile")], [jexp.pop("profile")])
    assert exp == jexp


def test_fault_sweep_runs_bitwise():
    """Flaps, staggered flaps, two gray levels and a permanent death as
    one call in both packages; every lane completes."""
    g, wls, faults, _ = tw.fault_sweep(2, 4, 60, 50, 300, 0.1)
    jg, jwls, jfaults, _ = jw.fault_sweep(2, 4, 60, 50, 300, 0.1)
    p = dict(ticks=2048, chunk_ticks=64, timeout_ticks=64, ooo_threshold=24)
    port = tf.simulate_batch(g, wls, None, tf.SimParams(**p), faults=faults,
                             device="cpu")
    ref = jf.simulate_batch(jg, jwls, None, jf.SimParams(**p),
                            faults=jfaults)
    assert_same_results(port, ref)
    assert all(r.completion_tick() != -1 for r in port)
    assert port[0].drops == 0 and all(r.drops for r in port[1:])


def test_host_fault_sweep_runs_bitwise():
    """The endpoint grid with its per-scenario profiles (two groups):
    the dead-host lane quarantines both flows and quiesces early, its
    pdc-off twin burns the budget, the NIC stall abandons nothing."""
    args = (2, 3, 40, 20, 200, 900)
    g, wls, faults, exp = tw.host_fault_sweep(*args)
    jg, jwls, jfaults, jexp = jw.host_fault_sweep(*args)
    p = dict(ticks=exp["budget"], chunk_ticks=64, timeout_ticks=16)
    port = tf.simulate_batch(g, wls, exp["profile"], tf.SimParams(**p),
                             faults=faults, device="cpu")
    ref = jf.simulate_batch(jg, jwls, jexp["profile"], jf.SimParams(**p),
                            faults=jfaults)
    assert_same_results(port, ref)
    dead, off, stall, healthy = port
    assert dead.flows_abandoned == 2 and dead.horizon < exp["budget"]
    assert off.horizon == exp["budget"] and off.flows_abandoned == 0
    assert stall.flows_abandoned == 0 and stall.completion_tick() > 0
    assert healthy.flows_abandoned == 0 and healthy.ticks_unreachable == 0


def test_corruption_sweep_llr_off_arm_runs_bitwise():
    """The BER grid without the link layer: corruption leaks into
    end-to-end recovery as silent drops; the BER = 0 lane drops
    nothing."""
    g, wls, faults, exp = tw.corruption_sweep((0.0, 0.05), 4, 2, 40)
    jg, jwls, jfaults, jexp = jw.corruption_sweep((0.0, 0.05), 4, 2, 40)
    port = tf.simulate_batch(g, wls, exp["profile"], exp["params"],
                             faults=faults, device="cpu")
    ref = jf.simulate_batch(jg, jwls, jexp["profile"], jexp["params"],
                            faults=jfaults)
    assert_same_results(port, ref)
    assert port[0].drops == 0 and port[1].drops > 0
    assert all(r.completion_tick() > 0 for r in port)
    # the LLR-on arm runs too (item 8, tests/test_torch_link.py); a
    # link= that is no LinkConfig is refused, as the reference's is
    with pytest.raises(TypeError, match="LinkConfig"):
        tf.simulate_batch(g, wls, exp["profile"], exp["params"],
                          faults=faults, link=True, device="cpu")
