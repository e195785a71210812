"""The profile scenarios of ``tests/test_profiles.py``, run by the port on
the CPU: each asserts what the reference's test asserts, and also that
the port's numbers equal the reference's bit for bit. Plus the handover
of a reference mid-run state under ``hpc()`` and ``ai_base()``, which
carries the RCCC state, the hybrid's state dict and ``rod_rejects``
across with ``repro_torch.convert``.
"""
import numpy as np
import pytest

from repro.network import fabric as jf
from repro.network import profile as jprof
from repro.network import topology as jt
from repro.network import workloads as jw
from repro.network.faults import FaultSchedule as JFaults
from repro_torch import convert
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network import fabric as tf
from repro_torch.network.profile import (CCAlgo, DeliveryMode,
                                         TransportProfile, cc_ablation)
from repro_torch.network.topology import fat_tree3, leaf_spine
from test_torch_fabric import (K6_DST, K6_PARAMS, K6_SIZE, K6_SRC, LANES,
                               _assert_lanes, _assert_state_matches, _bits,
                               _jax_dict)


def _incast(fan_in, size):
    """The port's copy of ``repro.network.workloads.incast``, checked
    against it: fan_in senders on distinct leaves -> host 0."""
    g = leaf_spine(leaves=fan_in + 1, spines=4, hosts_per_leaf=4)
    srcs = [4 * (leaf + 1) for leaf in range(fan_in)]
    wl = tf.Workload.of(srcs, [0] * fan_in, size)
    jg, jwl, exp = jw.incast(fan_in, size=size)
    assert jg.num_queues == g.num_queues
    np.testing.assert_array_equal(wl.src.numpy(), np.asarray(jwl.src))
    np.testing.assert_array_equal(wl.dst.numpy(), np.asarray(jwl.dst))
    return (g, wl), (jg, jwl), exp


def _config_a():
    return (leaf_spine(leaves=2, spines=4, hosts_per_leaf=4),
            tf.Workload.of([0, 1, 2], [4, 5, 6], 200),
            jt.leaf_spine(leaves=2, spines=4, hosts_per_leaf=4),
            jf.Workload.of([0, 1, 2], [4, 5, 6], 200))


def _same_run(port, ref):
    assert port.horizon == ref.horizon
    _assert_lanes(port, ref)
    _assert_state_matches(port.state, ref.state)


def test_nscc_vs_rccc_diverge_under_congested_incast():
    (g, wl), (jg, jwl), exp = _incast(4, 100000)
    rs, js = {}, {}
    for tp, jp in zip(cc_ablation(), jprof.cc_ablation()):
        rs[tp.name] = tf.simulate(g, wl, tp, tf.SimParams(ticks=1200),
                                  trace="full", device="cpu")
        js[jp.name] = jf.simulate(jg, jwl, jp, jf.SimParams(ticks=1200),
                                  trace="full")
        _same_run(rs[tp.name], js[jp.name])
    nscc, rccc = rs["nscc_only"], rs["rccc_only"]
    assert not np.array_equal(nscc.delivered_per_tick,
                              rccc.delivered_per_tick)
    assert nscc.cwnd_per_tick.std() > 0
    assert rccc.cwnd_per_tick.std() == 0
    for r in (nscc, rccc, rs["hybrid"]):
        gp = r.goodput((300, 1200))
        assert abs(float(gp.sum()) - 1.0) < 0.1
    np.testing.assert_allclose(rccc.goodput((300, 1200)), exp["share"],
                               atol=0.02)
    total = lambda r: int(r.state.delivered.sum())  # noqa: E731
    assert total(rs["hybrid"]) <= min(total(nscc), total(rccc)) + 50
    for k in rs:
        np.testing.assert_array_equal(rs[k].goodput((300, 1200)),
                                      js[k].goodput((300, 1200)))


@pytest.fixture(scope="module")
def rod_incast():
    (g, wl), (jg, jwl), _ = _incast(2, 300)
    tp = TransportProfile(cc=CCAlgo.NSCC, delivery=DeliveryMode.ROD,
                          name="rod_test")
    jp = jprof.TransportProfile(cc=jprof.CCAlgo.NSCC,
                                delivery=jprof.DeliveryMode.ROD,
                                name="rod_test")
    port = tf.simulate(g, wl, tp, tf.SimParams(ticks=2500), trace="full",
                       device="cpu")
    ref = jf.simulate(jg, jwl, jp, jf.SimParams(ticks=2500), trace="full")
    return port, ref, wl


def test_rod_in_order_delivery_invariant(rod_incast):
    r, ref, wl = rod_incast
    cum = r.delivered_per_tick.cumsum(axis=0)
    assert (cum[-1] == wl.size.numpy()).all(), "ROD must complete"
    np.testing.assert_array_equal(cum.astype(np.uint32), r.rx_base_per_tick)
    assert int(r.state.trims) > 0, "scenario must actually be congested"
    _same_run(r, ref)


def test_rod_rejects_counted_separately_from_dups(rod_incast):
    r, ref, _ = rod_incast
    s = r.state
    assert int(s.rod_rejects) > 0, "congested ROD must reject OOO"
    track_dups = (s.dst_track.dup.numpy().view(np.uint32).astype(np.int64)
                  + s.dst_track.oor.numpy().view(np.uint32)).sum()
    assert int(s.dups) == int(track_dups)
    assert int(s.rod_rejects) == int(ref.state.rod_rejects)
    assert int(s.dups) == int(ref.state.dups)


def test_mixed_per_flow_delivery_modes():
    g, wl, jg, jwl = _config_a()
    D, JD = DeliveryMode, jprof.DeliveryMode
    prof = TransportProfile(cc=CCAlgo.NSCC, lb=LBScheme.REPS,
                            delivery=(D.RUD, D.ROD, D.RUDI), name="mixed")
    jp = jprof.TransportProfile(cc=jprof.CCAlgo.NSCC,
                                lb=jprof.LBScheme.REPS,
                                delivery=(JD.RUD, JD.ROD, JD.RUDI),
                                name="mixed")
    r = tf.simulate(g, wl, prof, tf.SimParams(ticks=800), trace="full",
                    device="cpu")
    cum = r.delivered_per_tick.cumsum(axis=0)
    assert (cum[-1] == 200).all()
    np.testing.assert_array_equal(cum[:, 1].astype(np.uint32),
                                  r.rx_base_per_tick[:, 1])
    _same_run(r, jf.simulate(jg, jwl, jp, jf.SimParams(ticks=800),
                             trace="full"))


def test_delivery_tuple_length_validated():
    g, wl, jg, jwl = _config_a()
    prof = TransportProfile(delivery=(DeliveryMode.RUD, DeliveryMode.ROD))
    with pytest.raises(ValueError, match="per-flow delivery"):
        tf.simulate(g, wl, prof, tf.SimParams(ticks=300), device="cpu")
    jp = jprof.TransportProfile(delivery=(jprof.DeliveryMode.RUD,
                                          jprof.DeliveryMode.ROD))
    with pytest.raises(ValueError, match="per-flow delivery"):
        jf.simulate(jg, jwl, jp, jf.SimParams(ticks=300))


@pytest.mark.parametrize("name", ["hpc", "ai_base"])
def test_handover_from_a_reference_mid_run_state(name):
    """Start the port from the reference's state after 128 ticks, as a
    [1, F] batch, and run one chunk: lanes and state equal the
    reference's ticks 128..255."""
    jp = getattr(jprof.TransportProfile, name)()
    tp = getattr(TransportProfile, name)()

    def ref(t):
        return jf.simulate(jt.fat_tree3(k=6, pods=3),
                           jf.Workload.of(K6_SRC, K6_DST, K6_SIZE), jp,
                           jf.SimParams(**K6_PARAMS), trace="full",
                           max_ticks=t)

    mid, end = ref(128), ref(256)
    d = _jax_dict(mid.state)
    if name == "hpc":
        assert set(d["cc"]) == {"nscc", "rccc"} and d["rod_rejects"] > 0
    g = fat_tree3(k=6, pods=3)
    s = tf.stack_lanes([convert.state_from_numpy(d, "cpu")])
    wl = tf.Workload.stack([convert.workload_from_numpy(
        _jax_dict(jf.Workload.of(K6_SRC, K6_DST, K6_SIZE)), "cpu")])
    fault = tf.FaultSchedule.stack([convert.faults_from_numpy(
        _jax_dict(JFaults.from_mask(np.zeros(g.num_queues, bool))), "cpu")])
    step = tf.make_step(g, tp, tf.SimParams(**K6_PARAMS), len(K6_SRC),
                        device="cpu")
    s2, _, chunks, horizon = tf.run_chunks(step, s, wl, fault, budget=256,
                                           chunk=128, trace="full",
                                           tick0=128)
    assert horizon.tolist() == [256] and len(chunks) == 1
    for lane, key in zip(LANES, ("delivered", "cwnd", "qlen_max", "rx_base",
                                 "src_base")):
        np.testing.assert_array_equal(
            _bits(chunks[0][key][:, 0]), _bits(getattr(end, lane)[128:256]),
            err_msg=lane)
    _assert_state_matches(tf.take_lane(s2, 0), end.state)
