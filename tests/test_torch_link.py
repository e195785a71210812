"""The link layer on the port's tick (LLR replay at the hop, the CBFC
credit gate) against the reference package on the CPU, bitwise — the
twins of ``tests/test_link_layer.py`` (its sharded twin is in
``test_torch_shard.py``, its telemetry twin in
``test_torch_telemetry.py``).

Each run goes through ``repro.network`` and ``repro_torch.network`` with
the same ``link=`` spec; horizon, stats lanes, every state lane (the
LLR replay windows, the 20-bit CBFC counters and their credit-return
ring included) and the counters ``llr_replays`` / ``credit_stall_ticks``
are held bitwise, then the reference test's assertions are repeated on
the port's result. The grid is ``corruption_sweep``'s at a smaller
message size (120 packets, a 600-tick budget) so that every run stays
short. Last, ``repro_torch.convert`` round trips of live INC and link
states, and a handover: the reference's LLR+CBFC state after 128 ticks,
continued by the port, equals the reference's next 128 ticks.
"""
import dataclasses
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core import link as jlink
from repro.network import collectives as jc
from repro.network import fabric as jf
from repro.network import workloads as jw
from repro.network.faults import FaultSchedule as JFaults
from repro_torch import convert
from repro_torch.core import link
from repro_torch.core.link import LinkConfig, state_bitwise_equal
from repro_torch.network import fabric as tf
from repro_torch.network import workloads as tw
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import leaf_spine
from test_torch_batch import _same_state, assert_same_results
from test_torch_fabric import _assert_same_tree, _assert_state_matches, _jax_dict
from test_torch_faults import jprofile

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fabric_golden.npz")
SIZE, TICKS = 120, 600


def _jlink(spec):
    return None if spec is None else jlink.LinkConfig(
        **dataclasses.asdict(spec))


def _grid(bers=(0.0, 0.03)):
    """(port, reference) corruption grids at test size, and the params."""
    port = tw.corruption_sweep(bers=bers, size=SIZE, budget=TICKS)
    ref = jw.corruption_sweep(bers=bers, size=SIZE, budget=TICKS)
    return port, ref


def run_batch(port, ref, spec, **kw):
    """The grid's batch through both packages under ``spec``; held
    bitwise lane by lane (the link counters included)."""
    g, wls, scheds, exp = port
    jg, jwls, jscheds, jexp = ref
    faults, jfaults = kw.pop("faults", scheds), kw.pop("jfaults", jscheds)
    rs = tf.simulate_batch(g, wls, exp["profile"], exp["params"],
                           faults=faults, link=spec, device="cpu", **kw)
    js = jf.simulate_batch(jg, jwls, jexp["profile"], jexp["params"],
                           faults=jfaults, link=_jlink(spec), **kw)
    assert_same_results(rs, js)
    for b, (r, j) in enumerate(zip(rs, js)):
        assert (r.llr_replays, r.credit_stall_ticks) == \
            (j.llr_replays, j.credit_stall_ticks), b
    return rs


# ------------------------------------------------------------------------
# the event-driven LLRLink model and the spec
# ------------------------------------------------------------------------

def test_llr_stale_nack_clamps_to_send_base():
    for mod in (link, jlink):
        llr = mod.LLRLink(replay_capacity=16, timeout=8)
        for _ in range(10):
            llr.send()
        llr.on_ack(6)
        assert llr.on_nack(2) == [7, 8, 9]
        assert llr.retransmissions == 3
        assert llr.on_nack(7) == [7, 8, 9]


def test_linkconfig_validation():
    assert not LinkConfig.off().enabled
    assert LinkConfig.on(llr=True).enabled
    assert LinkConfig.on(llr=False, cbfc=True).enabled
    with pytest.raises(ValueError, match="llr_rtt"):
        LinkConfig(llr=True, llr_rtt=0)
    with pytest.raises(ValueError, match="credit_return_ticks"):
        LinkConfig(cbfc=True, credit_return_ticks=0)


def test_wrong_link_type_rejected():
    (g, wls, _, exp), _ = _grid((0.0,))
    for entry, w in (("simulate", wls.lanes(0)), ("simulate_batch", wls)):
        with pytest.raises(TypeError, match="LinkConfig"):
            getattr(tf, entry)(g, w, exp["profile"], exp["params"],
                               link=True, device="cpu")


def test_off_spec_shares_the_pre_link_tick():
    """None and ``LinkConfig.off()`` normalize to the same (pre-link)
    tick and state; the on specs size the link lanes."""
    assert tf._check_link(None) is None
    assert tf._check_link(LinkConfig.off()) is None
    on = LinkConfig.on(llr=True, cbfc=True, credit_return_ticks=3)
    assert tf._check_link(on) is on
    g = leaf_spine(2, 2, 2)
    wl = tf.Workload.stack([tf.Workload.of([0, 1], [2, 3], 8)] * 2)
    states = [tf.init_state(g, wl, TransportProfile.ai_full(),
                            tf.SimParams(), device="cpu", link=spec)
              for spec in (None, on)]
    assert states[0].llr_busy_until.shape == (2, 0)
    assert states[0].cbfc_ret.shape == (2, 0, 0)
    assert states[1].llr_busy_until.shape == (2, g.num_queues)
    assert states[1].cbfc_ret.shape == (2, 3, g.num_queues)
    assert state_bitwise_equal(states[0], states[1]) is None


def test_link_off_keeps_golden_full_trace_bitwise():
    gold = np.load(GOLDEN)
    g = leaf_spine(leaves=2, spines=4, hosts_per_leaf=4)
    wl = tf.Workload.of([0, 1, 2], [4, 5, 6], 200)
    r = tf.simulate(g, wl, TransportProfile.ai_full(), tf.SimParams(ticks=300),
                    trace="full", link=LinkConfig.off(), device="cpu")
    h = r.horizon
    np.testing.assert_array_equal(r.delivered_per_tick,
                                  gold["a_delivered"][:h])
    np.testing.assert_array_equal(r.cwnd_per_tick.view(np.int32),
                                  gold["a_cwnd"][:h].view(np.int32))
    np.testing.assert_array_equal(r.state.delivered.numpy(),
                                  gold["a_state_delivered"])


# ------------------------------------------------------------------------
# inertness, confinement, back-pressure
# ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clean():
    """The clean (BER = 0) grid and its run without the link layer."""
    port, ref = _grid((0.0,))
    return port, ref, run_batch(port, ref, None)[0]


@pytest.mark.parametrize("arm", ["link", "cbfc"])
def test_clean_link_armed_run_is_bitwise_inert(clean, arm):
    """BER = 0 with LLR (and CBFC) armed: bitwise the plain run on every
    pre-link lane, congestion trims included."""
    port, ref, off = clean
    exp = port[3]
    on = run_batch(port, ref, exp[arm])[0]
    assert on.llr_replays == 0
    if arm == "link":
        assert state_bitwise_equal(on.state, off.state) is None
        assert on.trims == off.trims > 0
        assert on.credit_stall_ticks == 0
    else:
        # the credit gate changes the clean run: it back-pressures
        assert on.trims == 0 < off.trims and on.credit_stall_ticks > 0
    assert link.LINK_STATE_LANES == jlink.LINK_STATE_LANES


def test_no_corruption_escapes_llr_across_seeds_and_bers():
    """Three seeds x two BERs as one batch per arm: the LLR arm delivers
    every flow with zero end-to-end drops and hop-local replays; the
    LLR-off arm leaks the same corruption as silent drops."""
    port, ref = _grid((0.03,))
    g, wls, _, exp = port
    wl = wls.lanes(0)
    points = [(seed, ber) for seed in (1, 0xBEEF, 12345)
              for ber in (0.02, 0.08)]
    kw = dict(
        faults=FaultSchedule.stack([FaultSchedule.healthy(g.num_queues)
                                    .corrupt(exp["uplinks"], b)
                                    for _, b in points]),
        jfaults=JFaults.stack([JFaults.healthy(g.num_queues)
                               .corrupt(exp["uplinks"], b)
                               for _, b in points]),
        seeds=np.asarray([s for s, _ in points], np.uint32))
    wl6 = tf.Workload.stack([wl] * 6)
    jwl6 = jf.Workload.stack([_lane0(ref[1])] * 6)
    port6, ref6 = (g, wl6) + port[2:], (ref[0], jwl6) + ref[2:]
    total = int(wl.size.sum())
    llr = run_batch(port6, ref6, exp["link"], **dict(kw))
    leak = run_batch(port6, ref6, None, **dict(kw))
    for (seed, ber), r, e in zip(points, llr, leak):
        assert r.drops == 0 and r.llr_replays > 0, (seed, ber)
        assert r.completion_tick() > 0, (seed, ber)
        assert int(r.state.delivered.sum()) == total
        assert e.drops > 0, (seed, ber)


def test_cbfc_backpressures_instead_of_trimming(clean):
    port, ref, off = clean
    cb = run_batch(port, ref, LinkConfig.on(llr=False, cbfc=True))[0]
    assert off.trims > 0 and cb.trims == 0
    assert cb.credit_stall_ticks > 0 and cb.completion_tick() > 0
    assert cb.drops == 0
    pricing = link.fabric_buffer_pricing(port[0].num_queues)
    assert pricing == jlink.fabric_buffer_pricing(port[0].num_queues)
    assert pricing["cbfc_total_bytes"] < pricing["pfc_total_bytes"] / 2


@pytest.mark.parametrize("arm", ["link", "cbfc"])
def test_batched_link_lanes_match_serial_bitwise(arm):
    port, ref = _grid((0.0, 0.02, 0.08))
    g, wls, scheds, exp = port
    rs = run_batch(port, ref, exp[arm])
    for i, r in enumerate(rs):
        solo = tf.simulate(g, wls.lanes(i), exp["profile"], exp["params"],
                           faults=scheds.lanes(i),
                           link=exp[arm], device="cpu")
        assert solo.horizon == r.horizon, i
        _same_state(solo.state, r.state)
        assert (solo.llr_replays, solo.credit_stall_ticks) == \
            (r.llr_replays, r.credit_stall_ticks), i
    assert rs[2].llr_replays > rs[1].llr_replays > 0


def test_corruption_sweep_is_the_shared_definition():
    g, wls, scheds, exp = tw.corruption_sweep(bers=(0.0, 0.01, 0.05))
    assert exp["bers"] == (0.0, 0.01, 0.05)
    assert exp["names"] == ["ber_0", "ber_0.01", "ber_0.05"]
    assert wls.src.shape[0] == 3
    assert exp["link"].llr and not exp["link"].cbfc
    assert exp["cbfc"].llr and exp["cbfc"].cbfc
    assert exp["params"].ticks == exp["budget"]
    gv, wl, expv = tw.victim_sweep(pairs=4, uplinks=2, size=400)
    assert exp["uplinks"] == expv["uplinks"]
    for i in range(3):
        np.testing.assert_array_equal(wls.src[i].numpy(), wl.src.numpy())
    cp = scheds.corrupt_p.numpy()
    assert (cp[0] == 0).all()
    for i, ber in enumerate(exp["bers"][1:], start=1):
        assert set(np.nonzero(cp[i])[0].tolist()) == set(exp["uplinks"])
        np.testing.assert_allclose(cp[i][list(exp["uplinks"])], ber)


# ------------------------------------------------------------------------
# convert: live INC and link lanes cross both ways
# ------------------------------------------------------------------------

def test_convert_round_trips_live_inc_and_link_lanes():
    port, ref = _grid((0.05,))
    exp = port[3]
    jg, jwls, jscheds, jexp = ref
    j = jf.simulate(jg, _lane0(jwls), jexp["profile"], jexp["params"],
                    faults=_lane0(jscheds), link=jexp["cbfc"])
    d = _jax_dict(j.state)
    assert d["llr_busy_until"].any() and d["cbfc_consumed"].any()
    assert d["cbfc_ret"].shape == (exp["cbfc"].credit_return_ticks,
                                   port[0].num_queues)
    assert d["cbfc_consumed"].dtype == np.uint32
    s = convert.state_from_numpy(d, "cpu")
    _assert_same_tree(convert.state_to_numpy(s), d)
    # a live INC context: the tree reduce's slots and bitmaps
    spec = jc.CollectiveSpec("all_reduce", tuple(range(8)), 24)
    jr = jf.simulate(_jgraph(), jc.build_workload(spec, "tree"),
                     jprofile(replace(TransportProfile.ai_full(), inc=True)),
                     jf.SimParams(ticks=200), max_ticks=200)
    d = _jax_dict(jr.state)
    assert (d["inc"]["slot_bits"] != 0).any() and d["inc_reduced"] > 0
    s = convert.state_from_numpy(d, "cpu")
    assert s.inc.slot_bits.dtype == torch.int32
    _assert_same_tree(convert.state_to_numpy(s), d)


def _lane0(tree):
    return type(tree)(*(getattr(tree, f.name)[0]
                        for f in dataclasses.fields(tree)))


def _jgraph():
    from repro.network import topology as jt
    return jt.leaf_spine(2, 2, 4)


@pytest.mark.parametrize("what", ["link", "inc"])
def test_handover_of_a_live_state(what):
    """The reference's state after 128 ticks, carried across, stepped by
    the port for one 128-tick chunk: equal to the reference's 256-tick
    run (lanes and state)."""
    if what == "link":
        port, ref = _grid((0.05,))
        g, wls, scheds, exp = port
        jg, jwls, jscheds, jexp = ref
        spec, prof, p = exp["cbfc"], exp["profile"], exp["params"]
        jwl, jfault = _lane0(jwls), _lane0(jscheds)
    else:
        g, jg = leaf_spine(2, 2, 4), _jgraph()
        spec, p = None, tf.SimParams(ticks=600)
        prof = replace(TransportProfile.ai_full(), inc=True)
        jwl = jc.build_workload(jc.CollectiveSpec(
            "all_reduce", tuple(range(8)), 24), "tree")
        jfault = JFaults.healthy(jg.num_queues)
    jp = jf.SimParams(**dataclasses.asdict(p))
    runs = [jf.simulate(jg, jwl, jprofile(prof), jp, faults=jfault,
                        link=_jlink(spec), trace="full", max_ticks=t)
            for t in (128, 256)]
    s = tf.stack_lanes([convert.state_from_numpy(_jax_dict(runs[0].state),
                                                 "cpu")])
    wl = tf.Workload.stack([convert.workload_from_numpy(_jax_dict(jwl),
                                                        "cpu")])
    fault = tf.FaultSchedule.stack([convert.faults_from_numpy(
        _jax_dict(jfault), "cpu")])
    step = tf.make_step(g, prof, p, int(wl.src.shape[1]),
                        corrupty=fault.has_corruption, link=spec,
                        device="cpu")
    s2, _, chunks, horizon = tf.run_chunks(step, s, wl, fault, budget=256,
                                           chunk=128, trace="full",
                                           tick0=128)
    assert horizon.tolist() == [256]
    np.testing.assert_array_equal(chunks[0]["delivered"][:, 0],
                                  runs[1].delivered_per_tick[128:256])
    _assert_state_matches(tf.take_lane(s2, 0), runs[1].state)
    live = (s2.llr_busy_until.any() and s2.cbfc_ret.any()
            if what == "link" else s2.inc.slot_bits.any())
    assert live
