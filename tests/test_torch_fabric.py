"""The port's fabric engine as a whole against the reference package, on
the CPU (plain kernel versions):

* the two goldens of ``tests/golden/fabric_golden.npz`` (config A as a
  bitwise prefix; config B — REPS, a dead uplink, seed 0x5EED+3 —
  through ``simulate_batch``, as its definition says, and matched over
  its whole 400-tick budget);
* trajectory parity with ``repro.network.fabric.simulate(trace="full")``
  on a 3-tier k=6 fat tree (fanout 3) with a 6:1 incast on top of a
  cross-pod permutation, so trims, NACKs, ``nack_mark`` and retransmits
  all run: every out lane and every final state lane bitwise;
* the stats tier against the full tier;
* a handover: the reference's state after 128 ticks, carried across with
  ``repro_torch.convert`` as a [1, F] batch, stepped one chunk by the
  port;
* the statics the port does not carry yet (telemetry) raising, alone
  and beside the fault, INC and link-layer statics it does.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.network import fabric as jf
from repro.network import topology as jt
from repro.network.faults import FaultSchedule as JFaults
from repro.network.profile import TransportProfile as JProfile
from repro_torch import convert
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.core.link import LinkConfig
from repro_torch.network import fabric as tf
from repro_torch.network.profile import DeliveryMode, TransportProfile
from repro_torch.network.topology import fat_tree3, leaf_spine

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fabric_golden.npz")
LANES = ("delivered_per_tick", "cwnd_per_tick", "qlen_max",
         "rx_base_per_tick", "src_base_per_tick")

# the trajectory-parity scenario: 27 hosts, Q = 135, fanout 3; host i
# sends to host (i+9) mod 27 and hosts 9-14 also send to host 0
K6_SRC = list(range(27)) + list(range(9, 15))
K6_DST = [(i + 9) % 27 for i in range(27)] + [0] * 6
K6_SIZE = 60
K6_PARAMS = dict(ticks=1024, queue_capacity=8)


def _jax_dict(obj):
    """A reference dataclass / dict pytree as a nested dict of numpy
    arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _jax_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _jax_dict(v) for k, v in obj.items()}
    return np.asarray(obj)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.size else a


def _assert_same_tree(got: dict, want: dict, path="state"):
    for k, g in got.items():
        w = want[k]
        if isinstance(g, dict):
            _assert_same_tree(g, w, f"{path}.{k}")
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (f"{path}.{k}", g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{path}.{k}")


def _assert_state_matches(port_state, jax_state):
    """Every lane the port carries equals the reference's bitwise, and
    every reference lane it does not carry is inert."""
    want = _jax_dict(jax_state)
    convert.state_from_numpy(want, "cpu")       # raises on a live lane
    _assert_same_tree(convert.state_to_numpy(port_state), want)


def _assert_lanes(port, ref, t0=0, t1=None):
    for lane in LANES:
        a, b = getattr(port, lane), getattr(ref, lane)[t0:t1]
        assert a.dtype == b.dtype, lane
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=lane)


# ------------------------------------------------------------- goldens --

def test_golden_a_is_a_bitwise_prefix():
    gold = np.load(GOLDEN)
    g = leaf_spine(leaves=2, spines=4, hosts_per_leaf=4)
    wl = tf.Workload.of([0, 1, 2], [4, 5, 6], 200)
    p = tf.SimParams(ticks=300)
    r = tf.simulate(g, wl, TransportProfile.ai_full(), p, trace="full",
                    device="cpu")
    h = r.horizon
    assert h <= 300 and h % p.chunk_ticks == 0
    np.testing.assert_array_equal(r.delivered_per_tick,
                                  gold["a_delivered"][:h])
    assert not gold["a_delivered"][h:].any()
    np.testing.assert_array_equal(_bits(r.cwnd_per_tick),
                                  _bits(gold["a_cwnd"][:h]))
    np.testing.assert_array_equal(r.qlen_max, gold["a_qlen"][:h])
    s = convert.state_to_numpy(r.state)
    np.testing.assert_array_equal(s["delivered"], gold["a_state_delivered"])
    np.testing.assert_array_equal(s["next_psn"], gold["a_state_next_psn"])
    np.testing.assert_array_equal(s["src_track"]["base"],
                                  gold["a_state_src_base"])


def test_ai_full_reps_failure_matches_golden_batched():
    gold = np.load(GOLDEN)
    g = leaf_spine(leaves=2, spines=4, hosts_per_leaf=8)
    wl = tf.Workload.of(list(range(8)), [8 + i for i in range(8)], 700)
    p = tf.SimParams(ticks=400, timeout_ticks=64, ooo_threshold=24)
    mask = np.zeros((1, g.num_queues), bool)
    mask[0, int(gold["b_failed_queue"][0])] = True
    r = tf.simulate_batch(g, tf.Workload.stack([wl]),
                          TransportProfile.ai_full(lb=LBScheme.REPS), p,
                          failed=mask,
                          seeds=np.asarray([0x5EED + 3], np.uint32),
                          trace="full", device="cpu")[0]
    assert r.horizon == 400
    np.testing.assert_array_equal(r.delivered_per_tick, gold["b_delivered"])
    np.testing.assert_array_equal(_bits(r.cwnd_per_tick),
                                  _bits(gold["b_cwnd"]))
    np.testing.assert_array_equal(r.qlen_max, gold["b_qlen"])
    s = convert.state_to_numpy(r.state)
    np.testing.assert_array_equal(s["delivered"], gold["b_state_delivered"])
    np.testing.assert_array_equal(s["src_track"]["base"],
                                  gold["b_state_src_base"])
    assert r.ticks_degraded == 400


# ------------------------------------------------- trajectory parity ----

def _k6_port(**kw):
    return tf.simulate(fat_tree3(k=6, pods=3),
                       tf.Workload.of(K6_SRC, K6_DST, K6_SIZE),
                       TransportProfile.ai_full(),
                       tf.SimParams(**K6_PARAMS), device="cpu", **kw)


def _k6_jax(**kw):
    return jf.simulate(jt.fat_tree3(k=6, pods=3),
                       jf.Workload.of(K6_SRC, K6_DST, K6_SIZE),
                       JProfile.ai_full(), jf.SimParams(**K6_PARAMS), **kw)


@pytest.fixture(scope="module")
def k6_port():
    return _k6_port(trace="full")


@pytest.fixture(scope="module")
def k6_jax():
    return _k6_jax(trace="full")


def test_trajectory_parity_k6_fat_tree(k6_port, k6_jax):
    assert k6_port.trims > 0 and k6_port.rtx_packets > 0, \
        "the scenario must drive the NACK -> nack_mark -> retransmit path"
    assert k6_port.horizon == k6_jax.horizon
    assert k6_port.completion_tick() == k6_jax.completion_tick() > 0
    _assert_lanes(k6_port, k6_jax)
    _assert_state_matches(k6_port.state, k6_jax.state)
    for stat in ("trims", "drops", "dups", "timeouts", "rtx_packets"):
        assert getattr(k6_port, stat) == getattr(k6_jax, stat), stat


def test_stats_tier_equals_full_tier(k6_port):
    window = (100, 300)
    st = _k6_port(trace="stats", goodput_window=window)
    assert st.horizon == k6_port.horizon
    np.testing.assert_array_equal(st.completion_ticks(),
                                  k6_port.completion_ticks())
    np.testing.assert_array_equal(st.source_completion_ticks(),
                                  k6_port.source_completion_ticks())
    assert st.qlen_peak == int(k6_port.qlen_max.max())
    np.testing.assert_array_equal(st.goodput(window),
                                  k6_port.goodput(window))
    _assert_same_tree(convert.state_to_numpy(st.state),
                      convert.state_to_numpy(k6_port.state))


def test_handover_from_a_reference_mid_run_state(k6_jax):
    """Start the port from the reference's state after 128 ticks and run
    one chunk: lanes and state equal the reference's ticks 128..255. The
    reference's [F] state enters the tick as a batch of one ([1, F])."""
    mid = _k6_jax(trace="full", max_ticks=128)
    end = _k6_jax(trace="full", max_ticks=256)
    g = fat_tree3(k=6, pods=3)
    s = tf.stack_lanes([convert.state_from_numpy(_jax_dict(mid.state),
                                                 "cpu")])
    wl = tf.Workload.stack([convert.workload_from_numpy(
        _jax_dict(jf.Workload.of(K6_SRC, K6_DST, K6_SIZE)), "cpu")])
    fault = tf.FaultSchedule.stack([convert.faults_from_numpy(
        _jax_dict(JFaults.from_mask(np.zeros(g.num_queues, bool))), "cpu")])
    step = tf.make_step(g, TransportProfile.ai_full(),
                        tf.SimParams(**K6_PARAMS), len(K6_SRC), device="cpu")
    s2, _, chunks, horizon = tf.run_chunks(step, s, wl, fault, budget=256,
                                           chunk=128, trace="full",
                                           tick0=128)
    assert horizon.tolist() == [256] and len(chunks) == 1
    for lane, key in zip(LANES, ("delivered", "cwnd", "qlen_max", "rx_base",
                                 "src_base")):
        np.testing.assert_array_equal(
            _bits(chunks[0][key][:, 0]),
            _bits(getattr(k6_jax, lane)[128:256]), err_msg=lane)
    _assert_state_matches(tf.take_lane(s2, 0), end.state)


def test_init_state_and_convert_round_trip():
    g, jg = fat_tree3(k=6, pods=3), jt.fat_tree3(k=6, pods=3)
    for seed in (0x5EED, 0xFFFFFFF0):
        s = tf.take_lane(tf.init_state(
            g, tf.Workload.stack([tf.Workload.of(K6_SRC, K6_DST, K6_SIZE)]),
            TransportProfile.ai_full(), tf.SimParams(), seed, device="cpu"),
            0)
        js = jf.init_state(jg, jf.Workload.of(K6_SRC, K6_DST, K6_SIZE),
                           JProfile.ai_full(), jf.SimParams(),
                           np.uint32(seed))
        _assert_state_matches(s, js)
        d = convert.state_to_numpy(s)
        _assert_same_tree(convert.state_to_numpy(
            convert.state_from_numpy(d, "cpu")), d)


# --------------------------------------------------- unported statics --

def _k6_step(profile=None, **statics):
    return tf.make_step(fat_tree3(k=6, pods=3),
                        profile or TransportProfile.ai_full(),
                        tf.SimParams(), len(K6_SRC), device="cpu", **statics)


@pytest.mark.parametrize("statics", [
    dict(lossy=True, tel=object()),
    dict(hosty=True, link=LinkConfig.on(), tel=object()),
    dict(corrupty=True, tel=object()),
    dict(tel=object()),
    dict(link=LinkConfig.on(llr=True, cbfc=True), tel=object())])
def test_unported_statics_raise(statics):
    """Telemetry raises, also beside the fault statics (gray loss, host
    faults, corruption) and the link layer, which build."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _k6_step(**statics)
    statics.pop("tel")
    assert callable(_k6_step(**statics))


@pytest.mark.parametrize("profile", [
    TransportProfile.ai_full(inc=True),
    TransportProfile.resilient(inc=True)], ids=lambda q: repr(q))
def test_unported_profiles_raise(profile):
    """INC profiles build a tick (ROADMAP.md item 7); telemetry beside
    them still raises."""
    assert callable(_k6_step(profile))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _k6_step(profile, tel=object())


@pytest.mark.parametrize("profile", [
    TransportProfile.ai_full(rto_backoff=2.0),
    TransportProfile.ai_full(ev_eviction=True),
    TransportProfile.ai_full(pdc_dead_after=4),
    TransportProfile.resilient()], ids=lambda q: q.describe())
@pytest.mark.parametrize("statics", [
    dict(), dict(lossy=True, hosty=True, corrupty=True)],
    ids=["healthy", "faulted"])
def test_recovery_statics_build(profile, statics):
    """The recovery knobs and the fault statics build a tick (ROADMAP.md
    item 6) that steps a healthy k=6 state."""
    step = _k6_step(profile, **statics)
    g = fat_tree3(k=6, pods=3)
    wl = tf.Workload.stack([tf.Workload.of(K6_SRC, K6_DST, K6_SIZE)])
    s = tf.init_state(g, wl, profile, tf.SimParams(), device="cpu")
    fault = tf.FaultSchedule.healthy(g.num_queues, batch=1,
                                     num_hosts=g.num_hosts)
    s2, out = step(s, 0, wl, fault)
    assert out["delivered"].shape == (1, len(K6_SRC))
    assert int(s2.flows_abandoned) == 0 and not s2.quarantined.any()


def test_convert_refuses_a_live_unported_lane():
    js = jf.init_state(jt.fat_tree3(k=6, pods=3),
                       jf.Workload.of(K6_SRC, K6_DST, K6_SIZE),
                       JProfile.ai_full(), jf.SimParams())
    d = _jax_dict(js)
    d["lane_the_port_lacks"] = np.int32(3)
    with pytest.raises(NotImplementedError, match="lane_the_port_lacks"):
        convert.state_from_numpy(d, "cpu")
    # the link-layer counters cross now (item 8)
    del d["lane_the_port_lacks"]
    d["credit_stall_ticks"] = np.int32(3)
    assert int(convert.state_from_numpy(d, "cpu").credit_stall_ticks) == 3
    # the recovery lanes and every fault lane cross now (item 6)
    d = _jax_dict(js)
    d["quarantined"] = d["quarantined"].copy()
    d["quarantined"][3] = True
    s = convert.state_from_numpy(d, "cpu")
    assert bool(s.quarantined[3]) and int(s.quarantined.sum()) == 1
    lossy = _jax_dict(JFaults.healthy(135, seed=0xFFFFFFF0).lossy([4], 0.1))
    f = convert.faults_from_numpy(lossy, "cpu")
    _assert_same_tree(convert.faults_to_numpy(f), lossy)


def test_entry_points_run_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    g = leaf_spine(2, 2, 2)
    wl = tf.Workload.of([0], [2], 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.simulate(g, wl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_state(g, wl, TransportProfile.ai_full(), tf.SimParams())
