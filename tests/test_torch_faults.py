"""The port's fault engine against the reference's, on the CPU, bitwise —
part 1 of the twins of ``tests/test_faults.py``: static masks and their
degenerate schedule, API validation, ``loss_threshold``, gray links and
PHY corruption without the link layer; and the pieces under them (the fault
schedule builders, EV eviction and its steering of draws).

Each twin runs the same seeded scenario through ``repro.network`` and
``repro_torch.network`` on the CPU, holds every lane and counter of the
two results bitwise (horizon, stats lanes, every state lane, the f32
``cwnd`` included, and the recovery counters), then repeats the
reference test's own assertions on the port's result. The other parts
are ``test_torch_faults_recovery.py``, ``test_torch_faults_escape.py``,
``test_torch_faults_backoff.py`` and ``test_torch_faults_batch.py``;
the helpers here serve them all.
"""
from dataclasses import fields, replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lb import schemes as jlb
from repro.network import fabric as jf
from repro.network import faults as jfl
from repro.network import topology as jt
from repro.network.profile import CCAlgo as JCC
from repro.network.profile import DeliveryMode as JDM
from repro.network.profile import TransportProfile as JP
from repro_torch.core.lb import schemes as lb
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network import fabric as tf
from repro_torch.network.faults import FaultSchedule, loss_threshold
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import leaf_spine
from test_torch_batch import _same_state, assert_same_results

# The port's CPU tick is hundreds of small eager operations: one
# intra-op thread per test process keeps parallel test workers from
# oversubscribing the cores (30x slower at Q = 320 when they do).
torch.set_num_threads(1)

NAMED_PROFILES = ("ai_base", "ai_full", "hpc")
_GRAPHS: dict = {}


def graphs(leaves=2, spines=2, hosts_per_leaf=4):
    """(port, reference) leaf-spine graphs, one pair per shape, so the
    reference's compiled runs are reused across tests."""
    key = (leaves, spines, hosts_per_leaf)
    if key not in _GRAPHS:
        _GRAPHS[key] = (leaf_spine(*key), jt.leaf_spine(*key))
    return _GRAPHS[key]


def jprofile(q: TransportProfile) -> JP:
    """The reference's TransportProfile with the port's fields."""
    d = q.delivery
    delivery = (tuple(JDM(int(m)) for m in d) if isinstance(d, tuple)
                else JDM(int(d)))
    return JP(cc=JCC(int(q.cc)), lb=jlb.LBScheme(int(q.lb)),
              delivery=delivery, inc=q.inc, rto_backoff=q.rto_backoff,
              rto_max_scale=q.rto_max_scale, ev_eviction=q.ev_eviction,
              pdc_dead_after=q.pdc_dead_after, name=q.name)


def run(g2, wl, prof, params, *, faults=None, failed=None, seed=0x5EED,
        trace="stats", max_ticks=None):
    """One scenario through both packages' ``simulate``; holds them
    bitwise and returns the port's result. ``wl`` is (src, dst, size);
    ``faults`` builds a schedule from a FaultSchedule class."""
    g, jg = g2
    r = tf.simulate(g, tf.Workload.of(*wl), prof, tf.SimParams(**params),
                    seed=seed, failed=failed, trace=trace,
                    max_ticks=max_ticks, device="cpu",
                    faults=None if faults is None else faults(FaultSchedule))
    j = jf.simulate(jg, jf.Workload.of(*wl), jprofile(prof),
                    jf.SimParams(**params), seed=seed, failed=failed,
                    trace=trace, max_ticks=max_ticks,
                    faults=None if faults is None
                    else faults(jfl.FaultSchedule))
    assert_same_results([r], [j])
    return r


def run_batch(g2, wls, prof, params, *, faults=None, failed=None,
              seeds=None, trace="stats", max_ticks=None):
    """B scenarios through both packages' ``simulate_batch``; held
    bitwise lane by lane. ``wls`` is a list of (src, dst, size);
    ``faults`` builds a [B, Q] schedule from a FaultSchedule class."""
    g, jg = g2
    kw = dict(trace=trace, max_ticks=max_ticks, failed=failed)
    if seeds is not None:
        kw["seeds"] = np.asarray(seeds, np.uint32)
    profs = prof if isinstance(prof, list) else None
    rs = tf.simulate_batch(
        g, [tf.Workload.of(*w) for w in wls], prof, tf.SimParams(**params),
        faults=None if faults is None else faults(FaultSchedule),
        device="cpu", **kw)
    js = jf.simulate_batch(
        jg, jf.Workload.stack([jf.Workload.of(*w) for w in wls]),
        [jprofile(q) for q in profs] if profs else jprofile(prof),
        jf.SimParams(**params),
        faults=None if faults is None else faults(jfl.FaultSchedule), **kw)
    assert_same_results(rs, js)
    return rs


def small():
    """2 leaves x 2 spines, 4 hosts/leaf; all flows cross-leaf, so every
    packet rides an uplink (``tests/test_faults.py``'s ``_small``)."""
    g2 = graphs(2, 2, 4)
    ups = [int(g2[0].up1_table[0, i]) for i in range(2)]
    return g2, ([0, 1, 2, 3], [4, 5, 6, 7], 150), ups


def delivered(r) -> np.ndarray:
    return r.state.delivered.numpy()


# ------------------------------------------------------------------------
# static masks: the degenerate schedule is bitwise the failed= path
# ------------------------------------------------------------------------

def test_from_mask_bitwise_equals_failed_serial():
    g2, wl, ups = small()
    mask = np.zeros(g2[0].num_queues, bool)
    mask[ups[0]] = True
    p = dict(ticks=900, timeout_ticks=64)
    for prof in (TransportProfile.ai_full(lb=LBScheme.REPS),
                 TransportProfile.hpc()):
        a = run(g2, wl, prof, p, failed=mask)
        b = run(g2, wl, prof, p, faults=lambda FS: FS.from_mask(mask))
        assert a.horizon == b.horizon, prof.name
        np.testing.assert_array_equal(a.completion_ticks(),
                                      b.completion_ticks())
        _same_state(a.state, b.state)
        assert b.ticks_degraded == b.horizon


def test_from_mask_bitwise_equals_failed_batched():
    g2, (src, dst, size), ups = small()
    wls = [(src, dst, size), (src, dst, size // 2)]
    masks = np.zeros((2, g2[0].num_queues), bool)
    masks[0, ups[0]] = True
    p = dict(ticks=900, timeout_ticks=64)
    base = run_batch(g2, wls, TransportProfile.ai_full(), p, failed=masks)
    via = run_batch(g2, wls, TransportProfile.ai_full(), p,
                    faults=lambda FS: FS.from_mask(masks))
    for i, (a, b) in enumerate(zip(base, via)):
        assert a.horizon == b.horizon, f"scenario {i}"
        np.testing.assert_array_equal(a.completion_ticks(),
                                      b.completion_ticks())
        _same_state(a.state, b.state)


def test_healthy_schedule_is_bitwise_no_faults():
    g2, wl, _ = small()
    p = dict(ticks=700)
    a = run(g2, wl, TransportProfile.ai_full(), p)
    b = run(g2, wl, TransportProfile.ai_full(), p,
            faults=lambda FS: FS.healthy(g2[0].num_queues))
    assert a.horizon == b.horizon
    _same_state(a.state, b.state)
    assert b.timeouts == 0 and b.ticks_degraded == 0


# ------------------------------------------------------------------------
# API validation
# ------------------------------------------------------------------------

def test_failed_and_faults_are_mutually_exclusive():
    g2, wl, _ = small()
    g = g2[0]
    with pytest.raises(ValueError, match="not both"):
        tf.simulate(g, tf.Workload.of(*wl), TransportProfile.ai_full(),
                    tf.SimParams(ticks=10),
                    failed=np.zeros(g.num_queues, bool),
                    faults=FaultSchedule.healthy(g.num_queues), device="cpu")


def test_schedule_validation():
    g2, wl, _ = small()
    g = g2[0]
    p, prof, w = tf.SimParams(ticks=10), TransportProfile.ai_full(), \
        tf.Workload.of(*wl)
    with pytest.raises(TypeError, match="FaultSchedule"):
        tf.simulate(g, w, prof, p, faults=np.zeros(g.num_queues, bool),
                    device="cpu")
    with pytest.raises(ValueError, match="queues"):
        tf.simulate(g, w, prof, p,
                    faults=FaultSchedule.healthy(g.num_queues + 1),
                    device="cpu")
    with pytest.raises(ValueError, match=r"\[Q\]"):
        tf.simulate(g, w, prof, p,
                    faults=FaultSchedule.healthy(g.num_queues, batch=2),
                    device="cpu")
    with pytest.raises(ValueError, match="batch axis"):
        tf.simulate_batch(g, [w] * 3, prof, p,
                          faults=FaultSchedule.healthy(g.num_queues, batch=2),
                          device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        FaultSchedule.healthy(g.num_queues).lossy(0, 1.5)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        FaultSchedule.healthy(g.num_queues).corrupt(0, -0.1)


def test_loss_threshold_endpoints():
    t = loss_threshold(torch.tensor([0.0, 0.5, 1.0])).numpy().view(
        np.uint32)
    assert t[0] == 0
    assert t[2] >= np.uint32(4294967040)
    assert 0 < t[1] < t[2]


@pytest.mark.parametrize("p", [0.0, 2.0 ** -24, 0.01, 0.5, 1.0 - 2.0 ** -24,
                               1.0, -0.25, 1.75])
def test_loss_threshold_matches_reference(p):
    """``clip(p, 0, 1) * f32(4294967040)`` in f32, cast to uint32: the
    port's int32 pattern is the reference's uint32, at the ends, just
    inside them, and clipped outside them."""
    got = loss_threshold(torch.tensor([p], dtype=torch.float32))
    want = np.asarray(jfl.loss_threshold(jnp.asarray([p], jnp.float32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_loss_threshold_matches_reference_on_random_lanes():
    p = np.random.default_rng(17).random((3, 257), dtype=np.float32)
    got = loss_threshold(torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jfl.loss_threshold(
                                      jnp.asarray(p))))


def test_profile_knob_validation():
    with pytest.raises(ValueError, match="rto_backoff"):
        replace(TransportProfile.ai_full(), rto_backoff=0.5)
    with pytest.raises(ValueError, match="rto_max_scale"):
        replace(TransportProfile.ai_full(), rto_max_scale=0)


# ------------------------------------------------------------------------
# the schedule builders (every lane) against the reference's
# ------------------------------------------------------------------------

def _same_schedule(got: FaultSchedule, want) -> None:
    for f in fields(jfl.FaultSchedule):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want,
                                                              f.name))
        if f.name == "seed":
            a = a.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for tick in (0, 99, 100, 399, 400, 10 ** 6):
        for view in ("dead_at", "host_dead_at", "nic_stalled_at"):
            np.testing.assert_array_equal(
                getattr(got, view)(tick).numpy(),
                np.asarray(getattr(want, view)(tick)), err_msg=view)
    assert (got.num_hosts, got.has_host_faults, got.has_corruption) == \
        (want.num_hosts, want.has_host_faults, want.has_corruption)


BUILDS = {
    "lossy": lambda FS: FS.healthy(16).lossy([3, 5], 0.05),
    "corrupt": lambda FS: FS.healthy(16, batch=2).corrupt(4, 0.25),
    "hosts": lambda FS: FS.healthy(16, num_hosts=8).host_fail([1, 6], 100)
    .nic_stall(2, 100, 400).host_fail(1, 99, 400),
    "with_hosts": lambda FS: FS.from_mask(np.eye(16, dtype=bool)[3], seed=9)
    .with_hosts(8).nic_stall(7, 0),
    "seed": lambda FS: FS.healthy(16, batch=3, seed=0xFFFFFFFF).with_seed(
        np.asarray([0, 7, 0xFFFFFFF0], np.uint32)),
    "stack_mixed": lambda FS: FS.stack([
        FS.healthy(16).lossy(2, 0.5), FS.healthy(16, num_hosts=8)
        .host_fail(3, 100).corrupt(9, 1.0).with_seed(3)]),
    "everything": lambda FS: FS.healthy(16, num_hosts=8).flap([0, 15], 5, 50)
    .lossy(0, 1.0).corrupt(15, 0.0).host_fail(0, 400).nic_stall(0, 99)
    .with_seed(12345),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_schedule_builders_match_reference(name):
    _same_schedule(BUILDS[name](FaultSchedule), BUILDS[name](jfl.FaultSchedule))


def test_zero_probability_lanes_build_no_fault_static():
    """A schedule whose gray / BER lanes are all zero and whose host
    lanes are all healthy selects none of the fault statics."""
    s = FaultSchedule.healthy(16, num_hosts=8).lossy(2, 0.0).corrupt(3, 0.0)
    assert not (s.has_loss or s.has_corruption or s.has_host_faults)
    assert FaultSchedule.healthy(16).lossy(2, 2.0 ** -30).has_loss


# ------------------------------------------------------------------------
# EV eviction and the steering of draws, against the reference policy
# ------------------------------------------------------------------------

def _lb_pair(f, k, seed, rng):
    """The same LB state in both packages, with a partly filled REPS
    ring, blacklist and eviction count."""
    js = jlb.LBState.create(f, k, np.uint32(seed))
    ring = rng.integers(-1, 8, (f, k)).astype(np.int32)
    ring = np.where(ring >= 0, np.asarray(js.ev_set)[:, :1] + ring, -1)
    bad = np.where(rng.random((f, k)) < 0.3,
                   np.asarray(js.ev_set), -1).astype(np.int32)
    js = replace(js, reps_ring=jnp.asarray(ring, jnp.int32),
                 reps_size=jnp.asarray(rng.integers(0, k + 1, f), jnp.int32),
                 reps_head=jnp.asarray(rng.integers(0, k, f), jnp.int32),
                 bad_ev=jnp.asarray(bad),
                 bad_n=jnp.asarray(rng.integers(0, 3 * k, f), jnp.int32))
    lanes = [np.array(getattr(js, fl.name)) for fl in fields(jlb.LBState)]
    ts = lb.LBState(*(torch.as_tensor(a.view(np.int32) if a.dtype ==
                                      np.uint32 else a) for a in lanes))
    return ts, js


def _same_lb(ts, js):
    for fl in fields(jlb.LBState):
        a = getattr(ts, fl.name).numpy()
        b = np.asarray(getattr(js, fl.name))
        np.testing.assert_array_equal(a.view(b.dtype) if b.dtype ==
                                      np.uint32 else a, b, err_msg=fl.name)


@pytest.mark.parametrize("scheme", list(LBScheme), ids=lambda s: s.name)
def test_evict_and_steered_select_match_reference(scheme):
    """``LBPolicy.evict`` (blacklist push, ``ev_set`` re-roll salted by
    ``bad_n`` with the uint32 wrap, REPS tombstones) and the steered
    ``select``, over several rounds of random evictions."""
    rng = np.random.default_rng(int(scheme) + 40)
    f, k = 37, 8
    ts, js = _lb_pair(f, k, 0xFFFFFFF0 - int(scheme), rng)
    pol = lb.LBPolicy(scheme, evict_enabled=True)
    jpol = jlb.LBPolicy(jlb.LBScheme(int(scheme)), evict_enabled=True)
    for rnd in range(4):
        psn = rng.integers(0, 2 ** 31, f).astype(np.int32)
        ts2, ev = pol.select(ts, torch.as_tensor(psn), 1000 + rnd)
        js2, jev = jpol.select(js, jnp.asarray(psn, jnp.uint32),
                               jnp.int32(1000 + rnd))
        np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
        _same_lb(ts2, js2)
        # evict the selected EV on some flows, a ring entry on others
        pick = np.where(rng.random(f) < 0.5, ev.numpy(),
                        np.asarray(js.reps_ring)[np.arange(f),
                                                 rng.integers(0, k, f)])
        valid = rng.random(f) < 0.6
        ts = pol.evict(ts2, torch.as_tensor(pick.astype(np.int32)),
                       torch.as_tensor(valid))
        js = jpol.evict(js2, jnp.asarray(pick, jnp.int32),
                        jnp.asarray(valid))
        _same_lb(ts, js)
    assert (ts.reps_ring == -1).any() and int(ts.bad_n.sum()) > 0


def test_evict_over_scenario_rows():
    """[B, F] lanes: each scenario's evictions touch its own rows, as B
    separate calls do."""
    rng = np.random.default_rng(5)
    pol = lb.LBPolicy(LBScheme.REPS, evict_enabled=True)
    pairs = [_lb_pair(9, 4, s, rng)[0] for s in (1, 2, 3)]
    st = tf.stack_lanes(pairs)
    ev = torch.stack([p.ev_set[:, 1] for p in pairs])
    valid = torch.as_tensor(rng.random((3, 9)) < 0.7)
    got = pol.evict(st, ev, valid)
    for b, one in enumerate(pairs):
        want = pol.evict(one, ev[b], valid[b])
        for fl in fields(lb.LBState):
            assert torch.equal(getattr(got, fl.name)[b],
                               getattr(want, fl.name)), (b, fl.name)


# ------------------------------------------------------------------------
# gray links + loss inference
# ------------------------------------------------------------------------

def test_lossy_link_survived():
    g2, wl, ups = small()
    p = dict(ticks=6000, timeout_ticks=64, ooo_threshold=24)
    r = run(g2, wl, TransportProfile.ai_full(), p,
            faults=lambda FS: FS.healthy(g2[0].num_queues).lossy(ups, 0.05))
    assert r.completion_tick() != -1
    assert r.drops > 0, "a 5% gray link must drop something"
    assert r.rtx_packets > 0
    assert r.ticks_degraded == 0
    np.testing.assert_array_equal(delivered(r), np.asarray(wl[2]).repeat(4))


def test_loss_draws_follow_seed():
    """Same schedule, different loss seeds => different drop streams
    (and the same seed reproduces exactly)."""
    g2, wl, ups = small()
    p = dict(ticks=6000, timeout_ticks=64, ooo_threshold=24)

    def gray(FS):
        return FS.healthy(g2[0].num_queues).lossy(ups, 0.08)
    r0 = run(g2, wl, TransportProfile.ai_full(), p, faults=gray)
    r0b = tf.simulate(g2[0], tf.Workload.of(*wl), TransportProfile.ai_full(),
                      tf.SimParams(**p), faults=gray(FaultSchedule),
                      device="cpu")
    r1 = run(g2, wl, TransportProfile.ai_full(), p,
             faults=lambda FS: gray(FS).with_seed(7))
    _same_state(r0.state, r0b.state)
    assert r0.drops != r1.drops \
        or r0.completion_tick() != r1.completion_tick()


def test_corrupted_uplinks_survived_without_link_layer():
    """PHY corruption with the link layer off: each corrupted
    transmission is a silent drop at its hop, recovered end to end."""
    g2, wl, ups = small()
    r = run(g2, wl, TransportProfile.ai_full(),
            dict(ticks=6000, timeout_ticks=64, ooo_threshold=24),
            faults=lambda FS: FS.healthy(g2[0].num_queues)
            .corrupt(ups, 0.05).with_seed(3))
    assert r.completion_tick() != -1
    assert r.drops > 0 and r.rtx_packets > 0 and r.ticks_degraded == 0
    np.testing.assert_array_equal(delivered(r), np.asarray(wl[2]).repeat(4))
