"""Dependency-scheduled collectives and in-network reduction on the port,
against the reference package on the CPU, bitwise — the twins of
``tests/test_collectives.py`` (its netmodel tests wait for ROADMAP.md
item 11), of the dependency and INC cases of
``tests/test_fabric_batch.py`` and of the INC cases of
``tests/test_adaptive_horizon.py``.

* The schedule builders (``flow_table`` and the numpy helpers) against
  the reference's over every kind, algorithm and a spread of sizes, and
  the same validation errors.
* Each simulator test runs the same collective through
  ``repro.network`` and ``repro_torch.network`` at the reference test's
  own size, holds the two results bitwise (horizon, stats or trace
  lanes, every state lane — the INC slots included — and the counters),
  then repeats the reference test's assertions on the port's result.
* ``collective_sweep`` at n = 4 (the kind x algorithm x INC x profile
  grid, padded to one batch) against the reference's.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.network import collectives as jc
from repro.network import fabric as jf
from repro.network import workloads as jw
from repro_torch.core.link import state_bitwise_equal
from repro_torch.network import collectives as coll
from repro_torch.network import fabric as tf
from repro_torch.network import workloads as tw
from repro_torch.network.profile import TransportProfile
from test_torch_batch import _same_state, assert_same_results
from test_torch_faults import graphs, jprofile

torch.set_num_threads(1)

AI = TransportProfile.ai_full()
AI_INC = replace(AI, inc=True, name="ai_full+inc")


def _specs(kind="all_reduce", n=8, s=32):
    hosts = tuple(range(n))
    return coll.CollectiveSpec(kind, hosts, s), jc.CollectiveSpec(kind,
                                                                 hosts, s)


def _wls(kind, algo, n, s, **kw):
    spec, jspec = _specs(kind, n, s)
    return (coll.build_workload(spec, algo, **kw),
            jc.build_workload(jspec, algo, **kw))


def _host_rx(wl, result, n):
    rx = np.zeros((n,), np.int64)
    np.add.at(rx, wl.dst.numpy(), result.state.delivered.numpy()
              .astype(np.int64))
    return rx


def run(g2, wls, prof, params, *, trace="stats", batch=False, **kw):
    """One collective (or a [B] batch) through both packages; held
    bitwise; returns the port's result(s)."""
    (g, jg), (wl, jwl) = g2, wls
    entry = "simulate_batch" if batch else "simulate"
    r = getattr(tf, entry)(g, wl, prof, tf.SimParams(**params), trace=trace,
                           device="cpu", **kw)
    j = getattr(jf, entry)(jg, jwl, [jprofile(q) for q in prof]
                           if isinstance(prof, list) else jprofile(prof),
                           jf.SimParams(**params), trace=trace, **kw)
    assert_same_results(r if batch else [r], j if batch else [j])
    for a, b in zip(r if batch else [r], j if batch else [j]):
        assert int(a.state.inc_reduced) == int(b.state.inc_reduced)
        assert int(a.state.inc_emits) == int(b.state.inc_emits)
    return r


# ------------------------------------------------------------------ builders

@pytest.mark.parametrize("kind,algo", [
    ("all_reduce", "ring"), ("all_reduce", "recursive_doubling"),
    ("all_reduce", "tree"), ("reduce_scatter", "ring"),
    ("reduce_scatter", "recursive_doubling"), ("all_gather", "ring"),
    ("all_gather", "recursive_doubling"), ("all_to_all", "ring")])
@pytest.mark.parametrize("n,s", [(2, 1), (4, 16), (8, 32), (16, 7)])
def test_flow_tables_match_reference(kind, algo, n, s):
    spec, jspec = _specs(kind, n, s)
    t, jt_ = coll.flow_table(spec, algo), jc.flow_table(jspec, algo)
    for lane in ("src", "dst", "size", "dep", "red", "phase"):
        a, b = getattr(t, lane), getattr(jt_, lane)
        assert a.dtype == b.dtype, lane
        np.testing.assert_array_equal(a, b, err_msg=lane)
    assert t.meta == jt_.meta
    np.testing.assert_array_equal(coll.expected_host_rx(spec, algo),
                                  jc.expected_host_rx(jspec, algo))
    assert coll.analytic_ticks(spec, algo) == jc.analytic_ticks(jspec, algo)
    wl, jwl = (coll.build_workload(spec, algo),
               jc.build_workload(jspec, algo, inc_groups=False))
    np.testing.assert_array_equal(wl.red.numpy(), t.red)
    for lane in ("src", "dst", "size", "start", "dep"):
        np.testing.assert_array_equal(getattr(wl, lane).numpy(),
                                      np.asarray(getattr(jwl, lane)))
    assert (coll.build_workload(spec, algo, inc_groups=False).red == -1).all()


def test_table_shapes_and_validation():
    """The reference's table and validation tests on the port's copy."""
    t = coll.flow_table(_specs()[0], "ring")
    has = t.dep >= 0
    assert len(t.src) == 2 * 7 * 8 and t.meta["chunk"] == 4
    assert (t.dep[has] < np.arange(len(t.src))[has]).all()
    assert (t.dst[t.dep[has]] == t.src[has]).all()
    t = coll.flow_table(_specs()[0], "tree")
    assert (t.red[:7] == 0).all() and (t.red[7:] == -1).all()
    t = coll.flow_table(_specs("all_to_all")[0], "ring")
    has = t.dep >= 0
    assert (t.src[t.dep[has]] == t.src[has]).all()
    with pytest.raises(ValueError, match="power-of-two"):
        coll.flow_table(_specs(n=6)[0], "recursive_doubling")
    with pytest.raises(ValueError, match="all_reduce only"):
        coll.flow_table(_specs("all_gather")[0], "tree")
    with pytest.raises(ValueError, match="unknown collective"):
        coll.CollectiveSpec("nope", (0, 1), 4)
    with pytest.raises(ValueError, match="distinct"):
        coll.CollectiveSpec("all_reduce", (0, 0), 4)
    with pytest.raises(ValueError, match="unknown algorithm"):
        coll.flow_table(_specs()[0], "butterfly")
    ring = coll.expected_host_rx(_specs("all_gather", 8, 64)[0], "ring")
    np.testing.assert_array_equal(
        ring, coll.expected_host_rx(_specs("all_gather", 8, 64)[0],
                                    "recursive_doubling"))
    assert int(ring[0]) == 7 * 64


@pytest.mark.parametrize("b", [4096.5, 0.5, 3 * 4096, 10_000, 10.0])
def test_from_bytes_matches_reference(b):
    a = coll.CollectiveSpec.from_bytes("all-reduce", range(4), b, mtu=4096)
    j = jc.CollectiveSpec.from_bytes("all-reduce", range(4), b, mtu=4096)
    assert (a.kind, a.hosts, a.size_pkts) == (j.kind, j.hosts, j.size_pkts)
    assert a.size_pkts >= 1


# ------------------------------------------------------ on the simulator

def test_dep_lane_gates_eligibility():
    g2 = graphs(2, 2, 2)
    pair = (tf.Workload.of([0, 1], [2, 3], [60, 60], dep=[-1, 0]),
            jf.Workload.of([0, 1], [2, 3], [60, 60], dep=[-1, 0]))
    r = run(g2, pair, AI, dict(ticks=500), trace="full")
    done0 = int(r.source_completion_ticks()[0])
    first1 = int(np.argmax(r.delivered_per_tick[:, 1] > 0))
    assert done0 > 0 and (r.delivered_per_tick[:, 1] > 0).any()
    assert first1 > done0
    free = (tf.Workload.of([0, 1], [2, 3], [60, 60]),
            jf.Workload.of([0, 1], [2, 3], [60, 60]))
    r2 = run(g2, free, AI, dict(ticks=500), trace="full")
    assert int(np.argmax(r2.delivered_per_tick[:, 1] > 0)) < first1


def test_ring_allreduce_exact_delivery_and_bound():
    spec = _specs(n=8, s=32)[0]
    pair = _wls("all_reduce", "ring", 8, 32)
    r = run(graphs(2, 4, 4), pair, AI, dict(ticks=1200))
    assert coll.collective_completion_ticks(r) >= coll.analytic_ticks(
        spec, "ring")
    np.testing.assert_array_equal(_host_rx(pair[0], r, 8),
                                  coll.expected_host_rx(spec, "ring"))


def test_inc_tree_allreduce_correctness():
    """INC off: exact per-host totals. INC on: every flow completes at
    its source, the root's downlink carries fewer packets (delivered +
    absorbed == expected) and the collective finishes sooner."""
    n, s = 8, 32
    spec = _specs(n=n, s=s)[0]
    pair = _wls("all_reduce", "tree", n, s)
    p = dict(ticks=1500)
    r_off = run(graphs(2, 4, 4), pair, AI, p)
    r_on = run(graphs(2, 4, 4), pair, AI_INC, p)
    expected = coll.expected_host_rx(spec, "tree")
    np.testing.assert_array_equal(_host_rx(pair[0], r_off, n), expected)
    assert int(r_off.state.inc_reduced) == 0
    assert r_off.state.inc.slot_psn.shape == (0, 1)
    reduced = int(r_on.state.inc_reduced)
    rx_on = _host_rx(pair[0], r_on, n)
    assert coll.collective_completion_ticks(r_on) > 0 and reduced > 0
    assert rx_on[0] < expected[0] and rx_on[0] + reduced == expected[0]
    np.testing.assert_array_equal(rx_on[1:], expected[1:])
    assert (coll.collective_completion_ticks(r_on)
            < coll.collective_completion_ticks(r_off))
    assert int(r_on.state.inc_emits) > 0


def test_inc_is_noop_without_reduction_groups():
    """An INC profile on a group-free schedule (ring) gives the lanes of
    INC off."""
    pair = _wls("all_reduce", "ring", 4, 16)
    p = dict(ticks=400)
    r_off = run(graphs(2, 2, 2), pair, AI, p, trace="full")
    r_on = run(graphs(2, 2, 2), pair, AI_INC, p, trace="full")
    np.testing.assert_array_equal(r_off.delivered_per_tick,
                                  r_on.delivered_per_tick)
    np.testing.assert_array_equal(r_off.cwnd_per_tick.view(np.int32),
                                  r_on.cwnd_per_tick.view(np.int32))
    assert int(r_on.state.inc_reduced) == 0


def test_inc_profile_with_red_disabled_is_bitwise_inc_off():
    """The twin of ``tests/test_adaptive_horizon.py:252``: an INC profile
    over ``red = -1`` lanes is the ``inc=False`` tick, bitwise, on every
    lane and every state field but the (empty vs live) INC slots."""
    spec = _specs(n=8, s=24)[0]
    wl_on = coll.build_workload(spec, "tree")
    wl_off = coll.build_workload(spec, "tree", inc_groups=False)
    g = graphs(2, 2, 4)[0]
    p = tf.SimParams(ticks=700)
    a = tf.simulate(g, wl_on, AI, p, trace="full", device="cpu")
    b = tf.simulate(g, wl_off, AI_INC, p, trace="full", device="cpu")
    for lane in ("delivered_per_tick", "src_base_per_tick"):
        np.testing.assert_array_equal(getattr(a, lane), getattr(b, lane))
    np.testing.assert_array_equal(a.cwnd_per_tick.view(np.int32),
                                  b.cwnd_per_tick.view(np.int32))
    assert int(b.state.inc_reduced) == 0 and int(b.state.inc_emits) == 0
    assert b.state.inc.slot_psn.shape == (2 * (8 - 1), 64)
    assert a.state.inc.slot_psn.shape == (0, 1)
    assert state_bitwise_equal(a.state, b.state, skip={"inc"}) is None


def test_stats_equals_full_derived_inc_collective_batch():
    """The twin of ``tests/test_adaptive_horizon.py:123``: a batched
    INC tree reduce (INC on and off lanes), the stats tier against the
    dense tier of the same port run, both held against the reference."""
    pair_on = _wls("all_reduce", "tree", 8, 24)
    pair_off = _wls("all_reduce", "tree", 8, 24, inc_groups=False)
    pair = (tf.Workload.stack([pair_on[0], pair_off[0]]),
            jf.Workload.stack([pair_on[1], pair_off[1]]))
    g2 = graphs(2, 2, 4)
    p = dict(ticks=800)
    full = run(g2, pair, AI_INC, p, trace="full", batch=True)
    stats = run(g2, pair, AI_INC, p, trace="stats", batch=True,
                goodput_window=(0, 800))
    for rs, rf in zip(stats, full):
        assert rs.horizon == rf.horizon
        np.testing.assert_array_equal(rs.completion_ticks(),
                                      rf.completion_ticks())
        np.testing.assert_array_equal(rs.source_completion_ticks(),
                                      rf.source_completion_ticks())
        np.testing.assert_array_equal(rs.goodput((0, 800)),
                                      rf.goodput((0, 800)))
        _same_state(rs.state, rf.state)
    assert int(stats[0].state.inc_reduced) > 0
    assert int(stats[1].state.inc_reduced) == 0


def test_dep_gated_batch_vs_serial_bitwise():
    """Dependency-scheduled ring all-reduces of three sizes and seeds:
    the batch against the reference's, each lane against the port's
    serial run (lanes stop at their own chunk)."""
    g2 = graphs(2, 2, 2)
    p = dict(ticks=350)
    seeds = [0x5EED + i for i in range(3)]
    pairs = [_wls("all_reduce", "ring", 4, s) for s in (12, 16, 20)]
    batch = run(g2, (tf.Workload.stack([w for w, _ in pairs]),
                     jf.Workload.stack([j for _, j in pairs])), AI, p,
                trace="full", batch=True,
                seeds=np.asarray(seeds, np.uint32))
    for i, r in enumerate(batch):
        solo = tf.simulate(g2[0], pairs[i][0], AI, tf.SimParams(**p),
                           seed=seeds[i], trace="full", device="cpu")
        assert solo.horizon == r.horizon, i
        np.testing.assert_array_equal(solo.delivered_per_tick,
                                      r.delivered_per_tick)
        _same_state(solo.state, r.state)


def test_inc_batch_vs_serial_bitwise():
    """The INC tick batch / serial: the accumulator slots ride the [B]
    axis."""
    g2 = graphs(2, 2, 4)
    pair = _wls("all_reduce", "tree", 8, 24)
    p = dict(ticks=600)
    a = run(g2, pair, AI_INC, p, trace="full")
    b = run(g2, (tf.Workload.stack([pair[0]] * 2),
                 jf.Workload.stack([pair[1]] * 2)), AI_INC, p,
            trace="full", batch=True)[1]
    assert int(a.state.inc_reduced) > 0
    np.testing.assert_array_equal(a.delivered_per_tick, b.delivered_per_tick)
    np.testing.assert_array_equal(a.src_base_per_tick, b.src_base_per_tick)
    _same_state(a.state, b.state)


def test_stack_padded_heterogeneous_grid():
    """Ring, recursive doubling and tree pad into one batch; every
    scenario completes and the inert pad flows deliver nothing."""
    pairs = [_wls("all_reduce", a, 4, 16)
             for a in ("ring", "recursive_doubling", "tree")]
    fs = [int(w.src.shape[0]) for w, _ in pairs]
    batch = coll.stack_padded([w for w, _ in pairs])
    jbatch = jc.stack_padded([j for _, j in pairs])
    assert batch.src.shape == (3, max(fs))
    for lane in ("src", "dst", "size", "start", "dep", "red"):
        np.testing.assert_array_equal(getattr(batch, lane).numpy(),
                                      np.asarray(getattr(jbatch, lane)))
    rs = run(graphs(2, 2, 2), (batch, jbatch), AI, dict(ticks=700),
             batch=True)
    for f, r in zip(fs, rs):
        assert coll.collective_completion_ticks(r) > 0
        assert (r.state.delivered.numpy()[f:] == 0).all()


def test_collective_sweep_one_batch_call():
    """The grid (kind x algorithm x INC x profile) at n = 4 as one batch
    against the reference's; the INC tree all-reduce beats the INC-off
    one."""
    g, wls, profs, names = tw.collective_sweep(n=4, size=16)
    jg, jwls, jprofs, jnames = jw.collective_sweep(n=4, size=16)
    assert names == jnames and len(names) == 15
    assert [q.describe() for q in profs] == [q.describe() for q in jprofs]
    for lane in ("src", "dst", "size", "start", "dep", "red"):
        np.testing.assert_array_equal(getattr(wls, lane).numpy(),
                                      np.asarray(getattr(jwls, lane)))
    rs = run((g, jg), (wls, jwls), profs, dict(ticks=700), batch=True)
    cts = {nm: coll.collective_completion_ticks(r)
           for nm, r in zip(names, rs)}
    assert all(ct > 0 for ct in cts.values()), cts
    assert (cts["ai_full/all_reduce/tree/inc"]
            < cts["ai_full/all_reduce/tree"])
    assert rs[names.index("ai_base/all_reduce/tree/inc")].state \
        .inc_reduced > 0
