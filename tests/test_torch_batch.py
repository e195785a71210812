"""The port's batched scenario engine (``simulate_batch``) against the
reference's, on the CPU (plain kernel versions), bitwise:

* B = 4 scenarios with per-lane seeds and sizes (one lane quiesces a
  chunk before the others), under a [B, Q] failed mask and under a
  per-lane link-flap schedule, in both trace tiers: every lane's
  horizon, trace or stat lanes and final state;
* a budget that is not a multiple of ``chunk_ticks``, and a zero budget;
* per-scenario profiles, and per-scenario graphs;
* batch-of-1 against ``simulate`` and batch-of-8 against 8 serial runs
  (the reference's ``tests/test_fabric_batch.py``), per-lane failure
  masks, and the refusals;
* the scenario-axis pieces on their own: ``init_state`` with a [B] seed
  lane against the reference's vmapped init (seeds past 2**31 wrap as
  its uint32 arithmetic does), the [B, Q] fault schedule builders, the
  strided plain ``nack_mark_lanes_`` (no lane reaches a neighbour
  scenario's rows) and the own-bit forms over [B, F, W] rings.

Small sizes (``leaf_spine(2, 4, 8)``, ``chunk_ticks`` 32 or 64); the
reference side of each case is built once per module.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.lb import schemes as jlb
from repro.network import fabric as jf
from repro.network import faults as jfaults
from repro.network import topology as jt
from repro.network.profile import TransportProfile as JProfile
from repro_torch import convert
from repro_torch.core.lb import schemes as lb
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.kernels import ops, ref
from repro_torch.network import fabric as tf
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import leaf_spine
from test_torch_fabric import _assert_lanes, _assert_state_matches

RNG = np.random.default_rng(1515)
SIZES = (16, 100, 64, 100)            # lane 0 quiesces chunks before the rest
SEEDS = (0x5EED, 0xFFFFFFF0, 0x5EED + 2, 0x80000001)
PARAMS = dict(ticks=400, chunk_ticks=64, timeout_ticks=64, ooo_threshold=24)
STATS = ("trims", "drops", "dups", "timeouts", "rtx_packets",
         "ticks_degraded", "ev_evictions", "flows_abandoned",
         "ticks_unreachable")


def _graphs():
    return (leaf_spine(leaves=2, spines=4, hosts_per_leaf=8),
            jt.leaf_spine(leaves=2, spines=4, hosts_per_leaf=8))


def _workloads(sizes=SIZES):
    src, dst = list(range(8)), [8 + i for i in range(8)]
    return ([tf.Workload.of(src, dst, s) for s in sizes],
            [jf.Workload.of(src, dst, s) for s in sizes])


def _fault_specs(g, jg):
    """(port kwargs, reference kwargs) of the two fault forms."""
    ups = [int(g.up1_table[0, i]) for i in range(4)]
    mask = np.zeros((4, g.num_queues), bool)
    mask[1, ups[0]] = mask[2, ups[1]] = mask[3, [ups[0], ups[2]]] = True
    ok, jok = FaultSchedule.healthy(g.num_queues), \
        jfaults.FaultSchedule.healthy(jg.num_queues)
    port = FaultSchedule.stack([ok, ok.flap(ups[0], 40, 200),
                                ok.flap(ups[1], 0), ok.flap(ups, 100, 160)])
    jax_ = jfaults.FaultSchedule.stack([
        jok, jok.flap(ups[0], 40, 200), jok.flap(ups[1], 0),
        jok.flap(ups, 100, 160)])
    return {"mask": ({"failed": mask}, {"failed": mask}),
            "flap": ({"faults": port}, {"faults": jax_})}


def _run(kind, trace, max_ticks=None, sizes=SIZES,
         profile=TransportProfile.ai_full(lb=LBScheme.REPS),
         jprofile=JProfile.ai_full(lb=jlb.LBScheme.REPS)):
    g, jg = _graphs()
    wls, jwls = _workloads(sizes)
    pk, jk = _fault_specs(g, jg)[kind]
    seeds = np.asarray(SEEDS, np.uint32)
    port = tf.simulate_batch(g, wls, profile, tf.SimParams(**PARAMS),
                             seeds=seeds, trace=trace, max_ticks=max_ticks,
                             goodput_window=(50, 250) if trace == "stats"
                             else None, device="cpu", **pk)
    jax_ = jf.simulate_batch(jg, jf.Workload.stack(jwls), jprofile,
                             jf.SimParams(**PARAMS), seeds=seeds, trace=trace,
                             max_ticks=max_ticks,
                             goodput_window=(50, 250) if trace == "stats"
                             else None, **jk)
    return port, jax_


def assert_same_results(port, jax_):
    assert len(port) == len(jax_)
    for b, (r, j) in enumerate(zip(port, jax_)):
        assert (r.horizon, r.max_ticks, r.trace) == \
            (j.horizon, j.max_ticks, j.trace), b
        if r.trace == "full":
            _assert_lanes(r, j)
        else:
            for k in ("stat_completion", "stat_src_completion",
                      "stat_win_delivered"):
                np.testing.assert_array_equal(getattr(r, k),
                                              np.asarray(getattr(j, k)),
                                              err_msg=f"lane {b} {k}")
            assert r.qlen_peak == j.qlen_peak and \
                r.goodput_window == j.goodput_window, b
            assert r.abandon_tick == j.abandon_tick, b
        _assert_state_matches(r.state, j.state)
        for stat in STATS:
            assert getattr(r, stat) == getattr(j, stat), (b, stat)


@pytest.fixture(scope="module", params=["mask-stats", "mask-full",
                                        "flap-stats", "flap-full"])
def batch_pair(request):
    kind, trace = request.param.split("-")
    return _run(kind, trace)


def test_batch_matches_reference_simulate_batch(batch_pair):
    port, jax_ = batch_pair
    assert_same_results(port, jax_)
    horizons = [r.horizon for r in port]
    assert len(set(horizons)) > 1 and min(horizons) == horizons[0], \
        f"lane 0 must stop chunks before the others: {horizons}"
    assert any(r.drops for r in port) and not port[0].drops


@pytest.mark.parametrize("trace", ["stats", "full"])
@pytest.mark.parametrize("max_ticks", [200, 0])
def test_batch_budget_off_the_chunk_grid_and_zero(trace, max_ticks):
    port, jax_ = _run("flap", trace, max_ticks=max_ticks)
    assert_same_results(port, jax_)
    assert all(r.horizon <= max_ticks for r in port)
    if max_ticks == 0 and trace == "full":
        assert port[0].delivered_per_tick.shape == (0, 8)


def test_batch_per_scenario_profiles():
    g, jg = _graphs()
    """Groups of two RCCC (ai_base) and two hybrid (hpc) lanes, whose
    credit sums and ``seen`` marks scatter by scenario, and one ai_full
    lane; reassembled by index."""
    wls, jwls = _workloads((40, 40, 56, 56, 40))
    names = ("ai_base", "hpc", "ai_base", "hpc", "ai_full")
    profs = [getattr(TransportProfile, n)() for n in names]
    jprofs = [getattr(JProfile, n)() for n in names]
    p = dict(PARAMS, ticks=256)
    seeds = [3, 4, 5, 6, 7]
    port = tf.simulate_batch(g, wls, profs, tf.SimParams(**p), seeds=seeds,
                             trace="full", device="cpu")
    jax_ = jf.simulate_batch(jg, jf.Workload.stack(jwls), jprofs,
                             jf.SimParams(**p), seeds=seeds, trace="full")
    assert_same_results(port, jax_)
    # the ai_full lane (a group of one) is the serial run
    r = tf.simulate(g, wls[4], profs[4], tf.SimParams(**p), seed=7,
                    trace="full", device="cpu")
    _assert_lanes(port[4], r)


def test_batch_per_scenario_graphs():
    """Graphs of different queue counts group and reassemble by index;
    failed= is refused for them."""
    gs = [leaf_spine(2, 4, 8), leaf_spine(2, 2, 8), leaf_spine(2, 4, 8)]
    jgs = [jt.leaf_spine(2, 4, 8), jt.leaf_spine(2, 2, 8),
           jt.leaf_spine(2, 4, 8)]
    gs[2], jgs[2] = gs[0], jgs[0]
    wls, jwls = _workloads((30, 60, 90))
    p = dict(PARAMS, ticks=200)
    port = tf.simulate_batch(gs, wls, None, tf.SimParams(**p),
                             seeds=[1, 2, 3], device="cpu")
    jax_ = jf.simulate_batch(jgs, jf.Workload.stack(jwls), None,
                             jf.SimParams(**p), seeds=[1, 2, 3])
    assert_same_results(port, jax_)
    with pytest.raises(ValueError, match="num_queues"):
        tf.simulate_batch(gs, wls, None, tf.SimParams(**p),
                          failed=[0], device="cpu")


# ------------------------------------------------- port against itself --

def _config_a():
    g = leaf_spine(leaves=2, spines=4, hosts_per_leaf=4)
    return g, tf.Workload.of([0, 1, 2], [4, 5, 6], 200), \
        tf.SimParams(ticks=300)


def _same_state(a, b):
    for (k, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), k


def _leaves(obj, path="state"):
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")


@pytest.mark.parametrize("trace", ["stats", "full"])
def test_batch_of_one_equals_simulate(trace):
    g, wl, p = _config_a()
    r = tf.simulate(g, wl, TransportProfile.ai_full(), p, trace=trace,
                    device="cpu")
    rb = tf.simulate_batch(g, tf.Workload.stack([wl]),
                           TransportProfile.ai_full(), p, trace=trace,
                           device="cpu")[0]
    assert r.horizon == rb.horizon and r.max_ticks == 300
    np.testing.assert_array_equal(r.completion_ticks(),
                                  rb.completion_ticks())
    if trace == "full":
        _assert_lanes(r, rb)
    _same_state(r.state, rb.state)


def test_batch_of_eight_equals_eight_serial_runs():
    """8 mixed scenarios (sizes x seeds x failure masks) through one
    tick == 8 serial runs, bitwise."""
    g = leaf_spine(leaves=2, spines=4, hosts_per_leaf=8)
    prof = TransportProfile.ai_full(lb=LBScheme.REPS)
    p = tf.SimParams(ticks=192, chunk_ticks=32, timeout_ticks=64,
                     ooo_threshold=24)
    wls, masks, seeds, fqs = [], [], [], []
    for i in range(8):
        wls.append(tf.Workload.of(list(range(8)), [8 + j for j in range(8)],
                                  20 + 16 * i))
        m = np.zeros((g.num_queues,), bool)
        fq = ()
        if i % 2 == 1:
            q = int(g.up1_table[0, i % 4])
            m[q] = True
            fq = (q,)
        masks.append(m)
        fqs.append(fq)
        seeds.append(0x5EED + i)
    serial = [tf.simulate(g, wls[i], prof, p, failed=fqs[i] or None,
                          seed=seeds[i], trace="full", device="cpu")
              for i in range(8)]
    batch = tf.simulate_batch(g, tf.Workload.stack(wls), prof, p,
                              failed=np.stack(masks),
                              seeds=np.asarray(seeds, np.uint32),
                              trace="full", device="cpu")
    for i, (a, b) in enumerate(zip(serial, batch)):
        assert a.horizon == b.horizon, i
        _assert_lanes(b, a)
        _same_state(a.state, b.state)


def test_batch_failed_queue_masks_change_outcomes():
    """Failure masks are per-scenario: a dead uplink shows up as silent
    drops in that lane only."""
    g = leaf_spine(leaves=2, spines=2, hosts_per_leaf=2)
    wl = tf.Workload.of([0, 1], [2, 3], 300)
    p = tf.SimParams(ticks=250, timeout_ticks=64)
    masks = np.zeros((2, g.num_queues), bool)
    masks[1, int(g.up1_table[0, 0])] = True
    healthy, degraded = tf.simulate_batch(g, tf.Workload.stack([wl, wl]),
                                          TransportProfile.ai_full(), p,
                                          failed=masks, device="cpu")
    assert int(healthy.state.drops) == 0
    assert int(degraded.state.drops) > 0


@pytest.mark.parametrize("kw,err", [
    (dict(shard=True), NotImplementedError),
    (dict(devices=2), NotImplementedError),
    (dict(telemetry=object()), NotImplementedError),
    (dict(link=object()), TypeError),
    (dict(failed=np.zeros((3, 2), bool)), ValueError),
    (dict(failed=[0], faults=FaultSchedule.healthy(40)), ValueError)],
    ids=["shard", "devices", "telemetry", "link", "mask_shape", "both"])
def test_batch_refusals(kw, err):
    g, wl, p = _config_a()
    with pytest.raises(err):
        tf.simulate_batch(g, [wl, wl], None, p, device="cpu", **kw)


def test_simulate_refuses_batched_inputs():
    g, wl, p = _config_a()
    with pytest.raises(ValueError, match="simulate_batch"):
        tf.simulate(g, tf.Workload.stack([wl]), None, p, device="cpu")
    with pytest.raises(ValueError, match=r"\[Q\] fault schedule"):
        tf.simulate(g, wl, None, p, faults=FaultSchedule.healthy(
            g.num_queues, batch=2), device="cpu")


# --------------------------------------------- the scenario-axis pieces --

def test_init_state_seed_lane_matches_vmapped_reference():
    g, jg = _graphs()
    wls, jwls = _workloads()
    seeds = np.asarray(SEEDS, np.uint32)
    s = tf.init_state(g, tf.Workload.stack(wls),
                      TransportProfile.ai_full(), tf.SimParams(), seeds,
                      device="cpu")
    js = jax.vmap(lambda w, sd: jf.init_state(
        jg, w, JProfile.ai_full(), jf.SimParams(), sd))(
        jf.Workload.stack(jwls), seeds)
    for b in range(4):
        _assert_state_matches(tf.take_lane(s, b),
                              jax.tree_util.tree_map(lambda a: a[b], js))
    state = lb.LBState.create(8, 16, torch.as_tensor(seeds.view(np.int32)),
                              "cpu")
    for b, sd in enumerate(seeds):
        one = lb.LBState.create(8, 16, int(sd), "cpu")
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(state, f.name)[b],
                               getattr(one, f.name)), f.name


def test_fault_schedule_builders_match_reference():
    g, jg = _graphs()
    Q = g.num_queues
    q = int(g.up1_table[0, 1])
    pairs = [
        (FaultSchedule.healthy(Q, batch=3),
         jfaults.FaultSchedule.healthy(Q, batch=3)),
        (FaultSchedule.from_mask(np.eye(3, Q, dtype=bool)),
         jfaults.FaultSchedule.from_mask(np.eye(3, Q, dtype=bool))),
        (FaultSchedule.healthy(Q).flap([q, 2], 7, 19).flap(q, 3),
         jfaults.FaultSchedule.healthy(Q).flap([q, 2], 7, 19).flap(q, 3)),
        (FaultSchedule.stack([FaultSchedule.healthy(Q),
                              FaultSchedule.healthy(Q).flap(q, 5)]),
         jfaults.FaultSchedule.stack([jfaults.FaultSchedule.healthy(Q),
                                      jfaults.FaultSchedule.healthy(Q)
                                      .flap(q, 5)])),
    ]
    for got, want in pairs:
        d = convert.faults_to_numpy(got)
        for k in ("fail_at", "heal_at"):
            np.testing.assert_array_equal(d[k], np.asarray(getattr(want, k)))
        np.testing.assert_array_equal(got.dead_at(6).numpy(),
                                      np.asarray(want.dead_at(6)))
    # the gray-link and BER lanes and the seed (ROADMAP.md item 6)
    got = FaultSchedule.healthy(Q, batch=2, seed=7).lossy([q], 0.1) \
        .corrupt(2, 0.03).with_seed([1, 0xFFFFFFFF])
    want = jfaults.FaultSchedule.healthy(Q, batch=2, seed=7).lossy(
        [q], 0.1).corrupt(2, 0.03).with_seed(np.asarray([1, 0xFFFFFFFF],
                                                        np.uint32))
    d = convert.faults_to_numpy(got)
    for f in dataclasses.fields(jfaults.FaultSchedule):
        w = np.asarray(getattr(want, f.name))
        assert d[f.name].dtype == w.dtype, f.name
        np.testing.assert_array_equal(d[f.name], w, err_msg=f.name)


def _lane_case(B, F, W, L):
    """Random [B, F, W] rings and [B, L] NACK lanes, with edge lanes in
    every scenario: flows -1, F, F + 3 and the int32 extremes (marking
    would reach a neighbour scenario's rows if the range test were left
    out), offsets on and past the ring's ends."""
    rtx = RNG.integers(0, 2 ** 32, (B, F, W), dtype=np.uint64)
    rtx[:, ::3] = 0
    base = RNG.integers(0, 2 ** 32, (B, F), dtype=np.uint64)
    flow = RNG.integers(0, F, (B, L))
    off = RNG.integers(-8, 32 * W + 8, (B, L))
    nack = RNG.integers(0, 3, (B, L)) > 0
    edge_flow = [-1, F, F + 3, -(2 ** 31), 2 ** 31 - 1, 0, F - 1, 0]
    edge_off = [3, 3, 3, 3, 3, -1, 32 * W - 1, 32 * W]
    k = min(L, len(edge_flow))
    flow[:, :k], off[:, :k], nack[:, :k] = edge_flow[:k], edge_off[:k], True
    psn = (base[np.arange(B)[:, None], np.clip(flow, 0, F - 1)]
           .astype(np.int64) + off) % 2 ** 32
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.uint64).astype(np.uint32).view(np.int32))
    return (t(rtx), t(base), torch.as_tensor(flow.astype(np.int32)),
            t(psn), torch.as_tensor(nack),
            torch.as_tensor(RNG.integers(0, 2, F).astype(bool)))


@pytest.mark.parametrize("B,F,W", [(1, 1, 1), (3, 1, 16), (3, 33, 17),
                                   (8, 7, 32), (2, 2048, 16)])
@pytest.mark.parametrize("with_rod", [False, True])
def test_strided_nack_lanes_equal_one_scenario_at_a_time(B, F, W, with_rod):
    L = 12 + 2 * F
    rtx, base, flow, psn, nack, rod = _lane_case(B, F, W, L)
    rod = rod if with_rod else None
    got = ops.nack_mark_lanes_(rtx.clone(), base, flow, psn, nack, rod)
    for b in range(B):
        want = ref.nack_mark_lanes_ref_(rtx[b].clone(), base[b], flow[b],
                                        psn[b], nack[b], rod)
        assert torch.equal(got[b], want), b


def test_strided_nack_lanes_out_of_range_flows_touch_no_row():
    """Lanes whose flow is -1, F, F + 3 or an int32 extreme mark nothing
    in any scenario, and a lane of scenario b marks only scenario b."""
    B, F, W = 3, 4, 2
    rtx = torch.zeros((B, F, W), dtype=torch.int32)
    base = torch.zeros((B, F), dtype=torch.int32)
    flow = torch.tensor([[-1, F, F + 3, -(2 ** 31), 2 ** 31 - 1]] * B,
                        dtype=torch.int32)
    psn = torch.full((B, 5), 3, dtype=torch.int32)
    nack = torch.ones((B, 5), dtype=torch.bool)
    assert not ops.nack_mark_lanes_(rtx, base, flow, psn, nack).any()
    flow[1, 0] = F - 1      # one in-range lane, in scenario 1's last row
    ops.nack_mark_lanes_(rtx, base, flow, psn, nack)
    assert rtx.nonzero().tolist() == [[1, F - 1, 0]]
    assert int(rtx[1, F - 1, 0]) == 1 << 3


def test_own_bit_forms_over_a_scenario_axis():
    """The [B, F, W] forms are the [B*F, W] forms, row for row."""
    B, F, W = 3, 33, 17
    g = lambda *s: torch.as_tensor(  # noqa: E731
        RNG.integers(0, 2 ** 32, s, dtype=np.uint64).astype(np.uint32)
        .view(np.int32))
    ring, rtx, base = g(B, F, W), g(B, F, W), g(B, F)
    off = torch.as_tensor(RNG.integers(-4, 32 * W + 4, (B, F)).astype(
        np.int32))
    ok = torch.as_tensor(RNG.integers(0, 2, (B, F)).astype(bool))
    clear = ok | torch.as_tensor(RNG.integers(0, 2, (B, F)).astype(bool))
    flat = lambda *ts: [t.reshape(B * F, *t.shape[2:]) for t in ts]  # noqa
    for got, want in zip(
            ops.sack_fused_own(ring, base, rtx, off, ok, clear),
            ref.sack_fused_own_ref(*flat(ring, base, rtx, off, ok, clear))):
        assert torch.equal(got.reshape(want.shape), want)
    for got, want in zip(ops.sack_advance_own(ring, base, off, ok),
                         ref.sack_advance_own_ref(*flat(ring, base, off, ok))):
        assert torch.equal(got.reshape(want.shape), want)
    a = ops.set_own_bit_(rtx.clone(), off, ok, unless=ring)
    b = ref.set_own_bit_ref_(*flat(rtx.clone(), off, ok), ring.reshape(-1, W))
    assert torch.equal(a.reshape(b.shape), b)
    a = ops.clear_own_bit_(rtx.clone(), off, ok)
    b = ref.clear_own_bit_ref_(*flat(rtx.clone(), off, ok))
    assert torch.equal(a.reshape(b.shape), b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.clear_own_bit_(rtx.transpose(0, 1), off.T, ok.T)


def test_policy_scatters_keep_to_their_scenario():
    """RCCC's grant sum, ``mark_seen`` and ``spend`` and EVBITMAP's
    feedback over [B, F] state equal one call per scenario; lanes with
    out-of-range flows reach no scenario's rows."""
    from repro_torch.core.cms import rccc
    B, F, H, L = 3, 6, 4, 9
    st = rccc.RCCCState.create((B, F), 8.0, "cpu")
    st = rccc.RCCCState(balance=st.balance,
                        seen=torch.as_tensor(RNG.integers(0, 2, (B, F))
                                             .astype(bool)))
    dst = torch.as_tensor(RNG.integers(0, H, (B, F)).astype(np.int32))
    active = torch.as_tensor(RNG.integers(0, 2, (B, F)).astype(bool))
    flow = torch.as_tensor(RNG.integers(-F - 2, F + 2, (B, L))
                           .astype(np.int32))
    flow[:, 0], flow[:, 1] = -(2 ** 31), F
    valid = torch.as_tensor(RNG.integers(0, 4, (B, L)) > 0)
    ev = torch.as_tensor(RNG.integers(0, 2 ** 16, (B, L)).astype(np.int32))
    cong = torch.as_tensor(RNG.integers(0, 2, (B, L)).astype(bool))
    lbs = lb.LBState.create(F, 4, torch.as_tensor(
        np.asarray(SEEDS[:B], np.uint32).view(np.int32)), "cpu")
    ev[:, 2] = lbs.ev_set[:, 0, 1]          # a lane whose EV is a slot's
    flow[:, 2], valid[:, 2], cong[:, 2] = 0, True, True
    batched = (rccc.grant_credits(st, dst, active, H),
               rccc.mark_seen(st, flow, valid), rccc.spend(st, flow, valid),
               lb.on_ack(lbs, LBScheme.EVBITMAP, flow, ev, cong, valid))
    assert batched[3].cong_bits.any()
    for b in range(B):
        one = tf.take_lane(st, b)
        lb1 = tf.take_lane(lbs, b)
        want = (rccc.grant_credits(one, dst[b], active[b], H),
                rccc.mark_seen(one, flow[b], valid[b]),
                rccc.spend(one, flow[b], valid[b]),
                lb.on_ack(lb1, LBScheme.EVBITMAP, flow[b], ev[b], cong[b],
                          valid[b]))
        for got, w in zip(batched, want):
            _same_state(tf.take_lane(got, b), w)


def test_step_launches_each_form_once_per_tick_whatever_b(monkeypatch):
    """At B = 3 the tick calls each tick kernel entry once per site and
    tick, as at B = 1 (the CPU's view of ``ops.LAUNCHES``)."""
    forms = ("sack_fused_own", "sack_advance_own", "nack_mark_lanes_",
             "set_own_bit_", "clear_own_bit_")
    calls = dict.fromkeys(forms, 0)
    for form in forms:
        def counted(*a, _fn=getattr(ops, form), _form=form, **kw):
            calls[_form] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, form, counted)
    g, _ = _graphs()
    wls, _ = _workloads(SIZES[:3])
    r = tf.simulate_batch(g, wls, None, tf.SimParams(ticks=128,
                                                     chunk_ticks=32),
                          seeds=[1, 2, 3], device="cpu")
    ticks = max(x.horizon for x in r)
    assert calls == dict.fromkeys(forms, ticks)
