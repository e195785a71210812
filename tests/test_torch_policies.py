"""Bitwise parity of the port's transport policies with the reference:
the NSCC hooks and Quick Adapt (the f32 ``cwnd`` lane included), LB
selection and feedback for STATIC, OBLIVIOUS and REPS, the named
profiles, EV eviction and the recovery statics building beside each CC
composition, and the lane-wise REPS feedback (``schemes.on_ack``) bitwise
with repeated flows, full rings, invalid and out-of-range lanes, at B = 1
and batched. RCCC, the hybrid, the open
loop, RR_SLOTS and EVBITMAP are held in ``test_torch_profile_policies.py``.
"""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cms import nscc as jnscc
from repro.core.lb import schemes as jlb
from repro.network import profile as jprof
from repro_torch.core.cms import nscc
from repro_torch.core.lb import schemes as lb
from repro_torch.kernels import ops
from repro_torch.network import profile

RNG = np.random.default_rng(4242)
F = 1024


def _t(a):
    a = np.array(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _same(got, want, name=""):
    g = np.ascontiguousarray(got.numpy())
    want = np.ascontiguousarray(want)
    if want.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.dtype == want.dtype, (name, g.dtype, want.dtype)
    # bitwise, floats included (compare the bit patterns)
    np.testing.assert_array_equal(g.view(np.uint8), want.view(np.uint8),
                                  err_msg=name)


def _same_dc(got, want):
    for f in fields(got):
        _same(getattr(got, f.name), getattr(want, f.name), f.name)


def _nscc_lanes():
    cwnd = RNG.uniform(0.5, 50.0, F).astype(np.float32)
    cwnd[:4] = [1.0, 48.0, 0.25, 6.0]
    rtt = np.round(RNG.uniform(0.0, 80.0, F), 1).astype(np.float32)
    rtt[F // 2:] = RNG.uniform(0.0, 80.0, F - F // 2)
    rtt[:6] = [0.0, 12.5, 10.0, 1e-7, 12.500001, 256.0]
    ecn = RNG.integers(0, 2, F).astype(bool)
    active = RNG.integers(0, 2, F).astype(bool)
    acked = RNG.integers(0, 30, F).astype(np.int32)
    lost = np.where(RNG.random(F) < 0.5, 0, RNG.integers(0, 9, F)).astype(
        np.int32)
    etick = RNG.integers(0, 60, F).astype(np.int32)
    return cwnd, rtt, ecn, active, acked, lost, etick


PARAMS = [(dict(base_rtt=10.0, max_cwnd=48.0)), dict(),
          dict(base_rtt=20.0, md=0.3, quick_gain=1.5, ai=0.7,
               max_cwnd=128.0)]


@pytest.mark.parametrize("kw", PARAMS)
def test_nscc_hooks_bitwise(kw):
    """The module function against JAX's eager call (exact division) and,
    folded, against JAX's jitted one; the policy hooks — what the tick
    calls — against the reference's hooks under jax.jit, as its engine
    runs them (XLA folds the gap's division by the constant target into
    a reciprocal multiply), and so the kernel entry points the hooks
    call, ``ops.nscc_ack`` and ``ops.nscc_epoch``, on [B, F] lanes (the
    epoch's edges: ``now - epoch_tick`` at ``epoch_len - 1`` and at
    ``epoch_len`` on the lanes whose epoch began at tick 59)."""
    cwnd, rtt, ecn, active, acked, lost, etick = _nscc_lanes()
    jp, tp = jnscc.NSCCParams(**kw), nscc.NSCCParams(**kw)
    jwd = (jnp.asarray(cwnd), jnp.asarray(ecn), jnp.asarray(rtt))
    _same(nscc.window_delta(_t(cwnd), _t(ecn), _t(rtt), tp),
          jnscc.window_delta(*jwd, jp), "window_delta")
    _same(nscc.window_delta(_t(cwnd), _t(ecn), _t(rtt), tp,
                            folded_reciprocal=True),
          jax.jit(lambda c, e, r: jnscc.window_delta(c, e, r, jp))(*jwd),
          "window_delta under jit")
    js = jnscc.NSCCState(jnp.asarray(cwnd), jnp.asarray(acked),
                         jnp.asarray(lost), jnp.asarray(etick))
    ts = nscc.NSCCState(_t(cwnd), _t(acked), _t(lost), _t(etick))
    jpol, tpol = jnscc.NSCCPolicy(jp), nscc.NSCCPolicy(tp)
    j1 = jax.jit(jpol.on_ack)(js, jnp.asarray(active), jnp.asarray(ecn),
                              jnp.asarray(rtt))
    t1 = tpol.on_ack(ts, _t(active), _t(ecn), _t(rtt))
    _same_dc(t1, j1)
    # the kernel entry point the hook calls, on the tick's [B, F] lanes
    lanes = [_t(a).view(4, -1) for a in (cwnd, acked, active, ecn, rtt)]
    for name, got, want in zip(("cwnd", "epoch_acked"),
                               ops.nscc_ack(*lanes, tp),
                               (j1.cwnd, j1.epoch_acked)):
        assert got.shape == (4, F // 4)
        _same(got.reshape(-1), want, f"ops.nscc_ack {name}")
    count = RNG.integers(0, 4, F).astype(np.int32)
    j2, t2 = jpol.on_nack(j1, jnp.asarray(count)), tpol.on_nack(t1, _t(count))
    _same_dc(t2, j2)
    stalled = RNG.integers(0, 2, F).astype(bool)
    j3 = jpol.on_timeout(j2, jnp.asarray(stalled))
    t3 = tpol.on_timeout(t2, _t(stalled))
    _same_dc(t3, j3)
    epoch_len = int(tp.base_rtt * tp.target_factor)
    for now in (0, 11, 12, 57, 59 + epoch_len - 1, 59 + epoch_len):
        want = jpol.end_of_tick(j3, jnp.int32(now))
        _same_dc(tpol.end_of_tick(t3, now), want)
        lanes = [getattr(t3, f.name).view(4, -1) for f in fields(t3)]
        got = nscc.NSCCState(*(t.reshape(-1) for t in ops.nscc_epoch(
            *lanes, now, tp)))
        _same_dc(got, want)
    inflight = RNG.integers(0, 60, F).astype(np.int32)
    _same(tpol.on_send_gate(t3, _t(inflight)),
          jpol.on_send_gate(j3, jnp.asarray(inflight)))
    _same(tpol.cwnd_view(t3, F), jpol.cwnd_view(j3, F))


# --------------------------------------------------------------- LB ------

SEEDS = [0x5EED, 0x5EED + 3, 0, 0xFFFFFFFF, 0x9E3779B1]


@pytest.mark.parametrize("seed", SEEDS)
def test_lb_state_create(seed):
    _same_dc(lb.LBState.create(F, 16, seed, "cpu"),
             jlb.LBState.create(F, 16, np.uint32(seed)))


def _random_lb(seed):
    """Matching LB states with a partly filled REPS recycle ring."""
    js = jlb.LBState.create(F, 16, np.uint32(seed))
    ring = RNG.integers(-1, 2 ** 16, (F, 16)).astype(np.int32)
    head = RNG.integers(0, 40, F).astype(np.int32)
    size = RNG.integers(0, 17, F).astype(np.int32)
    js = replace(js, reps_ring=jnp.asarray(ring), reps_head=jnp.asarray(head),
                 reps_size=jnp.asarray(size))
    ts = lb.LBState(*(_t(np.asarray(getattr(js, f.name)))
                      for f in fields(js)))
    return js, ts


@pytest.mark.parametrize("scheme", ["STATIC", "OBLIVIOUS", "REPS"])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_lb_select_and_feedback(scheme, seed):
    js, ts = _random_lb(seed)
    jpol = jlb.LBPolicy(jlb.LBScheme[scheme])
    tpol = lb.LBPolicy(lb.LBScheme[scheme])
    psn = RNG.integers(0, 2 ** 32, F, dtype=np.uint64).astype(np.uint32)
    for tick in (0, 7, 2 ** 23 + 5, 2 ** 31 - 1):
        jn, jev = jpol.select(js, jnp.asarray(psn), jnp.int32(tick))
        tn, tev = tpol.select(ts, _t(psn).clone(), tick)
        _same(tev, jev, "ev")
        _same_dc(tn, jn)
    # ACK feedback over E lanes, <= 1 ACK lane per flow
    E = 3 * F
    ef = RNG.permutation(E).astype(np.int32) % (F + 17) - 3
    et = RNG.integers(0, 4, E).astype(np.int32)
    ee = RNG.integers(0, 2 ** 16, E).astype(np.int32)
    ec = RNG.integers(0, 2, E).astype(np.int32)
    is_ack, is_nack = et == 1, (et == 2) | (et == 3)
    flows = np.arange(F)
    hot = (ef[None, :] == flows[:, None]) & is_ack[None, :]
    hot &= np.cumsum(hot, axis=1) == 1          # the first ACK lane only
    _same_dc(tpol.on_ack(ts, _t(hot), _t(ef), _t(ee), _t(ec), _t(is_ack),
                         _t(is_nack)),
             jpol.on_ack(js, jnp.asarray(hot), jnp.asarray(ef),
                         jnp.asarray(ee), jnp.asarray(ec),
                         jnp.asarray(is_ack), jnp.asarray(is_nack)))


# --------------------------------------------------------- profiles -----

@pytest.mark.parametrize("name", ["ai_base", "ai_full", "hpc", "resilient"])
def test_named_profiles_match(name):
    a, b = getattr(profile.TransportProfile, name)(), \
        getattr(jprof.TransportProfile, name)()
    for f in fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (int(va) if hasattr(va, "value") else va) == \
            (int(vb) if hasattr(vb, "value") else vb), f.name
    np.testing.assert_array_equal(a.delivery_modes(5), b.delivery_modes(5))


@pytest.mark.parametrize("cc", ["RCCC", "NSCC_AND_RCCC", "NONE"])
def test_unported_cc_raises(cc):
    """Every CC composition is built now, with the recovery loop
    (ROADMAP.md item 6), INC (item 7) and telemetry (item 9, which
    raised here before it was ported) too."""
    from repro_torch.network import fabric
    from repro_torch.network.telemetry import TelemetrySpec
    from repro_torch.network.topology import leaf_spine
    algo = profile.CCAlgo[cc]
    pol = profile.make_cc_policy(algo, nscc.NSCCParams(), 48.0)
    st = pol.create(4, torch.device("cpu"))
    assert pol.cwnd_view(st, 4).dtype == torch.float32
    g = leaf_spine(2, 2, 2)
    for prof in (profile.TransportProfile(cc=algo, rto_backoff=2.0),
                 profile.TransportProfile(cc=algo, pdc_dead_after=4)):
        assert callable(fabric.make_step(g, prof, fabric.SimParams(), 2,
                                         device="cpu"))
        assert callable(fabric.make_step(g, replace(prof, inc=True),
                                         fabric.SimParams(), 2,
                                         device="cpu"))
        # and with telemetry (item 9, which raised before it was ported)
        assert callable(fabric.make_step(g, replace(prof, inc=True),
                                         fabric.SimParams(), 2,
                                         tel=TelemetrySpec.on(),
                                         device="cpu"))
    with pytest.raises(ValueError, match="unknown CC"):
        profile.make_cc_policy(7, nscc.NSCCParams(), 48.0)


@pytest.mark.parametrize("scheme", ["RR_SLOTS", "EVBITMAP"])
def test_unported_lb_raises(scheme):
    """Every LB scheme is built now, with EV eviction (ROADMAP.md item
    6) too; the lane-wise REPS feedback, which the tick does not use and
    which raised until it was ported, runs (held against the reference
    in ``test_lane_wise_reps_feedback_matches_the_reference``): with no
    valid lane it changes nothing."""
    assert lb.LBPolicy(lb.LBScheme[scheme]).scheme == lb.LBScheme[scheme]
    assert lb.LBPolicy(lb.LBScheme[scheme], evict_enabled=True).evict_enabled
    st = lb.LBState.create(4, 8, 0x5EED, torch.device("cpu"))
    z = torch.zeros(4, dtype=torch.int32)
    _same_dc(lb.on_ack(st, lb.LBScheme.REPS, z, z, z.bool(), z.bool()), st)


def _reps_lanes(rng, n, flows, hi=None):
    """n lanes over ``flows`` (repeats, negatives and rows past the end
    when ``hi`` widens the range), a quarter congested, a fifth invalid."""
    lo, hi = (-flows - 3, flows + 3) if hi is None else (0, hi)
    return (rng.integers(lo, hi, n).astype(np.int32),
            rng.integers(0, 2 ** 16, n).astype(np.int32),
            rng.random(n) < 0.25, rng.random(n) < 0.8)


@pytest.mark.parametrize("case", ["repeats", "full_rings", "edges"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lane_wise_reps_feedback_matches_the_reference(case, seed):
    """``on_ack(..., REPS)`` against the reference's
    (``src/repro/core/lb/schemes.py:325-337``): lanes of one flow write
    one ring slot, the last lane's EV staying, and each adds one to the
    size; a flow whose ring is full takes nothing; congested and invalid
    lanes take nothing; rows outside [0, F) drop (a negative row counts
    from the end once)."""
    rng = np.random.default_rng(seed)
    f, k = 24, 8
    js = jlb.LBState.create(f, k, np.uint32(0x5EED + seed))
    size = {"repeats": rng.integers(0, k // 2, f),
            "full_rings": rng.choice([k - 1, k], f),
            "edges": rng.integers(0, k + 1, f)}[case].astype(np.int32)
    js = replace(js, reps_size=jnp.asarray(size),
                 reps_head=jnp.asarray(rng.integers(0, 3 * k, f).astype(
                     np.int32)),
                 reps_ring=jnp.asarray(rng.integers(-1, 99, (f, k)).astype(
                     np.int32)))
    ts = lb.LBState(*(_t(np.asarray(getattr(js, x.name))) for x in fields(js)))
    lanes = _reps_lanes(rng, 96, f, hi=6 if case == "repeats" else None)
    want = jlb.on_ack(js, jlb.LBScheme.REPS, *(jnp.asarray(a) for a in lanes))
    got = lb.on_ack(ts, lb.LBScheme.REPS, *(_t(a) for a in lanes))
    _same_dc(got, want)
    # batched: B = 3 scenarios, lane b its own draw, each as if alone
    draws = [lanes] + [_reps_lanes(rng, 96, f) for _ in range(2)]
    tb = lb.LBState(*(torch.stack([getattr(ts, x.name)] * 3)
                      for x in fields(ts)))
    gb = lb.on_ack(tb, lb.LBScheme.REPS,
                   *(torch.stack([_t(d[i]) for d in draws]) for i in range(4)))
    for b, d in enumerate(draws):
        one = jlb.on_ack(js, jlb.LBScheme.REPS, *(jnp.asarray(a) for a in d))
        _same(gb.reps_ring[b], one.reps_ring, f"ring {b}")
        _same(gb.reps_size[b], one.reps_size, f"size {b}")


@pytest.mark.parametrize("ok", [False, True], ids=["all_flows", "flow_ok"])
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("scheme", list(lb.LBScheme), ids=lambda s: s.name)
def test_lb_on_ack_per_flow_is_the_dense_feedback(scheme, bsz, ok):
    """``LBPolicy.on_ack_per_flow`` on ``ops.flow_fold``'s clean-ACK
    count and EV sum (the lanes ``is_ack & (ec == 0)``) gives the state
    that ``on_ack`` gives on the [B, F, E] ACK one-hot, for every scheme,
    with repeated ACK lanes on a flow, flows -1 and >= F, at B = 1 and 3
    and with and without a per-flow ``flow_ok`` (the mixed-ROD mask)."""
    f, k, e = 64, 8, 200
    st = lb.LBState.create(f, k, _t(RNG.integers(0, 2 ** 31, bsz)
                                    .astype(np.int32)), torch.device("cpu"))
    st = replace(st, reps_ring=_t(RNG.integers(-1, 2 ** 16, (bsz, f, k))
                                  .astype(np.int32)),
                 reps_head=_t(RNG.integers(0, 40, (bsz, f)).astype(np.int32)),
                 reps_size=_t(RNG.integers(0, k + 1, (bsz, f))
                              .astype(np.int32)),
                 cong_bits=_t(RNG.random((bsz, f, k)) < 0.2))
    ef = _t(RNG.integers(-2, f + 3, (bsz, e)).astype(np.int32))
    et = RNG.integers(0, 4, (bsz, e))
    ee = _t(RNG.integers(0, 2 ** 16, (bsz, e)).astype(np.int32))
    # lanes that name a slot's own EV of their flow, so EVBITMAP marks
    ef[:, :f] = torch.arange(f, dtype=torch.int32)
    ee[:, :f] = st.ev_set[:, torch.arange(f), torch.arange(f) % k]
    ec = _t(RNG.integers(0, 2, (bsz, e)).astype(np.int32))
    is_ack, is_nack = _t(et == 1), _t((et == 2) | (et == 3))
    flow_ok = _t(RNG.random(f) < 0.6) if ok else None
    pol = lb.LBPolicy(scheme)
    hot_ack = ((ef[:, None, :] == torch.arange(f, dtype=torch.int32)[:, None])
               & is_ack[:, None, :])
    want = pol.on_ack(st, hot_ack, ef, ee, ec, is_ack, is_nack,
                      flow_ok=flow_ok)
    (clean_n,), (clean_ev,) = ops.flow_fold(ef, f, (is_ack & (ec == 0),),
                                            ((0, ee),))
    got = pol.on_ack_per_flow(st, clean_n, clean_ev, ef, ee, ec, is_ack,
                              is_nack, flow_ok=flow_ok)
    for fld in fields(want):
        assert torch.equal(getattr(got, fld.name), getattr(want, fld.name)), \
            fld.name
    if scheme in (lb.LBScheme.REPS, lb.LBScheme.EVBITMAP):
        assert any(not torch.equal(getattr(want, fld.name),
                                   getattr(st, fld.name))
                   for fld in fields(want))
