"""Bitwise parity of the profile-table policies with the reference, hook
by hook over [F] lanes: RCCC (``grant_credits`` with and without ``dfc``
and ``demand``, ``mark_seen``, ``spend``, every ``RCCCPolicy`` hook), the
hybrid and open-loop compositions, RR_SLOTS and EVBITMAP selection and
feedback (duplicate flows and the ROD ``flow_ok`` mask included),
``static_ev``, ``describe`` and ``cc_ablation``; and ``init_state`` plus
``convert`` round trips for every CC state form.
"""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cms import rccc as jrccc
from repro.core.lb import schemes as jlb
from repro.network import fabric as jf
from repro.network import profile as jprof
from repro.network import topology as jt
from repro_torch import convert
from repro_torch.core.cms import nscc, rccc
from repro_torch.core.lb import schemes as lb
from repro_torch.network import fabric as tf
from repro_torch.network import profile
from repro_torch.network.topology import fat_tree3
from test_torch_fabric import (K6_DST, K6_SIZE, K6_SRC,
                               _assert_state_matches, _jax_dict)

RNG = np.random.default_rng(1212)
F, H = 1024, 37
CPU = torch.device("cpu")


def _t(a):
    a = np.array(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _same(got, want, name=""):
    g = np.ascontiguousarray(got.numpy())
    want = np.ascontiguousarray(np.asarray(want))
    if want.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.dtype == want.dtype and g.shape == want.shape, \
        (name, g.dtype, want.dtype, g.shape, want.shape)
    np.testing.assert_array_equal(g.view(np.uint8), want.view(np.uint8),
                                  err_msg=name)


def _same_tree(got, want, name="st"):
    if isinstance(got, dict):
        assert set(got) == set(want), name
        for k in got:
            _same_tree(got[k], want[k], f"{name}.{k}")
    elif hasattr(got, "__dataclass_fields__"):
        for f in fields(got):
            _same(getattr(got, f.name), getattr(want, f.name),
                  f"{name}.{f.name}")
    else:
        _same(got, want, name)


def _rccc_states():
    bal = RNG.uniform(-2.0, 60.0, F).astype(np.float32)
    bal[:3] = [0.999999, 1.0, 48.0]
    seen = RNG.integers(0, 2, F).astype(bool)
    return (rccc.RCCCState(_t(bal), _t(seen)),
            jrccc.RCCCState(jnp.asarray(bal), jnp.asarray(seen)))


def _lanes():
    dst = RNG.integers(0, H, F).astype(np.int32)
    active = RNG.integers(0, 2, F).astype(bool)
    return dst, active


@pytest.mark.parametrize("kind", ["plain", "dfc", "demand", "dfc+demand"])
def test_grant_credits_bitwise(kind):
    ts, js = _rccc_states()
    dst, active = _lanes()
    kw_t, kw_j = {}, {}
    if "dfc" in kind:
        dfc = RNG.uniform(0.1, 1.0, H).astype(np.float32)
        kw_t["dfc"], kw_j["dfc"] = _t(dfc), jnp.asarray(dfc)
    if "demand" in kind:
        dem = RNG.uniform(0.0, 4.0, F).astype(np.float32)
        kw_t["demand"], kw_j["demand"] = _t(dem), jnp.asarray(dem)
    for rate in (1.0, 0.37):
        _same_tree(rccc.grant_credits(ts, _t(dst), _t(active), H, rate,
                                      **kw_t),
                   jrccc.grant_credits(js, jnp.asarray(dst),
                                       jnp.asarray(active), H, rate, **kw_j))


def test_mark_seen_and_spend_bitwise():
    """Lanes that repeat a flow, masked lanes, a negative flow (counts
    from the end, as JAX's index rules) and one past the end (dropped)."""
    ts, js = _rccc_states()
    L = 3 * F
    flow = RNG.integers(-F // 2, F + 5, L).astype(np.int32)
    flow[:8] = [5, 5, 5, -1, F, F + 3, 0, 7]
    valid = RNG.integers(0, 2, L).astype(bool)
    valid[:8] = True
    _same_tree(rccc.mark_seen(ts, _t(flow), _t(valid)),
               jrccc.mark_seen(js, jnp.asarray(flow), jnp.asarray(valid)))
    _same_tree(rccc.spend(ts, _t(flow), _t(valid)),
               jrccc.spend(js, jnp.asarray(flow), jnp.asarray(valid)))
    _same(rccc.can_send(ts), jrccc.can_send(js))


def _policies(cc):
    params = dict(base_rtt=10.0, max_cwnd=48.0)
    return (profile.make_cc_policy(profile.CCAlgo[cc],
                                   nscc.NSCCParams(**params), 48.0),
            jprof.make_cc_policy(jprof.CCAlgo[cc],
                                 jprof.NSCCParams(**params), 48.0))


def _random_cc(cc, tpol, jpol):
    """Matching non-trivial CC states of the composition ``cc``, with
    RTT samples on the 1-tick grid of the fabric (the quick-increase
    gap's folded reciprocal shows on it)."""
    ts, js = tpol.create(F, CPU), jpol.create(F)
    if cc == "NONE":
        return ts, js
    bal = RNG.uniform(0.0, 50.0, F).astype(np.float32)
    seen = RNG.integers(0, 2, F).astype(bool)
    r = (rccc.RCCCState(_t(bal), _t(seen)),
         jrccc.RCCCState(jnp.asarray(bal), jnp.asarray(seen)))
    if cc == "RCCC":
        return r
    cwnd = RNG.uniform(0.5, 50.0, F).astype(np.float32)
    acked = RNG.integers(0, 30, F).astype(np.int32)
    n = (nscc.NSCCState(_t(cwnd), _t(acked), _t(acked // 3), _t(acked % 7)),
         replace(js["nscc"], cwnd=jnp.asarray(cwnd),
                 epoch_acked=jnp.asarray(acked),
                 epoch_lost=jnp.asarray(acked // 3),
                 epoch_tick=jnp.asarray(acked % 7)))
    return {"nscc": n[0], "rccc": r[0]}, {"nscc": n[1], "rccc": r[1]}


@pytest.mark.parametrize("cc", ["RCCC", "NSCC_AND_RCCC", "NONE"])
def test_cc_policy_hooks_bitwise(cc):
    tpol, jpol = _policies(cc)
    ts, js = _random_cc(cc, tpol, jpol)
    _same_tree(ts, js, "create-like")
    has_ack = RNG.integers(0, 2, F).astype(bool)
    ecn = RNG.integers(0, 2, F).astype(bool)
    rtt = RNG.integers(0, 40, F).astype(np.float32)
    count = RNG.integers(0, 4, F).astype(np.int32)
    dst, active = _lanes()
    inflight = RNG.integers(0, 60, F).astype(np.int32)
    flags = [RNG.integers(0, 2, F).astype(bool) for _ in range(3)]
    steps = [
        ("on_ack", (_t(has_ack), _t(ecn), _t(rtt)),
         (jnp.asarray(has_ack), jnp.asarray(ecn), jnp.asarray(rtt))),
        ("on_nack", (_t(count),), (jnp.asarray(count),)),
        ("on_grant_tick", (_t(dst), _t(active), H),
         (jnp.asarray(dst), jnp.asarray(active), H)),
        ("on_inject", (_t(flags[0]),), (jnp.asarray(flags[0]),)),
        ("on_rx_seen", (_t(flags[1]),), (jnp.asarray(flags[1]),)),
        ("on_timeout", (_t(flags[2]),), (jnp.asarray(flags[2]),)),
        ("end_of_tick", (13,), (jnp.int32(13),)),
    ]
    for hook, targs, jargs in steps:
        # the reference's hooks as its engine runs them: under jax.jit
        # (num_hosts is a shape, so it stays a Python int)
        jhook = getattr(jpol, hook)
        if hook == "on_grant_tick":
            jhook = jax.jit(jhook, static_argnums=3)
        else:
            jhook = jax.jit(jhook)
        ts = getattr(tpol, hook)(ts, *targs)
        js = jhook(js, *jargs)
        _same_tree(ts, js, hook)
        _same(tpol.on_send_gate(ts, _t(inflight)),
              jpol.on_send_gate(js, jnp.asarray(inflight)), "gate")
        _same(tpol.cwnd_view(ts, F), jpol.cwnd_view(js, F), "cwnd_view")


def _lb_pair(seed):
    js = jlb.LBState.create(F, 16, np.uint32(seed))
    cong = RNG.integers(0, 4, (F, 16)) == 0
    ptr = RNG.integers(0, 40, F).astype(np.int32)
    js = replace(js, cong_bits=jnp.asarray(cong), rr_ptr=jnp.asarray(ptr))
    ts = lb.LBState(*(_t(np.asarray(getattr(js, f.name)))
                      for f in fields(js)))
    return ts, js


@pytest.mark.parametrize("scheme", ["RR_SLOTS", "EVBITMAP"])
@pytest.mark.parametrize("seed", [0x5EED, 0, 0xFFFFFFFF])
def test_lb_select_and_feedback_bitwise(scheme, seed):
    ts, js = _lb_pair(seed)
    tpol, jpol = lb.LBPolicy(lb.LBScheme[scheme]), \
        jlb.LBPolicy(jlb.LBScheme[scheme])
    psn = RNG.integers(0, 2 ** 32, F, dtype=np.uint64).astype(np.uint32)
    psn[:3] = [0, 2 ** 31, 2 ** 32 - 1]
    for tick in (0, 9, 2 ** 31 - 1):
        tn, tev = tpol.select(ts, _t(psn), tick)
        jn, jev = jpol.select(js, jnp.asarray(psn), jnp.int32(tick))
        _same(tev, jev, "ev")
        _same_tree(tn, jn, "select")
        ts, js = tn, jn
    _same(tpol.static_ev(ts), jpol.static_ev(js), "static_ev")
    # feedback over E lanes; ACK lanes one per flow, NACK lanes repeat
    E = 3 * F
    ef = (RNG.permutation(E) % (F + 9)).astype(np.int32)
    ef[:6] = [4, 4, 4, 9, 9, 2]
    et = RNG.integers(0, 4, E).astype(np.int32)
    ee = RNG.integers(0, 2 ** 16, E).astype(np.int32)
    # lanes that name a slot's own EV, so the bitmap marks something
    ee[:F] = np.asarray(js.ev_set)[np.minimum(ef[:F], F - 1),
                                   RNG.integers(0, 16, F)]
    ec = RNG.integers(0, 2, E).astype(np.int32)
    ef = np.where(et == 0, ef, np.minimum(ef, F - 1)).astype(np.int32)
    is_ack, is_nack = et == 1, (et == 2) | (et == 3)
    hot = (ef[None, :] == np.arange(F)[:, None]) & is_ack[None, :]
    hot &= np.cumsum(hot, axis=1) == 1
    rod = RNG.integers(0, 2, F).astype(bool)
    for ok_t, ok_j in ((None, None), (_t(~rod), jnp.asarray(~rod))):
        tn = tpol.on_ack(ts, _t(hot), _t(ef), _t(ee), _t(ec), _t(is_ack),
                         _t(is_nack), flow_ok=ok_t)
        jn = jpol.on_ack(js, jnp.asarray(hot), jnp.asarray(ef),
                         jnp.asarray(ee), jnp.asarray(ec),
                         jnp.asarray(is_ack), jnp.asarray(is_nack),
                         flow_ok=ok_j)
        _same_tree(tn, jn, "on_ack")
        if scheme == "EVBITMAP":
            assert bool((tn.cong_bits & ~ts.cong_bits).any())


def test_lanewise_evbitmap_feedback_with_duplicate_and_negative_flows():
    ts, js = _lb_pair(7)
    B = 2 * F
    flow = RNG.integers(-3, F + 3, B).astype(np.int32)
    flow[:4] = [11, 11, 11, -1]
    ev = np.asarray(js.ev_set)[np.clip(flow, 0, F - 1),
                               RNG.integers(0, 16, B)].astype(np.int32)
    cong = RNG.integers(0, 2, B).astype(bool)
    valid = RNG.integers(0, 3, B) > 0
    _same_tree(lb.on_ack(ts, lb.LBScheme.EVBITMAP, _t(flow), _t(ev),
                         _t(cong), _t(valid)),
               jlb.on_ack(js, jlb.LBScheme.EVBITMAP, jnp.asarray(flow),
                          jnp.asarray(ev), jnp.asarray(cong),
                          jnp.asarray(valid)))
    # the REPS branch, which raised until it was ported, on the same
    # duplicate and negative flows
    _same_tree(lb.on_ack(ts, lb.LBScheme.REPS, _t(flow), _t(ev), _t(cong),
                         _t(valid)),
               jlb.on_ack(js, jlb.LBScheme.REPS, jnp.asarray(flow),
                          jnp.asarray(ev), jnp.asarray(cong),
                          jnp.asarray(valid)))


@pytest.mark.parametrize("name", ["ai_base", "ai_full", "hpc", "resilient"])
def test_describe_matches(name):
    a = getattr(profile.TransportProfile, name)()
    b = getattr(jprof.TransportProfile, name)()
    assert a.describe() == b.describe()
    D, JD = profile.DeliveryMode, jprof.DeliveryMode
    a = replace(a, delivery=(D.ROD, D.RUD, D.RUDI), inc=True)
    b = replace(b, delivery=(JD.ROD, JD.RUD, JD.RUDI), inc=True)
    assert a.describe() == b.describe()
    for x, y in zip(profile.cc_ablation(a), jprof.cc_ablation(b)):
        assert x.describe() == y.describe() and int(x.cc) == int(y.cc)


@pytest.mark.parametrize("name", ["ai_base", "hpc", "open_loop", "mixed"])
def test_init_state_and_convert_round_trip_per_profile(name):
    n = len(K6_SRC)
    if name == "open_loop":
        tp = profile.TransportProfile(cc=profile.CCAlgo.NONE)
        jp = jprof.TransportProfile(cc=jprof.CCAlgo.NONE)
    elif name == "mixed":
        tp = profile.TransportProfile(
            lb=lb.LBScheme.RR_SLOTS,
            delivery=tuple(profile.DeliveryMode(i % 2) for i in range(n)))
        jp = jprof.TransportProfile(
            lb=jlb.LBScheme.RR_SLOTS,
            delivery=tuple(jprof.DeliveryMode(i % 2) for i in range(n)))
    else:
        tp = getattr(profile.TransportProfile, name)()
        jp = getattr(jprof.TransportProfile, name)()
    s = tf.take_lane(tf.init_state(
        fat_tree3(k=6, pods=3),
        tf.Workload.stack([tf.Workload.of(K6_SRC, K6_DST, K6_SIZE)]), tp,
        tf.SimParams(), device="cpu"), 0)
    js = jf.init_state(jt.fat_tree3(k=6, pods=3),
                       jf.Workload.of(K6_SRC, K6_DST, K6_SIZE), jp,
                       jf.SimParams())
    _assert_state_matches(s, js)
    d = convert.state_to_numpy(s)
    back = convert.state_to_numpy(convert.state_from_numpy(d, "cpu"))
    _same_tree_np(back, d)


def _same_tree_np(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_tree_np(got[k], want[k])
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_convert_refuses_an_unknown_cc_state():
    js = jf.init_state(jt.fat_tree3(k=6, pods=3),
                       jf.Workload.of(K6_SRC, K6_DST, K6_SIZE),
                       jprof.TransportProfile.ai_base(), jf.SimParams())
    d = _jax_dict(js)
    d["cc"] = {"balance": d["cc"]["balance"]}
    with pytest.raises(ValueError, match="CC state"):
        convert.state_from_numpy(d, "cpu")
