"""The port's batched NSCC window update and ECMP port selection against
the reference package's ``repro.kernels.ops`` entry points.

Mirrors ``tests/test_kernels.py`` case for case (the same ``n``,
``fanout`` and ``NSCCParams`` sweeps), plus a params set whose
``base_rtt * target_factor`` is not exact in f32 and edge lanes. On the
CPU the port's plain versions (``repro_torch.kernels.ref``) are held
bitwise against the jnp oracle (``use_pallas=False``). The NSCC update
is held within rtol 1e-6 of the Pallas kernel in interpret mode
(``use_pallas=True``), the reference's own tolerance: that form is not
bitwise even against its own oracle, because XLA compiles the Pallas
body with its division by the constant target folded into a reciprocal
multiply (ROADMAP.md, "Faults found"), which moves some lanes by an ulp.
ECMP is bitwise against both forms. The CUDA kernels are held against the
plain versions on a card by ``test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cms.nscc import NSCCParams as JParams
from repro.kernels import ops as jops
from repro_torch.core.cms.nscc import NSCCParams
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(1207)

PARAM_SETS = [dict(), dict(base_rtt=20.0, md=0.3),
              dict(max_cwnd=128.0, quick_gain=1.5),
              dict(base_rtt=7.3, target_factor=1.1)]   # target not exact


def _t(a, device="cpu"):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _nscc_inputs(n, kw, rtt_hi=60.0, cnt_hi=5, edges=False):
    p = NSCCParams(**kw)
    cwnd = RNG.uniform(p.min_cwnd, p.max_cwnd, n).astype(np.float32)
    ecn = RNG.integers(0, 2, n).astype(np.int32)
    rtt = RNG.uniform(0.5, rtt_hi, n).astype(np.float32)
    cnt = RNG.integers(0, cnt_hi, n).astype(np.int32)
    if edges:
        # rtt 0, negative, +-inf, on the target; cwnd < 1; count 0,
        # negative and large
        k = min(n, 12)
        rtt[:k] = [0.0, -3.5, np.inf, -np.inf, p.base_rtt * p.target_factor,
                   1e-7, 0.0, -0.0, 1e30, 2.0, 12.5, 80.0][:k]
        cwnd[:k:3] = [0.25, 0.0, 1e-3, 0.9][:len(range(0, k, 3))]
        cnt[:k:2] = [-4, 0, 1 << 20, 7, -1, 3][:len(range(0, k, 2))]
    return cwnd, ecn, rtt, cnt


def _assert_nscc(cwnd, ecn, rtt, cnt, kw):
    jp, tp = JParams(**kw), NSCCParams(**kw)
    for e in (ecn, ecn.astype(bool)):        # int32 and bool ECN lanes
        got = ref.nscc_update_ref(_t(cwnd), _t(e), _t(rtt), _t(cnt), tp)
        assert got.dtype == torch.float32
        for up in (False, True):
            want = np.asarray(jops.nscc_update(
                jnp.asarray(cwnd), jnp.asarray(e), jnp.asarray(rtt),
                jnp.asarray(cnt), jp, use_pallas=up))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
            if not up:
                np.testing.assert_array_equal(_bits(got.numpy()),
                                              _bits(want))
    return got.numpy()


@pytest.mark.parametrize("n", [1, 7, 128, 129, 1000, 4096])
def test_nscc_update_matches_both_jax_forms(n):
    _assert_nscc(*_nscc_inputs(n, {}), {})


@pytest.mark.parametrize("kw", PARAM_SETS, ids=str)
def test_nscc_update_param_sweep(kw):
    p = NSCCParams(**kw)
    out = _assert_nscc(*_nscc_inputs(512, kw, rtt_hi=80.0, cnt_hi=3), kw)
    assert (out >= p.min_cwnd).all() and (out <= p.max_cwnd).all()


@pytest.mark.parametrize("kw", PARAM_SETS, ids=str)
def test_nscc_update_edge_lanes(kw):
    """rtt of 0, negative, +-inf and on the target; cwnd below 1; count
    of 0, negative and 2**20 — bitwise against both JAX forms."""
    _assert_nscc(*_nscc_inputs(300, kw, edges=True), kw)


def test_nscc_update_nan_lanes_stay_nan():
    """A NaN rtt or cwnd gives NaN where it is used, as torch.clamp and
    jnp.clip keep NaN (the CUDA kernel's max/clip do the same)."""
    cwnd = np.asarray([np.nan, np.nan, 10.0, 10.0, 10.0], np.float32)
    rtt = np.asarray([5.0, 5.0, np.nan, np.nan, np.nan], np.float32)
    ecn = np.asarray([0, 0, 1, 0, 1], np.int32)
    cnt = np.asarray([1, 0, 1, 1, 0], np.int32)
    got = ref.nscc_update_ref(_t(cwnd), _t(ecn), _t(rtt), _t(cnt),
                              NSCCParams()).numpy()
    want = np.asarray(jops.nscc_update(jnp.asarray(cwnd), jnp.asarray(ecn),
                                       jnp.asarray(rtt), jnp.asarray(cnt),
                                       use_pallas=False))
    np.testing.assert_array_equal(got, want)          # NaN == NaN here
    # lane 2: ECN with a NaN rtt is not "high", so its delta is 0
    assert np.isnan(got).tolist() == [True, True, False, True, False]


@pytest.mark.parametrize("n", [3, 500, 4096])
@pytest.mark.parametrize("fanout", [2, 4, 7, 8, 13, 16])
def test_ecmp_select_matches_both_jax_forms(n, fanout):
    src = RNG.integers(0, 1 << 20, n).astype(np.int32)
    dst = RNG.integers(0, 1 << 20, n).astype(np.int32)
    ev = RNG.integers(0, 65536, n).astype(np.int32)
    salt = RNG.integers(0, 256, n).astype(np.int32)
    got = ops.ecmp_select(_t(src), _t(dst), _t(ev), _t(salt), fanout).numpy()
    for up in (False, True):
        want = np.asarray(jops.ecmp_select(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ev),
            jnp.asarray(salt), fanout, use_pallas=up))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"pallas={up}")
    assert (got >= 0).all() and (got < fanout).all()


@pytest.mark.parametrize("fanout", [1, 3, 32, 1000])
def test_ecmp_select_negative_and_full_range_lanes(fanout):
    """Negative int32 lanes hash as their uint32 bit patterns (JAX's
    astype(uint32)); hashes with the top bit set take an unsigned mod."""
    n = 2048
    lanes = [RNG.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
             .astype(np.int32) for _ in range(4)]
    lanes[0][:4] = [-1, -2 ** 31, 2 ** 31 - 1, 0]
    got = ref.ecmp_hash_ref(*map(_t, lanes), fanout).numpy()
    want = np.asarray(jops.ecmp_select(*map(jnp.asarray, lanes), fanout,
                                       use_pallas=False))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got < fanout).all()


def test_ecmp_determinism_and_spread():
    """Same EV => same port; the port histogram over EVs is well mixed."""
    n = 1 << 14
    ev = _t(np.arange(n, dtype=np.int32))
    src, dst = _t(np.zeros(n, np.int32)), _t(np.ones(n, np.int32))
    salt = _t(np.full(n, 3, np.int32))
    p1 = ops.ecmp_select(src, dst, ev, salt, 4)
    assert torch.equal(p1, ops.ecmp_select(src, dst, ev, salt, 4))
    want = np.asarray(jops.ecmp_select(
        jnp.zeros(n, jnp.int32), jnp.ones(n, jnp.int32),
        jnp.arange(n, dtype=jnp.int32), jnp.full(n, 3, jnp.int32), 4,
        use_pallas=True))
    np.testing.assert_array_equal(p1.numpy(), want)
    hist = np.bincount(p1.numpy(), minlength=4) / n
    np.testing.assert_allclose(hist, 0.25, atol=0.02)


def test_ecmp_select_rejects_bad_fanout_and_dtype():
    lanes = [_t(np.arange(4, dtype=np.int32))] * 4
    for bad in (0, -3):
        with pytest.raises(ValueError, match="fanout"):
            ops.ecmp_select(*lanes, bad)
        with pytest.raises(ValueError, match="fanout"):
            ops.ecmp_select_cuda(*lanes, bad)
    with pytest.raises(TypeError, match="int32"):
        ops.ecmp_select(*lanes[:3], lanes[0].to(torch.int64), 4)


def test_new_kernels_take_plain_versions_on_cpu_and_count_nothing():
    before = dict(ops.LAUNCHES)
    cwnd, ecn, rtt, cnt = _nscc_inputs(64, {})
    for e in (ecn, ecn.astype(bool)):
        assert torch.equal(
            ops.nscc_update(_t(cwnd), _t(e), _t(rtt), _t(cnt)),
            ref.nscc_update_ref(_t(cwnd), _t(e), _t(rtt), _t(cnt),
                                NSCCParams()))
    lanes = [_t(RNG.integers(0, 1000, 64).astype(np.int32)) for _ in range(4)]
    assert torch.equal(ops.ecmp_select(*lanes, 7),
                       ref.ecmp_hash_ref(*lanes, 7))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["nscc_update", "ecmp_select"])
def test_new_kernels_refuse_cpu_tensors(kernel):
    cwnd, ecn, rtt, cnt = _nscc_inputs(8, {})
    lanes = [_t(np.arange(8, dtype=np.int32))] * 4
    args = {"nscc_update": (_t(cwnd), _t(ecn.astype(bool)), _t(rtt),
                            _t(cnt)),
            "ecmp_select": (*lanes, 5)}[kernel]
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(ops, f"{kernel}_cuda")(*args)


# ----------------------------------------------------- the enqueue ranks --

def _enqueue_loop(target, valid, base, cap):
    """The enqueue phase one lane at a time: each valid lane takes its
    queue's next position, base[b, q] plus the lanes before it there; an
    invalid lane reads base[b, 0]. Returns (pos, added, fits)."""
    bsz, n = target.shape
    pos = np.zeros((bsz, n), np.int64)
    added = np.zeros(base.shape, np.int64)
    fits = np.zeros((bsz, n), bool)
    for b in range(bsz):
        seen = np.zeros(base.shape[1], np.int64)
        for i in range(n):
            if not valid[b, i]:
                pos[b, i] = base[b, 0]
                continue
            q = target[b, i]
            pos[b, i] = base[b, q] + seen[q]
            seen[q] += 1
            fits[b, i] = pos[b, i] < cap
            added[b, q] += fits[b, i]
    return pos.astype(np.int32), added.astype(np.int32), fits


def _enqueue_case(kind, bsz, n, q, cap):
    """[B, n] targets and valid lanes and [B, Q] queue lengths of one
    case: random targets (invalid lanes among them, some aimed out of
    [0, Q)), every lane to one queue, or random targets over a base of 0,
    capacity - 1 or capacity."""
    if kind == "one_queue":
        target = np.full((bsz, n), q // 2, np.int32)
        valid = np.ones((bsz, n), bool)
    else:
        target = RNG.integers(0, q, (bsz, n)).astype(np.int32)
        valid = RNG.random((bsz, n)) < 0.7
        target[~valid & (RNG.random((bsz, n)) < 0.5)] = -1
        target[~valid & (RNG.random((bsz, n)) < 0.2)] = q + 3
    base = {"zero_base": np.zeros((bsz, q)),
            "base_cap_minus_1": np.full((bsz, q), cap - 1),
            "base_cap": np.full((bsz, q), cap)}.get(
        kind, RNG.integers(0, cap + 1, (bsz, q)))
    return target, valid, base.astype(np.int32)


ENQUEUE_CASES = [("random", 3, 200, 16, 8), ("random", 1, 77, 5, 4),
                 ("one_queue", 3, 96, 4, 64), ("one_queue", 1, 45, 3, 16),
                 ("zero_base", 3, 130, 9, 6), ("base_cap_minus_1", 1, 64, 4, 8),
                 ("base_cap", 3, 41, 7, 8)]


@pytest.mark.parametrize("kind,bsz,n,q,cap", ENQUEUE_CASES,
                         ids=lambda v: str(v))
def test_enqueue_rank_ref_matches_a_lane_loop(kind, bsz, n, q, cap):
    """``enqueue_rank_ref`` (pos, added, fits) against the enqueue phase
    walked one lane at a time, at B = 1 and 3 and at lane counts that are
    and are not multiples of 32."""
    target, valid, base = _enqueue_case(kind, bsz, n, q, cap)
    got = ref.enqueue_rank_ref(_t(target), _t(valid), _t(base), cap)
    for g, w in zip(got, _enqueue_loop(target, valid, base, cap)):
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind,bsz,n,q,cap", ENQUEUE_CASES[:3],
                         ids=lambda v: str(v))
def test_enqueue_rank_on_cpu_is_the_tick_composition(kind, bsz, n, q, cap):
    """On CPU tensors ``ops.enqueue_rank`` is the composition the tick
    ran: ``fabric._rank_within``'s positions, fits against the capacity
    and the [B, Q, n] enqueue one-hot's sum; no launch is counted."""
    from repro_torch.network import fabric
    target, valid, base = map(_t, _enqueue_case(kind, bsz, n, q, cap))
    before = dict(ops.LAUNCHES)
    pos, added, fits = ops.enqueue_rank(target, valid, base, cap)
    assert ops.LAUNCHES == before
    want_pos, _ = fabric._rank_within(target, valid, base)
    want_fits = valid & (want_pos < cap)
    qidx = torch.arange(q, dtype=torch.int32)
    hot_enq = (target[:, None, :] == qidx[:, None]) & want_fits[:, None, :]
    assert torch.equal(pos, want_pos) and torch.equal(fits, want_fits)
    assert torch.equal(added, hot_enq.sum(dim=-1, dtype=torch.int32))


def test_enqueue_rank_refuses_cpu_tensors_for_the_kernel():
    target, valid, base = map(_t, _enqueue_case("random", 2, 40, 5, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.enqueue_rank_cuda(target, valid, base, 8)


# --------------------------------------------------- the per-flow folds --

def _wrap32(a):
    return ((np.asarray(a, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(
        np.int32)


def _fold_loop(flow, f, masks, sums):
    """The per-flow folds one lane at a time: for each scenario and lane
    whose flow lies in [0, f), each set mask counts one for the flow, and
    each (k, value) adds the value where mask k is set; sums wrap as
    int32. Returns (counts [M, B, f], totals [S, B, f])."""
    bsz, n = flow.shape
    counts = np.zeros((len(masks), bsz, f), np.int64)
    totals = np.zeros((len(sums), bsz, f), np.int64)
    for b in range(bsz):
        for i in range(n):
            fl = int(flow[b, i])
            if not 0 <= fl < f:
                continue
            for k, m in enumerate(masks):
                counts[k, b, fl] += bool(m[b, i])
            for j, (k, v) in enumerate(sums):
                if masks[k][b, i]:
                    totals[j, b, fl] += int(v[b, i])
    return counts.astype(np.int32), _wrap32(totals)


def _control_lanes(kind, bsz, f, n):
    """Section 1's event lanes of one case as numpy arrays: types (none,
    ACK, NACK, OOO), flows (in [0, f) and outside it), PSNs over the
    whole int32 range, ECN bits, EVs and timestamps; then is_ack and
    is_nack as the tick makes them. ``repeat``: several ACK and NACK
    lanes on flows 0 and f - 1; ``out_of_range``: a third of the flows
    -1 or >= f; ``src_dead``: the lanes of flows whose source host died
    drop their ACKs and NACKs; ``wrap``: every ACK lane on flow 1 with a
    PSN near 2**31 - 1, so its sums wrap."""
    et = RNG.integers(0, 4, (bsz, n)).astype(np.int32)
    ef = RNG.integers(0, f, (bsz, n)).astype(np.int32)
    ep = RNG.integers(-2 ** 31, 2 ** 31, (bsz, n), dtype=np.int64).astype(
        np.int32)
    ec = RNG.integers(0, 2, (bsz, n)).astype(np.int32)
    ee = RNG.integers(0, 2 ** 16, (bsz, n)).astype(np.int32)
    ets = RNG.integers(0, 5000, (bsz, n)).astype(np.int32)
    if kind == "repeat":
        ef[:, :12] = [0, 0, 0, f - 1, f - 1, 0, f - 1, 0, 0, f - 1, 0, 0]
        et[:, :12] = [1, 1, 2, 1, 3, 3, 2, 2, 1, 1, 2, 3]
    elif kind == "out_of_range":
        out = RNG.random((bsz, n)) < 0.33
        ef[out] = RNG.choice([-1, -7, f, f + 5, 2 ** 31 - 1], out.sum())
    elif kind == "wrap":
        ef[:] = 1
        et[:] = 1
        ep[:] = 2 ** 31 - 1 - RNG.integers(0, 4, (bsz, n))
        ets[:] = 2 ** 31 - 9
    is_ack, is_nack = et == 1, (et == 2) | (et == 3)
    if kind == "src_dead":
        src_dead = RNG.random((bsz, f)) < 0.4
        lane_dead = np.take_along_axis(src_dead, np.clip(ef, 0, f - 1), -1)
        is_ack, is_nack = is_ack & ~lane_dead, is_nack & ~lane_dead
    return dict(ef=ef, ep=ep, ec=ec, ee=ee, ets=ets, is_ack=is_ack,
                is_nack=is_nack)


def _section1_fold(lanes, reps):
    """The fold section 1 asks for: the ACK and NACK counts; the ACK
    lanes' PSN, ECN and timestamp sums; under REPS the clean ACK lanes'
    count and EV sum."""
    masks = [lanes["is_ack"], lanes["is_nack"]]
    sums = [(0, lanes["ep"]), (0, lanes["ec"]), (0, lanes["ets"])]
    if reps:
        masks.append(lanes["is_ack"] & (lanes["ec"] == 0))
        sums.append((2, lanes["ee"]))
    return lanes["ef"], masks, sums


FOLD_CASES = [  # kind, B, F, lanes
    ("random", 1, 6, 40), ("random", 3, 9, 67), ("repeat", 1, 5, 30),
    ("repeat", 3, 5, 30), ("out_of_range", 3, 7, 50),
    ("src_dead", 1, 8, 45), ("src_dead", 3, 8, 45), ("wrap", 3, 4, 20),
    ("delivery", 1, 6, 24), ("delivery", 3, 10, 33)]


def _fold_operands(kind, bsz, f, n, reps):
    """(flow, masks, sums) of one case, numpy: section 1's fold, or for
    ``delivery`` section 5's (the data deliveries' count and PSN over the
    queue heads, whose flows repeat: several heads carry one flow)."""
    if kind == "delivery":
        pf = RNG.integers(-1, f + 2, (bsz, n)).astype(np.int32)
        ddata = RNG.random((bsz, n)) < 0.5
        pp = RNG.integers(-2 ** 31, 2 ** 31, (bsz, n),
                          dtype=np.int64).astype(np.int32)
        return pf, [ddata], [(0, pp)]
    return _section1_fold(_control_lanes(kind, bsz, f, n), reps)


@pytest.mark.parametrize("reps", [False, True], ids=["ai_full", "reps"])
@pytest.mark.parametrize("kind,bsz,f,n", FOLD_CASES, ids=str)
def test_flow_fold_ref_matches_a_lane_loop(kind, bsz, f, n, reps):
    """``flow_fold_ref`` (counts, totals) against the folds walked one
    lane at a time: repeated ACK and NACK lanes on a flow, flows -1 and
    >= F, dead sources' lanes, REPS's clean-ACK fold, section 5's form,
    B = 1 and 3, sums that wrap int32."""
    flow, masks, sums = _fold_operands(kind, bsz, f, n, reps)
    got = ref.flow_fold_ref(_t(flow), f, [_t(m) for m in masks],
                            [(k, _t(v)) for k, v in sums])
    for g, w in zip(got, _fold_loop(flow, f, masks, sums)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind,bsz,f,n", FOLD_CASES, ids=str)
def test_flow_fold_on_cpu_is_the_tick_composition(kind, bsz, f, n):
    """On CPU tensors ``ops.flow_fold`` gives what the tick's [B, F, L]
    one-hots gave (sections 1 and 5 as they were written before the
    fold): has_ack, the NACK count, the ACK lane's PSN, ECN and
    timestamp, REPS's clean-ACK recycle inputs under a per-flow
    ``flow_ok``, and the delivery's presence and PSN; no launch is
    counted."""
    from repro_torch.core.lb.schemes import _pick_lane
    reps = kind != "delivery"
    flow, masks, sums = _fold_operands(kind, bsz, f, n, reps)
    flow, masks = _t(flow), [_t(m) for m in masks]
    sums = [(k, _t(v)) for k, v in sums]
    before = dict(ops.LAUNCHES)
    counts, totals = ops.flow_fold(flow, f, masks, sums)
    assert ops.LAUNCHES == before
    flow_ids = torch.arange(f, dtype=torch.int32)
    own = flow[:, None, :] == flow_ids[:, None]
    if kind == "delivery":
        hot_d = own & masks[0][:, None, :]
        assert torch.equal(counts[0] > 0, hot_d.any(dim=-1))
        assert torch.equal(totals[0], _pick_lane(hot_d, sums[0][1]))
        return
    is_ack, is_nack = masks[:2]
    ep, ec, ets, ee = (v for _, v in sums)
    hot_ack = own & is_ack[:, None, :]
    hot_nack = own & is_nack[:, None, :]
    assert torch.equal(counts[0] > 0, hot_ack.any(dim=-1))
    assert torch.equal(counts[1], hot_nack.sum(dim=-1, dtype=torch.int32))
    assert torch.equal(counts[1] > 0, hot_nack.any(dim=-1))
    assert torch.equal(totals[0], _pick_lane(hot_ack, ep))
    assert torch.equal(totals[1], _pick_lane(hot_ack, ec))
    assert torch.equal(totals[2], _pick_lane(hot_ack, ets))
    flow_ok = _t(RNG.random(f) < 0.6)
    hot_clean = hot_ack & (ec[:, None, :] == 0) & flow_ok[:, None]
    valid = (counts[2] > 0) & flow_ok
    assert torch.equal(valid, hot_clean.any(dim=-1))
    assert torch.equal(torch.where(valid, totals[3], 0),
                       _pick_lane(hot_clean, ee))


def test_flow_fold_refuses_cpu_tensors_for_the_kernel():
    flow, masks, sums = _fold_operands("random", 2, 6, 40, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flow_fold_cuda(_t(flow), 6, [_t(m) for m in masks],
                           [(k, _t(v)) for k, v in sums])
