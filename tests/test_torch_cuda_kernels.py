"""The port's hand-written CUDA kernels against their plain PyTorch
versions on a card, bit for bit (float lanes as bit patterns, NaN
included). Every test is ``cuda``-marked and skips without a card.

This file imports neither JAX nor the reference package, so it runs on a
machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cms.nscc import NSCCParams
from repro_torch.kernels import ops, ref
from repro_torch.network.ecmp import RoutingTables
from repro_torch.network.topology import fat_tree3, leaf_spine

RNG = np.random.default_rng(2207)

PARAM_SETS = [dict(base_rtt=10.0, max_cwnd=48.0), dict(),
              dict(base_rtt=20.0, md=0.3, max_cwnd=128.0, quick_gain=1.5),
              dict(base_rtt=7.3, target_factor=1.1)]   # target not exact


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _words(shape):
    return RNG.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _sack_rows(n, w):
    ring = _words((n, w))
    for i in range(0, n, 3):
        ring[i, :i % (w + 1)] = 0xFFFFFFFF
    ring[-1] = 0
    if n > 1:
        ring[-2] = 0xFFFFFFFF
    return ring


def _same_bits(got, want):
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(1, 2), (2048, 16), (333, 32), (70, 7)])
def test_sack_kernels_match_plain_on_card(cuda, n, w):
    ring, base = _t(_sack_rows(n, w), cuda), _t(_words(n), cuda)
    rtx = _t(_words((n, w)), cuda)
    mask = _t(np.where(RNG.random((n, w)) < 0.3, _words((n, w)), 0)
              .astype(np.uint32), cuda)
    for got, want in zip(ops.sack_fused_cuda(ring, base, rtx, mask),
                         ref.sack_fused_ref(ring, base, rtx, mask)):
        assert _same_bits(got, want)
    for got, want in zip(ops.sack_advance_cuda(ring, base),
                         ref.sack_advance_ref(ring, base)):
        assert _same_bits(got, want)


def _own_lanes(n, w):
    """Row offsets over [-8, 32 W + 8) with the edge offsets -1, 31, 32
    and 32 W, and ok / clear lanes, as numpy."""
    off = RNG.integers(-8, 32 * w + 8, n).astype(np.int32)
    k = min(n, 4)
    off[:k] = [-1, 31, 32, 32 * w][:k]
    return (off, RNG.integers(0, 4, n) > 0, RNG.integers(0, 4, n) > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 2048])
@pytest.mark.parametrize("w", [1, 3, 8, 16, 17, 32])
def test_sack_own_kernels_match_plain_on_card(cuda, n, w):
    ring, base = _t(_sack_rows(n, w), cuda), _t(_words(n), cuda)
    rtx = _t(_words((n, w)), cuda)
    off, ok, clear = (_t(a, cuda) for a in _own_lanes(n, w))
    got = ops.sack_fused_own_cuda(ring, base, rtx, off, ok, clear)
    want = ref.sack_fused_own_ref(ring, base, rtx, off, ok, clear)
    assert len(got) == len(want) == 5
    for g, x in zip(got, want):
        assert _same_bits(g, x)
    got = ops.sack_advance_own_cuda(ring, base, off, ok)
    want = ref.sack_advance_own_ref(ring, base, off, ok)
    assert len(got) == len(want) == 4
    for g, x in zip(got, want):
        assert _same_bits(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("f,w,lanes", [(4, 2, 3), (2048, 16, 9216),
                                       (130, 32, 1000)])
def test_nack_kernel_matches_plain_on_card(cuda, f, w, lanes):
    rtx = _t(_words((f, w)), cuda)
    flow = _t(RNG.integers(-2, f + 2, lanes).astype(np.int32), cuda)
    off = _t(RNG.integers(-4, w * 32 + 8, lanes).astype(np.int32), cuda)
    valid = _t(RNG.integers(0, 2, lanes).astype(bool), cuda)
    assert _same_bits(ops.nack_mark_cuda(rtx, flow, off, valid),
                      ref.nack_mark_ref(rtx, flow, off, valid))


def _mark_lanes(f, w, lanes):
    """(base, flow, psn, nack, rod) as numpy: NACK lanes over rows
    [0, F) and offsets over [-8, 32 W + 8), then edge lanes (offsets -1,
    32 W and the int32 extremes, PSNs past the 2**32 and 2**31 wraps,
    duplicates, rows out of range, non-NACK lanes)."""
    base = _words(f)
    base[::4] = 0xFFFFFFFF - RNG.integers(0, 16, base[::4].shape)
    base[0] = 0xFFFFFFF0
    base[-1] = 0x7FFFFFF0
    flow = RNG.integers(0, f, lanes)
    off = RNG.integers(-8, 32 * w + 8, lanes)
    nack = RNG.integers(0, 3, lanes) > 0
    edges = ([(0, o, True) for o in (-1, 0, 31, 32, 32 * w - 1, 32 * w,
                                     -(2 ** 31), 2 ** 31 - 1, 16, 17)]
             + [(f - 1, 17, True)] * 8
             + [(r, 3, True) for r in (-1, f, f + 3, -(2 ** 31))]
             + [(0, 2, False)] * 4)
    for i, (r, o, v) in enumerate(edges[:lanes]):
        flow[i], off[i], nack[i] = r, o, v
    row = np.clip(flow, 0, f - 1)
    psn = ((base[row].astype(np.int64) + off) % 2 ** 32).astype(np.uint32)
    rod = RNG.integers(0, 2, f).astype(bool)
    rod[0] = False                 # row 0 holds the edges: they must mark
    return base, flow.astype(np.int32), psn, nack, rod


@pytest.mark.cuda
@pytest.mark.parametrize("mixed_rod", [False, True], ids=["rud", "mixed_rod"])
@pytest.mark.parametrize("f", [1, 33, 2048])
@pytest.mark.parametrize("w", [1, 3, 16, 17, 32])
def test_nack_mark_lanes_kernel_matches_plain_on_card(cuda, f, w, mixed_rod):
    rtx = _t(_words((f, w)), cuda)
    base, flow, psn, nack, rod = (
        _t(a, cuda) for a in _mark_lanes(f, w, max(64, 4 * f + 1024)))
    rod = rod if mixed_rod else None
    got = rtx.clone()
    assert ops.nack_mark_lanes_cuda(got, base, flow, psn, nack, rod) is got
    want = ref.nack_mark_lanes_ref_(rtx.clone(), base, flow, psn, nack, rod)
    assert _same_bits(got, want) and not _same_bits(got, rtx)


@pytest.mark.cuda
@pytest.mark.parametrize("mixed_rod", [False, True], ids=["rud", "mixed_rod"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("f", [1, 33, 2048])
@pytest.mark.parametrize("w", [1, 16, 17, 32])
def test_strided_nack_mark_lanes_kernel_matches_plain_on_card(cuda, b, f, w,
                                                             mixed_rod):
    """B scenarios of [F, W] rings: each scenario's NACK lanes (edge lanes
    with flows -1, F, F + 3 and -2**31 included) are a [B, L] slice of
    wider rows, as the tick hands them over; the kernel equals the plain
    version, and scenario by scenario the unbatched plain version (no
    lane reaches a neighbour scenario's rows)."""
    lanes, skip = max(64, 4 * f + 1024), 7
    per = [_mark_lanes(f, w, lanes) for _ in range(b)]
    base = _t(np.stack([x[0] for x in per]), cuda)
    wide = [np.zeros((b, skip + lanes), dt) for dt in (np.int32, np.uint32,
                                                       bool)]
    for i, x in enumerate(per):
        for a, v in zip(wide, x[1:4]):
            a[i, skip:] = v
    flow, psn, nack = (_t(a, cuda)[:, skip:] for a in wide)
    rod = _t(per[0][4], cuda) if mixed_rod else None
    rtx = _t(_words((b, f, w)), cuda)
    got = rtx.clone()
    assert ops.nack_mark_lanes_cuda(got, base, flow, psn, nack, rod) is got
    want = ref.nack_mark_lanes_ref_(rtx.clone(), base, flow, psn, nack, rod)
    assert _same_bits(got, want) and not _same_bits(got, rtx)
    for i in range(b):
        one = ref.nack_mark_lanes_ref_(rtx[i].clone(), base[i], flow[i],
                                       psn[i], nack[i], rod)
        assert _same_bits(got[i], one), i


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 2048])
@pytest.mark.parametrize("w", [1, 3, 16, 17, 32])
def test_own_bit_kernels_match_plain_on_card(cuda, n, w):
    rtx, ring = _t(_words((n, w)), cuda), _t(_words((n, w)), cuda)
    off = RNG.integers(-8, 32 * w + 8, n).astype(np.int32)
    k = min(n, 6)
    off[:k] = [-1, 0, 31, 32, 32 * w - 1, 32 * w][:k]
    off, valid = _t(off, cuda), _t(RNG.integers(0, 4, n) > 0, cuda)
    for unless in (None, ring):
        got = rtx.clone()
        assert ops.set_own_bit_cuda(got, off, valid, unless) is got
        assert _same_bits(got, ref.set_own_bit_ref_(rtx.clone(), off, valid,
                                                    unless))
    got = rtx.clone()
    assert ops.clear_own_bit_cuda(got, off, valid) is got
    assert _same_bits(got, ref.clear_own_bit_ref_(rtx.clone(), off, valid))


def _nscc_lanes(n, p, device):
    cwnd = RNG.uniform(0.25, p.max_cwnd * 1.2, n).astype(np.float32)
    ecn = RNG.integers(0, 2, n).astype(bool)
    rtt = RNG.uniform(0.0, 6.0 * p.base_rtt, n).astype(np.float32)
    cnt = RNG.integers(-2, 6, n).astype(np.int32)
    edge = np.asarray([0.0, -3.5, np.inf, -np.inf, np.nan,
                       p.base_rtt * p.target_factor, 1e-7, -0.0], np.float32)
    for j, v in enumerate(edge):
        rtt[j::97] = v
    cwnd[3::101], cwnd[5::211] = 0.5, np.nan
    cnt[1::13], cnt[2::13], cnt[4::13] = 0, -9, 1 << 30
    return tuple(_t(a, device) for a in (cwnd, ecn, rtt, cnt))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2048, 100003])
@pytest.mark.parametrize("kw", PARAM_SETS, ids=str)
def test_nscc_kernel_matches_plain_on_card(cuda, n, kw):
    p = NSCCParams(**kw)
    args = _nscc_lanes(n, p, cuda)
    assert _same_bits(ops.nscc_update_cuda(*args, p),
                      ref.nscc_update_ref(*args, p))
    # the entry point takes an int32 ECN lane too
    ecn_i = args[1].to(torch.int32)
    assert _same_bits(ops.nscc_update(args[0], ecn_i, *args[2:], p),
                      ref.nscc_update_ref(*args, p))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7168, 100003])
@pytest.mark.parametrize("fanout", [1, 2, 3, 7, 8, 13, 16, 32])
def test_ecmp_kernel_matches_plain_on_card(cuda, n, fanout):
    lanes = [_t(RNG.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                .astype(np.int32), cuda) for _ in range(4)]
    assert _same_bits(ops.ecmp_select_cuda(*lanes, fanout),
                      ref.ecmp_hash_ref(*lanes, fanout))


def _tick_nscc_lanes(n, p, device):
    """The tick forms' per-flow lanes as numpy-seeded tensors: windows
    below 1, at min_cwnd and max_cwnd and NaN; RTTs 0, on the target,
    just below it, +-inf and NaN; ACKs, ECN marks, epoch counters (lost
    0 on half the lanes) and epoch starts near ``now = 1000``, whose age
    crosses ``epoch_len`` (ages epoch_len - 1, epoch_len, epoch_len + 1
    first)."""
    target = np.float32(p.base_rtt * p.target_factor)
    epoch_len = int(p.base_rtt * p.target_factor)
    cwnd = RNG.uniform(0.25, p.max_cwnd * 1.2, n).astype(np.float32)
    rtt = RNG.uniform(0.0, 6.0 * float(target), n).astype(np.float32)
    edge = np.asarray([0.0, target, np.nextafter(target, np.float32(0)),
                       np.inf, -np.inf, np.nan, 1e-7, -0.0], np.float32)
    for j, v in enumerate(edge):
        rtt[j::97] = v
    cwnd[3::101], cwnd[5::211] = 0.5, np.nan
    cwnd[6::53], cwnd[7::59] = p.min_cwnd, p.max_cwnd
    acked = RNG.integers(0, 40, n).astype(np.int32)
    lost = np.where(RNG.random(n) < 0.5, 0, RNG.integers(1, 9, n))
    tick = 1000 - epoch_len + RNG.integers(-3, 4, n)
    tick[:3] = 1000 - np.asarray([epoch_len - 1, epoch_len, epoch_len + 1])[:n]
    ack, ecn = RNG.integers(0, 2, n) > 0, RNG.integers(0, 2, n) > 0
    return tuple(_t(a, device) for a in (
        cwnd, acked, ack, ecn, rtt, lost.astype(np.int32),
        tick.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 2048, 8192])
@pytest.mark.parametrize("kw", PARAM_SETS, ids=str)
def test_nscc_tick_kernels_match_plain_on_card(cuda, n, kw):
    """``nscc_ack`` and ``nscc_epoch`` against their plain versions, and
    through the dispatch on the tick's [B, F] lanes."""
    p = NSCCParams(**kw)
    cwnd, acked, ack, ecn, rtt, lost, tick = _tick_nscc_lanes(n, p, cuda)
    got = ops.nscc_ack_cuda(cwnd, acked, ack, ecn, rtt, p)
    want = ref.nscc_ack_ref(cwnd, acked, ack, ecn, rtt, p)
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    for now in (999, 1000, 1001):
        got = ops.nscc_epoch_cuda(cwnd, acked, lost, tick, now, p)
        want = ref.nscc_epoch_ref(cwnd, acked, lost, tick, now, p)
        assert len(got) == 4
        assert all(_same_bits(g, w) for g, w in zip(got, want)), now
    if n % 4 == 0:
        lanes = [t.view(4, -1) for t in (cwnd, acked, ack, ecn, rtt)]
        got = ops.nscc_ack(*lanes, p)
        assert got[0].shape == (4, n // 4)
        assert all(_same_bits(g.reshape(-1), w)
                   for g, w in zip(got, ref.nscc_ack_ref(
                       cwnd, acked, ack, ecn, rtt, p)))


TOPOLOGIES = [("fat_tree3", (16, 16)), ("fat_tree3", (6, 3)),
              ("leaf_spine", (4, 4, 4)), ("leaf_spine", (3, 3, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("make,args", TOPOLOGIES, ids=str)
@pytest.mark.parametrize("b", [1, 4])
def test_ecmp_tick_kernels_match_plain_on_card(cuda, make, args, b):
    """``ecmp_inject`` over [B, F] flow lanes (the EV lane also as a
    strided view, as STATIC's ``ev_set[..., 0]`` is) and ``ecmp_route``
    over [B, Q] queue-head lanes under the [Q] queue ids, and under
    random [B, Q] ids, against the plain versions."""
    g = {"fat_tree3": fat_tree3, "leaf_spine": leaf_spine}[make](*args)
    rt = RoutingTables(g, cuda)
    f, q, h = 2048, g.num_queues, g.num_hosts
    src, dst = (_t(RNG.integers(0, h, (b, f)).astype(np.int32), cuda)
                for _ in range(2))
    ev_set = _t(_words((b, f, 3)), cuda)
    for ev in (ev_set[..., 0], ev_set[..., 1].contiguous()):
        got = ops.ecmp_inject(rt, src, dst, ev)
        assert _same_bits(got, ref.ecmp_inject_ref(rt, src, dst, ev))
    before = ops.LAUNCHES["ecmp_route"]
    qsrc, qdst = (_t(RNG.integers(0, h, (b, q)).astype(np.int32), cuda)
                  for _ in range(2))
    qev = _t(_words((b, q)), cuda)
    qidx = torch.arange(q, dtype=torch.int32, device=cuda)
    rand = _t(RNG.integers(0, q, (b, q)).astype(np.int32), cuda)
    for queue in (qidx, rand):
        got = ops.ecmp_route_cuda(rt, queue, qsrc, qdst, qev)
        assert _same_bits(got, ref.ecmp_route_ref(rt, queue, qsrc, qdst,
                                                  qev))
    assert ops.LAUNCHES["ecmp_route"] == before + 2
