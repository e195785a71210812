"""The port's kernels of the reference's tick against the reference
package.

On the CPU the port's plain versions (``repro_torch.kernels.ref``) are
held bitwise against both JAX forms of each kernel: the Pallas kernel in
interpret mode (``use_pallas=True``) and its jnp oracle
(``use_pallas=False``). The hand-written CUDA kernels are held against
the plain versions on a card by ``test_torch_cuda_kernels.py``.
uint32 words cross as int32 bit patterns (``repro_torch._u32``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.cms.nscc import NSCCParams
from repro_torch.kernels import ops, ref
from repro_torch.network.ecmp import RoutingTables
from repro_torch.network.topology import fat_tree3

RNG = np.random.default_rng(1107)


def _words(shape):
    return RNG.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a, device="cpu"):
    """numpy uint32/int32/bool -> the port's tensor (uint32 as int32)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _np(t):
    return t.cpu().numpy()


def _u(t):
    return _np(t).view(np.uint32)


def _sack_rows(n, w):
    """Random rings plus edge rows: leading full words of every length,
    an empty row and a full row."""
    ring = _words((n, w))
    for i in range(0, n, 3):
        k = i % (w + 1)
        ring[i, :k] = 0xFFFFFFFF
    ring[-1] = 0
    if n > 1:
        ring[-2] = 0xFFFFFFFF
    return ring


def _assert_sack_fused(ring, base, rtx, mask):
    got = ref.sack_fused_ref(_t(ring), _t(base), _t(rtx), _t(mask))
    for up in (True, False):
        want = jops.sack_fused(jnp.asarray(ring), jnp.asarray(base),
                               jnp.asarray(rtx), jnp.asarray(mask),
                               use_pallas=up)
        for name, g, w in zip(("ring", "base", "rtx", "adv"), got, want):
            w = np.asarray(w)
            gv = _u(g) if w.dtype == np.uint32 else _np(g)
            np.testing.assert_array_equal(gv, w, err_msg=f"{name} {up}")


def _assert_sack_advance(ring, base):
    got = ref.sack_advance_ref(_t(ring), _t(base))
    for up in (True, False):
        want = jops.sack_advance(jnp.asarray(ring), jnp.asarray(base),
                                 use_pallas=up)
        for name, g, w in zip(("ring", "base", "adv"), got, want):
            w = np.asarray(w)
            gv = _u(g) if w.dtype == np.uint32 else _np(g)
            np.testing.assert_array_equal(gv, w, err_msg=f"{name} {up}")


@pytest.mark.parametrize("n,w", [(1, 2), (9, 8), (64, 16), (130, 32)])
def test_sack_fused_matches_both_jax_forms(n, w):
    ring = _sack_rows(n, w)
    mask = np.where(RNG.random((n, w)) < 0.2, _words((n, w)), 0).astype(
        np.uint32)
    _assert_sack_fused(ring, _words(n), _words((n, w)), mask)


@pytest.mark.parametrize("n,w", [(1, 2), (5, 4), (64, 16), (300, 32)])
def test_sack_advance_matches_both_jax_forms(n, w):
    _assert_sack_advance(_sack_rows(n, w), _words(n))


@pytest.mark.parametrize("case", ["empty", "full", "wrap"])
def test_sack_edge_cases(case):
    n, w = 6, 4
    if case == "empty":
        ring = np.zeros((n, w), np.uint32)
    elif case == "full":
        ring = np.full((n, w), 0xFFFFFFFF, np.uint32)
    else:   # base just below 2**32: the advance wraps modularly
        ring = np.asarray([[0xFFFFFFFF, 1, 0, 0], [7, 0, 0, 0],
                           [0, 0, 0, 0], [0xFFFFFFFF] * 4,
                           [0xFFFFFFFF, 0xFFFFFFFF, 0x80000000, 0],
                           [0xFFFFFFFE, 0, 0, 0]], np.uint32)
    base = np.full((n,), 0xFFFFFFF0, np.uint32)
    rtx = _words((n, w))
    _assert_sack_fused(ring, base, rtx, np.zeros((n, w), np.uint32))
    _assert_sack_advance(ring, base)
    _, b, x, a = ref.sack_fused_ref(_t(ring), _t(base), _t(rtx),
                                    _t(np.zeros((n, w), np.uint32)))
    if case == "empty":
        assert not _np(a).any() and np.array_equal(_u(x), rtx)
    if case == "full":
        assert (_np(a) == w * 32).all() and not _np(x).any()
    if case == "wrap":
        assert int(_u(b)[3]) == (0xFFFFFFF0 + w * 32) % 2 ** 32


def _assert_nack(rtx, flow, off, valid, pallas_only=False):
    got = _u(ref.nack_mark_ref(_t(rtx), _t(flow.astype(np.int32)),
                               _t(off.astype(np.int32)), _t(valid)))
    for up in ((True,) if pallas_only else (True, False)):
        want = jops.nack_mark(jnp.asarray(rtx), jnp.asarray(flow, jnp.int32),
                              jnp.asarray(off, jnp.int32),
                              jnp.asarray(valid), use_pallas=up)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(up))
    return got


@pytest.mark.parametrize("f,w,lanes", [(1, 2, 5), (9, 16, 64), (130, 4, 300)])
def test_nack_mark_matches_both_jax_forms(f, w, lanes):
    rtx = _words((f, w))
    flow = RNG.integers(0, f, lanes)
    off = RNG.integers(-4, w * 32 + 8, lanes)   # clipped, as both forms do
    valid = RNG.integers(0, 2, lanes).astype(bool)
    _assert_nack(rtx, flow, off, valid)


def test_nack_mark_duplicates_and_existing_bits():
    """Lanes carrying the SAME (flow, offset) set the bit once (OR, not
    add), set bits stay set, invalid lanes mark nothing."""
    rtx = np.asarray([[0, 0], [0, 0], [0, 0], [0x80000001, 0x80000001]],
                     np.uint32)
    flow = np.asarray([1, 1, 1, 2, 0, 3])
    off = np.asarray([5, 5, 37, 0, 63, 1])
    valid = np.asarray([True, True, True, True, False, True])
    out = _assert_nack(rtx, flow, off, valid)
    assert out[1, 0] == 1 << 5 and out[1, 1] == 1 << 5
    assert out[2, 0] == 1 and not out[0].any()
    assert out[3, 0] == 0x80000003 and out[3, 1] == 0x80000001


def test_nack_mark_out_of_range_rows_mark_nothing():
    """A valid lane whose row is negative or >= F marks nothing: the
    contract of the reference's Pallas kernel, which the port follows.
    (The reference's jnp oracle wraps row -1 to row F-1 instead — filed
    in ROADMAP.md "Faults found".)"""
    rtx = np.zeros((4, 2), np.uint32)
    flow, off = np.asarray([-1, 5, 4]), np.asarray([3, 7, 9])
    valid = np.ones(3, bool)
    out = _assert_nack(rtx, flow, off, valid, pallas_only=True)
    assert not out.any()
    oracle = np.asarray(jops.nack_mark(
        jnp.asarray(rtx), jnp.asarray(flow, jnp.int32),
        jnp.asarray(off, jnp.int32), jnp.asarray(valid), use_pallas=False))
    assert oracle[3, 0] == 1 << 3, "the oracle's wrap is the filed fault"


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    ring, base = _t(_sack_rows(8, 4)), _t(_words(8))
    before = dict(ops.LAUNCHES)
    for got, want in zip(ops.sack_advance(ring, base),
                         ref.sack_advance_ref(ring, base)):
        assert torch.equal(got, want)
    ops.sack_fused(ring, base, ring, ring)
    off, ok = _t(np.arange(8, dtype=np.int32)), _t(np.ones(8, bool))
    ops.sack_fused_own(ring, base, ring, off, ok, ok)
    ops.sack_advance_own(ring, base, off, ok)
    ops.nack_mark(ring, _t(np.zeros(3, np.int32)), _t(np.zeros(3, np.int32)),
                  _t(np.ones(3, bool)))
    lanes = _t(np.zeros(3, np.int32))
    ops.nack_mark_lanes_(ring, base, lanes, lanes, _t(np.ones(3, bool)))
    ops.set_own_bit_(ring, off, ok, unless=ring.clone())
    ops.clear_own_bit_(ring, off, ok)
    cwnd, n32 = _t(np.full((2, 4), 9.5, np.float32)), _t(np.ones((2, 4),
                                                               np.int32))
    flag = _t(np.ones((2, 4), bool))
    p = NSCCParams()
    for got, want in zip(ops.nscc_ack(cwnd, n32, flag, flag, cwnd, p),
                         ref.nscc_ack_ref(cwnd, n32, flag, flag, cwnd, p)):
        assert torch.equal(got, want)
    for got, want in zip(ops.nscc_epoch(cwnd, n32, n32, n32, 40, p),
                         ref.nscc_epoch_ref(cwnd, n32, n32, n32, 40, p)):
        assert torch.equal(got, want)
    rt = RoutingTables(fat_tree3(k=4, pods=2), "cpu")
    hosts, queue = n32 * 3, _t(np.arange(4, dtype=np.int32))
    assert torch.equal(ops.ecmp_inject(rt, n32, hosts, n32),
                       ref.ecmp_inject_ref(rt, n32, hosts, n32))
    assert torch.equal(ops.ecmp_route(rt, queue, n32, hosts, n32),
                       ref.ecmp_route_ref(rt, queue, n32, hosts, n32))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["sack_fused", "sack_advance",
                                    "nack_mark", "sack_fused_own",
                                    "sack_advance_own", "nack_mark_lanes",
                                    "set_own_bit", "clear_own_bit",
                                    "nscc_ack", "nscc_epoch", "ecmp_inject",
                                    "ecmp_route"])
def test_kernels_refuse_cpu_tensors(kernel):
    ring, base = _t(_sack_rows(8, 4)), _t(_words(8))
    lanes = _t(np.zeros(3, np.int32))
    off, ok = _t(np.zeros(8, np.int32)), _t(np.ones(8, bool))
    cwnd = _t(np.ones(8, np.float32))
    rt = RoutingTables(fat_tree3(k=4, pods=2), "cpu")
    args = {"sack_fused": (ring, base, ring, ring),
            "sack_advance": (ring, base),
            "nack_mark": (ring, lanes, lanes, _t(np.ones(3, bool))),
            "sack_fused_own": (ring, base, ring, off, ok, ok),
            "sack_advance_own": (ring, base, off, ok),
            "nack_mark_lanes": (ring, base, lanes, lanes,
                                _t(np.ones(3, bool))),
            "set_own_bit": (ring, off, ok, ring),
            "clear_own_bit": (ring, off, ok),
            "nscc_ack": (cwnd, off, ok, ok, cwnd, NSCCParams()),
            "nscc_epoch": (cwnd, off, off, off, 3, NSCCParams()),
            "ecmp_inject": (rt, lanes, lanes, lanes),
            "ecmp_route": (rt, lanes, lanes, lanes, lanes)}[kernel]
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(ops, f"{kernel}_cuda")(*args)
