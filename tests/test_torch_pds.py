"""Bit-level parity of the port against the reference package: the uint32
helpers, the PSN-ring helpers of ``core.pds``, the fabric's bit helpers
and enqueue ranks, the two hashes, the copied topologies and the routing
tables. Inputs come from a fixed numpy seed and span the whole uint32
range (values >= 2**31 included), so every signed/unsigned trap shows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pds as jpds
from repro.core.lb.schemes import _mix32 as j_mix32
from repro.network import ecmp as jecmp
from repro.network import fabric as jfab
from repro.network import topology as jtopo
from repro_torch import _u32
from repro_torch.core import pds
from repro_torch.core.lb.schemes import _mix32
from repro_torch.kernels import ops
from repro_torch.network import ecmp, fabric, topology

RNG = np.random.default_rng(2311)


def _words(shape):
    w = RNG.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    w.flat[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF][:w.size]
    return w


def _t(a):
    a = np.asarray(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.numpy()
    if want.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.dtype == want.dtype, (g.dtype, want.dtype)
    np.testing.assert_array_equal(g, want)


# ------------------------------------------------------------ _u32 helpers

def test_u32_helpers_match_numpy_uint32():
    a, b = _words(4096), _words(4096)
    n = RNG.integers(0, 32, 4096)
    ta, tb = _t(a), _t(b)
    _same(ta + tb, a + b)
    _same(ta - tb, a - b)
    _same(ta * tb, a * b)
    _same(ta ^ tb, a ^ b)
    _same(_u32.ult(ta, tb), a < b)
    _same(_u32.ult(ta, 0x90000000), a < np.uint32(0x90000000))
    for k in (0, 1, 15, 16, 31):
        _same(_u32.shr(ta, k), a >> np.uint32(k))
    _same(_u32.bit(torch.as_tensor(n)), np.uint32(1) << n.astype(np.uint32))
    for m in (3, 7, 65536):
        _same(_u32.umod(ta, m), (a % np.uint32(m)).astype(np.int32))
    _same(_u32.to_f32(ta), np.asarray(jnp.asarray(a).astype(jnp.float32)))
    hi = _words(4096)
    want = np.where(n == 0, a, (a >> n.astype(np.uint32))
                    | (hi << (32 - n).astype(np.uint32)))
    _same(_u32.funnel_r(ta, _t(hi), torch.as_tensor(n)), want)
    assert _u32.c32(0x9E3779B1) == np.uint32(0x9E3779B1).view(np.int32)


# --------------------------------------------------------------- core.pds

@pytest.mark.parametrize("w", [1, 2, 16, 32])
def test_pds_bit_helpers_match(w):
    x = _words(4096)
    _same(pds._popcount32(_t(x)), jpds._popcount32(jnp.asarray(x)))
    _same(pds._clz32(_t(x)), jpds._clz32(jnp.asarray(x)))
    ring = _words((257, w))
    for i in range(0, 257, 3):
        ring[i, :i % (w + 1)] = 0xFFFFFFFF
    ring[5::11] = 0
    _same(pds.trailing_ones(_t(ring)), jpds.trailing_ones(jnp.asarray(ring)))
    count = RNG.integers(0, w * 32 + 1, 257).astype(np.int32)
    _same(pds.shift_ring(_t(ring), _t(count)),
          jpds.shift_ring(jnp.asarray(ring), jnp.asarray(count)))
    jt = jpds.PSNTracker.create(257, w * 32)
    jt = jpds.PSNTracker(base=jt.base, ring=jnp.asarray(ring), rx_ok=jt.rx_ok,
                         dup=jt.dup, oor=jt.oor)
    tt = pds.PSNTracker.create(257, w * 32, "cpu")
    tt = pds.PSNTracker(base=tt.base, ring=_t(ring), rx_ok=tt.rx_ok,
                        dup=tt.dup, oor=tt.oor)
    _same(pds.ooo_distance(tt), jpds.ooo_distance(jt))


# ----------------------------------------------------- fabric bit helpers

@pytest.mark.parametrize("w", [2, 16])
def test_fabric_bit_helpers_match(w):
    n = 300
    ring = _words((n, w))
    ring[::7] = 0
    ring[1::7, :-1] = 0
    off = RNG.integers(-40, w * 32 + 40, n).astype(np.int32)
    valid = RNG.integers(0, 2, n).astype(bool)
    jr, jo, jv = jnp.asarray(ring), jnp.asarray(off), jnp.asarray(valid)
    tr, to, tv = _t(ring), _t(off), _t(valid)
    _same(fabric._first_set_bit(tr), jfab._first_set_bit(jr))
    _same(fabric._bit_plane(to, tv, w), jfab._bit_plane(jo, jv, w))
    _same(fabric._set_own_bit(tr, to, tv), jfab._set_own_bit(jr, jo, jv))
    _same(fabric._clear_own_bit(tr, to, tv), jfab._clear_own_bit(jr, jo, jv))
    _same(fabric._own_word(tr, to), jfab._own_word(jr, jo))


@pytest.mark.parametrize("n,q", [(1, 1), (50, 4), (700, 64)])
def test_rank_within_matches(n, q):
    target = RNG.integers(-1, q, n).astype(np.int32)
    valid = (target >= 0) & (RNG.random(n) < 0.8)
    base = RNG.integers(0, 9, q).astype(np.int32)
    got = fabric._rank_within(_t(target), _t(valid), _t(base))
    want = jfab._rank_within(jnp.asarray(target), jnp.asarray(valid),
                             jnp.asarray(base))
    for g, w in zip(got, want):
        _same(g, w)


# --------------------------------------------------------------- hashing

def test_mix32_and_ecmp_hash_match():
    x = _words(8192)
    _same(_mix32(_t(x)), j_mix32(jnp.asarray(x)))
    src, dst, ev, salt = (_words(8192) for _ in range(4))
    _same(ecmp.ecmp_hash(_t(src), _t(dst), _t(ev), _t(salt)),
          jecmp.ecmp_hash(jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(ev), jnp.asarray(salt)))


# ---------------------------------------------------- topology + routing

TOPOS = [("leaf_spine", (3, 3, 2)), ("leaf_spine", (2, 4, 8)),
         ("fat_tree3", (6, 3)), ("fat_tree3", (8, 4))]


@pytest.mark.parametrize("make,args", TOPOS)
def test_topology_copy_builds_the_same_graph(make, args):
    a = getattr(topology, make)(*args)
    b = getattr(jtopo, make)(*args)
    for name in a.__dataclass_fields__:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


@pytest.mark.parametrize("make,args", [("leaf_spine", (3, 3, 2)),
                                       ("fat_tree3", (6, 3)),
                                       ("leaf_spine", (4, 4, 4))])
def test_routing_tables_match(make, args):
    """Fanout 3 on the first two: a signed % would disagree wherever the
    hash has its top bit set; 4 (a mask) on the third. Random lanes
    through the methods, then the kernel entry points they call
    (``ops.ecmp_inject`` / ``ops.ecmp_route``) on the tick's shapes:
    [B, F] injection lanes, and [B, Q] queue-head lanes under the [Q]
    queue ids that every scenario shares."""
    g, jg = getattr(topology, make)(*args), getattr(jtopo, make)(*args)
    assert g.fanout1 == (4 if args == (4, 4, 4) else 3)
    rt, jrt = ecmp.RoutingTables(g, "cpu"), jecmp.RoutingTables(jg)
    n = 4096
    src = RNG.integers(0, g.num_hosts, n).astype(np.int32)
    dst = RNG.integers(0, g.num_hosts, n).astype(np.int32)
    ev = RNG.integers(0, 2 ** 16, n).astype(np.int32)
    want = jrt.injection_queue(jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(ev))
    _same(rt.injection_queue(_t(src), _t(dst), _t(ev)), want)
    _same(ops.ecmp_inject(rt, *(_t(a).view(4, -1) for a in (src, dst, ev)))
          .reshape(-1), want)
    queue = RNG.integers(0, g.num_queues, n).astype(np.int32)
    _same(rt.route_step(_t(queue), _t(src), _t(dst), _t(ev)),
          jrt.route_step(jnp.asarray(queue), jnp.asarray(src),
                         jnp.asarray(dst), jnp.asarray(ev)))
    q, b = g.num_queues, 3
    lanes = [RNG.integers(0, g.num_hosts, (b, q)).astype(np.int32)
             for _ in range(2)] + [_words((b, q)).view(np.int32)]
    qidx = np.arange(q, dtype=np.int32)
    got = ops.ecmp_route(rt, _t(qidx), *(_t(a) for a in lanes))
    assert got.shape == (b, q)
    _same(got, jrt.route_step(jnp.asarray(qidx), *map(jnp.asarray, lanes)))
