"""The in-place marks on the retransmit ring against the reference tick.

The port's tick writes the retransmit ring with three in-place forms of
``repro_torch.kernels.ops``, one call per site:

* ``nack_mark_lanes_`` — the NACK site (``repro/network/fabric.py``
  section 1): the reference computes each lane's offset from the source
  CACK, tests its range and ROD mask, clips it and calls
  ``repro.kernels.ops.nack_mark``;
* ``set_own_bit_`` — the RTO's bit 0 (section 9) and, with the source
  ring as ``unless``, the RR_SLOTS loss inference (section 1), where the
  reference tests ``_own_word`` of the source ring and calls
  ``_set_own_bit``;
* ``clear_own_bit_`` — the retransmit pick (section 3), the reference's
  ``_clear_own_bit``.

On the CPU their plain versions are held bitwise against those
compositions (``nack_mark`` in interpret mode, ``use_pallas=True``, and
in its jnp form where every row is in range) at W in {1, 3, 16, 17, 32},
on random lanes plus edges: offsets below 0 and at 32 W, PSN and base
across the 2**32 wrap, duplicate (row, bit) lanes, out-of-range rows,
non-NACK lanes and a mixed ROD mask. Then the tick: each step leaves its
input state untouched (the forms write only the ring the step made) and
calls each form as often as its profile's sites say. The CUDA kernels
are held against the plain versions on a card by
``test_torch_cuda_kernels.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.network import fabric as jfab
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.kernels import ops
from repro_torch.network import fabric as tf
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import CCAlgo, DeliveryMode, TransportProfile
from repro_torch.network.topology import fat_tree3
from test_torch_fabric import K6_DST, K6_PARAMS, K6_SIZE, K6_SRC

RNG = np.random.default_rng(1409)
WIDTHS = [1, 3, 16, 17, 32]
F_ROWS = 40


def _t(a):
    """A copy of numpy uint32/int32/bool as the port's tensor (uint32 as
    int32): the forms write in place, so no tensor shares the input."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a)


def _u(t):
    return t.numpy().view(np.uint32)


def _words(shape):
    return RNG.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _edge_offsets(w):
    return [-1, 0, 31, 32, 32 * w - 1, 32 * w, -(2 ** 31), 2 ** 31 - 1]


def _nack_lanes(f, w, lanes=256):
    """(rtx, base, flow, psn, nack, rod) as numpy: NACK lanes over rows
    [0, F) with offsets over [-8, 32 W + 8), then edge lanes."""
    rtx = _words((f, w))
    rtx[::3] = 0
    base = _words(f)
    base[::4] = 0xFFFFFFFF - RNG.integers(0, 16, base[::4].shape)
    base[0] = 0xFFFFFFF0                       # row 0 sits at the wrap,
    base[1] = 0x7FFFFFF0                       # row 1 at the int32 sign
    flow = RNG.integers(0, f, lanes)
    off = RNG.integers(-8, 32 * w + 8, lanes)
    nack = RNG.integers(0, 3, lanes) > 0
    i = 0
    for o in _edge_offsets(w):                 # each edge offset on row 0
        flow[i], off[i], nack[i] = 0, o, True
        i += 1
    for r in (0, 1):               # PSN past 2**32 (2**31), base below
        for o in (16, 17, 40):
            flow[i], off[i], nack[i] = r, min(o, 32 * w - 1), True
            i += 1
    flow[i:i + 8], off[i:i + 8], nack[i:i + 8] = f - 1, 5, True   # dupes
    i += 8
    for r in (-1, f, f + 3, -(2 ** 31), 2 ** 31 - 1):   # rows out of range
        flow[i], off[i], nack[i] = r, 3, True
        i += 1
    flow[i:i + 6], off[i:i + 6], nack[i:i + 6] = 0, 2, False   # not NACKs
    row = np.clip(flow, 0, f - 1)
    psn = ((base[row].astype(np.int64) + off) % 2 ** 32).astype(np.uint32)
    rod = RNG.integers(0, 2, f).astype(bool)
    rod[0] = rod[1] = rod[f - 1] = False   # the rows the edges check below
    return (rtx, base, flow.astype(np.int32), psn.view(np.int32), nack, rod)


def _reference_nack_site(rtx, base, flow, psn, nack, rod, use_pallas):
    """The reference tick's NACK site (fabric.py section 1) on the raw
    lanes ``ef[Q:]``, ``ep[Q:]``, ``is_nack[Q:]``."""
    w = rtx.shape[1]
    mp = 32 * w
    base, nf, nep = jnp.asarray(base), jnp.asarray(flow), jnp.asarray(psn)
    n_nack = jnp.asarray(nack)
    safe = jnp.where(n_nack, nf, 0)
    nack_off = nep - base[safe].astype(jnp.int32)
    n_ok = n_nack & (nack_off >= 0) & (nack_off < mp)
    if rod is not None:
        n_ok = n_ok & ~jnp.asarray(rod)[safe]
    return np.asarray(jops.nack_mark(jnp.asarray(rtx), nf,
                                     jnp.clip(nack_off, 0, mp - 1), n_ok,
                                     use_pallas=use_pallas))


@pytest.mark.parametrize("mixed_rod", [False, True], ids=["rud", "mixed_rod"])
@pytest.mark.parametrize("w", WIDTHS)
def test_nack_mark_lanes_matches_the_reference_nack_site(w, mixed_rod):
    rtx, base, flow, psn, nack, rod = _nack_lanes(F_ROWS, w)
    rod = rod if mixed_rod else None
    ring = _t(rtx)
    got = ops.nack_mark_lanes_(ring, _t(base), _t(flow), _t(psn), _t(nack),
                               None if rod is None else _t(rod))
    assert got is ring, "the form writes into the ring it is given"
    got = _u(got)
    # every lane, out-of-range rows included: the Pallas kernel's
    # contract (such a row marks nothing)
    np.testing.assert_array_equal(
        got, _reference_nack_site(rtx, base, flow, psn, nack, rod, True))
    # rows in range only: the jnp form as well (it wraps a negative row,
    # ROADMAP.md "Faults found")
    keep = (flow >= 0) & (flow < F_ROWS)
    lanes = (flow[keep], psn[keep], nack[keep])
    sub = _u(ops.nack_mark_lanes_(_t(rtx), _t(base), *map(_t, lanes),
                                  None if rod is None else _t(rod)))
    np.testing.assert_array_equal(sub, got)
    for up in (True, False):
        np.testing.assert_array_equal(
            sub, _reference_nack_site(rtx, base, *lanes, rod, up),
            err_msg=f"pallas={up}")
    # the edges did what they are there for: the duplicates set their
    # bit, and the PSNs past 2**32 and 2**31 (bases 16 below) set bits
    # 16 and 17
    assert got[F_ROWS - 1, 0] & (1 << 5)
    for r in (0, 1):
        assert got[r, 0] & (1 << 16) and got[r, 0] & (1 << 17), r


def _row_lanes(n, w):
    """(rtx, ring, off, valid) as numpy: random rows, then each edge
    offset with valid on and off."""
    rtx, ring = _words((n, w)), _words((n, w))
    rtx[::2] = 0
    ring[1::3] = 0
    off = RNG.integers(-8, 32 * w + 8, n).astype(np.int32)
    valid = RNG.integers(0, 4, n) > 0
    i = 0
    for o in _edge_offsets(w):
        off[i:i + 2], valid[i:i + 2] = o, [True, False]
        i += 2
    return rtx, ring, off, valid


@pytest.mark.parametrize("w", WIDTHS)
def test_set_and_clear_own_bit_match_the_reference_rto_and_pick(w):
    """The RTO's set (offset 0 where stalled), any set, and the
    retransmit pick's clear, against ``_set_own_bit`` /
    ``_clear_own_bit``."""
    rtx, _, off, valid = _row_lanes(96, w)
    zeros = np.zeros_like(off)
    for o in (zeros, off):
        ring = _t(rtx)
        got = ops.set_own_bit_(ring, _t(o), _t(valid))
        assert got is ring
        want = jfab._set_own_bit(jnp.asarray(rtx), jnp.asarray(o),
                                 jnp.asarray(valid))
        np.testing.assert_array_equal(_u(got), np.asarray(want))
    full = np.full_like(rtx, 0xFFFFFFFF)
    for r in (rtx, full):
        ring = _t(r)
        got = ops.clear_own_bit_(ring, _t(off), _t(valid))
        assert got is ring
        want = jfab._clear_own_bit(jnp.asarray(r), jnp.asarray(off),
                                   jnp.asarray(valid))
        np.testing.assert_array_equal(_u(got), np.asarray(want))
    assert (_u(got) != full).any()


@pytest.mark.parametrize("w", WIDTHS)
def test_set_own_bit_unless_matches_the_reference_rr_slots_site(w):
    """The RR_SLOTS loss inference (fabric.py section 1): for back in
    (1, 2) the reference marks PSN ack_psn - back K where the ACK is
    valid, newer than the slot's last ACK and not already SACKed at the
    source (its ``_own_word`` test); the port passes the source ring as
    ``unless``."""
    n, k = 96, 4
    rtx, ring, off0, has_ack = _row_lanes(n, w)
    base = _words(n)
    base[::5] = 0xFFFFFFFF - RNG.integers(0, 8, base[::5].shape)
    # ack_psn = base + off0 + K: both predecessors' offsets sweep the
    # edges and the in-range window
    ack_psn = ((base.astype(np.int64) + off0 + k) % 2 ** 32).astype(
        np.uint32).view(np.int32)
    prev = (ack_psn.astype(np.int64) - RNG.integers(-3 * k, 3 * k, n)).clip(
        -(2 ** 31), 2 ** 31 - 1).astype(np.int32)
    # the source ring's random words hold about half of the tested bits
    got = _t(rtx)
    for back in (1, 2):
        miss = _t(ack_psn) - back * k
        valid = _t(has_ack) & (miss > _t(prev)) & (miss >= 0)
        ops.set_own_bit_(got, miss - _t(base), valid, unless=_t(ring))
    jr, jring = jnp.asarray(rtx), jnp.asarray(ring)
    jbase, jack, jprev = (jnp.asarray(base), jnp.asarray(ack_psn),
                          jnp.asarray(prev))
    for back in (1, 2):
        miss = jack - back * k
        off = miss - jbase.astype(jnp.int32)
        w_i = jnp.clip(off, 0, w * 32 - 1)
        sacked = (jfab._own_word(jring, off)
                  >> (w_i % 32).astype(jnp.uint32)) & jnp.uint32(1)
        lost = (jnp.asarray(has_ack) & (miss > jprev) & (miss >= 0)
                & (sacked == 0))
        jr = jfab._set_own_bit(jr, off, lost)
    np.testing.assert_array_equal(_u(got), np.asarray(jr))
    assert (_u(got) != rtx).any(), "the inference must mark bits"


# ------------------------------------------------------------- the tick --

def _mixed_rr_slots(n):
    return TransportProfile(
        cc=CCAlgo.NONE, lb=LBScheme.RR_SLOTS, name="mixed",
        delivery=tuple(DeliveryMode.ROD if f % 2 else DeliveryMode.RUD
                       for f in range(n)))


#: profile -> calls per tick of (nack_mark_lanes_, set_own_bit_,
#: clear_own_bit_): the RTO's set and the NACK site are compiled out
#: under all-ROD; RR_SLOTS adds two sets
PROFILES = {
    "ai_full": (TransportProfile.ai_full, (1, 1, 1)),
    "hpc": (TransportProfile.hpc, (0, 0, 1)),
    "ai_base_evbitmap": (lambda: TransportProfile.ai_base(
        lb=LBScheme.EVBITMAP), (1, 1, 1)),
    "mixed_rr_slots": (lambda: _mixed_rr_slots(len(K6_SRC)), (1, 3, 1)),
}
FORMS = ("nack_mark_lanes_", "set_own_bit_", "clear_own_bit_", "nack_mark")


def _tensors(obj, path="state"):
    """Every tensor of a state pytree (dataclasses, dicts, tensors)."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _tensors(v, f"{path}.{k}")


@pytest.mark.parametrize("name", list(PROFILES))
def test_step_leaves_its_input_state_untouched(name, monkeypatch):
    """Clone every tensor of the state, step, compare: the in-place
    forms write only the ring the step made. The step calls each form as
    often per tick as its profile's sites say, and the functional
    ``nack_mark`` never."""
    make, per_tick = PROFILES[name]
    calls = dict.fromkeys(FORMS, 0)
    for form in FORMS:
        def counted(*a, _fn=getattr(ops, form), _form=form, **kw):
            calls[_form] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, form, counted)
    prof = make()
    g = fat_tree3(k=6, pods=3)
    wl = tf.Workload.stack([tf.Workload.of(K6_SRC, K6_DST, K6_SIZE,
                                           device="cpu")])
    p = tf.SimParams(**K6_PARAMS)
    step = tf.make_step(g, prof, p, len(K6_SRC), device="cpu")
    fault = FaultSchedule.healthy(g.num_queues, batch=1, device="cpu")
    s = tf.init_state(g, wl, prof, p, device="cpu")      # [1, F] state
    ticks, rtx_bits = 160, 0
    for tick in range(ticks):
        before = [(k, t.clone()) for k, t in _tensors(s)]
        ns, _ = step(s, tick, wl, fault)
        for (k, t0), (k1, t) in zip(before, _tensors(s)):
            assert k == k1 and torch.equal(t, t0), f"tick {tick}: {k}"
        rtx_bits += int((ns.rtx != 0).sum())
        s = ns
    assert [calls[f] for f in FORMS] == [n * ticks for n in per_tick] + [0]
    # the run wrote the ring: NACK or RTO marks (none under all-ROD,
    # whose recovery is go-back-N)
    assert (rtx_bits > 0) == (name != "hpc"), rtx_bits
    assert int(s.trims) > 0
