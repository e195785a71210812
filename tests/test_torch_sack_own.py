"""The own-bit SACK forms of the port's tick against the reference tick.

``repro_torch.kernels.ops.sack_fused_own`` / ``sack_advance_own`` take
each row's own PSN offset and do, in one call, what the reference's tick
does around its dense kernels: ``_bit_plane`` and the ``_own_word`` test
before ``repro.kernels.ops.sack_fused`` / ``sack_advance``, and
``_clear_own_bit`` of the ACKed PSN after ``sack_fused``
(``repro/network/fabric.py``, sections 1 and 5). On the CPU their plain
versions are held bitwise against that composition, with the reference
kernel in interpret mode (``use_pallas=True``) and in its jnp form
(``use_pallas=False``), at W in {1, 3, 16, 32}, on random rows plus edge
rows. The CUDA kernels are held against the plain versions on a card by
``test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.network import fabric as jfab
from repro_torch.kernels import ops
from repro_torch.network import fabric as tf
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import fat_tree3

RNG = np.random.default_rng(1307)
WIDTHS = [1, 3, 16, 32]


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a))


def _rows(w):
    """(ring, base, rtx, off, ok, clear): random rows, then edge rows."""
    mp = 32 * w
    edge_off = [-1, 31, 32, mp, 0, mp - 1, 5, 40, -(2 ** 31), 2 ** 31 - 1]
    n = 64 + 3 * len(edge_off) + 8
    ring = RNG.integers(0, 2 ** 32, (n, w), dtype=np.uint64).astype(np.uint32)
    for i in range(0, n, 3):   # leading full words of every length
        ring[i, :i % (w + 1)] = 0xFFFFFFFF
    # sparse rows: few bits, so own bits are often new
    ring[1::4] &= RNG.integers(0, 2 ** 32, (ring[1::4].shape),
                               dtype=np.uint64).astype(np.uint32)
    base = RNG.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    base[::5] = 0xFFFFFFFF - RNG.integers(0, 64, base[::5].shape)
    rtx = RNG.integers(0, 2 ** 32, (n, w), dtype=np.uint64).astype(np.uint32)
    off = RNG.integers(-8, mp + 8, n).astype(np.int32)
    ok = RNG.integers(0, 4, n) > 0
    clear = RNG.integers(0, 4, n) > 0
    i = 64
    for o in edge_off:             # each edge offset with ok/clear on,
        off[i:i + 3] = o           # ok off, and clear off
        ok[i:i + 3] = [True, False, True]
        clear[i:i + 3] = [True, True, False]
        i += 3
    # ok false with an in-range off whose bit is clear
    ring[i, :] = 0
    off[i], ok[i], clear[i] = 3, False, True
    # clear with off - adv negative: a full first word advances >= 32
    ring[i + 1, 0], ring[i + 1, 1:] = 0xFFFFFFFF, 0
    off[i + 1], ok[i + 1], clear[i + 1] = 4, True, True
    ring[i + 2], off[i + 2], ok[i + 2] = 0, 0, True          # empty row
    ring[i + 3], off[i + 3], ok[i + 3] = 0xFFFFFFFF, 7, True  # full row
    ring[i + 4], off[i + 4], ok[i + 4] = 0xFFFFFFFF, 7, False
    # the own bit completes the prefix: the advance runs past it
    ring[i + 5, :] = 0xFFFFFFFF
    ring[i + 5, 0] = 0xFFFFFFFE
    off[i + 5], ok[i + 5], clear[i + 5] = 0, True, True
    base[i + 2:i + 6] = 0xFFFFFFFF - np.arange(4, dtype=np.uint32) * 3
    # the acked bit is set in rtx, so a clear shows
    rtx[np.arange(n), np.clip(off, 0, mp - 1) // 32] |= np.uint32(
        0xFFFFFFFF)
    return ring, base, rtx, off, ok, clear


def _reference_site(ring, base, rtx, off, ok, clear, use_pallas):
    """The reference tick's ACK site (fabric.py section 1) on rows whose
    PSN is base + off: with rtx, the fused kernel and the clear; without,
    the receiver's delivery site (section 5)."""
    w = ring.shape[1]
    ring, base = jnp.asarray(ring), jnp.asarray(base)
    off, ok = jnp.asarray(off), jnp.asarray(ok)
    rec = ok & (off >= 0) & (off < 32 * w)
    bit = jnp.uint32(1) << (off % 32).astype(jnp.uint32)
    already = rec & ((jfab._own_word(ring, off) & bit) != 0)
    mask = jfab._bit_plane(off, rec, w)
    if rtx is None:
        ring2, base2, adv = jops.sack_advance(ring | mask, base,
                                              use_pallas=use_pallas)
        return ring2, base2, adv, already
    ring2, base2, rtx2, adv = jops.sack_fused(ring, base, jnp.asarray(rtx),
                                              mask, use_pallas=use_pallas)
    psn = (base + off.astype(jnp.uint32)).astype(jnp.int32)
    ack_off = psn - base2.astype(jnp.int32)
    rtx2 = jfab._clear_own_bit(rtx2, ack_off, jnp.asarray(clear))
    return ring2, base2, rtx2, adv, already


def _assert_same(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("w", WIDTHS)
def test_sack_fused_own_matches_the_reference_ack_site(w):
    ring, base, rtx, off, ok, clear = _rows(w)
    got = ops.sack_fused_own(_t(ring), _t(base), _t(rtx), _t(off), _t(ok),
                             _t(clear))
    names = ("ring", "base", "rtx", "adv", "already")
    for up in (True, False):
        want = _reference_site(ring, base, rtx, off, ok, clear, up)
        _assert_same(got, want, [f"{n} pallas={up}" for n in names])
    # the edge rows did what they are there for
    already, adv = got[4].numpy(), got[3].numpy()
    assert already.any() and not already.all()
    assert (adv == 32 * w).any() and (adv == 0).any()


@pytest.mark.parametrize("w", WIDTHS)
def test_sack_advance_own_matches_the_reference_delivery_site(w):
    ring, base, _, off, ok, _ = _rows(w)
    got = ops.sack_advance_own(_t(ring), _t(base), _t(off), _t(ok))
    names = ("ring", "base", "adv", "already")
    for up in (True, False):
        want = _reference_site(ring, base, None, off, ok, None, up)
        _assert_same(got, want, [f"{n} pallas={up}" for n in names])


def test_the_tick_runs_the_own_forms_only(monkeypatch):
    """Each tick calls each own form once and the dense SACK forms never;
    the call counts are the CPU's view of ``ops.LAUNCHES``."""
    calls = {k: 0 for k in ("sack_fused", "sack_advance", "sack_fused_own",
                            "sack_advance_own")}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(ops, name, counted)
    g = fat_tree3(k=6, pods=3)
    wl = tf.Workload.of(list(range(27)), [(i + 9) % 27 for i in range(27)],
                        8, device="cpu")
    r = tf.simulate(g, wl, TransportProfile.ai_full(),
                    tf.SimParams(ticks=64, chunk_ticks=32), device="cpu")
    assert calls == {"sack_fused": 0, "sack_advance": 0,
                     "sack_fused_own": r.horizon,
                     "sack_advance_own": r.horizon}
