"""The port's twins of ``tests/test_link_tss.py``: the TSS security rules
(Sec. 3.4) of ``repro_torch.core.tss`` and the link layer's LLR / CBFC
models (Sec. 3.5) of ``repro_torch.core.link``, on the CPU, with the
reference test's assertions (and hypothesis settings) on the port's
values. The TSS twins also hold each key, IV and ratchet value against
the JAX function's, bitwise.
"""
import jax.numpy as jnp
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import link as jlink  # noqa: E402
from repro.core import tss as jtss  # noqa: E402
from repro_torch.core import link, tss  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def i32(vals):
    return torch.tensor(vals, dtype=torch.int32)


def _u(t: torch.Tensor) -> int:
    """A 0-d or 1-element int32 pattern as its unsigned value."""
    return int(t.reshape(-1)[0]) & 0xFFFFFFFF


# ------------------------------------------------------------------- TSS
def test_iv_uniqueness_across_members_and_packets():
    """Nonce discipline: (member, counter) pairs never produce the same
    (key, IV) pair — the AES-GCM reuse attack surface (Sec. 3.4.1)."""
    sd = tss.SecureDomain.create(8, device=CPU)
    jsd = jtss.SecureDomain.create(8)
    seen = set()
    for member in (0, 1, 2):
        key = _u(tss.source_key(sd, torch.tensor(member, dtype=torch.int32)))
        assert key == int(jtss.source_key(jsd, jnp.int32(member)))
        for _ in range(5):
            sd, hi, lo = tss.iv_for_packet(sd, torch.tensor(
                member, dtype=torch.int32))
            jsd, jhi, jlo = jtss.iv_for_packet(jsd, jnp.int32(member))
            tup = (key, _u(hi), _u(lo))
            assert tup == (key, int(jhi), int(jlo))
            assert tup not in seen
            seen.add(tup)


def test_key_rotation_lifetime():
    sd = tss.SecureDomain.create(2, device=CPU)
    assert not bool(tss.needs_key_rotation(sd)[0])
    sd = tss.SecureDomain(
        sd.sdk, sd.iv_mask, sd.epoch, sd.an,
        sd.pkt_counter, torch.full((2,), 2 ** 31 - 1, dtype=torch.int32))
    assert bool(tss.needs_key_rotation(sd).all())
    sd2 = tss.rotate_key(sd)
    assert int(sd2.an) == int(sd.an) + 1
    assert int(sd2.key_packets.sum()) == 0
    # derived keys change with AN
    zero = torch.tensor(0, dtype=torch.int32)
    assert _u(tss.source_key(sd, zero)) != _u(tss.source_key(sd2, zero))
    jsd2 = jtss.rotate_key(jtss.SecureDomain.create(2))
    assert _u(sd2.sdk) == int(jsd2.sdk)
    assert _u(tss.source_key(sd2, zero)) == int(
        jtss.source_key(jsd2, jnp.int32(0)))


def test_zero_rtt_psn_antireplay():
    """Sec. 3.4.2 scheme 2: after a close at PSN p, any replayed open with
    PSN <= p is NACK'd with the PSN to use; fresh opens are zero-RTT."""
    g = tss.PSNGuard.create(4, device=CPU)
    ok, _ = tss.accept_new_pdc(g, i32([1]), i32([0]))
    assert bool(ok[0])  # initial state accepts (optimistic)
    g = tss.on_pdc_close(g, i32([1]), i32([41]))
    ok, nack = tss.accept_new_pdc(g, i32([1]), i32([41]))
    assert not bool(ok[0]) and int(nack[0]) == 42  # replay rejected
    ok, _ = tss.accept_new_pdc(g, i32([1]), i32([42]))
    assert bool(ok[0])  # ratcheted source reopens with zero RTT


def test_trimmed_packets_never_create_pdcs():
    assert tss.trimmed_packet_may_create_pdc() is False


def test_pdc_close_before_psn_wrap():
    assert not bool(tss.pdc_must_close(torch.tensor(1000, dtype=torch.int32)))
    assert bool(tss.pdc_must_close(torch.tensor(2 ** 31 - 1,
                                                dtype=torch.int32)))


# ------------------------------------------------------------------- LLR
def test_llr_go_back_n_recovers_corruption():
    lk = link.LLRLink(replay_capacity=16, timeout=8)
    sent = [lk.send() for _ in range(10)]
    # frame 4 corrupted on the wire; receiver NACKs at the gap
    delivered = link.llr_deliver(sent, corrupt={4})
    assert delivered == [0, 1, 2, 3]
    lk.on_ack(3)
    resend = lk.on_nack(4)
    assert resend[0] == 4 and resend[-1] == 9
    delivered += link.llr_deliver(resend, corrupt=set(), expected=4)
    assert delivered == list(range(10))
    assert lk.retransmissions == 6  # go-back-N cost, fine at link RTT


def test_llr_timeout_recovers_tail_loss():
    lk = link.LLRLink(replay_capacity=8, timeout=4)
    lk.send()
    lk.send()
    resent = []
    for _ in range(10):
        resent += lk.tick()
    assert resent[:2] == [0, 1]  # tail loss recovered by timeout
    lk.on_ack(1)
    assert lk.in_flight() == 0


def test_llr_replay_buffer_bounded():
    lk = link.LLRLink(replay_capacity=4)
    for _ in range(4):
        lk.send()
    assert not lk.can_send()
    lk.on_ack(0)
    assert lk.can_send()


# ------------------------------------------------------------------ CBFC
@given(st.lists(st.tuples(st.booleans(), st.integers(1, 9000)),
                min_size=1, max_size=200))
@settings(max_examples=30, deadline=None)
def test_cbfc_never_overruns_buffer(ops):
    """Property: under any send/drain interleaving, occupancy stays within
    the advertised buffer — CBFC's losslessness guarantee."""
    st_ = link.CBFCState(buffer_bytes=32768)
    occupancy = 0
    for is_send, size in ops:
        if is_send and st_.can_send(size):
            st_ = st_.send(size)
            occupancy += size
        elif not is_send and occupancy >= size:
            st_ = st_.drain(size)
            occupancy -= size
        assert 0 <= occupancy <= 32768
        assert st_.available() == 32768 - occupancy


def test_cbfc_counter_wraparound():
    st_ = link.CBFCState(buffer_bytes=4096, consumed=link.CTR_MOD - 100,
                         freed=link.CTR_MOD - 100)
    assert st_.available() == 4096
    st_ = st_.send(1000)       # wraps the 20-bit counter
    assert st_.available() == 3096
    st_ = st_.drain(1000)
    assert st_.available() == 4096


def test_cbfc_beats_pfc_buffer_requirement():
    """Sec. 3.5.2 claim (1): CBFC needs less buffer than PFC headroom for
    lossless operation (2 active VCs vs 8 PFC priorities, 100 m links)."""
    pfc = link.pfc_headroom_bytes(link_gbps=400, cable_m=100, mtu=4096)
    cbfc = link.cbfc_buffer_bytes(link_gbps=400, cable_m=100, mtu=4096)
    assert cbfc < pfc / 2
    assert (pfc, cbfc) == (
        jlink.pfc_headroom_bytes(link_gbps=400, cable_m=100, mtu=4096),
        jlink.cbfc_buffer_bytes(link_gbps=400, cable_m=100, mtu=4096))
