"""The port's twins of ``tests/test_uet_core.py``: headers, addressing,
matching, the messaging cost model, the PDC state machine, PSN/SACK
tracking and DFC, on the CPU, with the reference test's assertions (and
its hypothesis settings) on the port's values. Where a twin's values
come from a tensor, it also holds them against the JAX function's on
the same inputs, bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import pdc as jpdc  # noqa: E402
from repro.core import pds as jpds  # noqa: E402
from repro_torch.core import (addressing, headers, matching,  # noqa: E402
                              messaging, pdc, pds)
from repro_torch.core.types import (MsgProtocol, Profile,  # noqa: E402
                                    TransportMode, UET_UDP_PORT)

torch.set_num_threads(1)
CPU = "cpu"


def i32(vals):
    return torch.tensor(vals, dtype=torch.int32)


def u32(vals):
    """uint32 values as the port's int32 patterns."""
    return torch.as_tensor(np.asarray(vals, np.uint64).astype(np.uint32)
                           .view(np.int32))


# ---------------------------------------------------------------- headers
def test_uet_udp_port_is_rocev2_plus_two_and_prime():
    assert UET_UDP_PORT == 4793 == 4791 + 2
    assert all(UET_UDP_PORT % k for k in range(2, int(4793 ** 0.5) + 1))


def test_header_byte_model_matches_spec_table():
    """Sec. 3.2.2: PDS 12B RUD/ROD (16 w/ RCCC), 8B RUDI, 4B UUD; SES
    44/32/20B; TSS 12B (+16B ICV); Ethernet 14+4."""
    h = headers.HeaderConfig()  # RUD / UDP / IPv4 / SES std
    assert h.overhead_bytes() == 14 + 4 + 20 + 8 + 12 + 44
    rcc = headers.HeaderConfig(rccc=True)
    assert rcc.overhead_bytes() - h.overhead_bytes() == 4
    uud = headers.HeaderConfig(mode=TransportMode.UUD,
                               ses=headers.SES_HEADER_MIN)
    assert uud.overhead_bytes() == 14 + 4 + 20 + 8 + 4 + 20
    rudi = headers.HeaderConfig(mode=TransportMode.RUDI,
                                ses=headers.SES_HEADER_MIN)
    assert rudi.overhead_bytes() - uud.overhead_bytes() == 4
    tss = headers.HeaderConfig(tss=True)
    assert tss.overhead_bytes() - h.overhead_bytes() == 12 + 16
    native = headers.HeaderConfig(native_ip=True)
    assert h.overhead_bytes() - native.overhead_bytes() == 4  # 8B UDP -> 4B EV
    crc = headers.HeaderConfig(e2e_crc=True)
    assert crc.overhead_bytes() - h.overhead_bytes() == 4


@given(payload=st.integers(min_value=64, max_value=9000))
def test_header_efficiency_monotone(payload):
    h = headers.HeaderConfig()
    assert 0 < h.efficiency(payload) < 1
    assert h.efficiency(payload + 64) > h.efficiency(payload)


# ------------------------------------------------------------- addressing
def test_relative_addressing_resolves_and_authorizes():
    t = addressing.FEPTables.create(num_jobs=4, procs_per_job=8,
                                    ris_per_proc=4, device=CPU)
    ris = torch.arange(8 * 4, dtype=torch.int32).reshape(8, 4) + 100
    t = addressing.register_job(t, 1, jobid=0xABCDE,
                                proc_ids=torch.arange(8), ri_contexts=ris)
    ctx, ok = addressing.resolve(
        t,
        jobid=i32([0xABCDE, 0xABCDE, 0xDEAD]),
        pid_on_fep=i32([3, 99, 0]),
        ri=i32([2, 0, 0]),
        rel=i32([1, 1, 1]))
    assert bool(ok[0]) and int(ctx[0]) == 100 + 3 * 4 + 2
    assert not bool(ok[1])   # PIDonFEP out of range
    assert not bool(ok[2])   # unknown JobID => unauthorized
    assert int(ctx[1]) == -1 and int(ctx[2]) == -1


def test_absolute_addressing_service_table():
    t = addressing.FEPTables.create(2, 2, 2, num_services=16, device=CPU)
    svc = t.service_table.clone()
    svc[5] = 777
    t = addressing.FEPTables(t.jobid_keys, t.jobid_to_pid, t.pid_table,
                             t.ri_table, svc)
    ctx, ok = addressing.resolve(t, jobid=i32([0]), pid_on_fep=i32([5]),
                                 ri=i32([0]), rel=i32([0]))
    assert bool(ok[0]) and int(ctx[0]) == 777


def test_directory_scaling_claim():
    """Sec. 3.1.1: relative addressing stores N entries, not N*P."""
    assert addressing.directory_entries(10_000, 1000, relative=True) == 10_000
    assert addressing.directory_entries(10_000, 1000,
                                        relative=False) == 10_000_000


# ---------------------------------------------------------------- matching
def test_exact_match_and_consume():
    q = matching.RecvQueue.create(8, device=CPU)
    hi, lo = matching.encode_match_key(3, 42, 7)
    q = matching.post_receive(q, 0, hi, lo, 0, 0, matching.ANY_INITIATOR,
                              seq=0, buffer_id=11)
    slot, ok = matching.match(q, i32([hi]), i32([lo]), i32([1]),
                              Profile.AI_FULL)
    assert bool(ok[0]) and int(slot[0]) == 0
    q = matching.consume(q, slot[0], ok[0])
    slot2, ok2 = matching.match(q, i32([hi]), i32([lo]), i32([1]),
                                Profile.AI_FULL)
    assert not bool(ok2[0])  # consumed => unexpected now


def test_hpc_wildcard_in_order():
    """HPC: lowest posting order wins among wildcard matches."""
    q = matching.RecvQueue.create(8, device=CPU)
    mh, ml = matching.wildcard_mask(match_tag=False, match_seq=False)
    bh, bl = matching.encode_match_key(1, 0, 0)
    q = matching.post_receive(q, 3, bh, bl, mh, ml, matching.ANY_INITIATOR,
                              seq=5, buffer_id=1)
    q = matching.post_receive(q, 1, bh, bl, mh, ml, matching.ANY_INITIATOR,
                              seq=2, buffer_id=2)
    th, tl = matching.encode_match_key(1, 77, 9)
    slot, ok = matching.match(q, i32([th]), i32([tl]), i32([0]),
                              Profile.HPC)
    assert bool(ok[0]) and int(slot[0]) == 1  # seq=2 posted earlier


def test_ai_full_rejects_wildcards():
    q = matching.RecvQueue.create(4, device=CPU)
    mh, ml = matching.wildcard_mask(match_tag=False)
    bh, bl = matching.encode_match_key(1, 0, 0)
    q = matching.post_receive(q, 0, bh, bl, mh, ml, matching.ANY_INITIATOR,
                              0, 1)
    th, tl = matching.encode_match_key(1, 5, 0)
    _, ok = matching.match(q, i32([th]), i32([tl]), i32([0]),
                           Profile.AI_FULL)
    assert not bool(ok[0])


@given(comm=st.integers(0, 0xFFFF), tag=st.integers(0, 0xFFFFFF),
       seq=st.integers(0, 0xFFFFFF))
@settings(max_examples=50)
def test_match_key_roundtrip_distinct(comm, tag, seq):
    """The in-order-over-unordered trick (Sec. 3.2.1): distinct message
    seqs produce distinct keys, so unordered RUD still fills in order."""
    hi1, lo1 = matching.encode_match_key(comm, tag, seq)
    hi2, lo2 = matching.encode_match_key(comm, tag, (seq + 1) & 0xFFFFFF)
    assert (hi1, lo1) != (hi2, lo2)


# -------------------------------------------------------------- messaging
@pytest.mark.parametrize("proto", list(MsgProtocol))
@pytest.mark.parametrize("expected", [True, False])
def test_completion_time_table(proto, expected):
    """Sec. 3.1.3 table: playout equals the alpha/beta model for all six
    (protocol x expectedness) cells."""
    link = messaging.LinkModel(alpha=2.0, beta=0.05)
    size = 400.0
    ts, tr = (10.0, 4.0) if expected else (4.0, 30.0)
    model = messaging.model_completion(proto, expected, size, ts, tr, link)
    sim = messaging.simulate_protocol(proto, size, ts, tr, link,
                                      eager_limit=1000.0)
    assert abs(model - sim.receiver_complete) < 1e-9


def test_receiver_initiated_extra_rtt():
    """AI Base pays +2 alpha in the expected case vs rendezvous."""
    link = messaging.LinkModel(alpha=3.0, beta=0.01)
    r = messaging.model_completion(MsgProtocol.RENDEZVOUS, True, 100, 0, 0,
                                   link)
    ri = messaging.model_completion(MsgProtocol.RECEIVER_INITIATED, True,
                                    100, 0, 0, link)
    assert ri - r == pytest.approx(2 * link.alpha)


def test_deferrable_tracks_window():
    out = messaging.deferrable_vs_rendezvous_bandwidth(
        size=1e6, link=messaging.LinkModel(alpha=1e-6, beta=2.5e-12),
        eager_limit=16384.0, true_window=1e6)
    assert out["deferrable"] > out["rendezvous"]


# ------------------------------------------------------------------- PDC
def test_pdc_fig6_scenario():
    """Fig. 6: open -> full-rate during SYN -> establish on first ACK ->
    quiesce -> drain -> close."""
    pool = pdc.PDCPool.create(4, device=CPU)
    pool = pdc.open_pdc(pool, 0, 7, 4)
    assert int(pool.state[0]) == pdc.PDCState.SYN
    assert bool(pdc.may_send_data(pool.state)[0])  # full rate during SYN!
    pool = pdc.on_ack(pool, 0, 19, 1)
    assert int(pool.state[0]) == pdc.PDCState.ESTABLISHED
    assert int(pool.remote_id[0]) == 19
    st_ = pdc.step_initiator(pool.state[:1],
                             i32([int(pdc.InitEvent.CLOSE_REQ)]))
    assert int(st_[0]) == pdc.PDCState.QUIESCE
    assert not bool(pdc.may_accept_new_message(st_)[0])
    st_ = pdc.step_initiator(st_, i32([int(pdc.InitEvent.DRAINED)]))
    assert int(st_[0]) == pdc.PDCState.ACK_WAIT
    st_ = pdc.step_initiator(st_, i32([int(pdc.InitEvent.CLOSE_ACK)]))
    assert int(st_[0]) == pdc.PDCState.CLOSED


def test_pdc_target_machine():
    st_ = i32([int(pdc.PDCState.CLOSED)])
    st_ = pdc.step_target(st_, i32([int(pdc.TgtEvent.RX_SYN)]))
    assert int(st_[0]) == pdc.PDCState.SYN
    st_ = pdc.step_target(st_, i32([int(pdc.TgtEvent.RX_NOSYN)]))
    assert int(st_[0]) == pdc.PDCState.ESTABLISHED
    st_ = pdc.step_target(st_, i32([int(pdc.TgtEvent.RX_CLOSE)]))
    assert int(st_[0]) == pdc.PDCState.CLOSED


def test_pdc_secure_pending_path():
    """Sec. 3.4.2: secure PSN establishment goes through PENDING."""
    st_ = i32([int(pdc.PDCState.CLOSED)])
    st_ = pdc.step_target(st_, i32([int(pdc.TgtEvent.SECURE_PENDING)]))
    assert int(st_[0]) == pdc.PDCState.PENDING
    st_ = pdc.step_target(st_, i32([int(pdc.TgtEvent.SECURE_OK)]))
    assert int(st_[0]) == pdc.PDCState.SYN
    np.testing.assert_array_equal(pdc.TGT_TABLE, np.asarray(jpdc.TGT_TABLE))
    np.testing.assert_array_equal(pdc.INIT_TABLE,
                                  np.asarray(jpdc.INIT_TABLE))


# ---------------------------------------------------------------- PSN/SACK
@given(st.lists(st.integers(0, 255), min_size=1, max_size=64, unique=True))
@settings(max_examples=40, deadline=None)
def test_psn_tracker_property(psns):
    """Property: after receiving an arbitrary PSN set, CACK advances to
    exactly the first gap, and every received PSN is marked."""
    t = pds.PSNTracker.create(1, 256, device=CPU)
    t, fresh = pds.record_rx(t, torch.zeros(len(psns), dtype=torch.int32),
                             u32(psns), torch.ones(len(psns), dtype=torch.bool))
    assert bool(fresh.all())
    t, adv = pds.advance_cack(t)
    expect = 0
    s = set(psns)
    while expect in s:
        expect += 1
    assert int(t.base[0]) == expect
    assert int(adv[0]) == expect


def test_mp_range_rejection():
    """Sec. 3.2.5: PSNs beyond MP_RANGE are not accepted — receiver
    resource protection."""
    t = pds.PSNTracker.create(1, 64, device=CPU)
    t, fresh = pds.record_rx(t, i32([0, 0]), u32([63, 64]),
                             torch.ones(2, dtype=torch.bool))
    assert bool(fresh[0]) and not bool(fresh[1])
    assert int(t.oor[0]) == 1


def test_duplicate_detection():
    t = pds.PSNTracker.create(1, 64, device=CPU)
    one = u32([5])
    t, f1 = pds.record_rx(t, i32([0]), one, torch.ones(1, dtype=torch.bool))
    t, f2 = pds.record_rx(t, i32([0]), one, torch.ones(1, dtype=torch.bool))
    assert bool(f1[0]) and not bool(f2[0])
    assert int(t.dup[0]) == 1


def test_sack_view_and_ooo():
    t = pds.PSNTracker.create(1, 128, device=CPU)
    jt = jpds.PSNTracker.create(1, 128)
    for p in (0, 1, 5, 9):
        t, _ = pds.record_rx(t, i32([0]), u32([p]),
                             torch.ones(1, dtype=torch.bool))
        jt, _ = jpds.record_rx(jt, jnp.array([0], jnp.int32),
                               jnp.array([p], jnp.uint32), jnp.ones(1, bool))
    t, adv = pds.advance_cack(t)
    jt, _ = jpds.advance_cack(jt)
    assert int(adv[0]) == 2
    cack, lo, hi = pds.sack_view(t)
    assert int(cack[0]) == 2
    # bits now at offsets 3 (psn 5) and 7 (psn 9)
    assert int(lo[0]) == (1 << 3) | (1 << 7)
    assert int(pds.ooo_distance(t)[0]) == 8
    for got, want in zip((cack, lo, hi), jpds.sack_view(jt)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))


# ------------------------------------------------------------------- DFC
def test_dfc_scales_rccc_credit_rate():
    """Sec. 3.3.4: Destination Flow Control throttles senders below what
    the network could deliver — RCCC grants scale by the destination's
    absorption rate."""
    from repro_torch.core.cms import rccc as R
    st_ = R.RCCCState.create(4, initial_credit=0.0, device=CPU)
    st_ = R.mark_seen(st_, torch.arange(4, dtype=torch.int32),
                      torch.ones(4, dtype=torch.bool))
    dst = i32([0, 0, 1, 1])
    active = torch.ones(4, dtype=torch.bool)
    # destination 1 can only absorb half rate (memory pressure)
    dfc = torch.tensor([1.0, 0.5], dtype=torch.float32)
    st_ = R.grant_credits(st_, dst, active, num_hosts=2, rate=1.0, dfc=dfc)
    np.testing.assert_allclose(st_.balance.numpy(), [0.5, 0.5, 0.25, 0.25],
                               atol=1e-6)


def test_dfc_nscc_window_penalty():
    """Sec. 3.3.4 NSCC path: the receiver's window penalty scales the
    sender's congestion window."""
    from repro.core.cms import nscc as JN
    from repro_torch.core.cms import nscc as N
    params = N.NSCCParams()
    st_ = N.NSCCState.create(4, params, device=CPU)
    st2 = N.apply_dfc_penalty(st_, params, i32([1, 2]),
                              torch.tensor([0.5, 0.25], dtype=torch.float32),
                              torch.ones(2, dtype=torch.bool))
    np.testing.assert_allclose(st2.cwnd.numpy(), [64.0, 32.0, 48.0, 64.0],
                               atol=1e-4)
    jp = JN.NSCCParams()
    jst = JN.apply_dfc_penalty(JN.NSCCState.create(4, jp), jp,
                               jnp.array([1, 2]),
                               jnp.array([0.5, 0.25], jnp.float32),
                               jnp.ones(2, bool))
    np.testing.assert_array_equal(st2.cwnd.numpy(), np.asarray(jst.cwnd))
