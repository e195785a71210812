"""The port's control plane against the reference, on the CPU: the PDC
state machines, PSN tracking's batch API, addressing, tag matching, TSS,
NSCC's batch API and DFC, the transport tour, and the state converters.

* Seeded parity: ``chip_smoke.control_inputs`` at a small size (two
  seeds) through every part of the port (``chip_smoke.run_control``) and
  of the reference (``scripts/torch_port_reference.py``'s
  ``jax_control``), every output lane bitwise, f32 included. The batches
  hold repeated slots, PDCs, members, peers and CCCs (up to 8 a CCC),
  posting-order and JobID ties, negative and past-the-end indices and
  uint32 values >= 2**31.
* The golden: the same parts at the golden's size against
  ``tests/golden/torch_port_control.npz`` (what ``chip_smoke.py`` phase 8
  holds the card to), and the tour against the JAX tour's values and
  printed lines.
* The index rules and their edges one by one (``core.scatter`` against
  ``.at[...]``), the ties and no-hit cases, and the reference's two
  properties the port reproduces or declines (the IV reuse on a repeated
  member; the carry of ``or_mask``'s additive mask).
* The twins of ``tests/test_messaging_window.py``,
  ``tests/test_fabric_batch.py``'s two ``record_rx`` tests and
  ``tests/test_resilience.py``'s PEER_DEAD test.
"""
import contextlib
import dataclasses
import importlib.util
import io
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import addressing as jaddr
from repro.core import matching as jmatching
from repro.core import pdc as jpdc
from repro.core import pds as jpds
from repro.core import tss as jtss
from repro.core.cms import nscc as jnscc
from repro.core.types import PDCState as JPDCState
from repro.core.types import Profile as JProfile
from repro_torch import convert
from repro_torch.core import (addressing, matching, messaging, pdc, pds,
                              scatter, tss)
from repro_torch.core.cms import nscc
from repro_torch.core.types import PDCState, Profile
from repro_torch.kernels import ops

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CPU = "cpu"
#: a small batch of every part (the JAX side's eager calls dominate)
TINY = {"psn_n": 64, "lanes": 256, "rounds": 3, "pdc_n": 128, "jobs": 4,
        "pids": 8, "ris": 4, "entries": 64, "arrivals": 48, "members": 32,
        "iv_lanes": 96, "iv_rounds": 4, "peers": 32, "cccs": 32}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    """``scripts/torch_port_reference.py`` (the JAX side's runner)."""
    return _load("torch_port_reference",
                 REPO / "scripts" / "torch_port_reference.py")


@pytest.fixture(scope="module")
def tour_mod():
    return _load("uet_transport_tour_torch",
                 REPO / "examples" / "uet_transport_tour_torch.py")


@pytest.fixture(scope="module")
def gold():
    return np.load(chip_smoke.CONTROL)


def i32(vals):
    return torch.tensor(vals, dtype=torch.int32)


def u32(vals):
    return torch.as_tensor(np.asarray(vals, np.uint64).astype(np.uint32)
                           .view(np.int32))


def _same(got, want, what=""):
    assert chip_smoke.same_bits(got, want), (what, np.asarray(got),
                                             np.asarray(want))


# ------------------------------------------------------- seeded parity --

@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("part", chip_smoke.CONTROL_PARTS)
def test_part_matches_reference_bitwise(reference, part, seed):
    inp = chip_smoke.control_inputs(TINY, seed=seed)
    got = chip_smoke.run_control(inp, TINY, CPU, parts=(part,))
    want = reference.jax_control(inp, TINY, chip_smoke.CONTROL_NSCC,
                                 parts=(part,))
    chip_smoke._control_vs(got, want, f"{part} seed {seed}")


def test_control_batches_hold_the_edges():
    """The seeded batches carry what the parity tests claim to cover."""
    inp = chip_smoke.control_inputs(TINY, seed=1)
    ccc = inp["nscc/ccc"]
    _, counts = np.unique(ccc[(ccc >= 0) & (ccc < TINY["cccs"])],
                          return_counts=True)
    assert counts.max() >= 3                       # order-sensitive f32
    assert (np.bincount(inp["tss/member0"][inp["tss/member0"] >= 0]) > 1).any()
    assert (inp["pdc/open_slot"] < 0).any()
    assert (inp["pdc/open_slot"] >= TINY["pdc_n"]).any()
    assert (inp["pdc/open_psn"] >= 2 ** 31).any()
    assert (inp["tss/close_last0"] == 0xFFFFFFFF).any()
    assert len(set(inp["addr/jobids"].tolist())) < len(inp["addr/jobids"])
    assert len(set(inp["match/seq"].tolist())) < inp["match/seq"].size
    assert (np.bincount(inp["match/slot"]) > 1).any()


# ------------------------------------------------------------- golden --

def test_golden_inputs_are_the_generators(gold):
    inp = chip_smoke.control_inputs(chip_smoke.CONTROL_GOLDEN)
    assert chip_smoke.control_digest(inp) == str(gold["inputs_sha256"])


@pytest.mark.parametrize("part", chip_smoke.CONTROL_PARTS)
def test_golden_size_batch_matches_the_golden(gold, part):
    size = chip_smoke.CONTROL_GOLDEN
    got = chip_smoke.run_control(chip_smoke.control_inputs(size), size, CPU,
                                 parts=(part,))
    want = {k[6:]: gold[k] for k in gold.files
            if k.startswith(f"batch/{part}/")}
    chip_smoke._control_vs(got, want, f"golden {part}")


def test_tour_matches_the_jax_tour(gold, reference, tour_mod):
    got = tour_mod.tour(device=CPU)
    want = reference.jax_tour()
    assert got == want
    for k, v in got.items():
        assert v == gold[f"tour/{k}"].tolist(), k


def test_tour_prints_the_jax_tours_lines(gold, reference, tour_mod):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tour_mod.main(["--device", CPU]) == 0
    lines = buf.getvalue().splitlines()
    assert lines == reference.jax_tour_lines()
    assert lines == gold["tour_lines"].tolist()


# ------------------------------------------------------ index rules --

IDX = np.asarray([3, -1, 0, 3, 9, -7, 2, 3, -5], np.int32)   # n = 5


@pytest.mark.parametrize("op", ["get", "set", "add", "fadd", "fmul",
                                "umax"])
def test_scatter_rules_match_at(op):
    """Negatives count from the end once, reads clamp, writes outside
    [0, n) drop, a repeated set keeps the last lane, f32 accumulates in
    lane order, uint32 max is unsigned — as ``x[idx]`` / ``.at[idx]``."""
    rng = np.random.default_rng(7)
    n = 5
    idx = IDX
    if op in ("fadd", "fmul"):
        x = rng.uniform(-1, 1, n).astype(np.float32)
        v = np.asarray([1e8, 1.0, 3.0, -1e8, 2.0, 5.0, 1e-8, 7.5, 1.5],
                       np.float32)
        if op == "fmul":
            v = np.asarray([3.3, 0.7, 1.9, 1.1, 2.0, 0.3, 1.7, 0.9, 1.3],
                           np.float32)
    elif op == "umax":
        x = np.asarray([0, 0x80000000, 5, 0xFFFFFFFF, 7], np.uint32)
        v = np.asarray([0x7FFFFFFF, 1, 0x80000001, 0xFFFFFFFE, 3, 0, 9,
                        0x90000000, 2], np.uint32)
    else:
        x = np.arange(n, dtype=np.int32) * 10
        v = np.arange(idx.size, dtype=np.int32) + 100
    jx, jidx, jv = jnp.asarray(x), jnp.asarray(idx), jnp.asarray(v)
    t = torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x)
    tv = torch.as_tensor(v.view(np.int32) if v.dtype == np.uint32 else v)
    ti = torch.as_tensor(idx)
    got, want = {
        "get": lambda: (scatter.gather(t, ti), jx[jidx]),
        "set": lambda: (scatter.set_last(t, ti, tv), jx.at[jidx].set(jv)),
        "add": lambda: (scatter.add_at(t, ti, tv), jx.at[jidx].add(jv)),
        "fadd": lambda: (scatter.add_at_ordered(t, ti, tv),
                         jx.at[jidx].add(jv)),
        "fmul": lambda: (scatter.mul_at_ordered(t, ti, tv),
                         jx.at[jidx].mul(jv)),
        "umax": lambda: (scatter.umax_at(t, ti, tv), jx.at[jidx].max(jv)),
    }[op]()
    _same(got.numpy(), np.asarray(want), op)


def test_f32_scatter_add_is_lane_order():
    """x + 1e8 + 1 - 1e8 is 0 in f32 in lane order, 1 in others."""
    x = torch.zeros(1)
    for v in ([1e8, 1.0, -1e8], [1e8, -1e8, 1.0], [-1e8, 1.0, 1e8]):
        got = scatter.add_at_ordered(x, torch.zeros(3, dtype=torch.int64),
                                     torch.tensor(v))
        want = jnp.zeros(1, jnp.float32).at[jnp.zeros(3, jnp.int32)].add(
            jnp.asarray(v, jnp.float32))
        _same(got.numpy(), np.asarray(want), v)


# -------------------------------------------------------- PDC / pool --

def test_on_ack_repeated_slot_keeps_last_and_adds():
    pool = pdc.open_pdc(pdc.PDCPool.create(4, device=CPU), 0, 7, 4)
    pool = pdc.on_ack(pool, i32([0, 0]), i32([5, 6]), i32([1, 1]))
    jpool = jpdc.open_pdc(jpdc.PDCPool.create(4), jnp.int32(0), jnp.int32(7),
                          jnp.uint32(4))
    jpool = jpdc.on_ack(jpool, jnp.asarray([0, 0]), jnp.asarray([5, 6]),
                        jnp.asarray([1, 1]))
    assert int(pool.remote_id[0]) == 6 and int(pool.unacked[0]) == -2
    for f in dataclasses.fields(pool):
        _same(getattr(pool, f.name).numpy(),
              np.asarray(getattr(jpool, f.name)), f.name)


def test_peer_dead_aborts_every_live_state_to_closed():
    """Twin of tests/test_resilience.py's PEER_DEAD test."""
    ev = torch.full((4,), int(pdc.InitEvent.PEER_DEAD), dtype=torch.int32)
    live = i32([int(PDCState.SYN), int(PDCState.ESTABLISHED),
                int(PDCState.QUIESCE), int(PDCState.ACK_WAIT)])
    np.testing.assert_array_equal(pdc.step_initiator(live, ev).numpy(),
                                  np.full(4, int(PDCState.CLOSED)))
    # CLOSED holds (self-loop): nothing to tear down
    closed = i32([int(PDCState.CLOSED)])
    assert int(pdc.step_initiator(closed, ev[:1])[0]) == int(PDCState.CLOSED)
    jev = jnp.full((4,), int(jpdc.InitEvent.PEER_DEAD), jnp.int32)
    jlive = jnp.asarray([int(JPDCState.SYN), int(JPDCState.ESTABLISHED),
                         int(JPDCState.QUIESCE), int(JPDCState.ACK_WAIT)],
                        jnp.int32)
    _same(pdc.step_initiator(live, ev).numpy(),
          np.asarray(jpdc.step_initiator(jlive, jev)))


def test_every_transition_of_both_tables_equals_the_reference():
    for mine, theirs, step, jstep in (
            (pdc.INIT_TABLE, jpdc.INIT_TABLE, pdc.step_initiator,
             jpdc.step_initiator),
            (pdc.TGT_TABLE, jpdc.TGT_TABLE, pdc.step_target,
             jpdc.step_target)):
        np.testing.assert_array_equal(mine, np.asarray(theirs))
        s, e = np.meshgrid(np.arange(-1, mine.shape[0] + 1),
                           np.arange(-1, mine.shape[1] + 1))
        s, e = s.ravel().astype(np.int32), e.ravel().astype(np.int32)
        _same(step(torch.as_tensor(s), torch.as_tensor(e)).numpy(),
              np.asarray(jstep(jnp.asarray(s), jnp.asarray(e))))


# ---------------------------------------------------------- addressing --

@pytest.mark.parametrize("slot", [0, 3, 4, -1, -4, -5, 9])
def test_register_job_slot_rules(slot):
    """Row writes wrap a negative slot once and drop one outside
    [-J, J); the RI block wraps once, then clamps to fit."""
    J, P, R = 4, 3, 2
    proc = np.arange(P, dtype=np.int32) + 1
    ris = np.arange(P * R, dtype=np.int32).reshape(P, R) + 10
    t = addressing.register_job(
        addressing.FEPTables.create(J, P, R, device=CPU), slot, 77,
        torch.as_tensor(proc), torch.as_tensor(ris))
    jt = jaddr.register_job(jaddr.FEPTables.create(J, P, R), slot, 77,
                            jnp.asarray(proc), jnp.asarray(ris))
    for f in dataclasses.fields(t):
        _same(getattr(t, f.name).numpy(), np.asarray(getattr(jt, f.name)),
              f.name)


def test_resolve_takes_the_first_row_of_a_repeated_jobid():
    ris = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    t = addressing.FEPTables.create(3, 2, 4, device=CPU)
    jt = jaddr.FEPTables.create(3, 2, 4)
    for slot, base in ((2, 100), (0, 200)):
        t = addressing.register_job(t, slot, 0x55, torch.arange(2),
                                    ris + base)
        jt = jaddr.register_job(jt, slot, 0x55, jnp.arange(2),
                                jnp.asarray(ris.numpy() + base))
    args = ([0x55, 0x55, 0x66], [1, 0, 0], [3, 2, 0], [1, 1, 1])
    ctx, ok = addressing.resolve(t, *(i32(a) for a in args))
    jctx, jok = jaddr.resolve(jt, *(jnp.asarray(a) for a in args))
    assert ctx.tolist()[:2] == [200 + 7, 200 + 2]    # row 0, not row 2
    _same(ctx.numpy(), np.asarray(jctx))
    _same(ok.numpy(), np.asarray(jok))


# ------------------------------------------------------------ matching --

@pytest.mark.parametrize("prof", list(Profile))
def test_match_ties_and_no_hit(prof):
    """Equal posting seqs and several exact hits take the first index;
    no hit gives slot -1 under every profile."""
    key = matching.encode_match_key(2, 9, 4)
    wild = matching.wildcard_mask(match_seq=False)
    rows = [(5, key, (0, 0), 3), (1, key, wild, 3), (2, key, (0, 0), 3),
            (6, key, wild, 1), (3, matching.encode_match_key(2, 9, 5),
                                (0, 0), 0)]
    q = matching.RecvQueue.create(8, device=CPU)
    jq = jmatching.RecvQueue.create(8)
    for slot, (kh, kl), (mh, ml), seq in rows:
        q = matching.post_receive(q, slot, kh, kl, mh, ml,
                                  matching.ANY_INITIATOR, seq, slot)
        jq = jmatching.post_receive(jq, slot, kh & 0xFFFFFFFF,
                                    kl & 0xFFFFFFFF, mh & 0xFFFFFFFF,
                                    ml & 0xFFFFFFFF, jmatching.ANY_INITIATOR,
                                    seq, slot)
    miss = matching.encode_match_key(3, 9, 4)
    khi = [key[0], miss[0], key[0]]
    klo = [key[1], miss[1], key[1] + 2]
    slot, ok = matching.match(q, i32(khi), i32(klo), i32([0, 0, 0]), prof)
    jslot, jok = jmatching.match(
        jq, jnp.asarray(np.asarray(khi, np.int64) % 2 ** 32, jnp.uint32),
        jnp.asarray(np.asarray(klo, np.int64) % 2 ** 32, jnp.uint32),
        jnp.zeros(3, jnp.uint32), JProfile(int(prof)))
    _same(slot.numpy(), np.asarray(jslot), "slot")
    _same(ok.numpy(), np.asarray(jok), "ok")
    assert int(slot[1]) == -1
    if prof == Profile.HPC:
        assert slot.tolist()[0] == 6     # seq 1 is the lowest
    elif prof == Profile.AI_FULL:
        assert slot.tolist()[0] == 2     # first exact hit


# ----------------------------------------------------------------- TSS --

def test_iv_reuse_on_a_repeated_member_is_the_references():
    """A property of the reference the port reproduces: every lane reads
    the counter before the add, so member 1 twice in one batch gets one
    IV twice under one key (ROADMAP.md queue 3)."""
    sd, hi, lo = tss.iv_for_packet(tss.SecureDomain.create(4, device=CPU),
                                   i32([1, 1, 2]))
    jsd, jhi, jlo = jtss.iv_for_packet(jtss.SecureDomain.create(4),
                                       jnp.asarray([1, 1, 2]))
    assert len(set(lo.tolist())) == 1
    assert sd.pkt_counter.tolist() == [0, 2, 1, 0]
    _same(lo.numpy(), np.asarray(jlo))
    _same(hi.numpy(), np.asarray(jhi))
    _same(sd.pkt_counter.numpy(), np.asarray(jsd.pkt_counter))


def test_psn_ratchet_is_unsigned_across_2_31_and_2_32():
    start = np.asarray([0x7FFFFFF0, 0x80000005, 0xFFFFFFF0, 3], np.uint32)
    peer = np.asarray([0, 0, 1, 2, 2, 3], np.int32)
    last = np.asarray([0x80000002, 0x7FFFFFFF, 0xFFFFFFFF, 0x80000000,
                       0x7FFFFFFE, 0xFFFFFFFE], np.uint32)
    g = tss.PSNGuard(u32(start), u32(start))
    jg = jtss.PSNGuard(jnp.asarray(start), jnp.asarray(start))
    g = tss.on_pdc_close(g, torch.as_tensor(peer), u32(last))
    jg = jtss.on_pdc_close(jg, jnp.asarray(peer), jnp.asarray(last))
    probe = np.asarray([0x80000003, 0x80000002, 0, 0xFFFFFFFF], np.uint32)
    ok, nack = tss.accept_new_pdc(g, torch.arange(4), u32(probe))
    jok, jnack = jtss.accept_new_pdc(jg, jnp.arange(4), jnp.asarray(probe))
    _same(g.expected_psn.numpy(), np.asarray(jg.expected_psn))
    _same(g.start_psn.numpy(), np.asarray(jg.start_psn))
    _same(ok.numpy(), np.asarray(jok))
    _same(nack.numpy(), np.asarray(jnack))


# ----------------------------------------------------------------- PDS --

def test_unique_rows_duplicates_or_here_and_carry_in_the_reference():
    """Outside ``unique_rows``' contract (two lanes at one bit with
    ``unique_rows=True``) the reference's additive mask carries into the
    next bit; the port ORs, which is the reference's general path
    (ROADMAP.md queue 3)."""
    args = ([0, 0, 1], [3, 3, 5], [True, True, True])
    t, fresh = pds.record_rx(pds.PSNTracker.create(2, 64, device=CPU),
                             i32(args[0]), u32(args[1]),
                             torch.tensor(args[2]), unique_rows=True)
    jargs = (jnp.asarray(args[0], jnp.int32), jnp.asarray(args[1], jnp.uint32),
             jnp.asarray(args[2]))
    general, jfresh = jpds.record_rx(jpds.PSNTracker.create(2, 64), *jargs)
    carried, _ = jpds.record_rx(jpds.PSNTracker.create(2, 64), *jargs,
                                unique_rows=True)
    _same(t.ring.numpy(), np.asarray(general.ring))
    _same(fresh.numpy(), np.asarray(jfresh))
    assert int(np.asarray(carried.ring)[0, 0]) == 1 << 4     # 2 x (1 << 3)
    assert int(t.ring[0, 0]) == 1 << 3


def test_record_rx_on_the_cpu_launches_no_kernel():
    before = dict(ops.LAUNCHES)
    t = pds.PSNTracker.create(4, 64, device=CPU)
    t, _ = pds.record_rx(t, i32([0, 1]), u32([0, 1]),
                         torch.ones(2, dtype=torch.bool))
    pds.or_mask(t.ring, i32([0]), i32([1]), torch.ones(1, dtype=torch.bool))
    pds.advance_cack(t)
    assert ops.LAUNCHES == before


def test_record_rx_duplicate_lanes_or_semantics():
    """Twin of tests/test_fabric_batch.py: duplicate (pdc, psn) lanes in
    one batch set the bit once and report both lanes accepted."""
    t = pds.PSNTracker.create(2, 64, device=CPU)
    t2, fresh = pds.record_rx(t, i32([0, 0, 0, 1]), u32([3, 3, 4, 3]),
                              torch.tensor([True, True, True, True]))
    assert fresh.tolist() == [True, True, True, True]
    assert int(t2.ring[0, 0]) == (1 << 3) | (1 << 4)
    assert int(t2.ring[1, 0]) == 1 << 3


def test_record_rx_unique_rows_fast_path_matches_general():
    """Twin of tests/test_fabric_batch.py: unique_rows=True agrees with
    the general path whenever the batch really is one-lane-per-PDC."""
    rng = np.random.default_rng(5)
    t = pds.PSNTracker.create(8, 128, device=CPU)
    pdc_ = torch.as_tensor(rng.permutation(8)[:6].astype(np.int32))
    psn = u32(rng.integers(0, 200, 6))  # some OOR
    valid = torch.tensor([True, True, False, True, True, True])
    a, fa = pds.record_rx(t, pdc_, psn, valid, unique_rows=True)
    b, fb = pds.record_rx(t, pdc_, psn, valid, unique_rows=False)
    assert torch.equal(fa, fb)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name))


# ----------------------------------------------------------- messaging --

def test_deferrable_window_pacing_both_branches():
    """Twin of tests/test_messaging_window.py: at/above BDP deferrable
    streams at line rate; below it every extra window pays the ack-wait
    stall."""
    link = messaging.LinkModel(alpha=1e-6, beta=2.5e-12)
    a, b = link.alpha, link.beta
    size = 1e6
    bdp = 2 * a / b  # 800 kB
    hi = messaging.deferrable_vs_rendezvous_bandwidth(
        size, link, eager_limit=16384.0, true_window=bdp)
    assert hi["deferrable"] == pytest.approx(size / (a + b * size))
    w = bdp / 8
    lo = messaging.deferrable_vs_rendezvous_bandwidth(
        size, link, eager_limit=16384.0, true_window=w)
    t_expect = a + b * size + (size / w - 1.0) * (2 * a - b * w)
    assert lo["deferrable"] == pytest.approx(size / t_expect)
    assert lo["deferrable"] < hi["deferrable"]
    mid = messaging.deferrable_vs_rendezvous_bandwidth(
        size, link, eager_limit=16384.0, true_window=bdp / 2)
    assert lo["deferrable"] < mid["deferrable"] <= hi["deferrable"]


def test_deferrable_beats_stale_rendezvous_when_window_tracks():
    """Twin of tests/test_messaging_window.py, and every value of the
    cost model ``==`` the reference's."""
    from repro.core import messaging as jmsg
    from repro.core.types import MsgProtocol as JMP
    link = messaging.LinkModel(alpha=1e-6, beta=2.5e-12)
    out = messaging.deferrable_vs_rendezvous_bandwidth(
        size=1e6, link=link, eager_limit=16384.0, true_window=1e6)
    assert out["deferrable"] > out["rendezvous"]
    jlink = jmsg.LinkModel(alpha=1e-6, beta=2.5e-12)
    for w in (1e4, 1e5, 8e5, 1e6):
        assert messaging.deferrable_vs_rendezvous_bandwidth(
            1e6, link, 16384.0, w) == jmsg.deferrable_vs_rendezvous_bandwidth(
            1e6, jlink, 16384.0, w)
    for proto in messaging.MsgProtocol:
        for ts, tr in ((5.0, 2.0), (2.0, 12.0), (3.0, 3.0 + 1e-6)):
            mine = messaging.simulate_protocol(proto, 1000.0, ts, tr, link,
                                               eager_limit=2000.0)
            theirs = jmsg.simulate_protocol(JMP(int(proto)), 1000.0, ts, tr,
                                            jlink, eager_limit=2000.0)
            assert dataclasses.astuple(mine) == dataclasses.astuple(theirs)


# ---------------------------------------------- converters and devices --

def _jax_states():
    rng = np.random.default_rng(3)
    t, _ = jpds.record_rx(jpds.PSNTracker.create(4, 64),
                          jnp.asarray([0, 1, 1], jnp.int32),
                          jnp.asarray([0, 2, 0xFFFFFFF0], jnp.uint32),
                          jnp.ones(3, bool))
    q = jmatching.post_receive(jmatching.RecvQueue.create(4), 1, 0x80000001,
                               7, 0, 0xFFFFFFFF, jmatching.ANY_INITIATOR, 3,
                               9)
    sd, _, _ = jtss.iv_for_packet(jtss.SecureDomain.create(4),
                                  jnp.asarray([1, 3]))
    p = jnscc.NSCCParams()
    return {
        pdc.PDCPool: jpdc.open_pdc(jpdc.PDCPool.create(4), jnp.int32(2),
                                   jnp.int32(5), jnp.uint32(0xFFFFFFFE)),
        pds.PSNTracker: t,
        addressing.FEPTables: jaddr.register_job(
            jaddr.FEPTables.create(2, 2, 2), 0, 9, jnp.arange(2),
            jnp.asarray(rng.integers(0, 9, (2, 2)), jnp.int32)),
        matching.RecvQueue: q,
        tss.SecureDomain: sd,
        tss.PSNGuard: jtss.on_pdc_close(jtss.PSNGuard.create(3),
                                        jnp.asarray([1]),
                                        jnp.asarray([0x90000000],
                                                    jnp.uint32)),
        nscc.NSCCState: jnscc.on_acks(jnscc.NSCCState.create(3, p), p,
                                      jnp.asarray([0, 0, 2]),
                                      jnp.asarray([True, False, False]),
                                      jnp.asarray([9.0, 3.0, 20.0],
                                                  jnp.float32),
                                      jnp.ones(3, bool)),
    }


@pytest.mark.parametrize("cls", list(convert.CONTROL_U32),
                         ids=lambda c: c.__name__)
def test_control_state_round_trip(cls):
    js = _jax_states()[cls]
    d = {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}
    port = convert.control_from_numpy(cls, d, CPU)
    assert type(port) is cls
    back = convert.control_to_numpy(port)
    assert set(back) == set(d)
    for k, v in d.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert back[k].tobytes() == v.tobytes(), k
    with pytest.raises(NotImplementedError):
        convert.control_from_numpy(cls, {**d, "bogus": np.zeros(1)}, CPU)


@pytest.mark.parametrize("make", [
    lambda: pds.PSNTracker.create(4, 64),
    lambda: pdc.PDCPool.create(4),
    lambda: addressing.FEPTables.create(2, 2, 2),
    lambda: matching.RecvQueue.create(4),
    lambda: tss.SecureDomain.create(4),
    lambda: tss.PSNGuard.create(4),
], ids=["PSNTracker", "PDCPool", "FEPTables", "RecvQueue", "SecureDomain",
        "PSNGuard"])
def test_constructors_default_to_cuda(make):
    """No device means ``cuda``: on a machine without one the constructor
    raises rather than run on the CPU."""
    if torch.cuda.is_available():
        state = make()
        leaves = [getattr(state, f.name) for f in dataclasses.fields(state)]
        assert all(x.device.type == "cuda" for x in leaves)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
