"""The port's switch-resident reduction contexts (``repro_torch.core.inc``)
against the reference's ``repro.core.inc``, on the CPU, bitwise.

``process`` is held on seeded random lanes built so that every branch
of the reference is taken, and each branch is counted with the
reference's own dense formulas before the two are compared: the same
flow twice in a tick, two PSNs on one slot (the higher owns it), a
stale PSN, a child bit already set, a PSN that recycles a slot, a flow
that already has a delivery ACK, a group wider than the bitmap word, and
in-tick arrival order deciding the emitter. B = 2 scenarios with
different groups go through one port call against two reference calls,
and the state is carried over several ticks. ``member_ranks`` (a stable
sort in place of the [F, F] pass) is held on large and sparse group ids
with both gate forms, and nothing in ``repro_torch/core/inc.py`` builds
an [n, n] temporary (every tensor it makes is smaller than one [Q, Q] plane).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inc as jinc
from repro_torch.core import inc

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _u32(a):
    return np.asarray(a).astype(np.uint32).view(np.int32)


def _ref(st_psn, st_bits, lanes, ranks, red, has_d):
    """The reference's process on one scenario -> numpy (psn, bits as
    int32 patterns, absorb, emit)."""
    member, rank, gsz = ranks
    st = jinc.INCState(slot_psn=jnp.asarray(st_psn),
                       slot_bits=jnp.asarray(st_bits.view(np.uint32)))
    st2, absorb, emit = jinc.process(
        st, lane_flow=jnp.asarray(lanes[0]), lane_psn=jnp.asarray(lanes[1]),
        lane_cand=jnp.asarray(lanes[2]), member=member, rank=rank, gsz=gsz,
        red=jnp.asarray(red), has_delivery=jnp.asarray(has_d))
    return (np.asarray(st2.slot_psn), _u32(st2.slot_bits),
            np.asarray(absorb), np.asarray(emit))


def _branches(st_psn, st_bits, lanes, ranks, red, has_d) -> dict:
    """How many lanes take each branch of the reference's process, by its
    own dense formulas (numpy)."""
    flow, psn, cand = (np.asarray(x) for x in lanes)
    member, rank, gsz = (np.asarray(x) for x in ranks)
    a = st_psn.shape[1]
    m = cand & member[flow] & (gsz[flow] <= jinc.MAX_FANIN)
    g = np.where(m, red[flow], 0)
    slot = np.where(psn >= 0, psn, 0) % a
    cur_psn = st_psn[np.clip(g, 0, st_psn.shape[0] - 1), slot]
    cur_bits = st_bits.view(np.uint32)[np.clip(g, 0, st_psn.shape[0] - 1),
                                       slot]
    fresh = psn > cur_psn
    eff = np.where(fresh, 0, cur_bits).astype(np.uint32)
    bit = np.uint32(1) << np.clip(rank[flow], 0, 31).astype(np.uint32)
    already = (eff & bit) != 0
    stale = m & (psn < cur_psn)
    usable = m & ~stale & ~already & ~has_d[flow]
    lane = np.arange(flow.size)
    samef = ((flow[None, :] == flow[:, None]) & usable[None, :]
             & (lane[None, :] < lane[:, None])).any(1)
    ok = usable & ~samef
    key = np.where(ok, g * a + slot, -1)
    beaten = ok & ((key[None, :] == key[:, None]) & ok[None, :]
                   & (psn[None, :] > psn[:, None])).any(1)
    return {"wide": int((cand & member[flow]
                         & (gsz[flow] > jinc.MAX_FANIN)).sum()),
            "fresh": int((m & fresh & (cur_psn >= 0)).sum()),
            "stale": int(stale.sum()), "already": int((m & already).sum()),
            "has_delivery": int((m & has_d[flow]).sum()),
            "same_flow": int((usable & samef).sum()),
            "beaten": int(beaten.sum())}


def _scenario(rng, F=48, Q=96, G=48, A=8, groups=12, wide=False):
    """One random scenario: group ids in [0, groups) (or one group of 40
    members with ``wide``), a pre-filled state and lanes on few PSNs so
    that slots collide."""
    red = rng.integers(-1, groups, F).astype(np.int32)
    cross = rng.random(F) < 0.85
    if wide:
        red[:40] = groups
        cross[:40] = True
    lanes = (rng.integers(0, F, Q).astype(np.int32),
             rng.integers(-1, 24, Q).astype(np.int32),
             rng.random(Q) < 0.8)
    st_psn = rng.integers(-1, 20, (G, A)).astype(np.int32)
    st_bits = _u32(np.bitwise_and.reduce(
        rng.integers(0, 2 ** 32, (3, G, A), dtype=np.uint64)))
    has_d = rng.random(F) < 0.1
    return red, cross, lanes, st_psn, st_bits, has_d


def _port_ranks(reds, crosses, allowed=None):
    return inc.member_ranks(_t(np.stack(reds)), _t(np.stack(crosses)),
                            None if allowed is None else _t(allowed))


def _check_batch(scen, allowed=None) -> "list[dict]":
    """Port process over the scenarios as one [B] call against the
    reference per scenario; returns each scenario's branch counts."""
    reds, crosses, lanes, psns, bits, hds = zip(*scen)
    member, rank, gsz = _port_ranks(reds, crosses, allowed)
    st = inc.INCState(slot_psn=_t(np.stack(psns)),
                      slot_bits=_t(np.stack(bits)))
    st2, absorb, emit = inc.process(
        st, lane_flow=_t(np.stack([x[0] for x in lanes])),
        lane_psn=_t(np.stack([x[1] for x in lanes])),
        lane_cand=_t(np.stack([x[2] for x in lanes])),
        member=member, rank=rank, gsz=gsz, red=_t(np.stack(reds)),
        has_delivery=_t(np.stack(hds)))
    counts = []
    for b, (red, cross, ln, sp, sb, hd) in enumerate(scen):
        jr = jinc.member_ranks(jnp.asarray(red), jnp.asarray(cross),
                               None if allowed is None
                               else jnp.asarray(allowed))
        for x, y in zip((member, rank, gsz), jr):
            np.testing.assert_array_equal(x[b].numpy(), np.asarray(y))
        want = _ref(sp, sb, ln, jr, red, hd)
        got = (st2.slot_psn[b].numpy(), st2.slot_bits[b].numpy(),
               absorb[b].numpy(), emit[b].numpy())
        for name, x, y in zip(("slot_psn", "slot_bits", "absorb", "emit"),
                              got, want):
            np.testing.assert_array_equal(x, y, err_msg=f"{b} {name}")
        counts.append(dict(_branches(sp, sb, ln, jr, red, hd),
                           absorb=int(want[2].sum()),
                           emit=int(want[3].sum())))
    return counts


def _every_branch():
    """One hand-built scenario that takes every branch (lane by lane):
    L0 a child bit already set, L1 beaten by a higher PSN on its slot,
    L2 its flow's second usable lane, L3 a stale PSN, L4-L5 a higher PSN
    recycling a slot and absorbed in arrival order, L6 absorbed into a
    free slot, L7 a flow with a delivery this tick, L8 the bitmap's last
    child (emitted), L9 no group, L10 a same-leaf member, L11 not a
    candidate."""
    F, Q, A = 48, 96, 8        # the random scenarios' shapes
    red = np.full(F, -1, np.int32)
    red[:12] = [0, 0, 0, 0, 1, 1, -1, 2, 3, 3, 3, 3]
    cross = np.arange(F) != 7
    st_psn = np.full((F, A), -1, np.int32)
    st_bits = np.zeros((F, A), np.int32)
    st_psn[0, 5:7] = 5, 10
    st_bits[0, 5] = 1                    # flow 0 (rank 0) has PSN 5
    st_psn[3, 0] = 8
    st_bits[3, 0] = 0b1110               # flows 9-11 have PSN 8
    flow = np.zeros(Q, np.int32)
    psn = np.zeros(Q, np.int32)
    flow[:12] = [0, 1, 1, 2, 2, 3, 4, 5, 8, 6, 7, 9]
    psn[:12] = [5, 5, 4, 6, 13, 13, 3, 3, 8, 2, 2, 7]
    cand = np.arange(Q) < 11
    has_d = np.arange(F) == 5
    return red, cross, (flow, psn, cand), st_psn, st_bits, has_d


def test_process_matches_reference_on_every_branch():
    counts = _check_batch([_every_branch()])[0]
    assert counts.pop("wide") == 0          # test_oversized_group_...
    assert all(v > 0 for v in counts.values()), counts
    assert counts["absorb"] == 3 and counts["emit"] == 1, counts


@pytest.mark.parametrize("seed", range(6))
def test_process_matches_reference_random(seed):
    """Random lanes on few PSNs (slots collide, flows repeat), states
    with set bits and owned slots, odd seeds with a 40-member group."""
    rng = np.random.default_rng(1800 + seed)
    counts = _check_batch([_scenario(rng, wide=seed % 2 == 1)])[0]
    assert counts["absorb"] + counts["emit"] > 0, counts
    assert (counts["wide"] > 0) == (seed % 2 == 1), counts


def test_process_two_scenarios_with_different_groups():
    """B = 3 in one port call (the hand-built scenario between two
    random ones): the scenario offsets of every gather and scatter (flow
    rows, slot cells) keep each scenario on its own rows."""
    rng = np.random.default_rng(7)
    a = _scenario(rng, groups=3)
    b = _scenario(rng, groups=9, wide=True)
    counts = _check_batch([a, _every_branch(), b])
    assert all(c["absorb"] for c in counts), counts


@pytest.mark.parametrize("gate", ["flow", "scenario"])
def test_process_over_ticks_with_a_gate(gate):
    """The state carried over 12 ticks of a tree reduce into one parent:
    PSNs advance and recycle slots, some children retransmit, and a
    gate (RUD-only flows) takes members out, as [F] and as [B, F]."""
    rng = np.random.default_rng(11)
    F, A = 24, 4
    red = np.where(np.arange(F) < 20, np.arange(F) % 3, -1).astype(np.int32)
    cross = np.ones(F, bool)
    allowed = rng.random(F) < 0.8
    if gate == "scenario":
        allowed = allowed[None, :]
    psn = np.zeros(F, np.int32)
    st_psn = np.full((F, A), -1, np.int32)
    st_bits = np.zeros((F, A), np.int32)
    absorbed = emitted = 0
    for tick in range(12):
        flow = rng.permutation(F)[:16].astype(np.int32)
        lanes = (flow, psn[flow] - (rng.random(16) < 0.2),
                 rng.random(16) < 0.9)
        hd = rng.random(F) < 0.05
        jr = jinc.member_ranks(jnp.asarray(red), jnp.asarray(cross),
                               jnp.asarray(allowed.reshape(-1)))
        want = _ref(st_psn, st_bits, lanes, jr, red, hd)
        member, rank, gsz = inc.member_ranks(_t(red[None]), _t(cross[None]),
                                             _t(allowed))
        st2, absorb, emit = inc.process(
            inc.INCState(_t(st_psn[None]), _t(st_bits[None])),
            lane_flow=_t(flow[None]), lane_psn=_t(lanes[1][None]),
            lane_cand=_t(lanes[2][None]), member=member, rank=rank,
            gsz=gsz, red=_t(red[None]), has_delivery=_t(hd[None]))
        for x, y in zip((st2.slot_psn[0], st2.slot_bits[0], absorb[0],
                         emit[0]), want):
            np.testing.assert_array_equal(x.numpy(), y, err_msg=str(tick))
        st_psn, st_bits = want[0], want[1]
        absorbed += int(want[2].sum())
        emitted += int(want[3].sum())
        psn[flow] += 1
    assert absorbed and emitted


def test_oversized_group_passes_through():
    """The twin of ``tests/test_collectives.py``'s oversized-group test:
    a 40-member group can never complete its bitmap and passes through
    whole; a 32-member one aggregates 31 children into one emit."""
    f = 40
    for members, absorbed, emitted in ((40, 0, 0), (32, 31, 1)):
        red = np.where(np.arange(f) < members, 0, -1).astype(np.int32)
        member, rank, gsz = _port_ranks([red], [np.ones(f, bool)])
        assert int(gsz[0, 0]) == members
        lanes = members if members == 32 else 34
        _, absorb, emit = inc.process(
            inc.INCState.create(f, 8, 1, "cpu"),
            lane_flow=torch.arange(lanes, dtype=torch.int32)[None],
            lane_psn=torch.zeros((1, lanes), dtype=torch.int32),
            lane_cand=torch.ones((1, lanes), dtype=torch.bool),
            member=member, rank=rank, gsz=gsz, red=_t(red[None]),
            has_delivery=torch.zeros((1, f), dtype=torch.bool))
        assert int(absorb.sum()) == absorbed and int(emit.sum()) == emitted


@pytest.mark.parametrize("ids", ["dense", "sparse"])
def test_member_ranks_matches_reference(ids):
    rng = np.random.default_rng(3)
    F = 300
    hi = 6 if ids == "dense" else 10 ** 6
    reds = [rng.integers(-1, hi, F).astype(np.int32) for _ in range(3)]
    if ids == "sparse":
        for r in reds:       # a few large groups among singletons
            r[rng.random(F) < 0.5] = rng.integers(0, 4) * 77777
    crosses = [rng.random(F) < 0.7 for _ in range(3)]
    allowed = rng.random(F) < 0.9
    for gate in (None, allowed, np.stack([allowed, ~allowed, allowed])):
        got = _port_ranks(reds, crosses, gate)
        for b in range(3):
            g = None if gate is None else gate if gate.ndim == 1 else gate[b]
            want = jinc.member_ranks(jnp.asarray(reds[b]),
                                     jnp.asarray(crosses[b]),
                                     None if g is None else jnp.asarray(g))
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x[b].numpy(), np.asarray(y))


def test_state_create_and_no_quadratic_temporary():
    st = inc.INCState.create(5, 3, 2, "cpu")
    assert st.slot_psn.shape == (2, 5, 3) and (st.slot_psn == -1).all()
    assert st.slot_bits.dtype == torch.int32 and not st.slot_bits.any()
    assert inc.INCState.empty(4, "cpu").slot_psn.shape == (4, 0, 1)
    # every tensor the two functions make, as the dispatcher sees it:
    # none is as large as one [Q, Q] plane (the reference's samef /
    # beaten / r_tick and its [F, F] member pass)
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    Largest.numel = max(Largest.numel, o.numel())
            return out

    rng = np.random.default_rng(5)
    F = Q = 1024
    red = _t(rng.integers(-1, 64, (2, F)).astype(np.int32))
    st = inc.INCState.create(F, 8, 2, "cpu")
    lanes = dict(lane_flow=_t(rng.integers(0, F, (2, Q)).astype(np.int32)),
                 lane_psn=_t(rng.integers(0, 64, (2, Q)).astype(np.int32)),
                 lane_cand=torch.ones((2, Q), dtype=bool))
    with Largest():
        member, rank, gsz = inc.member_ranks(red,
                                             torch.ones((2, F), dtype=bool))
        _, absorb, emit = inc.process(
            st, member=member, rank=rank, gsz=gsz, red=red,
            has_delivery=torch.zeros((2, F), dtype=bool), **lanes)
    assert absorb.any()
    assert 0 < Largest.numel < Q * Q, Largest.numel
