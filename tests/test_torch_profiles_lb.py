"""Trajectory parity of the port's fabric engine with the reference for
the LB schemes the tick feeds back into and for mixed per-flow delivery,
on the CPU (the k=6 scenario of ``test_torch_fabric.py``; every out lane,
every final state lane and the stats scalars bitwise):

* ``ai_full(lb=RR_SLOTS)`` in a congested run, where the EV-based loss
  inference (an ACK for PSN x implies x-K, x-2K... of its slot were
  lost) marks bits in the retransmit ring;
* ``ai_full(lb=EVBITMAP)``, whose congestion feedback sets ``cong_bits``;
* a mixed per-flow delivery tuple (RUD, ROD, RUDI, ...) with REPS, so ROD
  lanes are pinned to their static EV among spraying RUD lanes.
"""
import numpy as np
import torch

from repro.core.lb.schemes import LBScheme as JLB
from repro.network import profile as jprof
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.kernels import ops
from repro_torch.network import profile as tprof
from test_torch_fabric import K6_SRC
from test_torch_profiles import assert_parity, run_pair


def test_rr_slots_loss_inference_trajectory(monkeypatch):
    """Count the retransmit bits set by the RR_SLOTS inference: every
    call of the in-place ``set_own_bit_`` that tests the source ring
    (``unless``); section 9's stall mark passes none. The form writes
    into its ring, so the spy compares against a copy taken before."""
    marked = []
    set_bit = ops.set_own_bit_

    def spy(ring, off, valid, unless=None):
        before = ring.clone()
        out = set_bit(ring, off, valid, unless=unless)
        if unless is not None:
            marked.append(int((out != before).sum()))
        return out

    monkeypatch.setattr(ops, "set_own_bit_", spy)
    ref, port = run_pair(jprof.TransportProfile.ai_full(lb=JLB.RR_SLOTS),
                         tprof.TransportProfile.ai_full(lb=LBScheme.RR_SLOTS))
    assert_parity(ref, port)
    assert port.trims > 0
    assert sum(marked) > 0, "the EV-based loss inference must mark rtx bits"
    assert (port.state.slot_last_ack >= 0).any()


def test_evbitmap_feedback_trajectory():
    ref, port = run_pair(jprof.TransportProfile.ai_full(lb=JLB.EVBITMAP),
                         tprof.TransportProfile.ai_full(lb=LBScheme.EVBITMAP))
    assert_parity(ref, port)
    assert bool(port.state.lb.cong_bits.any()), "cong_bits must be set"
    assert bool((port.state.lb.rr_ptr != 0).any())


def test_mixed_delivery_with_reps_trajectory():
    D, JD = tprof.DeliveryMode, jprof.DeliveryMode
    n = len(K6_SRC)
    tp = tprof.TransportProfile(
        cc=tprof.CCAlgo.NSCC, lb=LBScheme.REPS, name="mixed",
        delivery=tuple((D.RUD, D.ROD, D.RUDI)[i % 3] for i in range(n)))
    jp = jprof.TransportProfile(
        cc=jprof.CCAlgo.NSCC, lb=JLB.REPS, name="mixed",
        delivery=tuple((JD.RUD, JD.ROD, JD.RUDI)[i % 3] for i in range(n)))
    assert tp.describe() == jp.describe()
    ref, port = run_pair(jp, tp)
    assert_parity(ref, port)
    rod = np.arange(n) % 3 == 1
    s = port.state
    # ROD lanes deliver in order: cumulative delivered == receiver CACK
    cum = port.delivered_per_tick.cumsum(axis=0)
    np.testing.assert_array_equal(cum[:, rod].astype(np.uint32),
                                  port.rx_base_per_tick[:, rod])
    # ROD lanes never feed the REPS recycle ring
    assert not bool((s.lb.reps_size[torch.as_tensor(rod)] != 0).any())
    assert int(s.rod_rejects) > 0 and port.rtx_packets > 0
