"""A small faulted batch on the card against the same batch on the CPU
(the plain versions of the tick's kernels), bit for bit: B = 4 lanes
with a different fault class each (gray links, a host death with a NIC
stall, PHY corruption with a flap, all of them with a dead uplink), the
tick's kernels launched once per tick for the four lanes (none of the
selective-retransmit marks under all-ROD; the per-flow folds twice). Every test is
``cuda``-marked and skips without a card.

This file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_faults.py
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.convert import state_to_numpy
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.kernels import ops
from repro_torch.network import fabric as tf
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import leaf_spine

TICK_KERNELS = ("sack_fused_own", "sack_advance_own", "nack_mark_lanes",
                "set_own_bit", "clear_own_bit", "enqueue_rank", "flow_fold")
#: launches a tick of the tick kernels that are not launched once a tick
#: in every profile: the folds of sections 1 and 5
FOLDS_PER_TICK = {"flow_fold": 2}
SRC, DST, DEP = [0, 1, 2, 6, 3], [4, 5, 3, 0, 7], [-1, -1, -1, -1, 0]
PROFILES = {
    "resilient": (TransportProfile.resilient(), (1, 1, 1, 1, 1, 1, 2)),
    "reps_evict": (replace(TransportProfile.ai_full(lb=LBScheme.REPS),
                           ev_eviction=True, rto_backoff=3.0,
                           pdc_dead_after=3), (1, 1, 1, 1, 1, 1, 2)),
    "hpc_evict": (replace(TransportProfile.hpc(), ev_eviction=True,
                          rto_backoff=2.0, pdc_dead_after=4),
                  (1, 1, 0, 0, 1, 1, 2)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _schedule(g):
    ups = [int(g.up1_table[0, i]) for i in range(2)]
    ok = FaultSchedule.healthy(g.num_queues, num_hosts=g.num_hosts)
    return FaultSchedule.stack([
        ok.lossy(ups, 0.08).with_seed(5),
        ok.host_fail(0, 60).nic_stall(1, 50, 300),
        ok.corrupt(ups[1], 0.05).flap(ups[0], 100, 260).with_seed(9),
        ok.host_fail(5, 80, 400).lossy(ups[0], 0.03).corrupt(ups[1], 0.02)
        .flap(ups[1], 0).host_fail(0, 200).with_seed(0xFFFFFFFF),
    ])


def _walk(a, b, path):
    if isinstance(a, dict):
        for k in a:
            _walk(a[k], b[k], f"{path}.{k}")
        return
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a.view(np.uint8) if a.size else a,
                                  b.view(np.uint8) if b.size else b,
                                  err_msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("trace", ["stats", "full"])
def test_faulted_batch_on_card_matches_plain_versions(cuda, name, trace):
    prof, per_tick = PROFILES[name]
    g = leaf_spine(2, 2, 4)
    wl = tf.Workload.of(SRC, DST, 60, dep=DEP)
    p = tf.SimParams(ticks=900, chunk_ticks=64, timeout_ticks=16,
                     queue_capacity=4, ooo_threshold=12)
    runs = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launches()
        runs[dev] = tf.simulate_batch(
            g, [wl] * 4, prof, p, faults=_schedule(g),
            seeds=[0x5EED, 0xFFFFFFF0, 7, 0x80000001], trace=trace,
            max_ticks=777, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
    ticks = max(r.horizon for r in runs["cuda"])
    for k, n in zip(TICK_KERNELS, per_tick):
        assert launches[k] == n * ticks, (k, launches[k], ticks)
    for b, (r, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        assert r.horizon == c.horizon, b
        for k in ("stat_completion", "stat_src_completion",
                  "stat_win_delivered", "delivered_per_tick",
                  "cwnd_per_tick", "rx_base_per_tick", "src_base_per_tick"):
            if getattr(c, k) is not None:
                _walk(getattr(r, k), getattr(c, k), f"lane {b} {k}")
        _walk(state_to_numpy(r.state), state_to_numpy(c.state),
              f"lane {b} state")
        for k in ("ev_evictions", "flows_abandoned", "ticks_unreachable",
                  "drops", "timeouts"):
            assert getattr(r, k) == getattr(c, k), (b, k)
    assert any(r.flows_abandoned for r in runs["cuda"])
