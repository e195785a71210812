"""In-network reduction and the link layer on the card against the same
batches on the CPU (the plain versions of the tick's kernels), bit for
bit: a B = 2 tree all-reduce under an ``inc=True`` profile (lane 0 with
its reduction group, lane 1 with ``red = -1``), and the corruption grid
at B = 2 (BER 0 and 5 % on leaf 0's uplinks) under LLR and under
LLR + CBFC. Each tick kernel launches once per tick for the two lanes.
Every test is ``cuda``-marked and skips without a card.

This file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_inc_link.py
"""
from dataclasses import replace

import pytest
import torch

from repro_torch.convert import state_to_numpy
from repro_torch.kernels import ops
from repro_torch.network import collectives as coll
from repro_torch.network import fabric as tf
from repro_torch.network import workloads as tw
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import leaf_spine
from test_torch_cuda_faults import TICK_KERNELS, _walk

LANES = ("stat_completion", "stat_src_completion", "stat_win_delivered",
         "delivered_per_tick", "cwnd_per_tick", "rx_base_per_tick",
         "src_base_per_tick")
COUNTERS = ("trims", "drops", "timeouts", "llr_replays",
            "credit_stall_ticks")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _card_vs_cpu(run) -> list:
    """``run(device)`` on the CPU and on the card: every lane, state
    field and counter equal; one launch per tick kernel and tick."""
    runs = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launches()
        runs[dev] = run(dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
    ticks = max(r.horizon for r in runs["cuda"])
    for k in TICK_KERNELS:
        assert launches[k] == ticks, (k, launches[k], ticks)
    for b, (r, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        assert r.horizon == c.horizon, b
        for k in LANES:
            if getattr(c, k) is not None:
                _walk(getattr(r, k), getattr(c, k), f"lane {b} {k}")
        _walk(state_to_numpy(r.state), state_to_numpy(c.state),
              f"lane {b} state")
        for k in COUNTERS:
            assert getattr(r, k) == getattr(c, k), (b, k)
    return runs["cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["stats", "full"])
def test_inc_batch_on_card_matches_plain_versions(cuda, trace):
    spec = coll.CollectiveSpec("all_reduce", tuple(range(8)), 24)
    wls = [coll.build_workload(spec, "tree"),
           coll.build_workload(spec, "tree", inc_groups=False)]
    prof = replace(TransportProfile.ai_full(), inc=True, name="ai_full+inc")
    rs = _card_vs_cpu(lambda dev: tf.simulate_batch(
        leaf_spine(2, 2, 4), wls, prof, tf.SimParams(ticks=600),
        trace=trace, device=dev))
    assert int(rs[0].state.inc_reduced) > 0
    assert int(rs[1].state.inc_reduced) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["link", "cbfc"])
@pytest.mark.parametrize("trace", ["stats", "full"])
def test_link_batch_on_card_matches_plain_versions(cuda, arm, trace):
    g, wls, scheds, exp = tw.corruption_sweep(bers=(0.0, 0.05), size=120,
                                              budget=600)
    rs = _card_vs_cpu(lambda dev: tf.simulate_batch(
        g, wls, exp["profile"], exp["params"], faults=scheds,
        link=exp[arm], trace=trace, device=dev))
    assert rs[1].llr_replays > 0 and rs[1].drops == 0
    if arm == "cbfc":
        assert all(r.trims == 0 for r in rs)
        assert any(r.credit_stall_ticks for r in rs)
