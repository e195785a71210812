"""Telemetry and the split scenario axis on the card, bit for bit: a
small flapping batch with the probe on, on the card against the same
batch on the CPU (the plain versions of the tick's kernels): horizons,
stat lanes, state and every lane of the probe carry (each ring slot,
the f32 EWMA included); and ``shard.run_sharded`` over a repeated card
(B = 3: one padding lane) against the unsharded run on the card, with
and without telemetry. Each tick kernel launches once per tick of each
run (``flow_fold`` twice, for sections 1 and 5). Every test is ``cuda``-marked and skips without a card.

This file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_telemetry_shard.py
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import state_to_numpy
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.kernels import ops
from repro_torch.network import fabric as tf
from repro_torch.network import shard
from repro_torch.network import workloads as tw
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.telemetry import TelemetrySpec
from test_torch_cuda_faults import FOLDS_PER_TICK, TICK_KERNELS, _walk

LANES = ("stat_completion", "stat_src_completion", "stat_win_delivered")
SPEC = TelemetrySpec.on(probe_every=8, slots=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _flap_batch():
    """Three lanes of a small victim-share flap: sizes that stop at
    different chunks, a flap window per lane, per-lane seeds."""
    g, wl, exp = tw.victim_sweep(pairs=4, uplinks=2, size=300)
    q = exp["uplinks"][0]
    ok = FaultSchedule.healthy(g.num_queues)
    sched = FaultSchedule.stack([ok.flap(q, 40, 160), ok.flap(q, 80, 240),
                                 ok.flap(q, 20, 400)])
    wls = [tf.Workload.of(wl.src, wl.dst, s) for s in (30, 120, 60)]
    return (g, wls, TransportProfile.ai_full(lb=LBScheme.REPS),
            tf.SimParams(ticks=768, chunk_ticks=64, timeout_ticks=64,
                         ooo_threshold=24), sched,
            np.arange(3, dtype=np.uint32) + 0x5EED)


def _same(a, b, what: str) -> None:
    assert a.horizon == b.horizon, what
    for k in LANES:
        _walk(getattr(a, k), getattr(b, k), f"{what} {k}")
    _walk(state_to_numpy(a.state), state_to_numpy(b.state), f"{what} state")
    if b.telemetry is None:
        assert a.telemetry is None, what
        return
    for k, v in b.telemetry.lanes.items():
        _walk(np.asarray(a.telemetry.lanes[k]), np.asarray(v),
              f"{what} probe {k}")


def _launches_per_tick(ticks: int) -> None:
    torch.cuda.synchronize()
    for k in TICK_KERNELS:
        want = FOLDS_PER_TICK.get(k, 1) * ticks
        assert ops.LAUNCHES[k] == want, (k, ops.LAUNCHES[k], want)


@pytest.mark.cuda
def test_telemetry_batch_on_card_matches_plain_versions(cuda):
    g, wls, prof, p, sched, seeds = _flap_batch()
    runs = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launches()
        runs[dev] = tf.simulate_batch(g, wls, prof, p, faults=sched,
                                      seeds=seeds, telemetry=SPEC,
                                      device=dev)
    _launches_per_tick(max(r.horizon for r in runs["cuda"]))
    assert len({r.horizon for r in runs["cuda"]}) > 1
    for b, (r, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        _same(r, c, f"lane {b}")
    assert any(r.telemetry.stride > 1 for r in runs["cuda"])
    assert any(int(r.telemetry.final["drop_q"].sum()) for r in runs["cuda"])


@pytest.mark.cuda
@pytest.mark.parametrize("tel", [None, SPEC], ids=["off", "telemetry"])
def test_run_sharded_on_card_matches_unsharded(cuda, tel):
    g, wls, prof, p, sched, seeds = _flap_batch()
    base = tf.simulate_batch(g, wls, prof, p, faults=sched, seeds=seeds,
                             telemetry=tel, device="cuda")
    ops.reset_launches()
    shd = shard.run_sharded(g, tf.Workload.stack(wls), prof, p, sched,
                            seeds, "stats", p.ticks, None, (cuda, cuda),
                            tel=tel)
    # shard 0 holds lanes 0 and 1, shard 1 lane 2 and the padding lane,
    # which stops at the first chunk boundary
    _launches_per_tick(max(base[0].horizon, base[1].horizon)
                       + max(base[2].horizon, p.chunk_ticks))
    assert len(shd) == 3
    for b, (r, u) in enumerate(zip(shd, base)):
        _same(r, u, f"lane {b}")
