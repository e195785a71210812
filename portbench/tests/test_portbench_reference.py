"""The benchmark's plain reference (``portbench/reference``) on the CPU:
bitwise against the JAX package's goldens (``tests/golden/
fabric_golden.npz``, read with numpy) and against the port's plain path
on a small fat tree with every fault class under ``resilient()``; on a
card, against the port's kernels."""
import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench import harness
from portbench.reference import fabric as rf
from portbench.reference import profile as rp
from portbench.reference import schemes as rs
from portbench.reference import topology as rt

GOLDEN = ROOT / "tests" / "golden" / "fabric_golden.npz"


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


def test_golden_a_is_a_bitwise_prefix():
    gold = np.load(GOLDEN)
    g = rt.leaf_spine(leaves=2, spines=4, hosts_per_leaf=4)
    r = rf.simulate(g, rf.Workload.of([0, 1, 2], [4, 5, 6], 200),
                    rp.TransportProfile.ai_full(), rf.SimParams(ticks=300),
                    trace="full", device="cpu")
    h = r.horizon
    assert h <= 300 and h % 128 == 0
    np.testing.assert_array_equal(r.delivered_per_tick,
                                  gold["a_delivered"][:h])
    assert not gold["a_delivered"][h:].any()
    np.testing.assert_array_equal(_bits(r.cwnd_per_tick),
                                  _bits(gold["a_cwnd"][:h]))
    np.testing.assert_array_equal(r.qlen_max, gold["a_qlen"][:h])
    s = r.state
    np.testing.assert_array_equal(s.delivered.numpy(),
                                  gold["a_state_delivered"])
    np.testing.assert_array_equal(s.next_psn.numpy(),
                                  gold["a_state_next_psn"])
    np.testing.assert_array_equal(
        s.src_track.base.numpy().view(np.uint32), gold["a_state_src_base"])


def test_golden_b_reps_dead_uplink_batched():
    gold = np.load(GOLDEN)
    g = rt.leaf_spine(leaves=2, spines=4, hosts_per_leaf=8)
    wl = rf.Workload.of(list(range(8)), [8 + i for i in range(8)], 700)
    mask = np.zeros((1, g.num_queues), bool)
    mask[0, int(gold["b_failed_queue"][0])] = True
    r = rf.simulate_batch(
        g, rf.Workload.stack([wl]),
        rp.TransportProfile.ai_full(lb=rs.LBScheme.REPS),
        rf.SimParams(ticks=400, timeout_ticks=64, ooo_threshold=24),
        failed=mask, seeds=np.asarray([0x5EED + 3], np.uint32),
        trace="full", device="cpu")[0]
    assert r.horizon == 400 and r.ticks_degraded == 400
    np.testing.assert_array_equal(r.delivered_per_tick, gold["b_delivered"])
    np.testing.assert_array_equal(_bits(r.cwnd_per_tick),
                                  _bits(gold["b_cwnd"]))
    np.testing.assert_array_equal(r.qlen_max, gold["b_qlen"])
    np.testing.assert_array_equal(r.state.delivered.numpy(),
                                  gold["b_state_delivered"])
    np.testing.assert_array_equal(
        r.state.src_track.base.numpy().view(np.uint32),
        gold["b_state_src_base"])


def _engines(tiny, cell_name, dev_prog, dev_ref):
    manifest = harness.load_manifest(tiny)
    cell = harness.Cell.load(tiny / "portbench",
                             harness.workload_entry(manifest, cell_name))
    prog = harness.Engine(harness.program_modules(), cell.config, dev_prog)
    ref = harness.Engine(harness.reference_modules(), cell.config, dev_ref)
    return cell, prog, ref


@pytest.mark.parametrize("cell_name", ["tiny-resilient.tiny-faults-b4",
                                       "tiny-ai_full.tiny-perm2-b2"])
def test_reference_is_the_ports_plain_path(tiny, cell_name):
    """Every lane of a sweep, stats tier and full tier, bitwise: the
    faulted cell carries every fault class (gray loss, a dead host, a
    stalled NIC, PHY corruption, a dead uplink) under resilient()."""
    cpu = torch.device("cpu")
    cell, prog, ref = _engines(tiny, cell_name, cpu, cpu)
    inputs = harness.sweep_inputs(cell, ref.g, 2 ** 31 + 11, 0)
    got = harness.lane_outputs(prog.sweep(inputs, cell.lanes,
                                          cell.max_ticks))
    want = harness.lane_outputs(ref.sweep(inputs, cell.lanes,
                                          cell.max_ticks))
    res = harness.compare(got, want)
    assert res["elements_differing"] == 0, res["where"]
    assert len(want[0]) > 40            # every state lane is compared
    # the full tier's per-tick lanes too
    a = prog.sweep(inputs, cell.lanes, 256, trace="full")
    b = ref.sweep(inputs, cell.lanes, 256, trace="full")
    for x, y in zip(a, b, strict=True):
        for lane in ("delivered_per_tick", "cwnd_per_tick", "qlen_max",
                     "rx_base_per_tick", "src_base_per_tick"):
            np.testing.assert_array_equal(_bits(getattr(x, lane)),
                                          _bits(getattr(y, lane)))


@pytest.mark.cuda
def test_reference_on_the_card_matches_the_kernels(tiny, cuda):
    cell, prog, ref = _engines(tiny, "tiny-resilient.tiny-faults-b4", cuda,
                               cuda)
    inputs = harness.sweep_inputs(cell, ref.g, 5, 0)
    got = harness.lane_outputs(prog.sweep(inputs, cell.lanes,
                                          cell.max_ticks))
    want = harness.lane_outputs(ref.sweep(inputs, cell.lanes,
                                          cell.max_ticks))
    assert harness.compare(got, want)["elements_differing"] == 0
