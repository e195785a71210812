"""The configuration ``ft1024-hpc`` at a test size (``data/``:
fat_tree3(k=4) under ``hpc()``, two cross-pod permutations of 64 packets,
B = 2, budget 1024): the program against the plain reference bit for bit,
on a sweep whose go-back-N does real work (ROD rejects, duplicates,
trims); on a card, the same against the port's kernels; and the harness's
traced run (32 packets a flow, budget 512, to keep the profiled CPU sweep
short), which reads the HPC cell's three tick metrics there and leaves
them out of an AI Full cell."""
import json

import pytest
import torch

from portbench import harness

HPC = "tiny-hpc.tiny-perm2-b2-t1024"
HPC_TRACED = "tiny-hpc.tiny-perm2-b2-t512"
NEW = ("tick.rccc_host_ms", "tick.rod_host_ms", "tick.gbn_waste_share")


def _with_hpc(root):
    """The tiny copy's manifest with the tiny HPC cells beside its own."""
    m = json.loads((root / "BENCHMARK.json").read_text())
    have = {w["name"] for w in m["workloads"]}
    for name in (HPC, HPC_TRACED):
        if name not in have:
            m["workloads"].append({"name": name, "config": "tiny-hpc",
                                   "traffic": name.split(".")[1],
                                   "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def _sweep_both(root, dev):
    cell = harness.Cell.load(root / "portbench", harness.workload_entry(
        harness.load_manifest(root), HPC))
    prog = harness.Engine(harness.program_modules(), cell.config, dev)
    ref = harness.Engine(harness.reference_modules(), cell.config, dev)
    inputs = harness.sweep_inputs(cell, ref.g, 2 ** 33 + 7, 0)
    got = prog.sweep(inputs, cell.lanes, cell.max_ticks)
    want = ref.sweep(inputs, cell.lanes, cell.max_ticks)
    return got, harness.compare(harness.lane_outputs(got),
                                harness.lane_outputs(want))


def test_hpc_matches_the_reference_under_go_back_n(tiny):
    rs, res = _sweep_both(_with_hpc(tiny), torch.device("cpu"))
    assert res["elements_differing"] == 0, res["where"]
    assert res["horizons_differing"] == 0
    for r in rs:
        assert int(r.state.rod_rejects) > 0
        assert int(r.state.dups) > 0
        assert int(r.state.trims) > 0


@pytest.mark.cuda
def test_hpc_on_the_card_matches_the_reference(tiny, cuda):
    rs, res = _sweep_both(_with_hpc(tiny), cuda)
    assert res["elements_differing"] == 0, res["where"]
    assert all(int(r.state.rod_rejects) > 0 for r in rs)


def test_the_hpc_cell_reads_its_tick_metrics_and_ai_full_does_not(tiny):
    from repro_torch.network import fabric
    root, cpu = _with_hpc(tiny), torch.device("cpu")
    fabric.reset_driver_counts()
    hpc = harness.run_cell(root, HPC_TRACED, 9, 0.1, True, cpu, 0.0)
    counts = dict(fabric.TRANSPORT_COUNTS)
    other = harness.run_cell(root, "tiny-ai_full.tiny-perm2-b2", 9, 0.1,
                             True, cpu, 0.0)
    assert hpc["correct"] and other["correct"]
    for name in NEW:
        assert hpc["metrics"][name]["value"] > 0, name
        assert name not in other["metrics"], name
    assert hpc["metrics"]["tick.gbn_waste_share"] == {
        "value": 100.0 * (counts["dups"] + counts["rod_rejects"])
        / counts["arrivals"], "unit": "%"}
    assert hpc["metrics"]["tick.rod_host_ms"]["unit"] == "ms"
    # the spans are a share of the tick's host time
    assert hpc["metrics"]["tick.rccc_host_ms"]["value"] \
        < hpc["metrics"]["tick.host_ms"]["value"]
