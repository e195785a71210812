"""The benchmark's traffic and fault generators (``portbench/traffic``)
on the cells' own fabric, fat_tree3(k=16, pods=16)."""
import json

import numpy as np
import pytest

from conftest import ROOT

from portbench import harness
from portbench.reference import topology as rt
from portbench.reference.uet_types import NEVER_TICK

CELLS = ("ft1024-ai_full.perm2-b8", "ft1024-resilient.faults-b16")


@pytest.fixture(scope="module")
def ft1024():
    return rt.fat_tree3(k=16, pods=16)


def _cell(name):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Cell.load(ROOT / "portbench",
                             harness.workload_entry(manifest, name))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3])
def test_permutations_cross_pods_with_two_sources_each(ft1024, seed):
    cell = _cell(CELLS[0])
    f = harness.sweep_inputs(cell, ft1024, seed, 0)["flows"]
    pod = ft1024.host_pod
    assert f["src"].shape == (2048,) and (f["size"] == 256).all()
    assert (pod[f["src"]] != pod[f["dst"]]).all()      # no flow in its pod
    srcs = {}
    for s, d in zip(f["src"], f["dst"]):
        srcs.setdefault(int(d), set()).add(int(s))
    assert len(srcs) == 1024                            # every host a dst
    assert all(len(v) == 2 for v in srcs.values())      # two distinct srcs
    assert np.bincount(f["src"], minlength=1024).tolist() == [2] * 1024


def test_fault_classes_sit_on_their_lanes(ft1024):
    cell = _cell(CELLS[1])
    fl = harness.sweep_inputs(cell, ft1024, 2 ** 31 + 9, 0)["faults"]
    up1 = ft1024.up1_table
    ea, eb = fl["hit"]["edges"]
    dead, stalled = fl["hit"]["dead_host"], fl["hit"]["stalled_host"]
    assert ea != eb and dead != stalled
    assert fl["classes"].tolist() == [0, 1, 2, 3] * 4
    for b, c in enumerate(fl["classes"]):
        lossy = np.flatnonzero(fl["loss_p"][b])
        corrupt = np.flatnonzero(fl["corrupt_p"][b])
        dead_q = np.flatnonzero(fl["fail_at"][b] != NEVER_TICK)
        dead_h = np.flatnonzero(fl["host_fail_at"][b] != NEVER_TICK)
        stall_h = np.flatnonzero(fl["nic_stall_at"][b] != NEVER_TICK)
        assert sorted(lossy) == (sorted(up1[ea]) if c in (0, 3) else [])
        assert sorted(corrupt) == (sorted(up1[eb]) if c in (2, 3) else [])
        assert dead_q.tolist() == ([up1[ea, 0]] if c == 3 else [])
        assert dead_h.tolist() == ([dead] if c in (1, 3) else [])
        assert stall_h.tolist() == ([stalled] if c in (1, 3) else [])
        if c in (1, 3):
            assert fl["host_fail_at"][b, dead] == 100
            assert fl["host_heal_at"][b, dead] == NEVER_TICK
            assert (fl["nic_stall_at"][b, stalled],
                    fl["nic_heal_at"][b, stalled]) == (100, 400)
        assert (fl["heal_at"][b] == NEVER_TICK).all()
    assert np.isclose(fl["loss_p"].max(), 0.01)
    assert np.isclose(fl["corrupt_p"].max(), 0.01)
    assert len(set(fl["seed"].tolist())) == 16           # a seed a lane


@pytest.mark.parametrize("cell_name", CELLS)
def test_same_seed_same_inputs_other_seed_other_inputs(ft1024, cell_name):
    cell = _cell(cell_name)

    def flat(inp):
        parts = [inp["flows"][k] for k in ("src", "dst", "size")]
        parts.append(inp["seeds"])
        if inp["faults"] is not None:
            parts += [inp["faults"][k] for k in harness.FAULT_LANES]
        return [np.asarray(p) for p in parts]

    a = flat(harness.sweep_inputs(cell, ft1024, 123456789012, 0))
    b = flat(harness.sweep_inputs(cell, ft1024, 123456789012, 0))
    c = flat(harness.sweep_inputs(cell, ft1024, 123456789013, 0))
    d = flat(harness.sweep_inputs(cell, ft1024, 123456789012, 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert not all(np.array_equal(x, y) for x, y in zip(a, d))


def test_fault_lanes_build_the_ports_schedule(ft1024):
    """The generator's arrays are the lanes that the port's own builders
    give for the same choices (chip_smoke.fault_schedule's classes)."""
    import torch
    from repro_torch.network.faults import FaultSchedule
    cell = _cell(CELLS[1])
    fl = harness.sweep_inputs(cell, ft1024, 99, 0)["faults"]
    up1 = ft1024.up1_table
    ea, eb = fl["hit"]["edges"]
    dead, stalled = fl["hit"]["dead_host"], fl["hit"]["stalled_host"]
    ok = FaultSchedule.healthy(ft1024.num_queues,
                               num_hosts=ft1024.num_hosts)
    by_class = [
        ok.lossy(up1[ea], 0.01),
        ok.host_fail(dead, 100).nic_stall(stalled, 100, 400),
        ok.corrupt(up1[eb], 0.01),
        ok.lossy(up1[ea], 0.01).host_fail(dead, 100)
        .nic_stall(stalled, 100, 400).corrupt(up1[eb], 0.01)
        .flap(up1[ea, 0], 0)]
    want = FaultSchedule.stack([by_class[c].with_seed(int(s)) for c, s in
                                zip(fl["classes"], fl["seed"])])
    for k in harness.FAULT_LANES:
        got = fl[k].view(np.int32) if k == "seed" else fl[k]
        assert np.array_equal(getattr(want, k).numpy(), got), k
        assert getattr(want, k).dtype == torch.as_tensor(got).dtype, k
