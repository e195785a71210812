"""The incast generator (``portbench/traffic/incast.py``) on the cells'
own fabric, fat_tree3(k=16, pods=16), under ``incast8-b8``'s parameters:
256 destinations, 16 a pod, each fed by 8 sources in 8 distinct other
pods; every host the source of 2 flows, no pair twice; the seed decides
the inputs."""
import json

import numpy as np
import pytest

from conftest import ROOT

from portbench import harness
from portbench.reference import topology as rt

CELL = "ft1024-ai_full.incast8-b8"
SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3]


@pytest.fixture(scope="module")
def ft1024():
    return rt.fat_tree3(k=16, pods=16)


def _cell():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Cell.load(ROOT / "portbench",
                             harness.workload_entry(manifest, CELL))


def _flows(ft1024, seed, index=0):
    return harness.sweep_inputs(_cell(), ft1024, seed, index)["flows"]


@pytest.mark.parametrize("seed", SEEDS)
def test_each_destination_has_8_sources_in_8_other_pods(ft1024, seed):
    f = _flows(ft1024, seed)
    pod = np.asarray(ft1024.host_pod)
    for d in np.unique(f["dst"]):
        src_pods = pod[f["src"][f["dst"] == d]]
        assert src_pods.size == 8
        assert np.unique(src_pods).size == 8
        assert pod[d] not in src_pods


@pytest.mark.parametrize("seed", SEEDS)
def test_every_host_sources_2_flows_and_no_pair_repeats(ft1024, seed):
    f = _flows(ft1024, seed)
    H = int(ft1024.num_hosts)
    assert np.array_equal(np.bincount(f["src"], minlength=H),
                          np.full(H, 2))
    assert len(set(zip(f["src"].tolist(), f["dst"].tolist()))) == 2 * H
    assert (f["src"] != f["dst"]).all()


def test_2048_flows_of_64_packets_onto_16_destinations_a_pod(ft1024):
    cell = _cell()
    f = _flows(ft1024, 123456789012)
    pod = np.asarray(ft1024.host_pod)
    assert f["src"].size == 2048 and cell.lanes == 8
    assert (f["size"] == 64).all()
    assert f["src"].dtype == f["dst"].dtype == np.int32
    dests = np.unique(f["dst"])
    assert dests.size == 256
    assert np.array_equal(np.bincount(pod[dests], minlength=16),
                          np.full(16, 16))


def test_same_seed_same_inputs_other_seed_other_inputs(ft1024):
    def flat(inp):
        return [np.asarray(inp["flows"][k]) for k in ("src", "dst", "size")
                ] + [np.asarray(inp["seeds"])]

    cell = _cell()
    a = flat(harness.sweep_inputs(cell, ft1024, 123456789012, 0))
    b = flat(harness.sweep_inputs(cell, ft1024, 123456789012, 0))
    c = flat(harness.sweep_inputs(cell, ft1024, 123456789013, 0))
    d = flat(harness.sweep_inputs(cell, ft1024, 123456789012, 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    assert not np.array_equal(a[1], d[1])


def test_an_incast_that_cannot_be_balanced_is_refused(ft1024):
    gen = _cell().generator("incast")
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError):     # 16 sources, 15 other pods
        gen.generate(rng, ft1024, {"dests_per_pod": 8, "sources": 16,
                                   "packets": 1})
    with pytest.raises(ValueError):     # 5 x 3 flows over 64 hosts
        gen.generate(rng, ft1024, {"dests_per_pod": 5, "sources": 3,
                                   "packets": 1})
