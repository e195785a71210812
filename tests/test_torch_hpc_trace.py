"""UE's HPC profile in the port's tracing on the CPU: a small sweep under
``hpc()`` (hybrid NSCC + RCCC, all-ROD) records RCCC's ``policy.rccc``
spans inside ``policy.cc`` and the tick's ROD-only ``pds.rod`` blocks
inside their sections, ``ai_full()`` records neither and ``ai_base()``
(RCCC alone, RUD) only the first; ``fabric.TRANSPORT_COUNTS`` holds the
finished sweeps' lane sums of the final states' counters and a reset
clears it; and no lane of the results moves with the spans on."""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.network import fabric
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import fat_tree3

torch.set_num_threads(1)

G = fat_tree3(k=4, pods=4)
P = fabric.SimParams(chunk_ticks=64)
PROFILES = {"hpc": TransportProfile.hpc, "ai_full": TransportProfile.ai_full,
            "ai_base": TransportProfile.ai_base}
#: spans a tick: ROD's four blocks (sections 3 and 5 have two each);
#: RCCC's grant round, send gate, spend and seen-merge, and its window
#: view where RCCC alone reports the tick's cwnd lane
PER_TICK = {"hpc": {"pds.rod": 6, "policy.rccc": 4},
            "ai_full": {"pds.rod": 0, "policy.rccc": 0},
            "ai_base": {"pds.rod": 0, "policy.rccc": 5}}
ROD_SECTIONS = {"tick.1_control", "tick.3_injection", "tick.5_delivery",
                "tick.8_control_tc"}


@pytest.fixture(autouse=True)
def _default_recorder():
    spans.take()
    yield
    spans.follow_profiler()
    spans.take()


def _sweep(profile, max_ticks=512):
    h = np.arange(16, dtype=np.int32)
    wl = fabric.Workload.of(np.concatenate([h, h]),
                            np.concatenate([(h + 4) % 16, (h + 8) % 16]),
                            48, device="cpu")
    return fabric.simulate_batch(G, fabric.Workload.stack([wl, wl]),
                                 PROFILES[profile](), P, seeds=[3, 4],
                                 max_ticks=max_ticks, device="cpu")


def _lanes(rs):
    out = []
    for r in rs:
        lane = {"horizon": r.horizon, "comp": r.stat_completion}
        for f in fabric.SimState.__dataclass_fields__:
            v = getattr(r.state, f)
            if isinstance(v, torch.Tensor):
                lane[f] = v.numpy()
        lane["cc"] = r.state.cc
        out.append(lane)
    return out


@pytest.fixture(scope="module")
def hpc_on():
    """The hpc sweep with the recorder on: its results, records and the
    transport counts of that sweep alone."""
    spans.take()
    spans.enable()
    fabric.reset_driver_counts()
    try:
        rs = _sweep("hpc")
        return rs, spans.take(), dict(fabric.TRANSPORT_COUNTS)
    finally:
        spans.follow_profiler()


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_rod_and_rccc_spans_follow_the_profile(profile, hpc_on):
    if profile == "hpc":
        rs, recs, _ = hpc_on
    else:
        spans.enable()
        rs = _sweep(profile)
        recs = spans.take()
    ticks = max(r.horizon for r in rs)
    n = Counter(r[0] for r in recs)
    for name, k in PER_TICK[profile].items():
        assert n[name] == k * ticks, (name, n[name], ticks)
    by_id = {r[1]: r for r in recs}
    for name, _, parent, _, t0, t1 in recs:
        if name == "pds.rod":
            assert by_id[parent][0] in ROD_SECTIONS
        elif name == "policy.rccc" and profile == "hpc":
            assert by_id[parent][0] == "policy.cc"   # inside the hybrid
        if parent:
            assert by_id[parent][4] <= t0 and t1 <= by_id[parent][5]


def test_transport_counts_are_the_lane_sums_and_reset(hpc_on):
    rs, _, counts = hpc_on
    dups = sum(int(r.state.dups) for r in rs)
    rej = sum(int(r.state.rod_rejects) for r in rs)
    fresh = sum(int(r.state.delivered.sum()) for r in rs)
    assert counts == {"arrivals": fresh + dups + rej, "dups": dups,
                      "rod_rejects": rej,
                      "trims": sum(int(r.state.trims) for r in rs)}
    assert rej > 0 and counts["trims"] > 0
    # a second sweep adds its own sums; a reset clears both dicts
    fabric.reset_driver_counts()
    _sweep("ai_full", max_ticks=64)
    assert fabric.TRANSPORT_COUNTS["arrivals"] > 0
    assert fabric.TRANSPORT_COUNTS["rod_rejects"] == 0
    fabric.reset_driver_counts()
    assert fabric.TRANSPORT_COUNTS == dict.fromkeys(
        ("arrivals", "dups", "rod_rejects", "trims"), 0)
    assert fabric.DRIVER_COUNTS == {"ticks": 0, "masked_ticks": 0}


def test_the_spans_move_no_lane_of_the_results(hpc_on):
    spans.disable()
    off = _lanes(_sweep("hpc"))
    on = _lanes(hpc_on[0])
    assert spans.take() == []
    for a, b in zip(on, off, strict=True):
        assert a["horizon"] == b["horizon"]
        np.testing.assert_array_equal(a["comp"], b["comp"])
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b[k], err_msg=k)
        for part in ("nscc", "rccc"):
            for f, v in vars(a["cc"][part]).items():
                assert torch.equal(v, getattr(b["cc"][part], f)), (part, f)
