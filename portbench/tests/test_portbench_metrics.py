"""The per-layer metric readers (``portbench/metrics``) on made-up
inputs: the kernels' byte counts against PERF.md's kernel table at the
B = 4 batch's shapes, the trace arithmetic on a synthetic trace, and the
driver's frozen share on hand-made horizons."""
import pytest

from conftest import ROOT

from portbench import harness

METRICS = ROOT / "portbench" / "metrics"


def reader(name):
    return harness.load_module(METRICS / f"{name}.py")


#: fat_tree3(k=16, pods=16) at B = 4: F = 2048, W = 16, Q = 5120
FT1024_B4 = {"B": 4, "F": 2048, "W": 16, "Q": 5120, "L": 5120 + 2 * 2048,
             "tables": {"stage": 5120, "next_switch": 5120,
                        "host_leaf": 1024, "host_queue": 1024,
                        "host_pod": 1024, "up1": 1024, "down1": 1024,
                        "up2": 1024, "down2": 1024}}


def test_site_bytes_are_perf_mds_b4_figures():
    got = reader("kernels.roofline_share").site_bytes(FT1024_B4)
    # PERF.md section 6, the [B = 4] column of bound_ms (by)
    assert got["sack_fused_own"] == 2252800
    assert got["sack_advance_own"] == 1196032
    assert got["nscc_ack"] == 180224
    assert got["nscc_epoch"] == 262144
    assert got["ecmp_inject"] == 143360
    assert got["ecmp_route"] == 413696
    # the marks: their lanes only (the table adds the words they mark:
    # 536180, 89256, 89256 B on its data)
    assert got["nack_mark_lanes"] == 9 * 4 * 9216 <= 536180
    assert got["set_own_bit"] == got["clear_own_bit"] == 5 * 8192 <= 89256


def test_shapes_of_the_cells_fabric():
    from portbench.reference import topology as rt
    g = rt.fat_tree3(k=16, pods=16)

    class Prog:
        class params:
            mp_range = 512

    cell = harness.Cell("c", {}, {"lanes": 4}, ROOT)
    assert harness.shapes(cell, Prog, g, 2048) == FT1024_B4


def _trace(device, ticks=2, plain_wall_s=1e-5):
    return {"ticks": ticks, "wall_s": 2e-5,
            "plain_wall_s": plain_wall_s, "flows": 2048, "device": device}


# (name, start ns, end ns): two ticks, an overlap counted once
SYNTH = [("k_a", 0, 1000), ("k_b", 500, 2000), ("k_c", 3000, 4000),
         ("void (anonymous namespace)::sack_kernel<true, true, 4>(Args)",
          6000, 8000)]


def test_busy_ops_and_idle_on_a_synthetic_trace():
    ctx = {"trace": _trace(SYNTH)}
    assert harness.busy_seconds(SYNTH) == pytest.approx(5000e-9)
    assert reader("tick.device_ms").read(ctx) == pytest.approx(5000e-6 / 2)
    assert reader("tick.device_ops").read(ctx) == 2.0
    assert reader("device.idle_share").read(ctx) == pytest.approx(50.0)
    empty = {"trace": _trace([])}
    for name in ("tick.device_ms", "tick.device_ops", "device.idle_share",
                 "kernels.roofline_share"):
        assert reader(name).read(empty | {"shapes": FT1024_B4,
                                          "hbm_bytes_per_s": 3.35e12}) \
            is None


def test_roofline_share_of_a_synthetic_trace():
    ctx = {"trace": _trace(SYNTH), "shapes": FT1024_B4,
           "hbm_bytes_per_s": 3.35e12}
    want = 100 * (2252800 / 3.35e12) / 2000e-9
    assert reader("kernels.roofline_share").read(ctx) == pytest.approx(want)


def test_breakdown_of_a_synthetic_trace():
    b = harness.breakdown(_trace(SYNTH))
    assert b["device_ops"][0] == [SYNTH[3][0], pytest.approx(2e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps == {"before k_c": pytest.approx(1e-6),
                    f"before {SYNTH[3][0]}": pytest.approx(2e-6)}


@pytest.mark.parametrize("horizons, frozen", [
    ([[768, 768, 768, 768]], 0.0),
    ([[768, 1024, 768, 1024]], 100 * (1 - 3584 / 4096)),
    ([[768, 768], [512, 1024]], 100 * (1 - 3072 / (2 * 768 + 2 * 1024))),
])
def test_frozen_share_on_hand_made_horizons(horizons, frozen):
    r = reader("driver.frozen_share").read({"horizons": horizons})
    assert r == pytest.approx(frozen)


def test_launches_per_group_tick():
    ctx = {"horizons": [[768, 1024], [512, 512]], "launches": 9 * 1536}
    assert reader("kernels.launches_per_tick").read(ctx) == 9.0
    assert reader("kernels.launches_per_tick").read({"horizons": []}) \
        is None
