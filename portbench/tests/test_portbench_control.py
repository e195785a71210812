"""``correct`` comes out false when the timed path is wrong, at a size
the CPU runs: the bfloat16 control in the program's place, and a run
with the program broken underneath (a step that leaves its state as it
was, half of the batch left out, an answer altered where the tick makes
it). One chip holds each cell, so no exchange between chips can be left
out."""
import dataclasses

import pytest
import torch

from portbench import control, harness

from conftest import TINY

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", sorted(TINY))
def test_an_unbroken_run_is_correct(tiny, cell):
    res = harness.run_cell(tiny, cell, 2 ** 31 + 3, 0.1, False, CPU, 0.0)
    assert res["correct"], res["check"]
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_bf16_control_fails(tiny, cell):
    rows = control.control(tiny, cell, [1, 2 ** 31 + 1], CPU)
    for row in rows:
        assert row["elements_differing"] > harness.LIMITS[
            "elements_differing"], row


def _broken_step(monkeypatch, fault):
    from repro_torch.network import fabric
    make_step = fabric.make_step

    def broken(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(s, tick, wl, faults):
            ns, out = step(s, tick, wl, faults)
            return fault(s, ns, tick), out
        return run
    monkeypatch.setattr(fabric, "make_step", broken)


def _unchanged(s, ns, tick):
    return s


def _altered(s, ns, tick):
    if tick != 3:
        return ns
    hot = torch.zeros_like(ns.delivered)
    hot[0, 0] = 1
    return dataclasses.replace(ns, delivered=ns.delivered + hot)


@pytest.mark.parametrize("fault", [_unchanged, _altered])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_broken_step_is_not_correct(tiny, cell, fault, monkeypatch):
    _broken_step(monkeypatch, fault)
    res = harness.run_cell(tiny, cell, 11, 0.1, False, CPU, 0.0)
    assert not res["correct"]
    assert res["checks"]["elements_differing"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_half_the_batch_left_out_is_not_correct(tiny, cell, monkeypatch):
    from repro_torch.network import fabric
    simulate_batch = fabric.simulate_batch

    def half(g, wls, profile, p, *, faults=None, seeds=None, **kw):
        B = int(wls.src.shape[0])
        keep = torch.arange(B // 2)
        rs = simulate_batch(g, wls.lanes(keep), profile, p,
                            faults=None if faults is None
                            else faults.lanes(keep),
                            seeds=seeds[:B // 2], **kw)
        return rs + rs[:B - B // 2]
    monkeypatch.setattr(fabric, "simulate_batch", half)
    res = harness.run_cell(tiny, cell, 12, 0.1, False, CPU, 0.0)
    assert not res["correct"]
