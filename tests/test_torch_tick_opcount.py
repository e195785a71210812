"""The port's tick dispatches at most so many PyTorch operations outside
its kernel entry points, on the CPU (``scripts/torch_port_opcount.py``'s
count, its default configuration: ``fat_tree3(k=6, pods=3)``, two
permutations, F = 54 flows, B = 1).

On a card each counted operation that is not a view is one device
operation, so the limits pin the tick's host-bound launch count: with
NSCC's ACK update and Quick Adapt (``ops.nscc_ack`` / ``nscc_epoch``)
and the ECMP injection and routing walks (``ops.ecmp_inject`` /
``ecmp_route``) one kernel each, ``ai_full`` counts 416, ``hpc()`` 431
and ``ai_base`` 437 (537, 552 and 513 when those four ran as eager
compositions).
"""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.network import fabric
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import fat_tree3

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "torch_port_opcount.py"
TICKS = 8   # warm-up ticks, then as many counted


def _opcount():
    spec = importlib.util.spec_from_file_location("torch_port_opcount", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("profile,limit", [("ai_full", 425), ("hpc", 440),
                                           ("ai_base", 445)])
def test_tick_op_count_stays_under_its_limit(profile, limit):
    oc = _opcount()
    g = fat_tree3(k=6, pods=3)
    counts = oc.tick_op_counts(
        g, oc.healthy_workload(1), getattr(TransportProfile, profile)(),
        fabric.SimParams(), FaultSchedule.healthy(g.num_queues, batch=1,
                                                  device="cpu"), TICKS)
    assert sorted(counts) == list(range(TICKS, 2 * TICKS))
    # the tick never syncs with the host: the same operations every tick
    assert len(set(counts.values())) == 1, counts
    assert 0 < counts[TICKS] <= limit, (profile, counts[TICKS], limit)


def test_kernel_entries_are_paused_and_restored():
    """The count leaves out exactly the ``ops`` entry points it names,
    the four tick forms among them, and puts them back."""
    from repro_torch.kernels import ops
    oc = _opcount()
    for name in ("nscc_ack", "nscc_epoch", "ecmp_inject", "ecmp_route"):
        assert name in oc.KERNEL_ENTRIES
    before = {n: getattr(ops, n) for n in oc.KERNEL_ENTRIES}
    count = oc._Count()
    with oc._entries_paused(count):
        assert all(getattr(ops, n) is not before[n] for n in before)
    assert all(getattr(ops, n) is before[n] for n in before)
