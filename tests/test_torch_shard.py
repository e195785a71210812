"""The port's split of the scenario axis (``repro_torch.network.shard``)
against the reference's ``shard_map`` engine on the CPU, bitwise: the
portable twins of ``tests/test_shard.py`` (padding, ragged stats, full
trace, serial, per-profile and fault-schedule parity, the device forms,
the wide sweep ``slow``-marked as in the reference; the serial,
per-profile and fault-schedule twins are in ``test_torch_shard_groups.py``).
The sharded tests of ``tests/test_telemetry.py``,
``tests/test_link_layer.py`` and ``tests/test_resilience.py`` are in
``test_torch_shard_lanes.py``.

The reference shards over the 4 virtual CPU devices ``conftest.py``
makes; the port runs the same split over a repeated CPU device, through
``shard.run_sharded`` or ``simulate_batch(devices=(cpu,) * n)``, so its
shards, pads and per-shard stop boundaries are the same ones and run one
after another. Every lane's horizon, stat lanes, state and probe carry
is held bitwise against the reference's sharded run. The reference's
compile-cache and ``lax.cond`` fast-path tests have no twin: the port
builds its tick per call and has no fast path.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.network import fabric as jf
from repro.network import workloads as jw
from repro.network.shard import resolve_devices as jresolve
from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network import fabric as tf
from repro_torch.network import shard
from repro_torch.network import workloads as tw
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import leaf_spine
from test_torch_batch import _same_state, assert_same_results
from test_torch_faults import graphs, jprofile

torch.set_num_threads(1)

CPU = torch.device("cpu")
NDEV = len(jax.devices())
multi_device = pytest.mark.skipif(
    NDEV < 2, reason="the reference's sharded runs need >= 2 devices "
    "(tests/conftest.py makes 4 unless XLA_FLAGS is overridden)")


def _mixed_batch(b=6):
    """The reference's ragged sweep for both packages: staggered sizes,
    per-scenario seeds, one failure mask."""
    g2 = graphs(2, 4, 4)
    sizes = [40, 90, 140, 5000, 60, 220][:b]
    wls = [tf.Workload.of([0, 1, 2], [4, 5, 6], s) for s in sizes]
    jwls = jf.Workload.stack([jf.Workload.of([0, 1, 2], [4, 5, 6], s)
                              for s in sizes])
    masks = np.zeros((b, g2[0].num_queues), bool)
    masks[2, int(g2[0].up1_table[0, 0])] = True
    seeds = np.arange(b, dtype=np.uint32) + 0x5EED
    return g2, wls, jwls, masks, seeds


def _sharded(n, *args, **kw):
    """``simulate_batch`` over ``n`` shards of the CPU device."""
    return tf.simulate_batch(*args, devices=(CPU,) * n, device="cpu", **kw)


# ------------------------------------------------------------------------
# padding helpers
# ------------------------------------------------------------------------

def test_pad_scenarios_shapes_and_inertness():
    _, wls, jwls, _, _ = _mixed_batch()
    wls = tf.Workload.stack(wls)
    padded, pad = tw.pad_scenarios(wls, 4)
    jpadded, jpad = jw.pad_scenarios(jwls, 4)
    assert pad == jpad == 2 and padded.src.shape == (8, 3)
    for f in dataclasses.fields(tf.Workload):
        np.testing.assert_array_equal(getattr(padded, f.name).numpy(),
                                      np.asarray(getattr(jpadded, f.name)))
    assert (padded.size[6:] == 0).all() and (padded.dep[6:] == -1).all()
    aligned, pad0 = tw.pad_scenarios(wls, 3)
    assert pad0 == 0 and aligned is wls


def test_noop_scenarios_quiesce_at_first_chunk():
    g = leaf_spine(leaves=2, spines=2, hosts_per_leaf=2)
    rs = tf.simulate_batch(g, tw.noop_scenarios(f=2, b=2),
                           TransportProfile.ai_full(),
                           tf.SimParams(ticks=2000), device="cpu")
    for r in rs:
        assert r.horizon == tf.SimParams().chunk_ticks
        assert int(r.state.delivered.sum()) == 0


# ------------------------------------------------------------------------
# shard-vs-unshard bitwise parity
# ------------------------------------------------------------------------

@multi_device
def test_sharded_ragged_stats_parity():
    """B = 6 over 4 shards (two padding lanes), failure masks and seeds,
    the stats tier, against the reference's sharded run."""
    (g, jg), wls, jwls, masks, seeds = _mixed_batch()
    p = dict(ticks=700)
    prof = TransportProfile.ai_full(lb=LBScheme.REPS)
    win = (100, 700)
    shd = _sharded(4, g, wls, prof, tf.SimParams(**p), failed=masks,
                   seeds=seeds, goodput_window=win)
    ref = jf.simulate_batch(jg, jwls, jprofile(prof), jf.SimParams(**p),
                            failed=masks, seeds=seeds, goodput_window=win,
                            shard=True)
    assert len(shd) == 6
    assert_same_results(shd, ref)
    for i, (a, b) in enumerate(zip(shd, ref)):
        np.testing.assert_array_equal(a.goodput(win), b.goodput(win),
                                      err_msg=f"scenario {i}")


@multi_device
def test_sharded_full_trace_parity():
    (g, jg), wls, jwls, masks, seeds = _mixed_batch()
    p = dict(ticks=500)
    prof = TransportProfile.ai_full()
    shd = _sharded(4, g, wls, prof, tf.SimParams(**p), failed=masks,
                   seeds=seeds, trace="full")
    ref = jf.simulate_batch(jg, jwls, jprofile(prof), jf.SimParams(**p),
                            failed=masks, seeds=seeds, trace="full",
                            shard=True)
    assert_same_results(shd, ref)


@multi_device
@pytest.mark.slow
def test_sharded_wide_sweep_parity_four_devices():
    """A 16-scenario heterogeneous-horizon batch over 4 shards, a budget
    off the chunk grid."""
    g2 = graphs(2, 4, 8)
    (g, jg) = g2
    f = 8
    sizes = np.geomspace(40, 900, 16).astype(int)
    wls = [tf.Workload.of(list(range(f)), [f + i for i in range(f)], int(s))
           for s in sizes]
    jwls = jf.Workload.stack([jf.Workload.of(list(range(f)),
                                             [f + i for i in range(f)],
                                             int(s)) for s in sizes])
    seeds = np.arange(16, dtype=np.uint32)
    p = dict(ticks=2500, timeout_ticks=64)
    prof = TransportProfile.ai_full(lb=LBScheme.REPS)
    shd = _sharded(4, g, wls, prof, tf.SimParams(**p), seeds=seeds,
                   max_ticks=2500 - 37)
    ref = jf.simulate_batch(jg, jwls, jprofile(prof), jf.SimParams(**p),
                            seeds=seeds, max_ticks=2500 - 37, shard=True)
    assert len({r.horizon for r in shd}) > 1
    assert_same_results(shd, ref)


# ------------------------------------------------------------------------
# device resolution
# ------------------------------------------------------------------------

def test_resolve_devices_forms():
    """The reference's forms, over the devices of the run's kind (one
    ``cpu`` here: ``shard=True`` is the unsharded path there, as on a
    one-device JAX host)."""
    for args in ((None, False), (0, False), (1, False), (True, False),
                 (None, True), ([CPU], False)):
        assert shard.resolve_devices(*args, device="cpu") is None, args
    for devices in (2, 10 ** 6):
        with pytest.raises(ValueError, match="requested"):
            shard.resolve_devices(devices, False, device="cpu")
    with pytest.raises(ValueError, match="requested"):
        jresolve(10 ** 6, False)
    assert jresolve(0, False) is None and jresolve(1, False) is None
    assert shard.resolve_devices([CPU, "cpu"], False, device="cpu") == \
        (CPU, CPU)
    assert shard.available_devices("cpu") == (CPU,)
    # the cuda kind counts the cards (none here)
    assert len(shard.available_devices("cuda")) == torch.cuda.device_count()


def test_public_shard_forms_on_the_cpu():
    """``shard=True`` on the CPU runs (unsharded) and equals the plain
    run; ``devices=2`` is more devices than the CPU has; an explicit
    device list is split as given and equals the plain run."""
    (g, _), wls, _, masks, seeds = _mixed_batch(b=3)
    p = tf.SimParams(ticks=400)
    base = tf.simulate_batch(g, wls, None, p, seeds=seeds, device="cpu")
    for kw in (dict(shard=True), dict(devices=True), dict(devices=1),
               dict(devices=(CPU, CPU))):
        rs = tf.simulate_batch(g, wls, None, p, seeds=seeds, device="cpu",
                               **kw)
        for a, b in zip(base, rs):
            assert a.horizon == b.horizon, kw
            _same_state(a.state, b.state)
    with pytest.raises(ValueError, match="requested"):
        tf.simulate_batch(g, wls, None, p, devices=2, device="cpu")
