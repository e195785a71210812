"""The port's workload grids (``repro_torch.network.workloads``) against
the reference builders they copy, on the CPU: each builder's graph
tables, workload lanes and expectation dicts, at the builders' defaults
and at small sizes; and three sweeps end to end through both packages'
``simulate_batch`` (the profile ablation's seven profiles, the failure
sweep's [B, Q] masks, the size sweep), bitwise, plus the padding lanes
staying inert."""
import dataclasses

import numpy as np
import pytest

from repro.network import fabric as jf
from repro.network import workloads as jw
from repro_torch import convert
from repro_torch.network import fabric as tf
from repro_torch.network import workloads as tw
from test_torch_batch import assert_same_results

BUILDERS = [
    ("incast", (), {}), ("incast", (3, 50), {}),
    ("outcast", (), {}), ("outcast", (3, 20), {}),
    ("in_network", (), {}), ("in_network", (4, 2, 30), {}),
    ("permutation", (), {}), ("permutation", (4, 2, 3, 10), {}),
    ("two_flow_collision", (), {}),
    ("victim_sweep", (), {}), ("victim_sweep", (4, 2, 40), {}),
]


def _same_graph(a, b):
    for name in a.__dataclass_fields__:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


def _same_workload(wl, jwl):
    d = convert.workload_to_numpy(wl)
    for f in dataclasses.fields(jf.Workload):
        want = np.asarray(getattr(jwl, f.name))
        assert d[f.name].dtype == want.dtype, f.name
        np.testing.assert_array_equal(d[f.name], want, err_msg=f.name)


def _same_profiles(ps, jps):
    assert [q.describe() for q in ps] == [q.describe() for q in jps]


@pytest.mark.parametrize("name,args,kw", BUILDERS,
                         ids=[f"{n}{a}" for n, a, _ in BUILDERS])
def test_builder_matches_reference(name, args, kw):
    g, wl, exp = getattr(tw, name)(*args, **kw)
    jg, jwl, jexp = getattr(jw, name)(*args, **kw)
    _same_graph(g, jg)
    _same_workload(wl, jwl)
    assert exp == jexp


@pytest.mark.parametrize("args", [(), (4, 2, 40)])
def test_profile_ablation_sweep_matches_reference(args):
    g, wls, profs, names, exp = tw.profile_ablation_sweep(*args)
    jg, jwls, jprofs, jnames, jexp = jw.profile_ablation_sweep(*args)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    _same_profiles(profs, jprofs)
    assert names == jnames and exp == jexp and len(profs) == 7


@pytest.mark.parametrize("args", [(), (2, 4, 50)])
def test_failure_sweep_matches_reference(args):
    g, wls, masks, exp = tw.failure_sweep(*args)
    jg, jwls, jmasks, jexp = jw.failure_sweep(*args)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    np.testing.assert_array_equal(masks, jmasks)
    assert exp == jexp


@pytest.mark.parametrize("sizes", [(100, 400), (7,)])
def test_size_sweep_matches_reference(sizes):
    g, wls, exp = tw.size_sweep(sizes)
    jg, jwls, jexp = jw.size_sweep(sizes)
    _same_graph(g, jg)
    _same_workload(wls, jwls)
    assert exp == jexp


@pytest.mark.parametrize("f,b,multiple", [(5, 3, 4), (2, 4, 2), (3, 1, 1)])
def test_noop_and_pad_scenarios_match_reference(f, b, multiple):
    _same_workload(tw.noop_scenarios(f, b), jw.noop_scenarios(f, b))
    g, wl, _ = tw.incast(3, 20)
    _, jwl, _ = jw.incast(3, 20)
    wls = tf.Workload.stack([wl] * b)
    padded, pad = tw.pad_scenarios(wls, multiple)
    jpadded, jpad = jw.pad_scenarios(jf.Workload.stack([jwl] * b), multiple)
    assert pad == jpad
    _same_workload(padded, jpadded)
    with pytest.raises(ValueError, match="multiple"):
        tw.pad_scenarios(wls, 0)


# --------------------------------------------- sweeps through the engine --

def test_profile_ablation_sweep_runs_bitwise():
    """The seven profiles as one call in both packages, bitwise."""
    g, wls, profs, _, exp = tw.profile_ablation_sweep(4, 2, 40)
    jg, jwls, jprofs, _, _ = jw.profile_ablation_sweep(4, 2, 40)
    p = dict(ticks=256, chunk_ticks=64)
    port = tf.simulate_batch(g, wls, profs, tf.SimParams(**p), device="cpu")
    ref = jf.simulate_batch(jg, jwls, jprofs, jf.SimParams(**p))
    assert_same_results(port, ref)
    assert exp["victim_flow"] == 4


def test_failure_sweep_runs_bitwise():
    g, wls, masks, _ = tw.failure_sweep(2, 4, 50)
    jg, jwls, jmasks, _ = jw.failure_sweep(2, 4, 50)
    p = dict(ticks=256, chunk_ticks=64, timeout_ticks=64)
    port = tf.simulate_batch(g, wls, None, tf.SimParams(**p), failed=masks,
                             trace="full", device="cpu")
    ref = jf.simulate_batch(jg, jwls, None, jf.SimParams(**p),
                            failed=jmasks, trace="full")
    assert_same_results(port, ref)
    assert port[0].drops == 0 and all(r.drops for r in port[1:])


def test_size_sweep_with_padding_runs_bitwise():
    """Padded no-op lanes quiesce at the first boundary and leave the
    real lanes' bits alone."""
    g, wls, _ = tw.size_sweep((20, 60, 40))
    jg, jwls, _ = jw.size_sweep((20, 60, 40))
    padded, pad = tw.pad_scenarios(wls, 4)
    p = dict(ticks=256, chunk_ticks=32)
    port = tf.simulate_batch(g, padded, None, tf.SimParams(**p),
                             device="cpu")
    ref = jf.simulate_batch(jg, jwls, None, jf.SimParams(**p))
    assert pad == 1 and len(port) == 4
    assert_same_results(port[:3], ref)
    assert port[3].horizon == 32 and not port[3].state.delivered.any()
