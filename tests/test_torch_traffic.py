"""Model-driven traffic on the port against the reference package, on the
CPU — the twins of the compile, batch, fault and pricing tests of
``tests/test_traffic.py`` and of the priced-recovery tests of
``tests/test_resilience.py``.

* ``compile_step`` lowers the same plan on the same graph to the same
  workload, lane by lane, and to the same phases and meta, over train /
  decode, both layouts, a pipeline stage and two packet clamps; the
  refusals carry the reference's messages.
* Every simulated step runs through both packages and is held bitwise
  (horizon, stats or trace lanes, every state lane and counter); the
  priced ``StepTiming`` and ``RecoveryCosts`` are then ``==`` to the
  reference's, field by field, floats included — the pricing sums
  python floats over dicts in insertion order, so a reordered sum would
  differ in the last bit.
* The co-design sweep through one ``simulate_batch`` equals serial runs
  and the reference's batch; its mixed-Q batch refuses faults.
* Then the reference tests' own assertions on the port's results.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import plan as jplan
from repro.network import collectives as jcoll
from repro.network import fabric as jf
from repro.network import faults as jfl
from repro.network import topology as jt
from repro.network import traffic as jtr
from repro_torch import configs
from repro_torch.distributed.netmodel import FabricSpec
from repro_torch.distributed.plan import derive_plan
from repro_torch.network import collectives as coll
from repro_torch.network import traffic
from repro_torch.network.fabric import SimParams, simulate, simulate_batch
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import leaf_spine
from test_torch_batch import assert_same_results
from test_torch_faults import jprofile

torch.set_num_threads(1)

ARCH = "deepseek-coder-33b"
CFG = configs.get(ARCH)
AI = TransportProfile.ai_full()
LANES = ("src", "dst", "size", "start", "dep", "red")


def _plans(shape, layout="fsdp_tp", **mesh):
    return (derive_plan(CFG, shape, layout=layout, **mesh),
            jplan.derive_plan(jconfigs.get(ARCH), shape, layout=layout,
                              **mesh))


def _compiled(shape, graph=(4, 2, 4), layout="fsdp_tp", max_pkts=32,
              **mesh):
    plan, jp = _plans(shape, layout, **mesh)
    g, jg = leaf_spine(*graph), jt.leaf_spine(*graph)
    c = traffic.compile_step(plan, g, max_pkts=max_pkts)
    jc = jtr.compile_step(jp, jg, max_pkts=max_pkts)
    return (g, c), (jg, jc)


def _same_compiled(c, jc):
    for lane in LANES:
        np.testing.assert_array_equal(
            getattr(c.workload, lane).numpy(),
            np.asarray(getattr(jc.workload, lane)), err_msg=lane)
    assert [asdict(ph) for ph in c.phases] == [asdict(ph) for ph in jc.phases]
    assert c.meta == jc.meta and c.graph_name == jc.graph_name
    assert asdict(c.plan) == asdict(jc.plan)
    assert c.num_flows == jc.num_flows
    assert c.default_budget() == jc.default_budget()


def _same_timing(t, jt_):
    """Every StepTiming field ==, the dicts in the same key order."""
    assert asdict(t) == asdict(jt_)
    assert list(t.eff) == list(jt_.eff)
    assert t.time_to_train() == jt_.time_to_train()


# --------------------------------------------------------- compilation

@pytest.mark.parametrize("shape,layout,mesh,graph,max_pkts", [
    ("train_4k", "fsdp_tp", dict(dp=16, tp=16), (4, 2, 4), 32),
    ("train_4k", "tp_only", dict(dp=16, tp=16), (4, 4, 4), 32),
    ("train_4k", "fsdp_tp", dict(dp=4, tp=4), (4, 2, 4), 8),
    ("train_4k", "fsdp_tp", dict(dp=4, tp=2, pp=2), (4, 2, 4), 32),
    ("decode_32k", "fsdp_tp", dict(dp=16, tp=16), (4, 2, 4), 32),
    ("decode_32k", "tp_only", dict(dp=4, tp=4), (4, 4, 4), 8),
    ("prefill_32k", "fsdp_tp", dict(dp=8, tp=1), (4, 2, 4), 32),
    ("long_500k", "tp_only", dict(dp=1, tp=8), (3, 2, 6), 32),
])
def test_compiled_step_equals_reference(shape, layout, mesh, graph,
                                        max_pkts):
    (_, c), (_, jc) = _compiled(shape, graph, layout, max_pkts, **mesh)
    _same_compiled(c, jc)
    assert c.workload.src.dtype == torch.int32
    assert c.workload.src.device.type == "cpu"


def test_compiled_step_bitwise_deterministic():
    (g, c1), _ = _compiled("train_4k", dp=16, tp=16)
    c2 = traffic.compile_step(c1.plan, g)
    assert c1.phases == c2.phases
    for lane in LANES:
        assert torch.equal(getattr(c1.workload, lane),
                           getattr(c2.workload, lane)), lane


def test_compiled_phases_are_dep_chained():
    (_, c), _ = _compiled("train_4k", dp=16, tp=16)
    dep = c.workload.dep.numpy()
    names = [ph.name for ph in c.phases]
    assert names[0] == "dp_param"
    assert [n for n in names if n.startswith("tp_layer")]
    assert names[-3:] == ["dp_grad_rs", "dp_grad_ag", "dp_grad_ar"]
    for k, ph in enumerate(c.phases):
        roots = [f for f in range(ph.lo, ph.hi) if dep[f] < ph.lo]
        assert roots, ph.name
        if k == 0:
            assert all(dep[f] == -1 for f in roots)
        else:
            prev = c.phases[k - 1]
            assert all(prev.lo <= dep[f] < prev.hi for f in roots), ph.name


def test_dp_cannot_start_before_last_tp_completes():
    """The full-trace run of the compiled train step, bitwise the
    reference's; then every DP-grad root flow's first delivery lands
    after its gating TP flow source-completed at the same host."""
    (g, c), (jg, jc) = _compiled("train_4k", dp=4, tp=4, max_pkts=8)
    r = simulate(g, c.workload, AI, SimParams(), trace="full",
                 max_ticks=c.default_budget(), device="cpu")
    j = jf.simulate(jg, jc.workload, jprofile(AI), jf.SimParams(),
                    trace="full", max_ticks=jc.default_budget())
    assert_same_results([r], [j])
    src_comp = r.source_completion_ticks()
    dep = c.workload.dep.numpy()
    src = c.workload.src.numpy()
    last_tp = max((ph for ph in c.phases if ph.name.startswith("tp_layer")),
                  key=lambda ph: ph.lo)
    (dp_rs,) = [ph for ph in c.phases if ph.name == "dp_grad_rs"]
    delivered = r.delivered_per_tick
    checked = 0
    for f in range(dp_rs.lo, dp_rs.hi):
        if dep[f] < dp_rs.lo:
            gate = int(dep[f])
            assert last_tp.lo <= gate < last_tp.hi
            assert src[gate] == src[f]
            first = int(np.argmax(delivered[:, f] > 0))
            assert delivered[:, f].sum() > 0
            assert first > int(src_comp[gate]) > 0
            checked += 1
    assert checked > 0
    _same_timing(traffic.price_step(c, r), jtr.price_step(jc, j))


@pytest.mark.parametrize("case", ["hosts/leaf", "leaves", "no network"])
def test_compile_rejects_too_small_graphs(case):
    shape, mesh, graph = {
        "hosts/leaf": ("train_4k", dict(dp=4, tp=4), (4, 2, 1)),
        "leaves": ("train_4k", dict(dp=4, tp=4), (1, 2, 8)),
        "no network": ("train_4k", dict(dp=1, tp=1), (4, 2, 4)),
    }[case]
    plan, jp = _plans(shape, **mesh)
    with pytest.raises(ValueError) as want:
        jtr.compile_step(jp, jt.leaf_spine(*graph))
    with pytest.raises(ValueError, match=case.split()[0]) as got:
        traffic.compile_step(plan, leaf_spine(*graph))
    assert str(got.value) == str(want.value)


def test_compile_rejects_missing_pp_and_incast_hosts():
    """No spare host for the PP stage, and too few incast clients: the
    reference's messages."""
    for shape, mesh in (("train_4k", dict(dp=2, tp=2, pp=2)),
                        ("decode_32k", dict(dp=2, tp=2))):
        graph = (2, 2, 2)   # the 2 x 2 grid takes every host
        plan, jp = _plans(shape, **mesh)
        with pytest.raises(ValueError) as want:
            jtr.compile_step(jp, jt.leaf_spine(*graph))
        with pytest.raises(ValueError, match="spare host") as got:
            traffic.compile_step(plan, leaf_spine(*graph))
        assert str(got.value) == str(want.value)


def test_price_step_raises_on_budget_exhaustion():
    (g, c), _ = _compiled("decode_32k", dp=4, tp=4, max_pkts=8)
    r = simulate(g, c.workload, AI, SimParams(), max_ticks=4, device="cpu")
    with pytest.raises(RuntimeError, match="max_ticks"):
        traffic.price_step(c, r)


# ------------------------------------------------------------ pricing

@pytest.fixture(scope="module")
def decode_step():
    """The decode step (dp = tp = 4, fsdp_tp, 8-packet clamp) on the
    oversubscribed leaf-spine under ai_full, through both packages."""
    (g, c), (jg, jc) = _compiled("decode_32k", dp=4, tp=4, max_pkts=8)
    r = simulate(g, c.workload, AI, SimParams(),
                 max_ticks=c.default_budget(), device="cpu")
    j = jf.simulate(jg, jc.workload, jprofile(AI), jf.SimParams(),
                    max_ticks=jc.default_budget())
    assert_same_results([r], [j])
    return g, c, r, jc, j


def test_step_time_equals_reference(decode_step):
    g, c, r, jc, j = decode_step
    t = traffic.step_time(c.plan, g, AI, max_pkts=8, device="cpu")
    jt_ = jtr.step_time(jc.plan, jt.leaf_spine(4, 2, 4), jprofile(AI),
                        max_pkts=8)
    _same_timing(t, jt_)
    _same_timing(t, traffic.price_step(c, r))


def test_price_step_equals_reference_off_the_defaults(decode_step):
    """Another fleet: a slower fabric, other accelerator rates."""
    from repro.distributed.netmodel import FabricSpec as JFabricSpec
    _, c, r, jc, j = decode_step
    kw = dict(peak_flops=1e15, hbm_bw=3e12)
    _same_timing(
        traffic.price_step(c, r, fabric=FabricSpec(link_gbps=200.0,
                                                   links_per_chip=2), **kw),
        jtr.price_step(jc, j, fabric=JFabricSpec(link_gbps=200.0,
                                                 links_per_chip=2), **kw))


def test_priced_net_term_at_least_analytic(decode_step):
    _, c, r, _, _ = decode_step
    t = traffic.price_step(c, r)
    assert t.net_s >= t.analytic_net_s > 0
    assert all(0 < v <= 1 for v in t.eff.values())
    assert t.step_s == pytest.approx(max(t.compute_s, t.memory_s) + t.net_s)
    assert t.time_to_train(1e9) == pytest.approx(1e9 / t.tokens_per_sec)


def test_train_step_time_equals_reference():
    """The train step (every dp_grad phase) on the full-bisection graph."""
    plan, jp = _plans("train_4k", dp=4, tp=4)
    t = traffic.step_time(plan, leaf_spine(4, 4, 4), AI, max_pkts=8,
                          device="cpu")
    jt_ = jtr.step_time(jp, jt.leaf_spine(4, 4, 4), jprofile(AI),
                        max_pkts=8)
    _same_timing(t, jt_)
    assert [d["name"] for d in t.phases][-3:] \
        == ["dp_grad_rs", "dp_grad_ag", "dp_grad_ar"]


def test_step_time_monotone_under_link_flap():
    """Flapping a leaf uplink during the step can only slow it down;
    both priced steps equal the reference's."""
    plan, jp = _plans("decode_32k", dp=4, tp=4)
    g, jg = leaf_spine(4, 2, 4), jt.leaf_spine(4, 2, 4)
    ups = [int(g.up1_table[h, 0]) for h in range(4)]
    healthy = traffic.step_time(plan, g, AI, max_pkts=8, device="cpu")
    flap = FaultSchedule.healthy(g.num_queues).flap(ups, fail_at=5,
                                                    heal_at=120)
    faulty = traffic.step_time(plan, g, AI, faults=flap, max_pkts=8,
                               device="cpu")
    jflap = jfl.FaultSchedule.healthy(jg.num_queues).flap(
        ups, fail_at=5, heal_at=120)
    _same_timing(faulty, jtr.step_time(jp, jg, jprofile(AI), faults=jflap,
                                       max_pkts=8))
    assert faulty.sim_ticks >= healthy.sim_ticks
    assert faulty.step_s >= healthy.step_s


# ------------------------------------------------------- batch parity

def _sweep(**kw):
    profs = [AI, TransportProfile.hpc()]
    args = dict(arch_names=(ARCH,), dp=4, tp=4, layouts=("fsdp_tp",),
                max_pkts=8, **kw)
    return (traffic.model_sweep_scenarios(profiles=profs, **args),
            jtr.model_sweep_scenarios(profiles=[jprofile(q) for q in profs],
                                      **args))


def test_sweep_batch_matches_serial_including_incast():
    """The decode sweep (serving incast included) through ONE
    simulate_batch call: bitwise the serial runs and the reference's
    batch, across two topologies of different queue counts."""
    (graphs, wls, profs, points), (jgraphs, jwls, jprofs, jpoints) = _sweep()
    assert len({g.num_queues for g in graphs}) == 2
    for pt, jpt in zip(points, jpoints):
        assert {k: v for k, v in pt.items() if k != "compiled"} \
            == {k: v for k, v in jpt.items() if k != "compiled"}
        _same_compiled(pt["compiled"], jpt["compiled"])
    budget = max(pt["compiled"].default_budget() for pt in points)
    rs = simulate_batch(graphs, coll.stack_padded(wls), profs, SimParams(),
                        max_ticks=budget, device="cpu")
    js = jf.simulate_batch(jgraphs, jcoll.stack_padded(jwls), jprofs,
                           jf.SimParams(), max_ticks=budget)
    assert_same_results(rs, js)
    for g, wl, prof, r in zip(graphs, wls, profs, rs):
        r_serial = simulate(g, wl, prof, SimParams(), max_ticks=budget,
                            device="cpu")
        np.testing.assert_array_equal(
            r.source_completion_ticks()[:wl.src.shape[0]],
            r_serial.source_completion_ticks())


def test_mixed_topology_batch_rejects_faults():
    (graphs, wls, profs, _), _ = _sweep()
    with pytest.raises(ValueError, match="num_queues"):
        simulate_batch(graphs, coll.stack_padded(wls), profs, SimParams(),
                       failed=(0,), max_ticks=100, device="cpu")


def test_run_model_sweep_equals_reference():
    """The sweep's priced points, both layouts and two profiles on the
    two default topologies, == the reference's."""
    profs = [AI, TransportProfile.hpc()]
    kw = dict(arch_names=(ARCH,), dp=4, tp=4)
    pts = traffic.run_model_sweep(profiles=profs, device="cpu", **kw)
    jpts = jtr.run_model_sweep(profiles=[jprofile(q) for q in profs], **kw)
    assert pts == jpts
    assert [list(p["eff"]) for p in pts] == [list(p["eff"]) for p in jpts]
    by = {(p["layout"], p["topology"], p["profile"]): p["step_s"]
          for p in pts}
    for topo in ("full", "oversub2"):
        for prof in ("ai_full", "hpc"):
            assert by[("fsdp_tp", topo, prof)] > by[("tp_only", topo, prof)]


# ------------------------------------------------------ priced recovery

def _train_plans(dp=4):
    return _plans("train_4k", dp=dp, tp=4)


def test_price_recovery_rejects_unlosable_plans():
    for kw, match in (({"plan": _train_plans(dp=1)}, "DP axis"),
                      ({"plan": _train_plans(), "profile": AI},
                       "pdc_dead_after")):
        plan, jp = kw.pop("plan")
        with pytest.raises(ValueError) as want:
            jtr.price_recovery(jp, **({"profile": jprofile(kw["profile"])}
                                      if kw else {}))
        with pytest.raises(ValueError, match=match) as got:
            traffic.price_recovery(plan, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    plan, jp = _train_plans()
    with pytest.raises(ValueError, match="storage_gbps"):
        traffic.checkpoint_seconds(plan, storage_gbps=0.0)
    for kw in ({}, {"storage_gbps": 25.0, "state_factor": 2.0}):
        assert traffic.checkpoint_seconds(plan, **kw) \
            == jtr.checkpoint_seconds(jp, **kw)


@pytest.mark.slow
def test_price_recovery_end_to_end():
    """The full loop, every RecoveryCosts field == the reference's; then
    the reference test's assertions on the port's costs."""
    from repro_torch.ckpt.checkpointing import effective_rate
    plan, jp = _train_plans()
    rc = traffic.price_recovery(plan, device="cpu")
    assert asdict(rc) == asdict(jtr.price_recovery(jp))
    assert rc.detect_ticks > 0 and rc.detect_s > 0
    assert rc.flows_abandoned > 0
    assert rc.horizon < rc.budget
    assert rc.restore_s == pytest.approx(traffic.checkpoint_seconds(plan))
    assert 0 < rc.degraded_tokens_per_sec < rc.healthy_tokens_per_sec
    assert rc.replan_s > 0 and rc.downtime_s > rc.restore_s
    eff = effective_rate(rc.healthy_tokens_per_sec, 60.0, 3600.0,
                         write_s=traffic.checkpoint_seconds(plan),
                         detect_s=rc.detect_s, restore_s=rc.restore_s,
                         replan_s=rc.replan_s)
    assert 0 < eff < rc.healthy_tokens_per_sec
