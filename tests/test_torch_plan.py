"""The port's configs, sharding rule, parallelism plans and checkpoint
economics against the reference package's, on the CPU — the twins of the
plan tests of ``tests/test_traffic.py`` and of the economics and replan
tests of ``tests/test_resilience.py``.

* Every architecture of the registry equals the reference's field by
  field (``asdict``), and so do its analytic leaves, its parameter
  counts and its ``reduced`` form.
* ``param_pspec`` names the reference's axes for every leaf of every
  architecture, and for the names the planner's leaves never reach.
* ``derive_plan`` equals the reference's over every architecture x
  shape x layout on a spread of meshes; a mesh the reference rejects is
  rejected by the port with the same message.
* The analytic prices (``collective_seconds``, the plan's per-scope
  seconds) and the Young/Daly closed forms are held with ``==``: a
  reordered sum would differ in the last bit.
"""
from dataclasses import asdict

import pytest

from repro import configs as jconfigs
from repro.ckpt import checkpointing as jck
from repro.distributed import plan as jplan
from repro.distributed import sharding as jsh
from repro_torch import configs
from repro_torch.ckpt.checkpointing import (availability, effective_rate,
                                            young_daly_interval)
from repro_torch.distributed import sharding
from repro_torch.distributed.plan import (classify_leaves,
                                          collective_seconds, derive_plan,
                                          describe, replan_onto_survivors)

CFG = configs.get("deepseek-coder-33b")
MESHES = ((1, 1, 1), (2, 1, 1), (1, 4, 1), (16, 16, 1), (4, 4, 2),
          (8, 2, 4), (2, 8, 3), (3, 5, 6))


# ------------------------------------------------------------ configs

def test_registry_names_match():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert sorted(configs.SHAPES) == sorted(jconfigs.SHAPES)
    for k, s in configs.SHAPES.items():
        assert asdict(s) == asdict(jconfigs.SHAPES[k])


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_config_equals_reference(arch):
    cfg, ref = configs.get(arch), jconfigs.get(arch)
    assert asdict(cfg) == asdict(ref)
    assert cfg.param_leaves() == ref.param_leaves()
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert configs.shapes_for(cfg) == jconfigs.shapes_for(ref)
    assert asdict(configs.reduced(arch)) == asdict(jconfigs.reduced(arch))
    assert asdict(configs.pad_for_tp(cfg, 8)) \
        == asdict(jconfigs.pad_for_tp(ref, 8))


# ------------------------------------------------------- sharding rule

class _Leaf:
    def __init__(self, ndim):
        self.ndim = ndim


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_pspec_axes_equal_reference(arch):
    cfg = configs.get(arch)
    for path, shape in cfg.param_leaves():
        stacked = path[0] == "blocks"
        for dp in ("data", ("pod", "data")):
            got = sharding.param_pspec(path, _Leaf(len(shape)), dp, stacked)
            want = jsh.param_pspec(path, _Leaf(len(shape)), dp, stacked)
            assert got == tuple(want), (path, dp)
            assert len(got) == len(shape), path
    for layout in jplan.LAYOUTS:
        assert classify_leaves(cfg, layout) \
            == jplan.classify_leaves(jconfigs.get(arch), layout)


@pytest.mark.parametrize("name", ["embed", "head", "scale", "final_norm",
                                  "router", "wq", "w_in", "w_decay", "wo",
                                  "w_down", "w_out", "w_bcdt", "a_log",
                                  "decay_bias", "bonus", "dt_bias", "mix"])
def test_param_pspec_every_rule(name):
    """The names the planner's leaves never reach (norm scales, the
    Mamba and RWKV vectors, anything small) follow the reference too."""
    for stacked in (False, True):
        for nd in (1, 2, 3):
            path = (("blocks", "u0") if stacked else ()) + (name,)
            leaf = _Leaf(nd + stacked)
            assert sharding.param_pspec(path, leaf, "data", stacked) \
                == tuple(jsh.param_pspec(path, leaf, "data", stacked)), \
                (name, stacked, nd)


# -------------------------------------------------------------- plans

def _plans(cfg_arch, shape, layout, mesh):
    dp, tp, pp = mesh
    kw = dict(dp=dp, tp=tp, pp=pp, layout=layout)
    try:
        want = jplan.derive_plan(jconfigs.get(cfg_arch), shape, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            derive_plan(configs.get(cfg_arch), shape, **kw)
        assert str(got.value) == str(e)
        return None, None
    return derive_plan(configs.get(cfg_arch), shape, **kw), want


@pytest.mark.parametrize("layout", ["fsdp_tp", "tp_only"])
@pytest.mark.parametrize("shape", sorted(configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_derive_plan_equals_reference(arch, shape, layout):
    bw = 400e9 / 8
    for mesh in MESHES:
        got, want = _plans(arch, shape, layout, mesh)
        if got is None:
            continue
        assert asdict(got) == asdict(want), mesh
        assert got.devices == want.devices
        assert got.analytic_net_seconds(bw) == want.analytic_net_seconds(bw)
        assert list(got.analytic_net_seconds(bw)) \
            == list(want.analytic_net_seconds(bw))
        assert got.compute_seconds(1e15) == want.compute_seconds(1e15)
        assert got.memory_seconds(3e12) == want.memory_seconds(3e12)
        for scope in ("tp", "dp", "pp", "serve"):
            assert [asdict(d) for d in got.demands_for(scope)] \
                == [asdict(d) for d in want.demands_for(scope)]
        assert describe(got) == jplan.describe(want)
        if got.dp > 1:
            assert asdict(replan_onto_survivors(got, 1)) \
                == asdict(jplan.replan_onto_survivors(want, 1))


def test_plan_derivation_deterministic():
    a = derive_plan(CFG, "train_4k", dp=16, tp=16, layout="fsdp_tp")
    b = derive_plan(CFG, "train_4k", dp=16, tp=16, layout="fsdp_tp")
    assert a == b
    assert a.devices == 256
    assert a.param_bytes > 0 and a.tokens_per_step == a.global_batch * 4096


def test_plan_layouts_follow_sharding_rules():
    fsdp = derive_plan(CFG, "train_4k", dp=8, tp=8, layout="fsdp_tp")
    tponly = derive_plan(CFG, "train_4k", dp=8, tp=8, layout="tp_only")
    assert {"tp_stream", "dp_param", "dp_grad"} \
        <= {d.phase for d in fsdp.demands}
    assert {d.kind for d in fsdp.demands if d.phase == "dp_grad"} \
        == {"reduce_scatter", "all_reduce"}
    assert "dp_param" not in {d.phase for d in tponly.demands}
    (gar,) = [d for d in tponly.demands if d.phase == "dp_grad"]
    assert gar.kind == "all_reduce"

    def grad_s(p):
        return sum(collective_seconds(d.kind, d.n, d.bytes_per_rank, 50e9)
                   for d in p.demands if d.phase == "dp_grad")
    assert grad_s(tponly) > grad_s(fsdp)


def test_plan_decode_emits_serving_incast():
    p = derive_plan(CFG, "decode_32k", dp=4, tp=4, layout="fsdp_tp")
    kinds = {d.phase: d for d in p.demands}
    assert "serve_incast" in kinds and kinds["serve_incast"].kind == "incast"
    assert "dp_grad" not in kinds
    assert p.tokens_per_step == p.global_batch


def test_plan_validation():
    with pytest.raises(ValueError, match="layout"):
        derive_plan(CFG, "train_4k", dp=2, tp=2, layout="nope")
    with pytest.raises(ValueError, match="divide"):
        derive_plan(CFG, "train_4k", dp=2, tp=2, pp=7)
    with pytest.raises(ValueError, match=">= 1"):
        derive_plan(CFG, "train_4k", dp=0, tp=2)
    with pytest.raises(ValueError, match="unknown collective"):
        collective_seconds("bogus", 4, 1e6, 50e9)


@pytest.mark.parametrize("kind", ["all_reduce", "reduce_scatter",
                                  "all_gather", "all_to_all", "p2p",
                                  "incast"])
def test_alpha_beta_formulas(kind):
    bw = 50e9
    m = 1e9 / bw
    for n in (1, 2, 3, 4, 16):
        assert collective_seconds(kind, n, 1e9, bw) \
            == jplan.collective_seconds(kind, n, 1e9, bw)
    want = {"all_reduce": 2 * 3 / 4 * m, "all_gather": 3 * m,
            "p2p": m, "incast": 4 * m}
    if kind in want:
        assert collective_seconds(kind, 4, 1e9, bw) \
            == pytest.approx(want[kind])
    assert collective_seconds(kind, 1, 1e9, bw) == 0.0


# ------------------------------------------------ checkpoint economics

def test_young_daly_is_the_availability_argmax():
    costs = dict(write_s=2.0, detect_s=1.0, restore_s=2.0, replan_s=3.0)
    for mtbf in (600.0, 3600.0, 86400.0):
        tau = young_daly_interval(mtbf, costs["write_s"])
        assert tau == jck.young_daly_interval(mtbf, costs["write_s"])
        best = availability(tau, mtbf, **costs)
        assert best == jck.availability(tau, mtbf, **costs)
        for f in (0.25, 0.5, 0.9, 1.1, 2.0, 4.0):
            assert best > availability(tau * f, mtbf, **costs), (mtbf, f)


def test_availability_monotone_in_mtbf():
    prev = 0.0
    for mtbf in (300.0, 1800.0, 3600.0, 7200.0, 86400.0):
        kw = dict(write_s=1.5, detect_s=0.5, restore_s=1.0, replan_s=2.0)
        av = availability(young_daly_interval(mtbf, 1.5), mtbf, **kw)
        assert av == jck.availability(jck.young_daly_interval(mtbf, 1.5),
                                      mtbf, **kw)
        assert 0.0 < av < 1.0
        assert av > prev, mtbf
        prev = av


def test_economics_validation_and_effective_rate():
    for fn, args, kw, match in (
            (young_daly_interval, (0.0, 1.0), {}, "mtbf_s"),
            (young_daly_interval, (100.0, -1.0), {}, "write_s"),
            (availability, (0.0, 100.0), {"write_s": 1.0}, "interval_s"),
            (availability, (10.0, 0.0), {"write_s": 1.0}, "mtbf_s"),
            (availability, (10.0, 100.0), {"write_s": -1.0}, "write_s"),
            (availability, (10.0, 100.0),
             {"write_s": 1.0, "restore_s": -2.0}, "restore_s")):
        with pytest.raises(ValueError, match=match) as got:
            fn(*args, **kw)
        with pytest.raises(ValueError) as want:
            getattr(jck, fn.__name__)(*args, **kw)
        assert str(got.value) == str(want.value)
    av = availability(10.0, 1000.0, write_s=1.0)
    assert effective_rate(500.0, 10.0, 1000.0, write_s=1.0) == 500.0 * av
    kw = dict(write_s=1.0, detect_s=0.25, restore_s=2.0, replan_s=3.5)
    assert effective_rate(500.0, 10.0, 1000.0, **kw) \
        == jck.effective_rate(500.0, 10.0, 1000.0, **kw)


# ---------------------------------------------------------------- replan

def _train_plan(dp=4):
    return derive_plan(configs.get("deepseek-coder-33b"), "train_4k",
                       dp=dp, tp=4, layout="fsdp_tp")


def test_replan_onto_survivors():
    plan = _train_plan()
    p2 = replan_onto_survivors(plan, 1)
    assert p2.dp == plan.dp - 1
    assert (p2.tp, p2.pp, p2.arch, p2.shape, p2.layout) \
        == (plan.tp, plan.pp, plan.arch, plan.shape, plan.layout)
    assert p2.tokens_per_step == plan.tokens_per_step
    assert replan_onto_survivors(plan, 0) is plan
    with pytest.raises(ValueError, match="failed_hosts"):
        replan_onto_survivors(plan, -1)
    with pytest.raises(ValueError, match="surviving"):
        replan_onto_survivors(plan, plan.dp)
    ref = jplan.derive_plan(jconfigs.get("deepseek-coder-33b"), "train_4k",
                            dp=4, tp=4, layout="fsdp_tp")
    for k in (1, 2, 3):
        assert asdict(replan_onto_survivors(plan, k)) \
            == asdict(jplan.replan_onto_survivors(ref, k))
