"""Model-driven traffic: ParallelismPlan -> fabric schedule -> step time
(the port of ``repro.network.traffic``, over the port's simulator).

This is the co-design surface the ROADMAP's north star asks for: the
model zoo meets the packet fabric. The pipeline has three stages:

1. **plan** (`repro_torch.distributed.plan.derive_plan`): ArchConfig + mesh
   shape -> per-step collective demand (kinds, group sizes, byte
   volumes), classified by the REAL sharding rules.
2. **compile** (`compile_step`): lower the plan to ONE fabric
   :class:`~repro_torch.network.fabric.Workload` of dep-chained phases — param
   all-gathers, a per-layer TP all-reduce stream, PP point-to-point,
   DP grad reduce-scatter/all-gather, decode-time serving incast — each
   phase's root flows gated on the previous phase's source completion at
   the same host via the ``dep`` lane, so the whole step is one
   adaptive-horizon run.
3. **price** (`price_step`): read per-phase durations from the simulated
   source-completion ticks, form a per-scope *achieved efficiency*
   (analytic serialization bound / measured ticks, in (0, 1]), and divide
   the plan's full-scale analytic seconds by it. The network term of the
   step time is therefore SIMULATED per operating point — topology,
   transport profile and sharding layout all move it — replacing the
   analytic-only `netmodel` collective term.

Scale contract: the fabric is priced on a DOWNSCALED representative
schedule (``sim_tp``/``sim_dp`` groups, ``layers_sim`` layers, sizes
clamped to ``max_pkts``) because the simulator's per-tick arbitration is
quadratic in lanes — the plan's real group sizes and byte volumes enter
through the analytic side of the efficiency ratio. TP groups map to
hosts within one leaf (TP traffic meets only host downlinks); DP groups
take one host per leaf (DP traffic crosses the oversubscribable fabric)
— which is exactly why topology and profile separate operating points.

The compiled schedule (flow count, dep structure, phase slices) is
fixed per (plan, graph) and built with numpy on the host; its lanes
move to the run's device inside ``simulate`` / ``simulate_batch``. A
sweep's scenarios of unequal flow counts are padded to one batch with
`stack_padded`, and the batch runs one tick per (graph, profile) group.

Every entry point that runs the simulator (:func:`step_time`,
:func:`price_recovery`, :func:`run_model_sweep`) takes ``device=``:
``cuda`` unless given.

The module also closes the endpoint-failure loop ABOVE the fabric
(:func:`price_recovery`): kill one DP-replica host under a
liveness-enabled profile, read the simulated fault->PDC-teardown
detection latency off ``abandon_tick``, price the sharded checkpoint
restore (:func:`checkpoint_seconds`) and the replan onto survivors
(`replan_onto_survivors` + a degraded-rate step), and hand the
resulting :class:`RecoveryCosts` to `repro_torch.ckpt.checkpointing`'s
Young/Daly closed forms for effective-throughput pricing.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.distributed.plan import (ParallelismPlan, derive_plan)
from repro_torch.network import collectives as coll
from repro_torch.network.collectives import CollectiveSpec
from repro_torch.network.fabric import SimParams, SimResult, Workload, \
    simulate, simulate_batch
from repro_torch.network.topology import QueueGraph, leaf_spine

# the compute and memory rates of the priced fleet's accelerator: the
# reference's modelled accelerator, kept so that the prices are equal
# (not the card that runs the simulator); pass ``peak_flops=`` /
# ``hbm_bw=`` to :func:`price_step` to price another
PEAK_FLOPS = 197e12
HBM_BW = 819e9


# ---------------------------------------------------------------------------
# schedule builder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PhaseSlice:
    """One dep-chained phase of the compiled step: flows [lo, hi) of the
    workload, plus the phase's analytic serialization lower bound (ticks)
    used to form the achieved-efficiency ratio."""
    name: str
    scope: str        # plan scope: tp | dp | pp | serve
    lo: int
    hi: int
    ideal_ticks: int


@dataclass(frozen=True)
class CompiledStep:
    plan: ParallelismPlan
    graph_name: str
    workload: Workload           # [F] host-id flows, dep-chained phases
    phases: tuple                # tuple[PhaseSlice, ...] in chain order
    meta: dict

    @property
    def num_flows(self) -> int:
        return int(self.workload.src.shape[0])

    def default_budget(self) -> int:
        """Tick budget with the same slack rule netmodel uses."""
        return 6 * sum(ph.ideal_ticks for ph in self.phases) + 800


class _StepBuilder:
    """Accumulates per-phase flow tables into one host-id workload (numpy
    on the host; :meth:`build` gives it as CPU tensors).

    Chaining rule: a phase's root flows (table dep == -1) gate on the
    previous phase's LAST-algorithm-phase flow from the same source host
    (so e.g. the DP phase at host h cannot start before the last TP
    phase source-completes at h); hosts with no prior flow fall back to
    the previous phase's final flow as a representative barrier.
    """

    def __init__(self):
        self.src: list = []
        self.dst: list = []
        self.size: list = []
        self.dep: list = []
        self.n = 0
        self.phases: list[PhaseSlice] = []
        self._last_map: dict[int, int] = {}
        self._last_any = -1

    def add_rings(self, name: str, scope: str, specs: "list[CollectiveSpec]",
                  algo: str = "ring"):
        """One phase of concurrent collectives (disjoint host groups)."""
        lo = self.n
        ideal = 0
        new_map: dict[int, int] = {}
        for spec in specs:
            t = coll.flow_table(spec, algo)
            hosts = np.asarray(spec.hosts, np.int64)
            off = self.n
            src = hosts[t.src]
            dep = np.where(t.dep >= 0, t.dep + off, -1).astype(np.int64)
            for j in np.nonzero(t.dep < 0)[0]:
                dep[j] = self._last_map.get(int(src[j]), self._last_any)
            self.src += src.tolist()
            self.dst += hosts[t.dst].tolist()
            self.size += t.size.tolist()
            self.dep += dep.tolist()
            pmax = int(t.phase.max())
            for j in np.nonzero(t.phase == pmax)[0]:
                new_map[int(src[j])] = off + int(j)
            self.n += len(src)
            ideal = max(ideal, coll.analytic_ticks(spec, algo))
        self._finish(name, scope, lo, ideal, new_map)

    def add_flows(self, name: str, scope: str, src, dst, size,
                  ideal_ticks: int):
        """One phase of plain dep-rooted flows (incast / p2p)."""
        lo = self.n
        new_map: dict[int, int] = {}
        for s, d, z in zip(src, dst, size):
            self.src.append(int(s))
            self.dst.append(int(d))
            self.size.append(int(z))
            self.dep.append(self._last_map.get(int(s), self._last_any))
            new_map[int(s)] = self.n
            self.n += 1
        self._finish(name, scope, lo, ideal_ticks, new_map)

    def _finish(self, name, scope, lo, ideal, new_map):
        self.phases.append(PhaseSlice(name, scope, lo, self.n,
                                      max(1, int(ideal))))
        self._last_map = new_map
        self._last_any = self.n - 1

    def build(self) -> Workload:
        return Workload.of(np.asarray(self.src, np.int32),
                           np.asarray(self.dst, np.int32),
                           np.asarray(self.size, np.int32),
                           dep=np.asarray(self.dep, np.int32))


def _pkts(nbytes: float, max_pkts: int, mtu: int) -> int:
    return min(max_pkts, max(1, math.ceil(nbytes / mtu)))


def _sim_spec(kind: str, hosts, nbytes: float, max_pkts: int,
              mtu: int) -> CollectiveSpec:
    # route through from_bytes (the >=1-packet floor for sub-packet TP
    # messages lives there), then clamp to the sim's size budget
    s = CollectiveSpec.from_bytes(kind, hosts, nbytes, mtu)
    if s.size_pkts > max_pkts:
        s = CollectiveSpec(kind, s.hosts, max_pkts)
    return s


def compile_step(plan: ParallelismPlan, g: QueueGraph, *,
                 layers_sim: int = 2, max_pkts: int = 32,
                 mtu: int = 4096) -> CompiledStep:
    """Lower a plan to one dep-chained fabric workload on graph ``g``.

    Host mapping: TP group d takes ``sim_tp`` contiguous hosts of leaf d
    (TP = intra-leaf), DP group r takes host r of each used leaf (DP =
    cross-fabric). Decode adds ``fan`` client hosts from unused leaves
    incasting into the entry host. Raises if g is too small.
    """
    leaves = int(g.host_leaf.max()) + 1
    leaf_hosts = [np.nonzero(g.host_leaf == l)[0] for l in range(leaves)]
    hp = min(len(h) for h in leaf_hosts)

    sim_tp = 1 if plan.tp == 1 else min(plan.tp, 4, hp)
    sim_dp = 1 if plan.dp == 1 else min(plan.dp, 2, leaves)
    if plan.tp > 1 and sim_tp < 2:
        raise ValueError(f"graph {g.name} has {hp} hosts/leaf; need >= 2 "
                         f"for a TP group")
    if plan.dp > 1 and sim_dp < 2:
        raise ValueError(f"graph {g.name} has {leaves} leaves; need >= 2 "
                         f"for a DP group")
    layers_sim = max(1, min(layers_sim, plan.num_layers))

    # grid[d][r] = host id of DP replica d, TP rank r
    grid = [[int(leaf_hosts[d][r]) for r in range(sim_tp)]
            for d in range(sim_dp)]
    used = {h for row in grid for h in row}
    spare = [int(h) for l in range(leaves) for h in leaf_hosts[l]
             if int(h) not in used]
    entry = grid[0][0]

    by_phase = {d.phase: d for d in plan.demands}
    b = _StepBuilder()

    # 1. ZeRO-3 param all-gathers (fsdp_tp layout; step start)
    if "dp_param" in by_phase and sim_dp > 1:
        d = by_phase["dp_param"]
        b.add_rings("dp_param", d.scope, [
            _sim_spec("all_gather", [grid[dd][r] for dd in range(sim_dp)],
                      d.bytes_per_rank, max_pkts, mtu)
            for r in range(sim_tp)])

    # 2. the per-layer TP all-reduce stream
    if "tp_stream" in by_phase and sim_tp > 1:
        d = by_phase["tp_stream"]
        for i in range(layers_sim):
            b.add_rings(f"tp_layer{i}", d.scope, [
                _sim_spec("all_reduce", grid[dd], d.bytes_per_rank,
                          max_pkts, mtu)
                for dd in range(sim_dp)])

    # 3. PP activation send to the next stage (one representative hop)
    if "pp_p2p" in by_phase:
        d = by_phase["pp_p2p"]
        if not spare:
            raise ValueError(f"graph {g.name} has no spare host for the "
                             f"PP stage")
        pp_host = spare.pop(0)
        z = _pkts(d.bytes_per_rank, max_pkts, mtu)
        b.add_flows("pp_p2p", d.scope, [entry], [pp_host], [z],
                    ideal_ticks=z)

    # 4. DP gradient collectives (train)
    if "dp_grad" in by_phase and sim_dp > 1:
        for d in plan.demands:
            if d.phase != "dp_grad":
                continue
            groups = [[grid[dd][r] for dd in range(sim_dp)]
                      for r in range(sim_tp)]
            if d.kind == "reduce_scatter":
                b.add_rings("dp_grad_rs", d.scope, [
                    _sim_spec("reduce_scatter", hs, d.bytes_per_rank,
                              max_pkts, mtu) for hs in groups])
                b.add_rings("dp_grad_ag", d.scope, [
                    _sim_spec("all_gather", hs, d.bytes_per_rank / plan.dp,
                              max_pkts, mtu) for hs in groups])
            elif d.kind == "all_reduce":
                b.add_rings("dp_grad_ar", d.scope, [
                    _sim_spec("all_reduce", hs, d.bytes_per_rank,
                              max_pkts, mtu) for hs in groups])

    # 5. decode-time serving incast into the entry host
    if "serve_incast" in by_phase:
        d = by_phase["serve_incast"]
        fan = min(d.n, len(spare))
        if fan < 2:
            raise ValueError(f"graph {g.name} has {len(spare)} spare hosts; "
                             f"need >= 2 incast clients")
        z = _pkts(d.bytes_per_rank, max_pkts, mtu)
        b.add_flows("serve_incast", d.scope, spare[:fan], [entry] * fan,
                    [z] * fan, ideal_ticks=fan * z)

    if not b.phases:
        raise ValueError("plan has no network phases to simulate "
                         "(dp == tp == pp == 1 and not decode)")

    return CompiledStep(
        plan=plan, graph_name=g.name, workload=b.build(),
        phases=tuple(b.phases),
        meta={"sim_tp": sim_tp, "sim_dp": sim_dp, "layers_sim": layers_sim,
              "entry_host": entry, "max_pkts": max_pkts, "mtu": mtu})


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StepTiming:
    """End-to-end step economics for one operating point."""
    step_s: float
    net_s: float              # simulated-efficiency network term
    analytic_net_s: float     # plan's alpha-beta lower bound
    compute_s: float
    memory_s: float
    tokens_per_sec: float     # served (decode) or trained tokens/sec
    eff: dict                 # scope -> achieved efficiency (0, 1]
    sim_ticks: int            # simulated schedule completion tick
    phases: tuple             # ({name, scope, ticks, ideal_ticks}, ...)

    def time_to_train(self, total_tokens: float = 1e12) -> float:
        """Wall seconds to push total_tokens through at this step rate."""
        return total_tokens / self.tokens_per_sec


def price_step(compiled: CompiledStep, result: SimResult, *,
               fabric=None, peak_flops: float = PEAK_FLOPS,
               hbm_bw: float = HBM_BW) -> StepTiming:
    """Price a simulated schedule: per-phase durations come from the
    streamed source-completion ticks (phases are strictly chained, so
    phase k runs from phase k-1's end to its own), per-scope efficiency
    is ideal/measured, and the plan's full-scale analytic seconds are
    divided by it. ``step_s = max(compute, memory) + net`` — no
    compute/communication overlap is modeled (documented pessimism).
    ``peak_flops`` / ``hbm_bw`` default to the reference's modelled
    accelerator (:data:`PEAK_FLOPS`, :data:`HBM_BW`)."""
    from repro_torch.distributed.netmodel import FabricSpec
    fabric = fabric or FabricSpec()
    plan = compiled.plan

    src_comp = result.source_completion_ticks()
    ideal: dict[str, int] = {}
    measured: dict[str, int] = {}
    prev_end = 0
    detail = []
    for ph in compiled.phases:
        seg = src_comp[ph.lo:ph.hi]
        if (seg < 0).any():
            raise RuntimeError(
                f"phase {ph.name} did not complete within the tick budget "
                f"({result.max_ticks}) — raise max_ticks")
        end = int(seg.max())
        dur = max(1, end - prev_end)
        prev_end = max(prev_end, end)
        ideal[ph.scope] = ideal.get(ph.scope, 0) + ph.ideal_ticks
        measured[ph.scope] = measured.get(ph.scope, 0) + dur
        detail.append({"name": ph.name, "scope": ph.scope, "ticks": dur,
                       "ideal_ticks": ph.ideal_ticks})

    eff = {s: min(1.0, ideal[s] / max(1, measured[s])) for s in measured}
    bw = fabric.link_gbps * 1e9 / 8 * fabric.links_per_chip
    analytic = plan.analytic_net_seconds(bw)
    analytic_net = sum(analytic.values())
    net = sum(t / max(eff.get(s, 1.0), 1e-6) for s, t in analytic.items())
    compute = plan.compute_seconds(peak_flops)
    memory = plan.memory_seconds(hbm_bw)
    step = max(compute, memory) + net
    return StepTiming(
        step_s=step, net_s=net, analytic_net_s=analytic_net,
        compute_s=compute, memory_s=memory,
        tokens_per_sec=plan.tokens_per_step / step,
        eff=eff, sim_ticks=prev_end, phases=tuple(detail))


def step_time(plan: ParallelismPlan, g: "QueueGraph | None" = None,
              profile=None, p: "SimParams | None" = None, *,
              faults=None, failed=None, max_ticks: "int | None" = None,
              device=None, **compile_kw) -> StepTiming:
    """Convenience: compile -> simulate -> price, one operating point
    (the run on ``device``: ``cuda`` unless given)."""
    g = g if g is not None else leaf_spine(4, 4, 4)
    compiled = compile_step(plan, g, **compile_kw)
    budget = max_ticks if max_ticks is not None else compiled.default_budget()
    r = simulate(g, compiled.workload, profile, p or SimParams(),
                 faults=faults, failed=failed, max_ticks=budget,
                 device=device)
    return price_step(compiled, r)


# ---------------------------------------------------------------------------
# recovery pricing: host fault -> PDC teardown -> checkpoint-restart economics
# ---------------------------------------------------------------------------

def checkpoint_seconds(plan: ParallelismPlan, *,
                       storage_gbps: float = 100.0,
                       state_factor: float = 3.0) -> float:
    """Seconds to write (or restore) one sharded checkpoint: every host
    moves only its own shard (one file per host), so the cost is
    per-host state bytes over per-host storage bandwidth.
    ``state_factor`` scales params to full train state (params + grads +
    optimizer moments ~ 3x for Adam at matching precision)."""
    if storage_gbps <= 0:
        raise ValueError(f"storage_gbps must be > 0, got {storage_gbps}")
    bytes_per_host = state_factor * plan.param_bytes / plan.devices
    return bytes_per_host / (storage_gbps * 1e9 / 8)


@dataclass(frozen=True)
class RecoveryCosts:
    """Measured cost of losing one host, priced in seconds — the inputs
    to :func:`repro_torch.ckpt.checkpointing.availability`.

    ``detect_s`` is SIMULATED: the gap between the scheduled host death
    and the fabric's PDC-teardown signal (``abandon_tick``), i.e. the
    backed-off RTO strike run that declares the peer unreachable.
    ``restore_s`` is the sharded checkpoint read; ``replan_s`` is one
    wasted step at the degraded (survivor) rate while the collective
    groups re-form."""
    detect_s: float
    detect_ticks: int
    restore_s: float
    replan_s: float
    healthy_tokens_per_sec: float
    degraded_tokens_per_sec: float
    flows_abandoned: int
    horizon: int              # fault run's quiescence tick
    budget: int               # fault run's tick budget

    @property
    def downtime_s(self) -> float:
        """Fixed per-failure cost, excluding the half-interval of lost
        work (that term depends on the checkpoint interval)."""
        return self.detect_s + self.restore_s + self.replan_s


def price_recovery(plan: ParallelismPlan, g: "QueueGraph | None" = None,
                   profile=None, p: "SimParams | None" = None, *,
                   fail_at: int = 64, fabric=None,
                   storage_gbps: float = 100.0, device=None,
                   **compile_kw) -> RecoveryCosts:
    """Price the endpoint-failure recovery loop for one plan.

    Three runs of the compiled step schedule:

    1. healthy — baseline tokens/sec;
    2. the same schedule with one DP-replica host killed at ``fail_at``
       under a liveness-enabled profile (``TransportProfile.resilient``
       by default): the victim's flows strike out, the PDC tears down,
       quarantine quiesces the run early, and ``abandon_tick - fail_at``
       is the measured detection latency in ticks (seconds via
       ``FabricSpec.tick_seconds``);
    3. the replanned schedule on the survivors
       (:func:`repro_torch.distributed.plan.replan_onto_survivors`) — the
       degraded rate, whose step time also prices the replan barrier.

    The three runs live on ``device`` (``cuda`` unless given). Returns a
    :class:`RecoveryCosts`; feed it to
    :func:`repro_torch.ckpt.checkpointing.availability` /
    :func:`~repro_torch.ckpt.checkpointing.effective_rate` with an MTBF
    and checkpoint interval to get effective throughput."""
    from repro_torch.distributed.netmodel import FabricSpec
    from repro_torch.distributed.plan import replan_onto_survivors
    from repro_torch.network.faults import FaultSchedule
    from repro_torch.network.profile import TransportProfile

    g = g if g is not None else leaf_spine(4, 4, 4)
    profile = profile if profile is not None else TransportProfile.resilient()
    if profile.pdc_dead_after <= 0:
        raise ValueError(f"profile {profile.name!r} has pdc_dead_after=0: "
                         f"recovery pricing needs PDC liveness teardown")
    p = p if p is not None else SimParams(timeout_ticks=64)
    fabric = fabric or FabricSpec()

    compiled = compile_step(plan, g, **compile_kw)
    sim_dp = compiled.meta["sim_dp"]
    if sim_dp < 2:
        raise ValueError(f"plan dp={plan.dp}: recovery pricing needs a DP "
                         f"axis to lose (dp >= 2)")
    budget = compiled.default_budget() + 8000

    healthy = price_step(
        compiled,
        simulate(g, compiled.workload, profile, p, max_ticks=budget,
                 device=device),
        fabric=fabric)

    # kill DP replica (sim_dp - 1)'s first host: the last leaf's rank-0
    # host in compile_step's grid — a full replica loss, not a TP peer
    victim = int(np.nonzero(np.asarray(g.host_leaf) == sim_dp - 1)[0][0])
    sched = FaultSchedule.healthy(
        g.num_queues, num_hosts=g.num_hosts).host_fail(victim, fail_at)
    rf = simulate(g, compiled.workload, profile, p, faults=sched,
                  max_ticks=budget, device=device)
    if rf.flows_abandoned == 0 or rf.abandon_tick < 0:
        raise RuntimeError(
            f"host {victim} died at tick {fail_at} but no flow was "
            f"abandoned within {budget} ticks — liveness teardown never "
            f"fired (pdc_dead_after={profile.pdc_dead_after})")
    detect_ticks = int(rf.abandon_tick) - fail_at
    detect_s = detect_ticks * fabric.tick_seconds

    plan2 = replan_onto_survivors(plan, 1)
    compiled2 = compile_step(plan2, g, **compile_kw)
    degraded = price_step(
        compiled2,
        simulate(g, compiled2.workload, profile, p,
                 max_ticks=compiled2.default_budget(), device=device),
        fabric=fabric)

    return RecoveryCosts(
        detect_s=detect_s, detect_ticks=detect_ticks,
        restore_s=checkpoint_seconds(plan, storage_gbps=storage_gbps),
        replan_s=degraded.step_s,
        healthy_tokens_per_sec=healthy.tokens_per_sec,
        degraded_tokens_per_sec=degraded.tokens_per_sec,
        flows_abandoned=int(rf.flows_abandoned),
        horizon=int(rf.horizon), budget=budget)


# ---------------------------------------------------------------------------
# the co-design sweep: topology x profile x sharding plan x model
# ---------------------------------------------------------------------------

def default_topologies() -> list:
    """(label, graph): full-bisection vs 2:1-oversubscribed leaf-spine."""
    return [("full", leaf_spine(4, 4, 4)),
            ("oversub2", leaf_spine(4, 2, 4))]


def default_profiles() -> list:
    from repro_torch.network.profile import TransportProfile
    return [TransportProfile.ai_base(), TransportProfile.ai_full(),
            TransportProfile.hpc()]


def model_sweep_scenarios(arch_names=("deepseek-coder-33b", "mixtral-8x22b"),
                          shape: str = "decode_32k", *,
                          dp: int = 16, tp: int = 16,
                          topologies=None, profiles=None,
                          layouts=("fsdp_tp", "tp_only"),
                          max_pkts: int = 32):
    """Build the co-design grid: every (arch, topology, profile, layout)
    operating point as one scenario. Returns (graphs, workloads,
    profiles, points) aligned by index — feed the first three straight
    into ONE ``simulate_batch`` call (per-scenario graphs + profiles)."""
    from repro_torch import configs
    topologies = topologies if topologies is not None else default_topologies()
    profiles = profiles if profiles is not None else default_profiles()

    graphs, wls, profs, points = [], [], [], []
    for arch in arch_names:
        cfg = configs.get(arch)
        for layout in layouts:
            plan = derive_plan(cfg, shape, dp=dp, tp=tp, layout=layout)
            for tlabel, g in topologies:
                compiled = compile_step(plan, g, max_pkts=max_pkts)
                for prof in profiles:
                    graphs.append(g)
                    wls.append(compiled.workload)
                    profs.append(prof)
                    points.append({
                        "arch": arch, "shape": shape, "layout": layout,
                        "topology": tlabel, "profile": prof.name,
                        "dp": dp, "tp": tp, "compiled": compiled})
    return graphs, wls, profs, points


def run_model_sweep(arch_names=("deepseek-coder-33b", "mixtral-8x22b"),
                    shape: str = "decode_32k", *,
                    dp: int = 16, tp: int = 16,
                    topologies=None, profiles=None,
                    layouts=("fsdp_tp", "tp_only"),
                    p: "SimParams | None" = None,
                    max_ticks: "int | None" = None,
                    shard: bool = False, devices=None,
                    device=None) -> list:
    """Run the whole co-design grid in ONE ``simulate_batch`` call
    (scenarios grouped per (topology, profile), one tick each) and price
    every operating point. Returns one dict per point with the simulated
    step time, network term, efficiencies and tokens/sec. The batch runs
    on ``device`` (``cuda`` unless given); ``shard`` / ``devices`` split
    its scenario axis as in ``simulate_batch``."""
    graphs, wls, profs, points = model_sweep_scenarios(
        arch_names, shape, dp=dp, tp=tp, topologies=topologies,
        profiles=profiles, layouts=layouts)
    budget = max_ticks if max_ticks is not None else max(
        pt["compiled"].default_budget() for pt in points)
    rs = simulate_batch(graphs, coll.stack_padded(wls), profs,
                        p or SimParams(), max_ticks=budget,
                        shard=shard, devices=devices, device=device)
    out = []
    for pt, r in zip(points, rs):
        compiled = pt.pop("compiled")
        timing = price_step(compiled, r)
        out.append({
            **pt,
            "step_s": timing.step_s, "net_s": timing.net_s,
            "analytic_net_s": timing.analytic_net_s,
            "compute_s": timing.compute_s, "memory_s": timing.memory_s,
            "tokens_per_sec": timing.tokens_per_sec,
            "sim_ticks": timing.sim_ticks,
            "eff": {k: round(v, 4) for k, v in timing.eff.items()},
        })
    return out


# ---------------------------------------------------------------------------
# canary: one small config, sim within a band of analytic
# ---------------------------------------------------------------------------

def _canary(device=None) -> int:
    """Traffic canary: one small config priced end to end; the simulated
    network term must land within [1, 10]x of the plan's alpha-beta
    lower bound. Runs on ``device`` (``cuda`` unless given)."""
    from repro_torch import configs
    from repro_torch.network.profile import TransportProfile

    cfg = configs.get("deepseek-coder-33b")
    plan = derive_plan(cfg, "decode_32k", dp=4, tp=4, layout="fsdp_tp")
    g = leaf_spine(4, 2, 4)
    t0 = time.time()
    timing = step_time(plan, g, TransportProfile.ai_full(), device=device)
    ratio = timing.net_s / max(timing.analytic_net_s, 1e-12)
    print(f"traffic canary: {plan.arch} x {plan.shape} on {g.name}: "
          f"step={timing.step_s * 1e3:.3f} ms "
          f"net={timing.net_s * 1e3:.3f} ms "
          f"(analytic {timing.analytic_net_s * 1e3:.3f} ms, "
          f"sim/analytic {ratio:.2f}x) "
          f"tok/s={timing.tokens_per_sec:.0f} "
          f"[{time.time() - t0:.1f}s]")
    assert 1.0 <= ratio <= 10.0, (
        f"simulated network term {ratio:.2f}x analytic is outside the sane "
        f"band [1, 10] — scheduling or pricing regression")
    assert timing.sim_ticks > 0 and timing.step_s > 0
    print("traffic canary OK")
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the traffic canary")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    from repro_torch.network import traffic as _canonical
    raise SystemExit(_canonical._canary(ap.parse_args().device))
