"""Quickstart on the PyTorch port: the UET transport in twelve sections.

The twin of ``examples/quickstart.py`` (the JAX package's): it walks the
same scenarios through the port's entry points and prints the same
lines. The API is declarative: pick a ``TransportProfile`` (congestion
control, load balancing, per-flow delivery modes; the paper's Sec. 2.2
profile table ships as ``ai_base()`` / ``ai_full()`` / ``hpc()``), pass
numeric knobs in ``SimParams``, and call ``simulate`` /
``simulate_batch``. The sections:

  [1] a 4->1 incast under the three named profiles (one batched call),
  [2] the CC ablation (NSCC-only vs RCCC-only vs hybrid) on an outcast,
  [3] static ECMP vs REPS spraying on permutation traffic (Sec. 2.1),
  [4] a mixed ROD+RUD profile showing the in-order delivery invariant,
  [5] a failure sweep batched into one ``simulate_batch`` call,
  [6] whole collectives (dep-scheduled) + in-network reduction,
  [7] the adaptive horizon: quiescence early-exit + trace tiers,
  [8] dynamic faults: a mid-run link flap + a gray link, survived by
      the recovery loop (RTO backoff + path eviction, Sec 3.2.4),
  [9] model-driven traffic: a real model config's parallelism plan
      compiled to a dep-chained multi-collective step on the fabric and
      priced end to end,
  [10] the telemetry plane: fixed-memory probe rings that make a mid-run
      outage visible without perturbing a single bit of the simulation,
  [11] endpoint failure, priced: a host dies mid-run, the PDC liveness
      teardown detects and quarantines it, and the checkpoint-restart
      economics turn the measured costs into effective tokens/sec at
      the Young/Daly optimal checkpoint interval,
  [12] link-layer reliability (Sec 3.5): LLR replays corrupted frames at
      the hop, CBFC credits make the fabric lossless by back-pressure
      instead of trims.

Every scenario runs in chunks and stops at the first chunk boundary at
which it is quiescent, so a generous tick budget costs only what the
scenario needs. Results carry streaming statistics by default
(``trace="stats"``); ``trace="full"`` gives the dense per-tick lanes.

``SECTIONS`` holds one function per section, ``(device) -> list[str]``,
returning the lines that section prints; ``main()`` prints them in
order. The runs live on ``cuda`` unless ``--device cpu`` is given (there
is no CPU fallback).

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
from dataclasses import replace

import numpy as np

from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network import workloads
from repro_torch.network.fabric import (SimParams, Workload, simulate,
                                        simulate_batch)
from repro_torch.network.profile import (CCAlgo, DeliveryMode,
                                         TransportProfile, cc_ablation)

HEADER = "=== UET quickstart ==="


class _Lines(list):
    """The lines a section prints: ``say(text)`` is ``print(text)``."""

    def say(self, text: str) -> None:
        self.extend(text.split("\n"))


def incast_profiles(device=None) -> list:
    out = _Lines()
    out.say("\n[1] incast 4->1 across the paper's profiles (Sec 2.2) — one "
            "simulate_batch call, grouped by profile")
    g, wl, exp = workloads.incast(4, size=100000)
    profiles = [TransportProfile.ai_base(), TransportProfile.ai_full(),
                TransportProfile.hpc()]
    results = simulate_batch(g, Workload.stack([wl] * 3), profiles,
                             SimParams(ticks=1200),
                             goodput_window=(300, 1200), device=device)
    for prof, r in zip(profiles, results):
        gp = r.goodput((300, 1200))
        out.say(f"    {prof.name:8s} ({prof.describe()[len(prof.name):]}): "
                f"per-flow goodput {np.round(gp, 3)}")
    out.say(f"    (paper: {exp['share']:.2f} each is optimal; ai_base's RCCC "
            f"hits it exactly, Fig. 7 group 4)")
    return out


def cc_ablation_outcast(device=None) -> list:
    out = _Lines()
    out.say("\n[2] CC ablation on an outcast (Fig. 7 group 1): receiver "
            "credits are blind to the sender bottleneck")
    g, wl, exp = workloads.outcast(4, size=100000)
    for prof in cc_ablation():
        r = simulate(g, wl, prof, SimParams(ticks=2500),
                     goodput_window=(1200, 2500), device=device)
        out.say(f"    {prof.name:9s}: w->v share "
                f"{r.goodput((1200, 2500))[4]:.3f} "
                f"(RCCC grants {exp['rccc_w_share']:.2f}, optimum "
                f"{exp['nscc_w_share']:.2f})")
    return out


def spraying(device=None) -> list:
    out = _Lines()
    out.say("\n[3] permutation traffic: static ECMP vs REPS spraying "
            "(Sec 2.1 polarization)")
    g, wl, _ = workloads.permutation(k=8, pods=4, shift=17, size=100000)
    for scheme in (LBScheme.STATIC, LBScheme.REPS):
        r = simulate(g, wl, TransportProfile.ai_full(lb=scheme),
                     SimParams(ticks=1500), goodput_window=(700, 1500),
                     device=device)
        gp = r.goodput((700, 1500))
        out.say(f"    {scheme.name:9s}: mean {gp.mean():.3f}  "
                f"worst flow {gp.min():.3f}")
    return out


def delivery_modes(device=None) -> list:
    out = _Lines()
    out.say("\n[4] per-flow delivery modes: flow 0 ordered (ROD), flow 1 "
            "sprayed (RUD) in ONE profile (Sec 3.2.1)")
    g, wl, _ = workloads.incast(2, size=400)
    prof = TransportProfile(cc=CCAlgo.NSCC, lb=LBScheme.REPS,
                            delivery=(DeliveryMode.ROD, DeliveryMode.RUD),
                            name="mixed")
    # the in-order invariant needs the dense per-tick lanes: trace="full"
    r = simulate(g, wl, prof, SimParams(ticks=3000), trace="full",
                 device=device)
    cum = r.delivered_per_tick.cumsum(axis=0)
    in_order = bool((cum[:, 0].astype(np.uint32)
                     == r.rx_base_per_tick[:, 0]).all())
    out.say(f"    completion tick {r.completion_tick()}; ROD lane delivered "
            f"strictly in order: {in_order} (trims={int(r.state.trims)})")
    return out


def failure_sweep(device=None) -> list:
    out = _Lines()
    out.say("\n[5] failure sweep, batched: healthy + one-dead-uplink x4, "
            "one vmapped scan (REPS, Sec 3.2.4)")
    g, wls, masks, exp = workloads.failure_sweep(spines=4, hosts_per_leaf=8)
    p = SimParams(ticks=3000, timeout_ticks=64, ooo_threshold=24)
    results = simulate_batch(g, wls, TransportProfile.ai_full(lb=LBScheme.REPS),
                             p, failed=masks, goodput_window=(1500, 3000),
                             device=device)
    for i, r in enumerate(results):
        tag = "healthy   " if i == 0 else f"uplink {i - 1} dead"
        gp = r.goodput((1500, 3000)).mean()
        ref = exp["healthy_share"] if i == 0 else exp["degraded_share"]
        out.say(f"    {tag}: mean goodput {gp:.3f} (optimum {ref:.3f}, "
                f"drops {int(r.state.drops)})")
    return out


def collectives(device=None) -> list:
    out = _Lines()
    out.say("\n[6] whole collectives on the fabric: dependency-scheduled "
            "all-reduce algorithms + in-network reduction (INC)")
    # a collective is a Workload whose `dep` lane encodes the phase DAG;
    # the whole multi-phase exchange runs in one simulate_batch call, and
    # a kind x algorithm x INC grid is one batch
    from repro_torch.network import collectives as coll
    g = workloads.leaf_spine(leaves=4, spines=4, hosts_per_leaf=2)
    spec = coll.CollectiveSpec("all_reduce", tuple(range(8)), 32)
    ai = TransportProfile.ai_full()
    cfgs = [("ring", ai), ("recursive_doubling", ai), ("tree", ai),
            ("tree", replace(ai, inc=True, name="ai_full+inc"))]
    wls = coll.stack_padded([coll.build_workload(spec, a) for a, _ in cfgs])
    rs = simulate_batch(g, wls, [pr for _, pr in cfgs], SimParams(ticks=1200),
                        device=device)
    cts = {}
    for (algo, pr), r in zip(cfgs, rs):
        name = f"{algo}{'+inc' if pr.inc else ''}"
        cts[name] = coll.collective_completion_ticks(r)
        extra = (f", {int(r.state.inc_reduced)} pkts absorbed at the ToR"
                 if pr.inc else "")
        out.say(f"    {name:22s}: completion tick {cts[name]}{extra}")
    if cts["tree"] > 0 and cts["tree+inc"] > 0:
        out.say(f"    (INC-on tree finishes in "
                f"{cts['tree+inc'] / cts['tree']:.2f}x the INC-off time: the "
                f"switch reduces the incast away)")
    return out


def adaptive_horizon(device=None) -> list:
    out = _Lines()
    out.say("\n[7] adaptive horizon: the budget is a bound, not a cost")
    g, wl, _ = workloads.incast(4, size=600)
    # a wildly generous budget: the chunk loop exits at the first
    # quiescent chunk boundary, so both runs execute the same ticks
    r1 = simulate(g, wl, TransportProfile.ai_full(), SimParams(),
                  max_ticks=50_000, device=device)
    r2 = simulate(g, wl, TransportProfile.ai_full(), SimParams(),
                  max_ticks=5_000, device=device)
    out.say(f"    budget 50000: executed {r1.horizon} ticks "
            f"(completion {r1.completion_tick()}); budget 5000: executed "
            f"{r2.horizon} — same executable, same bits")
    assert r1.completion_tick() == r2.completion_tick()
    return out


def dynamic_faults(device=None) -> list:
    out = _Lines()
    out.say("\n[8] dynamic faults: links that flap and gray-fail mid-run, "
            "and the recovery loop that survives them")
    # a FaultSchedule is an input like the workload: per-queue outage
    # windows (dead while fail_at <= t < heal_at) + per-queue packet-loss
    # probability; drops are SILENT (no NACK), recovery is the
    # transport's job — RTO backoff, OOO loss inference, and EV (path)
    # eviction off dead paths
    from repro_torch.network.faults import FaultSchedule
    g = workloads.leaf_spine(leaves=2, spines=2, hosts_per_leaf=4)
    wl = Workload.of([0, 1, 2, 3], [4, 5, 6, 7], 150)
    ups = [int(g.up1_table[0, i]) for i in range(2)]
    sched = (FaultSchedule.healthy(g.num_queues)
             .flap(ups[0], 150, 500)       # uplink 0 flaps for 350 ticks
             .lossy(ups[1], 0.05))         # uplink 1 drops 5% silently
    prof = replace(TransportProfile.ai_full(lb=LBScheme.REPS),
                   ev_eviction=True, rto_backoff=2.0, name="ai_full+rec")
    r = simulate(g, wl, prof,
                 SimParams(ticks=8000, timeout_ticks=64, ooo_threshold=24),
                 faults=sched, device=device)
    out.say(f"    completion tick {r.completion_tick()} (healthy fabric "
            f"~{wl.size.max()}+): {r.timeouts} timeouts, "
            f"{r.rtx_packets} rtx, {r.ev_evictions} evictions, "
            f"{r.ticks_degraded} degraded ticks, "
            f"{int(r.state.drops)} silent drops recovered")
    assert r.completion_tick() != -1
    return out


def model_traffic(device=None) -> list:
    out = _Lines()
    out.say("\n[9] model-driven traffic: one config, plan -> schedule -> "
            "simulated step time")
    # derive the per-step collective demand from the real sharding rules
    # (ZeRO-3 param gathers, per-layer TP all-reduces, grad
    # reduce-scatter), compile it to ONE dep-chained workload on a
    # leaf-spine, simulate, and price the training step
    from repro_torch import configs
    from repro_torch.distributed.plan import derive_plan, describe
    from repro_torch.network.topology import leaf_spine
    from repro_torch.network.traffic import step_time
    plan = derive_plan(configs.get("deepseek-coder-33b"), "train_4k",
                       dp=16, tp=16, layout="fsdp_tp")
    out.say("    " + describe(plan).replace("\n", "\n    "))
    t = step_time(plan, leaf_spine(4, 2, 4), TransportProfile.ai_full(),
                  max_pkts=8, device=device)
    out.say(f"    simulated step: {t.step_s * 1e3:.1f} ms "
            f"(net {t.net_s * 1e3:.1f} ms vs {t.analytic_net_s * 1e3:.1f} ms "
            f"alpha-beta bound; compute {t.compute_s * 1e3:.1f} ms) -> "
            f"{t.tokens_per_sec:,.0f} tokens/s, "
            f"{t.time_to_train(1e12) / 86400:.1f} days to 1T tokens")
    assert t.net_s >= t.analytic_net_s
    return out


def telemetry(device=None) -> list:
    out = _Lines()
    out.say("\n[10] telemetry: fixed-memory probe rings streamed off the "
            "signals the tick already computes")
    # TelemetrySpec is static like the profile — off (the default) builds
    # no probe, on attaches a FabricTrace with decimated per-queue /
    # per-flow time series; probes never perturb the run
    from repro_torch.network.faults import FaultSchedule
    from repro_torch.network.telemetry import TelemetrySpec
    g, wl, exp = workloads.victim_sweep(pairs=4, uplinks=2, size=2500)
    sched = FaultSchedule.healthy(g.num_queues).flap(
        exp["uplinks"][0], 300, 700)
    r = simulate(g, wl, TransportProfile.ai_full(lb=LBScheme.REPS),
                 SimParams(ticks=1200, timeout_ticks=64, ooo_threshold=24),
                 faults=sched, telemetry=TelemetrySpec.on(), device=device)
    tr = r.telemetry
    pre, dur = tr.window_rates(100, 300), tr.window_rates(350, 700)
    out.say(f"    {tr.num_samples} samples at {tr.sample_spacing}-tick "
            f"spacing (ring decimated to stride {tr.stride})")
    out.say(f"    flap [300, 700): silent drops {pre['drop'].sum():.2f} -> "
            f"{dur['drop'].sum():.2f}/tick, goodput {pre['goodput']:.2f} -> "
            f"{dur['goodput']:.2f} pkts/tick — the outage is in the lanes")
    out.say("    (scripts/trace_export.py writes the same channels as "
            "Perfetto counter tracks)")
    assert dur["drop"].sum() > pre["drop"].sum()
    return out


def endpoint_failure(device=None) -> list:
    out = _Lines()
    out.say("\n[11] endpoint failure, priced: fault -> detection -> teardown "
            "-> checkpoint-restart economics")
    # host lanes ride the schedule like link lanes; detection is the
    # transport's job (pdc_dead_after consecutive zero-progress RTO
    # strikes declare the peer dead and quarantine its flows), and the
    # layers above the fabric price what the loss costs
    from repro_torch import configs
    from repro_torch.ckpt.checkpointing import (availability, effective_rate,
                                                young_daly_interval)
    from repro_torch.distributed.plan import derive_plan
    from repro_torch.network.faults import FaultSchedule
    from repro_torch.network.traffic import checkpoint_seconds, price_recovery
    g = workloads.leaf_spine(leaves=2, spines=2, hosts_per_leaf=4)
    wl = Workload.of([0, 1, 2, 6], [4, 5, 3, 0], 150)
    sched = FaultSchedule.healthy(
        g.num_queues, num_hosts=g.num_hosts).host_fail(4, 100)  # dies at 100
    prof = TransportProfile.resilient()   # NSCC + RUD + backoff + teardown
    budget = 6000
    r = simulate(g, wl, prof, SimParams(ticks=budget, timeout_ticks=64),
                 faults=sched, device=device)
    out.say(f"    host 4 dead at tick 100: detected at tick {r.abandon_tick} "
            f"({r.flows_abandoned} flows abandoned), run quiesced at "
            f"{r.horizon}/{budget} — no budget burn; survivors "
            f"{[int(c) for c in r.completion_ticks() if c > 0]}")
    assert r.horizon < budget and r.flows_abandoned > 0
    # price the full recovery loop for a real train plan: detection
    # (simulated, above), sharded-checkpoint restore, replan onto the
    # survivors — then the Young/Daly interval maximizes availability
    plan = derive_plan(configs.get("deepseek-coder-33b"), "train_4k",
                       dp=4, tp=4, layout="fsdp_tp")
    rc = price_recovery(plan, device=device)
    write_s = checkpoint_seconds(plan)
    mtbf = 3600.0
    tau = young_daly_interval(mtbf, write_s)
    kw = dict(write_s=write_s, detect_s=rc.detect_s,
              restore_s=rc.restore_s, replan_s=rc.replan_s)
    out.say(f"    recovery costs: detect {rc.detect_s * 1e3:.3f} ms "
            f"({rc.detect_ticks} ticks), restore {rc.restore_s:.2f} s, "
            f"replan {rc.replan_s:.1f} s; degraded rate "
            f"{rc.degraded_tokens_per_sec:,.0f} of "
            f"{rc.healthy_tokens_per_sec:,.0f} tokens/s")
    out.say(f"    1h MTBF: checkpoint every {tau:.0f} s (Young/Daly) -> "
            f"availability {availability(tau, mtbf, **kw):.4f}, "
            f"{effective_rate(rc.healthy_tokens_per_sec, tau, mtbf, **kw):,.0f}"
            f" effective tokens/s (vs "
            f"{effective_rate(rc.healthy_tokens_per_sec, 900.0, mtbf, **kw):,.0f}"
            f" at a naive 15-min interval)")
    assert (effective_rate(rc.healthy_tokens_per_sec, tau, mtbf, **kw)
            > effective_rate(rc.healthy_tokens_per_sec, 900.0, mtbf, **kw))
    return out


def link_layer(device=None) -> list:
    out = _Lines()
    out.say("\n[12] link-layer reliability (Sec 3.5): corruption confined to "
            "the hop by LLR replay, losslessness by CBFC credits")
    # LinkConfig is a static of the tick like TelemetrySpec: off (the
    # default) builds the pre-feature tick; llr=True arms per-queue
    # go-back-N replay (a corrupted frame is DELAYED by the link RTT,
    # never dropped), cbfc=True meters enqueues with 20-bit cyclic
    # credits (exhaustion back-pressures instead of trimming)
    from repro_torch.core.link import LinkConfig, fabric_buffer_pricing
    from repro_torch.network.telemetry import TelemetrySpec
    g, wls, scheds, exp = workloads.corruption_sweep(bers=(0.0, 0.04))
    prof, p = exp["profile"], exp["params"]
    on = simulate_batch(g, wls, prof, p, faults=scheds, link=exp["link"],
                        telemetry=TelemetrySpec.on(), device=device)
    off = simulate_batch(g, wls, prof, p, faults=scheds, device=device)
    r_llr, r_e2e = on[1], off[1]
    out.say(f"    BER 4% on {len(exp['uplinks'])} uplinks: LLR replayed "
            f"{r_llr.llr_replays} corrupted frames at their hop "
            f"({int(r_llr.drops)} e2e drops), completion "
            f"{r_llr.completion_tick()} vs {r_e2e.completion_tick()} under "
            f"e2e-only recovery ({int(r_e2e.drops)} silent drops, "
            f"{r_e2e.timeouts} RTOs)")
    llr_q = np.asarray(on[1].telemetry.final["llr_q"])
    out.say(f"    telemetry: replays landed on queues "
            f"{np.nonzero(llr_q)[0].tolist()} (the corrupted uplinks are "
            f"{list(exp['uplinks'])})")
    assert int(r_llr.drops) == 0 and int(r_e2e.drops) > 0
    assert r_llr.completion_tick() < r_e2e.completion_tick()
    # CBFC: the congested clean lane stops trimming, and the buffer it
    # needs undercuts PFC's per-(port, priority) headroom
    cb = simulate_batch(g, wls, prof, p, faults=scheds,
                        link=LinkConfig.on(llr=True, cbfc=True),
                        device=device)[0]
    bill = fabric_buffer_pricing(g.num_queues)
    out.say(f"    CBFC on the clean congested lane: {int(cb.trims)} trims "
            f"(e2e arm trimmed {int(off[0].trims)}), "
            f"{cb.credit_stall_ticks} stall ticks; lossless buffer bill "
            f"{bill['cbfc_total_bytes'] / 1e6:.1f} MB vs "
            f"{bill['pfc_total_bytes'] / 1e6:.1f} MB PFC headroom "
            f"({bill['cbfc_over_pfc']:.2f}x per port)")
    assert int(cb.trims) == 0 and cb.credit_stall_ticks > 0
    return out


#: one function per printed section, in order: ``(device) -> lines``
SECTIONS = [incast_profiles, cc_ablation_outcast, spraying, delivery_modes,
            failure_sweep, collectives, adaptive_horizon, dynamic_faults,
            model_traffic, telemetry, endpoint_failure, link_layer]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = ap.parse_args(argv).device
    print(HEADER)
    for section in SECTIONS:
        for line in section(device):
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
