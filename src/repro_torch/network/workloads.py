"""Canonical traffic patterns (Fig. 7 and friends) — the port of
``repro.network.workloads``, copied from its builders, which import no
JAX of their own but reach it through the reference's ``Workload``.

Each single-scenario builder returns (QueueGraph, Workload, dict of
expectations); the sweeps return a [B, F] stacked Workload (and masks or
profiles) to feed to ``repro_torch.network.fabric.simulate_batch``. The
expectations encode the paper's quantitative claims:

* incast (Fig. 7, group 4): j,k,l,m -> i. RCCC assigns 25% each — optimal.
* outcast (Fig. 7, group 1): o -> p,q,r,v plus w -> v. The sender o can
  only source 25% per flow; RCCC at v blindly grants 50/50, wasting 25% of
  v's ingress — w *could* get 75%. NSCC converges to ~75%.
* in-network (Fig. 7, groups 2/3): 12 pairs across a 3:1-oversubscribed
  uplink set deliver 33% each; a same-leaf flow into one of the receivers
  could take 67% but RCCC grants it only 50%.
* permutation: all-to-all-shifted full-rate traffic — the spraying /
  polarization benchmark (Sec. 2.1).

The fault grids (``fault_sweep``, ``host_fault_sweep``,
``corruption_sweep``) return [B, Q] / [B, H] fault schedules beside the
workloads; ``collective_sweep`` is the collective ablation grid (kind x
algorithm x INC on/off x profile) as one batch.
"""
from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch

from repro_torch.core.lb.schemes import LBScheme
from repro_torch.core.link import LinkConfig
from repro_torch.network.fabric import SimParams, Workload
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import CCAlgo, TransportProfile, cc_ablation
from repro_torch.network.topology import fat_tree3, leaf_spine


# ------------------------------------------------------------------------
# scenario-axis padding
# ------------------------------------------------------------------------

def noop_scenarios(f: int, b: int, device="cpu") -> Workload:
    """[b, f] inert scenario lanes: zero-size flows (src == dst == host
    0, no deps, no reduction groups). A zero-size flow is source- and
    receiver-complete from tick 0, never becomes eligible to inject, and
    leaves queues and the control ring untouched — the lane is quiescent
    at the first chunk boundary and freezes there."""
    z = torch.zeros((b, f), dtype=torch.int32, device=device)
    neg1 = torch.full((b, f), -1, dtype=torch.int32, device=device)
    return Workload(src=z, dst=z.clone(), size=z.clone(), start=z.clone(),
                    dep=neg1, red=neg1.clone())


def pad_scenarios(wls: Workload, multiple: int) -> "tuple[Workload, int]":
    """Pad a stacked [B, F] workload along the scenario axis up to a
    multiple of ``multiple`` with :func:`noop_scenarios` lanes. Lanes are
    independent, so padding never changes a real lane's bits. Returns
    (padded, pad_count)."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    b, f = (int(d) for d in wls.src.shape)
    pad = (-b) % multiple
    if pad == 0:
        return wls, 0
    extra = noop_scenarios(f, pad, wls.src.device)
    return Workload(*(torch.cat([getattr(wls, fl.name),
                                 getattr(extra, fl.name)])
                      for fl in fields(Workload))), pad


# ------------------------------------------------------------------------
# scenario sweeps (batched: feed to fabric.simulate_batch)
# ------------------------------------------------------------------------

def victim_sweep(pairs: int = 12, uplinks: int = 4, size: int = 100000):
    """The canonical victim-share scenario: the Fig. 7 in-network
    oversubscription pattern (:func:`in_network`) at bench scale —
    `pairs` cross-leaf flows squeezed through `uplinks` spine links
    while one same-leaf "victim" flow shares one of the receivers.
    Returns ``(g, wl, exp)`` with ``exp["victim_flow"]`` the index of the
    discriminating same-leaf flow and ``exp["uplinks"]`` the leaf-0
    uplink queue ids (the contended links)."""
    g, wl, exp = in_network(pairs, uplinks, size=size)
    return g, wl, dict(
        exp, victim_flow=pairs,
        uplinks=tuple(int(g.up1_table[0, i]) for i in range(uplinks)))


def profile_ablation_sweep(pairs: int = 12, uplinks: int = 4,
                           size: int = 100000):
    """The paper's operating-point grid as ONE ``simulate_batch`` call:
    the three named profiles (ai_base / ai_full / hpc) plus the CC
    ablation over the ai_full composition (NSCC-only vs RCCC-only vs
    hybrid vs open-loop), all on the Fig. 7 in-network oversubscription
    pattern (:func:`victim_sweep`). The victim flow's share is the
    discriminator: ~0.5 under blind receiver credits, rising toward the
    ``1 - uplinks/pairs`` optimum under NSCC's network signals.

    Returns (g, wls [P, F], profiles [P], names [P], expectations); pass
    the profiles list straight to ``simulate_batch(g, wls, profiles,
    p)``, which groups the scenarios by profile.
    """
    g, wl, exp = victim_sweep(pairs, uplinks, size=size)
    profiles = [TransportProfile.ai_base(), TransportProfile.ai_full(),
                TransportProfile.hpc(), *cc_ablation(),
                replace(TransportProfile.ai_full(), cc=CCAlgo.NONE,
                        name="open_loop")]
    wls = Workload.stack([wl] * len(profiles))
    return g, wls, profiles, [p.name for p in profiles], exp


def collective_sweep(n: int = 8, size: int = 40, hosts_per_leaf: int = 2):
    """The collective ablation grid — kind x algorithm x INC on/off x
    transport profile — as ONE ``simulate_batch`` call.

    Scenarios (15 with the defaults): all-reduce x {ring,
    recursive_doubling, tree} x {INC off, on} under both ai_full (NSCC)
    and ai_base (RCCC), then reduce-scatter / all-gather / all-to-all
    (ring schedules, ai_full, INC off). Flow counts differ, so the
    workloads are padded with inert size-0 flows
    (``collectives.stack_padded``) into one [B, Fmax] batch. Every
    scenario runs under an ``inc=True`` profile and the off lanes carry
    ``red = -1`` (bitwise the ``inc=False`` tick), so INC on/off is a
    data axis and the grid is one tick per transport profile.

    ``size`` must stay <= SimParams.max_cwnd for the ai_base x INC
    lanes: RCCC's receiver only grants credits to flows it has seen, and
    a fully absorbed INC member never surfaces at the receiver.

    Returns (g, wls [B, Fmax], profiles [B], names [B]).
    """
    from repro_torch.network import collectives as coll

    leaves = max(2, -(-n // hosts_per_leaf))
    g = leaf_spine(leaves=leaves, spines=4, hosts_per_leaf=hosts_per_leaf)
    hosts = tuple(range(n))
    grid = []
    for prof in (TransportProfile.ai_full(), TransportProfile.ai_base()):
        for kind, algo in (("all_reduce", "ring"),
                           ("all_reduce", "recursive_doubling"),
                           ("all_reduce", "tree")):
            for inc in (False, True):
                grid.append((prof, kind, algo, inc))
    for kind in ("reduce_scatter", "all_gather", "all_to_all"):
        grid.append((TransportProfile.ai_full(), kind, "ring", False))

    wls, profiles, names = [], [], []
    for prof, kind, algo, inc in grid:
        spec = coll.CollectiveSpec(kind, hosts, size)
        wls.append(coll.build_workload(spec, algo, inc_groups=inc))
        profiles.append(replace(prof, inc=True, name=prof.name + "+inc"))
        names.append(f"{prof.name}/{kind}/{algo}{'/inc' if inc else ''}")
    return g, coll.stack_padded(wls), profiles, names


def failure_sweep(spines: int = 4, hosts_per_leaf: int = 8,
                  size: int = 100000):
    """One scenario per failed leaf-0 uplink, plus a no-failure baseline
    (the REPS failure-mitigation experiment, Sec. 3.2.4, as a batch):
    scenario 0 is healthy; scenario 1+i kills uplink i. Returns (g,
    wls [S+1, F], masks [S+1, Q], expectations)."""
    g = leaf_spine(leaves=2, spines=spines, hosts_per_leaf=hosts_per_leaf)
    f = hosts_per_leaf
    wl = Workload.of(list(range(f)), [f + i for i in range(f)], size)
    b = spines + 1
    masks = np.zeros((b, g.num_queues), bool)
    for i in range(spines):
        masks[1 + i, int(g.up1_table[0, i])] = True
    wls = Workload.stack([wl] * b)
    live = (spines - 1) / spines
    return g, wls, masks, {
        "healthy_share": min(1.0, spines / f),
        "degraded_share": live * spines / f,  # (S-1) live uplinks over F flows
    }


def fault_sweep(spines: int = 4, hosts_per_leaf: int = 8, size: int = 600,
                flap_at: int = 150, heal_at: int = 1200, gray_p: float = 0.05):
    """The dynamic-fault grid as one batch, over cross-leaf pairs sharing
    leaf 0's uplinks: 0 healthy; 1 one uplink flaps over [flap_at,
    heal_at); 2 two uplinks flap, the second offset by half the window;
    3 one gray uplink losing ``gray_p``; 4 one losing ``4 * gray_p``; 5
    one uplink dies at ``flap_at`` for good. Every scenario keeps a
    healthy uplink, so with a sane transport every flow completes.
    Returns (g, wls [6, F], faults [6, Q], expectations)."""
    g = leaf_spine(leaves=2, spines=spines, hosts_per_leaf=hosts_per_leaf)
    f = hosts_per_leaf
    wl = Workload.of(list(range(f)), [f + i for i in range(f)], size)
    ups = [int(g.up1_table[0, i]) for i in range(spines)]
    mid = flap_at + (heal_at - flap_at) // 2
    healthy = FaultSchedule.healthy(g.num_queues)
    scheds = [
        healthy,
        healthy.flap(ups[0], flap_at, heal_at),
        healthy.flap(ups[0], flap_at, heal_at).flap(ups[1], mid,
                                                    mid + (heal_at - flap_at)),
        healthy.lossy(ups[0], gray_p),
        healthy.lossy(ups[0], min(1.0, 4 * gray_p)),
        healthy.flap(ups[0], flap_at),
    ]
    names = ["healthy", "flap_1", "flap_2_staggered", f"gray_{gray_p:g}",
             f"gray_{min(1.0, 4 * gray_p):g}", "dead_mid"]
    wls = Workload.stack([wl] * len(scheds))
    return g, wls, FaultSchedule.stack(scheds), {
        "names": names,
        "surviving_uplinks_min": spines - 2,  # scenario 2's worst moment
    }


def host_fault_sweep(spines: int = 4, hosts_per_leaf: int = 4,
                     size: int = 600, fail_at: int = 100,
                     stall_heal: int = 800, budget: int = 6000):
    """The endpoint-failure grid as one batch under the ``resilient``
    profile's PDC liveness teardown, over cross-leaf pairs (flow i:
    leaf-0 host i -> leaf-1 host i): 0 ``host_dead`` (flow 1's source
    and flow 0's destination die at ``fail_at`` for good: both flows
    must be abandoned and the run quiesce early); 1 the same under a
    ``pdc_dead_after=0`` twin (burns the budget); 2 ``nic_stall``
    (flow 0's source NIC frozen over [fail_at, stall_heal), ACK-live:
    nothing abandoned); 3 ``healthy``. Returns (g, wls [4, F], faults
    [4, Q] / [4, H], expectations) with ``["profile"]`` the
    per-scenario profile list, ``["dead_flows"]`` and ``["budget"]``."""
    g = leaf_spine(leaves=2, spines=spines, hosts_per_leaf=hosts_per_leaf)
    f = hosts_per_leaf
    wl = Workload.of(list(range(f)), [f + i for i in range(f)], size)
    prof = TransportProfile.resilient()
    prof_off = replace(prof, pdc_dead_after=0, name="resilient-pdc_off")
    healthy = FaultSchedule.healthy(g.num_queues, num_hosts=g.num_hosts)
    dead = healthy.host_fail([1, f], fail_at)   # flow 1 src, flow 0 dst
    stall = healthy.nic_stall(0, fail_at, stall_heal)
    scheds = [dead, dead, stall, healthy]
    names = ["host_dead", "host_dead_pdc_off", "nic_stall", "healthy"]
    wls = Workload.stack([wl] * len(scheds))
    return g, wls, FaultSchedule.stack(scheds), {
        "names": names,
        "profile": [prof, prof_off, prof, prof],
        "dead_flows": (0, 1),
        "budget": budget,
    }


def corruption_sweep(bers=(0.0, 0.01, 0.03, 0.08), pairs: int = 4,
                     uplinks: int = 2, size: int = 400, budget: int = 6000):
    """The link-corruption grid as one batch: the victim-share pattern
    (:func:`victim_sweep`) with a per-scenario bit-error rate on leaf
    0's uplinks, the BER axis of the BER x LLR-on/off grid. The LLR axis
    is the ``link=`` static, so it cannot ride the scenario axis: run the
    same batch twice, with ``link=exp["link"]`` (LLR armed: corruption
    replayed at the hop) and with ``link=None`` (corruption leaks into
    end-to-end recovery). The BER = 0 lane is the inertness anchor:
    there the two arms agree bitwise on every pre-link lane. Returns (g, wls [B, F], faults [B, Q],
    expectations) with ``["link"]`` / ``["cbfc"]`` the two link specs,
    ``["params"]`` the shared SimParams, ``["profile"]``, ``["bers"]`` /
    ``["names"]``, ``["uplinks"]`` and ``["budget"]``."""
    g, wl, exp = victim_sweep(pairs, uplinks, size=size)
    healthy = FaultSchedule.healthy(g.num_queues)
    scheds = [healthy.corrupt(exp["uplinks"], ber) if ber else healthy
              for ber in bers]
    wls = Workload.stack([wl] * len(scheds))
    return g, wls, FaultSchedule.stack(scheds), dict(
        exp,
        names=[f"ber_{ber:g}" for ber in bers],
        bers=tuple(float(b) for b in bers),
        link=LinkConfig.on(llr=True),
        cbfc=LinkConfig.on(llr=True, cbfc=True),
        params=SimParams(ticks=budget, timeout_ticks=256, ooo_threshold=24),
        profile=TransportProfile.ai_full(lb=LBScheme.REPS),
        budget=budget,
    )


def size_sweep(sizes, fan_in: int = 4):
    """Incast message-size sweep: same flow set, per-scenario sizes.
    Returns (g, wls [B, F], expectations)."""
    g = leaf_spine(leaves=fan_in + 1, spines=4, hosts_per_leaf=4)
    dst = 0
    srcs = [4 * (l + 1) for l in range(fan_in)]
    wls = Workload.stack(
        [Workload.of(srcs, [dst] * fan_in, int(s)) for s in sizes])
    return g, wls, {"share": 1.0 / fan_in}


def incast(fan_in: int = 4, size: int = 600):
    """`fan_in` senders on distinct leaves -> one destination host."""
    g = leaf_spine(leaves=fan_in + 1, spines=4, hosts_per_leaf=4)
    dst = 0  # host 0 on leaf 0
    srcs = [4 * (l + 1) for l in range(fan_in)]  # first host of other leaves
    wl = Workload.of(srcs, [dst] * fan_in, size)
    return g, wl, {"share": 1.0 / fan_in}


def outcast(fan_out: int = 4, size: int = 500):
    """One source o -> `fan_out` dests; plus w -> v (v also fed by o).

    Hosts: o = 0 (leaf 0); dests p,q,r on leaves 1..3; v on leaf 4;
    w = host on leaf 5. Flow layout: flows 0..3 from o, flow 4 = w->v.
    """
    g = leaf_spine(leaves=6, spines=4, hosts_per_leaf=4)
    o = 0
    dests = [4, 8, 12, 16][:fan_out]  # p, q, r, v
    v = dests[-1]
    w = 20
    src = [o] * fan_out + [w]
    dst = dests + [v]
    wl = Workload.of(src, dst, size)
    return g, wl, {
        "o_share": 1.0 / fan_out,      # o fair-shares its uplink
        "rccc_w_share": 0.5,            # RCCC blindly grants v's ingress 50/50
        "nscc_w_share": 1.0 - 1.0 / fan_out,  # NSCC lets w fill the rest (75%)
    }


def in_network(pairs: int = 12, uplinks: int = 4, size: int = 500):
    """`pairs` cross-leaf flows share `uplinks` spine links (3:1 oversub),
    plus one same-leaf flow into one of the receivers.

    Two leaves with `pairs` hosts each + `uplinks` spines. Flow i: host i on
    leaf 0 -> host i on leaf 1. Extra flow: another host on leaf 1 -> host 0
    on leaf 1 (same-leaf, bypasses the fabric bottleneck).
    """
    hosts_per_leaf = pairs + 1
    g = leaf_spine(leaves=2, spines=uplinks, hosts_per_leaf=hosts_per_leaf)
    src = [i for i in range(pairs)]
    dst = [hosts_per_leaf + i for i in range(pairs)]
    # same-leaf flow: last host of leaf 1 -> first host of leaf 1
    src.append(hosts_per_leaf + pairs)
    dst.append(hosts_per_leaf + 0)
    wl = Workload.of(src, dst, size)
    cross = uplinks / pairs
    return g, wl, {
        "cross_share": cross,                  # 4/12 = 33%
        "rccc_local_share": 0.5,               # RCCC blind grant
        "optimal_local_share": 1.0 - cross,    # 67%
    }


def permutation(k: int = 8, pods: int = 4, shift: int = 17, size: int = 400):
    """Cross-pod permutation on the Fig. 2 fat tree: host i -> (i+shift)%H.

    Full-bisection network: optimum is 100% per flow; static single-path
    ECMP collides and polarizes, spraying restores near-full throughput.
    """
    g = fat_tree3(k=k, pods=pods)
    H = g.num_hosts
    src = list(range(H))
    dst = [(i + shift) % H for i in range(H)]
    wl = Workload.of(src, dst, size)
    return g, wl, {"share": 1.0}


def two_flow_collision(size: int = 400):
    """Two cross-pod flows that *may* share a path depending on their EVs —
    the Sec. 2.1 collision scenario (25% same-pod / 6.25% cross-pod)."""
    g = fat_tree3(k=8, pods=4)
    # same pod, different leaves: hosts 0 (leaf 0) and 5 (leaf 1) -> pod 1
    wl = Workload.of([0, 5], [16, 21], size)
    return g, wl, {}
