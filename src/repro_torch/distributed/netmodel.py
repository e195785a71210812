"""UET-aware collective network model — the bridge between the paper's
transport and the training framework (the port of
``repro.distributed.netmodel``, over the port's simulator).

Given the collective byte counts parsed from a compiled step (the dry-run
artifacts), this module estimates collective wall time on a UET backend
fabric two ways:

1. `analytic_collective_time` — algorithmic lower bound: ring/tree costs
   on `links` of `link_gbps`, the classical alpha-beta model. This is the
   roofline's collective term.
2. `simulated_collective_time` — run the WHOLE multi-phase collective
   (dependency-scheduled ring / recursive-doubling / tree schedules from
   `repro_torch.network.collectives`) through the packet-level UET fabric
   simulator under a chosen transport profile, optionally with
   in-network reduction (INC), and price the collective term from the
   actual simulated completion tick. This replaced the seed's
   single-phase steady-state proxy (now removed): phase dependencies,
   stragglers, algorithm choice and switch-resident reduction all show
   up in the number. Full multi-collective *step* pricing — plan ->
   schedule -> simulated step time — lives in
   `repro_torch.network.traffic`.

`simulated_efficiency` = analytic / simulated time for the same spec —
the derate factor the roofline and the sharding planner consume
(term = bytes / (chips * link_bw * efficiency)).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.lb.schemes import LBScheme
from repro_torch.network.fabric import SimParams, simulate
from repro_torch.network.topology import leaf_spine


@dataclass(frozen=True)
class FabricSpec:
    link_gbps: float = 400.0   # per ICI/NIC link — paper's design point
    links_per_chip: int = 1
    mtu: int = 4096

    @property
    def tick_seconds(self) -> float:
        """One simulator tick == one MTU serialization on one link."""
        return self.mtu / (self.link_gbps * 1e9 / 8 * self.links_per_chip)


def analytic_collective_time(kind: str, bytes_total: float, chips: int,
                             fabric: FabricSpec = FabricSpec()) -> float:
    """Alpha-beta time for one collective of `bytes_total` output bytes.

    Ring all-reduce moves 2*(n-1)/n of the data per chip; all-gather and
    reduce-scatter (n-1)/n; all-to-all (n-1)/n across bisection;
    collective-permute exactly its payload.
    """
    bw = fabric.link_gbps * 1e9 / 8 * fabric.links_per_chip
    per_chip = bytes_total / max(chips, 1)
    n = max(chips, 2)
    factor = {
        "all-reduce": 2 * (n - 1) / n,
        "all-gather": (n - 1) / n,
        "reduce-scatter": (n - 1) / n,
        "all-to-all": (n - 1) / n,
        "collective-permute": 1.0,
    }.get(kind, 1.0)
    return per_chip * factor / bw


def collective_term_seconds(coll_bytes: dict, chips: int,
                            fabric: FabricSpec = FabricSpec(),
                            efficiency: float = 1.0) -> float:
    """Total collective seconds for a {kind: bytes} dict (per-device HLO
    numbers -> aggregate wall estimate at `efficiency` of line rate)."""
    t = 0.0
    for kind, b in coll_bytes.items():
        if kind == "total":
            continue
        t += analytic_collective_time(kind, b * chips, chips, fabric)
    return t / max(efficiency, 1e-6)


def analytic_time_for_spec(kind: str, size_pkts: int, chips: int,
                           fabric: FabricSpec = FabricSpec()) -> float:
    """Alpha-beta bound for a per-rank-INPUT-denominated collective (the
    `repro_torch.network.collectives` convention, size in MTU packets).
    `analytic_collective_time` is OUTPUT-denominated; the two differ for
    all-gather, whose output is n x the per-rank input block."""
    kind = kind.replace("_", "-")
    mult = chips if kind == "all-gather" else 1
    return analytic_collective_time(
        kind, size_pkts * mult * fabric.mtu * chips, chips, fabric)


# ---------------------------------------------------------------------------
# packet-level collective time from the UET simulator
# ---------------------------------------------------------------------------

def _collective_fabric(chips: int, hosts_per_leaf: int, oversub: int):
    leaves = max(1, -(-chips // hosts_per_leaf))
    return leaf_spine(leaves=leaves, spines=max(2, leaves // max(oversub, 1)),
                      hosts_per_leaf=hosts_per_leaf)


def simulated_collective_time(kind: str = "all-reduce",
                              bytes_total: "float | None" = None,
                              chips: int = 8, *,
                              size_pkts: "int | None" = None,
                              algo: str = "ring",
                              profile=None,
                              inc: bool = False,
                              fabric: FabricSpec = FabricSpec(),
                              hosts_per_leaf: int = 4,
                              oversub: int = 1,
                              trimming: bool = True,
                              ticks: "int | None" = None,
                              device=None) -> float:
    """Wall seconds for ONE whole collective, measured on the packet
    fabric: the dependency-scheduled schedule (ring / recursive_doubling
    / tree) runs to completion inside one compiled scan and the result
    is the source-completion tick times the MTU serialization time.

    Give the payload either as `bytes_total` (collective output bytes,
    converted to per-rank packets at `fabric.mtu`) or directly as
    `size_pkts` (per-rank packets). `inc=True` switches on in-network
    reduction (meaningful for the tree algorithm's fan-in phase).

    Raises RuntimeError if the collective does not complete within the
    tick budget (default: 6x the serialization lower bound + slack).
    The run lives on ``device``: ``cuda`` unless given.
    """
    from repro_torch.network import collectives as coll
    from repro_torch.network.profile import TransportProfile

    if size_pkts is None:
        if bytes_total is None:
            raise ValueError("give bytes_total or size_pkts")
        per_rank = bytes_total / max(chips, 1)
        if kind.replace("_", "-") == "all-gather":
            # bytes_total is OUTPUT-denominated (HLO convention) but the
            # schedule wants the per-rank INPUT block = output/n
            per_rank /= max(chips, 1)
        spec = coll.CollectiveSpec.from_bytes(kind, range(chips), per_rank,
                                              fabric.mtu)
    else:
        spec = coll.CollectiveSpec(kind, tuple(range(chips)), int(size_pkts))
    if profile is None:
        profile = TransportProfile.ai_full()
    if inc and not profile.inc:
        profile = replace(profile, inc=True, name=profile.name + "+inc")
    g = _collective_fabric(chips, hosts_per_leaf, oversub)
    wl = coll.build_workload(spec, algo)
    est = coll.analytic_ticks(spec, algo)
    budget = ticks if ticks is not None else 6 * est + 800
    # the run exits at its first quiescent chunk boundary, so a generous
    # budget costs nothing
    r = simulate(g, wl, profile, SimParams(trimming=trimming),
                 max_ticks=budget, device=device)
    ct = coll.collective_completion_ticks(r)
    if ct < 0:
        raise RuntimeError(
            f"collective {spec.kind}/{algo} on {chips} chips did not "
            f"complete within {budget} ticks — raise ticks=")
    return ct * fabric.tick_seconds


def simulated_efficiency(kind: str = "all-reduce", hosts: int = 8,
                         size_pkts: int = 64,
                         lb: "LBScheme | None" = None,
                         profile=None,
                         algo: str = "ring",
                         inc: bool = False,
                         trimming: bool = True,
                         oversub: int = 1,
                         ticks: "int | None" = None,
                         device=None) -> float:
    """Achieved efficiency of one collective on the packet-level UET
    fabric: analytic alpha-beta time / simulated completion time, in
    (0, 1]. This is the derate the roofline collective term divides by.

    ``profile`` selects the full transport composition; ``lb`` is the
    shorthand for the common collective ablation axis (ai_full profile
    with that scheme). Passing both is ambiguous and raises. The run
    lives on ``device``: ``cuda`` unless given.
    """
    from repro_torch.network.profile import TransportProfile
    if profile is None:
        profile = TransportProfile.ai_full(
            lb=LBScheme.OBLIVIOUS if lb is None else lb)
    elif lb is not None:
        raise ValueError("pass either profile= or lb=, not both — encode "
                         "the LB scheme in the profile")
    fabric = FabricSpec()
    t_sim = simulated_collective_time(
        kind, chips=hosts, size_pkts=size_pkts, algo=algo, profile=profile,
        inc=inc, fabric=fabric, oversub=oversub, trimming=trimming,
        ticks=ticks, device=device)
    t_ana = analytic_time_for_spec(kind, size_pkts, hosts, fabric)
    return float(min(1.0, t_ana / max(t_sim, 1e-12)))
