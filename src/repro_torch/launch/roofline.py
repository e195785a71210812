"""The roofline's collective pieces — the port of ``ring_time``,
``kind_sizes_from_reports``, ``uet_efficiencies`` and
``model_flops_per_device`` of ``repro.launch.roofline``.

``uet_efficiencies`` derates each collective kind by the packet-level
UET simulator: the analytic alpha-beta time over the simulated,
dependency-scheduled completion on a representative leaf-spine. Its
fabric run is the port's ``simulate_batch`` on ``device`` (``cuda``
unless given), so it launches the tick kernels once a tick.

The reference's ``analyze`` / ``main`` read the XLA cost reports that
``repro.launch.dryrun`` writes (HLO FLOPs, bytes, collective volumes of
the compiled fleet step) and price them with the reference's modelled
accelerator; the port has no such reports, so they are not ported.
"""
from __future__ import annotations

import math

#: bytes/s of one link, the reference roofline's modelled interconnect
#: (``ring_time`` prices with it, so its results are the reference's)
LINK_BW = 50e9

#: tokens one step of each shape processes, over the whole fleet
_SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,      # one token per sequence
    "long_500k": 1,
}


def model_flops_per_device(rep: dict) -> float:
    """6*N_active*D train / 2*N_active*D forward, per device, of a report
    dict (``active_params``, ``kind``, ``shape``, ``devices``)."""
    n = rep["active_params"]
    mult = 6.0 if rep["kind"] == "train" else 2.0
    tokens = _SHAPE_TOKENS[rep["shape"]]
    return mult * n * tokens / rep["devices"]


def ring_time(kind: str, bytes_per_dev: float, chips: int) -> float:
    n = max(chips, 2)
    factor = {"all-reduce": 2 * (n - 1) / n,
              "all-gather": (n - 1) / n,
              "reduce-scatter": (n - 1) / n,
              "all-to-all": (n - 1) / n,
              "collective-permute": 1.0}.get(kind, 1.0)
    return bytes_per_dev * factor / LINK_BW


def kind_sizes_from_reports(reps, mtu: int = 4096, max_pkts: int = 128,
                            min_pkts: int = 4) -> dict:
    """Representative per-kind payloads (per-rank packets) from dry-run
    reports' own per-device collective byte volumes, clamped to the
    simulator's tractable size band."""
    best: dict = {}
    for rep in reps:
        for k, b in rep["collectives"]["bytes"].items():
            if k == "total":
                continue
            best[k] = max(best.get(k, 0.0), float(b))
    return {k: max(min_pkts, min(max_pkts, math.ceil(b / mtu)))
            for k, b in best.items()}


def uet_efficiencies(kinds, hosts: int = 8, size_pkts: int = 64,
                     sizes: "dict | None" = None, device=None) -> dict:
    """Per-kind achieved-efficiency derates from the packet-level UET
    collective simulator: analytic alpha-beta time / simulated
    completion, all kinds as ONE ``simulate_batch`` call (heterogeneous
    flow counts padded). ``sizes`` overrides the probe payload per kind
    (see ``kind_sizes_from_reports``); the run lives on ``device``."""
    from repro_torch.distributed.netmodel import (FabricSpec,
                                                  _collective_fabric,
                                                  analytic_time_for_spec)
    from repro_torch.network import collectives as coll
    from repro_torch.network.fabric import SimParams, simulate_batch
    from repro_torch.network.profile import TransportProfile

    ks = [k for k in kinds if k not in ("total", "collective-permute")]
    if not ks:
        return {}
    fs = FabricSpec()
    sz = {k: int((sizes or {}).get(k, size_pkts)) for k in ks}
    specs = [coll.CollectiveSpec(k, tuple(range(hosts)), sz[k])
             for k in ks]
    budget = max(6 * coll.analytic_ticks(s, "ring") + 800 for s in specs)
    # the run exits at its first quiescent chunk boundary, so the
    # worst-case budget costs the kinds that finish early nothing
    rs = simulate_batch(
        _collective_fabric(hosts, hosts_per_leaf=4, oversub=1),
        coll.stack_padded([coll.build_workload(s, "ring") for s in specs]),
        TransportProfile.ai_full(), SimParams(), max_ticks=budget,
        device=device)
    out = {}
    for k, r in zip(ks, rs):
        ct = coll.collective_completion_ticks(r)
        if ct < 0:
            # never report a timeout as a measured efficiency
            print(f"uet_efficiencies: {k} did not complete within "
                  f"{budget} ticks — no derate applied")
            continue
        out[k] = min(1.0, analytic_time_for_spec(k, sz[k], hosts, fs)
                     / (ct * fs.tick_seconds))
    return out
