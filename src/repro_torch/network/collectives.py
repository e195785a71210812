"""Dependency-scheduled collectives compiled onto the packet fabric — the
port of ``repro.network.collectives`` (the port imports nothing of the
reference package, so the numpy schedule builders are a copy).

A collective (all-reduce, reduce-scatter, all-gather, all-to-all) is a
multi-phase exchange with data dependencies between phases. This module
lowers a :class:`CollectiveSpec` to a fabric :class:`Workload` whose
``dep`` lane encodes the algorithm's phase DAG (flow f is eligible once
flow ``dep[f]`` completes at its source) and whose ``red`` lane marks
switch-reducible fan-in groups for in-network reduction
(``repro_torch.core.inc``, enabled by ``TransportProfile(inc=True)``).
The whole collective then runs inside one run and batches through
``simulate_batch`` like any other workload.

Algorithms
----------
* ``ring`` — 2(n-1) phases for all-reduce (reduce-scatter then
  all-gather around the ring), n-1 for reduce-scatter / all-gather;
  all-reduce and reduce-scatter circulate ceil(S/n) chunks, all-gather
  forwards whole S-sized blocks; flow (p, i) depends on (p-1, i-1 mod
  n).
* ``recursive_doubling`` — log2(n) phases (n a power of two);
  all-reduce exchanges the full vector each phase; reduce-scatter halves
  (distance n/2 first), all-gather doubles; flow (p, i) depends on the
  phase-(p-1) flow INTO i.
* ``tree`` — all-reduce only: every non-root host sends its full vector
  to the root (ONE reduction group), then the root streams the result
  back; the broadcast flow to host i depends on the reduce flow from
  host i. With INC off this is the incast baseline; with INC on the ToR
  absorbs all but one child packet per PSN.
* ``all_to_all`` uses round-robin rounds r = 1..n-1 (i -> i+r, chunked),
  each host's rounds chained by ``dep``.

``size_pkts`` is the per-rank INPUT size S in MTU packets throughout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from repro_torch.network.fabric import SimResult, Workload

KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all")
ALGOS = ("ring", "recursive_doubling", "tree")


@dataclass(frozen=True)
class CollectiveSpec:
    """One collective: kind, participating host ids, per-rank size (pkts)."""

    kind: str
    hosts: tuple
    size_pkts: int

    def __post_init__(self):
        kind = self.kind.replace("-", "_")
        if kind not in KINDS:
            raise ValueError(f"unknown collective kind {self.kind!r}; "
                             f"choose from {KINDS}")
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "hosts", tuple(int(h) for h in self.hosts))
        if len(self.hosts) < 2:
            raise ValueError("a collective needs >= 2 hosts")
        if len(set(self.hosts)) != len(self.hosts):
            raise ValueError("collective hosts must be distinct")
        if self.size_pkts < 1:
            raise ValueError("size_pkts must be >= 1")

    @property
    def n(self) -> int:
        return len(self.hosts)

    @classmethod
    def from_bytes(cls, kind: str, hosts, bytes_per_rank: float,
                   mtu: int = 4096) -> "CollectiveSpec":
        """Byte-denominated constructor: the per-rank payload in MTU
        packets, a true ceiling with a floor of one packet."""
        return cls(kind, tuple(hosts),
                   max(1, math.ceil(bytes_per_rank / mtu)))


@dataclass(frozen=True)
class FlowTable:
    """The lowered schedule, in host-INDEX space (0..n-1), as numpy."""

    src: np.ndarray    # [F] host index
    dst: np.ndarray    # [F]
    size: np.ndarray   # [F] packets
    dep: np.ndarray    # [F] flow index or -1
    red: np.ndarray    # [F] reduction group id or -1
    phase: np.ndarray  # [F] phase number (diagnostics)
    meta: dict = field(default_factory=dict)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _table(src, dst, size, dep, red, ph, meta) -> FlowTable:
    f = len(src)

    def lane(v):
        return (np.full((f,), v, np.int32) if np.isscalar(v)
                else np.asarray(v, np.int32))
    return FlowTable(lane(src), lane(dst), lane(size), lane(dep), lane(red),
                     lane(ph), meta)


def _ring(n: int, s: int, kind: str) -> FlowTable:
    # all-reduce and reduce-scatter circulate 1/n-sized chunks of the
    # S-sized input; all-gather forwards whole S-sized blocks
    c = s if kind == "all_gather" else _ceil_div(s, n)
    phases = 2 * (n - 1) if kind == "all_reduce" else (n - 1)
    src, dst, dep, ph = [], [], [], []
    for p in range(phases):
        for i in range(n):
            src.append(i)
            dst.append((i + 1) % n)
            dep.append(-1 if p == 0 else (p - 1) * n + (i - 1) % n)
            ph.append(p)
    return _table(src, dst, c, dep, -1, ph, {"chunk": c, "phases": phases})


def _recursive_doubling(n: int, s: int, kind: str) -> FlowTable:
    d = n.bit_length() - 1
    if (1 << d) != n:
        raise ValueError(f"recursive_doubling needs a power-of-two host "
                         f"count, got {n}")
    if kind == "all_reduce":
        dist = [1 << p for p in range(d)]
        sizes = [s] * d
    elif kind == "reduce_scatter":     # recursive halving, far pairs first
        dist = [n >> (p + 1) for p in range(d)]
        sizes = [_ceil_div(s, 1 << (p + 1)) for p in range(d)]
    else:                              # all_gather: doubling
        dist = [1 << p for p in range(d)]
        sizes = [s * (1 << p) for p in range(d)]
    src, dst, size, dep, ph = [], [], [], [], []
    for p in range(d):
        for i in range(n):
            src.append(i)
            dst.append(i ^ dist[p])
            size.append(sizes[p])
            # the phase-(p-1) flow INTO i came from i ^ dist[p-1]
            dep.append(-1 if p == 0 else (p - 1) * n + (i ^ dist[p - 1]))
            ph.append(p)
    return _table(src, dst, size, dep, -1, ph, {"phases": d})


def _tree(n: int, s: int, kind: str) -> FlowTable:
    if kind != "all_reduce":
        raise ValueError("the tree algorithm is defined for all_reduce only")
    up = list(range(1, n))
    # reduce: every non-root -> root, one switch-reducible group; then
    # broadcast: root -> every non-root, pipelined on the reduce flow
    # from the same host
    return _table(up + [0] * (n - 1), [0] * (n - 1) + up, s,
                  [-1] * (n - 1) + [i - 1 for i in up],
                  [0] * (n - 1) + [-1] * (n - 1),
                  [0] * (n - 1) + [1] * (n - 1), {"phases": 2, "root": 0})


def _all_to_all(n: int, s: int) -> FlowTable:
    c = _ceil_div(s, n)
    src, dst, dep, ph = [], [], [], []
    for r in range(1, n):
        for i in range(n):
            src.append(i)
            dst.append((i + r) % n)
            dep.append(-1 if r == 1 else (r - 2) * n + i)
            ph.append(r - 1)
    return _table(src, dst, c, dep, -1, ph, {"chunk": c, "rounds": n - 1})


def flow_table(spec: CollectiveSpec, algo: str = "ring") -> FlowTable:
    """Lower a spec to its dependency-scheduled flow table."""
    n, s = spec.n, spec.size_pkts
    if spec.kind == "all_to_all":
        return _all_to_all(n, s)
    if algo == "ring":
        return _ring(n, s, spec.kind)
    if algo == "recursive_doubling":
        return _recursive_doubling(n, s, spec.kind)
    if algo == "tree":
        return _tree(n, s, spec.kind)
    raise ValueError(f"unknown algorithm {algo!r}; choose from {ALGOS}")


def build_workload(spec: CollectiveSpec, algo: str = "ring", *,
                   inc_groups: bool = True, device="cpu") -> Workload:
    """The fabric Workload for one whole collective (host-id space).

    ``inc_groups=False`` strips the ``red`` lane (all -1), turning
    in-network reduction off for this scenario even under an
    ``inc=True`` profile; the INC tick is an exact no-op on group-free
    traffic, so INC on/off is a data axis of one batch."""
    t = flow_table(spec, algo)
    hosts = np.asarray(spec.hosts, np.int32)
    red = t.red if inc_groups else np.full_like(t.red, -1)
    return Workload.of(hosts[t.src], hosts[t.dst], t.size, dep=t.dep,
                       red=red, device=device)


def expected_host_rx(spec: CollectiveSpec, algo: str = "ring") -> np.ndarray:
    """[n] packets each host receives with INC OFF (reliable delivery =>
    exact counts)."""
    t = flow_table(spec, algo)
    rx = np.zeros((spec.n,), np.int64)
    np.add.at(rx, t.dst, t.size.astype(np.int64))
    return rx


def analytic_ticks(spec: CollectiveSpec, algo: str = "ring") -> int:
    """Serialization lower bound in ticks (1 packet/tick line rate,
    latency ignored): the longest per-host send/receive chain."""
    t = flow_table(spec, algo)
    tx = np.zeros((spec.n,), np.int64)
    np.add.at(tx, t.src, t.size.astype(np.int64))
    rx = expected_host_rx(spec, algo)
    chain = np.zeros((len(t.src),), np.int64)
    for f in np.argsort(t.phase, kind="stable"):
        d = int(t.dep[f])
        chain[f] = int(t.size[f]) + (chain[d] if d >= 0 else 0)
    return int(max(tx.max(), rx.max(), chain.max()))


def collective_completion_ticks(result: SimResult) -> int:
    """Tick at which the collective finished: every flow source-complete
    (absorbed packets are ACKed at the switch and never surface at the
    receiver). -1 = did not finish in the run."""
    return result.source_completion_tick()


def stack_padded(wls: "list[Workload]") -> Workload:
    """Stack workloads of different flow counts along a scenario axis by
    padding each with inert flows (size 0: complete at tick 0, never
    eligible, deliver nothing) up to the widest scenario."""
    fmax = max(int(w.src.shape[0]) for w in wls)
    fill = {"dep": -1, "red": -1}
    padded = []
    for w in wls:
        pad = fmax - int(w.src.shape[0])
        padded.append(Workload(*(torch.cat([
            getattr(w, f.name),
            torch.full((pad,), fill.get(f.name, 0), dtype=torch.int32,
                       device=w.src.device)]) for f in fields(Workload))))
    return Workload.stack(padded)
