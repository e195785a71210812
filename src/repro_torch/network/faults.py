"""Fault schedules — the port of ``repro.network.faults``.

A :class:`FaultSchedule` holds per-queue and per-host fault lanes for one
scenario ([Q] / [H]) or a scenario batch ([B, Q] / [B, H]):

* ``fail_at`` / ``heal_at`` — one outage window per queue: dead while
  ``fail_at <= tick < heal_at``. Packets routed into a dead queue vanish
  silently (no trim, no NACK). The static ``failed=`` mask is the
  degenerate schedule ``fail_at=0, heal_at=NEVER_TICK``.
* ``loss_p`` — per-queue gray-link loss probability, drawn per enqueue
  from a counter-based hash of (seed, tick, enqueue lane).
* ``corrupt_p`` — per-queue PHY bit-error probability, drawn per
  transmission from an independent hash of (seed, tick, queue). Without
  the link layer's replay (ROADMAP.md item 8) a corrupted frame is a
  silent drop at the transmitting hop.
* ``seed`` — the draw stream's uint32 seed ([] or [B]), held as its
  int32 bit pattern (``repro_torch._u32``).
* ``host_fail_at`` / ``host_heal_at`` — per-host outage (node death: no
  injection, no ACK processing, no absorption of deliveries);
  ``nic_stall_at`` / ``nic_heal_at`` — injection frozen while the host
  stays ACK-live. Host lanes are optional: a schedule built without
  ``num_hosts`` carries zero-width lanes and cannot express endpoint
  faults.

Every builder returns a new schedule; composition only ever widens the
host lanes (0 -> H), never re-widens them.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from repro_torch._u32 import from_u64
from repro_torch.core.types import NEVER_TICK

I32 = torch.int32
F32 = torch.float32


def _seed_pattern(seed, shape, device) -> torch.Tensor:
    """uint32 seeds (taken modulo 2**32) as int32 patterns of ``shape``."""
    a = np.asarray(seed).astype(np.int64) & 0xFFFFFFFF
    a = np.array(np.broadcast_to(a, shape), np.uint32).view(np.int32)
    return torch.as_tensor(a).to(device)


def _hot(shape, ids, device) -> torch.Tensor:
    """[.., N] bool lanes with the last-axis positions ``ids`` set."""
    hot = np.zeros(shape[-1:], bool)
    hot[np.atleast_1d(np.asarray(ids, np.int64))] = True
    return torch.as_tensor(hot, device=device).expand(shape)


@dataclass(frozen=True)
class FaultSchedule:
    """Per-queue + per-host fault lanes of one scenario ([Q] / [H]) or of
    a scenario batch ([B, Q] / [B, H]; ``seed`` is [] / [B])."""

    fail_at: torch.Tensor   # [.., Q] int32 first dead tick (NEVER = healthy)
    heal_at: torch.Tensor   # [.., Q] int32 first live-again tick (NEVER = forever)
    loss_p: torch.Tensor    # [.., Q] float32 per-packet loss probability
    corrupt_p: torch.Tensor  # [.., Q] float32 per-transmission BER
    seed: torch.Tensor      # [..] uint32 (int32 pattern) draw-stream seed
    host_fail_at: torch.Tensor  # [.., H] int32 host dead from
    host_heal_at: torch.Tensor  # [.., H] int32 host live again
    nic_stall_at: torch.Tensor  # [.., H] int32 injection frozen from
    nic_heal_at: torch.Tensor   # [.., H] int32 injection live again

    # -- builders ---------------------------------------------------------
    @staticmethod
    def healthy(num_queues: int, batch: "int | None" = None, seed: int = 0,
                num_hosts: int = 0, device="cpu") -> "FaultSchedule":
        """All-healthy lanes ([Q], or [batch, Q] when batch is given);
        ``num_hosts`` sizes the host lanes (0: none)."""
        shape = (num_queues,) if batch is None else (batch, num_queues)
        hshape = shape[:-1] + (num_hosts,)
        never = dict(fill_value=NEVER_TICK, dtype=I32, device=device)
        return FaultSchedule(
            fail_at=torch.full(shape, **never),
            heal_at=torch.full(shape, **never),
            loss_p=torch.zeros(shape, dtype=F32, device=device),
            corrupt_p=torch.zeros(shape, dtype=F32, device=device),
            seed=_seed_pattern(seed, shape[:-1], device),
            host_fail_at=torch.full(hshape, **never),
            host_heal_at=torch.full(hshape, **never),
            nic_stall_at=torch.full(hshape, **never),
            nic_heal_at=torch.full(hshape, **never))

    @staticmethod
    def from_mask(mask, seed: int = 0, device="cpu") -> "FaultSchedule":
        """Queues set in the bool ``mask`` ([Q] or [B, Q]) are dead from
        tick 0 forever — the reference's ``failed=`` semantics. Host
        lanes are zero-width."""
        mask = torch.as_tensor(np.array(mask, bool), device=device)
        s = FaultSchedule.healthy(int(mask.shape[-1]),
                                  None if mask.dim() == 1 else
                                  int(mask.shape[0]), seed, 0, device)
        return replace(s, fail_at=torch.where(mask, 0, NEVER_TICK).to(I32))

    def with_hosts(self, num_hosts: int) -> "FaultSchedule":
        """Widen zero-width host lanes to [.., num_hosts] all-healthy
        lanes. A schedule already at ``num_hosts`` is returned as it is;
        any other nonzero width is an error."""
        if self.num_hosts == num_hosts:
            return self
        if self.num_hosts != 0:
            raise ValueError(
                f"schedule already has host lanes over {self.num_hosts} "
                f"hosts; cannot re-widen to {num_hosts}")
        hshape = tuple(self.fail_at.shape[:-1]) + (num_hosts,)
        never = dict(fill_value=NEVER_TICK, dtype=I32,
                     device=self.fail_at.device)
        return replace(self, host_fail_at=torch.full(hshape, **never),
                       host_heal_at=torch.full(hshape, **never),
                       nic_stall_at=torch.full(hshape, **never),
                       nic_heal_at=torch.full(hshape, **never))

    # -- combinators (queues are ids into [Q], hosts into [H]) ------------
    def flap(self, queues, fail_at: int,
             heal_at: int = NEVER_TICK) -> "FaultSchedule":
        """Give ``queues`` the outage window [fail_at, heal_at) (in every
        scenario of a batch). One window per queue: a later flap
        overwrites an earlier one."""
        hot = _hot(self.fail_at.shape, queues, self.fail_at.device)
        return replace(
            self,
            fail_at=torch.where(hot, int(fail_at), self.fail_at).to(I32),
            heal_at=torch.where(hot, int(heal_at), self.heal_at).to(I32))

    def lossy(self, queues, p: float) -> "FaultSchedule":
        """Make ``queues`` gray links dropping each packet w.p. ``p``."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"loss probability must be in [0, 1], got {p}")
        hot = _hot(self.loss_p.shape, queues, self.loss_p.device)
        return replace(self, loss_p=torch.where(
            hot, torch.tensor(p, dtype=F32), self.loss_p))

    def corrupt(self, queues, p: float) -> "FaultSchedule":
        """Give ``queues`` a PHY bit-error rate: each transmission out of
        the queue is corrupted independently w.p. ``p``."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"corruption probability must be in [0, 1], got {p}")
        hot = _hot(self.corrupt_p.shape, queues, self.corrupt_p.device)
        return replace(self, corrupt_p=torch.where(
            hot, torch.tensor(p, dtype=F32), self.corrupt_p))

    def _host_window(self, hosts, kind: str) -> torch.Tensor:
        if self.num_hosts == 0:
            raise ValueError(
                f"{kind} needs host lanes: build the schedule with "
                f"FaultSchedule.healthy(num_queues, num_hosts=H) or call "
                f".with_hosts(H) first")
        hs = np.atleast_1d(np.asarray(hosts, np.int64))
        if hs.size and (hs.min() < 0 or hs.max() >= self.num_hosts):
            raise ValueError(f"{kind} host ids must be in "
                             f"[0, {self.num_hosts}), got {hs.tolist()}")
        return _hot(self.host_fail_at.shape, hs, self.host_fail_at.device)

    def host_fail(self, hosts, fail_at: int,
                  heal_at: int = NEVER_TICK) -> "FaultSchedule":
        """Kill ``hosts`` over [fail_at, heal_at): no injection, no ACK
        processing or generation, no delivery absorption. One window per
        host (a later call overwrites an earlier one)."""
        hot = self._host_window(hosts, "host_fail")
        return replace(
            self,
            host_fail_at=torch.where(hot, int(fail_at),
                                     self.host_fail_at).to(I32),
            host_heal_at=torch.where(hot, int(heal_at),
                                     self.host_heal_at).to(I32))

    def nic_stall(self, hosts, stall_at: int,
                  heal_at: int = NEVER_TICK) -> "FaultSchedule":
        """Freeze ``hosts``' injection over [stall_at, heal_at) while
        keeping them ACK-live."""
        hot = self._host_window(hosts, "nic_stall")
        return replace(
            self,
            nic_stall_at=torch.where(hot, int(stall_at),
                                     self.nic_stall_at).to(I32),
            nic_heal_at=torch.where(hot, int(heal_at),
                                    self.nic_heal_at).to(I32))

    def with_seed(self, seed) -> "FaultSchedule":
        return replace(self, seed=_seed_pattern(
            seed, tuple(self.seed.shape), self.seed.device))

    @staticmethod
    def stack(scheds: "list[FaultSchedule]") -> "FaultSchedule":
        """Stack per-scenario [Q] schedules into a [B, Q] batch. Mixed
        host-lane widths {0, H} widen the zero-width ones; two distinct
        nonzero widths are an error."""
        widths = {s.num_hosts for s in scheds}
        nz = sorted(w for w in widths if w)
        if len(nz) > 1:
            raise ValueError(f"cannot stack schedules with host lanes "
                             f"over different host counts: {nz}")
        if nz and 0 in widths:
            scheds = [s.with_hosts(nz[0]) for s in scheds]
        return FaultSchedule(*(torch.stack([getattr(s, f.name)
                                            for s in scheds])
                               for f in fields(FaultSchedule)))

    # -- views ------------------------------------------------------------
    @property
    def num_queues(self) -> int:
        return int(self.fail_at.shape[-1])

    @property
    def num_hosts(self) -> int:
        """Width of the per-host lanes (0 = no endpoint faults)."""
        return int(self.host_fail_at.shape[-1])

    @property
    def has_host_faults(self) -> bool:
        """True iff any host outage or NIC stall is scheduled: the static
        (``hosty``) that builds the endpoint-fault tick."""
        if self.num_hosts == 0:
            return False
        return bool((self.host_fail_at != NEVER_TICK).any()
                    or (self.nic_stall_at != NEVER_TICK).any())

    @property
    def has_corruption(self) -> bool:
        """True iff any queue has a nonzero BER lane (``corrupty``)."""
        return bool(self.corrupt_p.any())

    @property
    def has_loss(self) -> bool:
        """True iff any queue has a nonzero gray-link lane (``lossy``)."""
        return bool(self.loss_p.any())

    def dead_at(self, tick: int) -> torch.Tensor:
        """[.., Q] bool — queues dead at ``tick``."""
        return (self.fail_at <= tick) & (tick < self.heal_at)

    def host_dead_at(self, tick: int) -> torch.Tensor:
        """[.., H] bool — hosts dead at ``tick``."""
        return (self.host_fail_at <= tick) & (tick < self.host_heal_at)

    def nic_stalled_at(self, tick: int) -> torch.Tensor:
        """[.., H] bool — hosts with frozen injection at ``tick``."""
        return (self.nic_stall_at <= tick) & (tick < self.nic_heal_at)

    def to(self, device) -> "FaultSchedule":
        return FaultSchedule(*(getattr(self, f.name).to(device)
                               for f in fields(self)))

    def lanes(self, idx) -> "FaultSchedule":
        """The scenarios ``idx`` (an index array) of a batch."""
        return FaultSchedule(*(getattr(self, f.name)[idx]
                               for f in fields(self)))


#: f32(4294967040.0): the largest float32 below 2**32
_THRESHOLD_SCALE = torch.tensor(4294967040.0, dtype=F32)


def loss_threshold(p: torch.Tensor) -> torch.Tensor:
    """[.., Q] uint32 (int32 pattern) compare threshold of the
    counter-based draws: a packet is hit iff its uniform uint32 hash is
    below it (unsigned, ``_u32.ult``). ``clip(p, 0, 1) * f32(4294967040)``
    in float32, then cast to uint32 as the reference does: p = 0 maps to
    0 (never), p = 1 to 4294967040."""
    prod = p.clamp(0.0, 1.0) * _THRESHOLD_SCALE.to(p.device)
    return from_u64(prod.to(torch.int64))


def failed_to_mask(num_queues: int, failed) -> np.ndarray:
    """[Q] bool mask from None / a queue-id iterable / a bool mask."""
    if failed is None:
        return np.zeros((num_queues,), bool)
    arr = np.asarray(failed)
    if arr.dtype == bool:
        if arr.shape != (num_queues,):
            raise ValueError(f"failed mask must be [Q={num_queues}], "
                             f"got {arr.shape}")
        return arr
    if arr.size and (arr.min() < 0 or arr.max() >= num_queues):
        raise ValueError(f"failed queue ids must be in [0, {num_queues}); "
                         f"pass a bool array to give a mask instead")
    mask = np.zeros((num_queues,), bool)
    mask[arr.astype(np.int64)] = True
    return mask


def as_schedule(num_queues: int, failed, faults, batch: int,
                device="cpu", g_num_hosts: "int | None" = None
                ) -> FaultSchedule:
    """One [batch, Q] schedule from the public (failed=, faults=) pair.
    ``faults``: a [Q] schedule (broadcast to every scenario) or a
    [batch, Q] one; ``g_num_hosts`` (when given) validates nonzero host
    lanes against the topology. ``failed``: a [batch, Q] mask (any 2-D
    array, 0/1 ints included), one [Q] mask, or queue ids (broadcast).
    At most one of the two; neither means all healthy."""
    if faults is not None:
        if failed is not None:
            raise ValueError("pass either failed= (static mask) or "
                             "faults= (FaultSchedule), not both")
        if not isinstance(faults, FaultSchedule):
            raise TypeError(f"faults= must be a FaultSchedule, got "
                            f"{type(faults).__name__}")
        if faults.num_queues != num_queues:
            raise ValueError(
                f"fault schedule is over {faults.num_queues} queues but "
                f"the topology has {num_queues}")
        if (g_num_hosts is not None and faults.num_hosts
                and faults.num_hosts != g_num_hosts):
            raise ValueError(
                f"fault schedule host lanes are over {faults.num_hosts} "
                f"hosts but the topology has {g_num_hosts}")
        if faults.fail_at.dim() == 1:
            return FaultSchedule(*(
                getattr(faults, f.name).expand(
                    (batch,) + tuple(getattr(faults, f.name).shape))
                .contiguous() for f in fields(FaultSchedule))).to(device)
        if faults.fail_at.shape[0] != batch:
            raise ValueError(f"fault schedule batch axis is "
                             f"{faults.fail_at.shape[0]}, expected {batch}")
        return faults.to(device)
    if failed is None:
        dead = np.zeros((batch, num_queues), bool)
    else:
        arr = np.asarray(failed)
        if arr.ndim == 2:
            dead = arr.astype(bool)
        else:
            dead = np.broadcast_to(failed_to_mask(num_queues, failed),
                                   (batch, num_queues))
    if dead.shape != (batch, num_queues):
        raise ValueError(f"failed mask must be [B={batch}, Q={num_queues}], "
                         f"got {dead.shape}")
    return FaultSchedule.from_mask(dead, device=device)


def _smoke(device=None) -> int:
    """Recovery canary: (1) a mid-run uplink flap is survived — timeouts
    fire while the link is down, the flow completes after heal, and the
    degraded-tick counter brackets the outage; (2) a PERMANENT mid-run
    failure of a pinned static path is escaped via EV eviction (the
    eviction-off twin stays stuck). Runs on ``device`` (``cuda`` unless
    given)."""
    from dataclasses import replace as _rep

    from repro_torch.core.lb.schemes import LBScheme
    # canonical class, NOT the __main__ copy this file becomes under -m
    from repro_torch.network.faults import FaultSchedule as FS
    from repro_torch.network.fabric import (SimParams, TransportProfile,
                                            Workload, simulate)
    from repro_torch.network.topology import leaf_spine

    g = leaf_spine(leaves=2, spines=2, hosts_per_leaf=4)
    wl = Workload.of([0, 1, 2, 3], [4, 5, 6, 7], 150)
    p = SimParams(ticks=4000, timeout_ticks=64)
    up = [int(g.up1_table[0, i]) for i in range(2)]

    # 1) flap: both uplinks down over [120, 420) — no surviving path
    #    during the window, full recovery after heal
    flap = FS.healthy(g.num_queues).flap(up, 120, 420)
    r = simulate(g, wl, TransportProfile.ai_full(), p, faults=flap,
                 device=device)
    ct = r.completion_tick()
    assert ct > 420, f"flap scenario should finish after heal, got {ct}"
    assert r.timeouts > 0, "outage must trigger RTO timeouts"
    assert r.ticks_degraded == 300, r.ticks_degraded

    # 2) permanent failure of a static path: eviction-on escapes,
    #    eviction-off is stuck at the budget
    dead = FS.healthy(g.num_queues).flap(up[0], 120)
    off = TransportProfile.ai_full(lb=LBScheme.STATIC, name="static")
    on = _rep(off, ev_eviction=True, name="static+evict")
    r_off = simulate(g, wl, off, p, faults=dead, device=device)
    r_on = simulate(g, wl, on, p, faults=dead, device=device)
    ct_on = r_on.completion_tick()
    assert ct_on != -1, "eviction must migrate flows off the dead path"
    assert r_on.ev_evictions > 0
    ct_off = r_off.completion_tick()
    assert ct_off == -1 or ct_on < ct_off, (ct_on, ct_off)
    print(f"fault smoke ok: flap survived (completion {ct}, "
          f"{r.timeouts} timeouts, {r.ticks_degraded} degraded ticks); "
          f"permanent failure escaped via {r_on.ev_evictions} evictions "
          f"(completion {ct_on} vs eviction-off "
          f"{'stuck' if ct_off == -1 else ct_off})")
    return 0


def _endpoint_smoke(device=None) -> int:
    """Endpoint canary: a never-healing dead host under a
    ``pdc_dead_after`` profile must be DETECTED (flows to/from it
    quarantined, abandonment visible in the stat lanes) and the run must
    quiesce EARLY — strictly before the tick budget — while every
    surviving flow still completes. The pdc-off twin burns the whole
    budget on the same schedule. Runs on ``device`` (``cuda`` unless
    given)."""
    from repro_torch.network import workloads
    from repro_torch.network.fabric import SimParams, simulate_batch

    g, wls, scheds, exp = workloads.host_fault_sweep()
    budget = int(exp["budget"])
    p = SimParams(ticks=budget, timeout_ticks=64)
    rs = simulate_batch(g, wls, exp["profile"], p, faults=scheds,
                        device=device)
    by = dict(zip(exp["names"], rs))

    r = by["host_dead"]
    dead_flows = exp["dead_flows"]
    assert r.horizon < budget, \
        f"dead host must quiesce early, ran {r.horizon}/{budget}"
    assert r.flows_abandoned == len(dead_flows), \
        (r.flows_abandoned, dead_flows)
    assert r.ticks_unreachable > 0 and r.abandon_tick > 0
    ct = r.completion_ticks()
    surviving = [f for f in range(ct.shape[0]) if f not in dead_flows]
    assert all(ct[f] > 0 for f in surviving), ct
    assert all(ct[f] == -1 for f in dead_flows), ct

    r_off = by["host_dead_pdc_off"]
    assert r_off.horizon == budget, \
        f"pdc-off twin must burn the budget, exited at {r_off.horizon}"
    assert r_off.flows_abandoned == 0

    r_stall = by["nic_stall"]
    assert r_stall.flows_abandoned == 0, \
        "an ACK-live NIC stall must not be declared dead"
    assert r_stall.completion_tick() > 0, "stall heals -> all complete"

    healthy = by["healthy"]
    assert healthy.flows_abandoned == 0 and healthy.ticks_unreachable == 0
    print(f"endpoint smoke ok: dead host detected at tick "
          f"{r.abandon_tick} ({r.flows_abandoned} flows abandoned, "
          f"{r.ticks_unreachable} unreachable ticks), quiesced at "
          f"{r.horizon}/{budget} vs pdc-off stuck at {r_off.horizon}; "
          f"NIC stall stayed live (completion "
          f"{r_stall.completion_tick()})")
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the recovery canary "
                                 "(--endpoint: the endpoint canary)")
    ap.add_argument("--endpoint", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    # run through the canonical module: under ``python -m`` this file is
    # also loaded as __main__, and fabric's isinstance check needs the
    # real FaultSchedule class
    from repro_torch.network import faults as _canonical
    raise SystemExit((_canonical._endpoint_smoke if args.endpoint
                      else _canonical._smoke)(args.device))
