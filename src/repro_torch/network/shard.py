"""The scenario axis split across devices — the port of
``repro.network.shard``: ``simulate_batch(..., shard=True)``.

A batch is cut into contiguous shards, one per device; each shard runs
the one-device driver (``fabric.ChunkLoop``) on its own lanes, with no
communication between shards. Consequences, as in the reference:

* per-lane trajectories are bitwise the unsharded ones (lanes never
  interact), the probe rings included;
* each shard stops at its own lanes' quiescence, not the batch's;
* ragged scenario counts are padded to a multiple of the device count
  with inert lanes (``workloads.pad_scenarios``: zero-size flows,
  all-healthy fault lanes, host lanes of the batch's width, the default
  seed) that quiesce at the first chunk boundary; the padding is dropped
  from the results;
* per-(graph, profile) groups compose: ``simulate_batch`` groups first,
  then shards each group.

The shards overlap on distinct devices: every chunk, the driver queues
the chunk's ticks on every live shard before it reads any shard's
quiescence flags, so each shard still syncs with the host once per
chunk. A device may be named more than once (``(dev, dev)``): its shards
then run one after another on it, which is how the split is tested on
one device.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from repro_torch.network import fabric
from repro_torch.network.faults import FaultSchedule


def available_devices(device) -> "tuple[torch.device, ...]":
    """The devices of ``device``'s kind: every CUDA device for ``cuda``,
    and the one ``cpu`` device for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def resolve_devices(devices, shard: bool, device="cuda"):
    """The ``simulate_batch`` (devices=, shard=) pair as a device tuple,
    or None for the unsharded path (0 or 1 device), with the reference's
    forms: ``devices=True`` is ``shard=True``; ``shard=True`` takes every
    device of ``device``'s kind (:func:`available_devices`); an int takes
    the first n (0 and 1: unsharded; more than are present: a
    ``ValueError``); a sequence is taken as given."""
    if isinstance(devices, bool):       # devices=True sugar for shard=True
        devices, shard = None, devices or shard
    if devices is None:
        if not shard:
            return None
        devs = available_devices(device)
    elif isinstance(devices, int):
        if devices <= 1:                # 0/1 = sharding disabled
            return None
        avail = available_devices(device)
        if devices > len(avail):
            raise ValueError(f"devices={devices} requested but "
                             f"{len(avail)} present")
        devs = avail[:devices]
    else:
        devs = tuple(torch.device(d) for d in devices)
    return devs if len(devs) > 1 else None


def _cat_schedules(a: FaultSchedule, b: FaultSchedule) -> FaultSchedule:
    return FaultSchedule(*(torch.cat([getattr(a, f.name),
                                      getattr(b, f.name).to(
                                          getattr(a, f.name))])
                           for f in fields(FaultSchedule)))


def run_sharded(g, wls, profile, p, fault, seeds, trace: str, budget: int,
                goodput_window, devs: tuple, tel=None,
                link=None) -> "list[fabric.SimResult]":
    """One (graph, profile) group's [B, F] batch split over ``devs``:
    the same inputs and per-scenario results as the unsharded driver,
    bitwise. ``fault`` is the batch's [B, Q] schedule and ``seeds`` its
    [B] seeds; the tick's fault statics are the whole batch's, so every
    shard builds the same tick."""
    from repro_torch.network.workloads import pad_scenarios

    n = len(devs)
    B, F = (int(d) for d in wls.src.shape)
    profile.delivery_modes(F)
    statics = fabric.fault_statics(fault)
    seeds = np.broadcast_to(np.asarray(seeds), (B,))
    wls_p, pad = pad_scenarios(wls, n)
    if pad:
        fault = _cat_schedules(fault, FaultSchedule.healthy(
            g.num_queues, batch=pad, num_hosts=fault.num_hosts))
        seeds = np.concatenate([seeds, np.full((pad,), fabric.DEFAULT_SEED,
                                               seeds.dtype)])
    m = (B + pad) // n
    loops = []
    for i, dev in enumerate(devs):
        sel = torch.arange(i * m, (i + 1) * m)
        loops.append(fabric._group_loop(
            g, wls_p.lanes(sel), profile, p, fault.lanes(sel),
            seeds[i * m:(i + 1) * m], trace, budget, goodput_window, dev,
            link, tel, statics))
    live = [lp for lp in loops if not lp.done]
    while live:
        for lp in live:
            lp.issue()
        for lp in live:
            lp.collect()
        live = [lp for lp in live if not lp.done]
    sizes = wls_p.size.cpu().numpy()
    out: list = []
    for i, lp in enumerate(loops):
        out += fabric._results(lp, sizes[i * m:(i + 1) * m], budget, trace,
                               goodput_window, tel)
    return out[:B]


def _smoke(device=None) -> int:
    """Ragged sharded batch vs the unsharded engine: bitwise parity of
    completion ticks, horizons, and the full final state. The batch is
    split over four devices of ``device``'s kind (``cuda`` unless given):
    every card when there are four, else the ones there are, repeated
    (one card: ``(cuda:0,) * 4``; the CPU: ``(cpu,) * 4``)."""
    from repro_torch import resolve_device
    from repro_torch.core.link import state_bitwise_equal
    from repro_torch.network.profile import TransportProfile
    from repro_torch.network.topology import leaf_spine

    avail = available_devices(resolve_device(device))
    devs = tuple(avail[i % len(avail)] for i in range(4))
    g = leaf_spine(leaves=2, spines=2, hosts_per_leaf=4)
    sizes = [40, 80, 120, 160, 200, 240]      # B=6: ragged on 4 devices
    wls = fabric.Workload.stack(
        [fabric.Workload.of([0, 1, 2, 3], [4, 5, 6, 7], s) for s in sizes])
    p = fabric.SimParams(ticks=2000)
    prof = TransportProfile.ai_full()
    base = fabric.simulate_batch(g, wls, prof, p, device=device)
    shd = fabric.simulate_batch(g, wls, prof, p, devices=devs, device=device)
    for i, (rb, rs) in enumerate(zip(base, shd)):
        assert rb.horizon == rs.horizon, (i, rb.horizon, rs.horizon)
        np.testing.assert_array_equal(rb.completion_ticks(),
                                      rs.completion_ticks(),
                                      err_msg=f"scenario {i}")
        drift = state_bitwise_equal(rb.state, rs.state, skip=())
        assert drift is None, f"scenario {i} state: {drift} drifted"
    print(f"shard smoke ok: {len(devs)} devices, B={len(sizes)} (ragged), "
          f"bitwise parity with the unsharded engine")
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the sharded engine canary")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    from repro_torch.network import shard as _canonical
    raise SystemExit(_canonical._smoke(ap.parse_args().device))
