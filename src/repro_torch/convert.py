"""Carry engine state between the reference and the port.

The reference's ``SimState``, ``Workload`` and ``FaultSchedule`` travel
as nested dicts of numpy arrays keyed by field name (nested dataclasses
— the PSN trackers, the CC state, the LB state — as nested dicts). This
module turns such a dict into the port's dataclasses on a device and
back. uint32 lanes become int32 bit patterns (``np.ndarray.view``) on the
way in and uint32 again on the way out, so a round trip is bitwise.

Lanes of features this slice does not port must be inert in the
incoming dict (zero-size, zero, False or never-failing); otherwise the
conversion raises ``NotImplementedError`` instead of dropping state.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass

import numpy as np
import torch

from repro_torch.core.cms.nscc import NSCCState
from repro_torch.core.lb.schemes import LBState
from repro_torch.core.pds import PSNTracker
from repro_torch.core.types import NEVER_TICK
from repro_torch.network.fabric import SimState, Workload
from repro_torch.network.faults import FaultSchedule

#: dotted paths of the lanes the reference keeps as uint32
U32_LANES = frozenset(
    [f"{t}.{k}" for t in ("src_track", "dst_track")
     for k in ("base", "ring", "rx_ok", "dup", "oor")]
    + ["rtx", "lb.salt"])

#: reference SimState lanes the port does not carry: each must be inert
_INERT_STATE = ("inc", "inc_reduced", "inc_emits", "rod_rejects",
                "ev_evictions", "rto_strikes", "quarantined",
                "flows_abandoned", "ticks_unreachable", "llr_busy_until",
                "llr_replays", "cbfc_consumed", "cbfc_freed", "cbfc_ret",
                "credit_stall_ticks")
_NESTED = {"src_track": PSNTracker, "dst_track": PSNTracker,
           "cc": NSCCState, "lb": LBState}


def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(d)


def _require_inert(d: dict, names, what: str, inert=lambda a: not a.any()):
    for name in names:
        if name not in d:
            continue
        for path, a in _leaves(d[name], f"{name}."):
            if not inert(a):
                raise NotImplementedError(
                    f"{what} lane {path} is live; the port does not carry "
                    f"it yet (see ROADMAP.md, 'Modules to port')")


def _to_tensor(a, path: str, device) -> torch.Tensor:
    a = np.array(a)          # an owned, writable copy (0-dim stays 0-dim)
    if path in U32_LANES:
        a = a.astype(np.uint32).view(np.int32)
    return torch.as_tensor(a).to(device)


def _build(cls, d: dict, device, prefix=""):
    vals = {}
    for f in fields(cls):
        sub = _NESTED.get(f.name) if not prefix else None
        if sub is not None:
            vals[f.name] = _build(sub, d[f.name], device, f"{f.name}.")
        else:
            vals[f.name] = _to_tensor(d[f.name], prefix + f.name, device)
    return cls(**vals)


def _to_numpy(obj, prefix="") -> dict:
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if is_dataclass(v):
            out[f.name] = _to_numpy(v, f"{prefix}{f.name}.")
        else:
            a = v.detach().cpu().numpy()
            out[f.name] = a.view(np.uint32) if (prefix + f.name) in U32_LANES \
                else a
    return out


def state_from_numpy(d: dict, device) -> SimState:
    """The port's SimState from a reference SimState given as a nested
    dict of numpy arrays."""
    _require_inert(d, _INERT_STATE, "SimState")
    return _build(SimState, d, device)


def state_to_numpy(s: SimState) -> dict:
    """A SimState as a nested dict of numpy arrays (uint32 lanes as
    uint32), keyed like the reference's fields."""
    return _to_numpy(s)


def workload_from_numpy(d: dict, device) -> Workload:
    return _build(Workload, d, device)


def workload_to_numpy(wl: Workload) -> dict:
    return _to_numpy(wl)


def faults_from_numpy(d: dict, device) -> FaultSchedule:
    """A link-outage FaultSchedule from a reference FaultSchedule dict;
    its loss / corruption / host lanes must be inert."""
    _require_inert(d, ("loss_p", "corrupt_p"), "FaultSchedule")
    _require_inert(d, ("host_fail_at", "nic_stall_at"), "FaultSchedule",
                   inert=lambda a: bool((a == NEVER_TICK).all()))
    return _build(FaultSchedule, d, device)


def faults_to_numpy(f: FaultSchedule) -> dict:
    return _to_numpy(f)
