"""Carry engine state between the reference and the port.

The reference's ``SimState``, ``Workload`` and ``FaultSchedule`` travel
as nested dicts of numpy arrays keyed by field name (nested dataclasses
— the PSN trackers, the CC state, the LB state — as nested dicts). This
module turns such a dict into the port's dataclasses on a device and
back. uint32 lanes become int32 bit patterns (``np.ndarray.view``) on the
way in and uint32 again on the way out, so a round trip is bitwise.

The CC state takes the form of the profile's policy: NSCC's and RCCC's
lanes, the hybrid's ``{"nscc": ..., "rccc": ...}`` dict, or the open
loop's empty [0] int32 placeholder; each is recognised by its keys.

Every lane of the reference's ``SimState`` crosses, the INC contexts
and the link-layer lanes (LLR replay windows, the 20-bit CBFC counters
and their credit-return ring) included; a lane the port does not know
raises ``NotImplementedError`` instead of being dropped. A
``FaultSchedule`` crosses whole: link windows, gray-link and BER lanes,
the seed (a uint32 lane) and the host / NIC lanes.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass

import numpy as np
import torch

from repro_torch.core.cms.nscc import NSCCState
from repro_torch.core.cms.rccc import RCCCState
from repro_torch.core.inc import INCState
from repro_torch.core.lb.schemes import LBState
from repro_torch.core.pds import PSNTracker
from repro_torch.network.fabric import SimState, Workload
from repro_torch.network.faults import FaultSchedule

#: dotted paths of the lanes the reference keeps as uint32
U32_LANES = frozenset(
    [f"{t}.{k}" for t in ("src_track", "dst_track")
     for k in ("base", "ring", "rx_ok", "dup", "oor")]
    + ["rtx", "lb.salt", "seed", "inc.slot_bits", "cbfc_consumed",
       "cbfc_freed"])

_NESTED = {"src_track": PSNTracker, "dst_track": PSNTracker,
           "lb": LBState, "inc": INCState}
_CC_STATES = (NSCCState, RCCCState)


def _require_known(d: dict, cls, what: str):
    unknown = sorted(set(d) - {f.name for f in fields(cls)})
    if unknown:
        raise NotImplementedError(
            f"{what} lane(s) {unknown} are not carried by the port (see "
            f"ROADMAP.md, 'Modules to port')")


def _to_tensor(a, path: str, device) -> torch.Tensor:
    a = np.array(a)          # an owned, writable copy (0-dim stays 0-dim)
    if path in U32_LANES:
        a = a.astype(np.uint32).view(np.int32)
    return torch.as_tensor(a).to(device)


def _cc_state(d, device, prefix="cc."):
    """The port's CC state from the reference's, by its form."""
    if not isinstance(d, dict):
        a = np.asarray(d)
        if a.shape != (0,):
            raise ValueError(f"unrecognised CC state lane of shape "
                             f"{a.shape}")
        return torch.zeros((0,), dtype=torch.int32, device=device)
    if set(d) == {"nscc", "rccc"}:
        return {k: _cc_state(d[k], device, f"{prefix}{k}.")
                for k in ("nscc", "rccc")}
    for cls in _CC_STATES:
        if set(d) == {f.name for f in fields(cls)}:
            return _build(cls, d, device, prefix)
    raise ValueError(f"unrecognised CC state with keys {sorted(d)}")


def _build(cls, d: dict, device, prefix=""):
    vals = {}
    for f in fields(cls):
        sub = _NESTED.get(f.name) if not prefix else None
        if sub is not None:
            vals[f.name] = _build(sub, d[f.name], device, f"{f.name}.")
        elif f.name == "cc" and not prefix:
            vals[f.name] = _cc_state(d[f.name], device)
        else:
            vals[f.name] = _to_tensor(d[f.name], prefix + f.name, device)
    return cls(**vals)


def _leaf_to_numpy(v, path: str):
    if is_dataclass(v):
        return _to_numpy(v, f"{path}.")
    if isinstance(v, dict):
        return {k: _leaf_to_numpy(x, f"{path}.{k}") for k, x in v.items()}
    a = v.detach().cpu().numpy()
    return a.view(np.uint32) if path in U32_LANES else a


def _to_numpy(obj, prefix="") -> dict:
    return {f.name: _leaf_to_numpy(getattr(obj, f.name), prefix + f.name)
            for f in fields(obj)}


def state_from_numpy(d: dict, device) -> SimState:
    """The port's SimState from a reference SimState given as a nested
    dict of numpy arrays."""
    _require_known(d, SimState, "SimState")
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
    """The port's FaultSchedule from a reference FaultSchedule dict,
    every lane carried (the seed as its int32 pattern)."""
    return _build(FaultSchedule, d, device)


def faults_to_numpy(f: FaultSchedule) -> dict:
    return _to_numpy(f)
