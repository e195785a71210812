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

The control-plane states (``PDCPool``, ``PSNTracker``, ``FEPTables``,
``RecvQueue``, ``SecureDomain``, ``PSNGuard``, ``NSCCState``) cross the
same way, flat, through ``control_from_numpy`` / ``control_to_numpy``.

The LM's parameter and decode-cache trees cross as flat dicts of numpy
arrays keyed by path (``"blocks/pos0/mixer/wq"``) through
``lm_params_from_numpy`` / ``lm_params_to_numpy`` and
``lm_cache_from_numpy`` / ``lm_cache_to_numpy``: every path of the
config's tree is required and an unknown one raises. bf16 arrays (numpy
has no bf16 of its own; JAX hands out ``ml_dtypes.bfloat16``) cross by
their bit pattern; on the way back a bf16 tensor becomes f32, exactly.
The training state crosses the same way: a gradient tree through the
params' converters (the same paths and shapes) and the AdamW state
through ``lm_opt_state_from_numpy`` / ``lm_opt_state_to_numpy``
(``m/<param path>``, ``v/<param path>`` and ``step``, the reference's
``opt_state`` tree flattened).
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.addressing import FEPTables
from repro_torch.core.cms.nscc import NSCCState
from repro_torch.core.cms.rccc import RCCCState
from repro_torch.core.inc import INCState
from repro_torch.core.lb.schemes import LBState
from repro_torch.core.matching import RecvQueue
from repro_torch.core.pdc import PDCPool
from repro_torch.core.pds import PSNTracker
from repro_torch.core.tss import PSNGuard, SecureDomain
from repro_torch.models import lm
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


#: the uint32 lanes of each control-plane state
CONTROL_U32 = {
    PDCPool: frozenset({"next_psn", "start_psn"}),
    PSNTracker: frozenset({"base", "ring", "rx_ok", "dup", "oor"}),
    FEPTables: frozenset(),
    RecvQueue: frozenset({"tag_hi", "tag_lo", "mask_hi", "mask_lo",
                          "initiators"}),
    SecureDomain: frozenset({"sdk", "iv_mask", "pkt_counter"}),
    PSNGuard: frozenset({"start_psn", "expected_psn"}),
    NSCCState: frozenset(),
}


def control_from_numpy(cls, d: dict, device):
    """A control-plane state of class ``cls`` (a key of ``CONTROL_U32``)
    from the reference's, given as a dict of numpy arrays by field name
    (uint32 lanes become their int32 patterns); every field is required
    and an unknown one raises."""
    _require_known(d, cls, cls.__name__)
    u32 = CONTROL_U32[cls]
    vals = {}
    for f in fields(cls):
        a = np.array(d[f.name])
        if f.name in u32:
            a = a.astype(np.uint32).view(np.int32)
        vals[f.name] = torch.as_tensor(a).to(device)
    return cls(**vals)


def control_to_numpy(obj) -> dict:
    """A control-plane state as a dict of numpy arrays keyed like the
    reference's fields (uint32 lanes as uint32)."""
    u32 = CONTROL_U32[type(obj)]
    out = {}
    for f in fields(obj):
        a = getattr(obj, f.name).detach().cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in u32 else a
    return out


def _lm_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a)).to(device)


def _lm_tree(arrays: dict, known, what: str, device) -> dict:
    unknown = sorted(set(arrays) - set(known))
    missing = sorted(set(known) - set(arrays))
    if unknown or missing:
        raise NotImplementedError(
            f"{what} path(s) {unknown} are not in the port's tree"
            if unknown else f"{what} path(s) {missing} are missing")
    return lm.unflatten({k: _lm_tensor(arrays[k], device) for k in known})


def _lm_numpy(tree: dict) -> dict:
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in lm.flatten(tree).items()}


def lm_params_from_numpy(cfg: ArchConfig, arrays: dict, device) -> dict:
    """The port's LM parameter tree from the reference's, given as {path:
    numpy array}; the shapes must be the config's."""
    shapes = lm.param_shapes(cfg)
    for k, (shape, _) in shapes.items():
        if k in arrays and tuple(np.shape(arrays[k])) != shape:
            raise ValueError(f"LM param {k}: shape {np.shape(arrays[k])}, "
                             f"the config's is {shape}")
    return _lm_tree(arrays, shapes, "LM param", device)


def lm_params_to_numpy(params: dict) -> dict:
    """An LM parameter tree as {path: numpy array} (bf16 as f32)."""
    return _lm_numpy(params)


def lm_cache_from_numpy(cfg: ArchConfig, arrays: dict, device) -> dict:
    """The port's decode cache from the reference's, given as {path:
    numpy array}."""
    known = lm.flatten(lm.init_cache(cfg, 1, 1, device="meta"))
    return _lm_tree(arrays, known, "LM cache", device)


def lm_cache_to_numpy(cache: dict) -> dict:
    """A decode cache as {path: numpy array} (bf16 as f32)."""
    return _lm_numpy(cache)


def lm_opt_state_from_numpy(cfg: ArchConfig, arrays: dict, device) -> dict:
    """The port's AdamW state {"m", "v", "step"} from the reference's,
    given as {"m/<path>" | "v/<path>" | "step": numpy array}; the
    moments take the params' paths and shapes, the step is 0-d int32."""
    moments = {}
    for which in ("m", "v"):
        sub = {k[2:]: a for k, a in arrays.items()
               if k.startswith(which + "/")}
        moments[which] = lm_params_from_numpy(cfg, sub, device)
    extra = sorted(k for k in arrays
                   if k != "step" and not k.startswith(("m/", "v/")))
    if extra or "step" not in arrays:
        raise NotImplementedError(
            f"opt state path(s) {extra} are not in the port's tree"
            if extra else "opt state path 'step' is missing")
    step = np.asarray(arrays["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt state step: {step.dtype}{step.shape}, the "
                         f"reference's is a 0-d int32")
    return {**moments, "step": torch.as_tensor(step).to(device)}


def lm_opt_state_to_numpy(opt_state: dict) -> dict:
    """An AdamW state as {"m/<path>" | "v/<path>" | "step": numpy
    array} (bf16 moments as f32)."""
    out = {f"{w}/{k}": v for w in ("m", "v")
           for k, v in _lm_numpy(opt_state[w]).items()}
    out["step"] = opt_state["step"].detach().cpu().numpy()
    return out
