"""AdamW, in place — the port of ``repro.train.optimizer``.

Moments are stored beside their parameter, in ``moment_dtype`` (f32 by
default; the 300B+ architectures run bf16 moments to fit their memory).
``apply_updates`` writes the new parameters and moments into the
caller's tensors, as the reference's launcher lets XLA do by donating
them (``donate_argnums=(0, 1)``): an out-of-place step would hold old
and new moments at once. The update's arithmetic is the reference's,
elementwise, run over flat slices of each leaf so that its f32
temporaries stay bounded; a slice gives the same bits as the whole
leaf. The step counter
stays a 0-d int32 tensor on the device: no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree as T

f32 = torch.float32

#: elements of one leaf updated at a time (256 MB per f32 temporary)
SLICE = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments beside each parameter, and the step counter."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    leaves = T.leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": T.map(zeros, params), "v": T.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: CUDA multiplies by a python scalar's reciprocal
    warm = torch.clamp(step.to(f32) / torch.tensor(
        float(max(cfg.warmup_steps, 1)), device=step.device), max=1.0)
    return cfg.lr * warm


def _slices(*ts: torch.Tensor):
    """Matching flat slices of same-shaped contiguous tensors."""
    n = ts[0].numel()
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


def grad_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's leaf order) of each leaf's f32
    sum of squares, as the reference's python ``sum``. Each leaf is
    reduced whole (one f32 square of it at a time), so the result does
    not depend on ``SLICE``."""
    total = None
    for g in T.leaves(grads):
        sq = torch.sum(torch.square(g.to(f32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, opt_state: dict, cfg: AdamWConfig):
    """One AdamW step, in place on ``params`` and ``opt_state``'s moments
    and counter. Returns (params, opt_state, grad_norm)."""
    gnorm = grad_norm(grads)
    # a true division (a python scalar over a tensor is a reciprocal and
    # a multiply in torch)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    opt_state["step"].add_(1)
    step = opt_state["step"]
    lr = _schedule(cfg, step)
    t = step.to(f32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=t.device), t)

    for p, g, m, v in zip(T.leaves(params), T.leaves(grads),
                          T.leaves(opt_state["m"]),
                          T.leaves(opt_state["v"])):
        for ps, gs, ms, vs in _slices(p, g.contiguous(), m, v):
            g32 = gs.to(f32) * scale
            m32 = ms.to(f32) * cfg.b1 + g32 * (1 - cfg.b1)
            v32 = vs.to(f32) * cfg.b2 + torch.square(g32) * (1 - cfg.b2)
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
                cfg.weight_decay * ps.to(f32)
            ps.copy_(ps.to(f32) - lr * delta)
            ms.copy_(m32)
            vs.copy_(v32)
    return params, opt_state, gnorm
