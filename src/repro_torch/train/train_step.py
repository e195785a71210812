"""Training step: chunked cross-entropy loss, remat'd backward, AdamW —
the port of ``repro.train.train_step``.

The LM-head matmul + softmax is the largest single activation of the
graph (logits [B, S, V]), so the loss is computed in sequence chunks,
each under ``torch.utils.checkpoint`` as the reference's under
``jax.checkpoint``: a chunk's logits are materialized, reduced to a
scalar and recomputed on the backward pass. This bounds loss memory to
[B, chunk, V] whatever S.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamWConfig, apply_updates

f32 = torch.float32

LOSS_CHUNK = 512
MOE_AUX_WEIGHT = 0.01


def _chunk_ce(h, head, labels):
    """Sum over [B, c] of logsumexp - the label's logit, f32."""
    logits = (h @ head).to(f32)                          # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)                # [B, c]
    # the reference's one-hot contraction picks the label's logit: the
    # same value and gradient as a gather
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(lse - true_logit)


def chunked_ce_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = LOSS_CHUNK):
    """Mean cross-entropy over [B, S] without materializing [B, S, V];
    the chunks summed in order (``acc + one``), then ``/ (B * S)``."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    n = S // chunk
    hs = hidden.reshape(B, n, chunk, D).transpose(0, 1)
    ls = labels.reshape(B, n, chunk).transpose(0, 1)
    grad = torch.is_grad_enabled() and (hidden.requires_grad
                                        or head.requires_grad)
    total = torch.zeros((), dtype=f32, device=hidden.device)
    for i in range(n):
        one = (checkpoint(_chunk_ce, hs[i], head, ls[i], use_reentrant=False)
               if grad else _chunk_ce(hs[i], head, ls[i]))
        total = total + one
    # a true division on every device (CUDA multiplies by the reciprocal
    # of a python scalar divisor)
    return total / torch.tensor(float(B * S), device=total.device)


def make_loss_fn(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                 act_spec=None, moe_token_spec=None,
                 scan_layers: bool = True, attn_head_specs=None,
                 loss_spec=None, remat_policy: str = "nothing",
                 moe_drops=None):
    """loss_fn(params, batch) -> (ce + MOE_AUX_WEIGHT * aux, (ce, aux)),
    the train step's loss. The sharding specs (``act_spec``,
    ``loss_spec``, ...) are accepted and are the identity on one device,
    as in ``build_forward``; ``moe_drops`` collects the MoE assignments
    dropped over capacity (see ``lm._moe_block``)."""
    fwd = lm.build_forward(cfg, mesh=mesh, dp_axes=dp_axes, remat=True,
                           act_spec=act_spec, output="hidden",
                           moe_token_spec=moe_token_spec,
                           scan_layers=scan_layers,
                           attn_head_specs=attn_head_specs,
                           remat_policy=remat_policy, moe_drops=moe_drops)

    def loss_fn(params, batch):
        hidden, aux, _ = fwd(params, batch["inputs"])
        ce = chunked_ce_loss(hidden, params["head"], batch["labels"])
        return ce + MOE_AUX_WEIGHT * aux, (ce, aux)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, ce, aux, grads) of ``loss_fn`` at ``params``: grads a tree
    like params, zeros for a leaf the loss does not reach (the embedding
    under precomputed embeds) or a non-float one, as JAX's."""
    with torch.enable_grad():
        live = T.map(lambda a: a.detach().requires_grad_(
            a.is_floating_point()), params)
        loss, (ce, aux) = loss_fn(live, batch)
        leaves = [a for a in T.leaves(live) if a.requires_grad]
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(a): g for a, g in zip(leaves, gs)}

        def grad_of(a):
            g = by_leaf.get(id(a))
            return torch.zeros_like(a) if g is None else g
        grads = T.map(grad_of, live)
    return loss.detach(), ce.detach(), aux.detach(), grads


def make_train_step(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    microbatches: int = 1, **loss_kw):
    """Build train_step(params, opt_state, batch) -> (params', opt',
    metrics); params' and opt' are the caller's tensors, updated in
    place.

    batch: {"inputs": [B, S] int (or [B, S, D] embeds for VLM stubs),
            "labels": [B, S] int}. ``loss_kw`` are ``make_loss_fn``'s
    (the reference's specs, ``scan_layers``, ``remat_policy``) and
    ``moe_drops``."""
    loss_fn = make_loss_fn(cfg, mesh=mesh, dp_axes=dp_axes, **loss_kw)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, ce, aux, grads = value_and_grad(loss_fn, params, batch)
        else:
            # gradient accumulation over microbatches, summed in the
            # reference's order
            B = batch["labels"].shape[0]
            mb = B // microbatches
            dev = batch["labels"].device
            loss = torch.zeros((), dtype=f32, device=dev)
            ce = torch.zeros((), dtype=f32, device=dev)
            aux = torch.zeros((), dtype=f32, device=dev)
            grads = None
            for i in range(microbatches):
                sl = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, c, a, g = value_and_grad(loss_fn, params, sl)
                loss = loss + l / microbatches
                ce = ce + c / microbatches
                aux = aux + a / microbatches
                grads = g if grads is None else T.map(torch.add, grads, g)
            grads = T.map(lambda x: x / microbatches, grads)
        params, opt_state, gnorm = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        metrics = {"loss": loss, "ce": ce, "moe_aux": aux,
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step
