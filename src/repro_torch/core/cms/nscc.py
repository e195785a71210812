"""Network Signal-based Congestion Control (Sec. 3.3.1) — the port of
``repro.core.cms.nscc``.

Four cases on each arriving ACK (ECN x high/low RTT) plus Quick Adapt,
as plain functions over per-flow [F] tensors. The f32 ``cwnd`` lane is
held bitwise against the JAX engine, so the arithmetic keeps JAX's
order and types: every Python-float constant acts as a weakly typed f32
(torch likewise computes ``f32_tensor op python_float`` in f32), and no
multiply-add is fused by hand.

One division has two forms. The reference runs its tick under
``jax.jit``, and XLA's algebraic simplifier rewrites the quick-increase
gap's division by the constant target, ``(target - rtt) / target``, into
a multiply by the target's f32 reciprocal, folded at compile time; the
same functions run eagerly (the kernel oracle, the reference's unit
calls) divide exactly. The two differ in the last bit for some RTTs
(``(12.5 - 10) / 12.5`` is 0.2, ``2.5 * f32(0.08)`` is 0.19999999).
``on_ack_per_flow`` — what the port's tick calls through ``NSCCPolicy``
— always takes the folded form, so the ``cwnd`` lane stays bitwise with
the reference engine; ``window_delta`` takes the exact one by default
(``folded_reciprocal``), as the kernel oracle ``nscc_update_ref`` needs.

The batch API over a pool of CCCs — ``classify``, ``on_acks``,
``on_loss`` and DFC's ``apply_dfc_penalty`` — is the reference's eager
one: it divides exactly, and its f32 scatters over repeated CCCs add
(or multiply) in lane order, as the reference's do on the CPU, on every
device (``repro_torch.core.scatter``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.core import scatter
from repro_torch.core.types import lane_shape


@dataclass(frozen=True)
class NSCCParams:
    """Control-loop gains. Class-level defaults; tune via replace()."""

    base_rtt: float = 8.0        # unloaded RTT estimate, ticks
    target_factor: float = 1.25  # high/low RTT threshold = base_rtt * this
    md: float = 0.65             # case-2 multiplicative decrease per ACK
    quick_gain: float = 0.60     # case-3 increase gain (packets per ACK max)
    ai: float = 1.0              # case-4 additive increase (pkts per cwnd ACKs)
    min_cwnd: float = 1.0
    max_cwnd: float = 64.0       # slightly above BDP; optimistic start value
    qa_min_frac: float = 0.125   # QA floor as a fraction of max_cwnd


@dataclass(frozen=True)
class NSCCState:
    """Per-CCC state (SoA over N contexts).

    cwnd:        [N] float32 congestion window, packets
    epoch_acked: [N] int32 packets delivered in current QA epoch
    epoch_lost:  [N] int32 packets reported lost in current QA epoch
    epoch_tick:  [N] int32 tick when the current QA epoch started
    """

    cwnd: torch.Tensor
    epoch_acked: torch.Tensor
    epoch_lost: torch.Tensor
    epoch_tick: torch.Tensor

    @staticmethod
    def create(n: "int | tuple[int, ...]", params: NSCCParams,
               device: torch.device) -> "NSCCState":
        """n contexts, or a lane shape such as (B, F)."""
        shape = lane_shape(n)
        # optimistic start: window at/near BDP (Sec. 3.3.3)
        z = torch.zeros(shape, dtype=torch.int32, device=device)
        return NSCCState(
            cwnd=torch.full(shape, params.max_cwnd, dtype=torch.float32,
                            device=device),
            epoch_acked=z, epoch_lost=z.clone(), epoch_tick=z.clone())


def classify(ecn: torch.Tensor, rtt: torch.Tensor,
             params: NSCCParams) -> torch.Tensor:
    """Return the paper's case number (1..4) per ACK, int32."""
    high = rtt > params.base_rtt * params.target_factor
    case = torch.where(ecn, torch.where(high, 2, 1),
                       torch.where(high, 4, 3))
    return case.to(torch.int32)


def _f32_reciprocal(x: float) -> float:
    """The f32 reciprocal of f32(x), as XLA folds ``1 / constant``."""
    one = torch.ones((), dtype=torch.float32)
    return float(one / torch.tensor(x, dtype=torch.float32))


def window_delta(cwnd: torch.Tensor, ecn: torch.Tensor, rtt: torch.Tensor,
                 params: NSCCParams,
                 folded_reciprocal: bool = False) -> torch.Tensor:
    """Per-ACK window adjustment (packets); the four-case core.

    Every division is tensor by tensor: torch turns a division BY a
    Python scalar into a multiply by its reciprocal on CUDA, and
    ``scalar / tensor`` into ``reciprocal * scalar`` everywhere, either
    of which can differ from JAX's correctly rounded f32 division in the
    last bit. ``folded_reciprocal`` computes the gap as the reference's
    compiled tick does (module docstring)."""
    target = params.base_rtt * params.target_factor
    high = rtt > target
    # case 2: aggressive MD proportional to RTT excess, per incoming ACK
    overload = ((rtt - target) / torch.clamp(rtt, min=1e-6)).clamp(0.0, 1.0)
    dec = -params.md * overload
    # case 3: quick increase guessing from measured vs expected RTT
    if folded_reciprocal:
        gap = ((target - rtt) * _f32_reciprocal(target)).clamp(0.0, 1.0)
    else:
        gap = ((target - rtt) / torch.full_like(rtt, target)).clamp(0.0, 1.0)
    quick = params.quick_gain * gap
    # case 4: gentle additive increase (+ai per full window of ACKs)
    gentle = torch.full_like(cwnd, params.ai) / torch.clamp(cwnd, min=1.0)
    zero = torch.zeros_like(dec)
    return torch.where(ecn, torch.where(high, dec, zero),
                       torch.where(high, gentle, quick))


def on_acks(state: NSCCState, params: NSCCParams, ccc: torch.Tensor,
            ecn: torch.Tensor, rtt: torch.Tensor,
            valid: torch.Tensor) -> NSCCState:
    """Apply a batch of ACKs: ccc [B] int32, ecn [B] bool, rtt [B] float32.

    Multiple ACKs may target the same CCC in one batch; each lane's delta
    is taken from the window before the batch, and a CCC adds its lanes'
    deltas in lane order (the reference's order on the CPU; torch's
    atomic scatter-add would leave it to the device). Lanes with
    ``valid`` False, or a CCC outside [-N, N), change nothing.
    """
    cw = scatter.gather(state.cwnd, ccc)
    delta = window_delta(cw, ecn, rtt.to(torch.float32), params)
    drop = torch.where(valid, ccc.to(torch.int64), state.cwnd.shape[0])
    cwnd = scatter.add_at_ordered(state.cwnd, drop, delta)
    return replace(
        state, cwnd=cwnd.clamp(params.min_cwnd, params.max_cwnd),
        epoch_acked=scatter.add_at(state.epoch_acked, drop, 1))


def on_loss(state: NSCCState, ccc: torch.Tensor, count: torch.Tensor,
            valid: torch.Tensor) -> NSCCState:
    """Record loss evidence (trim NACK / EV-inference / timeout) for QA."""
    drop = torch.where(valid, ccc.to(torch.int64), state.cwnd.shape[0])
    return replace(state, epoch_lost=scatter.add_at(
        state.epoch_lost, drop, count.to(torch.int32)))


def apply_dfc_penalty(state: NSCCState, params: NSCCParams,
                      ccc: torch.Tensor, penalty: torch.Tensor,
                      valid: torch.Tensor) -> NSCCState:
    """Destination Flow Control for NSCC (Sec. 3.3.4): the receiver sends a
    window *penalty* that scales the sender's congestion window. Repeated
    CCCs multiply in lane order."""
    drop = torch.where(valid, ccc.to(torch.int64), state.cwnd.shape[0])
    one = torch.ones_like(penalty, dtype=torch.float32)
    scale = (one - penalty).clamp(0.05, 1.0)
    cwnd = scatter.mul_at_ordered(state.cwnd, drop, scale)
    return replace(state, cwnd=cwnd.clamp(params.min_cwnd, params.max_cwnd))


def on_ack_per_flow(state: NSCCState, params: NSCCParams, ecn: torch.Tensor,
                    rtt: torch.Tensor, active: torch.Tensor) -> NSCCState:
    """One ACK per CCC per round (the fabric tick): elementwise update,
    with the gap in the compiled tick's folded form (module docstring)."""
    delta = window_delta(state.cwnd, ecn, rtt.to(torch.float32), params,
                         folded_reciprocal=True)
    cwnd = torch.where(active, state.cwnd + delta, state.cwnd)
    return replace(
        state,
        cwnd=cwnd.clamp(params.min_cwnd, params.max_cwnd),
        epoch_acked=state.epoch_acked + active.to(torch.int32),
    )


def on_loss_per_flow(state: NSCCState, count: torch.Tensor) -> NSCCState:
    """count [N] losses per CCC, elementwise."""
    return replace(state, epoch_lost=state.epoch_lost + count)


def quick_adapt(state: NSCCState, params: NSCCParams, now: int) -> NSCCState:
    """Once per RTT-epoch: if losses were seen, rescale cwnd to the
    delivered fraction (Sec. 3.3.1 QA / SMaRTT)."""
    epoch_len = int(params.base_rtt * params.target_factor)
    due = (now - state.epoch_tick) >= epoch_len
    delivered = state.epoch_acked.to(torch.float32)
    lost = state.epoch_lost.to(torch.float32)
    frac = delivered / torch.clamp(delivered + lost, min=1.0)
    lossy = due & (state.epoch_lost > 0)
    new_cwnd = torch.where(
        lossy,
        (state.cwnd * frac).clamp(params.qa_min_frac * params.max_cwnd,
                                  params.max_cwnd),
        state.cwnd)
    return NSCCState(
        cwnd=torch.clamp(new_cwnd, min=params.min_cwnd),
        epoch_acked=torch.where(due, 0, state.epoch_acked),
        epoch_lost=torch.where(due, 0, state.epoch_lost),
        epoch_tick=torch.where(due, now, state.epoch_tick),
    )


@dataclass(frozen=True)
class NSCCPolicy:
    """NSCC as the fabric engine's CC policy: per-tick hooks over
    densified [F] (or [B, F]) lanes (the protocol of ``repro_torch.network.profile``).
    Only the hooks the NSCC composition acts on do work; the rest return
    the state unchanged. Its arithmetic is the reference's compiled tick
    (module docstring)."""

    params: NSCCParams

    def create(self, f, device: torch.device) -> NSCCState:
        return NSCCState.create(f, self.params, device)

    def on_ack(self, st: NSCCState, has_ack, ecn, rtt) -> NSCCState:
        return on_ack_per_flow(st, self.params, ecn, rtt, has_ack)

    def on_nack(self, st: NSCCState, count) -> NSCCState:
        return on_loss_per_flow(st, count)

    def on_grant_tick(self, st, flow_dst, active, num_hosts):
        return st  # sender-based: no receiver scheduling round

    def on_send_gate(self, st: NSCCState, inflight) -> torch.Tensor:
        return inflight < torch.floor(st.cwnd).to(torch.int32)

    def on_inject(self, st, injected):
        return st  # window-based: nothing to spend per packet

    def on_rx_seen(self, st, seen):
        return st

    def on_timeout(self, st: NSCCState, stalled) -> NSCCState:
        return on_loss_per_flow(st, stalled.to(torch.int32))

    def end_of_tick(self, st: NSCCState, tick: int) -> NSCCState:
        return quick_adapt(st, self.params, tick)

    def cwnd_view(self, st: NSCCState, f) -> torch.Tensor:
        return st.cwnd
