"""Fabric telemetry plane — the port of ``repro.network.telemetry``.

A :class:`TelemetrySpec` is a static of the tick, like the profile: the
off spec (the default) builds no probe, so an off run is the
pre-telemetry tick, operation for operation. An enabled spec makes
``make_step`` emit a ``probe`` dict beside its out lanes, and the
driver carries the probe lanes of every scenario in its stats carry
(``trace="stats"``), frozen with the other stat lanes when the scenario
stops. Memory is ``O(slots * channels)`` per scenario, whatever the
horizon.

Sampling is the reference's adaptive-decimation ring: a sample is
considered every ``probe_every`` ticks; when the ring is full, the odd
slots are dropped and the stride doubles, so slot ``i`` holds the sample
of tick ``i * stride * probe_every``. The decision depends only on the
tick and the lane's carried count and stride, per lane, so it is the
same at any chunk size, batch or shard. The tick is a Python int here,
so a tick off the ``probe_every`` grid updates only the accumulators.

The carry is laid out for one write per probe tick. The five per-queue
event counters are one [B, 5, Qc] lane (``CHANNELS``), and every ring
channel is a column block of one int32 ring ``ring`` [B, S + 1, R]
(f32 channels as their bit patterns; slot ``S`` is a scratch slot that a
lane off its grid writes into): occupancy EWMA, the five counters, RTT
and cwnd, then the three gauges. :func:`lanes` gives one scenario's
carry under the reference's keys and shapes, which is what
:meth:`FabricTrace.from_lanes` takes.

The occupancy EWMA ``ewma + 2**-ewma_shift * (occ - ewma)`` is computed
as the reference's compiled tick computes it on the CPU: a fused
multiply-add whose product is exact, with results below the smallest
normal f32 flushed to zero. The f64 sum rounded once to f32 gives the
fused result; the flush is explicit, as neither PyTorch device flushes.

:class:`FabricTrace` is a numpy copy of the reference's host-side report
(time series, window rates, summary, Chrome-trace / Perfetto export);
``flap_victim_scenario`` / ``outage_visibility`` /
``assert_outage_visible`` are its health canary on the port's builders.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as tnf

__all__ = ["TelemetrySpec", "FabricTrace", "create", "make_update",
           "event_rows", "queue_events", "lanes"]

I32 = torch.int32
F32 = torch.float32

#: the per-queue event counters, in their order along the [B, 5, Q] axis
CHANNELS = ("ecn", "trim", "drop", "llr", "stall")
ECN, TRIM, DROP, LLR, STALL = range(len(CHANNELS))
#: ring channels the reference keeps as [S, Qc] / [S, Fc] / [S, Gc] lanes,
#: in their column order in the packed ring
RING_LANES = ("s_occ", "s_ecn", "s_trim", "s_drop", "s_llr", "s_stall",
              "s_rtt", "s_cwnd", "s_inflight", "s_degraded", "s_delivered")
#: the largest subnormal f32: a result at or below it is flushed to zero
_SUBNORMAL_MAX = float(np.nextafter(np.float32(2.0 ** -126), np.float32(0)))


@dataclass(frozen=True)
class TelemetrySpec:
    """Static probe-channel selection (fields, defaults and validation as
    in the reference). The default is off.

    probe_every: base sampling cadence in ticks.
    slots: ring capacity (even, >= 2); when full, the odd slots are
        dropped and the stride doubles.
    queues / flows / gauges: channel groups; disabled groups carry
        width-0 lanes.
    ewma_shift: occupancy EWMA smoothing ``alpha = 2**-ewma_shift``.
    """

    enabled: bool = False
    probe_every: int = 16
    slots: int = 64
    queues: bool = True
    flows: bool = True
    gauges: bool = True
    ewma_shift: int = 3

    def __post_init__(self):
        if self.probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got "
                             f"{self.probe_every}")
        if self.slots < 2 or self.slots % 2:
            raise ValueError(f"slots must be even and >= 2, got "
                             f"{self.slots}")
        if not 0 <= self.ewma_shift <= 16:
            raise ValueError(f"ewma_shift must be in [0, 16], got "
                             f"{self.ewma_shift}")

    @staticmethod
    def off() -> "TelemetrySpec":
        """The default: no probe, the pre-telemetry tick."""
        return TelemetrySpec()

    @staticmethod
    def on(probe_every: int = 16, slots: int = 64, *, queues: bool = True,
           flows: bool = True, gauges: bool = True,
           ewma_shift: int = 3) -> "TelemetrySpec":
        return TelemetrySpec(enabled=True, probe_every=probe_every,
                             slots=slots, queues=queues, flows=flows,
                             gauges=gauges, ewma_shift=ewma_shift)


def _widths(spec: TelemetrySpec, Q: int, F: int) -> "tuple[int, int, int]":
    return (Q if spec.queues else 0, F if spec.flows else 0,
            1 if spec.gauges else 0)


def create(spec: TelemetrySpec, B: int, Q: int, F: int, device) -> dict:
    """The initial probe carry of B scenarios (every lane [B, ...])."""
    S = spec.slots
    Qc, Fc, Gc = _widths(spec, Q, F)
    R = 6 * Qc + 2 * Fc + 3 * Gc
    i32 = dict(dtype=I32, device=device)
    return {
        # ring bookkeeping: sample count, decimation stride (in units of
        # probe_every), per-slot sample tick (-1 = empty)
        "n": torch.zeros((B,), **i32),
        "stride": torch.ones((B,), **i32),
        "stamp": torch.full((B, S + 1), -1, **i32),
        # every-tick accumulators
        "ewma_q": torch.zeros((B, Qc), dtype=F32, device=device),
        "peak_q": torch.zeros((B, Qc), **i32),
        "cnt_q": torch.zeros((B, len(CHANNELS), Qc), **i32),
        "rtt_f": torch.zeros((B, Fc), dtype=F32, device=device),
        # the packed ring (slot i <-> tick i * stride * probe_every)
        "ring": torch.zeros((B, S + 1, R), **i32),
    }


def event_rows(B: int, Q: int, n: int,
               device) -> "tuple[torch.Tensor, torch.Tensor]":
    """The constants :func:`queue_events` takes for B scenarios of Q
    queues and n candidate lanes: each scenario's first flat row
    ([B, 1] int64) and B * n int32 ones."""
    rows = len(CHANNELS) + 1              # the channels and a discard row
    return ((torch.arange(B, device=device) * (rows * Q))[:, None],
            torch.ones((B * n,), dtype=I32, device=device))


def queue_events(rows, Q: int, mark, target, drop_ev, trim_ev=None,
                 stall=None, tx_drop=None, llr=None) -> torch.Tensor:
    """This tick's per-queue event counts, [B, 5, Q] int32 in
    ``CHANNELS`` order. The queue lanes ``mark`` (ECN), ``tx_drop``
    (drops charged at the transmitting queue) and ``llr`` ([B, Q] bool)
    count at their own queue; the candidate lanes ``drop_ev``,
    ``trim_ev`` and ``stall`` ([B, n] bool, disjoint) at their
    ``target`` queue ([B, n] int64). None is a lane with no events.
    ``rows`` is :func:`event_rows`' pair. The candidate lanes are one
    scatter-add into each scenario's rows (lanes without an event go to a
    discard row), so no temporary is larger than [B, 6, Q] or [B, n];
    integer adds are exact in any order."""
    row0, ones = rows
    B = int(target.shape[0])
    ch = torch.where(drop_ev, DROP, len(CHANNELS))
    for ev, c in ((trim_ev, TRIM), (stall, STALL)):
        if ev is not None:
            ch = torch.where(ev, c, ch)
    idx = (ch * Q + row0 + target).view(-1)
    cnt = torch.zeros((B, len(CHANNELS) + 1, Q), dtype=I32,
                      device=target.device)
    cnt.view(-1).scatter_add_(0, idx, ones)
    cnt[:, ECN].add_(mark)
    if tx_drop is not None:
        cnt[:, DROP].add_(tx_drop)
    if llr is not None:
        cnt[:, LLR].add_(llr)
    return cnt[:, :len(CHANNELS)]


def make_update(spec: TelemetrySpec, Q: int, F: int, device):
    """The per-tick probe transition ``update(tel, s, probe, tick) ->
    tel'`` over B scenarios: ``s`` is the state after the tick, ``probe``
    the step's probe dict (``cnt`` [B, 5, Q] from :func:`queue_events`,
    ``rtt`` / ``has_rtt`` / ``cwnd`` [B, F]), ``tick`` a Python int.

    Sample decision, per lane, as the reference's: a sample is taken at
    tick t iff ``t % probe_every == 0`` and ``(t // probe_every) %
    stride == 0``; a lane whose ring holds ``slots`` samples at a sample
    point first keeps its even slots (the upper half stays stale until
    rewritten), halves its count and doubles its stride. A probe tick
    gathers each ring through its lane's compaction index and writes the
    sample into one slot per lane (the scratch slot for a lane off its
    grid)."""
    S = spec.slots
    pe = spec.probe_every
    Qc, Fc, Gc = _widths(spec, Q, F)
    alpha = 1.0 / (1 << spec.ewma_shift)
    comp = np.concatenate([np.arange(S // 2) * 2, np.arange(S // 2, S + 1)])
    comp_idx = torch.as_tensor(comp, dtype=torch.int64, device=device)
    slot_ids = torch.arange(S + 1, dtype=torch.int64, device=device)

    def update(tel: dict, s, probe: dict, tick: int) -> dict:
        # ---- every-tick accumulators ---------------------------------
        q_len = s.q_len[:, :Qc]
        ewma = tel["ewma_q"]
        d = q_len - ewma                                   # f32, rounded
        ewma = tnf.threshold(torch.add(ewma.double(), d, alpha=alpha)
                             .float(), _SUBNORMAL_MAX, 0.0)
        out = dict(tel)
        out["ewma_q"] = ewma
        out["peak_q"] = torch.maximum(tel["peak_q"], q_len)
        if Qc:
            out["cnt_q"] = tel["cnt_q"] + probe["cnt"]
        if Fc:
            out["rtt_f"] = torch.where(probe["has_rtt"], probe["rtt"],
                                       tel["rtt_f"])
        if tick % pe:
            return out
        # ---- probe tick: the sample decision, per lane ---------------
        n, stride = tel["n"], tel["stride"]
        aligned = (tick // pe) % stride == 0
        dec = aligned & (n >= S)
        n = torch.where(dec, S // 2, n)
        out["stride"] = torch.where(dec, stride * 2, stride)
        out["n"] = n + aligned.to(I32)
        src = torch.where(dec[:, None], comp_idx, slot_ids)    # [B, S+1]
        slot = torch.where(aligned, n, S).long()[:, None]      # [B, 1]
        stamp = tel["stamp"].gather(1, src)
        out["stamp"] = stamp.scatter_(1, slot, tick)
        parts = [out["ewma_q"].view(I32), out["cnt_q"].flatten(1),
                 out["rtt_f"].view(I32), probe["cwnd"][:, :Fc].view(I32)]
        if Gc:
            parts.append(torch.stack(
                [s.inflight.sum(dim=-1, dtype=I32), s.ticks_degraded,
                 s.delivered.sum(dim=-1, dtype=I32)], dim=-1))
        row = torch.cat(parts, dim=-1)                         # [B, R]
        R = row.shape[-1]
        ring = tel["ring"].gather(1, src[..., None].expand(-1, -1, R))
        out["ring"] = ring.scatter_(1, slot[..., None].expand(-1, 1, R),
                                    row[:, None])
        return out

    return update


def lanes(spec: TelemetrySpec, Q: int, F: int, tel: dict) -> dict:
    """One scenario's probe carry (a lane of the batch, tensors or numpy
    arrays without the [B] axis) as numpy arrays under the reference's
    keys and shapes: ``n``, ``stride``, ``stamp`` [S], the accumulators
    ``ewma_q`` ... ``rtt_f`` and the rings ``s_occ`` ... ``s_delivered``
    [S, width], stale slots included."""
    S = spec.slots
    Qc, Fc, Gc = _widths(spec, Q, F)
    g = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v)) for k, v in tel.items()}
    ring = g["ring"][:S]
    widths = (Qc,) * 6 + (Fc,) * 2 + (Gc,) * 3
    cols = np.cumsum((0,) + widths)
    out = {"n": np.int32(g["n"]), "stride": np.int32(g["stride"]),
           "stamp": g["stamp"][:S],
           "ewma_q": g["ewma_q"], "peak_q": g["peak_q"],
           "rtt_f": g["rtt_f"]}
    for c, name in enumerate(CHANNELS):
        out[f"{name}_q"] = g["cnt_q"][c]
    for i, name in enumerate(RING_LANES):
        a = np.ascontiguousarray(ring[:, cols[i]:cols[i + 1]])
        out[name] = a.view(np.float32) if name in ("s_occ", "s_rtt",
                                                   "s_cwnd") else a
    return out


# --------------------------------------------------------------------------
# host-side report object (a numpy copy of the reference's)
# --------------------------------------------------------------------------

def _col(a: np.ndarray) -> "np.ndarray | None":
    """Squeeze a [n, 0/1] gauge lane to [n], or None when disabled."""
    return a[:, 0] if a.shape[-1] else None


@dataclass(frozen=True)
class FabricTrace:
    """One scenario's reconstructed telemetry time series (plain numpy),
    as ``SimResult.telemetry``. ``ticks`` is the surviving sample grid;
    ``ecn`` / ``trim`` / ``drop`` / ``llr`` / ``stall`` / ``degraded`` /
    ``delivered`` are cumulative at each sample, ``occ`` the occupancy
    EWMA, ``rtt`` / ``cwnd`` the latest per-flow samples. ``lanes`` is
    the whole probe carry it was built from (:func:`lanes`: every ring
    slot, stale ones included)."""

    spec: TelemetrySpec
    horizon: int
    ticks: np.ndarray                      # [n] sample ticks
    occ: np.ndarray                        # [n, Qc] occupancy EWMA
    ecn: np.ndarray                        # [n, Qc] cumulative marks
    trim: np.ndarray                       # [n, Qc] cumulative trims
    drop: np.ndarray                       # [n, Qc] cumulative drops
    llr: np.ndarray                        # [n, Qc] cumulative LLR replays
    stall: np.ndarray                      # [n, Qc] cumulative credit stalls
    peak_q: np.ndarray                     # [Qc] running peak occupancy
    rtt: np.ndarray                        # [n, Fc] latest RTT sample
    cwnd: np.ndarray                       # [n, Fc] congestion window
    inflight: "np.ndarray | None"          # [n] packets in flight
    degraded: "np.ndarray | None"          # [n] cumulative degraded ticks
    delivered: "np.ndarray | None"         # [n] cumulative delivered
    stride: int = 1                        # final decimation stride
    final: dict = field(default_factory=dict)  # final accumulator values
    lanes: dict = field(default_factory=dict)  # the whole probe carry

    @staticmethod
    def from_lanes(spec: TelemetrySpec, tel: dict,
                   horizon: int) -> "FabricTrace":
        n = int(tel["n"])
        g = {k: np.asarray(tel[k]) for k in tel}
        return FabricTrace(
            spec=spec, horizon=int(horizon),
            ticks=g["stamp"][:n].astype(np.int64),
            occ=g["s_occ"][:n], ecn=g["s_ecn"][:n], trim=g["s_trim"][:n],
            drop=g["s_drop"][:n], llr=g["s_llr"][:n],
            stall=g["s_stall"][:n], peak_q=g["peak_q"],
            rtt=g["s_rtt"][:n], cwnd=g["s_cwnd"][:n],
            inflight=_col(g["s_inflight"][:n]),
            degraded=_col(g["s_degraded"][:n]),
            delivered=_col(g["s_delivered"][:n]),
            stride=int(g["stride"]),
            final={"ecn_q": g["ecn_q"], "trim_q": g["trim_q"],
                   "drop_q": g["drop_q"], "llr_q": g["llr_q"],
                   "stall_q": g["stall_q"], "ewma_q": g["ewma_q"],
                   "rtt_f": g["rtt_f"]},
            lanes=g,
        )

    @property
    def num_samples(self) -> int:
        return int(self.ticks.shape[0])

    @property
    def sample_spacing(self) -> int:
        """Ticks between surviving samples (stride * probe_every)."""
        return self.stride * self.spec.probe_every

    # ---- windowed rates off the cumulative channels ---------------------
    def _at(self, cum: np.ndarray, t: float) -> np.ndarray:
        """Cumulative channel value at time t: the last sample with
        tick <= t (zeros before the first sample)."""
        j = int(np.searchsorted(self.ticks, t, side="right")) - 1
        return cum[j] if j >= 0 else np.zeros_like(cum[0:1]).reshape(
            cum.shape[1:]) if cum.ndim > 1 else np.zeros((), cum.dtype)

    def window_rates(self, w0: int, w1: int) -> dict:
        """Per-queue mark/trim/drop rates (events per tick) and scenario
        goodput (packets per tick) over [w0, w1), from the cumulative
        channels at the nearest enclosed sample points."""
        if not self.spec.queues:
            raise ValueError("queue channels disabled in this TelemetrySpec")
        dt = float(w1 - w0)
        if dt <= 0:
            raise ValueError(f"empty window [{w0}, {w1})")
        rates = {
            "mark": (self._at(self.ecn, w1 - 1)
                     - self._at(self.ecn, w0 - 1)) / dt,
            "trim": (self._at(self.trim, w1 - 1)
                     - self._at(self.trim, w0 - 1)) / dt,
            "drop": (self._at(self.drop, w1 - 1)
                     - self._at(self.drop, w0 - 1)) / dt,
        }
        if self.delivered is not None:
            rates["goodput"] = float(
                self._at(self.delivered, w1 - 1)
                - self._at(self.delivered, w0 - 1)) / dt
        return rates

    def summary(self) -> dict:
        """Headline health numbers for the run."""
        out: dict = {"horizon": self.horizon,
                     "samples": self.num_samples,
                     "sample_spacing_ticks": self.sample_spacing}
        if self.spec.queues and self.num_samples:
            out.update(
                occ_p50=float(np.percentile(self.occ, 50)),
                occ_p99=float(np.percentile(self.occ, 99)),
                occ_peak=int(self.peak_q.max()) if self.peak_q.size else 0,
                marks_total=int(self.final["ecn_q"].sum()),
                trims_total=int(self.final["trim_q"].sum()),
                drops_total=int(self.final["drop_q"].sum()),
                llr_replays_total=int(self.final["llr_q"].sum()),
                credit_stalls_total=int(self.final["stall_q"].sum()),
                mark_rate=float(self.final["ecn_q"].sum()) / self.horizon,
                trim_rate=float(self.final["trim_q"].sum()) / self.horizon,
                drop_rate=float(self.final["drop_q"].sum()) / self.horizon,
            )
        if self.spec.flows and self.num_samples:
            seen = self.rtt[self.rtt > 0]
            if seen.size:
                out.update(rtt_p50=float(np.percentile(seen, 50)),
                           rtt_p99=float(np.percentile(seen, 99)))
        if self.delivered is not None and self.num_samples:
            out["goodput"] = float(self.delivered[-1]) / max(
                int(self.ticks[-1]), 1)
        return out

    # ---- Chrome-trace / Perfetto export ---------------------------------
    def to_chrome_trace(self, label: str = "fabric") -> list:
        """Chrome-trace counter events (``chrome://tracing`` and
        https://ui.perfetto.dev load the JSON directly). One counter
        track per channel; ``ts`` is the sample tick (one tick rendered
        as 1 us)."""
        ev = []

        def counter(name, ts, args, pid=0):
            ev.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                       "ts": int(ts), "args": args})

        for i, t in enumerate(self.ticks):
            if self.spec.queues:
                counter(f"{label}.occ_ewma", t,
                        {f"q{q}": float(self.occ[i, q])
                         for q in range(self.occ.shape[1])})
                dt = float(t - (self.ticks[i - 1] if i else -1))
                for ch, lane in (("mark", self.ecn), ("trim", self.trim),
                                 ("drop", self.drop), ("llr", self.llr),
                                 ("stall", self.stall)):
                    base = lane[i - 1] if i else np.zeros_like(lane[0])
                    counter(f"{label}.{ch}_rate", t,
                            {f"q{q}": float((lane[i, q] - base[q]) / dt)
                             for q in range(lane.shape[1])})
            if self.spec.flows:
                counter(f"{label}.rtt", t,
                        {f"f{fl}": float(self.rtt[i, fl])
                         for fl in range(self.rtt.shape[1])})
                counter(f"{label}.cwnd", t,
                        {f"f{fl}": float(self.cwnd[i, fl])
                         for fl in range(self.cwnd.shape[1])})
            if self.inflight is not None:
                counter(f"{label}.inflight", t,
                        {"pkts": int(self.inflight[i])})
        return ev

    def save_chrome_trace(self, path: str, label: str = "fabric") -> str:
        """Write ``{"traceEvents": [...]}`` JSON to ``path``."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_chrome_trace(label),
                       "displayTimeUnit": "ms"}, f)
        return path


# --------------------------------------------------------------------------
# health canary
# --------------------------------------------------------------------------
