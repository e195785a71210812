#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--out results.json] [--trace flap.json]

Phases, one line each:

1. device — the card's name and power limit (``nvidia-smi``); no CUDA,
   no run: the script exits non-zero before printing any result.
2. build  — compile every CUDA kernel of the port from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — each of the fourteen kernels against its plain PyTorch
   version on the card, random inputs plus edge lanes, bitwise: the
   dense ``sack_fused`` / ``sack_advance`` and ``nack_mark`` at the main
   path's shapes (F = 2048 flows, W = 16 ring words, L = Q + 2F = 9216
   NACK lanes); the own-bit ``sack_fused_own`` / ``sack_advance_own``
   at N in {1, 33, 2048} x W in {1, 3, 8, 16, 17, 32}, and the in-place
   marks on the retransmit ring ``nack_mark_lanes`` (with and without a
   ROD mask), ``set_own_bit`` (with and without ``unless``) and
   ``clear_own_bit`` at F in {1, 33, 2048} x W in {1, 3, 16, 17, 32},
   each timed at the main shape; then the five tick kernels at the batch
   phase's shapes, B = 4 scenarios: the own-bit SACK forms and the row
   marks over B·F = 8192 rows, and ``nack_mark_lanes`` with the
   scenario stride (B x W in {1, 3, 8} x {1, 16, 17, 32} at F in
   {1, 33, 2048}, lanes as [B, L] slices of wider rows, out-of-range
   flows in every scenario), each bitwise and timed (kernel, plain,
   device, bound from the lanes, the rows they reach and a read and a
   write of each word marked); ``nscc_update`` (N = F = 2048) and
   ``ecmp_select`` (N = Q + F = 7168) at the entry-point path's shapes
   and at a pool of N = 2**24 lanes. Kernel and plain times (CUDA
   events, warm, median of 20) beside the bound (for the marks, the
   bytes this data needs: the lanes, and the rows and words they
   reach); each kernel's device time alone (``torch.profiler``, CUDA
   kernel time / launches). The tick forms of the last two: ``nscc_ack``
   (NSCC's per-flow ACK update, the tick's folded gap) and ``nscc_epoch``
   (Quick Adapt) on the lanes of tick ``TICK_CAPTURE - 1`` of the
   full-width ``ai_full`` batch (B = 4) and at B·F in {1, 33, 2048, 8192}
   under three params sets with edge lanes (rtt 0, at and just below the
   target, +-inf, NaN; cwnd below 1, at min and max, NaN; has_ack off;
   lost 0 and > 0; epoch ages epoch_len - 1, epoch_len, epoch_len + 1);
   ``ecmp_inject`` ([4, 2048] flow lanes) and ``ecmp_route`` ([4, 5120]
   queue heads under the [Q] ids, read with a zero scenario stride) on
   that tick's lanes and on random in-range lanes of the full-width fat
   tree and of ``leaf_spine(4, 4, 4)``; each timed at B = 1 and B = 4
   (bound: each lane in and out once, the routing tables once). Then the
   sites: each tick kernel beside the
   dense composition that the tick ran before it (bit plane, old-bit
   test, dense kernel, and for the ACK site the clear of the ACKed bit;
   for the NACK site its lane arithmetic and the copying ``nack_mark``;
   for the RTO set, the retransmit clear and the RR_SLOTS mark the
   [F, W] plane, and the old-bit test for the last; a copy of each is
   kept here; for the four tick forms the eager bodies of
   ``NSCCPolicy.on_ack`` / ``end_of_tick`` and ``RoutingTables.
   injection_queue`` / ``route_step`` on scenario 0 of that tick's
   lanes), bitwise, both timed with CUDA events in turns, with their
   device operations per call.
4. goldens — the two reference goldens (``tests/golden/fabric_golden.npz``)
   reproduced bitwise on the card: A through ``simulate``, B (REPS, a
   dead uplink, seed 0x5EED+3) through ``simulate_batch``, as its
   definition says.
5. full width — ``fat_tree3(k=16, pods=16)`` (1024 endpoints, Q = 5120)
   with two overlapping cross-pod permutations (F = 2048 flows of 256
   packets), ``SimParams()``: ``ai_full`` for ``max_ticks=4096`` (every
   flow completes), then the profile table's ``hpc()`` (hybrid CC,
   all-ROD), ``ai_base(lb=EVBITMAP)`` (RCCC) and an open-loop RR_SLOTS
   profile with ROD on odd flows, each for ``max_ticks=1024``. Each run's
   per-flow stats, final state lanes and counters are bitwise equal to
   the JAX references (``tests/golden/torch_port_fullsize.npz`` and
   ``torch_port_profiles.npz``, written by
   ``scripts/torch_port_reference.py``), and each tick kernel is
   launched as often per tick as the run's sites say (``PER_TICK``: the
   two SACK kernels once; ``nack_mark_lanes``, ``set_own_bit`` and
   ``clear_own_bit`` 1, 1, 1 under ``ai_full`` and ``ai_base``, 0, 0, 1
   under all-ROD ``hpc()``, whose tick has no selective-retransmit path
   or RTO mark, and 1, 3, 1 under RR_SLOTS, whose loss inference marks
   twice; ``nscc_ack`` and ``nscc_epoch`` once under NSCC and the hybrid,
   never under RCCC or open loop; ``ecmp_inject`` and ``ecmp_route``
   once) and the entry-point forms never. Then the kernel entry points
   (``repro_torch.kernels.ops.nscc_update`` / ``ecmp_select`` /
   ``sack_fused`` / ``sack_advance`` / ``nack_mark``): one batched NSCC
   round over the hpc run's 2048 windows, the ECMP port choice of 7168
   packet lanes of the ai_full run, and the dense SACK forms and the
   copying NACK mark on the mixed run's final rings, checked against the
   plain versions and the tick's own routing.
   Then the batch: the same fabric and ``ai_full`` as B = 4 scenarios
   of one ``simulate_batch`` call (stats tier, ``max_ticks=4096``):
   seeds 0x5EED..0x5EED+3, lanes 0-1 healthy, lane 2's first edge-0
   uplink (``up1_table[0, 0]``) dead from tick 0, lane 3's flapping over
   [100, 400). Each lane's stats, final lanes and counters are bitwise
   equal to ``tests/golden/torch_port_batch.npz`` (the JAX
   ``simulate_batch``), lane 0 also to ``torch_port_fullsize.npz``;
   each tick kernel is launched once per tick for all four; the
   scenario-ticks per second beside the serial ``ai_full`` run's, and
   the peak memory.
   Then the faulted batch: the same fabric as B = 4 lanes of one
   ``simulate_batch`` call under ``TransportProfile.resilient()`` (RTO
   backoff, EV eviction, PDC teardown), ``SimParams(timeout_ticks=64,
   ooo_threshold=24)``, budget 2048, stats tier, seeds 0x5EED + b,
   fault-draw seed b: lane 0 gray links (1 % loss on edge switch 0's
   uplinks), lane 1 host 0 dead from tick 100 for good and host 1's NIC
   stalled over [100, 400), lane 2 PHY corruption (1 % BER on edge 1's
   uplinks, no link layer), lane 3 all of these and edge 0's first
   uplink dead from tick 0. Each lane's stats, final lanes (the
   recovery lanes included) and counters are bitwise equal to
   ``tests/golden/torch_port_faults.npz`` (the JAX ``simulate_batch``);
   lane 1 quarantines its four flows and stops before the budget, every
   other flow of every lane completes, some EV is evicted; each tick
   kernel is launched once per tick; scenario-ticks per second and peak
   memory beside the healthy batch's of the same call.
   Then the collectives: 32 concurrent tree all-reduces on the same
   fabric (group j = hosts {j + 32 i : i = 0..31}, root j, all 31
   children on other edge switches; 32 packets a rank; F = 1984 flows)
   as B = 2 lanes of one ``simulate_batch`` call under ``ai_full()`` with
   ``inc=True``, budget 4096: lane 0 with the groups' ``red`` ids, lane 1
   the same flows with ``red = -1`` (INC off as a data axis, the incast
   baseline). Each lane's horizon, stats lanes, ``inc_reduced`` /
   ``inc_emits``, counters and every final state lane but the packet and
   event buffers are bitwise equal to ``tests/golden/torch_port_inc.npz``
   (the JAX ``simulate_batch``); on lane 0 every non-root host receives
   what the schedule expects and the roots receive it less exactly the
   absorbed packets; each tick kernel is launched once per tick. Then
   the default ``collective_sweep()`` (15 scenarios, two profiles, a
   small leaf-spine, 1600 ticks) against the same golden.
   Then the link layer: the full-width ``ai_full`` traffic as B = 2
   lanes (1 % BER on edge 1's uplinks in lane 0, lane 1 healthy, seeds
   0x5EED and 0x5EED+1), ``SimParams(ticks=4096)``, once with
   ``link=LinkConfig.on(llr=True)`` and once with LLR + CBFC: each lane
   bitwise equal to ``tests/golden/torch_port_link.npz`` (horizon, stats
   lanes, ``llr_replays``, ``credit_stall_ticks``, trims, drops, every
   final state lane but the buffers), no drop on any lane, no trim under
   CBFC, each tick kernel once per tick. Both phases print
   scenario-ticks per second and peak memory beside the healthy
   batch's of the same call.
   Then telemetry: the faulted batch again with
   ``TelemetrySpec.on(probe_every=16, slots=16)`` (lane 3's ring
   decimates three times) and the link phase's LLR + CBFC arm with
   ``TelemetrySpec.on(probe_every=8, slots=16)`` (the ``llr`` and
   ``stall`` channels): each lane's final state bitwise the
   telemetry-off golden (``torch_port_faults.npz``,
   ``torch_port_link.npz``), its whole probe carry bitwise
   ``tests/golden/torch_port_telemetry.npz`` (the rings by the sha256 of
   their bytes); scenario-ticks per second and peak memory beside the
   same runs without telemetry in this call; each tick kernel once per
   tick. Then the flap canary (``telemetry.flap_victim_scenario()``)
   with telemetry on and off: the same final state, the outage visible
   in the probe lanes (``assert_outage_visible``), its Perfetto JSON
   written to ``--trace`` (default ``build/telemetry_flap.json``).
   Then the split scenario axis: lanes 0, 1 and 3 of the faulted batch
   with telemetry through ``shard.run_sharded`` over (cuda:0, cuda:0)
   (B = 3, one padding lane): every lane's horizon, stat lanes, state
   and probe carry bitwise the unsharded telemetry run's and the
   goldens, each tick kernel once per tick of each shard, the
   lane-ticks stepped beside the unsharded batch's; with more than one
   card also ``shard=True`` over all of them (else it says that the
   multi-card path is unverified).
6. cross-device — the first ``CROSS_TICKS`` = 64 ticks of the ai_full
   run with ``trace="full"`` on the card and on the CPU (plain versions),
   bitwise (half a chunk: the CPU run is the script's slowest step per
   tick).
7. traffic — model-driven traffic and its pricing
   (``repro_torch.network.traffic``, ``distributed.plan`` /
   ``netmodel``, ``ckpt.checkpointing``) through its entry points, each
   simulator run captured as it returns and held against
   ``tests/golden/torch_port_traffic.npz`` (the JAX package's, written
   by ``scripts/torch_port_reference.py --which traffic``): integer
   lanes bitwise, priced floats with ``==``. (a) the reference bench's
   co-design sweep ``run_model_sweep()``: 2 archs x 2 layouts x 2
   leaf-spines x 3 profiles at ``decode_32k``, dp = tp = 16, 24
   scenarios in one ``simulate_batch`` (6 (graph, profile) groups, F <=
   108 padded): each point's compiled workload, horizon,
   source-completion ticks, priced ``StepTiming`` and efficiencies, and
   the bench's separation gates (fsdp_tp slower than tp_only at every
   point, hpc > 1.05 x ai_full on ``oversub2`` under fsdp_tp, oversub2
   >= full). (b) the same grid on ``fat_tree3(k=16, pods=16)`` (12
   scenarios, 3 groups of B = 4, Q = 5120) and ``step_time`` of the
   deepseek-coder-33b ``train_4k`` plan at dp = tp = 16 on that graph
   under ``ai_full()`` (F = 136). (c) ``price_recovery`` of the
   ``train_4k`` plan at dp = tp = 4 (healthy, one dead DP host under
   ``resilient()``, replanned), every ``RecoveryCosts`` field, then the
   bench's economics gates on the measured costs (Young/Daly beats fixed
   intervals at every MTBF; availability monotone in MTBF). (d)
   netmodel's ``simulated_collective_time`` (all-reduce ring / tree,
   all-gather ring; 8 chips, 24 packets) and ``simulated_efficiency``.
   Each tick kernel launches as ``PER_TICK`` says once per tick of every
   (graph, profile) group. Scenarios per second of (a) and (b), each
   part's wall seconds and peak device memory, and the host ms per point
   of ``compile_step`` + ``price_step`` beside the simulator's. Step
   times are modelled fleet seconds, priced with the reference's
   modelled accelerator, not a measurement of the card.
8. control — the UET control plane (``repro_torch.core``: ``pdc``,
   ``pds``'s batch API, ``addressing``, ``matching``, ``tss``, NSCC's
   batch API and DFC) on the card: (a) ``tour(device="cuda")`` of
   ``examples/uet_transport_tour_torch.py``, every value ``==`` the JAX
   tour's in ``tests/golden/torch_port_control.npz`` (written by
   ``scripts/torch_port_reference.py --which control``); (b) the seeded
   batch of ``control_inputs(CONTROL_GOLDEN)`` (``record_rx`` at B =
   8192 over 2048 PDCs, the pool, addressing, matching, TSS, NSCC),
   every output lane bitwise the golden's; (c) one endpoint at real
   scale, ``control_inputs(CONTROL_REAL)``, on the card and on the
   port's plain CPU path, bitwise, part by part: eight rounds of
   ``or_mask`` + ``record_rx`` + ``advance_cack`` + ``sack_view`` over
   262144 lanes and N = 65536 PDCs at W = 32 (duplicates, stale and
   out-of-window PSNs); 65536 PDCs through every transition of both
   machines, PEER_DEAD included; ``FEPTables`` of 64 jobs x 1024
   PIDonFEP x 16 RIs and ``resolve`` of 262144 packets in both modes; a
   ``RecvQueue`` of 16384 posted entries, ``match`` of 4096 arrivals
   under each profile and ``consume``; a ``SecureDomain`` of 65536
   members, 16 rounds of 262144 IVs with a key rotation, a ``PSNGuard``
   of 65536 peers across 2**31; ``on_acks`` of 262144 ACKs over 65536
   CCCs (up to 8 a CCC), ``on_loss`` and ``apply_dfc_penalty``. Exactly
   one ``nack_mark`` launch per ``record_rx`` and per ``or_mask`` call,
   one ``sack_advance`` per ``advance_cack``, no other kernel; each
   part's card and CPU seconds and peak memory; then ``nack_mark`` and
   ``sack_advance`` timed at N = 65536, W = 32 (L = 262144 lanes).

9. serving — the LM substrate's serving path (``repro_torch.models.
   layers`` / ``lm``, ``serve.serve_step``), f32 with TF32 off, no kernel
   of its own: (a) the ten archs at ``configs.reduced`` widths (B = 2, S
   = 24; mixtral-8x22b's window is 16, so its ring cache wraps), params
   and tokens drawn with numpy by ``lm_inputs``: the full forward's
   logits and aux, every decode step's logits and the final cache within
   ``LM_ATOL`` of ``tests/golden/torch_port_lm.npz`` (written by
   ``scripts/torch_port_reference.py --which lm``); (b) mixtral-8x22b at
   full width (d_model 6144, 48 / 8 heads of 128, d_ff 16384, 8 experts
   top-2, SWA 4096, vocab 32768), depth cut from 56 layers to R = 2,
   params drawn on the card from a seeded generator: the MoE assignments
   a B = 2, S = 512 full forward drops over capacity, counted and
   printed, then a B = 2, S = 4 forward (8 tokens: no expert can pass its
   capacity of 8) with 0 drops required and the decode step held against
   it at every step; then one attention layer alone at that width, B =
   2, 5120 tokens decoded one by one through its ring of 4096 slots
   (``attention_ring``: the last 1024 wrap it) against its full-sequence
   form within ``LM_ATOL["dense"]``; (c) the same model in bf16: ``make_prefill`` at B =
   8, S = 1024, timed, then the prompt fed token by token into the cache
   and 128 greedy tokens, timed (tokens/s, ms/step, peak memory, the
   card's name and power limit); (d) ``serving_rate`` of mixtral-8x22b
   at ``decode_32k``, ``tp_only``, dp = tp = 4 on ``leaf_spine(4, 4,
   4)``, every field ``==`` the golden's, and each tick kernel launched
   once a tick of its simulator run; no kernel launches in (a)-(c).

10. training — the LM substrate's training path (``repro_torch.train``:
   AdamW in place, ``make_train_step`` with the chunked cross-entropy
   and remat, the ``Trainer``; ``data``, ``ckpt``, ``distributed.
   compression``, ``launch.roofline``), f32 with TF32 off where it
   compares: (a) the ten archs at ``configs.reduced`` widths (B = 2, S =
   16), params and batch drawn with numpy by ``train_inputs``, two
   ``make_train_step`` steps (AdamW lr 1e-3, warmup 1) against
   ``tests/golden/torch_port_train.npz`` (written by
   ``scripts/torch_port_reference.py --which train``): both steps'
   metrics, each leaf's gradient sum of squares and seeded samples of
   the step-1 gradients and of the params and moments after step 2
   (``train_vs``; jamba's step-2 grad norm and moments are reported,
   not held: ``TRAIN_CHAOTIC``); (b) mixtral-8x22b at full width, depth
   cut to R = 1: the f32 gradient of the train step's loss at B = 1, S =
   1024 against central differences along its own direction and along a
   Gaussian direction on expert 0's ``w_down``, on the base point's
   routing branch; then bf16 params with f32 moments, 6 steps of the
   ``Trainer`` over ``SyntheticTokens`` at B = 1, S = 4096, AdamW lr
   1e-3, warmup 20: finite losses and grad norms, every leaf moved (or
   its every step under half a bf16 spacing), step 0's batch's loss
   lower after, timed (ms/step, tokens/s, model FLOP/s as 6 N_active
   tokens and their share of the 989 TFLOP/s dense bf16 peak, drops a
   step, peak memory); (c) where ``msgpack`` and ``zstandard`` import,
   the trainer's checkpoint / restart drill at reduced size (the 7th call
   fails, ``ckpt_every=2``: it resumes at step 6 and ends at step 10, and
   the last checkpoint restored onto the CPU is bitwise the card's
   state); else the line ``checkpoint IO: msgpack/zstandard absent``;
   (d) ``uet_efficiencies`` over four kinds (8 hosts, 64 packets) ``==``
   the golden's, one launch of each tick kernel a tick; (e)
   ``compress_tree`` of a 2**24-element f32 tensor and its carried error,
   card against CPU, bitwise. No kernel launches in (a)-(c) or (e).

11. entry points — the last entry points of the port, each printing the
   lines of its JAX twin (``tests/golden/torch_port_entry.npz``, written
   by ``scripts/torch_port_reference.py --which entry``): (a) the twelve
   sections of ``examples/quickstart_torch.py`` (``SECTIONS``), its
   lines with the header byte for byte those of ``examples/quickstart.py``;
   (b) ``examples/fabric_telemetry_torch.py``, its lines byte for byte,
   and ``scripts/trace_export_torch.py`` at its defaults, its lines byte
   for byte and its Chrome-trace JSON by sha256 and event count, each in
   a temporary working directory; (c) the six CLI canaries
   (``repro_torch.network.faults`` ``_smoke`` / ``_endpoint_smoke``,
   ``network.telemetry``, ``core.link``, ``network.traffic``,
   ``network.shard`` over ``(cuda:0,) * 4`` on one card), every assert
   passing and every line the golden's once the golden's ``mask`` has
   replaced the traffic canary's wall seconds and the shard canary's
   device count. Each of the 20 tasks runs in a worker process of this
   script (as many at once as the host's cores less two: the tasks'
   fabrics are small and their ticks host-bound), which counts the
   ticks of every step it builds: each tick kernel is launched as often
   as those ticks' profiles say (``per_tick``), and no entry-point form.
   Each part's seconds and the phase's wall, beside the card's name and
   power limit.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "fabric_golden.npz"
FULLSIZE = ROOT / "tests" / "golden" / "torch_port_fullsize.npz"
PROFILES = ROOT / "tests" / "golden" / "torch_port_profiles.npz"
BATCH = ROOT / "tests" / "golden" / "torch_port_batch.npz"
FAULTS = ROOT / "tests" / "golden" / "torch_port_faults.npz"
INC = ROOT / "tests" / "golden" / "torch_port_inc.npz"
LINK = ROOT / "tests" / "golden" / "torch_port_link.npz"
TELEMETRY = ROOT / "tests" / "golden" / "torch_port_telemetry.npz"
TRAFFIC = ROOT / "tests" / "golden" / "torch_port_traffic.npz"
CONTROL = ROOT / "tests" / "golden" / "torch_port_control.npz"
#: the probe rings the telemetry golden holds as sha256 digests
TEL_RINGS = ("s_occ", "s_ecn", "s_trim", "s_drop", "s_llr", "s_stall",
             "s_rtt", "s_cwnd")
#: the faulted batch's lanes the shard phase splits over two shards
SHARD_LANES = (0, 1, 3)
#: the device the telemetry and shard phases run on
DEV = "cuda"
#: ticks of the cross-device phase (half of ``SimParams().chunk_ticks``)
CROSS_TICKS = 64
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate
F32_OPS_PER_S = 67e12       # H100 SXM non-tensor f32 rate
F_MAIN, W_MAIN, Q_MAIN = 2048, 16, 5120
POOL = 1 << 24              # a CCC-window / packet-lane pool at HBM rate
PROFILE_TICKS = 1024
KERNELS = {
    # name: (source in the repo, the TPU kernel it replaces, the symbol
    # of its CUDA kernel in a profiler trace)
    "sack_fused": ("src/repro_torch/kernels/csrc/sack.cu",
                   "src/repro/kernels/sack_fused.py:91",
                   "sack_kernel<true, false,"),
    "nack_mark": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                  "src/repro/kernels/nack_mark.py:70",
                  "nack_mark_kernel<false,"),
    "sack_advance": ("src/repro_torch/kernels/csrc/sack.cu",
                     "src/repro/kernels/sack_bitmap.py:82",
                     "sack_kernel<false, false,"),
    "sack_fused_own": ("src/repro_torch/kernels/csrc/sack.cu",
                       "src/repro/kernels/sack_fused.py:91",
                       "sack_kernel<true, true,"),
    "sack_advance_own": ("src/repro_torch/kernels/csrc/sack.cu",
                         "src/repro/kernels/sack_bitmap.py:82",
                         "sack_kernel<false, true,"),
    "nack_mark_lanes": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                        "src/repro/kernels/nack_mark.py:70",
                        "nack_mark_kernel<true,"),
    "set_own_bit": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                    "src/repro/kernels/nack_mark.py:70",
                    "own_bit_kernel<true,"),
    "clear_own_bit": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                      "src/repro/kernels/nack_mark.py:70",
                      "own_bit_kernel<false,"),
    "nscc_update": ("src/repro_torch/kernels/csrc/nscc_update.cu",
                    "src/repro/kernels/nscc_update.py:53",
                    "nscc_update_kernel"),
    "ecmp_select": ("src/repro_torch/kernels/csrc/ecmp_hash.cu",
                    "src/repro/kernels/ecmp_hash.py:52",
                    "ecmp_select_kernel"),
    "nscc_ack": ("src/repro_torch/kernels/csrc/nscc_update.cu",
                 "src/repro/kernels/nscc_update.py:53", "nscc_ack_kernel"),
    "nscc_epoch": ("src/repro_torch/kernels/csrc/nscc_update.cu",
                   "src/repro/kernels/nscc_update.py:53",
                   "nscc_epoch_kernel"),
    "ecmp_inject": ("src/repro_torch/kernels/csrc/ecmp_hash.cu",
                    "src/repro/kernels/ecmp_hash.py:52",
                    "ecmp_inject_kernel"),
    "ecmp_route": ("src/repro_torch/kernels/csrc/ecmp_hash.cu",
                   "src/repro/kernels/ecmp_hash.py:52",
                   "ecmp_route_kernel<true"),
}
TICK_KERNELS = ("sack_fused_own", "sack_advance_own", "nack_mark_lanes",
                "set_own_bit", "clear_own_bit", "nscc_ack", "nscc_epoch",
                "ecmp_inject", "ecmp_route")
#: the tick forms of the two entry-point kernels (``ops`` dispatch names)
TICK_FORMS = ("nscc_ack", "nscc_epoch", "ecmp_inject", "ecmp_route")
#: launches per tick of each tick kernel, by run: under all-ROD the NACK
#: site and the RTO's set are compiled out; RR_SLOTS's loss inference
#: adds two sets; the NSCC forms run under NSCC and the hybrid (ai_full,
#: hpc, resilient and the INC and link runs of ai_full), not under RCCC
#: (ai_base) or open loop (mixed); the routing walks once a tick always
PER_TICK = {"ai_full": (1, 1, 1, 1, 1, 1, 1, 1, 1),
            "hpc": (1, 1, 0, 0, 1, 1, 1, 1, 1),
            "base": (1, 1, 1, 1, 1, 0, 0, 1, 1),
            "ai_base": (1, 1, 1, 1, 1, 0, 0, 1, 1),
            "mixed": (1, 1, 1, 3, 1, 0, 0, 1, 1),
            "resilient": (1, 1, 1, 1, 1, 1, 1, 1, 1),
            "inc": (1, 1, 1, 1, 1, 1, 1, 1, 1),
            "llr": (1, 1, 1, 1, 1, 1, 1, 1, 1),
            "cbfc": (1, 1, 1, 1, 1, 1, 1, 1, 1)}
#: SimState lanes the profile goldens leave out: those of the recovery
#: loop (RTO strikes, quarantine, their counters), of INC and of the link
#: layer, none of which the three profile runs turn on
UNRECORDED_LANES = ("ev_evictions", "rto_strikes", "quarantined",
                    "flows_abandoned", "ticks_unreachable", "inc.slot_psn",
                    "inc.slot_bits", "inc_reduced", "inc_emits",
                    "llr_busy_until", "llr_replays", "cbfc_consumed",
                    "cbfc_freed", "cbfc_ret", "credit_stall_ticks")
ENTRY_KERNELS = ("sack_fused", "sack_advance", "nack_mark", "nscc_update",
                 "ecmp_select")
OWN_WIDTHS = (1, 3, 8, 16, 17, 32)
OWN_ROWS = (1, 33, F_MAIN)
MARK_WIDTHS = (1, 3, 16, 17, 32)
B_MAIN = 4                  # scenarios of the batch phase
STRIDE_BATCHES = (1, 3, 8)
STRIDE_WIDTHS = (1, 16, 17, 32)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _i32(a: np.ndarray, dev) -> torch.Tensor:
    """uint32 words as the port's int32 bit patterns, on `dev`."""
    return torch.as_tensor(np.asarray(a, np.uint64).astype(np.uint32)
                           .view(np.int32)).to(dev)


def _median_ms(fn, reps: int = 20, inner: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return float(np.median(times))


def _max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def _device_ms(fn, symbol: str, calls: int = 50) -> float:
    """Device time of one launch of the kernel named ``symbol``: its CUDA
    kernel time in a ``torch.profiler`` trace over its launch count. A
    trace now and then comes back without the kernel's records; it is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for ev in prof.key_averages():
            if symbol.replace(" ", "") in ev.key.replace(" ", ""):
                us += float(ev.device_time_total)
                n += int(ev.count)
        if n and us > 0:
            return us / n / 1e3
    raise RuntimeError(f"three profiler traces hold no device time for "
                       f"{symbol}")


def _assert_bits(x: np.ndarray, y: np.ndarray, what: str) -> None:
    """Same dtype, shape and bytes (floats compared bit for bit)."""
    assert x.dtype == y.dtype and x.shape == y.shape, (what, x.dtype, y.dtype)
    assert x.tobytes() == y.tobytes(), what


def _assert_equal(got, want, what: str) -> None:
    """Bitwise: float outputs compare as their int32 bit patterns, so a
    NaN must match a NaN of the same bits."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = (g != w).nonzero()[:4].tolist()
            raise AssertionError(f"{what}: output {i} differs at {bad}")


# ------------------------------------------------------------------ phases

def phase_device() -> "tuple[str, dict]":
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script measures the CUDA card and has no CPU "
                         "fallback")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    say("1 device", f"{dev['kind']} x{dev['count']}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi, dev


def phase_build() -> dict:
    from repro_torch.kernels import build
    secs, logs = build.build_all()
    regs = {k: " | ".join(ln.strip() for ln in v.splitlines()
                          if "registers" in ln) for k, v in logs.items()}
    say("2 build", f"built {sorted(logs) or 'nothing (cached)'} in "
        f"{secs:.1f} s; ptxas: {regs}")
    return {"seconds": secs, "ptxas": regs}


def _sack_inputs(rng, n, w, dev):
    ring = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
    # edge rows: leading full words of every length, empty, full, sparse
    for i in range(0, n, 7):
        k = (i // 7) % (w + 1)
        ring[i, :k] = 0xFFFFFFFF
        ring[i, k:] = rng.integers(0, 2 ** 32, w - k) >> rng.integers(0, 32)
    ring[1::97] = 0
    ring[2::97] = 0xFFFFFFFF
    base = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    base[::5] = 0xFFFFFFFF - rng.integers(0, 2048, base[::5].shape)
    rtx = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
    mask = np.zeros((n, w), np.uint64)
    rows = rng.integers(0, n, n // 2)
    mask[rows, rng.integers(0, w, rows.size)] = (
        np.uint64(1) << rng.integers(0, 32, rows.size).astype(np.uint64))
    return (_i32(ring, dev), _i32(base, dev), _i32(rtx, dev),
            _i32(mask, dev))


def _nack_inputs(rng, f, w, lanes, dev):
    rtx = rng.integers(0, 2 ** 32, (f, w), dtype=np.uint64)
    rtx[::3] = 0
    flow = rng.integers(-2, f + 2, lanes)
    off = rng.integers(-4, w * 32 + 8, lanes)
    valid = rng.integers(0, 4, lanes) == 0
    # duplicates: the same (flow, bit) several times, and a negative row
    flow[:64], off[:64], valid[:64] = 5, 37, True
    flow[64:96], valid[64:96] = -1, True
    return (_i32(rtx, dev), torch.as_tensor(flow.astype(np.int32)).to(dev),
            torch.as_tensor(off.astype(np.int32)).to(dev),
            torch.as_tensor(valid).to(dev))


def _nscc_params():
    """The tick's NSCC params, the defaults, and a set whose target
    (base_rtt * target_factor) is not exact in f32."""
    from repro_torch.core.cms.nscc import NSCCParams
    return [NSCCParams(base_rtt=10.0, max_cwnd=48.0), NSCCParams(),
            NSCCParams(base_rtt=7.3, target_factor=1.1)]


def _nscc_inputs(rng, n, p, dev):
    """Random windows plus edge lanes: rtt 0, negative, +-inf, NaN and on
    the target; cwnd below 1 and NaN; count 0, negative and large."""
    target = np.float32(p.base_rtt * p.target_factor)
    cwnd = rng.uniform(0.25, p.max_cwnd * 1.2, n).astype(np.float32)
    ecn = rng.integers(0, 2, n).astype(bool)
    rtt = rng.uniform(0.0, 6.0 * float(target), n).astype(np.float32)
    cnt = rng.integers(-2, 6, n).astype(np.int32)
    edge_rtt = np.asarray([0.0, -3.5, np.inf, -np.inf, np.nan, target, 1e-7,
                           -0.0, 1e30, np.nextafter(target, np.float32(0))],
                          np.float32)
    for j, v in enumerate(edge_rtt):
        rtt[j::997] = v
    cwnd[3::1009] = 0.5
    cwnd[5::2003] = np.nan
    cwnd[7::4001] = 0.0
    cnt[1::89], cnt[2::89], cnt[4::89] = 0, -9, 1 << 30
    return (torch.as_tensor(cwnd).to(dev), torch.as_tensor(ecn).to(dev),
            torch.as_tensor(rtt).to(dev), torch.as_tensor(cnt).to(dev))


def _ecmp_inputs(rng, n, dev):
    """Four int32 lanes over the full range (negative = top bit set)."""
    lanes = [rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
             .astype(np.int32) for _ in range(4)]
    lanes[0][:4] = [-1, -2 ** 31, 2 ** 31 - 1, 0]
    return [torch.as_tensor(x).to(dev) for x in lanes]


def _time_row(name, kern, plain, args, nbytes, nops, fast=False,
              ops_per_s=INT_OPS_PER_S) -> dict:
    """Times and bound of one kernel on ``args`` (already checked)."""
    inner = 5 if fast else 50
    ms = _median_ms(lambda: kern(*args), inner=inner)
    plain_ms = _median_ms(lambda: plain(*args), inner=inner)
    dev_ms = _device_ms(lambda: kern(*args), KERNELS[name][2],
                        calls=20 if fast else 50)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = nops / ops_per_s * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "bytes": nbytes}


def phase_kernels() -> dict:
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    F, W, L = F_MAIN, W_MAIN, Q_MAIN + 2 * F_MAIN
    ring, base, rtx, mask = _sack_inputs(rng, F, W, dev)
    nrtx, flow, off, valid = _nack_inputs(rng, F, W, L, dev)
    cases = {
        "sack_fused": (ops.sack_fused_cuda, ref.sack_fused_ref,
                       (ring, base, rtx, mask),
                       # bytes: ring, rtx, mask, base in; ring, rtx,
                       # base, adv out. ops: ~24 per word
                       (3 * F * W + F) * 4 + (2 * F * W + 2 * F) * 4,
                       24 * F * W),
        "nack_mark": (ops.nack_mark_cuda, ref.nack_mark_ref,
                      (nrtx, flow, off, valid),
                      2 * F * W * 4 + L * (4 + 4 + 1), 8 * L),
        "sack_advance": (ops.sack_advance_cuda, ref.sack_advance_ref,
                         (ring, base),
                         (F * W + F) * 4 + (F * W + 2 * F) * 4, 16 * F * W),
    }
    rows = {}
    for name, (kern, plain, args, nbytes, nops) in cases.items():
        got, want = kern(*args), plain(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        _assert_equal(got, want, name)
        rows[name] = _row(name, _max_abs_err(got, want),
                          _time_row(name, kern, plain, args, nbytes, nops))
        _say_row(name, rows[name], [tuple(a.shape) for a in args])
    # the own-bit SACK forms: bitwise at every width and row count, timed
    # at the main path's shape
    for n in OWN_ROWS:
        for w in OWN_WIDTHS:
            inputs = _own_inputs(rng, n, w, dev)
            for name, (kern, plain, args, _, _) in _own_cases(
                    *inputs).items():
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                _assert_equal(got, want, f"{name} n={n} w={w}")
    say("3 kernels", f"sack_fused_own, sack_advance_own: bitwise equal to "
        f"plain at N in {OWN_ROWS} x W in {OWN_WIDTHS}")
    for name, (kern, plain, args, nbytes, nops) in _own_cases(
            *_own_inputs(rng, F, W, dev)).items():
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        _assert_equal(got, want, name)
        rows[name] = _row(name, _max_abs_err(got, want),
                          _time_row(name, kern, plain, args, nbytes, nops))
        _say_row(name, rows[name], [tuple(a.shape) for a in args])
    # the in-place marks on the retransmit ring: bitwise at every width
    # and row count, each call on its own copy of the ring; timed at the
    # main path's shape
    for f in OWN_ROWS:
        for w in MARK_WIDTHS:
            for name, (kern, plain, args, _, _) in _mark_cases(
                    _mark_inputs(rng, f, w, dev)).items():
                got = kern(args[0].clone(), *args[1:])
                want = plain(args[0].clone(), *args[1:])
                torch.cuda.synchronize()
                _assert_equal((got,), (want,), f"{name} f={f} w={w}")
    say("3 kernels", f"nack_mark_lanes (with and without a ROD mask), "
        f"set_own_bit (with and without unless), clear_own_bit: bitwise "
        f"equal to plain at F in {OWN_ROWS} x W in {MARK_WIDTHS}")
    for name, (kern, plain, args, nbytes, nops) in _mark_cases(
            _mark_inputs(rng, F, W, dev)).items():
        if name not in KERNELS:    # a variant: checked above, not timed
            continue
        got = kern(args[0].clone(), *args[1:])
        want = plain(args[0].clone(), *args[1:])
        torch.cuda.synchronize()
        _assert_equal((got,), (want,), name)
        rows[name] = _row(name, _max_abs_err((got,), (want,)),
                          _time_row(name, kern, plain, args, nbytes, nops))
        _say_row(name, rows[name], [tuple(a.shape) for a in args])
    # the tick kernels at the batch phase's shapes: the NACK lanes with
    # the scenario stride, bitwise at every batch, row count and width
    # (with and without a ROD mask); then all five timed at B = 4
    for b in STRIDE_BATCHES:
        for f in OWN_ROWS:
            for w in STRIDE_WIDTHS:
                m = _stride_inputs(rng, b, f, w, dev)
                lanes = (m["rtx"], m["base"], m["flow"], m["psn"], m["nack"])
                for rod in (None, m["rod"]):
                    got = ops.nack_mark_lanes_cuda(lanes[0].clone(),
                                                   *lanes[1:], rod)
                    want = ref.nack_mark_lanes_ref_(lanes[0].clone(),
                                                    *lanes[1:], rod)
                    torch.cuda.synchronize()
                    _assert_equal((got,), (want,),
                                  f"nack_mark_lanes b={b} f={f} w={w}")
    say("3 kernels", f"nack_mark_lanes with the scenario stride ([B, L] "
        f"lane slices, flows -1, F, F + 3 and -2**31 in every scenario, "
        f"with and without a ROD mask): bitwise equal to plain at B in "
        f"{STRIDE_BATCHES} x F in {OWN_ROWS} x W in {STRIDE_WIDTHS}")
    for name, (kern, plain, args, nbytes, nops) in _batch_cases(
            rng, dev).items():
        got, want = kern(*_fresh(name, args)), plain(*_fresh(name, args))
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        _assert_equal(got, want, f"{name} b={B_MAIN}")
        rows[name]["batch"] = {
            "b": B_MAIN, "max_abs_err": _max_abs_err(got, want),
            **_time_row(name, kern, plain, args, nbytes, nops)}
        _say_row(f"{name} (B={B_MAIN})", rows[name]["batch"],
                 [tuple(a.shape) for a in args if a is not None])
    # the entry-point kernels: every params set / fanout, both sizes
    tick_params = _nscc_params()[0]
    for n in (F_MAIN, POOL):
        for p in _nscc_params():
            args = _nscc_inputs(rng, n, p, dev)
            got = ops.nscc_update_cuda(*args, p)
            want = ref.nscc_update_ref(*args, p)
            torch.cuda.synchronize()
            _assert_equal((got,), (want,), f"nscc_update n={n} {p}")
        args = _nscc_inputs(rng, n, tick_params, dev)
        timing = _time_row(
            "nscc_update", lambda *a: ops.nscc_update_cuda(*a, tick_params),
            lambda *a: ref.nscc_update_ref(*a, tick_params), args,
            n * (4 + 1 + 4 + 4) + n * 4, 20 * n, fast=n == POOL,
            ops_per_s=F32_OPS_PER_S)
        # the bitwise check above passed on every params set
        _record(rows, "nscc_update", n, 0.0, timing)
    for n in (Q_MAIN + F_MAIN, POOL):
        errs = []
        lanes = _ecmp_inputs(rng, n, dev)
        for fanout in (1, 2, 3, 7, 8, 13, 16, 32):
            got = ops.ecmp_select_cuda(*lanes, fanout)
            want = ref.ecmp_hash_ref(*lanes, fanout)
            torch.cuda.synchronize()
            _assert_equal((got,), (want,), f"ecmp_select n={n} f={fanout}")
            errs.append(_max_abs_err((got,), (want,)))
        # timed at the k=16 fat tree's fanout (8)
        timing = _time_row(
            "ecmp_select", lambda *a: ops.ecmp_select_cuda(*a, 8),
            lambda *a: ref.ecmp_hash_ref(*a, 8), lanes, n * 4 * 4 + n * 4,
            16 * n, fast=n == POOL)
        _record(rows, "ecmp_select", n, max(errs), timing)
    _tick_form_rows(rows, rng, dev)
    return rows


#: NSCC lanes (B·F) the tick forms are checked at
NSCC_LANES = (1, 33, F_MAIN, B_MAIN * F_MAIN)
#: ticks of the full-width ``ai_full`` batch whose last tick hands phase 3
#: the tick forms' real operands
TICK_CAPTURE = 48


@functools.lru_cache(maxsize=None)
def _tick_lanes() -> dict:
    """The four tick forms' operands as the tick hands them to ``ops`` on
    the last of ``TICK_CAPTURE`` ticks of the full-width ``ai_full``
    batch (B = 4) on the card: {form: its call's arguments}."""
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import simulate_batch
    _, g, wl, prof, p = _fullsize()
    seen, orig = {}, {k: getattr(ops, k) for k in TICK_FORMS}

    def recording(name):
        def call(*args):
            seen[name] = tuple(a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args)
            return orig[name](*args)
        return call
    try:
        for k in TICK_FORMS:
            setattr(ops, k, recording(k))
        simulate_batch(g, [wl] * B_MAIN, prof, p, trace="stats",
                       max_ticks=TICK_CAPTURE, device="cuda")
    finally:
        for k, f in orig.items():
            setattr(ops, k, f)
    torch.cuda.synchronize()
    assert sorted(seen) == sorted(TICK_FORMS), sorted(seen)
    return seen


def _nscc_tick_inputs(rng, n, p, dev):
    """The NSCC tick forms' [N] lanes (cwnd, epoch_acked, has_ack, ecn,
    rtt, epoch_lost, epoch_tick): random windows and RTTs plus edge lanes
    (rtt 0, exactly at the target, just below it, +-inf, NaN; cwnd below
    1, at min_cwnd and max_cwnd, NaN; has_ack off on half), epoch
    counters with lost 0 on half the lanes, and epoch starts whose age at
    ``now = 1000`` lies around ``epoch_len`` (epoch_len - 1, epoch_len
    and epoch_len + 1 first)."""
    target = np.float32(p.base_rtt * p.target_factor)
    epoch_len = int(p.base_rtt * p.target_factor)
    cwnd = rng.uniform(0.25, p.max_cwnd * 1.2, n).astype(np.float32)
    rtt = rng.uniform(0.0, 6.0 * float(target), n).astype(np.float32)
    edge = np.asarray([0.0, target, np.nextafter(target, np.float32(0)),
                       np.inf, -np.inf, np.nan, 1e-7, -0.0], np.float32)
    for j, v in enumerate(edge):
        rtt[j::97] = v
    cwnd[3::101], cwnd[5::211] = 0.5, np.nan
    cwnd[6::53], cwnd[7::59] = p.min_cwnd, p.max_cwnd
    acked = rng.integers(0, 40, n).astype(np.int32)
    lost = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 9, n))
    tick = 1000 - epoch_len + rng.integers(-3, 4, n)
    k = min(n, 3)
    tick[:k] = 1000 - np.asarray([epoch_len - 1, epoch_len,
                                  epoch_len + 1])[:k]
    t = lambda a: torch.as_tensor(a).to(dev)   # noqa: E731
    return (t(cwnd), t(acked), t(rng.integers(0, 2, n) > 0),
            t(rng.integers(0, 2, n) > 0), t(rtt), t(lost.astype(np.int32)),
            t(tick.astype(np.int32)))


def _host_lanes(rng, g, shape, dev):
    """Random in-range (src, dst) host lanes and full-range EV words."""
    return (torch.as_tensor(rng.integers(0, g.num_hosts, shape)
                            .astype(np.int32)).to(dev),
            torch.as_tensor(rng.integers(0, g.num_hosts, shape)
                            .astype(np.int32)).to(dev),
            _i32(rng.integers(0, 2 ** 32, shape, dtype=np.uint64), dev))


def _bits(ts) -> tuple:
    """Float outputs as their int32 bit patterns (for ``_max_abs_err``)."""
    return tuple(t.view(torch.int32) if t.dtype == torch.float32 else t
                 for t in ts)


def _table_bytes(rt, names) -> int:
    return sum(getattr(rt, n).numel() * 4 for n in names)


INJECT_TABLES = ("host_leaf", "host_queue", "up1")
ROUTE_TABLES = ("stage", "next_switch", "host_leaf", "host_queue",
                "host_pod", "down1", "up2", "down2")


def _tick_form_rows(rows: dict, rng, dev) -> None:
    """Phase 3's part for the tick forms of ``nscc_update`` and
    ``ecmp_select``: each bitwise against its plain version on the
    operands of a real tick (``_tick_lanes``) and on seeded lanes with
    edges, then timed at the serial run's shapes (B = 1: F = 2048 flows,
    Q = 5120 queues) and at the batch phase's (B = 4)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.network.ecmp import RoutingTables
    from repro_torch.network.topology import leaf_spine
    real = _tick_lanes()
    cwnd, acked, ack, ecn, rtt, tp = real["nscc_ack"]
    flat = [x.reshape(-1) for x in (cwnd, acked, ack, ecn, rtt)]
    _assert_equal(ops.nscc_ack_cuda(*flat, tp), ref.nscc_ack_ref(*flat, tp),
                  "nscc_ack on a tick's lanes")
    *lanes, now, _ = real["nscc_epoch"]
    flat = [x.reshape(-1) for x in lanes]
    _assert_equal(ops.nscc_epoch_cuda(*flat, now, tp),
                  ref.nscc_epoch_ref(*flat, now, tp),
                  "nscc_epoch on a tick's lanes")
    for n in NSCC_LANES:
        for p in _nscc_params():
            c, a, h, e, r, lo, tk = _nscc_tick_inputs(rng, n, p, dev)
            _assert_equal(ops.nscc_ack_cuda(c, a, h, e, r, p),
                          ref.nscc_ack_ref(c, a, h, e, r, p),
                          f"nscc_ack n={n} {p}")
            for now in (999, 1000, 1001):
                _assert_equal(ops.nscc_epoch_cuda(c, a, lo, tk, now, p),
                              ref.nscc_epoch_ref(c, a, lo, tk, now, p),
                              f"nscc_epoch n={n} now={now} {p}")
    say("3 kernels", f"nscc_ack, nscc_epoch: bitwise equal to plain on the "
        f"lanes of tick {TICK_CAPTURE - 1} of the full-width batch (B = "
        f"{B_MAIN}) and at B·F in {NSCC_LANES} x {len(_nscc_params())} "
        f"params sets, edge lanes and epoch ages around epoch_len")
    rt = real["ecmp_inject"][0]
    g = rt.g
    _, src, dst, ev = real["ecmp_inject"]
    _, queue, qsrc, qdst, qev = real["ecmp_route"]
    assert tuple(queue.shape) == (Q_MAIN,) and qsrc.shape == (B_MAIN, Q_MAIN)
    cases = [(rt, (src, dst, ev), (queue, qsrc, qdst, qev), "a tick's lanes")]
    for gr, tag in ((g, g.name), (leaf_spine(4, 4, 4), "leaf_spine(4, 4, 4)")):
        t = rt if gr is g else RoutingTables(gr, dev)
        qidx = torch.arange(gr.num_queues, dtype=torch.int32, device=dev)
        cases.append((t, _host_lanes(rng, gr, (B_MAIN, F_MAIN), dev),
                      (qidx, *_host_lanes(rng, gr, (B_MAIN, gr.num_queues),
                                          dev)), f"random lanes on {tag}"))
    for t, inj, rte, what in cases:
        flat = [x.reshape(-1) for x in inj]
        _assert_equal((ops.ecmp_inject_cuda(t, *flat),),
                      (ref.ecmp_inject_ref(t, *flat),), f"ecmp_inject {what}")
        _assert_equal((ops.ecmp_route_cuda(t, *rte),),
                      (ref.ecmp_route_ref(t, *rte),), f"ecmp_route {what}")
    say("3 kernels", f"ecmp_inject ([{B_MAIN}, {F_MAIN}] flow lanes), "
        f"ecmp_route ([{B_MAIN}, {Q_MAIN}] queue heads under the [Q] ids): "
        f"bitwise equal to plain on the lanes of tick {TICK_CAPTURE - 1} "
        f"and on random in-range lanes, on {g.name} and leaf_spine(4, 4, 4)")
    tp = _nscc_params()[0]
    for b in (1, B_MAIN):
        n = b * F_MAIN
        c, a, h, e, r, lo, tk = _nscc_tick_inputs(rng, n, tp, dev)
        forms = {
            # bytes: cwnd, rtt, acked (4 B) and has_ack, ecn (1 B) in;
            # cwnd, acked out. ops: ~20 f32 a lane
            "nscc_ack": (lambda *x: ops.nscc_ack_cuda(*x, tp),
                         lambda *x: ref.nscc_ack_ref(*x, tp),
                         (c, a, h, e, r), 22 * n, 20 * n, F32_OPS_PER_S),
            # four 4-byte lanes in and out; ~10 operations a lane
            "nscc_epoch": (lambda *x: ops.nscc_epoch_cuda(*x, 1000, tp),
                           lambda *x: ref.nscc_epoch_ref(*x, 1000, tp),
                           (c, a, lo, tk), 32 * n, 10 * n, F32_OPS_PER_S),
            # src, dst, ev in, the queue out, the tables read once;
            # ~20 integer operations a lane
            "ecmp_inject": (lambda *x: ops.ecmp_inject_cuda(rt, *x),
                            lambda *x: ref.ecmp_inject_ref(rt, *x),
                            tuple(x[:b].reshape(-1) for x in (src, dst, ev)),
                            16 * n + _table_bytes(rt, INJECT_TABLES), 20 * n,
                            INT_OPS_PER_S),
            # the queue ids once, src, dst, ev in, the queue out, the
            # tables read once
            "ecmp_route": (lambda *x: ops.ecmp_route_cuda(rt, *x),
                           lambda *x: ref.ecmp_route_ref(rt, *x),
                           (queue, qsrc[:b], qdst[:b], qev[:b]),
                           4 * Q_MAIN + 16 * b * Q_MAIN
                           + _table_bytes(rt, ROUTE_TABLES),
                           20 * b * Q_MAIN, INT_OPS_PER_S),
        }
        for name, (kern, plain, args, nbytes, nops, rate) in forms.items():
            got, want = kern(*args), plain(*args)
            got, want = ((got,), (want,)) if isinstance(
                got, torch.Tensor) else (got, want)
            torch.cuda.synchronize()
            _assert_equal(got, want, f"{name} b={b}")
            timing = _time_row(name, kern, plain, args, nbytes, nops,
                               ops_per_s=rate)
            err = _max_abs_err(_bits(got), _bits(want))
            if b == 1:
                rows[name] = _row(name, err, timing)
                _say_row(name, rows[name], [tuple(x.shape) for x in args])
            else:
                rows[name]["batch"] = {"b": b, "max_abs_err": err, **timing}
                _say_row(f"{name} (B={b})", rows[name]["batch"],
                         [tuple(x.shape) for x in args])


def _own_inputs(rng, n, w, dev):
    """Rings as ``_sack_inputs`` makes them and one PSN offset per row:
    mostly in [0, 32 W), with the edges -1, 31, 32 and 32 W first; ok on
    3 rows in 4, clear on the ok rows and 1 in 8 of the others."""
    ring, base, rtx, _ = _sack_inputs(rng, n, w, dev)
    off = rng.integers(-4, 32 * w + 4, n).astype(np.int32)
    k = min(n, 4)
    off[:k] = [-1, 31, 32, 32 * w][:k]
    ok = rng.integers(0, 4, n) > 0
    clear = ok | (rng.integers(0, 8, n) == 0)
    return (ring, base, rtx, torch.as_tensor(off).to(dev),
            torch.as_tensor(ok).to(dev), torch.as_tensor(clear).to(dev))


def _own_cases(ring, base, rtx, off, ok, clear) -> dict:
    from repro_torch.kernels import ops, ref
    f, w = ring.shape
    return {
        # bytes: ring, rtx, base, off in (4 B), ok, clear in (1 B); ring,
        # rtx, base, adv out (4 B), already out (1 B). ops: ~24 per word
        "sack_fused_own": (ops.sack_fused_own_cuda, ref.sack_fused_own_ref,
                           (ring, base, rtx, off, ok, clear),
                           16 * f * w + 19 * f, 24 * f * w),
        "sack_advance_own": (ops.sack_advance_own_cuda,
                             ref.sack_advance_own_ref, (ring, base, off, ok),
                             8 * f * w + 18 * f, 16 * f * w),
    }


def _mark_inputs(rng, f, w, dev) -> dict:
    """The in-place marks' operands at F rows of W words: the retransmit
    ring, a source ring (``unless``), the source CACK, L = Q + 2F NACK
    lanes (rows over [0, F), offsets over [-8, 32 W + 8), one lane in
    three not a NACK; then edge lanes: offsets -1, 32 W and the int32
    extremes, PSNs past the 2**32 and 2**31 wraps, duplicates, rows out
    of range, non-NACK lanes), a ROD mask, and one offset and valid lane
    per row with the edge offsets first."""
    lanes = Q_MAIN + 2 * f
    rtx = rng.integers(0, 2 ** 32, (f, w), dtype=np.uint64)
    rtx[::3] = 0
    ring = rng.integers(0, 2 ** 32, (f, w), dtype=np.uint64)
    ring[1::3] = 0
    base = rng.integers(0, 2 ** 32, f, dtype=np.uint64)
    base[::4] = 0xFFFFFFFF - rng.integers(0, 16, base[::4].shape)
    base[0], base[-1] = 0xFFFFFFF0, 0x7FFFFFF0
    flow = rng.integers(0, f, lanes)
    off = rng.integers(-8, 32 * w + 8, lanes)
    nack = rng.integers(0, 3, lanes) > 0
    edge_off = [-1, 0, 31, 32, 32 * w - 1, 32 * w, -(2 ** 31), 2 ** 31 - 1]
    edges = ([(0, o, True) for o in edge_off + [16, 17]]
             + [(f - 1, 17, True)] * 8
             + [(r, 3, True) for r in (-1, f, f + 3, -(2 ** 31))]
             + [(0, 2, False)] * 4)
    for i, (r, o, v) in enumerate(edges):
        flow[i], off[i], nack[i] = r, o, v
    psn = (base[np.clip(flow, 0, f - 1)].astype(np.int64) + off) % 2 ** 32
    rod = rng.integers(0, 2, f).astype(bool)
    rod[0] = False
    roff = rng.integers(-8, 32 * w + 8, f)
    k = min(f, len(edge_off))
    roff[:k] = edge_off[:k]
    t = lambda a: torch.as_tensor(a).to(dev)   # noqa: E731
    return {"rtx": _i32(rtx, dev), "ring": _i32(ring, dev),
            "base": _i32(base, dev), "flow": t(flow.astype(np.int32)),
            "psn": _i32(psn, dev), "nack": t(nack), "rod": t(rod),
            "off": t(roff.astype(np.int32)),
            "valid": t(rng.integers(0, 4, f) > 0)}


def _stride_inputs(rng, b, f, w, dev) -> dict:
    """B scenarios of ``_mark_inputs``: [B, F, W] rings, [B, F] bases
    and [B, L] NACK lanes handed over as the tick hands them, the
    [:, Q:] slice of [B, Q + L] rows; one [F] ROD mask for all."""
    per = [_mark_inputs(rng, f, w, dev) for _ in range(b)]
    out = {k: torch.stack([m[k] for m in per])
           for k in ("rtx", "ring", "base", "off", "valid")}
    for k in ("flow", "psn", "nack"):
        wide = torch.zeros((b, Q_MAIN + per[0][k].numel()),
                           dtype=per[0][k].dtype, device=dev)
        wide[:, Q_MAIN:] = torch.stack([m[k] for m in per])
        out[k] = wide[:, Q_MAIN:]
    out["rod"] = per[0]["rod"]
    return out


def _batch_cases(rng, dev) -> dict:
    """name -> (kernel, plain, args, bytes, ops) of the five tick
    kernels at the batch phase's shapes: B = 4 scenarios of F = 2048
    rows of W = 16 words, the row forms over the [B·F, W] view the tick
    hands them, the NACK lanes as [B, L] slices with the stride."""
    from repro_torch.kernels import ops, ref
    n = B_MAIN * F_MAIN
    cases = dict(_own_cases(*_own_inputs(rng, n, W_MAIN, dev)))
    rows = _mark_cases(_mark_inputs(rng, n, W_MAIN, dev))
    cases["set_own_bit"] = rows["set_own_bit"]
    cases["clear_own_bit"] = rows["clear_own_bit"]
    m = _stride_inputs(rng, B_MAIN, F_MAIN, W_MAIN, dev)
    lanes = (m["rtx"], m["base"], m["flow"], m["psn"], m["nack"])
    cases["nack_mark_lanes"] = (ops.nack_mark_lanes_cuda,
                                ref.nack_mark_lanes_ref_, lanes,
                                _lane_bytes(*lanes), 10 * m["flow"].numel())
    return cases


def _fresh(name, args):
    """An in-place form's arguments with a copy of the ring it writes."""
    if name in ("nack_mark_lanes", "set_own_bit", "clear_own_bit"):
        return (args[0].clone(), *args[1:])
    return args


def _lane_bytes(rtx, base, flow, psn, nack, rod=None) -> int:
    """The bytes the NACK lanes need on this data: each lane's flow, PSN
    and flag; base (and rod) of each row a NACK lane reaches (scenario
    b's flow f is row b*F + f of a [B, F, W] ring); a read and a write
    of each word it marks."""
    from repro_torch.core.types import scenario_rows
    f, w = rtx.shape[-2:]
    reach = nack & (flow >= 0) & (flow < f)
    row = torch.where(reach, scenario_rows(flow, f) + flow, 0).long()
    off = psn - base.reshape(-1)[row]
    ok = reach & (off >= 0) & (off < 32 * w)
    if rod is not None:
        ok = ok & ~rod[torch.where(reach, flow, 0).long()]
    rows = int(torch.unique(row[reach]).numel())
    words = int(torch.unique(row[ok] * w + (off[ok] // 32)).numel())
    return (flow.numel() * 9 + rows * (4 + (rod is not None))
            + words * 8)


def _row_bytes(rtx, off, valid, unless=None) -> int:
    """The bytes one bit per row needs on this data: each row's offset
    and flag; for each row in range, its ``unless`` word and a read and
    a write of its word where the bit is not blocked."""
    n, w = rtx.shape
    ok = valid & (off >= 0) & (off < 32 * w)
    k = int(ok.sum())
    if unless is None:
        return n * 5 + k * 8
    o = off.clamp(0, 32 * w - 1).long()
    word = unless.gather(1, (o // 32)[:, None])[:, 0]
    blocked = ok & (((word >> (o % 32)) & 1) != 0)
    return n * 5 + k * 4 + (k - int(blocked.sum())) * 8


def _mark_cases(m) -> dict:
    """name -> (kernel, plain, args, bytes, ops) of the in-place marks;
    ``args[0]`` is the ring each call writes. The names with a space are
    variants, checked but not timed."""
    from repro_torch.kernels import ops, ref
    lanes = (m["rtx"], m["base"], m["flow"], m["psn"], m["nack"])
    rows = (m["rtx"], m["off"], m["valid"])
    n_lanes, n_rows = m["flow"].numel(), m["off"].numel()
    return {
        "nack_mark_lanes": (ops.nack_mark_lanes_cuda,
                            ref.nack_mark_lanes_ref_, lanes,
                            _lane_bytes(*lanes), 10 * n_lanes),
        "nack_mark_lanes rod": (ops.nack_mark_lanes_cuda,
                                ref.nack_mark_lanes_ref_,
                                lanes + (m["rod"],),
                                _lane_bytes(*lanes, m["rod"]), 10 * n_lanes),
        "set_own_bit": (ops.set_own_bit_cuda, ref.set_own_bit_ref_, rows,
                        _row_bytes(*rows), 8 * n_rows),
        "set_own_bit unless": (ops.set_own_bit_cuda, ref.set_own_bit_ref_,
                               rows + (m["ring"],),
                               _row_bytes(*rows, m["ring"]), 10 * n_rows),
        "clear_own_bit": (ops.clear_own_bit_cuda, ref.clear_own_bit_ref_,
                          rows, _row_bytes(*rows), 8 * n_rows),
    }


def _site_fused_dense(ring, base, rtx, off, ok, clear):
    """The tick's ACK site as it ran before the own-bit kernel, kept as
    the yardstick: the old bit's test, the [F, W] bit plane, the dense
    ``sack_fused`` and the clear of the ACKed bit against the new base.
    ``ok`` is the tick's ``ack_in_range`` (range already tested)."""
    from repro_torch._u32 import bit
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import (_bit_plane, _clear_own_bit,
                                            _own_word)
    w = ring.shape[1]
    already = ok & ((_own_word(ring, off) & bit(off % 32)) != 0)
    ring, base, rtx, adv = ops.sack_fused(ring, base, rtx,
                                          _bit_plane(off, ok, w))
    return ring, base, _clear_own_bit(rtx, off - adv, clear), adv, already


def _site_advance_dense(ring, base, off, ok):
    """The tick's delivery site as it ran before the own-bit kernel: the
    old bit's test, the bit plane's OR and the dense ``sack_advance``."""
    from repro_torch._u32 import bit
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import _bit_plane, _own_word
    already = ok & ((_own_word(ring, off) & bit(off % 32)) != 0)
    ring, base, adv = ops.sack_advance(
        ring | _bit_plane(off, ok, ring.shape[1]), base)
    return ring, base, adv, already


def _site_nack_dense(rtx, base, flow, psn, nack, rod=None):
    """The tick's NACK site as it ran before the lane kernel: the lane
    arithmetic (offset from the source CACK, range and ROD tests, clip)
    and the copying ``nack_mark``."""
    from repro_torch.kernels import ops
    mp = 32 * rtx.shape[1]
    safe = torch.where(nack, flow, 0).long()
    off = psn - base[safe]
    ok = nack & (off >= 0) & (off < mp)
    if rod is not None:
        ok = ok & ~rod[safe]
    return ops.nack_mark(rtx, flow, off.clamp(0, mp - 1), ok)


def _site_rr_dense(rtx, off, valid, ring):
    """The tick's RR_SLOTS mark as it ran before the row kernel: the
    ``_own_word`` test of the source ring and ``_set_own_bit``."""
    from repro_torch._u32 import bit
    from repro_torch.network.fabric import _own_word, _set_own_bit
    w_i = off.clamp(0, 32 * rtx.shape[1] - 1)
    sacked = (_own_word(ring, off) & bit(w_i % 32)) != 0
    return _set_own_bit(rtx, off, valid & ~sacked)


def _site_on_ack_eager(cwnd, acked, lost, etick, has_ack, ecn, rtt,
                       params):
    """The tick's NSCC ACK hook as it ran before ``nscc_ack``
    (``nscc.on_ack_per_flow``'s eager body), kept as the yardstick."""
    from repro_torch.core.cms.nscc import window_delta
    delta = window_delta(cwnd, ecn, rtt.to(torch.float32), params,
                         folded_reciprocal=True)
    out = torch.where(has_ack, cwnd + delta, cwnd)
    return (out.clamp(params.min_cwnd, params.max_cwnd),
            acked + has_ack.to(torch.int32), lost, etick)


def _site_epoch_eager(cwnd, acked, lost, etick, now, params):
    """The tick's Quick Adapt as it ran before ``nscc_epoch``
    (``nscc.quick_adapt``'s eager body)."""
    epoch_len = int(params.base_rtt * params.target_factor)
    due = (now - etick) >= epoch_len
    delivered = acked.to(torch.float32)
    frac = delivered / torch.clamp(delivered + lost.to(torch.float32),
                                   min=1.0)
    lossy = due & (lost > 0)
    new_cwnd = torch.where(
        lossy, (cwnd * frac).clamp(params.qa_min_frac * params.max_cwnd,
                                   params.max_cwnd), cwnd)
    return (torch.clamp(new_cwnd, min=params.min_cwnd),
            torch.where(due, 0, acked), torch.where(due, 0, lost),
            torch.where(due, now, etick))


def _site_inject_eager(rt, src, dst, ev):
    """``RoutingTables.injection_queue`` as it ran before
    ``ecmp_inject``."""
    from repro_torch._u32 import umod
    from repro_torch.network.ecmp import ecmp_hash
    sleaf = rt.host_leaf[src]
    dleaf = rt.host_leaf[dst]
    h = umod(ecmp_hash(src, dst, ev, sleaf), rt.g.fanout1)
    return torch.where(sleaf == dleaf, rt.host_queue[dst], rt.up1[sleaf, h])


def _site_route_eager(rt, queue, src, dst, ev):
    """``RoutingTables.route_step`` on a three-level graph as it ran
    before ``ecmp_route``."""
    from repro_torch._u32 import umod
    from repro_torch.network.ecmp import DELIVERED, ecmp_hash
    from repro_torch.network.topology import Stage
    st, sw = rt.stage[queue], rt.next_switch[queue]
    dleaf, dpod = rt.host_leaf[dst], rt.host_pod[dst]
    L, A = rt.up1.shape[0], rt.down1.shape[0]
    agg = (sw - L).clamp(0, A - 1)
    go_down = rt.down1[agg, dleaf % rt.leaves_per_pod]
    go_up = rt.up2[agg, umod(ecmp_hash(src, dst, ev, sw), rt.up2.shape[1])]
    nxt_up1 = torch.where(torch.div(agg, rt.aggs_per_pod,
                                    rounding_mode="floor") == dpod,
                          go_down, go_up)
    core = (sw - L - A).clamp(0, rt.down2.shape[0] - 1)
    nxt_up2 = rt.down2[core, dpod]
    return torch.where(
        st == Stage.UP1, nxt_up1,
        torch.where(st == Stage.UP2, nxt_up2,
                    torch.where(st == Stage.DOWN2, go_down,
                                torch.where(st == Stage.DOWN1,
                                            rt.host_queue[dst], DELIVERED))))


def _tick_form_sites() -> dict:
    """name -> (eager, own, args) of the four tick forms' sites on scenario
    0 of a real tick's operands (``_tick_lanes``): the NSCC hooks through
    ``NSCCPolicy`` against their eager bodies, the routing walks through
    ``RoutingTables`` against theirs."""
    from repro_torch.core.cms.nscc import NSCCPolicy, NSCCState
    real = _tick_lanes()
    _, _, ack, ecn, rtt, tp = (a[:1] if isinstance(a, torch.Tensor)
                               else a for a in real["nscc_ack"])
    cwnd, acked, lost, etick, now, _ = (
        a[:1] if isinstance(a, torch.Tensor) else a
        for a in real["nscc_epoch"])
    pol = NSCCPolicy(tp)
    rt, src, dst, ev = (a[:1] if isinstance(a, torch.Tensor) else a
                        for a in real["ecmp_inject"])
    _, queue, qsrc, qdst, qev = real["ecmp_route"]

    def fields(st):
        return st.cwnd, st.epoch_acked, st.epoch_lost, st.epoch_tick

    return {
        "nscc_ack": (
            lambda c, a, lo, t, h, e, r: _site_on_ack_eager(
                c, a, lo, t, h, e, r, tp),
            lambda c, a, lo, t, h, e, r: fields(pol.on_ack(
                NSCCState(c, a, lo, t), h, e, r)),
            (cwnd, acked, lost, etick, ack, ecn, rtt)),
        "nscc_epoch": (
            lambda c, a, lo, t: _site_epoch_eager(c, a, lo, t, now, tp),
            lambda c, a, lo, t: fields(pol.end_of_tick(
                NSCCState(c, a, lo, t), now)),
            (cwnd, acked, lost, etick)),
        "ecmp_inject": (
            lambda *x: _site_inject_eager(rt, *x),
            lambda *x: rt.injection_queue(*x), (src, dst, ev)),
        "ecmp_route": (
            lambda *x: _site_route_eager(rt, queue, *x),
            lambda *x: rt.route_step(queue, *x),
            (qsrc[:1], qdst[:1], qev[:1])),
    }


def _device_ops(fn, calls: int = 10) -> float:
    """Device operations (kernels, memsets, copies) per call of ``fn``:
    the most that any of three traces holds."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):   # a trace now and then comes back with records lost
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    if not max(counts):
        raise RuntimeError("three profiler traces hold no device operation")
    return max(counts) / calls


def phase_sites() -> dict:
    """Each tick kernel beside the composition it replaced on the tick,
    on the same inputs at the main path's shape: bitwise equal, and both
    timed with CUDA events in turns (dense, own, own, dense). The
    in-place forms write into ``args[0]``: each is checked on its own
    copy, and timed on one of its own."""
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import _clear_own_bit, _set_own_bit
    dev = torch.device("cuda")
    rng = np.random.default_rng(1313)
    ring, base, rtx, off, ok, clear = _own_inputs(rng, F_MAIN, W_MAIN, dev)
    ok = ok & (off >= 0) & (off < 32 * W_MAIN)   # the tick's range test
    m = _mark_inputs(rng, F_MAIN, W_MAIN, dev)
    # the tick's NACK lanes reach rows in range only
    m["flow"] = m["flow"].clamp(0, F_MAIN - 1)
    lanes = (m["rtx"], m["base"], m["flow"], m["psn"], m["nack"])
    zeros = torch.zeros_like(m["off"])
    sites = {
        "sack_fused_own": (_site_fused_dense, ops.sack_fused_own,
                           (ring, base, rtx, off, ok, clear)),
        "sack_advance_own": (_site_advance_dense, ops.sack_advance_own,
                             (ring, base, off, ok)),
        "nack_mark_lanes": (_site_nack_dense, ops.nack_mark_lanes_, lanes),
        "set_own_bit rto": (_set_own_bit, ops.set_own_bit_,
                            (m["rtx"], zeros, m["valid"])),
        "clear_own_bit": (_clear_own_bit, ops.clear_own_bit_,
                          (m["rtx"], m["off"], m["valid"])),
        "set_own_bit rr_slots": (
            _site_rr_dense,
            lambda r, o, v, u: ops.set_own_bit_(r, o, v, unless=u),
            (m["rtx"], m["off"], m["valid"], m["ring"])),
    }
    shapes = {name: f"F={F_MAIN}, W={W_MAIN}" for name in sites}
    for name, site in _tick_form_sites().items():
        sites[name] = site
        shapes[name] = ", ".join(f"{tuple(a.shape)}" for a in site[2][:1])
    out = {}
    for name, (dense, own, args) in sites.items():
        got = own(args[0].clone(), *args[1:])
        want = dense(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        _assert_equal(got, want, f"site {name}")
        own_args = (args[0].clone(), *args[1:])
        t = [_median_ms(lambda f=f, a=a: f(*a))
             for f, a in ((dense, args), (own, own_args), (own, own_args),
                          (dense, args))]
        out[name] = {"dense_ms": (t[0] + t[3]) / 2, "own_ms": (t[1] + t[2]) / 2,
                     "dense_ms_runs": [t[0], t[3]],
                     "own_ms_runs": [t[1], t[2]],
                     "dense_device_ops": _device_ops(lambda: dense(*args)),
                     "own_device_ops": _device_ops(lambda: own(*own_args))}
        r = out[name]
        say("3 sites", f"{name}: bitwise equal to the dense composition it "
            f"replaced at {shapes[name]}; dense {r['dense_ms'] * 1e3:.2f} us "
            f"({r['dense_device_ops']:.0f} device ops), own "
            f"{r['own_ms'] * 1e3:.2f} us ({r['own_device_ops']:.0f} device ops)")
    return out


def _row(name, err, timing) -> dict:
    return {"name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": None,
            "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "device_ms": timing["device_ms"], "bytes": timing["bytes"]}


def _record(rows, name, n, err, timing) -> None:
    """The main-size measurement is the kernel's row; the pool's goes
    beside it under ``pool``."""
    if n == POOL:
        rows[name]["pool"] = {"n": n, "max_abs_err": err, **timing}
        _say_row(name, rows[name]["pool"], [(n,)])
    else:
        rows[name] = _row(name, err, timing)
        _say_row(name, rows[name], [(n,)])


def _say_row(name, r, shapes) -> None:
    say("3 kernels", f"{name}: bitwise equal to plain at {shapes}; kernel "
        f"{r['ms'] * 1e3:.2f} us (device {r['device_ms'] * 1e3:.3f} us), plain {r['plain_ms'] * 1e3:.2f} us, bound "
        f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}, {r['bytes']} B)")


def _golden_configs():
    from repro_torch.core.lb.schemes import LBScheme
    from repro_torch.network.fabric import SimParams, Workload
    from repro_torch.network.profile import TransportProfile
    from repro_torch.network.topology import leaf_spine
    gold = np.load(GOLDEN)
    a = (leaf_spine(leaves=2, spines=4, hosts_per_leaf=4),
         Workload.of([0, 1, 2], [4, 5, 6], 200), TransportProfile.ai_full(),
         SimParams(ticks=300), {})
    b = (leaf_spine(leaves=2, spines=4, hosts_per_leaf=8),
         Workload.of(list(range(8)), [8 + i for i in range(8)], 700),
         TransportProfile.ai_full(lb=LBScheme.REPS),
         SimParams(ticks=400, timeout_ticks=64, ooo_threshold=24),
         {"failed": [int(gold["b_failed_queue"][0])], "seed": 0x5EED + 3})
    return gold, {"a": a, "b": b}


def phase_goldens() -> dict:
    from repro_torch.network.fabric import simulate, simulate_batch
    gold, cfgs = _golden_configs()
    out = {}
    for tag, (g, wl, prof, p, kw) in cfgs.items():
        if tag == "a":
            r = simulate(g, wl, prof, p, trace="full", device="cuda")
        else:   # golden B is the batched run, as its definition says
            mask = np.zeros((1, g.num_queues), bool)
            mask[0, kw["failed"]] = True
            r = simulate_batch(g, [wl], prof, p, failed=mask,
                               seeds=np.asarray([kw["seed"]], np.uint32),
                               trace="full", device="cuda")[0]
        h = r.horizon
        for lane, key in (("delivered_per_tick", "delivered"),
                          ("cwnd_per_tick", "cwnd"), ("qlen_max", "qlen")):
            _assert_bits(getattr(r, lane), gold[f"{tag}_{key}"][:h],
                         f"golden {tag} {lane}")
        # the run stopped early only where the golden tail is inert
        assert not gold[f"{tag}_delivered"][h:].any(), tag
        _assert_bits(r.state.delivered.cpu().numpy(),
                     gold[f"{tag}_state_delivered"], f"golden {tag} delivered")
        _assert_bits(r.state.src_track.base.cpu().numpy().view(np.uint32),
                     gold[f"{tag}_state_src_base"], f"golden {tag} src_base")
        out[tag] = h
        say("4 goldens", f"golden {tag.upper()} bitwise on the card "
            f"(horizon {h}{', through simulate_batch' if tag == 'b' else ''})")
    return out


def _fullsize():
    from repro_torch.network.fabric import SimParams, Workload
    from repro_torch.network.profile import TransportProfile
    from repro_torch.network.topology import fat_tree3
    ref = np.load(FULLSIZE)
    h = np.arange(1024, dtype=np.int32)
    src = np.concatenate([h, h])
    dst = np.concatenate([(h + 512) % 1024, (h + 256) % 1024])
    assert np.array_equal(src, ref["src"]) and np.array_equal(dst, ref["dst"])
    g = fat_tree3(k=16, pods=16)
    assert g.num_queues == Q_MAIN and g.num_hosts == 1024
    return (ref, g, Workload.of(src, dst, 256), TransportProfile.ai_full(),
            SimParams())


def phase_fullwidth() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import simulate
    ref, g, wl, prof, p = _fullsize()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    r = simulate(g, wl, prof, p, trace="stats", max_ticks=4096,
                 device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    assert (r.stat_completion >= 0).all(), "every flow must complete"
    _assert_launches("ai_full", launches, r.horizon)
    s = r.state
    checks = {
        "stat_completion": r.stat_completion,
        "stat_src_completion": r.stat_src_completion,
        "delivered": s.delivered.cpu().numpy(),
        "next_psn": s.next_psn.cpu().numpy(),
        "src_base": s.src_track.base.cpu().numpy().view(np.uint32),
        "dst_base": s.dst_track.base.cpu().numpy().view(np.uint32),
        "cwnd": s.cc.cwnd.cpu().numpy(),
    }
    for k, v in checks.items():
        _assert_bits(v, ref[k], k)
    scalars = {"horizon": r.horizon, "trims": r.trims, "drops": r.drops,
               "dups": r.dups, "retransmits": r.rtx_packets,
               "timeouts": r.timeouts, "qlen_peak": r.qlen_peak}
    for k, v in scalars.items():
        assert v == int(ref[k]), (k, v, int(ref[k]))
    res = {"seconds": secs, "ticks_per_s": r.horizon / secs,
           "peak_bytes": peak, "launches": launches, **scalars,
           "completion_min": int(r.stat_completion.min()),
           "completion_max": int(r.stat_completion.max())}
    say("5 full width", f"{g.name} F={wl.src.shape[0]}: all complete "
        f"(ticks {res['completion_min']}..{res['completion_max']}), "
        f"horizon {r.horizon}, {res['ticks_per_s']:.1f} ticks/s "
        f"({secs:.2f} s), peak {peak / 2 ** 30:.2f} GiB, launches "
        f"{launches}; bitwise equal to the JAX reference {scalars}")
    return res


def phase_batch(serial: dict) -> dict:
    """The full-width ``ai_full`` fabric as B = 4 scenarios of one
    ``simulate_batch`` call, against the JAX ``simulate_batch`` golden;
    ``serial`` is phase 5's one-scenario run of the same call."""
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import simulate_batch
    from repro_torch.network.faults import FaultSchedule
    full, g, wl, prof, p = _fullsize()
    gold = np.load(BATCH)
    seeds = gold["seeds"]
    q = int(g.up1_table[0, 0])
    assert q == int(gold["fail_queue"]), "the flapping uplink"
    ok = FaultSchedule.healthy(g.num_queues)
    faults = FaultSchedule.stack([ok, ok, ok.flap(q, 0), ok.flap(q, 100, 400)])
    assert np.array_equal(faults.fail_at.numpy(), gold["fail_at"])
    assert np.array_equal(faults.heal_at.numpy(), gold["heal_at"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = simulate_batch(g, [wl] * B_MAIN, prof, p, faults=faults,
                        seeds=seeds, trace="stats", max_ticks=4096,
                        device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    horizons = [r.horizon for r in rs]
    # every scenario steps every tick until the last one stops: one
    # launch per tick kernel per tick for all four
    _assert_launches("ai_full", launches, max(horizons))
    for b, r in enumerate(rs):
        s = r.state
        lanes = {
            "stat_completion": r.stat_completion,
            "stat_src_completion": r.stat_src_completion,
            "delivered": s.delivered.cpu().numpy(),
            "next_psn": s.next_psn.cpu().numpy(),
            "src_base": s.src_track.base.cpu().numpy().view(np.uint32),
            "dst_base": s.dst_track.base.cpu().numpy().view(np.uint32),
            "cwnd": s.cc.cwnd.cpu().numpy(),
        }
        scalars = {"horizon": r.horizon, "trims": r.trims,
                   "drops": r.drops, "dups": r.dups,
                   "retransmits": r.rtx_packets, "timeouts": r.timeouts,
                   "qlen_peak": r.qlen_peak,
                   "ticks_degraded": r.ticks_degraded}
        for k, v in lanes.items():
            _assert_bits(v, gold[f"b{b}/{k}"], f"batch lane {b} {k}")
        for k, v in scalars.items():
            assert v == int(gold[f"b{b}/{k}"]), (b, k, v)
        if b == 0:   # lane 0 is the serial full-width run
            for k, v in lanes.items():
                _assert_bits(v, full[k], f"batch lane 0 {k} vs fullsize")
    sticks = sum(horizons)
    res = {"b": B_MAIN, "seconds": secs, "horizons": horizons,
           "ticks_run": max(horizons), "scenario_ticks": sticks,
           "scenario_ticks_per_s": sticks / secs,
           "lane_ticks_per_s": B_MAIN * max(horizons) / secs,
           "serial_ticks_per_s": serial["ticks_per_s"],
           "peak_bytes": peak, "serial_peak_bytes": serial["peak_bytes"],
           "launches": launches,
           "drops": [r.drops for r in rs],
           "timeouts": [r.timeouts for r in rs]}
    say("5 batch", f"B={B_MAIN} scenario-ticks/s {res['scenario_ticks_per_s']:.1f} "
        f"({sticks} scenario-ticks in {secs:.2f} s; all lanes stepped "
        f"{max(horizons)} ticks, {res['lane_ticks_per_s']:.1f} lane-ticks/s) "
        f"against the serial ai_full run's {serial['ticks_per_s']:.1f} "
        f"ticks/s")
    say("5 batch", f"peak {peak / 2 ** 30:.2f} GiB against the serial "
        f"run's {serial['peak_bytes'] / 2 ** 30:.2f} GiB")
    say("5 batch", f"{g.name} F={wl.src.shape[0]} x B={B_MAIN} (seeds "
        f"{[hex(int(x)) for x in seeds]}, uplink {q} dead / flapping on "
        f"lanes 2 / 3): horizons {horizons}, drops {res['drops']}, "
        f"timeouts {res['timeouts']}; every lane bitwise equal to the JAX "
        f"simulate_batch golden, lane 0 to the serial one; launches "
        f"{launches}")
    return res


def fault_schedule(g):
    """The faulted batch's [4, Q] / [4, H] schedule, as
    ``scripts/torch_port_reference.py`` builds it for the golden."""
    from repro_torch.network.faults import FaultSchedule
    up0 = [int(q) for q in g.up1_table[0, :]]
    up1 = [int(q) for q in g.up1_table[1, :]]
    ok = FaultSchedule.healthy(g.num_queues, num_hosts=g.num_hosts)
    lanes = [
        ok.lossy(up0, 0.01),
        ok.host_fail(0, 100).nic_stall(1, 100, 400),
        ok.corrupt(up1, 0.01),
        ok.lossy(up0, 0.01).host_fail(0, 100).nic_stall(1, 100, 400)
        .corrupt(up1, 0.01).flap(up0[0], 0),
    ]
    return FaultSchedule.stack([s.with_seed(b) for b, s in enumerate(lanes)])


def phase_faults(batch: dict) -> dict:
    """The full-width fabric as B = 4 faulted lanes of one
    ``simulate_batch`` call under ``resilient()``, against the JAX
    golden; ``batch`` is the healthy batch phase of the same call."""
    from dataclasses import fields
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import SimParams, simulate_batch
    from repro_torch.network.profile import TransportProfile
    _, g, wl, _, _ = _fullsize()
    gold = np.load(FAULTS)
    sched = fault_schedule(g)
    for f in fields(sched):
        got = getattr(sched, f.name).numpy()
        want = gold[f"sched.{f.name}"]
        _assert_bits(got.view(want.dtype) if f.name == "seed" else got,
                     want, f"schedule lane {f.name}")
    p = SimParams(timeout_ticks=int(gold["timeout_ticks"]),
                  ooo_threshold=int(gold["ooo_threshold"]))
    budget = int(gold["max_ticks"])
    prof = TransportProfile.resilient()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = simulate_batch(g, [wl] * B_MAIN, prof, p, faults=sched,
                        seeds=gold["seeds"], trace="stats",
                        max_ticks=budget, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    horizons = [r.horizon for r in rs]
    _assert_launches("resilient", launches, max(horizons))
    _faulted_vs_golden(rs, gold, budget)
    sticks = sum(horizons)
    res = {"b": B_MAIN, "seconds": secs, "horizons": horizons,
           "ticks_run": max(horizons), "scenario_ticks": sticks,
           "scenario_ticks_per_s": sticks / secs,
           "lane_ticks_per_s": B_MAIN * max(horizons) / secs,
           "healthy_scenario_ticks_per_s": batch["scenario_ticks_per_s"],
           "healthy_lane_ticks_per_s": batch["lane_ticks_per_s"],
           "peak_bytes": peak, "healthy_peak_bytes": batch["peak_bytes"],
           "launches": launches,
           **{k: [getattr(r, k) for r in rs] for k in (
               "drops", "timeouts", "rtx_packets", "ev_evictions",
               "flows_abandoned", "ticks_unreachable", "abandon_tick")}}
    say("5 faults", f"B={B_MAIN} scenario-ticks/s "
        f"{res['scenario_ticks_per_s']:.1f} ({sticks} scenario-ticks in "
        f"{secs:.2f} s; all lanes stepped {max(horizons)} ticks, "
        f"{res['lane_ticks_per_s']:.1f} lane-ticks/s) against the healthy "
        f"batch's {batch['scenario_ticks_per_s']:.1f} scenario-ticks/s "
        f"({batch['lane_ticks_per_s']:.1f} lane-ticks/s)")
    say("5 faults", f"peak {peak / 2 ** 30:.2f} GiB against the healthy "
        f"batch's {batch['peak_bytes'] / 2 ** 30:.2f} GiB")
    say("5 faults", f"{g.name} F={wl.src.shape[0]} x B={B_MAIN} under "
        f"{prof.describe()}: horizons {horizons}, drops {res['drops']}, "
        f"timeouts {res['timeouts']}, evictions {res['ev_evictions']}, "
        f"abandoned {res['flows_abandoned']} at {res['abandon_tick']}; "
        f"every lane bitwise equal to the JAX simulate_batch golden; "
        f"launches {launches}")
    return res


def _faulted_vs_golden(rs, gold, budget: int, lanes_of=None) -> None:
    """Faulted batch lanes (golden lanes ``lanes_of``, all by default)
    against ``tests/golden/torch_port_faults.npz``: stats, final lanes
    (the recovery lanes included) and counters, bitwise; lane 1
    quarantines and stops early, every other flow completes."""
    lanes_of = range(len(rs)) if lanes_of is None else lanes_of
    for b, r in zip(lanes_of, rs):
        s = r.state
        lanes = {
            "stat_completion": r.stat_completion,
            "stat_src_completion": r.stat_src_completion,
            "delivered": s.delivered.cpu().numpy(),
            "next_psn": s.next_psn.cpu().numpy(),
            "src_base": s.src_track.base.cpu().numpy().view(np.uint32),
            "dst_base": s.dst_track.base.cpu().numpy().view(np.uint32),
            "cwnd": s.cc.cwnd.cpu().numpy(),
            "rto": s.rto.cpu().numpy(),
            "rto_strikes": s.rto_strikes.cpu().numpy(),
            "quarantined": s.quarantined.cpu().numpy(),
            "inflight": s.inflight.cpu().numpy(),
            "bad_n": s.lb.bad_n.cpu().numpy(),
            "last_ev": s.lb.last_ev.cpu().numpy(),
            "bad_ev": s.lb.bad_ev.cpu().numpy(),
            "ev_set": s.lb.ev_set.cpu().numpy(),
        }
        scalars = {"horizon": r.horizon, "trims": r.trims,
                   "drops": r.drops, "dups": r.dups,
                   "retransmits": r.rtx_packets, "timeouts": r.timeouts,
                   "qlen_peak": r.qlen_peak,
                   "ticks_degraded": r.ticks_degraded,
                   "ev_evictions": r.ev_evictions,
                   "flows_abandoned": r.flows_abandoned,
                   "ticks_unreachable": r.ticks_unreachable,
                   "abandon_tick": r.abandon_tick}
        for k, v in lanes.items():
            _assert_bits(v, gold[f"b{b}/{k}"], f"faulted lane {b} {k}")
        for k, v in scalars.items():
            assert v == int(gold[f"b{b}/{k}"]), (b, k, v)
        settled = (r.stat_completion >= 0) | lanes["quarantined"]
        assert settled.all(), f"faulted lane {b}: a live flow is unfinished"
        if b == 1:
            assert r.flows_abandoned > 0 and r.abandon_tick >= 0
            assert r.horizon < budget, "lane 1 must quiesce before the budget"
        elif b in (0, 2):
            assert r.flows_abandoned == 0, f"faulted lane {b}"
    if len(rs) == B_MAIN:
        assert sum(r.ev_evictions for r in rs) > 0, "no EV was evicted"


def inc_workloads(device="cpu"):
    """The collectives phase's lanes, as ``scripts/torch_port_reference.py
    --which inc`` builds them: (INC lane, the same flows with ``red =
    -1``, per-host rx the schedules expect with INC off, the roots)."""
    from repro_torch.network import collectives as coll
    from repro_torch.network.fabric import Workload
    lanes: dict = {k: [] for k in ("src", "dst", "size", "dep", "red")}
    rx = np.zeros((1024,), np.int64)
    for j in range(32):
        hosts = np.asarray([j + 32 * i for i in range(32)], np.int32)
        spec = coll.CollectiveSpec("all_reduce", tuple(hosts), 32)
        t = coll.flow_table(spec, "tree")
        off = 62 * j
        for k, v in (("src", hosts[t.src]), ("dst", hosts[t.dst]),
                     ("size", t.size),
                     ("dep", np.where(t.dep >= 0, t.dep + off, -1)),
                     ("red", np.where(t.red >= 0, j, -1))):
            lanes[k].append(v)
        rx[hosts] += coll.expected_host_rx(spec, "tree")
    a = {k: np.concatenate(v).astype(np.int32) for k, v in lanes.items()}
    on = Workload.of(a["src"], a["dst"], a["size"], dep=a["dep"],
                     red=a["red"], device=device)
    off = Workload.of(a["src"], a["dst"], a["size"], dep=a["dep"],
                      device=device)
    return on, off, rx, np.arange(32)


def link_schedule(g):
    """The link phase's [2, Q] schedule: 1 % BER on edge 1's uplinks in
    lane 0, lane 1 healthy."""
    from repro_torch.network.faults import FaultSchedule
    ok = FaultSchedule.healthy(g.num_queues)
    return FaultSchedule.stack(
        [ok.corrupt([int(q) for q in g.up1_table[1, :]], 0.01), ok])


def _state_vs_golden(s, gold, prefix: str) -> int:
    """Every state lane but the packet and event buffers bitwise against
    ``gold[prefix + 'state.' + path]``; the lane sets must agree."""
    from repro_torch.convert import state_to_numpy
    state = _flat(state_to_numpy(s))
    lanes = sorted(k for k in state if k not in ("q_pkt", "ev_buf"))
    want = sorted(k[len(prefix) + 6:] for k in gold.files
                  if k.startswith(prefix + "state."))
    assert lanes == want, (prefix, set(lanes) ^ set(want))
    for k in lanes:
        _assert_bits(state[k], gold[f"{prefix}state.{k}"], f"{prefix}{k}")
    return len(lanes)


def _batch_vs_golden(r, gold, prefix: str, extra=()) -> dict:
    """A batch lane's stats lanes, scalars and state against the
    golden's ``prefix`` entries; returns the scalars."""
    s = r.state
    for k in ("stat_completion", "stat_src_completion"):
        _assert_bits(getattr(r, k), gold[prefix + k], prefix + k)
    for k in ("delivered", "next_psn"):
        _assert_bits(getattr(s, k).cpu().numpy(), gold[prefix + k],
                     prefix + k)
    scalars = {"horizon": r.horizon, "trims": r.trims, "drops": r.drops,
               "dups": r.dups, "retransmits": r.rtx_packets,
               "timeouts": r.timeouts, "qlen_peak": r.qlen_peak,
               "ticks_degraded": r.ticks_degraded,
               **{k: int(getattr(r, k) if hasattr(r, k)
                         else getattr(s, k)) for k in extra}}
    for k, v in scalars.items():
        assert v == int(gold[prefix + k]), (prefix, k, v, int(gold[prefix + k]))
    scalars["state_lanes"] = _state_vs_golden(s, gold, prefix)
    return scalars


def _timed_batch(run) -> "tuple[list, float, int, dict]":
    """``run()`` on the card from zeroed launch counts and peak memory:
    (results, seconds, peak bytes, launches)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = run()
    torch.cuda.synchronize()
    return (rs, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            dict(ops.LAUNCHES))


def _rate(tag: str, rs, secs: float, peak: int, batch: dict) -> dict:
    horizons = [r.horizon for r in rs]
    sticks = sum(horizons)
    res = {"b": len(rs), "seconds": secs, "horizons": horizons,
           "scenario_ticks": sticks, "scenario_ticks_per_s": sticks / secs,
           "lane_ticks_per_s": len(rs) * max(horizons) / secs,
           "peak_bytes": peak,
           "healthy_scenario_ticks_per_s": batch["scenario_ticks_per_s"],
           "healthy_peak_bytes": batch["peak_bytes"]}
    say(tag, f"B={len(rs)} scenario-ticks/s {res['scenario_ticks_per_s']:.1f}"
        f" ({sticks} scenario-ticks in {secs:.2f} s; all lanes stepped "
        f"{max(horizons)} ticks, {res['lane_ticks_per_s']:.1f} lane-ticks/s)"
        f" against the healthy B={batch['b']} batch's "
        f"{batch['scenario_ticks_per_s']:.1f} scenario-ticks/s")
    say(tag, f"peak {peak / 2 ** 30:.2f} GiB against the healthy batch's "
        f"{batch['peak_bytes'] / 2 ** 30:.2f} GiB")
    return res


def phase_collectives(batch: dict) -> dict:
    """INC at full width: the 32 concurrent tree all-reduces as B = 2
    lanes (INC on / off) of one ``simulate_batch`` call, then the default
    ``collective_sweep()``, against ``tests/golden/torch_port_inc.npz``."""
    from dataclasses import replace
    from repro_torch.network import collectives as coll
    from repro_torch.network.fabric import SimParams, simulate_batch
    from repro_torch.network.profile import TransportProfile
    from repro_torch.network.topology import fat_tree3
    from repro_torch.network.workloads import collective_sweep
    gold = np.load(INC)
    g = fat_tree3(k=16, pods=16)
    on, off, rx, roots = inc_workloads()
    for k in ("src", "dst", "size", "dep", "red"):
        _assert_bits(getattr(on, k).numpy(), gold[k], f"workload {k}")
    _assert_bits(rx, gold["expected_rx"], "expected_rx")
    prof = replace(TransportProfile.ai_full(), inc=True, name="ai_full+inc")
    rs, secs, peak, launches = _timed_batch(lambda: simulate_batch(
        g, [on, off], prof, SimParams(), trace="stats",
        max_ticks=int(gold["max_ticks"]), device="cuda"))
    _assert_launches("inc", launches, max(r.horizon for r in rs))
    scalars = [_batch_vs_golden(r, gold, f"b{b}/",
                                ("inc_reduced", "inc_emits"))
               for b, r in enumerate(rs)]
    assert all((r.stat_src_completion >= 0).all() for r in rs)
    got = [np.bincount(on.dst.numpy(), r.state.delivered.cpu().numpy(),
                       1024).astype(np.int64) for r in rs]
    np.testing.assert_array_equal(got[1], rx)    # INC off: every packet
    absorbed = int(rs[0].state.inc_reduced)
    assert absorbed > 0 and int(rs[1].state.inc_reduced) == 0
    others = np.setdiff1d(np.arange(1024), roots)
    np.testing.assert_array_equal(got[0][others], rx[others])
    assert int((rx - got[0])[roots].sum()) == absorbed, "payload lost"
    ct = [coll.collective_completion_ticks(r) for r in rs]
    assert 0 < ct[0] < ct[1], ct
    res = {**_rate("5 collectives", rs, secs, peak, batch),
           "launches": launches, "lanes": scalars, "completion": ct}
    say("5 collectives", f"{g.name} 32 tree all-reduces F={on.src.shape[0]}"
        f" x B=2 (INC on / off): horizons {res['horizons']}, collective "
        f"done at {ct}, absorbed {absorbed}, emitted "
        f"{int(rs[0].state.inc_emits)}; both lanes bitwise equal to the JAX "
        f"golden ({scalars[0]['state_lanes']} state lanes); delivered + "
        f"absorbed = the schedule's rx; launches {launches}")
    # the collective ablation grid: two profile groups, one after the
    # other, each running to its slowest scenario
    g2, wls, profs, names = collective_sweep()
    rs, secs, _, launches = _timed_batch(lambda: simulate_batch(
        g2, wls, profs, SimParams(ticks=1600), device="cuda"))
    for i, (nm, r) in enumerate(zip(names, rs)):
        assert nm == str(gold[f"s{i}/name"]), (i, nm)
        assert r.horizon == int(gold[f"s{i}/horizon"]), (nm, r.horizon)
        _assert_bits(r.stat_src_completion, gold[f"s{i}/stat_src_completion"],
                     f"{nm} stat_src_completion")
        _assert_bits(r.state.delivered.cpu().numpy(),
                     gold[f"s{i}/delivered"], f"{nm} delivered")
        for k in ("inc_reduced", "inc_emits"):
            assert int(getattr(r.state, k)) == int(gold[f"s{i}/{k}"]), (nm, k)
    groups = {q: max(r.horizon for r, x in zip(rs, profs) if x == q)
              for q in dict.fromkeys(profs)}
    group_ticks = sum(groups.values())
    # ai_full's group runs the NSCC forms, ai_base's (RCCC) does not
    fmax = int(wls.src.shape[-1])
    for i, k in enumerate(TICK_KERNELS):
        want = sum(per_tick(q, fmax)[i] * n for q, n in groups.items())
        assert launches[k] == want, \
            f"collective sweep: {k} launched {launches[k]} times, want {want}"
    assert all(launches[k] == 0 for k in ENTRY_KERNELS), launches
    cts = {nm: coll.collective_completion_ticks(r)
           for nm, r in zip(names, rs)}
    assert all(c > 0 for c in cts.values()), cts
    assert cts["ai_full/all_reduce/tree/inc"] < cts["ai_full/all_reduce/tree"]
    res["sweep"] = {"seconds": secs, "scenarios": len(rs),
                    "group_ticks": group_ticks, "launches": launches,
                    "completion": cts}
    say("5 collectives", f"collective_sweep(): {len(rs)} scenarios in two "
        f"profile groups ({group_ticks} ticks, {secs:.2f} s), bitwise equal "
        f"to the JAX golden; tree all-reduce done at "
        f"{cts['ai_full/all_reduce/tree/inc']} with INC against "
        f"{cts['ai_full/all_reduce/tree']} without")
    return res


def phase_link(batch: dict) -> dict:
    """The link layer at full width: B = 2 lanes (BER on edge 1's uplinks
    / healthy) under LLR and under LLR + CBFC, against
    ``tests/golden/torch_port_link.npz``."""
    from repro_torch.core.link import LinkConfig
    from repro_torch.network.fabric import SimParams, simulate_batch
    gold = np.load(LINK)
    _, g, wl, prof, _ = _fullsize()
    sched = link_schedule(g)
    budget = int(gold["max_ticks"])
    out = {}
    for tag, spec in (("llr", LinkConfig.on(llr=True)),
                      ("cbfc", LinkConfig.on(llr=True, cbfc=True))):
        rs, secs, peak, launches = _timed_batch(lambda: simulate_batch(
            g, [wl, wl], prof, SimParams(ticks=budget), faults=sched,
            seeds=gold["seeds"], trace="stats", link=spec, device="cuda"))
        _assert_launches(tag, launches, max(r.horizon for r in rs))
        scalars = [_batch_vs_golden(r, gold, f"{tag}/b{b}/",
                                    ("llr_replays", "credit_stall_ticks"))
                   for b, r in enumerate(rs)]
        assert all((r.stat_completion >= 0).all() for r in rs)
        assert all(r.drops == 0 for r in rs), "LLR lets no corruption out"
        assert rs[0].llr_replays > 0 and rs[1].llr_replays == 0
        if tag == "cbfc":
            assert all(r.trims == 0 for r in rs), "CBFC never trims"
        res = out[tag] = {**_rate(f"5 link {tag}", rs, secs, peak, batch),
                          "launches": launches, "lanes": scalars}
        say(f"5 link {tag}", f"{g.name} F={wl.src.shape[0]} x B=2 ({spec}):"
            f" horizons {res['horizons']}, llr_replays "
            f"{[r.llr_replays for r in rs]}, credit_stall_ticks "
            f"{[r.credit_stall_ticks for r in rs]}, trims "
            f"{[r.trims for r in rs]}, drops {[r.drops for r in rs]}; both "
            f"lanes bitwise equal to the JAX golden "
            f"({scalars[0]['state_lanes']} state lanes); launches {launches}")
    return out


def _same_state(a, b, what: str) -> None:
    """Two final states, every lane, bitwise."""
    from repro_torch.convert import state_to_numpy
    x, y = _flat(state_to_numpy(a)), _flat(state_to_numpy(b))
    assert sorted(x) == sorted(y), what
    for k in x:
        _assert_bits(x[k], y[k], f"{what} {k}")


def _tel_spec(gold, tag: str):
    from repro_torch.network.telemetry import TelemetrySpec
    return TelemetrySpec.on(probe_every=int(gold[f"{tag}/probe_every"]),
                            slots=int(gold[f"{tag}/slots"]))


def _tel_vs_golden(trace, gold, prefix: str) -> None:
    """A lane's whole probe carry (every ring slot, stale ones included)
    against ``tests/golden/torch_port_telemetry.npz``: the rings by the
    sha256 of their bytes, every other lane bitwise."""
    import hashlib
    want = sorted(k[len(prefix) + 4:] for k in gold.files
                  if k.startswith((prefix + "tel.", prefix + "sha.")))
    assert sorted(trace.lanes) == want, (prefix, set(trace.lanes) ^ set(want))
    for k, v in trace.lanes.items():
        v = np.asarray(v)
        if k in TEL_RINGS:
            got = hashlib.sha256(v.tobytes()).hexdigest()
            assert got == str(gold[f"{prefix}sha.{k}"]), (prefix, k)
        else:
            _assert_bits(v, gold[f"{prefix}tel.{k}"], prefix + k)


def _same_lanes(a: dict, b: dict, what: str) -> None:
    assert sorted(a) == sorted(b), what
    for k in a:
        _assert_bits(np.asarray(a[k]), np.asarray(b[k]), f"{what} {k}")


def phase_telemetry(faults: dict, link: dict, trace_path: Path) -> dict:
    """The probe at full width, against ``tests/golden/
    torch_port_telemetry.npz``: the faulted batch under
    ``TelemetrySpec.on(probe_every=16, slots=16)`` and the link phase's
    LLR + CBFC arm under ``TelemetrySpec.on(probe_every=8, slots=16)``,
    each lane's state bitwise the telemetry-off golden and its probe
    carry bitwise the JAX one; then the flap canary on the card."""
    from repro_torch.core.link import LinkConfig
    from repro_torch.network import telemetry as telem
    from repro_torch.network.fabric import SimParams, simulate, simulate_batch
    from repro_torch.network.profile import TransportProfile
    gold_t, gold_f, gold_l = (np.load(TELEMETRY), np.load(FAULTS),
                              np.load(LINK))
    _, g, wl, ai_full, _ = _fullsize()
    out = {}
    # the faulted batch
    spec = _tel_spec(gold_t, "faults")
    budget = int(gold_f["max_ticks"])
    p = SimParams(timeout_ticks=int(gold_f["timeout_ticks"]),
                  ooo_threshold=int(gold_f["ooo_threshold"]))
    rs, secs, peak, launches = _timed_batch(lambda: simulate_batch(
        g, [wl] * B_MAIN, TransportProfile.resilient(), p,
        faults=fault_schedule(g), seeds=gold_f["seeds"], trace="stats",
        max_ticks=budget, telemetry=spec, device=DEV))
    horizons = [r.horizon for r in rs]
    _assert_launches("resilient", launches, max(horizons))
    _faulted_vs_golden(rs, gold_f, budget)
    for b, r in enumerate(rs):
        _tel_vs_golden(r.telemetry, gold_t, f"faults/b{b}/")
    assert rs[3].telemetry.stride > 1, "lane 3's ring must decimate"
    sticks = sum(horizons)
    res = out["faults"] = {
        "spec": str(spec), "seconds": secs, "horizons": horizons,
        "scenario_ticks_per_s": sticks / secs,
        "off_scenario_ticks_per_s": faults["scenario_ticks_per_s"],
        "peak_bytes": peak, "off_peak_bytes": faults["peak_bytes"],
        "launches": launches, "rs": rs,
        "strides": [r.telemetry.stride for r in rs],
        "samples": [r.telemetry.num_samples for r in rs]}
    say("5 telemetry", f"faulted B={B_MAIN} with {spec}: scenario-ticks/s "
        f"{res['scenario_ticks_per_s']:.1f} against "
        f"{faults['scenario_ticks_per_s']:.1f} without telemetry in this "
        f"call; peak {peak / 2 ** 30:.2f} GiB against "
        f"{faults['peak_bytes'] / 2 ** 30:.2f} GiB; horizons {horizons}, "
        f"strides {res['strides']}, samples {res['samples']}; every lane's "
        f"state bitwise the telemetry-off golden and its probe carry "
        f"bitwise the JAX one; launches {launches}")
    # the link phase's LLR + CBFC arm
    spec = _tel_spec(gold_t, "link")
    rs, secs, peak, launches = _timed_batch(lambda: simulate_batch(
        g, [wl, wl], ai_full, SimParams(ticks=int(gold_l["max_ticks"])),
        faults=link_schedule(g), seeds=gold_l["seeds"], trace="stats",
        link=LinkConfig.on(llr=True, cbfc=True), telemetry=spec,
        device=DEV))
    _assert_launches("cbfc", launches, max(r.horizon for r in rs))
    for b, r in enumerate(rs):
        _batch_vs_golden(r, gold_l, f"cbfc/b{b}/",
                         ("llr_replays", "credit_stall_ticks"))
        _tel_vs_golden(r.telemetry, gold_t, f"link/b{b}/")
        fin = r.telemetry.final
        assert int(fin["llr_q"].sum()) == r.llr_replays, b
        # every stall tick stalls at least one enqueue
        stalls = int(fin["stall_q"].sum())
        assert stalls >= r.credit_stall_ticks and (
            stalls > 0) == (r.credit_stall_ticks > 0), (b, stalls)
    assert rs[0].llr_replays > 0, "the llr channel must count"
    sticks = sum(r.horizon for r in rs)
    res = out["link"] = {
        "spec": str(spec), "seconds": secs,
        "horizons": [r.horizon for r in rs],
        "scenario_ticks_per_s": sticks / secs,
        "off_scenario_ticks_per_s": link["cbfc"]["scenario_ticks_per_s"],
        "peak_bytes": peak, "off_peak_bytes": link["cbfc"]["peak_bytes"],
        "launches": launches,
        "llr_q": [int(r.telemetry.final["llr_q"].sum()) for r in rs],
        "stall_q": [int(r.telemetry.final["stall_q"].sum()) for r in rs]}
    say("5 telemetry", f"LLR + CBFC B=2 with {spec}: scenario-ticks/s "
        f"{res['scenario_ticks_per_s']:.1f} against "
        f"{res['off_scenario_ticks_per_s']:.1f} without telemetry; peak "
        f"{peak / 2 ** 30:.2f} GiB; llr channel {res['llr_q']}, stall "
        f"channel {res['stall_q']}; both lanes bitwise the telemetry-off "
        f"golden and the JAX probe carry; launches {launches}")
    # the flap canary: visible in the probe lanes, and no perturbation
    g2, wl2, prof, p2, sched, spec, (fail_at, heal_at) = \
        telem.flap_victim_scenario()
    runs = {}
    for tag, tel in (("on", spec), ("off", None)):
        t0 = time.perf_counter()
        runs[tag] = simulate(g2, wl2, prof, p2, faults=sched, telemetry=tel,
                             device=DEV)
        torch.cuda.synchronize()
        runs[tag + "_s"] = time.perf_counter() - t0
    on, off = runs["on"], runs["off"]
    assert on.horizon == off.horizon and off.telemetry is None
    _same_state(on.state, off.state, "canary on vs off")
    vis = telem.outage_visibility(on.telemetry, fail_at, heal_at, p2.ticks)
    telem.assert_outage_visible(vis)
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    on.telemetry.save_chrome_trace(str(trace_path), label="flap")
    out["canary"] = {"seconds_on": runs["on_s"], "seconds_off": runs["off_s"],
                     "ticks": on.horizon, "trace": str(trace_path),
                     **{k: v for k, v in vis.items()
                        if not isinstance(v, dict)}}
    say("5 telemetry", f"flap canary ({g2.name}, uplinks down over "
        f"[{fail_at}, {heal_at})): drops 0 -> {vis['drop_during']:.2f}/tick"
        f" -> 0, goodput {vis['goodput_pre']:.2f} -> "
        f"{vis['goodput_during']:.2f} -> {vis['goodput_post']:.2f}, heal "
        f"trim burst {vis['trim_burst']:.2f}/tick; state bitwise the "
        f"telemetry-off run's; {on.horizon} ticks in {runs['on_s']:.2f} s "
        f"on / {runs['off_s']:.2f} s off; Perfetto JSON {trace_path}")
    return out


def phase_shard(tel: dict) -> dict:
    """The split scenario axis: lanes 0, 1 and 3 of the faulted batch
    with telemetry on (B = 3, ragged: one padding lane) through
    ``shard.run_sharded`` over (cuda:0, cuda:0), bitwise the unsharded
    telemetry phase's lanes; over every card when there are several."""
    from repro_torch.network import shard
    from repro_torch.network.fabric import SimParams, Workload, simulate_batch
    from repro_torch.network.profile import TransportProfile
    gold_t, gold_f = np.load(TELEMETRY), np.load(FAULTS)
    _, g, wl, _, _ = _fullsize()
    spec = _tel_spec(gold_t, "faults")
    budget = int(gold_f["max_ticks"])
    p = SimParams(timeout_ticks=int(gold_f["timeout_ticks"]),
                  ooo_threshold=int(gold_f["ooo_threshold"]))
    prof = TransportProfile.resilient()
    sel = list(SHARD_LANES)
    sched = fault_schedule(g).lanes(torch.as_tensor(sel))
    seeds = np.asarray(gold_f["seeds"])[sel]
    dev = torch.device(DEV)
    rs, secs, peak, launches = _timed_batch(lambda: shard.run_sharded(
        g, Workload.stack([wl] * len(sel)), prof, p, sched, seeds, "stats",
        budget, None, (dev, dev), tel=spec))
    base = [tel["faults"]["rs"][b] for b in sel]
    for b, r, u in zip(sel, rs, base):
        assert r.horizon == u.horizon, (b, r.horizon, u.horizon)
        for k in ("stat_completion", "stat_src_completion",
                  "stat_win_delivered"):
            _assert_bits(getattr(r, k), getattr(u, k), f"shard lane {b} {k}")
        assert (r.qlen_peak, r.abandon_tick) == (u.qlen_peak, u.abandon_tick)
        _same_state(r.state, u.state, f"shard lane {b}")
        _same_lanes(r.telemetry.lanes, u.telemetry.lanes,
                    f"shard lane {b} probe carry")
        _tel_vs_golden(r.telemetry, gold_t, f"faults/b{b}/")
    _faulted_vs_golden(rs, gold_f, budget, lanes_of=sel)
    # each shard steps its own lanes to its own stop: shard 0 holds lanes
    # 0 and 1, shard 1 lane 3 and the padding lane, which stops at the
    # first chunk boundary
    shard_ticks = [max(rs[0].horizon, rs[1].horizon),
                   max(rs[2].horizon, min(p.chunk_ticks, budget))]
    _assert_launches("resilient", launches, sum(shard_ticks))
    lane_ticks = 2 * sum(shard_ticks)
    unsharded = B_MAIN * max(r.horizon for r in tel["faults"]["rs"])
    res = {"lanes": sel, "devices": [str(dev)] * 2, "seconds": secs,
           "peak_bytes": peak, "launches": launches,
           "shard_ticks": shard_ticks, "lane_ticks": lane_ticks,
           "unsharded_lane_ticks": unsharded,
           "horizons": [r.horizon for r in rs]}
    say("5 shard", f"faulted lanes {sel} with {spec} over 2 shards on "
        f"{dev} (one padding lane): every lane's horizon, stat lanes, state "
        f"and probe carry bitwise the unsharded run's and the goldens; "
        f"shards stepped {shard_ticks} ticks, {lane_ticks} lane-ticks "
        f"against the unsharded B={B_MAIN} batch's {unsharded}; "
        f"{secs:.2f} s; launches {launches}")
    ncards = torch.cuda.device_count()
    if ncards > 1:
        shd = simulate_batch(g, [wl] * len(sel), prof, p, faults=sched,
                             seeds=seeds, max_ticks=budget, telemetry=spec,
                             shard=True, device=DEV)
        for b, r, u in zip(sel, shd, base):
            assert r.horizon == u.horizon, b
            _same_state(r.state, u.state, f"multi-card lane {b}")
            _same_lanes(r.telemetry.lanes, u.telemetry.lanes,
                        f"multi-card lane {b} probe carry")
        res["multi_card"] = ncards
        say("5 shard", f"shard=True over {ncards} cards: bitwise the "
            f"unsharded lanes")
    else:
        res["multi_card"] = None
        say("5 shard", "one card: shard=True over several cards is "
            "unverified in this run")
    return res


def _assert_launches(tag: str, launches: dict, ticks: int) -> None:
    """Each tick kernel launched ``PER_TICK[tag]`` times a tick, and no
    entry-point form on the tick."""
    for k, n in zip(TICK_KERNELS, PER_TICK[tag]):
        assert launches[k] == n * ticks, \
            f"{tag}: {k} launched {launches[k]} times in {ticks} ticks"
    assert all(launches[k] == 0 for k in ENTRY_KERNELS), (tag, launches)


def _profiles(num_flows: int) -> dict:
    """The three full-width profile runs, by tag (as in
    ``scripts/torch_port_reference.py``)."""
    from repro_torch.core.lb.schemes import LBScheme
    from repro_torch.network.profile import (CCAlgo, DeliveryMode,
                                             TransportProfile)
    mixed = tuple(DeliveryMode.ROD if f % 2 else DeliveryMode.RUD
                  for f in range(num_flows))
    return {
        "hpc": TransportProfile.hpc(),
        "base": TransportProfile.ai_base(lb=LBScheme.EVBITMAP),
        "mixed": TransportProfile(cc=CCAlgo.NONE, lb=LBScheme.RR_SLOTS,
                                  delivery=mixed, name="mixed"),
    }


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def phase_profiles() -> "tuple[dict, dict]":
    """Phase 5, the profile table at full width against the references.
    Returns the results and each run's final state, by tag."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import simulate
    _, g, wl, _, p = _fullsize()
    ref = np.load(PROFILES)
    out, states = {}, {}
    for tag, prof in _profiles(int(wl.src.shape[0])).items():
        assert str(ref[f"{tag}/describe"]) == prof.describe(), tag
        modes = prof.delivery_modes(int(wl.src.shape[0]))
        assert np.array_equal(modes, ref[f"{tag}/delivery"]), tag
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        r = simulate(g, wl, prof, p, trace="stats", max_ticks=PROFILE_TICKS,
                     device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        _assert_launches(tag, launches, r.horizon)
        _assert_bits(r.stat_completion, ref[f"{tag}/stat_completion"],
                     f"{tag} stat_completion")
        _assert_bits(r.stat_src_completion,
                     ref[f"{tag}/stat_src_completion"],
                     f"{tag} stat_src_completion")
        state = _flat(state_to_numpy(r.state))
        lanes = [k for k in state
                 if k not in ("q_pkt", "ev_buf") + UNRECORDED_LANES]
        assert sorted(lanes) == sorted(
            k[len(f"{tag}/state."):] for k in ref.files
            if k.startswith(f"{tag}/state.")), tag
        # the reference leaves these lanes out of its profile goldens:
        # inert here (zero, or zero-size where INC / the link is off)
        for k in UNRECORDED_LANES:
            assert not state[k].any(), (tag, k)
        for k in lanes:
            _assert_bits(state[k], ref[f"{tag}/state.{k}"], f"{tag} {k}")
        s = r.state
        scalars = {"horizon": r.horizon, "qlen_peak": r.qlen_peak,
                   "trims": r.trims, "drops": r.drops, "dups": r.dups,
                   "rod_rejects": int(s.rod_rejects),
                   "retransmits": r.rtx_packets, "timeouts": r.timeouts}
        for k, v in scalars.items():
            assert v == int(ref[f"{tag}/{k}"]), (tag, k, v)
        out[tag] = {"seconds": secs, "ticks_per_s": r.horizon / secs,
                    "peak_bytes": peak, "launches": launches,
                    "state_lanes": len(lanes), **scalars}
        say("5 full width", f"{prof.describe()[:72]}: {r.horizon} ticks, "
            f"{r.horizon / secs:.1f} ticks/s ({secs:.2f} s), peak "
            f"{peak / 2 ** 30:.2f} GiB, launches {launches}; bitwise equal to "
            f"the JAX reference on the stats and {len(lanes)} state lanes "
            f"{scalars}")
        states[tag] = s
    return out, states


def phase_entry_points(states: dict) -> dict:
    """The kernels that are not on the tick, through their public entry
    points, as a user calls them: one coalesced NSCC ACK round over the
    hpc run's 2048 windows; the ECMP port choice of one tick's
    Q + F = 7168 packet lanes of the ai_full fabric (each queue's head
    packet at its next switch, each flow's next injection at its source
    leaf); the dense SACK forms of ``repro.kernels.ops`` on the mixed
    run's final rings, one received PSN on half the flows; and the
    copying ``nack_mark`` of one NACK lane per flow on its final
    retransmit ring."""
    from repro_torch.kernels import ops, ref
    from repro_torch.network.ecmp import RoutingTables
    from repro_torch.network.fabric import _bit_plane
    hpc_cwnd = states["hpc"].cc["nscc"].cwnd
    st = states["mixed"]
    _, g, wl, _, p = _fullsize()
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    F, Q = int(wl.src.shape[0]), g.num_queues
    ecn = torch.as_tensor(rng.integers(0, 2, F).astype(np.int32)).to(dev)
    rtt = torch.as_tensor(rng.uniform(4.0, 40.0, F).astype(np.float32)
                          ).to(dev)
    count = torch.as_tensor(rng.integers(0, 4, F).astype(np.int32)).to(dev)
    ev = torch.as_tensor(rng.integers(0, 1 << 16, Q + F).astype(np.int32)
                         ).to(dev)
    qflow = torch.as_tensor(rng.integers(0, F, Q).astype(np.int32)).to(dev)
    rt = RoutingTables(g, dev)
    wl = wl.to(dev)
    src = torch.cat([wl.src[qflow.long()], wl.src])
    dst = torch.cat([wl.dst[qflow.long()], wl.dst])
    salt = torch.cat([rt.next_switch, rt.host_leaf[wl.src.long()]])
    params = _nscc_params()[0]
    w = int(st.rtx.shape[1])
    mask = _bit_plane(
        torch.as_tensor(rng.integers(0, 32 * w, F).astype(np.int32)).to(dev),
        torch.as_tensor(rng.integers(0, 2, F).astype(bool)).to(dev), w)
    sack_in = (st.src_track.ring, st.src_track.base, st.rtx, mask)
    adv_in = (st.dst_track.ring | mask, st.dst_track.base)
    nack_in = (st.rtx, torch.arange(F, dtype=torch.int32, device=dev),
               torch.as_tensor(rng.integers(-4, 32 * w + 4, F).astype(
                   np.int32)).to(dev),
               torch.as_tensor(rng.integers(0, 2, F).astype(bool)).to(dev))
    ops.reset_launches()
    cwnd2 = ops.nscc_update(hpc_cwnd, ecn, rtt, count, params)
    port = ops.ecmp_select(src, dst, ev, salt, g.fanout1)
    fused = ops.sack_fused(*sack_in)
    advanced = ops.sack_advance(*adv_in)
    marked = ops.nack_mark(*nack_in)
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in ENTRY_KERNELS}
    for k, n in launches.items():
        assert n >= 1, f"{k} was not launched on its entry-point path"
    cpu = [t.cpu() for t in (hpc_cwnd, ecn, rtt, count)]
    _assert_bits(cwnd2.cpu().numpy(),
                 ref.nscc_update_ref(*cpu, params).numpy(), "nscc round")
    _assert_bits(port.cpu().numpy(),
                 ref.ecmp_hash_ref(src.cpu(), dst.cpu(), ev.cpu(), salt.cpu(),
                                   g.fanout1).numpy(), "ecmp ports")
    for what, got, want in (
            ("sack_fused", fused, ref.sack_fused_ref(
                *(t.cpu() for t in sack_in))),
            ("sack_advance", advanced, ref.sack_advance_ref(
                *(t.cpu() for t in adv_in))),
            ("nack_mark", (marked,), (ref.nack_mark_ref(
                *(t.cpu() for t in nack_in)),))):
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_bits(a.cpu().numpy(), b.numpy(), f"{what} output {i}")
    # the injection lanes' ports are the tick's own first-hop choice
    remote = rt.host_leaf[wl.src.long()] != rt.host_leaf[wl.dst.long()]
    sleaf = rt.host_leaf[wl.src.long()].long()
    up = rt.up1[sleaf, port[Q:].long()]
    inj = rt.injection_queue(wl.src, wl.dst, ev[Q:])
    assert torch.equal(up[remote], inj[remote]), "first-hop port"
    say("5 entry points", f"ops.nscc_update over {F} windows, "
        f"ops.ecmp_select over {Q + F} packet lanes (fanout {g.fanout1}) "
        f"and ops.sack_fused / sack_advance / nack_mark over {F} rings of "
        f"{w} words: "
        f"bitwise equal to the plain versions on the CPU, injection ports "
        f"equal to the tick's routing; launches {launches}")
    return {"launches": launches}


def phase_cross_device() -> dict:
    from repro_torch.network.fabric import simulate
    _, g, wl, prof, p = _fullsize()
    secs, runs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = simulate(g, wl, prof, p, trace="full",
                             max_ticks=CROSS_TICKS, device=dev)
        secs[dev] = time.perf_counter() - t0
    a, b = runs["cuda"], runs["cpu"]
    assert a.horizon == b.horizon == CROSS_TICKS
    for lane in ("delivered_per_tick", "cwnd_per_tick", "qlen_max",
                 "rx_base_per_tick", "src_base_per_tick"):
        _assert_bits(getattr(a, lane), getattr(b, lane), lane)
    _same_state(a.state, b.state, "state")
    say("6 cross-device", f"first {CROSS_TICKS} ticks at full width "
        f"bitwise equal on cuda and cpu (every out lane and state field; "
        f"cuda {secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s)")
    return {"seconds": secs}


class _Capture:
    """Record every SimResult that ``module.name`` (the simulator entry
    point a traffic function calls) returns while it runs, and the
    seconds spent in it."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.results: list = []
        self.seconds = 0.0

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def run(*args, **kw):
            t0 = time.perf_counter()
            r = orig(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.results += r if isinstance(r, list) else [r]
            return r
        setattr(self.module, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


TIMING_FIELDS = ("step_s", "net_s", "analytic_net_s", "compute_s",
                 "memory_s", "tokens_per_sec")


def _timing_vs_golden(compiled, r, t, gold, prefix: str) -> None:
    """One compiled step, its run and its StepTiming against the golden's
    point ``prefix``: lanes bitwise, priced floats ``==``."""
    for k in ("src", "dst", "size", "dep"):
        _assert_bits(getattr(compiled.workload, k).numpy(),
                     gold[prefix + k], prefix + k)
    assert ",".join(ph.name for ph in compiled.phases) \
        == str(gold[prefix + "phase_names"]), prefix
    _assert_bits(np.asarray([(ph.lo, ph.hi, ph.ideal_ticks)
                             for ph in compiled.phases], np.int64),
                 gold[prefix + "phases"], prefix + "phases")
    assert r.horizon == int(gold[prefix + "horizon"]), (prefix, r.horizon)
    _assert_bits(r.stat_src_completion, gold[prefix + "stat_src_completion"],
                 prefix + "stat_src_completion")
    assert t.sim_ticks == int(gold[prefix + "sim_ticks"]), prefix
    for k in TIMING_FIELDS:
        assert getattr(t, k) == float(gold[prefix + k]), \
            (prefix, k, getattr(t, k), float(gold[prefix + k]))
    assert ",".join(t.eff) == str(gold[prefix + "eff_scopes"]), prefix
    assert [t.eff[k] for k in t.eff] == gold[prefix + "eff"].tolist(), prefix
    assert [d["ticks"] for d in t.phases] \
        == gold[prefix + "phase_ticks"].tolist(), prefix


def _launches_per_group(tag: str, launches: dict, group_ticks: dict) -> None:
    """Each tick kernel launched ``PER_TICK[profile]`` times a tick of
    every (graph, profile) group, and no entry-point form."""
    for i, k in enumerate(TICK_KERNELS):
        want = sum(PER_TICK[prof][i] * n
                   for (_, prof), n in group_ticks.items())
        assert launches[k] == want, \
            f"traffic {tag}: {k} launched {launches[k]} times, want {want}"
    assert all(launches[k] == 0 for k in ENTRY_KERNELS), (tag, launches)


def _traffic_sweep(tag: str, gold, topologies) -> dict:
    """``run_model_sweep(topologies=...)`` on the card against the
    golden's part ``tag``."""
    from repro_torch.network import traffic
    with _Capture(traffic, "simulate_batch") as cap:
        pts, secs, peak, launches = _timed_batch(
            lambda: traffic.run_model_sweep(topologies=topologies,
                                            device="cuda"))
    rs = cap.results
    n = int(gold[f"{tag}/n"])
    assert len(pts) == len(rs) == n, (tag, len(pts), len(rs))
    t0 = time.perf_counter()
    _, _, _, points = traffic.model_sweep_scenarios(topologies=topologies)
    compile_s = time.perf_counter() - t0
    assert max(pt["compiled"].default_budget() for pt in points) \
        == int(gold[f"{tag}/budget"])
    t0 = time.perf_counter()
    timings = [traffic.price_step(pt["compiled"], r)
               for pt, r in zip(points, rs)]
    price_s = time.perf_counter() - t0
    groups: dict = {}
    for i, (pt, ref, r, t) in enumerate(zip(pts, points, rs, timings)):
        pre = f"{tag}/s{i}/"
        for k in ("arch", "layout", "topology", "profile"):
            assert pt[k] == str(gold[pre + k]) == ref[k], (pre, k)
        _timing_vs_golden(ref["compiled"], r, t, gold, pre)
        # the entry point's own dict: the same prices, eff rounded
        for k in TIMING_FIELDS + ("sim_ticks",):
            assert pt[k] == getattr(t, k), (pre, k)
        assert pt["eff"] == {k: round(v, 4) for k, v in t.eff.items()}, pre
        key = (pt["topology"], pt["profile"])
        groups[key] = max(groups.get(key, 0), r.horizon)
    _launches_per_group(tag, launches, groups)
    return {"points": pts, "scenarios": n, "groups": len(groups),
            "group_ticks": sum(groups.values()), "seconds": secs,
            "scenarios_per_s": n / secs, "peak_bytes": peak,
            "launches": launches, "sim_seconds": cap.seconds,
            "compile_ms_per_point": 1e3 * compile_s / n,
            "price_ms_per_point": 1e3 * price_s / n,
            "sim_ms_per_point": 1e3 * cap.seconds / n,
            "horizons": [r.horizon for r in rs]}


def _sweep_gates(pts: list) -> dict:
    """The reference bench's separation gates (``_model_sweep``)."""
    by = {(p["arch"], p["layout"], p["topology"], p["profile"]): p["step_s"]
          for p in pts}
    seps = {}
    for a in sorted({p["arch"] for p in pts}):
        for topo in ("full", "oversub2"):
            for prof in ("ai_base", "ai_full", "hpc"):
                assert by[(a, "fsdp_tp", topo, prof)] \
                    > by[(a, "tp_only", topo, prof)], (a, topo, prof)
        hpc = by[(a, "fsdp_tp", "oversub2", "hpc")]
        ai = by[(a, "fsdp_tp", "oversub2", "ai_full")]
        assert hpc > 1.05 * ai, (a, hpc, ai)
        full = by[(a, "fsdp_tp", "full", "ai_full")]
        assert ai >= full, (a, ai, full)
        seps[a] = {"hpc_over_ai_oversub2": hpc / ai,
                   "oversub2_over_full": ai / full}
    return seps


def _recovery_gates(rc, write_s: float) -> list:
    """The reference bench's economics gates on the measured costs:
    Young/Daly beats fixed intervals at every MTBF, availability at the
    optimum is monotone in MTBF."""
    from repro_torch.ckpt.checkpointing import (availability, effective_rate,
                                                young_daly_interval)
    kw = dict(write_s=write_s, detect_s=rc.detect_s, restore_s=rc.restore_s,
              replan_s=rc.replan_s)
    grid, prev = [], 0.0
    for mtbf in (1800.0, 3600.0, 7200.0, 14400.0):
        tau = young_daly_interval(mtbf, write_s)
        av = availability(tau, mtbf, **kw)
        eff = effective_rate(rc.healthy_tokens_per_sec, tau, mtbf, **kw)
        for iv in (30.0, 900.0):
            naive = effective_rate(rc.healthy_tokens_per_sec, iv, mtbf, **kw)
            assert eff > naive, (mtbf, iv, eff, naive)
        assert av >= prev, (mtbf, av, prev)
        prev = av
        grid.append({"mtbf_s": mtbf, "daly_interval_s": tau,
                     "availability": av, "effective_tokens_per_sec": eff})
    return grid


def traffic_train_plan(dp: int = 16, tp: int = 16):
    """The deepseek-coder-33b ``train_4k`` plan (fsdp_tp) of the traffic
    phase: dp = tp = 16 for part (b), 4 for the recovery loop."""
    from repro_torch import configs
    from repro_torch.distributed.plan import derive_plan
    return derive_plan(configs.get("deepseek-coder-33b"), "train_4k",
                       dp=dp, tp=tp, layout="fsdp_tp")


def phase_traffic() -> dict:
    """Phase 7: model-driven traffic and its pricing on the card, against
    ``tests/golden/torch_port_traffic.npz``."""
    from repro_torch.distributed import netmodel
    from repro_torch.network import traffic
    from repro_torch.network.profile import TransportProfile
    from repro_torch.network.topology import fat_tree3
    gold = np.load(TRAFFIC)
    out = {}
    # (a) the reference bench's co-design sweep
    res = out["a"] = _traffic_sweep("a", gold, None)
    res["separations"] = _sweep_gates(res["points"])
    say("7 traffic", f"(a) run_model_sweep(): {res['scenarios']} scenarios in "
        f"{res['groups']} (graph, profile) groups ({res['group_ticks']} group "
        f"ticks), {res['scenarios_per_s']:.3f} scenarios/s ({res['seconds']:.2f}"
        f" s wall, peak {res['peak_bytes'] / 2 ** 30:.3f} GiB); every point's "
        f"workload, horizon, source completion and priced step equal to the "
        f"JAX golden; separation gates hold {res['separations']}; launches "
        f"{res['launches']}")
    # (b) the same grid at the port's full width, then a train step
    g = fat_tree3(k=16, pods=16)
    res = out["b"] = _traffic_sweep("b", gold, [("ft16", g)])
    say("7 traffic", f"(b) run_model_sweep(topologies=[ft16]) on {g.name} "
        f"(Q={g.num_queues}): {res['scenarios']} scenarios in {res['groups']} "
        f"groups ({res['group_ticks']} group ticks), "
        f"{res['scenarios_per_s']:.3f} scenarios/s ({res['seconds']:.2f} s "
        f"wall, peak {res['peak_bytes'] / 2 ** 30:.3f} GiB), equal to the JAX "
        f"golden; launches {res['launches']}")
    plan = traffic_train_plan()
    prof = TransportProfile.ai_full()
    with _Capture(traffic, "simulate") as cap:
        t, secs, peak, launches = _timed_batch(
            lambda: traffic.step_time(plan, g, prof, device="cuda"))
    compiled = traffic.compile_step(plan, g)
    (r,) = cap.results
    _timing_vs_golden(compiled, r, t, gold, "b/train/")
    _launches_per_group("b train", launches, {("ft16", "ai_full"): r.horizon})
    res["train"] = {"seconds": secs, "peak_bytes": peak, "launches": launches,
                    "horizon": r.horizon, "num_flows": compiled.num_flows,
                    "step_s": t.step_s, "eff": t.eff,
                    "ticks_per_s": r.horizon / cap.seconds}
    say("7 traffic", f"(b) step_time of {plan.arch} train_4k dp=16 tp=16 on "
        f"{g.name} under ai_full: F={compiled.num_flows}, {r.horizon} ticks in "
        f"{secs:.2f} s ({r.horizon / cap.seconds:.1f} ticks/s), modelled "
        f"fleet step {t.step_s!r} s (priced with the reference's modelled "
        f"accelerator), eff {t.eff}; equal to the JAX golden")
    # (c) the recovery loop and its economics
    plan = traffic_train_plan(4, 4)
    with _Capture(traffic, "simulate") as cap:
        rc, secs, peak, launches = _timed_batch(
            lambda: traffic.price_recovery(plan, device="cuda"))
    for k in ("detect_s", "detect_ticks", "restore_s", "replan_s",
              "healthy_tokens_per_sec", "degraded_tokens_per_sec",
              "flows_abandoned", "horizon", "budget"):
        assert getattr(rc, k) == gold[f"c/{k}"].item(), \
            (k, getattr(rc, k), gold[f"c/{k}"])
    for run, r in zip(("healthy", "fault", "degraded"), cap.results):
        for k in ("horizon", "max_ticks", "flows_abandoned", "abandon_tick"):
            assert getattr(r, k) == int(gold[f"c/{run}/{k}"]), (run, k)
        _assert_bits(r.stat_src_completion,
                     gold[f"c/{run}/stat_src_completion"], f"c/{run}")
    assert len(cap.results) == 3 and rc.horizon < rc.budget
    _launches_per_group("c", launches, {(i, "resilient"): r.horizon
                                        for i, r in enumerate(cap.results)})
    grid = _recovery_gates(rc, traffic.checkpoint_seconds(plan))
    out["c"] = {"seconds": secs, "peak_bytes": peak, "launches": launches,
                "costs": {k: getattr(rc, k) for k in (
                    "detect_s", "detect_ticks", "restore_s", "replan_s",
                    "healthy_tokens_per_sec", "degraded_tokens_per_sec",
                    "flows_abandoned", "horizon", "budget")},
                "horizons": [r.horizon for r in cap.results], "grid": grid}
    say("7 traffic", f"(c) price_recovery of train_4k dp=4 tp=4: horizons "
        f"{out['c']['horizons']} ({secs:.2f} s, peak "
        f"{peak / 2 ** 30:.3f} GiB); detect {rc.detect_ticks} ticks, "
        f"{rc.flows_abandoned} flows abandoned, modelled fleet tokens/s "
        f"{rc.healthy_tokens_per_sec!r} healthy / "
        f"{rc.degraded_tokens_per_sec!r} degraded; every RecoveryCosts field "
        f"equal to the JAX golden; Young/Daly and availability gates hold")
    # (d) netmodel
    with _Capture(netmodel, "simulate") as cap:
        def run():
            ts = {f"{kind}/{algo}": netmodel.simulated_collective_time(
                kind, chips=8, size_pkts=24, algo=algo, device="cuda")
                for kind, algo in (("all-reduce", "ring"),
                                   ("all-reduce", "tree"),
                                   ("all-gather", "ring"))}
            ts["eff"] = netmodel.simulated_efficiency(
                "all-reduce", hosts=4, size_pkts=16, device="cuda")
            return ts
        ts, secs, peak, launches = _timed_batch(run)
    for k, v in ts.items():
        want = gold["d/eff" if k == "eff" else f"d/t/{k}"].item()
        assert v == want, (k, v, want)
    _launches_per_group("d", launches, {(i, "ai_full"): r.horizon
                                        for i, r in enumerate(cap.results)})
    out["d"] = {"seconds": secs, "peak_bytes": peak, "launches": launches,
                "values": ts, "horizons": [r.horizon for r in cap.results]}
    say("7 traffic", f"(d) netmodel: {ts} ({secs:.2f} s), equal to the JAX "
        f"golden; launches {launches}")
    for tag in ("a", "b"):
        res = out[tag]
        say("7 traffic", f"({tag}) host ms per point: compile_step "
            f"{res['compile_ms_per_point']:.3f} + price_step "
            f"{res['price_ms_per_point']:.3f} against the simulator's "
            f"{res['sim_ms_per_point']:.3f}")
    runs = [out[p]["launches"] for p in "abcd"] + [
        out["b"]["train"]["launches"]]
    out["launches"] = {k: sum(r[k] for r in runs) for k in TICK_KERNELS}
    for res in (out["a"], out["b"]):
        del res["points"]
    return out


# ------------------------------------------------------- control plane --

#: the control phase's seeded batches: the golden's size (the reference's
#: ``record_rx`` dedup is [B, B], so B = 8192 there) and one endpoint at
#: real scale (N = 65536 PDCs at ``DEFAULT_MP_RANGE`` = 1024, W = 32)
CONTROL_GOLDEN = {"psn_n": 2048, "lanes": 8192, "rounds": 3,
                  "pdc_n": 4096, "jobs": 8, "pids": 64, "ris": 8,
                  "entries": 1024, "arrivals": 512, "members": 1024,
                  "iv_lanes": 4096, "iv_rounds": 4, "peers": 1024,
                  "cccs": 1024}
CONTROL_REAL = {"psn_n": 65536, "lanes": 262144, "rounds": 8,
                "pdc_n": 65536, "jobs": 64, "pids": 1024, "ris": 16,
                "entries": 16384, "arrivals": 4096, "members": 65536,
                "iv_lanes": 262144, "iv_rounds": 16, "peers": 65536,
                "cccs": 65536}
CONTROL_SEED = 0xC0DE
CONTROL_PARTS = ("psn", "pdc", "addr", "match", "tss", "nscc")
#: the NSCC gains of the control batch: a target (base_rtt *
#: target_factor) that is not exact in f32
CONTROL_NSCC = {"base_rtt": 7.3, "target_factor": 1.1, "max_cwnd": 48.0}


def _u32s(rng, n) -> np.ndarray:
    return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _near(rng, centre: int, spread: int, n) -> np.ndarray:
    """uint32 values within ``spread`` of ``centre``, wrapping."""
    return ((centre + rng.integers(-spread, spread, n)) % 2 ** 32).astype(
        np.uint32)


def control_inputs(size: dict, seed: int = CONTROL_SEED) -> dict:
    """The control phase's inputs at ``size`` (``CONTROL_GOLDEN`` or
    ``CONTROL_REAL``), numpy arrays keyed ``part/name``, uint32 lanes as
    uint32. The same arrays feed the port here and the reference in
    ``scripts/torch_port_reference.py --which control``. Every batch
    holds repeated indices (slots, PDCs, members, peers, CCCs), ties, a
    few negative indices (which count from the end; none for the PSN
    rows, see below) and indices past the end (reads clamp, writes
    drop), and uint32 values >= 2**31."""
    rng = np.random.default_rng(seed)
    inp = {}
    # PSN tracking: R rounds of L lanes over N PDCs
    n, lanes, rounds = size["psn_n"], size["lanes"], size["rounds"]
    base0 = _u32s(rng, n)
    base0[::7] = _near(rng, 2 ** 32 - 40, 30, base0[::7].shape)
    inp["psn/base"] = base0
    for r in range(rounds):
        pdc = rng.integers(0, n, lanes)
        kind = rng.integers(0, 10, lanes)
        off = np.where(kind < 6, 4 * r + rng.integers(0, 6, lanes),
                       np.where(kind < 8, rng.integers(0, 1100, lanes),
                                4 * r - 1 - rng.integers(0, 8, lanes)))
        psn = ((base0[pdc].astype(np.int64) + off) % 2 ** 32).astype(
            np.uint32)
        dup = rng.random(lanes) < 0.05
        dup[0] = False
        src = np.where(dup, np.arange(lanes) - 1, np.arange(lanes))
        pdc, psn = pdc[src], psn[src]
        valid = rng.random(lanes) >= 0.05
        pdc = np.where(valid, pdc, rng.integers(-3 * n, 3 * n, lanes))
        # a few valid rows past the end (reads clamp, writes drop); no
        # negative valid row: the reference's dedup keys -1 apart from
        # N - 1 while its scatter aliases them, so two such lanes at one
        # bit carry into the next (ROADMAP.md queue 3)
        pdc = np.where(valid & (rng.random(lanes) < 0.002), pdc + n, pdc)
        inp[f"psn/pdc{r}"] = pdc.astype(np.int32)
        inp[f"psn/psn{r}"] = psn
        inp[f"psn/valid{r}"] = valid
    # the PDC pool: open, ACK, then every transition of both machines
    n = size["pdc_n"]
    k = n // 2
    slot = rng.integers(-n - 2, n + 2, k)
    slot[:6] = [n, n + 1, -n - 1, -1, 3, 3]   # past the end, wrapping, twice
    inp["pdc/open_slot"] = slot.astype(np.int32)
    inp["pdc/open_peer"] = rng.integers(0, 4096, k).astype(np.int32)
    inp["pdc/open_psn"] = _u32s(rng, k)
    inp["pdc/open_mode"] = rng.integers(0, 3, k).astype(np.int32)
    inp["pdc/ack_slot"] = rng.integers(0, n, n).astype(np.int32)
    inp["pdc/ack_remote"] = rng.integers(-1, 4096, n).astype(np.int32)
    inp["pdc/ack_n"] = rng.integers(0, 5, n).astype(np.int32)
    for r in range(6):
        for side, num in (("init", 8), ("tgt", 6)):
            ev = rng.integers(0, num, n)
            ev[rng.random(n) < 0.01] = -1      # counts from the end
            ev[rng.random(n) < 0.01] = num + 2  # clamps to the last
            inp[f"pdc/{side}_ev{r}"] = ev.astype(np.int32)
    # addressing: J jobs x P PIDonFEP x R RIs, two rows hold one JobID,
    # one row stays empty, then a slot past the end and slot -1
    jobs, pids, ris = size["jobs"], size["pids"], size["ris"]
    ids = rng.choice(1 << 24, jobs, replace=False)
    ids[jobs - 2] = ids[1]
    slots = list(rng.permutation(jobs)[:jobs - 1]) + [jobs, -1]
    inp["addr/slots"] = np.asarray(slots, np.int32)
    inp["addr/jobids"] = ids[np.asarray(slots) % jobs].astype(np.int32)
    for i in range(len(slots)):
        proc = rng.integers(0, jobs * pids, pids)
        proc[rng.random(pids) < 0.1] = -1
        ctx = rng.integers(0, 1 << 20, (pids, ris))
        ctx[rng.random((pids, ris)) < 0.1] = -1
        inp[f"addr/proc{i}"] = proc.astype(np.int32)
        inp[f"addr/ris{i}"] = ctx.astype(np.int32)
    svc = rng.integers(0, 1 << 20, 64)
    svc[rng.random(64) < 0.3] = -1
    inp["addr/service"] = svc.astype(np.int32)
    b = size["lanes"]
    known = rng.random(b) < 0.8
    inp["addr/jobid"] = np.where(known, ids[rng.integers(0, jobs, b)],
                                 rng.integers(0, 1 << 24, b)).astype(np.int32)
    inp["addr/pid"] = rng.integers(-2, pids + 2, b).astype(np.int32)
    inp["addr/ri"] = rng.integers(-1, ris + 1, b).astype(np.int32)
    inp["addr/rel"] = rng.integers(0, 2, b).astype(np.int32)
    # matching: E posted entries (exact and wildcard, posting-order ties),
    # B arrivals under each profile, consume, and HPC again
    e, b = size["entries"], size["arrivals"]
    post = np.concatenate([rng.permutation(e)[:e - e // 16],
                           rng.integers(0, e, e // 8)])
    kp = post.size
    comm, tag, sq = (rng.integers(0, 4, kp), rng.integers(0, 64, kp),
                     rng.integers(0, 16, kp))
    hi = (comm << 16) | (tag >> 8)
    lo = ((tag & 0xFF) << 24) | sq
    wild = rng.integers(0, 4, kp)
    wild[rng.random(kp) < 0.7] = 0
    mhi = np.select([wild == 1, wild == 2, wild == 3],
                    [0xFFFF, 0, 0xFFFF0000], 0)
    mlo = np.select([wild == 1, wild == 2, wild == 3],
                    [0xFFFFFFFF, 0xFFFFFF, 0], 0)
    init = np.where(rng.random(kp) < 0.5, 0xFFFFFFFF, rng.integers(0, 8, kp))
    inp["match/slot"] = post.astype(np.int32)
    inp["match/hi"] = hi.astype(np.uint32)
    inp["match/lo"] = lo.astype(np.uint32)
    inp["match/mhi"] = mhi.astype(np.uint32)
    inp["match/mlo"] = mlo.astype(np.uint32)
    inp["match/init"] = init.astype(np.uint32)
    inp["match/seq"] = rng.integers(0, max(e // 4, 1), kp).astype(np.int32)
    inp["match/buf"] = np.arange(kp, dtype=np.int32)
    pick = rng.integers(0, kp, b)
    kind = rng.integers(0, 4, b)
    khi = np.where(kind < 2, hi[pick], rng.integers(0, 4, b) << 16)
    klo = np.where(kind < 2, lo[pick], (rng.integers(0, 64, b) << 24)
                   | rng.integers(0, 16, b))
    khi = np.where(kind == 3, _u32s(rng, b), khi)
    inp["match/khi"] = khi.astype(np.uint32)
    inp["match/klo"] = klo.astype(np.uint32)
    inp["match/kinit"] = rng.integers(0, 8, b).astype(np.uint32)
    # TSS: M members, R rounds of L IVs, a rotation half way, the PSN
    # ratchet of P peers across 2**31 and 2**32
    m, lanes, rounds = size["members"], size["iv_lanes"], size["iv_rounds"]
    inp["tss/pkt_counter"] = np.where(
        rng.random(m) < 0.1, _near(rng, 2 ** 32 - 8, 8, m), _u32s(rng, m))
    kp = rng.integers(0, 1 << 20, m)
    sel = rng.random(m)
    kp = np.where(sel < 0.1, 2 ** 27 - rng.integers(0, 2 * rounds, m),
                  np.where(sel > 0.99, 2 ** 31 - 1 - rng.integers(
                      0, 2 * rounds, m), kp))
    inp["tss/key_packets"] = kp.astype(np.int32)
    for r in range(rounds):
        mem = rng.integers(0, m, lanes)
        mem[rng.random(lanes) < 0.002] = -1
        mem[:3] = [-1, 1, 1]
        inp[f"tss/member{r}"] = mem.astype(np.int32)
    p = size["peers"]
    inp["tss/start_psn"] = np.where(rng.random(p) < 0.05,
                                    _near(rng, 2 ** 32 - 100, 100, p),
                                    _near(rng, 2 ** 31, 2000, p))
    inp["tss/expected_psn"] = np.where(rng.random(p) < 0.05,
                                       _near(rng, 2 ** 32 - 100, 100, p),
                                       _near(rng, 2 ** 31, 2000, p))
    for r in range(4):
        inp[f"tss/close_peer{r}"] = rng.integers(0, p, p).astype(np.int32)
        last = _near(rng, 2 ** 31, 3000, p)
        last[rng.random(p) < 0.02] = 0xFFFFFFFF
        last[:2] = [0xFFFFFFFF, 0x7FFFFFFF]
        inp[f"tss/close_last{r}"] = last
        inp[f"tss/open_peer{r}"] = rng.integers(0, p, p).astype(np.int32)
        inp[f"tss/open_psn{r}"] = _near(rng, 2 ** 31, 3000, p)
    inp["tss/tx"] = (2_000_000_000 + rng.integers(-50, 50, p)).astype(
        np.int32)
    # NSCC: L ACKs over C CCCs, each CCC repeated 1-8 times, then loss
    # records and DFC penalties over repeated CCCs
    c, lanes = size["cccs"], size["lanes"]
    ccc = np.repeat(np.arange(c), rng.integers(1, 9, c))[:lanes]
    ccc = np.concatenate([ccc, rng.integers(0, c, lanes - ccc.size)])
    ccc = rng.permutation(ccc)
    odd = rng.random(lanes)
    ccc = np.where(odd < 0.001, -1 - rng.integers(0, 3, lanes),
                   np.where(odd > 0.999, c + rng.integers(0, 3, lanes), ccc))
    inp["nscc/cwnd"] = rng.uniform(0.5, 52.0, c).astype(np.float32)
    inp["nscc/epoch_acked"] = rng.integers(0, 100, c).astype(np.int32)
    inp["nscc/epoch_lost"] = rng.integers(0, 10, c).astype(np.int32)
    inp["nscc/ccc"] = ccc.astype(np.int32)
    inp["nscc/ecn"] = rng.random(lanes) < 0.4
    rtt = rng.uniform(0.0, 30.0, lanes).astype(np.float32)
    rtt[::97] = np.float32(7.3 * 1.1)
    inp["nscc/rtt"] = rtt
    inp["nscc/valid"] = rng.random(lanes) >= 0.05
    inp["nscc/loss_ccc"] = rng.integers(-2, c + 2, lanes).astype(np.int32)
    inp["nscc/loss_count"] = rng.integers(0, 4, lanes).astype(np.int32)
    inp["nscc/dfc_ccc"] = rng.permutation(ccc).astype(np.int32)
    inp["nscc/penalty"] = rng.uniform(-0.2, 1.2, lanes).astype(np.float32)
    return inp


def control_digest(inp: dict) -> str:
    """sha256 over the inputs' names, dtypes, shapes and bytes, in name
    order: the golden records it, so a changed generator shows."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(inp):
        a = np.ascontiguousarray(inp[k])
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _control_psn(inp: dict, size: dict, dev) -> dict:
    from repro_torch.core import pds, scatter
    out = {}
    n = size["psn_n"]
    t = pds.PSNTracker.create(n, 1024, device=dev)
    t = pds.PSNTracker(_i32(inp["psn/base"], dev), t.ring, t.rx_ok, t.dup,
                       t.oor)
    for r in range(size["rounds"]):
        pdc = torch.as_tensor(inp[f"psn/pdc{r}"]).to(dev)
        psn = _i32(inp[f"psn/psn{r}"], dev)
        valid = torch.as_tensor(inp[f"psn/valid{r}"]).to(dev)
        off = psn - scatter.gather(t.base, torch.where(valid, pdc, 0))
        mask, already = pds.or_mask(t.ring, pdc, off, valid)
        t, fresh = pds.record_rx(t, pdc, psn, valid)
        t, adv = pds.advance_cack(t)
        cack, lo, hi = pds.sack_view(t)
        for k, v in (("mask", mask), ("already", already), ("fresh", fresh),
                     ("adv", adv), ("cack", cack), ("lo", lo), ("hi", hi)):
            out[f"psn/{k}{r}"] = _np(v)
    for k in ("base", "ring", "rx_ok", "dup", "oor"):
        out[f"psn/{k}"] = _np(getattr(t, k))
    return out


def _control_pdc(inp: dict, size: dict, dev) -> dict:
    from repro_torch.core import pdc
    out = {}

    def lane(k):
        return _i32(inp[f"pdc/{k}"], dev)
    pool = pdc.PDCPool.create(size["pdc_n"], device=dev)
    pool = pdc.open_pdc(pool, lane("open_slot"), lane("open_peer"),
                        lane("open_psn"), lane("open_mode"))
    for k, v in vars(pool).items():
        out[f"pdc/open/{k}"] = _np(v)
    pool = pdc.on_ack(pool, lane("ack_slot"), lane("ack_remote"),
                      lane("ack_n"))
    for k, v in vars(pool).items():
        out[f"pdc/ack/{k}"] = _np(v)
    st, tg = pool.state, torch.zeros_like(pool.state)
    for r in range(6):
        st = pdc.step_initiator(st, lane(f"init_ev{r}"))
        tg = pdc.step_target(tg, lane(f"tgt_ev{r}"))
        out[f"pdc/init{r}"], out[f"pdc/tgt{r}"] = _np(st), _np(tg)
        out[f"pdc/send{r}"] = _np(pdc.may_send_data(st))
        out[f"pdc/accept{r}"] = _np(pdc.may_accept_new_message(st))
    return out


def _control_addr(inp: dict, size: dict, dev) -> dict:
    from repro_torch.core import addressing
    t = addressing.FEPTables.create(size["jobs"], size["pids"], size["ris"],
                                    device=dev)
    t = addressing.FEPTables(t.jobid_keys, t.jobid_to_pid, t.pid_table,
                             t.ri_table, _i32(inp["addr/service"], dev))
    for i, (slot, jobid) in enumerate(zip(inp["addr/slots"].tolist(),
                                          inp["addr/jobids"].tolist())):
        t = addressing.register_job(t, slot, jobid,
                                    _i32(inp[f"addr/proc{i}"], dev),
                                    _i32(inp[f"addr/ris{i}"], dev))
    ctx, ok = addressing.resolve(
        t, *(_i32(inp[f"addr/{k}"], dev) for k in ("jobid", "pid", "ri",
                                                    "rel")))
    out = {f"addr/{k}": _np(v) for k, v in vars(t).items()}
    out["addr/ctx"], out["addr/ok"] = _np(ctx), _np(ok)
    return out


def _control_match(inp: dict, size: dict, dev) -> dict:
    from repro_torch.core import matching
    from repro_torch.core.types import Profile
    q = matching.RecvQueue.create(size["entries"], device=dev)
    q = matching.post_receive(q, *(_i32(inp[f"match/{k}"], dev) for k in (
        "slot", "hi", "lo", "mhi", "mlo", "init", "seq", "buf")))
    out = {f"match/q/{k}": _np(v) for k, v in vars(q).items()}
    keys = [_i32(inp[f"match/{k}"], dev) for k in ("khi", "klo", "kinit")]
    for prof in Profile:
        slot, ok = matching.match(q, *keys, prof)
        out[f"match/{prof.name}/slot"] = _np(slot)
        out[f"match/{prof.name}/ok"] = _np(ok)
        if prof == Profile.AI_FULL:
            consumed = matching.consume(q, slot, ok)
    slot, ok = matching.match(consumed, *keys, Profile.HPC)
    out["match/consumed/valid"] = _np(consumed.valid)
    out["match/consumed/slot"], out["match/consumed/ok"] = _np(slot), _np(ok)
    return out


def _control_tss(inp: dict, size: dict, dev) -> dict:
    from repro_torch.core import tss
    out = {}
    sd = tss.SecureDomain.create(size["members"], seed=0x5D, device=dev)
    sd = tss.SecureDomain(sd.sdk, sd.iv_mask, sd.epoch + 3, sd.an,
                          _i32(inp["tss/pkt_counter"], dev),
                          _i32(inp["tss/key_packets"], dev))
    for r in range(size["iv_rounds"]):
        mem = _i32(inp[f"tss/member{r}"], dev)
        if r == size["iv_rounds"] // 2:
            sd = tss.rotate_key(sd)
        out[f"tss/key{r}"] = _np(tss.source_key(sd, mem))
        sd, iv_hi, iv_lo = tss.iv_for_packet(sd, mem)
        out[f"tss/iv_hi{r}"], out[f"tss/iv_lo{r}"] = _np(iv_hi), _np(iv_lo)
        out[f"tss/rot{r}"] = _np(tss.needs_key_rotation(sd))
        out[f"tss/rot_shared{r}"] = _np(tss.needs_key_rotation(sd, False))
    for k, v in vars(sd).items():
        out[f"tss/sd/{k}"] = _np(v)
    out["tss/kdf"] = _np(tss.kdf(sd.sdk, _i32(inp["tss/open_psn0"], dev),
                                 _i32(inp["tss/close_last0"], dev)))
    g = tss.PSNGuard(_i32(inp["tss/start_psn"], dev),
                     _i32(inp["tss/expected_psn"], dev))
    for r in range(4):
        g = tss.on_pdc_close(g, _i32(inp[f"tss/close_peer{r}"], dev),
                             _i32(inp[f"tss/close_last{r}"], dev))
        ok, nack = tss.accept_new_pdc(g, _i32(inp[f"tss/open_peer{r}"], dev),
                                      _i32(inp[f"tss/open_psn{r}"], dev))
        out[f"tss/accept{r}"], out[f"tss/nack{r}"] = _np(ok), _np(nack)
    out["tss/start_psn"] = _np(g.start_psn)
    out["tss/expected_psn"] = _np(g.expected_psn)
    out["tss/must_close"] = _np(tss.pdc_must_close(_i32(inp["tss/tx"], dev)))
    return out


def _control_nscc(inp: dict, size: dict, dev) -> dict:
    from repro_torch.core.cms import nscc
    p = nscc.NSCCParams(**CONTROL_NSCC)

    def lane(k):
        return torch.as_tensor(inp[f"nscc/{k}"]).to(dev)
    st = nscc.NSCCState(lane("cwnd"), lane("epoch_acked"),
                        lane("epoch_lost"), torch.zeros_like(
                            lane("epoch_lost")))
    out = {"nscc/case": _np(nscc.classify(lane("ecn"), lane("rtt"), p))}
    st = nscc.on_acks(st, p, lane("ccc"), lane("ecn"), lane("rtt"),
                      lane("valid"))
    out["nscc/acks_cwnd"] = _np(st.cwnd)
    st = nscc.on_loss(st, lane("loss_ccc"), lane("loss_count"),
                      lane("valid"))
    st = nscc.apply_dfc_penalty(st, p, lane("dfc_ccc"), lane("penalty"),
                                lane("valid"))
    for k, v in vars(st).items():
        out[f"nscc/{k}"] = _np(v)
    return out


CONTROL_RUNS = {"psn": _control_psn, "pdc": _control_pdc,
                "addr": _control_addr, "match": _control_match,
                "tss": _control_tss, "nscc": _control_nscc}


def run_control(inp: dict, size: dict, dev, parts=CONTROL_PARTS) -> dict:
    """Every part of the control batch through the port on ``dev``: the
    outputs as numpy arrays keyed ``part/name`` (uint32 lanes as their
    int32 patterns)."""
    out = {}
    for part in parts:
        out.update(CONTROL_RUNS[part](inp, size, dev))
    return out


def same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    """Shape and bytes equal, dtypes equal (an int32 pattern may stand
    for its uint32 lane)."""
    got, want = np.asarray(got), np.asarray(want)
    kinds = {got.dtype.kind, want.dtype.kind}
    return (got.shape == want.shape
            and (got.dtype == want.dtype or (
                kinds <= {"i", "u"}
                and got.dtype.itemsize == want.dtype.itemsize))
            and got.tobytes() == want.tobytes())


def _control_vs(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:8])
    for k in sorted(got):
        if not same_bits(got[k], want[k]):
            a, b = np.asarray(got[k]), np.asarray(want[k])
            bad = (np.flatnonzero(a.reshape(-1).view(np.uint8) !=
                                  b.reshape(-1).view(np.uint8))[:4]
                   if a.shape == b.shape and a.dtype.itemsize ==
                   b.dtype.itemsize else "shape/dtype")
            raise AssertionError(f"{what}: {k} differs ({a.dtype}{a.shape} "
                                 f"vs {b.dtype}{b.shape}; bytes {bad})")


def _load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _control_launches(tag: str, launches: dict, rounds: int) -> None:
    """One ``nack_mark`` per ``record_rx`` and per ``or_mask`` call, one
    ``sack_advance`` per ``advance_cack`` call, and no other kernel."""
    want = {k: 0 for k in launches}
    want["nack_mark"], want["sack_advance"] = 2 * rounds, rounds
    assert launches == want, f"control {tag}: launches {launches}, want {want}"


def phase_control(smi: str) -> dict:
    """Phase 8: the control plane on the card. (a) the port's transport
    tour against the JAX tour's values, (b) the golden-size seeded batch
    against the JAX golden, both from ``tests/golden/torch_port_control.npz``;
    (c) one endpoint at real scale on the card against the port's plain
    CPU path, part by part, bitwise; then the two kernels of its path
    timed at N = 65536, W = 32."""
    from repro_torch.kernels import ops, ref
    gold = np.load(CONTROL)
    out = {}
    # (a) the tour
    t0 = time.perf_counter()
    tour = _load_example("uet_transport_tour_torch")
    v = tour.tour(device=DEV)
    for k, val in v.items():
        want = gold[f"tour/{k}"].tolist()
        assert val == want, (k, val, want)
    assert "\n".join(tour.lines(v)).splitlines() == \
        gold["tour_lines"].tolist(), "the tour's printed lines"
    out["tour_s"] = time.perf_counter() - t0
    say("8 control", f"(a) tour(device={DEV!r}): {len(v)} values and its "
        f"printed lines == the JAX tour's ({out['tour_s']:.2f} s)")
    # (b) the golden-size batch
    inp = control_inputs(CONTROL_GOLDEN)
    assert control_digest(inp) == str(gold["inputs_sha256"]), \
        "control_inputs no longer makes the golden's inputs"
    got, secs, peak, launches = _timed_batch(
        lambda: run_control(inp, CONTROL_GOLDEN, DEV))
    _control_vs(got, {k[6:]: gold[k] for k in gold.files
                      if k.startswith("batch/")}, "control golden batch")
    _control_launches("b", launches, CONTROL_GOLDEN["rounds"])
    out["b"] = {"seconds": secs, "peak_bytes": peak, "launches": launches,
                "lanes": len(got)}
    say("8 control", f"(b) golden-size batch {CONTROL_GOLDEN}: {len(got)} "
        f"output lanes bitwise the JAX golden ({secs:.2f} s, peak "
        f"{peak} B); launches nack_mark {launches['nack_mark']}, "
        f"sack_advance {launches['sack_advance']}")
    # (c) one endpoint at real scale, card against the plain CPU path
    inp = control_inputs(CONTROL_REAL)
    total = {k: 0 for k in ops.LAUNCHES}
    for part in CONTROL_PARTS:
        got, secs, peak, launches = _timed_batch(
            lambda: CONTROL_RUNS[part](inp, CONTROL_REAL, DEV))
        t0 = time.perf_counter()
        want = CONTROL_RUNS[part](inp, CONTROL_REAL, "cpu")
        cpu_s = time.perf_counter() - t0
        _control_vs(got, want, f"control real {part}")
        if part == "psn":
            _control_launches("c", launches, CONTROL_REAL["rounds"])
        else:
            assert not any(launches.values()), (part, launches)
        for k, n in launches.items():
            total[k] += n
        out[part] = {"seconds": secs, "cpu_seconds": cpu_s,
                     "peak_bytes": peak, "launches": launches}
        say("8 control", f"(c) {part}: card {secs:.3f} s, peak {peak} B, "
            f"plain CPU path {cpu_s:.3f} s; bitwise equal ({len(got)} "
            f"lanes); {smi}")
    out["launches"] = {k: total[k] + out["b"]["launches"][k]
                       for k in total}
    # the path's two kernels at the endpoint's shapes, timed
    n, w, lanes = CONTROL_REAL["psn_n"], 32, CONTROL_REAL["lanes"]
    rng = np.random.default_rng(21)
    ring, base, _, _ = _sack_inputs(rng, n, w, DEV)
    nrtx, flow, off, valid = _nack_inputs(rng, n, w, lanes, DEV)
    rows = {}
    for name, kern, plain, args, nbytes, nops in (
            ("nack_mark", ops.nack_mark_cuda, ref.nack_mark_ref,
             (nrtx, flow, off, valid), 2 * n * w * 4 + lanes * (4 + 4 + 1),
             8 * lanes),
            ("sack_advance", ops.sack_advance_cuda, ref.sack_advance_ref,
             (ring, base), (n * w + n) * 4 + (n * w + 2 * n) * 4,
             16 * n * w)):
        got, want = kern(*args), plain(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        _assert_equal(got, want, f"{name} at the endpoint's shapes")
        rows[name] = {"n": n, "w": w, "max_abs_err": _max_abs_err(got, want),
                      **_time_row(name, kern, plain, args, nbytes, nops)}
        r = rows[name]
        say("8 control", f"{name} at N={n}, W={w}"
            f"{f', L={lanes}' if name == 'nack_mark' else ''}: bitwise "
            f"equal to plain; kernel {r['ms'] * 1e3:.2f} us (device "
            f"{r['device_ms'] * 1e3:.3f} us), plain {r['plain_ms'] * 1e3:.2f}"
            f" us, bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}, "
            f"{r['bytes']} B); {smi}")
    out["rows"] = rows
    return out


# ------------------------------------------------------------- serving --

LM = ROOT / "tests" / "golden" / "torch_port_lm.npz"
#: phase 9 (a): the ten archs at ``configs.reduced`` widths, f32; at seq
#: 24 mixtral-8x22b's window is 16 (``configs.reduced``), so its ring
#: cache wraps
LM_GOLDEN = {"batch": 2, "seq": 24, "seed": 0x5E7}
#: atol of a logit, aux or cache lane against the golden (rtol 1e-4):
#: ``tests/test_decode_parity.py``'s, 2e-4 dense (attention, RWKV) and
#: 5e-3 where MoE routing or Mamba's exp chain takes part
LM_ATOL = {"dense": 2e-4, "moe": 5e-3}
LM_RTOL = 1e-4
#: phase 9 (b) / (c): mixtral-8x22b at full width, depth cut 56 -> 2
LM_ARCH = "mixtral-8x22b"
LM_FULL_LAYERS = 2
LM_SEED = 0x5E7
#: (b): T = B * S = 8 tokens, so no expert can get more than its
#: capacity of 8 (``lm.moe_capacity``): the full forward cannot drop
LM_PARITY = {"batch": 2, "seq": 4}
#: (b): a forward whose capacity drops are counted and printed
LM_CENSUS = {"batch": 2, "seq": 512}
#: (b): one attention layer alone, decoded through a ring cache of
#: min(S, window) = 4096 slots: positions 0-5119, the last 1024 wrap it
LM_RING = {"batch": 2, "seq": 5120}
#: (c): the bf16 served run
LM_SERVE = {"batch": 8, "prompt": 1024, "new": 128}
#: (d): the priced decode step
LM_RATE = {"dp": 4, "tp": 4, "layout": "tp_only", "shape": "decode_32k"}


def lm_family(cfg) -> str:
    """``"moe"`` where MoE routing or a Mamba mixer takes part, else
    ``"dense"`` (the key of ``LM_ATOL``)."""
    return ("moe" if cfg.num_experts or any(m == "mamba"
                                            for m, _ in cfg.pattern)
            else "dense")


def lm_inputs(arch: str, size: dict = LM_GOLDEN) -> "tuple[dict, np.ndarray]":
    """Phase 9 (a)'s params ({path: f32 array} over the tree of
    ``lm.param_shapes``, drawn with numpy from ``size["seed"]``, path by
    path in name order) and [B, S] int32 tokens of ``configs.reduced(arch,
    seq=S)``. Norm scales near 1, mixes in (0.1, 0.9), decay biases in
    (-7, -5), Mamba's ``a_log`` near log(1..N), the embedding at 0.02 and
    every other matrix at fan-in ** -0.5."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.reduced(arch, seq=size["seq"])
    rng = np.random.default_rng(size["seed"])
    out = {}
    for path, (shape, _) in sorted(lm.param_shapes(cfg, torch.float32)
                                   .items()):
        name = path.rsplit("/", 1)[-1]
        if name == "scale":
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "mix":
            a = rng.uniform(0.1, 0.9, shape)
        elif name == "decay_bias":
            a = rng.uniform(-7, -5, shape)
        elif name == "a_log":
            a = (np.log(np.arange(1, shape[-1] + 1))
                 + 0.1 * rng.standard_normal(shape))
        elif name in ("bonus", "dt_bias"):
            a = 0.1 * rng.standard_normal(shape)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        out[path] = a.astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (size["batch"], size["seq"]))
    return out, toks.astype(np.int32)


def run_lm(arch: str, dev, size: dict = LM_GOLDEN) -> dict:
    """One arch of phase 9 (a) on the port: the full forward's logits and
    aux, every decode step's logits (``make_decode_step`` from an empty
    cache of S slots) and the final cache ({name: numpy array})."""
    from repro_torch import configs, convert
    from repro_torch.models import lm
    from repro_torch.serve.serve_step import make_decode_step
    cfg = configs.reduced(arch, seq=size["seq"])
    arrays, toks = lm_inputs(arch, size)
    params = convert.lm_params_from_numpy(cfg, arrays, dev)
    toks = torch.as_tensor(toks, device=dev)
    logits, aux, _ = lm.build_forward(cfg, remat=False)(params, toks)
    step = make_decode_step(cfg)
    B, S = toks.shape
    cache = lm.init_cache(cfg, B, S, torch.float32, device=dev)
    outs = []
    for i in range(S):
        lg, cache = step(params, cache, toks[:, i:i + 1], i)
        outs.append(lg)
    out = {"logits": _np(logits), "aux": _np(aux),
           "decode": _np(torch.stack(outs, 1))}
    out.update({f"cache/{k}": v
                for k, v in convert.lm_cache_to_numpy(cache).items()})
    return out


def lm_vs_golden(arch: str, got: dict, gold) -> float:
    """Every output of ``run_lm`` against the golden's: floats within
    ``LM_ATOL`` / ``LM_RTOL``, integer and bool lanes equal. Returns the
    largest absolute error."""
    from repro_torch import configs
    cfg = configs.reduced(arch, seq=LM_GOLDEN["seq"])
    atol = LM_ATOL[lm_family(cfg)]
    keys = {k[len(arch) + 1:] for k in gold.files
            if k.startswith(f"{arch}/") and k[len(arch) + 1:] not in (
                "params_sha256", "tokens")}
    assert keys == set(got), (arch, sorted(keys ^ set(got)))
    worst = 0.0
    for k in sorted(keys):
        want, have = gold[f"{arch}/{k}"], got[k]
        assert want.shape == have.shape, (arch, k, want.shape, have.shape)
        if want.dtype.kind == "f":
            err = np.abs(have.astype(np.float64) - want)
            bad = err > atol + LM_RTOL * np.abs(want)
            assert not bad.any(), (arch, k, float(err.max()), atol)
            worst = max(worst, float(err.max()))
        else:
            assert np.array_equal(have, want), (arch, k)
    return worst


def lm_golden_phase(dev) -> dict:
    """Phase 9 (a): the ten archs against ``tests/golden/torch_port_lm.npz``
    on ``dev``; per arch its largest error and seconds."""
    from repro_torch import configs
    gold = np.load(LM)
    out = {}
    for arch in configs.ARCH_NAMES:
        arrays, toks = lm_inputs(arch)
        assert control_digest({**arrays, "tokens": toks}) == \
            str(gold[f"{arch}/params_sha256"]), \
            f"lm_inputs({arch!r}) no longer makes the golden's inputs"
        t0 = time.perf_counter()
        got = run_lm(arch, dev)
        secs = time.perf_counter() - t0
        out[arch] = {"max_abs_err": lm_vs_golden(arch, got, gold),
                     "seconds": secs}
    return out


def attention_ring(cfg, size: dict, dev, seed: int) -> dict:
    """Phase 9 (b)'s layer check: one attention layer of ``cfg``
    (``L.init_attention``, f32, drawn from ``seed`` on ``dev``) over
    [B, S, d_model] N(0, 1) inputs, decoded token by token through a ring
    cache of min(S, window) slots and held at every step against the
    full-sequence (flash) form of the same inputs, within
    ``LM_ATOL["dense"]`` / ``LM_RTOL``. No MoE, so nothing drops. Returns
    the largest absolute error and output."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = L.init_attention(gen, cfg.d_model, cfg.n_q, cfg.n_kv, cfg.head_dim,
                         torch.float32, dev)
    B, S = size["batch"], size["seq"]
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    kw = dict(n_q=cfg.n_q, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, window=cfg.sliding_window)
    full, _ = L.attention_fwd(p, x, pos, **kw)
    C = min(S, cfg.sliding_window) if cfg.sliding_window else S
    cache = L.init_attention_cache(B, cfg.n_kv, C, cfg.head_dim,
                                   torch.float32, dev)
    dec = torch.empty_like(full)
    for i in range(S):
        out, cache = L.attention_fwd(p, x[:, i:i + 1], pos[i:i + 1],
                                     cache=cache, **kw)
        dec[:, i] = out[:, 0]
    err = (dec - full).abs()
    bad = err > LM_ATOL["dense"] + LM_RTOL * full.abs()
    assert not bool(bad.any()), (
        "decode through the ring disagrees with the full form at "
        f"position {int(bad.any(0).any(-1).nonzero()[0])}", float(err.max()))
    # the ring held the last C positions
    assert sorted(cache["pos"].tolist()) == list(range(S - C, S))
    return {"cache_slots": C, "max_abs_err": float(err.max()),
            "max_abs_out": float(full.abs().max())}


def _full_cfg():
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(LM_ARCH),
                               num_layers=LM_FULL_LAYERS)


def _tokens(cfg, size: dict, seed: int):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (size["batch"], size["seq"]),
                         generator=gen, device=DEV, dtype=torch.int32)


def _param_bytes(params: dict) -> int:
    from repro_torch.models import lm
    return sum(v.numel() * v.element_size()
               for v in lm.flatten(params).values())


def phase_serving(smi: str) -> dict:
    """Phase 9: the LM substrate's serving path on the card. (a) the ten
    reduced archs against the golden, f32; (b) mixtral-8x22b at full
    width, f32: the decode step against the full forward with no
    capacity drop, and one attention layer decoded through its wrapping
    ring against its full form; (c) the same in bf16: prefill and greedy decode,
    timed; (d) ``serving_rate`` against the golden, with the tick
    kernels' launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.serve_step import (make_decode_step, make_prefill,
                                              serving_rate)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {}
    # (a) the ten reduced archs against the golden
    res, secs, peak, launches = _timed_batch(lambda: lm_golden_phase(DEV))
    assert not any(launches.values()), launches
    out["a"] = {"archs": res, "seconds": secs, "peak_bytes": peak}
    errs = {k: float(f"{v['max_abs_err']:.3g}") for k, v in res.items()}
    say("9 serving", f"(a) ten reduced archs (B={LM_GOLDEN['batch']}, "
        f"S={LM_GOLDEN['seq']}, f32, TF32 off): full-forward logits and "
        f"aux, {LM_GOLDEN['seq']} decode steps and the final cache within "
        f"{LM_ATOL} (rtol {LM_RTOL}) of the JAX golden; largest errors "
        f"{errs} ({secs:.2f} s, peak {peak} B)")
    # (b) full width, f32: decode against the full forward
    cfg = _full_cfg()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, LM_SEED, torch.float32, device=DEV)
    drops: list = []
    fwd = lm.build_forward(cfg, remat=False, moe_drops=drops)
    census_logits, _, _ = fwd(params, _tokens(cfg, LM_CENSUS, LM_SEED))
    census = [int(d) for d in drops]
    assert bool(torch.isfinite(census_logits).all())
    del census_logits
    drops.clear()
    toks = _tokens(cfg, LM_PARITY, LM_SEED + 1)
    full, aux, _ = fwd(params, toks)
    assert sum(int(d) for d in drops) == 0, drops
    step = make_decode_step(cfg)
    B, S = toks.shape
    cache = lm.init_cache(cfg, B, S, torch.float32, device=DEV)
    worst = 0.0
    for i in range(S):
        lg, cache = step(params, cache, toks[:, i:i + 1], i)
        err = (lg - full[:, i]).abs()
        assert bool((err <= LM_ATOL["moe"]
                     + LM_RTOL * full[:, i].abs()).all()), (i, float(
                         err.max()))
        worst = max(worst, float(err.max()))
    torch.cuda.synchronize()
    assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
    out["b"] = {"param_bytes": _param_bytes(params), "census": census,
                "parity_max_abs_err": worst, "aux": float(aux),
                "seconds": time.perf_counter() - t0,
                "peak_bytes": torch.cuda.max_memory_allocated()}
    say("9 serving", f"(b) {LM_ARCH} full width (d_model {cfg.d_model}, "
        f"{cfg.n_q}/{cfg.n_kv} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.num_experts} experts top-{cfg.experts_per_token}, SWA "
        f"{cfg.sliding_window}, vocab {cfg.vocab}), R={cfg.repeats}, f32 "
        f"({out['b']['param_bytes']} B of params): the full forward at "
        f"B={LM_CENSUS['batch']}, S={LM_CENSUS['seq']} drops {census} "
        f"assignments over capacity (per MoE layer); at B={B}, S={S} it "
        f"drops 0 and the decode step matches it at every step, largest "
        f"error {worst:.3g} (atol {LM_ATOL['moe']}, rtol {LM_RTOL}); "
        f"{out['b']['seconds']:.2f} s, peak {out['b']['peak_bytes']} B")
    del params, fwd, full, cache, lg
    torch.cuda.empty_cache()
    # (b) the attention layer alone at full width, far into the ring
    t0 = time.perf_counter()
    ring = attention_ring(cfg, LM_RING, DEV, LM_SEED + 3)
    torch.cuda.synchronize()
    assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
    out["b"]["ring"] = {**ring, "seconds": time.perf_counter() - t0}
    say("9 serving", f"(b) one {LM_ARCH} attention layer at full width, "
        f"f32, B={LM_RING['batch']}: {LM_RING['seq']} tokens decoded one by "
        f"one through a ring of {ring['cache_slots']} slots (SWA "
        f"{cfg.sliding_window}) match its full-sequence form at every "
        f"step, largest error {ring['max_abs_err']:.3g} on outputs up to "
        f"{ring['max_abs_out']:.3g} (atol {LM_ATOL['dense']}, rtol "
        f"{LM_RTOL}); {out['b']['ring']['seconds']:.2f} s")
    torch.cuda.empty_cache()
    # (c) the served run in bf16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, LM_SEED, torch.bfloat16, device=DEV)
    nbytes = _param_bytes(params)
    Bs, P, N = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["new"]
    prompts = _tokens(cfg, {"batch": Bs, "seq": P}, LM_SEED + 2)
    prefill = make_prefill(cfg)
    t0 = time.perf_counter()
    first = prefill(params, prompts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        last = prefill(params, prompts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_s = sorted(times)[1]
    assert bool(torch.isfinite(last.float()).all())
    assert torch.equal(first, last)
    # the prompt through the decode step into the cache, then greedy
    # decode: the serving example's loop
    r = _load_example("serve_decode_torch").generate(cfg, params, prompts, N)
    feed_s, decode_s = r["prefill_s"], r["decode_s"]
    assert bool(torch.isfinite(r["logits"].float()).all())
    assert int(r["ids"].min()) >= 0 and int(r["ids"].max()) < cfg.vocab
    assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the least a decode step can take: every weight but the embedding's
    # unread rows read once, over the card's memory rate
    step_bytes = nbytes - params["embed"].numel() * 2
    out["c"] = {"param_bytes": nbytes, "prefill_first_s": first_s,
                "prefill_s": prefill_s,
                "prefill_tokens_per_s": Bs * P / prefill_s,
                "feed_ms_per_step": feed_s / P * 1e3,
                "decode_ms_per_step": decode_s / N * 1e3,
                "decode_tokens_per_s": Bs * N / decode_s,
                "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
                "peak_bytes": peak, "nvidia_smi": smi}
    c = out["c"]
    say("9 serving", f"(c) {LM_ARCH} full width, R={cfg.repeats}, bf16 "
        f"({nbytes} B of params): make_prefill B={Bs} S={P} "
        f"{prefill_s * 1e3:.1f} ms ({c['prefill_tokens_per_s']:.0f} "
        f"tokens/s; first call {first_s * 1e3:.1f} ms); the prompt fed "
        f"token by token {c['feed_ms_per_step']:.3f} ms/step, then {N} "
        f"greedy tokens {c['decode_ms_per_step']:.3f} ms/step "
        f"({c['decode_tokens_per_s']:.0f} tokens/s; the weights' bytes "
        f"over {HBM_BYTES_PER_S / 1e12} TB/s bound a step at "
        f"{c['decode_bound_ms']:.3f} ms); peak {peak} B; {smi}")
    del params, r, last, first
    torch.cuda.empty_cache()
    # (d) serving_rate on the simulated fabric, against the golden
    from repro_torch import configs
    from repro_torch.network import traffic
    gold = np.load(LM)
    with _Capture(traffic, "simulate") as cap:
        rate, secs, peak, launches = _timed_batch(
            lambda: serving_rate(configs.get(LM_ARCH), **LM_RATE,
                                 device=DEV))
    got = lm.flatten(rate, "serve/")
    assert set(got) == {k for k in gold.files if k.startswith("serve/")}
    for k, v in got.items():
        assert v == gold[k].item(), (k, v, gold[k])
    (r,) = cap.results
    _launches_per_group("serving", launches, {("g", "ai_full"): r.horizon})
    out["d"] = {"rate": rate, "seconds": secs, "peak_bytes": peak,
                "launches": launches, "horizon": r.horizon}
    say("9 serving", f"(d) serving_rate({LM_ARCH}, {LM_RATE}): "
        f"{rate['sim_ticks']} ticks, modelled {rate['tokens_per_sec_served']!r}"
        f" tokens/s served, step {rate['step_s']!r} s (priced with the "
        f"reference's modelled accelerator), eff {rate['eff']}; == the JAX "
        f"golden ({secs:.2f} s); launches {launches}")
    out["launches"] = launches
    return out



# ------------------------------------------------------------ training --

TRAIN = ROOT / "tests" / "golden" / "torch_port_train.npz"
#: phase 10 (a): the ten archs at ``configs.reduced`` widths, f32, two
#: steps of ``make_train_step`` on one batch
TRAIN_GOLDEN = {"batch": 2, "seq": 16, "seed": 0x7A1}
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 1}
#: entries of each leaf sampled into the golden (seeded by the path)
TRAIN_SAMPLE = 256
#: tolerance of a metric (relative) and of a gradient or moment sample
#: (relative to the largest magnitude of the leaf's sample) against the
#: golden: 1e-4 dense; 5e-3 where MoE routing or Mamba's exp chain takes
#: part (jamba's forward alone sits 1.9e-3 from JAX's by the reference's
#: own rounding sensitivity, PERF.md)
TRAIN_RTOL = {"dense": 1e-4, "moe": 5e-3}
#: archs whose step 2 is chaotic in the reference itself: step 1's Adam
#: update is g / |g|, so wherever a gradient sits near 0 a rounding flips
#: it by two learning rates, and jamba's Mamba chain amplifies that. An
#: ulp of noise on JAX's own embedding moves its step-2 grad norm by
#: 2.9 % and its moments after step 2 by 9.6 % (m) and 17.5 % (v) of a
#: leaf's largest; the card's f32 GEMM order moves the port's by 9.8 %,
#: 36.5 % and 34.8 % (``tests/test_torch_train_jamba.py``; PERF.md). So
#: for these the step-2 grad norm and moments are only required finite
#: (their gap is reported), and the params after step 2 are held to the
#: two-learning-rate bound; step 1 and step 2's loss, ce and aux are held
#: as every arch's
TRAIN_CHAOTIC = ("jamba-1.5-large-398b",)
#: params after step 2: Adam's update is sign-like where a gradient is
#: near 0 (step 1's is g / |g|), so an entry may move by up to two
#: learning rates either way; where the step-1 gradient and the step-2
#: first moment clear their tolerance by this factor, the update's error
#: is under 4 / factor of the learning rates
TRAIN_CLEAR = 10.0
#: phase 10 (b): mixtral-8x22b at full width, depth cut 56 -> 1
TRAIN_ARCH = "mixtral-8x22b"
TRAIN_LAYERS = 1
TRAIN_SEED = 0x7A1
#: (b) 1: the f32 backward against central differences at B = 1, S = 1024,
#: on the base point's branch of the piecewise capacity dispatch (every
#: token routed to the base's experts, so the same drops): along the
#: gradient's own direction a step that moves the loss by ``eta``, within
#: ``rtol`` (the f32 loss's ulp, ~1e-6, over the step); along a Gaussian
#: direction on expert 0's ``w_down`` by ``eta_leaf`` and half that,
#: Richardson-extrapolated, within ``rtol_leaf`` (the step is a quarter
#: of the weights' scale)
TRAIN_FD = {"batch": 1, "seq": 1024, "eta": 1e-2, "eta_leaf": 1e-3,
            "rtol": 1e-3, "rtol_leaf": 1e-2}
#: (b) 2: bf16 params, f32 moments, ``launch/train.py``'s optimizer
TRAIN_RUN = {"batch": 1, "seq": 4096, "steps": 6,
             "opt": {"lr": 1e-3, "warmup_steps": 20}}
#: the card's dense bf16 peak (NVIDIA's data sheet, H100 SXM, 700 W)
BF16_PEAK = 989e12
#: (c) the trainer drill at reduced size
TRAIN_DRILL = {"arch": "glm4-9b", "batch": 2, "seq": 16, "steps": 10,
               "ckpt_every": 2, "poison_call": 7}
#: (d) the roofline's UET derates
TRAIN_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
TRAIN_DERATE = {"hosts": 8, "size_pkts": 64}
#: (e) gradient compression of one 2**24-element f32 tensor
TRAIN_COMPRESS = {"n": 1 << 24, "seed": 0xC0DE}


def train_inputs(arch: str, size: dict = TRAIN_GOLDEN
                 ) -> "tuple[dict, dict]":
    """Phase 10 (a)'s params (``lm_inputs``' draws at ``size``) and one
    batch of numpy arrays: the tokens (or, for the vit_stub frontend,
    [B, S, d_model] N(0, 1) embeds) and [B, S] int32 labels."""
    from repro_torch import configs
    cfg = configs.reduced(arch, seq=size["seq"])
    arrays, toks = lm_inputs(arch, size)
    rng = np.random.default_rng(size["seed"] + 1)
    B, S = toks.shape
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    inputs = (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
              if cfg.frontend == "vit_stub" else toks)
    return arrays, {"inputs": inputs, "labels": labels}


def train_sample(path: str, n: int, full: bool = False) -> np.ndarray:
    """The flat indices of leaf ``path`` (``n`` entries) in the golden:
    all of them (or ``full``), else ``TRAIN_SAMPLE`` drawn from a seed of
    the path."""
    import zlib
    if full or n <= TRAIN_SAMPLE:
        return np.arange(n)
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    return np.sort(rng.choice(n, TRAIN_SAMPLE, replace=False))


def train_record(metrics1: dict, metrics2: dict, grads: dict,
                 params: dict, m: dict, v: dict, full: bool = False) -> dict:
    """Phase 10 (a)'s record of one arch, from {path: numpy array} trees
    (grads of step 1; params and moments after step 2) and each step's
    metrics: both steps' metrics, each leaf's gradient sum of squares
    (f64) and the sampled entries (every entry if ``full``)."""
    out = {f"s{i}/{k}": np.asarray(v_, np.float32)
           for i, mt in ((1, metrics1), (2, metrics2))
           for k, v_ in mt.items()}
    for path, g in grads.items():
        g = np.asarray(g, np.float32)
        idx = train_sample(path, g.size, full)
        out[f"grad_sumsq/{path}"] = np.sum(np.square(g.astype(np.float64)))
        out[f"grad/{path}"] = g.reshape(-1)[idx]
        for tag, tree in (("param", params), ("m", m), ("v", v)):
            out[f"{tag}/{path}"] = np.asarray(tree[path],
                                              np.float32).reshape(-1)[idx]
    return out


def run_train(arch: str, dev, size: dict = TRAIN_GOLDEN,
              full: bool = False, **step_kw) -> dict:
    """One arch of phase 10 (a) on the port: two steps of
    ``make_train_step`` (``TRAIN_OPT``, ``step_kw``) on
    ``train_inputs``, recorded as ``train_record`` names it."""
    from repro_torch import configs, convert
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                              value_and_grad)
    cfg = configs.reduced(arch, seq=size["seq"])
    arrays, batch = train_inputs(arch, size)
    params = convert.lm_params_from_numpy(cfg, arrays, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    ocfg = AdamWConfig(**TRAIN_OPT)
    opt = init_opt_state(params, ocfg)
    loss_kw = {k: v for k, v in step_kw.items() if k != "microbatches"}
    _, _, _, grads = value_and_grad(make_loss_fn(cfg, **loss_kw), params,
                                    batch)
    grads = convert.lm_params_to_numpy(grads)
    step = make_train_step(cfg, opt_cfg=ocfg, **step_kw)
    ms = []
    for _ in range(2):
        params, opt, mt = step(params, opt, batch)
        ms.append({k: _np(v) for k, v in mt.items()})
    st = convert.lm_opt_state_to_numpy(opt)
    return train_record(ms[0], ms[1], grads, convert.lm_params_to_numpy(
        params), {k[2:]: a for k, a in st.items() if k.startswith("m/")},
        {k[2:]: a for k, a in st.items() if k.startswith("v/")}, full)


def train_vs(arch: str, got: dict, want: dict, family: str,
             params0: dict, full: bool = False) -> dict:
    """``run_train``'s record against the reference's: metrics within
    ``TRAIN_RTOL``, each leaf's gradient sum of squares within twice it,
    gradient and moment samples within it times the sample's largest
    magnitude, params after step 2 as ``TRAIN_CLEAR`` says (``params0``:
    {path: numpy array} at step 0); for ``TRAIN_CHAOTIC`` archs the
    step-2 grad norm and moments only finite. Returns the largest errors,
    each relative to its own tolerance (and the unheld gaps)."""
    rtol = TRAIN_RTOL[family]
    chaotic = arch in TRAIN_CHAOTIC
    assert set(got) == set(want), (arch, sorted(set(got) ^ set(want))[:6])
    worst = {"metric": 0.0, "grad": 0.0, "moment": 0.0, "param": 0.0}
    unheld = {}
    for i in (1, 2):
        for k in ("loss", "ce", "moe_aux", "grad_norm"):
            g, w = float(got[f"s{i}/{k}"]), float(want[f"s{i}/{k}"])
            assert math.isfinite(g), (arch, f"s{i}/{k}", g)
            err = abs(g - w) / (rtol * abs(w) + 1e-7)
            if chaotic and i == 2 and k == "grad_norm":
                unheld[k] = abs(g - w) / abs(w)
                continue
            assert err <= 1, (arch, f"s{i}/{k}", g, w, rtol)
            worst["metric"] = max(worst["metric"], err)
    lrs = [TRAIN_OPT["lr"] * min(t / max(TRAIN_OPT["warmup_steps"], 1), 1.0)
           for t in (1, 2)]
    for key in sorted(k for k in want if k.startswith("grad/")):
        path = key[5:]
        sq_g, sq_w = float(got["grad_sumsq/" + path]), \
            float(want["grad_sumsq/" + path])
        assert abs(sq_g - sq_w) <= 2 * rtol * sq_w + 1e-30, \
            (arch, path, "sum of squares", sq_g, sq_w)
        tols = {}
        for tag, kind in (("grad", "grad"), ("m", "moment"),
                          ("v", "moment")):
            g = got[f"{tag}/{path}"].astype(np.float64)
            w = want[f"{tag}/{path}"].astype(np.float64)
            assert np.isfinite(g).all(), (arch, tag, path)
            err = np.abs(g - w)
            if chaotic and tag != "grad":
                tols[tag] = math.inf
                unheld[tag] = max(unheld.get(tag, 0.0), float(
                    err.max() / max(np.abs(w).max(), 1e-30)))
                continue
            tols[tag] = tol = rtol * float(np.abs(w).max())
            assert (err <= tol).all(), (arch, tag, path, float(err.max()),
                                        tol)
            if tol > 0:
                worst[kind] = max(worst[kind], float(err.max()) / tol)
        g1 = want["grad/" + path].astype(np.float64)
        m2 = want["m/" + path].astype(np.float64)
        p0 = params0[path].reshape(-1)[train_sample(
            path, params0[path].size, full)].astype(np.float64)
        gp = got["param/" + path].astype(np.float64)
        wp = want["param/" + path].astype(np.float64)
        err = np.abs(gp - wp)
        ulp = 4 * np.spacing(np.abs(wp).astype(np.float32)).astype(
            np.float64)
        # any entry: two sign-like updates either way, and rounding
        wd = 0.1 * np.abs(p0) * 2 * sum(lrs) * rtol
        loose = 2 * 2 * sum(lrs) + wd + ulp
        assert (err <= loose).all(), (arch, "param", path, float(err.max()))
        clear = (np.abs(g1) >= TRAIN_CLEAR * tols["grad"]) & \
            (np.abs(m2) >= TRAIN_CLEAR * tols["m"])
        tight = 4 / TRAIN_CLEAR * sum(lrs) + wd + ulp
        assert (err[clear] <= tight[clear]).all(), \
            (arch, "param (clear entries)", path, float(err[clear].max()))
        if clear.any():
            worst["param"] = max(worst["param"],
                                 float((err[clear] / tight[clear]).max()))
    if chaotic:
        worst["step2_unheld"] = unheld
    return worst


def train_golden_phase(dev) -> dict:
    """Phase 10 (a): the ten archs against
    ``tests/golden/torch_port_train.npz`` on ``dev``."""
    from repro_torch import configs
    gold = np.load(TRAIN)
    out = {}
    for arch in configs.ARCH_NAMES:
        arrays, batch = train_inputs(arch)
        assert control_digest({**arrays, **batch}) == \
            str(gold[f"{arch}/inputs_sha256"]), \
            f"train_inputs({arch!r}) no longer makes the golden's inputs"
        want = {k[len(arch) + 1:]: gold[k] for k in gold.files
                if k.startswith(f"{arch}/") and not k.endswith("_sha256")}
        t0 = time.perf_counter()
        got = run_train(arch, dev)
        secs = time.perf_counter() - t0
        cfg = configs.reduced(arch, seq=TRAIN_GOLDEN["seq"])
        out[arch] = {**train_vs(arch, got, want, lm_family(cfg), arrays),
                     "seconds": secs}
    return out


class _Routes:
    """Record the MoE's top-k expert choices of every forward while it
    runs (``layers.top_k_low_first``); with ``held``, a list of earlier
    choices (one per call, in order), route every token to those instead
    (the gates are the probabilities at the held experts) and count the
    tokens whose own choice differs (``moved``)."""

    def __init__(self, held: "list | None" = None):
        self.held, self.moved, self.routes, self.gaps = held, 0, [], []

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.orig = L, L.top_k_low_first

        def top_k(probs, k):
            vals, idx = self.orig(probs, k)
            if L.recomputing():
                return vals, idx
            if self.held is not None:
                held = self.held[len(self.routes)]
                self.moved += int((idx != held).any(-1).sum())
                vals, idx = probs.gather(-1, held), held
            else:
                # the nearest tie: a token's k-th probability over its
                # (k+1)-th, the least over tokens
                top = torch.topk(probs.detach(), k + 1, dim=-1).values
                self.gaps.append(float((top[..., k - 1] - top[..., k]).min()))
            self.routes.append(idx.detach().clone())
            return vals, idx
        L.top_k_low_first = top_k
        return self

    def __exit__(self, *exc):
        self.L.top_k_low_first = self.orig


def _full_train_cfg():
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(TRAIN_ARCH),
                               num_layers=TRAIN_LAYERS)


def train_fd(cfg, dev) -> dict:
    """Phase 10 (b) 1: the f32 backward of the train step's loss at full
    width against central differences along two directions, on the base
    point's branch of the capacity dispatch: every evaluation routes
    every token to the base's experts (and so drops the same
    assignments). The gradient is that branch's; a token whose top-2 sits
    within a rounding of its third would move under the free routing at
    any step the f32 loss can resolve, so the routing is held, and the
    tokens the free routing would have moved are counted."""
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    B, S = TRAIN_FD["batch"], TRAIN_FD["seq"]
    params = lm.init_params(cfg, TRAIN_SEED, torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("inputs", "labels")}
    drops: list = []
    loss_fn = make_loss_fn(cfg, moe_drops=drops)
    t0 = time.perf_counter()
    with _Routes() as rt:
        loss0, _, _, grads = value_and_grad(loss_fn, params, batch)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    route0, drops0, tie = rt.routes, [int(d) for d in drops], min(rt.gaps)
    flat_p, flat_g = lm.flatten(params), lm.flatten(grads)
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                          for g in flat_g.values()))
    moved = []

    @torch.no_grad()
    def loss_at(moves: list, eps: float) -> float:
        """The loss with every (leaf, direction, scale) of ``moves``
        moved by eps times scale times direction, on the base's routing;
        the leaves moved back after (their bits may differ by a
        rounding)."""
        for p, d, c in moves:
            p.add_(d, alpha=eps * c)
        drops.clear()
        with _Routes(route0) as r:
            loss = float(loss_fn(params, batch)[0])
        for p, d, c in moves:
            p.sub_(d, alpha=eps * c)
        assert [int(x) for x in drops] == drops0, (drops, drops0)
        assert len(r.routes) == len(route0), "a MoE call more or less"
        moved.append(r.moved)
        return loss

    def central(moves, eps) -> float:
        return (loss_at(moves, eps) - loss_at(moves, -eps)) / (2 * eps)

    # the gradient's own direction d = g / |g|: dL/deps = |g|
    eps = TRAIN_FD["eta"] / gnorm
    fd_g = central([(flat_p[k], flat_g[k], 1 / gnorm) for k in flat_p], eps)
    err_g = abs(fd_g - gnorm) / gnorm
    assert err_g <= TRAIN_FD["rtol"], ("gradient direction", fd_g, gnorm)
    # a seeded N(0, 1) direction on expert 0's w_down (downstream of the
    # routing); Richardson over eps and eps / 2
    leaf = flat_p["blocks/pos0/ffn/w_down"]
    d = torch.zeros_like(leaf)
    d[0, 0] = torch.randn(leaf.shape[2:], generator=gen, device=dev)
    want = float(torch.sum(flat_g["blocks/pos0/ffn/w_down"].double()
                           * d.double()))
    eps2 = TRAIN_FD["eta_leaf"] / abs(want)
    c1 = central([(leaf, d, 1.0)], eps2)
    c2 = central([(leaf, d, 1.0)], eps2 / 2)
    fd_d = (4 * c2 - c1) / 3
    err_d = abs(fd_d - want) / abs(want)
    assert err_d <= TRAIN_FD["rtol_leaf"], ("w_down direction", fd_d, want,
                                            c1, c2)
    assert moved[2:] == [0, 0, 0, 0], moved   # w_down cannot move routes
    return {"loss": float(loss0), "grad_norm": gnorm, "grad_s": grad_s,
            "drops": drops0, "nearest_tie": tie, "eps": eps, "fd": fd_g,
            "rel_err": err_g, "free_moved": moved, "leaf_eps": eps2, "leaf_dd": want,
            "leaf_fd": fd_d, "leaf_fd_eps": c1, "leaf_fd_half_eps": c2,
            "leaf_rel_err": err_d}


def _bf16_still(p: torch.Tensor, step_bound: float) -> bool:
    """Whether every entry of bf16 ``p`` sits where a step of at most
    ``step_bound`` rounds back to it (less than half the gap to either
    neighbour)."""
    a = p.detach().float().abs()
    e = torch.floor(torch.log2(torch.clamp(a, min=2.0 ** -126)))
    # the gap below a power of two is half the gap above it
    gap = torch.where(a == torch.exp2(e), torch.exp2(e - 8),
                      torch.exp2(e - 7))
    return bool((step_bound < gap / 2).all())


def train_full(cfg, dev, smi: str) -> dict:
    """Phase 10 (b) 2: bf16 training of full-width mixtral through the
    port's ``Trainer`` over ``SyntheticTokens``, timed."""
    import tempfile
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_loss_fn, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    B, S, N = TRAIN_RUN["batch"], TRAIN_RUN["seq"], TRAIN_RUN["steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, TRAIN_SEED, torch.bfloat16, device=dev)
    ocfg = AdamWConfig(**TRAIN_RUN["opt"])
    opt = init_opt_state(params, ocfg)
    before = {k: v.clone() for k, v in lm.flatten(params).items()}
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab, seq_len=S,
                                      global_batch=B))

    def data_fn(i):
        b = data.global_batch(i)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    drops: list = []
    step = make_train_step(cfg, opt_cfg=ocfg, moe_drops=drops)
    with tempfile.TemporaryDirectory() as ckdir:
        tr = Trainer(TrainerConfig(total_steps=N, ckpt_every=10 * N,
                                   ckpt_dir=ckdir, log_every=N + 1),
                     step, data_fn, params, opt)
        hist = tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert [h["step"] for h in hist] == list(range(1, N + 1))
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    # one MoE layer, one token chunk: one count a step
    drop_steps = [int(d) for d in drops]
    assert len(drop_steps) == N, drop_steps
    after = lm.flatten(tr.params)
    m, v = lm.flatten(tr.opt_state["m"]), lm.flatten(tr.opt_state["v"])
    lr_max = max(ocfg.lr * min(t / ocfg.warmup_steps, 1.0)
                 for t in range(1, N + 1))
    still = []
    for k, p in after.items():
        assert bool((m[k] != 0).any()) and bool((v[k] > 0).any()), \
            f"{k}: no gradient reached its moments"
        if not torch.equal(p, before[k]):
            continue
        # Adam's step is at most (1.2 + wd |p|) learning rates (|m^| /
        # sqrt(v^) <= ~1.16 at b1 = 0.9, b2 = 0.95); a leaf may stay only
        # where bf16 rounds every such step back
        bound = lr_max * (1.2 + ocfg.weight_decay
                          * float(before[k].float().abs().max()))
        assert _bf16_still(before[k], bound), f"{k} did not change"
        still.append(k)
    del before
    with torch.no_grad():
        b0 = data_fn(0)
        loss_after = float(make_loss_fn(cfg)(tr.params, b0)[0])
    assert loss_after < losses[0], (loss_after, losses[0])
    dts = sorted(h["dt"] for h in hist[1:])
    step_s = dts[len(dts) // 2]
    tokens = B * S
    flops = 6 * cfg.active_param_count() * tokens
    return {"losses": losses, "grad_norms": gnorms,
            "loss_step0_batch_after": loss_after, "drops": drop_steps,
            "still_bf16": still, "ms_per_step": step_s * 1e3,
            "dts": [h["dt"] for h in hist], "tokens_per_s": tokens / step_s,
            "model_flops_per_step": flops,
            "model_flop_per_s": flops / step_s,
            "bf16_peak_share": flops / step_s / BF16_PEAK,
            "param_bytes": _param_bytes(tr.params), "peak_bytes": peak,
            "nvidia_smi": smi}



def train_drill(dev) -> dict:
    """Phase 10 (c): the twin of ``tests/test_substrate.py``'s
    checkpoint / restart drill with the port's real train step on
    ``dev``: the 7th call raises, ``ckpt_every=2``; the trainer resumes
    at step 6 and ends at step 10, and the last checkpoint restored onto
    the CPU is bitwise the trainer's params and state."""
    import tempfile
    from repro_torch import configs
    from repro_torch.ckpt import checkpointing as ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    d = TRAIN_DRILL
    cfg = configs.reduced(d["arch"], seq=d["seq"])
    params = lm.init_params(cfg, TRAIN_SEED, torch.float32, device=dev)
    ocfg = AdamWConfig(**TRAIN_OPT)
    step = make_train_step(cfg, opt_cfg=ocfg)
    calls = [0]

    def poisoned(p, o, b):
        calls[0] += 1
        if calls[0] == d["poison_call"]:  # a simulated node failure
            raise RuntimeError("injected failure")
        return step(p, o, b)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab, seq_len=d["seq"],
                                      global_batch=d["batch"]))

    def data_fn(i):
        b = data.global_batch(i)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckdir:
        tr = Trainer(TrainerConfig(total_steps=d["steps"],
                                   ckpt_every=d["ckpt_every"], log_every=100,
                                   ckpt_dir=ckdir),
                     poisoned, data_fn, params, init_opt_state(params, ocfg))
        hist = tr.run()
        assert tr.state.step == d["steps"] and tr.state.failures == 1
        # resumed at step 6: no step replayed
        assert [h["step"] for h in hist] == list(range(1, d["steps"] + 1))
        assert ckpt.latest_step(ckdir) == d["steps"]
        live = {"params": tr.params, "opt": tr.opt_state}
        back = ckpt.restore(ckdir, d["steps"], live, "cpu")
        n = 0
        for (path, a), (_, b) in zip(_path_leaves(live), _path_leaves(back)):
            assert b.device.type == "cpu" and a.dtype == b.dtype, path
            assert torch.equal(a.cpu(), b), f"{path} restored differently"
            n += 1
        files = sorted(os.listdir(os.path.join(ckdir, f"step_{d['steps']:08d}")))
    return {"history_steps": [h["step"] for h in hist],
            "losses": [h["loss"] for h in hist], "leaves": n, "files": files,
            "seconds": time.perf_counter() - t0}


def _path_leaves(tree) -> list:
    """[(path string, leaf)] of a tree, in JAX's order."""
    from repro_torch import tree as T
    return [(T.path_str(p), leaf) for p, leaf in T.leaves_with_paths(tree)]


def train_derates(dev) -> dict:
    """Phase 10 (d): ``launch.roofline.uet_efficiencies`` on ``dev``,
    every derate ``==`` the golden's, one launch of each tick kernel a
    tick of its ``simulate_batch`` run."""
    from repro_torch.launch import roofline
    from repro_torch.network import fabric
    gold = np.load(TRAIN)
    with _Capture(fabric, "simulate_batch") as cap:
        eff, secs, peak, launches = _timed_batch(
            lambda: roofline.uet_efficiencies(TRAIN_KINDS, device=dev,
                                              **TRAIN_DERATE))
    assert sorted(eff) == sorted(TRAIN_KINDS), eff
    for k, v in eff.items():
        assert v == float(gold[f"derate/{k}"]), (k, v, gold[f"derate/{k}"])
    ticks = max(r.horizon for r in cap.results)
    _launches_per_group("training", launches, {("g", "ai_full"): ticks})
    return {"derates": eff, "ticks": ticks,
            "horizons": [r.horizon for r in cap.results], "seconds": secs,
            "peak_bytes": peak, "launches": launches}


def train_compress(dev) -> dict:
    """Phase 10 (e): ``compress_tree`` of a seeded 2**24-element f32
    tensor and its carried error on ``dev`` and on the CPU, bitwise."""
    from repro_torch.distributed import compression as comp
    c = TRAIN_COMPRESS
    rng = np.random.default_rng(c["seed"])
    g = (3 * rng.standard_normal(c["n"])).astype(np.float32)
    e = (0.01 * rng.standard_normal(c["n"])).astype(np.float32)
    outs = {}
    for where in (dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, err = comp.compress_tree({"g": torch.as_tensor(g, device=where)},
                                    {"g": torch.as_tensor(e, device=where)})
        torch.cuda.synchronize()
        outs[where] = ([_np(x) for x in q["g"]] + [_np(err["g"])],
                       time.perf_counter() - t0)
    for got, want, what in zip(outs[dev][0], outs["cpu"][0],
                               ("q", "scale", "error")):
        _assert_bits(got, want, f"compress_tree {what}")
    return {"n": c["n"], "card_s": outs[dev][1], "cpu_s": outs["cpu"][1],
            "bytes": comp.compressed_bytes({"g": torch.as_tensor(g)})}


def phase_training(smi: str) -> dict:
    """Phase 10: the LM substrate's training path on the card. (a) the
    ten reduced archs' two train steps against the golden, f32; (b)
    full-width mixtral, R = 1: the f32 backward against central
    differences, then 6 bf16 steps through the trainer, timed; (c) the
    trainer's checkpoint / restart drill; (d) the roofline's UET derates
    against the golden, with the tick kernels' launches; (e) gradient
    compression, card against CPU, bitwise."""
    import importlib.util
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {}
    t_phase = time.perf_counter()
    # (a) the ten reduced archs against the golden
    res, secs, peak, launches = _timed_batch(lambda: train_golden_phase(DEV))
    assert not any(launches.values()), launches
    out["a"] = {"archs": res, "seconds": secs, "peak_bytes": peak}
    worst = {k: max(v[x] for x in ("metric", "grad", "moment", "param"))
             for k, v in res.items()}
    unheld = {k: {x: float(f"{y:.3g}") for x, y in
                  res[k]["step2_unheld"].items()} for k in TRAIN_CHAOTIC}
    say("10 training", f"(a) ten reduced archs (B={TRAIN_GOLDEN['batch']}, "
        f"S={TRAIN_GOLDEN['seq']}, f32, TF32 off): two make_train_step steps"
        f" (AdamW {TRAIN_OPT}) against the JAX golden: metrics, gradient sums"
        f" of squares and samples, params and moments after step 2; largest "
        f"error over its tolerance "
        f"{({k: float(f'{v:.3g}') for k, v in worst.items()})} (tolerances "
        f"{TRAIN_RTOL}); step 2's grad norm and moments, not held where the"
        f" reference's own step 2 is chaotic: gaps {unheld} ({secs:.2f} s, "
        f"peak {peak} B)")
    # (b) 1: the f32 backward at full width against central differences
    cfg = _full_train_cfg()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    fd = train_fd(cfg, DEV)
    torch.cuda.synchronize()
    fd["seconds"] = time.perf_counter() - t0
    fd["peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    say("10 training", f"(b) {TRAIN_ARCH} full width, R={cfg.repeats}, f32,"
        f" B={TRAIN_FD['batch']}, S={TRAIN_FD['seq']}: loss {fd['loss']:.6f},"
        f" |grad| {fd['grad_norm']:.6g}; on the base's routing branch, a "
        f"central difference along the gradient (eps {fd['eps']:.3g}) "
        f"{fd['fd']:.6g}, rel err {fd['rel_err']:.3g} (limit "
        f"{TRAIN_FD['rtol']}; the nearest tie, a token's 2nd probability "
        f"over its 3rd, is {fd['nearest_tie']:.3g}: the free routing would "
        f"have moved {fd['free_moved'][:2]} tokens); along a Gaussian "
        f"direction on expert 0's w_down (eps {fd['leaf_eps']:.3g}, "
        f"Richardson) {fd['leaf_fd']:.6g} against {fd['leaf_dd']:.6g}, rel err"
        f" {fd['leaf_rel_err']:.3g} (limit {TRAIN_FD['rtol_leaf']}); the "
        f"drops {fd['drops']} the base's in every evaluation; "
        f"{fd['seconds']:.2f} s, peak {fd['peak_bytes']} B")
    # (b) 2: bf16 training through the trainer
    run = train_full(cfg, DEV, smi)
    torch.cuda.empty_cache()
    assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
    out["b"] = {"fd": fd, "run": run}
    say("10 training", f"(b) {TRAIN_ARCH} full width, R={cfg.repeats}, bf16 "
        f"params ({run['param_bytes']} B), f32 moments, B={TRAIN_RUN['batch']}"
        f", S={TRAIN_RUN['seq']}, AdamW {TRAIN_RUN['opt']}: "
        f"{TRAIN_RUN['steps']} Trainer steps, losses "
        f"{[round(x, 4) for x in run['losses']]}, grad norms "
        f"{[round(x, 4) for x in run['grad_norms']]}; step 0's batch after "
        f"them {run['loss_step0_batch_after']:.4f}; MoE drops per step "
        f"{run['drops']}; {run['ms_per_step']:.1f} ms/step (median of steps "
        f"2-{TRAIN_RUN['steps']}), {run['tokens_per_s']:.0f} tokens/s, model "
        f"{run['model_flop_per_s'] / 1e12:.1f} TFLOP/s (6 N_active tokens), "
        f"{100 * run['bf16_peak_share']:.1f} % of the {BF16_PEAK / 1e12:.0f} "
        f"TFLOP/s dense bf16 peak; leaves bf16 rounds still: "
        f"{run['still_bf16']}; peak {run['peak_bytes']} B; {smi}")
    # (c) the trainer drill through the reference's checkpoint format
    if all(importlib.util.find_spec(m) for m in ("msgpack", "zstandard")):
        ops.reset_launches()
        out["c"] = train_drill(DEV)
        assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
        say("10 training", f"(c) trainer drill ({TRAIN_DRILL}): the 7th call "
            f"failed, resumed at step 6, history steps "
            f"{out['c']['history_steps']}; the step-{TRAIN_DRILL['steps']} "
            f"checkpoint ({out['c']['files']}) restored onto the CPU bitwise "
            f"the card's {out['c']['leaves']} leaves "
            f"({out['c']['seconds']:.2f} s)")
    else:
        out["c"] = {"absent": True}
        print("checkpoint IO: msgpack/zstandard absent", flush=True)
    # (d) the roofline's UET derates
    out["d"] = train_derates(DEV)
    say("10 training", f"(d) uet_efficiencies({list(TRAIN_KINDS)}, "
        f"{TRAIN_DERATE}): {out['d']['derates']} == the JAX golden; "
        f"{out['d']['ticks']} ticks; launches {out['d']['launches']} "
        f"({out['d']['seconds']:.2f} s)")
    # (e) compression
    ops.reset_launches()
    out["e"] = train_compress(DEV)
    assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
    say("10 training", f"(e) compress_tree of {out['e']['n']} f32 entries and "
        f"their carried error: q, scales and the new error bitwise the CPU's "
        f"(card {out['e']['card_s']:.3f} s, CPU {out['e']['cpu_s']:.3f} s; "
        f"{out['e']['bytes']} wire bytes)")
    out["launches"] = out["d"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    say("10 training", f"phase {out['seconds']:.1f} s")
    return out


ENTRY = ROOT / "tests" / "golden" / "torch_port_entry.npz"
#: phase 11's CLI canaries: golden key -> (module, function); each takes
#: ``device`` and prints its lines
ENTRY_CANARIES = {
    "faults": ("repro_torch.network.faults", "_smoke"),
    "endpoint": ("repro_torch.network.faults", "_endpoint_smoke"),
    "telemetry": ("repro_torch.network.telemetry", "_smoke"),
    "link": ("repro_torch.core.link", "_smoke"),
    "traffic": ("repro_torch.network.traffic", "_canary"),
    "shard": ("repro_torch.network.shard", "_smoke"),
}
ENTRY_PARTS = {"a": "the quickstart", "b": "the tour and the export",
               "c": "the six canaries"}
#: phase 11's tasks: ``qs<n>`` the quickstart's sections, ``tour`` and
#: ``export``, ``canary/<name>``; longest first (their seconds alone on
#: the card), the order its workers take them in
ENTRY_TASKS = ("canary/faults", "canary/endpoint", "qs2", "canary/telemetry",
               "qs12", "qs7", "qs11", "qs1", "qs5", "export", "canary/link",
               "qs3", "tour", "canary/shard", "qs10", "qs8", "qs6", "qs4",
               "qs9", "canary/traffic")
#: seconds one task may take before phase 11 kills its worker and fails
ENTRY_TASK_LIMIT = 600


def entry_part(task: str) -> str:
    return ("a" if task.startswith("qs") else "c"
            if task.startswith("canary/") else "b")


def per_tick(profile, num_flows: int) -> tuple:
    """Launches a tick of each tick kernel (``TICK_KERNELS``) under
    ``profile`` with ``num_flows`` flows, from the tick's sites: the two
    SACK kernels and the retransmit pick once; the NACK mark and the
    RTO's set once unless every flow is ROD; RR_SLOTS's loss inference
    two sets more; NSCC's ACK update and Quick Adapt once under NSCC and
    the hybrid; the two routing walks once."""
    from repro_torch.core.lb.schemes import LBScheme
    from repro_torch.network.profile import CCAlgo, DeliveryMode
    rod = profile.delivery_modes(num_flows) == int(DeliveryMode.ROD)
    sel = int(not bool(rod.all()))
    rr = int(profile.lb == LBScheme.RR_SLOTS and bool(sel))
    nscc = int(profile.cc in (CCAlgo.NSCC, CCAlgo.NSCC_AND_RCCC))
    return (1, 1, sel, 2 * rr + sel, 1, nscc, nscc, 1, 1)


class _Ticks:
    """Count the ticks of every step ``fabric.make_step`` builds while
    the context is open, with the launches a tick its profile makes
    (:func:`per_tick`), and record the ``devices=`` of every
    ``fabric.simulate_batch`` call."""

    def __init__(self):
        self.steps: list = []     # [per-tick launches, ticks] per step
        self.devices: list = []

    def __enter__(self):
        from repro_torch.network import fabric
        self.fabric = fabric
        self.orig = (fabric.make_step, fabric.simulate_batch)
        make_step, simulate_batch = self.orig

        def counted(g, profile, p, F, *args, **kw):
            step = make_step(g, profile, p, F, *args, **kw)
            rec = [per_tick(profile, F), 0]
            self.steps.append(rec)

            def run(*a, **k):
                rec[1] += 1
                return step(*a, **k)
            return run

        def batch(*args, **kw):
            if kw.get("devices") is not None:
                self.devices.append([str(d) for d in kw["devices"]])
            return simulate_batch(*args, **kw)
        fabric.make_step, fabric.simulate_batch = counted, batch
        return self

    def __exit__(self, *exc):
        self.fabric.make_step, self.fabric.simulate_batch = self.orig

    def want(self) -> dict:
        """Each tick kernel's launches over the counted ticks."""
        return {k: sum(per[i] * n for per, n in self.steps)
                for i, k in enumerate(TICK_KERNELS)}


def _load_script(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_entry_task(task: str, dev: str = DEV) -> dict:
    """Run one of phase 11's tasks on ``dev`` in a fresh temporary working
    directory (the tour and the export write ``fabric_trace.json`` to
    theirs): the lines it prints (a quickstart section's, as returned),
    its seconds, its launches, the launches its ticks make, the
    ``devices=`` it split over; the export also the sha256 of its JSON
    text and its event count."""
    import contextlib
    import hashlib
    import importlib
    import io
    import tempfile

    from repro_torch.kernels import ops
    out: dict = {"task": task}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            buf = io.StringIO()
            ops.reset_launches()
            t0 = time.perf_counter()
            with _Ticks() as ticks, contextlib.redirect_stdout(buf):
                if task.startswith("qs"):
                    sections = _load_example("quickstart_torch").SECTIONS
                    lines = sections[int(task[2:]) - 1](dev)
                elif task == "tour":
                    _load_example("fabric_telemetry_torch").main(
                        ["--device", dev])
                elif task == "export":
                    _load_script("trace_export_torch").main(
                        ["--device", dev])
                else:
                    mod, fn = ENTRY_CANARIES[task.split("/", 1)[1]]
                    rc = getattr(importlib.import_module(mod), fn)(dev)
                    assert rc == 0, (task, rc)
                if dev != "cpu":
                    torch.cuda.synchronize()
            out["seconds"] = time.perf_counter() - t0
            out["launches"] = dict(ops.LAUNCHES)
            if not task.startswith("qs"):
                lines = buf.getvalue().splitlines()
            else:
                assert not buf.getvalue(), (task, buf.getvalue())
            if task in ("tour", "export"):
                text = Path("fabric_trace.json").read_text()
                out["sha256"] = hashlib.sha256(text.encode()).hexdigest()
                out["events"] = len(json.loads(text)["traceEvents"])
        finally:
            os.chdir(cwd)
    out.update(lines=list(lines), want=ticks.want(),
               ticks=sum(n for _, n in ticks.steps),
               steps=len(ticks.steps), devices=ticks.devices)
    return out


def masked(lines, mask: str) -> "list[str]":
    """``lines`` with every match of the entry golden's ``mask`` replaced
    by one marker."""
    import re
    return [re.sub(mask, "<masked>", str(ln)) for ln in lines]


def entry_vs_golden(res: dict, gold, dev: str = DEV) -> None:
    """Phase 11's task results against ``tests/golden/torch_port_entry.npz``:
    the quickstart's lines, the tour's and the export's byte for byte,
    the export's JSON by digest and event count, the canaries' apart from
    the golden's masked fields; each tick kernel launched as its ticks
    say, no entry-point kernel; the shard canary split over four devices
    of the run's kind."""
    from repro_torch.network.shard import available_devices
    qs = ["=== UET quickstart ==="] + sum(
        (res[f"qs{i}"]["lines"] for i in range(1, 13)), [])
    want = [str(x) for x in gold["quickstart"]]
    assert qs == want, _first_diff("quickstart", qs, want)
    for task in ("tour", "export"):
        got, want = res[task]["lines"], [str(x) for x in gold[task]]
        assert got == want, _first_diff(task, got, want)
    assert res["export"]["sha256"] == str(gold["export_sha256"]), \
        (res["export"]["sha256"], str(gold["export_sha256"]))
    assert res["export"]["events"] == int(gold["export_events"])
    mask = str(gold["mask"])
    for c in ENTRY_CANARIES:
        got = masked(res[f"canary/{c}"]["lines"], mask)
        want = masked(np.atleast_1d(gold[f"canary/{c}"]), mask)
        assert got == want, _first_diff(f"canary {c}", got, want)
    avail = available_devices(torch.device(dev))
    four = [str(avail[i % len(avail)]) for i in range(4)]
    assert res["canary/shard"]["devices"] == [four], \
        res["canary/shard"]["devices"]
    for task, r in res.items():
        assert r["ticks"] > 0, task
        for k in TICK_KERNELS:
            # the plain versions (a CPU run) count no launch
            want = r["want"][k] if torch.device(dev).type == "cuda" else 0
            assert r["launches"][k] == want, \
                (task, k, r["launches"][k], want, r["ticks"])
        assert all(r["launches"][k] == 0 for k in ENTRY_KERNELS), \
            (task, r["launches"])


def _first_diff(what: str, got: list, want: list) -> str:
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return f"{what}: line {i}: got {a!r}, want {b!r}"
    return f"{what}: {len(got)} lines, want {len(want)}"


def entry_workers() -> int:
    """Phase 11's worker processes: the host's cores less two, at most
    eight. Its tasks are host-bound (a small fabric's tick is a few
    hundred tiny device operations), so processes overlap them."""
    return max(1, min(8, len(os.sched_getaffinity(0)) - 2))


def run_entry_tasks(tasks: list, workers: int, dev: str = DEV) -> dict:
    """Run ``tasks`` in ``workers`` processes of this script
    (``--entry-task``), at most one task a process, in their order; each
    process's result comes back as JSON. A task that fails or passes
    ``ENTRY_TASK_LIMIT`` fails the phase, and every process still running
    is killed."""
    import tempfile
    if workers <= 1:
        return {t: run_entry_task(t, dev) for t in tasks}
    todo, live, res = list(tasks), [], {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            while todo or live:
                while todo and len(live) < workers:
                    task = todo.pop(0)
                    path = Path(tmp) / f"{len(todo)}.json"
                    # stderr to a file: a pipe nobody reads until the
                    # worker ends could fill and stall it
                    with open(path.with_suffix(".err"), "w") as err:
                        proc = subprocess.Popen(
                            [sys.executable, str(Path(__file__).resolve()),
                             "--entry-task", task, "--entry-device", dev,
                             "--out", str(path)],
                            stdout=subprocess.DEVNULL, stderr=err)
                    live.append((task, proc, path, time.perf_counter()))
                time.sleep(0.2)
                for item in list(live):
                    task, proc, path, t0 = item
                    if proc.poll() is None:
                        if time.perf_counter() - t0 > ENTRY_TASK_LIMIT:
                            raise RuntimeError(f"phase 11 task {task} ran "
                                               f"past {ENTRY_TASK_LIMIT} s")
                        continue
                    live.remove(item)
                    if proc.returncode:
                        err = path.with_suffix(".err").read_text()
                        raise RuntimeError(f"phase 11 task {task} exited "
                                           f"{proc.returncode}:\n{err[-4000:]}")
                    res[task] = json.loads(path.read_text())
        finally:
            for _, proc, _, _ in live:
                proc.kill()
                proc.wait()
    return {t: res[t] for t in tasks}


def phase_entry(smi: str, workers: "int | None" = None) -> dict:
    """Phase 11: the last entry points on the card, against the JAX
    package's printed lines (``tests/golden/torch_port_entry.npz``)."""
    gold = np.load(ENTRY)
    workers = entry_workers() if workers is None else workers
    t0 = time.perf_counter()
    res = run_entry_tasks(ENTRY_TASKS, workers)
    wall = time.perf_counter() - t0
    entry_vs_golden(res, gold)
    launches = {k: sum(r["launches"][k] for r in res.values())
                for k in TICK_KERNELS + ENTRY_KERNELS}
    assert all(launches[k] > 0 for k in TICK_KERNELS), launches
    out = {"workers": workers, "seconds": wall, "launches": launches,
           "tasks": {t: {k: r[k] for k in ("seconds", "ticks", "steps",
                                            "launches")}
                     for t, r in res.items()}}
    for part, what in ENTRY_PARTS.items():
        tasks = [t for t in res if entry_part(t) == part]
        secs = [res[t]["seconds"] for t in tasks]
        ticks = sum(res[t]["ticks"] for t in tasks)
        out[part] = {"seconds": sum(secs), "longest": max(secs),
                     "ticks": ticks}
        say("11 entry", f"({part}) {what}: {len(tasks)} tasks, {ticks} "
            f"ticks, {sum(secs):.1f} s of task time (longest "
            f"{max(secs):.1f} s: {tasks[secs.index(max(secs))]})")
    qs = 1 + sum(len(res[f"qs{i}"]["lines"]) for i in range(1, 13))
    say("11 entry", f"the quickstart's {qs} lines, the tour's "
        f"{len(res['tour']['lines'])} and the export's "
        f"{len(res['export']['lines'])} byte for byte the JAX package's; "
        f"the export's JSON sha256 {res['export']['sha256'][:16]}... and "
        f"{res['export']['events']} events the golden's; the six canaries' "
        f"asserts pass, their lines the golden's (masked: wall seconds, "
        f"device count), the shard canary over "
        f"{res['canary/shard']['devices'][0]}; each tick kernel launched "
        f"as its ticks' profiles say, no entry-point kernel; launches "
        f"{launches}")
    say("11 entry", f"phase {wall:.1f} s over {workers} worker processes; "
        f"{smi}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", type=Path,
                    default=ROOT / "build" / "telemetry_flap.json",
                    help="where the flap canary's Perfetto JSON goes")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every phase's numbers to this JSON file")
    ap.add_argument("--entry-task", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--entry-device", default=DEV, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.entry_task is not None:
        # one of phase 11's worker processes: run one task, write its
        # result to --out
        sys.path.insert(0, str(ROOT / "src"))
        torch.set_num_threads(1)
        res = run_entry_task(args.entry_task, args.entry_device)
        args.out.write_text(json.dumps(res))
        return 0
    t0 = time.perf_counter()
    smi, device = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    result = {"nvidia_smi": smi, "device": device,
              "build": phase_build(), "kernels": phase_kernels(),
              "sites": phase_sites(), "goldens": phase_goldens(),
              "full_width": phase_fullwidth()}
    result["batch"] = phase_batch(result["full_width"])
    result["faults"] = phase_faults(result["batch"])
    result["collectives"] = phase_collectives(result["batch"])
    result["link"] = phase_link(result["batch"])
    result["telemetry"] = phase_telemetry(result["faults"], result["link"],
                                          args.trace)
    result["shard"] = phase_shard(result["telemetry"])
    # the results' device states are not kept past the phases that read them
    del result["telemetry"]["faults"]["rs"]
    result["profiles"], states = phase_profiles()
    result["entry_points"] = phase_entry_points(states)
    result["cross_device"] = phase_cross_device()
    result["traffic"] = phase_traffic()
    result["control"] = phase_control(smi)
    result["serving"] = phase_serving(smi)
    result["training"] = phase_training(smi)
    result["entry"] = phase_entry(smi)
    kernels = []
    for name, row in result["kernels"].items():
        row = {k: v for k, v in row.items()
               if k not in ("bytes", "pool")}
        row["launches"] = (result["full_width"]["launches"][name]
                           if name in TICK_KERNELS
                           else result["entry_points"]["launches"][name])
        if "batch" in row:   # the same kernel on the batch phase's path
            row["batch"] = {**{k: v for k, v in row["batch"].items()
                               if k != "bytes"},
                            "launches": result["batch"]["launches"][name]}
            # and on the faulted batch's, the collectives' and the link
            # layer's
            row["faults"] = {"launches": result["faults"]["launches"][name]}
            row["collectives"] = {
                "launches": result["collectives"]["launches"][name]}
            row["link"] = {k: {"launches": v["launches"][name]}
                           for k, v in result["link"].items()}
            # and with telemetry on, and on the split scenario axis
            row["telemetry"] = {
                k: {"launches": result["telemetry"][k]["launches"][name]}
                for k in ("faults", "link")}
            row["shard"] = {"launches": result["shard"]["launches"][name]}
            # and on the model-driven traffic's runs, all four parts
            row["traffic"] = {"launches": result["traffic"]["launches"][name]}
            # and on serving_rate's priced decode step
            row["serving"] = {"launches": result["serving"]["launches"][name]}
            # and on the roofline's UET derates
            row["training"] = {
                "launches": result["training"]["launches"][name]}
            # and on the last entry points: the quickstart, the tour,
            # the export and the six canaries
            row["entry"] = {"launches": result["entry"]["launches"][name]}
        if name in result["control"]["rows"]:
            # the control plane's path: record_rx / or_mask and
            # advance_cack at the endpoint's shapes
            row["control"] = {
                **{k: v for k, v in result["control"]["rows"][name].items()
                   if k != "bytes"},
                "launches": result["control"]["launches"][name]}
        kernels.append(row)
    result["seconds"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
