#!/usr/bin/env python3
"""Where the PyTorch port's training path spends its time on a CUDA card.

Runs ``chip_smoke.py`` phase 10 (b)'s bf16 training step — mixtral-8x22b
at full width (d_model 6144, 48 / 8 heads of 128, d_ff 16384, 8 experts
top-2, SWA 4096, vocab 32768), depth cut to R = 1, bf16 params, f32
AdamW moments (``lr=1e-3, warmup_steps=20``), one sequence of
``--seq`` tokens from ``SyntheticTokens`` — and measures:

1. the whole ``make_train_step`` step: ``--warm`` steps, then ``--calls``
   steps each timed alone (the median is kept), then ``--calls`` steps
   under ``torch.profiler``;
2. its two parts alone, the same way: the loss's value and gradients
   (``value_and_grad``: the forward, the remat'd backward) and the
   optimizer's in-place update (``apply_updates``).

For each: the host syncs in one call (``torch.cuda.set_sync_debug_mode``),
the unprofiled wall ms per call, the profiled run's wall and device busy
ms per call, the device's idle share in that same profiled run, the
device operations per call, the ten largest device-time consumers and
the peak device memory. For the optimizer also the least time the card
could take: params, grads and both moments read once and params and
moments written once, over 3.35 TB/s.

    PYTHONPATH=src python3 scripts/torch_port_profile_train.py \\
        [--seq 4096] [--calls 3] [--out FILE]

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import (HBM_BYTES_PER_S, TRAIN_RUN, TRAIN_SEED,  # noqa: E402
                        _full_train_cfg, _param_bytes)
from repro_torch import tree as T  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,  # noqa
                                         init_opt_state)
from repro_torch.train.train_step import (make_loss_fn,  # noqa: E402
                                          make_train_step, value_and_grad)
from torch_port_profile_serving import (host_syncs, profiled,  # noqa: E402
                                        report, timed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=TRAIN_RUN["seq"])
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_profile_train: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _full_train_cfg()
    params = lm.init_params(cfg, TRAIN_SEED, torch.bfloat16, device=dev)
    ocfg = AdamWConfig(**TRAIN_RUN["opt"])
    opt = init_opt_state(params, ocfg)
    nbytes = _param_bytes(params)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab,
                                      seq_len=args.seq, global_batch=1))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.global_batch(0).items()}
    res = {"nvidia_smi": smi, "arch": cfg.name, "repeats": cfg.repeats,
           "dtype": "bfloat16", "moments": "float32", "seq": args.seq,
           "param_bytes": nbytes}

    def median_wall(fn) -> "tuple[float, list]":
        walls = sorted(timed(fn, 1) for _ in range(args.calls))
        return walls[len(walls) // 2], walls

    # 1. the whole step
    step = make_train_step(cfg, opt_cfg=ocfg)

    def one_step():
        step(params, opt, batch)

    for _ in range(args.warm):
        one_step()
    torch.cuda.reset_peak_memory_stats()
    wall, walls = median_wall(one_step)
    peak = torch.cuda.max_memory_allocated()
    res["step"] = {"walls_ms": walls, "tokens_per_s": args.seq / wall * 1e3,
                   **report(f"train step S={args.seq} (median of "
                            f"{args.calls})", wall,
                            profiled(one_step, args.calls), peak,
                            host_syncs(one_step))}

    # 2. its parts: value and gradients, then the update
    loss_fn = make_loss_fn(cfg)
    grads = {}

    def vg():
        grads["g"] = value_and_grad(loss_fn, params, batch)[3]

    vg()
    wall, walls = median_wall(vg)
    res["value_and_grad"] = {
        "walls_ms": walls, **report("value_and_grad", wall,
                                    profiled(vg, args.calls), peak,
                                    host_syncs(vg))}

    def update():
        apply_updates(params, grads["g"], opt, ocfg)

    wall, walls = median_wall(update)
    # params read and written, grads read, both moments read and written
    moved = sum(p.numel() * (2 * p.element_size() + g.element_size()
                             + 2 * m.element_size() + 2 * v.element_size())
                for p, g, m, v in zip(T.leaves(params), T.leaves(grads["g"]),
                                      T.leaves(opt["m"]), T.leaves(opt["v"])))
    res["update"] = {"walls_ms": walls, "bytes": moved,
                     "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                     **report("apply_updates", wall,
                              profiled(update, args.calls), peak,
                              host_syncs(update))}
    print(f"  the update's bytes ({moved}) over {HBM_BYTES_PER_S / 1e12} "
          f"TB/s bound it at {res['update']['bound_ms']:.3f} ms")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
