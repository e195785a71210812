"""End-to-end example on the PyTorch port: train a GLM4-family LM on the
synthetic pipeline with the fault-tolerant trainer (checkpoint/restart,
straggler watch) — the twin of ``examples/train_lm.py``.

Sizes: --size tiny (~4M, CI), small (~25M, default), 100m (~100M params).
A few hundred steps drop the loss well below the unigram entropy.

Run: PYTHONPATH=src python examples/train_lm_torch.py --steps 300 \
         --size small [--device cpu]
It runs on ``cuda`` unless ``--device`` names another device. Restart
behaviour: re-running the same command resumes from the latest
checkpoint in --ckpt-dir (delete the dir for a fresh run).
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

SIZES = {
    # (layers, d_model, heads, kv, d_ff, vocab)
    "tiny": (2, 128, 4, 2, 256, 2048),
    "small": (4, 384, 8, 2, 1024, 8192),
    "100m": (12, 768, 12, 4, 2048, 16384),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", choices=SIZES, default="small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    L, D, H, KV, F, V = SIZES[args.size]
    cfg = dataclasses.replace(
        configs.get("glm4-9b"), num_layers=L, d_model=D, num_heads=H,
        num_kv_heads=KV, d_ff=F, vocab_size=V, head_dim=D // H,
        pad_heads_to=0, pad_kv_to=0, pad_vocab_to=0, tp_pad=1)
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({L}L d{D} h{H} ff{F} v{V})")

    params = lm.init_params(cfg, 0, torch.float32, device=dev)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=50)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, mesh=None, opt_cfg=ocfg)

    data = SyntheticTokens(DataConfig(
        vocab_size=V, seq_len=args.seq, global_batch=args.batch))

    def data_fn(step_idx):
        b = data.global_batch(step_idx)
        return {"inputs": torch.as_tensor(b["inputs"], device=dev),
                "labels": torch.as_tensor(b["labels"], device=dev)}

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10),
        step, data_fn, params, opt)
    if trainer.try_resume():
        print(f"resumed from checkpoint at step {trainer.state.step}")
    hist = trainer.run()
    first = hist[0]["loss"] if hist else float("nan")
    last = sum(h["loss"] for h in hist[-10:]) / max(len(hist[-10:]), 1)
    print(f"\nloss: first {first:.3f} -> last-10 avg {last:.3f} "
          f"(stragglers flagged: {trainer.state.straggler_steps})")
    assert last < first, "loss did not improve"
    return hist


if __name__ == "__main__":
    main()
