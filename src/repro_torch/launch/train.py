"""Training launcher — the port of ``repro.launch.train``: ``--arch <id>``
selects any of the ten architectures.

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --steps 50 --reduced [--device cpu]

The reference drives its production mesh and the 2-D FSDP x TP rules on
a fleet of 256 or more chips, and otherwise a host mesh with a reduced
config. The port's model code takes a mesh of one device, so it always
takes that second path: the host mesh, ``configs.reduced``, f32 params,
the sharded train step's specs (the identity on one device), the
fault-tolerant trainer and its async checkpoints. It runs on ``cuda``
unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=configs.ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config of the same family (the port "
                         "runs it with or without the flag)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's two-pod fleet mesh: refused, the "
                         "port runs one device")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod names the reference's 512-chip fleet; the "
                 "port runs a mesh of one device")

    dev = resolve_device(args.device)
    mesh = make_host_mesh(dev)
    cfg = configs.reduced(args.arch, seq=args.seq)
    dp = shd.dp_axes(mesh)

    params = lm.init_params(cfg, 0, torch.float32, device=dev)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=20)
    opt = init_opt_state(params, ocfg)

    step = make_train_step(
        cfg, mesh=mesh, dp_axes=dp, opt_cfg=ocfg,
        act_spec=shd.named(mesh, shd.activation_pspec(cfg, mesh)),
        attn_head_specs=shd.attn_head_specs(cfg, mesh),
        loss_spec=shd.named(mesh, (dp if len(dp) > 1 else dp[0], None,
                                   None)))

    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab, seq_len=args.seq, global_batch=args.batch))

    def data_fn(i):
        b = data.global_batch(i)
        return {"inputs": torch.as_tensor(b["inputs"], device=dev),
                "labels": torch.as_tensor(b["labels"], device=dev)}

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      ckpt_every=max(20, args.steps // 3),
                      ckpt_dir=args.ckpt_dir, log_every=10),
        step, data_fn, params, opt, param_shardings=dev, opt_shardings=dev)
    if trainer.try_resume():
        print(f"resumed at step {trainer.state.step}")
    hist = trainer.run()
    losses = [h["loss"] for h in hist]
    print(f"arch={cfg.name} mesh={dict(zip(mesh.axis_names, mesh.shape))} "
          f"device={dev} loss {losses[0]:.3f} -> "
          f"{np.mean(losses[-5:]):.3f}")
    return hist


if __name__ == "__main__":
    main()
