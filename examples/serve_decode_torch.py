"""Serving example on the PyTorch port: greedy decode with ring KV caches,
the twin of ``examples/serve_decode.py`` (the JAX package's).

A reduced mixtral-family config (MoE + sliding-window attention) runs
the serving path: the prompt goes through the decode step token by
token into the ring cache, then each request extends it one greedy token
per step. ``generate(cfg, params, prompts, tokens)`` is the loop, for
any params (a test feeds it the JAX example's); ``main()`` draws params
and prompts from ``--seed`` and prints what the JAX example prints. The
tensors live on ``cuda`` unless ``--device cpu`` is given (there is no
CPU fallback).

Run: PYTHONPATH=src python examples/serve_decode_torch.py --tokens 16 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.models import lm
from repro_torch.serve.serve_step import make_decode_step, sample_greedy


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params: dict, prompts: torch.Tensor, tokens: int) -> dict:
    """Feed ``prompts`` [B, P] through the decode step into a ring cache of
    P + ``tokens`` slots, then decode ``tokens`` greedy tokens. Returns
    the generated ids [B, tokens], the last logits and the seconds of
    both loops."""
    dev = prompts.device
    B, P = prompts.shape
    cache = lm.init_cache(cfg, B, P + tokens, params["embed"].dtype,
                          device=dev)
    dstep = make_decode_step(cfg, mesh=None)
    t0 = time.perf_counter()
    logits = None
    for i in range(P):
        logits, cache = dstep(params, cache, prompts[:, i:i + 1], i)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = []
    tok = sample_greedy(logits)[:, None]
    t0 = time.perf_counter()
    for i in range(tokens):
        out.append(tok)
        logits, cache = dstep(params, cache, tok, P + i)
        tok = sample_greedy(logits)[:, None]
    _sync(dev)
    return {"ids": torch.cat(out, dim=1), "logits": logits,
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.reduced("mixtral-8x22b", seq=64)
    params = lm.init_params(cfg, args.seed, torch.float32, device=dev)
    B, P = args.batch, args.prompt_len
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev,
                            dtype=torch.int32)

    r = generate(cfg, params, prompts, args.tokens)
    print(f"prefill: {P} steps in {r['prefill_s']:.2f}s")
    print(f"decode: {args.tokens} tokens x {B} requests in "
          f"{r['decode_s']:.2f}s ({args.tokens * B / r['decode_s']:.1f} "
          f"tok/s)")
    print("generated ids (request 0):", r["ids"][0].tolist())
    assert bool(torch.isfinite(r["logits"]).all())


if __name__ == "__main__":
    main()
