"""Deterministic sharded synthetic-token pipeline — a copy of
``repro.data.pipeline`` (numpy only).

A production data loader's contract, minus the storage backend: globally
deterministic batches keyed by (seed, step) so that (a) every data-parallel
host slices only its own rows, (b) restart from a checkpoint replays the
exact token stream (step index is the cursor — no separate dataloader
state to checkpoint), and (c) elastic rescaling re-slices the same global
batch across a different host count.

The synthetic distribution is a mixture of Zipfian unigrams and short
repeated motifs, giving a learnable (compressible) stream — loss drops
measurably within a few hundred steps, which the training example relies
on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    motif_len: int = 16
    motif_count: int = 64
    motif_prob: float = 0.7


class SyntheticTokens:
    """Deterministic (seed, step) -> global batch of token ids."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # Zipfian unigram table
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()
        # fixed motif bank drawn from the unigram distribution
        self.motifs = rng.choice(
            cfg.vocab_size, size=(cfg.motif_count, cfg.motif_len),
            p=self.unigram)

    def global_batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self.unigram)
        # overwrite spans with motifs (the learnable structure)
        n_spans = int((S // cfg.motif_len) * cfg.motif_prob)
        for b in range(B):
            ids = rng.integers(0, cfg.motif_count, size=n_spans)
            offs = rng.integers(0, S + 1 - cfg.motif_len, size=n_spans)
            for m, o in zip(ids, offs):
                toks[b, o:o + cfg.motif_len] = self.motifs[m]
        return {"inputs": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def host_batch(self, step: int, process_index: int,
                   num_processes: int) -> dict:
        """This host's row slice of the deterministic global batch."""
        g = self.global_batch(step)
        B = self.cfg.global_batch
        assert B % num_processes == 0
        rows = slice(process_index * B // num_processes,
                     (process_index + 1) * B // num_processes)
        return {k: v[rows] for k, v in g.items()}
