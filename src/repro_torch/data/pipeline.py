"""Deterministic synthetic token pipeline with host-side prefetch.

Stateless-resumable: batch at step k is a pure function of (seed, k), so a
job restarted from a step-k checkpoint regenerates the identical stream —
no data-loader state needs checkpointing (runtime/ft relies on this).

The generator is a Zipf-ish unigram sampler with a Markov flavour (next
token mixes a shifted copy of the current one) so the loss actually falls
during the example training runs — pure-uniform tokens would pin loss at
ln(V).

A copy of the reference's `data/pipeline.py` with one deliberate
difference: with `embed_dim` set the reference deletes "tokens" from the
batch, whisper's audio stub included, whose `loss_fn` reads them (so the
reference cannot train whisper through its `run_training`). Here
"tokens" go only for the vlm stub (`frames` 0); the audio batch keeps
the tokens drawn before, and every other array, drawn in the same order,
equals the reference's.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    markov_mix: float = 0.65     # P(next = f(cur)) — learnable structure
    embed_dim: int = 0           # vlm/audio stub embedding width
    frames: int = 0              # audio stub frame count


class SyntheticLM:
    """Batch factory: `batch_at(step)` is pure in (cfg.seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** -cfg.zipf_a
        self._probs = probs / probs.sum()

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        B, T = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(B, T + 1), p=self._probs)
        # markov structure: with prob markov_mix, next = (cur*7+3) % V —
        # applied sequentially so the chain composes (label_t really is
        # f(final token_t) wherever the coin lands heads)
        take = rng.random((B, T)) < cfg.markov_mix
        for t in range(T):
            follow = (toks[:, t] * 7 + 3) % cfg.vocab
            toks[:, t + 1] = np.where(take[:, t], follow, toks[:, t + 1])
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.embed_dim:        # vlm stub: embeddings instead of tokens
            out["embeds"] = rng.standard_normal(
                (B, T, cfg.embed_dim)).astype(np.float32) * 0.02
            out["mrope_positions"] = np.broadcast_to(
                np.arange(T, dtype=np.int32), (3, B, T)).copy()
            if not cfg.frames:
                del out["tokens"]
        if cfg.frames:           # audio stub: frame embeddings
            out["frames"] = rng.standard_normal(
                (B, cfg.frames, cfg.embed_dim)).astype(np.float32) * 0.02
        return out


def make_pipeline(cfg: DataConfig, start_step: int = 0,
                  prefetch: int = 2) -> Iterator[dict]:
    """Background-thread prefetched iterator starting at `start_step`."""
    src = SyntheticLM(cfg)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(src.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def gen():
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    return gen()
