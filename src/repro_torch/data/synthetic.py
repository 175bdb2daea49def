"""Deterministic synthetic corpus with learnable structure.

Tokens follow a sparse Markov chain (each token has ``branching`` plausible
successors drawn from a seeded table), so a real LM can actually *learn* it —
losses fall well below log(vocab) and perplexity comparisons between FP and
integer softmax are meaningful. Fully offline and reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    vocab: int
    seed: int = 0
    branching: int = 4

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.table = rng.integers(0, self.vocab, size=(self.vocab, self.branching))
        # skewed successor probabilities (zipf-ish) -> non-trivial entropy
        w = 1.0 / np.arange(1, self.branching + 1)
        self.probs = w / w.sum()

    def sample(self, batch: int, seq: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, seed))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(seq):
            branch = rng.choice(self.branching, size=batch, p=self.probs)
            toks[:, t + 1] = self.table[toks[:, t], branch]
        return toks

    def batch(self, batch: int, seq: int, seed: int) -> Dict[str, np.ndarray]:
        toks = self.sample(batch, seq, seed)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def batches(self, batch: int, seq: int, start_step: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(batch, seq, seed=step)
            step += 1


def family_batch(cfg, batch: int, seq: int, seed: int,
                 corpus: Optional[SyntheticCorpus] = None) -> Dict[str, np.ndarray]:
    """Family-aware batch: adds M-RoPE positions (vlm) / frame embeds (encdec)."""
    corpus = corpus or SyntheticCorpus(cfg.vocab, seed=1234)
    b = corpus.batch(batch, seq, seed)
    if cfg.rope_type == "mrope":
        # text-only stream: all three position components equal (Qwen2-VL rule)
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32)[None, None],
                              (3, batch, seq)).copy()
        b["positions"] = pos
    if cfg.family == "encdec":
        rng = np.random.default_rng((seed, 7))
        b["frames"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)
    return b
