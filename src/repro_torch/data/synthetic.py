"""Deterministic synthetic LM data: a fixed random bigram chain.

Sequences are sampled from a vocab-sized Markov chain whose transition
structure is derived from a fixed seed, so (a) every (step, shard) batch is
reproducible for checkpoint/restart tests, and (b) the distribution has
real learnable structure — training loss decreasing below the unigram
entropy proves the optimizer/model plumbing end-to-end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataCfg:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 1234
    branching: int = 4   # candidate successors per token (entropy control)


class SyntheticLM:
    """Host-sharded deterministic stream; ``batch(step, shard, n_shards)``
    is a pure function — restart at any step reproduces the batch."""

    def __init__(self, cfg: DataCfg):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # each token's successors: `branching` choices with random weights
        self.succ = rng.integers(0, cfg.vocab,
                                 size=(cfg.vocab, cfg.branching))
        w = rng.random((cfg.vocab, cfg.branching)) + 0.1
        self.w = w / w.sum(axis=1, keepdims=True)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        """Topology-invariant: the full global batch is generated from
        (seed, step) alone and sliced per shard, so elastic resharding and
        DP-vs-single-host equivalence hold exactly."""
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        b = cfg.global_batch // n_shards
        g = cfg.global_batch
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 4096)
        toks = np.empty((g, cfg.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=g)
        # vectorised chain sampling
        for t in range(cfg.seq):
            cur = toks[:, t]
            choice = (rng.random(g)[:, None] <
                      np.cumsum(self.w[cur], axis=1)).argmax(axis=1)
            toks[:, t + 1] = self.succ[cur, choice]
        sl = slice(shard * b, (shard + 1) * b)
        return {"tokens": toks[sl, :-1], "labels": toks[sl, 1:]}

    def frontend_batch(self, step: int, shard: int, n_shards: int,
                       d_model: int, n_tokens: int,
                       key: str) -> Dict[str, np.ndarray]:
        """Stub modality embeddings for vlm/audio archs."""
        base = self.batch(step, shard, n_shards)
        b = base["tokens"].shape[0]
        rng = np.random.default_rng(
            (self.cfg.seed * 999_983 + step) * 4096 + shard)
        base[key] = rng.standard_normal(
            (b, n_tokens, d_model)).astype(np.float32)
        return base
