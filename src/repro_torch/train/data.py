"""Deterministic, shardable, resumable token pipeline.

The port's own copy of ``repro.train.data`` (numpy only, so the batches
are bit-equal to the JAX package's).  Every batch is a pure function of
``(seed, step)``: after a checkpoint restore or a membership change, the
pipeline replays from any step index with any data-parallel shard count
without coordination.  The "corpus" is a seeded generator with document
structure (documents repeat token n-grams), so the loss of a training run
falls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .. import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_docs: int = 512          # synthetic corpus size
    doc_len: int = 2_048
    ngram: int = 8             # learnable structure: repeated n-grams


class TokenPipeline:
    """Synthetic corpus with Zipfian unigrams + repeated n-grams."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab
        # Zipfian unigram distribution.
        ranks = np.arange(1, V + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        # Each document: a bank of n-grams sampled once, then tiled with noise.
        n_grams_per_doc = 16
        bank = rng.choice(V, size=(cfg.n_docs, n_grams_per_doc, cfg.ngram), p=probs)
        docs = np.empty((cfg.n_docs, cfg.doc_len), np.int32)
        for d in range(cfg.n_docs):
            seq = bank[d, rng.integers(0, n_grams_per_doc, cfg.doc_len // cfg.ngram)]
            docs[d] = seq.reshape(-1)[: cfg.doc_len]
        self.docs = docs

    # ------------------------------------------------------------------
    def batch_at(
        self, step: int, *, shard: int = 0, num_shards: int = 1
    ) -> Dict[str, np.ndarray]:
        """The ``shard``-th slice of the global batch for ``step``.

        Deterministic in (seed, step, shard, num_shards) with the global
        batch independent of the sharding: the elastic-scaling invariant."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        per = cfg.global_batch // num_shards
        out_tokens = np.empty((per, cfg.seq_len + 1), np.int32)
        for i in range(per):
            g = shard * per + i  # global row index
            rs = np.random.default_rng((cfg.seed, step, g))
            need = cfg.seq_len + 1
            parts = []
            while need > 0:
                d = rs.integers(0, cfg.n_docs)
                off = rs.integers(0, cfg.doc_len - 1)
                take = min(need, cfg.doc_len - off)
                parts.append(self.docs[d, off : off + take])
                need -= take
            out_tokens[i] = np.concatenate(parts)
        return {
            "tokens": out_tokens[:, :-1],
            "targets": out_tokens[:, 1:],
        }

    def torch_batch_at(self, step: int, *, device="cuda", **kw) -> Dict[str, torch.Tensor]:
        """``batch_at`` as int32 tensors on ``device`` (CUDA unless the
        caller asks for the CPU)."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in self.batch_at(step, **kw).items()}
