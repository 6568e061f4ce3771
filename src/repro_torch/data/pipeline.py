"""Data pipelines: deterministic, resumable, host-side synthetic sources
(counterpart of ``repro.data.pipeline``; host numpy, batch for batch the
reference's).

Every source is seeded and step-indexed, so a restore at step N
reproduces batch N exactly (a checkpoint stores only the step).  Batches
are numpy arrays; the train loop moves them to its device.
``GraphMinibatchStream`` and ``synthetic_molecules`` come with the GNN
slice, which brings the neighbour sampler and `build_triplets`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenStream:
    """Synthetic LM token batches with a Zipfian unigram + ngram structure
    (so losses actually decrease during example training runs)."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        probs = 1.0 / np.arange(1, cfg.vocab + 1) ** 1.1
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, step))
        B, S = self.cfg.global_batch, self.cfg.seq_len
        toks = rng.choice(self.cfg.vocab, size=(B, S + 1), p=self._probs)
        # inject learnable bigram structure: x[t+1] = f(x[t]) half the time
        nxt = (toks[:, :-1] * 31 + 7) % self.cfg.vocab
        mask = rng.random((B, S)) < 0.5
        toks[:, 1:][mask] = nxt[mask]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class RecsysStreamConfig:
    n_items: int
    n_cates: int
    n_users: int
    seq_len: int
    batch: int
    seed: int = 0


class RecsysStream:
    """DIN batches: user history (items+cates), candidate, CTR label with a
    planted preference signal (users favour items in their own cluster)."""

    def __init__(self, cfg: RecsysStreamConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        user = rng.integers(0, c.n_users, size=c.batch)
        cluster = user % 64
        hist = (rng.integers(0, c.n_items // 64, size=(c.batch, c.seq_len))
                * 64 + cluster[:, None]) % c.n_items
        # random padding tail
        lens = rng.integers(c.seq_len // 2, c.seq_len + 1, size=c.batch)
        pad = np.arange(c.seq_len)[None, :] >= lens[:, None]
        hist[pad] = -1
        cand_pos = rng.random(c.batch) < 0.5
        cand = np.where(
            cand_pos,
            (rng.integers(0, c.n_items // 64, size=c.batch) * 64 + cluster)
            % c.n_items,
            rng.integers(0, c.n_items, size=c.batch))
        return {
            "hist_items": hist.astype(np.int32),
            "hist_cates": np.where(hist >= 0, hist % c.n_cates, -1).astype(np.int32),
            "cand_item": cand.astype(np.int32),
            "cand_cate": (cand % c.n_cates).astype(np.int32),
            "user_id": user.astype(np.int32),
            "label": cand_pos.astype(np.float32),
        }
