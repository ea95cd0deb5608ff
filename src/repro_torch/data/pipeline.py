"""LM token pipeline, a copy of ``repro/data/pipeline.py`` (numpy, the
same RNG calls in the same order, so equal seeds give the same batches
array for array): a synthetic corpus and its packing into fixed-shape
batches.

No real corpora ship with the repository; the synthetic stream mixes
Zipfian unigrams with repeated n-gram "phrases", so models have
learnable structure and loss curves behave like language, not noise.
``packed_batches`` yields (B, S) next-token batches cut from packed
(B, S + 1) sequences.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["LMDataConfig", "synthetic_corpus", "packed_batches"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_phrases: int = 512
    phrase_len: int = 8
    phrase_prob: float = 0.5
    zipf: float = 1.3


def synthetic_corpus(cfg: LMDataConfig) -> Iterator[np.ndarray]:
    """Infinite stream of token chunks (np.int32 arrays)."""
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab
    phrases = rng.integers(1, v, size=(cfg.n_phrases, cfg.phrase_len))
    # phrase popularity is Zipfian too
    ranks = np.arange(1, cfg.n_phrases + 1, dtype=np.float64)
    probs = ranks ** -cfg.zipf
    probs /= probs.sum()
    while True:
        out = []
        n = 0
        target = cfg.seq_len * 4
        while n < target:
            if rng.uniform() < cfg.phrase_prob:
                pid = rng.choice(cfg.n_phrases, p=probs)
                out.append(phrases[pid])
                n += cfg.phrase_len
            else:
                k = int(rng.integers(2, 16))
                toks = (rng.zipf(cfg.zipf + 0.2, k) % (v - 1)) + 1
                out.append(toks)
                n += k
        yield np.concatenate(out).astype(np.int32)


def packed_batches(cfg: LMDataConfig) -> Iterator[dict]:
    """Pack the stream into (B, S) token / target batches (next-token
    LM): ``{"tokens", "targets"}``, int32."""
    stream = synthetic_corpus(cfg)
    buf = np.zeros(0, dtype=np.int32)
    need = cfg.global_batch * (cfg.seq_len + 1)
    while True:
        while len(buf) < need:
            buf = np.concatenate([buf, next(stream)])
        chunk, buf = buf[:need], buf[need:]
        seqs = chunk.reshape(cfg.global_batch, cfg.seq_len + 1)
        yield {
            "tokens": seqs[:, :-1].copy(),
            "targets": seqs[:, 1:].copy(),
        }
