"""Token / batch pipeline: deterministic synthetic streams for training and
serving (no external corpora).

Port of ``repro.data.pipeline``. Sequences are Zipf-distributed token
streams with Markov locality, so that the loss surface is not trivial (a
model must learn the bigram structure to beat the unigram floor); hubert
gets frame embeddings and mask spans, pixtral patch embeddings ahead of
the text. Every draw comes from ``np.random.default_rng(seed)``, in the
reference's order, so the port's batches are the JAX package's exactly;
they are handed over as tensors on ``device``.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float64)


class TokenPipeline:
    """Markov-Zipf synthetic LM stream: an infinite iterator of batches."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                 locality: float = 0.3, device="cuda"):
        self.cfg = cfg
        self.batch, self.seq = batch, seq
        self.rng = np.random.default_rng(seed)
        self.probs = _zipf_probs(min(cfg.vocab_size, 65536))
        self.vocab = len(self.probs)
        self.locality = locality
        self.device = resolve_device(device)

    def _sample_tokens(self, n) -> np.ndarray:
        flat = self.rng.choice(self.vocab, size=n, p=self.probs)
        # Markov locality: with prob `locality`, shift the previous token
        rep = self.rng.random(n) < self.locality
        shifted = np.roll(flat, 1)
        flat = np.where(rep, (shifted + 1) % self.vocab, flat)
        return flat.astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def _put(self, arrays) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def __next__(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b, s = self.batch, self.seq
        if cfg.frontend == "frames":
            emb = self.rng.standard_normal(
                (b, s, cfg.frontend_dim)).astype(np.float32)
            mask = self.rng.random((b, s)) < 0.15
            # span masking (hubert masks ~10-frame spans)
            for _ in range(2):
                mask |= np.roll(mask, 1, axis=1)
            labels = self._sample_tokens(b * s).reshape(b, s) % cfg.vocab_size
            return self._put({"embeds": emb, "mask": mask, "labels": labels})
        toks = self._sample_tokens(b * s).reshape(b, s) % cfg.vocab_size
        batch = {"tokens": toks, "labels": toks}
        if cfg.frontend == "patches":
            batch["patches"] = self.rng.standard_normal(
                (b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
        return self._put(batch)


def request_stream(cfg: ArchConfig, rate_trace, max_len: int = 64,
                   seed: int = 0):
    """Serving request generator: at step t yields ~rate_trace[t] requests
    (request id, numpy int32 prompt) of random prompt lengths."""
    rng = np.random.default_rng(seed)
    probs = _zipf_probs(min(cfg.vocab_size, 8192))
    rid = 0
    for rate in np.asarray(rate_trace):
        n = rng.poisson(max(rate, 0.0))
        reqs = []
        for _ in range(int(n)):
            ln = int(rng.integers(4, max_len))
            toks = rng.choice(len(probs), size=ln, p=probs).astype(np.int32)
            reqs.append((rid, toks))
            rid += 1
        yield reqs
