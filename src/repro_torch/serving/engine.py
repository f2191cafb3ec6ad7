"""Inference serving steps + a bucketed host-side engine.

Port of ``repro.serving.engine``. ``make_prefill_step`` /
``make_serve_step`` build the step functions; the engine runs one per
(batch-bucket, seq-bucket), the analogue of the paper's per-configuration
engines, and FCPO's iAgent actions select which bucket runs each step
(batch size <-> BS action, seq bucket <-> RES action).

The steps take ``use_kernels`` (default True): on the GPU a cache-less
prefill runs K4 ``flash_attention`` in every layer and a decode step K5
``decode_attention``; ``use_kernels=False`` is the JAX package's
``use_pallas=False`` path (``sdpa``) on any device. The cache offset is a
host int, and the engine's steps update the cache in place.

The prefill step returns the logits at the bucket's LAST slot, as the
reference does: when the prompt is shorter than its bucket that slot holds
a pad token (a reference fault kept for parity; ROADMAP queue 3).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.registry import Model


def make_prefill_step(model: Model, with_cache: bool = True,
                      use_kernels: bool = True) -> Callable:
    """(params, cache|None, batch) -> (last_logits, cache); with
    ``with_cache=False``, (params, batch) -> logits."""

    @torch.no_grad()
    def prefill_step(params, cache, batch):
        logits, new_cache, _ = model.apply(params, batch, cache,
                                           use_kernels=use_kernels)
        return logits[:, -1], new_cache

    if not with_cache:
        @torch.no_grad()
        def prefill_only(params, batch):
            logits, _, _ = model.apply(params, batch, use_kernels=use_kernels)
            return logits

        return prefill_only
    return prefill_step


def make_serve_step(model: Model, use_kernels: bool = True,
                    greedy: bool = True) -> Callable:
    """One decode step: (params, cache, batch) -> (next_tokens, cache).

    ``batch["tokens"]`` is (B, 1), the previously emitted token; the step
    appends it to the cache and returns the argmax next token (int32), or
    the last logits with ``greedy=False``."""

    @torch.no_grad()
    def serve_step(params, cache, batch):
        logits, new_cache, _ = model.apply(params, batch, cache,
                                           use_kernels=use_kernels)
        if greedy:
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return nxt[:, None], new_cache
        return logits[:, -1], new_cache

    return serve_step


def make_encode_step(model: Model, use_kernels: bool = True) -> Callable:
    """Encoder scoring step: (params, batch) -> logits."""

    @torch.no_grad()
    def encode_step(params, batch):
        logits, _, _ = model.apply(params, batch, use_kernels=use_kernels)
        return logits

    return encode_step


# ---------------------------------------------------------------------------
# Host-side bucketed engine
# ---------------------------------------------------------------------------
def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"size {n} exceeds the largest compiled bucket {buckets[-1]} "
        f"(buckets={tuple(buckets)}); extend the bucket set or split the "
        f"request into bucket-sized chunks")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Bucketed serving engine for one model replica.

    FCPO control surface:
      * ``batch_bucket``  — the iAgent BS action picks the batch size
      * ``seq_bucket``    — the RES action picks the input length bucket
        (short requests are padded into it)
      * concurrency is managed by the caller (MT action = in-flight steps)
    """

    def __init__(self, model: Model, params, max_cache_len: int = 4096,
                 batch_buckets=(1, 2, 4, 8, 16, 32, 64),
                 seq_buckets=(128, 256, 512, 1024), cache_dtype=None,
                 use_kernels: bool = True):
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        self.max_cache_len = max_cache_len
        self.cache_dtype = cache_dtype or torch.bfloat16
        self.batch_buckets = tuple(batch_buckets)
        self.seq_buckets = tuple(seq_buckets)
        self.use_kernels = use_kernels
        self._prefill = make_prefill_step(model, use_kernels=use_kernels)
        self._decode = make_serve_step(model, use_kernels=use_kernels)
        self.stats = {"prefill_calls": 0, "decode_calls": 0,
                      "padded_tokens": 0, "real_tokens": 0}

    def new_cache(self, batch: int):
        return self.model.new_cache(batch, self.max_cache_len,
                                    self.cache_dtype, self.device)

    def _tokens(self, tokens):
        return torch.as_tensor(tokens, dtype=torch.int32, device=self.device)

    def prefill(self, tokens, extra: Optional[Dict[str, Any]] = None):
        """tokens: (B, S) ints. Pads B and S to buckets (zeros on the
        right); returns (last_logits (B, V), cache, info)."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        bb = _bucket(b, self.batch_buckets)
        sb = _bucket(s, self.seq_buckets)
        pad_b, pad_s = bb - b, sb - s
        batch = {"tokens": F.pad(tokens, (0, pad_s, 0, pad_b))}
        if extra:
            batch.update(extra)
        cache = self.new_cache(bb)
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, cache, batch)
        _sync(self.device)
        dt = time.perf_counter() - t0
        self.stats["prefill_calls"] += 1
        self.stats["padded_tokens"] += pad_b * sb + b * pad_s
        self.stats["real_tokens"] += b * s
        return logits[:b], cache, {"bucket": (bb, sb), "latency_s": dt}

    def decode(self, cache, last_tokens):
        t0 = time.perf_counter()
        nxt, cache = self._decode(self.params, cache,
                                  {"tokens": self._tokens(last_tokens)})
        _sync(self.device)
        self.stats["decode_calls"] += 1
        return nxt, cache, {"latency_s": time.perf_counter() - t0}

    def generate(self, tokens, steps: int):
        """Greedy generation of ``steps`` tokens: (B, steps) int32."""
        tokens = self._tokens(tokens)
        b = tokens.shape[0]
        bb = _bucket(b, self.batch_buckets)
        tokens = F.pad(tokens, (0, 0, 0, bb - b))  # decode at bucket size
        logits, cache, _ = self.prefill(tokens)
        cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out = [cur]
        for _ in range(steps - 1):
            cur, cache, _ = self.decode(cache, cur)
            out.append(cur)
        return torch.cat(out, dim=1)[:b]
