"""K5 ``decode_attention`` — one query token against a KV cache on the GPU.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py:110``
(``decode_attention`` -> ``decode_attention_bhd`` :66). CUDA source:
``csrc/decode_attention.cu`` (split-KV: one block per (split of the cache
prefix, kv head, batch row); up to eight query heads of the group share
each K/V tile, which arrives by ``cp.async`` into a two-stage ring; online
softmax in float32; only the ``kv_len`` valid keys are read; with more than
one split a second kernel combines the partials). Plain version:
``kernels/ref.py::decode_attention_ref``; its split-and-combine,
``decode_attention_split_ref``.

Bound on an H100: the valid K/V prefix read once, 2 B kv_len Hkv D
sizeof(T) bytes; at B=64, kv_len 4096, Hkv=2, D=64 in bf16, 134 MB or
40.1 µs at 3.35 TB/s. On the serve path (B <= 8, kv_len ~17) the launch
sets the time.

``kv_len`` is a host int shared by the batch (the engine's cache offset is
one), so a launch needs no device->host sync. CPU tensors take the plain
version; CUDA tensors launch the kernel (there is no fallback).
``decode_attention.launches`` counts wrapper calls that launched the
kernel (one, whether or not the combine kernel follows).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.obs.trace import traced_kernel

HEAD_DIMS = (32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TARGET_BLOCKS = 4 * 132   # a few blocks on each of the H100's SMs
SPLIT_MIN_KEYS = 256            # fewer keys than this per split: one split
SPLIT_ALIGN = 64                # a split's length is a multiple of this
MAX_SPLITS = 64
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 10 + [_P]


def num_splits(b: int, hkv: int, kv_len: int) -> int:
    """How many ranges K5 cuts the cache prefix into: enough blocks
    (B * Hkv per split) for a few on every SM, but at least
    ``SPLIT_MIN_KEYS`` keys per split, so a short cache (the serve path)
    takes one split and no combine."""
    want = -(-SPLIT_TARGET_BLOCKS // (b * hkv))
    return max(1, min(want, -(-kv_len // SPLIT_MIN_KEYS), MAX_SPLITS))


def split_chunk(kv_len: int, n_split: int) -> int:
    """Keys per split: ceil(kv_len / n_split), rounded up to a multiple of
    ``SPLIT_ALIGN``."""
    chunk = -(-kv_len // n_split)
    return -(-chunk // SPLIT_ALIGN) * SPLIT_ALIGN


def split_bounds(kv_len: int, n_split: int) -> list:
    """The key ranges [start, end) of the ``n_split`` splits, as the kernel
    cuts them; a range may be empty (start >= kv_len)."""
    chunk = split_chunk(kv_len, n_split)
    return [(i * chunk, min(kv_len, (i + 1) * chunk)) for i in range(n_split)]


@traced_kernel("decode_attention")
def decode_attention(q, k_cache, v_cache, kv_len):
    """q (B, 1, Hq, D); k_cache, v_cache (B, S_max, Hkv, D); ``kv_len`` an
    int in [1, S_max]. Attention of the one query over cache slots
    [0, kv_len); returns (B, 1, Hq, D) in q's type. The caches may be of
    another type than q (float32 or bf16 each)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    if not isinstance(kv_len, int) or isinstance(kv_len, bool):
        raise TypeError(f"decode_attention: kv_len must be a host int, got "
                        f"{type(kv_len).__name__}")
    if q.device.type != "cuda" or q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be a (B, 1, Hq, D) CUDA "
                         f"tensor, got {tuple(q.shape)} on {q.device}")
    b, _, hq, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or \
            k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}; expected (B, S_max, Hkv, D)")
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"decode_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k_cache.dtype not in DTYPES or \
            v_cache.dtype != k_cache.dtype:
        raise ValueError(f"decode_attention: q {q.dtype}, caches "
                         f"{k_cache.dtype}/{v_cache.dtype}; each must be "
                         f"float32 or bfloat16, the caches alike")
    if not 1 <= kv_len <= s_max:
        raise ValueError(f"decode_attention: kv_len {kv_len} outside "
                         f"[1, S_max={s_max}]")
    if b > 65535:
        raise ValueError(f"decode_attention: B={b} must be at most 65535 "
                         f"(a grid dimension)")
    build.check_tensors("decode_attention", q.device, q=q, k_cache=k_cache,
                        v_cache=v_cache)
    lib = build.load("decode_attention")
    out = torch.empty_like(q)
    n_split = num_splits(b, hkv, kv_len)
    part = torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    fn = lib.decode_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), part.data_ptr() if part is not None else None,
            b, hq, hkv, d, s_max, kv_len, n_split,
            split_chunk(kv_len, n_split), DTYPES[q.dtype],
            DTYPES[k_cache.dtype], torch.cuda.current_stream(q.device)
            .cuda_stream)
    build.check(lib, "decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
