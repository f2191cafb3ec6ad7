"""K5 ``decode_attention`` — one query token against a KV cache on the GPU.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py:110``
(``decode_attention`` -> ``decode_attention_bhd`` :66). CUDA source:
``csrc/decode_attention.cu`` (one block per (batch row, kv head); the group
of query heads shares each K/V tile; online softmax in float32; only the
``kv_len`` valid keys are read). Plain version:
``kernels/ref.py::decode_attention_ref``.

Bound on an H100: the valid K/V prefix read once, 2 B kv_len Hkv D
sizeof(T) bytes; at B=64, kv_len 4096, Hkv=2, D=64 in bf16, 134 MB or
40.1 µs at 3.35 TB/s. On the serve path (B <= 8, kv_len ~17) the launch
sets the time.

``kv_len`` is a host int shared by the batch (the engine's cache offset is
one), so a launch needs no device->host sync. CPU tensors take the plain
version; CUDA tensors launch the kernel (there is no fallback).
``decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention_ref

HEAD_DIMS = (32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448     # dynamic shared memory one block may take
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 8 + [_P]


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
    build.check_tensors("decode_attention", q.device, q=q, k_cache=k_cache,
                        v_cache=v_cache)
    lib = build.load("decode_attention")
    smem_fn = lib.decode_attention_smem_bytes
    smem_fn.argtypes, smem_fn.restype = [_I, _I], ctypes.c_longlong
    if smem_fn(hq // hkv, d) > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention: a group of {hq // hkv} query "
                         f"heads at D={d} needs more than the "
                         f"{MAX_SMEM_BYTES} B of shared memory of one block")
    out = torch.empty_like(q)
    fn = lib.decode_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), b, hq, hkv, d, s_max, kv_len, DTYPES[q.dtype],
            DTYPES[k_cache.dtype], torch.cuda.current_stream(q.device)
            .cuda_stream)
    build.check(lib, "decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
