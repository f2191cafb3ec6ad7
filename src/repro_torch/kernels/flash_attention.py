"""K4 ``flash_attention`` — causal / bidirectional GQA attention on the GPU.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:112``
(``flash_attention`` -> ``flash_attention_bhsd`` :74). CUDA source:
``csrc/flash_attention.cu``: one block per (q tile, q head, batch row), a
loop over KV tiles with an online softmax in float32, KV tiles above the
causal diagonal skipped; query head h reads kv head h // group, no repeated
KV in device memory. bf16 runs on the tensor cores (``wgmma``, K/V tiles
through a TMA ring signalled by mbarriers, P rounded to bf16 before P V;
its plain form is ``kernels/ref.py::flash_attention_bf16p_ref``); float32
on the CUDA cores in float32. Plain version:
``kernels/ref.py::flash_attention_ref``.

Bound on an H100: 4 B Hq Sq Sk D flops (halved under the causal mask); at
the prefill shape B=4, S=2048, Hq=14, Hkv=2, D=64 in bf16, 30.1 GFLOP per
layer or 30.4 µs at 989 TFLOP/s.

CPU tensors take the plain version; CUDA tensors launch the kernel (there
is no fallback). ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import DTYPES, HEAD_DIMS
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.obs.trace import traced_kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 8 + [_P]


@traced_kernel("flash_attention")
def flash_attention(q, k, v, *, causal=True):
    """q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D), one type (float32 or bf16).
    Returns (B, Sq, Hq, D) in that type; causal masking is aligned at
    position 0 (query i sees keys j <= i)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda" or q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-d CUDA "
                         f"tensors, got {tuple(q.shape)} / {tuple(k.shape)} "
                         f"on {q.device}")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or \
            sq < 1 or sk < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         f"(B, Sq, Hq, D) and (B, Sk, Hkv, D)")
    if hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v are {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; expected one type, float32 or "
                         f"bfloat16")
    if b > 65535 or hq > 65535:
        raise ValueError(f"flash_attention: B={b} and Hq={hq} must be at "
                         f"most 65535 (grid dimensions)")
    build.check_tensors("flash_attention", q.device, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, hq, hkv, d, int(bool(causal)), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
