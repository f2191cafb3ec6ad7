"""K2 ``delta_codec`` — the FL error-feedback encode/decode on the GPU.

Replaces the Pallas kernel ``repro/kernels/delta_codec.py:41``
(``delta_codec``). CUDA source: ``csrc/delta_codec.cu`` (one block per
agent row; int8 by a block max-reduce, topk by a radix select on the bit
pattern of |x| and an index-ordered tie pass). Plain version:
``kernels/ref.py::delta_codec_ref``; the two agree bit for bit.

Bound on an H100: 16 B per value per round; 72 KB per agent over one
iAgent's 12 leaves, ~44 µs of HBM time at A=2048 (3.35 TB/s). At small A
the one launch per leaf dominates.

CPU tensors take the plain version; CUDA tensors launch the kernel (there
is no fallback). ``delta_codec.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import DELTA_CODECS, delta_codec_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 4 + [_P]


def delta_codec(delta, residual, *, codec: str, k: int = 1):
    """Error feedback + encode + decode of (A, L) float32 rows. ``k`` is
    the top-k budget (topk codec). Returns (decoded, new_residual)."""
    if codec not in DELTA_CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of "
                         f"{DELTA_CODECS}")
    if delta.device.type == "cpu":
        return delta_codec_ref(delta, residual, codec=codec, k=k)
    for x, name in ((delta, "delta"), (residual, "residual")):
        if x.device.type != "cuda" or x.dtype != torch.float32 \
                or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"delta_codec: {name} must be a contiguous "
                             f"(A, L) float32 CUDA tensor, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if residual.shape != delta.shape or residual.device != delta.device:
        raise ValueError("delta_codec: delta and residual differ in shape "
                         "or device")
    a, l = delta.shape
    dec, res = torch.empty_like(delta), torch.empty_like(delta)
    lib = build.load("delta_codec")
    fn = lib.delta_codec_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(delta.data_ptr(), residual.data_ptr(), dec.data_ptr(),
            res.data_ptr(), a, l, DELTA_CODECS.index(codec), k,
            torch.cuda.current_stream(delta.device).cuda_stream)
    build.check(lib, "delta_codec", rc)
    delta_codec.launches += 1
    return dec, res


delta_codec.launches = 0
