"""K6 ``pack`` — the frame/token packing row gather on the GPU.

Replaces the Pallas kernel ``repro/kernels/packing.py:34`` (``pack``).
CUDA source: ``csrc/pack.cu``: one warp per output row, eight rows per
block, a grid of at most the blocks the card holds at once; the indices of
32 rows come in one load and go out by shuffle; each lane issues all of its
row's loads before its stores (plain stores: the caller reads the bucket
next); a padding row is written as zeros and reads nothing. Raw-byte copies in 16-, 4- or
1-byte words, so every element type is copied bit for bit. Plain version:
``kernels/ref.py::pack_ref``; the two agree bit for bit.

Bound on an H100: the N output rows written, each distinct row of a
non-negative index read once and the indices: at T=4096, D=896 float32,
N=8192 with ~10 % padding drawn uniformly, ~3,480 distinct rows, 41.9 MB
or 12.5 µs at 3.35 TB/s from a cold table; HBM sets the time.

No module of the port calls it yet (nor of the JAX package, beyond its
kernel wrappers). CPU tensors take the plain version; CUDA tensors launch
the kernel (there is no fallback). ``pack.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pack_ref
from repro_torch.obs.trace import traced_kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I] * 2 + [ctypes.c_longlong, _P]


@traced_kernel("pack")
def pack(tokens, indices):
    """tokens (T, D) of any type; indices (N,) int32, negative = padding.
    Returns (N, D) with out[i] = tokens[indices[i]] (an index past T - 1
    reads row T - 1) and zero rows for padding."""
    if tokens.device.type == "cpu":
        return pack_ref(tokens, indices)
    if tokens.device.type != "cuda" or tokens.dim() != 2 or \
            indices.dim() != 1:
        raise ValueError(f"pack: tokens must be a (T, D) CUDA tensor and "
                         f"indices (N,), got {tuple(tokens.shape)} on "
                         f"{tokens.device} and {tuple(indices.shape)}")
    if indices.dtype != torch.int32:
        raise ValueError(f"pack: indices are {indices.dtype}, expected "
                         f"int32")
    t, d = tokens.shape
    n = indices.shape[0]
    if t < 1 or d < 1:
        raise ValueError(f"pack: tokens {tuple(tokens.shape)} is empty")
    if tokens.device != indices.device or not tokens.is_contiguous() or \
            not indices.is_contiguous():
        raise ValueError("pack: tokens and indices must be contiguous and on "
                         "one device")
    out = torch.empty((n, d), dtype=tokens.dtype, device=tokens.device)
    lib = build.load("pack")
    fn = lib.pack_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(tokens.data_ptr(), indices.data_ptr(), out.data_ptr(), t, n,
            d * tokens.element_size(),
            torch.cuda.current_stream(tokens.device).cuda_stream)
    build.check(lib, "pack", rc)
    pack.launches += 1
    return out


pack.launches = 0
