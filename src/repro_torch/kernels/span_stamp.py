"""Span stamps — the flight recorder's device clock on the GPU.

Replaces no TPU kernel: the JAX package times its compiled run's phases
with host callbacks (``repro/obs/trace.py``), which a CUDA graph cannot
replay (a host-side range runs once, at capture). CUDA source:
``csrc/span_stamp.cu``: one thread reads the absolute episode index
``*episode + delta`` and the sampling period ``*every`` from device memory
and, on a sampled episode, writes ``%globaltimer`` (ns) to its row's
``slot`` of ``stamps``. The span sites of ``repro_torch.obs.trace`` launch
it in pairs, as nodes of the driver's graphs. Plain version:
``span_stamp_ref`` (the same row arithmetic, writing a given clock value);
the two write the same positions.

Bound: 24 B a stamp; a stamp's cost is its launch (a graph node).

There is no stamp kernel on the CPU: CPU span sites take host spans. CUDA
tensors launch the kernel (there is no fallback); ``span_stamp.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _L, _L, _I, _I, _I, _P]


def _row(episode, every, delta: int, base: int):
    """(row, written) of the stamp: the kernel's arithmetic on tensors."""
    e = episode.to(torch.int64) + delta
    k = every.to(torch.int64)
    ok = (k >= 1) & (e >= base) & (torch.remainder(e, k.clamp_min(1)) == 0)
    row = torch.div(e, k.clamp_min(1), rounding_mode="floor") - torch.div(
        base + k - 1, k.clamp_min(1), rounding_mode="floor")
    return row, ok


def span_stamp_ref(stamps, episode, every, slot: int, *, delta: int = 0,
                   base: int = 0, clock=None):
    """Plain version of the stamp: writes ``clock`` (a 0-dim int64 tensor)
    where the kernel writes ``%globaltimer``, in place."""
    row, ok = _row(episode, every, delta, base)
    ok = ok & (row < stamps.shape[0])
    at = (row.clamp(0, stamps.shape[0] - 1) * stamps.shape[1] + slot).view(1)
    flat = stamps.view(-1)
    flat.index_copy_(0, at, torch.where(ok, clock, flat.index_select(0, at)))
    return stamps


def span_stamp(stamps, episode, every, slot: int, *, delta: int = 0,
               base: int = 0):
    """Stamp the device clock into ``stamps`` ((rows, slots) int64 on a
    CUDA device) at row ``episode // every - ceil(base / every)``, column
    ``slot``, where ``episode = *episode + delta`` is at least ``base`` and
    a multiple of ``*every`` (``episode`` and ``every``: 0-dim int64 CUDA
    tensors, read when the kernel runs). Returns ``stamps``."""
    if stamps.device.type != "cuda":
        raise ValueError(f"span_stamp: stamps is on {stamps.device}; the "
                         f"stamp kernel runs on CUDA only (CPU spans are "
                         f"host spans)")
    if stamps.dtype != torch.int64 or stamps.dim() != 2 or \
            not stamps.is_contiguous():
        raise ValueError(f"span_stamp: stamps must be a contiguous (rows, "
                         f"slots) int64 tensor, got {stamps.dtype} "
                         f"{tuple(stamps.shape)}")
    for x, name in ((episode, "episode"), (every, "every")):
        if x.device != stamps.device or x.dtype != torch.int64 or \
                x.numel() != 1:
            raise ValueError(f"span_stamp: {name} must be one int64 on "
                             f"{stamps.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    lib = build.load("span_stamp")
    fn = lib.span_stamp_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(stamps.data_ptr(), episode.data_ptr(), every.data_ptr(), delta,
            base, stamps.shape[0], stamps.shape[1], slot,
            torch.cuda.current_stream(stamps.device).cuda_stream)
    build.check(lib, "span_stamp", rc)
    span_stamp.launches += 1
    return stamps


span_stamp.launches = 0
