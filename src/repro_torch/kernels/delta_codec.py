"""K2 ``delta_codec`` — the FL error-feedback encode/decode on the GPU.

Replaces the Pallas kernel ``repro/kernels/delta_codec.py:41``
(``delta_codec``). CUDA source: ``csrc/delta_codec.cu``. One launch codes
every leaf of an FL round (``delta_codec_leaves``; up to ``MAX_LEAVES``
leaves a launch): the leaves' pointers, lengths and budgets travel in one
by-value kernel parameter, a row of up to 512 values takes a warp and a
longer row the block, and each thread holds 16 of its row's values in
registers, so each input is read once (int8: a max-reduce, then the
quantisation; topk: the k-th largest |x| found bit by bit on its bit
pattern by counts over the registers, then the index-ordered tie pass only
where the tied values do not all fit). ``delta_codec`` is the
one-leaf call, the counterpart of the Pallas function. Plain version:
``kernels/ref.py::delta_codec_ref`` per leaf; the two agree bit for bit.

Bound on an H100: 16 B per value per round; 72 KB per agent over one
iAgent's 12 leaves, 0.173 µs at A=8 and 44.3 µs at A=2048 of HBM time
(3.35 TB/s). At small A the launch and the longest row's reductions set
the time.

CPU tensors take the plain version; CUDA tensors launch the kernel (there
is no fallback). ``delta_codec.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import DELTA_CODECS, delta_codec_ref
from repro_torch.obs.trace import traced_kernel

MAX_LEAVES = 16      # leaves one launch takes (csrc/delta_codec.cu)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 3 + [_P]


def _check_codec(codec):
    if codec not in DELTA_CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of "
                         f"{DELTA_CODECS}")


@traced_kernel("delta_codec",
               lambda ds, *_, **__: ds[0].device if len(ds) else "cpu")
def delta_codec_leaves(deltas: Sequence[torch.Tensor],
                       residuals: Sequence[torch.Tensor], *, codec: str,
                       ks: Sequence[int]
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Error feedback + encode + decode of every leaf of a round: leaf i is
    (A, L_i) float32 rows ``deltas[i]`` and ``residuals[i]`` with top-k
    budget ``ks[i]`` (topk codec). Returns the lists (decoded,
    new_residual). On the GPU one launch per ``MAX_LEAVES`` leaves."""
    _check_codec(codec)
    n = len(deltas)
    if len(residuals) != n or len(ks) != n or n == 0:
        raise ValueError(f"delta_codec: {n} deltas, {len(residuals)} "
                         f"residuals and {len(ks)} budgets; expected the "
                         f"same number, at least one")
    dev = deltas[0].device
    if dev.type == "cpu":
        pairs = [delta_codec_ref(d, r, codec=codec, k=k)
                 for d, r, k in zip(deltas, residuals, ks)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    a = deltas[0].shape[0] if deltas[0].dim() == 2 else -1
    for i, (d, r) in enumerate(zip(deltas, residuals)):
        for x, name in ((d, "delta"), (r, "residual")):
            if x.device != dev or x.device.type != "cuda" \
                    or x.dtype != torch.float32 or x.dim() != 2 \
                    or x.shape[0] != a or not x.is_contiguous():
                raise ValueError(
                    f"delta_codec: {name} {i} must be a contiguous (A, L) "
                    f"float32 tensor on {dev} with A={a}, got {x.dtype} "
                    f"{tuple(x.shape)} on {x.device}")
        if r.shape != d.shape:
            raise ValueError(f"delta_codec: delta and residual {i} differ "
                             f"in shape")
    decs = [torch.empty_like(d) for d in deltas]
    ress = [torch.empty_like(d) for d in deltas]
    ptrs = lambda xs: (_P * n)(*(x.data_ptr() for x in xs))
    ints = lambda xs: (_I * n)(*xs)
    lib = build.load("delta_codec")
    fn = lib.delta_codec_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(ptrs(deltas), ptrs(residuals), ptrs(decs), ptrs(ress),
            ints([d.shape[1] for d in deltas]), ints(ks), n, a,
            DELTA_CODECS.index(codec),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "delta_codec", rc)
    delta_codec.launches += -(-n // MAX_LEAVES)
    return decs, ress


def delta_codec(delta, residual, *, codec: str, k: int = 1):
    """Error feedback + encode + decode of one leaf's (A, L) float32 rows.
    ``k`` is the top-k budget (topk codec). Returns (decoded,
    new_residual)."""
    (dec,), (res,) = delta_codec_leaves([delta], [residual], codec=codec,
                                        ks=[k])
    return dec, res


delta_codec.launches = 0
