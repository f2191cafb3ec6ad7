"""K1 ``diversity_insert`` — the Eq. 6 buffer ingest on the GPU.

Replaces the Pallas kernel ``repro/kernels/diversity.py:93``
(``diversity_insert``). CUDA source: ``csrc/diversity_insert.cu``. One
block of two warps per agent; slots, p_sum and candidates in shared memory
for the whole T-step chain. Candidates go in pairs: the slot t would take
is known before t is scored, so warp 0 factors t and t + 1 for both
outcomes of t in the same instructions (9 lanes a factor, the forward solve
as its ninth row), while warp 1 takes the three lowest slot scores and the
three KLs; one barrier a pair. Every value is formed as in the one-lane
kernel it replaces, so the results are that kernel's bit for bit. Plain
version: ``kernels/ref.py::diversity_insert_ref``.

Bound on an H100 at N=64, D=8, NA=15, T=10: ~7.7 KB read + ~6.9 KB written
per agent, ~9 µs of HBM time at A=2048 (3.35 TB/s); at small A the chain of
the factor's columns (one ``sqrtf``, one division and one shuffle each)
sets the time, at A=2048 the issue of the 32 warps an SM holds.

CPU tensors take the plain version; CUDA tensors launch the kernel (there
is no fallback). ``diversity_insert.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import diversity_insert_ref
from repro_torch.obs.trace import traced_kernel

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 21 + [_I] * 5 + [_F] * 3 + [_P]


def _check(x, name, shape, dtype):
    if x.device.type != "cuda":
        raise ValueError(f"diversity_insert: {name} is on {x.device}, "
                         f"expected a CUDA tensor")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"diversity_insert: {name} is {x.dtype} "
                         f"{tuple(x.shape)}, expected {dtype} {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"diversity_insert: {name} must be contiguous")


@traced_kernel("diversity_insert")
def diversity_insert(states, probs, score, filled, s_sum, s_outer, p_sum,
                     n_filled, cand_states, cand_probs, *, alpha, beta,
                     ridge=0.1):
    """Fused batch insert of T candidates per agent.

    states (A, N, D) f32, probs (A, N, NA) f32, score (A, N) f32, filled
    (A, N) bool, s_sum (A, D), s_outer (A, D, D), p_sum (A, NA) f32,
    n_filled (A,) int32, cand_states (A, T, D), cand_probs (A, T, NA) f32.
    Returns the updated (states, probs, score, filled, s_sum, s_outer,
    p_sum, n_filled) and the trace (slot (A, T) int32, do (A, T) bool,
    d (A, T) f32), as ``diversity_insert_ref``."""
    if states.device.type == "cpu":
        return diversity_insert_ref(states, probs, score, filled, s_sum,
                                    s_outer, p_sum, n_filled, cand_states,
                                    cand_probs, alpha=alpha, beta=beta,
                                    ridge=ridge)
    a, n, d = states.shape
    na, t = probs.shape[-1], cand_states.shape[1]
    f32 = torch.float32
    ins = ((states, "states", (a, n, d), f32),
           (probs, "probs", (a, n, na), f32),
           (score, "score", (a, n), f32),
           (filled, "filled", (a, n), torch.bool),
           (s_sum, "s_sum", (a, d), f32),
           (s_outer, "s_outer", (a, d, d), f32),
           (p_sum, "p_sum", (a, na), f32),
           (n_filled, "n_filled", (a,), torch.int32),
           (cand_states, "cand_states", (a, t, d), f32),
           (cand_probs, "cand_probs", (a, t, na), f32))
    for x, name, shape, dtype in ins:
        _check(x, name, shape, dtype)
    outs = (torch.empty_like(states), torch.empty_like(probs),
            torch.empty_like(score), torch.empty_like(filled),
            torch.empty_like(s_sum), torch.empty_like(s_outer),
            torch.empty_like(p_sum), torch.empty_like(n_filled),
            torch.empty((a, t), dtype=torch.int32, device=states.device),
            torch.empty((a, t), dtype=torch.bool, device=states.device),
            torch.empty((a, t), dtype=f32, device=states.device))
    lib = build.load("diversity_insert")
    fn = lib.diversity_insert_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(*(x.data_ptr() for x, *_ in ins), *(o.data_ptr() for o in outs),
            a, n, d, na, t, alpha, beta, ridge,
            torch.cuda.current_stream(states.device).cuda_stream)
    build.check(lib, "diversity_insert", rc)
    diversity_insert.launches += 1
    return outs


diversity_insert.launches = 0
