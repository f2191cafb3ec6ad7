"""K3 ``queue_advance`` — the twin's K-microtick data-plane advance on the GPU.

Replaces the Pallas kernel ``repro/kernels/queue_advance.py:50``
(``queue_advance``). CUDA source: ``csrc/queue_advance.cu``: a warp per
agent, up to 8 agents a block, in two phases. Lane i of warp 0 runs the
scalar chain of the K ticks for the block's agent i (every counter and
both credits; none of them reads the ring) and writes each tick's schedule
to shared memory, while the rings and histograms land by ``cp.async``;
then each agent's warp takes its requests completed in the interval, each
finding its completion tick and its arrival in the schedule, and rebuilds
the ring from the last writer of each slot. ``record=True`` also returns
the counters after every tick ((A, K, SIM_NCOUNTERS) int32, the request
attribution's input): the kernel's recording instantiation writes them
from the chains and a prefix of per-tick SLO counts; without it the
unrecorded instantiation runs, the kernel of before. Plain version:
``kernels/ref.py::queue_advance_ref``; the two agree bit for bit.

Precondition, met by every state the twin reaches from ``sim_init``:
monotone counters head <= p_inf <= launch <= p_pre <= tail with tail -
head <= R, and credits, caps and arrivals >= 0.

Bound on an H100 at R=512, H=64, K=20: 4,832 B per agent (each input read
once, each output written once), 0.0115 µs at A=8 and 2.95 µs at A=2048 of
HBM time (3.35 TB/s); recording writes 960 B more per agent (0.59 µs more
at A=2048); the chain of K dependent ticks and the requests'
searches of the schedule set the time.

CPU tensors take the plain version; CUDA tensors launch the kernel (there
is no fallback). ``queue_advance.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (SIM_NCAPS, SIM_NCOUNTERS, check_ring,
                                     queue_advance_ref)
from repro_torch.obs.trace import traced_kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 13 + [_I] * 4 + [_P]
# dynamic shared memory one block may take on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448
AGENTS_PER_BLOCK = 8     # csrc/queue_advance.cu


def _check(x, name, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"queue_advance: {name} is on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"queue_advance: {name} is {x.dtype} "
                         f"{tuple(x.shape)}, expected {dtype} {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"queue_advance: {name} must be contiguous")


@traced_kernel("queue_advance")
def queue_advance(arrive, counters, credits, lat_sum, hist, arrivals, caps,
                  record: bool = False):
    """Advance every agent's twin K microticks (the control interval).

    arrive (A, R) int32 with R a power of two, counters (A, SIM_NCOUNTERS)
    int32, credits (A, 2) float32, lat_sum (A,) float32, hist (A, H) int32,
    arrivals (A, K) int32, caps (A, SIM_NCAPS) float32. Returns new
    (arrive, counters, credits, lat_sum, hist), as ``queue_advance_ref``,
    and with ``record`` the counters after each tick, (A, K,
    SIM_NCOUNTERS) int32, as a sixth; the inputs are left as they were.
    The kernel assumes the twin's invariant (module docstring): monotone
    counters with tail - head <= R, and credits, caps and arrivals >= 0."""
    if arrive.device.type == "cpu":
        return queue_advance_ref(arrive, counters, credits, lat_sum, hist,
                                 arrivals, caps, record=record)
    if arrive.device.type != "cuda" or arrive.dim() != 2:
        raise ValueError(f"queue_advance: arrive must be an (A, R) CUDA "
                         f"tensor, got {tuple(arrive.shape)} on "
                         f"{arrive.device}")
    a, ring = arrive.shape
    check_ring(ring)
    hist_n, k = hist.shape[-1], arrivals.shape[-1]
    i32, f32, dev = torch.int32, torch.float32, arrive.device
    ins = ((arrive, "arrive", (a, ring), i32),
           (counters, "counters", (a, SIM_NCOUNTERS), i32),
           (credits, "credits", (a, 2), f32),
           (lat_sum, "lat_sum", (a,), f32),
           (hist, "hist", (a, hist_n), i32),
           (arrivals, "arrivals", (a, k), i32),
           (caps, "caps", (a, SIM_NCAPS), f32))
    for x, name, shape, dtype in ins:
        _check(x, name, shape, dtype, dev)
    if a < 1 or hist_n < 1:
        raise ValueError(f"queue_advance: needs A >= 1 agents and H >= 1 "
                         f"buckets, got A={a}, H={hist_n}")
    # a block's schedules and scalars, and one agent's ring, histogram and
    # tick sums (csrc/queue_advance.cu, shared_words and smem_bytes)
    nb = AGENTS_PER_BLOCK
    smem = ((((nb + 1) * (3 * k + 2) + nb * (SIM_NCOUNTERS + 2 + SIM_NCAPS)
              + 3) & ~3) + ((ring + hist_n + k + 3) & ~3)) * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"queue_advance: ring {ring}, histogram {hist_n} "
                         f"and {k} ticks need {smem} B of shared memory an "
                         f"agent, more than the {MAX_SMEM_BYTES} B one block "
                         f"may take")
    outs = tuple(torch.empty_like(x) for x, *_ in ins[:5])
    if record:   # its rows go out as 16-byte stores
        outs += (torch.empty((a, k, SIM_NCOUNTERS), dtype=i32, device=dev),)
        if outs[-1].data_ptr() % 16:
            raise ValueError("queue_advance: the tick buffer is not 16-byte "
                             "aligned")
    lib = build.load("queue_advance")
    fn = lib.queue_advance_launch
    fn.argtypes, fn.restype = _ARGTYPES, _I
    rc = fn(*(x.data_ptr() for x, *_ in ins), *(o.data_ptr() for o in outs),
            *(() if record else (None,)), a, ring, hist_n, k,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "queue_advance", rc)
    queue_advance.launches += 1
    return outs


queue_advance.launches = 0
