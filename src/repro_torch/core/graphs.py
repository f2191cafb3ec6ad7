"""Captured bodies: the port's counterpart of a jitted ``lax.scan`` body.

A ``GraphedBody`` wraps a function of no arguments that reads and writes
only tensors which outlive it (static inputs, state copied back in place,
history rows written at a device-side counter). On a CUDA device its first
call runs the body eagerly on a side stream — a real step of the run, and
the warm-up capture asks for — and captures it as a CUDA graph right
after; every later call replays the graph, one host launch. On the CPU
every call runs the body eagerly.

Capture runs nothing, so the kernel wrappers' launch counters, which count
in Python, would count the capture and not the replays: the counts a
capture adds are taken back and added once per replay instead (so is the
count of a meshed fleet's collectives, NCCL calls that the graph holds). Generators
the body draws from are registered with the graph, so each replay advances
their Philox offsets exactly as an eager call does. Python's cyclic
garbage collector is off during a capture: a graph left in a reference
cycle (a body bound to its driver) that the collector freed mid-capture
would destroy its executable graph and memory pool, calls that invalidate
the capture. A capture error (a host sync, an allocation the stream
cannot record) raises: there is no fallback to eager execution. A body
runs under ``obs.trace.quiet()``: the kernel wrappers it calls record a
span only where the body binds its own span sites (a traced driver's).
"""
from __future__ import annotations

import gc
import time
from contextlib import contextmanager
from dataclasses import fields, is_dataclass
from typing import Callable, Dict, Sequence

import torch

from repro_torch.distributed.sharding import COLLECTIVES
from repro_torch.kernels.delta_codec import delta_codec
from repro_torch.kernels.diversity import diversity_insert
from repro_torch.kernels.queue_advance import queue_advance
from repro_torch.kernels.span_stamp import span_stamp
from repro_torch.obs import trace as obs_trace

# the kernel wrappers a captured body of this package may launch, and the
# count of the fleet's collectives (a meshed fleet's bodies issue them)
COUNTED = (diversity_insert, delta_codec, queue_advance, span_stamp,
           COLLECTIVES)


class GraphedBody:
    """``body`` run eagerly once, then captured and replayed (CUDA), or run
    eagerly every time (CPU). ``generators``: the CUDA generators the body
    draws from. ``capture_s`` is the wall time of the capture (the eager
    first call excluded); ``replays`` counts host graph launches."""

    def __init__(self, body: Callable[[], None], device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.body, self.device = body, torch.device(device)
        self.generators = tuple(generators)
        self.graph = None
        self.launches: Dict[object, int] = {}   # kernel launches per replay
        self.capture_s = 0.0
        self.replays = 0

    def __call__(self) -> None:
        if self.device.type != "cuda":
            with obs_trace.quiet():
                self.body()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            self.replays += 1
            for fn, n in self.launches.items():
                fn.launches += n

    def release(self) -> None:
        """Free the captured graph (a later call captures anew). A graph
        that captured NCCL collectives holds its communicator: NCCL's
        destruction of the communicator waits until every such graph is
        freed, so a meshed run's graphs are released before its process
        group is destroyed."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
            self.graph = None

    def _warm_up_and_capture(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), obs_trace.quiet():
            self.body()
        main.wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = {fn: fn.launches for fn in COUNTED}
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="global"), \
                    obs_trace.quiet():
                self.body()
            self.launches = {fn: fn.launches - n for fn, n in before.items()
                             if fn.launches != n}
        finally:
            if collecting:
                gc.enable()
            for fn, n in before.items():      # the capture launched nothing
                fn.launches = n
        self.capture_s = time.perf_counter() - t0
        self.graph = graph


@contextmanager
def full_float32():
    """float32 matrix products in full precision (no TF32) on the card, as
    on the CPU; the previous settings are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def copy_into(dst, src, path: str = "") -> None:
    """Copy ``src`` into the tensors of ``dst`` in place, walking
    dataclasses, dicts and tensors of the same layout (the static carry:
    what a new-state return would rebind). Shared objects are skipped. A
    tensor whose dtype differs from its destination's raises, naming the
    leaf: a silent cast would store what the other driver does not."""
    if dst is src:
        return
    if torch.is_tensor(dst):
        if src.dtype != dst.dtype:
            raise TypeError(f"copy_into: {path or 'tensor'} is {src.dtype}, "
                            f"its destination {dst.dtype}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            copy_into(v, src[k], f"{path}.{k}" if path else str(k))
    elif is_dataclass(dst):
        for f in fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name),
                      f"{path}.{f.name}" if path else f.name)
    else:
        raise TypeError(f"copy_into: cannot copy into {type(dst).__name__}")
