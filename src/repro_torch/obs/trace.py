"""Span tracing: the flight recorder's timeline layer.

Port of ``repro.obs.trace``. A ``Tracer`` collects phase-level spans —
timestamps on the host's ``time.perf_counter_ns`` timeline bracketing
regions of a run — and exports them as Chrome trace-event JSON that opens
in Perfetto / ``chrome://tracing``. The names, the event layout, the
tolerance for unmatched and open spans and ``validate_chrome_trace`` are
the JAX package's.

Where the spans come from:

* **Host spans** (``Tracer.span``): plain wall bracketing. The reference
  driver takes them around its sampled episodes, FL rounds and pod merges,
  and on the CPU every span site takes them.
* **Device spans** (``StampBuffer``): inside the graph driver's CUDA
  graphs a host-side range would run once, at capture, and never at a
  replay. There each end of a span is a ``span_stamp`` kernel, a node of
  the graph that writes the device's ``%globaltimer`` into a device buffer
  at the row of the sampled episode. The episode index and the sampling
  period are read from device memory, so one capture serves any sampling.
  ``drain()`` reads every buffer back in one transfer each and turns the
  stamps into complete (``X``) events on the host's timeline, through one
  offset taken when the buffer was attached (a stamp and two host readings
  around a synchronize).

Span sites: a traced body asks its ``sites`` object for ``span(name)``, a
context. ``HostSites`` (the CPU's, sampled on the host) and
``DeviceSites`` (a ``StampBuffer`` row picked by a device episode counter)
are the two kinds. With no tracer the drivers pass ``None`` and dispatch
exactly what they dispatch untraced.

Kernel spans (``kernel_span``): a kernel wrapper runs its work inside
``kernel/<name>`` when a traced body has bound its sites (``bind``: K2
inside ``fl/encode``), or at the top level under an active tracer
(``activate``) with ``kernel_spans=True``: there it is a host span that
synchronizes the device at its end, on every call (the JAX package does
not sample top-level kernel spans either). Inside any other body run by
``core/graphs.py`` (``quiet``) it records nothing, as the JAX package's
wrappers record nothing inside an un-instrumented trace; a wrapper never
records while its stream is being captured.

Spans never feed the numerics: a traced run computes the untraced run's
values bit for bit.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.span_stamp import span_stamp

# the activated tracers (``activate``) and the sites bound by traced bodies
# (``bind``) or ``QUIET`` (``quiet``), innermost last
_ACTIVE: List["Tracer"] = []
_BOUND: List[Any] = []
QUIET = object()


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


@contextmanager
def activate(tracer: Optional["Tracer"]):
    """Mark ``tracer`` active so top-level instrumentation (the kernel
    wrappers) records into it. ``None`` is a no-op, so callers can thread
    an optional tracer straight through."""
    if tracer is None:
        yield None
        return
    _ACTIVE.append(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.pop()


def active_tracer() -> Optional["Tracer"]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def bind(sites):
    """Make ``sites`` the span sites of the kernel wrappers called in the
    block (a traced body's; ``None`` is a no-op)."""
    if sites is None:
        yield
        return
    _BOUND.append(sites)
    try:
        yield
    finally:
        _BOUND.pop()


@contextmanager
def quiet():
    """The kernel wrappers called in the block record no span unless a
    traced body binds its sites inside it (a captured body's eager and
    capture calls)."""
    _BOUND.append(QUIET)
    try:
        yield
    finally:
        _BOUND.pop()


def kernel_span(name: str, device):
    """The context a kernel wrapper runs in: ``kernel/<name>`` against the
    bound sites, or against the active tracer with ``kernel_spans`` at the
    top level; otherwise a no-op."""
    if _BOUND:
        sites = _BOUND[-1]
        if sites is QUIET:
            return nullcontext()
        return sites.span(f"kernel/{name}", "kernel")
    tracer = active_tracer()
    if tracer is None or not tracer.kernel_spans:
        return nullcontext()
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return nullcontext()
    return host_span(tracer, f"kernel/{name}", device, "kernel")


@contextmanager
def host_span(tracer: "Tracer", name: str, device, cat: str = "phase"):
    """A host span that ends when ``device`` has finished the work issued
    in it (the JAX package blocks on its results inside the span)."""
    device = torch.device(device)
    with tracer.span(name, cat):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def traced_kernel(name: str, device_of=lambda x, *_, **__: x.device):
    """Decorate a kernel wrapper: its call runs inside ``kernel_span(name,
    device_of(*args, **kw))``. The wrapper's attributes (``launches``) are
    the decorated function's."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with kernel_span(name, device_of(*args, **kw)):
                return fn(*args, **kw)
        return call
    return wrap


def span_of(sites, name: str):
    """``sites.span(name)``, or a no-op without sites."""
    return nullcontext() if sites is None else sites.span(name)


# ---------------------------------------------------------------------------
# Span sites
# ---------------------------------------------------------------------------
class HostSites:
    """Host spans into ``tracer`` when ``when`` (the host knows the
    episode), else none."""

    def __init__(self, tracer: "Tracer", when: bool):
        self.tracer, self.when = tracer, bool(when)

    def span(self, name: str, cat: str = "phase"):
        return self.tracer.span(name, cat) if self.when else nullcontext()


class DeviceSites:
    """Device spans into ``buf`` at the row of the episode ``episode +
    delta`` (``episode``: a 0-dim int64 device tensor, read when the stamps
    run)."""

    def __init__(self, buf: "StampBuffer", episode: torch.Tensor,
                 delta: int):
        self.buf, self.episode, self.delta = buf, episode, int(delta)

    def span(self, name: str, cat: str = "phase"):
        return self.buf.span(name, self.episode, self.delta)


def calibrate(device) -> int:
    """The offset (ns) from ``device``'s ``%globaltimer`` to the host's
    ``perf_counter_ns``: one stamp between two host readings around a
    synchronize, the closest bracket of three."""
    device = torch.device(device)
    stamps = torch.zeros((1, 1), dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    one = torch.ones((), dtype=torch.int64, device=device)
    best = None
    for _ in range(3):
        torch.cuda.synchronize(device)
        h0 = time.perf_counter_ns()
        span_stamp(stamps, zero, one, 0)
        torch.cuda.synchronize(device)
        h1 = time.perf_counter_ns()
        if best is None or h1 - h0 < best[0]:
            best = (h1 - h0, (h0 + h1) // 2 - int(stamps[0, 0]))
    return best[1]


class StampBuffer:
    """Device stamps of the span ``sites`` ((name, cat) pairs) over the
    sampled episodes of one run: (rows, 2 * sites) int64 on a CUDA device,
    row j for the j-th sampled absolute episode at or after ``base``
    (episode ``e`` is sampled when ``e % tracer.span_sample_every == 0``;
    the period lives on the device, ``every``). Site i's begin stamp is
    column 2i and its end 2i + 1; 0 = not written. ``drain()`` turns the
    written pairs into events and clears the buffer."""

    def __init__(self, tracer: "Tracer", device, n_rows: int,
                 sites: Sequence[Tuple[str, str]], base: int = 0):
        device = torch.device(device)
        self.tracer, self.base = tracer, int(base)
        self.sites = tuple(sites)
        self.col = {name: 2 * i for i, (name, _) in enumerate(self.sites)}
        self.stamps = torch.zeros((max(int(n_rows), 1), 2 * len(sites)),
                                  dtype=torch.int64, device=device)
        self.every = torch.tensor(tracer.span_sample_every,
                                  dtype=torch.int64, device=device)
        self.offset_ns = calibrate(device)

    @contextmanager
    def span(self, name: str, episode: torch.Tensor, delta: int = 0):
        col = self.col[name]
        span_stamp(self.stamps, episode, self.every, col, delta=delta,
                   base=self.base)
        yield
        span_stamp(self.stamps, episode, self.every, col + 1, delta=delta,
                   base=self.base)

    def events(self) -> List[Dict[str, Any]]:
        """The written stamps as events, in one transfer; the buffer is
        cleared."""
        host = self.stamps.cpu().tolist()
        self.stamps.zero_()
        out, pid = [], self.tracer.pid
        for row in host:
            for i, (name, cat) in enumerate(self.sites):
                b, e = row[2 * i], row[2 * i + 1]
                if not b:
                    continue
                t0 = (b + self.offset_ns) / 1e3
                if not e:   # begun, never ended: an open span
                    out.append({"name": name, "cat": cat + "-open",
                                "ph": "i", "ts": t0, "s": "t", "pid": pid,
                                "tid": 0})
                    continue
                out.append({"name": name, "cat": cat, "ph": "X", "ts": t0,
                            "dur": max((e - b) / 1e3, 0.0), "pid": pid,
                            "tid": 0})
        return out


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------
class Tracer:
    """Flight-recorder event collector + Chrome trace-event exporter.

    ``span_sample_every``: record the drivers' per-episode spans only on
    every N-th absolute episode (on the card the period is read from device
    memory by the stamps). ``kernel_spans``: let the kernel wrappers record
    ``kernel/<name>`` spans when called at the top level under
    ``activate``. ``pid``: the trace's process id.

    Events live in memory as dicts; begin/end pairs are folded into
    complete ``X`` slices at ``_end`` time via a span stack (an end that
    skips stack levels closes the inner spans at the same timestamp; an
    unmatched end records an instant). Device spans come from the attached
    ``StampBuffer``s at ``drain()``.
    """

    def __init__(self, span_sample_every: int = 1,
                 kernel_spans: bool = False, pid: int = 1):
        if int(span_sample_every) < 1:
            raise ValueError(f"span_sample_every must be >= 1, got "
                             f"{span_sample_every}")
        self.span_sample_every = int(span_sample_every)
        self.kernel_spans = bool(kernel_spans)
        self.pid = pid
        self.events: List[Dict[str, Any]] = []
        self._stack: List[Tuple[str, str, float]] = []
        self._lock = threading.Lock()
        self._buffers: List[StampBuffer] = []

    def sampled(self, episode: int) -> bool:
        """Whether the drivers record absolute episode ``episode``."""
        return episode % self.span_sample_every == 0

    # -- recording ---------------------------------------------------------
    def _begin(self, name: str, cat: str):
        with self._lock:
            self._stack.append((name, cat, _now_us()))

    def _end(self, name: str):
        now = _now_us()
        with self._lock:
            while self._stack:
                n, cat, t0 = self._stack.pop()
                self.events.append({"name": n, "cat": cat, "ph": "X",
                                    "ts": t0, "dur": max(now - t0, 0.0),
                                    "pid": self.pid, "tid": 0})
                if n == name:
                    return
            # unmatched end: record an instant so the anomaly is visible
            self.events.append({"name": name, "cat": "unmatched-end",
                                "ph": "i", "ts": now, "s": "t",
                                "pid": self.pid, "tid": 0})

    def instant(self, name: str, cat: str = "mark"):
        self.events.append({"name": name, "cat": cat, "ph": "i",
                            "ts": _now_us(), "s": "t",
                            "pid": self.pid, "tid": 0})

    def add_complete(self, name: str, ts_us: float, dur_us: float,
                     cat: str = "request", pid: Optional[int] = None,
                     tid: int = 0, args: Optional[Dict] = None):
        """Append a pre-formed complete slice (the request-attribution
        exporter uses this with virtual twin-time timestamps)."""
        ev = {"name": name, "cat": cat, "ph": "X", "ts": float(ts_us),
              "dur": float(max(dur_us, 0.0)),
              "pid": self.pid if pid is None else pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "host"):
        """Host-side span: plain wall bracketing."""
        self._begin(name, cat)
        try:
            yield
        finally:
            self._end(name)

    def attach(self, device, n_rows: int, sites: Sequence[Tuple[str, str]],
               base: int = 0) -> StampBuffer:
        """A ``StampBuffer`` on ``device`` whose stamps ``drain()``
        collects."""
        buf = StampBuffer(self, device, n_rows, sites, base)
        self._buffers.append(buf)
        return buf

    # -- export --------------------------------------------------------------
    def drain(self):
        """Collect the device stamps, and flush any still-open host spans
        (e.g. the run was interrupted) as zero-duration instants so that
        the export is always well-formed."""
        for buf in self._buffers:
            self.events.extend(buf.events())
        with self._lock:
            while self._stack:
                n, cat, t0 = self._stack.pop()
                self.events.append({"name": n, "cat": cat + "-open",
                                    "ph": "i", "ts": t0, "s": "t",
                                    "pid": self.pid, "tid": 0})

    def chrome_events(self) -> List[Dict[str, Any]]:
        self.drain()
        return sorted(self.events, key=lambda e: e["ts"])

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (``traceEvents`` container
        format)."""
        return {"traceEvents": self.chrome_events(),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=float)
        return path

    def close(self):
        """Release the device buffers (their stamps are collected
        first)."""
        self.drain()
        self._buffers = []

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Schema validation
# ---------------------------------------------------------------------------
REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")
VALID_PH = {"X", "B", "E", "i", "I", "M", "C", "b", "e", "s", "t", "f"}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Structural check of a Chrome trace-event JSON object. Returns a list
    of problems (empty == valid): container shape, per-event required keys,
    known phase codes, numeric non-negative timestamps, ``X`` events carry
    a non-negative ``dur``."""
    problems: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["not a {'traceEvents': [...]} container"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [k for k in REQUIRED_KEYS if k not in ev]
        if missing:
            problems.append(f"event {i}: missing {missing}")
            continue
        if ev["ph"] not in VALID_PH:
            problems.append(f"event {i}: unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            problems.append(f"event {i}: bad ts {ev['ts']!r}")
        if ev["ph"] == "X" and (not isinstance(ev.get("dur"), (int, float))
                                or ev["dur"] < 0):
            problems.append(f"event {i}: X event without valid dur")
    return problems
