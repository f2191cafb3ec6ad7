"""Flight recorder: span tracing, cost and memory accounting, and
request-grade latency attribution.

Port of ``repro.obs``. Three layers over the same run:

* ``repro_torch.obs.trace`` — phase-level spans (episode -> fl_round
  uplink / encode / aggregate / finetune -> pod merge, plus per-kernel
  spans): host spans on the CPU and in the reference driver, device clock
  stamps inside the graph driver's CUDA graphs; exported as Chrome
  trace-event JSON (Perfetto / chrome://tracing).
* ``repro_torch.obs.profile`` — the operations and bytes of one episode
  and one round of the graph driver, its memory high-water mark, the
  in-place audit of the fleet's state, the per-policy memory report, and
  the kernels' operation and byte counts from their shapes.
* ``repro_torch.obs.requests`` — per-request lifecycle records
  reconstructed from the twin's per-microtick counters (the recording K3),
  decomposing tail latency into per-stage delays.

``core`` may import ``repro_torch.obs.trace``; the other two layers sit
above ``core`` / ``sim`` and are not imported from them.
"""
from repro_torch.obs.trace import (Tracer, activate, active_tracer,
                                   validate_chrome_trace)

__all__ = ["Tracer", "activate", "active_tracer", "validate_chrome_trace"]
