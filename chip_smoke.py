#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

In order, it:
  1. prints the card's name and power limit (nvidia-smi) and fails without
     CUDA;
  2. builds every kernel of the port from ``src/repro_torch/csrc``, and K1
     and K3 once more with their phase marks defined as clock64 stamps (one
     nvcc per build, all started together), and prints the ptxas reports;
  3. holds K1 ``diversity_insert`` against its plain PyTorch version on the
     card at A=8 and A=2048 (T=10, N=64) from empty, half-full and full
     buffers: identical decision traces (a first divergence is accepted only
     at a near-tie, score gap below 1e-5 relative) and floats within
     rtol 1e-4 / atol 1e-5; then reads the stamped K1's cycles per phase
     on full buffers at A=8 and A=2048;
  4. holds K2 ``delta_codec`` against its plain version bit for bit in all
     three codecs at all 12 leaf sizes of one iAgent, at A=8 and A=2048,
     through ``delta_codec_leaves`` (one launch for the 12 leaves, as the
     trainer calls it; random data, a grid with exact int8 halfway cases
     and |x| ties, and rows with NaN, +-inf or zeros);
  5. holds K3 ``queue_advance`` against its plain version bit for bit at
     A=8 and A=2048 (R=512, H=64, K=20), ten intervals chained from empty
     pipelines in three regimes (idle, nominal, overload with drops and a
     full post queue), with conservation checked, and its recording
     instantiation (``record=True``: the counters after every tick) bit
     for bit against the plain version's, its state equal to the
     unrecorded kernel's; then reads the stamped K3's cycles per phase on
     the nominal regime's loaded state;
  6. times each kernel, its plain version and (K2 topk) ``torch.topk`` at
     the main path's shapes: device time by CUDA-graph replay (CUDA
     events; K1, K2 and K3 the median of five readings at 1 and at 20
     calls per graph, K2 a call being one round of 12 leaves), and the
     eager per-call time with the host's launch cost;
  7. drives ``repro_torch.launch.train_fleet`` at its defaults (8 agents,
     2 pods, 20 episodes), then with ``--fl-codec int8`` and ``--fl-codec
     topk``, each under the default ``--driver scan`` (the episode, FL
     round and pod merge as CUDA graphs) and then ``--driver reference``,
     with every launch count set to 0 just before each run and read just
     after: under both drivers K1 must launch once per episode, K2 once
     per FL round, K3 never; the histories must be finite and equal
     between the drivers; prints ms per episode with the graphs' capture
     time apart;
  8. drives the twin: ``train_fleet --env-backend twin`` (20 episodes, K3
     once per control interval, both drivers), then
     ``repro_torch.launch.simulate`` at its defaults (60 intervals, the
     interval body one CUDA graph, K3 once per interval) and after four
     twin-trained episodes with ``--compare-fluid``; summaries finite,
     requests conserved for every agent;
  9. times ten episodes of the default fluid run and of the twin run under
     each driver alone, then ten more under ``torch.profiler`` (the graph
     driver's after eight that capture its three graphs), and
     ``simulate_fleet`` graphed and as an eager loop the same way: host
     wall, capture time, device busy share (against the wall alone too:
     the profiler slows graph replays), kernels and host graph launches
     per episode, the kernels taking the most device time, and the launch
     counters against the profiler's count of each kernel;
 10. ``[graph parity]``: the graph driver against the reference driver on
     the card (A=8, P=2, ``fl_every=1``, eight episodes: two pod merges,
     int8, stragglers, noise from the fleet's generator), fluid and twin:
     identical actions, histories and final state bit for bit, equal
     launch counts;
 11. checks small runs (A=4, P=2, int8 codec, pre-drawn action noise) on
     the card against the same runs on the CPU (plain versions): the fluid
     trainer, and the twin trainer with its final twin state exactly equal
     (a first action divergence is accepted only at a near-tie of the
     Gumbel-max scores, and reported);
 11b. ``[chaos]``, the slice of the FL round's transport and chaos layers:
     ``train_fleet`` with ``--fl-codec int8 --fl-deadline-s 0.002
     --fl-async --robust-agg trimmed --clip-factor 3`` and crash (0.1),
     byzantine (0.25, sign_flip) and partition (0.3) faults, fluid and
     twin, ten episodes under both drivers (K1 once per episode, K2 once
     per round, K3 once per twin interval, equal histories); the graph
     driver against the reference driver bit for bit (A=8, eight
     episodes); the card against the CPU (A=4, eight episodes: histories
     within rtol 1e-3 / atol 1e-4, actions, timers and parked-upload masks
     identical); ten profiled episodes of the graph driver (ms per
     episode, busy share, capture time, at most three graph launches per
     replayed episode);
 11c. ``[state dtype]``: ``train_fleet --state-dtype bf16`` and ``lean``
     with ``--fl-codec int8``, fluid and twin, ten episodes under both
     drivers (K1 once per episode, K2 once per round, K3 once per twin
     interval, as without a policy; histories bit for bit between the
     drivers); the graph driver against the reference driver bit for bit
     per policy over four episodes, plain and under the chaos slice with
     byzantine noise
     (every leaf at its stored dtype, both generators' states equal); a
     float32-policy fleet against the default fleet bit for bit; the card
     against the CPU per policy (A=4, histories within rtol 1e-2 / atol
     1e-3); ten profiled episodes of the graph driver per policy;
 11d. ``[resume]``: ``train_fleet --state-dtype lean`` with the chaos
     slice, byzantine noise, ``--health`` and ``--metrics-out``, 20
     episodes, straight through and killed by ``--stop-after 7`` at
     ``--ckpt-every 5`` and rerun: histories, the final checkpoint
     (generator and health states included) and the streamed episode
     records bit for bit; that checkpoint restores on the CPU;
 11e. ``[state bytes]``: ``fleet_state_bytes`` by family, the allocated
     memory of a built fleet and a checkpoint's save / restore time and
     size per policy at A=8 and A=2048 (lean at least 2x smaller per agent
     than float32 at A=2048);
 11f. ``[health]``: ``train_fleet --health --metrics-out --alerts-out``,
     fluid and twin, ten episodes under both drivers (bit for bit), then
     with the chaos flags and ``--susp-threshold 0.5``: K1, K2 and K3
     launch as in the same runs without health; the graph driver against
     the reference driver with health, plain and gated (four episodes;
     bit for bit, equal launches and streamed records); the card against the CPU at A=4
     (health counts identical; the suspicion per agent and round, an
     agent left out from a round whose leave-one-out reference is under
     ``LOO_SHARE`` of the reference); the ops the
     episode and round bodies dispatch without ``--health`` equal to the
     parent port's (``PARENT_BODY_OPS``), and with it; ten profiled
     episodes of the graph driver with and without ``--health`` per
     backend;
 11g. ``[metrics]``: the CLI's JSONL records equal its returned history
     under both drivers, with the trailing scaling record; ``watch``
     renders the file; ms per replayed episode with the sink against
     without it (off, on, on, off); the stream with a ring of two slots
     (the host waits, every record once and in order); ten profiled
     episodes with health and the sink (at most three graph launches an
     episode);
 11h. ``[leaderboard]``: the ``[main path]`` default run checkpointed at
     its end, loaded with ``load_fleet`` and scored on {steady, burst} ×
     {fluid, twin} × {float32, int8} (one replicate) twice: finite rows,
     equal between the calls;
 11i. the flight recorder. ``[stamp]``: ``span_stamp`` writes exactly its
     plain version's slots (only sampled episodes), monotone stamps, the
     clock's resolution from 2,000 stamps in one graph, its time;
     ``[trace]``: ``train_fleet --trace-out`` at the CLI default, fluid
     and twin, both drivers, ``--trace-sample`` 1 and 2 (valid traces,
     span counts and nesting, histories bit for bit against untraced,
     graph launches per episode unchanged, the graph driver's stamp
     launches equal at either sampling), then 200 replayed episodes
     traced against 200 untraced in eight alternating turns, a profiled
     window of each (kernels per episode up by the stamp nodes, the stamp
     kernels' device time) and the episode spans against the wall; ``[attribution]``: ``simulate --attribution --trace-out`` (K3
     once per interval, conservation exact for every agent), the recorded
     run card against CPU exactly on one noise, ms per interval recorded
     against not; ``[obs profile]``: ``fleet_memory_report`` at A=2048,
     P=8 (peak memory, the in-place audit);
 11j. the paper's comparison set. ``[ablation]``: K2 over the single
     head's 8-leaf round bit for bit; ``FCPOConfig(single_head=True)`` at
     A=8, P=2, int8, 20 episodes, fluid and twin, under both drivers (K1
     once per episode, K2 once per round, K3 once per twin interval;
     histories and final state bit for bit between the drivers); graph
     parity with recorded actions; A=4 card runs against the CPU.
     ``[baselines]``: K1 at BCEdge's N=700, NA=13 against its plain
     version (empty, half-full, full; timed); ``run_bcedge`` (20 offline
     episodes), ``run_octopinf`` and ``run_distream`` at n=8 on
     ``DYNAMIC`` traces, fluid and twin, with launch counts, ms per
     runtime interval, and the static policies card vs CPU.
     ``[oracles]``: ``sim_interval_agent`` (K3 at A=1) against
     ``sim_interval_ref`` and ``sim/oracle.py``; ``buffer_insert`` (K1 at
     T=1) against ``buffer_insert_reference`` (near-tie rule);
 11k. ``[mesh]``: ``train_fleet --mesh fleet`` on one NCCL rank (the
     CLI default, 20 episodes, fluid, twin and int8; the graph driver
     captures the collectives) against ``--mesh none`` bit for bit
     (histories, the whole final fleet, K1–K3 launches), ``--mesh debug``
     likewise, ``--mesh production`` raising; ten replayed episodes meshed
     and meshless in turns (ms per episode, at most three graph launches
     an episode, the collectives of each graph, the profiler's NCCL
     kernels, copies and kernels per episode); then two gloo ranks
     spawned on the card (``chip_smoke.py --mesh-rank``: A=8, P=2, int8,
     stragglers 0.3, eight episodes, the reference driver) against the
     meshless card run within rtol/atol 1e-5, two balanced
     ``fleet_device_bytes`` entries, K1 / K2 once per episode / round on
     each rank, and the graph driver refusing the gloo mesh;
 12. holds K5 ``decode_attention`` and K4 ``flash_attention`` against their
     plain versions (the JAX tests' sweeps, K4's bf16 tensor-core path on
     every shape of the sweep, K5 with several splits and the combine, the
     invalid cache tail, and the full-width qwen2-0.5b shapes: K5 on the
     serve path and at B=64 / S_max 4096, K4 at B=4, S=2048) within
     rtol = atol = 2e-5 in float32 and 2e-2 in bf16, and K6 ``pack`` bit
     for bit (every word path, all-padding, one row, bf16 rows); times
     each, its plain version and a PyTorch call of the same function
     (``scaled_dot_product_attention``, ``index_select``) as the median of
     five readings, K5, K6 and ``index_select`` also with 20 calls per
     graph (the graph's own launch out); K6 and ``index_select`` read
     their token tables cold (four tables, more than the L2 holds, in
     turn);
 13. drives ``repro_torch.launch.serve`` at its defaults (qwen2-0.5b full
     width, 4 replicas, 30 episodes): K5 once per layer per decode step,
     K1 once per episode, the others never;
 14. runs the cache-less prefill step at full width (B=4, S=2048; K4 once
     per layer) against the same step on ``sdpa``, in bf16 and float32;
     then the engine at its default buckets (B=8, 128-token prompt, 32 new
     tokens: prefill ms, decode ms per step, tokens/s; the decode step's
     device time less its weight-streaming term, ``LatencyModel``'s
     overhead); then a reduced model on the card against the CPU
     (identical tokens up to a near-tie, logits within rtol 1e-3 / atol
     1e-4);
 14b. the rest of the transformer family, each phase freeing the last
     model first. ``[moe serve]``: ``repro_torch.launch.serve --arch
     deepseek-v2-lite-16b`` at its defaults (4 replicas, 30 episodes),
     full width and depth (15,706,484,224 parameters checked): K1 once
     per episode, K2–K6 never (MLA and the experts are plain torch ops, as
     in the reference), peak bytes, t0 / t1, ms per ``generate``; on the
     launcher's own engine, one MoE layer's expert casts timed and one
     ``generate`` profiled; then K1 against its plain version at the
     launcher's A=4. ``[archs]``:
     granite-moe-3b-a800m, qwen2-7b, gemma-7b, pixtral-12b and
     qwen1.5-0.5b at full width and depth, each: its parameter count,
     the cache-less prefill at B=4, S=2048 (K4 once per layer) against
     ``use_kernels=False`` in bf16 (max |diff|, argmax agreement) and in
     float32 (within rtol / atol 1e-3, argmax agreement, and the bf16
     runs' agreement with the float32 plain run), four float32 decode
     steps (K5 once per layer per step) against ``use_kernels=False``
     in the same band, the engine at B=8, a 128-token prompt and 32 new
     tokens (K5 once per layer per decode step), ms per call, peak bytes;
     then K4 and K5 at the config's bf16 shapes against plain (the
     kernel tests' tolerance) and timed. ``[encode]``: hubert-xlarge
     through ``make_encode_step`` at B=4, S=2048 (K4 bidirectional at
     D=80 once per layer) against ``use_kernels=False`` in bf16 and in
     float32 (the same band), also with HuBERT's mask; K4 at that shape
     against plain and timed. ``[MoE reference]``:
     reduced deepseek-v2-lite and granite (2 layers, float32) card vs
     CPU: tokens under the near-tie rule, the first MoE layer's routing
     (top-k, keep, slots) equal, two card runs bit for bit. ``[ssm
     serve]``: ``launch/serve --arch zamba2-1.2b`` and ``--arch
     xlstm-125m`` at full width and depth (K1 once an episode; zamba2's
     shared attention block K5 six times a decode step; xlstm no
     attention kernel), zamba2 through the ``[archs]`` checks (the
     cache-less prefill at B=4, S=2048 with K4 six times against
     ``use_kernels=False`` in bf16 and in float32 under ``assert_close``,
     four float32 decode steps on K5, the engine at B=8, K4 / K5 at its
     MHA D=64 shapes against plain and timed), and both reduced, card vs
     CPU (tokens under the near-tie rule). ``[lm train]``:
     ``launch/train --arch zamba2-1.2b`` at full width and depth for 10
     steps of batch 8 x seq 128 (finite, falling loss; ms per step,
     tokens/s, peak bytes), ``--grad-compression`` in a world of one,
     six steps of xlstm-125m at full width whose step-3 checkpoint
     resumed with ``--resume`` equals the straight run bit for bit, and
     reduced zamba2 / xlstm card vs CPU from the same
     numpy params (losses, grad norms, lrs, params and moments in rtol
     1e-3 / atol 1e-4, an AdamW near-zero-gradient step allowed to flip);
     training launches no kernel (the plain path, as in the reference);
 15. prints the kernel table as one JSON line (with the recording K3, the
     span stamp, K1 on the deepseek serve path and K4 / K5 at each
     served model's shapes, zamba2's included, as rows of their own), then
     ``{"ok": true, "device": {...}}`` as the last line.
Any failure raises and exits non-zero.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import math
import string
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
LEAF_SIZES = (512, 64, 3072, 48, 48, 1, 192, 4, 364, 7, 208, 4)
# the Fig. 12 single head: the backbone and value leaves, then head_res
# over the 4 x 7 x 4 joint actions
SINGLE_HEAD_LEAF_SIZES = (512, 64, 3072, 48, 48, 1, 5376, 112)
RTOL, ATOL = 1e-4, 1e-5
NEAR_TIE = 1e-5
DEV = "cuda"
# the slice of the FL round's transport and chaos layers (its CLI flags);
# the deadline drops the four slowest links of the int8 uploads at A=8
CHAOS_ARGV = ["--fl-codec", "int8", "--fl-deadline-s", "0.002", "--fl-async",
              "--robust-agg", "trimmed", "--clip-factor", "3",
              "--fault-crash-prob", "0.1", "--fault-byzantine-frac", "0.25",
              "--fault-byzantine-mode", "sign_flip",
              "--fault-partition-prob", "0.3"]


# the same with byzantine noise (drawn from the fleet's fault generator)
NOISE_ARGV = [*CHAOS_ARGV[:-3], "noise", *CHAOS_ARGV[-2:]]
POLICIES = ("bf16", "lean")
# the episodes of the CLI runs of [chaos], [state dtype] and [health] (the
# launch and parity checks are per episode and per round)
CUT_EPISODES = 10


def chaos_kwargs(mode="sign_flip"):
    """``CHAOS_ARGV`` (``mode="noise"``: ``NOISE_ARGV``) as the drivers'
    keyword arguments."""
    from repro_torch.fl.transport import TransportConfig
    from repro_torch.resilience.faults import FaultConfig
    from repro_torch.resilience.guards import GuardConfig
    return dict(
        transport=TransportConfig(codec="int8", deadline_s=0.002,
                                  async_rounds=True),
        guards=GuardConfig(agg="trimmed", clip_factor=3.0),
        faults=FaultConfig(crash_prob=0.1, byzantine_frac=0.25,
                           byzantine_mode=mode, partition_prob=0.3))


def health_kwargs(threshold=0.0):
    """``--health`` (and ``--susp-threshold``, on the chaos slice's
    guards) as the drivers' keyword arguments."""
    from repro_torch.health import HealthConfig
    from repro_torch.resilience.guards import GuardConfig
    out = dict(health=HealthConfig())
    if threshold:
        guards = chaos_kwargs()["guards"]
        out["guards"] = GuardConfig(agg=guards.agg,
                                    clip_factor=guards.clip_factor,
                                    susp_threshold=threshold)
    return out


class ListSink:
    """A metrics sink that keeps its records."""

    def __init__(self):
        self.records = []

    def append(self, record):
        self.records.append(record)


def check_records(records, hist, label):
    """One streamed record per episode, in order, equal to the history
    row (float32 values)."""
    import numpy as np
    episodes = [r for r in records if "episode" in r]
    n = len(next(iter(hist.values())))
    if [r["episode"] for r in episodes] != list(range(n)):
        raise AssertionError(f"{label}: streamed episodes "
                             f"{[r['episode'] for r in episodes]}")
    for i, r in enumerate(episodes):
        if set(r) != {"episode", *hist}:
            raise AssertionError(f"{label}: record keys differ from the "
                                 f"history's")
        for k, v in hist.items():
            if np.float32(r[k]) != np.float32(v[i]):
                raise AssertionError(f"{label}: record {i} {k} {r[k]} is "
                                     f"not the history's {v[i]}")


def raw(x):
    """A numpy leaf's bits (bf16 ``|V2`` leaves as uint16)."""
    import numpy as np
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint16) if x.dtype.kind == "V" else x


def leaves(tree, prefix=""):
    """(dotted name, numpy leaf) of a nested dict (``fleet_to_numpy``)."""
    import numpy as np
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


START = time.time()


def log(msg):
    """Print a line; a phase header (``[name] ...``, no JSON) also shows
    the seconds since the script started, where a run's time goes."""
    if msg.startswith("[") and "{" not in msg:
        msg = f"{msg}  @ {time.time() - START:.0f} s"
    print(msg, flush=True)


def eager_ms(fn, iters=50, warmup=5):
    """Mean time per call of ``fn`` issued eagerly from Python, by CUDA
    events: the host's launch overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


@contextlib.contextmanager
def collected():
    """The cyclic garbage collector run, then off for the block (a capture;
    as in ``core/graphs.py``): a graph or event of an earlier phase freed
    mid-capture invalidates the capture."""
    import gc
    on = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if on:
            gc.enable()


def device_ms(fn, iters=50, per_graph=1, graphs=1):
    """Mean device time of ``fn``: captured ``per_graph`` times in one CUDA
    graph and replayed back to back, so the host's launch overhead is out
    (with ``per_graph`` > 1 also the graph's own launch, which matters for
    kernels of a few microseconds). With ``graphs`` > 1 that many graphs
    are captured, each from the next calls of ``fn``, and replayed in
    turn: an ``fn`` that walks through inputs larger than the L2 then reads
    each of them cold."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    captured = []
    with collected():
        for _ in range(graphs):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(per_graph):
                    fn()
            captured.append(graph)
    for graph in captured:
        graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        captured[i % graphs].replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters / per_graph


def median_ms(fn, iters=50, samples=5, per_graph=1, graphs=1):
    """The median of ``samples`` ``device_ms`` readings: one reading of a
    kernel of a few microseconds moves by a microsecond or two between
    replays of its graph. With ``per_graph`` 20 the graph's own launch is
    spread over 20 calls: that reading is the device's own time."""
    return sorted(device_ms(fn, iters, per_graph, graphs)
                  for _ in range(samples))[samples // 2]


# ---------------------------------------------------------------------------
# K1 diversity_insert
# ---------------------------------------------------------------------------
def k1_inputs(torch, a, fill, t_steps, gen, cfg):
    from repro_torch.core.buffer import RIDGE, buffer_init
    from repro_torch.kernels.ref import diversity_insert_ref
    na = cfg.n_res + cfg.n_bs + cfg.n_mt
    dev = torch.device(DEV)

    def cands(t):
        s = torch.randn(a, t, cfg.state_dim, generator=gen, device=dev) * 2.0
        p = torch.softmax(torch.randn(a, t, na, generator=gen, device=dev), -1)
        return s, p

    b = buffer_init(cfg, a, dev)
    state = [b.states, b.probs, b.score, b.filled, b.s_sum, b.s_outer,
             b.p_sum, b.n_filled]
    if fill:
        s, p = cands(fill)
        state = list(diversity_insert_ref(*state, s, p, alpha=cfg.alpha,
                                          beta=cfg.beta, ridge=RIDGE)[:8])
    s, p = cands(t_steps)
    return [x.contiguous() for x in state] + [s, p]


def k1_compare(torch, cfg, args, out_k, out_p, label):
    """Traces identical except a first divergence at a near-tie; floats of
    the agents that did not diverge within the band. Returns the max abs
    error over the compared floats."""
    from repro_torch.core.buffer import RIDGE
    from repro_torch.kernels.ref import diversity_insert_ref
    slot_k, do_k, d_k = out_k[8:]
    slot_p, do_p, d_p = out_p[8:]
    diff = (slot_k != slot_p) | (do_k != do_p)
    diverged = diff.any(1)
    for a in torch.nonzero(diverged).flatten().tolist():
        t = int(torch.nonzero(diff[a])[0])
        pre = diversity_insert_ref(*args[:8], args[8][:, :t], args[9][:, :t],
                                   alpha=cfg.alpha, beta=cfg.beta,
                                   ridge=RIDGE) if t else args
        score = pre[2][a]
        gaps = [abs(float(d_k[a, t]) - float(score.min())),
                abs(float(d_p[a, t]) - float(score.min()))]
        if slot_k[a, t] != slot_p[a, t]:
            gaps.append(abs(float(score[slot_k[a, t]] - score[slot_p[a, t]])))
        scale = max(1.0, abs(float(d_p[a, t])))
        if min(gaps) > NEAR_TIE * scale:
            raise AssertionError(f"K1 {label}: agent {a} diverges at t={t} "
                                 f"with no near-tie (gaps {gaps})")
        log(f"  K1 {label}: agent {a} diverges at t={t} at a near-tie "
            f"(gap {min(gaps):.3g}: d kernel {float(d_k[a, t])!r} / plain "
            f"{float(d_p[a, t])!r}, min score {float(score.min())!r}, slot "
            f"{int(slot_k[a, t])}/{int(slot_p[a, t])}, do "
            f"{bool(do_k[a, t])}/{bool(do_p[a, t])}); accepted, excluded "
            f"from float checks")
    keep = ~diverged
    err = 0.0
    names = ("states", "probs", "score", "filled", "s_sum", "s_outer",
             "p_sum", "n_filled", "slot", "do", "d")
    for name, k, p in zip(names, out_k, out_p):
        k, p = k[keep], p[keep]
        if k.dtype in (torch.bool, torch.int32, torch.int64):
            if not torch.equal(k, p):
                raise AssertionError(f"K1 {label}: {name} differs")
            continue
        fin = torch.isfinite(p)
        if not torch.equal(fin, torch.isfinite(k)) or \
                not torch.equal(k[~fin], p[~fin]):
            raise AssertionError(f"K1 {label}: {name} non-finite mismatch")
        torch.testing.assert_close(k[fin], p[fin], rtol=RTOL, atol=ATOL,
                                   msg=f"K1 {label}: {name}")
        if fin.any():
            err = max(err, float((k[fin] - p[fin]).abs().max()))
    return err


def check_k1(torch, cfg, gen, agents=(8, 2048), fills=(32, 96), tag=""):
    """K1 against its plain version at each of ``agents`` from an empty,
    a half-full and a full buffer (``fills`` candidates first), then
    timed on the full buffer. Returns (max abs err, {A: timing})."""
    from repro_torch.obs import profile as prof
    from repro_torch.core.buffer import RIDGE
    from repro_torch.kernels.diversity import diversity_insert
    from repro_torch.kernels.ref import diversity_insert_ref
    err, timing = 0.0, {}
    for a in agents:
        for fill, label in zip((0, *fills), ("empty", "half-full", "full")):
            args = k1_inputs(torch, a, fill, cfg.n_steps, gen, cfg)
            kw = dict(alpha=cfg.alpha, beta=cfg.beta, ridge=RIDGE)
            out_k = diversity_insert(*args, **kw)
            out_p = diversity_insert_ref(*args, **kw)
            torch.cuda.synchronize()
            if label == "full" and not bool(out_p[3].all()):
                raise AssertionError("K1 full-buffer case is not full")
            e = k1_compare(torch, cfg, args, out_k, out_p,
                           f"{tag}A={a} {label}")
            err = max(err, e)
            log(f"  K1 {tag}A={a} {label}: ok, max|err| {e:.3g}")
        ms = median_ms(lambda: diversity_insert(*args, **kw))
        ms20 = median_ms(lambda: diversity_insert(*args, **kw), 10,
                         per_graph=20)
        plain = device_ms(lambda: diversity_insert_ref(*args, **kw))
        eager = eager_ms(lambda: diversity_insert(*args, **kw))
        cost = prof.kernel_cost(
            "diversity_insert", a=a, n=cfg.buffer_size, d=cfg.state_dim,
            na=cfg.n_res + cfg.n_bs + cfg.n_mt, t=cfg.n_steps,
            flops_per_candidate=prof.k1_flops_per_candidate(cfg))
        moved, flops = cost["bytes_accessed"], cost["flops"]
        if moved != prof.nbytes(*args, *out_k):
            raise AssertionError("K1: obs.profile's byte count is not the "
                                 "arguments' and results' bytes")
        bound = max(moved / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        by = "bytes" if moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS \
            else "operations"
        timing[a] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=None)
        log(f"  K1 {tag}A={a} (full buffer): kernel {ms:.4f} ms (median of 5 "
            f"graph replays; {ms20:.4f} ms at 20 calls per graph; "
            f"{eager:.4f} ms per eager call), plain {plain:.4f} ms, bound "
            f"{bound:.6f} ms ({by}, {moved} B)")
    return err, timing


# (mark in csrc/diversity_insert.cu, label): the phase that ends at the mark
K1_PHASES = (("LOAD", "load"), ("MEAN_COV", "mean+cov"),
             ("CHOLESKY", "cholesky"), ("SOLVE_NORM", "solve+norm"),
             ("KL", "kl"), ("ARGMIN", "argmin"), ("EXCHANGE", "exchange"),
             ("UPDATE", "update"), ("STORE", "store"))
K1_MAX_BLOCKS, K1_WARPS = 4096, 2
# the same for csrc/queue_advance.cu: warp 0 runs the chains, warp 1 + i
# takes agent i's ring (up to 8 agents a block)
K3_WARPS = 9
K3_PHASES = (("LOAD", "load"), ("SCALAR", "scalar chain"), ("COPY", "copy"),
             ("BARRIER", "barrier"), ("REQUESTS", "requests"),
             ("FOLD", "fold"), ("STORE", "store"))
STAMPS = string.Template("""#define ${P}_PHASE_MARKS
#include <cuda_runtime.h>
enum { $enum, ${P}_NPH };
__device__ unsigned long long ${p}_phase_sum[$blocks][$warps][${P}_NPH];
__shared__ unsigned long long ${p}_phase_acc[$warps][${P}_NPH + 1];
__device__ __forceinline__ void ${p}_stamp_start() {
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    for (int i = 0; i < ${P}_NPH; ++i) ${p}_phase_acc[w][i] = 0ull;
    ${p}_phase_acc[w][${P}_NPH] = clock64();
  }
}
__device__ __forceinline__ void ${p}_stamp(int ph) {
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    const unsigned long long now = clock64();
    ${p}_phase_acc[w][ph] += now - ${p}_phase_acc[w][${P}_NPH];
    ${p}_phase_acc[w][${P}_NPH] = now;
  }
}
__device__ __forceinline__ void ${p}_stamp_flush() {
  if ((threadIdx.x & 31) == 0 && blockIdx.x < $blocks) {
    const int w = threadIdx.x >> 5;
    for (int i = 0; i < ${P}_NPH; ++i)
      ${p}_phase_sum[blockIdx.x][w][i] = ${p}_phase_acc[w][i];
  }
}
#define ${P}_MARK_START() ${p}_stamp_start()
#define ${P}_MARK(phase) ${p}_stamp(${P}_PH_##phase)
#define ${P}_MARK_END() ${p}_stamp_flush()
#include "$source"
extern "C" int ${p}_phase_read(void* host, int n_blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, ${p}_phase_sum, sizeof(unsigned long long) * n_blocks * $warps *
      ${P}_NPH));
}
""")


def stamped_source(prefix, phases, source, warps, blocks=K1_MAX_BLOCKS):
    """A translation unit that builds the kernel in ``source`` with its
    phase marks (``<prefix>_MARK(...)``) defined as clock64 stamps: lane 0
    of each warp adds the cycles since its previous mark to the phase the
    mark ends, in shared memory, and each block writes its sums to
    ``<prefix>_phase_sum`` at the end (``<prefix>_phase_read`` copies them
    out). A mark costs lane 0 one clock64 and three shared-memory
    accesses, which the phase it ends absorbs."""
    return STAMPS.substitute(
        P=prefix, p=prefix.lower(),
        enum=", ".join(f"{prefix}_PH_{mark}" for mark, _ in phases),
        blocks=blocks, warps=warps, source=source)


def start_stamped(name, prefix, phases, warps):
    """Start nvcc on kernel ``name`` built with its phase marks as clock64
    stamps (``stamped_source``) and its own flags; returns the process and
    the library it writes (``build/kernels``, gitignored)."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    unit = build.BUILD_DIR / f"{name}-stamped.cu"
    unit.write_text(stamped_source(prefix, phases, build.CSRC / f"{name}.cu",
                                   warps))
    out = unit.with_suffix(".so")
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.flags(name), "-o", str(out), str(unit)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_stamped(proc, out):
    """Wait for ``start_stamped``'s nvcc and load its library; raises with
    the compiler's output if the build failed."""
    text, _ = proc.communicate()
    out.with_suffix(".log").write_text(text)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.stem} (exit "
                           f"{proc.returncode}):\n{text}")
    return ctypes.CDLL(str(out))


def read_phases(lib, prefix, n_blocks, warps, n_phases):
    """The stamped kernel's cycles per (block, warp, phase) after its last
    launch."""
    import numpy as np
    read = getattr(lib, f"{prefix.lower()}_phase_read")
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    buf = np.zeros((n_blocks, warps, n_phases), np.uint64)
    rc = read(buf.ctypes.data, n_blocks)
    if rc != 0:
        raise RuntimeError(f"{prefix.lower()}_phase_read: CUDA error {rc}")
    return buf.astype(np.float64)


@contextlib.contextmanager
def launching(name, lib):
    """Within the block, kernel ``name``'s wrapper launches ``lib`` (a build
    of another translation unit with the same C launch function)."""
    from repro_torch.kernels import build
    saved = build.load(name)
    build._LIBS[name] = lib
    try:
        yield
    finally:
        build._LIBS[name] = saved


def k1_phases(torch, cfg, gen, lib):
    """The stamped K1 on a full buffer at A=8 and A=2048: the cycles lane 0
    of each warp spends in each phase, averaged over the agents; per block
    for load and store, per candidate for the rest (the kernel takes
    candidates in pairs)."""
    from repro_torch.core.buffer import RIDGE
    from repro_torch.kernels.diversity import diversity_insert
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, ridge=RIDGE)
    for a in (8, 2048):
        args = k1_inputs(torch, a, 96, cfg.n_steps, gen, cfg)
        with launching("diversity_insert", lib):
            for _ in range(3):                     # the last launch counts
                diversity_insert(*args, **kw)
            torch.cuda.synchronize()
        cyc = read_phases(lib, "K1", a, K1_WARPS, len(K1_PHASES)).mean(0)
        per = [1 if label in ("load", "store") else cfg.n_steps
               for _, label in K1_PHASES]
        for w in range(K1_WARPS):
            parts = [f"{label} {cyc[w, i] / per[i]:.0f}"
                     for i, (_, label) in enumerate(K1_PHASES) if cyc[w, i]]
            log(f"  K1 A={a} full, warp {w}: {' | '.join(parts)}; "
                f"{cyc[w].sum():.0f} cycles in all")


# ---------------------------------------------------------------------------
# K2 delta_codec
# ---------------------------------------------------------------------------
def k2_rows(torch, a, l, gen, kind):
    """(delta, residual) rows of one leaf: random deltas with residuals;
    the quarter grid (exact int8 halfway cases, |x| ties); or special
    (random rows, every fourth holding NaN, +inf and -inf, the next all
    zeros: the 1e-12 scale floor)."""
    dev = torch.device(DEV)
    if kind == "grid":
        # multiples of 1/4 with max |x| = 63.5: scale is exactly 0.5, so odd
        # quarters land on int8 halfway cases, and |x| ties abound for topk
        x = torch.randint(-254, 255, (a, l), generator=gen, device=dev) / 4.0
        x[:, 0] = 63.5
        return x.contiguous(), torch.zeros_like(x)
    d = torch.randn(a, l, generator=gen, device=dev) * 0.01
    r = torch.randn(a, l, generator=gen, device=dev) * 0.001
    if kind == "special":
        d[0::4, 0], d[0::4, l // 2], d[0::4, -1] = math.nan, math.inf, \
            -math.inf
        d[1::4], r[1::4] = 0.0, 0.0
    return d, r


def check_k2(torch, gen, sizes=LEAF_SIZES, agents=(8, 2048)):
    """K2 through ``delta_codec_leaves``, one launch over a round's leaves
    (``sizes``: the iAgent's 12, or the single head's 8) as the trainer
    calls it: bit for bit (as int32 patterns, NaN payloads included)
    against the plain version per leaf on the card; then the round timed
    (median of five, at 1 and at 20 rounds per graph) beside the plain
    version and ``torch.topk`` over the same leaves."""
    from repro_torch.obs import profile as prof
    from repro_torch.fl.transport import topk_k
    from repro_torch.kernels.delta_codec import (delta_codec,
                                                 delta_codec_leaves)
    from repro_torch.kernels.ref import delta_codec_ref
    ks = [topk_k(l, 0.05) for l in sizes]
    n = len(sizes)
    bits = lambda x: x.view(torch.int32)
    for a in agents:
        for codec in ("float32", "int8", "topk"):
            for kind in ("random", "grid", "special"):
                rows = [k2_rows(torch, a, l, gen, kind) for l in sizes]
                before = delta_codec.launches
                decs, ress = delta_codec_leaves(
                    [d for d, _ in rows], [r for _, r in rows], codec=codec,
                    ks=ks)
                if delta_codec.launches != before + 1:
                    raise AssertionError(f"K2 {codec} A={a}: "
                                         f"{delta_codec.launches - before} "
                                         f"launches for {n} leaves, not 1")
                for (d, r), k, dk, rk in zip(rows, ks, decs, ress):
                    dp, rp = delta_codec_ref(d, r, codec=codec, k=k)
                    bad = (bits(dk) != bits(dp)) | (bits(rk) != bits(rp))
                    if bool(bad.any()):
                        raise AssertionError(
                            f"K2 {codec} A={a} L={d.shape[1]} {kind}: "
                            f"{int(bad.sum())} values differ from the plain "
                            f"version")
            torch.cuda.synchronize()
            log(f"  K2 {codec} A={a}: one launch, bit-identical at all {n} "
                f"leaf sizes (random, grid, NaN/inf/zero rows)")
    timing = {}
    for a in agents:
        rows = [k2_rows(torch, a, l, gen, "random") for l in sizes]
        ds, rs = [d for d, _ in rows], [r for _, r in rows]
        moved = prof.kernel_cost("delta_codec", a=a,
                                 lengths=sizes)["bytes_accessed"]
        if moved != sum(prof.nbytes(d, r) * 2 for d, r in rows):
            raise AssertionError("K2: obs.profile's byte count differs")
        bound = moved / HBM_BYTES_PER_S * 1e3
        for codec in ("int8", "topk"):
            def run_kernel():
                delta_codec_leaves(ds, rs, codec=codec, ks=ks)

            def run_plain():
                for (d, r), k in zip(rows, ks):
                    delta_codec_ref(d, r, codec=codec, k=k)

            def run_library():
                for (d, r), k in zip(rows, ks):
                    torch.topk((d + r).abs(), k, dim=-1)

            ms = median_ms(run_kernel)
            ms20 = median_ms(run_kernel, 10, per_graph=20)
            plain = device_ms(run_plain)
            lib = median_ms(run_library) if codec == "topk" else None
            eager = eager_ms(run_kernel)
            timing[(codec, a)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                      bound_by="bytes", library_ms=lib)
            log(f"  K2 {codec} A={a} (one round = {n} leaves, one launch): "
                f"kernel {ms:.4f} ms (median of 5 graph replays; {ms20:.4f} "
                f"ms at 20 rounds per graph; {eager:.4f} ms eager), plain "
                f"{plain:.4f} ms, torch.topk "
                f"{'-' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{bound:.6f} ms ({moved} B)")
    return timing


# ---------------------------------------------------------------------------
# K3 queue_advance
# ---------------------------------------------------------------------------
K3_REGIMES = ("idle", "nominal", "overload")


def k3_interval(torch, regime, a, sp, gen, cfg, env_params, rate, phase):
    """Arrivals (A, K) int32 and caps (A, 6) float32 of one interval.
    idle: 0-1 arrivals per tick; nominal: the nominal traces' rate spread
    over the ticks; both under the caps of random actions on the fleet's
    device mix. overload: 3-6x what post service (the bottleneck) serves,
    batch 1, queues of 16, so ten intervals reach the overflow."""
    from repro_torch.sim.state import action_caps, spread_arrivals
    dev = torch.device(DEV)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(
        s, generator=gen, device=dev)
    if regime == "overload":
        c_post = u(0.2, 0.5, a)
        caps = torch.stack([u(1.0, 2.0, a), c_post, torch.ones_like(c_post),
                            torch.ones_like(c_post),
                            torch.full_like(c_post, 16.0),
                            torch.full_like(c_post, 5.0)], dim=1)
        lam = u(3.0, 6.0, a, 1) * c_post[:, None]
        arrivals = torch.poisson(lam.expand(a, sp.k_ticks).contiguous(),
                                 generator=gen).to(torch.int32)
        return arrivals, caps, phase
    acts = torch.stack([torch.randint(0, n, (a,), generator=gen, device=dev)
                        for n in (cfg.n_res, cfg.n_bs, cfg.n_mt)], dim=1)
    caps = action_caps(cfg, sp, env_params, acts)
    if regime == "idle":
        arrivals = torch.randint(0, 2, (a, sp.k_ticks), generator=gen,
                                 device=dev, dtype=torch.int32)
        return arrivals, caps, phase
    arrivals, phase = spread_arrivals(sp, rate, phase)
    return arrivals, caps, phase


def check_k3(torch, cfg, gen):
    """K3 bit for bit against its plain version, ten chained intervals per
    regime; times it on the nominal regime's loaded state (median of five,
    at 1 and at 20 calls per graph). Returns (timing, {A: the loaded
    state's arguments})."""
    from repro_torch.obs import profile as prof
    from repro_torch.core.env import default_env_params
    from repro_torch.data.workload import fleet_traces
    from repro_torch.kernels.queue_advance import queue_advance
    from repro_torch.kernels.ref import (SIM_ARRIVED, SIM_COMPLETED,
                                         SIM_DROPPED, SIM_HEAD, SIM_LAUNCH,
                                         SIM_TAIL, queue_advance_ref)
    from repro_torch.sim.state import SimParams, sim_init
    import numpy as np
    sp = SimParams()
    timing, loads = {}, {}
    for a in (8, 2048):
        speeds = torch.as_tensor(np.random.default_rng(0).choice(
            [0.5, 0.75, 1.0, 2.0], a), dtype=torch.float32, device=DEV)
        env_params = default_env_params(speeds, cfg.slo_s, DEV)
        cpu_gen = torch.Generator().manual_seed(a)
        rates = fleet_traces(cpu_gen, a, 10, device=DEV)
        for regime in K3_REGIMES:
            state = sim_init(sp, a, DEV).tensors()
            phase = torch.zeros(a, device=DEV)
            for t in range(10):
                arrivals, caps, phase = k3_interval(
                    torch, regime, a, sp, gen, cfg, env_params, rates[:, t],
                    phase)
                out_k = queue_advance(*state, arrivals, caps)
                out_p = queue_advance_ref(*state, arrivals, caps)
                rec_k = queue_advance(*state, arrivals, caps, record=True)
                rec_p = queue_advance_ref(*state, arrivals, caps,
                                          record=True)
                torch.cuda.synchronize()
                names = ("arrive", "counters", "credits", "lat_sum", "hist",
                         "ticks")
                for name, k, p in [*zip(names, out_k, out_p),
                                   *((f"recorded {n}", k, p) for n, k, p
                                     in zip(names, rec_k, rec_p)),
                                   *((f"recorded vs unrecorded {n}", k, p)
                                     for n, k, p in zip(names, rec_k,
                                                        out_k))]:
                    if not torch.equal(k, p):
                        raise AssertionError(
                            f"K3 A={a} {regime} interval {t}: {name} "
                            f"differs in {int((k != p).sum())} entries")
                state = out_k
            c = state[1]
            arrived = c[:, SIM_ARRIVED]
            in_flight = c[:, SIM_TAIL] - c[:, SIM_HEAD]
            if not torch.equal(arrived, c[:, SIM_DROPPED] + c[:, SIM_COMPLETED]
                               + in_flight):
                raise AssertionError(f"K3 A={a} {regime}: requests not "
                                     f"conserved")
            dropped = int(c[:, SIM_DROPPED].sum())
            completed = int(c[:, SIM_COMPLETED].sum())
            if regime == "overload":
                full = c[:, SIM_LAUNCH] - c[:, SIM_HEAD] == 16
                if not bool((c[:, SIM_DROPPED] > 0).all()) or \
                        not bool(full.all()):
                    raise AssertionError(f"K3 A={a} overload: drops "
                                         f"{dropped}, post queue full on "
                                         f"{int(full.sum())} of {a}")
            elif dropped or not completed:
                raise AssertionError(f"K3 A={a} {regime}: {dropped} drops, "
                                     f"{completed} completions")
            log(f"  K3 A={a} {regime}: bit-identical over 10 intervals "
                f"(recording too: the tick series and the state; recorded "
                f"state == unrecorded), "
                f"arrived {int(arrived.sum())}, completed {completed}, "
                f"dropped {dropped}")
            if regime == "nominal":
                loaded = (state, arrivals, caps)
        state, arrivals, caps = loaded
        args = (*state, arrivals, caps)
        ms = median_ms(lambda: queue_advance(*args))
        ms20 = median_ms(lambda: queue_advance(*args), 10, per_graph=20)
        plain = device_ms(lambda: queue_advance_ref(*args))
        eager = eager_ms(lambda: queue_advance(*args))
        moved = prof.kernel_cost("queue_advance", a=a, ring=sp.ring,
                                 hist=sp.hist_n,
                                 k=sp.k_ticks)["bytes_accessed"]
        if moved != prof.nbytes(*args, *state):
            raise AssertionError("K3: obs.profile's byte count differs")
        bound = moved / HBM_BYTES_PER_S * 1e3
        timing[a] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                         bound_by="bytes", library_ms=None)
        log(f"  K3 A={a}: kernel {ms:.4f} ms (median of 5 graph replays; "
            f"{ms20:.4f} ms at 20 calls per graph; {eager:.4f} ms per eager "
            f"call), plain {plain:.4f} ms, bound {bound:.6f} ms (bytes, "
            f"{moved} B)")
        # the recording instantiation, timed in turns with the unrecorded
        rec = lambda: queue_advance(*args, record=True)
        turns = [median_ms(rec) if i % 3 else median_ms(
            lambda: queue_advance(*args)) for i in range(4)]
        rec20 = median_ms(rec, 10, per_graph=20)
        plain_rec = device_ms(lambda: queue_advance_ref(*args, record=True))
        moved_rec = prof.kernel_cost(
            "queue_advance", a=a, ring=sp.ring, hist=sp.hist_n,
            k=sp.k_ticks, record=True)["bytes_accessed"]
        bound_rec = moved_rec / HBM_BYTES_PER_S * 1e3
        timing[("record", a)] = dict(
            ms=(turns[1] + turns[2]) / 2, plain_ms=plain_rec,
            bound_ms=bound_rec, bound_by="bytes", library_ms=None)
        log(f"  K3 A={a} recording: kernel {turns[1]:.4f} / {turns[2]:.4f} "
            f"ms against unrecorded {turns[0]:.4f} / {turns[3]:.4f} ms in "
            f"turns (median of 5 each; {rec20:.4f} ms at 20 calls per "
            f"graph), plain {plain_rec:.4f} ms, bound {bound_rec:.6f} ms "
            f"(bytes, {moved_rec} B)")
        loads[a] = args
    return timing, loads


def k3_phases(torch, sp, loads, lib):
    """The stamped K3 on the nominal regime's loaded state at A=8 and
    A=2048: the cycles lane 0 of each warp spends in each phase, for warp 0
    (the scalar chains) and averaged over the agents' warps; the chain also
    per tick."""
    import numpy as np
    from repro_torch.kernels.queue_advance import queue_advance
    for a, args in loads.items():
        with launching("queue_advance", lib):
            for _ in range(3):                     # the last launch counts
                queue_advance(*args)
            torch.cuda.synchronize()
        nb = min(K3_WARPS - 1, a)
        blocks = -(-a // nb)
        cyc = read_phases(lib, "K3", blocks, K3_WARPS, len(K3_PHASES))
        agent = np.arange(blocks)[:, None] * nb + np.arange(K3_WARPS - 1)
        used = (np.arange(K3_WARPS - 1) < nb)[None, :] & (agent < a)
        for who, c in (("warp 0", cyc[:, 0].mean(0)),
                       ("agent warps", cyc[:, 1:][used].mean(0))):
            parts = [f"{label} {c[j]:.0f}"
                     for j, (_, label) in enumerate(K3_PHASES) if c[j]]
            log(f"  K3 A={a} nominal, {who}: {' | '.join(parts)}; "
                f"{c.sum():.0f} cycles in all")
        log(f"  K3 A={a}: the chain {cyc[:, 0, 1].mean() / sp.k_ticks:.0f} "
            f"cycles a tick")


# ---------------------------------------------------------------------------
# The main paths and small runs against the CPU
# ---------------------------------------------------------------------------
def wrappers():
    """The six kernel wrappers, K1..K6 in order."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.delta_codec import delta_codec
    from repro_torch.kernels.diversity import diversity_insert
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.packing import pack
    from repro_torch.kernels.queue_advance import queue_advance
    return (diversity_insert, delta_codec, queue_advance, flash_attention,
            decode_attention, pack)


def reset_launches():
    for fn in wrappers():
        fn.launches = 0


def read_launches():
    """(K1, ..., K6) launch counts."""
    return tuple(fn.launches for fn in wrappers())


@contextlib.contextmanager
def graph_spy(module):
    """Collect every ``GraphedBody`` that ``module`` makes while the block
    runs (for their capture times and host graph launches)."""
    made = []
    cls = module.GraphedBody

    class Spy(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    module.GraphedBody = Spy
    try:
        yield made
    finally:
        module.GraphedBody = cls


def drive(torch, argv, n_episodes, fl_every, n_steps, strict=False):
    """One ``train_fleet`` run under each driver (``scan``, the default,
    then ``--driver reference``), the launch counts set to 0 just before
    each and read just after: K1 once per episode, K2 once per FL round
    under int8/topk, K3 once per twin control interval, finite histories,
    equal between the drivers (``strict``: bit for bit). Returns the scan
    run's (K1, K2, K3)."""
    import numpy as np
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.launch import train_fleet
    rounds = n_episodes // fl_every
    want = (n_episodes, 0 if "--fl-codec" not in argv else rounds,
            n_episodes * n_steps if "twin" in argv else 0)
    counts, hists = {}, {}
    for driver in ("scan", "reference"):
        reset_launches()
        with graph_spy(fleet_mod) as graphs:
            t0 = time.time()
            _, hist = train_fleet.main([*argv, "--device", DEV,
                                        "--driver", driver])
            torch.cuda.synchronize()
            wall = time.time() - t0
        counts[driver], hists[driver] = read_launches()[:3], hist
        for key, v in hist.items():
            if len(v) != n_episodes or not all(map(math.isfinite, v)):
                raise AssertionError(f"{argv} {driver}: history {key} is "
                                     f"not {n_episodes} finite values")
        if counts[driver] != want:
            raise AssertionError(
                f"{argv} {driver}: K1, K2, K3 launched {counts[driver]} "
                f"times, expected {want} (K1 once per episode, K2 once per "
                f"FL round under int8/topk, K3 once per twin interval)")
        capture = sum(g.capture_s for g in graphs)
        replays = sum(g.replays for g in graphs)
        log(f"  {' '.join(argv) or '(defaults)'} --driver {driver}: K1 "
            f"{want[0]}, K2 {want[1]}, K3 {want[2]} launches, "
            f"{(wall - capture) / n_episodes * 1e3:.2f} ms/episode (wall "
            f"incl. trace set-up, capture out)"
            + (f"; capture {capture:.3f} s, {replays} graph launches "
               f"({replays / n_episodes:.2f}/episode)"
               if driver == "scan" else ""))
    same = all(np.array_equal(hists["scan"][k], v)
               for k, v in hists["reference"].items())
    if strict and not same:
        raise AssertionError(f"{argv}: the drivers' histories differ")
    for k, v in hists["reference"].items():
        np.testing.assert_allclose(hists["scan"][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{argv}: scan vs reference {k}")
    log(f"  histories of the two drivers: "
        f"{'bit for bit' if same else 'within rtol 1e-4 / atol 1e-5'}")
    return counts["scan"]


def drive_simulate(argv, want_k3):
    """One ``simulate`` run with the launch counts set to 0 just before and
    read just after: K3 once per simulated (and twin-trained) interval, a
    finite summary, requests conserved for every agent."""
    import numpy as np
    from repro_torch.launch import simulate
    reset_launches()
    t0 = time.time()
    summ = simulate.main([*argv, "--device", DEV])
    wall = time.time() - t0
    k3 = read_launches()[2]
    if k3 != want_k3:
        raise AssertionError(f"simulate {argv}: K3 launched {k3} times, "
                             f"expected {want_k3}")
    for key, v in summ.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"simulate {argv}: {key} not finite")
    if not (summ["arrived"] == summ["dropped"] + summ["completed"]
            + summ["in_flight"]).all():
        raise AssertionError(f"simulate {argv}: requests not conserved")
    if not summ["completed"].sum():
        raise AssertionError(f"simulate {argv}: nothing completed")
    log(f"  simulate {' '.join(argv) or '(defaults)'}: K3 {k3} launches, "
        f"evaluation {summ['wall_s'] / 60 * 1e3:.2f} ms/interval (60 "
        f"intervals graphed, wall incl. capture), whole call {wall:.2f} s; "
        f"effective throughput "
        f"{float(summ['effective_throughput'].mean()):.2f} req/s, p99 "
        f"{float(summ['p99_latency_s'].mean()) * 1e3:.0f} ms, requests "
        f"conserved")
    return k3


def run_pair(torch, cfg, backend, chaos=False, policy=None, health=False):
    """A=4, P=2, int8 codec, 3 episodes (``chaos``: the chaos kwargs, eight
    episodes): the card run (kernels) and the CPU run (plain versions) of
    ``train_fleet_reference`` from one numpy fleet state, one set of traces
    and one set of Gumbel noise. Histories within rtol 1e-3 / atol 1e-4.
    In the twin the actions and the final twin state must be equal, under
    chaos the timers and the parked uploads' masks too; a first action
    divergence is accepted only at a near-tie of the Gumbel-max scores (gap
    below 1e-5 relative), and reported. ``policy``: the fleet stored at a
    state policy; bf16 storage rounds where float32 roundoff differs, so
    the histories are held within rtol 1e-2 / atol 1e-3 (about two bf16
    steps). ``health``: the observatory on (the gate at 0.5 under
    ``chaos``); with identical actions, its histogram counts, observation
    counts, marker positions and last selection must be equal, and the
    suspicion is held round by round (``susp_rounds``)."""
    import numpy as np
    from repro_torch.core import crl
    from repro_torch.core.agent import noise_width
    from repro_torch.core.fleet import (fleet_from_numpy, fleet_init,
                                        fleet_to_numpy, train_fleet_reference)
    from repro_torch.fl.transport import TransportConfig
    a, n_eps = 4, 8 if chaos else 3
    kw = chaos_kwargs() if chaos else dict(
        transport=TransportConfig(codec="int8"))
    if health:
        kw.update(health_kwargs(0.5 if chaos else 0.0))
    tree = fleet_to_numpy(fleet_init(cfg, a, 7, n_pods=2, device="cpu",
                                     env_backend=backend,
                                     state_policy=policy))
    rtol, atol = (1e-3, 1e-4) if policy is None else (1e-2, 1e-3)
    rng = np.random.default_rng(7)
    traces = rng.uniform(5.0, 120.0, (a, n_eps * cfg.n_steps)).astype(
        np.float32)
    u = rng.uniform(1e-6, 1.0, (n_eps, a, cfg.n_steps, noise_width(cfg)))
    gumbel = (-np.log(-np.log(u))).astype(np.float32)
    sample = crl.sample_actions
    hists, trees, records, rounds = [], [], [], []
    for dev in (DEV, "cpu"):
        record, rnd = [], []

        def recording(cfg_, params, obs, mask, gumbel=None, generator=None,
                      place=None):
            out = sample(cfg_, params, obs, mask, gumbel=gumbel,
                         generator=generator, place=place)
            logp = out[2]["joint"] if cfg_.single_head else torch.cat(
                [out[2][h] for h in ("res", "bs", "mt")], -1)
            scores = gumbel + logp
            record.append((out[0].cpu(), scores.cpu()))
            return out

        crl.sample_actions = recording
        restore = record_rounds(torch, rnd) if health else (lambda: None)
        try:
            fleet = fleet_from_numpy(cfg, tree, device=dev)
            fleet, h = train_fleet_reference(
                cfg, fleet, torch.as_tensor(traces, device=dev),
                env_backend=backend, gumbel=torch.as_tensor(gumbel,
                                                            device=dev),
                **kw)
        finally:
            crl.sample_actions = sample
            restore()
        hists.append(h)
        trees.append(fleet_to_numpy(fleet))
        records.append(record)
        rounds.append(rnd)
    diverged = first_action_divergence(torch, cfg, *records)
    tainted = susp_rounds(rounds, rtol, atol) if health and not diverged \
        else None
    for key in hists[1]:
        if key == "health_susp" and (tainted is None or tainted.any()):
            # a fleet mean over agents; held agent by agent above
            gap = np.abs(np.asarray(hists[0][key], np.float64)
                         - np.asarray(hists[1][key], np.float64)).max()
            log(f"  card vs cpu: {key} (fleet mean) max gap {gap:.4g}; "
                f"held per agent and round in susp_rounds")
            continue
        np.testing.assert_allclose(hists[0][key], hists[1][key], rtol=rtol,
                                   atol=atol, err_msg=f"card vs cpu: {key}")
    exact = []
    if backend == "twin" and not diverged:
        exact += [(f"twin state {k}", trees[0]["env_state"]["sim"][k], v)
                  for k, v in trees[1]["env_state"]["sim"].items()]
    if chaos and not diverged:
        exact += [(k, trees[0][k], trees[1][k])
                  for k in ("crash_timer", "partition_timer")]
        exact += [(f"pending.{k}", trees[0]["pending"][k],
                   trees[1]["pending"][k]) for k in ("has", "staleness")]
    if health and not diverged:
        exact += [(f"health.{k}", trees[0]["health"][k],
                   trees[1]["health"][k])
                  for k in ("reward_hist", "miss_hist", "n_obs", "sel_last")]
        exact.append(("health.reward_p2.n", trees[0]["health"]["reward_p2"]
                      ["n"], trees[1]["health"]["reward_p2"]["n"]))
    for name, got, want in exact:
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"card vs cpu: {name}")
    log(f"  card run == CPU run ({backend}, A={a}, {n_eps} episodes, int8"
        f"{', chaos' if chaos else ''}"
        f"{', ' + policy if policy else ''}"
        f"{', health' if health else ''}): {len(hists[1])} metrics "
        f"within rtol {rtol:g} / atol {atol:g}, actions "
        f"{'identical' if not diverged else 'identical up to a near-tie'}"
        + (", final twin state identical" if backend == "twin"
           and not diverged else "")
        + (", crash / partition timers and parked uploads identical"
           if chaos and not diverged else "")
        + (", health counts identical" if health and not diverged else "")
        + (", single head" if cfg.single_head else ""))


# the leave-one-out reference's share of the reference, |r - w_i d_i|^2 /
# |r|^2, below which an agent's round is left out of the card-vs-CPU
# suspicion check: the closed form (``dot - w sq``, ``ref_sq - 2 w dot +
# w^2 sq``) then cancels, and float32 moves cos_loo by ~eps |r| / |r_-i|
# in both packages; down to 1e-4 the float32 suspicion stays in the band
# of float64 (tests/test_torch_health.py::
# test_attribution_in_band_down_to_a_loo_share_of_1e_4)
LOO_SHARE = 1e-4


def record_rounds(torch, out):
    """Wraps the FL round's attribution and suspicion update
    (``repro_torch.core.fleet``) to append, per round, the scored
    selection, the agents whose leave-one-out reference is under
    ``LOO_SHARE`` of the reference (computed in float64 from the round's
    deltas and weights; a lone contributor's is 0), the round's raw
    suspicion and the EMA after it to ``out``. Returns the function that
    unwraps them."""
    from repro_torch.core import fleet as tfleet
    from repro_torch.health.attribution import robust_reference_weights
    score, update = tfleet.attribution_scores, tfleet.update_round

    def scoring(deltas, sel, place=None):
        got = score(deltas, sel, place)
        w = robust_reference_weights(got["norm"], sel).cpu().double()
        leaves = [deltas[k].detach().cpu().double().reshape(len(w), -1)
                  for k in sorted(deltas)]
        refs = [w @ f for f in leaves]
        ref_sq = sum((r * r).sum() for r in refs)
        loo_sq = sum(((r - w[:, None] * f) ** 2).sum(1)
                     for r, f in zip(refs, leaves))
        out.append(dict(sel=sel.cpu(), susp=got["susp"].cpu(),
                        ill=sel.cpu() & (loo_sq < LOO_SHARE * ref_sq),
                        share=(loo_sq / ref_sq).float()))
        return got

    def updating(hcfg, state, susp_new, sel):
        new = update(hcfg, state, susp_new, sel)
        out[-1]["ema"] = new.susp.cpu()
        return new

    tfleet.attribution_scores, tfleet.update_round = scoring, updating

    def restore():
        tfleet.attribution_scores, tfleet.update_round = score, update
    return restore


def susp_rounds(rounds, rtol, atol):
    """The card's and the CPU's rounds (``record_rounds``), in the band
    round by round: every agent's raw suspicion and EMA, but an agent's
    from the first round in which its leave-one-out reference was under
    ``LOO_SHARE`` of the reference on either side (logged, with the
    card's share and the gap there). Returns the (A,) mask of the agents
    left out."""
    import numpy as np
    card, cpu = rounds
    if len(card) != len(cpu):
        raise AssertionError(f"card vs cpu: {len(card)} scored rounds, "
                             f"{len(cpu)} on the CPU")
    tainted = np.zeros(card[0]["sel"].shape[0], bool) if card else \
        np.zeros(0, bool)
    for r, (k, c) in enumerate(zip(card, cpu)):
        if not np.array_equal(k["sel"].numpy(), c["sel"].numpy()):
            raise AssertionError(f"card vs cpu: round {r} scored other "
                                 f"clients")
        ill = k["ill"].numpy() | c["ill"].numpy()
        for i in np.flatnonzero(ill):
            log(f"  card vs cpu: round {r}, agent {i}: leave-one-out share "
                f"{float(k['share'][i]):.3g} of the reference; suspicion "
                f"{float(k['susp'][i]):.6g} on the card, "
                f"{float(c['susp'][i]):.6g} on the CPU (left out from here)")
        tainted |= ill
        keep = ~tainted
        for key in ("susp", "ema"):
            np.testing.assert_allclose(
                k[key].numpy()[keep], c[key].numpy()[keep], rtol=rtol,
                atol=atol, err_msg=f"card vs cpu: {key} of round {r}")
    log(f"  card vs cpu: suspicion and its EMA held for every agent in "
        f"{len(card)} rounds, but {int(tainted.sum())} agent(s) from an "
        f"ill-conditioned round on")
    return tainted


def first_action_divergence(torch, cfg, card, cpu):
    """False if the two runs took the same actions at every step; True if
    they first part at a near-tie of the Gumbel-max scores (reported);
    raises otherwise."""
    bounds = ((0, cfg.n_res), (cfg.n_res, cfg.n_res + cfg.n_bs),
              (cfg.n_res + cfg.n_bs, cfg.n_res + cfg.n_bs + cfg.n_mt))
    for step, ((act_k, sc_k), (act_c, sc_c)) in enumerate(zip(card, cpu)):
        if torch.equal(act_k, act_c):
            continue
        agent, head = [int(i) for i in torch.nonzero(act_k != act_c)[0]]
        # the single head draws all three actions from one joint max
        lo, hi = (0, sc_c.shape[-1]) if cfg.single_head else bounds[head]
        top = torch.topk(sc_c[agent, lo:hi], 2).values
        gap = float(top[0] - top[1])
        if gap > NEAR_TIE * max(1.0, abs(float(top[0]))):
            raise AssertionError(
                f"card vs cpu: actions part at step {step}, agent {agent}, "
                f"head {head} with no near-tie (score gap {gap:.3g})")
        log(f"  card vs cpu: actions part at step {step}, agent {agent}, "
            f"head {head} at a near-tie (score gap {gap:.3g}); accepted")
        return True
    if len(card) != len(cpu):
        raise AssertionError("card vs cpu: different numbers of steps")
    return False


def timed(torch, fn):
    """Host wall seconds of ``fn`` between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def profile_episodes(torch, cfg, backend="fluid", n_episodes=10,
                     policy=None, reference=True, **kw):
    """Where the time of the CLI default run goes (in ``backend``; ``kw``:
    the drivers' transport / guards / faults) under each driver: after
    eight episodes that warm up (the reference driver) or run eagerly and
    capture the three graphs (the graph driver; the first pod merge
    follows the eighth), ``n_episodes`` timed alone, then ``n_episodes``
    under ``torch.profiler``. Every window holds five FL rounds and one
    pod merge. A replayed episode takes at most three graph launches.
    ``policy``: the fleet stored at that state policy. ``reference=False``
    leaves out the reference driver's windows ([profile] takes them; the
    later phases profile the graph driver). Returns the graph
    driver's window: ``profiled``'s numbers and ``alone_ms`` (ms per
    replayed episode without the profiler)."""
    from repro_torch.core.fleet import (FleetScan, fleet_init,
                                        train_fleet_reference)
    from repro_torch.data.workload import fleet_traces
    warm, n = 8, cfg.n_steps
    gen = torch.Generator()
    gen.manual_seed(1)
    traces = fleet_traces(gen, 8, (warm + 2 * n_episodes) * n, device=DEV)
    window = lambda i: traces[:, (warm + i * n_episodes) * n:
                              (warm + (i + 1) * n_episodes) * n]
    name = backend + (f" --state-dtype {policy}" if policy else "") + (
        " --health" if kw.get("health") else "") + (
        " --metrics-out" if kw.get("metrics_sink") else "")
    init = lambda: fleet_init(cfg, 8, 0, n_pods=2, device=DEV,
                              env_backend=backend, state_policy=policy)
    if reference:
        fleet = init()
        fleet, _ = train_fleet_reference(cfg, fleet, traces[:, :warm * n],
                                         env_backend=backend, **kw)
        wall = timed(torch, lambda: train_fleet_reference(
            cfg, fleet, window(0), env_backend=backend, **kw))
        log(f"  {name} --driver reference: {n_episodes} episodes alone: "
            f"wall {wall / n_episodes * 1e3:.2f} ms/episode")
        profiled(torch, lambda: train_fleet_reference(
            cfg, fleet, window(1), env_backend=backend, **kw),
            n_episodes, f"{name} --driver reference: {n_episodes} episodes",
            "episode", alone=wall)
    driver = FleetScan(cfg, init(), traces, env_backend=backend, **kw)
    for _ in range(warm):
        driver.step()
    per_step = []

    def steps():
        for _ in range(n_episodes):
            before = driver.graph_launches
            driver.step()
            per_step.append(driver.graph_launches - before)

    replays = driver.graph_launches
    wall = timed(torch, steps)
    log(f"  {name} --driver scan: {n_episodes} replayed episodes alone: "
        f"wall {wall / n_episodes * 1e3:.2f} ms/episode, "
        f"{(driver.graph_launches - replays) / n_episodes:.2f} graph "
        f"launches/episode; capture {driver.capture_s:.3f} s for "
        f"{sum(g.graph is not None for g in driver.graphs)} graphs")
    out = profiled(torch, steps, n_episodes,
                   f"{name} --driver scan: {n_episodes} episodes", "episode",
                   alone=wall) or {}
    if max(per_step) > 3:
        raise AssertionError(f"{name}: a replayed episode took "
                             f"{max(per_step)} graph launches (at most 3)")
    log(f"    graph launches per replayed episode: at most "
        f"{max(per_step)}")
    return dict(out, alone_ms=wall / n_episodes * 1e3,
                max_graph_launches=max(per_step))


def profile_simulate(torch, cfg, n_int=60):
    """``simulate_fleet`` (8 agents, the ``dynamic`` scenario) graphed, and
    the same interval loop run eagerly, with one seed for the noise: ms
    per interval alone (graphed: a one-interval call, which runs eagerly
    and captures, taken from a (1 + n_int)-interval call, capture out),
    then ``n_int`` intervals under ``torch.profiler``; the final twin
    states must be equal."""
    from repro_torch.core.agent import sample_actions
    from repro_torch.core.fleet import fleet_init
    from repro_torch.sim import harness
    from repro_torch.sim.state import (SimParams, action_caps, sim_init,
                                       spread_arrivals)
    from repro_torch.sim.step import sim_interval
    from repro_torch.sim.scenarios import make_scenario
    sp = SimParams()
    fleet = fleet_init(cfg, 8, 0, device=DEV)
    params, ep = fleet.astate.policy.params(), fleet.env_params
    gen = torch.Generator()
    gen.manual_seed(2)
    traces = make_scenario("dynamic", gen, 8, n_int + 1, device=DEV)
    noise = lambda: torch.Generator(device=DEV).manual_seed(3)
    out = {}

    def graphed(t=n_int):
        out["graphed"] = harness.simulate_fleet(
            cfg, sp, params, fleet.masks, ep, traces[:, :t],
            generator=noise())[0]

    def eager():
        g = noise()
        st = sim_init(sp, 8, DEV)
        drops = torch.zeros(8, dtype=torch.int32, device=DEV)
        act = torch.zeros(8, 3, dtype=torch.long, device=DEV)
        phase = torch.zeros(8, device=DEV)
        with torch.no_grad():
            for t in range(n_int):
                rate = traces[:, t]
                obs = harness.sim_observe(cfg, sp, ep, st, drops, act, rate)
                act, _, _ = sample_actions(cfg, params, obs, fleet.masks,
                                           generator=g)
                arrivals, phase = spread_arrivals(sp, rate, phase)
                st2 = sim_interval(st, arrivals,
                                   action_caps(cfg, sp, ep, act))
                drops = st2.dropped - st.dropped
                st = st2
        out["eager"] = st

    alone = {}
    for t in (1, n_int + 1):
        with graph_spy(harness) as graphs:
            alone[t] = timed(torch, lambda: graphed(t)) - graphs[0].capture_s
    wall = (alone[n_int + 1] - alone[1]) / n_int
    log(f"  simulate graphed: {wall * 1e3:.3f} ms per replayed interval "
        f"alone; the first interval (eager) {alone[1] * 1e3:.2f} ms")
    with graph_spy(harness) as graphs:
        profiled(torch, graphed, n_int, "simulate graphed: 60 intervals",
                 "interval", capture=lambda: graphs[0].capture_s)
        log(f"    capture {graphs[0].capture_s:.4f} s")
    wall = timed(torch, eager)
    log(f"  simulate eager loop: {wall / n_int * 1e3:.3f} ms/interval alone")
    profiled(torch, eager, n_int, "simulate eager loop: 60 intervals",
             "interval", alone=wall)
    for a, b in zip(out["graphed"].tensors(), out["eager"].tensors()):
        if not torch.equal(a, b):
            raise AssertionError("simulate: graphed and eager final twin "
                                 "states differ")
    log("  simulate graphed == eager loop: final twin state identical")


KERNEL_NAMES = (("diversity_insert", 0), ("delta_codec", 1),
                ("queue_advance", 2))


def profiled(torch, fn, n, label, unit, capture=None, alone=None):
    """Run ``fn`` (``n`` units of work) under ``torch.profiler``; print the
    host wall per unit (less ``capture()`` seconds of graph capture where
    given), the device's busy share (also against ``alone``, the wall of
    the same work timed without the profiler, which slows graph replays),
    the kernels taking the most device time, and K1-K3's launch counters
    against the profiler's count of each kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    counted = read_launches()
    cap = capture() if capture else 0.0
    wall -= cap
    averages = prof.key_averages()      # one pass over the events
    kernels = [e for e in averages
               if str(e.device_type).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0.0)
    total = sum(dev_us(e) for e in kernels)
    n_launch = sum(e.count for e in kernels)
    if not total:
        log("  device time: not measured (the profiler recorded no kernel)")
        return None
    graph_launches = sum(e.count for e in averages
                         if e.key == "cudaGraphLaunch")
    log(f"  {label} under the profiler: wall {wall / n * 1e3:.2f} ms/{unit}"
        + (f" (capture {cap:.3f} s out)" if capture else "")
        + f", device busy {total / 1e3 / n:.3f} ms/{unit} "
        f"({100 * total / 1e6 / wall:.2f}% busy, "
        f"{100 - 100 * total / 1e6 / wall:.2f}% idle), "
        f"{n_launch / n:.0f} kernels/{unit}, "
        f"{graph_launches / n:.2f} cudaGraphLaunch/{unit}"
        + (f"; against the wall alone {100 * total / 1e6 / alone:.2f}% busy"
           if alone else ""))
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        log(f"    {dev_us(e) / 1e3 / n:8.4f} ms/{unit} "
            f"{e.count / n:6.1f} launches/{unit}  {e.key[:70]}")
    seen = [sum(e.count for e in kernels if name + "_kernel" in e.key)
            for name, _ in KERNEL_NAMES]
    log("    launch counters vs the profiler's kernels: " + ", ".join(
        f"{name} {counted[i]} / {seen[j]}"
        for j, (name, i) in enumerate(KERNEL_NAMES)))
    if any(counted[i] != seen[j] for j, (_, i) in enumerate(KERNEL_NAMES)):
        log("    (they differ: the profiler does not show every kernel "
            "inside a graph replay)")
    stamp_us = sum(dev_us(e) for e in kernels if "span_stamp" in e.key)
    return dict(kernels=n_launch / n, device_ms=total / 1e3 / n,
                stamp_ms=stamp_us / 1e3 / n,
                wall_ms=wall / n * 1e3, graph_launches=graph_launches / n,
                busy=(total / 1e6 / alone) if alone else None,
                launches=counted[:3])


def graph_parity(torch, backend, chaos=False, policy=None,
                 mode="sign_flip", health=False, single_head=False,
                 n_eps=8):
    """The graph driver against the reference driver on the card: A=8,
    P=2, ``fl_every=1``, ``n_eps`` episodes (eight: two pod merges; four:
    one), int8, Bernoulli
    stragglers (``chaos``: the chaos kwargs on top), noise from each
    fleet's generator (one seed): identical actions (recorded into a
    device buffer, which capture keeps), histories and final state bit for
    bit, equal launch counts, and equal generator states: the Philox
    offsets the replays advanced are the ones ``get_state()`` reports.
    ``policy``: the fleets stored at that state policy (every leaf
    compared at its stored dtype); ``mode``: the byzantine mode under
    ``chaos`` (``noise`` draws from the fault generator in the FL-round
    graph). ``health``: the observatory on (with ``chaos``, the suspicion
    gate at 0.5), its state compared with the rest and the streamed
    records with the histories. ``single_head``: the Fig. 12 ablation's
    fleet (one joint head, 8 parameter leaves)."""
    import numpy as np
    from repro_torch.configs.fcpo import FCPOConfig
    from repro_torch.core import crl
    from repro_torch.core.agent import sample_actions
    from repro_torch.core.fleet import (fleet_init, fleet_to_numpy,
                                        train_fleet_reference,
                                        train_fleet_scan)
    from repro_torch.fl.transport import TransportConfig
    cfg, a = FCPOConfig(fl_every=1, single_head=single_head), 8
    n = n_eps * cfg.n_steps
    kw = chaos_kwargs(mode) if chaos else dict(
        transport=TransportConfig(codec="int8"))
    if health:
        kw.update(health_kwargs(0.5 if chaos else 0.0))
    traces = torch.as_tensor(np.random.default_rng(5).uniform(
        5.0, 160.0, (a, n)).astype(np.float32), device=DEV)
    runs, sinks = [], []
    for drive_fn in (train_fleet_reference, train_fleet_scan):
        rec = torch.full((n, a, 3), -1, dtype=torch.long, device=DEV)
        pos = torch.zeros((), dtype=torch.long, device=DEV)

        def recording(*args, **kw):
            out = sample_actions(*args, **kw)
            rec.index_copy_(0, pos.view(1), out[0][None])
            pos.add_(1)
            return out

        crl.sample_actions = recording
        try:
            fleet = fleet_init(cfg, a, 11, n_pods=2, device=DEV,
                               env_backend=backend, state_policy=policy)
            sinks.append(ListSink())
            reset_launches()
            fleet, hist = drive_fn(cfg, fleet, traces, straggler_prob=0.25,
                                   seed=3, env_backend=backend,
                                   metrics_sink=sinks[-1] if health else None,
                                   **kw)
            counts = read_launches()[:3]
        finally:
            crl.sample_actions = sample_actions
        gens = [g.get_state() for g in (fleet.generator,
                                         fleet.fault_generator)
                if g is not None]
        runs.append((rec.cpu(), hist, fleet_to_numpy(fleet), counts, gens))
    (act_r, hist_r, st_r, n_r, g_r), (act_s, hist_s, st_s, n_s, g_s) = runs
    if len(g_r) != len(g_s) or not all(map(torch.equal, g_r, g_s)):
        raise AssertionError(f"graph parity ({backend}): generator states "
                             f"differ from the reference driver's")
    if (act_r < 0).any() or not torch.equal(act_r, act_s):
        raise AssertionError(f"graph parity ({backend}): the drivers took "
                             f"different actions")
    if n_r != n_s:
        raise AssertionError(f"graph parity ({backend}): launches {n_s} "
                             f"against the reference's {n_r}")
    if health:
        if sinks[0].records != sinks[1].records:
            raise AssertionError(f"graph parity ({backend}, health): the "
                                 f"streamed records differ")
        if "health" not in st_s or "health_susp" not in hist_s:
            raise AssertionError(f"graph parity ({backend}): no health")
        check_records(sinks[1].records, hist_s, f"graph parity ({backend})")

    got = dict(leaves(st_s))
    for name, want in [*leaves(st_r), *((f"history.{k}", v)
                                        for k, v in hist_r.items())]:
        have = got[name] if name in got else hist_s[name[8:]]
        if (name in got and have.dtype != want.dtype) or \
                not np.array_equal(raw(have), raw(want)):
            raise AssertionError(f"graph parity ({backend}): {name} differs "
                                 f"from the reference driver's")
    log(f"  {backend}{' (chaos, ' + mode + ')' if chaos else ''}"
        f"{' single head' if single_head else ''}"
        f"{' --state-dtype ' + policy if policy else ''}"
        f"{' --health' + (' gate 0.5' if chaos else '') if health else ''}"
        f"{', streamed records equal' if health else ''}: {n} control steps "
        f"of identical actions; "
        f"{len(hist_r)} history metrics and {len(got)} state leaves bit "
        f"for bit; {len(g_s)} generator states equal; launches K1, K2, K3 "
        f"{n_s} under both drivers")


# ---------------------------------------------------------------------------
# The flight recorder: span stamps, traced runs, request attribution, profile
# ---------------------------------------------------------------------------
def stamp_phase(torch):
    """``span_stamp`` against its plain version: for sampling periods 1-3,
    bases 0 and 5 and deltas 0 and -1, twenty episodes each, the kernel
    writes exactly the plain version's positions (only sampled rows) and
    its stamps grow in launch order; then 2,000 stamps back to back in one
    graph: the clock's resolution (the gcd of the differences) and the
    gap between two stamp nodes; then its time (one stamp a graph and 20
    a graph, median of five), the plain version's and the bound (24 B).
    Returns the timing with ``max_abs_err`` (for this kernel: the slots,
    over all 120 calls, that the kernel and the plain version write
    differently; a stamp's value is the clock's, which the plain version
    cannot know) and the resolution in ns."""
    import numpy as np
    from repro_torch.kernels.span_stamp import span_stamp, span_stamp_ref
    from repro_torch.obs import profile as prof
    i64 = dict(dtype=torch.int64, device=DEV)
    differ = 0
    for every in (1, 2, 3):
        for base, delta in ((0, 0), (5, -1)):
            got, want = (torch.zeros((8, 2), **i64) for _ in range(2))
            period, clock = torch.tensor(every, **i64), torch.ones((), **i64)
            for e in range(20):
                ep = torch.tensor(e, **i64)
                span_stamp(got, ep, period, 1, delta=delta, base=base)
                span_stamp_ref(want, ep, period, 1, delta=delta, base=base,
                               clock=clock)
            torch.cuda.synchronize()
            differ += int(((got != 0) != (want != 0)).sum())
            if not torch.equal(got != 0, want != 0):
                raise AssertionError(f"[stamp] every={every} base={base} "
                                     f"delta={delta}: written slots "
                                     f"{(got != 0).tolist()}, plain "
                                     f"{(want != 0).tolist()}")
            vals = got[:, 1][got[:, 1] != 0]
            if not bool((vals.diff() > 0).all()):
                raise AssertionError(f"[stamp] every={every}: stamps not "
                                     f"monotone")
    log("  span_stamp: the written slots equal the plain version's for "
        "every in 1..3, base 0 / 5, delta 0 / -1 (only sampled rows), "
        "stamps monotone")
    n = 2000
    s = torch.zeros((n, 1), **i64)
    rows = torch.arange(n, **i64)
    one = torch.ones((), **i64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        span_stamp(s, rows[0], one, 0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collected(), torch.cuda.graph(graph):
        for r in range(n):
            span_stamp(s, rows[r], one, 0)
    graph.replay()
    torch.cuda.synchronize()
    v = s[:, 0].cpu().numpy().astype(np.int64)
    d = np.diff(v)
    if (d < 0).any() or (v == 0).any():
        raise AssertionError("[stamp] back-to-back stamps not monotone")
    res = int(np.gcd.reduce(d[d > 0]))
    log(f"  %globaltimer: resolution {res} ns (gcd of {n - 1} differences); "
        f"two stamp nodes back to back in a graph are {d.min()} / "
        f"{float(np.median(d)):.0f} / {d.max()} ns apart (min / median / "
        f"max); {len(np.unique(v))} distinct values")
    st, st2 = torch.zeros((1, 2), **i64), torch.zeros((1, 2), **i64)
    zero = torch.zeros((), **i64)
    ms = median_ms(lambda: span_stamp(st, zero, one, 0))
    ms20 = median_ms(lambda: span_stamp(st, zero, one, 0), 10, per_graph=20)
    plain = median_ms(lambda: span_stamp_ref(st2, zero, one, 0, clock=one))
    bound = prof.kernel_cost("span_stamp")["bytes_accessed"] \
        / HBM_BYTES_PER_S * 1e3
    log(f"  span_stamp: {ms:.4f} ms a graph of one stamp, {ms20:.4f} ms a "
        f"stamp at 20 per graph; plain {plain:.4f} ms; bound {bound:.2e} "
        f"ms (bytes, 24 B)")
    return dict(max_abs_err=float(differ), ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by="bytes", library_ms=None), res


def check_trace(torch, path, n_eps, every, driver, label):
    """A ``--trace-out`` file of the CLI default (``fl_every`` 2, two pods,
    a merge every fourth round): valid; the sampled episodes' spans, each
    round's phases nested in it, episodes in order; no open or unmatched
    span. Returns the events."""
    import collections
    from repro_torch.obs.trace import validate_chrome_trace
    with open(path) as f:
        trace = json.load(f)
    bad = validate_chrome_trace(trace)
    if bad:
        raise AssertionError(f"{label}: invalid trace: {bad[:3]}")
    ev = trace["traceEvents"]
    if any(e["ph"] != "X" for e in ev):
        raise AssertionError(f"{label}: open or unmatched spans")
    counts = collections.Counter(e["name"] for e in ev)
    sampled = range(0, n_eps, every)
    rounds = sum(e % 2 == 1 for e in sampled)
    merges = sum(e in (7, 15) for e in sampled)
    want = {"episode": len(sampled)}
    if rounds:
        want["fl_round"] = rounds
        if driver == "scan":
            want.update({p: rounds for p in ("fl/uplink", "fl/aggregate",
                                             "fl/finetune")})
    if merges:
        want["pod_merge"] = merges
    if dict(counts) != want:
        raise AssertionError(f"{label}: spans {dict(counts)}, expected "
                             f"{want}")
    eps = sorted((e for e in ev if e["name"] == "episode"),
                 key=lambda e: e["ts"])
    for prev, nxt in zip(eps, eps[1:]):
        if nxt["ts"] < prev["ts"] + prev["dur"]:
            raise AssertionError(f"{label}: episodes overlap")
    rnds = [e for e in ev if e["name"] == "fl_round"]
    for e in ev:
        if e["name"].startswith("fl/") and not any(
                r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]
                for r in rnds):
            raise AssertionError(f"{label}: {e['name']} outside its round")
    return ev


def trace_phase(torch, cfg):
    """``train_fleet --trace-out`` at the CLI default, fluid and twin,
    under both drivers, at ``--trace-sample`` 1 and 2, beside the same run
    untraced: valid traces with the expected spans (``check_trace``),
    histories bit for bit, graph launches per episode unchanged, and under
    the graph driver the same ``span_stamp`` launches at either sampling
    (the stamps run on every episode and write only on sampled ones: one
    capture serves any sampling), calibration and stamp nodes counted.
    Then, per backend, 200 replayed episodes traced against 200 untraced
    in eight alternating turns, a profiled window of each
    (kernels per episode: up by the stamp nodes), and the traced window's
    episode spans against its wall per episode. Returns the fluid graph
    driver's stamp launches at sample 1 (the kernels line)."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.kernels.span_stamp import span_stamp
    from repro_torch.launch import train_fleet
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    n_eps, rounds, merges = 20, 10, 2
    # calibration (3) + episode (2 each) + round: fl_round, uplink,
    # aggregate, finetune (8 each) + merge (2 each)
    want_stamps = 3 + 2 * n_eps + 8 * rounds + 2 * merges
    main_launches = None
    try:
        for backend in ("fluid", "twin"):
            argv = ["--episodes", str(n_eps), "--device", DEV,
                    *(["--env-backend", "twin"] if backend == "twin" else [])]
            for driver in ("scan", "reference"):
                hists, stamps, per_ep = {}, {}, {}
                for every in (None, 1, 2):
                    extra = [] if every is None else [
                        "--trace-out", str(tmp / f"{backend}{driver}{every}"
                                           ".json"),
                        "--trace-sample", str(every)]
                    reset_launches()
                    span_stamp.launches = 0
                    with graph_spy(fleet_mod) as graphs:
                        _, hists[every] = train_fleet.main(
                            [*argv, "--driver", driver, *extra])
                    torch.cuda.synchronize()
                    stamps[every] = span_stamp.launches
                    per_ep[every] = sum(g.replays for g in graphs) / n_eps
                    if every is not None:
                        check_trace(torch, extra[1], n_eps, every, driver,
                                    f"[trace] {backend} {driver} "
                                    f"sample {every}")
                for every in (1, 2):
                    for k, v in hists[None].items():
                        if not np.array_equal(hists[every][k], v):
                            raise AssertionError(
                                f"[trace] {backend} {driver} sample {every}: "
                                f"history {k} differs from the untraced run")
                if len(set(per_ep.values())) != 1:
                    raise AssertionError(f"[trace] {backend} {driver}: graph "
                                         f"launches per episode {per_ep}")
                want = {None: 0, 1: want_stamps if driver == "scan" else 0,
                        2: want_stamps if driver == "scan" else 0}
                if stamps != want:
                    raise AssertionError(f"[trace] {backend} {driver}: "
                                         f"span_stamp launches {stamps}, "
                                         f"expected {want}")
                if backend == "fluid" and driver == "scan":
                    main_launches = stamps[1]
                log(f"  train_fleet {backend} --driver {driver} "
                    f"--trace-out: traces valid at --trace-sample 1 and 2, "
                    f"histories bit for bit against untraced, "
                    f"{per_ep[1]:.2f} graph launches/episode as untraced; "
                    f"span_stamp launches {stamps[1]} / {stamps[2]}")
            traced_windows(torch, cfg, backend)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return main_launches


def traced_windows(torch, cfg, backend, n_episodes=10, turn=50):
    """The graph driver on the CLI default (A=8, P=2) traced and untraced,
    each after eight episodes (eager first, captures): eight turns of
    ``turn`` replayed episodes timed alone (untraced, traced, traced,
    untraced, traced, untraced, untraced, traced: ``4 * turn`` episodes of
    each, so that the host's drift falls on both alike), then a profiled
    window of ``n_episodes`` of each: kernels and graph launches per
    episode (the stamp nodes are the difference), the stamp kernels'
    device time against the episode's, and, for the traced driver, its
    episode spans against its wall per episode."""
    import numpy as np
    from repro_torch.core.fleet import FleetScan, fleet_init
    from repro_torch.data.workload import fleet_traces
    from repro_torch.kernels.span_stamp import span_stamp
    from repro_torch.obs.trace import Tracer
    warm, n, order = 8, cfg.n_steps, (False, True, True, False,
                                       True, False, False, True)
    gen = torch.Generator().manual_seed(1)
    traces = fleet_traces(gen, 8, (warm + 4 * turn + 2 * n_episodes) * n,
                          device=DEV)
    tracer = Tracer()
    drivers = {}
    for traced in (False, True):
        drivers[traced] = FleetScan(
            cfg, fleet_init(cfg, 8, 0, n_pods=2, device=DEV,
                            env_backend=backend), traces,
            env_backend=backend, tracer=tracer if traced else None)
        for _ in range(warm):
            drivers[traced].step()
    walls = {False: [], True: []}

    def steps(traced):
        def run():
            for _ in range(turn):
                drivers[traced].step()
        return run

    for traced in order:
        walls[traced].append(timed(torch, steps(traced)) / turn * 1e3)
    tracer.drain()
    tracer.events.clear()
    before = span_stamp.launches
    wall_traced = timed(torch, lambda: [drivers[True].step()
                                        for _ in range(n_episodes)])
    stamps = span_stamp.launches - before
    tracer.drain()
    spans = [e["dur"] for e in tracer.events if e["name"] == "episode"]
    off, on = np.mean(walls[False]), np.mean(walls[True])
    # the spread of a turn's mean, over the turns of one condition, and
    # the standard error of the difference of the two means
    sd = np.sqrt((np.var(walls[False], ddof=1) + np.var(walls[True],
                                                        ddof=1)) / 4)
    log(f"  {backend} graph driver, eight turns of {turn} replayed "
        f"episodes (U T T U T U U T): untraced "
        f"{' / '.join(f'{w:.4f}' for w in walls[False])} ms/episode, "
        f"traced {' / '.join(f'{w:.4f}' for w in walls[True])}; means "
        f"{off:.4f} / {on:.4f} ms ({100 * (on - off) / off:+.3f} %, standard "
        f"error {100 * sd / off:.3f} %); the next {n_episodes} traced: "
        f"{stamps} stamp launches ({stamps / n_episodes:.2f}/episode), "
        f"episode spans mean {np.mean(spans) / 1e3:.3f} ms against a wall "
        f"of {wall_traced / n_episodes * 1e3:.3f} ms/episode")
    got = {}
    for traced in (False, True):
        got[traced] = profiled(
            torch, lambda: [drivers[traced].step()
                            for _ in range(n_episodes)], n_episodes,
            f"{backend} --driver scan{' traced' if traced else ''}: "
            f"{n_episodes} episodes", "episode") or {}
    if got[False] and got[True]:
        st = got[True]["stamp_ms"]
        log(f"  {backend}: kernels/episode {got[True]['kernels']:.1f} traced "
            f"against {got[False]['kernels']:.1f} untraced "
            f"({got[True]['kernels'] - got[False]['kernels']:+.1f}; the "
            f"window's stamp nodes {stamps / n_episodes:.1f}); graph "
            f"launches/episode {got[True]['graph_launches']:.2f} / "
            f"{got[False]['graph_launches']:.2f}; device ms/episode "
            f"{got[True]['device_ms']:.4f} traced against "
            f"{got[False]['device_ms']:.4f} untraced, of which the stamp "
            f"kernels {st * 1e3:.3f} us "
            f"({100 * st / got[True]['device_ms']:.3f} % of the traced "
            f"episode's device time)")
    tracer.close()


def attribution_phase(torch, cfg):
    """``simulate --attribution --trace-out`` at its defaults (A=8, 60
    intervals): K3 once per interval (the recording instantiation),
    conservation exact for every agent, a valid trace; then the recorded
    run on the card against the same run on the CPU (one fleet, one set of
    traces and Gumbel noise): final state, tick series, caps and the
    attribution's records exactly equal; then ms per replayed interval
    recorded against unrecorded in turns. Returns the K3 launches."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.fleet import (fleet_from_numpy, fleet_init,
                                        fleet_to_numpy)
    from repro_torch.launch import simulate
    from repro_torch.obs import requests as obs_requests
    from repro_torch.obs.trace import validate_chrome_trace
    from repro_torch.sim import harness
    from repro_torch.sim.scenarios import make_scenario
    from repro_torch.sim.state import SimParams
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_attr_"))
    try:
        path = tmp / "req.json"
        reset_launches()
        summ = simulate.main(["--attribution", "--trace-out", str(path),
                              "--device", DEV])
        k3 = read_launches()[2]
        with open(path) as f:
            trace = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if k3 != 60 or not summ["conservation_ok"].all() or \
            validate_chrome_trace(trace):
        raise AssertionError(f"[attribution] K3 {k3} launches, conservation "
                             f"{summ['conservation_ok'].tolist()}")
    log(f"  simulate --attribution --trace-out: K3 {k3} launches, "
        f"conservation exact for all {len(summ['conservation_ok'])} agents, "
        f"{len(trace['traceEvents'])} request slices, trace valid")
    sp, a, t = SimParams(), 8, 60
    tree = fleet_to_numpy(fleet_init(cfg, a, 0, device="cpu"))
    traces = make_scenario("dynamic", torch.Generator().manual_seed(2), a,
                           t + 1, device="cpu")
    rng = np.random.default_rng(3)
    u = rng.uniform(1e-6, 1.0, (t + 1, a, 15))
    gumbel = torch.tensor((-np.log(-np.log(u))).astype(np.float32))
    runs = {}
    for dev in (DEV, "cpu"):
        f = fleet_from_numpy(cfg, tree, device=dev)
        args = (cfg, sp, f.astate.policy.params(), f.masks, f.env_params)
        runs[dev] = harness.simulate_fleet(
            *args, traces[:, :t].to(dev), gumbel=gumbel[:t].to(dev),
            record_ticks=True)
    (sk, hk, _), (sc, hc, _) = runs[DEV], runs["cpu"]
    for name, x, y in zip(("arrive", "counters", "credits", "lat_sum",
                           "hist"), sk.tensors(), sc.tensors()):
        if not torch.equal(x.cpu(), y):
            raise AssertionError(f"[attribution] card vs CPU: {name} differs")
    for k in ("tick_counters", "caps"):
        if not np.array_equal(hk[k], hc[k]):
            raise AssertionError(f"[attribution] card vs CPU: {k} differs")
    ak, ac = (obs_requests.attribute_run(h, s) for h, s in
              ((hk, sk), (hc, sc)))
    if ak["records"] != ac["records"] or \
            not all(r["ok"] for r in ak["conservation"]):
        raise AssertionError("[attribution] card vs CPU: records differ or "
                             "conservation failed")
    log(f"  recorded simulate_fleet card vs CPU (A={a}, {t} intervals, one "
        f"noise): final twin state, {hk['tick_counters'].size} tick "
        f"counters, caps and {len(ak['records'])} request records "
        f"identical; conservation exact")
    # ms per replayed interval, recorded against unrecorded, in turns
    f = fleet_from_numpy(cfg, tree, device=DEV)
    args = (cfg, sp, f.astate.policy.params(), f.masks, f.env_params)
    tr_dev, g_dev = traces.to(DEV), gumbel.to(DEV)

    def per_interval(record):
        alone = {}
        for n in (1, t + 1):
            with graph_spy(harness) as graphs:
                alone[n] = timed(torch, lambda: harness.simulate_fleet(
                    *args, tr_dev[:, :n], gumbel=g_dev[:n],
                    record_ticks=record)) - graphs[0].capture_s
        return (alone[t + 1] - alone[1]) / t * 1e3

    turns = [per_interval(r) for r in (False, True, True, False)]
    off, on = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    log(f"  simulate graphed, ms per replayed interval: unrecorded "
        f"{turns[0]:.4f} / {turns[3]:.4f}, recorded {turns[1]:.4f} / "
        f"{turns[2]:.4f} ({on - off:+.4f} ms)")
    return k3


def obs_profile_phase(torch, cfg):
    """``fleet_memory_report`` at A=2048, P=8 (float32 and lean): per
    policy the graph driver's peak memory (``max_memory_allocated`` around
    the run's capture and replays), arguments, outputs, temporaries, the
    counted episode and round's operations and bytes, and the in-place
    audit (every fleet leaf updated in place)."""
    from repro_torch.obs.profile import fleet_memory_report
    t0 = time.time()
    rep = fleet_memory_report(cfg, 2048, n_pods=8, device=DEV)
    for pol, row in rep.items():
        if row["donation_ok"] != 1.0:
            raise AssertionError(f"[obs profile] {pol}: {row['aliased_args']}"
                                 f" of {row['donated_leaves']} leaves updated "
                                 f"in place")
        log(f"  A=2048 P=8 {pol}: peak {row['peak_bytes'] / 2**20:.2f} MiB "
            f"({row['peak_bytes_per_agent']:.0f} B/agent; arguments "
            f"{row['argument_size_in_bytes'] / 2**20:.2f} MiB, outputs "
            f"{row['output_size_in_bytes']:.0f} B, temporaries "
            f"{row['temp_size_in_bytes'] / 2**20:.2f} MiB), state "
            f"{row['state_per_agent']:.0f} B/agent; one episode + one round: "
            f"{row['ops']:.0f} ops, {row['flops'] / 1e9:.3f} GFLOP, "
            f"{row['bytes_accessed'] / 2**20:.1f} MiB accessed (upper "
            f"bound); {row['aliased_args']:.0f}/{row['donated_leaves']:.0f} "
            f"leaves in place")
    f32, lean = rep["float32"], rep["lean"]
    log(f"  peak per agent float32 / lean: "
        f"{f32['peak_bytes_per_agent'] / lean['peak_bytes_per_agent']:.3f}x;"
        f" {time.time() - t0:.1f} s")

# ---------------------------------------------------------------------------
# State dtype policies, checkpoint resume, state bytes
# ---------------------------------------------------------------------------
def state_dtype_phase(torch, cfg):
    """``train_fleet --state-dtype bf16 / lean --fl-codec int8``, fluid and
    twin, ``CUT_EPISODES`` episodes under both drivers: the default run's launch counts
    (K1 once per episode, K2 once per round, K3 once per twin interval) and
    histories equal bit for bit between the drivers; the graph driver
    against the reference driver bit for bit per policy (every leaf at its
    stored dtype, generator states equal), plain and under the chaos slice
    with byzantine noise; a float32-policy fleet is the default fleet bit
    for bit; the card against the CPU per policy; ten profiled episodes per
    policy under the graph driver (graph parity over four episodes).
    Returns {(policy, backend): (K1, K2, K3)}."""
    from repro_torch.configs.fcpo import FCPOConfig
    n = cfg.n_steps
    counts = {}
    for policy in POLICIES:
        for backend in ("fluid", "twin"):
            argv = ["--episodes", str(CUT_EPISODES), "--state-dtype", policy,
                    "--fl-codec", "int8"]
            if backend == "twin":
                argv += ["--env-backend", "twin"]
            counts[policy, backend] = drive(torch, argv, CUT_EPISODES,
                                            cfg.fl_every, n, strict=True)
    log("  launches of K1, K2, K3 per policy: " + json.dumps(
        {f"{p}/{b}": c for (p, b), c in counts.items()}))
    for policy in POLICIES:
        for backend in ("fluid", "twin"):
            graph_parity(torch, backend, policy=policy, n_eps=4)
            graph_parity(torch, backend, chaos=True, policy=policy,
                         mode="noise", n_eps=4)
    float32_is_default(torch)
    for policy in POLICIES:
        for backend in ("fluid", "twin"):
            run_pair(torch, FCPOConfig(fl_every=1), backend, policy=policy)
    for policy in ("float32", *POLICIES):
        for backend in ("fluid", "twin") if policy != "float32" \
                else ("fluid",):
            profile_episodes(torch, cfg, backend, policy=policy,
                             reference=False)
    return counts


def float32_is_default(torch):
    """A fleet built with ``state_policy="float32"`` trains as one built
    without a policy: histories and every state leaf bit for bit."""
    import numpy as np
    from repro_torch.configs.fcpo import FCPOConfig
    from repro_torch.core.fleet import (fleet_init, fleet_to_numpy,
                                        train_fleet_scan)
    cfg, a = FCPOConfig(fl_every=1), 8
    traces = torch.as_tensor(np.random.default_rng(5).uniform(
        5.0, 160.0, (a, 8 * cfg.n_steps)).astype(np.float32), device=DEV)
    out = []
    for policy in (None, "float32"):
        fleet, hist = train_fleet_scan(
            cfg, fleet_init(cfg, a, 11, n_pods=2, device=DEV,
                            state_policy=policy), traces, seed=3,
            straggler_prob=0.25, **chaos_kwargs())
        out.append((hist, dict(leaves(fleet_to_numpy(fleet)))))
    (h0, s0), (h1, s1) = out
    for k, v in [*h0.items(), *s0.items()]:
        w = h1[k] if k in h1 else s1[k]
        if not np.array_equal(v, w):
            raise AssertionError(f"--state-dtype float32: {k} differs from "
                                 f"the default run's")
    log(f"  --state-dtype float32 == the default (chaos, eight episodes): "
        f"{len(h0)} history metrics and {len(s0)} state leaves bit for bit")


def resume_phase(torch, cfg):
    """``train_fleet --state-dtype lean`` with the chaos slice, byzantine
    noise, ``--health`` and ``--metrics-out``, 20 episodes, the graph
    driver: once straight through (``--ckpt-every 5``), once killed by
    ``--stop-after 7`` and rerun. The checkpoints land at 5, 7, 12, 17,
    20; the two invocations' histories are the straight run's, the final
    checkpoint is its checkpoint bit for bit (both generators' states and
    the health state included) and the resumed metrics file holds the
    straight file's episode records. That checkpoint then restores on the
    CPU, every leaf equal."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.fleet import fleet_init
    from repro_torch.launch import train_fleet
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.eval.stream import read_metrics
    from repro_torch.health import HealthConfig
    argv = ["--episodes", "20", "--state-dtype", "lean", *NOISE_ARGV,
            "--health", "--ckpt-every", "5", "--device", DEV]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        reset_launches()
        _, h_s = train_fleet.main([*argv, "--ckpt-dir", str(tmp / "a"),
                                   "--metrics-out", str(tmp / "a.jsonl")])
        k = read_launches()[:3]
        if k != (20, 20 // cfg.fl_every, 0):
            raise AssertionError(f"[resume]: K1, K2, K3 launched {k}")
        killed = [*argv, "--ckpt-dir", str(tmp / "b"),
                  "--metrics-out", str(tmp / "b.jsonl")]
        _, h_1 = train_fleet.main([*killed, "--stop-after", "7"])
        if ckpt.latest_step(str(tmp / "b")) != 7:
            raise AssertionError("[resume]: --stop-after 7 left no "
                                 "checkpoint at episode 7")
        _, h_2 = train_fleet.main(killed)
        for key, v in h_s.items():
            if not np.array_equal(np.concatenate([h_1[key], h_2[key]]), v):
                raise AssertionError(f"[resume]: history {key} differs "
                                     f"from the straight run's")
        with np.load(tmp / "a" / "step_00000020.npz") as a, \
                np.load(tmp / "b" / "step_00000020.npz") as b:
            want = {key: a[key] for key in a.files}
            got = {key: b[key] for key in b.files}
        if set(got) != set(want) or not all(
                np.array_equal(raw(got[key]), raw(v))
                for key, v in want.items()):
            raise AssertionError("[resume]: the resumed run's final "
                                 "checkpoint differs from the straight "
                                 "run's")
        gens = [key for key in want if key.startswith("torch/")]
        n_health = sum(key.startswith("13/") for key in want)
        if not n_health:
            raise AssertionError("[resume]: no health state in the "
                                 "checkpoint")
        episodes = lambda path: [r for r in read_metrics(str(path))[1]
                                 if "episode" in r]
        if episodes(tmp / "a.jsonl") != episodes(tmp / "b.jsonl") or \
                len(episodes(tmp / "a.jsonl")) != 20:
            raise AssertionError("[resume]: the resumed metrics file's "
                                 "records differ from the straight run's")
        log(f"  stop at 7 and rerun == straight run: 20 episodes of "
            f"histories, all {len(want)} checkpoint arrays ({n_health} of "
            f"health state, {', '.join(gens)} included) and the 20 "
            f"streamed episode records bit for bit")
        like = fleet_init(cfg, 8, 0, n_pods=2, device="cpu",
                          state_policy="lean", health=HealthConfig())
        on_cpu, manifest = ckpt.restore(str(tmp / "b"), 20, like, cfg)
        flat = ckpt.fleet_flat(on_cpu)
        for key, v in flat.items():
            if not key.startswith("torch/") and not np.array_equal(
                    raw(v), raw(want[key])):
                raise AssertionError(f"[resume]: {key} restored on the CPU "
                                     f"differs")
        log(f"  the card's checkpoint restores on the CPU: {len(flat)} "
            f"leaves equal (generator states restored: "
            f"{manifest['restored_generators'] or 'none, another device'})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The health observatory, the metrics stream, the leaderboard
# ---------------------------------------------------------------------------
# (episode body, FL-round body) ops that the graph driver's bodies
# dispatch on the card without health or sink (``body_ops``, A=8, P=2,
# the CLI's default run), as the port before the health observatory
# dispatched them, counted by ``body_ops`` under torch ``BODY_OPS_TORCH``
BODY_OPS_TORCH = "2.11.0+cu128"
PARENT_BODY_OPS = {"fluid": [1964, 1150], "twin": [2357, 1152]}


def body_ops(torch, cfg, backend, **kw):
    """The non-view ops the graph driver's episode and FL-round bodies
    dispatch on ``DEV`` (A=8, P=2, one eager call of each after four
    episodes: the graphs capture exactly these). Each op is at most a
    kernel or a copy; the kernels K1–K3 launch through ``ctypes`` and are
    counted by their own counters."""
    from repro_torch.obs.profile import OpBytes
    from repro_torch.core.fleet import FleetScan, fleet_init
    from repro_torch.data.workload import fleet_traces

    gen = torch.Generator()
    gen.manual_seed(1)
    driver = FleetScan(cfg, fleet_init(cfg, 8, 0, n_pods=2, device=DEV,
                                       env_backend=backend),
                       fleet_traces(gen, 8, 6 * cfg.n_steps, device=DEV),
                       env_backend=backend, **kw)
    for _ in range(4):
        driver.step()
    out = []
    for graph in driver.graphs[:2]:
        with OpBytes() as c:
            graph.body()
        out.append(c.ops)
    torch.cuda.synchronize()
    return out


def health_phase(torch, cfg, default, k_base):
    """``train_fleet --health --metrics-out --alerts-out`` fluid and twin,
    ``CUT_EPISODES`` episodes under both drivers (histories bit for bit), then with the
    chaos flags and ``--susp-threshold 0.5``: K1, K2 and K3 launch as in
    the same runs without health (``k_base``). The graph driver against
    the reference driver with health (plain and gated chaos; four
    episodes), bit for bit
    with equal launch counts and streamed records; the card against the
    CPU at A=4; per backend, the ops the episode and round bodies
    dispatch without health exactly the parent port's
    (``PARENT_BODY_OPS``, ``body_ops``) and with it, and ten profiled
    episodes of the graph driver with and without health (the profiler's kernel counts are
    reported beside ``default``, the default window profiled earlier in
    this call: they move by a few kernels between windows of one call).
    Returns the windows {(backend, health on): numbers}."""
    import shutil
    import tempfile
    from repro_torch.configs.fcpo import FCPOConfig
    n = cfg.n_steps
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_health_"))
    counts = {}
    try:
        for backend in ("fluid", "twin"):
            twin = ["--env-backend", "twin"] if backend == "twin" else []
            out = ["--health", "--metrics-out", str(tmp / "run.jsonl"),
                   "--alerts-out", str(tmp / "alerts.jsonl")]
            counts[backend] = drive(torch, ["--episodes", str(CUT_EPISODES),
                                            *out, *twin], CUT_EPISODES,
                                    cfg.fl_every, n, strict=True)
            counts[backend + " chaos"] = drive(
                torch, ["--episodes", str(CUT_EPISODES), *CHAOS_ARGV, *out,
                        "--susp-threshold", "0.5", *twin], CUT_EPISODES,
                cfg.fl_every, n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  launches of K1, K2, K3 with --health: " + json.dumps(counts))
    if counts != k_base:
        raise AssertionError(f"[health]: K1, K2, K3 launched {counts}, "
                             f"without health {k_base}")
    for backend in ("fluid", "twin"):
        graph_parity(torch, backend, health=True, n_eps=4)
        graph_parity(torch, backend, chaos=True, health=True, n_eps=4)
    for backend in ("fluid", "twin"):
        run_pair(torch, FCPOConfig(fl_every=1), backend, health=True)
    run_pair(torch, FCPOConfig(fl_every=1), "twin", chaos=True, health=True)
    for backend in ("fluid", "twin"):
        ops_off = body_ops(torch, cfg, backend)
        ops_on = body_ops(torch, cfg, backend, **health_kwargs())
        if torch.__version__ != BODY_OPS_TORCH:
            raise AssertionError(
                f"[health] {backend}: PARENT_BODY_OPS were counted under "
                f"torch {BODY_OPS_TORCH}, this is {torch.__version__}: "
                f"count them again with body_ops on the parent port")
        if ops_off != PARENT_BODY_OPS[backend]:
            raise AssertionError(
                f"[health] {backend}: without --health the episode and "
                f"round bodies dispatch {ops_off} ops, the parent port "
                f"{PARENT_BODY_OPS[backend]}")
        log(f"  [health] {backend}: episode / round bodies dispatch "
            f"{ops_off[0]} / {ops_off[1]} ops without --health (the parent "
            f"port's), {ops_on[0]} / {ops_on[1]} with it (+"
            f"{ops_on[0] - ops_off[0]} / +{ops_on[1] - ops_off[1]})")
    windows = {}
    for backend in ("fluid", "twin"):
        windows[backend, False] = profile_episodes(torch, cfg, backend,
                                                   reference=False)
        windows[backend, True] = profile_episodes(torch, cfg, backend,
                                                  reference=False,
                                                  **health_kwargs())
        off, on, base = windows[backend, False], windows[backend, True], \
            default[backend]
        if on.get("launches") != off.get("launches"):
            raise AssertionError(f"[health] {backend}: K1, K2, K3 "
                                 f"{on.get('launches')} in the profiled "
                                 f"window, {off.get('launches')} without")
        log(f"  [health] {backend}: --health adds "
            f"{on.get('kernels', 0) - off.get('kernels', 0):.1f} kernels and "
            f"{on['alone_ms'] - off['alone_ms']:.3f} ms per replayed episode "
            f"alone ({on['alone_ms']:.3f} against {off['alone_ms']:.3f}), "
            f"device {on.get('device_ms', 0) - off.get('device_ms', 0):.3f} "
            f"ms; {on.get('graph_launches')} graph launches an episode; "
            f"without --health the profiler counts {off.get('kernels')} "
            f"kernels an episode, in the default window "
            f"{base.get('kernels')}")
    return windows


def metrics_phase(torch, cfg):
    """``train_fleet --health --fl-codec int8 --metrics-out --alerts-out``
    under both drivers: the file's episode records equal the returned
    history, a trailing scaling record follows; ``watch`` renders the
    file. Then ms per replayed episode with a JSONL sink against without
    one (health on, fluid; alternately off, on, on, off, ten episodes
    each after eight), and ten profiled episodes with health and the sink
    (at most three graph launches an episode). Returns the timings."""
    import shutil
    import tempfile
    from repro_torch.core.fleet import FleetScan, fleet_init
    from repro_torch.data.workload import fleet_traces
    from repro_torch.eval.stream import MetricsSink, read_metrics
    from repro_torch.launch import train_fleet
    from repro_torch.launch.watch import render
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_metrics_"))
    try:
        for driver in ("scan", "reference"):
            path, alerts = tmp / f"{driver}.jsonl", tmp / "alerts.jsonl"
            _, hist = train_fleet.main([
                "--episodes", "20", "--health", "--fl-codec", "int8",
                "--device", DEV, "--driver", driver, "--metrics-out",
                str(path), "--alerts-out", str(alerts)])
            _, recs = read_metrics(str(path))
            check_records(recs[:-1], hist, f"[metrics] {driver}")
            if "devices" not in recs[-1]:
                raise AssertionError("[metrics]: no trailing scaling record")
            log(f"  --driver {driver}: {len(recs) - 1} records equal the "
                f"returned history, then the scaling record "
                f"{json.dumps(recs[-1])}")
        text = render(str(path), 10, alerts_path=str(alerts))
        if "episodes recorded: 20" not in text or "health:" not in text:
            raise AssertionError("[metrics]: watch did not render the run")
        for line in text.splitlines():
            log("    watch | " + line)

        warm, n_eps, n = 8, 10, cfg.n_steps
        gen = torch.Generator()
        gen.manual_seed(1)
        traces = fleet_traces(gen, 8, (warm + n_eps) * n, device=DEV)
        hk = health_kwargs()
        per = {False: [], True: []}
        for i, on in enumerate((False, True, True, False)):
            sink = MetricsSink(str(tmp / f"t{i}.jsonl")) if on else None
            driver = FleetScan(cfg, fleet_init(cfg, 8, 0, n_pods=2,
                                               device=DEV), traces,
                               metrics_sink=sink, **hk)
            for _ in range(warm):
                driver.step()

            def steps():
                for _ in range(n_eps):
                    driver.step()
                driver.drain()
            per[on].append(timed(torch, steps) / n_eps * 1e3)
            if sink is not None:
                sink.close()
                if len(read_metrics(str(tmp / f"t{i}.jsonl"))[1]) != \
                        warm + n_eps:
                    raise AssertionError("[metrics]: records lost")
        off, on = sum(per[False]) / 2, sum(per[True]) / 2
        log(f"  sink cost (fluid, --health, ten replayed episodes alone, "
            f"off/on/on/off): {per[False][0]:.3f} / {per[True][0]:.3f} / "
            f"{per[True][1]:.3f} / {per[False][1]:.3f} ms per episode; "
            f"the sink adds {on - off:.3f} ms per episode")
        ring_waits = sink_ring_of_two(torch, cfg, traces, hk)
        with MetricsSink(str(tmp / "profiled.jsonl")) as sink:
            window = profile_episodes(torch, cfg, metrics_sink=sink, **hk)
        if window["max_graph_launches"] > 3:
            raise AssertionError("[metrics]: more than 3 graph launches")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(off_ms=off, on_ms=on, window=window, ring_waits=ring_waits)


def sink_ring_of_two(torch, cfg, traces, hk):
    """The graph driver's stream with ``SINK_DEPTH`` 2 over ``traces``:
    the host runs ahead of the device and waits for its oldest copy
    (``SinkTap.waits`` > 0); the records are the history, in order, each
    once. Returns the waits."""
    from repro_torch.core import fleet as tfleet
    records = []

    class ListSink:
        append = staticmethod(records.append)

    depth, tfleet.SINK_DEPTH = tfleet.SINK_DEPTH, 2
    try:
        driver = tfleet.FleetScan(cfg, tfleet.fleet_init(
            cfg, 8, 0, n_pods=2, device=DEV), traces,
            metrics_sink=ListSink(), **hk)
        _, hist = driver.run()
    finally:
        tfleet.SINK_DEPTH = depth
    check_records(records, hist, "[metrics] ring of two")
    if driver.tap.waits == 0:
        raise AssertionError("[metrics] ring of two: the host never waited "
                             "for a slot")
    log(f"  ring of two: {len(records)} records equal the history; the "
        f"host waited {driver.tap.waits} times for a slot")
    return driver.tap.waits


def leaderboard_phase(torch, cfg):
    """The default ``train_fleet`` run of ``[main path]`` (20 episodes)
    with a checkpoint at its end, loaded by ``load_fleet`` and scored on
    {steady, burst} × {fluid, twin} × {float32, int8} (one replicate, six
    adaptation episodes, 30 held-out twin intervals), twice: finite rows,
    equal between the two calls. Returns the rows."""
    import shutil
    import tempfile
    from repro_torch.eval import leaderboard as lb
    from repro_torch.launch import train_fleet
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_board_"))
    try:
        train_fleet.main(["--episodes", "20", "--device", DEV,
                          "--ckpt-dir", str(tmp)])
        fleet = lb.load_fleet(cfg, str(tmp), n_agents=8, n_pods=2,
                              device=DEV)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cells = lb.grid_cells(("steady", "burst"), ("fluid", "twin"),
                          ("float32", "int8"))
    t0 = time.time()
    rows = lb.run_leaderboard(cfg, fleet, cells, replicates=1)
    wall = time.time() - t0
    again = lb.run_leaderboard(cfg, fleet, cells, replicates=1)
    if rows != again:
        raise AssertionError("[leaderboard]: rows differ between two calls")
    keys = ("reward_mean", "train_eff_mean", "eval_eff_mean",
            "eval_p99_mean", "eval_slo_mean", "fl_payload_bytes")
    for r in rows:
        if not all(math.isfinite(r[k]) for k in keys):
            raise AssertionError(f"[leaderboard]: {r['name']} not finite")
        log("  " + json.dumps({k: r[k] for k in ("name", *keys)}))
    log(f"  {len(rows)} cells in {wall:.2f} s, equal in a second call")
    return rows


def state_bytes_phase(torch, cfg):
    """Per policy at A=8 / P=2 and A=2048 / P=8: ``fleet_state_bytes`` by
    family, the ``torch.cuda.memory_allocated`` growth of building the
    fleet, and a checkpoint's save and restore wall time and file size.
    Lean must be at least 2x smaller per agent than float32 at A=2048."""
    import gc
    import shutil
    import tempfile
    from repro_torch.core.fleet import fleet_init, fleet_state_bytes
    from repro_torch.training import checkpoint as ckpt
    rows = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_bytes_"))
    try:
        for a, p in ((8, 2), (2048, 8)):
            for policy in ("float32", *POLICIES):
                pol = None if policy == "float32" else policy
                gc.collect()
                torch.cuda.synchronize()
                m0 = torch.cuda.memory_allocated()
                fleet = fleet_init(cfg, a, 0, n_pods=p, device=DEV,
                                   state_policy=pol)
                gc.collect()
                torch.cuda.synchronize()
                alloc = torch.cuda.memory_allocated() - m0
                b = fleet_state_bytes(fleet)
                d = tmp / f"{a}-{policy}"
                save_s = timed(torch, lambda: ckpt.save(str(d), 1, fleet))
                size = sum(f.stat().st_size for f in d.iterdir())
                like = fleet_init(cfg, a, 1, n_pods=p, device=DEV,
                                  state_policy=pol)
                restore_s = timed(torch, lambda: ckpt.restore(str(d), 1,
                                                              like, cfg))
                rows[a, policy] = dict(b, allocated=float(alloc),
                                       save_s=save_s, restore_s=restore_s,
                                       file_bytes=float(size))
                log(f"  A={a} P={p} {policy}: " + ", ".join(
                    f"{k} {v:.0f}" for k, v in b.items()
                    if k not in ("per_agent",))
                    + f" B; per agent {b['per_agent']:.1f} B; allocated "
                    f"{alloc} B; checkpoint {size} B, save "
                    f"{save_s * 1e3:.1f} ms, restore "
                    f"{restore_s * 1e3:.1f} ms")
                del fleet, like
            ratio = rows[a, "float32"]["per_agent"] / \
                rows[a, "lean"]["per_agent"]
            alloc_ratio = rows[a, "float32"]["allocated"] / \
                rows[a, "lean"]["allocated"]
            log(f"  A={a}: float32 / lean per agent {ratio:.3f} (bytes), "
                f"{alloc_ratio:.3f} (allocated)")
            if a == 2048 and ratio < 2.0:
                raise AssertionError(f"lean is {ratio:.3f}x smaller than "
                                     f"float32 per agent at A=2048 "
                                     f"(at least 2.0)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


# ---------------------------------------------------------------------------
# The LM side: K4 flash_attention, K5 decode_attention, K6 pack, serving
# ---------------------------------------------------------------------------
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
# ---------------------------------------------------------------------------
# The paper's comparison set: the single-head ablation (Fig. 12), the
# BCEdge / OctopInf / Distream baselines, the reference oracles
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# The fleet mesh: one NCCL rank with the graph driver, two gloo ranks
# ---------------------------------------------------------------------------
MESH_RANKS = 2          # gloo ranks sharing the card


def mesh_traces(torch, a, n_eps, n_steps):
    """The two-rank run's traces, made alike in every process."""
    import numpy as np
    return torch.as_tensor(np.random.default_rng(9).uniform(
        5.0, 160.0, (a, n_eps * n_steps)).astype(np.float32), device=DEV)


def mesh_gloo_run(torch, mesh=None):
    """``tests/test_mesh.py``'s settings at the size one card holds: A=8,
    P=2, int8, ``fl_every=1``, stragglers 0.3, eight episodes, the
    reference driver, on ``mesh`` (None: meshless). Returns (fleet,
    history, (K1, K2, K3) launches)."""
    from repro_torch.configs.fcpo import FCPOConfig
    from repro_torch.core.fleet import fleet_init, train_fleet_reference
    from repro_torch.fl.transport import TransportConfig
    cfg = FCPOConfig(fl_every=1)
    fleet = fleet_init(cfg, 8, 0, n_pods=2, device=DEV, mesh=mesh)
    reset_launches()
    fleet, hist = train_fleet_reference(
        cfg, fleet, mesh_traces(torch, 8, 8, cfg.n_steps), mesh=mesh,
        straggler_prob=0.3, seed=3, transport=TransportConfig(codec="int8"))
    torch.cuda.synchronize()
    return fleet, hist, read_launches()[:3]


def mesh_rank(rank, world, rendezvous, out):
    """One gloo rank of the two that share the card (``chip_smoke.py
    --mesh-rank``): checks that the graph driver refuses a gloo mesh on
    the card, runs ``mesh_gloo_run`` on the (pod 2, data 1) mesh, and
    writes the whole fleet (gathered; rank 0), the history and its own
    launch counts and per-rank bytes to ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.configs.fcpo import FCPOConfig
        from repro_torch.core.fleet import (FleetScan, fleet_device_bytes,
                                            fleet_gather, fleet_init,
                                            fleet_to_numpy)
        from repro_torch.kernels import build
        from repro_torch.launch.mesh import make_fleet_mesh
        build.build()
        mesh = make_fleet_mesh(world, 2, device_type="cuda")
        cfg = FCPOConfig(fl_every=1)
        try:
            FleetScan(cfg, fleet_init(cfg, 8, 0, n_pods=2, device=DEV,
                                      mesh=mesh),
                      mesh_traces(torch, 8, 1, cfg.n_steps), mesh=mesh)
            refused = ""
        except ValueError as e:
            refused = str(e)
        fleet, hist, counts = mesh_gloo_run(torch, mesh)
        per = fleet_device_bytes(fleet)
        whole = fleet_to_numpy(fleet_gather(fleet))
        info = dict(rank=rank, launches=counts, device_bytes=per,
                    agents=[fleet.placement.agents.start,
                            fleet.placement.agents.stop],
                    refused=refused)
        Path(out, f"rank{rank}.json").write_text(json.dumps(info))
        if rank == 0:
            np.savez(Path(out, "fleet.npz"), **{k: raw(v) for k, v in
                                                 leaves(whole)})
            np.savez(Path(out, "hist.npz"), **hist)
    finally:
        dist.destroy_process_group()


def mesh_two_ranks(torch):
    """Two gloo ranks spawned on the card against the meshless card run:
    within rtol/atol 1e-5 (an int8 residual's rounding tie by the tests'
    rule), integer state exact; two balanced ``fleet_device_bytes``
    entries; each rank's K1 / K2 launches one per episode / round; the
    graph driver refuses the gloo mesh."""
    import os
    import shutil
    import tempfile
    import numpy as np
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
             str(r), str(MESH_RANKS), str(tmp / "rendezvous"), str(tmp)],
            env=env) for r in range(MESH_RANKS)]
        try:
            for p in procs:
                p.wait(timeout=240)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"[mesh] the gloo ranks exited "
                                 f"{[p.returncode for p in procs]}")
        spawn_s = time.time() - t0
        infos = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
        got_fleet = dict(np.load(tmp / "fleet.npz"))
        got_hist = dict(np.load(tmp / "hist.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fleet, hist, counts = mesh_gloo_run(torch)
    from repro_torch.core.fleet import fleet_to_numpy
    want = {k: raw(v) for k, v in leaves(fleet_to_numpy(fleet))}
    for k, v in hist.items():
        np.testing.assert_allclose(got_hist[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=f"[mesh] gloo history {k}")
    for k, v in want.items():
        g = got_fleet[k]
        if k.startswith("residuals.") and v.dtype.kind == "f":
            # an int8 rounding tie moves a coordinate by one step (at most
            # two a leaf), as the CPU tests accept
            bad = ~np.isclose(g, v, rtol=1e-5, atol=1e-5)
            step = 2 * np.abs(v).reshape(len(v), -1).max(1)
            step = step.reshape((-1,) + (1,) * (v.ndim - 1))
            if bad.sum() > 2 or not (np.abs(g - v) <= 1.01 *
                                     np.broadcast_to(step, v.shape))[bad].all():
                raise AssertionError(f"[mesh] gloo {k}: {bad.sum()} off")
        elif v.dtype.kind == "f":
            np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"[mesh] gloo {k}")
        elif not np.array_equal(g, v):
            raise AssertionError(f"[mesh] gloo {k} differs")
    per = infos[0]["device_bytes"]
    vals = sorted(per.values())
    if len(per) != MESH_RANKS or vals[-1] > 2 * vals[0]:
        raise AssertionError(f"[mesh] gloo fleet_device_bytes {per}")
    for info in infos:
        if info["launches"] != [8, 8, 0]:
            raise AssertionError(f"[mesh] rank {info['rank']}: K1, K2, K3 "
                                 f"{info['launches']}, not 8, 8, 0")
        if "gloo process group cannot be" not in info["refused"]:
            raise AssertionError("[mesh] the graph driver took a gloo mesh "
                                 "on the card")
    log(f"  2 gloo ranks on the card (pod 2 x data 1, A=8: agents "
        f"{[i['agents'] for i in infos]}), reference driver, 8 episodes, "
        f"int8, stragglers 0.3: == the meshless card run within 1e-5 "
        f"({len(hist)} metrics, {len(want)} leaves); fleet_device_bytes "
        f"{per}; launches K1, K2, K3 per rank {[i['launches'] for i in infos]}"
        f" (meshless {list(counts)}); the graph driver refuses the gloo "
        f"mesh; gloo all_gather / all_reduce on CUDA tensors directly, no "
        f"host staging; {spawn_s:.1f} s for the spawn")


def mesh_window(torch, cfg, backend, mesh, n_episodes=10, profile=False):
    """Ten replayed episodes of the CLI default (A=8, P=2) after eight that
    run eagerly and capture the graphs, on ``mesh`` (None: meshless):
    ms per replayed episode alone, graph launches per episode (at most
    three) and the collectives (the counter, topped up per replay: per
    episode of the window, and per replay of each graph); ``profile``: ten more under ``torch.profiler``, counting
    its NCCL kernels and device-to-device copies per round."""
    from repro_torch.core.fleet import FleetScan, fleet_init
    from repro_torch.data.workload import fleet_traces
    from repro_torch.distributed.sharding import COLLECTIVES
    warm, n = 8, cfg.n_steps
    gen = torch.Generator()
    gen.manual_seed(1)
    traces = fleet_traces(gen, 8, (warm + 2 * n_episodes) * n, device=DEV)
    driver = FleetScan(cfg, fleet_init(cfg, 8, 0, n_pods=2, device=DEV,
                                       env_backend=backend, mesh=mesh),
                       traces, env_backend=backend, mesh=mesh)
    for _ in range(warm):
        driver.step()
    per_step = []

    def steps():
        for _ in range(n_episodes):
            before = driver.graph_launches
            driver.step()
            per_step.append(driver.graph_launches - before)
    rounds = lambda: int(driver.schedule[driver.episodes:
                                         driver.episodes + n_episodes].sum())
    c0 = COLLECTIVES.launches
    wall = timed(torch, steps)
    out = dict(ms=wall / n_episodes * 1e3, graph_launches=max(per_step),
               collectives_per_episode=(COLLECTIVES.launches - c0)
               / n_episodes,
               # per replay of the episode, round and merge graphs
               collectives_per_body=[g.launches.get(COLLECTIVES, 0)
                                     for g in driver.graphs])
    if max(per_step) > 3:
        raise AssertionError(f"[mesh] a replayed episode took "
                             f"{max(per_step)} graph launches (at most 3)")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        n_rounds = rounds()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            steps()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        out["nccl_kernels_per_round"] = sum(
            e.count for e in averages if "nccl" in e.key.lower()) / n_rounds
        out["dtod_per_round"] = sum(
            e.count for e in averages if "DtoD" in e.key) / n_rounds
        out["kernels_per_episode"] = sum(
            e.count for e in averages
            if str(e.device_type).endswith("CUDA")) / n_episodes
    return out


def mesh_phase(torch, cfg):
    """``train_fleet --mesh``. One NCCL rank: the CLI default (20
    episodes), fluid, twin and int8, ``--mesh fleet`` under the graph
    driver against ``--mesh none`` bit for bit (histories, the whole
    final fleet, K1–K3 launches), the graph launches per episode and the
    collectives and NCCL kernels per round, ms per replayed episode meshed
    and meshless in turns (none, fleet, fleet, none); ``--mesh debug`` ==
    ``--mesh none``; ``--mesh production`` raises, naming the ranks it
    needs and the world's. Then two gloo ranks on the card
    (``mesh_two_ranks``). Returns the windows."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.distributed.sharding import COLLECTIVES
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train_fleet
    mesh_mod.init_world("cuda")
    try:
        for argv, meshed in ((["--episodes", "20"], "fleet"),
                             (["--episodes", "20", "--env-backend", "twin"],
                              "fleet"),
                             (["--episodes", "20", "--fl-codec", "int8"],
                              "fleet"),
                             (["--episodes", "8", "--fl-every", "1"],
                              "debug")):
            runs = {}
            for mesh in ("none", meshed):
                reset_launches()
                COLLECTIVES.launches = 0
                with graph_spy(fleet_mod) as graphs:
                    fleet, hist = train_fleet.main(
                        [*argv, "--device", DEV, "--mesh", mesh])
                torch.cuda.synchronize()
                runs[mesh] = (hist, dict(leaves(fleet_mod.fleet_to_numpy(
                    fleet_mod.fleet_gather(fleet)))), read_launches()[:3],
                    sum(g.replays for g in graphs), COLLECTIVES.launches)
            (h0, s0, k0, g0, c0), (h1, s1, k1, g1, c1) = runs.values()
            for name, v in [*h0.items(), *s0.items()]:
                w = h1[name] if name in h1 else s1[name]
                if not np.array_equal(raw(v), raw(w)):
                    raise AssertionError(f"[mesh] {argv}: {name} differs "
                                         f"from the meshless run's")
            if k0 != k1 or g0 != g1 or c0 or not c1:
                raise AssertionError(f"[mesh] {argv}: launches {k1} / "
                                     f"{k0}, graph launches {g1} / {g0}, "
                                     f"collectives {c1} / {c0}")
            log(f"  {' '.join(argv)} --mesh {meshed} (1 NCCL rank) "
                f"== --mesh none bit for bit: {len(h0)} metrics, {len(s0)} "
                f"leaves; K1, K2, K3 {k1}, {g1} graph launches and {c1} "
                f"collectives in the run")
        try:
            train_fleet.main(["--episodes", "2", "--device", DEV, "--mesh",
                              "production"])
            raise AssertionError("[mesh] --mesh production ran on 1 rank")
        except ValueError as e:
            if "512 ranks; the world has 1" not in str(e):
                raise
            log(f"  --mesh production on 1 rank: ValueError: {e}")
        windows = {}
        mesh = mesh_mod.make_fleet_mesh(1, 2, "cuda")
        for backend in ("fluid", "twin"):
            turns = [mesh_window(torch, cfg, backend, m)
                     for m in (None, mesh, mesh, None)]
            plain = mesh_window(torch, cfg, backend, None, profile=True)
            windows[backend] = dict(
                meshless_ms=[turns[0]["ms"], turns[3]["ms"]],
                meshed_ms=[turns[1]["ms"], turns[2]["ms"]],
                meshless_kernels_per_episode=plain["kernels_per_episode"],
                meshless_dtod_per_round=plain["dtod_per_round"],
                **mesh_window(torch, cfg, backend, mesh, profile=True))
            log(f"  {backend}: ms per replayed episode meshless / meshed in "
                f"turns {turns[0]['ms']:.3f}, {turns[1]['ms']:.3f}, "
                f"{turns[2]['ms']:.3f}, {turns[3]['ms']:.3f}; graph "
                f"launches an episode at most {windows[backend]['graph_launches']}"
                f"; {windows[backend]['collectives_per_episode']:.1f} "
                f"collectives an episode (episode / round / merge graphs "
                f"{windows[backend]['collectives_per_body']}), the "
                f"profiler's NCCL kernels "
                f"{windows[backend]['nccl_kernels_per_round']:.1f} and "
                f"device copies {windows[backend]['dtod_per_round']:.1f} a "
                f"round (meshless "
                f"{windows[backend]['meshless_dtod_per_round']:.1f}), "
                f"{windows[backend]['kernels_per_episode']:.0f} kernels an "
                f"episode (meshless "
                f"{windows[backend]['meshless_kernels_per_episode']:.0f}), "
                f"profiled")
    finally:
        dist.destroy_process_group()
    mesh_two_ranks(torch)
    return windows


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def drive_single_head(torch, backend, n_eps=20):
    """``FCPOConfig(single_head=True)`` at A=8, P=2, int8, ``n_eps``
    episodes on nominal traces under ``train_fleet_scan`` and then
    ``train_fleet_reference``, the launch counts set to 0 just before each
    and read just after: K1 once per episode, K2 once per FL round, K3 once
    per twin interval; finite histories; the two drivers' histories and
    final state bit for bit. Returns the graph driver's (K1, K2, K3)."""
    import numpy as np
    from repro_torch.configs.fcpo import FCPOConfig
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.fl.transport import TransportConfig
    from repro_torch.sim import make_scenario
    cfg, a = FCPOConfig(single_head=True), 8
    n = cfg.n_steps
    traces = make_scenario("nominal", torch.Generator(device=DEV)
                           .manual_seed(0), a, n_eps * n, device=DEV)
    want = (n_eps, n_eps // cfg.fl_every,
            n_eps * n if backend == "twin" else 0)
    runs = {}
    for name, drive_fn in (("scan", fleet_mod.train_fleet_scan),
                           ("reference", fleet_mod.train_fleet_reference)):
        fleet = fleet_mod.fleet_init(cfg, a, 0, n_pods=2, device=DEV,
                                     env_backend=backend)
        reset_launches()
        with graph_spy(fleet_mod) as graphs:
            t0 = time.time()
            fleet, hist = drive_fn(cfg, fleet, traces, env_backend=backend,
                                   transport=TransportConfig(codec="int8"))
            torch.cuda.synchronize()
            wall = time.time() - t0
        counts = read_launches()[:3]
        if counts != want:
            raise AssertionError(f"[ablation] {backend} {name}: K1, K2, K3 "
                                 f"launched {counts}, expected {want}")
        for key, v in hist.items():
            if v.shape != (n_eps,) or not np.isfinite(v).all():
                raise AssertionError(f"[ablation] {backend} {name}: {key} "
                                     f"is not {n_eps} finite values")
        capture = sum(g.capture_s for g in graphs)
        runs[name] = (counts, hist, dict(leaves(fleet_mod.fleet_to_numpy(
            fleet))))
        log(f"  single head {backend} {name}: K1 {want[0]}, K2 {want[1]}, "
            f"K3 {want[2]} launches, {(wall - capture) / n_eps * 1e3:.2f} "
            f"ms/episode (capture {capture:.3f} s out)")
    (_, h_s, st_s), (_, h_r, st_r) = runs["scan"], runs["reference"]
    for k, v in h_r.items():
        if not np.array_equal(h_s[k], v):
            raise AssertionError(f"[ablation] {backend}: history {k} "
                                 f"differs between the drivers")
    for k, v in st_r.items():
        if not np.array_equal(raw(st_s[k]), raw(v)):
            raise AssertionError(f"[ablation] {backend}: {k} differs "
                                 f"between the drivers")
    if "params.head_bs.w" in st_s or "params.head_res.w" not in st_s:
        raise AssertionError("[ablation] the fleet is not single-head")
    log(f"  single head {backend}: histories ({len(h_r)} metrics) and "
        f"final state ({len(st_r)} leaves) bit for bit between the drivers")
    return runs["scan"][0]


def ablation_phase(torch, gen):
    """[ablation]: K2 on the single head's 8-leaf round, the single head
    through both drivers (launches, bit for bit), graph parity with
    recorded actions, and small card runs against the CPU. Returns
    ({backend: (K1, K2, K3)}, K2's single-head timing per codec)."""
    from repro_torch.configs.fcpo import FCPOConfig
    k2_ms = check_k2(torch, gen, SINGLE_HEAD_LEAF_SIZES, agents=(8,))
    counts = {b: drive_single_head(torch, b) for b in ("fluid", "twin")}
    for backend in ("fluid", "twin"):
        graph_parity(torch, backend, single_head=True)
        run_pair(torch, FCPOConfig(fl_every=1, single_head=True), backend)
    return counts, k2_ms


def baselines_phase(torch, gen, n_rep=8, n_eps=10, offline=20):
    """[baselines]: ``run_bcedge`` (``offline`` episodes on profiling
    traces, then the frozen runtime), ``run_octopinf`` (re-planned every 30
    intervals) and ``run_distream`` at n=8 replicas on ``DYNAMIC`` traces,
    fluid and twin, the launch counts set to 0 just before each call and
    read just after (K1 once per offline episode, K3 once per twin
    interval, K2 never); finite episode histories; then ms per runtime
    interval (a second call; BCEdge's without its offline phase); and the
    static policies on the card against the CPU. Returns (K1 launches of
    the BCEdge calls, K1 at N=700 (err, timing))."""
    import numpy as np
    from repro_torch.core import baselines
    from repro_torch.data.workload import DYNAMIC, fleet_traces
    # K1 at BCEdge's offline shape: N=700 slots, NA=13 (~62 KB of shared
    # memory a block, the opt-in path above 48 KB); A=2 at n=8
    k1 = check_k1(torch, baselines.bcedge_config(), gen, agents=(2, 64),
                  fills=(350, 800), tag="N=700 NA=13 ")
    n = baselines.bcedge_config().n_steps
    t_int = n_eps * n
    traces = fleet_traces(torch.Generator(device=DEV).manual_seed(0), n_rep,
                          t_int, device=DEV, **DYNAMIC)
    k1_bcedge = 0
    for backend in ("fluid", "twin"):
        twin = t_int if backend == "twin" else 0
        cases = (
            ("bcedge", lambda off, dev=DEV: baselines.run_bcedge(
                n_rep, traces.to(dev), 0, offline_episodes=off,
                env_backend=backend, device=dev),
             (offline, 0, offline * n * (twin > 0) + twin)),
            ("octopinf", lambda off, dev=DEV: baselines.run_octopinf(
                n_rep, traces.to(dev), period=30, env_backend=backend,
                device=dev), (0, 0, twin)),
            ("distream", lambda off, dev=DEV: baselines.run_distream(
                n_rep, traces.to(dev), env_backend=backend, device=dev),
             (0, 0, twin)))
        for name, run, want in cases:
            reset_launches()
            t0 = time.time()
            hist = run(offline)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = read_launches()[:3]
            if counts != want:
                raise AssertionError(f"[baselines] {name} {backend}: K1, "
                                     f"K2, K3 launched {counts}, expected "
                                     f"{want}")
            if name == "bcedge":
                k1_bcedge += counts[0]
            for key, v in hist.items():
                if v.shape != (n_eps,) or not np.isfinite(v).all():
                    raise AssertionError(f"[baselines] {name} {backend}: "
                                         f"{key} is not {n_eps} finite "
                                         f"values")
            t0 = time.time()
            run(0)
            torch.cuda.synchronize()
            per = (time.time() - t0) / t_int * 1e3
            log(f"  {name} {backend}: launches K1, K2, K3 {counts}; first "
                f"call {wall:.2f} s; runtime {per:.3f} ms/interval (host "
                f"wall, {t_int} intervals, {n_rep} replicas); effective "
                f"throughput {hist['effective_throughput'].mean():.2f} "
                f"req/s, reward {hist['reward'].mean():.4f}")
            if name != "bcedge":
                cpu = run(0, "cpu")
                for key, v in cpu.items():
                    np.testing.assert_allclose(
                        hist[key], v, rtol=1e-3, atol=1e-4,
                        err_msg=f"[baselines] {name} {backend} card vs "
                                f"cpu: {key}")
                log(f"  {name} {backend}: card == CPU within rtol 1e-3 / "
                    f"atol 1e-4 ({len(cpu)} metrics)")
    return k1_bcedge, k1


def oracles_phase(torch, t_int=50, a=8, steps=100):
    """[oracles]: ``sim_interval_agent`` on the card (K3 at A=1, once per
    interval) over ``t_int`` intervals of one agent against
    ``sim_interval_ref`` (the plain version on the card) bit for bit and
    the port's Python oracle request for request; ``buffer_insert`` (K1 at
    T=1, once per step) against ``buffer_insert_reference`` over ``steps``
    chained inserts at A=8, N=64: decisions equal (a divergence only at a
    near-tie, reported; that agent leaves the comparison), scores and
    moments within rtol 1e-4 / atol 1e-5."""
    import numpy as np
    from repro_torch.configs.fcpo import FCPOConfig
    from repro_torch.core import buffer as buf
    from repro_torch.sim import oracle, state as sim_state, step as sim_step
    sp = sim_state.SimParams()
    rng = np.random.default_rng(0)
    arrivals = rng.integers(0, 7, (t_int, sp.k_ticks)).astype(np.int32)
    caps = np.stack([rng.choice([1.5, 2.0, 2.5, 3.0], t_int),
                     rng.choice([2.0, 3.0, 4.0], t_int),
                     rng.choice([2.0, 4.0, 8.0], t_int),
                     rng.choice([1.0, 2.0, 3.0], t_int),
                     np.full(t_int, 64.0), np.full(t_int, 20.0)],
                    1).astype(np.float32)
    arr_d = torch.as_tensor(arrivals, device=DEV)
    caps_d = torch.as_tensor(caps, device=DEV)
    one = sim_state.SimState(*(x[0] for x in sim_state.sim_init(
        sp, 1, DEV).tensors()))
    st_k = st_p = one
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    for t in range(t_int):
        st_k = sim_step.sim_interval_agent(st_k, arr_d[t], caps_d[t])
    torch.cuda.synchronize()
    k_ms = (time.time() - t0) / t_int * 1e3
    k3 = read_launches()[2]
    t0 = time.time()
    for t in range(t_int):
        st_p = sim_step.sim_interval_ref(st_p, arr_d[t], caps_d[t])
    torch.cuda.synchronize()
    p_ms = (time.time() - t0) / t_int * 1e3
    if k3 != t_int or read_launches()[2] != t_int:
        raise AssertionError(f"[oracles] K3 launched {k3} times in "
                             f"{t_int} intervals")
    for name, x, y in zip(("arrive", "counters", "credits", "lat_sum",
                           "hist"), st_k.tensors(), st_p.tensors()):
        if not torch.equal(x, y):
            raise AssertionError(f"[oracles] sim_interval_agent {name} "
                                 f"differs from sim_interval_ref")
    t0 = time.time()
    py = oracle.simulate_python_agent(arrivals, caps, sp)
    o_ms = (time.time() - t0) / t_int * 1e3
    got = (int(st_k.arrived), int(st_k.dropped), int(st_k.completed),
           int(st_k.effective), float(st_k.lat_sum), int(st_k.in_flight))
    want = tuple(py[k] for k in ("arrived", "dropped", "completed",
                                 "effective", "lat_sum", "in_flight"))
    if got != want or not (py["dropped"] and py["effective"]
                           and py["effective"] < py["completed"]):
        raise AssertionError(f"[oracles] twin {got} != oracle {want}")
    log(f"  sim_interval_agent (K3 A=1, {t_int} launches) == "
        f"sim_interval_ref bit for bit == sim/oracle.py request for request "
        f"(arrived {want[0]}, dropped {want[1]}, completed {want[2]}, "
        f"effective {want[3]}); ms per interval: K3 {k_ms:.4f}, plain "
        f"{p_ms:.4f}, Python oracle {o_ms:.4f} (host wall)")

    cfg = FCPOConfig()
    gen = torch.Generator(device=DEV).manual_seed(3)
    na = cfg.n_res + cfg.n_bs + cfg.n_mt
    b_s = b_r = buf.buffer_init(cfg, a, DEV)
    gone, k1 = {}, 0
    for t in range(steps):
        s = torch.randn(a, cfg.state_dim, generator=gen, device=DEV) * 3.0
        p = torch.softmax(torch.randn(a, na, generator=gen, device=DEV), -1)
        pay = (torch.randint(0, 4, (a, 3), generator=gen, device=DEV),
               *(torch.randn(a, generator=gen, device=DEV)
                 for _ in range(3)))
        d = buf.diversity(cfg, b_r, s, p)
        filled, score = b_r.filled, b_r.score
        low = torch.where(filled, score, torch.inf)
        slot_r = torch.where(~filled.all(-1),
                             torch.argmin(filled.to(torch.int32), -1),
                             torch.argmin(low, -1))
        do_r = ~filled.all(-1) | (d > low.min(-1).values)
        before = read_launches()[0]
        b_s2 = buf.buffer_insert(cfg, b_s, s, pay[0], *pay[1:], p)
        k1 += read_launches()[0] - before
        b_r = buf.buffer_insert_reference(cfg, b_r, s, pay[0], *pay[1:], p)
        hit = (b_s2.score != b_s.score) | (b_s2.filled != b_s.filled)
        for i in range(a):
            slots = torch.nonzero(hit[i]).flatten().tolist()
            if i in gone or slots == ([int(slot_r[i])] if do_r[i] else []):
                continue
            sc = b_s.score[i]
            gaps = [abs(float(d[i]) - float(sc.min()))]
            if slots:
                gaps.append(abs(float(sc[slots[0]] - sc[int(slot_r[i])])))
            if min(gaps) > NEAR_TIE * max(1.0, abs(float(d[i]))):
                raise AssertionError(f"[oracles] buffer_insert agent {i} "
                                     f"step {t}: decision differs from the "
                                     f"recompute oracle with no near-tie "
                                     f"(gaps {gaps})")
            log(f"  buffer_insert agent {i} parts from the recompute "
                f"oracle at step {t} at a near-tie (gap {min(gaps):.3g}); "
                f"accepted, left out from here")
            gone[i] = t
        b_s = b_s2
    keep = torch.tensor([i not in gone for i in range(a)], device=DEV)
    if not keep.any():
        raise AssertionError("[oracles] every agent parted at a near-tie")
    for name in ("score", "s_sum", "s_outer", "p_sum"):
        torch.testing.assert_close(getattr(b_s, name)[keep],
                                   getattr(b_r, name)[keep], rtol=RTOL,
                                   atol=ATOL, msg=f"[oracles] {name}")
    for name in ("filled", "n_filled", "actions"):
        if not torch.equal(getattr(b_s, name)[keep],
                           getattr(b_r, name)[keep]):
            raise AssertionError(f"[oracles] buffer_insert {name} differs")
    if k1 != steps:
        raise AssertionError(f"[oracles] K1 launched {k1} times in "
                             f"{steps} buffer_insert calls")
    log(f"  buffer_insert (K1 T=1, {k1} launches) == "
        f"buffer_insert_reference over {steps} chained inserts at A={a}, "
        f"N={cfg.buffer_size}: decisions equal"
        + (f" up to near-ties (agents {sorted(gone)})" if gone else "")
        + ", scores and moments within rtol 1e-4 / atol 1e-5")
    return k3, k1


QWEN = "qwen2-0.5b"
# (b, sq, sk, hq, hkv, d, dtype, causal): tests/test_kernels.py FLASH_CASES
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, "float32", True),
    (2, 128, 128, 4, 2, 64, "float32", True),
    (1, 256, 256, 8, 1, 64, "float32", True),
    (1, 128, 128, 4, 4, 128, "bfloat16", True),
    (1, 128, 128, 2, 2, 256, "float32", True),
    (2, 128, 128, 4, 4, 80, "float32", False),
    (1, 384, 384, 7, 1, 64, "float32", True),
    (2, 50, 70, 4, 2, 32, "float32", False),       # ragged tiles
    (4, 2048, 2048, 14, 2, 64, "float32", True),   # the prefill shape
    (4, 2048, 2048, 14, 2, 64, "bfloat16", True),
]
# K4's bf16 path (wgmma, TMA) on every float32 shape of the sweep above
FLASH_BF16_CASES = [c[:6] + ("bfloat16", c[7]) for c in FLASH_CASES[:-2]
                    if c[6] == "float32"]
# (b, hq, hkv, d, s_max, kv_len, q dtype, cache dtype): DECODE_CASES, then
# the serve path (qwen2-0.5b, cache 256, bf16; and reduced over a bf16
# cache) and the engine defaults (B=64, cache 4096)
DECODE_CASES = [
    (2, 4, 4, 64, 256, 256, "float32", "float32"),
    (2, 4, 2, 64, 512, 300, "float32", "float32"),
    (1, 8, 2, 128, 512, 77, "float32", "float32"),
    (1, 14, 2, 64, 512, 500, "float32", "float32"),
    (1, 4, 4, 128, 256, 128, "bfloat16", "bfloat16"),
    (2, 16, 16, 256, 256, 199, "float32", "float32"),
    *[(b, 14, 2, 64, 256, 17, "bfloat16", "bfloat16") for b in (1, 2, 4, 8)],
    (8, 4, 2, 32, 256, 17, "float32", "bfloat16"),
    *[(64, 14, 2, 64, 4096, n, "bfloat16", "bfloat16")
      for n in (1, 777, 4096)],
]
# K5 with several splits and the combine (tests/test_torch_cuda.py
# DECODE_SPLIT_CASES): kv_len 4096 at B=2, one past a split boundary, a long
# S_max with a short kv_len, D=80 and 256, a group of 16 heads
DECODE_SPLIT_CASES = [
    (2, 14, 2, 64, 4096, 4096, "bfloat16", "bfloat16"),
    (2, 4, 2, 64, 4352, 4097, "float32", "float32"),
    (2, 4, 2, 32, 4352, 4097, "float32", "bfloat16"),
    (1, 8, 2, 128, 8192, 300, "float32", "float32"),
    (1, 4, 1, 80, 2048, 1500, "bfloat16", "bfloat16"),
    (1, 16, 16, 256, 1024, 1000, "float32", "float32"),
    (1, 16, 1, 64, 1024, 700, "bfloat16", "bfloat16"),
]
K5_MAIN = (8, 14, 2, 64, 256, 17, "bfloat16", "bfloat16")
K5_BIG = (64, 14, 2, 64, 4096, 4096, "bfloat16", "bfloat16")
K4_MAIN = FLASH_CASES[-1]


def attn_tol(dtype):
    """The JAX tests' tolerance: only the summation order differs."""
    return 2e-2 if dtype == "bfloat16" else 2e-5


def peak_flops(dtype):
    return BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS


def k4_inputs(torch, gen, case):
    b, sq, sk, hq, hkv, d, dtype, _ = case
    dt = getattr(torch, dtype)
    return [torch.randn(s, generator=gen, device=DEV).to(dt)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def k4_timing(torch, gen, case):
    """K4 at one shape: kernel, plain version and ``sdpa`` as the median
    of five readings, its bound (``obs.profile.kernel_cost``)."""
    from repro_torch.obs import profile as prof
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    b, sq, sk, hq, hkv, d, dtype, causal = case
    q, k, v = k4_inputs(torch, gen, case)
    ms = median_ms(lambda: flash_attention(q, k, v, causal=causal), 10)
    plain = median_ms(lambda: flash_attention_ref(q, k, v, causal=causal), 3)
    lib = median_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True))
    cost = prof.kernel_cost("flash_attention", b=b, s=sq, hq=hq, hkv=hkv,
                            d=d, causal=causal, itemsize=q.element_size())
    flops, moved = cost["flops"], cost["bytes_accessed"]
    t_ops, t_bytes = flops / peak_flops(dtype), moved / HBM_BYTES_PER_S
    row = dict(ms=ms, plain_ms=plain, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=lib)
    log(f"  K4 {dtype} B={b} S={sq} Hq={hq} Hkv={hkv} D={d} "
        f"{'causal' if causal else 'bidirectional'}: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
        f"{row['bound_ms']:.5f} ms ({flops / 1e9:.2f} GFLOP, {moved} B); "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    return row


def check_k4(torch, gen):
    """K4 against its plain version over the sweep; times it at the
    prefill shape. Returns (max |err| at the prefill shape, timing)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import (flash_attention_bf16p_ref,
                                         flash_attention_ref)
    err = 0.0
    for case in FLASH_CASES + FLASH_BF16_CASES:
        q, k, v = k4_inputs(torch, gen, case)
        got = flash_attention(q, k, v, causal=case[-1])
        want = flash_attention_ref(q, k, v, causal=case[-1])
        torch.cuda.synchronize()
        tol = attn_tol(case[6])
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"K4 {case}")
        e = float((got.float() - want.float()).abs().max())
        if case == K4_MAIN:
            err = e
            emu = flash_attention_bf16p_ref(q, k, v, causal=case[-1])
            e_emu = float((got.float() - emu.float()).abs().max())
            log(f"  K4 {case}: max|err| {e_emu:.3g} against the bf16-P "
                f"emulation (kernels/ref.py::flash_attention_bf16p_ref)")
            del emu
        log(f"  K4 {case}: ok, max|err| {e:.3g} (tol {tol})")
        del got, want
    timing = {case[6]: k4_timing(torch, gen, case)
              for case in (K4_MAIN, FLASH_CASES[-2])}
    return err, timing


def k5_inputs(torch, gen, case):
    b, hq, hkv, d, s_max, _, qt, ct = case
    q = torch.randn((b, 1, hq, d), generator=gen, device=DEV).to(
        getattr(torch, qt))
    kc, vc = (torch.randn((b, s_max, hkv, d), generator=gen, device=DEV).to(
        getattr(torch, ct)) for _ in range(2))
    return q, kc, vc


def k5_timing(torch, gen, case):
    """K5 at one shape: kernel, plain version and ``sdpa`` as the median
    of five readings (and at 20 calls per graph), its bound."""
    from repro_torch.obs import profile as prof
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      num_splits)
    from repro_torch.kernels.ref import decode_attention_ref
    b, hq, hkv, d, s_max, n, qt, ct = case
    q, kc, vc = k5_inputs(torch, gen, case)
    ms = median_ms(lambda: decode_attention(q, kc, vc, n))
    plain = median_ms(lambda: decode_attention_ref(q, kc, vc, n), 10)
    kv = [c[:, :n].transpose(1, 2) for c in (kc, vc)]
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), *kv, enable_gqa=True)
    lib = median_ms(sdpa)
    cost = prof.kernel_cost("decode_attention", b=b, hq=hq, hkv=hkv, d=d,
                            kv_len=n, itemsize=kc.element_size(),
                            q_itemsize=q.element_size())
    flops, moved = cost["flops"], cost["bytes_accessed"]
    t_ops, t_bytes = flops / peak_flops(qt), moved / HBM_BYTES_PER_S
    row = dict(ms=ms, plain_ms=plain, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=lib)
    log(f"  K5 B={b} Hq={hq} Hkv={hkv} D={d} S_max={s_max} kv_len={n} {qt} "
        f"({num_splits(b, hkv, n)} split(s)): kernel {ms:.4f} ms "
        f"(device; {eager_ms(lambda: decode_attention(q, kc, vc, n)):.4f}"
        f" ms eager), plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
        f"{row['bound_ms']:.6f} ms ({moved} B); {moved / ms / 1e6:.1f} "
        f"GB/s; 20 calls per graph: kernel "
        f"{device_ms(lambda: decode_attention(q, kc, vc, n), 20, 20):.4f}"
        f" ms, sdpa {device_ms(sdpa, 20, 20):.4f} ms")
    return row


def check_k5(torch, gen):
    """K5 against its plain version over the sweep, garbage past kv_len
    ignored; times it at the serve path's shape and at the engine
    defaults. Returns (max |err| at the serve shape, timing)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      num_splits)
    from repro_torch.kernels.ref import decode_attention_ref
    err = 0.0
    for case in DECODE_CASES + DECODE_SPLIT_CASES:
        q, kc, vc = k5_inputs(torch, gen, case)
        n = case[5]
        got = decode_attention(q, kc, vc, n)
        want = decode_attention_ref(q, kc, vc, n)
        tol = attn_tol(case[6])
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"K5 {case}")
        e = float((got.float() - want.float()).abs().max())
        if case == K5_MAIN:
            err = e
        if n < case[4]:     # the invalid tail: garbage must not enter
            kc[:, n:], vc[:, n:] = 1e9, -1e9
            if not torch.equal(decode_attention(q, kc, vc, n), got):
                raise AssertionError(f"K5 {case}: the cache past kv_len "
                                     f"changed the result")
        torch.cuda.synchronize()
        log(f"  K5 {case}: ok, {num_splits(case[0], case[2], n)} split(s), "
            f"max|err| {e:.3g} (tol {tol})"
            + (", tail ignored" if n < case[4] else ""))
    timing = {case[0]: k5_timing(torch, gen, case) for case in (K5_MAIN,
                                                                  K5_BIG)}
    return err, timing


def check_k6(torch, gen):
    """K6 bit for bit against its plain version: the JAX test's case in
    three types, then T=4096, D=896, N=8192 with ~10 % padding (timed)."""
    from repro_torch.obs import profile as prof
    from repro_torch.kernels.packing import pack
    from repro_torch.kernels.ref import pack_ref
    bits = lambda x: x.view({1: torch.uint8, 2: torch.int16,
                             4: torch.int32}[x.element_size()])
    idx8 = torch.tensor([0, 63, -1, 5, 5, -1, 17, 2], dtype=torch.int32,
                        device=DEV)
    cases = [((torch.randn((64, 128), generator=gen, device=DEV) * 10).to(
        dt), idx8) for dt in (torch.float32, torch.bfloat16, torch.int32)]
    big = torch.randn((4096, 896), generator=gen, device=DEV)
    idx = torch.randint(0, 4096, (8192,), generator=gen, device=DEV,
                        dtype=torch.int32)
    pad = torch.rand(8192, generator=gen, device=DEV) < 0.1
    idx = torch.where(pad, -1, idx).to(torch.int32)
    cases.append((big, idx))
    # every row padding, one row, N past a multiple of the 8 rows a block
    # takes, bf16 rows of 1,792 bytes, tokens 4 and 1 bytes off 16-byte
    # alignment (the 4- and 1-byte word paths)
    flat = torch.randn(4096 * 896 + 1, generator=gen, device=DEV)
    cases += [(big[:64], torch.full((300,), -1, dtype=torch.int32,
                                    device=DEV)),
              (big, idx[:1]),
              (big, torch.cat([idx, idx[:1]])),
              (big.to(torch.bfloat16), idx),
              (flat[1:].view(4096, 896), idx),
              ((flat * 100).to(torch.int8).view(torch.uint8)[1:1 + 512 * 893]
               .view(512, 893), torch.where(idx[:1000] < 0, -1,
                                            idx[:1000] % 600))]
    for tok, ix in cases:
        got, want = pack(tok, ix), pack_ref(tok, ix)
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"K6 {tok.dtype} {tuple(tok.shape)} N="
                                 f"{ix.shape[0]} (data_ptr % 16 = "
                                 f"{tok.data_ptr() % 16}): differs from the "
                                 f"plain version")
        log(f"  K6 {tok.dtype} T={tok.shape[0]} D={tok.shape[1]} "
            f"N={ix.shape[0]} (data_ptr % 16 = {tok.data_ptr() % 16}, "
            f"{int((ix < 0).sum())} padding): bit-identical")
    # Timed cold: four token tables of 14.7 MB (more than the 50 MB L2
    # together) taken in turn, each call also writing a 29.4 MB bucket, so
    # no call finds rows an earlier call left in L2. The bound charges each
    # distinct row read once (a duplicate index may hit L2 within a call).
    safe = idx.clamp(min=0)
    tables = [big] + [torch.randn((4096, 896), generator=gen, device=DEV)
                      for _ in range(3)]
    turn = itertools.count()

    def cold(f):
        return lambda: f(tables[next(turn) % len(tables)])

    kernel = cold(lambda t: pack(t, idx))
    select = cold(lambda t: torch.index_select(t, 0, safe))
    ms = median_ms(kernel, graphs=len(tables))
    ms20 = median_ms(kernel, 10, per_graph=20)
    lib = median_ms(select, graphs=len(tables))
    lib20 = median_ms(select, 10, per_graph=20)
    plain = median_ms(cold(lambda t: pack_ref(t, idx)), graphs=len(tables))
    warm = median_ms(lambda: pack(big, idx))
    warm_lib = median_ms(lambda: torch.index_select(big, 0, safe))
    n_real = int((idx >= 0).sum())
    n_rows = int(torch.unique(idx[idx >= 0]).numel())
    row = big.shape[1] * big.element_size()
    moved = prof.kernel_cost("pack", n=idx.shape[0], distinct=n_rows,
                             row_bytes=row)["bytes_accessed"]
    bound = moved / HBM_BYTES_PER_S * 1e3
    log(f"  K6 T=4096 D=896 N=8192 ({8192 - n_real} padding rows, {n_rows} "
        f"distinct rows), cold tables, median of 5 graph replays: kernel "
        f"{ms:.4f} ms, index_select {lib:.4f} ms; 20 calls per graph: "
        f"kernel {ms20:.4f} ms, index_select {lib20:.4f} ms; plain "
        f"{plain:.4f} ms; one warm table (1 call per graph): kernel "
        f"{warm:.4f} ms, index_select {warm_lib:.4f} ms; bound "
        f"{bound:.6f} ms ({moved} B)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=lib)


def drive_serve(torch, n_episodes=30):
    """``repro_torch.launch.serve`` at its defaults (qwen2-0.5b full width,
    4 replicas, 30 episodes) with every launch count set to 0 just before
    and read just after: K5 once per layer per decode step (one decode step
    per ``generate(steps=2)``), K1 once per episode, K2/K3/K4/K6 never."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    n_layers = get_config(QWEN).n_layers
    reset_launches()
    t0 = time.time()
    summ = serve.main(["--device", DEV, "--episodes", str(n_episodes)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(zip(("K1", "K2", "K3", "K4", "K5", "K6"),
                      read_launches()))
    want = dict(K1=n_episodes, K2=0, K3=0, K4=0, K5=n_layers * n_episodes,
                K6=0)
    if counts != want:
        raise AssertionError(f"[serve] launches {counts}, expected {want}")
    for key, v in summ.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"[serve] {key} is not finite")
    log(f"  serve (defaults): launches {counts}; calibrated t0 "
        f"{float(summ['t0']) * 1e3:.3f} ms, t1 {float(summ['t1']) * 1e6:.1f} "
        f"us/item; generate(steps=2) {summ['generate_s'].mean() * 1e3:.2f} "
        f"ms mean at bs {sorted(set(summ['bs'].tolist()))}; episode loop "
        f"{float(summ['wall_s']) / n_episodes * 1e3:.1f} ms/episode; whole "
        f"call {wall:.1f} s")
    return counts["K5"]


def full_width_params(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import get_model
    cfg = get_config(QWEN)
    params = get_model(cfg).init(torch.Generator(device=DEV).manual_seed(0))
    n = sum(x.numel() for x in _leaves(params))
    if n != 494_032_768:
        raise AssertionError(f"{QWEN}: {n} parameters, expected 494032768")
    return cfg, params


def _leaves(tree):
    """The tensors of a parameter tree (dicts, and lists such as
    ``first_blocks``)."""
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from (_leaves(v) if isinstance(v, (dict, list)) else (v,))


def run_prefill(torch, cfg, params, calls=3):
    """``make_prefill_step(model, with_cache=False)`` at full width, B=4,
    S=2048: K4 once per layer per call; logits against the same step with
    ``use_kernels=False`` (bf16: max difference and argmax agreement
    reported; float32: within rtol 1e-3 / atol 1e-3, the band of 24
    layers summed in two orders); wall ms per call; one bf16 call under
    the profiler (where its device time goes). Returns the K4 launches of
    the bf16 kernel calls."""
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import make_prefill_step
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=DEV).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                     generator=gen, device=DEV,
                                     dtype=torch.int32)}
    launches = 0
    for dtype in ("bfloat16", "float32"):
        model = get_model(cfg.replace(dtype=dtype))
        step = make_prefill_step(model, with_cache=False)
        plain_step = make_prefill_step(model, with_cache=False,
                                       use_kernels=False)
        step(params, batch)                       # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        for _ in range(calls):
            got = step(params, batch)
        torch.cuda.synchronize()
        ms = (time.time() - t0) / calls * 1e3
        if flash_attention.launches != cfg.n_layers * calls or \
                read_launches()[4] != 0:
            raise AssertionError(f"[prefill] K4 launched "
                                 f"{flash_attention.launches} times in "
                                 f"{calls} calls, expected "
                                 f"{cfg.n_layers * calls}")
        n_k4 = flash_attention.launches
        if dtype == "bfloat16":
            launches = n_k4
            profiled(torch, lambda: step(params, batch), 1,
                     f"prefill {dtype} B=4 S=2048, cache-less", "call")
        plain_step(params, batch)
        torch.cuda.synchronize()
        t0 = time.time()
        want = plain_step(params, batch)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        if not torch.isfinite(got).all():
            raise AssertionError(f"[prefill] {dtype}: logits not finite")
        diff = float((got.float() - want.float()).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3,
                                       msg="[prefill] float32 kernels vs "
                                           "sdpa")
        log(f"  prefill {dtype} B=4 S=2048 ({cfg.n_layers} layers): "
            f"{ms:.1f} ms per call with K4 ({n_k4} "
            f"launches in {calls} calls), {plain_ms:.1f} ms with sdpa; "
            f"logits max|diff| {diff:.3g} (max|logit| "
            f"{float(want.float().abs().max()):.3g}), argmax agreement "
            f"{agree * 100:.3f} %")
        del got, want
        torch.cuda.empty_cache()
    return launches


def run_generate(torch, cfg, params, b=8, prompt=128, new=32):
    """The engine at full width and its default buckets: B=8, a 128-token
    prompt, 32 new tokens; prefill ms, decode ms per step, tokens/s."""
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine(get_model(cfg), params)
    gen = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                           device=DEV, dtype=torch.int32)
    engine.generate(tokens, steps=4)              # warm-up
    reset_launches()
    t0 = time.time()
    logits, cache, info = engine.prefill(tokens)
    cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out, dec = [cur], []
    for _ in range(new - 1):
        cur, cache, d_info = engine.decode(cache, cur)
        out.append(cur)
        dec.append(d_info["latency_s"])
    total = time.time() - t0
    counts = read_launches()
    if counts[4] != cfg.n_layers * (new - 1) or counts[3]:
        raise AssertionError(f"[generate] launches K4 {counts[3]}, K5 "
                             f"{counts[4]}; expected 0 and "
                             f"{cfg.n_layers * (new - 1)}")
    toks = torch.cat(out, 1)
    if toks.shape != (b, new) or not bool(((toks >= 0) & (
            toks < cfg.vocab_size)).all()):
        raise AssertionError("[generate] bad tokens")
    log(f"  generate B={b} prompt {prompt} (bucket {info['bucket']}), "
        f"{new} new tokens: prefill {info['latency_s'] * 1e3:.2f} ms, decode "
        f"{sum(dec) / len(dec) * 1e3:.3f} ms/step (min {min(dec) * 1e3:.3f}),"
        f" {b * new / total:.1f} tokens/s; K5 {counts[4]} launches")

    def decode_steps(n=8):
        c, kv = cur, cache
        for _ in range(n):
            c, kv, _ = engine.decode(kv, c)

    stats = profiled(torch, decode_steps, 8, f"decode B={b}, 8 steps",
                     "step")
    profiled(torch, lambda: engine.prefill(tokens), 1,
             f"prefill B={b} S={prompt}", "call")
    # core/env.py's LatencyModel: the step's fixed cost beyond streaming
    # its weights once (the parameters as stored)
    from repro_torch.core.env import DECODE_OVERHEAD_S
    weights = sum(x.numel() * x.element_size() for x in _leaves(params))
    stream_ms = weights / HBM_BYTES_PER_S * 1e3
    if stats is None:
        log("  [LatencyModel] overhead_s: not measured (no device time)")
    else:
        log(f"  [LatencyModel] {card()}: decode step B={b} device time "
            f"{stats['device_ms']:.4f} ms - weight streaming {weights} B / "
            f"3.35e12 B/s ({stream_ms:.4f} ms) = overhead_s "
            f"{(stats['device_ms'] - stream_ms) / 1e3:.6f} s (the default "
            f"in core/env.py: DECODE_OVERHEAD_S = {DECODE_OVERHEAD_S:g})")


def lm_trace(torch, model, params, tokens, steps, device):
    """Prefill then ``steps - 1`` greedy decode steps with a float32 cache;
    the logits of every step (on the CPU) and the tokens."""
    from repro_torch.serving.engine import make_prefill_step, make_serve_step
    prefill = make_prefill_step(model)
    step = make_serve_step(model, greedy=False)
    cache = model.new_cache(tokens.shape[0], 64, torch.float32, device)
    logits, cache = prefill(params, cache, {"tokens": tokens.to(device)})
    out_l, out_t = [], []
    for i in range(steps):
        if i:
            logits, cache = step(params, cache, {"tokens": cur})
        cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out_l.append(logits.cpu())
        out_t.append(cur.cpu())
    return torch.stack(out_l, 1), torch.cat(out_t, 1)


def run_lm_reference(torch, steps=16):
    """A reduced qwen2-0.5b (float32, float32 cache) with the same
    numpy-made parameters on the card (K5 in every decode step) and on the
    CPU (plain versions): identical tokens, a first divergence accepted
    only where the CPU's top-two logits differ by under 1e-5 relative;
    logits within rtol 1e-3 / atol 1e-4 up to it."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import (get_model, params_from_numpy,
                                             params_to_numpy)
    cfg = get_config(QWEN).reduced()
    model = get_model(cfg)
    tree = params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 12)), dtype=torch.int32)
    runs = [lm_trace(torch, model, params_from_numpy(cfg, tree, dev),
                     tokens, steps, dev) for dev in (DEV, "cpu")]
    note, err = card_vs_cpu_tokens(torch, runs, "LM reference", steps)
    log(f"  reduced {QWEN} float32, B=4, {steps} tokens: card (K5) vs CPU "
        f"tokens {note}; logits max|diff| {err:.3g} (rtol 1e-3 / atol 1e-4)")


# ---------------------------------------------------------------------------
# The rest of the transformer family: MoE, MLA, the frontends
# ---------------------------------------------------------------------------
DEEPSEEK = "deepseek-v2-lite-16b"
GRANITE = "granite-moe-3b-a800m"
HUBERT = "hubert-xlarge"
ZAMBA = "zamba2-1.2b"
XLSTM = "xlstm-125m"
# full-width parameter counts from the JAX package's shapes
# (tests/test_torch_archs.py and tests/test_torch_ssm.py::FULL_COUNTS)
FULL_COUNTS = {DEEPSEEK: 15_706_484_224, "pixtral-12b": 12_253_025_280,
               "gemma-7b": 8_537_680_896, "qwen2-7b": 7_615_616_512,
               GRANITE: 3_298_793_472, HUBERT: 945_973_760,
               "qwen1.5-0.5b": 463_987_712, ZAMBA: 1_104_937_856,
               XLSTM: 113_922_896}
# [archs]: the configs run at full width and full depth
ARCHS = (GRANITE, "qwen2-7b", "gemma-7b", "pixtral-12b", "qwen1.5-0.5b")
# every K4 and K5 shape that [archs] and [encode] launch, held against the
# plain version and timed as rows of the kernels line: K4 (b, sq, sk, hq,
# hkv, d, dtype, causal) of the cache-less prefill (B=4, S=2048), K5 (b,
# hq, hkv, d, s_max, kv_len, q dtype, cache dtype) of the engine's decode
# (B=8, a 256-slot cache; kv_len 144 is the middle of the generation: a
# 128-token prompt, 32 new tokens)
K4_ROWS = {GRANITE: (4, 2048, 2048, 24, 8, 64, "bfloat16", True),
           "qwen2-7b": (4, 2048, 2048, 28, 4, 128, "bfloat16", True),
           "gemma-7b": (4, 2048, 2048, 16, 16, 256, "bfloat16", True),
           "pixtral-12b": (4, 2048, 2048, 32, 8, 128, "bfloat16", True),
           "qwen1.5-0.5b": (4, 2048, 2048, 16, 16, 64, "bfloat16", True),
           HUBERT: (4, 2048, 2048, 16, 16, 80, "bfloat16", False),
           ZAMBA: (4, 2048, 2048, 32, 32, 64, "bfloat16", True)}
K5_ROWS = {GRANITE: (8, 24, 8, 64, 256, 144, "bfloat16", "bfloat16"),
           "qwen2-7b": (8, 28, 4, 128, 256, 144, "bfloat16", "bfloat16"),
           "gemma-7b": (8, 16, 16, 256, 256, 144, "bfloat16", "bfloat16"),
           "pixtral-12b": (8, 32, 8, 128, 256, 144, "bfloat16", "bfloat16"),
           "qwen1.5-0.5b": (8, 16, 16, 64, 256, 144, "bfloat16",
                            "bfloat16"),
           ZAMBA: (8, 32, 32, 64, 256, 144, "bfloat16", "bfloat16")}


def attn_layers(cfg):
    """The GQA attention calls of one forward (K4 or K5 once each): every
    layer of a transformer, zamba2's shared block once per group, none in
    an MLA model or in xlstm."""
    if cfg.use_mla or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def fresh_peak(torch):
    """Free what the last phase left and restart the peak-memory count."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def peak_bytes(torch):
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def moe_serve_phase(torch, smi, n_episodes=30):
    """[moe serve]: ``repro_torch.launch.serve --arch deepseek-v2-lite-16b``
    at its defaults (4 replicas, 30 episodes), full width and depth, with
    every launch count set to 0 just before and read just after: K1 once
    per episode, the others never (MLA and the experts run plain torch
    ops, as in the reference). Then, on the launcher's own engine, where a
    serving call goes (``moe_serve_costs``), and K1 against its plain
    version at the launcher's A=4. Returns (K1 launches, K1's max |err|
    and timing at A=4)."""
    import numpy as np
    from repro_torch.launch import serve
    fresh_peak(torch)
    reset_launches()
    t0 = time.time()
    summ, engine = serve.main(["--device", DEV, "--arch", DEEPSEEK,
                               "--episodes", str(n_episodes)],
                              return_engine=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(zip(("K1", "K2", "K3", "K4", "K5", "K6"),
                      read_launches()))
    want = dict(K1=n_episodes, K2=0, K3=0, K4=0, K5=0, K6=0)
    if counts != want:
        raise AssertionError(f"[moe serve] launches {counts}, expected "
                             f"{want}")
    if int(summ["n_params"]) != FULL_COUNTS[DEEPSEEK]:
        raise AssertionError(f"[moe serve] {int(summ['n_params'])} "
                             f"parameters, expected {FULL_COUNTS[DEEPSEEK]}")
    for key, v in summ.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"[moe serve] {key} is not finite")
    log(f"  serve --arch {DEEPSEEK} (defaults, full width and depth) on "
        f"{smi}: {int(summ['n_params'])} parameters (expected "
        f"{FULL_COUNTS[DEEPSEEK]}); peak {peak_bytes(torch)} B allocated; "
        f"launches {counts}; calibrated t0 {float(summ['t0']) * 1e3:.3f} ms,"
        f" t1 {float(summ['t1']) * 1e6:.1f} us/item; generate(steps=2) "
        f"{summ['generate_s'].mean() * 1e3:.2f} ms mean (min "
        f"{summ['generate_s'].min() * 1e3:.2f}) at bs "
        f"{sorted(set(summ['bs'].tolist()))}; episode loop "
        f"{float(summ['wall_s']) / n_episodes * 1e3:.1f} ms/episode; whole "
        f"call {wall:.1f} s")
    moe_serve_costs(torch, engine)
    del engine
    fresh_peak(torch)
    from repro_torch.configs.fcpo import FCPOConfig
    err, timing = check_k1(torch, FCPOConfig(), torch.Generator(
        device=DEV).manual_seed(6), agents=(4,), tag="serve ")
    return counts["K1"], err, timing[4]


def moe_serve_costs(torch, engine):
    """Where a deepseek-v2-lite serving call of ``engine`` (the
    launcher's) goes: the float32 -> bf16 cast of one MoE layer's three
    expert stacks (timed, against its bytes bound: 4 B read and 2 B
    written an element), times the MoE layers; then one
    ``generate(steps=2)`` at bs 8 under the profiler (busy share, top
    kernels)."""
    cfg = engine.model.cfg
    stacks = [engine.params["blocks"]["moe"][n][0]
              for n in ("gate", "up", "down")]
    cast_ms = median_ms(lambda: [w.to(torch.bfloat16) for w in stacks], 5)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    moved = sum(w.numel() for w in stacks) * 6
    log(f"  expert casts: one MoE layer's three (E, d, ff) stacks float32 "
        f"-> bf16 {cast_ms:.3f} ms (bound {moved / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms, {moved} B), x {n_moe} layers = {cast_ms * n_moe:.1f} ms a "
        f"forward")
    tokens = torch.zeros((8, 16), dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.generate(tokens, steps=2)
    torch.cuda.synchronize()
    alone = time.time() - t0
    profiled(torch, lambda: engine.generate(tokens, steps=2), 1,
             f"{DEEPSEEK} generate(steps=2) bs=8", "call", alone=alone)


def compare_steps(torch, cfg, step, plain_step, params, batch, label,
                  want_k4):
    """``step`` (kernels) against ``plain_step`` (``use_kernels=False``) on
    the same batch: K4 launches of one call, ms per call of each (after a
    warm-up each), logits max |diff| and argmax agreement; the argmax of
    each (for ``float32_check``)."""
    from repro_torch.kernels.flash_attention import flash_attention
    step(params, batch)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    got = step(params, batch)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    counts = read_launches()
    if flash_attention.launches != want_k4 or any(
            n for i, n in enumerate(counts) if i != 3):
        raise AssertionError(f"[{label}] launches {counts}, expected K4 "
                             f"{want_k4} and nothing else")
    plain_step(params, batch)
    torch.cuda.synchronize()
    t0 = time.time()
    want = plain_step(params, batch)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if not torch.isfinite(got).all():
        raise AssertionError(f"[{label}] logits not finite")
    diff = max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))        # a row at a time
    scale = max(float(w.float().abs().max()) for w in want)
    argmax = (got.argmax(-1), want.argmax(-1))
    agree = float((argmax[0] == argmax[1]).float().mean())
    del got, want
    return dict(ms=ms, plain_ms=plain_ms, k4=want_k4, diff=diff,
                scale=scale, agree=agree, argmax=argmax)


@contextlib.contextmanager
def routing_spy(replay=None):
    """Record every ``moe_route`` decision made inside the block (the list
    yielded), or, given ``replay`` (such a list from another run), hand
    the block those decisions in order instead of its own: two runs then
    differ in everything but the routing."""
    from repro_torch.models import moe
    route, seen = moe.moe_route, []

    def spy(p, cfg, xf):
        if replay is None:
            seen.append(route(p, cfg, xf))
        else:
            seen.append(replay[len(seen)])
            if seen[-1].topi.shape[0] != xf.shape[0]:
                raise AssertionError("routing replayed onto another call")
        return seen[-1]

    moe.moe_route = spy
    try:
        yield seen
    finally:
        moe.moe_route = route


def float32_check(torch, cfg, params, batch, label, make_step, bf16,
                  decode=4, prompt=16):
    """The float32 counterpart of ``compare_steps``: the same batch through
    the float32 model (float32 activations, K4's float32 variant once per
    layer) with kernels and with ``use_kernels=False``, held within rtol /
    atol 1e-3 (the band of ``[prefill]``; a wrong kernel moves logits by
    O(1)), a batch row at a time; the argmax agreement of the two, and of
    ``bf16`` (the bf16 kernel and plain runs' argmax) with the float32
    plain run: where the bf16 runs disagree with each other only as much
    as each does with float32, the gap is bf16 rounding, not K4. In an
    MoE config a route can flip on a last-bit difference in a router logit
    and move a token's whole expert output, so the held plain run replays
    the kernel run's routing (``routing_spy``); the free plain run gives
    the agreement figures and the count of tokens whose top-k differs.
    Then, for a decoder (``decode`` > 0), a ``prompt``-token prefill and
    ``decode`` float32 decode steps fed the batch's next tokens (K5's
    float32 variant once per layer per step, a float32 cache), with
    kernels and without, their logits held in the same band. Returns a
    dict for the log."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import (make_prefill_step,
                                            make_serve_step)
    model = get_model(cfg.replace(dtype="float32"))
    reset_launches()
    with routing_spy() as routes:
        got = make_step(model)(params, batch)
    counts = read_launches()
    n_attn = attn_layers(cfg)
    if flash_attention.launches != n_attn or any(
            n for i, n in enumerate(counts) if i != 3):
        raise AssertionError(f"[{label}] float32 launches {counts}, "
                             f"expected K4 {n_attn} and nothing else")
    with routing_spy() as free_routes:
        want = make_step(model, use_kernels=False)(params, batch)
    arg = want.argmax(-1)
    res = dict(agree=float((got.argmax(-1) == arg).float().mean()),
               k4_vs_f32=float((bf16[0] == arg).float().mean()),
               plain_vs_f32=float((bf16[1] == arg).float().mean()),
               k4=n_attn)
    note = ""
    if routes:
        flips = [int((a.topi != b.topi).any(-1).sum())
                 for a, b in zip(routes, free_routes)]
        first = next((i for i, n in enumerate(flips) if n), None)
        res.update(free_diff=max(float((g - w).abs().max())
                                 for g, w in zip(got, want)),
                   flips=sum(flips), first_flip=first)
        note = (f"; free-running plain run: max|diff| {res['free_diff']:.3g},"
                f" {sum(flips)} token-layers of "
                f"{sum(r.topi.shape[0] for r in routes)} "
                f"with another top-k, the first in MoE layer {first}; held "
                f"with the kernel run's routing replayed")
        del want
        with routing_spy(replay=routes):
            want = make_step(model, use_kernels=False)(params, batch)
    res["diff"] = max(float((g - w).abs().max()) for g, w in zip(got, want))
    res["scale"] = max(float(w.abs().max()) for w in want)
    log(f"  {label} float32: logits max|diff| {res['diff']:.3g} (max|logit|"
        f" {res['scale']:.3g}), argmax agreement {res['agree'] * 100:.3f} %;"
        f" bf16 argmax against float32 plain: with K4 "
        f"{res['k4_vs_f32'] * 100:.3f} %, with use_kernels=False "
        f"{res['plain_vs_f32'] * 100:.3f} %{note}")
    for i, (g, w) in enumerate(zip(got, want)):   # a row at a time
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3,
                                   msg=lambda m: f"[{label}] float32 row "
                                                 f"{i}: {m}")
    del got, want, routes, free_routes
    if not decode:
        return res
    tokens = batch["tokens"][:, :prompt + decode]
    runs, routes = [], None
    for kernels in (True, False):
        cache = model.new_cache(tokens.shape[0], prompt + decode,
                                torch.float32, DEV)
        step = make_serve_step(model, use_kernels=kernels, greedy=False)
        out = []
        with routing_spy(replay=routes) as seen:
            _, cache = make_prefill_step(model, use_kernels=False)(
                params, cache, {"tokens": tokens[:, :prompt]})
            reset_launches()
            for i in range(prompt, prompt + decode):
                logits, cache = step(params, cache,
                                     {"tokens": tokens[:, i:i + 1]})
                out.append(logits)
        if kernels and (decode_attention.launches != n_attn * decode
                        or any(n for j, n in enumerate(read_launches())
                               if j != 4)):
            raise AssertionError(f"[{label}] float32 decode launches "
                                 f"{read_launches()}, expected K5 "
                                 f"{n_attn * decode} only")
        routes = seen
        runs.append(torch.stack(out))
    res["decode_diff"] = float((runs[0] - runs[1]).abs().max())
    res["k5"] = n_attn * decode
    log(f"  {label} float32 decode: {decode} steps after a {prompt}-token "
        f"prefill, K5 {res['k5']} launches, logits max|diff| "
        f"{res['decode_diff']:.3g} (max|logit| "
        f"{float(runs[1].abs().max()):.3g})"
        + ("; the kernel run's routing replayed" if routes else ""))
    torch.testing.assert_close(runs[0], runs[1], rtol=1e-3, atol=1e-3,
                               msg=lambda m: f"[{label}] float32 decode: "
                                             f"{m}")
    return res


def arch_generate(torch, cfg, model, params, b=8, prompt=128, new=32):
    """The engine (default batch and seq buckets, a 256-slot cache): B=8,
    a 128-token prompt, 32 new tokens; K5 once per GQA layer per decode
    step."""
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine(model, params, max_cache_len=256)
    gen = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                           device=DEV, dtype=torch.int32)
    engine.generate(tokens, steps=4)              # warm-up
    reset_launches()
    t0 = time.time()
    logits, cache, info = engine.prefill(tokens)
    cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out, dec = [cur], []
    for _ in range(new - 1):
        cur, cache, d_info = engine.decode(cache, cur)
        out.append(cur)
        dec.append(d_info["latency_s"])
    total = time.time() - t0
    counts = read_launches()
    want_k5 = attn_layers(cfg) * (new - 1)
    if counts != (0, 0, 0, 0, want_k5, 0):
        raise AssertionError(f"[archs] {cfg.name} generate: launches "
                             f"{counts}, expected K5 {want_k5} only")
    toks = torch.cat(out, 1)
    if toks.shape != (b, new) or not bool(((toks >= 0) & (
            toks < cfg.vocab_size)).all()):
        raise AssertionError(f"[archs] {cfg.name}: bad tokens")
    return dict(k5=want_k5, prefill_ms=info["latency_s"] * 1e3,
                decode_ms=sum(dec) / len(dec) * 1e3,
                tokens_per_s=b * new / total)


def arch_phase(torch, gen, smi, names=ARCHS, tag="archs"):
    """[archs]: each of ``names`` at full width and depth (random weights
    from a seed on the card): its parameter count; the cache-less prefill
    step at B=4, S=2048 with K4 (once per attention layer: zamba2's shared
    block once per group) against the same step with
    ``use_kernels=False``, in bf16 and in float32 (``float32_check``, with
    four float32 decode steps on K5); the engine at B=8 (K5 in every
    decode step); peak bytes; then K4 and K5 at the config's bf16 shapes
    against plain. Returns the K4 / K5 rows of these shapes and the
    phase's launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import get_model, param_count
    from repro_torch.serving.engine import make_prefill_step
    rows, launches = {}, {}
    for name in names:
        cfg = get_config(name)
        fresh_peak(torch)
        t0 = time.time()
        model = get_model(cfg)
        params = model.init(torch.Generator(device=DEV).manual_seed(0))
        n = param_count(params)
        if n != FULL_COUNTS[name]:
            raise AssertionError(f"[{tag}] {name}: {n} parameters, "
                                 f"expected {FULL_COUNTS[name]}")
        init_s = time.time() - t0
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                         generator=gen, device=DEV,
                                         dtype=torch.int32)}

        def make_step(m, **kw):
            return make_prefill_step(m, with_cache=False, **kw)

        pre = compare_steps(torch, cfg, make_step(model),
                            make_step(model, use_kernels=False), params,
                            batch, f"{tag} {name}", attn_layers(cfg))
        f32 = float32_check(torch, cfg, params, batch, f"{tag} {name}",
                            make_step, pre.pop("argmax"))
        del batch
        g = arch_generate(torch, cfg, model, params)
        launches[name] = dict(K4=pre["k4"], K5=g["k5"])
        log(f"  {name} ({cfg.n_layers} layers, full depth, d_model "
            f"{cfg.d_model}) on {smi}: {n} parameters (expected "
            f"{FULL_COUNTS[name]}), init {init_s:.1f} s; prefill B=4 S=2048 "
            f"{pre['ms']:.1f} ms with K4 ({pre['k4']} launches), "
            f"{pre['plain_ms']:.1f} ms with use_kernels=False; bf16 logits "
            f"max|diff| {pre['diff']:.3g} (max|logit| {pre['scale']:.3g}), "
            f"argmax agreement {pre['agree'] * 100:.3f} %; float32 max|diff|"
            f" {f32['diff']:.3g}, argmax agreement {f32['agree'] * 100:.3f} "
            f"%, decode max|diff| {f32['decode_diff']:.3g}; generate B=8 "
            f"prompt 128 + 32: prefill {g['prefill_ms']:.2f} ms, decode "
            f"{g['decode_ms']:.3f} ms/step, {g['tokens_per_s']:.1f} "
            f"tokens/s, K5 {g['k5']} launches; peak {peak_bytes(torch)} B")
        del params, model
        fresh_peak(torch)
        rows[("flash_attention", name)] = attn_row(
            torch, gen, "flash_attention", K4_ROWS[name], pre["k4"])
        rows[("decode_attention", name)] = attn_row(
            torch, gen, "decode_attention", K5_ROWS[name], g["k5"])
    return rows, launches


def attn_row(torch, gen, kernel, case, launches):
    """K4 / K5 at one model shape: max |err| against the plain version and
    the timing row (all the kernels line's keys)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import (decode_attention_ref,
                                         flash_attention_ref)
    if kernel == "flash_attention":
        q, k, v = k4_inputs(torch, gen, case)
        got = flash_attention(q, k, v, causal=case[-1])
        want = flash_attention_ref(q, k, v, causal=case[-1])
        tol, timing = attn_tol(case[6]), k4_timing
    else:
        q, k, v = k5_inputs(torch, gen, case)
        got = decode_attention(q, k, v, case[5])
        want = decode_attention_ref(q, k, v, case[5])
        tol, timing = attn_tol(case[6]), k5_timing
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=f"{kernel} {case}")
    err = float((got.float() - want.float()).abs().max())
    del q, k, v, got, want
    return dict(max_abs_err=err, launches=launches,
                **timing(torch, gen, case))


def encode_phase(torch, gen, smi):
    """[encode]: hubert-xlarge at full width through ``make_encode_step``,
    B=4, S=2048 frames: K4 bidirectional at D=80 once per layer, against
    ``use_kernels=False`` in bf16 and in float32 (``float32_check``);
    peak bytes. Returns (K4 row, launches)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import get_model, param_count
    from repro_torch.serving.engine import make_encode_step
    cfg = get_config(HUBERT)
    fresh_peak(torch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    n = param_count(params)
    if n != FULL_COUNTS[HUBERT]:
        raise AssertionError(f"[encode] {n} parameters, expected "
                             f"{FULL_COUNTS[HUBERT]}")
    batch = {"embeds": torch.randn((4, 2048, cfg.frontend_dim),
                                   generator=gen, device=DEV)}
    res = compare_steps(torch, cfg, make_encode_step(model),
                        make_encode_step(model, use_kernels=False), params,
                        batch, "encode", cfg.n_layers)
    f32 = float32_check(torch, cfg, params, batch, "encode",
                        make_encode_step, res.pop("argmax"), decode=0)
    batch["mask"] = torch.rand((4, 2048), generator=gen, device=DEV) < 0.08
    masked = make_encode_step(model)(params, batch)
    if not torch.isfinite(masked).all():
        raise AssertionError("[encode] masked logits not finite")
    log(f"  {HUBERT} ({cfg.n_layers} layers, full depth, bidirectional, "
        f"D={cfg.head_dim}) on {smi}: {n} parameters (expected "
        f"{FULL_COUNTS[HUBERT]}); encode B=4 S=2048 {res['ms']:.1f} ms with "
        f"K4 ({res['k4']} launches), {res['plain_ms']:.1f} ms with "
        f"use_kernels=False; bf16 logits max|diff| {res['diff']:.3g} "
        f"(max|logit| {res['scale']:.3g}), argmax agreement "
        f"{res['agree'] * 100:.3f} %; float32 max|diff| {f32['diff']:.3g}, "
        f"argmax agreement {f32['agree'] * 100:.3f} %; with HuBERT's mask: "
        f"finite; peak {peak_bytes(torch)} B")
    del params, model, masked, batch
    fresh_peak(torch)
    return attn_row(torch, gen, "flash_attention", K4_ROWS[HUBERT],
                    res["k4"]), res["k4"]


def card_vs_cpu_tokens(torch, runs, label, steps):
    """Identical tokens of a card run and a CPU run, a first divergence
    accepted only where the CPU's top-two logits differ by under 1e-5
    relative; logits within rtol 1e-3 / atol 1e-4 up to it. Returns
    (note, max |diff|)."""
    (lk, tk), (lc, tc) = runs
    upto, note = steps, "identical"
    diff = (tk != tc).any(0)
    if diff.any():
        upto = int(torch.nonzero(diff)[0])
        for row in torch.nonzero(tk[:, upto] != tc[:, upto]).flatten():
            top = torch.topk(lc[row, upto], 2).values
            gap = float(top[0] - top[1])
            if gap > 1e-5 * max(1.0, abs(float(top[0]))):
                raise AssertionError(f"[{label}] row {int(row)} parts at "
                                     f"step {upto} with no near-tie (gap "
                                     f"{gap:.3g})")
        note = f"identical up to a near-tie at step {upto} (reported)"
    torch.testing.assert_close(lk[:, :upto + 1], lc[:, :upto + 1],
                               rtol=1e-3, atol=1e-4,
                               msg=f"[{label}] card vs cpu logits")
    return note, float((lk[:, :upto + 1] - lc[:, :upto + 1]).abs().max())


def moe_reference_phase(torch, steps=16):
    """[MoE reference]: reduced deepseek-v2-lite and granite (2 layers,
    float32, float32 cache) with the same numpy-made parameters on the
    card and on the CPU, B=4, 16 tokens: tokens under the near-tie rule,
    the first MoE layer's routing (top-k ids, ``keep``) equal, and the
    card run equal to itself bit for bit across two calls (the
    deterministic combine)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.models.registry import (get_model, params_from_numpy,
                                             params_to_numpy)
    route = moe.moe_route
    for name in (DEEPSEEK, GRANITE):
        seen = []

        def spy(*args):
            seen.append(route(*args))
            return seen[-1]

        cfg = get_config(name).reduced()
        model = get_model(cfg)
        tree = params_to_numpy(model.init(torch.Generator().manual_seed(0)))
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 12)), dtype=torch.int32)
        runs, first = [], []
        for dev in (DEV, "cpu", DEV):
            seen.clear()
            moe.moe_route = spy
            try:
                runs.append(lm_trace(torch, model, params_from_numpy(
                    cfg, tree, dev), tokens, steps, dev))
            finally:
                moe.moe_route = route
            first.append(seen[0])
        if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[2])):
            raise AssertionError(f"[MoE reference] {name}: two card runs "
                                 f"differ")
        for key in ("topi", "keep", "slot"):
            if not torch.equal(getattr(first[0], key).cpu(),
                               getattr(first[1], key)):
                raise AssertionError(f"[MoE reference] {name}: the first "
                                     f"MoE layer's {key} differs card vs "
                                     f"CPU")
        note, err = card_vs_cpu_tokens(torch, runs[:2],
                                       "MoE reference", steps)
        log(f"  reduced {name} float32, B=4, {steps} tokens: card vs CPU "
            f"tokens {note}; logits max|diff| {err:.3g} (rtol 1e-3 / atol "
            f"1e-4); first MoE layer's routing (top-k, keep, slots) equal, "
            f"{int((~first[0].keep).sum())} of {first[0].keep.numel()} "
            f"assignments dropped; two card runs bit for bit")



# ---------------------------------------------------------------------------
# The SSM and hybrid families; LM training
# ---------------------------------------------------------------------------
def drive_serve_arch(torch, name, n_episodes, label):
    """``repro_torch.launch.serve --arch name`` at full width and depth
    with every launch count set to 0 just before and read just after: K1
    once per episode, K5 once per attention call of the one decode step of
    each ``generate(steps=2)`` (zamba2: 6, xlstm: none), nothing else;
    then one ``generate(steps=2)`` at bs 8 on the launcher's engine under
    the profiler. Returns the launch counts."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    cfg = get_config(name)
    fresh_peak(torch)
    reset_launches()
    t0 = time.time()
    summ, engine = serve.main(["--device", DEV, "--arch", name,
                               "--episodes", str(n_episodes)],
                              return_engine=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(zip(("K1", "K2", "K3", "K4", "K5", "K6"),
                      read_launches()))
    want = dict(K1=n_episodes, K2=0, K3=0, K4=0,
                K5=attn_layers(cfg) * n_episodes, K6=0)
    if counts != want:
        raise AssertionError(f"[{label}] serve --arch {name}: launches "
                             f"{counts}, expected {want}")
    if int(summ["n_params"]) != FULL_COUNTS[name]:
        raise AssertionError(f"[{label}] {name}: {int(summ['n_params'])} "
                             f"parameters, expected {FULL_COUNTS[name]}")
    for key, v in summ.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"[{label}] {name}: {key} is not finite")
    log(f"  serve --arch {name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_episodes} episodes): {int(summ['n_params'])} "
        f"parameters; launches {counts}; peak {peak_bytes(torch)} B; "
        f"calibrated t0 {float(summ['t0']) * 1e3:.3f} ms, t1 "
        f"{float(summ['t1']) * 1e6:.1f} us/item; generate(steps=2) "
        f"{summ['generate_s'].mean() * 1e3:.2f} ms mean at bs "
        f"{sorted(set(summ['bs'].tolist()))}; episode loop "
        f"{float(summ['wall_s']) / n_episodes * 1e3:.1f} ms/episode; whole "
        f"call {wall:.1f} s")
    tokens = torch.zeros((8, 16), dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.generate(tokens, steps=2)
    torch.cuda.synchronize()
    profiled(torch, lambda: engine.generate(tokens, steps=2), 1,
             f"{name} generate(steps=2) bs=8", "call",
             alone=time.time() - t0)
    return counts


def ssm_reference(torch, steps=16):
    """Reduced zamba2 and xlstm (float32, a float32 cache) with the same
    numpy-made parameters on the card (zamba2: K5 in the shared block of
    every decode step) and on the CPU: tokens under the near-tie rule,
    logits within rtol 1e-3 / atol 1e-4."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import (get_model, params_from_numpy,
                                             params_to_numpy)
    for name in (ZAMBA, XLSTM):
        cfg = get_config(name).reduced()
        model = get_model(cfg)
        tree = params_to_numpy(model.init(torch.Generator().manual_seed(0)))
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 12)), dtype=torch.int32)
        reset_launches()
        card = lm_trace(torch, model, params_from_numpy(cfg, tree, DEV),
                        tokens, steps, DEV)
        k5 = read_launches()[4]
        runs = [card, lm_trace(torch, model, params_from_numpy(
            cfg, tree, "cpu"), tokens, steps, "cpu")]
        if k5 != attn_layers(cfg) * (steps - 1):
            raise AssertionError(f"[ssm serve] reduced {name}: K5 {k5}, "
                                 f"expected {attn_layers(cfg) * (steps - 1)}")
        note, err = card_vs_cpu_tokens(torch, runs, "ssm serve", steps)
        log(f"  reduced {name} float32, B=4, {steps} tokens: card (K5 {k5}) "
            f"vs CPU tokens {note}; logits max|diff| {err:.3g} (rtol 1e-3 / "
            f"atol 1e-4)")


def ssm_serve_phase(torch, gen, smi, n_episodes=5):
    """[ssm serve]: ``serve --arch zamba2-1.2b`` and ``--arch xlstm-125m``
    at full width and depth (K1 each episode, zamba2's K5 six times a
    decode step); zamba2 through ``arch_phase`` (the cache-less prefill at
    B=4, S=2048 with K4 six times against ``use_kernels=False``, bf16 and
    float32 under ``assert_close``, four float32 decode steps on K5, the
    engine at B=8, K4 / K5 at zamba2's bf16 shapes against plain); both
    reduced, card against CPU. Returns (K4 / K5 rows, launches)."""
    launches = {name: drive_serve_arch(torch, name, n_episodes, "ssm serve")
                for name in (ZAMBA, XLSTM)}
    rows, arch_launches = arch_phase(torch, gen, smi, (ZAMBA,), "ssm serve")
    launches[f"{ZAMBA} prefill/generate"] = arch_launches[ZAMBA]
    ssm_reference(torch)
    return rows, launches


class StepClock(list):
    """A ``history`` list for ``launch/train.main`` that synchronizes the
    card and stamps the time at each step's metrics."""

    def __init__(self, torch):
        super().__init__()
        self.torch, self.times = torch, [time.perf_counter()]

    def append(self, metrics):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        super().append(metrics)

    def step_ms(self):
        """Median ms of the steps after the first (which pays the
        first-use set-up)."""
        gaps = sorted(b - a for a, b in zip(self.times[1:],
                                            self.times[2:]))
        return gaps[len(gaps) // 2] * 1e3

    def column(self, key):
        return [float(m[key]) for m in self]


def train_leaves(tree):
    from repro_torch.training.optimizer import flatten
    return flatten(tree)[0]


def train_run(torch, label, argv, **kw):
    """One ``launch/train.main`` run on the card with launches counted
    (training reaches no kernel: the plain path, as in the reference) and
    its loss finite, no update rejected. Returns (state, StepClock)."""
    from repro_torch.launch import train
    clock = StepClock(torch)
    reset_launches()
    state = train.main(["--device", DEV, *argv], history=clock, **kw)
    if any(read_launches()):
        raise AssertionError(f"[{label}] launches {read_launches()}, "
                             f"expected none")
    losses = clock.column("loss")
    if not all(math.isfinite(x) for x in losses) or any(
            clock.column("update_rejected") if "update_rejected" in clock[0]
            else ()):
        raise AssertionError(f"[{label}] losses {losses}")
    return state, clock


def train_close(torch, got, want, label, lrs, flips=2):
    """Two train states within rtol 1e-3 / atol 1e-4, leaf by leaf; up to
    ``flips`` coordinates a leaf may lie outside, each by at most twice
    the sum of the learning rates (an AdamW step of a near-zero gradient
    taken the other way; tests/test_torch_training.py)."""
    bound = 2.02 * sum(lrs)
    worst = 0
    for i, (g, w) in enumerate(zip(train_leaves(got), train_leaves(want))):
        g, w = g.detach().cpu().float(), w.detach().cpu().float()
        bad = ~torch.isclose(g, w, rtol=1e-3, atol=1e-4)
        if int(bad.sum()) > flips or bool(
                ((g - w).abs()[bad] > bound).any()):
            raise AssertionError(f"[{label}] leaf {i}: {int(bad.sum())} "
                                 f"coordinates off, max "
                                 f"{float((g - w).abs().max()):.3g}")
        worst = max(worst, int(bad.sum()))
    return worst


def profile_train_step(torch, state, batch, seq):
    """One more zamba2 train step (the CLI's: remat, AdamW) on the run's
    final state under the profiler, after one unprofiled step."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(ZAMBA)
    step = make_train_step(get_model(cfg))
    data = next(TokenPipeline(cfg, batch, seq, seed=1, device=DEV))
    torch.cuda.synchronize()
    t0 = time.time()
    step(state, data)
    torch.cuda.synchronize()
    profiled(torch, lambda: step(state, data), 1,
             f"{ZAMBA} train step {batch} x {seq}", "step",
             alone=time.time() - t0)


def lm_train_phase(torch, smi, steps=10, batch=8, seq=128):
    """[lm train]: ``launch/train.main --arch zamba2-1.2b`` at full width
    and depth for ``steps`` steps (batch 8, seq 128, remat): finite,
    falling loss, ms per step, tokens/s, peak bytes; ``--grad-compression``
    in a world of one; xlstm-125m at full width, 6 steps checkpointed
    every 3, and its step-3 checkpoint resumed with ``--resume`` equal to
    the straight run bit for bit (zamba2's train state is 13.3 GB a
    checkpoint: the three writes of a resume check pass the chip
    machine's 45 GiB disk limit); reduced zamba2 and xlstm card vs CPU
    from the same numpy params (two microbatches)."""
    import os
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import get_model, params_to_numpy
    base = ["--batch", str(batch), "--seq", str(seq), "--log-every", "5"]
    fresh_peak(torch)
    state, clock = train_run(torch, "lm train", ["--arch", ZAMBA, "--steps",
                                                 str(steps), *base])
    peak = peak_bytes(torch)
    losses = clock.column("loss")
    if not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"[lm train] {ZAMBA} loss does not fall: "
                             f"{losses}")
    ms = clock.step_ms()
    cfg = get_config(ZAMBA)
    log(f"  train --arch {ZAMBA} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, full depth) on {smi}: {steps} steps of batch "
        f"{batch} x seq {seq}, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({', '.join(f'{x:.4f}' for x in losses)}); {ms:.1f} ms/step "
        f"(median of steps 2-{steps}), {batch * seq / ms * 1e3:.0f} "
        f"tokens/s; peak {peak} B allocated")
    profile_train_step(torch, state, batch, seq)
    del state
    fresh_peak(torch)
    comp, clock = train_run(torch, "lm train compression", [
        "--arch", ZAMBA, "--steps", "3", *base, "--grad-compression"])
    ef = max(float(x.abs().max()) for x in train_leaves(comp["ef"]))
    if not ef > 0:
        raise AssertionError("[lm train] --grad-compression left no "
                             "residual")
    log(f"  --grad-compression (a world of one): 3 steps, loss "
        f"{', '.join(f'{x:.4f}' for x in clock.column('loss'))}, "
        f"{clock.step_ms():.1f} ms/step, max|residual| {ef:.3g}; peak "
        f"{peak_bytes(torch)} B")
    del comp
    fresh_peak(torch)
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", XLSTM, "--steps", "6", *base, "--ckpt-every", "3"]
        straight, clock = train_run(torch, "lm train xlstm", argv + [
            "--ckpt-dir", f"{d}/a"])
        xcfg = get_config(XLSTM)
        log(f"  train --arch {XLSTM} ({xcfg.n_layers} layers, d_model "
            f"{xcfg.d_model}): 6 steps, loss "
            f"{', '.join(f'{x:.4f}' for x in clock.column('loss'))}, "
            f"{clock.step_ms():.1f} ms/step, "
            f"{batch * seq / clock.step_ms() * 1e3:.0f} tokens/s; peak "
            f"{peak_bytes(torch)} B")
        os.mkdir(f"{d}/b")
        for suffix in (".npz", ".json"):     # moved, not copied
            os.replace(f"{d}/a/step_00000003{suffix}",
                       f"{d}/b/step_00000003{suffix}")
        resumed, _ = train_run(torch, "lm train resume", argv + [
            "--ckpt-dir", f"{d}/b", "--resume"])
        for i, (a, b) in enumerate(zip(train_leaves(resumed),
                                       train_leaves(straight))):
            if not torch.equal(a, b):
                raise AssertionError(f"[lm train] resumed leaf {i} differs "
                                     f"from the straight run")
        log(f"  --resume from step 3 of 6: the final state equals the "
            f"straight run's bit for bit ({len(train_leaves(straight))} "
            f"leaves)")
    del straight, resumed
    fresh_peak(torch)
    from repro_torch.launch import train
    for name in (ZAMBA, XLSTM):
        cfg = get_config(name).reduced()
        tree = params_to_numpy(get_model(cfg).init(
            torch.Generator().manual_seed(0)))
        argv = ["--arch", name, "--reduced", "--steps", "3", "--batch", "4",
                "--seq", "64", "--microbatches", "2"]
        card, hc = train_run(torch, "lm train reference", argv,
                             params=tree)
        hg = []
        cpu = train.main(argv + ["--device", "cpu"], params=tree,
                         history=hg)
        for key in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(
                torch.tensor(hc.column(key)),
                torch.tensor([float(m[key]) for m in hg]), rtol=1e-3,
                atol=1e-4, msg=f"[lm train] reduced {name} card vs CPU {key}")
        flips = train_close(torch, card, cpu, f"lm train {name}",
                            hc.column("lr"))
        log(f"  reduced {name}, 3 steps of 2 microbatches: card vs CPU loss,"
            f" grad norm, lr within rtol 1e-3 / atol 1e-4; params and moments"
            f" too ({flips} coordinates at most a leaf outside, each within "
            f"the AdamW bound)")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs one NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.fcpo import FCPOConfig
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    stamped = (start_stamped("diversity_insert", "K1", K1_PHASES, K1_WARPS),
               start_stamped("queue_advance", "K3", K3_PHASES, K3_WARPS))
    paths = build.build()
    k1_stamped, k3_stamped = (finish_stamped(*job) for job in stamped)
    log(f"[build] {len(paths)} kernels and the stamped K1 and K3 in "
        f"{time.time() - t0:.1f} s")
    for name, path in paths.items():
        report = path.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"  {name}: {line.strip()}")

    cfg = FCPOConfig()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    log("[K1] diversity_insert vs plain")
    k1_err, k1_t = check_k1(torch, cfg, gen)
    log("[K1 phases] clock64 stamps at the kernel's phase marks")
    k1_phases(torch, cfg, gen, k1_stamped)
    log("[K2] delta_codec vs plain")
    k2_t = check_k2(torch, gen)
    log("[K3] queue_advance vs plain")
    k3_t, k3_loads = check_k3(torch, cfg, gen)
    log("[K3 phases] clock64 stamps at the kernel's phase marks")
    from repro_torch.sim.state import SimParams
    k3_phases(torch, SimParams(), k3_loads, k3_stamped)
    del k3_loads

    n = cfg.n_steps
    from repro_torch.launch import train_fleet
    log("[warm-up] one short train_fleet run (first-use set-up of the "
        "libraries, outside every timed run)")
    train_fleet.main(["--episodes", "2", "--device", DEV])
    log("[main path] repro_torch.launch.train_fleet")
    k1_n, _, _ = drive(torch, ["--episodes", "20"], 20, cfg.fl_every, n)
    _, k2_int8, _ = drive(torch, ["--episodes", "20", "--fl-codec", "int8"],
                          20, cfg.fl_every, n)
    _, k2_topk, _ = drive(torch, ["--episodes", "20", "--fl-codec", "topk"],
                          20, cfg.fl_every, n)
    log("[twin train] repro_torch.launch.train_fleet --env-backend twin")
    _, _, k3_n = drive(torch, ["--env-backend", "twin", "--episodes", "20"],
                       20, cfg.fl_every, n)
    log("[twin eval] repro_torch.launch.simulate")
    drive_simulate([], 60)
    drive_simulate(["--train-episodes", "4", "--train-backend", "twin",
                    "--compare-fluid"], 4 * n + 60)
    log("[profile] default runs under both drivers, torch.profiler")
    default_windows = {"fluid": profile_episodes(torch, cfg),
                       "twin": profile_episodes(torch, cfg, "twin")}
    profile_simulate(torch, cfg)
    log("[graph parity] graph driver vs reference driver on the card")
    graph_parity(torch, "fluid")
    graph_parity(torch, "twin")
    log("[reference] small run, card vs CPU")
    run_pair(torch, FCPOConfig(fl_every=1), "fluid")
    log("[twin reference] small twin run, card vs CPU")
    run_pair(torch, FCPOConfig(fl_every=1), "twin")
    log("[chaos] train_fleet " + " ".join(CHAOS_ARGV))
    k_chaos = {"fluid": drive(torch, ["--episodes", str(CUT_EPISODES),
                                      *CHAOS_ARGV], CUT_EPISODES,
                              cfg.fl_every, n),
               "twin": drive(torch, ["--env-backend", "twin", "--episodes",
                                     str(CUT_EPISODES), *CHAOS_ARGV],
                             CUT_EPISODES, cfg.fl_every, n)}
    log("  launches of K1, K2, K3 on the slice's path: "
        + json.dumps(k_chaos))
    graph_parity(torch, "fluid", chaos=True)
    graph_parity(torch, "twin", chaos=True)
    run_pair(torch, FCPOConfig(fl_every=1), "fluid", chaos=True)
    run_pair(torch, FCPOConfig(fl_every=1), "twin", chaos=True)
    profile_episodes(torch, cfg, reference=False, **chaos_kwargs())
    profile_episodes(torch, cfg, "twin", reference=False, **chaos_kwargs())
    log("[state dtype] train_fleet --state-dtype bf16 / lean")
    state_dtype_phase(torch, cfg)
    log("[resume] train_fleet --state-dtype lean " + " ".join(NOISE_ARGV)
        + " --ckpt-every 5, killed by --stop-after 7 and rerun")
    resume_phase(torch, cfg)
    log("[state bytes] fleet_state_bytes, allocated memory, checkpoints")
    state_bytes_phase(torch, cfg)
    log("[health] train_fleet --health --metrics-out --alerts-out, fluid "
        "and twin, plain and with the chaos flags and --susp-threshold 0.5")
    health_phase(torch, cfg, default_windows,
                 {"fluid": (CUT_EPISODES, 0, 0),
                  "fluid chaos": k_chaos["fluid"],
                  "twin": (CUT_EPISODES, 0, CUT_EPISODES * n),
                  "twin chaos": k_chaos["twin"]})
    log("[metrics] the JSONL stream, watch, the sink's cost")
    metrics_phase(torch, cfg)
    log("[leaderboard] a reduced grid from the [main path] run's "
        "checkpoint")
    leaderboard_phase(torch, cfg)
    log("[stamp] span_stamp vs plain, the clock's resolution")
    stamp_t, stamp_res = stamp_phase(torch)
    log("[trace] train_fleet --trace-out, fluid and twin, both drivers, "
        "--trace-sample 1 and 2")
    stamp_n = trace_phase(torch, cfg)
    log("[attribution] simulate --attribution --trace-out; the recording K3 "
        "card vs CPU")
    k3_rec_n = attribution_phase(torch, cfg)
    log("[obs profile] fleet_memory_report at A=2048, P=8")
    obs_profile_phase(torch, cfg)
    log("[ablation] the single head (Fig. 12) through both drivers, K2 on "
        "its 8-leaf round, graph parity, card vs CPU")
    ablation_counts, k2_single = ablation_phase(torch, gen)
    log("[baselines] BCEdge / OctopInf / Distream at n=8, DYNAMIC traces, "
        "fluid and twin; K1 at N=700, NA=13")
    k1_bcedge_n, (k1_700_err, k1_700_t) = baselines_phase(torch, gen)
    log("[oracles] sim_interval_agent vs sim/oracle.py; buffer_insert vs "
        "buffer_insert_reference")
    oracles_phase(torch)
    log("  launches of K1, K2, K3 in the single-head runs: "
        + json.dumps(ablation_counts) + "; K2 single-head round: "
        + json.dumps({c: k2_single[(c, 8)]["ms"]
                      for c in ("int8", "topk")}))
    log("[mesh] train_fleet --mesh fleet / debug / production on 1 NCCL "
        "rank (graph driver), 2 gloo ranks on the card")
    mesh_windows = mesh_phase(torch, cfg)
    log("  [mesh] windows: " + json.dumps(mesh_windows))

    log("[K5] decode_attention vs plain")
    k5_err, k5_t = check_k5(torch, gen)
    log("[K4] flash_attention vs plain")
    k4_err, k4_t = check_k4(torch, gen)
    log("[K6] pack vs plain")
    k6_t = check_k6(torch, gen)
    log(f"[serve] repro_torch.launch.serve ({QWEN} full width)")
    k5_n = drive_serve(torch)
    cfg_lm, params_lm = full_width_params(torch)
    log("[prefill] make_prefill_step(with_cache=False), full width")
    k4_n = run_prefill(torch, cfg_lm, params_lm)
    log("[generate] ServingEngine at full width, default buckets")
    run_generate(torch, cfg_lm, params_lm)
    del params_lm
    torch.cuda.empty_cache()
    log("[LM reference] reduced model, card vs CPU")
    run_lm_reference(torch)
    log(f"[moe serve] repro_torch.launch.serve --arch {DEEPSEEK} (full "
        f"width and depth)")
    moe_k1, moe_k1_err, moe_k1_t = moe_serve_phase(torch,
                                                   smi.splitlines()[0])
    log("[archs] " + ", ".join(ARCHS) + " at full width: prefill (K4) and "
        "generate (K5)")
    arch_rows, arch_launches = arch_phase(torch, gen, smi.splitlines()[0])
    log("  [archs] launches per config: " + json.dumps(arch_launches))
    log(f"[encode] {HUBERT} at full width through make_encode_step (K4 "
        f"bidirectional, D=80)")
    arch_rows[("flash_attention", HUBERT)], _ = encode_phase(
        torch, gen, smi.splitlines()[0])
    log("[MoE reference] reduced deepseek-v2-lite and granite, card vs CPU")
    moe_reference_phase(torch)
    log(f"[ssm serve] serve --arch {ZAMBA} / {XLSTM} at full width; "
        f"{ZAMBA} prefill (K4 x 6) and generate (K5 x 6 a step); reduced, "
        f"card vs CPU")
    ssm_rows, ssm_launches = ssm_serve_phase(torch, gen, smi.splitlines()[0])
    log("  [ssm serve] launches: " + json.dumps(ssm_launches))
    arch_rows.update(ssm_rows)
    log(f"[lm train] train --arch {ZAMBA} at full width, --resume, "
        f"--grad-compression; {XLSTM}; reduced, card vs CPU")
    lm_train_phase(torch, smi.splitlines()[0])

    rows = [dict(name="diversity_insert", route="cuda",
                 source="src/repro_torch/csrc/diversity_insert.cu",
                 replaces="src/repro/kernels/diversity.py:93",
                 launches=k1_n, max_abs_err=k1_err, **k1_t[8])]
    rows.append(dict(name="diversity_insert[N=700,NA=13]", route="cuda",
                     source="src/repro_torch/csrc/diversity_insert.cu",
                     replaces="src/repro/kernels/diversity.py:93",
                     launches=k1_bcedge_n, max_abs_err=k1_700_err,
                     **k1_700_t[2]))
    for codec, launches in (("int8", k2_int8), ("topk", k2_topk)):
        rows.append(dict(name=f"delta_codec[{codec}]", route="cuda",
                         source="src/repro_torch/csrc/delta_codec.cu",
                         replaces="src/repro/kernels/delta_codec.py:41",
                         launches=launches, max_abs_err=0.0,
                         **k2_t[(codec, 8)]))
    rows.append(dict(name="queue_advance", route="cuda",
                     source="src/repro_torch/csrc/queue_advance.cu",
                     replaces="src/repro/kernels/queue_advance.py:50",
                     launches=k3_n, max_abs_err=0.0, **k3_t[8]))
    rows.append(dict(name="queue_advance[record]", route="cuda",
                     source="src/repro_torch/csrc/queue_advance.cu",
                     replaces="src/repro/kernels/queue_advance.py:50",
                     launches=k3_rec_n, max_abs_err=0.0,
                     **k3_t[("record", 8)]))
    rows.append(dict(name="span_stamp", route="cuda",
                     source="src/repro_torch/csrc/span_stamp.cu",
                     replaces="none (the span callbacks of "
                              "src/repro/obs/trace.py:203)",
                     launches=stamp_n, **stamp_t))
    rows.append(dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:112",
                     launches=k4_n, max_abs_err=k4_err, **k4_t["bfloat16"]))
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attention.cu",
                     replaces="src/repro/kernels/decode_attention.py:110",
                     launches=k5_n, max_abs_err=k5_err,
                     **k5_t[K5_MAIN[0]]))
    rows.append(dict(name="pack", route="cuda",
                     source="src/repro_torch/csrc/pack.cu",
                     replaces="src/repro/kernels/packing.py:34",
                     launches=0, max_abs_err=0.0, **k6_t))
    rows.append(dict(name=f"diversity_insert[serve {DEEPSEEK}, A=4]",
                     route="cuda",
                     source="src/repro_torch/csrc/diversity_insert.cu",
                     replaces="src/repro/kernels/diversity.py:93",
                     launches=moe_k1, max_abs_err=moe_k1_err, **moe_k1_t))
    src = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:112"),
           "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:110")}
    for (kernel, arch), row in arch_rows.items():
        rows.append(dict(name=f"{kernel}[{arch}]", route="cuda",
                         source=src[kernel][0], replaces=src[kernel][1],
                         **row))
    log("[A=2048] " + json.dumps(
        {"diversity_insert": k1_t[2048],
         **{f"delta_codec[{c}]": k2_t[(c, 2048)] for c in ("int8", "topk")},
         "queue_advance": k3_t[2048],
         "queue_advance[record]": k3_t[("record", 2048)],
         "span_stamp resolution ns": stamp_res}))
    log("[LM other shapes] " + json.dumps(
        {"flash_attention[float32]": k4_t["float32"],
         "decode_attention[B=64,kv_len=4096]":
             k5_t[K5_BIG[0]]}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    else:
        main()
