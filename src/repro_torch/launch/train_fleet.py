"""Fleet training launcher — the FCPO loop of the PyTorch/CUDA port.

Runs the federated-continual cadence (CRL episodes -> Eq. 7 selection ->
Alg. 1 aggregation -> Alg. 2 fine-tune -> hierarchical pod merge) on the
GPU (``--device cuda``, the default) or the CPU, through one of two
drivers (``--driver``): ``scan``, the default as in the JAX package, is
``repro_torch.core.fleet.train_fleet_scan`` (on the GPU the episode, the FL
round and the pod merge are CUDA graphs, captured once and replayed; on
the CPU the same bodies run eagerly), and ``reference`` is the Python-loop
``train_fleet_reference``. The two give the same numbers. The device
picks the implementation of
each kernel: CUDA tensors launch the hand-written kernels
(``repro_torch.kernels``), CPU tensors run their plain PyTorch versions.
``--env-backend twin`` trains in the request-level digital twin (K
microticks per control interval, one K3 launch per interval on the GPU);
``--scenario`` picks the workload from the scenario library. The
transport and chaos layers take the JAX CLI's flags: ``--fl-async``
(deadline-missed uploads park and join later rounds), ``--robust-agg``,
``--trim-frac``, ``--clip-factor``, ``--no-reject-nonfinite`` and the
``--fault-*`` family (crashes, byzantine uploads, pod partitions).

``--health`` attaches the fleet health observatory
(``repro_torch.health``: telemetry sketches and drift detectors advanced
in the episode graph, FL contribution attribution in the round graph);
``--health-bins`` sets its histogram resolution and ``--susp-threshold``
gates Eq. 7 selection on the attribution's suspicion EMA.
``--metrics-out`` streams one JSONL record per episode while the run goes
(``python -m repro_torch.launch.watch <file> --follow`` tails it), plus a
trailing scaling record; ``--alerts-out`` evaluates the alert rules over
the stream into an alerts file. The flags, defaults and errors are the
JAX CLI's.

``--trace-out`` records the flight recorder's phase spans (episode,
fl_round and its uplink / encode / aggregate / finetune phases, pod merge)
on every ``--trace-sample``-th episode and writes them as Chrome
trace-event JSON (open in Perfetto): under the graph driver on the card
each span's ends are ``span_stamp`` nodes of the CUDA graphs, stamping
the device's clock; under the reference driver and on the CPU they are
host spans.

``--state-dtype {float32,bf16,lean}`` stores the fleet's state families
narrower (``repro_torch.core.dtypes``); the math stays float32.
``--ckpt-dir`` + ``--ckpt-every`` write checkpoints in the JAX package's
format (``repro_torch.training.checkpoint``) with auto-resume: a killed
run relaunched with the same command restarts from the latest checkpoint
and gives the uninterrupted run's numbers bit for bit (``--stop-after N``
stops an invocation after N episodes, for the drill). ``--pallas`` and
``--fl-pallas`` are accepted with the JAX CLI's errors; they change
nothing, because the device picks each kernel's path.

``--mesh {none,debug,production,fleet}`` places the fleet on a
``torch.distributed`` device mesh (``repro_torch.launch.mesh``): ``fleet``
is the (pod, data) mesh over the world's ranks (pods over the FL
hierarchy), ``debug`` a (world, 1) (data, model) mesh, ``production`` the
(16, 16) / (2, 16, 16) mesh, which raises on fewer than 256 / 512 ranks.
Each rank holds its slice of the agents (``cuda:LOCAL_RANK``, NCCL; gloo
with ``--device cpu``); the FL round's cross-agent steps are collectives,
and rank 0 prints, streams and writes the checkpoints (the whole fleet,
gathered). Several ranks run under torchrun; one rank runs plainly:
  torchrun --nproc-per-node 8 -m repro_torch.launch.train_fleet \
      --mesh fleet --agents 16 --pods 2

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train_fleet
  PYTHONPATH=src python -m repro_torch.launch.train_fleet --agents 8 \\
      --pods 2 --episodes 20 --fl-codec int8
  PYTHONPATH=src python -m repro_torch.launch.train_fleet --env-backend twin \\
      --scenario switching --episodes 20
  PYTHONPATH=src python -m repro_torch.launch.train_fleet --device cpu \\
      --agents 4 --episodes 4 --fl-every 1 --driver reference
  PYTHONPATH=src python -m repro_torch.launch.train_fleet --fl-codec int8 \\
      --fl-deadline-s 0.002 --fl-async --robust-agg trimmed \\
      --clip-factor 3 --fault-crash-prob 0.1 --fault-byzantine-frac 0.25 \\
      --fault-partition-prob 0.3
  PYTHONPATH=src python -m repro_torch.launch.train_fleet --state-dtype \\
      lean --ckpt-dir /tmp/run1 --ckpt-every 5 --stop-after 7  # then rerun
  PYTHONPATH=src python -m repro_torch.launch.train_fleet --health \\
      --metrics-out run.jsonl --alerts-out alerts.jsonl \\
      --fault-byzantine-frac 0.25 --fl-codec int8 --susp-threshold 0.5
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.backends import BACKENDS, get_backend
from repro_torch.core.dtypes import POLICIES
from repro_torch.core.graphs import full_float32
from repro_torch.core.fleet import (FleetScan, fleet_device_bytes,
                                    fleet_init, fleet_state_bytes,
                                    train_fleet_reference)
from repro_torch.eval.stream import MetricsSink
from repro_torch.fl.transport import CODECS, TransportConfig
from repro_torch.health import HealthConfig
from repro_torch.health.alerts import AlertEngine
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_mod
from repro_torch.obs.trace import Tracer
from repro_torch.resilience.faults import BYZANTINE_MODES, FaultConfig
from repro_torch.resilience.guards import AGG_METHODS, GuardConfig
from repro_torch.sim import SCENARIOS, SimParams, make_scenario
from repro_torch.training import checkpoint as ckpt_mod


def _say(fleet):
    """``print`` on rank 0 (and without a mesh), a no-op on the others."""
    place = fleet.placement
    return print if place is None or place.rank == 0 else \
        (lambda *a, **k: None)


def resume(args, cfg, fleet, start: int, faults):
    """The fleet of checkpoint ``start`` restored into ``fleet``'s layout
    and dtypes. A checkpoint without this device's generator states (one
    the JAX package wrote, or one from another device) has its generators
    seeded from ``--seed`` / ``--fault-seed`` and the step, and says so."""
    step_seed = lambda s: int(np.random.SeedSequence([s, start])
                              .generate_state(1)[0])
    say = _say(fleet)
    fleet, manifest = ckpt_mod.restore(args.ckpt_dir, start, fleet, cfg,
                                       seed=step_seed(args.seed))
    say(f"auto-resume: restored episode {start} from {args.ckpt_dir}")
    got = manifest["restored_generators"]
    if "torch/generator" not in got:
        say(f"auto-resume: the checkpoint holds no generator state for "
            f"this device; the action noise is seeded from --seed "
            f"{args.seed} and step {start}")
    if (faults.byzantine_active and faults.byzantine_mode == "noise"
            and "torch/fault_generator" not in got):
        gen = torch.Generator(device=fleet.pod_ids.device)
        gen.manual_seed(step_seed(faults.seed))
        fleet.fault_generator = gen
        say(f"auto-resume: the byzantine noise is seeded from "
            f"--fault-seed {faults.seed} and step {start}")
    return fleet


def run_with_checkpoints(args, driver: FleetScan, start: int) -> None:
    """The graph driver over ``[start, --episodes)`` with a checkpoint
    every ``--ckpt-every`` episodes of this invocation and at its end, read
    from the fleet's own tensors between episodes (the JAX CLI's chunk
    boundaries, without restarting the driver; a meshed fleet is gathered
    and rank 0 writes it); the streamed records are written before each
    save, and on the way out. ``--stop-after`` ends the
    invocation early."""
    every = args.ckpt_every or (args.episodes - start)
    say = _say(driver.fleet)
    rank0 = say is print
    e, since = start, 0
    extra = dict(episodes=args.episodes, agents=args.agents,
                 pods=args.pods, seed=args.seed, scenario=args.scenario,
                 state_dtype=args.state_dtype)
    with full_float32():
        try:
            while e < args.episodes:
                driver.step()
                e, since = e + 1, since + 1
                stop = bool(args.stop_after) and e - start >= args.stop_after
                if since == every or e == args.episodes or stop:
                    driver.drain()
                    ckpt_mod.save(args.ckpt_dir, e, driver.fleet,
                                  extra=extra)
                    if rank0:
                        ckpt_mod.keep_last(args.ckpt_dir, args.keep_last)
                    since = 0
                if stop:
                    say(f"--stop-after {args.stop_after}: stopping at "
                        f"episode {e}/{args.episodes} (rerun the same "
                        f"command to resume)")
                    return
        finally:
            driver.drain()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--episodes", type=int, default=200)
    ap.add_argument("--fl-every", type=int, default=None,
                    help="override cfg.fl_every")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="probability an agent is offline for an FL round "
                         "(Bernoulli draw); composes with the deadline "
                         "stragglers of --fl-deadline-s")
    ap.add_argument("--fl-codec", choices=CODECS, default="float32",
                    help="on-wire FL delta codec: float32 is lossless; "
                         "int8/topk compress the params-base delta with "
                         "error feedback (the delta_codec kernel on the GPU)")
    ap.add_argument("--fl-topk-frac", type=float, default=0.05,
                    help="fraction of coordinates the topk codec keeps per "
                         "tensor")
    ap.add_argument("--fl-deadline-s", type=float, default=0.0,
                    help="FL round deadline (s); uplink time = encoded "
                         "payload bits / per-agent bandwidth. <= 0 disables")
    ap.add_argument("--fl-async", action="store_true",
                    help="staleness-tolerant rounds: a selected client that "
                         "misses the deadline parks its decoded delta and "
                         "joins a later round staleness-discounted")
    ap.add_argument("--fl-pallas", action="store_true",
                    help="the JAX CLI's switch to the fused delta codec "
                         "kernel; accepted, and changes nothing here: CUDA "
                         "tensors always launch the K2 kernel, CPU tensors "
                         "run its plain version")
    # --- chaos layer: fault injection (FaultConfig) ---
    ap.add_argument("--fault-crash-prob", type=float, default=0.0,
                    help="per-agent per-episode crash probability: the "
                         "agent's state freezes (params zeroed), it leaves "
                         "episodes and Eq. 7 selection for "
                         "--fault-crash-recovery episodes, then rejoins "
                         "warm-started from its pod base network")
    ap.add_argument("--fault-crash-recovery", type=int, default=2,
                    help="episodes a crashed agent stays down")
    ap.add_argument("--fault-byzantine-frac", type=float, default=0.0,
                    help="per-agent per-round probability of shipping a "
                         "corrupted delta (after the codec)")
    ap.add_argument("--fault-byzantine-mode", choices=BYZANTINE_MODES,
                    default="sign_flip",
                    help="corruption: sign_flip (scaled negation), noise "
                         "(additive gaussian), nan (poisoned upload)")
    ap.add_argument("--fault-byzantine-scale", type=float, default=10.0,
                    help="magnitude of sign_flip/noise corruption")
    ap.add_argument("--fault-partition-prob", type=float, default=0.0,
                    help="per-pod probability, at each hierarchical merge, "
                         "of dropping off the cloud tier for "
                         "--fault-partition-merges merge events")
    ap.add_argument("--fault-partition-merges", type=int, default=1,
                    help="merge events a partitioned pod skips")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault plan (independent of --seed)")
    # --- chaos layer: defenses (GuardConfig) ---
    ap.add_argument("--robust-agg", choices=AGG_METHODS, default="mean",
                    help="Algorithm 1 statistic: mean is the paper's; "
                         "trimmed/median are coordinate-wise robust "
                         "statistics that bound byzantine influence")
    ap.add_argument("--trim-frac", type=float, default=0.2,
                    help="per-side trim fraction of the trimmed-mean "
                         "aggregator (in [0, 0.5))")
    ap.add_argument("--clip-factor", type=float, default=0.0,
                    help="clip each client delta leaf to this multiple of "
                         "the selected-client median leaf norm; 0 disables")
    ap.add_argument("--no-reject-nonfinite", action="store_true",
                    help="disable the NaN/Inf contribution rejection (on "
                         "by default)")
    # --- fleet health observatory and the metrics stream ---
    ap.add_argument("--health", action="store_true",
                    help="attach the fleet health observatory: per-agent "
                         "telemetry sketches + drift detectors advanced in "
                         "the episode, FL contribution attribution per "
                         "round; per-episode health_* summaries join the "
                         "history and the --metrics-out stream")
    ap.add_argument("--health-bins", type=int, default=16,
                    help="histogram sketch resolution (quantile error is "
                         "bounded by one bin width)")
    ap.add_argument("--susp-threshold", type=float, default=0.0,
                    help="act on the attribution evidence: clients whose "
                         "suspicion EMA exceeds this are dropped from Eq. 7 "
                         "selection (one round behind by construction). "
                         "0 observes without acting; requires --health")
    ap.add_argument("--alerts-out", type=str, default=None,
                    help="evaluate the declarative health alert rules "
                         "(repro_torch.health.alerts.DEFAULT_RULES) over the "
                         "metrics stream and write fire/resolve lines to "
                         "this ALERTS.jsonl; requires --health")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="stream per-episode metrics (reward, "
                         "fl_payload_bytes, health_*, ...) to this JSONL "
                         "file while training runs; tail it live with "
                         "python -m repro_torch.launch.watch <file> --follow")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="flight recorder: record phase spans (episode, "
                         "fl_round uplink/encode/aggregate/finetune, pod "
                         "merge) from inside the graphed run and write "
                         "Chrome trace-event JSON here (open in Perfetto)")
    ap.add_argument("--trace-sample", type=int, default=1,
                    help="record spans only on every Nth episode (read "
                         "from device memory by the span stamps: changing "
                         "it never recaptures)")
    ap.add_argument("--env-backend", choices=BACKENDS, default="fluid",
                    help="environment the CRL episodes run in: the fluid "
                         "MDP or the request-level digital twin")
    ap.add_argument("--scenario", choices=SCENARIOS, default="nominal",
                    help="workload scenario of the training traces")
    ap.add_argument("--dt", type=float, default=0.05,
                    help="twin microtick length (s)")
    ap.add_argument("--k-ticks", type=int, default=20,
                    help="twin microticks per control interval")
    ap.add_argument("--ring", type=int, default=512,
                    help="twin ring capacity (power of two)")
    ap.add_argument("--pallas", action="store_true",
                    help="the JAX CLI's switch to the fused twin kernel; "
                         "accepted, and changes nothing here: CUDA tensors "
                         "always launch the K3 kernel, CPU tensors run its "
                         "plain version")
    ap.add_argument("--state-dtype", choices=tuple(POLICIES),
                    dest="state_dtype", default="float32",
                    help="stored-state precision policy "
                         "(repro_torch.core.dtypes): float32 is the default "
                         "layout; bf16 halves optimizer/env/transport/buffer "
                         "state; lean adds int8 buffer slots and bf16 "
                         "params (>= 2x fewer bytes per agent). The math "
                         "stays float32")
    ap.add_argument("--driver", choices=("scan", "reference"),
                    default="scan",
                    help="scan: the episode, FL round and pod merge as "
                         "CUDA graphs replayed by the host (eager on the "
                         "CPU); reference: the Python-loop driver")
    ap.add_argument("--no-federated", action="store_true")
    ap.add_argument("--no-learn", action="store_true")
    ap.add_argument("--mesh", choices=("none", "debug", "production",
                                       "fleet"),
                    default="none",
                    help="fleet = the scaling mesh: ('pod', 'data') over "
                         "every rank of the world, pods over the "
                         "FL-hierarchy axis (run several ranks with "
                         "torchrun --nproc-per-node N)")
    # --- periodic checkpoint + auto-resume ---
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint directory (training.checkpoint "
                         "layout, the JAX package's). If it already holds "
                         "checkpoints, the run AUTO-RESUMES from "
                         "latest_step and reproduces the uninterrupted "
                         "run's numbers exactly")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a checkpoint every N episodes (requires "
                         "--ckpt-dir; 0 saves only at the end of the run)")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="prune all but the newest N checkpoints after "
                         "every save")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="exit after this many episodes of THIS invocation "
                         "(kill-and-resume drills; requires --ckpt-dir). "
                         "0 disables")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.episodes < 1:
        ap.error("--episodes must be >= 1")
    if args.fl_every is not None and args.fl_every < 1:
        ap.error("--fl-every must be >= 1 (use --no-federated to disable FL)")
    if args.ring <= 0 or args.ring & (args.ring - 1):
        ap.error("--ring must be a positive power of two")
    if args.k_ticks < 1:
        ap.error("--k-ticks must be >= 1")
    if args.env_backend == "fluid" and (
            args.pallas or args.dt != 0.05 or args.k_ticks != 20
            or args.ring != 512):
        ap.error("--pallas/--dt/--k-ticks/--ring configure the twin data "
                 "plane and are silent no-ops on the fluid backend; add "
                 "--env-backend twin")
    if args.fl_async and args.fl_deadline_s <= 0:
        ap.error("--fl-async parks deadline-missed uploads and needs "
                 "--fl-deadline-s > 0 to ever have one")
    if args.fl_pallas and args.fl_codec == "float32":
        ap.error("--fl-pallas routes the delta codec through the fused "
                 "kernel, but the float32 codec skips the codec entirely "
                 "(lossless identity path); add --fl-codec int8 or topk")
    if args.fl_topk_frac != 0.05 and args.fl_codec != "topk":
        ap.error("--fl-topk-frac only affects the topk codec; add "
                 "--fl-codec topk")
    if args.ckpt_every and not args.ckpt_dir:
        ap.error("--ckpt-every needs --ckpt-dir")
    if args.stop_after and not args.ckpt_dir:
        ap.error("--stop-after simulates a kill mid-run and only makes "
                 "sense with --ckpt-dir (nothing would survive otherwise)")
    if args.ckpt_dir and args.driver == "reference":
        ap.error("--ckpt-dir periodic checkpointing drives the scan "
                 "driver; drop --driver reference")
    if args.ckpt_every < 0 or args.stop_after < 0 or args.keep_last < 1:
        ap.error("--ckpt-every/--stop-after must be >= 0, --keep-last >= 1")
    if args.susp_threshold and not args.health:
        ap.error("--susp-threshold gates selection on the suspicion EMA "
                 "the observatory maintains; add --health")
    if args.alerts_out and not args.health:
        ap.error("--alerts-out evaluates rules over the health_* metrics; "
                 "add --health")
    if args.health_bins != 16 and not args.health:
        ap.error("--health-bins only affects the observatory; add --health")
    if args.trace_sample < 1:
        ap.error("--trace-sample must be >= 1")

    dev = resolve_device(args.device)
    if args.mesh == "none":
        return train(args, dev)
    owns_world = mesh_mod.init_world(dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", mesh_mod.local_rank())
    try:
        return train(args, dev)
    finally:
        if owns_world:
            dist.destroy_process_group()


def make_mesh(args, dev):
    """The device mesh of ``--mesh`` over the world's ranks (None for
    ``none``)."""
    if args.mesh == "none":
        return None
    world = dist.get_world_size()
    if args.mesh == "debug":
        return mesh_mod.make_debug_mesh(world, 1, device_type=dev.type)
    if args.mesh == "production":
        return mesh_mod.make_production_mesh(multi_pod=args.pods > 1,
                                             device_type=dev.type)
    return mesh_mod.make_fleet_mesh(world, args.pods, device_type=dev.type)


def train(args, dev):
    """The run of ``main``'s checked arguments on ``dev``: returns (this
    rank's fleet, the history)."""
    # full float32 on the card, as on the CPU (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        build.build()          # kernel build is set-up, not training time

    cfg = FCPOConfig() if args.fl_every is None else \
        FCPOConfig(fl_every=args.fl_every)
    transport = TransportConfig(codec=args.fl_codec,
                                topk_frac=args.fl_topk_frac,
                                deadline_s=args.fl_deadline_s,
                                async_rounds=args.fl_async)
    faults = FaultConfig(
        crash_prob=args.fault_crash_prob,
        crash_recovery=args.fault_crash_recovery,
        byzantine_frac=args.fault_byzantine_frac,
        byzantine_mode=args.fault_byzantine_mode,
        byzantine_scale=args.fault_byzantine_scale,
        partition_prob=args.fault_partition_prob,
        partition_merges=args.fault_partition_merges,
        seed=args.fault_seed)
    guards = GuardConfig(agg=args.robust_agg, trim_frac=args.trim_frac,
                         clip_factor=args.clip_factor,
                         reject_nonfinite=not args.no_reject_nonfinite,
                         susp_threshold=args.susp_threshold)
    health = HealthConfig(bins=args.health_bins) if args.health else None
    backend = get_backend(args.env_backend, sim_params=SimParams(
        dt=args.dt, k_ticks=args.k_ticks, ring=args.ring))
    mesh = make_mesh(args, dev)
    fleet = fleet_init(cfg, args.agents, args.seed, n_pods=args.pods,
                       device=dev, env_backend=backend,
                       state_policy=(args.state_dtype
                                     if args.state_dtype != "float32"
                                     else None),
                       health=health, mesh=mesh)
    # rank 0 prints, streams, traces and prunes checkpoints
    rank0 = fleet.placement is None or fleet.placement.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    n_dev = 1 if mesh is None else dist.get_world_size()
    gen = torch.Generator()
    gen.manual_seed(args.seed + 1)
    traces = make_scenario(args.scenario, gen, args.agents,
                           args.episodes * cfg.n_steps, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"fleet: {args.agents} iAgents, {args.pods} pods, "
        f"{args.episodes} episodes, env={backend.name}, "
        f"scenario={args.scenario}, driver={args.driver}, "
        f"mesh={args.mesh}, state_dtype={args.state_dtype} "
        f"({fleet_state_bytes(fleet)['per_agent'] / 1024:.1f} KB/agent), "
        f"device={dev.type} ({name}) ({n_dev} devices)")

    kw = dict(learn=not args.no_learn, federated=not args.no_federated,
              straggler_prob=args.straggler_prob, seed=args.seed,
              env_backend=backend, transport=transport,
              faults=faults if faults.active else None, guards=guards,
              health=health)
    start = (ckpt_mod.latest_step(args.ckpt_dir) or 0) \
        if args.ckpt_dir else 0
    if start >= args.episodes:
        say(f"checkpoint step {start} >= --episodes {args.episodes}: "
            f"run already complete, nothing to do")
        return fleet, {}
    if start > 0:
        fleet = resume(args, cfg, fleet, start, faults)
    # the sink opens after the resume is known: a resumed run appends to
    # the metrics file instead of truncating the episodes before the kill
    sink = engine = None
    if args.metrics_out and rank0:
        sink = MetricsSink(args.metrics_out, meta=dict(
            agents=args.agents, pods=args.pods, episodes=args.episodes,
            driver=args.driver, env_backend=backend.name,
            scenario=args.scenario, fl_codec=args.fl_codec,
            robust_agg=args.robust_agg, seed=args.seed),
            resume=start > 0)
        if start > 0 and sink.n_records:
            say(f"metrics resume: appending to {args.metrics_out} "
                f"({sink.n_records} episodes already recorded)")
        kw["metrics_sink"] = sink
    if args.alerts_out and rank0:
        # the engine tees in front of the JSONL sink (or runs alone
        # without --metrics-out): each record is forwarded and evaluated
        engine = AlertEngine(args.alerts_out, forward=sink)
        kw["metrics_sink"] = engine
    tracer = None
    if args.trace_out and rank0:
        tracer = Tracer(span_sample_every=args.trace_sample)
        kw["tracer"] = tracer
    t0 = time.time()
    try:
        if args.driver == "scan":
            driver = FleetScan(cfg, fleet, traces[:, start * cfg.n_steps:],
                               episode_offset=start,
                               total_episodes=args.episodes, **kw)
            try:
                if args.ckpt_dir:
                    run_with_checkpoints(args, driver, start)
                else:
                    driver.run()
            finally:
                driver.close()     # before a mesh's process group goes
            fleet, hist = driver.fleet, driver.history()
            capture = driver.capture_s
        else:
            fleet, hist = train_fleet_reference(cfg, fleet, traces, **kw)
            capture = 0.0
        wall = time.time() - t0
        # where the fleet state lives, by device (a collective on a mesh)
        per_device = fleet_device_bytes(fleet)
        if sink is not None:
            # one trailing scaling record in the same stream: step time and
            # where the fleet state lives (watch renders the scaling row)
            n_rec = len(hist["reward"])
            row = {"devices": float(n_dev), "agents": float(args.agents),
                   "step_time_s": wall / max(n_rec, 1),
                   "step_time_per_agent_s":
                       wall / max(n_rec, 1) / max(args.agents, 1),
                   "state_bytes_per_agent":
                       fleet_state_bytes(fleet)["per_agent"]}
            for d, b in sorted(per_device.items()):
                row[f"dev{d}_bytes"] = b
            sink.append(row)
    finally:
        if engine is not None:
            engine.close()              # closes the forwarded sink too
        elif sink is not None:
            sink.close()
        if tracer is not None:
            tracer.export(args.trace_out)
            say(f"flight recorder: "
                f"{len(tracer.chrome_events())} span events -> "
                f"{args.trace_out} (open in Perfetto)")
            tracer.close()

    n_run = len(hist["reward"])
    k = max(n_run // 10, 1)
    say(f"\nwall {wall:.2f}s  ({(wall - capture) / n_run * 1e3:.1f} "
        f"ms/episode)")
    if args.driver == "scan" and dev.type == "cuda":
        say(f"graph capture {capture:.3f} s apart from the episodes; "
            f"{driver.graph_launches / n_run:.2f} graph launches/episode")
    say(f"{'':24s}{'first ' + str(k) + ' eps':>16s}"
        f"{'last ' + str(k) + ' eps':>16s}")
    for key, scale, unit in (("reward", 1, ""), ("throughput", 1, "/s"),
                             ("effective_throughput", 1, "/s"),
                             ("latency", 1e3, "ms"), ("gated", 1, "")):
        a, b = hist[key][:k].mean() * scale, hist[key][-k:].mean() * scale
        say(f"{key:24s}{a:12.3f}{unit:4s}{b:12.3f}{unit}")

    fl_eps = np.flatnonzero(hist["fl_payload_bytes"])
    if fl_eps.size:
        say(f"\nFL transport (codec={args.fl_codec}, "
            f"deadline={args.fl_deadline_s}s, async={args.fl_async}): "
            f"{fl_eps.size} rounds, "
            f"{hist['fl_payload_bytes'][fl_eps].mean() / 1024:.1f} KB/round, "
            f"uplink {hist['fl_uplink_s'][fl_eps].mean() * 1e3:.1f} ms, "
            f"missed {hist['fl_missed'][fl_eps].mean():.2f}/round, "
            f"stale joins {hist['fl_stale_used'][fl_eps].mean():.2f}/round, "
            f"rejected {hist['fl_rejected'].sum():.0f}, "
            f"clipped {hist['fl_clipped'].sum():.0f}")
    if health is not None and "health_drift_score" in hist:
        flags = np.asarray(hist["health_drift_flag"])
        say(f"\nhealth: drift flags on {np.count_nonzero(flags)} of "
            f"{flags.size} episodes, "
            f"drift score last {hist['health_drift_score'][-1]:.2f}, "
            f"reward p50 last {hist['health_reward_p50'][-1]:.3f}, "
            f"susp last {hist['health_susp'][-1]:.3f}"
            + (f"; {engine.n_alerts} alerts -> {args.alerts_out}"
                 if engine is not None else ""))
    if faults.active:
        say(f"\nchaos: crash_prob={faults.crash_prob}, "
            f"byzantine={faults.byzantine_frac} "
            f"({faults.byzantine_mode} x{faults.byzantine_scale}), "
            f"partition={faults.partition_prob}; defenses: "
            f"agg={guards.agg}, clip={guards.clip_factor}, "
            f"reject_nonfinite={guards.reject_nonfinite}; "
            f"update_rejected {hist['update_rejected'].sum():.0f}")
    return fleet, hist


if __name__ == "__main__":
    main()
