"""Request-level twin launcher — evaluate FCPO policies on the digital twin.

Port of ``repro.launch.simulate``. Builds a fleet (optionally trained
first, on the fluid MDP or in the twin), drives it through the
request-level simulator (``repro_torch.sim``) on a named workload
scenario, and prints request-grade metrics: throughput, effective
throughput, p50/p99 end-to-end latency and drops. ``--compare-fluid``
also evaluates the same policies on the fluid MDP over the same traces and
prints the fidelity gap. On the GPU (the default) each control interval is
one K3 ``queue_advance`` launch for the fleet, inside the interval body's
CUDA graph (captured once, replayed per interval); the warm-up training and
the fluid comparison run through ``train_fleet``, the graph driver.
``--attribution`` records the counters after every microtick (K3's
recording instantiation on the card) and prints the per-request stage
latency decomposition, with the conservation check against the twin's
own counters; ``--trace-out`` (which implies it) writes the sampled
request lifecycles as Chrome trace-event JSON. ``--pallas`` is the JAX
CLI's switch to its fused twin kernel: accepted with the JAX CLI's error
beside ``--attribution``, and it changes nothing here, because the device
picks K3's path (CUDA tensors launch the kernel, CPU tensors run its plain
version).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.simulate
  PYTHONPATH=src python -m repro_torch.launch.simulate --agents 16 \\
      --scenario ood --train-episodes 40 --train-backend twin --compare-fluid
  PYTHONPATH=src python -m repro_torch.launch.simulate --device cpu \\
      --agents 4 --intervals 20
  PYTHONPATH=src python -m repro_torch.launch.simulate --agents 4 \\
      --intervals 30 --attribution --trace-out req.json
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.backends import BACKENDS, FLUID, get_backend
from repro_torch.core.crl import AgentState
from repro_torch.core.fleet import fleet_init, train_fleet
from repro_torch.data.workload import fleet_traces
from repro_torch.kernels import build
from repro_torch.obs import requests as obs_requests
from repro_torch.obs.trace import Tracer
from repro_torch.sim import SCENARIOS, SimParams, eval_fleet, make_scenario
from repro_torch.sim.metrics import stage_breakdown_table

ROWS = (("throughput", "req/s"), ("effective_throughput", "req/s"),
        ("mean_latency_s", "s"), ("p50_latency_s", "s"),
        ("p99_latency_s", "s"), ("drop_rate", ""), ("hist_censored", ""))


def _generator(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--intervals", type=int, default=60,
                    help="control intervals to simulate")
    ap.add_argument("--scenario", choices=SCENARIOS, default="dynamic")
    ap.add_argument("--train-episodes", type=int, default=0,
                    help="warm-up training episodes before evaluation "
                         "(0 = untrained policies)")
    ap.add_argument("--train-backend", choices=BACKENDS, default="fluid",
                    help="environment the warm-up episodes train in "
                         "(twin = 'train where you serve')")
    ap.add_argument("--dt", type=float, default=0.05,
                    help="microtick length in seconds")
    ap.add_argument("--k-ticks", type=int, default=20,
                    help="microticks per control interval")
    ap.add_argument("--ring", type=int, default=512,
                    help="ring capacity (power of two)")
    ap.add_argument("--hist", type=int, default=64,
                    help="latency histogram buckets (ticks)")
    ap.add_argument("--pallas", action="store_true",
                    help="route the data plane through the fused Pallas "
                         "queue_advance kernel (the JAX CLI's switch; "
                         "accepted, and changes nothing here: CUDA tensors "
                         "always launch the K3 kernel, CPU tensors run its "
                         "plain version)")
    ap.add_argument("--compare-fluid", action="store_true",
                    help="also evaluate on the fluid MDP and print the gap")
    ap.add_argument("--attribution", action="store_true",
                    help="record per-microtick counters and print the "
                         "per-request stage latency decomposition (the "
                         "recording K3 on the card)")
    ap.add_argument("--attr-sample", type=int, default=16,
                    help="keep every Nth request in the attribution "
                         "records / Chrome trace")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write the sampled request lifecycles as Chrome "
                         "trace-event JSON (open in Perfetto); implies "
                         "--attribution")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.intervals < 1:
        ap.error("--intervals must be >= 1")
    if args.ring <= 0 or args.ring & (args.ring - 1):
        ap.error("--ring must be a positive power of two")
    if args.k_ticks < 1 or args.hist < 2:
        ap.error("--k-ticks must be >= 1 and --hist >= 2")
    if args.trace_out:
        args.attribution = True
    if args.attribution and args.pallas:
        ap.error("--attribution needs the jnp data plane (drop --pallas): "
                 "the fused kernel advances whole intervals per call")

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        build.build()          # kernel build is set-up, not simulation time

    cfg = FCPOConfig()
    if args.compare_fluid and args.intervals % cfg.n_steps:
        # the fluid plane evaluates in whole episodes; keep both planes on
        # the same workload window
        args.intervals = max(args.intervals // cfg.n_steps, 1) * cfg.n_steps
        print(f"note: --compare-fluid rounds the horizon to whole episodes "
              f"-> {args.intervals} intervals")
    sp = SimParams(dt=args.dt, k_ticks=args.k_ticks, ring=args.ring,
                   hist_n=args.hist)
    train_be = get_backend(args.train_backend, sim_params=sp)
    fleet = fleet_init(cfg, args.agents, args.seed, device=dev,
                       env_backend=train_be)
    if args.train_episodes > 0:
        warmup = fleet_traces(_generator(args.seed + 1), args.agents,
                              args.train_episodes * cfg.n_steps, device=dev)
        fleet, _ = train_fleet(cfg, fleet, warmup, env_backend=train_be)
    traces = make_scenario(args.scenario, _generator(args.seed + 2),
                           args.agents, args.intervals, device=dev)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"twin: {args.agents} agents, {args.intervals} intervals, "
          f"K={sp.k_ticks} microticks of {sp.dt * 1e3:.0f} ms, "
          f"ring={sp.ring}, scenario={args.scenario}, "
          f"trained={args.train_episodes} eps on {train_be.name}, "
          f"device={dev.type} ({name})")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 3)
    t0 = time.time()
    state, history, summ = eval_fleet(cfg, sp, fleet, traces, generator=gen,
                                      record_ticks=args.attribution)
    summ = {k: v.cpu().numpy() for k, v in summ.items()}
    wall = time.time() - t0
    print(f"wall {wall:.3f}s ({wall / args.intervals * 1e3:.2f} ms per "
          f"interval, {wall / (args.intervals * sp.k_ticks) * 1e6:.0f} "
          f"us/microtick for the fleet)\n")

    print(f"{'metric':24s}{'fleet mean':>12s}{'min':>10s}{'max':>10s}")
    for k, unit in ROWS:
        v = summ[k]
        print(f"{k:24s}{v.mean():10.3f} {unit:4s}{v.min():9.3f}{v.max():10.3f}")
    print(f"{'requests':24s}arrived={int(summ['arrived'].sum())} "
          f"completed={int(summ['completed'].sum())} "
          f"dropped={int(summ['dropped'].sum())}")

    if args.attribution:
        attr = obs_requests.attribute_run(history, state,
                                          sample_every=args.attr_sample)
        ok = [rep["ok"] for rep in attr["conservation"]]
        bad = [i for i, good in enumerate(ok) if not good]
        dec = obs_requests.stage_decomposition(attr["agents"], sp.dt)
        print(f"\nrequest attribution ({len(attr['records'])} sampled "
              f"records, 1/{args.attr_sample}; conservation "
              f"{'FAILED for agents ' + str(bad) if bad else 'exact'})")
        print(stage_breakdown_table(dec))
        summ["conservation_ok"] = np.asarray(ok)
        if args.trace_out:
            with Tracer() as tr:
                n = obs_requests.records_to_chrome(tr, attr["records"],
                                                   sp.dt)
                tr.export(args.trace_out)
            print(f"wrote {n} request slices -> {args.trace_out} "
                  f"(open in Perfetto / chrome://tracing)")

    if args.compare_fluid:
        hist = _fluid_eval(cfg, fleet, traces)
        eff_f = float(np.mean(hist["effective_throughput"]))
        eff_t = float(summ["effective_throughput"].mean())
        gap = abs(eff_f - eff_t) / max(abs(eff_f), 1e-9)
        print(f"\nfluid-vs-twin effective throughput: fluid={eff_f:.2f} "
              f"twin={eff_t:.2f} gap={gap * 100:.1f}%")
    summ["wall_s"] = wall
    return summ


def _fluid_eval(cfg, fleet, traces):
    """Evaluate (no learning) on the fluid MDP over the same traces. The
    fleet may have been trained on either backend: its env states are
    swapped for fresh fluid ones so the policies carry over."""
    a = traces.shape[0]
    astate = fleet.astate
    fleet = fleet.replace(astate=AgentState(
        astate.policy, astate.opt, astate.buffer,
        FLUID.init(cfg, a, traces.device)))
    n_eps = max(traces.shape[1] // cfg.n_steps, 1)
    _, hist = train_fleet(cfg, fleet, traces[:, :n_eps * cfg.n_steps],
                          learn=False, federated=False)
    return hist


if __name__ == "__main__":
    main()
