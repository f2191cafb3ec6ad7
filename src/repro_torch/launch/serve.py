"""FCPO-controlled serving launcher — the paper's full system, end to end.

Port of ``repro.launch.serve``. One process = one cluster: N replicas of
one LM engine, each piggybacked with an iAgent. The engine's measured
prefill curve becomes the MDP the fleet trains on; every episode the fleet
runs its CRL inner loop, an FL round every ``fl_every`` episodes, and one
real batch is served by ``engine.generate`` at the batch size the fleet
chose.

On the GPU (the default) the model runs at the full width and depth of
``--arch`` (any decoder of ``repro_torch.configs``: qwen2-0.5b by default,
24 layers, d_model 896; deepseek-v2-lite-16b, 27 layers, 15.7 G float32
parameters, fits one 80 GB card) with random weights made from ``--seed``
on the card. Every decode step runs K5 ``decode_attention`` in each GQA
layer (zamba2-1.2b: its shared attention block, six times a step);
MLA layers (deepseek), the MoE experts and xlstm-125m's recurrent cells
run plain torch ops, as the reference runs them outside any Pallas
kernel. ``--reduced`` gives the small variant.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --arch granite-moe-3b-a800m --replicas 2 --episodes 2
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, shape_applicable
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.env import EnvParams
from repro_torch.core.fleet import fl_round, fleet_episode, fleet_init
from repro_torch.data.workload import fleet_traces
from repro_torch.kernels import build
from repro_torch.models.registry import get_model, param_count
from repro_torch.serving.engine import ServingEngine


def calibrate_env_from_engine(engine: ServingEngine, cfg_f: FCPOConfig,
                              seq: int = 32) -> EnvParams:
    """Measure the engine's (t0, t1) batching curve on this device and
    return EnvParams (0-dim tensors) matching it, so the MDP the agents
    learn on is this data plane's latency surface."""
    vocab = engine.model.cfg.vocab_size
    times = {}
    for bs in (1, max(engine.batch_buckets)):
        tokens = torch.zeros((bs, seq), dtype=torch.int32) % vocab
        engine.prefill(tokens)  # warm-up
        t0 = time.perf_counter()
        for _ in range(3):
            engine.prefill(tokens)
        times[bs] = (time.perf_counter() - t0) / 3
    b_lo, b_hi = sorted(times)
    t1 = max((times[b_hi] - times[b_lo]) / (b_hi - b_lo), 1e-5)
    t0_fixed = max(times[b_lo] - t1 * b_lo, 1e-4)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=engine.device)
    return EnvParams(t0=f(t0_fixed), t1=f(t1), pre_rate=f(400.0),
                     post_rate=f(500.0), contention=f(0.15),
                     queue_cap=f(128.0), slo_s=f(cfg_f.slo_s),
                     net_lat=f(0.01))


def main(argv=None, return_engine=False):
    """Run the launcher; returns a summary: per-episode fleet-mean
    ``reward``, ``effective_throughput``, ``latency`` (s), the served
    batch size ``bs`` and the ``generate_s`` wall time of each served
    batch, plus the calibrated ``t0``/``t1`` (s), the ``wall_s`` of the
    episode loop and the model's parameter count ``n_params``. With
    ``return_engine``, ``(summary, engine)``: the engine that served, for
    a caller that measures it further without building the model again."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--episodes", type=int, default=30)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--slo-ms", type=float, default=250.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.episodes < 1 or args.replicas < 1:
        ap.error("--episodes and --replicas must be >= 1")

    dev = resolve_device(args.device)
    # full float32 on the card, as on the CPU (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        build.build()          # kernel build is set-up, not serving time

    cfg = get_config(args.arch)
    decodes, why = shape_applicable(cfg, "decode_32k")
    if not decodes:
        ap.error(f"--arch {args.arch} cannot be served ({why})")
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    n_params = param_count(params)
    engine = ServingEngine(model, params, max_cache_len=256,
                           batch_buckets=(1, 2, 4, 8), seq_buckets=(16, 32))

    cfg_f = FCPOConfig(slo_s=args.slo_ms / 1000.0)
    fleet = fleet_init(cfg_f, args.replicas, args.seed, n_pods=args.pods,
                       device=dev, slo_s=cfg_f.slo_s)
    env_params = calibrate_env_from_engine(engine, cfg_f)
    fleet = fleet.replace(env_params=EnvParams(**{
        f.name: getattr(env_params, f.name).expand(args.replicas).clone()
        for f in dataclasses.fields(EnvParams)}))
    t0_s, t1_s = float(env_params.t0), float(env_params.t1)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name}{' (reduced)' if args.reduced else ''}: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {n_params:,} "
          f"parameters, {args.replicas} replicas, device={dev.type} "
          f"({name})")
    print(f"calibrated latency model: t0={t0_s * 1e3:.1f}ms "
          f"t1={t1_s * 1e6:.0f}us/item")

    trace_gen = torch.Generator()
    trace_gen.manual_seed(1)
    traces = fleet_traces(trace_gen, args.replicas,
                          args.episodes * cfg_f.n_steps, device=dev)
    hist = {k: [] for k in ("reward", "effective_throughput", "latency",
                            "bs", "generate_s")}
    wall0 = time.perf_counter()
    for e in range(args.episodes):
        rates = traces[:, e * cfg_f.n_steps:(e + 1) * cfg_f.n_steps]
        fleet, rollouts, metrics = fleet_episode(cfg_f, fleet, rates)
        if (e + 1) % cfg_f.fl_every == 0:
            fleet, _, _ = fl_round(cfg_f, fleet, rollouts)
        # serve one real batch at the fleet's current configuration
        vals = torch.stack([metrics[k].mean() for k in
                            ("reward", "effective_throughput", "latency")]
                           + [rollouts.actions[0, -1, 1].float()]).tolist()
        bs = min(cfg_f.bs_values[int(vals[3])], max(engine.batch_buckets))
        g0 = time.perf_counter()
        out = engine.generate(torch.zeros((bs, 16), dtype=torch.int32),
                              steps=2)
        gen_s = time.perf_counter() - g0
        for k, v in zip(hist, (*vals[:3], bs, gen_s)):
            hist[k].append(v)
        print(f"ep {e + 1:3d} reward {vals[0]:+.3f} eff_thr {vals[1]:6.1f} "
              f"lat {vals[2] * 1e3:6.1f}ms | served real batch bs={bs} -> "
              f"{tuple(out.shape)} in {gen_s * 1e3:.1f}ms", flush=True)
    wall = time.perf_counter() - wall0
    print("done")
    summary = {k: np.asarray(v) for k, v in hist.items()}
    summary.update(t0=np.asarray(t0_s), t1=np.asarray(t1_s),
                   wall_s=np.asarray(wall), n_params=np.asarray(n_params))
    return (summary, engine) if return_engine else summary


if __name__ == "__main__":
    main()
