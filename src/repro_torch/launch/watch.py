"""Live metrics watcher: tail the JSONL stream a fleet run writes.

Port of ``repro.launch.watch``. ``repro_torch.launch.train_fleet
--metrics-out run.jsonl`` streams one record per episode; this CLI reads
the same file — once, or continuously with ``--follow`` — and prints the
run header, a per-metric tail summary, the health and FL transport
digests and the scaling row. ``render`` is a pure function of the file,
so its text is the JAX watcher's on the same file. Torn last lines (the
writer may be mid-append) are tolerated by ``read_metrics``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.watch run.jsonl
  PYTHONPATH=src python -m repro_torch.launch.watch run.jsonl --follow \
      --interval 2 --alerts alerts.jsonl
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from repro_torch.eval.stream import (device_summary, fl_round_summary,
                               health_summary, read_metrics, tail_summary)
from repro_torch.health.alerts import read_alerts

WATCH_METRICS = ("reward", "throughput", "effective_throughput", "latency",
                 "loss", "gated", "fl_payload_bytes", "fl_missed",
                 "fl_stale_used", "health_reward_p50", "health_miss_p90",
                 "health_drift_score", "health_susp")


def render(path: str, tail_k: int, metrics=WATCH_METRICS,
           alerts_path=None, alerts_k: int = 5) -> str:
    """One status report for the metrics file — the string ``main`` prints.
    Pure function of the file contents so tests can diff it.

    Degrades instead of crashing on the live-file edge cases: a meta-only
    file (run killed before episode 0 landed) renders a "no records yet"
    line, and metric keys this watcher does not know (a newer writer, or
    non-numeric values) are skipped rather than garbling the table. The
    ``health_*`` rows and the health digest line appear only for runs that
    enabled the fleet health observatory (``train_fleet.py --health``) —
    a pre-health metrics file, or one whose early episodes predate the
    observatory, renders exactly as before. ``alerts_path`` appends the
    tail of an ALERTS.jsonl file (``--alerts-out``) when it exists."""
    meta, records = read_metrics(path)
    lines = []
    if meta:
        lines.append("run: " + "  ".join(
            f"{k}={meta[k]}" for k in sorted(meta)))
    if not records:
        lines.append("no records yet (run warming up, or killed before "
                     "episode 0) — retry with --follow")
        return "\n".join(lines)
    n_eps = sum(1 for r in records if "devices" not in r)
    lines.append(f"episodes recorded: {n_eps}")
    summary = tail_summary(records, k=tail_k)
    shown = [m for m in metrics if m in summary]
    if shown:
        lines.append(f"{'metric':24s}{'last':>12s}"
                     f"{f'tail[{tail_k}]':>12s}{'mean':>12s}")
        for m in shown:
            s = summary[m]
            lines.append(f"{m:24s}{s['last']:12.4f}"
                         f"{s['tail_mean']:12.4f}{s['mean']:12.4f}")
    health = health_summary(records)
    if health is not None:
        lines.append(
            f"health: {health['episodes']:.0f} episodes, "
            f"drift flags on {health['drift_flags']:.0f} "
            f"(score last {health['drift_score_last']:.2f}), "
            f"reward p50 {health['reward_p50_last']:.3f}, "
            f"miss p90 {health['miss_p90_mean']:.3f}, "
            f"susp last {health['susp_last']:.2f} "
            f"(max {health['susp_max']:.2f})")
    fl = fl_round_summary(records)
    if fl is not None:
        lines.append(f"FL: {fl['rounds']:.0f} rounds, "
                     f"{fl['payload_bytes'] / 1024:.1f} KB/round, "
                     f"uplink {fl['uplink_s'] * 1e3:.1f} ms, "
                     f"missed {fl['missed']:.2f}/round, "
                     f"stale joins {fl['stale_used']:.2f}/round, "
                     f"rejected {fl.get('rejected', 0.0):.2f}/round, "
                     f"clipped {fl.get('clipped', 0.0):.2f}/round")
    dev = device_summary(records)
    if dev is not None:
        lines.append(
            f"scaling: {dev.get('devices', 1):.0f} devices, "
            f"{dev.get('agents', 0):.0f} agents, "
            f"step {dev.get('step_time_s', 0.0) * 1e3:.1f} ms "
            f"({dev.get('step_time_per_agent_s', 0.0) * 1e6:.1f} us/agent), "
            f"state {dev.get('state_bytes_per_agent', 0.0) / 1024:.1f} "
            f"KB/agent")
        per_dev = [(k, v) for k, v in sorted(dev.items())
                   if k.startswith("dev") and k.endswith("_bytes")]
        if per_dev:
            lines.append("per-device state: " + "  ".join(
                f"{k[:-len('_bytes')]}={v / 1024:.0f}KB"
                for k, v in per_dev))
    if alerts_path is not None:
        alerts = read_alerts(alerts_path)  # missing/torn file -> []
        fired = [a for a in alerts if a.get("kind") == "alert"]
        lines.append(f"alerts: {len(fired)} fired")
        for a in alerts[-alerts_k:]:
            kind = "RESOLVED" if a.get("kind") == "resolve" else \
                a.get("severity", "warn").upper()
            lines.append(
                f"  [{kind:8s}] ep {a.get('episode', -1):>5} "
                f"{a.get('rule', '?')}: {a.get('metric', '?')} "
                f"{a.get('op', '?')} {a.get('threshold', 0.0):g} "
                f"(value {a.get('value', 0.0):.4g})")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="metrics JSONL file "
                                 "(train_fleet.py --metrics-out)")
    ap.add_argument("--tail", type=int, default=10,
                    help="episodes in the tail-mean window")
    ap.add_argument("--follow", action="store_true",
                    help="keep re-reading until interrupted (like tail -f)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="seconds between --follow refreshes")
    ap.add_argument("--alerts", default=None, metavar="ALERTS_JSONL",
                    help="also tail this alerts file "
                         "(train_fleet.py --alerts-out)")
    args = ap.parse_args(argv)
    if not os.path.exists(args.path):
        ap.error(f"no metrics file at {args.path}")

    try:
        print(render(args.path, args.tail, alerts_path=args.alerts))
        while args.follow:
            try:
                time.sleep(max(args.interval, 0.1))
            except KeyboardInterrupt:
                break
            print()
            print(render(args.path, args.tail, alerts_path=args.alerts))
    except BrokenPipeError:  # `watch ... | head` closing the pipe is fine
        sys.stderr.close()


if __name__ == "__main__":
    main()
