"""Streaming metrics: a JSONL sink for live fleet observability.

Port of ``repro.eval.stream`` (no JAX in it, so a copy). ``MetricsSink`` is
the tap both fleet drivers accept (``train_fleet_scan(...,
metrics_sink=...)`` / ``train_fleet_reference(..., metrics_sink=...)``):
one JSON line per episode — reward, throughput, the FL transport metrics,
the health summaries, everything in the run history. The reference driver
appends each record as its episode ends; the graph driver copies each
episode's history row to pinned host memory behind the replays and writes
the record once the copy has landed, a few episodes behind the device at
most, and every record before the run returns.

File format: line 1 is a ``{"kind": "meta", ...}`` header (run shape,
backend, scenario — whatever the writer stamps); every further line is
``{"episode": int, "<metric>": float, ...}`` with sorted keys.
``launch/watch.py`` is the reader CLI; ``read_metrics`` / ``tail_summary``
are the library surface it (and the tests) share.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

META_KIND = "meta"


class MetricsSink:
    """Append-only JSONL metrics writer. Records are flushed per line so a
    reader (``launch/watch.py --follow``) sees them while the run is live.
    Usable as a context manager; ``append`` after ``close`` raises.

    ``resume=True`` continues an existing file instead of truncating it —
    the checkpoint auto-resume path (``train_fleet.py --ckpt-dir``) relies
    on this to keep the episodes recorded before a kill. The existing meta
    header is validated against ``meta``: every key both sides share must
    agree (a resumed run with a different shape/seed would silently splice
    incomparable records), and the header must exist and parse. A missing
    file resumes as a fresh write."""

    def __init__(self, path: str, meta: Optional[Dict[str, Any]] = None,
                 resume: bool = False):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        header = {"kind": META_KIND}
        header.update(meta or {})
        if resume and os.path.exists(path):
            old_meta, records = read_metrics(path)
            if not old_meta:
                raise ValueError(
                    f"cannot resume metrics file {path}: no parseable "
                    f"{META_KIND} header on line 1")
            for k in set(old_meta) & set(meta or {}):
                if old_meta[k] != (meta or {})[k]:
                    raise ValueError(
                        f"cannot resume metrics file {path}: meta mismatch "
                        f"on {k!r} (file has {old_meta[k]!r}, run has "
                        f"{(meta or {})[k]!r})")
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(size - 1, 0))
                torn_tail = size > 0 and f.read(1) != b"\n"
            self._f = open(path, "a")
            if torn_tail:
                # a kill mid-append left a partial line with no newline;
                # without this the next record would merge into it and BOTH
                # lines would be lost to the reader
                self._f.write("\n")
            self.n_records = len(records)
        else:
            self._f = open(path, "w")
            self.n_records = 0
            self._write(header)

    def _write(self, obj: Dict[str, Any]):
        self._f.write(json.dumps(obj, sort_keys=True, default=float) + "\n")
        self._f.flush()

    def append(self, record: Dict[str, Any]):
        """One per-episode record: plain scalars only (the fleet drivers
        pass ``{"episode": int, **metric_floats}``)."""
        self._write(record)
        self.n_records += 1

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Parse a metrics JSONL file -> (meta, records). Tolerates a torn last
    line (the writer may be mid-append) by dropping it."""
    meta: Dict[str, Any] = {}
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a live file
            if i == 0 and obj.get("kind") == META_KIND:
                meta = {k: v for k, v in obj.items() if k != "kind"}
            else:
                records.append(obj)
    return meta, records


def tail_summary(records: List[Dict[str, Any]], k: int = 10
                 ) -> Dict[str, Dict[str, float]]:
    """Per-metric {"last": newest value, "tail_mean": mean over the last k
    records, "mean": run mean} for every numeric key except ``episode``."""
    out: Dict[str, Dict[str, float]] = {}
    if not records:
        return out
    num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
    # keys from ANY record that held a numeric value (first-seen order): a
    # garbled newest record must not hide a metric the run has been logging
    keys, seen = [], set()
    for r in records:
        for key, v in r.items():
            if key != "episode" and key not in seen and num(v):
                seen.add(key)
                keys.append(key)
    tail = records[-k:]
    for key in keys:
        # a newer writer may emit non-numeric values for a key an older
        # record held as a float (or vice versa) — skip those, never crash
        vals = [r[key] for r in records if num(r.get(key))]
        tvals = [r[key] for r in tail if num(r.get(key))]
        if not vals:
            continue
        out[key] = {"last": float(vals[-1]),
                    "tail_mean": float(sum(tvals) / max(len(tvals), 1)),
                    "mean": float(sum(vals) / max(len(vals), 1))}
    return out


def device_summary(records: List[Dict[str, Any]]
                   ) -> Optional[Dict[str, float]]:
    """Scaling digest from the trailing device records the launcher appends
    (``train_fleet.py --metrics-out`` with a mesh): mesh size, per-agent
    step time, stored-state bytes per agent, and one ``dev<i>_bytes`` row
    per device showing where the fleet pytree actually landed. Same JSONL
    protocol as every other record — a device record is just an episode-less
    line carrying a ``devices`` key. None when the run wrote none (yet)."""
    rows = [r for r in records if "devices" in r]
    if not rows:
        return None
    last = rows[-1]
    num = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
    out = {k: float(v) for k, v in last.items() if num(v)}
    out["rows"] = float(len(rows))
    return out


def health_summary(records: List[Dict[str, Any]]) -> Optional[Dict[str, float]]:
    """Fleet-health digest over the episodes that carried health metrics
    (``health_*`` keys exist only when the run enabled the observatory, so
    mixed pre-/post-PR-10 files reduce to the episodes that have them).
    None when no record holds any health key (yet)."""
    rows = [r for r in records if "health_drift_score" in r]
    if not rows:
        return None
    mean = lambda key: float(sum(r.get(key, 0.0) for r in rows) / len(rows))
    last = rows[-1]
    return {
        "episodes": float(len(rows)),
        "drift_flags": float(sum(r.get("health_drift_flag", 0.0) > 0.0
                                 for r in rows)),
        "drift_score_last": float(last.get("health_drift_score", 0.0)),
        "susp_last": float(last.get("health_susp", 0.0)),
        "susp_max": float(max(r.get("health_susp", 0.0) for r in rows)),
        "reward_p50_last": float(last.get("health_reward_p50", 0.0)),
        "miss_p90_mean": mean("health_miss_p90"),
        "act_entropy_last": float(last.get("health_act_entropy", 0.0)),
    }


def fl_round_summary(records: List[Dict[str, Any]]) -> Optional[Dict[str, float]]:
    """FL transport digest over the episodes that actually held a round
    (``fl_payload_bytes > 0``); None when the run had no rounds (yet)."""
    rounds = [r for r in records if r.get("fl_payload_bytes", 0.0) > 0.0]
    if not rounds:
        return None
    mean = lambda key: float(sum(r.get(key, 0.0) for r in rounds) / len(rounds))
    return {
        "rounds": float(len(rounds)),
        "payload_bytes": mean("fl_payload_bytes"),
        "uplink_s": mean("fl_uplink_s"),
        "missed": mean("fl_missed"),
        "stale_used": mean("fl_stale_used"),
        "rejected": mean("fl_rejected"),
        "clipped": mean("fl_clipped"),
    }
