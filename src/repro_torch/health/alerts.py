"""Declarative alert rules over the metrics stream -> ``ALERTS.jsonl``.

Port of ``repro.health.alerts`` (host-only, so a copy). ``AlertEngine`` is
a duck-typed metrics sink (``append`` / ``close``, like
``eval.stream.MetricsSink``) that sits in front of the real sink: every
per-episode record passes through unchanged to the forwarded sink, and on
the way each ``AlertRule`` predicate is evaluated on the host. A rule that
holds for ``window`` consecutive records fires once (one ``{"kind":
"alert", ...}`` JSONL line) and stays latched until its predicate clears,
which writes a matching ``"resolve"`` line.

Rules are data: ``(name, metric, op, threshold, window, severity)``.
Records missing the rule's metric (files without health, device records)
do not advance the rule.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

ALERT_KIND = "alert"
RESOLVE_KIND = "resolve"
_OPS = ("gt", "lt")
_SEVERITIES = ("info", "warn", "crit")


@dataclass(frozen=True)
class AlertRule:
    """``metric op threshold`` sustained for ``window`` consecutive
    records fires the rule."""
    name: str
    metric: str
    op: str
    threshold: float
    window: int = 1
    severity: str = "warn"

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; expected {_OPS}")
        if self.severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"expected {_SEVERITIES}")
        if self.window < 1:
            raise ValueError("window must be >= 1")

    def holds(self, value: float) -> bool:
        return value > self.threshold if self.op == "gt" \
            else value < self.threshold


# The standing rulebook: a drift flag is an event worth one line the
# moment it happens; suspicion and SLO-miss need to *persist* before they
# page anyone; a reward collapse is the one that matters most and is the
# noisiest, hence the longest window.
DEFAULT_RULES: Tuple[AlertRule, ...] = (
    AlertRule("drift-detected", "health_drift_flag", "gt", 0.5, 1, "warn"),
    AlertRule("suspect-clients", "health_susp", "gt", 0.5, 2, "crit"),
    AlertRule("slo-miss-p90", "health_miss_p90", "gt", 0.9, 3, "warn"),
    AlertRule("reward-collapse", "health_reward_p50", "lt", -0.5, 4, "crit"),
)


class AlertEngine:
    """Tee sink: forwards every record downstream, evaluates the rulebook,
    appends fire/resolve lines to ``path``. Use in place of (or wrapping)
    a ``MetricsSink`` wherever the drivers take ``metrics_sink=``."""

    def __init__(self, path: str, rules: Tuple[AlertRule, ...] = DEFAULT_RULES,
                 forward: Optional[Any] = None):
        self.path = path
        self.rules = tuple(rules)
        self.forward = forward
        self._streak = {r.name: 0 for r in self.rules}
        self._active = {r.name: False for r in self.rules}
        self.n_alerts = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")

    def _emit(self, kind: str, rule: AlertRule, record: Dict[str, Any],
              value: float):
        self._f.write(json.dumps({
            "kind": kind, "rule": rule.name, "metric": rule.metric,
            "op": rule.op, "threshold": rule.threshold,
            "severity": rule.severity, "value": float(value),
            "episode": record.get("episode"),
        }, sort_keys=True, default=float) + "\n")
        self._f.flush()

    def append(self, record: Dict[str, Any]):
        if self.forward is not None:
            self.forward.append(record)
        num = lambda v: isinstance(v, (int, float)) \
            and not isinstance(v, bool)
        for rule in self.rules:
            value = record.get(rule.metric)
            if not num(value):
                continue  # record predates the metric, or isn't an episode
            if rule.holds(value):
                self._streak[rule.name] += 1
                if (self._streak[rule.name] >= rule.window
                        and not self._active[rule.name]):
                    self._active[rule.name] = True
                    self.n_alerts += 1
                    self._emit(ALERT_KIND, rule, record, value)
            else:
                self._streak[rule.name] = 0
                if self._active[rule.name]:
                    self._active[rule.name] = False
                    self._emit(RESOLVE_KIND, rule, record, value)

    @property
    def n_records(self):
        return getattr(self.forward, "n_records", 0)

    def close(self):
        if not self._f.closed:
            self._f.close()
        if self.forward is not None:
            self.forward.close()

    def __enter__(self) -> "AlertEngine":
        return self

    def __exit__(self, *exc):
        self.close()


def read_alerts(path: str) -> List[Dict[str, Any]]:
    """Parse an ALERTS.jsonl file; tolerates a torn live tail like
    ``eval.stream.read_metrics``. Missing file reads as no alerts."""
    if not os.path.exists(path):
        return []
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
