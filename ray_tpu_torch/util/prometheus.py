# Copied from ray_tpu/util/prometheus.py (JAX-free): module names read ray_tpu_torch.
"""Prometheus text-format 0.0.4 exposition.

Reference: src/ray/stats/metric.h + the reference's per-node metrics
agents exporting OpenCensus views to Prometheus. Here the head's
aggregated metric table (daemon `_h_metrics_summary`) is rendered
directly: counters and gauges become labeled series, histograms become
cumulative ``le`` bucket series with the mandatory ``+Inf`` bucket,
``_sum`` and ``_count``.

Renders FROM the wire shape `metrics_summary()` returns, so the same
function serves the dashboard's ``/metrics`` endpoint and the
``ray_tpu_torch metrics scrape`` CLI.

Series-emission rule (keeps PromQL ``sum()`` double-count-free):
``by_node`` present -> only per-node labeled series; else ``by_tags``
present -> one series per tag set (the empty tag set renders
unlabeled); else the single aggregate value.

Naming convention (enforced by lint rule RT009 for metrics declared in
the package): ``^[a-z][a-z0-9_]*$``, counters end in ``_total``,
label keys ``^[a-z][a-z0-9_]*$``. Dots/dashes in legacy user metric
names are sanitized to underscores at exposition time.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["render_prometheus", "METRIC_NAME_RE", "LABEL_KEY_RE"]

#: The documented naming convention (see README "Metrics export"):
#: lowercase snake_case names; counters additionally end in `_total`.
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
LABEL_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*$")

_INVALID_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize_name(name: str) -> str:
    safe = _INVALID_CHARS.sub("_", str(name))
    if not safe or not (safe[0].isalpha() or safe[0] in "_:"):
        safe = "_" + safe
    return safe


def _escape_help(text: str) -> str:
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _labels(pairs: Iterable[Tuple[str, str]]) -> str:
    rendered = ",".join(
        f'{_sanitize_name(k)}="{_escape_label_value(v)}"'
        for k, v in pairs
    )
    return "{" + rendered + "}" if rendered else ""


def _parse_tag_key(flat: str) -> List[Tuple[str, str]]:
    """Inverse of the head's ``"|".join(f"{k}={v}")`` tag flattening.
    Values may themselves contain ``=`` (only the first one splits);
    a ``|`` inside a value is not recoverable — documented limitation
    of the flat form."""
    if not flat:
        return []
    pairs = []
    for part in flat.split("|"):
        key, _, value = part.partition("=")
        pairs.append((key, value))
    return pairs


def _fmt(value) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(float(value))


def _bucket_pairs(buckets: Dict[str, float]) -> List[Tuple[str, float]]:
    """``{"le_0.005": 3, ..., "inf": 9}`` -> ordered cumulative
    ``(le-label, count)`` pairs ending at ``+Inf``. The head already
    accumulates cumulatively in boundary order; re-sort defensively by
    the numeric bound and enforce monotonicity so a malformed entry
    can never emit a decreasing series (which Prometheus rejects)."""
    numbered = []
    inf_count = None
    for key, count in buckets.items():
        if key == "inf":
            inf_count = float(count)
            continue
        if key.startswith("le_"):
            try:
                bound = float(key[3:])
            except ValueError:
                continue
            numbered.append((bound, float(count)))
    numbered.sort(key=lambda pair: pair[0])
    out: List[Tuple[str, float]] = []
    running = 0.0
    for bound, count in numbered:
        running = max(running, count)
        out.append((f"{bound:g}", running))
    if inf_count is not None:
        running = max(running, inf_count)
    out.append(("+Inf", running))
    return out


def _histogram_lines(
    safe: str, series: dict, base_labels: List[Tuple[str, str]]
) -> List[str]:
    count = float(series.get("count", 0) or 0)
    total = float(series.get("sum", 0.0) or 0.0)
    buckets = series.get("buckets") or {}
    pairs = _bucket_pairs(buckets) if buckets else [("+Inf", count)]
    # The +Inf bucket must equal _count; a reservoir-less entry (no
    # declared boundaries) still gets its mandatory +Inf series.
    if pairs and pairs[-1][0] == "+Inf":
        pairs[-1] = ("+Inf", max(pairs[-1][1], count))
    lines = []
    for le, cumulative in pairs:
        lines.append(
            f"{safe}_bucket"
            f"{_labels(base_labels + [('le', le)])} "
            f"{_fmt(cumulative)}"
        )
    lines.append(f"{safe}_sum{_labels(base_labels)} {_fmt(total)}")
    lines.append(
        f"{safe}_count{_labels(base_labels)} {_fmt(count)}"
    )
    return lines


def render_prometheus(metrics: Dict[str, dict]) -> str:
    """Render a `metrics_summary()` mapping as Prometheus text-format
    0.0.4 (the dashboard's ``/metrics`` payload)."""
    lines: List[str] = []
    for name in sorted(metrics):
        entry = metrics[name]
        kind = entry.get("kind")
        safe = _sanitize_name(name)
        if entry.get("description"):
            lines.append(
                f"# HELP {safe} {_escape_help(entry['description'])}"
            )
        if kind == "counter":
            lines.append(f"# TYPE {safe} counter")
            value_key = "total"
        elif kind == "gauge":
            lines.append(f"# TYPE {safe} gauge")
            value_key = "value"
        elif kind == "histogram":
            lines.append(f"# TYPE {safe} histogram")
            value_key = None
        else:
            lines.append(f"# TYPE {safe} untyped")
            value_key = "value"

        by_node = entry.get("by_node")
        by_tags = entry.get("by_tags")
        if by_node:
            # Core runtime metrics: ONLY per-node labeled series (the
            # reference exports per-node series through each node's
            # metrics agent). No unlabeled cluster line — it would
            # double-count under PromQL sum().
            for node, value in sorted(by_node.items()):
                lines.append(
                    f"{safe}{_labels([('node', node)])} {_fmt(value)}"
                )
            continue
        if kind == "histogram":
            series_list: List[Tuple[List[Tuple[str, str]], dict]]
            if by_tags:
                series_list = [
                    (_parse_tag_key(flat), series)
                    for flat, series in sorted(by_tags.items())
                ]
            else:
                series_list = [([], entry)]
            for base_labels, series in series_list:
                lines.extend(
                    _histogram_lines(safe, series, base_labels)
                )
            continue
        if by_tags:
            for flat, series in sorted(by_tags.items()):
                lines.append(
                    f"{safe}{_labels(_parse_tag_key(flat))} "
                    f"{_fmt(series.get(value_key, 0.0) or 0.0)}"
                )
        else:
            lines.append(
                f"{safe} {_fmt(entry.get(value_key, 0.0) or 0.0)}"
            )
    return "\n".join(lines) + "\n"
