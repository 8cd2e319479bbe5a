"""Metric exporters: Prometheus text exposition + JSON snapshots (the
port's copy of ``repro.obs.export``, byte for byte the same text).

``prometheus_text(registry)`` renders every registered metric in the
Prometheus text exposition format (counters get the conventional
``_total`` suffix; histograms expose cumulative ``_bucket{le=...}``
series plus ``_sum``/``_count``).  ``validate_prometheus_text`` is a
strict parser used by tests and the CI smoke step -- it checks line
syntax, bucket monotonicity, and that every histogram's ``+Inf`` bucket
equals its ``_count``.
"""

from __future__ import annotations

import json
import re

from repro_torch.obs.metrics import Counter, Gauge, Histogram, bucket_hi

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(\{[^{}]*\})?"                        # optional label set
    r" ([-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$")
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')


def sanitize(name: str) -> str:
    """Dotted metric name -> valid Prometheus name."""
    out = _NAME_RE.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


def _labels_str(labels: dict[str, str], extra: dict[str, str] | None = None
                ) -> str:
    pairs = {**labels, **(extra or {})}
    if not pairs:
        return ""
    body = ",".join(f'{sanitize(k)}="{v}"'
                    for k, v in sorted(pairs.items()))
    return "{" + body + "}"


def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        return repr(v)
    return str(v)


def prometheus_text(registry) -> str:
    """Render the registry in Prometheus text exposition format."""
    groups: dict[str, list] = {}
    kinds: dict[str, str] = {}
    for m in registry.metrics():
        base = sanitize(m.name)
        if isinstance(m, Counter):
            base, kind = base + "_total", "counter"
        elif isinstance(m, Gauge):
            kind = "gauge"
        else:
            kind = "histogram"
        if kinds.setdefault(base, kind) != kind:
            raise ValueError(f"metric name {base!r} maps to both "
                             f"{kinds[base]} and {kind}")
        groups.setdefault(base, []).append(m)
    lines = []
    for base in sorted(groups):
        help_text = next((m.help for m in groups[base] if m.help), "")
        if help_text:
            lines.append(f"# HELP {base} "
                         + help_text.replace("\\", r"\\").replace("\n",
                                                                  r"\n"))
        lines.append(f"# TYPE {base} {kinds[base]}")
        for m in sorted(groups[base],
                        key=lambda m: sorted(m.labels.items())):
            if isinstance(m, Histogram):
                counts, count, total = m.snapshot()
                cum = 0
                for i in sorted(counts):
                    cum += counts[i]
                    lines.append(
                        f"{base}_bucket"
                        f"{_labels_str(m.labels, {'le': _fmt(bucket_hi(i))})}"
                        f" {cum}")
                lines.append(
                    f"{base}_bucket{_labels_str(m.labels, {'le': '+Inf'})}"
                    f" {count}")
                lines.append(
                    f"{base}_sum{_labels_str(m.labels)} {_fmt(total)}")
                lines.append(
                    f"{base}_count{_labels_str(m.labels)} {count}")
            else:
                lines.append(
                    f"{base}{_labels_str(m.labels)} {_fmt(m.value)}")
    return "\n".join(lines) + "\n"


def validate_prometheus_text(text: str) -> int:
    """Parse ``text`` strictly; returns the sample count.  Raises
    ``ValueError`` on any malformed line, non-monotonic histogram
    buckets, or a ``+Inf`` bucket that disagrees with ``_count``."""
    samples = 0
    series: dict[tuple, float] = {}
    buckets: dict[tuple, list[tuple[float, float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, labelstr, value = m.group(1), m.group(2), float(m.group(3))
        labels = {}
        if labelstr:
            for part in labelstr[1:-1].split(","):
                if not _LABEL_RE.match(part):
                    raise ValueError(
                        f"line {lineno}: malformed label {part!r}")
                k, v = part.split("=", 1)
                labels[k] = v[1:-1]
        samples += 1
        le = labels.pop("le", None)
        key = (name, tuple(sorted(labels.items())))
        if le is not None and name.endswith("_bucket"):
            buckets.setdefault(key, []).append((float(le), value))
        else:
            series[key] = value
    for (name, labels), rows in buckets.items():
        cum = [v for _, v in rows]     # exposition order
        if any(b < a for a, b in zip(cum, cum[1:])):
            raise ValueError(f"{name}{dict(labels)}: non-monotonic buckets")
        count_key = (name[:-len("_bucket")] + "_count", labels)
        if count_key not in series:
            raise ValueError(f"{name}{dict(labels)}: missing _count")
        if rows[-1][0] != float("inf") or rows[-1][1] != series[count_key]:
            raise ValueError(
                f"{name}{dict(labels)}: +Inf bucket != _count")
    return samples


def metrics_json(registry) -> dict:
    """JSON-ready snapshot (same data the Prometheus text carries, plus
    histogram percentile estimates)."""
    return registry.snapshot()


def write_metrics(registry, path: str):
    """Write the JSON snapshot to ``path``."""
    with open(path, "w") as f:
        json.dump(metrics_json(registry), f, indent=1, sort_keys=True)
        f.write("\n")


def write_prometheus(registry, path: str):
    """Write the Prometheus text exposition to ``path``."""
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
