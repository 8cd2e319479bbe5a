"""Stall-attribution report: turn a trace into "where did the tail go".

    PYTHONPATH=src python -m repro_torch.obs.report trace.json [--json] [--top N]

Reads a Chrome/Perfetto ``trace_event`` JSON file (written by
``Tracer.export`` / ``python -m repro_torch.launch.ycsb --trace-out``)
and prints:

* per-span-name aggregates (count, total ms, max ms, share of wall);
* a **stall breakdown**: every ``write_stall`` span is attributed to
  its recorded cause (e.g. ``imm_queue_full``) *and* to the background
  span with the largest time overlap (flush build, install, a
  compaction launch, ...) -- "no stall should be unexplained" is the
  point: a p99 spike either lines up with a named background span or
  shows up here as ``none-active`` (cold start, jit compile, OS noise).

The launch spans' child phases (``compact.crc_verify``,
``compact.merge_phase2``, ``compact.format``) are measured, not modelled:
their args name the clock (``"clock": "cuda_event"`` on the card,
``"host"`` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys

# span-name prefixes considered "background work" for stall attribution
BG_PREFIXES = ("flush.", "compact", "memtable.rotate")


def load_events(path: str) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") in ("X", "C", "i")]


def spans(events: list[dict]) -> list[dict]:
    return [e for e in events if e.get("ph") == "X"]


def aggregate(events: list[dict]) -> list[dict]:
    """Per-name span aggregates sorted by total duration desc."""
    xs = spans(events)
    if not xs:
        return []
    wall_us = max(e["ts"] + e.get("dur", 0.0) for e in xs) - \
        min(e["ts"] for e in xs)
    agg: dict[str, dict] = {}
    for e in xs:
        row = agg.setdefault(e["name"], {"name": e["name"], "count": 0,
                                         "total_ms": 0.0, "max_ms": 0.0})
        dur_ms = e.get("dur", 0.0) / 1000.0
        row["count"] += 1
        row["total_ms"] += dur_ms
        row["max_ms"] = max(row["max_ms"], dur_ms)
    for row in agg.values():
        row["wall_share"] = (row["total_ms"] * 1000.0) / max(wall_us, 1e-9)
    return sorted(agg.values(), key=lambda r: -r["total_ms"])


def stall_breakdown(events: list[dict]) -> list[dict]:
    """One row per (cause, culprit): total stalled ms, count, max ms.

    ``cause`` is the stall span's recorded ``args.cause``; ``culprit``
    is the concurrently-running background span name with the largest
    overlap (``none-active`` when nothing background overlapped -- the
    stall was spent waiting on something untraced)."""
    xs = spans(events)
    stalls = [e for e in xs if e["name"] == "write_stall"]
    bg = [e for e in xs if e["name"].startswith(BG_PREFIXES)]
    rows: dict[tuple[str, str], dict] = {}
    for s in stalls:
        s0, s1 = s["ts"], s["ts"] + s.get("dur", 0.0)
        best, best_ov = "none-active", 0.0
        for b in bg:
            ov = min(s1, b["ts"] + b.get("dur", 0.0)) - max(s0, b["ts"])
            if ov > best_ov:
                best_ov, best = ov, b["name"]
        cause = (s.get("args") or {}).get("cause", "unknown")
        row = rows.setdefault((cause, best), {
            "cause": cause, "culprit": best, "count": 0,
            "total_ms": 0.0, "max_ms": 0.0})
        dur_ms = (s1 - s0) / 1000.0
        row["count"] += 1
        row["total_ms"] += dur_ms
        row["max_ms"] = max(row["max_ms"], dur_ms)
    return sorted(rows.values(), key=lambda r: -r["total_ms"])


def counter_summary(events: list[dict]) -> list[dict]:
    """Per-counter-track min/max/last (queue depths, compaction debt)."""
    tracks: dict[str, dict] = {}
    for e in events:
        if e.get("ph") != "C":
            continue
        v = float((e.get("args") or {}).get("value", 0))
        row = tracks.setdefault(e["name"], {"name": e["name"], "samples": 0,
                                            "min": v, "max": v, "last": v})
        row["samples"] += 1
        row["min"] = min(row["min"], v)
        row["max"] = max(row["max"], v)
        row["last"] = v
    return sorted(tracks.values(), key=lambda r: r["name"])


def report(path: str) -> dict:
    events = load_events(path)
    return {
        "spans": aggregate(events),
        "stalls": stall_breakdown(events),
        "counters": counter_summary(events),
        "n_events": len(events),
    }


def _print_report(rep: dict, top: int):
    print(f"{rep['n_events']} events")
    print(f"\n{'span':<28} {'count':>7} {'total ms':>10} {'max ms':>9} "
          f"{'wall%':>6}")
    for row in rep["spans"][:top]:
        print(f"{row['name']:<28} {row['count']:>7} "
              f"{row['total_ms']:>10.2f} {row['max_ms']:>9.2f} "
              f"{100 * row['wall_share']:>5.1f}%")
    if rep["stalls"]:
        print(f"\nstall attribution ({sum(r['count'] for r in rep['stalls'])}"
              f" stalls, "
              f"{sum(r['total_ms'] for r in rep['stalls']):.2f} ms total):")
        print(f"{'cause':<18} {'culprit':<24} {'count':>6} "
              f"{'total ms':>10} {'max ms':>9}")
        for row in rep["stalls"]:
            print(f"{row['cause']:<18} {row['culprit']:<24} "
                  f"{row['count']:>6} {row['total_ms']:>10.2f} "
                  f"{row['max_ms']:>9.2f}")
    else:
        print("\nno write_stall spans: nothing blocked the write path")
    if rep["counters"]:
        print(f"\n{'counter track':<32} {'samples':>8} {'min':>8} "
              f"{'max':>8} {'last':>8}")
        for row in rep["counters"]:
            print(f"{row['name']:<32} {row['samples']:>8} "
                  f"{row['min']:>8.1f} {row['max']:>8.1f} "
                  f"{row['last']:>8.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="trace_event JSON (Tracer.export output)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of tables")
    ap.add_argument("--top", type=int, default=20,
                    help="span rows to print (default 20)")
    args = ap.parse_args(argv)
    rep = report(args.trace)
    if args.json:
        json.dump(rep, sys.stdout, indent=1)
        print()
    else:
        _print_report(rep, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
