"""Render per-site quantization-health tables from a telemetry JSONL log
(port of ``repro/telemetry/report.py``).

    PYTHONPATH=src python -m repro_torch.telemetry.report telemetry.jsonl
    PYTHONPATH=src python -m repro_torch.telemetry.report log.jsonl \
        --top 20 --json
    PYTHONPATH=src python -m repro_torch.telemetry.report log.jsonl --perf

Aggregates every step in the log per site and prints the sites sorted by
worst (max) clip rate — the at-a-glance answer to "which hindsight range
is about to hurt me".  ``--perf`` renders the performance half of the
stream instead: the per-phase step-time breakdown (data / compile /
execute / telemetry / checkpoint), throughput, and the slowest steps —
the at-a-glance answer to "where does the step time go".
"""
from __future__ import annotations

import argparse
import json
import statistics

from .sinks import MemorySink, read_jsonl_full, read_jsonl_records

_COLS = ("steps", "clip_rate_mean", "clip_rate_max", "sqnr_db_mean",
         "util_mean", "drift_max", "streak_max")
_HDR = ("site", "steps", "clip%mean", "clip%max", "SQNR dB", "util",
        "driftmax", "streak")


def summarize(path: str, with_events: bool = False):
    sink = MemorySink()
    for step, records, events in read_jsonl_full(path):
        sink.write(step, records, events)
    if with_events:
        return sink.summary(), sink.events
    return sink.summary()


def render_events(events, top=None) -> str:
    """Table of explicit guard-trigger events (newest last)."""
    if not events:
        return "no guard events"
    rows = events[-top:] if top else events
    lines = [f"guard events ({len(events)} total):"]
    for ev in rows:
        old = "[{:+.4g}, {:+.4g}]".format(*ev.get("old", [0, 0]))
        new = "[{:+.4g}, {:+.4g}]".format(*ev.get("new", [0, 0]))
        lines.append(f"  step {ev['step']:5d} {ev['action']:<15} "
                     f"{ev['site']}  {old} -> {new} "
                     f"(clip {100 * ev.get('clip_rate', 0):.2f}%)")
    return "\n".join(lines)


def summarize_perf(path: str):
    """Aggregate the ``"perf"`` records of a JSONL log.

    Returns ``None`` when the log has no perf records (pre-v2 logs or
    runs without a :class:`~repro_torch.telemetry.trace.StepTimer`);
    otherwise a dict with per-phase aggregates, step-time percentiles,
    throughput and the per-step records (for the slowest-steps table).
    """
    perfs = [dict(rec["perf"], step=rec["step"])
             for rec in read_jsonl_records(path) if rec.get("perf")]
    if not perfs:
        return None
    times = [p["step_time_ms"] for p in perfs]
    phases = {}
    for p in perfs:
        for name, ms in p.get("phases_ms", {}).items():
            phases.setdefault(name, []).append(ms)
    total = sum(times)
    phase_summary = {
        name: {
            "steps": len(ms),
            "mean_ms": statistics.mean(ms),
            "max_ms": max(ms),
            "total_ms": sum(ms),
            "share": sum(ms) / total if total else 0.0,
        }
        for name, ms in phases.items()
    }
    thr = [p["throughput"] for p in perfs if "throughput" in p]
    out = {
        "steps": len(perfs),
        "step_ms_mean": statistics.mean(times),
        "step_ms_p50": statistics.median(times),
        "step_ms_max": max(times),
        "compile_count": max(p.get("compile_count", 0) for p in perfs),
        "phases": phase_summary,
        "records": perfs,
    }
    if thr:
        out["throughput_mean"] = statistics.mean(thr)
        out["throughput_unit"] = next(
            (p.get("throughput_unit") for p in perfs
             if p.get("throughput_unit")), "items/s")
    return out


def render_perf(perf, slowest: int = 5) -> str:
    """Per-phase table + slowest-steps table from :func:`summarize_perf`."""
    lines = [f"perf: {perf['steps']} steps, "
             f"step {perf['step_ms_p50']:.1f} ms p50 / "
             f"{perf['step_ms_mean']:.1f} ms mean / "
             f"{perf['step_ms_max']:.1f} ms max, "
             f"{perf['compile_count']} compile(s)"]
    if "throughput_mean" in perf:
        lines[0] += (f", {perf['throughput_mean']:.1f} "
                     f"{perf['throughput_unit']} mean")
    hdr = ["phase".ljust(12)] + [h.rjust(10) for h in
                                 ("steps", "mean_ms", "max_ms", "share%")]
    lines.append(" ".join(hdr))
    lines.append("-" * len(lines[-1]))
    order = sorted(perf["phases"].items(), key=lambda kv: -kv[1]["total_ms"])
    for name, s in order:
        lines.append(" ".join([
            name.ljust(12),
            f"{s['steps']:10d}",
            f"{s['mean_ms']:10.2f}",
            f"{s['max_ms']:10.2f}",
            f"{100 * s['share']:10.1f}",
        ]))
    if slowest:
        rows = sorted(perf["records"], key=lambda p: -p["step_time_ms"])
        lines.append("")
        lines.append(f"slowest {min(slowest, len(rows))} steps:")
        for p in rows[:slowest]:
            ph = p.get("phases_ms", {})
            dom = max(ph, key=ph.get) if ph else "?"
            lines.append(f"  step {p['step']:6d} {p['step_time_ms']:10.2f} ms"
                         f"  dominant phase: {dom} "
                         f"({ph.get(dom, 0.0):.2f} ms)")
    return "\n".join(lines)


def render(summary, top=None, sort_key="clip_rate_max") -> str:
    rows = sorted(summary.items(), key=lambda kv: -kv[1].get(sort_key, 0.0))
    if top:
        rows = rows[:top]
    name_w = max([len("site")] + [len(n) for n, _ in rows])
    lines = [" ".join([_HDR[0].ljust(name_w)]
                      + [h.rjust(9) for h in _HDR[1:]])]
    lines.append("-" * len(lines[0]))
    for name, s in rows:
        lines.append(" ".join([
            name.ljust(name_w),
            f"{int(s['steps']):9d}",
            f"{100 * s['clip_rate_mean']:9.3f}",
            f"{100 * s['clip_rate_max']:9.3f}",
            f"{s['sqnr_db_mean']:9.1f}",
            f"{s['util_mean']:9.3f}",
            f"{s['drift_max']:9.3f}",
            f"{int(s['streak_max']):9d}",
        ]))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Per-site quantization health from a telemetry JSONL log")
    ap.add_argument("log", help="telemetry JSONL file")
    ap.add_argument("--top", type=int, default=0,
                    help="only show the N worst sites")
    ap.add_argument("--sort", default="clip_rate_max", choices=_COLS,
                    help="column to sort (descending) by")
    ap.add_argument("--json", action="store_true",
                    help="emit the aggregated summary as JSON instead")
    ap.add_argument("--events", type=int, default=10, metavar="N",
                    help="show the last N explicit guard-trigger events "
                         "(0 = hide)")
    ap.add_argument("--perf", action="store_true",
                    help="render the per-phase step-time breakdown from "
                         "the log's 'perf' records instead of the "
                         "quantization-health tables")
    ap.add_argument("--slowest", type=int, default=5, metavar="N",
                    help="with --perf: list the N slowest steps")
    args = ap.parse_args(argv)

    if args.perf:
        try:
            perf = summarize_perf(args.log)
        except OSError as e:
            ap.error(f"cannot read {args.log}: {e}")
        if perf is None:
            print(f"[report] no perf records in {args.log} (run the "
                  f"trainer with --trace / a StepTimer to produce them)")
            return None
        if args.json:
            payload = {k: v for k, v in perf.items() if k != "records"}
            print(json.dumps(payload, indent=2, sort_keys=True))
        else:
            print(render_perf(perf, slowest=args.slowest))
        return perf

    try:
        summary, events = summarize(args.log, with_events=True)
    except OSError as e:
        ap.error(f"cannot read {args.log}: {e}")
    if not summary:
        print(f"[report] no telemetry records in {args.log}")
        return summary
    if args.json:
        print(json.dumps({"sites": summary, "events": events},
                         indent=2, sort_keys=True))
    else:
        print(render(summary, top=args.top or None, sort_key=args.sort))
        if args.events:
            print()
            print(render_events(events, top=args.events))
    return summary


if __name__ == "__main__":
    main()
