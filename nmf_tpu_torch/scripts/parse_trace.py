#!/usr/bin/env python
"""Aggregate per-op device times from a torch.profiler Chrome trace.

    python -m nmf_tpu_torch.scripts.parse_trace /tmp/trace [--top 40] \
        [--group] [--steps 1]

Port of ``nmf_tpu/scripts/parse_xplane.py`` (which reads a
``jax.profiler`` xplane). /tmp/trace is a directory holding traces
written by ``prof.export_chrome_trace`` (``profile_step.py --trace DIR``
writes one a profiled window). The newest ``*.json`` (or ``*.json.gz``)
under it is read; the durations of its device events (the card's
kernels, with memcpy and memset as ops of their own) are summed by name,
and the top ops are printed (with ``--group``, also totals grouped by
name prefix, nmf_tpu's regex), each total divided by ``--steps``.
"""
import argparse
import collections
import gzip
import json
import re
import sys
from pathlib import Path

# the Chrome trace's categories of events that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def newest_trace(trace_dir: Path) -> Path:
    traces = sorted((p for pattern in ("*.json", "*.json.gz")
                     for p in Path(trace_dir).rglob(pattern)),
                    key=lambda p: p.stat().st_mtime)
    if not traces:
        raise FileNotFoundError(f"no *.json trace under {trace_dir}")
    return traces[-1]


def load_trace(path: Path) -> list:
    """The trace's events (the ``traceEvents`` list)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def device_op_times(events) -> collections.Counter:
    """{op name: total ms} over the complete ("X") events that ran on the
    card."""
    totals = collections.Counter()
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            totals[ev["name"]] += float(ev.get("dur", 0.0)) / 1e3  # us
    return totals


GROUP_RE = re.compile(r"^(.*?)(?:\.\d+)?$")


def group_name(name: str) -> str:
    """fusion.123 -> fusion; loop_add_fusion.5 -> loop_add_fusion."""
    return GROUP_RE.match(name).group(1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir", type=Path)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--group", action="store_true",
                    help="also print totals grouped by op-name prefix")
    ap.add_argument("--steps", type=int, default=1,
                    help="divide totals by this many profiled steps")
    args = ap.parse_args(argv)

    events = load_trace(newest_trace(args.trace_dir))
    totals = device_op_times(events)
    if not totals:
        cats = collections.Counter(ev.get("cat") for ev in events
                                   if ev.get("ph") == "X")
        print(f"no device events found; event categories: {dict(cats)}",
              file=sys.stderr)
        return 1
    total = sum(totals.values()) / args.steps
    print(f"total device time: {total:.2f} ms over {len(totals)} ops")
    print(f"{'ms':>9}  {'%':>5}  op")
    for name, ms in totals.most_common(args.top):
        ms /= args.steps
        print(f"{ms:9.3f}  {100 * ms / total:5.1f}  {name[:110]}")
    if args.group:
        grouped = collections.Counter()
        for name, ms in totals.items():
            grouped[group_name(name)] += ms / args.steps
        print("\ngrouped:")
        for name, ms in grouped.most_common(args.top):
            print(f"{ms:9.3f}  {100 * ms / total:5.1f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
