"""Reduce a jax.profiler trace to device busy time, idle share and gaps.

Usage: python scripts/trace_summary.py TRACE_DIR [top_n]

Reads the newest ``*.xplane.pb`` under TRACE_DIR (what
``jax.profiler.trace(TRACE_DIR)`` writes) and, over the device planes,
prints one JSON object: the window from the first kernel start to the
last kernel end, the busy time (union of kernel intervals), the idle
share (1 - busy / window), the number and median of the gaps between
kernels, and the top kernels by total device time.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from collections import Counter

# per-op and per-module summary lines repeat the kernels' time
_SUMMARY_LINES = ("XLA Ops", "XLA Modules", "Source code",
                  "Framework Ops", "Framework Name Scope", "Steps")


def newest_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def _family(name: str) -> str:
    return re.sub(r"[._]?\d+$", "", name.split("/")[-1])


def summarize(trace_dir: str, device_prefix: str = "/device:GPU",
              top_n: int = 12) -> dict:
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(newest_xplane(trace_dir))
    intervals, dur_by, cnt_by = [], Counter(), Counter()
    lines = Counter()
    for plane in pd.planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines[f"{plane.name} | {line.name}"] += len(events)
            if line.name in _SUMMARY_LINES:
                continue
            for ev in events:
                intervals.append((ev.start_ns, ev.end_ns))
                dur_by[_family(ev.name)] += ev.duration_ns
                cnt_by[_family(ev.name)] += 1
    if not intervals:
        return {"device_events": 0, "lines": dict(lines)}
    intervals.sort()
    busy, gaps = 0, []
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append(s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = cur_e - intervals[0][0]
    gaps.sort()
    return {
        "device_events": len(intervals),
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "gaps": len(gaps),
        "median_gap_us": gaps[len(gaps) // 2] / 1e3 if gaps else 0.0,
        "lines": dict(lines),
        "top_kernels": [
            {"name": k, "ms": d / 1e6, "count": cnt_by[k]}
            for k, d in dur_by.most_common(top_n)],
    }


if __name__ == "__main__":
    top = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    print(json.dumps(summarize(sys.argv[1], top_n=top), indent=1))
