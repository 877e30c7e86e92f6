"""Profiling / tracing helpers (aux-subsystem parity, SURVEY.md §5).

The reference's only instrumentation is two atomic counters
(metric_distance_computations / metric_hops, hnswlib/hnswalg.h:65-66) and
unconditional debug prints. Here:
- per-query hop/distance counters ride in the traversal loop state
  (SearchParams(collect_metrics=True) -> index.last_metrics), and
- `trace()` wraps jax.profiler for full device timelines, with a parser for
  the per-op summary used to drive this framework's own optimization.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace: `with trace('/tmp/tr'): run(); ...` then
    `op_summary('/tmp/tr')`."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


def op_summary(log_dir: str, top: int = 20) -> list[tuple[str, float, int]]:
    """Parse the newest trace in log_dir → [(op_name, total_ms, count)],
    device events only, sorted by total time."""
    files = sorted(
        glob.glob(os.path.join(log_dir, "plugins/profile/*/*.trace.json.gz"))
    )
    if not files:
        return []
    with gzip.open(files[-1]) as f:
        t = json.load(f)
    events = t.get("traceEvents", [])
    pids = {
        e["pid"]: e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    dev = {p for p, n in pids.items() if "GPU" in n}
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev:
            agg[e["name"]] += e.get("dur", 0)
            cnt[e["name"]] += 1
    return [(n, d / 1e3, cnt[n]) for n, d in agg.most_common(top)]
