"""One profiler trace of the headline solve, reduced to its top device ops.

Runs the medium-config solve of one engine (default: bench.py's), warms it
up, traces one more solve with ``jax.profiler``, and prints one JSON line:
the device busy share of the traced window and the ten device ops with the
most total device time.  The raw trace stays under ``--out``.

    python experiments/trace_headline.py [--engine tt] [--out chiprun_out/trace]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_op_times(xspace_path: str):
    """Per-op device time from the device planes of one trace.

    Device planes carry several lines over the same work (modules, ops,
    streams).  Ops are read from the "XLA Ops" lines where present, else
    from every line; busy time is the union of those events' intervals.
    Returns (per-op total ns, busy ns, window ns, ns per line name)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xspace_path)
    lines = []
    for plane in data.planes:
        if plane.name.startswith("/device:"):
            lines.extend(plane.lines)
    per_line = defaultdict(int)
    for line in lines:
        for ev in line.events:
            per_line[line.name] += int(ev.duration_ns)
    chosen = [ln for ln in lines if ln.name == "XLA Ops"] or lines
    per_op = defaultdict(int)
    intervals = []
    for line in chosen:
        for ev in line.events:
            per_op[ev.name] += int(ev.duration_ns)
            start = int(ev.start_ns)
            intervals.append((start, start + int(ev.duration_ns)))
    busy = window = 0
    if intervals:
        intervals.sort()
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in intervals) - intervals[0][0]
    return dict(per_op), busy, window, dict(per_line)


def main() -> int:
    import bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default=bench.DEFAULT_ENGINE)
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args()

    import jax

    from tpu3drecon.benchmark import medium_config as mc
    from tpu3drecon.utils.device import device_info

    solver, problem = mc.prepare_engine(args.engine)
    jax.block_until_ready(solver(problem))
    jax.block_until_ready(solver(problem))
    t0 = time.perf_counter()
    with jax.profiler.trace(args.out):
        jax.block_until_ready(solver(problem))
    wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    per_op, busy, window, per_line = device_op_times(path)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    total = sum(per_op.values())
    print(json.dumps({
        "engine": args.engine,
        "device": device_info().as_dict(),
        "traced_wall_s": wall,
        "device_window_s": window * 1e-9,
        "device_busy_share_of_window": busy / window if window else None,
        "device_op_total_s": total * 1e-9,
        "device_line_totals_s": {k: v * 1e-9 for k, v in per_line.items()},
        "top10": [
            {"op": name, "s": ns * 1e-9, "share": ns / total}
            for name, ns in top
        ],
        "xplane": path,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
