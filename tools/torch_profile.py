"""Where a query's time goes in presto_tpu_torch on a CUDA card.

    python3 tools/torch_profile.py [--scale 1.0] [--query q1|q6|q3|partkey ...]

For each query: one cold run, then one warm run under torch.profiler
(CPU + CUDA activities).  Prints one JSON line per query with

- ``wall_s``: host clock of the profiled warm run, ending in a
  synchronize (profiler on, so slower than an unprofiled run);
- ``device_busy_s``: the union of the CUDA kernel and memcpy intervals
  on the device timeline, and ``device_idle_share`` = 1 - busy / wall;
- ``top_device``: the device time by kernel name, largest first;
- ``operators_wall_s``: host wall per operator from the engine's own
  OperatorStats (the feed operators run in parallel threads, so their
  sum may exceed the wall; ``feed*`` sums the feed threads), read from
  the query's completion event.

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import PARTKEY, Q1, Q3, Q6, card_line  # noqa: E402


def _busy_seconds(events) -> float:
    """Union of device intervals (microseconds) -> seconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--query", action="append",
                    choices=["q1", "q6", "q3", "partkey"])
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    from presto_tpu_torch import events as ev
    from presto_tpu_torch.localrunner import LocalQueryRunner

    class Completed(ev.EventListener):
        def __init__(self):
            self.last = None

        def query_completed(self, event):
            self.last = event

    card = card_line()
    runner = LocalQueryRunner.tpch(scale=args.scale)
    done = Completed()
    runner.event_bus.register(done)
    sql = {"q1": Q1, "q6": Q6, "q3": Q3, "partkey": PARTKEY}
    for label in args.query or ["q1", "q6"]:
        runner.execute(sql[label])                      # cold
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.execute(sql[label])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_events = [e for e in prof.events()
                         if e.device_type.name == "CUDA"]
        busy = _busy_seconds(device_events)
        by_name = {}
        for e in device_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        ops = {}
        for s in done.last.operator_stats:
            name = re.sub(r"feed\d+", "feed*", s["operator"])
            ops[name] = ops.get(name, 0.0) + (
                s["wall_ns"] + s["finish_wall_ns"]) / 1e9
        print(json.dumps({
            "query": label, "scale": args.scale, "wall_s": wall,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "device_events": len(device_events),
            "top_device": top, "operators_wall_s": ops, "card": card}),
            flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
