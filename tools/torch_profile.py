"""Where a query's time goes in presto_tpu_torch on a CUDA card.

    python3 tools/torch_profile.py [--scale 1.0] [--query q1|q3|q4|...]
    python3 tools/torch_profile.py --scale 1 --query ds:q72 --query ds:q67
    python3 tools/torch_profile.py --scale 1 --query q18 --query orderkey \
        --ab streaming_aggregation_enabled --rounds 2

``--query ds:<file>`` runs a TPC-DS suite file (``tests/tpcds_suite/
<file>.sql``, as phase 6 of chip_smoke.py runs it) from the tpcds catalog
at ``--scale``.

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

``--ab FLAG`` times instead of profiling: FLAG is a bool of EngineConfig,
and each query runs cold once on a runner with it on and once on one with
it off, then warm in turns (on, off, off, on; ``--rounds`` times), with no
profiler.  One JSON line per query: ``on_s`` and ``off_s`` (host clock,
ending in a synchronize), each setting's operator names and
``operators_wall_s`` of its last run.  Rows must give the same bits on
every run of a setting and agree across the two (doubles to 1e-9).

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

from chip_smoke import (  # noqa: E402
    PARTKEY, Q1, Q3, Q6, SQL_QUERIES, card_line, ds_sql, rows_match,
)

# a GROUP BY on lineitem's sort key that the planner can stream
ORDERKEY = """
select l_orderkey, count(*), sum(l_extendedprice) from lineitem
group by l_orderkey order by 3 desc, 1 limit 10"""

QUERIES = {"q1": Q1, "q6": Q6, "q3": Q3, "partkey": PARTKEY,
           "orderkey": ORDERKEY, **SQL_QUERIES}


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


def _operator_walls(event) -> dict:
    """Host wall per operator from a completion event, feed threads
    summed under ``feed*``."""
    ops = {}
    for s in event.operator_stats:
        name = re.sub(r"feed\d+", "feed*", s["operator"])
        ops[name] = ops.get(name, 0.0) + (
            s["wall_ns"] + s["finish_wall_ns"]) / 1e9
    return ops


def ab(flag: str, rounds: int, scale: float, queries, card: str,
       listener_cls) -> None:
    """Warm walls of each query with the EngineConfig bool ``flag`` on
    and off, in turns, on one runner each."""
    import dataclasses

    import torch

    from presto_tpu_torch.config import EngineConfig
    from presto_tpu_torch.localrunner import LocalQueryRunner

    runners, done = {}, {}
    for on in (True, False):
        runners[on] = LocalQueryRunner.tpch(
            scale=scale,
            config=dataclasses.replace(EngineConfig(), **{flag: on}))
        done[on] = listener_cls()
        runners[on].event_bus.register(done[on])
    for label, sql in queries:
        rows, names = {}, {}
        for on, runner in runners.items():
            rows[on] = runner.execute(sql).rows                 # cold
            names[on] = sorted({s["operator"].rsplit(".", 1)[-1]
                                for s in done[on].last.operator_stats})
        rows_match(rows[False], rows[True], f"{label} {flag} off")
        walls = {True: [], False: []}
        for _ in range(rounds):
            for on in (True, False, False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = runners[on].execute(sql).rows
                torch.cuda.synchronize()
                walls[on].append(time.perf_counter() - t0)
                if got != rows[on]:
                    raise AssertionError(f"{label}: {flag}={on} gave "
                                         "other bits on a repeat")
        print(json.dumps({
            "query": label, "scale": scale, "ab": flag,
            "on_s": walls[True], "off_s": walls[False],
            "operators_on": names[True], "operators_off": names[False],
            "operators_wall_s_on": _operator_walls(done[True].last),
            "operators_wall_s_off": _operator_walls(done[False].last),
            "rows": len(rows[True]), "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--query", action="append",
                    help=f"one of {sorted(QUERIES)}, or ds:<suite file>")
    ap.add_argument("--ab", metavar="FLAG",
                    help="time FLAG (an EngineConfig bool) on and off")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    for label in args.query or ():
        if label not in QUERIES and not label.startswith("ds:"):
            ap.error(f"unknown query {label}")

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
    queries = [(label, ds_sql(label[3:]) if label.startswith("ds:")
                else QUERIES[label]) for label in args.query or ["q1", "q6"]]
    if args.ab:
        ab(args.ab, args.rounds, args.scale, queries, card, Completed)
        print(card)
        return 0
    runner = LocalQueryRunner.tpch(scale=args.scale)
    done = Completed()
    runner.event_bus.register(done)
    for label, sql in queries:
        runner.execute(sql)                             # cold
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.execute(sql)
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
        ops = _operator_walls(done.last)
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
