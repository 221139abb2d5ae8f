"""Smoke run of presto_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--scale 1.0] [--seed 0]

Phases (any failure exits non-zero; nothing is caught):

1. device and build: the card's name and power limit, then every kernel
   of ``presto_tpu_torch/csrc`` built with nvcc for sm_90a (one nvcc per
   source, in parallel), with the build seconds and ptxas report;
2. kernel against plain: each kernel's wrapper on tensors on the card at
   the shapes the main path gives it, held against its plain PyTorch
   version (tolerance stated per kernel) and against itself on a repeat
   (bit-identical), with CUDA-event times of the kernel, the plain
   version and one PyTorch library call, and the least time the card
   could take (``bound_ms``);
3. SQL on the card: TPC-H Q1 and Q6 through
   ``presto_tpu_torch.localrunner.LocalQueryRunner`` on ``cuda`` at
   ``--scale``, rows held against a numpy oracle over the same generator
   columns (1e-9 relative for doubles, exact for keys and counts), with
   the kernels' launch counts over that run and the cold and warm wall
   seconds.

The last lines are the kernels line ``{"kernels": [...]}``, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
import time

# H100 SXM data sheet rates (the card's memory rate and float64 rate)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07 and l_quantity < 24
"""


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_segment_sums(n: int, g: int, a: int, seed: int) -> dict:
    """B1 at one shape: kernel vs plain (<= 1e-12 relative), repeat
    bit-identity, and times."""
    import torch

    from presto_tpu_torch.ops import segment_sums as S

    gen = torch.Generator(device="cuda").manual_seed(seed)
    gid = torch.randint(0, g, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals = torch.rand((n, a), generator=gen, device="cuda",
                      dtype=torch.float64) * 1e5
    got = S.direct_segment_sums(gid, vals, g)
    again = S.direct_segment_sums(gid, vals, g)
    want = S.direct_segment_sums_reference(gid, vals, g)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel_err = float(((got - want).abs()
                     / want.abs().clamp(min=1.0)).max())
    if rel_err > 1e-12:
        raise AssertionError(f"segment_sums n={n} g={g} a={a}: relative "
                             f"error {rel_err} > 1e-12")
    if not torch.equal(got, again):
        raise AssertionError(f"segment_sums n={n} g={g} a={a}: two runs "
                             "differ")
    iters = 20 if n > 100_000 else 200
    gid64 = gid.long()
    ms = cuda_ms(lambda: S._launch(gid, vals, g), iters)
    plain_ms = cuda_ms(
        lambda: S.direct_segment_sums_reference(gid, vals, g), iters)
    library_ms = cuda_ms(
        lambda: torch.zeros((g, a), dtype=torch.float64,
                            device="cuda").index_add_(0, gid64, vals),
        iters)
    nbytes = n * (4 + 8 * a) + g * a * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * a / FP64_OPS_PER_S * 1e3
    return {"n": n, "g": g, "a": a, "max_abs_err": abs_err,
            "max_rel_err": rel_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# --------------------------------------------------------------------------
# phase 3: SQL on the card against a numpy oracle
# --------------------------------------------------------------------------

def lineitem_columns(scale: float, names):
    """The generator's lineitem columns as host numpy arrays (codes
    decoded to strings for dictionary columns)."""
    import numpy as np

    from presto_tpu_torch.batch import concat_batches
    from presto_tpu_torch.connectors.tpch import TpchConnector

    conn = TpchConnector(scale=scale)
    handle = conn.get_table("lineitem")
    batches = []
    for split in conn.get_splits(handle, 1):
        batches.extend(conn.page_source(split, names, 1 << 24))
    b = concat_batches(batches) if len(batches) > 1 else batches[0]
    out = {}
    for name, c in zip(names, b.columns):
        v = np.asarray(c.values)[:b.num_rows]
        if c.dictionary is not None:
            v = np.asarray(c.dictionary.values, dtype=object)[v]
        out[name] = v
    return out


def oracle_q1(cols):
    import numpy as np

    sel = cols["l_shipdate"] <= _days(1998, 12, 1) - 90
    rf, ls = cols["l_returnflag"][sel], cols["l_linestatus"][sel]
    qty, price = cols["l_quantity"][sel], cols["l_extendedprice"][sel]
    disc, tax = cols["l_discount"][sel], cols["l_tax"][sel]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    keys = sorted(set(zip(rf, ls)))
    rows = []
    for k in keys:
        m = (rf == k[0]) & (ls == k[1])
        cnt = int(m.sum())
        rows.append((k[0], k[1], qty[m].sum(), price[m].sum(),
                     disc_price[m].sum(), charge[m].sum(),
                     qty[m].sum() / cnt, price[m].sum() / cnt,
                     disc[m].sum() / cnt, cnt))
    return [tuple(float(x) if isinstance(x, np.floating) else x
                  for x in r) for r in rows]


def oracle_q6(cols):
    sd, disc = cols["l_shipdate"], cols["l_discount"]
    sel = ((sd >= _days(1994, 1, 1)) & (sd < _days(1995, 1, 1))
           & (disc >= 0.05) & (disc <= 0.07) & (cols["l_quantity"] < 24))
    return [(float((cols["l_extendedprice"][sel] * disc[sel]).sum()),)]


def rows_match(got, want, label: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, want {len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        for c, (x, y) in enumerate(zip(g, w)):
            if isinstance(y, float):
                if abs(x - y) > 1e-9 * max(abs(y), 1e-300):
                    raise AssertionError(
                        f"{label} row {r} col {c}: {x!r} != {y!r}")
            elif x != y:
                raise AssertionError(f"{label} row {r} col {c}: {x!r} != "
                                     f"{y!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="TPC-H scale factor of the SQL phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel phase's random inputs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from presto_tpu_torch import cuda_build
    from presto_tpu_torch.ops import groupby as G
    from presto_tpu_torch.ops import segment_sums as S

    card = card_line()
    print(f"card: {card}", flush=True)

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{cuda_build.sources()}", flush=True)
    for name, log in cuda_build.build_logs.items():
        print(f"nvcc[{name}]: {log.strip()}", flush=True)

    # -- phase 2: kernels against their plain versions --------------------
    # Q1's shape at SF1 (2^23 padded rows, 7 segments, 19 sum/count
    # columns), a ragged shape at the gate, and the smallest
    shapes = [(1 << 23, 7, 19), (1_000_003, 32, 5), (1, 1, 1)]
    checks = [check_segment_sums(n, g, a, args.seed + i)
              for i, (n, g, a) in enumerate(shapes)]
    for c in checks:
        print("segment_sums " + json.dumps(c), flush=True)

    # -- phase 3: SQL on the card -----------------------------------------
    from presto_tpu_torch.localrunner import LocalQueryRunner

    seen_devices = []
    real_direct, real_global = (G.direct_grouped_aggregate,
                                G.global_aggregate)

    def direct_spy(key_codes, doms, aggs, num_rows, live_mask=None):
        seen_devices.extend(("q1", codes.device) for codes, _ in key_codes)
        seen_devices.extend(("q1", v.device) for _p, v, _ in aggs
                            if v is not None)
        return real_direct(key_codes, doms, aggs, num_rows, live_mask)

    def global_spy(aggs, num_rows, live_mask=None):
        seen_devices.extend(("q6", v.device) for _p, v, _ in aggs
                            if v is not None)
        return real_global(aggs, num_rows, live_mask)

    G.direct_grouped_aggregate, G.global_aggregate = direct_spy, global_spy
    runner = LocalQueryRunner.tpch(scale=args.scale)
    if runner.device.type != "cuda":
        raise AssertionError(f"runner on {runner.device}")
    names = ["l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
    t0 = time.perf_counter()
    cols = lineitem_columns(args.scale, names)
    want = {"q1": oracle_q1(cols), "q6": oracle_q6(cols)}
    n_rows = len(cols["l_shipdate"])
    print(f"oracle: {n_rows} lineitem rows in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    walls = {}
    S.LAUNCHES.reset()          # the main path: cold Q1, cold Q6
    for label, sql in (("q1", Q1), ("q6", Q6)):
        t0 = time.perf_counter()
        res = runner.execute(sql)
        torch.cuda.synchronize()
        walls[label] = [time.perf_counter() - t0]
        rows_match(res.rows, want[label], label)
    launches = S.LAUNCHES.count
    if launches < 1:
        raise AssertionError("Q1 ran without launching segment_sums")
    bad = [(q, str(d)) for q, d in seen_devices if d.type != "cuda"]
    if bad or {q for q, _ in seen_devices} != {"q1", "q6"}:
        raise AssertionError(f"aggregation inputs not on cuda: "
                             f"{seen_devices}")
    for label, sql in (("q1", Q1), ("q6", Q6)):
        for _ in range(2):
            t0 = time.perf_counter()
            res = runner.execute(sql)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            rows_match(res.rows, want[label], label)
    G.direct_grouped_aggregate, G.global_aggregate = real_direct, real_global
    for label, w in walls.items():
        warm = min(w[1:])
        print("sql " + json.dumps({
            "query": label, "scale": args.scale, "rows": n_rows,
            "cold_s": w[0], "warm_s": warm,
            "warm_rows_per_s": n_rows / warm, "card": card}), flush=True)

    q1 = checks[0]
    kernels = [{
        "name": "direct_segment_sums", "route": "cuda",
        "source": "presto_tpu_torch/csrc/segment_sums.cu",
        "replaces": "presto_tpu/ops/pallas_groupby.py:48",
        "launches": launches, "max_abs_err": q1["max_abs_err"],
        "ms": q1["ms"], "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"], "bound_by": q1["bound_by"],
        "library_ms": q1["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
