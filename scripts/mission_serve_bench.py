"""MissionServer benchmark: Poisson full-mission arrivals.

Like serve_bench.py but every request is a complete mission (retry-
ladder beam search + raced refine through pipeline.plan_batch) on the
shared bench map — the reference's compare2 per-request flow
(compare2.cpp:129-321) as a fleet service.

Usage: python scripts/mission_serve_bench.py [loads ...] [--max_batch=N]
"""

import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def main():
    from _bench_common import build_bench_batch
    from grad_traj_optimization_tpu import serving
    from grad_traj_optimization_tpu.config import OptimizerConfig

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    max_batch = 256
    for a in sys.argv[1:]:
        if a.startswith("--max_batch="):
            max_batch = int(a.split("=", 1)[1])
    loads = [float(a) for a in args] or [100.0, 200.0, 400.0]

    # one SHARED bench map + many start/goal pairs
    dist, origins_b, res, starts, goals, _ = build_bench_batch(512)
    dist1 = dist[:1]
    origin = origins_b[0]

    srv = serving.MissionServer(
        dist1, origin, res, cfg=OptimizerConfig(),
        max_batch=max_batch, max_wait_ms=5.0,
    )

    # pre-warm every pow2 bucket TWICE: once with normal missions
    # (base search + refine programs) and once with unreachable goals
    # (all lanes fail -> the retry rung fires at the full bucket size,
    # compiling the wider/deeper retry program for that pow2 shape —
    # otherwise retry shapes compile lazily mid-load, measured as a
    # 26 s first-load latency spike)
    t0 = time.perf_counter()
    goal_bad = np.concatenate(
        [np.array([60.0, 60.0, 60.0]), np.zeros(3)]
    ).astype(np.float32)
    b = 1
    while b <= max_batch:
        # await the normal burst BEFORE submitting the unreachable one
        # — back-to-back submits coalesce into one mixed 2b batch and
        # neither intended bucket shape compiles
        futs = [srv.submit(starts[i % 512], goals[i % 512])
                for i in range(b)]
        for f in futs:
            f.result(timeout=1800)
        futs = [srv.submit(starts[i % 512], goal_bad)
                for i in range(b)]
        for f in futs:
            f.result(timeout=1800)
        b *= 2
    print(f"# warmed buckets in {time.perf_counter() - t0:.1f}s",
          flush=True)

    for load in loads:
        srv.stats = serving.ServerStats()
        duration = 4.0
        n_req = int(load * duration)
        gaps = np.random.default_rng(5).exponential(1.0 / load, n_req)
        arrivals = np.cumsum(gaps)
        futs = []
        t_start = time.perf_counter()
        for i in range(n_req):
            dt = t_start + arrivals[i] - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            futs.append(srv.submit(starts[i % 512], goals[i % 512]))
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t_start
        s = srv.stats.summary()
        print(json.dumps({
            "offered_missions_per_s": load,
            "achieved_missions_per_s": round(n_req / wall, 1),
            "n_requests": n_req,
            "n_ok": sum(o["ok"] for o in outs),
            "mean_batch": round(s["mean_batch"], 1),
            "latency_ms_p50": round(s["total_ms_p50"], 1),
            "latency_ms_p99": round(s["total_ms_p99"], 1),
            "device_ms_p50": round(s["device_ms_p50"], 1),
        }), flush=True)
    srv.shutdown()
    print("# done", flush=True)


if __name__ == "__main__":
    main()
