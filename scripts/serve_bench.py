"""Serving benchmark: Poisson request arrivals through serving.SolveServer.

Measures achieved throughput and end-to-end request latency (p50/p99)
at several offered loads on the current device, on bench-shaped
scenarios (100x100x25 shared map, 7 waypoints).  The dispatch loop
self-regulates: while one batch is in flight the queue accumulates the
next, so batch sizes grow with offered load until max_batch caps them.

Usage: python scripts/serve_bench.py [loads_req_per_s ...]
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
    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import fixtures, serving
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig
    from grad_traj_optimization_tpu.fields import sdf

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    max_batch = 256
    for a in sys.argv[1:]:
        if a.startswith("--max_batch="):
            max_batch = int(a.split("=", 1)[1])
    loads = [float(a) for a in args] or [100.0, 500.0, 1000.0, 1400.0, 2000.0]

    # one shared bench-shaped map + many waypoint variants
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        512, n_waypoints=7, seed=11, max_obstacle_points=4096
    )
    origin = jnp.asarray(map_cfg.origin, jnp.float32)
    res = map_cfg.resolution
    occ = sdf.rasterize(
        jnp.asarray(pts[0], jnp.float32), origin, res, map_cfg.grid_shape,
        valid_mask=jnp.asarray(valid[0]),
    )
    dist = sdf.edt(occ, res)
    dist = jax.device_put(dist)
    resolution = jnp.asarray(res, jnp.float32)

    wps_host = np.asarray(wps, np.float32)

    def scenario(i):
        # HOST waypoint leaves: the server stacks them on host and pays
        # one upload per batch (a device array per request would cost a
        # per-lane remote op in assembly)
        return solve_mod.Scenario(
            dist=dist,  # same array -> shared-map batches
            origin=origin,
            resolution=resolution,
            waypoints=wps_host[i % len(wps_host)],
        )

    cfg = OptimizerConfig()
    server = serving.SolveServer(cfg=cfg, max_batch=max_batch, max_wait_ms=5.0)

    # pre-warm every pow2 bucket so the load sweep measures steady state,
    # not XLA compiles
    t0 = time.perf_counter()
    b = 1
    while b <= max_batch:
        futs = [server.submit(scenario(i)) for i in range(b)]
        for f in futs:
            f.result(timeout=900)
        b *= 2
    warm_s = time.perf_counter() - t0
    print(f"# warmed pow2 buckets in {warm_s:.1f}s", flush=True)

    for load in loads:
        server.stats = serving.ServerStats()
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
            futs.append(server.submit(scenario(i)))
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t_start
        s = server.stats.summary()
        print(
            json.dumps(
                {
                    "offered_req_per_s": load,
                    "achieved_req_per_s": round(n_req / wall, 1),
                    "n_requests": n_req,
                    "mean_batch": round(s["mean_batch"], 1),
                    "latency_ms_p50": round(s["total_ms_p50"], 1),
                    "latency_ms_p99": round(s["total_ms_p99"], 1),
                    "queue_wait_ms_p50": round(s["wait_ms_p50"], 1),
                    "assemble_ms_p50": round(s["assemble_ms_p50"], 1),
                    "device_ms_p50": round(s["device_ms_p50"], 1),
                    "solve_ms_p50": round(s["solve_ms_p50"], 1),
                    "download_ms_p50": round(s["download_ms_p50"], 1),
                    "pad_fraction": round(s["pad_fraction"], 3),
                }
            ),
            flush=True,
        )
    server.shutdown()


if __name__ == "__main__":
    main()
