"""Online replanning tick latency (round-4 VERDICT item 4).

The reference's actual deployment mode is the receding-horizon loop
(path_finder.cpp:302-363 resetRoot exists precisely for it); this
script measures WARM per-tick wall times for both rebuilt loops on the
current device:

* ``replan_loop`` — beam kino search -> Hermite seed -> penalty refine
  per tick (the compare22 flow);
* ``replan_loop_rrt(backend="native")`` — persistent C++ RRT* tree:
  grow -> corridor -> bounded refine -> root commit per tick.

Tick boundaries are observed through the ``map_update`` callback (called
at the start of every tick), so the loops run UNMODIFIED.  The first
ticks pay jit compiles and are reported separately.

Usage: python scripts/bench_replan_tick.py [n_runs]
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
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import fixtures, replan
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig

    n_runs = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    kino_beam = int(sys.argv[2]) if len(sys.argv) > 2 else 64

    # the reference's own demo map (200x200x25 @ 0.2 m) flown corner
    # to corner through its wall gaps
    map_cfg, obss, wp = fixtures.opti_node_scenario()
    scn = solve_mod.make_scenario(wp, obss, map_cfg)
    dist = scn.dist
    origin = scn.origin
    res = float(map_cfg.resolution)
    start = np.concatenate([np.asarray(wp[0], np.float64), np.zeros(3)])
    goal = np.concatenate([np.asarray(wp[-1], np.float64), np.zeros(3)])
    ocfg = OptimizerConfig(iters_step2=60)

    def run_loop(loop_fn, **kw):
        stamps = []

        def marker(t, grid):
            stamps.append(time.perf_counter())
            return None

        t0 = time.perf_counter()
        results = loop_fn(map_update=marker, **kw)
        t_total = time.perf_counter() - t0
        stamps.append(time.perf_counter())
        ticks = np.diff(np.asarray(stamps))
        return results, ticks, t_total

    out = {}

    # ---- beam-kino loop ----
    all_ticks = []
    first_ticks = []
    reached = 0
    fallbacks = 0
    for r in range(n_runs):
        results, ticks, t_total = run_loop(
            replan.replan_loop,
            dist_grid=dist, origin=origin, resolution=res,
            start_state=start, goal=goal,
            rcfg=replan.ReplanConfig(max_ticks=40, horizon=8.0,
                                     kino_beam=kino_beam),
            ocfg=ocfg,
        )
        reached += any(t.reached_goal for t in results)
        fallbacks += sum(t.via_fallback for t in results)
        first_ticks.append(ticks[:2])
        all_ticks.extend(ticks[2:])  # warm ticks only
        print(f"kino run {r}: {len(results)} ticks, "
              f"reached={results[-1].reached_goal}, total {t_total:.2f}s",
              flush=True)
        # per-stage attribution of the slowest warm ticks (round-5
        # VERDICT item 5: WHERE does the p99 tick go?)
        warm = results[2:]
        order = np.argsort([-(t.t_search + t.t_fallback + t.t_refine)
                            for t in warm])[:3]
        for j in order:
            t = warm[j]
            print(json.dumps({
                "slow_tick": int(j), "run": r,
                "search_ms": round(t.t_search * 1e3, 1),
                "fallback_ms": round(t.t_fallback * 1e3, 1),
                "refine_ms": round(t.t_refine * 1e3, 1),
                "search_ok": t.search_ok,
                "via_fallback": t.via_fallback,
            }), flush=True)
    at = np.asarray(all_ticks)
    out.update({
        "kino_warm_tick_p50_ms": round(float(np.percentile(at, 50)) * 1e3, 1),
        "kino_warm_tick_p99_ms": round(float(np.percentile(at, 99)) * 1e3, 1),
        "kino_first_tick_s": round(float(np.mean(np.concatenate(first_ticks)[::2])), 2),
        "kino_n_warm_ticks": len(at),
        "kino_runs_reached": reached,
        "kino_fallback_ticks": fallbacks,
    })
    print(json.dumps({k: v for k, v in out.items()}), flush=True)

    # ---- native RRT* loop ----
    all_ticks = []
    first_ticks = []
    reached = 0
    for r in range(n_runs):
        results, ticks, t_total = run_loop(
            replan.replan_loop_rrt,
            dist_grid=dist, origin=origin, resolution=res,
            start=start[:3], goal=goal[:3],
            rcfg=replan.RRTReplanConfig(
                max_ticks=40, backend="native", seed=r,
            ),
            ocfg=ocfg,
        )
        reached += any(t.reached_goal for t in results)
        first_ticks.append(ticks[:2])
        all_ticks.extend(ticks[2:])
        print(f"rrt run {r}: {len(results)} ticks, "
              f"reached={results[-1].reached_goal}, total {t_total:.2f}s",
              flush=True)
    at = np.asarray(all_ticks)
    out.update({
        "rrt_warm_tick_p50_ms": round(float(np.percentile(at, 50)) * 1e3, 1),
        "rrt_warm_tick_p99_ms": round(float(np.percentile(at, 99)) * 1e3, 1),
        "rrt_first_tick_s": round(float(np.mean(np.concatenate(first_ticks)[::2])), 2),
        "rrt_n_warm_ticks": len(at),
        "rrt_runs_reached": reached,
    })
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
