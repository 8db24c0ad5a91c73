"""Benchmark: batched trajectory solves per second on one GPU.

    python bench.py

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...},
with the device (platform, device_kind, count) and the card's name and
power limit.  Exits non-zero without a GPU.  Every timed region ends in
``jax.block_until_ready``.

Baseline: the reference C++ back-end runs one solve per NLopt wall-clock
budget of 0.05-0.5 s (BASELINE.md) — we take the opti_node step-2 budget
of 0.1 s, i.e. ~10 solves/s on the reference CPU, as the comparison point.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu.utils import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU found (JAX platform {dev.platform!r})")
    compile_cache.enable(os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip()
    sync = jax.block_until_ready

    from grad_traj_optimization_tpu import fixtures
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig
    from grad_traj_optimization_tpu.fields import sdf

    BATCH = 1024
    N_WP = 7
    cfg = OptimizerConfig()

    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        BATCH, n_waypoints=N_WP, seed=42, max_obstacle_points=4096
    )
    grid = map_cfg.grid_shape
    origin = jnp.asarray(map_cfg.origin, jnp.float32)
    res = map_cfg.resolution

    # ---- distance-field builds: one batched EDT over all scenarios ----
    @jax.jit
    def build_fields(pts, valid):
        occ = jax.vmap(
            lambda p, v: sdf.rasterize(p, origin, res, grid, valid_mask=v)
        )(pts.astype(jnp.float32), valid)
        return sdf.edt_batch(occ, res)

    # device-put the 54 MB of obstacle points ONCE, outside the timed
    # region: the EDT build is timed, not the host-to-device copy
    pts_d = jax.device_put(jnp.asarray(pts, jnp.float32))
    valid_d = jax.device_put(jnp.asarray(valid))
    t0 = time.perf_counter()
    dist = sync(build_fields(pts_d, valid_d))
    t_edt_total = time.perf_counter() - t0  # includes compile
    # min-of-3 warm reps, like the solve metric
    edt_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sync(build_fields(pts_d, valid_d))
        edt_times.append(time.perf_counter() - t0)
    t_edt_warm = min(edt_times)

    scns = solve_mod.Scenario(
        dist=dist,
        origin=jnp.broadcast_to(origin, (BATCH, 3)),
        resolution=jnp.full((BATCH,), res, jnp.float32),
        waypoints=jnp.asarray(wps, jnp.float32),
    )

    # ---- batched solve throughput ----
    run = lambda: solve_mod.solve_batch(
        scns, cfg=cfg, steps=(2,), record_trace=False
    )
    sols = run()
    sync(sols)  # compile + warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sync(run())
        times.append(time.perf_counter() - t0)
    t_batch = min(times)
    solves_per_s = BATCH / t_batch

    # ---- single-solve latency ----
    # (a) p50 of one synchronous B=1 solve (the number BASELINE.md's
    #     <10 ms target is about); (b) per-solve time of K solves
    #     queued back to back and synchronized once.
    one_scn = jax.tree.map(lambda x: x[0], scns)
    run1 = lambda: solve_mod.solve(
        one_scn, cfg=cfg, steps=(2,), record_trace=False
    )
    sync(run1())
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        sync(run1())
        lat.append(time.perf_counter() - t0)
    p50_ms = float(np.median(lat) * 1e3)
    K = 50
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        last = None
        for _ in range(K):
            last = run1()
        sync(last)
        reps.append((time.perf_counter() - t0) / K * 1e3)
    queued_ms = float(np.median(reps))

    # ---- front-end + full pipeline (round 4) ----
    # The reference's compare2 times BOTH stages (search
    # compare2.cpp:168-177, optimization :296-321); these rows time the
    # batched beam search and the full search -> Hermite-seed -> refine
    # pipeline on the same bench scenarios.  All stages are jitted and
    # chain device-side (no host readbacks between stages).
    from grad_traj_optimization_tpu.search import kinodynamic as kd

    starts = np.concatenate(
        [np.asarray(wps)[:, 0], np.zeros((BATCH, 3))], axis=1
    ).astype(np.float32)
    goals = np.concatenate(
        [np.asarray(wps)[:, -1], np.zeros((BATCH, 3))], axis=1
    ).astype(np.float32)
    origins_b = np.broadcast_to(np.asarray(origin), (BATCH, 3))

    def run_search():
        return kd.search_batch(
            dist, origins_b, res, starts, goals, max_iters=16, beam=64
        )

    rb = sync(run_search())  # compile + warm
    t_se = []
    for _i in range(3):
        t0 = time.perf_counter()
        sync(run_search())
        t_se.append(time.perf_counter() - t0)
    t_search = min(t_se)
    n_reached = int(jnp.sum(rb.reached))

    # ---- moving-obstacle (space-time) batched front-end (round 5) ----
    # compare22's dynamic mode at batch scale: every primitive sweep
    # sample additionally tested against predicted moving boxes at its
    # absolute node time (kinodynamic_astar.cpp:199-213).  Two drifting
    # boxes per scenario, batched prediction leaves.
    from grad_traj_optimization_tpu.search import predictor

    n_obj = 2
    hist = np.zeros((BATCH, n_obj, 2, 3), np.float32)
    rng_d = np.random.default_rng(7)
    p0 = rng_d.uniform(-4, 4, (BATCH, n_obj, 3))
    p0[..., 2] = rng_d.uniform(1.0, 3.0, (BATCH, n_obj))
    v0 = rng_d.uniform(-0.6, 0.6, (BATCH, n_obj, 3))
    hist[:, :, 0] = (p0 - 0.5 * v0).astype(np.float32)
    hist[:, :, 1] = p0.astype(np.float32)
    hist_t = np.broadcast_to(
        np.array([[-0.5, 0.0]], np.float32), (BATCH, n_obj, 2)
    )
    scale = np.full((BATCH, n_obj, 3), 0.8, np.float32)
    pred_b = jax.vmap(predictor.fit_const_vel)(
        jnp.asarray(hist), jnp.asarray(hist_t), jnp.asarray(scale)
    )

    def run_search_dyn():
        return kd.search_batch(
            dist, origins_b, res, starts, goals, obstacle_pred=pred_b,
            start_times=np.zeros(BATCH, np.float32),
            max_iters=16, beam=64,
        )

    rd = sync(run_search_dyn())
    t_sd = []
    for _i in range(3):
        t0 = time.perf_counter()
        sync(run_search_dyn())
        t_sd.append(time.perf_counter() - t0)
    t_search_dyn = min(t_sd)
    n_reached_dyn = int(jnp.sum(rd.reached))

    ress_b = np.full((BATCH,), res, np.float32)

    # honest end-to-end pipeline (round-5 VERDICT item 2): the search
    # stage runs the BATCHED RETRY LADDER (one wider/deeper sub-batch
    # over unreached lanes — the path behind the 100/100 quality
    # claim), and success counts (search reached) AND (refine
    # status == 0).  Refining a truncated seed to "converged" no
    # longer counts (reference status flow kinodynamic_astar.cpp:
    # 278-313: only REACH_END hands a full seed to the optimizer).
    def run_search_adaptive():
        return kd.search_batch_adaptive(
            dist, origins_b, res, starts, goals, max_iters=16,
            beam=64, retries=1,
        )

    # the retry-ladder search timed ALONE: this is the pipeline's
    # actual search stage, so the search fraction below uses it (the
    # plain single-pass t_search would understate the numerator)
    sync(run_search_adaptive())
    t_sa = []
    for _i in range(3):
        t0 = time.perf_counter()
        sync(run_search_adaptive())
        t_sa.append(time.perf_counter() - t0)
    t_search_adaptive = min(t_sa)

    def run_pipeline():
        r, n_re, _ = run_search_adaptive()
        p6, v6, a6, t6 = kd.resample_knots_batch(
            r.pos, r.vel, r.acc, r.times, 6
        )
        sol = solve_mod.solve_kino_batch(
            dist, jnp.asarray(origins_b), jnp.asarray(ress_b),
            p6, v6, a6, t6, cfg=cfg, steps=(2,),
        )
        return r, sol

    rp, sp = run_pipeline()
    sync(sp)
    t_pl = []
    for _i in range(3):
        t0 = time.perf_counter()
        rp, sp = run_pipeline()
        sync(sp)
        t_pl.append(time.perf_counter() - t0)
    t_pipeline = min(t_pl)
    n_reached_retry = int(jnp.sum(rp.reached))
    n_ok_reached = int(jnp.sum(rp.reached & (sp.status == 0)))

    # quality-at-scale variant: the seed-duration RACE (the gate-
    # measured quality lever) batched — two refine arms per lane,
    # winner by cost
    def run_pipeline_race():
        r, _, _ = kd.search_batch_adaptive(
            dist, origins_b, res, starts, goals, max_iters=16,
            beam=64, retries=1,
        )
        p6, v6, a6, t6 = kd.resample_knots_batch(
            r.pos, r.vel, r.acc, r.times, 6
        )
        return r, solve_mod.solve_kino_batch_race(
            dist, jnp.asarray(origins_b), jnp.asarray(ress_b),
            p6, v6, a6, t6, stretches=(1.0, 1.2), cfg=cfg, steps=(2,),
        )

    rr, sr = run_pipeline_race()
    sync(sr)
    t_pr = []
    for _i in range(3):
        t0 = time.perf_counter()
        rr, sr = run_pipeline_race()
        sync(sr)
        t_pr.append(time.perf_counter() - t0)
    t_pipeline_race = min(t_pr)
    race_wins = int(jnp.sum(
        (sr.status == 0) & (sp.status == 0) & (sr.cost < sp.cost - 1e-6)
    ))

    # the COMPLETE production ladder (plan_batch): batched retries +
    # raced refine + exact host-A* fallback over the last unreached
    # lanes — the 100%-success configuration
    from grad_traj_optimization_tpu import pipeline as _pipeline

    def run_ladder():
        return _pipeline.plan_batch(
            dist, origins_b, res, starts, goals, cfg=cfg, beam=64,
            max_iters=16, retries=1, host_fallback=True,
        )

    rl = run_ladder()
    sync(rl.solution)
    t_lad = []
    for _i in range(2):
        t0 = time.perf_counter()
        sync(run_ladder().solution)
        t_lad.append(time.perf_counter() - t0)
    ladder_stats = {
        "pipeline_ladder_plans_per_s": round(BATCH / min(t_lad), 1),
        "pipeline_ladder_ok": int(rl.ok.sum()),
        "pipeline_ladder_host_recovered": int(rl.n_host_fallback),
    }
    frontend_stats = {
        "frontend_searches_per_s": round(BATCH / t_search, 1),
        "frontend_reached": n_reached,
        "frontend_dynamic_searches_per_s": round(
            BATCH / t_search_dyn, 1
        ),
        "frontend_dynamic_reached": n_reached_dyn,
        "pipeline_solves_per_s": round(BATCH / t_pipeline, 1),
        "pipeline_reached": n_reached_retry,
        "pipeline_ok_reached": n_ok_reached,
        "frontend_adaptive_searches_per_s": round(
            BATCH / t_search_adaptive, 1
        ),
        "pipeline_n_ok": int(jnp.sum(sp.status == 0)),
        "pipeline_search_fraction": round(
            t_search_adaptive / t_pipeline, 3
        ),
        "pipeline_race_solves_per_s": round(
            BATCH / t_pipeline_race, 1
        ),
        "pipeline_race_improved_lanes": race_wins,
        **ladder_stats,
    }

    # ---- algorithmic presets vs the reference config ----
    # TURBO: dual race at the same 100-eval budget; TURBO_POLISH: fast
    # 30+30 race + 20-iteration post-race restart (the round-3 tail
    # lever); TURBO_SAFE: the never-worse construction (the ref arm IS
    # the reference schedule bitwise, so per-lane ratios are <= 1.0 by
    # construction).  Ratios vs the reference-config solutions from
    # this same run.
    from grad_traj_optimization_tpu.config import (
        TURBO_CONFIG, TURBO_POLISH_CONFIG, TURBO_SAFE_CONFIG,
    )

    preset_stats = {}

    def measure_preset(prefix, pcfg):
        run_t = lambda: solve_mod.solve_batch(
            scns, cfg=pcfg, steps=(2,), record_trace=False
        )
        sols_t = run_t()
        sync(sols_t)
        times_t = []
        for _ in range(3):
            t0 = time.perf_counter()
            sync(run_t())
            times_t.append(time.perf_counter() - t0)
        r = np.asarray(sols_t.cost) / np.asarray(sols.cost)
        keep = np.isfinite(r) & (r > 0)
        r = r[keep]
        preset_stats.update({
            f"{prefix}_solves_per_s": round(BATCH / min(times_t), 2),
            f"{prefix}_cost_geomean_ratio": round(
                float(np.exp(np.mean(np.log(r)))), 4
            ),
            f"{prefix}_cost_p99_ratio": round(
                float(np.percentile(r, 99)), 3
            ),
            f"{prefix}_n_excluded": int((~keep).sum()),
        })

    measure_preset("turbo", TURBO_CONFIG)
    measure_preset("turbo_polish", TURBO_POLISH_CONFIG)
    measure_preset("safe", TURBO_SAFE_CONFIG)

    # ---- the reference's own demo map (200x200x25 = 1M voxels,
    # 11 waypoints): one shared map, 256 jittered waypoint sets, on the
    # full grid and on the default path (auto-crop to the waypoint
    # window, bitwise-identical solves) ----
    import dataclasses

    o_cfg, o_obss, o_wp = fixtures.opti_node_scenario()
    o_scn = solve_mod.make_scenario(o_wp, o_obss, o_cfg)
    BO = 256
    rng = np.random.default_rng(3)
    o_wps = np.stack([
        o_wp + np.concatenate(
            [rng.uniform(-0.3, 0.3, (len(o_wp), 2)),
             np.zeros((len(o_wp), 1))], 1,
        )
        for _ in range(BO)
    ])
    o_sh = solve_mod.Scenario(
        dist=o_scn.dist[None],
        origin=jnp.broadcast_to(o_scn.origin, (BO, 3)),
        resolution=jnp.broadcast_to(o_scn.resolution, (BO,)),
        waypoints=jnp.asarray(o_wps, jnp.float32),
    )

    def timed_opti(c):
        s_out = sync(solve_mod.solve_batch(o_sh, cfg=c, steps=(2,)))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            sync(solve_mod.solve_batch(o_sh, cfg=c, steps=(2,)))
            ts.append(time.perf_counter() - t0)
        return s_out, min(ts)

    s_o, t_full = timed_opti(dataclasses.replace(cfg, auto_crop=False))
    s_c, t_crop = timed_opti(cfg)
    bitwise = int(np.sum(
        np.all(np.asarray(s_c.dp) == np.asarray(s_o.dp), axis=(1, 2))
    ))
    opti = {
        "opti_node_map_solves_per_s": round(BO / t_crop, 1),
        "opti_node_map_n_ok": int(jnp.sum(s_c.status == 0)),
        "opti_node_map_uncropped_solves_per_s": round(BO / t_full, 1),
        "opti_node_map_crop_bitwise_lanes": f"{bitwise}/{BO}",
    }

    n_ok = int(jnp.sum(sols.status == 0))
    baseline_solves_per_s = 10.0  # reference: ~0.1 s/solve budget
    print(
        json.dumps(
            {
                "metric": "trajectory_solves_per_s_single_card",
                "value": round(solves_per_s, 2),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / baseline_solves_per_s, 2),
                "batch": BATCH,
                "p50_single_solve_ms": round(p50_ms, 3),
                "queued_single_solve_ms": round(queued_ms, 3),
                "batch_wall_s": round(t_batch, 4),
                "edt_builds_total_s_incl_compile": round(t_edt_total, 2),
                "edt_builds_warm_s": round(t_edt_warm, 3),
                "edt_builds_per_s": round(BATCH / t_edt_warm, 1),
                "n_status_ok": n_ok,
                **frontend_stats,
                **preset_stats,
                **opti,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()
