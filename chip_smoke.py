"""Start the planner on one NVIDIA GPU and check every phase of its main path.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded path only

One process drives the card.  Each phase prints one JSON line with its
result, the comparison it made (value and limit) and its wall seconds,
compilation included.  The first line names the card, its power limit
and the JAX version; the last line is the one-line verdict
``{"ok": true, "device": {...}}``.  Any failed phase or comparison raises,
so the script exits non-zero and prints no verdict.  Without a GPU it
exits non-zero before doing anything.

Phases (one card):
  0. native  — rebuild the host engine (native/) from the tracked sources.
  1. edt     — 1024 bench maps (100x100x25) and the reference's opti_node
               map (200x200x25) against the native exact EDT.
  2. refine  — B=1 opti_node solve against the float64 oracle; the B=1024
               fleet against the native float64 batch solve; 256 waypoint
               sets on the shared opti_node map, full grid vs exact crop.
  3. mission — plan_batch at B=1024 with the exact host rung.
  4. serve   — MissionServer answers 64 requests on the opti_node map.
  5. replan  — replan_loop flies the opti_node map past a moving obstacle.

Tolerances, and why:
  * EDT <= 1e-4 m on cells below the 10000 m free cap: both transforms
    are exact (integer squared cell distances), so only the final f32
    sqrt and metric scaling differ.  The sharded-EDT check uses the same
    bound.
  * B=1 solve within 1e-3 m of the float64 oracle in position: the
    accuracy target of BASELINE.md.  Every einsum runs at HIGHEST
    precision, so no TF32 pass enters the descent.  The check runs a
    15-iteration budget: on the opti_node map f32 and f64 descents part
    by 3 mm after 25 iterations on the CPU as well (last-bit differences
    flip accept/reject decisions), so only a short budget measures the
    arithmetic rather than that chaos.  The default 100-iteration gap is
    printed beside it.
  * Fleet costs against float64 (every 8th lane, 128 of 1024, re-solved
    by the native engine on the host): p50 |log ratio| < 0.02, p90 <
    0.25, mean < 0.10.  At 100 iterations f32 reductions in another
    order flip lanes between equal-quality basins, so lanes are compared
    as a distribution, not one by one.
  * Cropped vs full grid: bitwise equal dp on every lane.  In-window
    lookups read the same cells through the same global-frame arithmetic.
  * Sharded vs one card (--four): the fleet-cost bounds above at the full
    budget, |dp| within 1e-4 after 8 iterations (before f32 reordering
    can compound), and bitwise equal beam searches.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FLEET = 1024          # bench fleet: maps of 100x100x25 at 0.2 m
NATIVE_LANES = 128    # fleet lanes re-solved by the native f64 engine
EDT_CHECK_MAPS = 16   # fleet maps compared with the native EDT
OPTI_LANES = 256      # jittered waypoint sets on the shared opti_node map
SERVE_REQUESTS = 64
EDT_TOL_M = 1e-4
ORACLE_TOL_M = 1e-3
ORACLE_ITERS = 15     # step-2 budget of the B=1 oracle check
COST_P50, COST_P90, COST_MEAN = 0.02, 0.25, 0.10
SHORT_DP_TOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return " | ".join(ln.strip() for ln in out.stdout.splitlines())


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def report(phase: str, t0: float, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "wall_s": round(time.perf_counter() - t0, 3)}),
          flush=True)


def cost_log_ratio_stats(a, b):
    r = np.abs(np.log(np.asarray(a, np.float64) / np.asarray(b, np.float64)))
    r = np.sort(r)
    return {
        "p50": float(r[len(r) // 2]),
        "p90": float(r[int(np.ceil(0.9 * (len(r) - 1)))]),
        "mean": float(np.mean(r)),
    }


def check_cost_stats(st, what):
    check(st["p50"] < COST_P50 and st["p90"] < COST_P90
          and st["mean"] < COST_MEAN,
          f"{what} cost |log ratio| {st} vs p50<{COST_P50} "
          f"p90<{COST_P90} mean<{COST_MEAN}")


def oracle_max_dev(sol, gopt, coeff_g, n: int = 200) -> float:
    """Max position gap between a JAX solution and the float64 oracle."""
    import jax.numpy as jnp

    from grad_traj_optimization_tpu.core import poly

    T = np.asarray(sol.T, np.float64)
    ts = np.linspace(1e-3, T.sum() - 1e-3, n)
    pos_j = np.asarray(
        poly.evaluate(sol.coeff, sol.T, jnp.asarray(ts, jnp.float32))
    )
    edges = np.cumsum(np.asarray(gopt.times, np.float64))
    pos_g = np.zeros((n, 3))
    for i, t in enumerate(ts):
        s = min(int(np.searchsorted(edges, t, side="right")), len(edges) - 1)
        tl = t - (edges[s - 1] if s > 0 else 0.0)
        pos_g[i] = coeff_g[s] @ np.array([tl**j for j in range(6)])
    return float(np.abs(pos_j - pos_g).max())


def build_fleet(n: int):
    """The bench fleet: occupancy + EDT of ``n`` random maps on device."""
    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import fixtures
    from grad_traj_optimization_tpu.fields import sdf

    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        n, n_waypoints=7, seed=42, max_obstacle_points=4096
    )
    origin = jnp.asarray(map_cfg.origin, jnp.float32)
    res = map_cfg.resolution

    @jax.jit
    def fields(p, v):
        occ = jax.vmap(
            lambda pp, vv: sdf.rasterize(
                pp, origin, res, map_cfg.grid_shape, valid_mask=vv
            )
        )(p, v)
        return occ, sdf.edt_batch(occ, res)

    occ, dist = jax.block_until_ready(
        fields(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    )
    return map_cfg, occ, dist, np.asarray(wps, np.float32)


def fleet_scenarios(map_cfg, dist, wps):
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import solver as solve_mod

    B = wps.shape[0]
    return solve_mod.Scenario(
        dist=dist,
        origin=jnp.broadcast_to(
            jnp.asarray(map_cfg.origin, jnp.float32), (B, 3)
        ),
        resolution=jnp.full((B,), map_cfg.resolution, jnp.float32),
        waypoints=jnp.asarray(wps),
    )


def opti_node_batch(o_scn, o_wp, lanes: int):
    """``lanes`` jittered copies of the opti_node waypoints on the one
    shared opti_node field (the bench's shared-map batch)."""
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import solver as solve_mod

    rng = np.random.default_rng(3)
    wps = np.stack([
        o_wp + np.concatenate(
            [rng.uniform(-0.3, 0.3, (len(o_wp), 2)),
             np.zeros((len(o_wp), 1))], 1,
        )
        for _ in range(lanes)
    ])
    return solve_mod.Scenario(
        dist=o_scn.dist[None],
        origin=jnp.broadcast_to(o_scn.origin, (lanes, 3)),
        resolution=jnp.broadcast_to(o_scn.resolution, (lanes,)),
        waypoints=jnp.asarray(wps, jnp.float32),
    )


def phase_native():
    from grad_traj_optimization_tpu import native

    t0 = time.perf_counter()
    native.build(force=True)
    check(native.available(), "native engine loads after a fresh build")
    report("native", t0, built="make -B -C native")


def phase_edt(fleet_n: int, n_check: int):
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import fixtures, native
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.fields import sdf

    t0 = time.perf_counter()
    map_cfg, occ, dist, wps = build_fleet(fleet_n)
    t_fleet = time.perf_counter() - t0
    idx = np.unique(np.linspace(0, fleet_n - 1, n_check).astype(int))
    err = 0.0
    for i in idx:
        ref = native.edt(np.asarray(occ[i]), map_cfg.resolution)
        mask = ref < sdf.FREE_DIST
        err = max(err, float(np.abs(np.asarray(dist[i]) - ref)[mask].max()))

    o_cfg, o_obss, o_wp = fixtures.opti_node_scenario()
    o_scn = solve_mod.make_scenario(o_wp, o_obss, o_cfg)
    o_occ = sdf.rasterize(
        jnp.asarray(o_obss, jnp.float32), o_scn.origin, o_cfg.resolution,
        o_cfg.grid_shape,
    )
    ref = native.edt(np.asarray(o_occ), o_cfg.resolution)
    mask = ref < sdf.FREE_DIST
    err_o = float(np.abs(np.asarray(o_scn.dist) - ref)[mask].max())
    check(err <= EDT_TOL_M, f"fleet EDT error {err} m > {EDT_TOL_M}")
    check(err_o <= EDT_TOL_M, f"opti_node EDT error {err_o} m > {EDT_TOL_M}")
    report("edt", t0, maps=int(fleet_n), grid=list(map_cfg.grid_shape),
           checked_maps=int(len(idx)), max_err_m=err,
           opti_node_grid=list(o_cfg.grid_shape), opti_node_max_err_m=err_o,
           tol_m=EDT_TOL_M, fleet_build_s=round(t_fleet, 3))
    return (map_cfg, dist, wps), (o_cfg, o_obss, o_wp, o_scn)


def phase_refine(fleet, opti, opti_lanes: int):
    import jax

    from grad_traj_optimization_tpu import crop_scenarios, native
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig
    from grad_traj_optimization_tpu.reference_impl import golden

    cfg = OptimizerConfig()
    map_cfg, dist, wps = fleet
    o_cfg, o_obss, o_wp, o_scn = opti

    # B=1 on the reference's own map against the float64 oracle
    t0 = time.perf_counter()
    gm = golden.GoldenSDFMap(o_cfg.origin, o_cfg.resolution, o_cfg.map_size)
    for p in o_obss:
        gm.set_occupancy(p)
    gm.update_esdf()
    devs = {}
    for c in (OptimizerConfig(iters_step2=ORACLE_ITERS), cfg):
        sol1 = jax.block_until_ready(solve_mod.solve(o_scn, cfg=c))
        check(int(sol1.status) == 0, "B=1 opti_node solve status")
        gopt = golden.GoldenOptimizer(gm, c)
        gopt.setup(o_wp)
        _, coeff_g = gopt.optimize(steps=(2,))
        devs[c.iters_step2] = oracle_max_dev(sol1, gopt, coeff_g)
    dev = devs[ORACLE_ITERS]
    check(dev <= ORACLE_TOL_M, f"B=1 oracle gap {dev} m > {ORACLE_TOL_M}")
    report("refine_b1", t0, iters=ORACLE_ITERS, max_pos_dev_m=dev,
           tol_m=ORACLE_TOL_M,
           default_budget_max_pos_dev_m=devs[cfg.iters_step2])

    # the fleet against the native float64 batch solve
    t0 = time.perf_counter()
    scns = fleet_scenarios(map_cfg, dist, wps)
    sols = jax.block_until_ready(solve_mod.solve_batch(scns, cfg=cfg))
    t_dev = time.perf_counter() - t0
    status = np.asarray(sols.status)
    sub = np.linspace(0, len(wps) - 1, min(NATIVE_LANES, len(wps)))
    sub = np.unique(sub.astype(int))
    _, _, costs_ref = native.solve_batch(
        np.asarray(dist[sub]), np.asarray(map_cfg.origin, np.float32),
        map_cfg.resolution, wps[sub], cfg,
    )
    st = cost_log_ratio_stats(np.asarray(sols.cost)[sub], costs_ref)
    check(int((status == 0).sum()) == len(status),
          f"fleet status ok {(status == 0).sum()}/{len(status)}")
    check_cost_stats(st, "fleet vs native f64")
    report("refine_fleet", t0, lanes=int(len(status)),
           status_ok=int((status == 0).sum()), f64_lanes=int(len(sub)),
           cost_log_ratio=st, bounds={"p50": COST_P50, "p90": COST_P90,
                                      "mean": COST_MEAN},
           device_s_incl_compile=round(t_dev, 3))

    # shared opti_node map: full grid vs the exact crop
    t0 = time.perf_counter()
    full_cfg = OptimizerConfig(auto_crop=False)
    batch = opti_node_batch(o_scn, o_wp, opti_lanes)
    cropped = crop_scenarios(batch, cfg)
    s_full = jax.block_until_ready(solve_mod.solve_batch(batch, cfg=full_cfg))
    s_crop = jax.block_until_ready(
        solve_mod.solve_batch(cropped, cfg=full_cfg)
    )
    same = int(np.all(
        np.asarray(s_crop.dp) == np.asarray(s_full.dp), axis=(1, 2)
    ).sum())
    check(same == opti_lanes, f"crop bitwise dp lanes {same}/{opti_lanes}")
    check(int((np.asarray(s_full.status) == 0).sum()) == opti_lanes,
          "opti_node batch status")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    report("refine_crop", t0, lanes=opti_lanes,
           full_grid=list(batch.dist.shape[1:]),
           crop_grid=list(cropped.dist.shape[1:]),
           bitwise_dp_lanes=same, peak_bytes_in_use=peak)


def phase_mission(fleet):
    import jax

    from grad_traj_optimization_tpu import plan_batch

    map_cfg, dist, wps = fleet
    B = wps.shape[0]
    t0 = time.perf_counter()
    z3 = np.zeros((B, 3), np.float32)
    starts = np.concatenate([wps[:, 0], z3], axis=1)
    goals = np.concatenate([wps[:, -1], z3], axis=1)
    origins = np.broadcast_to(np.asarray(map_cfg.origin, np.float32), (B, 3))
    res = plan_batch(
        dist, origins, map_cfg.resolution, starts, goals, beam=64,
        max_iters=16, retries=1, host_fallback=True,
    )
    jax.block_until_ready(res.solution)
    n_ok = int(res.ok.sum())
    check(n_ok == B, f"plan_batch ok {n_ok}/{B}")
    report("mission", t0, lanes=B, ok=n_ok,
           reached_before_host_rung=int(res.reached.sum())
           - int(res.n_host_fallback),
           n_retried=int(res.n_retried),
           n_host_fallback=int(res.n_host_fallback))


def phase_serve(opti, n_requests: int):
    from grad_traj_optimization_tpu.serving import MissionServer

    o_cfg, _, o_wp, o_scn = opti
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    srv = MissionServer(
        o_scn.dist, np.asarray(o_cfg.origin, np.float32), o_cfg.resolution,
        max_batch=n_requests, max_wait_ms=50.0, host_fallback=True,
    )
    try:
        futs = []
        for _ in range(n_requests):
            j = np.concatenate([rng.uniform(-0.3, 0.3, 2), [0.0]])
            s = np.concatenate([o_wp[0] + j, np.zeros(3)])
            g = np.concatenate([o_wp[-1] - j, np.zeros(3)])
            futs.append(srv.submit(s, g))
        outs = [f.result(timeout=900) for f in futs]
    finally:
        srv.shutdown()
    n_ok = sum(bool(o["ok"]) for o in outs)
    check(n_ok == n_requests, f"served ok {n_ok}/{n_requests}")
    st = srv.stats.summary()
    report("serve", t0, requests=n_requests, ok=n_ok,
           batches=st["n_batches"],
           total_ms_p50=round(st["total_ms_p50"], 3))


def phase_replan(opti, min_ticks: int = 3):
    from grad_traj_optimization_tpu import replan
    from grad_traj_optimization_tpu.config import OptimizerConfig

    o_cfg, _, o_wp, o_scn = opti
    t0 = time.perf_counter()
    start = np.concatenate([np.asarray(o_wp[0], np.float64), np.zeros(3)])
    goal = np.concatenate([np.asarray(o_wp[-1], np.float64), np.zeros(3)])
    mid = 0.5 * (np.asarray(o_wp[0]) + np.asarray(o_wp[-1]))

    def mover(t):
        # one box drifting across the route at 1 m/s
        x = mid[0] - 3.0 + 1.0 * t
        hist = np.array([[[x - 0.5, mid[1], mid[2]], [x, mid[1], mid[2]]]])
        return hist, np.array([[t - 0.5, t]]), np.array([[0.8, 0.8, 1.5]])

    results = replan.replan_loop(
        o_scn.dist, o_scn.origin, float(o_cfg.resolution),
        start_state=start, goal=goal, obstacle_update=mover,
        rcfg=replan.ReplanConfig(max_ticks=12),
        ocfg=OptimizerConfig(iters_step2=60),
    )
    states = np.stack([r.state for r in results])
    check(len(results) >= min_ticks, f"replan ticks {len(results)} < "
          f"{min_ticks}")
    check(bool(np.isfinite(states).all()), "replan states finite")
    report("replan", t0, ticks=len(results),
           reached_goal=bool(results[-1].reached_goal),
           min_clearance_m=float(min(r.min_clearance for r in results)))


def run_one_card():
    phase_native()
    fleet, opti = phase_edt(FLEET, EDT_CHECK_MAPS)
    phase_refine(fleet, opti, OPTI_LANES)
    phase_mission(fleet)
    phase_serve(opti, SERVE_REQUESTS)
    phase_replan(opti)


def run_four_cards(devices, fleet_n: int = FLEET, edt_n: int = 512):
    """The sharded paths on a 4-device mesh, each against one card."""
    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig
    from grad_traj_optimization_tpu.fields import sdf
    from grad_traj_optimization_tpu.parallel import edt_sharded
    from grad_traj_optimization_tpu.parallel import mesh as pmesh
    from grad_traj_optimization_tpu.search import kinodynamic as kd

    check(len(devices) == 4, f"--four needs 4 devices, found {len(devices)}")
    card0 = devices[0]
    t0 = time.perf_counter()
    with jax.default_device(card0):
        map_cfg, _, dist, wps = build_fleet(fleet_n)
        scns = fleet_scenarios(map_cfg, dist, wps)
    mesh = pmesh.make_mesh(n_data=4, n_space=1, devices=devices)
    cfg = OptimizerConfig()
    s_sh = jax.block_until_ready(pmesh.sharded_solve(scns, mesh, cfg=cfg))
    placed = len(s_sh.cost.sharding.device_set)
    check(placed == 4, f"sharded solution spans {placed} devices")
    s_one = jax.block_until_ready(solve_mod.solve_batch(scns, cfg=cfg))
    st = cost_log_ratio_stats(s_sh.cost, s_one.cost)
    check_cost_stats(st, "sharded vs one card")
    check(int((np.asarray(s_sh.status) == 0).sum()) == fleet_n,
          "sharded status")
    short = OptimizerConfig(iters_step1=3, iters_step2=8)
    d_sh = pmesh.sharded_solve(scns, mesh, cfg=short)
    d_one = solve_mod.solve_batch(scns, cfg=short)
    ddp = float(jnp.max(jnp.abs(jax.device_put(d_sh.dp, card0) - d_one.dp)))
    check(ddp < SHORT_DP_TOL, f"short-budget |dp| gap {ddp} >= "
          f"{SHORT_DP_TOL}")
    report("four_solve", t0, lanes=fleet_n, mesh="data=4",
           result_devices=placed, cost_log_ratio=st,
           short_budget_max_abs_dp=ddp, tol=SHORT_DP_TOL)

    t0 = time.perf_counter()
    z3 = np.zeros((fleet_n, 3), np.float32)
    starts = np.concatenate([wps[:, 0], z3], axis=1)
    goals = np.concatenate([wps[:, -1], z3], axis=1)
    origins = np.broadcast_to(
        np.asarray(map_cfg.origin, np.float32), (fleet_n, 3)
    )
    kw = dict(max_iters=16, beam=64)
    r_sh = jax.block_until_ready(pmesh.sharded_search(
        dist, origins, map_cfg.resolution, starts, goals, mesh, **kw
    ))
    with jax.default_device(card0):
        r_one = jax.block_until_ready(kd.search_batch(
            dist, origins, map_cfg.resolution, starts, goals, **kw
        ))
    diff = [name for name, a, b in zip(kd.KinoResult._fields, r_sh, r_one)
            if not np.array_equal(np.asarray(a), np.asarray(b))]
    check(not diff, f"sharded search differs from one card in {diff}")
    report("four_search", t0, lanes=fleet_n, bitwise_equal=True,
           reached=int(np.asarray(r_sh.reached).sum()))

    t0 = time.perf_counter()
    with jax.default_device(card0):
        occ = (jax.random.uniform(jax.random.key(0), (edt_n,) * 3)
               < 1e-4).astype(jnp.float32)
        d_one = jax.block_until_ready(sdf.edt(occ, 0.2))
    smesh = pmesh.make_mesh(n_data=1, n_space=4, devices=devices)
    d_sh = jax.block_until_ready(edt_sharded.edt_sharded(occ, 0.2, smesh))
    placed = len(d_sh.sharding.device_set)
    check(placed == 4, f"sharded EDT spans {placed} devices")
    err = float(jnp.max(jnp.abs(jax.device_put(d_sh, card0) - d_one)))
    check(err <= EDT_TOL_M, f"sharded EDT error {err} m > {EDT_TOL_M}")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    check(all(p and p > 0 for p in peaks), f"per-card peak bytes {peaks}")
    report("four_edt", t0, grid=[edt_n] * 3, mesh="space=4",
           result_devices=placed, max_err_m=err, tol_m=EDT_TOL_M,
           peak_bytes_in_use_per_card=peaks)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    import jax

    from grad_traj_optimization_tpu.utils import compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform "
                 f"{devices[0].platform!r}); nothing was run")
    cache = compile_cache.enable(ROOT)
    print(json.dumps({"card": card_line(), "jax": jax.__version__,
                      "compile_cache": cache}), flush=True)
    if args.four:
        run_four_cards(devices)
    else:
        run_one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    main()
