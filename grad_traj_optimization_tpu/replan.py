"""Receding-horizon replanning with moving obstacles.

Rebuild of the reference's dynamic-planning flow (src/compare22.cpp:90-247
+ the Fast-Planner-style loop it embodies): at each replan tick,

1. moving-obstacle predictions are refreshed from pose histories
   (search.predictor, reference obj_predictor.cpp timer callback),
2. a kinodynamic search runs from the current state toward the goal
   against the space-time distance oracle (search.kinodynamic, reference
   kinodynamic_astar.cpp:17-315),
3. the knot states seed a Hermite trajectory (core.qp.kino_coeff,
   reference PolyKinoGeneration) refined by the penalty optimizer
   (reference setKinoPath + optimizeTrajectory, grad_traj_optimizer.cpp:
   35-65, 128-243),
4. the vehicle flies the refined trajectory for ``replan_dt`` seconds and
   the loop repeats from the reached state.

The static field can change mid-flight through ``map_update`` (walls
appearing re-route the next tick — the rebuild's replacement for the
reference RRT* tree-repair machinery); dynamic obstacles enter through
the penalty oracle per tick.  Each tick is one jitted program; ticks
are a host loop (the real-time outer loop is inherently sequential).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from grad_traj_optimization_tpu.config import OptimizerConfig
from grad_traj_optimization_tpu.core import poly, qp
from grad_traj_optimization_tpu.fields import dynamic, sdf
from grad_traj_optimization_tpu.opt import descent, penalty
from grad_traj_optimization_tpu.search import kinodynamic, predictor


@dataclasses.dataclass
class ReplanConfig:
    replan_dt: float = 0.5        # seconds flown per tick
    horizon: float = 7.0          # kino search horizon [m]
    margin: float = 0.3           # collision margin for search
    max_vel: float = 3.0
    max_acc: float = 2.0
    goal_tol: float = 0.5
    max_ticks: int = 40
    kino_iters: int = 16
    kino_beam: int = 64
    n_waypoints: int = 6          # knots passed to the back-end
    # On beam NO_PATH, retry with the exact host kinodynamic A*
    # (native.kino_search — the faithful reference algorithm,
    # kinodynamic_astar.cpp:17-315) before giving up and hovering.
    # The exact search validates against the STATIC field only; ticks
    # with moving obstacles still re-check dynamic clearance after
    # refinement like every other tick.
    fallback_exact: bool = True


@dataclasses.dataclass
class TickResult:
    state: np.ndarray             # (6,) state after flying replan_dt
    coeff: np.ndarray             # refined segment coefficients
    times: np.ndarray
    reached_goal: bool
    search_ok: bool
    min_clearance: float
    via_fallback: bool = False    # beam failed; exact host A* seeded
    # per-stage wall seconds (tick-tail attribution, round-5 VERDICT
    # item 5); host-observed, so each includes its device dispatches
    t_search: float = 0.0         # beam search (incl. result readback)
    t_fallback: float = 0.0       # exact host A* when the beam failed
    t_refine: float = 0.0         # resample + penalty refine + fly


@functools.partial(jax.jit, static_argnames=("cfg", "steps"))
def _refine_kino(dist_grid, origin, resolution, pos, vel, acc, times,
                 cfg: OptimizerConfig, steps=(2,)):
    """setKinoPath-equivalent: Hermite seed + penalty refinement.

    Jitted: one compile per (shape, cfg) — run eagerly, every one of
    its ops would be a separate dispatch each tick.
    """
    T = jnp.asarray(times, jnp.float32)
    Df, dp0 = qp.kino_d(
        jnp.asarray(pos, jnp.float32),
        jnp.asarray(vel, jnp.float32),
        jnp.asarray(acc, jnp.float32),
    )
    dep = qp.build_dep(T)
    ctx = penalty.build_ctx(T, Df, cfg, dep=dep)
    num_dp = dp0.shape[1]
    lb, ub = penalty.bounds(
        jnp.asarray(pos, jnp.float32), num_dp, cfg
    )
    field, grid_shape = penalty.make_field(dist_grid, origin, resolution)

    dp = dp0
    for step in steps:
        cag = functools.partial(
            penalty.cost_and_grad, ctx=ctx, field=field,
            grid_shape=grid_shape, cfg=cfg, step=step,
        )
        co = functools.partial(
            penalty.cost_only, ctx=ctx, field=field,
            grid_shape=grid_shape, cfg=cfg, step=step,
        )
        iters = cfg.iters_step1 if step == 1 else cfg.iters_step2
        res = descent.minimize(cag, co, dp, lb, ub, iters, cfg,
                               record_trace=False)
        dp = res.dp
    coeff = qp.coeff_from_d(Df, dp, T)
    return coeff, T


@jax.jit
def _fly_tick(coeff, T, t_fly, dist_grid, origin, resolution):
    """One jitted tick epilogue: state after flying t_fly + the static
    clearance of the whole refined trajectory (bundling these ~20 ops
    into one dispatch per tick)."""
    p = poly.evaluate(coeff, T, t_fly, deriv=0)
    v = poly.evaluate(coeff, T, t_fly, deriv=1)
    a = poly.evaluate(coeff, T, t_fly, deriv=2)
    samples, sample_ts = poly.sample_uniform(coeff, T, 100)
    dmin = jnp.min(
        sdf.distance_at(dist_grid, origin, resolution, samples)
    )
    return p, v, a, samples, sample_ts, dmin


@jax.jit
def _clearance_dynamic(dist_grid, origin, resolution, samples, ts, pred):
    """Space-time clearance: sample i is evaluated at ITS planned flight
    time ts[i] (absolute), not a single snapshot time — a box crossing
    the path between ticks is caught at the sample it threatens."""
    return jnp.min(
        dynamic.evaluate_coarse(
            dist_grid, origin, resolution, samples, ts, pred
        )
    )


def _resample_knots(pos, vel, acc, times, n: int):
    """Downsample a search branch's knots to n (keeping ends).

    Zero-duration segments are the beam's masked post-termination tail
    (see kinodynamic.search early-termination tracking) — dropped here
    along with their duplicate knots.
    """
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    acc = np.asarray(acc, np.float64)
    times = np.asarray(times, np.float64)
    # the masked dupes are rotated to the FRONT (kinodynamic.search), so
    # the real branch starts at the first kept segment's start knot
    seg_keep = times > 1e-6
    j0 = int(np.argmax(seg_keep)) if seg_keep.any() else 0
    knot_keep = np.zeros(len(pos), bool)
    knot_keep[j0] = True
    knot_keep[1:][seg_keep] = True
    pos, vel, acc = pos[knot_keep], vel[knot_keep], acc[knot_keep]
    times = times[seg_keep]
    k = len(pos)
    if k <= n:
        return pos, vel, acc, np.maximum(times, 1e-2)
    idx = np.unique(np.round(np.linspace(0, k - 1, n)).astype(int))
    seg_times = []
    for a, b in zip(idx[:-1], idx[1:]):
        seg_times.append(max(times[a:b].sum(), 1e-2))
    return pos[idx], vel[idx], acc[idx], np.array(seg_times)


def _pad_knots_fixed(pos, vel, acc, times, k_to: int = 48):
    """Normalize a variable-length knot branch to EXACTLY ``k_to``
    knots: downsample via :func:`_resample_knots` when longer, then
    front-pad with zero-duration duplicates of the first knot (the
    masked-dupe convention the traced resampler already drops).
    Keeps every jitted consumer at one compiled shape."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    acc = np.asarray(acc, np.float64)
    times = np.asarray(times, np.float64)
    if len(pos) > k_to:
        pos, vel, acc, times = _resample_knots(pos, vel, acc, times, k_to)
    m = k_to - len(pos)
    if m > 0:
        pos = np.concatenate([np.repeat(pos[:1], m, axis=0), pos])
        vel = np.concatenate([np.repeat(vel[:1], m, axis=0), vel])
        acc = np.concatenate([np.repeat(acc[:1], m, axis=0), acc])
        times = np.concatenate([np.zeros(m), times])
    return pos, vel, acc, times


def replan_loop(
    dist_grid,
    origin,
    resolution,
    start_state,
    goal,
    obstacle_histories=None,
    obstacle_times=None,
    obstacle_scales=None,
    obstacle_update: Callable | None = None,
    map_update: Callable | None = None,
    rcfg: ReplanConfig = ReplanConfig(),
    ocfg: OptimizerConfig = OptimizerConfig(),
):
    """Run the receding-horizon loop until the goal (or max_ticks).

    Args:
      start_state: (6,) = [position, velocity].
      goal: (6,) = [position, velocity] (end velocity usually zero).
      obstacle_update: optional ``f(t) -> (histories, times, scales)``
        refreshing pose histories each tick (simulating the ROS feeds).
      map_update: optional ``f(t, dist_grid) -> dist_grid | None``
        applying STATIC map changes each tick (the rebuild's answer to
        the reference's incremental rcvAddMap/rcvDelMap + tree repair,
        path_finder.cpp:121-127, 1065-1554: instead of repairing a
        search tree, the whole tick re-solves against the new field on
        the accelerator).  Return a same-shape grid (one jit serves every
        tick) or None for "no change".  For appearing obstacles the
        cheap incremental form is
        ``sdf.edt_update(old_dist, new_occ, res, lo, hi, mode="add")``
        (the region-limited analogue of the reference's setUpdateRange
        windowed sweep, sdf_map.cpp:244-262 — EXACT for additions), or
        ``sdf.edt(new_occ, res, prev_dist=old_dist)`` for the unwindowed
        min-with-old (sdf_map.cpp:358-360); in-box removals use
        ``edt_update(..., mode="reset")`` (the reference's literal
        windowed rebuild); scattered removals need a full rebuild.
    Returns:
      list of TickResult.
    """
    start_state = np.asarray(start_state, np.float64)
    goal = np.asarray(goal, np.float64)
    if start_state.shape != (6,) or goal.shape != (6,):
        raise ValueError(
            "replan_loop expects start_state and goal as (6,) [p, v] "
            f"vectors; got {start_state.shape} and {goal.shape}"
        )
    origin = jnp.asarray(origin, jnp.float32)
    state = np.asarray(start_state, np.float64).copy()
    goal = np.asarray(goal, np.float64)
    t_now = 0.0
    results: list[TickResult] = []

    if rcfg.fallback_exact:
        # pre-warm the fallback seed's fixed resample shape (48 knots,
        # _pad_knots_fixed) so the first fallback TICK does not pay its
        # compile (that compile was the measured warm-tick p99)
        wp_, wv_, wa_, wt_ = _pad_knots_fixed(
            np.zeros((2, 3)), np.zeros((2, 3)), np.zeros((2, 3)),
            np.full((1,), 0.5),
        )
        kinodynamic.resample_knots_batch(
            wp_[None].astype(np.float32), wv_[None].astype(np.float32),
            wa_[None].astype(np.float32), wt_[None].astype(np.float32),
            rcfg.n_waypoints,
        )

    for tick in range(rcfg.max_ticks):
        # 0. static map changes (walls appearing/vanishing mid-flight)
        if map_update is not None:
            new_grid = map_update(t_now, dist_grid)
            if new_grid is not None:
                if new_grid.shape != dist_grid.shape:
                    raise ValueError(
                        "map_update must keep the grid shape "
                        f"({new_grid.shape} != {dist_grid.shape})"
                    )
                dist_grid = new_grid

        # 1. refresh predictions
        pred = None
        if obstacle_update is not None:
            oh, ot, osc = obstacle_update(t_now)
            pred = predictor.fit_const_vel(
                jnp.asarray(oh, jnp.float32), jnp.asarray(ot, jnp.float32),
                jnp.asarray(osc, jnp.float32),
            )
        elif obstacle_histories is not None:
            pred = predictor.fit_const_vel(
                jnp.asarray(obstacle_histories, jnp.float32),
                jnp.asarray(obstacle_times, jnp.float32),
                jnp.asarray(obstacle_scales, jnp.float32),
            )

        # horizon-clipped goal (reference horizon termination)
        to_goal = goal[:3] - state[:3]
        dist_goal = np.linalg.norm(to_goal)
        if dist_goal <= rcfg.goal_tol:
            break
        tgt = goal.copy()
        if dist_goal > rcfg.horizon:
            tgt[:3] = state[:3] + to_goal / dist_goal * rcfg.horizon
            tgt[3:] = 0.0

        # 2. kinodynamic search against the space-time oracle: static EDT
        #    min predicted obstacle boxes at each primitive's absolute time
        #    (reference compare22 flow, kinodynamic_astar 'dynamic' mode)
        t_s0 = time.perf_counter()
        kres = kinodynamic.search(
            dist_grid, origin, resolution,
            state.astype(np.float32), tgt.astype(np.float32),
            obstacle_pred=pred, start_time=t_now,
            max_acc=rcfg.max_acc, max_vel=rcfg.max_vel,
            margin=rcfg.margin, max_iters=rcfg.kino_iters,
            beam=rcfg.kino_beam,
        )
        search_ok = bool(kres.reached)  # host read = device sync
        t_search = time.perf_counter() - t_s0
        via_fallback = False
        knots = (kres.pos, kres.vel, kres.acc, kres.times)

        t_f0 = time.perf_counter()
        if not search_ok and rcfg.fallback_exact:
            # the beam is a fixed-iteration approximation and can miss
            # narrow passages the exact search threads; retry with the
            # faithful host A* before declaring NO_PATH
            from grad_traj_optimization_tpu import native

            if native.available():
                fpos, fvel, facc, ftimes, freached = native.kino_search(
                    np.asarray(dist_grid, np.float32),
                    np.asarray(origin, np.float32),
                    float(resolution),
                    state, tgt,
                    max_acc=rcfg.max_acc, max_vel=rcfg.max_vel,
                    margin=rcfg.margin,
                )
                if freached and len(ftimes) >= 1:
                    search_ok = True
                    via_fallback = True
                    # the exact A* returns a VARIABLE knot count; pad
                    # to ONE fixed shape so the jitted resampler
                    # compiles once for every fallback tick (each
                    # distinct count was a fresh ~0.5 s compile — the
                    # 966 ms p99 tick, round-5 attribution)
                    knots = _pad_knots_fixed(
                        fpos, fvel, facc, ftimes, k_to=48
                    )
        t_fallback = time.perf_counter() - t_f0

        if not search_ok:
            # NO_PATH this tick (reference kinodynamic_astar.cpp:278-313
            # status semantics): flying an unvalidated plan can cross
            # obstacles, so hold position (quadrotors hover) and retry
            # next tick — e.g. after a map change invalidated the route.
            state = np.concatenate([state[:3], np.zeros(3)])
            t_now += rcfg.replan_dt
            hold = jnp.zeros((1, 3, 6), jnp.float32).at[0, :, 0].set(
                jnp.asarray(state[:3], jnp.float32)
            )
            dmin = float(
                sdf.distance_at(
                    dist_grid, origin,
                    jnp.asarray(resolution, jnp.float32),
                    jnp.asarray(state[None, :3], jnp.float32),
                )[0]
            )
            results.append(
                TickResult(
                    state=state.copy(),
                    coeff=np.asarray(hold),
                    times=np.array([rcfg.replan_dt]),
                    reached_goal=False,
                    search_ok=False,
                    min_clearance=dmin,
                    t_search=t_search,
                    t_fallback=t_fallback,
                )
            )
            continue

        # 3. refine — resample to EXACTLY n_waypoints knots (the
        # traced cubic-Hermite resampler reconstructs the branch
        # geometry exactly); the host _resample_knots returns FEWER
        # knots on short branches, and every distinct count compiled
        # its own ~9 s refine program (multi-second p99 tick spikes)
        t_r0 = time.perf_counter()
        p6, v6, a6, t6 = kinodynamic.resample_knots_batch(
            np.asarray(knots[0], np.float32)[None],
            np.asarray(knots[1], np.float32)[None],
            np.asarray(knots[2], np.float32)[None],
            np.asarray(knots[3], np.float32)[None],
            rcfg.n_waypoints,
        )
        pos, vel, acc, times = p6[0], v6[0], a6[0], t6[0]
        coeff, T = _refine_kino(
            dist_grid, origin, resolution, pos, vel, acc, times, ocfg
        )

        # 4. fly replan_dt along the refined trajectory
        t_fly = min(rcfg.replan_dt, float(np.sum(np.asarray(T))))
        p, v, _a, samples, sample_ts, dmin_static = _fly_tick(
            coeff, T, jnp.asarray(t_fly, jnp.float32), dist_grid, origin,
            jnp.asarray(resolution, jnp.float32),
        )
        t_start = t_now  # trajectory local time 0 == this tick's start
        t_now += t_fly

        if pred is not None:
            # each sample evaluated at its own planned flight time
            dmin = float(
                _clearance_dynamic(
                    dist_grid, origin,
                    jnp.asarray(resolution, jnp.float32), samples,
                    jnp.asarray(t_start, jnp.float32) + sample_ts, pred,
                )
            )
        else:
            dmin = float(dmin_static)
        state = np.concatenate([np.asarray(p), np.asarray(v)]).astype(
            np.float64
        )
        t_refine = time.perf_counter() - t_r0

        results.append(
            TickResult(
                state=state.copy(),
                coeff=np.asarray(coeff),
                times=np.asarray(T),
                reached_goal=bool(
                    np.linalg.norm(goal[:3] - state[:3]) <= rcfg.goal_tol
                ),
                search_ok=search_ok,
                min_clearance=dmin,
                via_fallback=via_fallback,
                t_search=t_search,
                t_fallback=t_fallback,
                t_refine=t_refine,
            )
        )
        if results[-1].reached_goal:
            break
    return results


@dataclasses.dataclass
class RRTReplanConfig:
    replan_dt: float = 0.5        # seconds flown per tick
    goal_tol: float = 0.5
    max_ticks: int = 40
    init_iters: int = 2000        # first RRTpathFind budget
    grow_iters: int = 400         # per-tick refine budget (RRTpathRefine)
    repair_iters: int = 200       # treeRepair budget after a map change
    rdp_epsilon: float = 0.4
    min_bos: float = 0.3
    seed: int = 0
    backend: str = "python"       # "python" | "native" tree engine
    # Resample every tick's corridor to this fixed waypoint count so
    # ONE compiled back-end program serves the whole flight (variable
    # RDP counts compile per count — multi-second p99 tick spikes).  None keeps the variable-count RDP corridor.
    n_waypoints: int | None = 6


def _resample_corridor(path, radii, n: int, min_bos: float):
    """Arc-length resample a safe-ball corridor to exactly n waypoints.

    Resampled points lie ON the corridor polyline, i.e. on chords
    between overlapping safe balls, so each is inside at least one of
    its bracketing balls; its bound half-width is the larger in-ball
    slack max_j (r_j - |p - c_j|) over the bracketing nodes, clamped
    at ``min_bos`` (the same floor the RDP corridor uses).
    """
    path = np.asarray(path, np.float64)
    radii = np.asarray(radii, np.float64)
    if len(path) < 2:
        path = np.concatenate([path, path[-1:] + 1e-6], axis=0)
        radii = np.concatenate([radii, radii[-1:]])
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    si = np.linspace(0.0, s[-1], n)
    pts = np.stack(
        [np.interp(si, s, path[:, k]) for k in range(3)], axis=-1
    )
    j = np.clip(np.searchsorted(s, si, side="right") - 1, 0,
                len(path) - 2)
    slack_a = radii[j] - np.linalg.norm(pts - path[j], axis=1)
    slack_b = radii[j + 1] - np.linalg.norm(pts - path[j + 1], axis=1)
    bos = np.maximum(np.maximum(slack_a, slack_b), min_bos)
    return pts, bos


def replan_loop_rrt(
    dist_grid,
    origin,
    resolution,
    start,
    goal,
    map_update: Callable | None = None,
    rcfg: RRTReplanConfig = RRTReplanConfig(),
    ocfg: OptimizerConfig = OptimizerConfig(),
    steps=(2,),
):
    """Receding-horizon flight on ONE persistent RRT* tree.

    This is the reference's actual RRT flight loop (path_finder.cpp):
    per tick the tree is refined (`RRTpathFind` rounds :713-804), map
    changes revalidate and repair it in place (RRTpathReEvaluate/
    ReConnect/treeRepair :1065-1554) instead of replanning from scratch,
    the traced corridor (tracePath/getPath :806-887) is refined by the
    penalty optimizer with per-waypoint safe-ball bounds
    (``solve(bos_wp=...)``), the vehicle flies ``replan_dt`` along the
    refined trajectory, and the flown-past part of the tree is committed
    away (resetRoot/costRecast :302-375).

    ``start``/``goal`` are (3,) positions (the RRT state space is
    geometric; endpoint derivatives are zero, as in the reference's
    corridor consumer).  ``map_update(t, dist_grid) -> grid | None``
    has `replan_loop`'s contract.  Returns a list of TickResult; a tick
    whose tree has no surviving path after repair + regrowth hovers in
    place (search_ok=False) and retries next tick.

    Note: the corridor's waypoint count varies across ticks, so each new
    count compiles its own back-end program — fine for the real-time
    loop this models (compile once per count, then reuse).
    """
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.search import rrt

    start = np.asarray(start, np.float64).reshape(3)
    goal = np.asarray(goal, np.float64).reshape(3)
    origin = jnp.asarray(origin, jnp.float32)
    if rcfg.backend == "native":
        # the C++ tree engine (gtop_rrt_*): same method surface, ~100x
        # the insertion rate — what keeps grow+repair inside a
        # real-time tick
        from grad_traj_optimization_tpu import native as native_mod

        planner_cls = native_mod.NativeRRTPlanner
    elif rcfg.backend == "python":
        planner_cls = rrt.RRTPlanner
    else:
        raise ValueError(f"unknown rrt backend {rcfg.backend!r}")
    planner = planner_cls(
        np.asarray(dist_grid), np.asarray(origin), float(resolution),
        start=start, goal=goal, seed=rcfg.seed,
    )
    planner.grow(rcfg.init_iters)

    state = np.concatenate([start, np.zeros(3)])
    state_acc = np.zeros(3)
    t_now = 0.0
    results: list[TickResult] = []
    # per-tick auto-crop would re-decide the window every tick (the
    # waypoints change, so the decision cache misses and every tick
    # pays a host read-back of the waypoints)
    ocfg_tick = dataclasses.replace(ocfg, auto_crop=False)

    def _hover_tick():
        nonlocal t_now
        t_now += rcfg.replan_dt
        hold = jnp.zeros((1, 3, 6), jnp.float32).at[0, :, 0].set(
            jnp.asarray(state[:3], jnp.float32)
        )
        dmin = float(
            sdf.distance_at(
                dist_grid, origin, jnp.asarray(resolution, jnp.float32),
                jnp.asarray(state[None, :3], jnp.float32),
            )[0]
        )
        results.append(
            TickResult(
                state=state.copy(), coeff=np.asarray(hold),
                times=np.array([rcfg.replan_dt]), reached_goal=False,
                search_ok=False, min_clearance=dmin,
            )
        )

    for tick in range(rcfg.max_ticks):
        if np.linalg.norm(goal - state[:3]) <= rcfg.goal_tol:
            break

        # 0. map changes repair the tree IN PLACE (the reference's
        #    rcvAddMap/rcvDelMap → tree-repair path)
        if map_update is not None:
            new_grid = map_update(t_now, dist_grid)
            if new_grid is not None:
                if new_grid.shape != dist_grid.shape:
                    raise ValueError(
                        "map_update must keep the grid shape "
                        f"({new_grid.shape} != {dist_grid.shape})"
                    )
                dist_grid = new_grid
                planner.update_map(
                    np.asarray(new_grid), repair_iters=rcfg.repair_iters
                )

        # 1. refine the tree; regrow harder if the path was lost
        planner.grow(rcfg.grow_iters)
        if not np.isfinite(planner.best_cost):
            state[3:] = 0.0  # hover (reference NO_PATH semantics)
            state_acc[:] = 0.0
            _hover_tick()
            continue

        # 2. trace the corridor, drop the part already flown past (the
        #    root only advances when a ball contains the state, so the
        #    traced path can trail the vehicle — rrt.trim_passed), and
        #    refine the forward remainder under safe-ball bounds
        res_rrt = planner.result()
        path_f, radii_f = rrt.trim_passed(
            res_rrt.path, res_rrt.radii, state[:3]
        )
        path_c = np.concatenate([state[None, :3], path_f], axis=0)
        radii_c = np.concatenate([radii_f[:1], radii_f])
        from grad_traj_optimization_tpu.search import rdp as rdp_mod

        if rcfg.n_waypoints:
            wps, bos_wp = _resample_corridor(
                path_c, radii_c, rcfg.n_waypoints, rcfg.min_bos
            )
        else:
            wps, idx = rdp_mod.simplify(
                path_c, rcfg.rdp_epsilon, return_index=True
            )
            bos_wp = np.maximum(radii_c[idx], rcfg.min_bos)
            wps = np.asarray(wps, np.float64)
        if len(wps) == 2:   # a straight shot has no free derivatives
            # insert a CERTIFIED interior point: the full corridor node
            # nearest the chord midpoint.  The chord midpoint itself may
            # lie up to rdp_epsilon off the certified path (RDP keeps
            # only endpoints when every node is within epsilon of the
            # chord), i.e. possibly inside an obstacle — a tight bound
            # box there would pin the optimizer in collision.
            mid = 0.5 * (wps[0] + wps[1])
            full_p = path_c
            if len(full_p) > 2:
                full_r = radii_c
                j = 1 + int(np.argmin(
                    np.linalg.norm(full_p[1:-1] - mid, axis=1)
                ))
                wps = np.insert(wps, 1, full_p[j], axis=0)
                bos_wp = np.insert(
                    bos_wp, 1, max(float(full_r[j]), rcfg.min_bos)
                )
            else:
                # 2-node corridor [state, end node]: the state->end
                # chord is NOT a certified tree edge (trim_passed may
                # have collapsed a longer corridor to just the final
                # node, and the flown state can sit outside every
                # ball), so clamp the midpoint into the end node's
                # safe ball before pinning a bound box around it
                r_end = float(radii_c[-1])
                dvec = mid - wps[1]
                dn = float(np.linalg.norm(dvec))
                if dn > 0.9 * r_end:
                    mid = wps[1] + dvec * (0.9 * r_end / max(dn, 1e-12))
                wps = np.insert(wps, 1, mid, axis=0)
                bos_wp = np.insert(bos_wp, 1, min(bos_wp[0], bos_wp[1]))
        # the refinement must CARRY the vehicle's velocity/acceleration
        # into the first segment's fixed derivatives (the reference's
        # startVel/startAcc contract, qp_generator.cpp:12-16, 425-431)
        # — re-solving from rest every tick makes each flown
        # replan_dt window cover only the quintic's initial crawl
        # (measured 0.1 m/tick on the opti_node map) AND tears the
        # flown velocity at tick boundaries.  The kino-seeded batch
        # path takes full knot states, so the corridor waypoints ride
        # it as knots: interior/goal knots at rest, the start knot at
        # the flown state.
        n_k = len(wps)
        kvel = np.zeros((n_k, 3))
        kacc = np.zeros((n_k, 3))
        kvel[0] = state[3:]
        kacc[0] = state_acc
        T_alloc = qp.allocate_times(
            jnp.asarray(wps, jnp.float32), ocfg.mean_v, ocfg.init_time
        )
        sol_b = solve_mod.solve_kino_batch(
            dist_grid[None], origin[None], jnp.asarray(
                [resolution], jnp.float32
            ),
            jnp.asarray(wps, jnp.float32)[None],
            jnp.asarray(kvel, jnp.float32)[None],
            jnp.asarray(kacc, jnp.float32)[None],
            T_alloc[None],
            cfg=ocfg_tick, steps=steps, record_trace=False,
            bos_wp=jnp.asarray(bos_wp, jnp.float32)[None],
        )
        sol = jax.tree.map(lambda x: x[0], sol_b)

        # 3. fly replan_dt along the refined trajectory
        t_fly = min(rcfg.replan_dt, float(jnp.sum(sol.T)))
        p, v, a, _, _, dmin = _fly_tick(
            sol.coeff, sol.T, jnp.asarray(t_fly, jnp.float32), dist_grid,
            origin, jnp.asarray(resolution, jnp.float32),
        )
        t_now += t_fly
        state = np.concatenate([np.asarray(p), np.asarray(v)]).astype(
            np.float64
        )
        state_acc = np.asarray(a, np.float64)

        # 4. commit the flown-past tree (resetRoot); failures (vehicle
        #    outside every path ball after a sharp refinement) just skip
        #    the commit — the tree stays valid, only uncommitted.  Once
        #    the commit point is inside the END node's ball the reference
        #    flags commit_end (terminal: the remaining path is one safe
        #    ball) — we stop committing and let the per-tick refinement
        #    finish the approach to goal_tol.
        if not planner.commit_end:
            planner.reset_root(state[:3])

        results.append(
            TickResult(
                state=state.copy(), coeff=np.asarray(sol.coeff),
                times=np.asarray(sol.T),
                reached_goal=bool(
                    np.linalg.norm(goal - state[:3]) <= rcfg.goal_tol
                ),
                search_ok=True, min_clearance=float(dmin),
            )
        )
        if results[-1].reached_goal:
            break
    return results
