"""End-to-end trajectory solve: Scenario batch -> Solution batch.

The reference pipeline (src/opti_node.cpp:47-147) is an object graph:
``GradTrajOptimizer`` holding an ``SDFMap``, NLopt callbacks, mutable
coefficient state.  Here the whole thing is one pure function::

    solve(scenario, ...) -> Solution

jitted once per (grid shape, waypoint count, config) and scaled with
``vmap`` over scenarios and ``jax.sharding`` over a device mesh
(see :mod:`grad_traj_optimization_tpu.parallel`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from grad_traj_optimization_tpu.config import MapConfig, OptimizerConfig
from grad_traj_optimization_tpu.core import poly, qp
from grad_traj_optimization_tpu.fields import sdf
from grad_traj_optimization_tpu.opt import descent, penalty

STATUS_OK = 0
STATUS_DIVERGED = 1  # NaN/Inf appeared (per-scenario failure detection)


class Scenario(NamedTuple):
    """One trajectory-planning problem instance (a pytree).

    dist: (nx, ny, nz) distance field in meters.
    origin: (3,) map origin.
    resolution: () voxel size.
    waypoints: (m+1, 3) path to seed from.
    grid_offset/grid_full: set by :func:`crop_scenarios` — ``dist`` is
      the [offset, offset+shape) cell window of a ``grid_full``-cell
      map whose origin is still ``origin`` (the exact-crop frame: all
      coordinate arithmetic stays global, so cropped lookups are
      bitwise-identical to the full map for in-window samples).  None
      for ordinary full-grid scenarios.
    """

    dist: jnp.ndarray
    origin: jnp.ndarray
    resolution: jnp.ndarray
    waypoints: jnp.ndarray
    grid_offset: jnp.ndarray | None = None   # (3,) int32 cell offset
    grid_full: jnp.ndarray | None = None     # (3,) int32 full extents


class Solution(NamedTuple):
    coeff: jnp.ndarray       # (m, 3, 6) ascending-power coefficients
    T: jnp.ndarray           # (m,) segment times
    cost: jnp.ndarray        # () final cost
    cost_trace: jnp.ndarray  # (total iters,) monotone cost envelope
    n_accept: jnp.ndarray    # () accepted descent iterations
    dp: jnp.ndarray          # (3, 3m-3) optimized free derivatives
    status: jnp.ndarray      # () STATUS_*


def make_scenario(
    waypoints,
    obstacle_points,
    map_cfg: MapConfig,
    valid_mask=None,
    dist=None,
) -> Scenario:
    """Build a Scenario, rasterizing + EDT-transforming obstacles.

    (Reference flow: initSDFMap + updateSDFMap, grad_traj_optimizer.cpp:
    112-126.)  Pass ``dist`` directly to reuse a prebuilt field.
    """
    origin = jnp.asarray(map_cfg.origin, dtype=jnp.float32)
    res = jnp.asarray(map_cfg.resolution, dtype=jnp.float32)
    if dist is None:
        occ = sdf.rasterize(
            jnp.asarray(obstacle_points, dtype=jnp.float32),
            origin,
            map_cfg.resolution,
            map_cfg.grid_shape,
            valid_mask=valid_mask,
        )
        dist = sdf.edt(occ, map_cfg.resolution)
    return Scenario(
        dist=dist,
        origin=origin,
        resolution=res,
        waypoints=jnp.asarray(waypoints, dtype=jnp.float32),
    )


def _dual_arm_cfgs(cfg: OptimizerConfig):
    """The two arm configs of seed_mode='dual' (see OptimizerConfig)."""
    cfg_a = dataclasses.replace(cfg, seed_mode="reference",
                                polish_iters=0)
    cfg_b = dataclasses.replace(
        cfg,
        seed_mode="min_snap",
        iters_step2=cfg.dual_ms_iters or cfg.iters_step2,
        accept_window=cfg.dual_ms_window or cfg.accept_window,
        polish_iters=0,
    )
    return cfg_a, cfg_b


def _polish_cfg(cfg: OptimizerConfig) -> OptimizerConfig:
    """Config of the post-race polish restart (step 2 only)."""
    return dataclasses.replace(
        cfg, seed_mode="reference", polish_iters=0,
        iters_step2=cfg.polish_iters,
    )


def _combine_dual(sa: Solution, sb: Solution) -> Solution:
    """Per-lane best of two Solution arms (non-finite cost loses)."""
    ca = jnp.where(jnp.isfinite(sa.cost), sa.cost, jnp.inf)
    cb = jnp.where(jnp.isfinite(sb.cost), sb.cost, jnp.inf)
    better = cb < ca

    def sel(a, b):
        bt = better.reshape(
            better.shape + (1,) * (a.ndim - better.ndim)
        )
        return jnp.where(bt, b, a)

    # traces may differ in length (dual_ms_iters): edge-pad the shorter
    # so the winner's monotone envelope is preserved
    ta, tb = sa.cost_trace, sb.cost_trace
    L = max(ta.shape[-1], tb.shape[-1])

    def pad_edge(t):
        pad = [(0, 0)] * (t.ndim - 1) + [(0, L - t.shape[-1])]
        return jnp.pad(t, pad, mode="edge") if L > t.shape[-1] else t

    return Solution(
        coeff=sel(sa.coeff, sb.coeff),
        T=sa.T,
        cost=sel(sa.cost, sb.cost),
        cost_trace=sel(pad_edge(ta), pad_edge(tb)),
        n_accept=sel(sa.n_accept, sb.n_accept),
        dp=sel(sa.dp, sb.dp),
        status=sel(sa.status, sb.status),
    )


def _merge_polish(win: Solution, sp: Solution) -> Solution:
    """Fold a post-race polish run into the race winner.

    The polish starts AT the winner's iterate, so its best-seen cost is
    <= the winner's up to the fresh-BB first step; per-lane the lower
    cost wins.  Cost traces concatenate so the monotone envelope spans
    the full schedule (the polish trace is clamped by the winner's
    final envelope value).
    """
    better = sp.cost < win.cost

    def sel(a, b):
        bt = better.reshape(better.shape + (1,) * (a.ndim - better.ndim))
        return jnp.where(bt, b, a)

    tw, tp = win.cost_trace, sp.cost_trace
    if tw.shape[-1] and tp.shape[-1]:
        trace = jnp.concatenate(
            [tw, jnp.minimum(tp, tw[..., -1:])], axis=-1
        )
    else:
        trace = tw
    return Solution(
        coeff=sel(win.coeff, sp.coeff),
        T=win.T,
        cost=jnp.minimum(win.cost, sp.cost),
        cost_trace=trace,
        n_accept=win.n_accept + sp.n_accept,
        dp=sel(win.dp, sp.dp),
        status=sel(win.status, sp.status),
    )


def _seed_dp(Df, dep, dp0, lb, ub, cfg: OptimizerConfig):
    """Initial free derivatives per cfg.seed_mode (unbatched)."""
    if cfg.seed_mode == "min_snap":
        return jnp.clip(qp.min_snap_dp(Df, dep.Rpp, dep.Rfp), lb, ub)
    return dp0


def _solve_field(
    field: penalty.Field,
    grid_shape: tuple[int, int, int],
    waypoints,
    cfg: OptimizerConfig,
    steps: tuple[int, ...],
    record_trace: bool,
    bos_wp=None,
    dp_init=None,
    T=None,
    Df=None,
) -> Solution:
    """Core unbatched solve against a prepared Field.

    ``T``/``Df`` override the waypoint-derived segment times and fixed
    derivatives — the setKinoPath seeding path (grad_traj_optimizer.
    cpp:35-65), where times come from the search and the fixed block
    carries the start/end kino states (pass ``dp_init`` from
    qp.kino_d alongside).
    """
    wp = waypoints
    if T is None:
        T = qp.allocate_times(wp, cfg.mean_v, cfg.init_time)
    Df_wp, dp0 = qp.straight_line_d(wp)
    if Df is None:
        Df = Df_wp
    dep = qp.build_dep(T)
    ctx = penalty.build_ctx(T, Df, cfg, dep=dep)
    num_dp = dp0.shape[1]
    lb, ub = penalty.bounds(
        wp, num_dp, cfg, dtype=wp.dtype,
        bos=None if bos_wp is None else bos_wp[1 : 1 + num_dp // 3],
    )
    dp0 = _seed_dp(Df, dep, dp0, lb, ub, cfg)
    if dp_init is not None:
        dp0 = jnp.clip(dp_init, lb, ub)

    dp = dp0
    traces = []
    n_acc = jnp.zeros((), jnp.int32)
    cost = jnp.zeros(())
    for step in steps:
        cag = functools.partial(
            penalty.cost_and_grad,
            ctx=ctx,
            field=field,
            grid_shape=grid_shape,
            cfg=cfg,
            step=step,
        )
        co = functools.partial(
            penalty.cost_only,
            ctx=ctx,
            field=field,
            grid_shape=grid_shape,
            cfg=cfg,
            step=step,
        )
        iters = cfg.iters_step1 if step == 1 else cfg.iters_step2
        res = descent.minimize(
            cag, co, dp, lb, ub, iters, cfg, record_trace=record_trace
        )
        dp, cost = res.dp, res.cost
        n_acc = n_acc + res.n_accept
        traces.append(res.cost_trace)

    coeff = qp.coeff_from_d(Df, dp, T)
    bad = jnp.logical_not(
        jnp.isfinite(cost) & jnp.all(jnp.isfinite(dp))
    )
    status = jnp.where(bad, STATUS_DIVERGED, STATUS_OK).astype(jnp.int32)
    # failure recovery: fall back to the (always finite) seed on divergence
    dp_safe = jnp.where(bad, dp0, dp)
    coeff = jnp.where(bad, qp.coeff_from_d(Df, dp0, T), coeff)
    return Solution(
        coeff=coeff,
        T=T,
        cost=cost,
        cost_trace=jnp.concatenate(traces) if traces else jnp.zeros((0,)),
        n_accept=n_acc,
        dp=dp_safe,
        status=status,
    )


def solve(
    scenario: Scenario,
    cfg: OptimizerConfig = OptimizerConfig(),
    steps: tuple[int, ...] = (2,),
    record_trace: bool = True,
    bos_wp=None,
) -> Solution:
    """Solve one scenario.

    ``steps`` follows the reference two-step schedule
    (grad_traj_optimizer.cpp:128-148, 413-415): step 1 optimizes collision
    only (ws = 0), step 2 the full cost.  The active demo (opti_node.cpp:
    104) runs only step 2; pass ``steps=(1, 2)`` for the full schedule.

    ``bos_wp``: optional (n_wp,) per-waypoint position-bound half-widths
    (a search corridor's clearance radii) replacing the scalar
    ``cfg.bos`` — see penalty.bounds.
    """
    if scenario.grid_offset is None and _autocrop_candidate(
        scenario.dist.shape, cfg, scenario
    ):
        batch = Scenario(*jax.tree.map(lambda x: x[None], scenario))
        batch = _maybe_autocrop(
            batch, cfg, bos_wp=bos_wp,
            key_leaves=(scenario.dist, scenario.waypoints),
        )
        if batch.grid_offset is not None:
            scenario = Scenario(*jax.tree.map(lambda x: x[0], batch))
    return _solve_jit(
        scenario, cfg=cfg, steps=steps, record_trace=record_trace,
        bos_wp=bos_wp,
    )


def _scenario_field(scenario: Scenario):
    """Field handle + static grid shape of one (unbatched) scenario."""
    field, grid_shape = penalty.make_field(
        scenario.dist, scenario.origin, scenario.resolution
    )
    return field._replace(
        offset=scenario.grid_offset, full=scenario.grid_full
    ), grid_shape


@functools.partial(
    jax.jit, static_argnames=("cfg", "steps", "record_trace")
)
def _solve_jit(
    scenario: Scenario,
    cfg: OptimizerConfig,
    steps: tuple[int, ...],
    record_trace: bool,
    bos_wp=None,
) -> Solution:
    """The single-scenario solve (see :func:`solve`)."""
    if cfg.seed_mode == "dual":
        cfg_a, cfg_b = _dual_arm_cfgs(cfg)
        win = _combine_dual(
            solve(scenario, cfg=cfg_a, steps=steps,
                  record_trace=record_trace, bos_wp=bos_wp),
            solve(scenario, cfg=cfg_b, steps=steps,
                  record_trace=record_trace, bos_wp=bos_wp),
        )
        if cfg.polish_iters > 0:
            field, grid_shape = _scenario_field(scenario)
            sp = _solve_field(
                field, grid_shape, scenario.waypoints, _polish_cfg(cfg),
                (2,), record_trace, bos_wp=bos_wp, dp_init=win.dp,
            )
            win = _merge_polish(win, sp)
        return win
    field, grid_shape = _scenario_field(scenario)
    return _solve_field(
        field, grid_shape, scenario.waypoints, cfg, steps, record_trace,
        bos_wp=bos_wp,
    )


def _is_traced(scenarios) -> bool:
    """True when any leaf is a tracer (inside jit/vmap — host-side
    decisions like auto-crop must then be skipped)."""
    return any(
        isinstance(leaf, jax.core.Tracer)
        for leaf in jax.tree.leaves(scenarios)
    )


#: grids below this voxel count skip the auto-crop attempt: deciding
#: the window reads the waypoints back to the host, which only pays off
#: when the crop can remove a large fraction of a LARGE grid.
_AUTO_CROP_MIN_VOXELS = 1 << 19


def _autocrop_candidate(grid_shape, cfg: OptimizerConfig, scenarios):
    return (
        cfg.auto_crop
        and int(np.prod(grid_shape)) >= _AUTO_CROP_MIN_VOXELS
        and not _is_traced(scenarios)
    )


def _maybe_autocrop(
    scenarios: Scenario,
    cfg: OptimizerConfig,
    bos_wp=None,
    key_leaves=None,
) -> Scenario:
    """Apply exact cropping when the batch qualifies (the reference's
    own map shape, opti_node.cpp:61, should take it by default).

    Conditions: concrete inputs, ``cfg.auto_crop``, a grid large enough
    for cropping to pay (>= ``_AUTO_CROP_MIN_VOXELS``), and an uncropped
    qualifying batch (shared origin, uniform resolution).  Anything else
    returns the batch unchanged.

    ``bos_wp``: per-waypoint position-bound half-widths when the caller
    passes them to solve/solve_batch (the RRT-corridor path).  The crop
    window must cover the LARGEST bound or in-bounds iterates could
    cross the crop face and read the -1 deep-collision sentinel; the
    margin is widened by ``max(bos_wp) - cfg.bos`` when positive.

    ``key_leaves``: optional (dist, waypoints) pair to key the decision
    cache on — solve() passes its UNBATCHED leaves so repeated B=1
    solves hit the cache even though the [None]-expanded batch leaves
    are rebuilt per call.
    """
    if scenarios.grid_offset is not None or not _autocrop_candidate(
        scenarios.dist.shape[1:], cfg, scenarios
    ):
        return scenarios
    margin = cfg.crop_margin
    if bos_wp is not None:
        if _is_traced((bos_wp,)):
            return scenarios  # cannot widen for an unknown bound
        margin += max(0.0, float(np.max(np.asarray(bos_wp))) - cfg.bos)
    # the crop decision reads the waypoints back to the host and
    # dispatches a slice — cache it for REPEATED solves of the same
    # arrays (replan ticks, serving, benchmarking all re-solve identical
    # Scenario leaves).  Strong refs in the cache keep the ids valid.
    # Only immutable device arrays are cached: id-keying a mutable host
    # numpy array would return a stale crop after an in-place edit +
    # re-solve.
    if key_leaves is None:
        key_leaves = (scenarios.dist, scenarios.waypoints)
    cacheable = all(
        isinstance(x, jax.Array) for x in key_leaves
    )
    key = (
        id(key_leaves[0]), id(key_leaves[1]),
        cfg.bos, margin, cfg.n_samples,
    )
    if cacheable:
        hit = _AUTOCROP_CACHE.get(key)
        if hit is not None and hit[0] is key_leaves[0] and (
            hit[1] is key_leaves[1]
        ):
            return hit[2]
    try:
        cropped = crop_scenarios(scenarios, cfg, margin=margin)
    except ValueError:  # mixed origins/resolutions
        return scenarios
    if cacheable:
        if len(_AUTOCROP_CACHE) > 8:
            _AUTOCROP_CACHE.pop(next(iter(_AUTOCROP_CACHE)))
        _AUTOCROP_CACHE[key] = (
            key_leaves[0], key_leaves[1], cropped,
        )
    return cropped


#: (id(dist), id(waypoints), cfg key) -> (dist, waypoints, cropped)
_AUTOCROP_CACHE: dict = {}


def solve_batch(
    scenarios: Scenario,
    cfg: OptimizerConfig = OptimizerConfig(),
    steps: tuple[int, ...] = (2,),
    record_trace: bool = False,
    bos_wp=None,
    dp0=None,
) -> Solution:
    """Solve a batch: every leaf of ``scenarios`` has a leading batch axis.

    To share one map across the whole batch, pass ``dist`` with leading
    dimension 1 (other leaves batched normally) — the single grid is
    closed over, not copied.

    The distance grids are flattened into ONE buffer closed over by the
    vmapped body; each lane indexes its slab by an int32 offset, so the
    grids may hold at most 2^31 voxels in all (ValueError otherwise).
    This keeps the hot trilinear lookup a single flat gather instead of
    a per-scenario batched gather.

    With concrete inputs and ``cfg.auto_crop`` (the default), qualifying
    batches are exact-cropped to their waypoint window before dispatch
    (see :func:`crop_scenarios`).
    """
    scenarios = _maybe_autocrop(scenarios, cfg, bos_wp=bos_wp)
    return _solve_batch_jit(
        scenarios, cfg=cfg, steps=steps, record_trace=record_trace,
        bos_wp=bos_wp, dp0=dp0,
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "steps", "record_trace")
)
def _solve_batch_jit(
    scenarios: Scenario,
    cfg: OptimizerConfig,
    steps: tuple[int, ...],
    record_trace: bool,
    bos_wp=None,
    dp0=None,
) -> Solution:
    if cfg.seed_mode == "dual":
        # race both seeds through this same dispatch; per-lane best wins
        cfg_a, cfg_b = _dual_arm_cfgs(cfg)
        win = _combine_dual(
            solve_batch(scenarios, cfg=cfg_a, steps=steps,
                        record_trace=record_trace, bos_wp=bos_wp,
                        dp0=dp0),
            solve_batch(scenarios, cfg=cfg_b, steps=steps,
                        record_trace=record_trace, bos_wp=bos_wp,
                        dp0=dp0),
        )
        if cfg.polish_iters > 0:
            # post-race polish: restart every lane's descent from its
            # winner (fresh BB state).  Polish-ALL, deliberately: the
            # gather-the-neediest variant measured slower end-to-end
            # (see OptimizerConfig.polish_iters).
            sp = solve_batch(
                scenarios, cfg=_polish_cfg(cfg), steps=(2,),
                record_trace=record_trace, bos_wp=bos_wp, dp0=win.dp,
            )
            win = _merge_polish(win, sp)
        return win
    return _vmapped_solve(
        scenarios, cfg, steps, record_trace, bos_wp=bos_wp, dp0=dp0
    )


#: most voxels one flat int32-indexed field buffer may hold (the last
#: flat index, 2^31 - 1, is the largest int32)
_MAX_FLAT_VOXELS = 1 << 31


def _vmapped_solve(scenarios: Scenario, cfg: OptimizerConfig, steps,
                   record_trace: bool, bos_wp=None, dp0=None, T=None,
                   Df=None) -> Solution:
    """vmap of :func:`_solve_field` over a Scenario batch whose grids
    are flattened into one buffer (shared when ``dist`` has leading
    dimension 1)."""
    B = scenarios.waypoints.shape[0]
    n_grids = scenarios.dist.shape[0]
    grid_shape = scenarios.dist.shape[1:]
    nvox = int(np.prod(grid_shape))
    if n_grids * nvox > _MAX_FLAT_VOXELS:
        raise ValueError(
            f"{n_grids} grids of {tuple(grid_shape)} hold "
            f"{n_grids * nvox} voxels; one int32-indexed field buffer "
            f"holds at most {_MAX_FLAT_VOXELS} — split the batch"
        )
    flat_all = scenarios.dist.reshape(-1)
    if n_grids == 1:
        bases = jnp.zeros((B,), jnp.int32)  # shared map
    else:
        bases = jnp.arange(B, dtype=jnp.int32) * nvox

    def one(base, origin, resolution, waypoints, offset, full, bwp, dpi,
            Ti, Dfi):
        field = penalty.Field(
            flat=flat_all, base=base, origin=origin,
            resolution=resolution, offset=offset, full=full,
        )
        return _solve_field(
            field, grid_shape, waypoints, cfg, steps, record_trace,
            bos_wp=bwp, dp_init=dpi, T=Ti, Df=Dfi,
        )

    return jax.vmap(one)(
        bases, scenarios.origin, scenarios.resolution,
        scenarios.waypoints, scenarios.grid_offset, scenarios.grid_full,
        bos_wp, dp0, T, Df,
    )


def crop_scenarios(
    scenarios: Scenario,
    cfg: OptimizerConfig = OptimizerConfig(),
    margin: float = 2.0,
    multiple: int = 8,
) -> Scenario:
    """Crop each scenario's grid to a static window around its waypoints.

    The descent's position variables are box-bounded within ``cfg.bos`` of
    the interior waypoints (grad_traj_optimizer.cpp:154-177), so the
    trajectory can only be pulled ``bos`` (+ overshoot) away from the
    waypoint bounding box — the rest of the grid is dead weight in the
    lookups.  Cropping shrinks the field each lane reads.

    The crop window covers every waypoint ± (bos + margin), snapped to
    whole cells; one static shape (the batch max, rounded up to
    ``multiple``) serves the whole batch so the solve stays jittable.
    Shared-map batches (``dist`` leading dim 1) take ONE union window
    over all scenarios' waypoints, preserving the shared-map path (no
    per-scenario grid copies).

    The crop is EXACT for in-window queries: the returned Scenario keeps
    the GLOBAL ``origin`` and records the integer cell offset + the full
    extents (``grid_offset``/``grid_full``); the lookup
    (fields.sdf.trilinear_flat) does all floor/frac coordinate arithmetic
    in the global frame and only the final cell index subtracts the
    offset, so in-window lookups are bitwise-identical to the full grid.
    The remaining approximation is
    the window boundary itself: queries outside the window (or within
    half a cell of an interior crop face) read as out-of-map (-1, the
    reference's deep-collision sentinel, sdf_map.cpp:187) — a restoring
    penalty in the rare case a mid-optimization iterate overshoots the
    ``margin``.
    """
    # ONE device->host transfer for everything the window needs
    wps, origins, res_all = jax.device_get(
        (scenarios.waypoints, scenarios.origin, scenarios.resolution)
    )
    wps = np.asarray(wps, np.float64)  # (B, n_wp, 3)
    origins = np.asarray(origins, np.float64)  # (B, 3)
    res_all = np.asarray(res_all, np.float64)
    res = float(res_all.reshape(-1)[0])
    if not np.allclose(res_all, res):
        raise ValueError("crop_scenarios needs a uniform resolution batch")
    if not np.allclose(origins, origins[0]):
        raise ValueError("crop_scenarios needs a shared-origin batch")
    if scenarios.grid_offset is not None:
        raise ValueError("scenarios are already cropped")
    grid = np.asarray(scenarios.dist.shape[1:])  # (3,)
    B = wps.shape[0]
    shared = scenarios.dist.shape[0] == 1

    half = cfg.bos + margin
    lo = wps.min(axis=1) - half  # (B, 3)
    hi = wps.max(axis=1) + half
    if shared:  # one union window -> one shared cropped grid
        lo = np.broadcast_to(lo.min(axis=0), lo.shape)
        hi = np.broadcast_to(hi.max(axis=0), hi.shape)
    i_lo = np.floor((lo - origins) / res).astype(np.int64)
    i_hi = np.ceil((hi - origins) / res).astype(np.int64) + 1
    i_lo = np.clip(i_lo, 0, grid[None, :])
    i_hi = np.clip(i_hi, 0, grid[None, :])

    ext = (i_hi - i_lo).max(axis=0)  # (3,)
    shape = tuple(
        int(min(g, -(-e // multiple) * multiple))
        for e, g in zip(ext, grid)
    )
    if shape == tuple(grid):
        return scenarios
    offset = np.clip(i_lo, 0, grid[None, :] - np.asarray(shape)[None, :])

    @functools.partial(jax.jit, static_argnames=("shp",))
    def _slice(dist, off, shp):
        return jax.vmap(
            lambda d, o: jax.lax.dynamic_slice(d, (o[0], o[1], o[2]), shp)
        )(dist, off)

    n_grids = scenarios.dist.shape[0]
    new_dist = _slice(
        scenarios.dist, jnp.asarray(offset[:n_grids], jnp.int32), shape
    )
    return Scenario(
        dist=new_dist,
        origin=scenarios.origin,
        resolution=scenarios.resolution,
        waypoints=scenarios.waypoints,
        grid_offset=jnp.asarray(offset, jnp.int32),
        grid_full=jnp.broadcast_to(
            jnp.asarray(grid, jnp.int32), (B, 3)
        ),
    )


def solve_kino_batch(
    dists,
    origins,
    resolutions,
    pos,
    vel,
    acc,
    times,
    cfg: OptimizerConfig = OptimizerConfig(),
    steps: tuple[int, ...] = (2,),
    record_trace: bool = False,
    bos_wp=None,
) -> Solution:
    """Batched setKinoPath + optimizeTrajectory (the reference's
    search-seeded back-end, grad_traj_optimizer.cpp:35-65 + compare2's
    refinement stage :233-321): Hermite-seed from search knot states
    and refine under bounds centered on the knot positions.

    Args:
      dists: (B, nx, ny, nz) or (1, ...) shared; origins (B, 3);
      resolutions (B,); pos/vel/acc (B, m+1, 3) knot states;
      times (B, m) segment durations.
    """
    pos = jnp.asarray(pos, jnp.float32)
    scn = Scenario(
        dist=jnp.asarray(dists),
        origin=jnp.asarray(origins, jnp.float32),
        resolution=jnp.asarray(resolutions, jnp.float32),
        waypoints=pos,
    )
    T = jnp.asarray(times, jnp.float32)
    Df, dp0 = jax.vmap(qp.kino_d)(
        pos, jnp.asarray(vel, jnp.float32), jnp.asarray(acc, jnp.float32)
    )
    scn = _maybe_autocrop(scn, cfg, bos_wp=bos_wp)
    return _solve_kino_jit(
        scn, T, Df, dp0, cfg=cfg, steps=steps,
        record_trace=record_trace, bos_wp=bos_wp,
    )


def solve_kino_batch_race(
    dists,
    origins,
    resolutions,
    pos,
    vel,
    acc,
    times,
    stretches: tuple[float, ...] = (1.0, 1.2),
    cfg: OptimizerConfig = OptimizerConfig(),
    steps: tuple[int, ...] = (2,),
    bos_wp=None,
) -> Solution:
    """Batched seed-duration RACE (round 5): refine the same knot
    states under each duration ``stretch`` and keep the per-lane
    winner by final cost (converged arms preferred).

    This is the race that closed the beam-vs-hybrid quality gap on the
    gates (BEAM_VS_EXACT.md: duration is free at seeding —
    PolyKinoGeneration takes Time as an input, qp_generator.cpp:
    23-154) lifted to batch scale: each arm is one
    :func:`solve_kino_batch` dispatch, so a 2-arm race costs ~2x the
    back-end while the search stage is unchanged.
    """
    import jax.numpy as _jnp

    times = _jnp.asarray(times, _jnp.float32)
    best: Solution | None = None
    for s in stretches:
        sol = solve_kino_batch(
            dists, origins, resolutions, pos, vel, acc, times * s,
            cfg=cfg, steps=steps, record_trace=False, bos_wp=bos_wp,
        )
        if best is None:
            best = sol
            continue
        b_ok = best.status == 0
        s_ok = sol.status == 0
        take = _jnp.where(
            b_ok == s_ok, sol.cost < best.cost, s_ok
        )

        def sel(x, y):
            t = take.reshape((-1,) + (1,) * (x.ndim - 1))
            return _jnp.where(t, y, x)

        best = jax.tree.map(sel, best, sol)
    return best


@functools.partial(
    jax.jit, static_argnames=("cfg", "steps", "record_trace")
)
def _solve_kino_jit(
    scn: Scenario, T, Df, dp0,
    cfg: OptimizerConfig,
    steps: tuple[int, ...],
    record_trace: bool,
    bos_wp=None,
) -> Solution:
    """Kino-seeded batch solve (vmapped flat-buffer path)."""
    return _vmapped_solve(
        scn, cfg, steps, record_trace, bos_wp=bos_wp, dp0=dp0, T=T, Df=Df
    )


def evaluate_solution(sol: Solution, n: int = 400):
    """Reference-style evaluation metrics (opti_node.cpp:136-142)."""
    length = poly.length(sol.coeff, sol.T, n)
    jerk = poly.jerk_cost(sol.coeff, sol.T)
    mean_v, max_v = poly.mean_max_speed(sol.coeff, sol.T, n)
    mean_a, max_a = poly.mean_max_acc(sol.coeff, sol.T, n)
    return {
        "time_sum": jnp.sum(sol.T),
        "length": length,
        "jerk": jerk,
        "mean_v": mean_v,
        "max_v": max_v,
        "mean_a": mean_a,
        "max_a": max_a,
        "cost": sol.cost,
    }
