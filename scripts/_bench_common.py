"""Shared scaffolding for the benchmark scripts: the bench scenario
batch (random_scenarios seed 42, device-resident EDT build) and its
start/goal assembly."""

from __future__ import annotations

import numpy as np


def build_bench_batch(B: int, seed: int = 42, n_waypoints: int = 7):
    """Bench-shaped batch: (dist, origins_b, res, starts, goals)."""
    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import fixtures
    from grad_traj_optimization_tpu.fields import sdf

    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        B, n_waypoints=n_waypoints, seed=seed,
        max_obstacle_points=4096,
    )
    grid = map_cfg.grid_shape
    origin = jnp.asarray(map_cfg.origin, jnp.float32)
    res = map_cfg.resolution

    @jax.jit
    def build_fields(pts, valid):
        occ = jax.vmap(
            lambda p, v: sdf.rasterize(p, origin, res, grid,
                                       valid_mask=v)
        )(pts.astype(jnp.float32), valid)
        return sdf.edt_batch(occ, res)

    dist = jax.block_until_ready(build_fields(
        jax.device_put(jnp.asarray(pts, jnp.float32)),
        jax.device_put(jnp.asarray(valid)),
    ))
    starts = np.concatenate(
        [np.asarray(wps)[:, 0], np.zeros((B, 3))], axis=1
    ).astype(np.float32)
    goals = np.concatenate(
        [np.asarray(wps)[:, -1], np.zeros((B, 3))], axis=1
    ).astype(np.float32)
    origins_b = np.broadcast_to(np.asarray(origin), (B, 3))
    return dist, origins_b, res, starts, goals, wps
