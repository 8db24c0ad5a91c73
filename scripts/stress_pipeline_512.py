"""512^3 stress pipeline: EDT -> exact crop -> batched solve.

Runs the BASELINE.md stress shape as ONE pipeline on the device:

1. rasterize a random 512^3 map (0.2 m resolution = a 102 m cube,
   the reference's sdf_map dense-buffer shape at stress scale),
2. the exact EDT (dense min-plus passes),
3. a 256-scenario shared-map batch (waypoint sets clustered in a
   20 m working volume — a realistic mission pocket in a big map),
4. solver.crop_scenarios (EXACT cell-boundary crop, global frame)
   down to the mission pocket,
5. the batched solve on the cropped window.

Prints one JSON line with per-stage and end-to-end timings.

Run: python scripts/stress_pipeline_512.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig
    from grad_traj_optimization_tpu.fields import sdf

    N = 512
    RES = 0.2
    B = 256
    origin = jnp.asarray([-51.2, -51.2, 0.0], jnp.float32)
    cfg = OptimizerConfig()
    rng = np.random.default_rng(0)

    # random pillar field across the whole cube (on-device rasterize)
    n_pts = 200_000
    pts = np.stack(
        [
            rng.uniform(-51.0, 51.0, n_pts),
            rng.uniform(-51.0, 51.0, n_pts),
            rng.uniform(0.2, 102.0, n_pts),
        ],
        axis=1,
    ).astype(np.float32)
    # keep a mission pocket around the waypoints passable
    keep = ~(
        (np.abs(pts[:, 0]) < 10.0)
        & (np.abs(pts[:, 1]) < 10.0)
        & (np.abs(pts[:, 2] - 10.0) < 6.0)
    ) | (rng.random(n_pts) < 0.02)
    pts = pts[keep]
    pts_d = jax.device_put(jnp.asarray(pts))

    @jax.jit
    def build(p):
        occ = sdf.rasterize(p, origin, RES, (N, N, N))
        return sdf.edt(occ, RES)

    sync = jax.block_until_ready
    t0 = time.perf_counter()
    dist = sync(build(pts_d))
    t_edt_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist = sync(build(pts_d))
    t_edt = time.perf_counter() - t0

    # mission waypoints: 7 per scenario inside the pocket
    wps = np.stack(
        [
            np.stack(
                [
                    np.linspace(-7, 7, 7) + rng.uniform(-0.5, 0.5, 7),
                    rng.uniform(-7, 7, 7),
                    10.0 + rng.uniform(-2, 2, 7),
                ],
                axis=1,
            )
            for _ in range(B)
        ]
    ).astype(np.float32)
    scns = solve_mod.Scenario(
        dist=dist[None],
        origin=jnp.broadcast_to(origin, (B, 3)),
        resolution=jnp.full((B,), RES, jnp.float32),
        waypoints=jnp.asarray(wps),
    )

    t0 = time.perf_counter()
    cropped = solve_mod.crop_scenarios(scns, cfg)
    jax.block_until_ready(cropped.dist)
    t_crop = time.perf_counter() - t0
    crop_shape = list(cropped.dist.shape[1:])

    run = lambda: solve_mod.solve_batch(
        cropped, cfg=cfg, steps=(2,), record_trace=False
    )
    s = run()
    sync(s)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sync(run())
        times.append(time.perf_counter() - t0)
    t_solve = min(times)

    # end-to-end warm pipeline: EDT + crop + solve
    t0 = time.perf_counter()
    d2 = build(pts_d)
    scns2 = scns._replace(dist=d2[None])
    c2 = solve_mod.crop_scenarios(scns2, cfg)
    sync(
        solve_mod.solve_batch(c2, cfg=cfg, steps=(2,), record_trace=False)
    )
    t_e2e = time.perf_counter() - t0

    print(
        json.dumps({
            "grid": [N, N, N],
            "batch": B,
            "crop_grid": crop_shape,
            "edt_cold_s": round(t_edt_cold, 2),
            "edt_warm_s": round(t_edt, 3),
            "crop_s": round(t_crop, 3),
            "solve_s": round(t_solve, 3),
            "solves_per_s": round(B / t_solve, 1),
            "pipeline_e2e_s": round(t_e2e, 3),
            "n_ok": int(jnp.sum(s.status == 0)),
        }),
        flush=True,
    )


if __name__ == "__main__":
    main()
