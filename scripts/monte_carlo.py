"""Monte-Carlo driver: N random scenarios in compiled chunks.

BASELINE.md stress config: a 100k-scenario Monte-Carlo.  This driver
realizes the
scenario-count axis on whatever devices are visible: scenarios are
generated, EDT-transformed and solved in fixed-size chunks (one jit
compile serves every chunk), aggregate statistics accumulate on the
host, and progress checkpoints let a preempted run resume
(grad_traj_optimization_tpu.checkpoint).  On a multi-device mesh each
chunk is sharded over the "data" axis via parallel.mesh.sharded_solve.

Usage: python scripts/monte_carlo.py [n_total] [chunk] [ckpt_path]
Prints one JSON line per progress interval and a final summary line.
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
    n_total = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    ckpt_path = sys.argv[3] if len(sys.argv) > 3 else "/tmp/gtop_mc_ckpt"

    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import checkpoint, fixtures
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig
    from grad_traj_optimization_tpu.fields import sdf
    from grad_traj_optimization_tpu.parallel import mesh as pmesh

    cfg = OptimizerConfig()
    n_dev = len(jax.devices())
    m = pmesh.make_mesh(n_space=1) if n_dev > 1 else None

    # resume if a checkpoint exists
    state = {
        "done": np.zeros((), np.int64),
        "n_ok": np.zeros((), np.int64),
        "cost_sum": np.zeros((), np.float64),
        "cost_max": np.zeros((), np.float64),
        "accept_sum": np.zeros((), np.float64),
    }
    if os.path.exists(ckpt_path) or os.path.exists(ckpt_path + ".npz"):
        state = checkpoint.restore(ckpt_path, state)
        print(json.dumps(
            {"resumed_at": int(state["done"])}), flush=True)

    from grad_traj_optimization_tpu.config import MapConfig

    map_cfg = MapConfig(
        origin=(-10.0, -10.0, 0.0), resolution=0.2,
        map_size=(20.0, 20.0, 5.0),
    )
    origin = jnp.asarray(map_cfg.origin, jnp.float32)
    res = map_cfg.resolution

    @jax.jit
    def gen_chunk(key):
        # fully on-device: PRNG boxes -> occupancy -> EDT (no host
        # generation, no obstacle-point transfer over the link)
        occ, wps = fixtures.random_scenarios_device(
            key, chunk, n_waypoints=7, map_cfg=map_cfg
        )
        return sdf.edt_batch(occ, res), wps

    t0 = time.perf_counter()
    t_solve = 0.0
    ck = int(state["done"]) // chunk
    while int(state["done"]) < n_total:
        ts = time.perf_counter()
        # deterministic per chunk -> resumable
        dist, wps = gen_chunk(jax.random.key(1000 + ck))
        scns = solve_mod.Scenario(
            dist=dist,
            origin=jnp.broadcast_to(origin, (chunk, 3)),
            resolution=jnp.full((chunk,), res, jnp.float32),
            waypoints=jnp.asarray(wps, jnp.float32),
        )
        if m is not None:
            sols = pmesh.sharded_solve(scns, m, cfg=cfg, steps=(2,))
        else:
            sols = solve_mod.solve_batch(
                scns, cfg=cfg, steps=(2,), record_trace=False
            )
        n_ok = int(jnp.sum(sols.status == 0))
        cost = np.asarray(sols.cost, np.float64)
        acc = float(jnp.sum(sols.n_accept))
        t_solve += time.perf_counter() - ts

        state["done"] = state["done"] + chunk
        state["n_ok"] = state["n_ok"] + n_ok
        state["cost_sum"] = state["cost_sum"] + cost.sum()
        state["cost_max"] = np.maximum(state["cost_max"], cost.max())
        state["accept_sum"] = state["accept_sum"] + acc
        ck += 1
        if ck % 8 == 0 or int(state["done"]) >= n_total:
            checkpoint.save(ckpt_path, state)
            done = int(state["done"])
            print(json.dumps({
                "done": done,
                "n_ok": int(state["n_ok"]),
                "mean_cost": round(float(state["cost_sum"]) / done, 3),
                "device_solves_per_s": round(done / max(t_solve, 1e-9), 1),
            }), flush=True)

    done = int(state["done"])
    wall = time.perf_counter() - t0
    print(json.dumps({
        "metric": "monte_carlo",
        "n_scenarios": done,
        "n_ok": int(state["n_ok"]),
        "mean_cost": round(float(state["cost_sum"]) / done, 3),
        "max_cost": round(float(state["cost_max"]), 3),
        "mean_accept": round(float(state["accept_sum"]) / done, 2),
        "wall_s": round(wall, 1),
        "end_to_end_solves_per_s": round(done / wall, 1),
        "device_solves_per_s": round(done / max(t_solve, 1e-9), 1),
        "n_devices": n_dev,
    }), flush=True)


if __name__ == "__main__":
    main()
