"""Device-side measurements of the refine loop and the EDT build.

    python scripts/profile_refine.py [out_dir]

Run on the GPU.  Prints one JSON line per measurement and writes the
profiler traces under ``out_dir`` (default ``profile_out/`` in the checkout):

* ``solve_b1024`` / ``solve_b1``: wall time of ``solve_batch`` on the
  bench fleet (100x100x25 maps, 7 waypoints, default config) at B=1024
  and of ``solve`` at B=1, each ending in ``block_until_ready``; and a
  profiler trace of one call, reduced to device kernels per descent
  iteration, device busy time and idle share.
* ``edt_fleet`` / ``edt_512``: the batched EDT of 1024 bench maps and
  the single-grid EDT of a 512^3 grid, with min-plus element operations
  per second and bytes moved per second.
* ``opti_node_crop``: the shared opti_node batch (256 lanes) on the
  full grid against the exact crop.

Wall times are medians of repeated warm calls; compilation is excluded
and reported separately where it is measured.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn, reps: int = 5) -> list[float]:
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def _union_ns(intervals) -> int:
    busy, end = 0, -1
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def trace_reduce(fn, log_dir: str) -> dict:
    """Trace one warm call of ``fn`` and reduce the device planes to
    kernel count, busy time (union of kernel intervals) and idle share
    of the window between the first kernel start and the last end."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn())
    jax.profiler.start_trace(log_dir)
    jax.block_until_ready(fn())
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    intervals, names = [], {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                intervals.append((ev.start_ns, ev.end_ns))
                names[ev.name] = names.get(ev.name, 0) + 1
    if not intervals:
        return {"kernels": 0}
    lo = min(s for s, _ in intervals)
    hi = max(e for _, e in intervals)
    busy = _union_ns(intervals)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return {
        "kernels": len(intervals),
        "distinct_kernels": len(names),
        "device_window_ms": (hi - lo) / 1e6,
        "device_busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / max(hi - lo, 1),
        "top_kernels": top,
    }


def main():
    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu import fixtures
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig
    from grad_traj_optimization_tpu.fields import sdf
    from grad_traj_optimization_tpu.utils import compile_cache

    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "profile_out"
    )
    os.makedirs(out_dir, exist_ok=True)
    compile_cache.enable(ROOT)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("profile_refine: no GPU found")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    emit(card=card, device_kind=dev.device_kind, jax=jax.__version__)

    cfg = OptimizerConfig()
    iters = cfg.iters_step2
    B = 1024
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        B, n_waypoints=7, seed=42, max_obstacle_points=4096
    )
    origin = jnp.asarray(map_cfg.origin, jnp.float32)
    res = map_cfg.resolution

    @jax.jit
    def occupancy(p, v):
        return jax.vmap(
            lambda pp, vv: sdf.rasterize(
                pp, origin, res, map_cfg.grid_shape, valid_mask=vv
            )
        )(p, v)

    occ = jax.block_until_ready(
        occupancy(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    )
    edt_b = jax.jit(lambda o: sdf.edt_batch(o, res))
    t0 = time.perf_counter()
    dist = jax.block_until_ready(edt_b(occ))
    t_compile = time.perf_counter() - t0
    ts = timed(lambda: edt_b(occ))
    nx, ny, nz = map_cfg.grid_shape
    # min-plus passes along y and x: lines * n_out * n_src add+min pairs
    ops = B * (nx * nz * ny * ny + ny * nz * nx * nx)
    nbytes = B * nx * ny * nz * 4 * 2 * 3  # read + write, 3 passes
    med = float(np.median(ts))
    emit(measure="edt_fleet", maps=B, grid=[nx, ny, nz],
         first_call_s=t_compile, median_s=med, reps_s=ts,
         minplus_pairs_per_s=ops / med, bytes_per_s=nbytes / med,
         trace=trace_reduce(lambda: edt_b(occ),
                            os.path.join(out_dir, "edt_fleet")))

    n = 512
    occ512 = (jax.random.uniform(jax.random.key(0), (n, n, n)) < 1e-4
              ).astype(jnp.float32)
    edt1 = jax.jit(lambda o: sdf.edt(o, 0.2))
    t0 = time.perf_counter()
    jax.block_until_ready(edt1(occ512))
    t_compile = time.perf_counter() - t0
    ts = timed(lambda: edt1(occ512), reps=3)
    med = float(np.median(ts))
    emit(measure="edt_512", grid=[n] * 3, first_call_s=t_compile,
         median_s=med, reps_s=ts, minplus_pairs_per_s=2 * n**4 / med,
         bytes_per_s=n**3 * 4 * 2 * 3 / med)
    del occ512

    scns = solve_mod.Scenario(
        dist=dist,
        origin=jnp.broadcast_to(origin, (B, 3)),
        resolution=jnp.full((B,), res, jnp.float32),
        waypoints=jnp.asarray(wps, jnp.float32),
    )
    run_b = lambda: solve_mod.solve_batch(scns, cfg=cfg)
    t0 = time.perf_counter()
    jax.block_until_ready(run_b())
    t_compile = time.perf_counter() - t0
    ts = timed(run_b)
    tr = trace_reduce(run_b, os.path.join(out_dir, "solve_b1024"))
    emit(measure="solve_b1024", first_call_s=t_compile,
         median_s=float(np.median(ts)), reps_s=ts,
         solves_per_s=B / float(np.median(ts)),
         kernels_per_iteration=tr.get("kernels", 0) / (iters + 1),
         trace=tr)

    one = jax.tree.map(lambda x: x[0], scns)
    run_1 = lambda: solve_mod.solve(one, cfg=cfg, record_trace=False)
    t0 = time.perf_counter()
    jax.block_until_ready(run_1())
    t_compile = time.perf_counter() - t0
    ts = timed(run_1, reps=30)
    tr = trace_reduce(run_1, os.path.join(out_dir, "solve_b1"))
    emit(measure="solve_b1", first_call_s=t_compile,
         p50_ms=1e3 * float(np.median(ts)),
         p90_ms=1e3 * float(np.percentile(ts, 90)),
         kernels_per_iteration=tr.get("kernels", 0) / (iters + 1),
         trace=tr)

    o_cfg, o_obss, o_wp = fixtures.opti_node_scenario()
    o_scn = solve_mod.make_scenario(o_wp, o_obss, o_cfg)
    lanes = 256
    rng = np.random.default_rng(3)
    o_wps = np.stack([
        o_wp + np.concatenate([rng.uniform(-0.3, 0.3, (len(o_wp), 2)),
                               np.zeros((len(o_wp), 1))], 1)
        for _ in range(lanes)
    ])
    batch = solve_mod.Scenario(
        dist=o_scn.dist[None],
        origin=jnp.broadcast_to(o_scn.origin, (lanes, 3)),
        resolution=jnp.broadcast_to(o_scn.resolution, (lanes,)),
        waypoints=jnp.asarray(o_wps, jnp.float32),
    )
    full_cfg = OptimizerConfig(auto_crop=False)
    cropped = solve_mod.crop_scenarios(batch, full_cfg)
    run_full = lambda: solve_mod.solve_batch(batch, cfg=full_cfg)
    run_crop = lambda: solve_mod.solve_batch(cropped, cfg=full_cfg)
    jax.block_until_ready((run_full(), run_crop()))
    t_full, t_crop = [], []
    for order in (0, 1, 1, 0):
        for which in ((0, 1) if order == 0 else (1, 0)):
            if which == 0:
                t_full += timed(run_full, reps=3)
            else:
                t_crop += timed(run_crop, reps=3)
    emit(measure="opti_node_crop", lanes=lanes,
         full_grid=list(batch.dist.shape[1:]),
         crop_grid=list(cropped.dist.shape[1:]),
         full_median_s=float(np.median(t_full)),
         crop_median_s=float(np.median(t_crop)),
         full_s=t_full, crop_s=t_crop)


if __name__ == "__main__":
    main()
