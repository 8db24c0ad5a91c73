"""Sharded solving and sharded EDT on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from grad_traj_optimization_tpu import solver as solve_mod
from grad_traj_optimization_tpu.config import MapConfig, OptimizerConfig
from grad_traj_optimization_tpu.fields import sdf
from grad_traj_optimization_tpu.parallel import edt_sharded, mesh as pmesh


def _tiny_batch(batch):
    map_cfg = MapConfig(
        origin=(-2.0, -2.0, 0.0), resolution=0.25, map_size=(4.0, 4.0, 2.0)
    )
    rng = np.random.default_rng(0)
    grid = map_cfg.grid_shape
    occ = (rng.random((batch,) + grid) < 0.05).astype(np.float32)
    dist = jax.vmap(lambda o: sdf.edt(o, map_cfg.resolution))(
        jnp.asarray(occ)
    )
    wps = rng.uniform(-1.2, 1.2, size=(batch, 5, 3)).astype(np.float32)
    wps[..., 2] = rng.uniform(0.5, 1.5, size=(batch, 5))
    return solve_mod.Scenario(
        dist=dist,
        origin=jnp.broadcast_to(
            jnp.asarray(map_cfg.origin, jnp.float32), (batch, 3)
        ),
        resolution=jnp.full((batch,), map_cfg.resolution, jnp.float32),
        waypoints=jnp.asarray(wps),
    )


def test_sharded_solve_matches_unsharded():
    assert len(jax.devices()) >= 8, "conftest should give 8 CPU devices"
    cfg = OptimizerConfig(iters_step1=3, iters_step2=5)
    scns = _tiny_batch(16)
    m = pmesh.make_mesh(n_data=8, n_space=1)
    sols_sharded = pmesh.sharded_solve(scns, m, cfg=cfg, steps=(2,))
    sols_local = solve_mod.solve_batch(
        scns, cfg=cfg, steps=(2,), record_trace=False
    )
    np.testing.assert_allclose(
        np.asarray(sols_sharded.coeff), np.asarray(sols_local.coeff),
        rtol=1e-5, atol=1e-5,
    )
    stats = pmesh.convergence_stats(sols_sharded)
    assert float(stats["n_ok"]) == 16.0


def test_sharded_edt_matches_local():
    m = pmesh.make_mesh(n_data=1, n_space=8)
    rng = np.random.default_rng(1)
    occ = (rng.random((40, 12, 6)) < 0.07).astype(np.float32)
    d_sh = edt_sharded.edt_sharded(jnp.asarray(occ), 0.2, m)
    d_loc = sdf.edt(jnp.asarray(occ), 0.2)
    np.testing.assert_allclose(
        np.asarray(d_sh), np.asarray(d_loc), rtol=1e-5, atol=1e-5
    )


def test_sharded_edt_empty_and_full():
    m = pmesh.make_mesh(n_data=1, n_space=4)
    occ = np.zeros((16, 8, 4), np.float32)
    d = edt_sharded.edt_sharded(jnp.asarray(occ), 0.5, m)
    np.testing.assert_allclose(np.asarray(d), sdf.FREE_DIST)
    occ[:] = 1.0
    d = edt_sharded.edt_sharded(jnp.asarray(occ), 0.5, m)
    np.testing.assert_allclose(np.asarray(d), 0.0)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_multiprocess_distributed_solve():
    """True multi-process bring-up: 2 worker processes x 4 virtual CPU
    devices each run jax.distributed + mesh.global_scenarios +
    sharded_solve on a global batch; the globally-reduced stats must
    match a single-process solve of the same problem."""
    import json
    import os
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "scripts", "multihost_worker.py")
    env = {
        k: v for k, v in os.environ.items() if k != "XLA_FLAGS"
    }  # workers set their own device count
    procs = []
    try:
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(i), "2", str(port)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                env=env,
            )
            for i in range(2)
        ]
        # drain both pipes concurrently (a worker blocked on a full pipe
        # while the other is being communicate()d would deadlock)
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            futs = [
                ex.submit(p.communicate, timeout=480) for p in procs
            ]
            outs = [f.result()[0] for f in futs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    result_lines = [
        ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")
    ]
    assert result_lines, outs[0][-3000:]
    stats = json.loads(result_lines[0][len("RESULT "):])
    assert stats["n_devices"] == 8
    assert stats["n_ok"] == 8.0

    # single-process reference on the identical global problem
    from grad_traj_optimization_tpu import fixtures

    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        8, n_waypoints=5, seed=11, max_obstacle_points=1024
    )
    origin = jnp.asarray(map_cfg.origin, jnp.float32)
    res = map_cfg.resolution
    occ = jax.vmap(
        lambda p, v: sdf.rasterize(
            p, origin, res, map_cfg.grid_shape, valid_mask=v
        )
    )(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    dist = sdf.edt_batch(occ, res)
    batch = solve_mod.Scenario(
        dist=dist,
        origin=jnp.broadcast_to(origin, (8, 3)),
        resolution=jnp.full((8,), res, jnp.float32),
        waypoints=jnp.asarray(wps, jnp.float32),
    )
    cfg = OptimizerConfig(iters_step1=5, iters_step2=15)
    sols = solve_mod.solve_batch(batch, cfg=cfg, steps=(2,))
    ref_mean = float(jnp.mean(sols.cost))
    assert abs(stats["mean_cost"] - ref_mean) < 1e-3 * abs(ref_mean)


def test_sharded_edt_512_sharded_axis():
    """Stress-scale sharded axis (round-3 VERDICT item 3a): the ring
    min-plus x-pass at the full 512-cell stress extent (the local y/z
    passes are embarrassingly parallel and shape-independent — they are
    held smaller to keep the suite fast), cross-checked against the
    native C++ exact Felzenszwalb oracle.  The full 512^3 run is
    recorded by scripts/stress_edt_sharded.py in SCALING.md."""
    import pytest

    from grad_traj_optimization_tpu import native

    if not native.available():
        pytest.skip("native engine unavailable")
    m = pmesh.make_mesh(n_data=1, n_space=8)
    rng = np.random.default_rng(3)
    occ = (rng.random((512, 96, 48)) < 5e-4).astype(np.float32)
    d_sh = edt_sharded.edt_sharded(jnp.asarray(occ), 0.2, m)
    d_ref = native.edt(occ, 0.2)
    np.testing.assert_allclose(
        np.asarray(d_sh), d_ref, rtol=1e-5, atol=1e-4
    )


def test_sharded_search_matches_local():
    """Round-5: mesh.sharded_search == search_batch bitwise over the
    8-device mesh, for both per-lane and shared (dim-1) maps."""
    from grad_traj_optimization_tpu import fixtures
    from grad_traj_optimization_tpu.parallel import mesh as pmesh
    from grad_traj_optimization_tpu.search import kinodynamic as kd

    rng = np.random.default_rng(5)
    cases = []
    while len(cases) < 8:
        c = fixtures.random_search_case(rng)
        if c is not None:
            cases.append(c)
    dists = np.stack([c[0] for c in cases])
    origins = np.stack([c[1] for c in cases]).astype(np.float32)
    res = cases[0][2]
    starts = np.stack(
        [np.concatenate([c[3], np.zeros(3)]) for c in cases]
    ).astype(np.float32)
    goals = np.stack(
        [np.concatenate([c[4], np.zeros(3)]) for c in cases]
    ).astype(np.float32)
    m = pmesh.make_mesh()
    kw = dict(max_iters=10, beam=16)
    r_sh = pmesh.sharded_search(dists, origins, res, starts, goals, m,
                                **kw)
    r_loc = kd.search_batch(dists, origins, res, starts, goals, **kw)
    for a, b in zip(r_sh, r_loc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # shared-map (leading dim 1) replication path
    r_sh2 = pmesh.sharded_search(dists[:1], origins, res, starts,
                                 goals, m, **kw)
    r_loc2 = kd.search_batch(dists[:1], origins, res, starts, goals,
                             **kw)
    for a, b in zip(r_sh2, r_loc2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sharded_search_dynamic_matches_local():
    """Round-5: sharded_search with obstacle_pred/start_times operands
    (batched prediction leaves split over data) == local batch."""
    from grad_traj_optimization_tpu import fixtures
    from grad_traj_optimization_tpu.parallel import mesh as pmesh
    from grad_traj_optimization_tpu.search import kinodynamic as kd
    from grad_traj_optimization_tpu.search import predictor

    rng = np.random.default_rng(6)
    cases = []
    while len(cases) < 8:
        c = fixtures.random_search_case(rng)
        if c is not None:
            cases.append(c)
    dists = np.stack([c[0] for c in cases])
    origins = np.stack([c[1] for c in cases]).astype(np.float32)
    res = cases[0][2]
    starts = np.stack(
        [np.concatenate([c[3], np.zeros(3)]) for c in cases]
    ).astype(np.float32)
    goals = np.stack(
        [np.concatenate([c[4], np.zeros(3)]) for c in cases]
    ).astype(np.float32)
    B = 8
    hist = np.tile(
        np.array([[[0.0, 0.0, 1.5], [0.2, 0.0, 1.5]]], np.float32),
        (B, 1, 1, 1),
    )
    hist_t = np.broadcast_to(
        np.array([[-0.5, 0.0]], np.float32), (B, 1, 2)
    )
    scale = np.full((B, 1, 3), 0.8, np.float32)
    pred_b = jax.vmap(predictor.fit_const_vel)(
        jnp.asarray(hist), jnp.asarray(hist_t), jnp.asarray(scale)
    )
    t0s = np.linspace(0.0, 0.7, B).astype(np.float32)
    m = pmesh.make_mesh()
    kw = dict(max_iters=10, beam=16)
    r_sh = pmesh.sharded_search(
        dists, origins, res, starts, goals, m, obstacle_pred=pred_b,
        start_times=t0s, **kw,
    )
    r_loc = kd.search_batch(
        dists, origins, res, starts, goals, obstacle_pred=pred_b,
        start_times=t0s, **kw,
    )
    for a, b in zip(r_sh, r_loc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # array-valued static kwargs are rejected with a clear error
    import pytest

    with pytest.raises(TypeError, match="static"):
        pmesh.sharded_search(
            dists, origins, res, starts, goals, m,
            bad_arg=np.zeros(8), **kw,
        )
