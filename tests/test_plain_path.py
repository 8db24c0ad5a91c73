"""The plain XLA refine path against the float64 oracle, the exact-crop
lookup frame, the EDT, and the runtime guards (removed options, int32
field buffer, native loader, host rung, compile cache, chip_smoke)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grad_traj_optimization_tpu import native
from grad_traj_optimization_tpu import solver as solve_mod
from grad_traj_optimization_tpu.config import MapConfig, OptimizerConfig
from grad_traj_optimization_tpu.core import poly, qp
from grad_traj_optimization_tpu.fields import sdf
from grad_traj_optimization_tpu.reference_impl import golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wall_scene():
    """10x10x4 m map with a gapped wall across y=0; 5 waypoints."""
    map_cfg = MapConfig(
        origin=(-5.0, -5.0, 0.0), resolution=0.25, map_size=(10.0, 10.0, 4.0)
    )
    obss = np.array([
        (x, 0.0, z)
        for x in np.arange(-2.0, 2.0, 0.25)
        for z in np.arange(0.1, 4.0, 0.25)
        if abs(x) > 0.6
    ])
    wp = np.array([[0.0, -3.0, 2.0], [0.3, -1.5, 2.0], [0.0, 0.0, 2.0],
                   [-0.3, 1.5, 2.0], [0.0, 3.0, 2.0]])
    return map_cfg, obss, wp


def _pillar_scene(map_cfg, n_pillars, n_wp, seed, half=0.5):
    """Random square pillars through the whole height, waypoints along y."""
    rng = np.random.default_rng(seed)
    o = np.asarray(map_cfg.origin)
    ext = np.asarray(map_cfg.map_size)
    r = map_cfg.resolution
    obss = np.array([
        (x, y, z)
        for cx, cy in rng.uniform(o[:2] + 0.3 * ext[:2],
                                  o[:2] + 0.7 * ext[:2], (n_pillars, 2))
        for x in np.arange(cx - half, cx + half, r)
        for y in np.arange(cy - half, cy + half, r)
        for z in np.arange(0.05, ext[2], r)
    ])
    ymid = o[1] + 0.5 * ext[1]
    wp = np.stack([
        rng.uniform(-1.5, 1.5, n_wp) + o[0] + 0.5 * ext[0],
        np.linspace(ymid - 0.35 * ext[1], ymid + 0.35 * ext[1], n_wp),
        rng.uniform(0.4, 0.6, n_wp) * ext[2],
    ], -1)
    return map_cfg, obss, wp


def _golden_map(map_cfg, obss):
    gm = golden.GoldenSDFMap(map_cfg.origin, map_cfg.resolution,
                             map_cfg.map_size)
    for p in obss:
        gm.set_occupancy(p)
    gm.update_esdf()
    return gm


def _max_gap(coeff, T, coeff_g, times_g, n=150):
    """Max position gap between a solution and oracle coefficients."""
    T = np.asarray(T, np.float64)
    ts = np.linspace(1e-3, T.sum() - 1e-3, n)
    p = np.asarray(poly.evaluate(coeff, jnp.asarray(T, jnp.float32),
                                 jnp.asarray(ts, jnp.float32)))
    edges = np.cumsum(np.asarray(times_g, np.float64))
    pg = np.zeros((n, 3))
    for i, t in enumerate(ts):
        s = min(int(np.searchsorted(edges, t, side="right")), len(edges) - 1)
        tl = t - (edges[s - 1] if s > 0 else 0.0)
        pg[i] = coeff_g[s] @ np.array([tl**j for j in range(6)])
    return float(np.abs(p - pg).max())


def _batch(map_cfg, obss, wps, shared=False):
    scn = solve_mod.make_scenario(wps[0], obss, map_cfg)
    B = len(wps)
    return solve_mod.Scenario(
        dist=scn.dist[None] if shared else jnp.stack([scn.dist] * B),
        origin=jnp.broadcast_to(scn.origin, (B, 3)),
        resolution=jnp.broadcast_to(scn.resolution, (B,)),
        waypoints=jnp.asarray(np.stack(wps), jnp.float32),
    )


_ORACLE_CASES = {
    # the properties the whole-descent kernel was checked for, now on
    # the plain vmapped path (both steps of the reference schedule)
    "reference": (_wall_scene, dict(iters_step1=4, iters_step2=10)),
    "va_penalties": (_wall_scene, dict(
        iters_step1=3, iters_step2=10, alpha_v=0.1, v0=1.0, alpha_a=0.1,
        a0=1.5)),
    "nonmonotone": (_wall_scene, dict(
        iters_step1=4, iters_step2=10, accept_window=4)),
    "many_waypoints": (lambda: _pillar_scene(
        MapConfig(origin=(-10.0, -10.0, 0.0), resolution=0.25,
                  map_size=(20.0, 20.0, 5.0)), 6, 11, 0),
        dict(iters_step1=3, iters_step2=10)),
    "multitile_200": (lambda: _pillar_scene(
        MapConfig(origin=(-25.0, -25.0, 0.0), resolution=0.25,
                  map_size=(50.0, 50.0, 2.0)), 6, 5, 4),
        dict(iters_step1=3, iters_step2=6)),
}


@pytest.mark.parametrize("case", sorted(_ORACLE_CASES))
def test_solve_batch_matches_float64_oracle(case):
    """Every lane of the batched plain path tracks the float64 oracle
    within the 1e-3 m parity budget (BASELINE.md)."""
    scene, kw = _ORACLE_CASES[case]
    map_cfg, obss, wp = scene()
    cfg = OptimizerConfig(**kw)
    wps = [wp, wp + np.array([0.15, 0.0, 0.1])]
    sols = solve_mod.solve_batch(_batch(map_cfg, obss, wps), cfg=cfg,
                                 steps=(1, 2))
    assert np.all(np.asarray(sols.status) == solve_mod.STATUS_OK)
    gm = _golden_map(map_cfg, obss)
    for b, w in enumerate(wps):
        gopt = golden.GoldenOptimizer(gm, cfg)
        gopt.setup(w)
        _, coeff_g = gopt.optimize(steps=(1, 2))
        gap = _max_gap(sols.coeff[b], sols.T[b], coeff_g, gopt.times)
        assert gap < 1e-3, f"{case} lane {b}: {gap} m"


def test_solve_batch_exact_gradient_mode_matches_single():
    """gradient_mode='exact' on the batched path: every lane equals its
    unbatched solve and the descent lowers the cost."""
    map_cfg, obss, wp = _wall_scene()
    cfg = OptimizerConfig(iters_step1=3, iters_step2=8,
                          gradient_mode="exact")
    wps = [wp, wp + np.array([0.15, 0.0, 0.1])]
    batch = _batch(map_cfg, obss, wps)
    sols = solve_mod.solve_batch(batch, cfg=cfg, steps=(1, 2),
                                 record_trace=True)
    for b in range(2):
        one = solve_mod.Scenario(*jax.tree.map(lambda x: x[b], batch))
        s1 = solve_mod.solve(one, cfg=cfg, steps=(1, 2))
        np.testing.assert_array_equal(int(sols.n_accept[b]),
                                      int(s1.n_accept))
        np.testing.assert_allclose(np.asarray(sols.dp[b]),
                                   np.asarray(s1.dp), rtol=1e-5, atol=1e-5)
        tr = np.asarray(sols.cost_trace[b])[cfg.iters_step1:]
        assert tr[-1] < tr[0]


def test_solve_batch_shared_map_equals_copies():
    """A shared map (dist leading dim 1) and per-lane copies of it give
    bitwise the same solves."""
    map_cfg, obss, wp = _wall_scene()
    cfg = OptimizerConfig(iters_step1=3, iters_step2=10)
    wps = [wp, wp + np.array([0.15, 0.0, 0.1]),
           wp + np.array([-0.1, 0.05, 0.0])]
    s_sh = solve_mod.solve_batch(_batch(map_cfg, obss, wps, shared=True),
                                 cfg=cfg, steps=(1, 2))
    s_cp = solve_mod.solve_batch(_batch(map_cfg, obss, wps), cfg=cfg,
                                 steps=(1, 2))
    for a, b in zip(s_sh, s_cp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_solve_kino_batch_matches_float64_oracle():
    """The kino-seeded batch (setKinoPath: times, fixed derivatives and
    seed from knot states) tracks the oracle run from the same seed."""
    map_cfg, obss, wp = _wall_scene()
    rng = np.random.default_rng(4)
    B = 2
    pos = np.stack([wp, wp + np.array([0.1, 0.0, -0.1])]).astype(np.float32)
    vel = rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    acc = rng.uniform(-0.2, 0.2, pos.shape).astype(np.float32)
    vel[:, [0, -1]] = 0.0
    acc[:, [0, -1]] = 0.0
    times = np.full((B, len(wp) - 1), 1.2, np.float32)
    cfg = OptimizerConfig(iters_step2=10)
    scn = solve_mod.make_scenario(wp, obss, map_cfg)
    sol = solve_mod.solve_kino_batch(
        scn.dist[None], np.broadcast_to(np.asarray(map_cfg.origin), (B, 3)),
        np.full((B,), map_cfg.resolution), pos, vel, acc, times, cfg=cfg,
    )
    assert np.all(np.asarray(sol.status) == solve_mod.STATUS_OK)
    gm = _golden_map(map_cfg, obss)
    for b in range(B):
        Df, dp0 = qp.kino_d(pos[b], vel[b], acc[b])
        gopt = golden.GoldenOptimizer(gm, cfg)
        gopt.setup(pos[b])
        gopt.times = times[b].astype(np.float64)
        gopt.deps = golden.GoldenDeps(gopt.times)
        gopt.Df = np.asarray(Df, np.float64)
        gopt.Dp0 = np.asarray(dp0, np.float64)
        _, coeff_g = gopt.optimize(steps=(2,))
        gap = _max_gap(sol.coeff[b], sol.T[b], coeff_g, gopt.times)
        assert gap < 1e-3, f"lane {b}: {gap} m"


@pytest.mark.parametrize("offset", [(0, 0, 0), (3, 5, 0), (8, 2, 4),
                                    (11, 9, 5)])
def test_trilinear_flat_crop_frame(offset):
    """A cropped window with its offset frame reads bitwise the full
    grid for in-window samples and out-of-map (-1, 0) outside it."""
    rng = np.random.default_rng(sum(offset))
    full = (17, 15, 11)
    win = (6, 6, 6)
    grid = rng.uniform(0.0, 3.0, full).astype(np.float32)
    origin = np.array([-1.0, 0.5, 0.0], np.float32)
    res = 0.2
    o = np.asarray(offset)
    crop = grid[o[0]:o[0] + win[0], o[1]:o[1] + win[1], o[2]:o[2] + win[2]]
    q = (origin + rng.uniform(-0.1, 1.1, (400, 3))
         * np.asarray(full) * res).astype(np.float32)
    args = (origin, np.float32(res), jnp.asarray(q))
    d_full, g_full = sdf.trilinear_flat(
        jnp.asarray(grid).reshape(-1), 0, full, *args
    )
    d_crop, g_crop = sdf.trilinear_flat(
        jnp.asarray(crop).reshape(-1), 0, win, *args,
        offset=jnp.asarray(o, jnp.int32), full=jnp.asarray(full, jnp.int32),
    )
    # in-window: every interpolation corner lies inside the crop
    lo = origin + (o + 0.5) * res
    hi = origin + (o + np.asarray(win) - 0.5) * res
    inside = np.all((q > lo + 1e-4) & (q < hi - 1e-4), axis=1)
    assert inside.sum() > 0
    np.testing.assert_array_equal(np.asarray(d_crop)[inside],
                                  np.asarray(d_full)[inside])
    np.testing.assert_array_equal(np.asarray(g_crop)[inside],
                                  np.asarray(g_full)[inside])
    outside = ~np.all((q > origin + o * res) &
                      (q < origin + (o + np.asarray(win)) * res), axis=1)
    assert np.all(np.asarray(d_crop)[outside] == -1.0)
    assert np.all(np.asarray(g_crop)[outside] == 0.0)


@pytest.mark.parametrize("shape", [(7, 9, 5), (13, 11, 17), (31, 3, 19)])
def test_minplus_edt_matches_native(shape):
    """The dense min-plus EDT (single grid and batch) equals the native
    Felzenszwalb transform at odd sizes."""
    if not native.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(shape[0])
    occ = (rng.random((2,) + shape) < 0.04).astype(np.float32)
    occ[0, 0, 0, 0] = 1.0
    res = 0.3
    one = np.asarray(sdf.edt(jnp.asarray(occ[0]), res))
    both = np.asarray(sdf.edt_batch(jnp.asarray(occ), res))
    for k in range(2):
        ref = native.edt(occ[k], res)
        np.testing.assert_allclose(both[k], ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(one, native.edt(occ[0], res), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("kw", [dict(lookup_mode="mxu"),
                                dict(lookup_mode="fused"),
                                dict(lookup_precision="high")])
def test_config_refuses_removed_lookup_options(kw):
    with pytest.raises(TypeError):
        OptimizerConfig(**kw)


def test_solve_batch_refuses_int32_overflowing_field_buffer():
    """8,590 bench maps hold more voxels than one int32-indexed buffer
    addresses; the batch is refused at trace time, never read wrong."""
    B = 8590
    abstract = solve_mod.Scenario(
        dist=jax.ShapeDtypeStruct((B, 100, 100, 25), jnp.float32),
        origin=jax.ShapeDtypeStruct((B, 3), jnp.float32),
        resolution=jax.ShapeDtypeStruct((B,), jnp.float32),
        waypoints=jax.ShapeDtypeStruct((B, 7, 3), jnp.float32),
    )
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(
            lambda s: solve_mod.solve_batch(s, cfg=OptimizerConfig()),
            abstract,
        )
    ok = abstract._replace(
        dist=jax.ShapeDtypeStruct((B - 1, 100, 100, 25), jnp.float32)
    )
    shapes = jax.eval_shape(
        lambda s: solve_mod._vmapped_solve(s, OptimizerConfig(), (2,),
                                           False),
        ok._replace(
            origin=jax.ShapeDtypeStruct((B - 1, 3), jnp.float32),
            resolution=jax.ShapeDtypeStruct((B - 1,), jnp.float32),
            waypoints=jax.ShapeDtypeStruct((B - 1, 7, 3), jnp.float32),
        ),
    )
    assert shapes.cost.shape == (B - 1,)


def test_plan_batch_host_fallback_raises_without_native(monkeypatch):
    from grad_traj_optimization_tpu import pipeline

    def broken():
        raise RuntimeError("native build failed: no compiler")

    monkeypatch.setattr(native, "load", broken)
    z = np.zeros((1, 6), np.float32)
    with pytest.raises(RuntimeError, match="native build failed"):
        pipeline.plan_batch(np.zeros((1, 8, 8, 4), np.float32),
                            np.zeros(3, np.float32), 0.25, z, z,
                            host_fallback=True)


def _native_copy(tmp_path):
    d = tmp_path / "native"
    d.mkdir()
    for name in native._SOURCES:
        shutil.copy(os.path.join(native._NATIVE_DIR, name), d / name)
    return str(d)


@pytest.mark.parametrize("fault", ["foreign_host", "stale_source",
                                   "missing_stamp"])
def test_native_loader_refuses_foreign_or_stale_build(tmp_path,
                                                      monkeypatch, fault):
    """A library is current only when its stamp names these exact sources
    built on this host; anything else is rebuilt, never loaded as is."""
    d = _native_copy(tmp_path)
    lib = os.path.join(d, native._LIB_NAME)
    with open(lib, "wb") as f:
        f.write(b"not a library")
    with open(lib + ".stamp", "w") as f:
        f.write(native._stamp(d) + "\n")
    assert native._is_current(d)
    if fault == "foreign_host":
        monkeypatch.setattr(native, "_host_id", lambda: "another-host")
    elif fault == "stale_source":
        with open(os.path.join(d, "gtop_core.cpp"), "a") as f:
            f.write("\n// edited\n")
    else:
        os.remove(lib + ".stamp")
    assert not native._is_current(d)


def test_native_build_failure_raises(tmp_path):
    d = _native_copy(tmp_path)
    with open(os.path.join(d, "gtop_core.cpp"), "w") as f:
        f.write("this is not C++\n")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build(d)
    assert not native._is_current(d)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    from grad_traj_optimization_tpu.utils import compile_cache

    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
        want = str(tmp_path / "cc")
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = os.path.join(str(tmp_path), ".jax_cache")
    assert compile_cache.cache_dir(str(tmp_path)) == want


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no verdict on a machine
    without a GPU, and in a directory holding nothing else of the repo."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def gpu_device():
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    return devs[0]


@pytest.mark.gpu
def test_gpu_solve_matches_float64_oracle(gpu_device):
    """chip_smoke's B=1 phase at test size: the GPU solve tracks the
    float64 oracle within 1e-3 m."""
    map_cfg, obss, wp = _wall_scene()
    cfg = OptimizerConfig(iters_step1=10, iters_step2=25)
    with jax.default_device(gpu_device):
        scn = solve_mod.make_scenario(wp, obss, map_cfg)
        sol = solve_mod.solve(scn, cfg=cfg)
    gopt = golden.GoldenOptimizer(_golden_map(map_cfg, obss), cfg)
    gopt.setup(wp)
    _, coeff_g = gopt.optimize(steps=(2,))
    assert _max_gap(sol.coeff, sol.T, coeff_g, gopt.times) < 1e-3
