"""Penalty cost/gradient vs the float64 golden port, and descent behavior."""

import numpy as np
import jax.numpy as jnp

from grad_traj_optimization_tpu.config import OptimizerConfig
from grad_traj_optimization_tpu.core import qp
from grad_traj_optimization_tpu.fields import sdf
from grad_traj_optimization_tpu.opt import penalty
from grad_traj_optimization_tpu.reference_impl import golden


def _small_problem(seed=0):
    """A small map + 5-waypoint problem solvable in tests."""
    rng = np.random.default_rng(seed)
    origin = np.array([-5.0, -5.0, 0.0])
    res = 0.25
    size = (10.0, 10.0, 4.0)
    gm = golden.GoldenSDFMap(origin, res, size)
    # a wall with a gap
    for x in np.arange(-2.0, 2.0, res):
        for z in np.arange(0.1, 4.0, res):
            if abs(x) > 0.6:
                gm.set_occupancy(np.array([x, 0.0, z]))
    gm.update_esdf()

    wp = np.array(
        [
            [0.0, -3.0, 2.0],
            [0.3, -1.5, 2.0],
            [0.0, 0.0, 2.0],
            [-0.3, 1.5, 2.0],
            [0.0, 3.0, 2.0],
        ]
    )
    cfg = OptimizerConfig()
    gopt = golden.GoldenOptimizer(gm, cfg)
    gopt.setup(wp)
    return gm, gopt, wp, cfg


def _jax_ctx(gopt, wp, cfg):
    T = jnp.asarray(gopt.times, jnp.float32)
    Df = jnp.asarray(gopt.Df, jnp.float32)
    ctx = penalty.build_ctx(T, Df, cfg)
    grid = jnp.asarray(gopt.map.dist, jnp.float32)
    origin = jnp.asarray(gopt.map.origin, jnp.float32)
    field, shape = penalty.make_field(grid, origin, gopt.map.resolution)
    return ctx, field, shape


def test_cost_and_grad_matches_golden():
    gm, gopt, wp, cfg = _small_problem()
    ctx, field, shape = _jax_ctx(gopt, wp, cfg)

    rng = np.random.default_rng(1)
    for trial in range(3):
        dp = gopt.Dp0 + 0.3 * rng.standard_normal(gopt.Dp0.shape)
        c_g, g_g = gopt.cost_and_grad(dp, step=2)
        c_j, g_j = penalty.cost_and_grad(
            jnp.asarray(dp, jnp.float32), ctx, field, shape, cfg, step=2
        )
        # cost is a continuous functional -> tight
        assert abs(float(c_j) - c_g) / max(abs(c_g), 1.0) < 2e-3
        # the trilinear gradient is piecewise per voxel cell: an f32 sample
        # landing on a cell face can legitimately pick the neighboring
        # cell's slope, so pointwise entries get a loose bound while the
        # overall direction must agree tightly
        g_j = np.asarray(g_j)
        cos = np.sum(g_j * g_g) / (
            np.linalg.norm(g_j) * np.linalg.norm(g_g)
        )
        assert cos > 0.999
        np.testing.assert_allclose(
            g_j, g_g, rtol=0.15, atol=0.02 * np.abs(g_g).max()
        )


def test_cost_only_consistent_with_cost_and_grad():
    gm, gopt, wp, cfg = _small_problem()
    ctx, field, shape = _jax_ctx(gopt, wp, cfg)
    dp = jnp.asarray(gopt.Dp0, jnp.float32)
    c1, _ = penalty.cost_and_grad(dp, ctx, field, shape, cfg, step=2)
    c2 = penalty.cost_only(dp, ctx, field, shape, cfg, step=2)
    np.testing.assert_allclose(float(c1), float(c2), rtol=1e-6)


def test_exact_gradient_matches_autodiff():
    """The 'exact' gradient mode must match jax.grad of the identical
    sampled cost (the 'reference' mode intentionally does not: it
    replicates the C++ formula's extra cd factor and +1e-5 bias).
    Finite differences are unsuitable here: the trilinear field makes the
    cost piecewise-smooth with kinks at voxel faces."""
    import jax

    gm, gopt, wp, _ = _small_problem()
    cfg = OptimizerConfig(gradient_mode="exact")
    ctx, field, shape = _jax_ctx(gopt, wp, cfg)

    dp0 = jnp.asarray(gopt.Dp0 + 0.1, jnp.float32)
    _, g = penalty.cost_and_grad(dp0, ctx, field, shape, cfg, step=2)
    g_auto = jax.grad(
        lambda dp: penalty.cost_only(dp, ctx, field, shape, cfg, step=2)
    )(dp0)
    g, g_auto = np.asarray(g), np.asarray(g_auto)
    np.testing.assert_allclose(
        g, g_auto, rtol=1e-3, atol=1e-3 * np.abs(g_auto).max()
    )


def test_va_penalty_matches_golden():
    """Velocity/acceleration penalties on (reference gradient mode,
    CLICK-style scales) vs the float64 faithful loop port."""
    gm, gopt, wp, _ = _small_problem()
    cfg = OptimizerConfig(
        alpha_v=0.1, v0=1.0, r_v=1.5, alpha_a=0.1, a0=1.5, r_a=1.5
    )
    gopt = golden.GoldenOptimizer(gm, cfg)
    gopt.setup(wp)
    ctx, field, shape = _jax_ctx(gopt, wp, cfg)

    rng = np.random.default_rng(7)
    for trial in range(3):
        dp = gopt.Dp0 + 0.3 * rng.standard_normal(gopt.Dp0.shape)
        c_g, g_g = gopt.cost_and_grad(dp, step=2)
        c_j, g_j = penalty.cost_and_grad(
            jnp.asarray(dp, jnp.float32), ctx, field, shape, cfg, step=2
        )
        assert abs(float(c_j) - c_g) / max(abs(c_g), 1.0) < 2e-3
        g_j = np.asarray(g_j)
        cos = np.sum(g_j * g_g) / (
            np.linalg.norm(g_j) * np.linalg.norm(g_g)
        )
        assert cos > 0.999
        np.testing.assert_allclose(
            g_j, g_g, rtol=0.15, atol=0.02 * np.abs(g_g).max()
        )
        # the penalties actually contribute: zeroing them changes cost
        cfg0 = OptimizerConfig()
        ctx0, field0, shape0 = _jax_ctx(gopt, wp, cfg0)
        c_off = penalty.cost_only(
            jnp.asarray(dp, jnp.float32), ctx0, field0, shape0, cfg0,
            step=2,
        )
        assert float(c_j) > float(c_off) + 1e-3


def test_va_penalty_step1_inactive():
    """Step 1 skips the vel/acc block (the reference gates it on
    step == 2, grad_traj_optimizer.cpp:385)."""
    gm, gopt, wp, _ = _small_problem()
    cfg_on = OptimizerConfig(alpha_v=0.2, alpha_a=0.2)
    cfg_off = OptimizerConfig()
    gopt_on = golden.GoldenOptimizer(gm, cfg_on)
    gopt_on.setup(wp)
    ctx_on, field, shape = _jax_ctx(gopt_on, wp, cfg_on)
    ctx_off, _, _ = _jax_ctx(gopt_on, wp, cfg_off)
    dp = jnp.asarray(gopt_on.Dp0, jnp.float32)
    c_on, g_on = penalty.cost_and_grad(dp, ctx_on, field, shape, cfg_on,
                                       step=1)
    c_off, g_off = penalty.cost_and_grad(dp, ctx_off, field, shape,
                                         cfg_off, step=1)
    np.testing.assert_allclose(float(c_on), float(c_off), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(g_on), np.asarray(g_off),
                               rtol=1e-6)


def test_exact_va_gradient_matches_autodiff():
    """Exact mode with vel/acc penalties on must match jax.grad of the
    identical sampled cost (reference mode intentionally does not: no
    sign(v)/sign(a), stale cv/ca quirk)."""
    import jax

    gm, gopt, wp, _ = _small_problem()
    cfg = OptimizerConfig(
        gradient_mode="exact", alpha_v=0.1, v0=1.0, alpha_a=0.1, a0=1.5
    )
    gopt = golden.GoldenOptimizer(gm, cfg)
    gopt.setup(wp)
    ctx, field, shape = _jax_ctx(gopt, wp, cfg)

    dp0 = jnp.asarray(gopt.Dp0 + 0.1, jnp.float32)
    _, g = penalty.cost_and_grad(dp0, ctx, field, shape, cfg, step=2)
    g_auto = jax.grad(
        lambda dp: penalty.cost_only(dp, ctx, field, shape, cfg, step=2)
    )(dp0)
    g, g_auto = np.asarray(g), np.asarray(g_auto)
    np.testing.assert_allclose(
        g, g_auto, rtol=2e-3, atol=2e-3 * np.abs(g_auto).max()
    )


def test_bounds_layout():
    gm, gopt, wp, cfg = _small_problem()
    lb_g, ub_g = gopt.bounds()
    lb, ub = penalty.bounds(wp, gopt.deps.num_dp, cfg)
    np.testing.assert_allclose(np.asarray(lb), lb_g)
    np.testing.assert_allclose(np.asarray(ub), ub_g)
