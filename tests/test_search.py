"""Front-end search layer: grid wavefront, RDP, predictor, kinodynamic."""

import numpy as np
import jax
import jax.numpy as jnp

from grad_traj_optimization_tpu.fields import sdf, dynamic
from grad_traj_optimization_tpu.search import (
    grid_search,
    kinodynamic,
    predictor,
    rdp,
)


def _wall_map():
    """10x10x4 m map, wall at y=0 with a gap around x in [-0.6, 0.6]."""
    origin = np.array([-5.0, -5.0, 0.0])
    res = 0.25
    pts = []
    for x in np.arange(-5.0, 5.0, res):
        for z in np.arange(0.1, 4.0, res):
            if abs(x) > 0.6:
                pts.append((x, 0.0, z))
    occ = sdf.rasterize(
        jnp.asarray(np.array(pts), jnp.float32),
        jnp.asarray(origin, jnp.float32), res, (40, 40, 16),
    )
    dist = sdf.edt(occ, res)
    return dist, origin, res


def test_grid_plan_through_gap():
    dist, origin, res = _wall_map()
    plan = grid_search.plan(
        dist, origin, res,
        np.array([0.0, -3.0, 2.0]), np.array([0.0, 3.0, 2.0]),
    )
    assert bool(plan.reached)
    n = int(plan.length)
    path = np.asarray(plan.path)[:n]
    # path endpoints at start/goal cells
    np.testing.assert_allclose(path[0], [0.125, -2.875, 2.125], atol=0.26)
    np.testing.assert_allclose(path[-1], [0.125, 3.125, 2.125], atol=0.26)
    # every path point keeps clearance
    d = np.asarray(sdf.distance_at(dist, jnp.asarray(origin, jnp.float32),
                                   res, jnp.asarray(path, jnp.float32)))
    assert (d >= 0.4 - 1e-6).all()
    # passes through the gap: where the path crosses y≈0, |x| < 0.6
    cross = path[np.abs(path[:, 1]) < 0.3]
    assert len(cross) > 0 and np.all(np.abs(cross[:, 0]) < 0.7)


def test_grid_plan_unreachable():
    dist, origin, res = _wall_map()
    # goal inside the wall (blocked by clearance) but endpoints are
    # unblocked by design; instead wall off completely: clearance so large
    # nothing passes
    plan = grid_search.plan(
        dist, origin, res,
        np.array([0.0, -3.0, 2.0]), np.array([0.0, 3.0, 2.0]),
        clearance=10.0,
    )
    assert not bool(plan.reached)


def test_grid_plan_long_serpentine_corridor():
    """A maze whose shortest path is ~2000 cells: the old fixed
    1024-sweep cap silently returned an unconverged field and a false
    reached=False here (the path needs ~1950 relaxations); the
    cell-count bound + converged flag fix it."""
    n = 64
    res = 0.25
    origin = np.array([0.0, 0.0, 0.0])
    dist = np.full((n, n, 1), 10.0, np.float32)
    # serpentine: walls across x, alternating gap at x=0 / x=n-1
    for row, y in enumerate(range(2, n - 2, 2)):
        dist[:, y, 0] = 0.0
        if row % 2 == 0:
            dist[n - 2 :, y, 0] = 10.0
        else:
            dist[:2, y, 0] = 10.0
    start = origin + (np.array([1, 1, 0]) + 0.5) * res
    goal = origin + (np.array([1, n - 2, 0]) + 0.5) * res
    plan = grid_search.plan(
        jnp.asarray(dist), origin, res, start, goal, clearance=0.1,
        max_len=4096,
    )
    assert bool(plan.converged)
    assert bool(plan.reached)
    npath = int(plan.length)
    assert npath > 600  # the path really snakes
    # path stays on corridor cells
    path = np.asarray(plan.path)[:npath]
    idx = np.floor((path - origin) / res).astype(int)
    assert (dist[idx[:, 0], idx[:, 1], idx[:, 2]] > 0.1).all()


def test_rdp_matches_shape():
    # a dense L-shaped path simplifies to ~3 points
    a = np.stack([np.linspace(0, 1, 50), np.zeros(50), np.zeros(50)], -1)
    b = np.stack([np.ones(50), np.linspace(0, 1, 50), np.zeros(50)], -1)
    curve = np.concatenate([a, b], axis=0)
    simp = rdp.simplify(curve, epsilon=0.01)
    assert 3 <= len(simp) <= 5
    np.testing.assert_allclose(simp[0], curve[0])
    np.testing.assert_allclose(simp[-1], curve[-1])


def test_rdp_keeps_deviating_point():
    curve = np.array(
        [[0, 0, 0], [1, 0.5, 0], [2, 0, 0]], dtype=np.float64
    )
    simp = rdp.simplify(curve, epsilon=0.1)
    assert len(simp) == 3  # middle point deviates > eps


def test_rdp_masked_matches_host():
    """simplify_masked keeps a superset of points within the same epsilon
    tolerance, and the masked polyline stays within epsilon of the host
    result's geometry."""
    rng = np.random.default_rng(3)
    # noisy arc: forces multiple split levels
    t = np.linspace(0, np.pi, 60)
    curve = np.stack(
        [np.cos(t), np.sin(t), 0.05 * rng.standard_normal(60)], axis=-1
    )
    eps = 0.08
    host = rdp.simplify(curve, eps)

    pad = 4  # exercise the padding path
    padded = np.concatenate([curve, np.repeat(curve[-1:], pad, 0)], 0)
    valid = np.arange(len(padded)) < len(curve)
    keep = np.asarray(rdp.simplify_masked(
        jnp.asarray(padded), jnp.asarray(valid), eps
    ))
    kept = padded[keep]
    # endpoints kept
    np.testing.assert_allclose(kept[0], curve[0])
    np.testing.assert_allclose(kept[-1], curve[-1])
    assert not keep[len(curve):].any()  # padding never kept
    # RDP contract: every input point within eps of the kept polyline
    seg = kept[1:] - kept[:-1]

    def pt_seg_dist(p):
        v = p[None] - kept[:-1]
        tt = np.clip(
            (v * seg).sum(-1) / np.maximum((seg * seg).sum(-1), 1e-12),
            0, 1,
        )
        proj = kept[:-1] + tt[:, None] * seg
        return np.linalg.norm(p[None] - proj, axis=-1).min()

    max_dev = max(pt_seg_dist(p) for p in curve)
    assert max_dev <= eps + 1e-6
    # comparable sparsity to the host result (same epsilon)
    assert keep.sum() <= len(host) + 4


def test_kino_search_trim_keeps_branch_start():
    """max_iters + 2 > max_knots: the static trim must discard the
    masked post-termination dupes, not the real branch prefix (the
    dupes are rolled to the front before trimming)."""
    dist, origin, res = _wall_map()
    start = np.array([0, -3, 2, 0, 0.5, 0], np.float32)
    goal = np.array([0, 3, 2, 0, 0, 0], np.float32)
    result = kinodynamic.search(
        dist, origin, res, start, goal, max_iters=40, beam=32,
        margin=0.2, max_knots=32,
    )
    assert bool(result.reached)
    times = np.asarray(result.times)
    pos = np.asarray(result.pos)
    seg_keep = times > 1e-6
    j0 = int(np.argmax(seg_keep))
    knot_keep = np.zeros(len(pos), bool)
    knot_keep[j0] = True
    knot_keep[1:][seg_keep] = True
    kept = pos[knot_keep]
    # the kept branch starts at the vehicle state (termination fired
    # well before iteration 40, so the real branch fits max_knots and
    # nothing real may be trimmed) and ends at the goal
    np.testing.assert_allclose(kept[0], start[:3], atol=1e-5)
    np.testing.assert_allclose(kept[-1], goal[:3], atol=1e-5)
    # consecutive kept knots are connected: each hop's length is
    # consistent with its duration (no zero-time teleports — the bug
    # this guards against produced a leaf-to-goal branch missing the
    # real prefix)
    step = np.linalg.norm(np.diff(kept, axis=0), axis=1)
    tk = times[seg_keep]
    assert (step <= 3.0 * tk + 0.8).all(), (step, tk)


def test_beam_vs_exact_gate():
    """SURVEY section-7 parity gate for the front-end consolidation:
    the batched beam must succeed nearly as often as the exact reference
    A* (native host port) and seed final optimized trajectories of
    comparable cost.  Conservative thresholds; the recorded 100-case
    suite (BEAM_VS_EXACT.md, scripts/beam_vs_exact.py) measured
    96/100 beam success, refined-cost geomean 0.98, time ratio 1.01."""
    import pytest

    from grad_traj_optimization_tpu import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    import sys
    sys.path.insert(0, "scripts")
    from beam_vs_exact import run_suite

    stats = run_suite(
        16, seed=5, verbose=False,
        retime="race:search,stretch:1.2", retries=2,
    )
    assert stats["exact_success"] >= stats["n_cases"] - 2
    assert stats["beam_success"] >= stats["exact_success"] - 2
    if stats["both_success"] >= 8:
        # round-4 recorded 100-case suite: gm 0.853, p90 1.11,
        # time gm 1.19 (the duration race trades a little flight time
        # for cost) — conservative bounds on the 16-case subsample
        assert stats["cost_ratio_geomean"] < 1.15
        assert stats["time_ratio_geomean"] < 1.45


def test_const_vel_prediction():
    t = np.array([[0.0, 0.5, 1.0]])
    pos = np.array([[[0, 0, 1], [0.5, 0, 1], [1.0, 0, 1]]], np.float32)
    pred = predictor.fit_const_vel(
        jnp.asarray(pos), jnp.asarray(t, jnp.float32),
        jnp.asarray([[0.4, 0.4, 1.0]], jnp.float32),
    )
    p = np.asarray(predictor.predict_position(pred, jnp.asarray(2.0)))
    np.testing.assert_allclose(p[0], [2.0, 0.0, 1.0], atol=1e-5)


def test_obj_history_ring_buffer():
    """queue_size / skip_num thinning semantics
    (obj_predictor.cpp:19-34) feeding the const-vel fit."""
    h = predictor.ObjHistory(queue_size=3, skip_num=2)
    recorded = []
    for k in range(10):
        # object moving at 1 m/s in x, observed every 0.1 s
        recorded.append(h.observe([0.1 * k, 0.0, 1.0], 0.1 * k))
    # 1 in skip_num observations lands (k = 1, 3, 5, 7, 9)
    assert sum(recorded) == 5
    assert len(h) == 3  # ring keeps the newest queue_size
    pos, t = h.arrays()
    np.testing.assert_allclose(t, [0.5, 0.7, 0.9], atol=1e-6)

    h2 = predictor.ObjHistory(queue_size=3, skip_num=2)
    for k in range(10):
        h2.observe([0.0, 0.2 * k, 1.0], 0.1 * k)
    hp, ht, sc = predictor.stack_histories(
        [h, h2], [[0.4, 0.4, 1.0]] * 2
    )
    pred = predictor.fit_const_vel(hp, ht, sc)
    p = np.asarray(predictor.predict_position(pred, jnp.asarray(2.0)))
    np.testing.assert_allclose(p[0], [2.0, 0.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(p[1], [0.0, 4.0, 1.0], atol=1e-5)


def test_poly_fit_recovers_polynomial():
    rng = np.random.default_rng(0)
    ts = np.linspace(0.0, 2.0, 12)
    coef = rng.uniform(-0.5, 0.5, size=(3, 3))  # quadratic truth
    pos = np.stack(
        [coef[d, 0] + coef[d, 1] * ts + coef[d, 2] * ts**2 for d in range(3)],
        axis=-1,
    )
    pred = predictor.fit_poly(
        jnp.asarray(pos[None], jnp.float32),
        jnp.asarray(ts[None], jnp.float32),
        jnp.asarray([[0.5, 0.5, 1.0]], jnp.float32),
        lam=0.0,
    )
    p = np.asarray(predictor.predict_position(pred, jnp.asarray(1.3)))
    truth = np.array(
        [coef[d, 0] + coef[d, 1] * 1.3 + coef[d, 2] * 1.3**2 for d in range(3)]
    )
    np.testing.assert_allclose(p[0], truth, atol=5e-2)


def test_dynamic_edt_min_over_boxes():
    dist, origin, res = _wall_map()
    # one box moving along +x at 1 m/s starting at (-2, -3, 2)
    hist_pos = np.array([[[-2.5, -3, 2], [-2.0, -3, 2]]], np.float32)
    hist_t = np.array([[-0.5, 0.0]], np.float32)
    pred = predictor.fit_const_vel(
        jnp.asarray(hist_pos), jnp.asarray(hist_t),
        jnp.asarray([[1.0, 1.0, 1.0]], jnp.float32),
    )
    q = jnp.asarray([[-1.0, -3.0, 2.0]], jnp.float32)
    # at t=0 box center (-2,-3,2), half=0.5 -> distance along x = 0.5
    d0 = dynamic.evaluate_coarse(dist, jnp.asarray(origin, jnp.float32),
                                 res, q, 0.0, pred)
    np.testing.assert_allclose(float(d0[0]), 0.5, atol=1e-3)
    # at t=1 box at (-1,-3,2): query inside -> 0
    d1 = dynamic.evaluate_coarse(dist, jnp.asarray(origin, jnp.float32),
                                 res, q, 1.0, pred)
    np.testing.assert_allclose(float(d1[0]), 0.0, atol=1e-5)
    # time < 0 -> static only (far from wall: large distance)
    dm = dynamic.evaluate_coarse(dist, jnp.asarray(origin, jnp.float32),
                                 res, q, -1.0, pred)
    assert float(dm[0]) > 1.0


def test_heuristic_matches_reference_formula():
    """Check the quartic-based heuristic against brute-force minimization
    of the Pontryagin cost over a dense time grid."""
    rng = np.random.default_rng(1)
    for _ in range(5):
        x1 = rng.uniform(-3, 3, 6)
        x2 = rng.uniform(-3, 3, 6)
        w_time, max_vel = 10.0, 3.0
        cost, t_opt = kinodynamic.estimate_heuristic(
            jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
            w_time, max_vel,
        )
        dp = x2[:3] - x1[:3]
        v0, v1 = x1[3:], x2[3:]
        c1 = -36 * dp @ dp
        c2 = 24 * (v0 + v1) @ dp
        c3 = -4 * (v0 @ v0 + v0 @ v1 + v1 @ v1)
        t_bar = np.abs(dp).max() / max_vel
        ts = np.linspace(max(t_bar, 1e-3), 50.0, 200000)
        cs = -c1 / (3 * ts**3) - c2 / (2 * ts**2) - c3 / ts + w_time * ts
        brute = cs.min() * (1 + 1.0 / 10000.0)
        assert abs(float(cost) - brute) / abs(brute) < 1e-2


def test_shot_coeffs_hit_end_state():
    rng = np.random.default_rng(2)
    s1 = rng.uniform(-2, 2, 6).astype(np.float32)
    s2 = rng.uniform(-2, 2, 6).astype(np.float32)
    td = 1.7
    coef = np.asarray(kinodynamic.shot_coeffs(
        jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(td)
    ))  # (3, 4)
    tp = np.array([td**j for j in range(4)])
    tv = np.array([0, 1, 2 * td, 3 * td**2])
    np.testing.assert_allclose(coef @ tp, s2[:3], atol=1e-3)
    np.testing.assert_allclose(coef @ tv, s2[3:], atol=1e-3)
    np.testing.assert_allclose(coef[:, 0], s1[:3], atol=1e-6)
    np.testing.assert_allclose(coef[:, 1], s1[3:], atol=1e-6)


def test_kino_search_reaches_goal_free_space():
    origin = np.array([-5.0, -5.0, 0.0])
    res = 0.25
    dist = jnp.full((40, 40, 16), sdf.FREE_DIST, jnp.float32)
    start = np.array([0, -3, 2, 0, 0, 0], np.float32)
    goal = np.array([0, 3, 2, 0, 0, 0], np.float32)
    result = kinodynamic.search(
        dist, origin, res, start, goal, max_iters=10, beam=32,
    )
    assert bool(result.reached)
    times = np.asarray(result.times)
    assert np.isfinite(times).all()
    # in free space the direct one-shot fires immediately: every
    # primitive segment is masked to zero duration (the documented
    # early-termination tail) and only the shot segment remains
    assert (times[:-1] == 0.0).all() and times[-1] > 0
    # final knot is the goal
    np.testing.assert_allclose(
        np.asarray(result.pos[-1]), goal[:3], atol=1e-5
    )


def test_kino_search_avoids_wall():
    dist, origin, res = _wall_map()
    start = np.array([0, -3, 2, 0, 0.5, 0], np.float32)
    goal = np.array([0, 3, 2, 0, 0, 0], np.float32)
    result = kinodynamic.search(
        dist, origin, res, start, goal, max_iters=16, beam=64,
        max_tau=0.4, margin=0.2,
    )
    # knots keep the margin from the wall
    d = np.asarray(
        sdf.distance_at(dist, jnp.asarray(origin, jnp.float32), res,
                        jnp.asarray(result.pos))
    )
    assert (d > 0.15).all()


def test_free_end_vel_shot_properties():
    rng = np.random.default_rng(7)
    for _ in range(5):
        p0 = rng.uniform(-2, 2, 3).astype(np.float32)
        p1 = rng.uniform(-2, 2, 3).astype(np.float32)
        v0 = rng.uniform(-1, 1, 3).astype(np.float32)
        coef, T, v1 = kinodynamic.free_end_vel_shot(
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(v0)
        )
        T = float(T)
        coef, v1 = np.asarray(coef), np.asarray(v1)
        assert T > 0
        tp = np.array([T**j for j in range(4)])
        tv = np.array([0, 1, 2 * T, 3 * T**2])
        np.testing.assert_allclose(coef @ tp, p1, atol=3e-3)
        np.testing.assert_allclose(coef @ tv, v1, atol=3e-3)
        np.testing.assert_allclose(coef[:, 0], p0, atol=1e-6)
        np.testing.assert_allclose(coef[:, 1], v0, atol=1e-6)
        # end velocity within the stretch bound
        assert np.all(v1 <= (2.5 / 3) * 3.0 + 1e-3)


def test_kino_search_space_time_avoids_moving_box():
    """With a box parked on the straight-line path at crossing time, the
    space-time search must deviate; the static search (time<0 analogue)
    would happily pass through that region before/after."""
    origin = np.array([-5.0, -5.0, 0.0])
    res = 0.25
    dist = jnp.full((40, 40, 16), sdf.FREE_DIST, jnp.float32)
    start = np.array([0, -3, 2, 0, 1.0, 0], np.float32)
    goal = np.array([0, 3, 2, 0, 0, 0], np.float32)

    # stationary (const-vel = 0) box sitting at the corridor midpoint
    hist = np.array([[[0.0, 0.0, 2.0], [0.0, 0.0, 2.0]]], np.float32)
    hist_t = np.array([[-0.5, 0.0]], np.float32)
    pred = predictor.fit_const_vel(
        jnp.asarray(hist), jnp.asarray(hist_t),
        jnp.asarray([[1.2, 1.2, 1.2]], jnp.float32),
    )
    res_dyn = kinodynamic.search(
        dist, origin, res, start, goal, obstacle_pred=pred,
        max_iters=14, beam=64, margin=0.2,
    )
    # knots keep clearance from the box at their times
    from grad_traj_optimization_tpu.fields import dynamic as dyn

    times = np.concatenate([[0.0], np.cumsum(np.asarray(res_dyn.times))])
    n = len(np.asarray(res_dyn.pos))
    d = [
        float(
            dyn.min_dist_to_boxes(
                jnp.asarray(res_dyn.pos[i]), jnp.asarray(times[min(i, len(times)-1)]), pred
            )
        )
        for i in range(n - 1)  # skip the final one-shot goal knot
    ]
    assert min(d) > 0.15


def test_beam_vs_hybrid_exact_gate():
    """Second front-end gate (round-3): the batched beam vs the exact
    HYBRID A* (compare2's front-end, native.hybrid_search with
    setParameterAuto params).  Conservative thresholds; the recorded
    100-case suite lives in BEAM_VS_EXACT.md (scripts/beam_vs_exact.py
    runs both this and the kino gate)."""
    import pytest

    from grad_traj_optimization_tpu import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    import sys
    sys.path.insert(0, "scripts")
    from beam_vs_exact import run_suite

    stats = run_suite(
        12, seed=9, verbose=False, exact="hybrid",
        retime="race:search,stretch:1.2", retries=2,
    )
    assert stats["exact_arm"] == "hybrid"
    assert stats["exact_success"] >= stats["n_cases"] - 3
    assert stats["beam_success"] >= stats["exact_success"] - 2
    if stats["both_success"] >= 6:
        # round-4 recorded 100-case suite (BEAM_VS_EXACT.md): hybrid
        # exact 100/100, beam 100/100 (retries=2); seed-duration race
        # closes the round-3 duration gap: refined-cost geomean 0.967
        # (was 1.13), flight time gm 0.890, jerk gm 0.313.  The
        # 12-case subsample swings hard (measured 1.26 on seed 9 —
        # two tail cases dominate a 12-sample geomean), so the bounds
        # stay loose; the 100-case record is the real gate:
        assert stats["cost_ratio_geomean"] < 1.45
        assert stats["time_ratio_geomean"] < 1.1
        assert stats["jerk_ratio_geomean"] < 0.7


def test_search_batch_lanes_equal_single_search():
    """search_batch (one vmapped program over the batch) returns, lane
    for lane, bitwise the per-case search."""
    rng = np.random.default_rng(11)
    from grad_traj_optimization_tpu import fixtures

    cases = []
    while len(cases) < 3:
        c = fixtures.random_search_case(rng)
        if c is not None:
            cases.append(c)
    dists = np.stack([c[0] for c in cases])
    origins = np.stack([c[1] for c in cases])
    starts = np.stack(
        [np.concatenate([c[3], np.zeros(3)]) for c in cases]
    ).astype(np.float32)
    goals = np.stack(
        [np.concatenate([c[4], np.zeros(3)]) for c in cases]
    ).astype(np.float32)
    rbatch = kinodynamic.search_batch(
        dists, origins, cases[0][2], starts, goals
    )
    for i, (dist, origin, res, start, goal) in enumerate(cases):
        r1 = kinodynamic.search(
            dist, jnp.asarray(origin, jnp.float32), res, starts[i],
            goals[i],
        )
        for a, b in zip(r1, rbatch):
            assert np.array_equal(np.asarray(a), np.asarray(b)[i])


def test_retime_knots_modes():
    pos = np.array([[0, 0, 1], [1.8, 0, 1], [3.6, 0, 1]], np.float64)
    vel = np.zeros((3, 3))
    times = np.array([0.5, 0.5])
    t_search = kinodynamic.retime_knots(pos, vel, times, mode="search")
    np.testing.assert_allclose(t_search, times)
    t_mv = kinodynamic.retime_knots(pos, vel, times, mode="mean_v",
                                    mean_v=1.8)
    np.testing.assert_allclose(t_mv, [1.0, 1.0])
    t_st = kinodynamic.retime_knots(pos, vel, times, mode="stretch",
                                    stretch=1.5)
    np.testing.assert_allclose(t_st, [0.75, 0.75])
    t_p = kinodynamic.retime_knots(pos, vel, times, mode="pontryagin")
    assert np.all(t_p > 0.1) and np.all(np.isfinite(t_p))


def test_resample_knots_batch_hermite_exact():
    """The batched resampler's cubic-Hermite interpolation must
    reconstruct the true branch geometry: on a direct-shot lane the
    resampled knots lie ON the shot cubic (computeShotTraj,
    kinodynamic_astar.cpp:393-404), and a kino-seeded batched solve
    agrees with the unbatched replan._refine_kino."""
    from grad_traj_optimization_tpu import fixtures, replan
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig

    rng = np.random.default_rng(2)
    cases = []
    while len(cases) < 3:
        c = fixtures.random_search_case(rng)
        if c is not None:
            cases.append(c)
    dists = np.stack([c[0] for c in cases])
    origins = np.stack([c[1] for c in cases])
    res = cases[0][2]
    starts = np.stack(
        [np.concatenate([c[3], np.zeros(3)]) for c in cases]
    ).astype(np.float32)
    goals = np.stack(
        [np.concatenate([c[4], np.zeros(3)]) for c in cases]
    ).astype(np.float32)
    rb = kinodynamic.search_batch(
        dists, origins, res, starts, goals
    )
    p6, v6, a6, t6 = kinodynamic.resample_knots_batch(
        rb.pos, rb.vel, rb.acc, rb.times, 6
    )
    assert np.all(np.asarray(t6) > 0)
    for i in range(3):
        # endpoints: the resample starts at the first REAL knot (the
        # vehicle start — the masked dupes collapse onto cum-time 0)
        # and ends at the branch end (the goal for reached lanes)
        if bool(rb.reached[i]):
            np.testing.assert_allclose(
                np.asarray(p6[i][0]), starts[i][:3], atol=1e-5
            )
            np.testing.assert_allclose(
                np.asarray(p6[i][-1]), goals[i][:3], atol=1e-5
            )

    cfg = OptimizerConfig(iters_step2=20)
    sols = solve_mod.solve_kino_batch(
        dists, origins, np.full(3, res, np.float32), p6, v6, a6, t6,
        cfg=cfg, steps=(2,),
    )
    assert np.all(np.asarray(sols.status) == 0)
    assert np.all(np.asarray(sols.cost) < 1e5)
    coeff_r, _ = replan._refine_kino(
        jnp.asarray(dists[1]), jnp.asarray(origins[1], jnp.float32),
        jnp.asarray(res, jnp.float32), p6[1], v6[1], a6[1], t6[1], cfg,
    )
    np.testing.assert_allclose(
        np.asarray(coeff_r), np.asarray(sols.coeff[1]), atol=1e-4
    )


def test_search_batch_dynamic_matches_single():
    """Round-5: search_batch(obstacle_pred=...) == per-scenario
    search(obstacle_pred=...) bitwise, for both batched and shared
    prediction leaves (the batched space-time front-end,
    kinodynamic_astar.cpp:199-213 at batch scale)."""
    rng = np.random.default_rng(21)
    from grad_traj_optimization_tpu import fixtures

    cases = []
    while len(cases) < 3:
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

    # one moving box per scenario, drifting across the map center
    hist = np.stack([
        np.array([[[-1.0 + 0.1 * i, 0.0, 1.5], [-0.8 + 0.1 * i, 0.0, 1.5]]],
                 np.float32)
        for i in range(3)
    ])  # (B, n_obj=1, H=2, 3)
    hist_t = np.broadcast_to(
        np.array([[-0.5, 0.0]], np.float32), (3, 1, 2)
    )
    scale = np.full((3, 1, 3), 0.8, np.float32)
    pred_b = jax.vmap(predictor.fit_const_vel)(
        jnp.asarray(hist), jnp.asarray(hist_t), jnp.asarray(scale)
    )
    t0s = np.array([0.0, 0.3, 0.7], np.float32)

    rb = kinodynamic.search_batch(
        dists, origins, res, starts, goals, obstacle_pred=pred_b,
        start_times=t0s, max_iters=12, beam=32,
    )
    for i in range(3):
        pred_i = jax.tree.map(lambda x: x[i], pred_b)
        r1 = kinodynamic.search(
            dists[i], jnp.asarray(origins[i]), res, starts[i],
            goals[i], obstacle_pred=pred_i, start_time=float(t0s[i]),
            max_iters=12, beam=32,
        )
        for a, b in zip(r1, rb):
            assert np.array_equal(np.asarray(a), np.asarray(b)[i])

    # shared prediction leaves ((n_obj, ...)) + shared map
    pred_s = jax.tree.map(lambda x: x[0], pred_b)
    rb_sh = kinodynamic.search_batch(
        dists[:1], origins, res, starts, goals, obstacle_pred=pred_s,
        start_times=t0s, max_iters=12, beam=32,
    )
    for i in range(3):
        r1 = kinodynamic.search(
            dists[0], jnp.asarray(origins[i]), res, starts[i],
            goals[i], obstacle_pred=pred_s, start_time=float(t0s[i]),
            max_iters=12, beam=32,
        )
        for a, b in zip(r1, rb_sh):
            assert np.array_equal(np.asarray(a), np.asarray(b)[i])


def test_search_batch_adaptive_merges_retries():
    """The batched retry ladder re-searches only unreached lanes and
    scatters back; merged result must match a direct wide search on
    the retried lanes and keep base results elsewhere."""
    rng = np.random.default_rng(5)
    from grad_traj_optimization_tpu import fixtures

    cases = []
    while len(cases) < 4:
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

    # a starved base budget forces failures; the ladder must recover
    base = kinodynamic.search_batch(
        dists, origins, res, starts, goals,
        beam=2, max_iters=3,
    )
    merged, n_retried, used = kinodynamic.search_batch_adaptive(
        dists, origins, res, starts, goals,
        beam=2, max_iters=3, retries=2, widen=4.0, deepen=3.0,
    )
    base_reached = np.asarray(base.reached)
    merged_reached = np.asarray(merged.reached)
    assert merged_reached.sum() >= base_reached.sum()
    # the starved budget must actually exercise the retry path (a
    # fixture where the base reaches 4/4 would make this test vacuous)
    assert not base_reached.all(), "fixture too easy — no retry fired"
    assert n_retried > 0 and used >= 1
    # untouched lanes keep base results bitwise — modulo the knot-axis
    # FRONT-PADDING the merge applies when a deeper rung returns more
    # knots (zero-duration dupes of the first knot; compare suffixes)
    for i in np.where(base_reached)[0]:
        for a, b in zip(base, merged):
            a_i, b_i = np.asarray(a)[i], np.asarray(b)[i]
            if a_i.ndim >= 1 and a_i.shape != b_i.shape:
                b_i = b_i[b_i.shape[0] - a_i.shape[0]:]
            assert np.array_equal(a_i, b_i)


def test_fast_heuristic_matches_exact():
    """heu='fast' (polynomial cos(acos/3) + bit-trick cbrt) must track
    the exact transcendental heuristic to f32 accuracy in the bulk:
    p99 relative error < 1e-6, identical finite-ness, and knife-edge
    deviations (different quartic-root selection where f32 root
    formulas are themselves ill-conditioned) rarer than 1e-3."""
    rng = np.random.default_rng(3)
    N = 100000
    x1 = np.concatenate([
        rng.uniform(-20, 20, (N, 3)), rng.uniform(-3, 3, (N, 3))
    ], 1).astype(np.float32)
    x2 = np.concatenate([
        rng.uniform(-20, 20, (N, 3)), rng.uniform(-3, 3, (N, 3))
    ], 1).astype(np.float32)
    he, te = kinodynamic.estimate_heuristic(
        jnp.asarray(x1), jnp.asarray(x2), 10.0, 3.0
    )
    hf, tf = kinodynamic.estimate_heuristic(
        jnp.asarray(x1), jnp.asarray(x2), 10.0, 3.0, fast=True
    )
    he, hf = np.asarray(he), np.asarray(hf)
    assert np.array_equal(np.isfinite(he), np.isfinite(hf))
    fin = np.isfinite(he)
    rel = np.abs(hf[fin] / he[fin] - 1)
    assert np.percentile(rel, 99) < 1e-6
    assert (rel > 1e-3).mean() < 1e-3

    # primitive accuracy
    v = np.asarray(rng.uniform(-1e6, 1e6, 50000), np.float32)
    fc = np.asarray(kinodynamic._fast_cbrt(jnp.asarray(v)))
    assert np.max(np.abs(fc / np.cbrt(v.astype(np.float64)) - 1)) < 1e-6
    x = np.linspace(-1, 1, 50001).astype(np.float32)
    ca = np.asarray(kinodynamic._cos_acos3(jnp.asarray(x)))
    assert np.max(np.abs(
        ca - np.cos(np.arccos(x.astype(np.float64)) / 3)
    )) < 3e-7


def test_dedup_variants_quality():
    """Round-5 dedup arms on fixture cases:

    * 'pp64' (per-parent top-beam pre-cut) is provably EXACT — must
      match dedup='exact' (the beam^2 bound) bitwise;
    * 'approx512' (lax.approx_max_k pre-cut) must reach like exact512
      and land close on seed cost (on CPU approx_max_k falls back to
      an exact selection, so it equals exact512 here).
    """
    rng = np.random.default_rng(17)
    from grad_traj_optimization_tpu import fixtures

    n_reach_e = n_reach_a = 0
    for _ in range(6):
        c = None
        while c is None:
            c = fixtures.random_search_case(rng)
        dist, origin, res, start, goal = c
        s6 = np.concatenate([start, np.zeros(3)]).astype(np.float32)
        g6 = np.concatenate([goal, np.zeros(3)]).astype(np.float32)
        kw = dict(max_iters=20, beam=64)
        rx = kinodynamic.search(
            dist, jnp.asarray(origin, jnp.float32), res, s6, g6,
            dedup="exact", **kw,
        )
        rp = kinodynamic.search(
            dist, jnp.asarray(origin, jnp.float32), res, s6, g6,
            dedup="pp64", **kw,
        )
        for a, b in zip(rx, rp):
            assert np.array_equal(np.asarray(a), np.asarray(b))

        re_ = kinodynamic.search(
            dist, jnp.asarray(origin, jnp.float32), res, s6, g6,
            dedup="exact512", **kw,
        )
        ra = kinodynamic.search(
            dist, jnp.asarray(origin, jnp.float32), res, s6, g6,
            dedup="approx512", **kw,
        )
        n_reach_e += bool(re_.reached)
        n_reach_a += bool(ra.reached)
        if bool(re_.reached) and bool(ra.reached):
            assert float(ra.cost) < 1.3 * float(re_.cost) + 1e-6
    assert n_reach_a >= n_reach_e - 1


def test_beam_quality_pinned_gate():
    """Round-5 CI enforcement of the recorded beam quality (VERDICT r4
    item 6): the 25-case pinned fixture suite vs BOTH exact host
    oracles, whose refined objectives are cached on disk
    (scripts/gen_beam_gate_cache.py — the native engine is
    deterministic).  Only the batched beam + batched refine run here
    (one compile each), so the real recorded bounds are enforced
    cheaply: success 25/25 with retries, vs-kino cost gm <= 0.97,
    vs-hybrid cost gm <= 1.12 (recorded 100-case: 0.858 / 0.983,
    BEAM_VS_EXACT.md; the old 12-case smoke bound of 1.45 let a
    regression to 1.4 pass).
    """
    import os
    import pytest

    cache_path = os.path.join(
        os.path.dirname(__file__), "data", "beam_gate_oracle.npz"
    )
    if not os.path.exists(cache_path):
        pytest.skip("oracle cache missing (scripts/gen_beam_gate_cache.py)")
    cache = np.load(cache_path)
    n_cases = int(cache["n_cases"])
    margin = float(cache["margin"])

    from grad_traj_optimization_tpu import fixtures, replan
    from grad_traj_optimization_tpu import solver as solve_mod
    from grad_traj_optimization_tpu.config import OptimizerConfig

    rng = np.random.default_rng(int(cache["seed"]))
    cases = []
    while len(cases) < n_cases:
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

    merged, _n_retried, _used = kinodynamic.search_batch_adaptive(
        dists, origins, res, starts, goals, retries=2,
        margin=margin, max_vel=3.0, max_acc=2.0,
        beam=64, max_iters=30,
    )
    reached = np.asarray(merged.reached)
    assert reached.all(), f"beam+retries reached {reached.sum()}/{n_cases}"

    # batched race refine (search-duration arm vs stretch-1.2 arm),
    # mirroring the recorded front-end config (BEAM_VS_EXACT.md)
    cfg = OptimizerConfig(iters_step2=int(cache["refine_iters"]))
    p6, v6, a6, t6 = kinodynamic.resample_knots_batch(
        merged.pos, merged.vel, merged.acc, merged.times, 6
    )
    ress = np.full(n_cases, res, np.float32)
    costs = []
    for t_arm in (t6, t6 * 1.2):
        sol = solve_mod.solve_kino_batch(
            jnp.asarray(dists), jnp.asarray(origins),
            jnp.asarray(ress), p6, v6, a6, t_arm,
            cfg=cfg, steps=(2,),
        )
        costs.append(np.asarray(sol.cost))
    cb = np.minimum(*costs)

    def gm_ratio(oracle_ok, oracle_cost):
        ok = np.asarray(oracle_ok) & np.isfinite(cb)
        r = cb[ok] / np.maximum(np.asarray(oracle_cost)[ok], 1e-9)
        return float(np.exp(np.mean(np.log(np.maximum(r, 1e-9))))), ok.sum()

    gm_k, n_k = gm_ratio(cache["ok_kino"], cache["cost_kino"])
    gm_h, n_h = gm_ratio(cache["ok_hybrid"], cache["cost_hybrid"])
    assert n_k >= n_cases - 2 and n_h >= n_cases - 2
    assert gm_k <= 0.97, f"vs-kino refined-cost gm {gm_k:.3f} > 0.97"
    assert gm_h <= 1.12, f"vs-hybrid refined-cost gm {gm_h:.3f} > 1.12"


def test_plan_batch_end_to_end():
    """Round-5 pipeline.plan_batch: one call = adaptive search +
    Hermite resample + raced refine; ok == reached & converged; the
    long-tau arm never loses reach."""
    from grad_traj_optimization_tpu import pipeline

    rng = np.random.default_rng(17)
    from grad_traj_optimization_tpu import fixtures

    cases = []
    while len(cases) < 4:
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
    from grad_traj_optimization_tpu.config import OptimizerConfig

    cfg = OptimizerConfig(iters_step2=15)
    r = pipeline.plan_batch(
        dists, origins, res, starts, goals, cfg=cfg,
        beam=32, max_iters=12, retries=1,
    )
    assert r.ok.sum() >= 3
    assert np.array_equal(
        r.ok, r.reached & (np.asarray(r.solution.status) == 0)
    )
    r2 = pipeline.plan_batch(
        dists, origins, res, starts, goals, cfg=cfg,
        beam=32, max_iters=12, retries=1,
        long_tau_arm=True,
    )
    assert r2.reached.sum() >= r.reached.sum()
    assert r2.arm is not None and r2.arm.shape == (4,)
    # raced winners on converged lanes are never worse than the base
    both = r.ok & r2.ok
    assert np.all(
        np.asarray(r2.solution.cost)[both]
        <= np.asarray(r.solution.cost)[both] + 1e-5
    )


def test_sort_payload_dedup_matches_legacy_bitwise():
    """Round-5: the sort-payload exact<K> dedup (variadic stable
    lax.sort carries) selects IDENTICAL beams to the legacy
    lexsort+gather formulation (kept as dedup='lex<K>') — full-result
    bitwise equality on fixture cases."""
    rng = np.random.default_rng(3)
    from grad_traj_optimization_tpu import fixtures

    n_checked = 0
    while n_checked < 3:
        c = fixtures.random_search_case(rng)
        if c is None:
            continue
        dist, origin, res, s, g = c[:5]
        s6 = np.concatenate([s, np.zeros(3)]).astype(np.float32)
        g6 = np.concatenate([g, np.zeros(3)]).astype(np.float32)
        kws = dict(max_iters=12, beam=32)
        r_new = kinodynamic.search(dist, jnp.asarray(origin), res, s6,
                                   g6, dedup="exact512", **kws)
        r_old = kinodynamic.search(dist, jnp.asarray(origin), res, s6,
                                   g6, dedup="lex512", **kws)
        for a, b in zip(r_new, r_old):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        n_checked += 1


def test_plan_batch_host_fallback_recovers():
    """Round-5: plan_batch(host_fallback=True) recovers lanes the
    starved beam misses via the exact native A* and refines them."""
    from grad_traj_optimization_tpu import native, pipeline

    if not native.available():
        import pytest

        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(5)
    from grad_traj_optimization_tpu import fixtures

    cases = []
    while len(cases) < 4:
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
    from grad_traj_optimization_tpu.config import OptimizerConfig

    cfg = OptimizerConfig(iters_step2=10)
    kw = dict(beam=2, max_iters=3, retries=0,
              stretches=(1.0,), cfg=cfg)
    base = pipeline.plan_batch(
        dists, origins, res, starts, goals, **kw
    )
    assert not base.reached.all(), "fixture too easy for the probe"
    fb = pipeline.plan_batch(
        dists, origins, res, starts, goals, host_fallback=True, **kw
    )
    assert fb.n_host_fallback >= 1
    assert fb.reached.sum() > base.reached.sum()
    assert fb.ok.sum() >= fb.reached.sum() - 1  # recovered lanes refine
    # recovered search branches end at their goals
    for i in np.where(fb.reached & ~base.reached)[0]:
        np.testing.assert_allclose(
            np.asarray(fb.search.pos)[i, -1], goals[i, :3], atol=1e-4
        )


def test_host_fallback_packed_mask_bitwise():
    """The fallback rung ships a bit-packed (d > margin) mask instead
    of the f32 field (the exact A* only thresholds the field:
    gtop_core.cpp k_dist_at/k_shot_ok callers).  The native search on
    the expanded two-level field must return BITWISE-identical knots
    to the full field."""
    from grad_traj_optimization_tpu import native, pipeline

    if not native.available():
        import pytest

        pytest.skip("native engine unavailable")
    from grad_traj_optimization_tpu import fixtures

    rng = np.random.default_rng(11)
    margin = 0.2
    n_checked = 0
    while n_checked < 3:
        c = fixtures.random_search_case(rng)
        if c is None:
            continue
        dist, origin, res, s3, g3 = c
        s6 = np.concatenate([s3, np.zeros(3)]).astype(np.float64)
        g6 = np.concatenate([g3, np.zeros(3)]).astype(np.float64)
        packed = np.asarray(
            pipeline._pack_safe_u8(jnp.asarray(dist)[None], margin)
        )
        safe = np.unpackbits(packed, axis=-1, bitorder="little")[
            ..., : dist.shape[-1]
        ].astype(bool)[0]
        two_level = np.where(
            safe, np.float32(10000.0), np.float32(0.0)
        )
        full = native.kino_search(
            np.asarray(dist, np.float32), origin, float(res), s6, g6,
            margin=margin,
        )
        masked = native.kino_search(
            two_level, origin, float(res), s6, g6, margin=margin,
        )
        assert full[4] == masked[4]
        for a, b in zip(full[:4], masked[:4]):
            np.testing.assert_array_equal(a, b)
        n_checked += 1


def test_plan_batch_degenerate_cases():
    """plan_batch edge cases: B=1, and a start placed at the goal."""
    from grad_traj_optimization_tpu import pipeline
    from grad_traj_optimization_tpu.config import OptimizerConfig

    rng = np.random.default_rng(19)
    from grad_traj_optimization_tpu import fixtures

    c = None
    while c is None:
        c = fixtures.random_search_case(rng)
    dist, origin, res, s, g = c[:5]
    cfg = OptimizerConfig(iters_step2=8)
    # B=1
    r = pipeline.plan_batch(
        dist[None], origin[None].astype(np.float32), res,
        np.concatenate([s, np.zeros(3)])[None].astype(np.float32),
        np.concatenate([g, np.zeros(3)])[None].astype(np.float32),
        cfg=cfg, beam=16, max_iters=10, retries=1,
    )
    assert r.reached.shape == (1,)
    # start == goal: must not crash; the shot connects immediately
    r2 = pipeline.plan_batch(
        dist[None], origin[None].astype(np.float32), res,
        np.concatenate([s, np.zeros(3)])[None].astype(np.float32),
        np.concatenate([s, np.zeros(3)])[None].astype(np.float32),
        cfg=cfg, beam=16, max_iters=10, retries=0,
    )
    assert r2.reached.shape == (1,)
